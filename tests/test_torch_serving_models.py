"""The four ported families through their serving batchers, on the CPU, at
small sizes, against their own unbatched routes and the JAX package's
batchers on the same weights and inputs.

- Whisper (`WhisperBatcher`): three concurrent seek-loop requests fuse into
  one dispatch; tokens identical to the sequential `generate` and to the
  JAX batcher's (greedy, float32).
- Kokoro (`batch_synthesize`, `KokoroBatcher`): each row's durations
  identical to its sequential call and its audio within one int16 step
  (rows of one frame bucket, so that each row draws its sequential noise);
  with the JAX batch's noise fed in, the JAX `batch_synthesize` rows within
  two int16 steps (the f32 bar of tests/test_torch_kokoro.py,
  `exact_first_frame`).
- MossFormer2-SE (`StackBatcher`): chunks through the batcher within 1e-5
  of their peak of the unbatched route (float32, batched matmuls and
  convolutions sum in another order), and the batched core within 1e-4 of
  the peak of the JAX vmapped batch (two FFT libraries; the JAX dither fed
  in, as in tests/test_torch_mossformer2_se.py).
- Qwen3-TTS (`Qwen3TTSBatcher`): greedy codes identical to the JAX
  batcher's and to the port's `_run_codes`; sampled codes of a request
  identical whether it shares the pool or runs alone, and equal to
  `_run_codes` with its seed; `generate` routes through an installed
  batcher, streaming too.

Every future is read with a timeout and every batcher closed in a
`finally`, so a stuck worker fails one test instead of hanging the run.
"""

from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import test_torch_qwen3_tts as tq
import test_torch_whisper as tw
from test_torch_kokoro import (TINY as KOKORO_TINY, exact_first_frame,  # noqa: F401
                               jax_noise, small_buckets)
from test_torch_mossformer2_se import TINY as MOSS_TINY, WAVE_REL, _jax_dither, _moved, _x
from test_torch_qwen3_tts import TEXT, jax_fresh  # noqa: F401

import mlx_audio_tpu.tts.models.kokoro.kokoro as jkok
import mlx_audio_tpu_torch.tts.models.kokoro.kokoro as pkok
from mlx_audio_tpu.nn.module import load_weights
from mlx_audio_tpu.serving import get_infer_hook as jax_hook
from mlx_audio_tpu.sts.models.mossformer2_se import Model as JaxMoss
from mlx_audio_tpu.sts.models.mossformer2_se import MossFormer2SEConfig as JaxMossConfig
from mlx_audio_tpu.sts.models.mossformer2_se import model as jmoss_model
from mlx_audio_tpu.stt.models.whisper.tokenizer import DummyTokenizer as JaxTok
from mlx_audio_tpu_torch import dsp
from mlx_audio_tpu_torch.nn import load_jax_params
from mlx_audio_tpu_torch.serving import get_infer_hook
from mlx_audio_tpu_torch.sts.models.mossformer2_se import Model as Moss
from mlx_audio_tpu_torch.sts.models.mossformer2_se import model as pmoss_model
from mlx_audio_tpu_torch.stt.models.whisper.tokenizer import DummyTokenizer
from mlx_audio_tpu_torch.tts.models.kokoro.pipeline import KokoroPipeline

TIMEOUT = 300


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Tiny ops: one intra-op thread per test process (restored after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def whisper_pair():
    """tests/test_torch_whisper.py's tiny pair (2 + 2 layers, width 64,
    the published vocabulary) on one set of weights."""
    jm = tw.JaxModel(tw.JaxDims(**tw.DIMS))
    rng = np.random.default_rng(0)
    flat = {k: np.asarray(v) + (rng.standard_normal(v.shape).astype(np.float32) * 0.1
                                if k.endswith(".bias") else 0)
            for k, v in tw.flatten_params(jm).items()}
    jm = load_weights(jm, {k: jnp.asarray(v) for k, v in flat.items()})
    pm = tw.Model(tw.ModelDimensions(**tw.DIMS), device="cpu")
    load_jax_params(pm, flat)
    return jm, pm


@pytest.fixture(scope="module")
def kokoro_models(small_buckets):
    jm = jkok.Model(jkok.ModelConfig.from_dict(KOKORO_TINY))
    pm = pkok.Model(KOKORO_TINY, device="cpu")
    load_jax_params(pm, {k: np.asarray(v) for k, v in tw.flatten_params(jm).items()})
    return jm, pm


@pytest.fixture(scope="module")
def qwen_pair(jax_fresh):
    return tq._pair(jax_fresh)


def _concurrent(fn, args_list):
    with ThreadPoolExecutor(len(args_list)) as ex:
        futs = [ex.submit(fn, *a) for a in args_list]
        return [f.result(timeout=TIMEOUT) for f in futs]


# ---- Whisper ----

WHISPER_V = 51866
WHISPER_KW = dict(language="en", temperature=0.0, sample_len=12, without_timestamps=True,
                  condition_on_previous_text=False, no_speech_threshold=None)


def test_whisper_batcher_matches_sequential_and_jax(whisper_pair):
    jm, pm = whisper_pair
    rng = np.random.default_rng(30)
    audios = [(rng.standard_normal(16000 * 2) * 0.05).astype(np.float32) for _ in range(3)]

    def port(a):
        return pm.generate(a, tokenizer=DummyTokenizer(n_vocab=WHISPER_V), **WHISPER_KW)

    def jax_(a):
        return jm.generate(a, tokenizer=JaxTok(n_vocab=WHISPER_V), **WHISPER_KW)

    seq = [port(a) for a in audios]
    outs = {}
    for tag, model, run, hook in (("port", pm, port, get_infer_hook),
                                  ("jax", jm, jax_, jax_hook)):
        batcher = model.make_batcher(max_batch=4, window_ms=300.0).install()
        try:
            assert hook(model) is batcher
            outs[tag] = _concurrent(run, [(a,) for a in audios])
            # one 30 s window a request, one prompt and option set: one dispatch
            assert batcher.dispatch_count == 1, tag
        finally:
            batcher.close()
        assert hook(model) is None
    for s, b, j in zip(seq, outs["port"], outs["jax"]):
        toks = [x["tokens"] for x in s.segments]
        assert len(toks) == 1 and len(toks[0]) > 0
        assert [x["tokens"] for x in b.segments] == toks == [x["tokens"] for x in j.segments]
        assert b.text == s.text == j.text


# ---- Kokoro ----

# three phoneme strings of one text bucket whose durations land in one frame
# bucket (65-128 frames)
KOKORO_TEXTS = ["ðə kwɪk fɑks", "tˈɛst ˈO ðə", "ˈO ðə tˈɛst wɜɹld"]


def _int16_steps(a, b) -> int:
    """How many int16 steps apart two waveforms of the model's int16
    output (k / 32767) lie at most."""
    assert a.shape == b.shape and a.size > 0
    return int(np.abs(np.round(a * 32767.0) - np.round(b * 32767.0)).max())


def _refs(seed, n):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(64).astype(np.float32) * 0.1 for _ in range(n)]


def test_kokoro_batch_synthesize_matches_sequential_and_jax(kokoro_models, exact_first_frame):
    jm, pm = kokoro_models
    refs = _refs(31, 3)
    seq = [pm(t, r, return_output=True) for t, r in zip(KOKORO_TEXTS, refs)]
    buckets = {pkok._bucket(int(s.pred_dur.sum()), pkok.FRAME_BUCKETS) for s in seq}
    assert len(buckets) == 1, "the texts must share a frame bucket"
    batched = pm.batch_synthesize(KOKORO_TEXTS, refs)
    assert len(batched) == 3
    for s, b in zip(seq, batched):
        np.testing.assert_array_equal(b.pred_dur, s.pred_dur)
        assert _int16_steps(b.audio, s.audio) <= 1

    ref = jm.batch_synthesize(KOKORO_TEXTS, refs)
    frames = jkok._bucket(int(max(r.pred_dur.sum() for r in ref)), jkok.FRAME_BUCKETS)
    L = frames * 2 * pm.decoder.generator.total_upsample
    got = pm.batch_synthesize(KOKORO_TEXTS, refs, noise=jax_noise(L, batch=4)[1])
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.pred_dur, r.pred_dur)
        assert _int16_steps(g.audio, r.audio) <= 2


def test_kokoro_batcher_routes_the_pipeline(kokoro_models):
    """`KokoroPipeline.infer` goes through an installed batcher: three
    concurrent segments in one dispatch, each its sequential call's audio
    within one int16 step."""
    _, pm = kokoro_models
    refs = _refs(32, 3)
    packs = [np.stack([r[None]] * 20) for r in refs]  # (20, 1, 64): row len(ps)-1
    seq = [pm(t, p[len(t) - 1], return_output=True) for t, p in zip(KOKORO_TEXTS, packs)]
    batcher = pm.make_batcher(max_batch=4, window_ms=300.0).install()
    try:
        assert get_infer_hook(pm) is batcher
        outs = _concurrent(lambda t, p: KokoroPipeline.infer(pm, t, p),
                           list(zip(KOKORO_TEXTS, packs)))
        assert batcher.dispatch_count == 1
    finally:
        batcher.close()
    assert get_infer_hook(pm) is None
    for s, o in zip(seq, outs):
        np.testing.assert_array_equal(o.pred_dur, s.pred_dur)
        assert _int16_steps(o.audio, s.audio) <= 1


# ---- MossFormer2-SE ----


@pytest.fixture(scope="module")
def moss_weights():
    return _moved(JaxMoss(JaxMossConfig(**MOSS_TINY)), np.random.default_rng(33))[1]


def _moss_pair(weights, **extra):
    cfg = {**MOSS_TINY, **extra}
    jm = load_weights(JaxMoss(JaxMossConfig(**cfg)),
                      {k: jnp.asarray(v) for k, v in weights.items()})
    return jm, load_jax_params(Moss(cfg, device="cpu"), weights)


def test_fbank_rows_equal_the_single_row_fbank():
    """The batched fbank of MossFormer2-SE's chunk core: each row equals
    `compute_fbank_kaldi` of that row alone (held to the JAX package in
    tests/test_torch_dsp.py), the dither draw included."""
    x = torch.from_numpy(np.stack([_x(37 + i, 9000) for i in range(3)]) * 1000)
    rows = dsp.compute_fbank_kaldi_rows(x, num_mels=8)
    assert rows.shape == (3, 19, 8)
    for i in range(3):
        np.testing.assert_allclose(rows[i].numpy(), dsp.compute_fbank_kaldi(x[i], num_mels=8)
                                   .numpy(), rtol=0, atol=1e-5)
    assert dsp.compute_fbank_kaldi_rows(x[:, :1000]).shape == (3, 0, 60)


def test_mossformer2_se_window_batcher(moss_weights):
    _, pm = _moss_pair(moss_weights)
    audios = [_x(34 + i, 48000) * 0.05 for i in range(3)]
    solo = [pm.enhance(a, chunked=False) for a in audios]
    batcher = pm.make_batcher(max_batch=4, window_ms=300.0).install()
    try:
        # keyed on the processor, and on the wrapper for a server's teardown
        assert get_infer_hook(pm.processor) is batcher and get_infer_hook(pm) is batcher
        batched = _concurrent(lambda a: pm.enhance(a, chunked=False), [(a,) for a in audios])
        assert batcher.dispatch_count == 1
    finally:
        batcher.close()
    assert get_infer_hook(pm.processor) is None and get_infer_hook(pm) is None
    for got, ref in zip(batched, solo):
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max())


def test_mossformer2_se_chunked_self_fusion(moss_weights):
    """One long chunked request submits its own windows together: the
    equal-length chunks fuse, the result is the unbatched chunked decode."""
    _, pm = _moss_pair(moss_weights, chunk_seconds=1.0)
    audio = _x(35, int(3.5 * 48000)) * 0.05
    ref = pm.enhance(audio, chunked=True)
    batcher = pm.make_batcher(max_batch=4, window_ms=300.0).install()
    try:
        got = pm.enhance(audio, chunked=True)
        # four 1 s chunks at a 0.75 s stride and a 0.5 s tail: two shapes
        assert batcher.dispatch_count == 2
    finally:
        batcher.close()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max())


def test_mossformer2_se_batch_core_matches_jax_vmap(moss_weights, monkeypatch):
    jm, pm = _moss_pair(moss_weights)
    monkeypatch.setattr(dsp, "kaldi_dither", _jax_dither)
    x = np.stack([_x(36 + i, 24000) for i in range(3)]) * 0.05 * pmoss_model.MAX_WAV_VALUE
    ref = np.asarray(jmoss_model._process_batch_jit(jm.net.model, jnp.asarray(x),
                                                    jm.processor._cfg_static))
    with torch.inference_mode():
        got = pmoss_model._process_batch_core(pm.processor.model, torch.from_numpy(x),
                                              pm.config).numpy()
    assert got.shape == ref.shape == x.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=WAVE_REL * np.abs(ref).max())


# ---- Qwen3-TTS ----

QWEN_TEXTS = [TEXT, "Another line, longer than the first one was."]
GREEDY = dict(temperature=0.0, top_k=0, top_p=1.0, repetition_penalty=1.05, max_tokens=8,
              min_tokens=8)
SAMPLED = dict(temperature=0.9, top_k=20, top_p=1.0, repetition_penalty=1.05, max_tokens=8,
               min_tokens=8)


def _run_codes(pm, text, seed=0, **kw):
    emb, tr, pad = pm._prepare_generation_inputs(text)
    return np.concatenate(list(pm._run_codes(emb, tr, pad, chunk_tokens=kw["max_tokens"],
                                             seed=seed, **kw)))


def _served(model, preps, kws, **batcher_kw):
    """Each (embeds, trailing) with its kwargs through one batcher, all
    submitted together; returns the codes and the batcher's tick count."""
    batcher = model.make_batcher(**batcher_kw)
    try:
        futs = [batcher.submit(e, t, **kw) for (e, t), kw in zip(preps, kws)]
        codes = [np.asarray(f.result(timeout=TIMEOUT)) for f in futs]
        return codes, batcher.dispatch_count
    finally:
        batcher.close()


def test_qwen3_greedy_batcher_matches_run_codes_and_jax(qwen_pair):
    jm, pm = qwen_pair
    want = [_run_codes(pm, t, **GREEDY) for t in QWEN_TEXTS]
    pool = dict(slots=2, max_len=64, tick_frames=3)
    preps = [pm._prepare_generation_inputs(t)[:2] for t in QWEN_TEXTS]
    got, ticks = _served(pm, preps, [GREEDY] * 2, **pool)
    jpreps = [tuple(np.asarray(a) for a in jm._prepare_generation_inputs(t)[:2])
              for t in QWEN_TEXTS]
    jgot, _ = _served(jm, jpreps, [GREEDY] * 2, **pool)
    assert ticks == 3  # 8 frames in ticks of 3, both slots in each
    for w, g, j in zip(want, got, jgot):
        assert w.shape == (8, 4)
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(j, w)


def test_qwen3_sampled_codes_depend_only_on_the_seed(qwen_pair):
    """Three sampled requests sharing a three-slot pool (one greedy
    co-tenant among them) give the codes each gives alone in a one-slot
    pool, and the single-request path's with the same seed."""
    _, pm = qwen_pair
    texts = QWEN_TEXTS + ["Third."]
    kws = [dict(SAMPLED, seed=5), dict(GREEDY), dict(SAMPLED, seed=7, top_k=0, top_p=0.9)]
    preps = [pm._prepare_generation_inputs(t)[:2] for t in texts]
    shared, _ = _served(pm, preps, kws, slots=3, max_len=64, tick_frames=4)
    for p, kw, got, text in zip(preps, kws, shared, texts):
        alone, _ = _served(pm, [p], [kw], slots=1, max_len=64, tick_frames=4)
        np.testing.assert_array_equal(got, alone[0])
        np.testing.assert_array_equal(got, _run_codes(pm, text, **kw))
    assert not np.array_equal(shared[0], shared[2])


def test_qwen3_generate_routes_through_the_batcher(qwen_pair):
    _, pm = qwen_pair
    kw = dict(temperature=0.9, top_k=20, max_tokens=10, min_tokens=10, seed=3)
    seen = []
    orig = pm._decode_codes
    pm._decode_codes = lambda c: (seen.append(np.asarray(c)), orig(c))[1]
    try:
        ref = list(pm.generate(TEXT, **kw))
        batcher = pm.make_batcher(slots=2, max_len=64, tick_frames=4).install()
        try:
            assert get_infer_hook(pm) is batcher
            out = list(pm.generate(TEXT, **kw))
            chunks = list(pm.generate(TEXT, stream=True, streaming_interval=0.25, **kw))
            ticks = batcher.dispatch_count
        finally:
            batcher.close()
        assert get_infer_hook(pm) is None
    finally:
        del pm._decode_codes
    assert len(ref) == len(out) == 1 and ticks == 6  # two requests of 10 frames, ticks of 4
    np.testing.assert_array_equal(seen[1], seen[0])
    np.testing.assert_array_equal(out[0].audio, ref[0].audio)
    assert [c.token_count for c in chunks] == [3, 3, 3, 1]
    assert all(c.is_streaming_chunk for c in chunks) and chunks[-1].is_final_chunk
    assert sum(c.samples for c in chunks) == 10 * 16
    # the streamed chunks decode the same codes, 3 frames at a time with context
    np.testing.assert_array_equal(seen[-1], seen[0][-seen[-1].shape[0]:])


def test_qwen3_batcher_refuses_a_request_and_serves_the_next(qwen_pair):
    _, pm = qwen_pair
    emb, tr, _ = pm._prepare_generation_inputs(TEXT)
    batcher = pm.make_batcher(slots=1, max_len=16, tick_frames=2)
    try:
        with pytest.raises(ValueError, match="capacity"):
            batcher.submit(emb.repeat(1, 3, 1), tr, **GREEDY).result(timeout=TIMEOUT)
        ok = batcher.submit(emb, tr, **dict(GREEDY, max_tokens=2, min_tokens=2))
        assert ok.result(timeout=TIMEOUT).shape == (2, 4)
    finally:
        batcher.close()


def test_warmups_run_every_batch_bucket(kokoro_models, moss_weights, qwen_pair):
    """Each batcher's `warmup` (the server's boot call): Kokoro and the
    stack batcher run one batched call at every bucket 1, 2, 4, …,
    max_batch outside the scheduler; the slot batcher fills every slot once."""
    _, km = kokoro_models
    _, mm = _moss_pair(moss_weights)
    _, qm = qwen_pair
    calls = []
    kb, mb = km.make_batcher(max_batch=6), mm.make_batcher(max_batch=6)
    qb = qm.make_batcher(slots=3, max_len=64, tick_frames=2)
    try:
        orig = km.batch_synthesize
        km.batch_synthesize = lambda ps, refs, **kw: (calls.append(len(ps)),
                                                      orig(ps, refs, **kw))[1]
        try:
            kb.warmup()
        finally:
            del km.batch_synthesize
        run_batch = mb._run_batch
        mb._run_batch = lambda items: (calls.append(len(items)), run_batch(items))[1]
        mb.warmup()  # no example item: nothing to run
        mb.warmup(_x(38, 48000) * 0.05)
        qb.warmup()
        assert calls == [1, 2, 4, 6, 1, 2, 4, 6]
        assert kb.dispatch_count == mb.dispatch_count == 0  # outside the scheduler
        assert qb.dispatch_count == 1 and all(a is None for a in qb.active)
    finally:
        for b in (kb, mb, qb):
            b.close()
