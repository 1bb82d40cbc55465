"""Chatterbox-Turbo in the port against the JAX package on the CPU at
`tests/test_chatterbox_turbo.py`'s tiny sizes (a GPT-2 of two layers of 32,
the tiny S3Gen of `test_torch_chatterbox.py` with a meanflow estimator, a
voice encoder of 16):

- the sampler (`sample_rows`) against `_sample_topk_topp` with the JAX
  draws passed in, under the repetition penalty, top-k and top-p;
- T3Turbo's prompt and its decode with the JAX loop's draws replayed (the
  planted stop mid-run, and the cap), and the chunked decode: its chunks
  the JAX package's chunks, together the one decode's tokens;
- `integrated_loudness` and `normalize_loudness` against the JAX
  functions, and the 48 kHz K-weighting table;
- `_split_text`, `_filter_speech_tokens` and `sanitize`;
- `Model.generate` end to end with the JAX package's draws (T3's, the
  flow's fixed noise, HiFT's source), over two text chunks;
- `TurboBatcher`: requests batched equal to each alone (sampled and
  greedy), and `generate` (plain and streamed) through the installed
  batcher equal to the direct route;
- a fault of the reference: the JAX package's int4 T3Turbo reads packed
  words as its speech embedding and raises; the port's int4 T3Turbo decodes
  the tokens of the JAX float32 T3Turbo on the dequantized weights.

float32 bar: 1e-5 of each output's peak, 1e-4 for waveforms (HiFT's ISTFT
head); tokens identical."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlx_audio_tpu.codec.models import s3gen as js
from mlx_audio_tpu.codec.models.s3gen import s3gen as js3
from mlx_audio_tpu.nn import quantized as jq
from mlx_audio_tpu.nn.module import flatten_params as jax_flatten
from mlx_audio_tpu.tts.models.chatterbox import t3 as jt3
from mlx_audio_tpu.tts.models.chatterbox import voice_encoder as jve
from mlx_audio_tpu.tts.models.chatterbox_turbo import chatterbox_turbo as jct
from mlx_audio_tpu_torch.codec.models import s3gen as ps
from mlx_audio_tpu_torch.nn import load_jax_params
from mlx_audio_tpu_torch.nn import quantized as pq
from mlx_audio_tpu_torch.tts.models.chatterbox import t3 as pt3
from mlx_audio_tpu_torch.tts.models.chatterbox import voice_encoder as pve
from mlx_audio_tpu_torch.tts.models.chatterbox_turbo import chatterbox_turbo as pct

from test_chatterbox_turbo import TINY_GPT2, tiny_cfg
from test_torch_chatterbox import VE_HP, FakeS3, FakeTok, TINY_SIZES
from test_torch_lm import _moved, numpy_init, one_torch_thread  # noqa: F401  (fixture)
from test_torch_s3gen import CAM, ENC, EST, HIFT, sine_draws

BAR = 1e-5
WAV_BAR = 1e-4
STOP = 61
# the JAX front ends' static arguments, for compiling them once a shape
MEL_STATIC = ("n_fft", "num_mels", "sampling_rate", "hop_size", "win_size", "fmin", "fmax")
LOG_STATIC = ("sample_rate", "n_mels", "n_fft", "hop_length", "padding")


def _close(got, want, bar=BAR):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    peak = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= bar * peak, f"max|d| {err:.3e} > {bar:g} of the peak {peak:.3e}"


def _t(x):
    return torch.from_numpy(np.array(x))


def _carry(jm, pm, seed):
    jm = _moved(jm, np.random.default_rng(seed))
    load_jax_params(pm, {k: np.asarray(v) for k, v in jax_flatten(jm).items()})
    return jm


def _t3_pair(seed=0, gpt2=None, stop_bias=0.0):
    """(JAX T3Turbo, port T3Turbo) on the same weights; `stop_bias` adds
    3·u (u a unit direction) to the final norm's shift and stop_bias/3·u to
    the stop token's head row, which lifts the stop's logit by about
    `stop_bias` at every step."""
    cfg = tiny_cfg()
    if gpt2:
        cfg.gpt2_overrides = gpt2
    with numpy_init(seed):
        jm = jct.T3Turbo(cfg)
    pm = pct.T3Turbo(cfg, device="cpu")
    jm = _carry(jm, pm, seed)
    if stop_bias:
        u = np.random.default_rng(seed).standard_normal(pm.dim).astype(np.float32)
        u /= np.linalg.norm(u)
        w = np.asarray(jm.speech_head.weight).copy()
        w[STOP] += stop_bias / 3.0 * u
        shift = np.asarray(jm.tfmr.ln_f.bias) + 3.0 * u
        jm = jm.replace(speech_head=jm.speech_head.replace(weight=jnp.asarray(w)),
                        tfmr=jm.tfmr.replace(ln_f=jm.tfmr.ln_f.replace(bias=jnp.asarray(shift))))
        with torch.no_grad():
            pm.speech_head.weight.copy_(_t(w))
            pm.tfmr.ln_f.bias.copy_(_t(shift))
    return jm, pm


def _conds(dim=32, seed=1):
    rng = np.random.default_rng(seed)
    spk = rng.standard_normal((1, 16)).astype(np.float32)
    emb = rng.standard_normal((1, 4, dim)).astype(np.float32) * 0.1
    return (jt3.T3Cond(speaker_emb=jnp.asarray(spk), cond_prompt_speech_emb=jnp.asarray(emb),
                       emotion_adv=None),
            pt3.T3Cond(speaker_emb=_t(spk), cond_prompt_speech_emb=_t(emb), emotion_adv=None))


def _gumbel(key, V):
    return _t(np.asarray(jax.random.gumbel(key, (1, V))))


@pytest.mark.parametrize("temp,top_k,top_p,rep", [(0.8, 1000, 0.95, 1.2), (1.3, 5, 1.0, 1.0),
                                                  (0.5, 0, 0.6, 2.0), (1e-3, 3, 0.9, 1.2)])
def test_sampler_with_the_jax_draws(temp, top_k, top_p, rep):
    rng = np.random.default_rng(2)
    V = 70
    for s in range(8):
        logits = rng.standard_normal((1, V)).astype(np.float32) * 2.0
        hist = np.full((1, 128), -1)
        hist[0, -5:] = rng.integers(0, V, 5)
        key = jax.random.PRNGKey(s)
        jl = jnp.asarray(logits)
        if rep != 1.0:
            from mlx_audio_tpu.lm.sample import apply_repetition_penalty as jpen

            jl = jpen(jl, jnp.asarray(hist, jnp.int32), rep)
        want = int(jct._sample_topk_topp(jl, key, temp, top_k, top_p)[0])
        got = pct.sample_rows(_t(logits), [None], _t(hist), torch.tensor([temp]),
                              torch.tensor([top_k]), torch.tensor([top_p]), rep,
                              gumbel=_gumbel(key, V))
        assert int(got[0]) == want


class JaxT3Draws:
    """The port's T3 draws replaced by the JAX loop's: each step's Gumbel
    draw from the key stream `_turbo_decode_loop` splits."""

    def __init__(self, monkeypatch):
        self.key = None
        me, orig = self, pct.sample_rows

        def sample_rows(logits, generators, hist, temps, top_ks, top_ps, rep_pens,
                        gumbel=None):
            me.key, sub = jax.random.split(me.key)
            return orig(logits, generators, hist, temps, top_ks, top_ps, rep_pens,
                        gumbel=_gumbel(sub, logits.shape[-1]))

        monkeypatch.setattr(pct, "sample_rows", sample_rows)


SAMPLED = dict(temperature=0.9, top_k=20, top_p=0.95, repetition_penalty=1.2)


@pytest.mark.parametrize("stop_bias", [0.0, 3.0])
def test_t3_tokens_and_chunks_with_the_jax_draws(stop_bias, monkeypatch):
    """The JAX package pads the prompt to 32 rows; the port prefills it
    unpadded. With the stop's head row lifted the stop comes mid-run."""
    jm, pm = _t3_pair(3, stop_bias=stop_bias)
    draws = JaxT3Draws(monkeypatch)
    jc, pc = _conds()
    ids = np.array([[3, 4, 5, 6, 7]])
    with torch.no_grad():
        bos = np.full((1, 1), 60)
        _close(pm.prefill_embeds(pc, ids).numpy(), jm.prepare_input_embeds(jc, ids, bos))
    lens = []
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        want = jm.inference_turbo(jc, ids, max_gen_len=24, key=key, **SAMPLED)
        draws.key = key
        got = pm.inference_turbo(pc, ids, max_gen_len=24, seed=0, **SAMPLED)
        np.testing.assert_array_equal(got, want)
        jchunks = list(jm.inference_turbo_stream(jc, ids, max_gen_len=24, chunk_size=5, key=key,
                                                 **SAMPLED))
        draws.key = key
        pchunks = list(pm.inference_turbo_stream(pc, ids, max_gen_len=24, chunk_size=5, seed=0,
                                                 **SAMPLED))
        assert [f for _, f in pchunks] == [f for _, f in jchunks]
        for (p, _), (j, _) in zip(pchunks, jchunks):
            np.testing.assert_array_equal(p, j)
        lens.append(want.shape[1])
    assert (max(lens) < 24) == bool(stop_bias)


SIGNALS = [("sine", 48000, 1), ("noise", 24000, 1), ("stereo", 44100, 2), ("short", 16000, 1),
           ("silence", 24000, 1), ("quiet_burst", 22050, 1)]


@pytest.mark.parametrize("kind,sr,ch", SIGNALS)
def test_loudness_against_the_jax_meter(kind, sr, ch):
    from mlx_audio_tpu import dsp as jdsp
    from mlx_audio_tpu_torch import dsp as pdsp

    rng = np.random.default_rng(4)
    n = int(sr * (0.3 if kind == "short" else 2.5))
    x = {"sine": np.sin(2 * np.pi * 997 * np.arange(n) / sr),
         "noise": rng.standard_normal(n) * 0.1,
         "stereo": rng.standard_normal((n, 2)) * np.array([0.1, 0.02]),
         "short": rng.standard_normal(n) * 0.1, "silence": np.zeros(n),
         "quiet_burst": np.concatenate([np.zeros(n // 2), rng.standard_normal(n - n // 2)])
         * 1e-3}[kind].astype(np.float32)
    assert (x.ndim == 2) == (ch == 2)
    want = jdsp.integrated_loudness(x, sr)
    got = pdsp.integrated_loudness(x, sr)
    assert got == want or (np.isinf(got) and np.isinf(want))
    np.testing.assert_array_equal(pdsp.normalize_loudness(x, sr, -20.0),
                                  jdsp.normalize_loudness(x, sr, -20.0))
    for a, b in zip(pdsp._k_weighting_coeffs(sr), jdsp._k_weighting_coeffs(sr)):
        np.testing.assert_array_equal(np.asarray(a, dtype=object), np.asarray(b, dtype=object))


def test_split_filter_and_sanitize():
    for text, pat, m in (("One. Two. Three. Four.", r"(?<=[.!?])\s+", 16),
                         ("abc", None, 800), ("One. Two! Three?", r"(?<=[.!?])\s+", 800)):
        assert pct.Model._split_text(text, pat, m) == jct.Model._split_text(text, pat, m)
    pm = pct.Model.__new__(pct.Model)
    torch.nn.Module.__init__(pm)
    pm.t3 = pct.T3Turbo(tiny_cfg(), device="cpu")
    jm = jct.Model.__new__(jct.Model)
    jm.t3 = jct.T3Turbo(tiny_cfg())
    toks = np.array([1, 70, 6561, 5, 60, 61, 4298, 2])
    np.testing.assert_array_equal(pm._filter_speech_tokens(toks),
                                  jm._filter_speech_tokens(toks))
    keys = ["t3.tfmr.transformer.h.0.attn.c_attn.weight", "t3.speech_emb.weight",
            "s3gen.encoder.embed.out.0.weight", "s3gen.decoder.estimator.x", "s3gen.mel2wav.y",
            "s3gen.flow.encoder_proj.weight", "ve.lstm.0.Wx"]
    w = {k: np.full(2, i, np.float32) for i, k in enumerate(keys)}
    assert list(pm.sanitize(w)) == list(jm.sanitize(w))


def _jax_turbo_s3gen(seed):
    """The JAX package's Turbo S3Gen (the meanflow estimator, two steps) at the
    tiny sizes, and the port's, on the same weights."""
    with numpy_init(seed):
        jest = js.ConditionalDecoder(**EST, meanflow=True)
        jcfm = js3.CausalConditionalCFM(estimator=jest, cfm_params=js.CFMParams())
        jcfm.MEL_CHANNELS = 8
        jgen = js3.S3Token2Wav.__new__(js3.S3Token2Wav)
        jgen.flow = js.CausalMaskedDiffWithXvec(
            input_size=16, output_size=8, spk_embed_dim=192, vocab_size=70, n_timesteps=2,
            encoder=js.UpsampleConformerEncoder(**ENC), decoder=jcfm)
        jgen.speaker_encoder = js.CAMPPlus(**CAM)
        jgen.mel2wav = js.HiFTGenerator(**HIFT, sampling_rate=22050)
    n_trim = js3.S3GEN_SR // 50
    jgen._trim_fade = jnp.concatenate([jnp.zeros(n_trim),
                                       (jnp.cos(jnp.linspace(jnp.pi, 0.0, n_trim)) + 1) / 2])
    pgen = pct.build_turbo_s3gen("cpu", sizes=TINY_SIZES)
    pgen.flow.decoder.MEL_CHANNELS = 8
    jgen = _carry(jgen, pgen, seed)
    jgen.flow.decoder.MEL_CHANNELS = 8
    return jgen, pgen


@pytest.fixture(scope="module")
def tiny_models():
    """The JAX package's tiny Turbo (built without its full-size parts) and
    the port's, on the same weights."""
    jt, pt = _t3_pair(5)
    jgen, pgen = _jax_turbo_s3gen(6)
    with numpy_init(7):
        jv = jve.VoiceEncoder(jve.VoiceEncConfig(**VE_HP))
    pv = pve.VoiceEncoder(pve.VoiceEncConfig(**VE_HP), device="cpu")
    jv = _carry(jv, pv, 7)
    jm = jct.Model.__new__(jct.Model)
    jm.config = jct.ModelConfig(t3_config=tiny_cfg())
    jm.sample_rate, jm.t3, jm.s3gen, jm.ve, jm._conds = 24000, jt, jgen, jv, None
    pm = pct.Model(pct.ModelConfig(t3_config=tiny_cfg()), device="cpu", s3gen_sizes=TINY_SIZES)
    pm.t3, pm.s3gen, pm.ve = pt, pgen, pv
    for m in (jm, pm):
        m.set_runtime(tokenizer=FakeTok(), s3_tokenizer=FakeS3())
    return jm, pm


def test_generate_end_to_end_with_the_jax_draws(tiny_models, monkeypatch):
    """Two text chunks from a 2 s reference (its loudness normalised): each
    chunk's waveform within 1e-4 of the peak of the JAX package's, T3's and
    HiFT's draws the chunk key's halves, the flow's noise PRNGKey(42)."""
    from mlx_audio_tpu import native

    monkeypatch.setattr(native, "available", lambda: False)
    for cls in (jve.VoiceEncoder,):
        monkeypatch.setattr(cls, "__call__", jax.jit(cls.__call__))
    monkeypatch.setattr(js.CAMPPlus, "inference", jax.jit(js.CAMPPlus.inference))
    monkeypatch.setattr(js.HiFTGenerator, "inference", jax.jit(js.HiFTGenerator.inference))
    monkeypatch.setattr(js3, "mel_spectrogram", jax.jit(js3.mel_spectrogram,
                                                       static_argnames=MEL_STATIC))
    monkeypatch.setattr(jct, "log_mel_spectrogram", jax.jit(jct.log_mel_spectrogram,
                                                            static_argnames=LOG_STATIC))
    monkeypatch.setattr(js.CausalMaskedDiffWithXvec, "inference", jax.jit(
        js.CausalMaskedDiffWithXvec.inference,
        static_argnames=("finalize", "n_timesteps", "streaming", "meanflow")))
    jm, pm = tiny_models
    draws = JaxT3Draws(monkeypatch)
    hift_keys = []
    monkeypatch.setattr(ps.ConditionalCFM, "initial_noise", lambda self, shape, device, g=None:
                        _t(np.asarray(jax.random.normal(jax.random.PRNGKey(42), shape))))
    monkeypatch.setattr(ps.SineGen, "draws", lambda sg, B, T, device, g=None:
                        sine_draws(sg, B, T, hift_keys.pop(0)))
    ref = np.random.default_rng(8).standard_normal(48000).astype(np.float32) * 0.1
    text = "Hello there. Second one!"
    kw = dict(ref_audio=ref, sample_rate=24000, max_tokens=16, **SAMPLED)
    want = list(jm.generate(text, seed=9, split_pattern=r"(?<=[.!?])\s+", **kw))
    key = jax.random.PRNGKey(9)
    t3_keys = []
    for _ in want:
        key, k1, k2 = jax.random.split(key, 3)
        t3_keys.append(k1)
        hift_keys.append(k2)

    orig = pm.t3.inference_turbo

    def inference_turbo(*a, **k):
        draws.key = t3_keys.pop(0)
        return orig(*a, **k)

    monkeypatch.setattr(pm.t3, "inference_turbo", inference_turbo)
    got = list(pm.generate(text, seed=9, split_pattern=r"(?<=[.!?])\s+", **kw))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.samples == w.samples > 0 and g.token_count == w.token_count
        _close(g.audio, w.audio, bar=WAV_BAR)


def _prompts(pm, n=3):
    jc, pc = _conds(seed=10)
    del jc
    with torch.no_grad():
        return [pm.t3.prefill_embeds(pc, np.array([[3] + list(range(4, 5 + i))])).numpy()
                for i in range(n)]


@pytest.mark.parametrize("temperature", [0.0, 0.9])
def test_turbo_batcher_equals_each_request_alone(tiny_models, temperature):
    """Three requests, two slots (the third joins mid-flight), ticks of 4:
    each request's tokens are `decode_chunks`' for its seed."""
    from mlx_audio_tpu_torch.tts.models.chatterbox_turbo import TurboBatcher

    _, pm = tiny_models
    embs = _prompts(pm)
    kw = dict(SAMPLED, temperature=temperature)
    want = [np.concatenate([t for t, _ in pm.t3.decode_chunks(
        torch.from_numpy(e), 14, kw["temperature"], kw["top_k"], kw["top_p"],
        kw["repetition_penalty"], 20 + i)]) for i, e in enumerate(embs)]
    b = TurboBatcher(pm, slots=2, max_len=96, tick_frames=4)
    try:
        futs = [b.submit(e, max_tokens=14, seed=20 + i, **kw) for i, e in enumerate(embs)]
        got = [f.result(timeout=60) for f in futs]
    finally:
        b.close()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_generate_through_the_installed_batcher(tiny_models):
    """`generate`, plain and streamed, through the installed TurboBatcher:
    the direct route's audio."""
    _, pm = tiny_models
    ref = np.random.default_rng(11).standard_normal(48000).astype(np.float32) * 0.1
    kw = dict(ref_audio=ref, sample_rate=24000, max_tokens=12, seed=4, **SAMPLED)
    direct = list(pm.generate("Hello there.", **kw))
    streamed_direct = list(pm.generate("Hello there.", stream=True, streaming_interval=0.4,
                                       **kw))
    b = pm.make_batcher(slots=2, max_len=96, tick_frames=4).install()
    try:
        served = list(pm.generate("Hello there.", **kw))
        streamed = list(pm.generate("Hello there.", stream=True, streaming_interval=0.4, **kw))
        assert b.dispatch_count >= 2
    finally:
        b.close()
    np.testing.assert_array_equal(served[0].audio, direct[0].audio)
    np.testing.assert_array_equal(np.concatenate([r.audio for r in streamed]),
                                  np.concatenate([r.audio for r in streamed_direct]))


def test_jax_quantized_turbo_fault(monkeypatch):
    """A fault of the reference: the JAX package's `quantize_module` (the
    packing `convert --quantize` applies) packs T3Turbo's speech table,
    which `_turbo_decode_loop` then indexes as `.weight[tok]` (packed
    words), and the decode raises. The port reads its tables through the
    embeddings' calls: its int4 T3Turbo decodes the tokens of the JAX
    float32 T3Turbo on the dequantized weights."""
    gpt2 = dict(TINY_GPT2, n_embd=64)
    jm, _ = _t3_pair(12, gpt2=gpt2)
    jq4 = jq.quantize_module(jm, 64, 4)
    jc, pc = _conds(dim=64, seed=13)
    ids = np.array([[3, 4, 5, 6]])
    with pytest.raises(Exception):
        jq4.inference_turbo(jc, ids, max_gen_len=12, key=jax.random.PRNGKey(0), **SAMPLED)
    flat = {k: np.asarray(v) for k, v in jax_flatten(jq4).items()}
    cfg = tiny_cfg()
    cfg.gpt2_overrides = gpt2
    pm4 = pct.T3Turbo(cfg, device="cpu")
    pq.quantize_module(pm4, 64, 4, quantize=False)
    load_jax_params(pm4, flat)
    assert isinstance(pm4.speech_emb, pq.QuantizedEmbedding)
    deq = {}
    for k, v in flat.items():
        base = k[: -len(".weight")]
        if k.endswith(".weight") and base + ".scales" in flat:
            v = np.asarray(jq.dequantize_arrays(jnp.asarray(v), jnp.asarray(flat[base + ".scales"]),
                                                jnp.asarray(flat[base + ".biases"]), 64, 4,
                                                jnp.float32))
        if not k.endswith((".scales", ".biases")):
            deq[k] = v
    jf = jct.T3Turbo(cfg)
    from mlx_audio_tpu.nn.module import load_weights as jload

    jf = jload(jf, {k: jnp.asarray(v) for k, v in deq.items()})
    draws = JaxT3Draws(monkeypatch)
    for seed in range(2):
        key = jax.random.PRNGKey(seed)
        want = jf.inference_turbo(jc, ids, max_gen_len=12, key=key, **SAMPLED)
        draws.key = key
        got = pm4.inference_turbo(pc, ids, max_gen_len=12, seed=0, **SAMPLED)
        np.testing.assert_array_equal(got, want)
