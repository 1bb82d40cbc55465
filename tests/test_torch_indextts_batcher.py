"""`IndexTTSBatcher` on the CPU at test_torch_indextts's tiny widths (the stop
planted at step 6): concurrent requests at top_k = 1 through the slot pool
equal to the single-request `_indextts_decode` and to the JAX package's
batcher (counts and codes identical, latents within 1e-5 of the peak), the
planted stop and a cap mid-tick; sampled requests equal to the same request
alone through the pool (each row's own seeded generator); `generate`
through the installed batcher equal to the direct route; and a bucketed
B = 1 prefill equal to the unpadded prompt's."""

import numpy as np
import pytest
import torch

from mlx_audio_tpu.tts.models.indextts import indextts as ji
from mlx_audio_tpu_torch.lm.continuous import _bucket
from mlx_audio_tpu_torch.serving import get_infer_hook
from mlx_audio_tpu_torch.tts.models.indextts import batcher as pb
from mlx_audio_tpu_torch.tts.models.indextts import indextts as pi

from test_indextts import FakeTok
from test_torch_indextts import PLANT, REF, _close, planted  # noqa: F401  (fixture)
from test_torch_lm import one_torch_thread  # noqa: F401  (fixture)

TIMEOUT = 120
TEXTS = ("hello there", "the quick brown fox", "ab", "over the lazy dog again")


def _embeddings(model, mel):
    return [np.asarray(model.prepare_input_embedding(FakeTok().encode(t), mel))
            for t in TEXTS]


def _run(model, embs, caps, **kw):
    b = model.make_batcher(slots=4, max_len=128, tick_frames=4)
    try:
        futs = [b.submit(e, max_tokens=m, **kw) for e, m in zip(embs, caps)]
        return [np.asarray(f.result(timeout=TIMEOUT)) for f in futs], b.steps
    finally:
        b.close()


def _codes(pm, lat):
    with torch.no_grad():
        return pm.mel_head(torch.as_tensor(lat)).argmax(-1).numpy()


def test_batched_top_k_1_equals_alone_and_the_jax_batcher(planted):
    """Four requests, the third capped at 3 (mid-tick): each equals its
    `_indextts_decode` (the stop step's latent kept) and the JAX batcher's
    rows for the same prompts."""
    jm, pm = planted
    mel = np.asarray(ji.log_mel_spectrogram(REF, n_mels=16))
    embs = _embeddings(jm, mel)
    caps = (20, 20, 3, 20)
    got, steps = _run(pm, embs, caps, temperature=0.8, top_k=1)
    want, _ = _run(jm, embs, caps, temperature=0.8, top_k=1)
    assert steps <= 3  # ticks of 4 steps: the planted stop ends every row by the second
    for e, m, g, w in zip(embs, caps, got, want):
        alone, n = pi._indextts_decode(pm, torch.tensor(e), m, 0.8, 1, seed=0)
        rows = min(n, m)
        assert g.shape == w.shape == (rows, 32) and rows == min(PLANT + 1, m)
        _close(g, alone[:rows].numpy())
        _close(g, w)
        np.testing.assert_array_equal(_codes(pm, g), _codes(pm, w))
    assert _codes(pm, got[0])[-1] == pm.args.gpt.stop_mel_token


def test_batched_sampled_equals_alone(planted):
    """A sampled request draws from its own generator: its latents are the
    same beside three others as alone in the pool."""
    _, pm = planted
    embs = [np.asarray(e) for e in _embeddings(pm, pi.log_mel_spectrogram(REF, n_mels=16))]
    kw = dict(temperature=0.9, top_k=12)
    b = pm.make_batcher(slots=4, max_len=128, tick_frames=4)
    try:
        futs = [b.submit(e, max_tokens=10, seed=s, **kw) for s, e in enumerate(embs)]
        batched = [f.result(timeout=TIMEOUT) for f in futs]
        for s, (e, want) in enumerate(zip(embs, batched)):
            alone = b.submit(e, max_tokens=10, seed=s, **kw).result(timeout=TIMEOUT)
            np.testing.assert_array_equal(alone, want)
    finally:
        b.close()


def test_generate_routes_through_the_batcher(planted):
    _, pm = planted
    direct = next(pm.generate("Hello.", ref_audio=REF, max_tokens=20, top_k=1, seed=0))
    b = pm.make_batcher(slots=2, max_len=128, tick_frames=4).install()
    try:
        assert get_infer_hook(pm) is b
        served = next(pm.generate("Hello.", ref_audio=REF, max_tokens=20, top_k=1, seed=0))
        assert b.steps > 0
    finally:
        b.close()
    assert get_infer_hook(pm) is None
    assert served.token_count == PLANT + 1 and direct.token_count == PLANT + 1
    _close(served.audio, direct.audio)


def test_bucketed_prefill_equals_the_unpadded_prompt(planted):
    _, pm = planted
    emb = pm.prepare_input_embedding(FakeTok().encode("hi"), pi.log_mel_spectrogram(REF,
                                                                                    n_mels=16))
    T = emb.shape[1]
    P = _bucket(T)
    assert P > T
    g = pm.args.gpt
    x = torch.zeros(1, P, g.model_dim)
    x[:, :T] = emb
    padded = pm.gpt.make_caches(1, P, torch.float32)
    plain = pm.gpt.make_caches(1, T, torch.float32)
    with torch.no_grad():
        h = pb._prefill_b1(pm, padded, x, T)
        h_ref, _ = pm.gpt(emb, plain)
    _close(h.numpy(), h_ref[0, -1].numpy())
    for a, c in zip(padded, plain):
        _close(a.k[:, :, :T].numpy(), c.k.numpy())


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_warmup_and_greedy_rows(planted, temperature):
    """`warmup` runs a wave of one tiny request a slot; a greedy row
    (temperature 0) takes the argmax, as the JAX batcher's does."""
    _, pm = planted
    b = pm.make_batcher(slots=2, max_len=64, tick_frames=4)
    try:
        b.warmup()
        e = pm.prepare_input_embedding(FakeTok().encode("hey"),
                                       pi.log_mel_spectrogram(REF, n_mels=16))
        out = b.submit(e.numpy(), max_tokens=20, temperature=temperature,
                       top_k=1).result(timeout=TIMEOUT)
    finally:
        b.close()
    assert out.shape == (PLANT + 1, 32)
