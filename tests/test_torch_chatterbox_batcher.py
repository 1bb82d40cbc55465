"""`T3Batcher` on the CPU at test_torch_chatterbox's tiny T3 (two Llama
layers of 32, CFG pairs in adjacent cache rows): greedy requests through
the slot pool equal to the single-request decode (`T3.decode` with the
argmax) and to the JAX package's batcher at temperature 0; sampled
requests equal to the same request alone through the pool and to
`T3.decode` with the request's seed (each slot's own seeded generator, the
one sampler `t3.sample_rows`); a mid-flight join (five requests through two slots
after the warm-up); and `generate` through the installed batcher equal to
the direct route at the argmax settings. Tokens identical."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlx_audio_tpu.tts.models.chatterbox import batcher as jb
from mlx_audio_tpu_torch.serving import get_infer_hook
from mlx_audio_tpu_torch.tts.models.chatterbox import batcher as pb

from test_torch_chatterbox import ARGMAX, _cond_pair, _t3_pair, tiny_port_model
from test_torch_lm import one_torch_thread  # noqa: F401  (fixture)

TIMEOUT = 120
TEXTS = ([5, 3, 4, 7, 0], [5, 9, 9, 12, 13, 14, 2, 0], [5, 1, 0], [5, 8, 8, 8, 30, 31, 0])


class _Shim:
    def __init__(self, t3):
        self.t3 = t3
        self.device = torch.device("cpu")


@pytest.fixture(scope="module")
def t3s():
    jm, pm = _t3_pair(40)
    with torch.no_grad():
        pm.speech_head.weight[60] = 0.0  # never the SOS; the stop may come
    jm = jm.replace(speech_head=jm.speech_head.replace(
        weight=jnp.asarray(pm.speech_head.weight.detach().numpy())))
    return jm, pm


def _embeds(jm, pm):
    out = []
    for i, text in enumerate(TEXTS):
        jc, pc = _cond_pair(seed=50 + i)
        with torch.inference_mode():
            e = pm.build_prefill_embeds(pc, np.array([text]), cfg_on=True).numpy()
        np.testing.assert_allclose(
            e, np.asarray(jm.build_prefill_embeds(jc, np.array([text]), cfg_on=True)),
            atol=1e-5 * float(np.abs(e).max()))
        out.append(e)
    return out


def _run(batcher_cls, t3, embeds, caps, slots=4, warm=False, **kw):
    b = batcher_cls(_Shim(t3), slots=slots, max_len=128, tick_frames=4)
    try:
        if warm:
            b.warmup()
        futs = [b.submit(e, max_tokens=m, seed=i, **kw)
                for i, (e, m) in enumerate(zip(embeds, caps))]
        return [list(np.asarray(f.result(timeout=TIMEOUT))) for f in futs], b.steps
    finally:
        b.close()


def test_greedy_batched_equals_alone_and_the_jax_batcher(t3s):
    """Four requests at temperature 0 (CFG 0.5, repetition penalty 1.2),
    the third capped at 3 (mid-tick)."""
    jm, pm = t3s
    embeds = _embeds(jm, pm)
    caps = (20, 20, 3, 20)
    kw = dict(temperature=0.0, cfg_weight=0.5, repetition_penalty=1.2)
    got, steps = _run(pb.T3Batcher, pm, embeds, caps, **kw)
    want, _ = _run(jb.T3Batcher, jm, embeds, caps, **kw)
    assert got == want
    assert steps >= 1
    for e, m, g in zip(embeds, caps, got):
        alone = pm.decode(torch.as_tensor(e), m, 0.0, 1.0, 0.0, 1.2, 0.5, 0,
                          sampler=lambda lg, gen: lg.argmax(-1))
        assert g == alone.tolist()


def test_sampled_batched_equals_alone_through_the_pool(t3s):
    jm, pm = t3s
    embeds = _embeds(jm, pm)
    kw = dict(temperature=0.8, top_p=0.9, min_p=0.05, repetition_penalty=1.2, cfg_weight=0.5)
    got, _ = _run(pb.T3Batcher, pm, embeds, (12,) * 4, **kw)
    for i, (e, g) in enumerate(zip(embeds, got)):
        b = pb.T3Batcher(_Shim(pm), slots=2, max_len=128, tick_frames=4)
        try:
            alone = list(np.asarray(b.submit(e, max_tokens=12, seed=i, **kw)
                                    .result(timeout=TIMEOUT)))
        finally:
            b.close()
        assert g == alone
        assert all(0 <= t < 70 and t != 61 for t in g)


@pytest.mark.parametrize("kw", [dict(temperature=0.8, top_p=0.9, min_p=0.05),
                                dict(temperature=1.0, top_p=1.0, min_p=0.0)])
def test_sampled_request_equals_t3_decode_with_its_seed(t3s, kw):
    """One sampler serves both routes (`t3.sample_rows`), each request's
    draws from its own generator seeded by the request: a sampled request
    through the pool gives `T3.decode`'s tokens for the same seed."""
    jm, pm = t3s
    embeds = _embeds(jm, pm)
    kw = dict(kw, repetition_penalty=1.3, cfg_weight=0.5)
    got, _ = _run(pb.T3Batcher, pm, embeds, (12,) * 4, **kw)
    for i, (e, g) in enumerate(zip(embeds, got)):
        alone = pm.decode(torch.as_tensor(e), 12, kw["temperature"], kw["top_p"], kw["min_p"],
                          1.3, 0.5, i)
        assert g == alone.tolist()


def test_mid_flight_join_after_warmup(t3s):
    """Five greedy requests through two slots: slots recycle at tick
    boundaries, and every request equals its run alone."""
    jm, pm = t3s
    embeds = _embeds(jm, pm)
    embeds.append(embeds[0][:, :-2].copy())
    caps = (9, 5, 7, 9, 6)
    got, _ = _run(pb.T3Batcher, pm, embeds, caps, slots=2, warm=True, temperature=0.0)
    for e, m, g in zip(embeds, caps, got):
        alone = pm.decode(torch.as_tensor(e), m, 0.0, 1.0, 0.0, 1.2, 0.5, 0,
                          sampler=lambda lg, gen: lg.argmax(-1))
        assert g == alone.tolist()


def test_generate_through_the_installed_batcher():
    """`Model.generate` with a T3Batcher installed takes the pool (its tick
    count moves) and gives the direct route's samples."""
    pm = tiny_port_model(41)
    ref = np.random.default_rng(42).standard_normal(24000).astype(np.float32) * 0.1
    kw = dict(ref_audio=ref, audio_prompt_sr=24000, max_new_tokens=8, seed=4, **ARGMAX)
    direct = list(pm.generate("hi there", **kw))[0]
    b = pm.make_batcher(slots=2, max_len=128, tick_frames=4).install()
    try:
        assert get_infer_hook(pm) is b
        served = list(pm.generate("hi there", **kw))[0]
        assert b.dispatch_count > 0
    finally:
        b.close()
    assert get_infer_hook(pm) is None
    np.testing.assert_array_equal(served.audio, direct.audio)
