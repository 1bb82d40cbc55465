"""The port's `ContinuousBatcher` and `serving.LMContinuousBatcher` on the
CPU at tiny widths: every greedy request's tokens equal its single-request
decode (`generate_tokens`) and the JAX package's batcher's, across EOS,
mid-flight joins (more requests than slots), fused ticks, embedding
prompts and the host-sampled case of a repetition window wider than the
pool's history; and the batcher installed as Orpheus's serving hook.
Every future is read with a timeout and every batcher closed in a
`finally`.
"""

import numpy as np
import pytest
import torch

from mlx_audio_tpu.lm import CausalLM as JaxLM
from mlx_audio_tpu.lm import LMConfig as JaxConfig
from mlx_audio_tpu.lm.continuous import ContinuousBatcher as JaxBatcher
from mlx_audio_tpu.nn.module import flatten_params
from mlx_audio_tpu_torch.lm import CausalLM, ContinuousBatcher, LMConfig, generate_tokens
from mlx_audio_tpu_torch.nn import load_jax_params
from mlx_audio_tpu_torch.serving import LMContinuousBatcher, get_infer_hook

from test_torch_lm import _moved, numpy_init, one_torch_thread  # noqa: F401  (fixture)

T_OUT = 60
V = 200
CFG = dict(model_type="llama", hidden_size=64, num_hidden_layers=2, intermediate_size=128,
           num_attention_heads=4, num_key_value_heads=2, vocab_size=V)
PEN = dict(repetition_penalty=1.3, repetition_context_size=20)


@pytest.fixture(scope="module")
def pair():
    with numpy_init(1):
        jm = _moved(JaxLM(JaxConfig(**CFG)), np.random.default_rng(1))
    pm = CausalLM(LMConfig(**CFG), device="cpu")
    load_jax_params(pm, {k: np.asarray(v) for k, v in flatten_params(jm).items()})
    return jm, pm


def _prompts():
    rng = np.random.default_rng(2)
    return [rng.integers(0, V, n).tolist() for n in (5, 17, 3, 11, 8)]


def _sequential(pm, prompts, max_tokens, eos=(), **kw):
    with torch.inference_mode():
        return [generate_tokens(pm, p, max_tokens=max_tokens, eos_token_ids=eos, **kw)[0][0]
                .tolist() for p in prompts]


def _batched(batcher, prompts, **kw):
    try:
        futs = [batcher.submit(p, **kw) for p in prompts]
        return [f.result(timeout=T_OUT) for f in futs]
    finally:
        batcher.close()


@pytest.mark.parametrize("tick", [1, 4])
def test_greedy_requests_equal_their_single_decode(pair, tick):
    """Five prompts through two slots (three join mid-flight), a repetition
    penalty over 20, an EOS that one request draws early: each request's
    tokens are its `generate_tokens` tokens, EOS kept, and the JAX
    batcher's."""
    jm, pm = pair
    prompts = _prompts()
    free = _sequential(pm, prompts, 24, **PEN)
    eos = free[2][4]
    seq = _sequential(pm, prompts, 24, eos=(eos,), **PEN)
    assert any(len(s) < 24 for s in seq) and any(len(s) == 24 for s in seq)
    got = _batched(ContinuousBatcher(pm, slots=2, max_len=64, tick_tokens=tick), prompts,
                   max_tokens=24, eos_ids=(eos,), **PEN)
    want = _batched(JaxBatcher(jm, slots=2, max_len=64, tick_tokens=tick), prompts,
                    max_tokens=24, eos_ids=(eos,), **PEN)
    assert got == seq == want


def test_host_sampled_window_and_embedding_prompts(pair):
    """A repetition window wider than the pool's history (host sampling on
    the fetched logits, one step a tick) and an embedding prompt, beside an
    ordinary request."""
    _, pm = pair
    prompts = _prompts()[:2]
    seq = _sequential(pm, prompts, 16, repetition_penalty=1.3, repetition_context_size=40)
    batcher = ContinuousBatcher(pm, slots=3, max_len=64, tick_tokens=4, rep_hist=8)
    try:
        with torch.inference_mode():
            emb = pm.model.embed_tokens(torch.as_tensor(prompts[1]))
        futs = [batcher.submit(prompts[0], max_tokens=16, repetition_penalty=1.3,
                               repetition_context_size=40),
                batcher.submit_embeds(emb.numpy(), max_tokens=16)]
        ref = _sequential(pm, prompts[1:], 16)
        got = [f.result(timeout=T_OUT) for f in futs]
    finally:
        batcher.close()
    assert got == [seq[0], ref[0]]
    assert batcher.steps >= 15  # host-sampled: one step a tick


def test_sampled_requests_keep_their_seed_beside_co_tenants(pair):
    """A sampled request's tokens depend only on its seed: alone and beside
    two co-tenants."""
    _, pm = pair
    prompts = _prompts()[:3]
    kw = dict(max_tokens=12, temp=0.8, top_k=20, top_p=0.9, min_p=0.02)
    alone = _batched(ContinuousBatcher(pm, slots=3, max_len=64, tick_tokens=4),
                     prompts[:1], seed=5, **kw)
    b = ContinuousBatcher(pm, slots=3, max_len=64, tick_tokens=4)
    try:
        futs = [b.submit(p, seed=s, **kw) for p, s in zip(prompts, (5, 6, 7))]
        together = [f.result(timeout=T_OUT) for f in futs]
    finally:
        b.close()
    assert together[0] == alone[0]
    assert together[1] != together[2]


def test_stream_callback_and_close(pair):
    """`on_token` streams every token as it is taken; `close` fails a
    request still waiting for a slot."""
    import threading

    _, pm = pair
    seen, started = [], threading.Event()
    b = ContinuousBatcher(pm, slots=1, max_len=64, tick_tokens=4)
    try:
        f1 = b.submit(_prompts()[0], max_tokens=10, on_token=seen.append)
        assert f1.result(timeout=T_OUT) == seen and len(seen) == 10
        b.submit(_prompts()[1], max_tokens=50, on_token=lambda t: started.set())
        waiting = b.submit(_prompts()[2], max_tokens=10)
        assert started.wait(T_OUT)
    finally:
        b.close()
    with pytest.raises(RuntimeError, match="closed"):
        waiting.result(timeout=T_OUT)


def test_lm_batcher_as_orpheus_hook(tmp_path):
    """`make_batcher` puts an LMContinuousBatcher on an Orpheus model; once
    installed, `generate` routes through it and gives the samples of the
    unbatched path; `close` removes the hook."""
    from test_torch_orpheus import port_orpheus

    pm = port_orpheus(tmp_path)
    try:
        want = [r.audio for r in pm.generate("Hello there.", temperature=0.0, max_tokens=40)]
        batcher = pm.make_batcher(slots=2, max_len=128)
        assert isinstance(batcher, LMContinuousBatcher)
        batcher.install()
        try:
            batcher.warmup()
            assert get_infer_hook(pm) is batcher
            steps = batcher.dispatch_count
            got = [r.audio for r in pm.generate("Hello there.", temperature=0.0,
                                                max_tokens=40)]
            assert batcher.dispatch_count > steps
        finally:
            batcher.close()
    finally:  # the tokenizer and codec are set on the class
        type(pm)._tokenizer = type(pm)._codec = None
    assert get_infer_hook(pm) is None
    assert len(got) == len(want) == 1
    np.testing.assert_array_equal(got[0], want[0])
