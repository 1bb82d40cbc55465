"""The port's LM core against the JAX package on the CPU at tiny widths:
`CausalLM` (Llama, Qwen3's q/k norms, Qwen2's bias, Llama-3's rope
scaling, tied embeddings, embeddings as input, int4 with the fused q/k/v
and gate/up), the samplers' filters, and the generate loops.

Weights go across with `load_jax_params`, every constant-initialised
parameter (norms, biases) moved off its constant first. float32 bars: 1e-5
on logits of O(1); greedy tokens must be identical, repetition penalty and
the EOS trim included. Sampled tokens come from a torch generator, so they
match the JAX package's in distribution only: the tests hold them to the
filters' support.
"""

import contextlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlx_audio_tpu.lm import CausalLM as JaxLM
from mlx_audio_tpu.lm import LMConfig as JaxConfig
from mlx_audio_tpu.lm import generate as jgen
from mlx_audio_tpu.lm import sample as jsample
from mlx_audio_tpu.nn import layers as jlayers
from mlx_audio_tpu.nn import quantized as jq
from mlx_audio_tpu.nn.module import flatten_params, load_weights
from mlx_audio_tpu.ops import rope as jrope
from mlx_audio_tpu.ops.attention import scaled_dot_product_attention as jsdpa
from mlx_audio_tpu_torch.lm import CausalLM, LMConfig, make_caches
from mlx_audio_tpu_torch.lm import generate as pgen
from mlx_audio_tpu_torch.lm import sample as psample
from mlx_audio_tpu_torch.nn import load_jax_params
from mlx_audio_tpu_torch.nn import quantized as pq
from mlx_audio_tpu_torch.ops import rope as prope
from mlx_audio_tpu_torch.ops.attention import scaled_dot_product_attention as psdpa

ATOL = 1e-5
V = 200
BASE = dict(hidden_size=64, num_hidden_layers=2, intermediate_size=128,
            num_attention_heads=4, num_key_value_heads=2, vocab_size=V)
LLAMA3 = {"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
          "high_freq_factor": 4.0, "original_max_position_embeddings": 16}
CONFIGS = {
    "llama": dict(model_type="llama"),
    "qwen3": dict(model_type="qwen3"),
    "qwen2": dict(model_type="qwen2"),
    "llama3_rope": dict(model_type="llama", rope_scaling=LLAMA3, rope_theta=500000.0),
    "tied": dict(model_type="llama", tie_word_embeddings=True),
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The tiny model's ops are too small to share out: one intra-op thread
    per test process (restored after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@contextlib.contextmanager
def numpy_init(seed=0):
    """The JAX package's weight initialiser drawing from numpy while a
    reference model is built: `jax.random.uniform` compiles a program for
    every new weight shape (~0.2 s each on the CPU), and the tests need only
    seeded weights of the same spread, which go across to the port."""
    rng = np.random.default_rng(seed)

    def he_uniform(key, shape, fan_in, dtype=jnp.float32):
        scale = math.sqrt(1.0 / max(fan_in, 1))
        return jnp.asarray(rng.uniform(-scale, scale, shape), dtype)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jlayers, "_he_uniform", he_uniform)
        yield


# the JAX model's calls, compiled once a shape: eager dispatch compiles
# every operation anew for each new shape
_jit_call = jax.jit(lambda m, *a: m(*a))
_jit_hidden = jax.jit(lambda m, x: m.hidden_states(x)[0])


def _moved(jm, rng):
    """The JAX model with every constant-initialised parameter moved."""
    flat = {}
    for k, v in flatten_params(jm).items():
        v = np.asarray(v)
        if v.dtype.kind == "f" and v.size and np.all(v == v.flat[0]):
            v = v + rng.standard_normal(v.shape).astype(np.float32) * 0.1
        flat[k] = v
    return load_weights(jm, {k: jnp.asarray(v) for k, v in flat.items()})


def _pair(name, quantize=False):
    cfg = dict(BASE, **CONFIGS[name])
    with numpy_init():
        jm = _moved(JaxLM(JaxConfig(**cfg)), np.random.default_rng(0))
    pm = CausalLM(LMConfig(**cfg), device="cpu")
    if quantize:
        jq.quantize_module(jm, group_size=64, bits=4)
        pq.quantize_module(pm, group_size=64, bits=4, quantize=False)
    load_jax_params(pm, {k: np.asarray(v) for k, v in flatten_params(jm).items()})
    if quantize:
        assert jq.fuse_quantized_projections(jm) == pq.fuse_quantized_projections(pm) == 4
    return jm, pm


@pytest.fixture(scope="module")
def pairs():
    return {name: _pair(name) for name in CONFIGS}


def _ids(n, seed=0, batch=1):
    return np.random.default_rng(seed).integers(0, V, (batch, n))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_causal_lm_logits(pairs, name):
    jm, pm = pairs[name]
    ids = _ids(12)
    want, _ = _jit_call(jm, jnp.asarray(ids))
    got, _ = pm(torch.as_tensor(ids))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=ATOL)


@pytest.mark.parametrize("name", ["llama", "qwen3"])
def test_cached_steps_and_hidden_states(pairs, name):
    """A prefill then single-token steps through the caches (bf16, as the
    JAX package's default) give the JAX package's logits; `hidden_states`
    and embeddings as input give the same hidden states."""
    jm, pm = pairs[name]
    ids = _ids(9, seed=1)
    jc = jm.make_caches(batch=1, max_len=16)
    pc = pm.make_caches(batch=1, max_len=16)
    assert pc[0].k.dtype == torch.bfloat16
    with torch.inference_mode():
        for sl in (slice(0, 7), slice(7, 8), slice(8, 9)):
            want, jc = _jit_call(jm, jnp.asarray(ids[:, sl]), jc)
            got, pc = pm(torch.as_tensor(ids[:, sl]), pc)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)
        jh = _jit_hidden(jm, jnp.asarray(ids))
        emb = pm.model.embed_tokens(torch.as_tensor(ids))
        ph, _ = pm.hidden_states(emb)
    np.testing.assert_allclose(ph.numpy(), np.asarray(jh), rtol=0, atol=ATOL)


def test_quantized_int4_with_fused_projections():
    jm, pm = _pair("qwen3", quantize=True)
    assert hasattr(pm.model.layers[0].self_attn, "qkv_fused")
    assert hasattr(pm.model.layers[0].mlp, "gate_up_fused")
    ids = _ids(10, seed=2)
    want, _ = _jit_call(jm, jnp.asarray(ids))
    got, _ = pm(torch.as_tensor(ids))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=ATOL)


def test_llama3_rope_freqs():
    want = np.asarray(jrope.llama3_rope_freqs(128, 500000.0, factor=32.0))
    got = prope.llama3_rope_freqs(128, 500000.0, factor=32.0)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_attention_with_a_bf16_cache_under_float32_queries():
    """JAX promotes the bf16 values to float32 for the product with float32
    probabilities; the port no longer rounds the probabilities to bf16."""
    rng = np.random.default_rng(3)
    q = rng.standard_normal((1, 4, 3, 16)).astype(np.float32)
    k, v = (rng.standard_normal((1, 2, 7, 16)).astype(np.float32) for _ in range(2))
    kb, vb = (torch.as_tensor(a).bfloat16() for a in (k, v))
    want = jsdpa(jnp.asarray(q), jnp.asarray(kb.float().numpy()).astype(jnp.bfloat16),
                 jnp.asarray(vb.float().numpy()).astype(jnp.bfloat16))
    got = psdpa(torch.as_tensor(q), kb, vb)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


def test_make_caches():
    caches = make_caches(3, 2, 4, 10, 8, dtype=torch.float32, device="cpu")
    assert len(caches) == 3 and caches[0].k.shape == (2, 4, 10, 8) and caches[0].pos == 0


# ---- samplers ----


@pytest.mark.parametrize("min_p,keep", [(0.0, 1), (0.05, 1), (0.2, 1), (0.2, 5)])
def test_min_p_filter(min_p, keep):
    x = np.random.default_rng(4).standard_normal((3, 50)).astype(np.float32) * 3
    want = np.asarray(jsample.min_p_filter(jnp.asarray(x), min_p, keep))
    got = psample.min_p_filter(torch.as_tensor(x), min_p, keep).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_array_equal(got[np.isfinite(got)], want[np.isfinite(want)])


@pytest.mark.parametrize("kw", [dict(temp=0.0), dict(temp=0.7, top_k=5),
                                dict(temp=1.0, top_p=0.6), dict(temp=0.8, min_p=0.1),
                                dict(temp=1.0, top_k=8, top_p=0.9, min_p=0.05)])
def test_make_sampler(kw):
    """Greedy equals JAX's argmax; a sampled token always lies in the support
    the JAX filters leave, and a seeded generator repeats its draws."""
    x = np.random.default_rng(5).standard_normal((4, 60)).astype(np.float32) * 2
    sampler = psample.make_sampler(**kw)
    if kw["temp"] == 0.0:
        want = np.asarray(jsample.make_sampler(**kw)(jnp.asarray(x), jax.random.PRNGKey(0)))
        np.testing.assert_array_equal(sampler(torch.as_tensor(x)).numpy(), want)
        return
    z = jnp.asarray(x) / kw["temp"]
    if kw.get("top_k"):
        z = jsample.top_k_filter(z, kw["top_k"])
    if kw.get("top_p", 1.0) < 1.0:
        z = jsample.top_p_filter(z, kw["top_p"])
    if kw.get("min_p", 0.0) > 0.0:
        z = jsample.min_p_filter(z, kw["min_p"])
    support = np.isfinite(np.asarray(z))
    draws = []
    for seed in (0, 0, 1):
        g = torch.Generator().manual_seed(seed)
        draws.append(np.stack([sampler(torch.as_tensor(x), g).numpy() for _ in range(30)]))
    assert np.array_equal(draws[0], draws[1])
    assert all(support[r, t] for d in draws for row in d for r, t in enumerate(row))


# ---- generation ----

EOS = 7


@pytest.mark.parametrize("name", ["llama", "qwen3", "llama3_rope"])
def test_generate_tokens_greedy(pairs, name):
    """Greedy tokens with repetition penalty 1.3 over 20, for one prompt
    (trimmed at its first EOS) and a batch of two."""
    jm, pm = pairs[name]
    kw = dict(max_tokens=24, repetition_penalty=1.3, repetition_context_size=20)
    for ids in (_ids(9, seed=6)[0], _ids(5, seed=7, batch=2)):
        want, wn = jgen.generate_tokens(jm, jnp.asarray(ids), eos_token_ids=(EOS,), **kw)
        with torch.inference_mode():
            got, gn = pgen.generate_tokens(pm, ids, eos_token_ids=(EOS,), **kw)
        np.testing.assert_array_equal(got, want)
        assert gn == wn


def _eos_hit(pm, ids):
    """A token the greedy decode of `ids` draws for the first time at step 5
    or soon after, to serve as EOS."""
    with torch.inference_mode():
        toks, _ = pgen.generate_tokens(pm, ids, max_tokens=12, repetition_penalty=1.3,
                                       repetition_context_size=20)
    row = [int(t) for t in toks[0]]
    return next(t for i, t in enumerate(row) if i >= 5 and t not in row[:i])


def test_generate_trims_at_eos_and_stream_matches(pairs):
    """An EOS the decode draws first at step 5 or so: both packages stop
    there and keep it; `stream_generate` yields the same tokens in chunks
    of 4 with finish_reason "stop" on the last, and "length" when the cap
    comes first."""
    jm, pm = pairs["llama"]
    ids = _ids(8, seed=8)[0]
    eos = _eos_hit(pm, ids)
    kw = dict(max_tokens=30, repetition_penalty=1.3, repetition_context_size=20,
              eos_token_ids=(eos,))
    want, wn = jgen.generate_tokens(jm, jnp.asarray(ids), **kw)
    with torch.inference_mode():
        got, gn = pgen.generate_tokens(pm, ids, **kw)
        streamed = list(pgen.stream_generate(pm, ids, chunk_size=4, **kw))
        capped = list(pgen.stream_generate(pm, ids, chunk_size=4, **dict(kw, max_tokens=3)))
    jstream = list(jgen.stream_generate(jm, jnp.asarray(ids), chunk_size=4, **kw))
    np.testing.assert_array_equal(got, want)
    assert gn == wn and got[0, -1] == eos and list(got[0]).index(eos) == gn - 1
    assert [r.token for r in streamed] == [r.token for r in jstream] == list(got[0])
    assert [r.finish_reason for r in streamed] == [r.finish_reason for r in jstream]
    assert streamed[-1].finish_reason == "stop"
    assert [r.finish_reason for r in capped] == [None, None, "length"]


def test_decode_polls_stop_the_batch_when_every_row_is_done(pairs, monkeypatch):
    """B = 2 rows with an EOS: the loop reads the all-done flag every
    POLL_STEPS steps, so it stops within POLL_STEPS of the last row's EOS,
    and returns the JAX loop's tokens up to that step."""
    jm, pm = pairs["llama"]
    ids = _ids(6, seed=9, batch=2)
    with torch.inference_mode():
        free, _ = pgen.generate_tokens(pm, ids, max_tokens=40)
    eos = int(free[0, 3])
    calls = []
    real = pgen._default_model_call
    monkeypatch.setattr(pgen, "_default_model_call",
                        lambda m, i, c: (calls.append(1), real(m, i, c))[1])
    kw = dict(max_tokens=40, eos_token_ids=(eos,))
    want, wn = jgen.generate_tokens(jm, jnp.asarray(ids), **kw)
    with torch.inference_mode():
        got, gn = pgen.generate_tokens(pm, ids, model_call=pgen._default_model_call, **kw)
    np.testing.assert_array_equal(got, want)
    assert gn == wn
    if wn < 40:  # every row drew EOS: the decode stopped at the next poll
        assert len(calls) - 1 <= -(-wn // pgen.POLL_STEPS) * pgen.POLL_STEPS


def test_sampled_generation_repeats_with_its_seed(pairs):
    _, pm = pairs["qwen3"]
    ids = _ids(6, seed=10)[0]
    kw = dict(max_tokens=12, temp=0.8, top_p=0.9)
    with torch.inference_mode():
        a, _ = pgen.generate_tokens(pm, ids, seed=3, **kw)
        b, _ = pgen.generate_tokens(pm, ids, seed=3, **kw)
        c, _ = pgen.generate_tokens(pm, ids, seed=4, **kw)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
