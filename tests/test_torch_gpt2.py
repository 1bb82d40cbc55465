"""The port's GPT-2 backbone (`lm/gpt2.py`) against the JAX package's on the
CPU at tiny widths (two layers of 32, four heads): the uncached causal
forward from token ids and from embeddings, a prefill then cached decode
steps into float32 and bf16 caches, and IndexTTS's one-row `wpe` read at
positions past its table (the JAX gather clamps them to row 0; the port
reads them through the embedding's call).

Weights go across with `load_jax_params`, every constant-initialised
parameter moved off its constant first. float32 bar: 1e-5 of each hidden
state's peak."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlx_audio_tpu.lm.cache import KVCache as JaxKVCache
from mlx_audio_tpu.lm.gpt2 import GPT2Config as JaxConfig
from mlx_audio_tpu.lm.gpt2 import GPT2Model as JaxGPT2
from mlx_audio_tpu.nn.module import flatten_params
from mlx_audio_tpu_torch.lm.gpt2 import GPT2Config, GPT2Model
from mlx_audio_tpu_torch.nn import load_jax_params

from test_torch_lm import _moved, numpy_init, one_torch_thread  # noqa: F401  (fixture)

BAR = 1e-5
CFG = dict(n_embd=32, n_head=4, n_layer=2, n_positions=16, vocab_size=50)

_jit_call = jax.jit(lambda m, x, caches, positions: m(x, caches, positions=positions))


def _close(got, want, bar=BAR):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    peak = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= bar * peak, f"max|d| {err:.3e} > {bar:g} of the peak {peak:.3e}"


def _pair(seed=0, **over):
    cfg = dict(CFG, **over)
    with numpy_init(seed):
        jm = _moved(JaxGPT2(JaxConfig(**cfg)), np.random.default_rng(seed))
    pm = GPT2Model(GPT2Config(**cfg), device="cpu")
    load_jax_params(pm, {k: np.asarray(v) for k, v in flatten_params(jm).items()})
    return jm, pm


@pytest.fixture(scope="module")
def pair():
    return _pair()


@pytest.mark.parametrize("inputs", ["ids", "embeddings"])
def test_uncached_causal_forward(pair, inputs):
    jm, pm = pair
    rng = np.random.default_rng(1)
    x = (rng.integers(0, CFG["vocab_size"], (2, 7)) if inputs == "ids"
         else rng.standard_normal((2, 7, CFG["n_embd"])).astype(np.float32))
    want, _ = jax.jit(lambda m, x: m(x))(jm, jnp.asarray(x))
    with torch.no_grad():
        got, caches = pm(torch.from_numpy(x))
    assert caches is None
    _close(got.numpy(), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_then_cached_decode(pair, dtype):
    """A 6-token prefill, then four one-token steps, each step's hidden
    state against the JAX model's with its functional caches."""
    jm, pm = pair
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    bar = BAR if dtype == "float32" else 1e-2
    ids = np.random.default_rng(2).integers(0, CFG["vocab_size"], (1, 10))
    H, hd = CFG["n_head"], CFG["n_embd"] // CFG["n_head"]
    jc = [JaxKVCache(1, H, 12, hd, jd) for _ in range(CFG["n_layer"])]
    pc = pm.make_caches(1, 12, td)
    assert [c.k.dtype for c in pc] == [td] * CFG["n_layer"]
    with torch.no_grad():
        for a, b in ((0, 6), (6, 7), (7, 8), (8, 9), (9, 10)):
            want, jc = _jit_call(jm, jnp.asarray(ids[:, a:b]), jc, None)
            got, pc = pm(torch.from_numpy(ids[:, a:b]), pc)
            _close(got.numpy(), want, bar)
    assert pc[0].pos == 10 and int(jc[0].pos) == 10


def test_one_row_wpe_past_its_table():
    """IndexTTS's GPT: `n_positions=1`, fed embeddings at positions up to
    twelve. The JAX gather clamps every position to row 0; so does the
    port's lookup, so a nonzero row is added at every position alike."""
    jm, pm = _pair(seed=3, n_positions=1)
    assert tuple(pm.wpe.weight.shape) == (1, CFG["n_embd"])
    assert float(pm.wpe.weight.detach().abs().max()) > 0
    x = np.random.default_rng(4).standard_normal((1, 5, CFG["n_embd"])).astype(np.float32)
    pos = np.array([0, 3, 7, 11, 12])
    H, hd = CFG["n_head"], CFG["n_embd"] // CFG["n_head"]
    jc = [JaxKVCache(1, H, 8, hd, jnp.float32) for _ in range(CFG["n_layer"])]
    want, _ = _jit_call(jm, jnp.asarray(x), jc, jnp.asarray(pos))
    with torch.no_grad():
        got, _ = pm(torch.from_numpy(x), pm.make_caches(1, 8, torch.float32),
                    positions=torch.from_numpy(pos))
        at_zero, _ = pm(torch.from_numpy(x), pm.make_caches(1, 8, torch.float32),
                        positions=torch.zeros(5, dtype=torch.long))
    _close(got.numpy(), want)
    torch.testing.assert_close(got, at_zero, rtol=0, atol=0)
