"""The port's layers and weight bridge against the JAX package's layers.

Weights go from the JAX layer through its flatten_params dict into the
port with load_jax_params. f32 bar 1e-5: both sides run the same float32
operations; only summation order differs.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from mlx_audio_tpu.nn import layers as jl
from mlx_audio_tpu.nn.module import flatten_params
from mlx_audio_tpu_torch.nn import Conv1d, Embedding, LayerNorm, Linear, load_jax_params
from mlx_audio_tpu_torch.nn.module import cast_floats

ATOL = 1e-5


def _bridge(jax_layer, port_layer, rng):
    """Give every JAX parameter random values, then carry them across."""
    for name, val in flatten_params(jax_layer).items():
        setattr(jax_layer, name,
                jnp.asarray(rng.standard_normal(val.shape).astype(np.float32) * 0.3))
    flat = {k: np.asarray(v) for k, v in flatten_params(jax_layer).items()}
    load_jax_params(port_layer, flat)
    return jax_layer, port_layer


def _compare(jax_layer, port_layer, x, fn="__call__"):
    ref = np.asarray(getattr(jax_layer, fn)(jnp.asarray(x)))
    port_fn = port_layer.forward if fn == "__call__" else getattr(port_layer, fn)
    with torch.no_grad():
        out = port_fn(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL)


def test_linear():
    rng = np.random.default_rng(0)
    j, p = _bridge(jl.Linear(24, 40), Linear(24, 40, device="cpu"), rng)
    _compare(j, p, rng.standard_normal((3, 5, 24)).astype(np.float32))


def test_linear_without_bias():
    rng = np.random.default_rng(1)
    j, p = _bridge(jl.Linear(24, 8, bias=False),
                   Linear(24, 8, bias=False, device="cpu"), rng)
    _compare(j, p, rng.standard_normal((4, 24)).astype(np.float32))


def test_embedding_lookup_and_as_linear():
    rng = np.random.default_rng(2)
    j, p = _bridge(jl.Embedding(50, 16), Embedding(50, 16, device="cpu"), rng)
    ids = rng.integers(0, 50, (2, 7))
    np.testing.assert_array_equal(
        p(torch.from_numpy(ids)).detach().numpy(), np.asarray(j(jnp.asarray(ids))))
    _compare(j, p, rng.standard_normal((2, 3, 16)).astype(np.float32), "as_linear")


def test_conv1d_nlc_strided():
    """k = 3, stride 2, padding 1 (the Whisper encoder's conv2); the bridge
    turns the JAX (O, K, I) weight into torch's (O, I, K)."""
    rng = np.random.default_rng(3)
    j, p = _bridge(jl.Conv1d(12, 20, 3, stride=2, padding=1),
                   Conv1d(12, 20, 3, stride=2, padding=1, device="cpu"), rng)
    assert tuple(p.weight.shape) == (20, 12, 3)
    _compare(j, p, rng.standard_normal((2, 31, 12)).astype(np.float32))


def test_layernorm():
    rng = np.random.default_rng(4)
    j, p = _bridge(jl.LayerNorm(32), LayerNorm(32, device="cpu"), rng)
    x = (rng.standard_normal((3, 6, 32)) * 4 + 1).astype(np.float32)
    _compare(j, p, x)


def test_layernorm_bf16_returns_input_dtype():
    p = LayerNorm(16, device="cpu")
    p.reset_parameters(None)
    x = torch.randn(2, 16, generator=torch.Generator().manual_seed(0)).bfloat16()
    y = p(x)
    assert y.dtype == torch.bfloat16
    ref = torch.nn.functional.layer_norm(x.float(), (16,), eps=1e-5).bfloat16()
    torch.testing.assert_close(y, ref, atol=0, rtol=0)


def test_cast_floats_leaves_integers():
    p = Linear(4, 4, device="cpu")
    p.register_buffer("ids", torch.arange(3))
    cast_floats(p, torch.bfloat16)
    assert p.weight.dtype == torch.bfloat16 and p.bias.dtype == torch.bfloat16
    assert p.ids.dtype == torch.int64


@pytest.mark.parametrize("fault", ["unknown", "missing", "shape"])
def test_bridge_errors(fault):
    flat = {"weight": np.zeros((8, 4), np.float32), "bias": np.zeros(8, np.float32)}
    if fault == "unknown":
        flat["scale"] = np.zeros(8, np.float32)
        match = "not found in model"
    elif fault == "missing":
        del flat["bias"]
        match = "missing from checkpoint"
    else:
        flat["weight"] = np.zeros((4, 8), np.float32)
        match = "Shape mismatch"
    with pytest.raises(ValueError, match=match):
        load_jax_params(Linear(4, 8, device="cpu"), flat)


def test_bridge_non_strict_allows_missing():
    p = Linear(4, 8, device="cpu")
    p.reset_parameters(None)
    w = np.full((8, 4), 0.5, np.float32)
    load_jax_params(p, {"weight": w}, strict=False)
    np.testing.assert_array_equal(p.weight.detach().numpy(), w)
    assert float(p.bias.detach().abs().sum()) == 0.0
