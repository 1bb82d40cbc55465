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
from mlx_audio_tpu_torch.nn import (Conv1d, ConvTranspose1d, Embedding, InstanceNorm, LayerNorm,
                                    Linear, load_jax_params)
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


@pytest.mark.parametrize("groups", [1, 2, 8])
def test_conv_transpose1d_grouped(groups):
    """k = 3, stride 2, padding 1 at groups 1, 2 and C (the depthwise pool of
    Kokoro's upsampling AdainResBlk1d): the bridge turns the JAX (O, K, I/g)
    weight into torch's (I, O/g, K) group by group. Same float32
    operations on both sides, so 1e-6."""
    rng = np.random.default_rng(10 + groups)
    j, p = _bridge(jl.ConvTranspose1d(8, 8, 3, stride=2, padding=1, groups=groups),
                   ConvTranspose1d(8, 8, 3, stride=2, padding=1, groups=groups,
                                   device="cpu"), rng)
    assert tuple(p.weight.shape) == (8, 8 // groups, 3)
    x = rng.standard_normal((2, 9, 8)).astype(np.float32)
    ref = np.asarray(j(jnp.asarray(x)))
    with torch.no_grad():
        out = p(torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape == (2, 17, 8)
    np.testing.assert_allclose(out, ref, atol=1e-6)


@pytest.mark.parametrize("masked", [False, True])
def test_instance_norm(masked):
    """Single-pass masked statistics in float32: with valid_len only the
    first valid_len positions of each row count, as in the JAX layer."""
    rng = np.random.default_rng(5)
    j, p = _bridge(jl.InstanceNorm(12), InstanceNorm(12, device="cpu"), rng)
    x = (rng.standard_normal((3, 20, 12)) * 2 + 0.5).astype(np.float32)
    vl = np.array([20, 7, 1], np.int32) if masked else None
    ref = np.asarray(j(jnp.asarray(x), None if vl is None else jnp.asarray(vl)))
    with torch.no_grad():
        out = p(torch.from_numpy(x), None if vl is None else torch.from_numpy(vl)).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL)


def test_instance_norm_bf16_without_affine():
    rng = np.random.default_rng(6)
    j, p = jl.InstanceNorm(16, affine=False), InstanceNorm(16, affine=False, device="cpu")
    x = rng.standard_normal((2, 30, 16)).astype(np.float32)
    vl = np.array([30, 11], np.int32)
    ref = np.asarray(j(jnp.asarray(x, jnp.bfloat16), jnp.asarray(vl)).astype(jnp.float32))
    with torch.no_grad():
        out = p(torch.from_numpy(x).bfloat16(), torch.from_numpy(vl))
    assert out.dtype == torch.bfloat16 and not list(p.parameters())
    # float32 statistics on both sides, one bf16 rounding of the output:
    # a summation-order difference may move it by one bf16 ulp (2^-7)
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=2 ** -7, atol=1e-6)


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
