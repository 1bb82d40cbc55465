"""The port's LSTM and BiLSTM (torch's fused LSTM operator) against the JAX
package's `lax.scan` LSTMs, on weights carried across by load_jax_params.

f32 bar 1e-5 of the output's peak: both sides run the same float32 gate
arithmetic, step by step; only the summation order of the two gate
products differs.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from mlx_audio_tpu.nn import recurrent as jr
from mlx_audio_tpu.nn.module import flatten_params
from mlx_audio_tpu_torch.nn import BiLSTM, LSTM, load_jax_params

REL = 1e-5
VALID = np.array([9, 4, 1], np.int32)  # ragged rows of a batch padded to T = 9


def _bridge(jax_layer, port_layer, rng):
    for name, val in flatten_params(jax_layer).items():
        setattr_path(jax_layer, name,
                     jnp.asarray(rng.standard_normal(val.shape).astype(np.float32) * 0.4))
    load_jax_params(port_layer, {k: np.asarray(v) for k, v in flatten_params(jax_layer).items()})
    return jax_layer, port_layer


def setattr_path(obj, dotted, val):
    *path, last = dotted.split(".")
    for p in path:
        obj = getattr(obj, p)
    setattr(obj, last, val)


def _close(out, ref):
    out = np.asarray(out, np.float32)
    ref = np.asarray(ref, np.float32)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=REL * np.abs(ref).max())


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_lstm(reverse, masked):
    rng = np.random.default_rng(0)
    j, p = _bridge(jr.LSTM(6, 5), LSTM(6, 5, device="cpu"), rng)
    x = rng.standard_normal((3, 9, 6)).astype(np.float32)
    h0 = rng.standard_normal((3, 5)).astype(np.float32) * 0.5
    c0 = rng.standard_normal((3, 5)).astype(np.float32) * 0.5
    vl = VALID if masked else None
    ref, (rh, rc) = j(jnp.asarray(x), (jnp.asarray(h0), jnp.asarray(c0)), reverse=reverse,
                      valid_len=None if vl is None else jnp.asarray(vl))
    with torch.no_grad():
        out, (h, c) = p(torch.from_numpy(x), (torch.from_numpy(h0), torch.from_numpy(c0)),
                        reverse=reverse, valid_len=None if vl is None else torch.from_numpy(vl))
    _close(out, ref)
    _close(h, rh)
    _close(c, rc)


@pytest.mark.parametrize("masked", [False, True])
def test_bilstm(masked):
    """The reversed direction starts at each row's last valid step and
    emits zeros on the padding; the forward one runs over everything."""
    rng = np.random.default_rng(1)
    j, p = _bridge(jr.BiLSTM(8, 4), BiLSTM(8, 4, device="cpu"), rng)
    assert {n for n, _ in p.named_parameters()} == set(flatten_params(j))
    x = rng.standard_normal((3, 9, 8)).astype(np.float32)
    vl = VALID if masked else None
    ref = j(jnp.asarray(x), valid_len=None if vl is None else jnp.asarray(vl))
    with torch.no_grad():
        out = p(torch.from_numpy(x), valid_len=None if vl is None else torch.from_numpy(vl))
    _close(out, ref)
    if masked:
        assert not out[1, 4:, 4:].any() and not out[2, 1:, 4:].any()


def test_bilstm_bf16():
    """bf16 weights and input: the JAX scan keeps h and c in bf16 and rounds
    at every op; torch's operator rounds its own way. Bar: 2 % of the
    output's peak over 9 steps."""
    rng = np.random.default_rng(2)
    j, p = _bridge(jr.BiLSTM(8, 4), BiLSTM(8, 4, device="cpu"), rng)
    x = rng.standard_normal((2, 9, 8)).astype(np.float32)
    vl = VALID[:2]
    from mlx_audio_tpu.nn.module import cast_floats as jcast
    from mlx_audio_tpu_torch.nn import cast_floats

    ref = jcast(j)(jnp.asarray(x, jnp.bfloat16), valid_len=jnp.asarray(vl))
    with torch.no_grad():
        out = cast_floats(p)(torch.from_numpy(x).bfloat16(), valid_len=torch.from_numpy(vl))
    assert out.dtype == torch.bfloat16
    ref = np.asarray(ref.astype(jnp.float32))
    np.testing.assert_allclose(out.float().numpy(), ref, atol=0.02 * np.abs(ref).max())
