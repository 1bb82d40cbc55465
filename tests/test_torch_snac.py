"""SNAC in the port against the JAX package on the CPU at tiny widths, with
the local attention: encoder codes identical; decode and
`decode_stream` within 1e-5 with the JAX package's noise draws passed in
(`noise_fn`; the port's own draws come from a torch generator, a
deliberate difference); weight-norm folding and `sanitize` on a torch-layout
checkpoint; Snake against the JAX function.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlx_audio_tpu.codec.models import base as jbase
from mlx_audio_tpu.codec.models.snac import SNAC as JaxSNAC
from mlx_audio_tpu.nn.activations import snake as jsnake
from mlx_audio_tpu.nn.module import flatten_params, load_weights
from mlx_audio_tpu_torch.codec.models import SNAC
from mlx_audio_tpu_torch.codec.models import base as pbase
from mlx_audio_tpu_torch.nn import load_jax_params
from mlx_audio_tpu_torch.nn.activations import snake

from test_torch_lm import numpy_init, one_torch_thread  # noqa: F401  (fixture)

ATOL = 1e-5
# the published 24 kHz model's features at tiny widths (three codebooks at
# strides 4, 2, 1, depthwise convolutions, noise blocks), with the local
# attention the 32/44 kHz models have
CONFIGS = {
    "tiny": dict(sampling_rate=24000, encoder_dim=16, encoder_rates=[2, 2],
                 decoder_dim=64, decoder_rates=[2, 2], attn_window_size=4,
                 codebook_size=64, codebook_dim=4, vq_strides=[4, 2, 1], noise=True,
                 depthwise=True),
}


# the JAX codec's calls, compiled once a shape (eager dispatch compiles every
# operation anew for each new shape)
_encode = jax.jit(lambda m, x: m.encode(x))
_decode = jax.jit(lambda m, c: m.decode(c))
_decode_stream = jax.jit(lambda m, c, ctx: m.decode_stream(c, ctx, context_frames=4))


def jax_noise(shape):
    """The JAX package's draw: jax.random.normal(PRNGKey(0)) for the shape."""
    return torch.from_numpy(np.array(jax.random.normal(jax.random.PRNGKey(0), shape)))


def _moved(jm, rng):
    flat = {}
    for k, v in flatten_params(jm).items():
        v = np.asarray(v, np.float32)
        if v.size and np.all(v == v.flat[0]):  # Snake's alpha, norms, biases
            v = v + 0.2 * np.abs(rng.standard_normal(v.shape)).astype(np.float32)
        flat[k] = v
    return load_weights(jm, {k: jnp.asarray(v) for k, v in flat.items()})


@pytest.fixture(scope="module", params=list(CONFIGS))
def pair(request):
    cfg = CONFIGS[request.param]
    with numpy_init():
        jm = _moved(JaxSNAC(**cfg), np.random.default_rng(0))
    pm = SNAC(**cfg, device="cpu")
    load_jax_params(pm, {k: np.asarray(v) for k, v in flatten_params(jm).items()})
    return jm, pm, cfg


def _audio(pm, seconds_frames=6, seed=1):
    n = pm.hop_length * 16 * seconds_frames
    return 0.3 * np.random.default_rng(seed).standard_normal((1, 1, n)).astype(np.float32)


def test_encode_codes_equal(pair):
    jm, pm, cfg = pair
    audio = _audio(pm)
    want = _encode(jm, jnp.asarray(audio))
    got = pm.encode(audio)
    assert len(got) == len(want) == len(pm.vq_strides)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_decode_with_the_jax_noise(pair):
    jm, pm, cfg = pair
    codes = _encode(jm, jnp.asarray(_audio(pm, seed=2)))
    want = np.asarray(_decode(jm, codes))
    got = pm.decode([np.asarray(c) for c in codes], noise_fn=jax_noise).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    # the port's own draws: a generator seeded 0 at every decode
    a, b = pm.decode([np.asarray(c) for c in codes]), pm.decode([np.asarray(c) for c in codes])
    assert torch.equal(a, b)


def test_decode_stream_with_the_jax_noise(pair):
    """Three chunks, each decoded with the previous chunk's codes as
    context; the new samples and the context equal the JAX package's."""
    jm, pm, cfg = pair
    codes = [np.asarray(c) for c in _encode(jm, jnp.asarray(_audio(pm, 9, seed=3)))]
    per = [c.shape[1] // 3 for c in codes]
    jctx = pctx = None
    for i in range(3):
        part = [c[:, i * p:(i + 1) * p] for c, p in zip(codes, per)]
        want, jctx = _decode_stream(jm, [jnp.asarray(p) for p in part], jctx)
        got, pctx = pm.decode_stream(part, pctx, context_frames=4, noise_fn=jax_noise)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)
        for g, w in zip(pctx, jctx):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_snake():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 5, 8)).astype(np.float32)
    a = np.abs(rng.standard_normal((1, 1, 8))).astype(np.float32) + 0.1
    np.testing.assert_allclose(snake(torch.as_tensor(x), torch.as_tensor(a)).numpy(),
                               np.asarray(jsnake(jnp.asarray(x), jnp.asarray(a))),
                               rtol=0, atol=1e-6)


def test_fold_weight_norm_pairs():
    """Conv (g of size-1 axes but the first) and transposed-conv (g over the
    middle axis) pairs, and torch's parametrize names, fold as in the JAX
    package."""
    rng = np.random.default_rng(5)
    w = {
        "a.weight_g": rng.random((4, 1, 1)).astype(np.float32),
        "a.weight_v": rng.standard_normal((4, 3, 5)).astype(np.float32),
        "b.weight_g": rng.random((1, 6, 1)).astype(np.float32),
        "b.weight_v": rng.standard_normal((3, 6, 2)).astype(np.float32),
        "c.parametrizations.weight.original0": rng.random((2, 1, 1)).astype(np.float32),
        "c.parametrizations.weight.original1": rng.standard_normal((2, 2, 3)).astype(np.float32),
        "c.bias": np.ones(2, np.float32),
    }
    want = jbase.fold_weight_norm_pairs(w)
    got = pbase.fold_weight_norm_pairs({k: torch.as_tensor(v) for k, v in w.items()})
    assert sorted(got) == sorted(want) == ["a.weight", "b.weight", "c.bias", "c.weight"]
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k], np.float32), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-7)


def test_sanitize_torch_checkpoint(pair):
    """A checkpoint in the upstream torch layout (convolutions (O, I, K),
    weight norm as g/v pairs): the port's `sanitize` gives the JAX
    package's, and the codec decodes the same."""
    jm, pm, cfg = pair
    torch_layout = {}
    for k, v in flatten_params(jm).items():
        v = np.asarray(v, np.float32)
        if k.endswith(".weight") and v.ndim == 3 and "alpha" not in k:
            v = np.ascontiguousarray(np.transpose(v, (0, 2, 1)))  # JAX (O, K, I) -> torch
            norm = np.sqrt((v ** 2).sum(axis=(1, 2), keepdims=True))
            torch_layout[k[:-len("weight")] + "weight_g"] = norm
            torch_layout[k[:-len("weight")] + "weight_v"] = v
        else:
            torch_layout[k] = v
    want = jm.sanitize(dict(torch_layout))
    got = pm.sanitize(dict(torch_layout))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]), rtol=1e-6,
                                   atol=1e-7, err_msg=k)
    fresh = SNAC(**cfg, device="cpu")
    load_jax_params(fresh, got)
    codes = [np.asarray(c) for c in _encode(jm, jnp.asarray(_audio(pm, seed=6)))]
    torch.testing.assert_close(fresh.decode(codes, noise_fn=jax_noise),
                               pm.decode(codes, noise_fn=jax_noise), rtol=0, atol=1e-6)

