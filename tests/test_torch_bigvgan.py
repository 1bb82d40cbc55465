"""BigVGAN in the port against the JAX package on the CPU at tiny widths: the
kaiser-sinc filters, Snake and SnakeBeta (plain and log-scale), the
anti-aliasing up- and downsampling and `Activation1d`, `AMPBlock1` and
`AMPBlock2`, a whole BigVGAN of each block type, and `sanitize` from a
checkpoint in PyTorch's layout with weight-norm pairs, anti-aliasing
filters and BatchNorm counters.

The port runs the generator channels-first, so its pieces take (B, C, T)
where the JAX package's take (B, T, C); the whole model takes the JAX
package's (B, T, num_mels). Weights go across with `load_jax_params`,
every constant-initialised parameter moved off its constant first.
float32 bar: 1e-5 of each output's peak."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlx_audio_tpu.codec.models.bigvgan import bigvgan as jb
from mlx_audio_tpu.nn.module import flatten_params
from mlx_audio_tpu_torch.codec.models.bigvgan import bigvgan as pb
from mlx_audio_tpu_torch.nn import load_jax_params
from mlx_audio_tpu_torch.nn.module import init_weights

from test_torch_lm import _moved, numpy_init, one_torch_thread  # noqa: F401  (fixture)

BAR = 1e-5
TINY = dict(num_mels=8, upsample_rates=[4, 2], upsample_kernel_sizes=[8, 4],
            upsample_initial_channel=16, resblock_kernel_sizes=[3, 5],
            resblock_dilation_sizes=[[1, 2], [1, 3]], activation="snakebeta",
            snake_logscale=True)

_jit_call = jax.jit(lambda m, x: m(x))


def _close(got, want, bar=BAR):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    peak = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= bar * peak, f"max|d| {err:.3e} > {bar:g} of the peak {peak:.3e}"


def _carry(jm, pm, seed=0):
    jm = _moved(jm, np.random.default_rng(seed))
    load_jax_params(pm, {k: np.asarray(v) for k, v in flatten_params(jm).items()})
    return jm


def _run_cf(jm, pm, x):
    """The JAX module on channels-last x, the port's on its channels-first
    transpose → (JAX output, the port's transposed back)."""
    want = _jit_call(jm, jnp.asarray(x))
    with torch.no_grad():
        got = pm(torch.from_numpy(x).transpose(1, 2)).transpose(1, 2)
    return got.numpy(), np.array(want)


@pytest.mark.parametrize("args", [(0.25, 0.3, 12), (0.5 / 3, 0.2, 18), (0.2, 0.1, 7),
                                  (0.0, 0.3, 12), (0.45, 0.02, 8)])
def test_kaiser_sinc_filters(args):
    """Even and odd lengths, the three kaiser-beta branches, a zero cutoff."""
    want = jb._kaiser_sinc_filter1d(*args)  # (1, K, 1)
    got = pb._kaiser_sinc_filter1d(*args)  # (1, 1, K)
    np.testing.assert_array_equal(got[0, 0], want[0, :, 0])


@pytest.mark.parametrize("cls", ["Snake", "SnakeBeta"])
@pytest.mark.parametrize("logscale", [False, True])
def test_snake_activations(cls, logscale):
    jm = getattr(jb, cls)(6, alpha_logscale=logscale)
    pm = getattr(pb, cls)(6, alpha_logscale=logscale, device="cpu")
    init_weights(torch.nn.Sequential(pm), None)
    np.testing.assert_array_equal(pm.alpha.detach().numpy(), np.asarray(jm.alpha))
    jm = _carry(jm, pm, seed=1)
    x = np.random.default_rng(2).standard_normal((2, 11, 6)).astype(np.float32) * 2
    _close(*_run_cf(jm, pm, x))


@pytest.mark.parametrize("ratio", [2, 3])
def test_up_and_down_sampling(ratio):
    """The edge pad, the depthwise transposed convolution with its gain and
    crop, and the strided lowpass; lengths L·ratio and L back."""
    x = np.random.default_rng(ratio).standard_normal((2, 13, 5)).astype(np.float32)
    got, want = _run_cf(jb.UpSample1d(ratio), pb.UpSample1d(ratio, device="cpu"), x)
    assert got.shape == (2, 13 * ratio, 5)
    _close(got, want)
    got, want = _run_cf(jb.DownSample1d(ratio), pb.DownSample1d(ratio, device="cpu"),
                        np.asarray(want))
    assert got.shape == (2, 13, 5)
    _close(got, want)


def test_activation1d():
    jm = jb.Activation1d(jb.SnakeBeta(5, alpha_logscale=True))
    pm = pb.Activation1d(pb.SnakeBeta(5, alpha_logscale=True, device="cpu"), device="cpu")
    jm = _carry(jm, pm, seed=3)
    x = np.random.default_rng(4).standard_normal((1, 17, 5)).astype(np.float32)
    _close(*_run_cf(jm, pm, x))


@pytest.mark.parametrize("block", ["AMPBlock1", "AMPBlock2"])
def test_amp_blocks(block):
    with numpy_init(5):
        jm = getattr(jb, block)(8, True, "snakebeta", kernel_size=3, dilation=[1, 3])
    pm = getattr(pb, block)(8, True, "snakebeta", kernel_size=3, dilation=[1, 3],
                            device="cpu")
    jm = _carry(jm, pm, seed=6)
    x = np.random.default_rng(7).standard_normal((2, 19, 8)).astype(np.float32)
    _close(*_run_cf(jm, pm, x))


def _bigvgan(seed, **over):
    cfg = dict(TINY, **over)
    with numpy_init(seed):
        jm = jb.BigVGAN(jb.BigVGANConfig(**cfg))
    pm = pb.BigVGAN(cfg, device="cpu")
    return _carry(jm, pm, seed), pm


@pytest.mark.parametrize("over", [dict(resblock="1"), dict(resblock="2", activation="snake"),
                                  dict(use_tanh_at_final=False, use_bias_at_final=False)])
def test_bigvgan(over):
    jm, pm = _bigvgan(8, **over)
    mel = np.random.default_rng(9).standard_normal((2, 9, 8)).astype(np.float32)
    want = _jit_call(jm, jnp.asarray(mel))
    with torch.no_grad():
        got = pm.decode(torch.from_numpy(mel))
    assert tuple(got.shape) == (2, 9 * 8, 1)
    _close(got.numpy(), want)


def test_sanitize_folds_weight_norm_and_drops_filters():
    """A checkpoint in PyTorch's layout (convolutions (O, I, K), transposed
    ones (I, O, K)), every conv weight a weight-norm pair, with the
    anti-aliasing filters and BatchNorm counters beside them: the port's
    `sanitize` gives the JAX package's keys, and the loaded model its
    output."""
    jm, _ = _bigvgan(10)
    flat = {k: np.asarray(v) for k, v in flatten_params(jm).items()}
    ckpt = {}
    for k, v in flat.items():
        if k.endswith(".weight") and v.ndim == 3:
            up = k.startswith("ups.")  # a transposed conv: (I, O, K), g over O
            t = v.transpose(2, 0, 1) if up else v.transpose(0, 2, 1)
            g = np.sqrt((t ** 2).sum(axis=(0, 2) if up else (1, 2), keepdims=True))
            ckpt[k[:-len("weight")] + "weight_g"] = g
            ckpt[k[:-len("weight")] + "weight_v"] = t * 1.5
        else:
            ckpt[k] = v
    ckpt["resblocks.0.activations.0.upsample.filter"] = np.zeros((1, 1, 12), np.float32)
    ckpt["resblocks.0.activations.0.downsample.lowpass.filter"] = np.zeros((1, 1, 12),
                                                                           np.float32)
    ckpt["activation_post.num_batches_tracked"] = np.zeros((), np.int64)
    pm = pb.BigVGAN(TINY, device="cpu")
    out = pm.sanitize(dict(ckpt))
    assert sorted(out) == sorted(flat)
    load_jax_params(pm, out)
    mel = np.random.default_rng(11).standard_normal((1, 7, 8)).astype(np.float32)
    with torch.no_grad():
        got = pm(torch.from_numpy(mel))
    _close(got.numpy(), _jit_call(jm, jnp.asarray(mel)))
