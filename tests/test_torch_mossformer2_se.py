"""MossFormer2-SE in the port against the JAX package: every module of the
mask net, the ReLU² attention's plain version against the Pallas kernel in
interpret mode, and `Model.enhance` on its three routes.

Weights go across with load_jax_params after every JAX parameter, the
constant-initialised ones and the zero depthwise weights included, has been
moved by seeded noise, so no branch computes zeros. The JAX fbank's dither
draw (PRNGKey(0)) is fed into the port's fbank in place of its own.

Bars, all float32: 1e-5 for single layers and the ReLU² attention (the same
float32 products summed in other orders leave ~1e-6); 1e-4 for the mask net
and the FLASH layer, where rope tables and sinusoids computed by two
libraries differ in the last bit; the enhanced waveforms are held to
1e-4 of their peak (two FFT libraries, ~1e-6 relative). bf16 ReLU²
attention: 2 bf16 ulp at max|ref|, since the Pallas kernel multiplies by
1/group_size where the plain version divides, which can move a rounded
weight by one ulp.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from mlx_audio_tpu.nn import layers as jl
from mlx_audio_tpu.nn.module import flatten_params, load_weights
from mlx_audio_tpu.ops.pallas.relu2_attention import relu2_attention as jax_relu2
from mlx_audio_tpu.sts.models.mossformer2_se import Model as JaxModel
from mlx_audio_tpu.sts.models.mossformer2_se import MossFormer2SEConfig as JaxConfig
from mlx_audio_tpu.sts.models.mossformer2_se import mossformer2 as jm
from mlx_audio_tpu_torch import dsp
from mlx_audio_tpu_torch.nn import GroupNorm, load_jax_params
from mlx_audio_tpu_torch.ops.cuda.relu2_attention import (relu2_attention,
                                                          relu2_attention_reference,
                                                          scratch_elems)
from mlx_audio_tpu_torch.sts.models.mossformer2_se import Model
from mlx_audio_tpu_torch.sts.models.mossformer2_se import mossformer2 as pm

ATOL_LAYER = 1e-5
ATOL = 1e-4
WAVE_REL = 1e-4
TINY = dict(in_channels=12, out_channels=16, out_channels_final=961, num_blocks=1,
            num_mels=4)


def _moved(jax_module, rng, scale=0.1):
    """The JAX module with every parameter moved by seeded noise, and its
    flat numpy weights."""
    flat = {k: np.asarray(v) + rng.standard_normal(v.shape).astype(np.float32) * scale
            for k, v in flatten_params(jax_module).items()}
    return load_weights(jax_module, {k: jnp.asarray(v) for k, v in flat.items()}), flat


def _pair(jax_module, port_module, seed, scale=0.1):
    j, flat = _moved(jax_module, np.random.default_rng(seed), scale)
    return j, load_jax_params(port_module, flat)


def _same(j, p, x, atol=ATOL_LAYER):
    with torch.no_grad():
        out = p(torch.from_numpy(x))
    ref = j(jnp.asarray(x))
    if isinstance(ref, list):
        assert len(out) == len(ref)
        for o, r in zip(out, ref):
            np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=atol)
    else:
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=atol)


def _x(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# ---- norms and small layers ----


@pytest.mark.parametrize("name", ["ScaleNorm", "GlobalLayerNorm", "CLayerNorm",
                                  "ScaledSinuEmbedding", "OffsetScale"])
def test_small_layers(name):
    args = dict(OffsetScale=(24, 4)).get(name, (24,))
    j, p = _pair(getattr(jm, name)(*args), getattr(pm, name)(*args, device="cpu"), 1)
    _same(j, p, _x(2, 2, 37, 24) * 3)


@pytest.mark.parametrize("groups", [1, 4])
def test_group_norm(groups):
    j, p = _pair(jl.GroupNorm(groups, 24, eps=1e-8), GroupNorm(groups, 24, eps=1e-8,
                                                                device="cpu"), 3)
    _same(j, p, _x(4, 2, 37, 24) * 3 + 1)


def test_rope_rotate():
    x = _x(5, 2, 3, 300, 40)
    np.testing.assert_allclose(pm._rope_rotate(torch.from_numpy(x), 32).numpy(),
                               np.asarray(jm._rope_rotate(jnp.asarray(x), 32)), atol=ATOL)


@pytest.mark.parametrize("norm", ["scalenorm", "layernorm"])
def test_ffconvm_and_conv_module(norm):
    j, p = _pair(jm.FFConvM(12, 20, norm=norm), pm.FFConvM(12, 20, norm=norm, device="cpu"), 6)
    _same(j, p, _x(7, 2, 33, 12))
    j, p = _pair(jm.ConvModule(20), pm.ConvModule(20, device="cpu"), 8)
    _same(j, p, _x(9, 2, 33, 20))


@pytest.mark.parametrize("dims", [(16, 16), (16, 24)], ids=["residual", "projecting"])
def test_unideep_fsmn(dims):
    j, p = _pair(jm.UniDeepFsmn(*dims, lorder=5, hidden_size=20),
                 pm.UniDeepFsmn(*dims, lorder=5, hidden_size=20, device="cpu"), 10)
    _same(j, p, _x(11, 2, 40, dims[0]))


def test_gated_fsmn_block():
    j, p = _pair(jm.GatedFSMNBlock(16), pm.GatedFSMNBlock(16, device="cpu"), 12)
    _same(j, p, _x(13, 1, 50, 16))


def test_depthwise_weight_in_another_layout_fails_the_shape_check():
    _, flat = _moved(jm.ConvModule(20), np.random.default_rng(14))
    flat["weight"] = flat["weight"].transpose(0, 2, 1)  # torch's (C, 1, K)
    with pytest.raises(ValueError, match="Shape mismatch for weight"):
        load_jax_params(pm.ConvModule(20, device="cpu"), flat)


@pytest.mark.parametrize("n,causal", [(13, False), (13, True), (16, False), (29, True)],
                         ids=["ragged", "ragged_causal", "whole_groups", "three_groups_causal"])
def test_flash_layer(n, causal):
    kw = dict(group_size=8, query_key_dim=8, expansion_factor=4.0, causal=causal)
    j, p = _pair(jm.FlashShareAFFConvM(16, **kw), pm.FlashShareAFFConvM(16, device="cpu", **kw),
                 15 + n)
    _same(j, p, _x(16, 2, n, 16), atol=ATOL)


def test_mask_net():
    args = (12, 16, 31, 1)
    j, p = _pair(jm.MossFormerMaskNet(*args), pm.MossFormerMaskNet(*args, device="cpu"), 17)
    _same(j, p, _x(18, 1, 300, 12) * 2, atol=ATOL)


# ---- ReLU² attention ----


@pytest.mark.parametrize(
    "dtype,N,group_size",
    [("float32", 16, 16), ("bfloat16", 16, 16), ("float32", 13, None),
     ("bfloat16", 200, None), ("float32", 200, 256)],
    ids=["f32", "bf16", "f32_ragged13", "bf16_ragged200", "f32_ragged200_g256"])
def test_relu2_reference_matches_pallas_kernel(dtype, N, group_size):
    rng = np.random.default_rng(N)
    q, k = (rng.standard_normal((2, 3, N, 8)).astype(np.float32) for _ in range(2))
    v = rng.standard_normal((2, 3, N, 24)).astype(np.float32)
    jd = jnp.dtype(dtype)
    with pltpu.force_tpu_interpret_mode():
        ref = jax_relu2(*(jnp.asarray(a, jd) for a in (q, k, v)), group_size)
    td = getattr(torch, dtype)
    out = relu2_attention_reference(*(torch.from_numpy(a).to(td) for a in (q, k, v)),
                                    group_size)
    assert out.dtype == td and out.shape == (2, 3, N, 24)
    ref = np.asarray(ref.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(out.numpy(), ref, atol=ATOL_LAYER)
    else:
        ulp = 2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 7)
        np.testing.assert_allclose(out.float().numpy(), ref, atol=2 * ulp)


def test_relu2_reference_beyond_2048_matches_the_lax_path():
    """N > 2048: the JAX entry takes its einsum path; the port has one
    version for every N."""
    rng = np.random.default_rng(2100)
    q, k = (rng.standard_normal((1, 1, 2100, 8)).astype(np.float32) for _ in range(2))
    v = rng.standard_normal((1, 1, 2100, 16)).astype(np.float32)
    ref = jax_relu2(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 32)
    out = relu2_attention_reference(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v), 32)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL_LAYER, rtol=1e-5)


def test_cpu_call_launches_no_kernel():
    x = torch.from_numpy(_x(19, 1, 2, 16, 8))
    before = relu2_attention.launches
    out = relu2_attention(x, x, x, 16)
    assert relu2_attention.launches == before == 0
    np.testing.assert_array_equal(out.numpy(), relu2_attention_reference(x, x, x, 16).numpy())


@pytest.mark.parametrize("n,causal", [(13, False), (24, True), (29, False)],
                         ids=["ragged", "causal", "three_groups"])
def test_one_call_attention_equals_two_calls(n, causal, monkeypatch):
    """`_attention` takes v and u in one ReLU² call on the whole of v;u; per
    column that is the JAX package's two calls, one on v and one on u."""
    layer = pm.FlashShareAFFConvM(16, group_size=8, query_key_dim=8, causal=causal,
                                  device="cpu")
    rng = np.random.default_rng(40 + n)
    quad_q, lin_q, quad_k, lin_k = (torch.from_numpy(_x(41 + i, 2, n, 8)) for i in range(4))
    hidden = torch.from_numpy(rng.standard_normal((2, n, 64)).astype(np.float32))
    one = layer._attention(quad_q, lin_q, quad_k, lin_k, hidden)
    calls = []

    def two_calls(q, k, vu, g):
        calls.append(vu.shape[-1])
        E = vu.shape[-1] // 2
        return torch.cat([relu2_attention_reference(q, k, vu[..., :E], g),
                          relu2_attention_reference(q, k, vu[..., E:], g)], dim=-1)

    monkeypatch.setattr(pm, "relu2_attention", two_calls)
    two = layer._attention(quad_q, lin_q, quad_k, lin_k, hidden)
    assert calls == [64]
    for a, b in zip(one, two):
        assert a.shape == b.shape == (2, n, 32)
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-6 * b.abs().max().item())


def _two_pass_bf16(q, k, v, group_size):
    """The bf16 kernel's two passes in plain torch: the score pass writes
    bf16(relu(q·kᵀ / g)²) into a scratch of np × np weights (np = N rounded
    up to 64, zero past N), the PV pass sums the bf16 weights times v in
    float32 over the padded keys (v zero past N) and rounds to bf16."""
    B, G, N, _ = q.shape
    np_ = -(-N // 64) * 64
    sim = torch.matmul(q.float(), k.float().transpose(-1, -2)) / group_size
    p = torch.zeros(B, G, np_, np_, dtype=torch.bfloat16)
    p[:, :, :N, :N] = torch.relu(sim).square().to(torch.bfloat16)
    vp = torch.zeros(B, G, np_, v.shape[-1], dtype=torch.bfloat16)
    vp[:, :, :N] = v
    assert p.numel() == scratch_elems(B, G, N)
    return torch.matmul(p.float(), vp.float())[:, :, :N].to(torch.bfloat16)


@pytest.mark.parametrize("N,D,E,group_size", [(64, 32, 48, None), (200, 40, 24, None),
                                              (70, 16, 8, 256), (13, 8, 24, 16)],
                         ids=["n64", "ragged200_d40", "ragged70_g256", "ragged13"])
def test_relu2_bf16_two_passes_match_jax(N, D, E, group_size):
    """The bf16 path's arithmetic (weights rounded to bf16 before PV, the
    scratch padded to 64 keys) and the plain version against the Pallas
    kernel in interpret mode in bf16, within 2 bf16 ulp at max|ref| (JAX multiplies by
    1/group_size where the port divides)."""
    rng = np.random.default_rng(300 + N + D)
    q, k = (rng.standard_normal((1, 2, N, D)).astype(np.float32) for _ in range(2))
    v = rng.standard_normal((1, 2, N, E)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jax_relu2(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                                   group_size).astype(jnp.float32))
    tq, tk, tv = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    g = N if group_size is None else group_size
    ulp = 2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 7)
    for out in (_two_pass_bf16(tq, tk, tv, g), relu2_attention_reference(tq, tk, tv, group_size)):
        assert out.dtype == torch.bfloat16 and out.shape == (1, 2, N, E)
        np.testing.assert_allclose(out.float().numpy(), ref, atol=2 * ulp)


@pytest.mark.parametrize("B,G,N,want", [(1, 10, 256, 10 * 256 * 256), (1, 1, 2500, 2560 ** 2),
                                        (2, 3, 13, 6 * 64 * 64)])
def test_relu2_scratch_pads_n_to_64(B, G, N, want):
    assert scratch_elems(B, G, N) == want


# ---- the enhancer ----


@pytest.fixture(scope="module")
def tiny_weights():
    return _moved(JaxModel(JaxConfig(**TINY)), np.random.default_rng(20))[1]


def _jax_dither(shape, device):
    return torch.from_numpy(np.array(jax.random.normal(jax.random.PRNGKey(0),
                                                         tuple(shape)))).to(device)


@pytest.mark.parametrize(
    "seconds,extra,chunked",
    [(1.0, {}, None),
     (3.0, dict(one_time_decode_length=1, decode_window=1), False),
     (2.5, dict(chunk_seconds=1.0), True)],
    ids=["one_shot", "segmented", "chunked"])
def test_enhance_matches_jax(tiny_weights, monkeypatch, seconds, extra, chunked):
    cfg = {**TINY, **extra}
    jmodel = load_weights(JaxModel(JaxConfig(**cfg)),
                          {k: jnp.asarray(v) for k, v in tiny_weights.items()})
    pmodel = load_jax_params(Model(cfg, device="cpu"), tiny_weights)
    monkeypatch.setattr(dsp, "kaldi_dither", _jax_dither)
    audio = _x(21, int(48000 * seconds)) * 0.05
    ref = np.asarray(jmodel.enhance(audio, chunked=chunked))
    out = pmodel.enhance(audio, chunked=chunked)
    assert out.shape == ref.shape == audio.shape and out.dtype == ref.dtype
    np.testing.assert_allclose(out, ref, atol=WAVE_REL * np.abs(ref).max())
    assert np.abs(ref - audio).max() > 10 * WAVE_REL * np.abs(ref).max()  # it did enhance


def test_enhance_takes_audio_input(tiny_weights, monkeypatch):
    """`enhance(audio_input=...)`, the upstream parameter name, as in the JAX
    package, gives what `enhance(audio)` gives."""
    jmodel = load_weights(JaxModel(JaxConfig(**TINY)),
                          {k: jnp.asarray(v) for k, v in tiny_weights.items()})
    pmodel = load_jax_params(Model(TINY, device="cpu"), tiny_weights)
    monkeypatch.setattr(dsp, "kaldi_dither", _jax_dither)
    audio = _x(23, 48000) * 0.05
    ref = np.asarray(jmodel.enhance(audio_input=audio))
    out = pmodel.enhance(audio_input=audio)
    np.testing.assert_array_equal(out, pmodel.enhance(audio))
    np.testing.assert_allclose(out, ref, atol=WAVE_REL * np.abs(ref).max())


def test_sanitize_matches_jax():
    rng = np.random.default_rng(22)
    weights = {
        "mossformer.norm.weight": rng.standard_normal((180, 1)),
        "model.mossformer.prelu.weight": rng.standard_normal((1,)),
        "mossformer.mdl.intra_mdl.mossformerM.fsmn.0.gated_fsmn.fsmn.conv1.weight":
            rng.standard_normal((256, 39, 1, 1)),
        "net.model.mossformer.mdl.intra_mdl.mossformerM.layers.0.to_qk.conv_module.conv.weight":
            rng.standard_normal((128, 17, 1)),
    }
    ref = JaxModel(JaxConfig(**TINY)).sanitize(dict(weights))
    out = Model(TINY, device="cpu").sanitize(dict(weights))
    assert list(out) == list(ref)
    for key in ref:
        np.testing.assert_array_equal(out[key], ref[key])
