"""The port's quantized layers and the plain versions of its three quantized
kernels against the JAX package.

Packing and quantization are bit-exact. Layers run in float32 on the CPU,
where both packages take dequantize + matmul; bar 1e-5, the summation order
being the only difference. The plain versions follow the TPU kernels'
formula (sum of x·q·s plus per-group sums of x times the biases) and are
held to the Pallas kernels run in interpret mode at 1e-4, the bar
`tests/test_pallas.py` holds those kernels to against dequantize + matmul.
The routing guard is held to the JAX decisions at the full-width shapes of
Qwen3-TTS 0.6B, with `pallas_enabled` patched to True.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import mlx_audio_tpu.ops.pallas as jax_pallas
import mlx_audio_tpu.ops.pallas.quant_matmul as jax_qmm
from mlx_audio_tpu.nn import layers as jl
from mlx_audio_tpu.nn import quantized as jq
from mlx_audio_tpu.nn.module import flatten_params
from mlx_audio_tpu_torch.nn import Embedding, Linear, load_jax_params
from mlx_audio_tpu_torch.nn import quantized as pq
from mlx_audio_tpu_torch.ops.cuda import quant_matmul as pk

ATOL = 1e-5
KERNEL_ATOL = 1e-4


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("bits", [2, 3, 4, 6, 8])
def test_pack_unpack_bit_exact(bits):
    rng = np.random.default_rng(bits)
    q = rng.integers(0, 2 ** bits, (5, 96)).astype(np.float32)
    ref = jq._pack_rows(q, bits)
    got = pq._pack_rows(torch.from_numpy(q), bits).numpy()
    if bits in (3, 6):
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, ref)
    else:
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got.view(np.uint32), ref)
    unpacked = pq.unpack_rows(torch.from_numpy(got), bits).numpy()
    np.testing.assert_array_equal(unpacked, np.asarray(jq.unpack_rows(jnp.asarray(ref), bits)))
    np.testing.assert_array_equal(unpacked, q.astype(np.int64))


@pytest.mark.parametrize("bits,group_size", [(2, 32), (3, 64), (4, 64), (6, 64), (8, 32)])
def test_quantize_dequantize_match(bits, group_size):
    rng = np.random.default_rng(10 + bits)
    w = rng.standard_normal((24, 128)).astype(np.float32) * 0.2
    jp, js, jb = jq.quantize_arrays(w, group_size, bits)
    pp, ps, pb = pq.quantize_arrays(torch.from_numpy(w), group_size, bits)
    got = pp.numpy().view(np.uint32) if pp.dtype == torch.int32 else pp.numpy()
    np.testing.assert_array_equal(got, jp)
    np.testing.assert_array_equal(ps.numpy(), js)
    np.testing.assert_array_equal(pb.numpy(), jb)
    jd = np.asarray(jq.dequantize_arrays(jnp.asarray(jp), jnp.asarray(js), jnp.asarray(jb),
                                         group_size, bits))
    pd = pq.dequantize_arrays(pp, ps, pb, group_size, bits).numpy()
    np.testing.assert_array_equal(pd, jd)


def _bridge(jax_layer, port_layer):
    flat = {k: np.asarray(v) for k, v in flatten_params(jax_layer).items()}
    load_jax_params(port_layer, flat)
    return port_layer


@pytest.mark.parametrize("bits", [4, 6, 8])
def test_quantized_linear_matches(bits):
    rng = np.random.default_rng(20 + bits)
    lin = jl.Linear(128, 48)
    lin.weight = jnp.asarray(rng.standard_normal((48, 128)).astype(np.float32) * 0.1)
    lin.bias = jnp.asarray(rng.standard_normal(48).astype(np.float32))
    jql = jq.QuantizedLinear.from_linear(lin, 64, bits)
    pql = _bridge(jql, pq.QuantizedLinear(128, 48, bias=True, group_size=64, bits=bits,
                                          device="cpu"))
    x = rng.standard_normal((3, 5, 128)).astype(np.float32)
    with torch.no_grad():
        out = pql(_t(x)).numpy()
    np.testing.assert_allclose(out, np.asarray(jql(jnp.asarray(x))), atol=ATOL)


def test_quantized_fused_linear_mixed_bias_matches():
    """q (bias), k (no bias), v (bias) row-stacked: the missing bias is
    zero-filled, and each split equals its sibling."""
    rng = np.random.default_rng(30)
    jlins, plins = [], []
    for n_out, bias in ((64, True), (32, False), (32, True)):
        lin = jl.Linear(64, n_out, bias=bias)
        lin.weight = jnp.asarray(rng.standard_normal((n_out, 64)).astype(np.float32) * 0.1)
        if bias:
            lin.bias = jnp.asarray(rng.standard_normal(n_out).astype(np.float32))
        jql = jq.QuantizedLinear.from_linear(lin, 64, 4)
        jlins.append(jql)
        plins.append(_bridge(jql, pq.QuantizedLinear(64, n_out, bias=bias, device="cpu")))
    jf = jq.QuantizedFusedLinear.from_siblings(jlins)
    pf = pq.QuantizedFusedLinear.from_siblings(plins)
    assert pf.split_sizes == (64, 32, 32)
    np.testing.assert_array_equal(pf.bias.detach().numpy(), np.asarray(jf.bias))
    x = rng.standard_normal((2, 64)).astype(np.float32)
    with torch.no_grad():
        outs = pf(_t(x))
    for o, r, sib in zip(outs, jf(jnp.asarray(x)), plins):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=ATOL)
        with torch.no_grad():
            np.testing.assert_allclose(o.numpy(), sib(_t(x)).numpy(), atol=ATOL)


def test_quantized_embedding_matches():
    rng = np.random.default_rng(40)
    emb = jl.Embedding(40, 128)
    jqe = jq.QuantizedEmbedding.from_embedding(emb, 64, 4)
    pqe = _bridge(jqe, pq.QuantizedEmbedding(40, 128, device="cpu"))
    ids = rng.integers(0, 40, (2, 7))
    with torch.no_grad():
        np.testing.assert_allclose(pqe(_t(ids)).numpy(), np.asarray(jqe(jnp.asarray(ids))),
                                   atol=ATOL)
        x = rng.standard_normal((3, 128)).astype(np.float32)
        np.testing.assert_allclose(pqe.as_linear(_t(x)).numpy(),
                                   np.asarray(jqe.as_linear(jnp.asarray(x))), atol=ATOL)


def test_quantize_module_and_fuse():
    """quantize_module's predicate sees the same dotted paths as the JAX
    package's, and fuse_quantized_projections row-stacks the declared
    groups and removes the siblings."""
    from mlx_audio_tpu_torch.tts.models.qwen3_tts.talker import TalkerDecoderLayer
    from mlx_audio_tpu_torch.tts.models.qwen3_tts.config import Qwen3TTSTalkerConfig

    cfg = Qwen3TTSTalkerConfig(hidden_size=64, intermediate_size=128,
                               num_attention_heads=4, num_key_value_heads=2, head_dim=16)
    layer = torch.nn.ModuleDict({"a": TalkerDecoderLayer(cfg, device="cpu"),
                                 "head": Linear(64, 32, device="cpu"),
                                 "emb": Embedding(10, 64, device="cpu")})
    seen = []

    def predicate(path, m):
        seen.append(path)
        return path != "head"

    pq.quantize_module(layer, bits=4, predicate=predicate)
    assert "a.self_attn.q_proj" in seen and "a.mlp.down_proj" in seen and "emb" in seen
    assert isinstance(layer["head"], Linear)
    assert isinstance(layer["emb"], pq.QuantizedEmbedding)
    assert pq.fuse_quantized_projections(layer) == 2
    attn, mlp = layer["a"].self_attn, layer["a"].mlp
    assert not hasattr(attn, "q_proj") and attn.qkv_fused.split_sizes == (64, 32, 32)
    assert not hasattr(mlp, "gate_proj") and mlp.gate_up_fused.split_sizes == (128, 128)


# (bits, N, K, M): Qwen3-TTS 0.6B's quantized projections at the M the path
# gives them, edge cases of each rule, and the 8-bit GEMV
GUARD_SHAPES = [
    (4, 4096, 1024, 1), (4, 1024, 2048, 1), (4, 3072, 1024, 1), (4, 6144, 1024, 2),
    (4, 1024, 3072, 32), (4, 2048, 2048, 336), (4, 1024, 2048, 336), (4, 2048, 2048, 3),
    (4, 1536, 512, 256), (4, 512, 512, 256), (4, 512, 512, 1), (4, 2048, 512, 256),
    (4, 4096, 1024, 512), (4, 4096, 1024, 1024), (4, 1024, 4096, 512), (4, 1000, 1024, 1),
    (4, 384, 1024, 1), (4, 200, 1024, 4), (4, 1024, 1024, 2000), (6, 4096, 1024, 1),
    (6, 1024, 3072, 32), (6, 1024, 4096, 512), (8, 4096, 1024, 1), (8, 4096, 1024, 2),
    (2, 4096, 1024, 1), (3, 4096, 1024, 1),
]


@pytest.mark.parametrize("bits,N,K,M", GUARD_SHAPES)
def test_routing_guard_matches_jax(monkeypatch, bits, N, K, M):
    monkeypatch.setattr(jax_pallas, "pallas_enabled", lambda: True)
    jql = jq.QuantizedLinear(K, N, bits=bits)
    assert pq.qmm_routable(bits, 64, N, K, M) == jql._pallas_routable(jnp.zeros((M, K)))


# (bits, K, I, N, M)
MLP_SHAPES = [(4, 1024, 3072, 1024, 1), (4, 1024, 3072, 1024, 2), (4, 1024, 3072, 1024, 16),
              (4, 1024, 3072, 1024, 17), (4, 1024, 3072, 1024, 32), (4, 512, 1024, 512, 256),
              (4, 1024, 1536, 1024, 1), (8, 1024, 3072, 1024, 1), (4, 1024, 3072, 1000, 1),
              (4, 1024, 3072, 384, 1), (6, 1024, 3072, 1024, 1)]


@pytest.mark.parametrize("bits,K,I,N,M", MLP_SHAPES)
def test_fused_mlp_guard_matches_jax(monkeypatch, bits, K, I, N, M):
    monkeypatch.setattr(jax_pallas, "pallas_enabled", lambda: True)
    monkeypatch.setattr(jax_qmm, "quantized_mlp", lambda *a, **k: "routed")
    gu = [jq.QuantizedLinear(K, I, bias=False, bits=bits) for _ in range(2)]
    fused = jq.QuantizedFusedLinear.from_siblings(gu)
    down = jq.QuantizedLinear(I, N, bias=False, bits=bits)
    routed = jq.fused_mlp_call(fused, down, jnp.zeros((M, K))) == "routed"
    assert pq.fused_mlp_routable(bits, 64, K, I, N, M) == routed


def _qweights(rng, N, K, bits, gs=64):
    w = rng.standard_normal((N, K)).astype(np.float32) * 0.05
    return jq.quantize_arrays(w, gs, bits)


def _port_w(p):
    return torch.from_numpy(p.view(np.int32) if p.dtype == np.uint32 else p)


@pytest.mark.parametrize("bits,N,K,M", [(4, 512, 256, 4), (4, 700, 256, 3), (8, 256, 128, 2),
                                        (6, 512, 256, 4), (6, 600, 128, 2)])
def test_qmm_plain_matches_pallas(bits, N, K, M):
    """quantized_matmul (4/8-bit, ragged N = 700) and quantized_matmul6
    (ragged N = 600): the plain version, which a CPU tensor takes, against
    the Pallas kernel in interpret mode."""
    rng = np.random.default_rng(50 + bits + N)
    packed, scales, biases = _qweights(rng, N, K, bits)
    x = rng.standard_normal((M, K)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        ref = jax_qmm.quantized_matmul(jnp.asarray(x), jnp.asarray(packed), jnp.asarray(scales),
                                       jnp.asarray(biases), bits=bits, group_size=64)
    before = (pk.quantized_matmul.launches, pk.quantized_matmul6.launches)
    out = pk.quantized_matmul(_t(x), _port_w(packed), _t(scales), _t(biases), bits=bits,
                              group_size=64)
    assert (pk.quantized_matmul.launches, pk.quantized_matmul6.launches) == before
    assert tuple(out.shape) == (M, N)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=KERNEL_ATOL)


@pytest.mark.parametrize("bits,M,N", [(4, 1, 256), (4, 4, 640), (8, 2, 256)])
def test_qmlp_plain_matches_pallas(bits, M, N):
    """The fused SwiGLU's plain version against `quantized_mlp` in interpret
    mode (N = 640 is ragged against the 512-row down block)."""
    rng = np.random.default_rng(60 + bits + M)
    per = 32 // bits
    K, I = 128, per * 128
    pg, sg, bg = _qweights(rng, 2 * I, K, bits)
    pd, sd, bd = _qweights(rng, N, I, bits)
    x = rng.standard_normal((M, K)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        ref = jax_qmm.quantized_mlp(jnp.asarray(x), *(jnp.asarray(a) for a in
                                                      (pg, sg, bg, pd, sd, bd)),
                                    bits=bits, group_size=64)
    out = pk.quantized_mlp(_t(x), _port_w(pg), _t(sg), _t(bg), _port_w(pd), _t(sd), _t(bd),
                           bits=bits, group_size=64)
    assert pk.quantized_mlp.launches == 0
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=KERNEL_ATOL)


def test_plain_versions_keep_bf16_output_and_f32_sums():
    """bf16 in, bf16 out, sums in float32: the plain version equals the
    float32 result rounded once."""
    rng = np.random.default_rng(70)
    packed, scales, biases = _qweights(rng, 256, 128, 4)
    x = torch.from_numpy(rng.standard_normal((2, 128)).astype(np.float32)).bfloat16()
    out = pk.quantized_matmul(x, _port_w(packed), _t(scales), _t(biases))
    ref = pk.quantized_matmul(x.float(), _port_w(packed), _t(scales), _t(biases))
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, ref.bfloat16())


# ---- the tensor-core GEMM's arithmetic (M > 4: qmm_mma) ----
#
# The kernel feeds the integer codes to bf16 tensor-core products, sums x·q
# over each group, then folds y += s·Σ(x·q) + b·Σx; float32 x goes in as
# three bf16 parts. These tests hold that arithmetic, written as plain torch,
# to the JAX package's kernels.


@pytest.mark.parametrize("bits", [4, 6, 8])
def test_every_code_is_exact_in_bf16(bits):
    q = torch.arange(2 ** bits, dtype=torch.int32)
    assert torch.equal(q.to(torch.bfloat16).to(torch.int32), q)
    if bits < 8:
        # the kernel's conversion: the code or-ed under bf16's 128.0 (0x4300),
        # less 128
        magic = (q.to(torch.int16) | 0x4300).view(torch.bfloat16)
        assert torch.equal((magic - 128).to(torch.int32), q)


def _split3(x):
    """float32 → three bf16 parts, as the kernel splits float32 x."""
    hi = x.to(torch.bfloat16)
    r = x - hi.float()
    mid = r.to(torch.bfloat16)
    return hi, mid, (r - mid.float()).to(torch.bfloat16)


def test_three_way_bf16_split_sums_back_to_x():
    """hi + mid + lo == x exactly for every float32 of magnitude at least
    2^-110 (large, small and tiny values) and for subnormals on bf16's own
    grid (multiples of 2^-133); below that the parts lose what lies under
    bf16's smallest step, at most 2^-134."""
    rng = np.random.default_rng(90)
    mant = rng.uniform(1.0, 2.0, 4000)
    exps = rng.integers(-110, 127, 4000)
    normal = (rng.choice([-1.0, 1.0], 4000) * mant * np.exp2(exps.astype(np.float64)))
    grid_sub = rng.integers(-(2 ** 7) + 1, 2 ** 7, 200) * 2.0 ** -133
    x = torch.from_numpy(np.concatenate([normal, grid_sub, [0.0, 3.3e38, -3.3e38, 2.0 ** -110]])
                         .astype(np.float32))
    hi, mid, lo = _split3(x)
    assert torch.equal((hi.float() + mid.float()) + lo.float(), x)
    tiny = torch.from_numpy(rng.uniform(-2.0 ** -110, 2.0 ** -110, 1000).astype(np.float32))
    tiny = torch.cat([tiny, torch.tensor([2.0 ** -149, 1e-40, -7e-45])])
    hi, mid, lo = _split3(tiny)
    err = ((hi.float() + mid.float()) + lo.float() - tiny).abs()
    assert err.max().item() <= 2.0 ** -134


def _mma_arithmetic(x, q, scales, biases, group_size):
    """The kernel's factored sum in plain torch: per-group products of the
    bf16 parts of x with the integer codes, scaled once a group, plus the
    biases times the per-group sums of x."""
    M, K = x.shape
    N, G = scales.shape
    parts = _split3(x) if x.dtype == torch.float32 else (x,)
    qg = q.float().reshape(N, G, group_size)
    gacc = sum(torch.einsum("mgk,ngk->mng", p.float().reshape(M, G, group_size), qg)
               for p in parts)
    xg = x.float().reshape(M, G, group_size).sum(-1)
    return (gacc * scales[None]).sum(-1) + xg @ biases.T


@pytest.mark.parametrize("bits,group_size", [(4, 32), (4, 64), (4, 128), (6, 32), (6, 64),
                                             (6, 128), (8, 64), (8, 128)])
def test_mma_arithmetic_matches_pallas(bits, group_size):
    """M = 37 and N = 1000 (both ragged against the kernel's tiles), float32
    x split three ways, against `quantized_matmul` in interpret mode, at the
    kernel's float32 bar on the card: max|d| <= 1e-4 max|ref|, ||d|| <= 1e-5
    ||ref||."""
    rng = np.random.default_rng(100 + bits + group_size)
    M, N, K = 37, 1000, 256
    packed, scales, biases = _qweights(rng, N, K, bits, group_size)
    x = (rng.standard_normal((M, K)) * np.exp2(rng.integers(-6, 6, (M, 1)))).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jax_qmm.quantized_matmul(
            jnp.asarray(x), jnp.asarray(packed), jnp.asarray(scales), jnp.asarray(biases),
            bits=bits, group_size=group_size))
    q = pk.unpack_rows(_port_w(packed), bits)
    got = _mma_arithmetic(_t(x), q, _t(scales), _t(biases), group_size).numpy()
    d = np.abs(got - ref)
    assert d.max() <= 1e-4 * np.abs(ref).max()
    assert np.linalg.norm(got - ref) <= 1e-5 * np.linalg.norm(ref)


@pytest.mark.parametrize("bits", [4, 6])
def test_mma_arithmetic_bf16_x_rounds_like_the_plain_version(bits):
    """bf16 x: every product is exact, so the kernel's arithmetic rounds to
    the plain version's bf16 output within one ulp of max|ref|."""
    rng = np.random.default_rng(120 + bits)
    M, N, K = 37, 1000, 256
    packed, scales, biases = _qweights(rng, N, K, bits)
    x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32)).bfloat16()
    q = pk.unpack_rows(_port_w(packed), bits)
    got = _mma_arithmetic(x, q, _t(scales), _t(biases), 64).bfloat16().float()
    ref = pk.quantized_matmul(x, _port_w(packed), _t(scales), _t(biases), bits=bits)
    ulp = 2.0 ** (np.floor(np.log2(ref.float().abs().max().item())) - 7)
    assert (got - ref.float()).abs().max().item() <= ulp
