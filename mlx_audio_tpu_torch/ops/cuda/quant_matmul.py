"""Dequantize-matmul and fused quantized SwiGLU for Hopper: wrappers and
plain versions.

Counterparts of the TPU kernels in `mlx_audio_tpu/ops/pallas/quant_matmul.py`:
`_qmm_kernel` (`quantized_matmul`, 4/8-bit), `_qmm6_kernel`
(`quantized_matmul6`, the 6-bit stream) and `_qmlp_kernel`
(`quantized_mlp`). The kernels are `mlx_audio_tpu_torch/csrc/quant_matmul.cu`,
built at first use by `_build.load_library`.

Weights are MLX-affine: 4/8-bit rows are uint32 words kept as int32 (the
same bits), 6-bit rows MLX's uint8 stream; scales and biases are float32
(N, K / group_size). Each wrapper takes its plain version for CPU tensors
only; a CUDA tensor goes to the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["quantized_matmul", "quantized_matmul6", "quantized_mlp",
           "quantized_matmul_reference", "quantized_mlp_reference", "unpack_rows"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# values per unit the kernel unpacks at once: one word (4/8-bit) or three
# words (6-bit); K and group_size must be multiples of it
_CHUNK = {4: 8, 8: 4, 6: 16}


def unpack_rows(w: torch.Tensor, bits: int) -> torch.Tensor:
    """Packed rows → (..., K) integer values: MLX's uint8 stream for 3/6
    bits, little-endian words (int32 holding uint32 bits) otherwise."""
    if bits in (3, 6):
        b = w.to(torch.int32).reshape(*w.shape[:-1], -1, 3)
        word = b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16)
        per = 24 // bits
        shifts = torch.arange(per, dtype=torch.int32, device=w.device) * bits
        q = (word[..., None] >> shifts) & ((1 << bits) - 1)
        return q.reshape(*w.shape[:-1], -1)
    per = 32 // bits
    shifts = torch.arange(per, dtype=torch.int32, device=w.device) * bits
    # an arithmetic shift of a negative word fills ones above bit 31 - shift;
    # the mask keeps only the value's own bits
    q = (w.to(torch.int32)[..., None] >> shifts) & ((1 << bits) - 1)
    return q.reshape(*w.shape[:-1], -1)


def _qmm_f32(x2, w, scales, biases, bits, group_size):
    """float32 (M, N) by the TPU kernel's formula: sum_k x·q·s over the
    weight, plus the per-group sums of x times the biases."""
    N = w.shape[0]
    M, K = x2.shape
    G = K // group_size
    q = unpack_rows(w, bits).float().reshape(N, G, group_size)
    ws = (q * scales.float()[:, :, None]).reshape(N, K)
    xg = x2.reshape(M, G, group_size).sum(-1)
    return x2 @ ws.T + xg @ biases.float().T


def quantized_matmul_reference(x, w, scales, biases, *, bits: int = 4,
                               group_size: int = 64) -> torch.Tensor:
    """Plain PyTorch version of the kernels: x (..., K) → (..., N) in x's
    dtype, accumulated in float32."""
    K = x.shape[-1]
    y = _qmm_f32(x.reshape(-1, K).float(), w, scales, biases, bits, group_size)
    return y.to(x.dtype).reshape(*x.shape[:-1], w.shape[0])


def quantized_mlp_reference(x, w_gu, s_gu, b_gu, w_down, s_down, b_down, *,
                            bits: int = 4, group_size: int = 64) -> torch.Tensor:
    """Plain version of the fused MLP: g and u stay float32, h = silu(g)·u
    is float32, only the output takes x's dtype."""
    K = x.shape[-1]
    I = w_gu.shape[0] // 2
    gu = _qmm_f32(x.reshape(-1, K).float(), w_gu, s_gu, b_gu, bits, group_size)
    g, u = gu[:, :I], gu[:, I:]
    h = g * torch.sigmoid(g) * u
    y = _qmm_f32(h, w_down, s_down, b_down, bits, group_size)
    return y.to(x.dtype).reshape(*x.shape[:-1], w_down.shape[0])


_SM90 = set()  # device indices seen to have capability (9, 0)


def _check_card(x) -> None:
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"the quantized kernels take float32 or bfloat16 x, not {x.dtype}")
    if x.device.index not in _SM90:
        cap = torch.cuda.get_device_capability(x.device)
        if cap != (9, 0):
            raise RuntimeError(
                f"the quantized kernels are built for sm_90a; device {x.device} has "
                f"capability {cap}")
        _SM90.add(x.device.index)


def _check_weight(x, w, scales, biases, bits, group_size, K, name="w"):
    N = w.shape[0]
    if bits not in _CHUNK:
        raise ValueError(f"no kernel for bits={bits}")
    want = torch.uint8 if bits == 6 else torch.int32
    if w.dtype != want:
        raise TypeError(f"{name}: {bits}-bit rows must be {want}, got {w.dtype}")
    if w.dim() != 2 or w.shape[1] * w.element_size() * 8 != K * bits:
        raise ValueError(f"{name}: shape {tuple(w.shape)} does not hold {K} {bits}-bit values a row")
    c = _CHUNK[bits]
    if K % c or group_size % c or K % group_size:
        raise ValueError(
            f"K={K} and group_size={group_size} must be multiples of {c} and K of group_size")
    for t, what in ((w, name), (scales, "scales"), (biases, "biases")):
        if t.device != x.device:
            raise ValueError(f"{what} must lie on x's device {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what} must be contiguous")
    for t, what in ((scales, "scales"), (biases, "biases")):
        if t.dtype != torch.float32 or tuple(t.shape) != (N, K // group_size):
            raise ValueError(
                f"{what} must be float32 ({N}, {K // group_size}), got {t.dtype} {tuple(t.shape)}")
    if w.data_ptr() % 4:
        raise ValueError(f"{name} must be 4-byte aligned")


def _stream(x) -> int:
    """The raw current stream of x's device, which must be the current
    device: the launch goes to the current device."""
    idx = x.device.index
    if idx != torch.cuda.current_device():
        raise ValueError(f"x lies on {x.device}, the current device is "
                         f"cuda:{torch.cuda.current_device()}")
    return torch._C._cuda_getCurrentRawStream(idx)


def _x2d(x):
    K = x.shape[-1]
    x2 = x.reshape(-1, K)
    if x2.stride(-1) != 1:
        x2 = x2.contiguous()
    return x2


# the kernels `qmm_fwd` chooses from, by the code it reports (QmmRoute in
# csrc/quant_matmul.cu): the tiled CUDA-core kernel (x at an address or
# rows the others cannot take), the GEMV (M <= 4) and the tensor-core GEMM
# (M > 4)
QMM_KERNELS = ("qmm_kernel", "qmm_gemv", "qmm_mma")


def _launch_qmm(fn, x, w, scales, biases, bits, group_size):
    """Launch qmm_fwd and count it on `fn` (its total, its kernel and its
    weight's (N, K))."""
    _check_card(x)
    K = x.shape[-1]
    _check_weight(x, w, scales, biases, bits, group_size, K)
    x2 = _x2d(x)
    M, N = x2.shape[0], w.shape[0]
    y = torch.empty(M, N, dtype=x.dtype, device=x.device)
    route = ctypes.c_int(-1)  # this call's own: another thread may launch meanwhile
    err = _build.load_library().qmm_fwd(
        x2.data_ptr(), w.data_ptr(), scales.data_ptr(), biases.data_ptr(), y.data_ptr(),
        M, N, K, group_size, bits, _DTYPE_CODE[x.dtype], x2.stride(0), x.device.index,
        ctypes.addressof(route), _stream(x))
    if err != 0:
        raise RuntimeError(f"qmm_fwd ({bits}-bit) launch failed: {_build.error_string(err)}")
    if route.value >= 0:
        _build.count_launch(fn, QMM_KERNELS[route.value], (N, K))
    return y.reshape(*x.shape[:-1], N)


def quantized_matmul(x, w, scales, biases, *, bits: int = 4,
                     group_size: int = 64) -> torch.Tensor:
    """x (..., K) · dequant(w (N, K·bits/32 words))ᵀ → (..., N) in x's dtype,
    accumulated in float32. bits=6 goes to `quantized_matmul6`."""
    if bits == 6:
        return quantized_matmul6(x, w, scales, biases, group_size=group_size)
    if x.device.type == "cpu":
        return quantized_matmul_reference(x, w, scales, biases, bits=bits,
                                          group_size=group_size)
    if bits not in (4, 8):
        raise ValueError(f"no kernel for bits={bits}")
    return _launch_qmm(quantized_matmul, x, w, scales, biases, bits, group_size)


def quantized_matmul6(x, w, scales, biases, *, group_size: int = 64) -> torch.Tensor:
    """The 6-bit dequant-matmul over MLX's uint8 stream w (N, K·6/8)."""
    if x.device.type == "cpu":
        return quantized_matmul_reference(x, w, scales, biases, bits=6,
                                          group_size=group_size)
    return _launch_qmm(quantized_matmul6, x, w, scales, biases, 6, group_size)


def reset_launches(*fns) -> None:
    """Zero the launch counts of `fns` (default: all three wrappers)."""
    for fn in fns or (quantized_matmul, quantized_matmul6, quantized_mlp):
        fn.launches = 0
        if hasattr(fn, "kernels"):
            fn.kernels = dict.fromkeys(QMM_KERNELS, 0)
            fn.shapes = {}  # (N, K) -> launches


# h is M·I·4 bytes and each tile of up to 4 rows of x is one pass over the
# weights; the routing guard (`nn.quantized.fused_mlp_call`) admits M <= 16
QMLP_MAX_M = 16

# per (device, stream): the grid barrier's state (64 words, see
# `grid_arrive` in csrc/quant_matmul.cu), zeroed once and left ready by
# every call, and the h scratch, grown as needed. Calls on one stream run
# one after another, so they can share both; another stream gets its own.
_QMLP_STATE: dict = {}
_BAR_WORDS = 64


def _qmlp_state(x, stream: int, n_h: int):
    key = (x.device.index, stream)
    state = _QMLP_STATE.get(key)
    if state is None or state[1].numel() < n_h:
        bar = state[0] if state else torch.zeros(_BAR_WORDS, dtype=torch.int32, device=x.device)
        state = (bar, torch.empty(n_h, dtype=torch.float32, device=x.device))
        _QMLP_STATE[key] = state
    return state


def quantized_mlp(x, w_gu, s_gu, b_gu, w_down, s_down, b_down, *,
                  bits: int = 4, group_size: int = 64) -> torch.Tensor:
    """silu(x·Wgᵀ)·(x·Wuᵀ)·Wdᵀ in one cooperative launch. w_gu holds the
    gate rows then the up rows (a row-stacked `QuantizedFusedLinear`),
    w_down (N, I·bits/32). Its grid is capped at the blocks the card holds
    at once (the grid-wide barrier needs them all resident); the launch
    raises if even that cannot be met."""
    if x.device.type == "cpu":
        return quantized_mlp_reference(x, w_gu, s_gu, b_gu, w_down, s_down, b_down,
                                       bits=bits, group_size=group_size)
    if bits not in (4, 8):
        raise ValueError(f"the fused MLP kernel takes bits 4 or 8, not {bits}")
    _check_card(x)
    K = x.shape[-1]
    I = w_gu.shape[0] // 2
    if w_gu.shape[0] != 2 * I:
        raise ValueError("w_gu must hold gate and up rows of equal count")
    _check_weight(x, w_gu, s_gu, b_gu, bits, group_size, K, "w_gu")
    _check_weight(x, w_down, s_down, b_down, bits, group_size, I, "w_down")
    x2 = _x2d(x)
    M, N = x2.shape[0], w_down.shape[0]
    if M > QMLP_MAX_M:
        raise ValueError(f"the fused MLP kernel takes M <= {QMLP_MAX_M}, got {M}")
    y = torch.empty(M, N, dtype=x.dtype, device=x.device)
    stream = _stream(x)
    bar, h = _qmlp_state(x, stream, M * I)
    err = _build.load_library().qmlp_fwd(
        x2.data_ptr(), w_gu.data_ptr(), s_gu.data_ptr(), b_gu.data_ptr(),
        w_down.data_ptr(), s_down.data_ptr(), b_down.data_ptr(), y.data_ptr(),
        h.data_ptr(), bar.data_ptr(), M, K, I, N, group_size, bits, _DTYPE_CODE[x.dtype],
        x.device.index, x2.stride(0), stream)
    if err != 0:
        raise RuntimeError(f"qmlp_fwd launch failed: {_build.error_string(err)}")
    _build.count_launch(quantized_mlp)
    return y.reshape(*x.shape[:-1], N)


quantized_matmul.kernels = dict.fromkeys(QMM_KERNELS, 0)
quantized_matmul6.kernels = dict.fromkeys(QMM_KERNELS, 0)
reset_launches()
