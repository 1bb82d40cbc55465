"""ReLU² attention for Hopper: wrapper and plain version.

Counterpart of the TPU kernel `mlx_audio_tpu/ops/pallas/relu2_attention.py`
(`_relu2_kernel`), MossFormer2's quadratic branch. The kernel is
`mlx_audio_tpu_torch/csrc/relu2_attention.cu`, built at first use by
`_build.load_library`.

`relu2_attention` takes the plain version for CPU tensors only; a CUDA
tensor goes to the kernel or raises. The kernels take every N: the JAX
package's N > 2048 detour to its einsum path, a VMEM limit of the TPU, has
no counterpart here. Each dtype runs two launches, a score pass into a
scratch of B·G·np² weights in v's dtype (np = N rounded up to `N_PAD`) and
a PV pass.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build

__all__ = ["relu2_attention", "relu2_attention_reference"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# the two passes' scratch pads N to a multiple of this (NPAD in
# csrc/relu2_attention.cu)
N_PAD = 64


def scratch_elems(B: int, G: int, N: int) -> int:
    """Elements (of v's dtype) of the weights the two passes hand over."""
    np_ = -(-N // N_PAD) * N_PAD
    return B * G * np_ * np_


def relu2_attention_reference(q, k, v, group_size: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version: float32 scores divided by `group_size`
    (default N), relu, squared and rounded to v's dtype, then a float32 PV
    product cast to v's dtype. q/k (B, G, N, D), v (B, G, N, E) →
    (B, G, N, E)."""
    if group_size is None:
        group_size = q.shape[2]
    sim = torch.matmul(q.float(), k.float().transpose(-1, -2)) / group_size
    attn = torch.relu(sim).square().to(v.dtype)
    return torch.matmul(attn.float(), v.float()).to(v.dtype)


def _check(q, k, v) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dim() != 4:
            raise ValueError(f"{name} must be (B, G, N, ·), got {tuple(t.shape)}")
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{name} must lie on q's CUDA device {q.device}")
        if t.dtype != v.dtype:
            raise TypeError(f"{name} is {t.dtype}, v is {v.dtype}")
    if v.dtype not in _DTYPE_CODE:
        raise TypeError(f"relu2_attention takes float32 or bfloat16, not {v.dtype}")
    B, G, N, D = q.shape
    if k.shape != q.shape or v.shape[:3] != (B, G, N):
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} "
                         "do not match")
    if D > 128:
        raise ValueError(f"query/key dim {D} > 128")
    if B * G > 65535:
        raise ValueError(f"{B * G} (batch, group) tiles > 65535")
    # 16-byte vector loads: rows must start on 16-byte boundaries
    vec = 16 // v.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"{name} must be contiguous in its last dim")
        if t.shape[3] % vec or any(st % vec for st in t.stride()[:3]) or t.data_ptr() % 16:
            raise ValueError(
                f"{name}: last dim and strides must be multiples of {vec} elements "
                "and the data 16-byte aligned")
    cap = torch.cuda.get_device_capability(q.device)
    if cap != (9, 0):
        raise RuntimeError(
            f"the relu2 attention kernel is built for sm_90a; device {q.device} "
            f"has capability {cap}")


def relu2_attention(q, k, v, group_size: Optional[int] = None) -> torch.Tensor:
    """q/k (B, G, N, D), v (B, G, N, E) → (B, G, N, E) in v's dtype, f32 or
    bf16, D ≤ 128. Any strides with a unit last dim: a `split` half of a
    wider projection goes in without a copy. The output is contiguous."""
    if q.device.type == "cpu":
        return relu2_attention_reference(q, k, v, group_size)
    _check(q, k, v)
    B, G, N, D = q.shape
    E = v.shape[3]
    if group_size is None:
        group_size = N
    out = torch.empty(B, G, N, E, dtype=v.dtype, device=v.device)
    if out.numel() == 0:
        return out
    scratch = torch.empty(scratch_elems(B, G, N), dtype=v.dtype, device=v.device)
    lib = _build.load_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.relu2_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            scratch.data_ptr(),
            B, G, N, D, E,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
            ctypes.c_float(group_size), _DTYPE_CODE[v.dtype], stream,
        )
    if err != 0:
        raise RuntimeError(f"relu2_attention launch failed: {_build.error_string(err)}")
    _build.count_launch(relu2_attention)
    return out


relu2_attention.launches = 0
