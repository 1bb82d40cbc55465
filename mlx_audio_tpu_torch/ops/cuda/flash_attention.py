"""Flash attention for Hopper: wrapper and plain version.

Counterpart of the TPU kernel `mlx_audio_tpu/ops/pallas/flash_attention.py`
(`_flash_kernel`). The kernel is `mlx_audio_tpu_torch/csrc/flash_attention.cu`,
built at first use by `_build.load_library`.

`flash_attention` takes the plain version for CPU tensors only; a CUDA
tensor goes to the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build

__all__ = ["flash_attention", "flash_attention_reference"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_reference(q, k, v, *, causal: bool = False,
                              scale: Optional[float] = None) -> torch.Tensor:
    """Plain PyTorch version with the kernel's semantics: q is scaled in its
    own dtype, scores and softmax are float32, masked scores are -1e30, p is
    cast to v's dtype before the PV product, and the row sum is clamped at
    1e-30. q: (B, H, T, D), k/v: (B, H, S, D) → (B, H, T, D)."""
    T, D = q.shape[2], q.shape[3]
    S = k.shape[2]
    if scale is None:
        scale = D ** -0.5
    if causal and T != S:
        raise ValueError(f"causal flash attention needs T == S, got {T} and {S}")
    s = torch.matmul((q * scale).float(), k.float().transpose(-1, -2))
    if causal:
        bad = torch.ones(T, S, dtype=torch.bool, device=q.device).triu(1)
        s = s.masked_fill(bad, -1e30)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.matmul(p.to(v.dtype).float(), v.float())
    return (acc / torch.clamp(l, min=1e-30)).to(q.dtype)


def _check(q, k, v, causal: bool) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dim() != 4:
            raise ValueError(f"{name} must be (B, H, L, D), got {tuple(t.shape)}")
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{name} must lie on q's CUDA device {q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q is {q.dtype}")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"flash_attention takes float32 or bfloat16, not {q.dtype}")
    B, H, T, D = q.shape
    if k.shape != v.shape or k.shape[:2] != (B, H) or k.shape[3] != D:
        raise ValueError(
            f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}"
            " do not match (repeat GQA heads before the call)")
    if D > 128:
        raise ValueError(f"head dim {D} > 128")
    if causal and T != k.shape[2]:
        raise ValueError("causal flash attention needs T == S")
    if k.shape[2] == 0:
        raise ValueError("flash attention needs at least one key")
    # 16-byte vector loads: rows must start on 16-byte boundaries
    vec = 16 // q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"{name} must be contiguous in its last dim")
        if D % vec or any(st % vec for st in t.stride()[:3]) or t.data_ptr() % 16:
            raise ValueError(
                f"{name}: head dim and strides must be multiples of {vec} "
                "elements and the data 16-byte aligned")
    cap = torch.cuda.get_device_capability(q.device)
    if cap != (9, 0):
        raise RuntimeError(
            f"the flash attention kernel is built for sm_90a; device {q.device} "
            f"has capability {cap}")


def flash_attention(q, k, v, *, causal: bool = False,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, H, T, D), k/v: (B, H, S, D) → (B, H, T, D), f32 or bf16,
    D ≤ 128; `causal` needs T == S. Any strides with a unit last dim (the
    (B, T, H, D) → (B, H, T, D) transposed view needs no copy); the output
    keeps q's memory layout."""
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal=causal, scale=scale)
    _check(q, k, v, causal)
    B, H, T, D = q.shape
    S = k.shape[2]
    if scale is None:
        scale = D ** -0.5
    if q.dtype == torch.bfloat16:
        # the bf16 kernel reads through TMA tensor maps, which take no zero
        # stride: a broadcast (expanded) operand is laid out first
        q, k, v = (t if all(st or n == 1 for st, n in zip(t.stride(), t.shape)) else
                   t.contiguous() for t in (q, k, v))
    out = torch.empty_like(q)  # preserves q's strides
    lib = _build.load_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, H, T, S, D,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
            ctypes.c_float(scale), int(causal), _DTYPE_CODE[q.dtype], stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: {_build.error_string(err)}")
    _build.count_launch(flash_attention)
    return out


flash_attention.launches = 0
