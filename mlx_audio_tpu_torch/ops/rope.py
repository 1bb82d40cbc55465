"""Rotary position embeddings (counterpart of `mlx_audio_tpu/ops/rope.py`):
the rotate-half layout and the `traditional` (interleaved pairs) one, and
Llama-3's frequency scaling."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

__all__ = ["rope_cos_sin", "apply_rope", "llama3_rope_freqs"]


def rope_cos_sin(positions: torch.Tensor, dims: int, base: float = 10000.0,
                 scale: float = 1.0, freqs: Optional[torch.Tensor] = None,
                 dtype=torch.float32):
    """cos/sin tables of shape (..., dims/2) for integer `positions`."""
    dev = positions.device
    if freqs is None:
        freqs = base ** (-torch.arange(0, dims, 2, dtype=torch.float32, device=dev) / dims)
    angles = positions[..., None].float() * scale * freqs
    return torch.cos(angles).to(dtype), torch.sin(angles).to(dtype)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               traditional: bool = False) -> torch.Tensor:
    """x (..., T, D) rotated by cos/sin (T, D/2) or broadcastable; the first
    2·cos.shape[-1] features rotate, the rest pass through. Returns x's
    dtype."""
    d = cos.shape[-1]
    if traditional:
        x1 = x[..., 0:2 * d:2]
        x2 = x[..., 1:2 * d:2]
        out = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                          dim=-1).reshape(*x.shape[:-1], 2 * d)
    else:
        x1 = x[..., :d]
        x2 = x[..., d:2 * d]
        out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    if 2 * d < x.shape[-1]:
        out = torch.cat([out.to(x.dtype), x[..., 2 * d:]], dim=-1)
    return out.to(x.dtype)


def llama3_rope_freqs(dims: int, base: float, factor: float = 8.0,
                      low_freq_factor: float = 1.0, high_freq_factor: float = 4.0,
                      original_max_position: int = 8192, device=None) -> torch.Tensor:
    """Llama-3's long-context rescaling of the rope frequencies (float32,
    (dims/2,)): wavelengths past original_max_position / low_freq_factor
    slow down by `factor`, those under original_max_position /
    high_freq_factor stay, and the band between blends the two. Computed in
    float64 on the host, as the JAX package does."""
    freqs = base ** (-np.arange(0, dims, 2, dtype=np.float64) / dims)
    wavelens = 2 * np.pi / freqs
    low_freq_wavelen = original_max_position / low_freq_factor
    high_freq_wavelen = original_max_position / high_freq_factor
    new_freqs = np.where(wavelens > low_freq_wavelen, freqs / factor, freqs)
    smooth = (original_max_position / wavelens - low_freq_factor) / (
        high_freq_factor - low_freq_factor)
    mid = np.where((wavelens <= low_freq_wavelen) & (wavelens >= high_freq_wavelen),
                   freqs / ((1 - smooth) / factor + smooth), new_freqs)
    return torch.from_numpy(mid.astype(np.float32)).to(device)
