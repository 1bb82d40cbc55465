"""torch-style `interpolate` (nearest / linear) for (N, C, L) tensors
(counterpart of `mlx_audio_tpu/tts/models/interpolate.py`).

This is not `F.interpolate`: the output size is int(L · scale_factor) and
the source positions come from L / size, clipped to [0, L − 1], in float32,
exactly as the JAX function computes them. Kokoro's sine source resamples
by 1/300 and 300 with it, so its index arithmetic is copied, not
approximated."""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["interpolate"]


def interpolate(
    x: torch.Tensor,  # (N, C, L)
    size: Optional[int] = None,
    scale_factor: Optional[float] = None,
    mode: str = "nearest",
    align_corners: bool = False,
) -> torch.Tensor:
    if x.ndim != 3:
        raise ValueError(f"interpolate expects (N, C, L), got {tuple(x.shape)}")
    if size is not None and scale_factor is not None:
        raise ValueError("pass only one of size / scale_factor")
    L = x.shape[-1]
    if size is None:
        if scale_factor is None:
            raise ValueError("one of size/scale_factor is required")
        size = int(L * scale_factor)
    if size == L:
        return x
    # float32 positions, as the JAX package's int32 arange times a float
    n = torch.arange(size, dtype=torch.float32, device=x.device)

    if mode == "nearest":
        idx = torch.floor(n * (L / size)).long().clamp(0, L - 1)
        return x[..., idx]

    if mode == "linear":
        if align_corners and size > 1:
            pos = n * ((L - 1) / (size - 1))
        else:
            pos = (n + 0.5) * (L / size) - 0.5
        pos = pos.clamp(0.0, L - 1)
        lo = torch.floor(pos).long()
        hi = (lo + 1).clamp(0, L - 1)
        w = (pos - lo).to(x.dtype)
        return x[..., lo] * (1 - w) + x[..., hi] * w

    raise ValueError(f"Unsupported mode: {mode}")
