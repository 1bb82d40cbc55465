"""Activation functions (counterpart of `mlx_audio_tpu/nn/activations.py`):
the ones the ported families use."""

from __future__ import annotations

import torch

__all__ = ["snake"]


def snake(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """Snake: x + sin²(αx)/α (the DAC, SNAC and BigVGAN vocoders), in x's
    dtype."""
    a = alpha.to(x.dtype)
    s = torch.sin(a * x)
    return x + s * s / (a + 1e-9)
