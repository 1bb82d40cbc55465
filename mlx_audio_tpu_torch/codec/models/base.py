"""Shared codec utilities (counterpart of `mlx_audio_tpu/codec/models/base.py`):
weight-norm folding, and the port's convolutions run channels-first."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ...nn import Conv1d as _Conv1d
from ...nn import ConvTranspose1d as _ConvTranspose1d
from ...nn.sanitize import as_float32

__all__ = ["Conv1d", "ConvTranspose1d", "fold_weight_norm_pairs"]


class Conv1d(_Conv1d):
    """The port's Conv1d (its weight layout and loading), run channels-first:
    (B, C_in, T) → (B, C_out, T')."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv1d(x, self.weight.to(x.dtype), b, stride=self.stride,
                        padding=self.padding, dilation=self.dilation, groups=self.groups)


class ConvTranspose1d(_ConvTranspose1d):
    """The port's ConvTranspose1d, run channels-first."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv_transpose1d(x, self.weight.to(x.dtype), b, stride=self.stride,
                                  padding=self.padding, output_padding=self.output_padding,
                                  groups=self.groups)


def fold_weight_norm_pairs(weights: dict) -> dict:
    """Fold every (weight_g, weight_v) pair into one `weight` (float32 numpy),
    w = g·v/‖v‖, the norm taken over the axes where g has size 1: the conv
    (except_dim=0) and transposed-conv (except_dim=2) conventions alike.
    torch's parametrize-style names (`parametrizations.weight.original0`
    for g, `original1` for v) are read too."""
    out = dict(weights)
    for k in [k for k in weights if k.endswith("parametrizations.weight.original0")]:
        base = k[: -len("parametrizations.weight.original0")]
        out[base + "weight_g"] = out.pop(k)
        vk = base + "parametrizations.weight.original1"
        if vk in out:
            out[base + "weight_v"] = out.pop(vk)
    for gkey in [k for k in out if k.endswith("weight_g")]:
        vkey = gkey[:-1] + "v"
        if vkey not in out:
            continue
        g = as_float32(out.pop(gkey))
        v = as_float32(out.pop(vkey))
        if g.ndim < v.ndim:
            g = g.reshape(g.shape + (1,) * (v.ndim - g.ndim))
        norm_axes = tuple(i for i in range(v.ndim) if g.shape[i] == 1)
        norm = np.sqrt((v ** 2).sum(axis=norm_axes, keepdims=True))
        out[gkey.rsplit(".", 1)[0] + ".weight"] = g * v / np.maximum(norm, 1e-12)
    return out
