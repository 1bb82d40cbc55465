"""Shared codec utilities (counterpart of `mlx_audio_tpu/codec/models/base.py`):
weight-norm folding."""

from __future__ import annotations

import numpy as np

from ...nn.sanitize import as_float32

__all__ = ["fold_weight_norm_pairs"]


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
