"""Checkpoint orientation helpers (counterpart of `mlx_audio_tpu/nn/sanitize.py`),
aimed at the port's own parameter layouts: Conv1d (O, I, K),
ConvTranspose1d (I, O, K)."""

from __future__ import annotations

import numpy as np
from torch import nn

__all__ = ["orient_to", "orient_weights_to_model"]


def orient_to(w, expected: tuple):
    """Permute a conv weight into the expected layout: identity first, then
    the (O,I,K), (I,O,K), (O,K,I) and in/out-swapped permutations.
    Shape-driven, hence idempotent."""
    w = np.asarray(w)
    if tuple(w.shape) == tuple(expected) or w.ndim != len(expected):
        return w
    if w.ndim == 3:
        perms = ((0, 2, 1), (1, 2, 0), (2, 1, 0), (2, 0, 1), (1, 0, 2))
    elif w.ndim == 4:
        perms = ((0, 2, 3, 1), (1, 2, 3, 0), (3, 1, 2, 0))
    else:
        return w
    for perm in perms:
        if tuple(np.transpose(w, perm).shape) == tuple(expected):
            return np.ascontiguousarray(np.transpose(w, perm))
    return w


def orient_weights_to_model(model: nn.Module, weights: dict) -> dict:
    """Orient every >= 3-D weight against the model's parameter shapes (keys
    the model does not have pass through)."""
    expected = {k: tuple(v.shape) for k, v in model.named_parameters()}
    out = {}
    for k, w in weights.items():
        if k in expected and getattr(w, "ndim", 0) >= 3:
            w = orient_to(w, expected[k])
        out[k] = w
    return out
