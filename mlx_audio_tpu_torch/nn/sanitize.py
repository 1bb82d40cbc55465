"""Checkpoint orientation helpers (counterpart of `mlx_audio_tpu/nn/sanitize.py`),
aimed, as there, at the JAX package's layouts (Conv1d (O, K, I/groups)):
every family's `sanitize` returns what the JAX package's returns, and
`nn.module.load_weights` takes it. Values may be numpy arrays or torch
tensors (a bfloat16 checkpoint's values are tensors)."""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

__all__ = ["as_float32", "orient_to", "orient_weights_to_model", "permute", "readings_of"]

# the layouts a 3-D conv weight may come in, as permutations onto the JAX
# package's: as it is, torch Conv1d (O, I, K), torch ConvTranspose1d (I, O, K)
READINGS = ((0, 1, 2), (0, 2, 1), (1, 2, 0))


def permute(w, perm):
    """`w` with its axes permuted, contiguous, of the same kind (numpy or torch)."""
    if isinstance(w, torch.Tensor):
        return w.permute(*perm).contiguous()
    return np.ascontiguousarray(np.transpose(np.asarray(w), perm))


def as_float32(w) -> np.ndarray:
    """A numpy float32 copy of a numpy array or torch tensor (bfloat16 too)."""
    if isinstance(w, torch.Tensor):
        return w.detach().to("cpu", torch.float32).numpy()
    return np.asarray(w, np.float32)


def _same_order(shape, a, b) -> bool:
    """Whether permutations `a` and `b` of an array of `shape` order its
    elements alike (only axes longer than 1 count)."""
    return [x for x in a if shape[x] > 1] == [x for x in b if shape[x] > 1]


def readings_of(module: nn.Module) -> tuple:
    """The layouts a checkpoint may hold `module`'s 3-D weight in: its own
    torch layout and the JAX package's."""
    from .layers import Conv1d, ConvTranspose1d

    if isinstance(module, Conv1d):
        return ((0, 1, 2), (0, 2, 1))
    if isinstance(module, ConvTranspose1d) and module.groups == 1:
        return ((0, 1, 2), (1, 2, 0))
    return READINGS


def orient_to(w, expected: tuple, readings: tuple = READINGS):
    """Permute a conv weight into the expected layout: identity first, then
    the (O,I,K), (I,O,K), (O,K,I) and in/out-swapped permutations, as the
    JAX package does. Shape-driven, hence idempotent. A 3-D weight whose
    shape fits `expected` in two of the layouts `readings` names (as it is,
    as a torch Conv1d weight, as a torch ConvTranspose1d weight), where the
    two order its elements differently, raises: its layout cannot be told
    from its shape."""
    shape = tuple(w.shape)
    if len(shape) == 3:
        fits = [p for p in readings if tuple(shape[a] for a in p) == tuple(expected)]
        if any(not _same_order(shape, fits[0], p) for p in fits[1:]):
            raise ValueError(
                f"a weight of shape {shape} fits {tuple(expected)} in more than one "
                f"layout (permutations {fits}): its layout cannot be told from its shape")
    if shape == tuple(expected) or w.ndim != len(expected):
        return w
    if w.ndim == 3:
        perms = ((0, 2, 1), (1, 2, 0), (2, 1, 0), (2, 0, 1), (1, 0, 2))
    elif w.ndim == 4:
        perms = ((0, 2, 3, 1), (1, 2, 3, 0), (3, 1, 2, 0))
    else:
        return w
    for perm in perms:
        if tuple(shape[a] for a in perm) == tuple(expected):
            return permute(w, perm)
    return w


def orient_weights_to_model(model: nn.Module, weights: dict) -> dict:
    """Orient every >= 3-D weight against the model's parameter shapes in
    the JAX package's layout (keys the model does not have pass through)."""
    from .module import jax_param_shapes

    expected = jax_param_shapes(model)
    modules = dict(model.named_modules())
    out = {}
    for k, w in weights.items():
        if k in expected and getattr(w, "ndim", 0) >= 3:
            w = orient_to(w, expected[k], readings_of(modules[k.rpartition(".")[0]]))
        out[k] = w
    return out
