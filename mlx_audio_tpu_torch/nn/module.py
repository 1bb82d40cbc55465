"""Module utilities (counterpart of `mlx_audio_tpu/nn/module.py`).

`load_jax_params` is the weight bridge: it takes the JAX package's
`flatten_params` dict (dotted keys → numpy arrays) and loads it into a
module of this package, with the same strict, shape-checked contract as the
JAX package's `load_weights`. Parity tests run both packages on identical
weights through it.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch
from torch import nn

from .layers import Conv1d, ConvTranspose1d

__all__ = ["cast_floats", "load_jax_params", "init_weights", "jax_param_shapes"]


def cast_floats(module: nn.Module, dtype=torch.bfloat16) -> nn.Module:
    """Cast every floating-point parameter and buffer to `dtype` in place;
    integer and bool tensors are left as they are."""
    for t in list(module.parameters()) + list(module.buffers()):
        if t.is_floating_point():
            t.data = t.data.to(dtype)
    return module


def init_weights(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fill every layer's parameters from `generator`, in module order."""
    for m in module.modules():
        if hasattr(m, "reset_parameters") and m is not module:
            m.reset_parameters(generator)
    return module


def _to_torch_layout(owner: nn.Module, name: str, w: np.ndarray) -> np.ndarray:
    if name == "weight" and w.ndim == 3:
        if isinstance(owner, Conv1d):
            return np.transpose(w, (0, 2, 1))  # JAX (O, K, I) -> torch (O, I, K)
        if isinstance(owner, ConvTranspose1d):
            # JAX (O, K, I/g) -> torch (I, O/g, K): output channel o of group
            # j is row j·O/g + o in JAX and column o of row block j in torch
            o, k, i_g = w.shape
            g = owner.groups
            return (w.reshape(g, o // g, k, i_g).transpose(0, 3, 1, 2)
                    .reshape(g * i_g, o // g, k))
    if w.dtype == np.uint32:
        # packed quantized words: the same 32 bits, as torch's int32
        return w.view(np.int32)
    return w


def jax_param_shapes(model: nn.Module) -> dict:
    """Each parameter's shape in the JAX package's layout, the layout
    `load_jax_params` takes: convolutions (O, K, I/groups)."""
    modules = dict(model.named_modules())
    shapes = {}
    for key, p in model.named_parameters():
        owner = modules[key.rpartition(".")[0]]
        shape = tuple(p.shape)
        if key.endswith("weight") and p.ndim == 3:
            if isinstance(owner, Conv1d):
                shape = (shape[0], shape[2], shape[1])
            elif isinstance(owner, ConvTranspose1d):
                g = owner.groups
                shape = (shape[1] * g, shape[2], shape[0] // g)
        shapes[key] = shape
    return shapes


def load_jax_params(model: nn.Module, flat: Mapping[str, np.ndarray],
                    strict: bool = True,
                    not_built: Sequence[str] = ()) -> nn.Module:
    """Copy a JAX `flatten_params` dict into `model` in place.

    Every key must name a parameter of `model` and match its shape after
    the layout change; with strict=True every parameter of `model` must be
    present. `not_built` lists JAX key prefixes of parts the port does not
    build (e.g. an encoder only another path uses); their keys are dropped
    by name, every other key stays checked. Buffers (recomputed constants)
    are never loaded. Floating values are cast to each parameter's dtype and
    device; packed quantized weights (uint32 words, uint8 bitstreams) go in
    bit for bit, uint32 as int32."""
    flat = {k: v for k, v in flat.items()
            if not any(k.startswith(p) for p in not_built)}
    params = dict(model.named_parameters())
    unknown = [k for k in flat if k not in params]
    if unknown:
        raise ValueError(
            f"Checkpoint keys not found in model ({len(unknown)}): "
            f"{unknown[:10]}{'...' if len(unknown) > 10 else ''}"
        )
    if strict:
        missing = [k for k in params if k not in flat]
        if missing:
            raise ValueError(
                f"Model parameters missing from checkpoint ({len(missing)}): "
                f"{missing[:10]}{'...' if len(missing) > 10 else ''}"
            )
    # by registry name: `getattr` would find a method where a submodule is
    # named `forward` (the JAX package's BiLSTM)
    modules = dict(model.named_modules())
    converted = {}
    for key, w in flat.items():
        owner_path, _, name = key.rpartition(".")
        owner = modules[owner_path]
        w = _to_torch_layout(owner, name, np.asarray(w))
        p = params[key]
        w_int = w.dtype.kind in "iub"
        if w_int == p.is_floating_point() or (
                w_int and w.dtype.itemsize != p.element_size()):
            raise TypeError(f"dtype mismatch for {key}: model {p.dtype} vs "
                            f"checkpoint {w.dtype}")
        if tuple(w.shape) != tuple(p.shape):
            raise ValueError(
                f"Shape mismatch for {key}: model {tuple(p.shape)} vs "
                f"checkpoint {tuple(w.shape)}"
            )
        converted[key] = w
    with torch.no_grad():
        for key, w in converted.items():
            p = params[key]
            # float32 on the host first: numpy has no bfloat16 of its own
            w = np.array(w, np.float32 if p.is_floating_point() else None)
            p.copy_(torch.from_numpy(w))
    return model
