"""Module utilities (counterpart of `mlx_audio_tpu/nn/module.py`).

Weights cross between the packages in the JAX package's layout: `load_weights`
takes a dict of dotted keys in that layout (a checkpoint after `sanitize`, or
the JAX package's `flatten_params`) into a module of this package, with the
JAX `load_weights`' strict, shape-checked contract, and `flatten_params`
gives a module's parameters back in it, so that a checkpoint written by
either package loads in the other. Parity tests run both packages on
identical weights through `load_jax_params`, the same function.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch
from torch import nn

from .layers import Conv1d, Conv2d, ConvTranspose1d

__all__ = ["cast_floats", "flatten_params", "init_weights", "jax_param_shapes",
           "load_jax_params", "load_weights"]


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


def _to_torch_layout(owner: nn.Module, name: str, w: torch.Tensor) -> torch.Tensor:
    """A JAX-layout value of `owner.<name>` as the port's parameter holds it
    (a view where one will do)."""
    if name == "weight" and w.ndim == 3:
        if isinstance(owner, Conv1d):
            return w.permute(0, 2, 1)  # JAX (O, K, I) -> torch (O, I, K)
        if isinstance(owner, ConvTranspose1d):
            # JAX (O, K, I/g) -> torch (I, O/g, K): output channel o of group
            # j is row j·O/g + o in JAX and column o of row block j in torch
            o, k, i_g = w.shape
            g = owner.groups
            return (w.reshape(g, o // g, k, i_g).permute(0, 3, 1, 2)
                    .reshape(g * i_g, o // g, k))
    if name == "weight" and w.ndim == 4 and isinstance(owner, Conv2d):
        return w.permute(0, 3, 1, 2)  # JAX (O, KH, KW, I) -> torch (O, I, KH, KW)
    return w


def _to_jax_layout(owner: nn.Module, name: str, p: torch.Tensor) -> torch.Tensor:
    """The inverse of `_to_torch_layout`."""
    if name == "weight" and p.ndim == 3:
        if isinstance(owner, Conv1d):
            return p.permute(0, 2, 1)
        if isinstance(owner, ConvTranspose1d):
            i, o_g, k = p.shape
            g = owner.groups
            return (p.reshape(g, i // g, o_g, k).permute(0, 2, 3, 1)
                    .reshape(g * o_g, k, i // g))
    if name == "weight" and p.ndim == 4 and isinstance(owner, Conv2d):
        return p.permute(0, 2, 3, 1)
    return p


def _as_tensor(w) -> torch.Tensor:
    """A checkpoint value (numpy array, torch tensor, or ml_dtypes bfloat16
    array) as a CPU or device tensor with the same bits; uint32 words
    become int32, as the port stores them."""
    if isinstance(w, torch.Tensor):
        return w.detach()
    w = np.asarray(w)
    if w.dtype.name == "bfloat16":  # ml_dtypes: numpy has none of its own
        return torch.from_numpy(np.ascontiguousarray(w).view(np.int16)).view(torch.bfloat16)
    if w.dtype == np.uint32:
        w = w.view(np.int32)
    if not w.flags.writeable:  # torch wants writable memory to share
        w = w.copy()
    return torch.from_numpy(w)


def jax_param_shapes(model: nn.Module) -> dict:
    """Each parameter's shape in the JAX package's layout, the layout
    `load_weights` takes: convolutions (O, K, I/groups) and (O, KH, KW, I/groups)."""
    modules = dict(model.named_modules())
    shapes = {}
    for key, p in model.named_parameters():
        owner_path, _, name = key.rpartition(".")
        shapes[key] = tuple(_to_jax_layout(modules[owner_path], name, p.detach()).shape)
    return shapes


def flatten_params(model: nn.Module) -> dict:
    """Dotted key → value of every parameter in the JAX package's layout and
    dtypes, on the host: what the JAX package's `flatten_params` gives for
    the same model, so a checkpoint written from it loads in either
    package. Values are numpy arrays, packed quantized words uint32; a
    bfloat16 parameter stays a torch tensor (numpy has no bfloat16)."""
    modules = dict(model.named_modules())
    out = {}
    for key, p in model.named_parameters():
        owner_path, _, name = key.rpartition(".")
        t = _to_jax_layout(modules[owner_path], name, p.detach()).to("cpu").contiguous()
        if t.dtype == torch.bfloat16:
            out[key] = t
            continue
        a = t.numpy()
        out[key] = a.view(np.uint32) if a.dtype == np.int32 else a
    return out


def load_weights(model: nn.Module, weights: Mapping[str, object], strict: bool = True,
                 not_built: Sequence[str] = ()) -> nn.Module:
    """Copy `weights` into `model`'s parameters in place and return it.

    The counterpart of the JAX package's `nn.module.load_weights`, and the
    one layout contract of the port's loader: values are in the JAX
    package's layout (what its `flatten_params` gives and what every
    family's `sanitize` returns), convolutions (O, K, I/groups), packed
    quantized words uint32 (or int32 with the same bits). Values may be
    numpy arrays or torch tensors; no layout is ever inferred from a shape.

    Every key must name a parameter of `model` and match its JAX-layout
    shape; with strict=True every parameter must be present. `not_built`
    lists key prefixes of parts the port does not build (e.g. an encoder
    only another path uses): their keys are dropped by name, every other
    key stays checked. Buffers (recomputed constants) are never loaded.
    Floating values are cast to each parameter's dtype on its device;
    packed quantized weights (uint32 words, uint8 bitstreams) go in bit
    for bit."""
    weights = {k: v for k, v in weights.items()
               if not any(k.startswith(p) for p in not_built)}
    params = dict(model.named_parameters())
    unknown = [k for k in weights if k not in params]
    if unknown:
        raise ValueError(
            f"Checkpoint keys not found in model ({len(unknown)}): "
            f"{unknown[:10]}{'...' if len(unknown) > 10 else ''}"
        )
    if strict:
        missing = [k for k in params if k not in weights]
        if missing:
            raise ValueError(
                f"Model parameters missing from checkpoint ({len(missing)}): "
                f"{missing[:10]}{'...' if len(missing) > 10 else ''}"
            )
    # by registry name: `getattr` would find a method where a submodule is
    # named `forward` (the JAX package's BiLSTM)
    modules = dict(model.named_modules())
    converted = {}
    for key, w in weights.items():
        owner_path, _, name = key.rpartition(".")
        p = params[key]
        w = _as_tensor(w)
        w_int = not (w.is_floating_point() or w.is_complex())
        if w_int == p.is_floating_point() or (
                w_int and w.element_size() != p.element_size()):
            raise TypeError(f"dtype mismatch for {key}: model {p.dtype} vs "
                            f"checkpoint {w.dtype}")
        want = tuple(_to_jax_layout(modules[owner_path], name, p.detach()).shape)
        if tuple(w.shape) != want:
            raise ValueError(f"Shape mismatch for {key}: model {want} vs checkpoint "
                             f"{tuple(w.shape)}")
        converted[key] = _to_torch_layout(modules[owner_path], name, w)
    with torch.no_grad():
        for key, w in converted.items():
            p = params[key]
            if not p.is_floating_point() and w.dtype != p.dtype:
                w = w.view(p.dtype)  # the same bits (uint8 words as int8 and so on)
            p.copy_(w)
    return model


def load_jax_params(model: nn.Module, flat: Mapping[str, np.ndarray],
                    strict: bool = True,
                    not_built: Sequence[str] = ()) -> nn.Module:
    """Copy a JAX `flatten_params` dict into `model` in place: `load_weights`
    under the name the parity tests use."""
    return load_weights(model, flat, strict=strict, not_built=not_built)
