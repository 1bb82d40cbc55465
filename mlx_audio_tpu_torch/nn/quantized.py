"""Affine-quantized layers in MLX's scheme (counterpart of
`mlx_audio_tpu/nn/quantized.py`).

Weights are quantized per `group_size` elements along the input dimension,
w = scales·q + biases with q in [0, 2^bits). 2/4/8/16-bit rows pack
little-endian into uint32 words, kept here as int32 with the same bits;
3/6-bit rows are MLX's uint8 stream (3 bytes per 8/4 values). Packed
weights, scales and biases are parameters with requires_grad=False, so
`load_jax_params` carries them across bit for bit.

A CUDA input whose shape passes the same routing guard as the JAX package's
Pallas route (`x.is_cuda` in place of `pallas_enabled()`) goes through the
hand-written kernels in `ops/cuda/quant_matmul.py`; every other input, and
every CPU input, takes dequantize + matmul in the input's dtype. The guard's
thresholds were measured on a TPU (KERNEL_BENCH.md); they are kept as they
are until they are measured again on the H100.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.cuda.quant_matmul import quantized_matmul, quantized_mlp, unpack_rows
from .layers import Embedding, Linear, clamp_ids

__all__ = [
    "QuantizedLinear", "QuantizedEmbedding", "QuantizedFusedLinear",
    "quantize_arrays", "dequantize_arrays", "quantize_module",
    "fuse_quantized_projections", "fused_mlp_call", "unpack_rows",
    "qmm_routable", "fused_mlp_routable",
]

SUPPORTED_BITS = (2, 3, 4, 6, 8, 16)


def _pack_rows(q: torch.Tensor, bits: int) -> torch.Tensor:
    """Pack integer values (..., in) little-endian: 3/6-bit → uint8 stream,
    otherwise int32 words holding the uint32 bits."""
    q = q.to(torch.int64)
    if bits in (3, 6):
        per = 24 // bits
        q = q.reshape(*q.shape[:-1], -1, per)
        shifts = torch.arange(per, dtype=torch.int64, device=q.device) * bits
        word = (q << shifts).sum(-1)  # 24 bits used
        out = torch.stack([word & 0xFF, (word >> 8) & 0xFF, (word >> 16) & 0xFF], -1)
        return out.reshape(*word.shape[:-1], -1).to(torch.uint8)
    per = 32 // bits
    q = q.reshape(*q.shape[:-1], -1, per)
    shifts = torch.arange(per, dtype=torch.int64, device=q.device) * bits
    word = (q << shifts).sum(-1)
    return torch.where(word >= 2 ** 31, word - 2 ** 32, word).to(torch.int32)


def quantize_arrays(w: torch.Tensor, group_size: int = 64, bits: int = 4):
    """Quantize a float matrix (out, in) → (packed, scales, biases) on `w`'s
    device, scales and biases float32: per-group min/max mapped onto
    [0, 2^bits - 1], as MLX and the JAX package do. Computed on the host in
    float32, as the JAX package computes it in numpy, so that the words are
    the same bits wherever the weight lies (the card divides by a scalar
    through its reciprocal, which rounds otherwise)."""
    if bits not in SUPPORTED_BITS:
        raise ValueError(f"bits={bits} unsupported (supported: {SUPPORTED_BITS})")
    dev = w.device
    w = w.detach().to("cpu", torch.float32)
    wg = w.reshape(*w.shape[:-1], -1, group_size)
    w_min = wg.amin(-1)
    w_max = wg.amax(-1)
    n = 2 ** bits - 1
    scales = torch.clamp((w_max - w_min) / n, min=1e-10)
    biases = w_min
    q = torch.clamp(torch.round((wg - biases[..., None]) / scales[..., None]), 0, n)
    return _pack_rows(q.reshape(w.shape), bits).to(dev), scales.to(dev), biases.to(dev)


def dequantize_arrays(w, scales, biases, group_size: int, bits: int,
                      dtype=torch.float32) -> torch.Tensor:
    q = unpack_rows(w, bits).to(dtype)
    K = q.shape[-1]
    s = scales.to(dtype).repeat_interleave(group_size, dim=-1)[..., :K]
    b = biases.to(dtype).repeat_interleave(group_size, dim=-1)[..., :K]
    return q * s + b


def _rows(x: torch.Tensor) -> int:
    return math.prod(x.shape[:-1]) if x.dim() > 1 else 1


def qmm_routable(bits: int, group_size: int, N: int, K: int, M: int) -> bool:
    """The JAX package's routing decisions for the dequant-matmul kernel
    (`QuantizedLinear._pallas_routable`), by shape alone."""
    if bits not in (4, 6, 8):
        return False
    per = 16 if bits == 6 else 32 // bits
    if K % per or group_size % per:
        return False
    if not (N >= 512 or (N >= 128 and N % 128 == 0)):
        return False
    # the TPU's GEMV floor: M = 1 below 2^19 weights stays on dequant+matmul
    if M == 1 and N * K < (1 << 19):
        return False
    Kp = K // per
    bn = min(512, N)
    w_cols = 3 * Kp if bits == 6 else Kp
    # the TPU kernel's on-chip (VMEM) estimate; past 12 MB it stays off
    est = 4 * (per * M * Kp + 2 * M * bn + 2 * M * Kp + 4 * bn * w_cols)
    if est > 12 * 1024 * 1024:
        return False
    return bits in (4, 6) or M >= 2


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class QuantizedLinear(nn.Module):
    def __init__(self, input_dims: int, output_dims: int, bias: bool = True,
                 group_size: int = 64, bits: int = 4, device=None):
        super().__init__()
        if bits in (3, 6):
            w = torch.zeros(output_dims, input_dims * bits // 8, dtype=torch.uint8,
                            device=device)
        else:
            w = torch.zeros(output_dims, input_dims // (32 // bits), dtype=torch.int32,
                            device=device)
        self.weight = _param(w)
        self.scales = _param(torch.ones(output_dims, input_dims // group_size, device=device))
        self.biases = _param(torch.zeros(output_dims, input_dims // group_size, device=device))
        self.bias = _param(torch.zeros(output_dims, device=device)) if bias else None
        self.group_size = group_size
        self.bits = bits

    @classmethod
    def from_linear(cls, lin: Linear, group_size: int = 64, bits: int = 4,
                    quantize: bool = True):
        """`lin` quantized; `quantize=False` gives the layout only (zero
        words), for weights that a checkpoint fills in."""
        out_d, in_d = lin.weight.shape
        dev = lin.weight.device
        obj = cls(in_d, out_d, bias=lin.bias is not None, group_size=group_size,
                  bits=bits, device=dev)
        if quantize:
            packed, scales, biases = quantize_arrays(lin.weight, group_size, bits)
            obj.weight = _param(packed)
            obj.scales = _param(scales)
            obj.biases = _param(biases)
        if lin.bias is not None:
            obj.bias = _param(lin.bias.detach().clone())
        return obj

    def dequantized_weight(self, dtype=torch.bfloat16) -> torch.Tensor:
        return dequantize_arrays(self.weight, self.scales, self.biases,
                                 self.group_size, self.bits, dtype)

    def _kernel_routable(self, x: torch.Tensor) -> bool:
        return x.is_cuda and qmm_routable(self.bits, self.group_size,
                                          self.weight.shape[0], x.shape[-1], _rows(x))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self._kernel_routable(x):
            y = quantized_matmul(x, self.weight, self.scales, self.biases,
                                 bits=self.bits, group_size=self.group_size)
        else:
            y = F.linear(x, self.dequantized_weight(x.dtype))
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y


class QuantizedFusedLinear(QuantizedLinear):
    """Output-axis row-stack of sibling `QuantizedLinear`s that share one
    input (q/k/v, gate/up): one dequant-matmul launch instead of one per
    sibling; `forward` returns the per-sibling splits. Built after loading
    by `fuse_quantized_projections`; the checkpoint keeps the siblings."""

    split_sizes: Tuple[int, ...] = ()

    @classmethod
    def from_siblings(cls, lins: Sequence[QuantizedLinear]) -> "QuantizedFusedLinear":
        first = lins[0]
        in_d = first.scales.shape[1] * first.group_size
        any_bias = any(l.bias is not None for l in lins)
        dev = first.weight.device
        obj = cls(in_d, sum(l.weight.shape[0] for l in lins), bias=any_bias,
                  group_size=first.group_size, bits=first.bits, device=dev)
        obj.weight = _param(torch.cat([l.weight for l in lins], 0))
        obj.scales = _param(torch.cat([l.scales for l in lins], 0))
        obj.biases = _param(torch.cat([l.biases for l in lins], 0))
        if any_bias:
            # mixed bias-ness (a bias-less key between biased query and
            # value): a zero bias is the identity, so zero-fill
            dt = next(l.bias.dtype for l in lins if l.bias is not None)
            obj.bias = _param(torch.cat([
                l.bias if l.bias is not None
                else torch.zeros(l.weight.shape[0], dtype=dt, device=dev)
                for l in lins]))
        obj.split_sizes = tuple(int(l.weight.shape[0]) for l in lins)
        return obj

    @staticmethod
    def fusable(lins) -> bool:
        """Plain QuantizedLinears with one quantization geometry."""
        if not all(type(l) is QuantizedLinear for l in lins):
            return False
        first = lins[0]
        return all(l.bits == first.bits and l.group_size == first.group_size
                   and l.scales.shape[1] == first.scales.shape[1] for l in lins)

    def forward(self, x: torch.Tensor):  # type: ignore[override]
        return tuple(torch.split(super().forward(x), self.split_sizes, dim=-1))


def fused_mlp_routable(bits: int, group_size: int, K: int, I: int, N: int, M: int) -> bool:
    """The JAX package's routing decisions for the fused SwiGLU kernel
    (`fused_mlp_call`), by shape alone."""
    if bits not in (4, 8):
        return False
    per = 32 // bits
    if K % per or I % (per * 128) or group_size % per:
        return False
    if not (N >= 512 or (N >= 128 and N % 128 == 0)):
        return False
    return M <= 16


def fused_mlp_call(gate_up, down, x: torch.Tensor) -> Optional[torch.Tensor]:
    """silu(g)·u · Wdᵀ in one fused-MLP launch when the input lies on the card
    and both halves pass the guard; None tells the caller to take
    gate_up → silu·mul → down."""
    if type(gate_up) is not QuantizedFusedLinear or type(down) is not QuantizedLinear:
        return None
    split = gate_up.split_sizes
    if len(split) != 2 or split[0] != split[1]:
        return None
    if gate_up.bias is not None or down.bias is not None:
        return None
    if gate_up.bits != down.bits or gate_up.group_size != down.group_size:
        return None
    if not x.is_cuda:
        return None
    if not fused_mlp_routable(gate_up.bits, gate_up.group_size, x.shape[-1], split[0],
                              down.weight.shape[0], _rows(x)):
        return None
    return quantized_mlp(x, gate_up.weight, gate_up.scales, gate_up.biases,
                         down.weight, down.scales, down.biases,
                         bits=gate_up.bits, group_size=gate_up.group_size)


def fuse_quantized_projections(model: nn.Module) -> int:
    """Row-stack q/k/v and gate/up on every module that declares
    `_FUSE_GROUPS = ((fused_attr, (names…)), …)`: each group of fusable
    QuantizedLinears becomes one `QuantizedFusedLinear` under `fused_attr`,
    and the originals go. Run after loading. Returns the groups fused."""
    fused = 0
    for mod in list(model.modules()):
        if getattr(mod, "_fuse_veto", False):
            continue
        for fused_attr, names in getattr(type(mod), "_FUSE_GROUPS", ()):
            lins = [getattr(mod, n, None) for n in names]
            if any(l is None for l in lins) or not QuantizedFusedLinear.fusable(lins):
                continue
            setattr(mod, fused_attr, QuantizedFusedLinear.from_siblings(lins))
            for n in names:
                delattr(mod, n)
            fused += 1
    return fused


class QuantizedEmbedding(nn.Module):
    def __init__(self, num_embeddings: int, dims: int, group_size: int = 64,
                 bits: int = 4, device=None):
        super().__init__()
        if bits in (3, 6):
            w = torch.zeros(num_embeddings, dims * bits // 8, dtype=torch.uint8, device=device)
        else:
            w = torch.zeros(num_embeddings, dims // (32 // bits), dtype=torch.int32,
                            device=device)
        self.weight = _param(w)
        self.scales = _param(torch.ones(num_embeddings, dims // group_size, device=device))
        self.biases = _param(torch.zeros(num_embeddings, dims // group_size, device=device))
        self.group_size = group_size
        self.bits = bits

    @classmethod
    def from_embedding(cls, emb: Embedding, group_size: int = 64, bits: int = 4,
                       quantize: bool = True):
        n, d = emb.weight.shape
        obj = cls(n, d, group_size=group_size, bits=bits, device=emb.weight.device)
        if quantize:
            packed, scales, biases = quantize_arrays(emb.weight, group_size, bits)
            obj.weight = _param(packed)
            obj.scales = _param(scales)
            obj.biases = _param(biases)
        return obj

    def dequantized_weight(self, dtype=torch.bfloat16) -> torch.Tensor:
        return dequantize_arrays(self.weight, self.scales, self.biases,
                                 self.group_size, self.bits, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # gather the packed rows first, then dequantize only those (float32);
        # the ids clamp as the JAX package's gather clamps them
        x = clamp_ids(x, self.weight.shape[0])
        return dequantize_arrays(self.weight[x], self.scales[x], self.biases[x],
                                 self.group_size, self.bits, torch.float32)

    def as_linear(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.dequantized_weight(x.dtype))


def quantize_module(model: nn.Module, group_size: int = 64, bits: int = 4,
                    predicate=None, quantize: bool = True) -> nn.Module:
    """Replace Linear/Embedding submodules with quantized ones in place.

    `predicate(path, module)` may veto (False/None), accept (True) or
    override ({"group_size", "bits"}) per layer; `path` is the dotted name,
    as the JAX package gives it. `quantize=False` swaps in the quantized
    layout without quantizing the current weights (the loader's case: a
    checkpoint fills them in)."""

    def maybe_swap(v, path):
        if not isinstance(v, (Linear, Embedding)):
            return None
        gs, b = group_size, bits
        if predicate is not None:
            r = predicate(path, v)
            if r is False or r is None:
                return None
            if isinstance(r, dict):
                gs = r.get("group_size", gs)
                b = r.get("bits", b)
        if v.weight.shape[-1] % gs != 0 or b not in SUPPORTED_BITS:
            return None
        if isinstance(v, Linear):
            return QuantizedLinear.from_linear(v, gs, b, quantize=quantize)
        return QuantizedEmbedding.from_embedding(v, gs, b, quantize=quantize)

    def visit(mod, prefix):
        for name, child in list(mod.named_children()):
            path = f"{prefix}.{name}" if prefix else name
            new = maybe_swap(child, path)
            if new is not None:
                setattr(mod, name, new)
            else:
                visit(child, path)

    visit(model, "")
    return model
