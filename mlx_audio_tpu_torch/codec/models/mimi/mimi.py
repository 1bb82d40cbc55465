"""Mimi: a streaming SEANet + transformer codec with a split residual VQ
(counterpart of `mlx_audio_tpu/codec/models/mimi/mimi.py`, with the same
parameter names and the same configuration).

As in the JAX package, every streamable module has `init_state(batch)` and
`step(x, state) -> (y, state)` with fixed-size carry buffers: the causal
left pad lives in a zero-initialised convolution tail, the transposed
convolutions carry their overlap-add tail, and the windowed transformer
keeps a `RingKVCache` with absolute positions. Here the steps run eagerly;
the ring caches update in place, so a state is consumed by the step that
takes it (the JAX package's functional states can be reused). Channels-last
inside; the public API keeps (B, C, T).

A streaming step is one 12.5 Hz frame (1920 samples at 24 kHz). The
streaming encoder starts the `edge`-padded downsample from a zero tail,
where the offline call repeats the first sample, so the two may part on the
first frame, as in the JAX package.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ....device import resolve_device
from ....lm.cache import RingKVCache
from ....nn import Conv1d, ConvTranspose1d, LayerNorm, Linear
from ....nn.module import init_weights
from ....ops.rope import apply_rope, rope_cos_sin

__all__ = ["Mimi", "MimiConfig", "mimi_202407", "MimiStreamingDecoder", "SeanetConfig",
           "TransformerConfig"]

DEFAULT_FILENAME = "tokenizer-e351c8d8-checkpoint125.safetensors"


@dataclass
class SeanetConfig:
    dimension: int = 512
    channels: int = 1
    causal: bool = True
    nfilters: int = 64
    nresidual_layers: int = 1
    ratios: List[int] = field(default_factory=lambda: [8, 6, 5, 4])
    ksize: int = 7
    residual_ksize: int = 3
    last_ksize: int = 3
    dilation_base: int = 2
    pad_mode: str = "constant"
    true_skip: bool = True
    compress: int = 2


@dataclass
class TransformerConfig:
    d_model: int = 512
    num_heads: int = 8
    num_layers: int = 8
    layer_scale: Optional[float] = 0.01
    context: int = 250
    max_period: float = 10000.0
    dim_feedforward: int = 2048
    gating: bool = False
    norm: str = "layer_norm"
    positional_embedding: str = "rope"
    bias_ff: bool = False
    bias_attn: bool = False
    kv_repeat: int = 1
    max_seq_len: int = 8192
    conv_layout: bool = True

    @property
    def head_dim(self) -> int:
        return self.d_model // self.num_heads


@dataclass
class MimiConfig:
    channels: int = 1
    sample_rate: float = 24000.0
    frame_rate: float = 12.5
    renormalize: bool = True
    seanet: SeanetConfig = field(default_factory=SeanetConfig)
    transformer: TransformerConfig = field(default_factory=TransformerConfig)
    quantizer_nq: int = 16
    quantizer_bins: int = 2048
    quantizer_dim: int = 256


def mimi_202407(num_codebooks: int) -> MimiConfig:
    return MimiConfig(quantizer_nq=num_codebooks)


def elu(x):
    return F.elu(x, 1.0)


# ---------------------------------------------------------------------------
# Streamable convolutions
# ---------------------------------------------------------------------------


class StreamableConv1d(nn.Module):
    """A causal convolution with a streaming tail. The offline call pads as
    the reference does (causal left pad and the extra right pad that makes
    the frame count whole)."""

    def __init__(self, in_channels, out_channels, ksize, stride, dilation, groups, bias,
                 causal, pad_mode, device=None):
        super().__init__()
        self.conv = Conv1d(in_channels, out_channels, ksize, stride=stride,
                           dilation=dilation, groups=groups, bias=bias, device=device)
        self.causal = causal
        self.pad_mode = pad_mode
        self.ksize = ksize
        self.stride = stride
        self.dilation = dilation
        self.out_channels = out_channels

    @property
    def _keff(self):
        return (self.ksize - 1) * self.dilation + 1

    def forward(self, x):  # (B, T, C)
        keff = self._keff
        padding_total = keff - self.stride
        L = x.shape[1]
        nframes = max(L + padding_total - keff, 0) / self.stride + 1.0
        ideal = (int(math.ceil(nframes)) - 1) * self.stride + keff - padding_total
        extra = max(0, ideal - L)
        if self.causal:
            pl, pr = padding_total, extra
        else:
            pr = padding_total // 2
            pl = padding_total - pr
            pr += extra
        if self.pad_mode == "edge":
            x = torch.cat([x[:, :1].expand(-1, pl, -1), x, x[:, -1:].expand(-1, pr, -1)],
                          dim=1)
        else:
            x = F.pad(x, (0, 0, pl, pr))
        return self.conv(x)

    def init_state(self, batch: int, in_channels: int, device=None, dtype=torch.float32):
        pad = self._keff - self.stride
        return torch.zeros(batch, max(pad, 0), in_channels, device=device, dtype=dtype)

    def step(self, x, state):
        """x (B, S, C) with S divisible by the stride; state (B, pad, C)."""
        buf = torch.cat([state.to(x.dtype), x], dim=1)
        y = self.conv(buf)
        pad = self._keff - self.stride
        new_state = buf[:, buf.shape[1] - pad:] if pad > 0 else buf[:, :0]
        return y, new_state


class StreamableConvTranspose1d(nn.Module):
    def __init__(self, in_channels, out_channels, ksize, stride, groups, bias, causal,
                 device=None):
        super().__init__()
        self.convtr = ConvTranspose1d(in_channels, out_channels, ksize, stride=stride,
                                      groups=groups, bias=bias, device=device)
        self.causal = causal
        self.ksize = ksize
        self.stride = stride
        self.out_channels = out_channels

    def forward(self, x):
        pad_total = max(self.ksize - self.stride, 0)
        y = self.convtr(x)
        if self.causal:
            ul, ur = 0, pad_total
        else:
            ur = pad_total // 2
            ul = pad_total - ur
        return y[:, ul:y.shape[1] - ur]

    def init_state(self, batch: int, device=None, dtype=torch.float32):
        return torch.zeros(batch, max(self.ksize - self.stride, 0), self.out_channels,
                           device=device, dtype=dtype)

    def step(self, x, state):
        """x (B, S, C): the overlap-add of the transposed convolution's
        tails. The carried tail is what the offline call adds to the next
        frames, the bias taken out (the next step adds it again)."""
        y = self.convtr(x)  # (B, (S-1)·stride + ksize, C)
        tail = self.ksize - self.stride
        pt = state.shape[1]
        if pt > 0:
            y = torch.cat([y[:, :pt] + state.to(y.dtype), y[:, pt:]], dim=1)
        out_len = y.shape[1] - tail
        new_state = y[:, out_len:]
        if self.convtr.bias is not None:
            new_state = new_state - self.convtr.bias.to(y.dtype)
        return y[:, :out_len], new_state


# ---------------------------------------------------------------------------
# SEANet
# ---------------------------------------------------------------------------


class SeanetResnetBlock(nn.Module):
    def __init__(self, cfg: SeanetConfig, dim: int, ksizes_and_dilations, device=None):
        super().__init__()
        hidden = dim // cfg.compress
        block = []
        for i, (ksize, dilation) in enumerate(ksizes_and_dilations):
            in_c = dim if i == 0 else hidden
            out_c = dim if i == len(ksizes_and_dilations) - 1 else hidden
            block.append(StreamableConv1d(in_c, out_c, ksize, 1, dilation, 1, True,
                                          cfg.causal, cfg.pad_mode, device=device))
        self.block = nn.ModuleList(block)

    def forward(self, x):
        residual = x
        for b in self.block:
            x = b(elu(x))
        return x + residual

    def init_state(self, batch, dim, device=None):
        states = []
        in_c = dim
        for b in self.block:
            states.append(b.init_state(batch, in_c, device))
            in_c = b.out_channels
        return states

    def step(self, x, states):
        residual = x
        new_states = []
        for b, s in zip(self.block, states):
            x, ns = b.step(elu(x), s)
            new_states.append(ns)
        return x + residual, new_states


class EncoderLayer(nn.Module):
    def __init__(self, cfg: SeanetConfig, ratio: int, mult: int, device=None):
        super().__init__()
        dilation = 1
        residuals = []
        for _ in range(cfg.nresidual_layers):
            residuals.append(SeanetResnetBlock(cfg, mult * cfg.nfilters,
                                               [(cfg.residual_ksize, dilation), (1, 1)],
                                               device=device))
            dilation *= cfg.dilation_base
        self.residuals = nn.ModuleList(residuals)
        self.downsample = StreamableConv1d(mult * cfg.nfilters, mult * cfg.nfilters * 2,
                                           ratio * 2, ratio, 1, 1, True, True, cfg.pad_mode,
                                           device=device)
        self.dim = mult * cfg.nfilters

    def forward(self, x):
        for r in self.residuals:
            x = r(x)
        return self.downsample(elu(x))

    def init_state(self, batch, device=None):
        return {"res": [r.init_state(batch, self.dim, device) for r in self.residuals],
                "down": self.downsample.init_state(batch, self.dim, device)}

    def step(self, x, state):
        res_states = []
        for r, s in zip(self.residuals, state["res"]):
            x, ns = r.step(x, s)
            res_states.append(ns)
        y, ds = self.downsample.step(elu(x), state["down"])
        return y, {"res": res_states, "down": ds}


class SeanetEncoder(nn.Module):
    def __init__(self, cfg: SeanetConfig, device=None):
        super().__init__()
        mult = 1
        self.init_conv1d = StreamableConv1d(cfg.channels, mult * cfg.nfilters, cfg.ksize, 1, 1,
                                            1, True, cfg.causal, cfg.pad_mode, device=device)
        layers = []
        for ratio in reversed(cfg.ratios):
            layers.append(EncoderLayer(cfg, ratio, mult, device=device))
            mult *= 2
        self.layers = nn.ModuleList(layers)
        self.final_conv1d = StreamableConv1d(mult * cfg.nfilters, cfg.dimension,
                                             cfg.last_ksize, 1, 1, 1, True, cfg.causal,
                                             cfg.pad_mode, device=device)
        self.channels = cfg.channels
        self.final_in = mult * cfg.nfilters

    def forward(self, x):
        x = self.init_conv1d(x)
        for layer in self.layers:
            x = layer(x)
        return self.final_conv1d(elu(x))

    def init_state(self, batch, device=None):
        return {"init": self.init_conv1d.init_state(batch, self.channels, device),
                "layers": [layer.init_state(batch, device) for layer in self.layers],
                "final": self.final_conv1d.init_state(batch, self.final_in, device)}

    def step(self, x, state):
        x, s_init = self.init_conv1d.step(x, state["init"])
        s_layers = []
        for layer, s in zip(self.layers, state["layers"]):
            x, ns = layer.step(x, s)
            s_layers.append(ns)
        y, s_final = self.final_conv1d.step(elu(x), state["final"])
        return y, {"init": s_init, "layers": s_layers, "final": s_final}


class DecoderLayer(nn.Module):
    def __init__(self, cfg: SeanetConfig, ratio: int, mult: int, device=None):
        super().__init__()
        self.upsample = StreamableConvTranspose1d(mult * cfg.nfilters,
                                                  mult * cfg.nfilters // 2, ratio * 2, ratio,
                                                  1, True, cfg.causal, device=device)
        dilation = 1
        residuals = []
        for _ in range(cfg.nresidual_layers):
            residuals.append(SeanetResnetBlock(cfg, mult * cfg.nfilters // 2,
                                               [(cfg.residual_ksize, dilation), (1, 1)],
                                               device=device))
            dilation *= cfg.dilation_base
        self.residuals = nn.ModuleList(residuals)
        self.dim_out = mult * cfg.nfilters // 2

    def forward(self, x):
        x = self.upsample(elu(x))
        for r in self.residuals:
            x = r(x)
        return x

    def init_state(self, batch, device=None):
        return {"up": self.upsample.init_state(batch, device),
                "res": [r.init_state(batch, self.dim_out, device) for r in self.residuals]}

    def step(self, x, state):
        x, s_up = self.upsample.step(elu(x), state["up"])
        s_res = []
        for r, s in zip(self.residuals, state["res"]):
            x, ns = r.step(x, s)
            s_res.append(ns)
        return x, {"up": s_up, "res": s_res}


class SeanetDecoder(nn.Module):
    def __init__(self, cfg: SeanetConfig, device=None):
        super().__init__()
        mult = 1 << len(cfg.ratios)
        self.init_conv1d = StreamableConv1d(cfg.dimension, mult * cfg.nfilters, cfg.ksize, 1,
                                            1, 1, True, cfg.causal, cfg.pad_mode, device=device)
        layers = []
        for ratio in cfg.ratios:
            layers.append(DecoderLayer(cfg, ratio, mult, device=device))
            mult //= 2
        self.layers = nn.ModuleList(layers)
        self.final_conv1d = StreamableConv1d(cfg.nfilters, cfg.channels, cfg.last_ksize, 1, 1,
                                             1, True, cfg.causal, cfg.pad_mode, device=device)
        self.dimension = cfg.dimension
        self.nfilters = cfg.nfilters

    def forward(self, x):
        x = self.init_conv1d(x)
        for layer in self.layers:
            x = layer(x)
        return self.final_conv1d(elu(x))

    def init_state(self, batch, device=None):
        return {"init": self.init_conv1d.init_state(batch, self.dimension, device),
                "layers": [layer.init_state(batch, device) for layer in self.layers],
                "final": self.final_conv1d.init_state(batch, self.nfilters, device)}

    def step(self, x, state):
        x, s_init = self.init_conv1d.step(x, state["init"])
        s_layers = []
        for layer, s in zip(self.layers, state["layers"]):
            x, ns = layer.step(x, s)
            s_layers.append(ns)
        y, s_final = self.final_conv1d.step(elu(x), state["final"])
        return y, {"init": s_init, "layers": s_layers, "final": s_final}


# ---------------------------------------------------------------------------
# Transformer (context-windowed, rope)
# ---------------------------------------------------------------------------


class LayerScale(nn.Module):
    def __init__(self, dim: int, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.empty(dim, device=device))

    def reset_parameters(self, generator=None) -> None:
        self.scale.data.fill_(1.0)

    def forward(self, x):
        return self.scale.to(x.dtype) * x


class MimiAttention(nn.Module):
    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        self.in_proj = Linear(cfg.d_model, 3 * cfg.d_model, bias=cfg.bias_attn, device=device)
        self.out_proj = Linear(cfg.d_model, cfg.d_model, bias=cfg.bias_attn, device=device)
        self.num_heads = cfg.num_heads
        self.head_dim = cfg.head_dim
        self.context = cfg.context
        self.max_period = cfg.max_period

    def forward(self, x, cache: Optional[RingKVCache] = None, pos0: int = 0):
        B, T, D = x.shape
        qkv = self.in_proj(x).reshape(B, T, 3, self.num_heads, self.head_dim)
        q = qkv[:, :, 0].transpose(1, 2)
        k = qkv[:, :, 1].transpose(1, 2)
        v = qkv[:, :, 2].transpose(1, 2)
        positions = pos0 + torch.arange(T, device=x.device)
        cos, sin = rope_cos_sin(positions, self.head_dim, base=self.max_period)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        if cache is not None:
            k, v, cache = cache.update(k, v)
            mask = cache.attention_mask(T, self.context, pos0)
        else:
            delta = (torch.arange(T, device=x.device)[:, None]
                     - torch.arange(T, device=x.device)[None, :])
            ok = (delta >= 0) & (delta < self.context)
            mask = torch.where(ok, torch.zeros((), device=x.device), float("-inf"))[None, None]
        # float32 scores from the operands' dtype, as the JAX einsum's
        # preferred_element_type=float32
        scores = torch.matmul((q * self.head_dim ** -0.5).float(), k.float().transpose(-1, -2))
        probs = torch.softmax(scores + mask, dim=-1).to(v.dtype)
        out = torch.matmul(probs, v).to(x.dtype)
        return self.out_proj(out.transpose(1, 2).reshape(B, T, D)), cache


class MlpNoGating(nn.Module):
    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        self.linear1 = Linear(cfg.d_model, cfg.dim_feedforward, bias=cfg.bias_ff, device=device)
        self.linear2 = Linear(cfg.dim_feedforward, cfg.d_model, bias=cfg.bias_ff, device=device)

    def forward(self, x):
        return self.linear2(F.gelu(self.linear1(x), approximate="tanh"))


class MimiTransformerLayer(nn.Module):
    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        self.gating = MlpNoGating(cfg, device=device)
        self.norm1 = LayerNorm(cfg.d_model, device=device)
        self.norm2 = LayerNorm(cfg.d_model, device=device)
        if cfg.layer_scale is not None:
            self.layer_scale_1 = LayerScale(cfg.d_model, device=device)
            self.layer_scale_2 = LayerScale(cfg.d_model, device=device)
        self.self_attn = MimiAttention(cfg, device=device)

    def forward(self, x, cache=None, pos0: int = 0):
        a, cache = self.self_attn(self.norm1(x), cache, pos0)
        if hasattr(self, "layer_scale_1"):
            a = self.layer_scale_1(a)
        x = x + a
        m = self.gating(self.norm2(x))
        if hasattr(self, "layer_scale_2"):
            m = self.layer_scale_2(m)
        return x + m, cache


class ProjectedTransformer(nn.Module):
    def __init__(self, cfg: TransformerConfig, input_dim: int, output_dims, device=None):
        super().__init__()
        self.transformer_layers = nn.ModuleList(MimiTransformerLayer(cfg, device=device)
                                                for _ in range(cfg.num_layers))
        if input_dim != cfg.d_model:
            self.input_proj = Linear(input_dim, cfg.d_model, bias=False, device=device)
        # the JAX package's list holds None where an output needs no
        # projection: a dict keyed by the index keeps its parameter names
        self.output_projs = nn.ModuleDict({
            str(i): Linear(cfg.d_model, od, bias=False, device=device)
            for i, od in enumerate(output_dims) if od != cfg.d_model})
        self.n_outputs = len(output_dims)
        self.cfg = cfg

    def forward(self, x, caches=None, pos0: int = 0):  # x (B, T, C)
        if hasattr(self, "input_proj"):
            x = self.input_proj(x)
        for i, layer in enumerate(self.transformer_layers):
            x, _ = layer(x, caches[i] if caches is not None else None, pos0)
        outs = [self.output_projs[str(i)](x) if str(i) in self.output_projs else x
                for i in range(self.n_outputs)]
        return outs, caches

    def make_cache(self, batch: int, device=None) -> List[RingKVCache]:
        cfg = self.cfg
        return [RingKVCache(batch, cfg.num_heads, cfg.context, cfg.head_dim, device=device)
                for _ in self.transformer_layers]


# ---------------------------------------------------------------------------
# Quantization
# ---------------------------------------------------------------------------


class EuclideanCodebook(nn.Module):
    def __init__(self, dim: int, codebook_size: int, device=None):
        super().__init__()
        self.embedding_sum = nn.Parameter(torch.empty(codebook_size, dim, device=device))
        self.cluster_usage = nn.Parameter(torch.empty(codebook_size, device=device))
        self.initialized = nn.Parameter(torch.empty(1, device=device))
        self.epsilon = 1e-5

    def reset_parameters(self, generator=None) -> None:
        # the JAX package's constants: an empty codebook of unit usage
        self.embedding_sum.data.zero_()
        self.cluster_usage.data.fill_(1.0)
        self.initialized.data.zero_()

    @property
    def embedding(self):
        usage = self.cluster_usage.clamp(min=self.epsilon)[:, None]
        return self.embedding_sum / usage

    def encode(self, x):  # (..., D) → indices
        emb = self.embedding.float()
        c2 = (emb * emb).sum(-1) / 2
        dot = torch.matmul(x.float(), emb.T)
        return torch.argmin(c2 - dot, dim=-1)

    def decode(self, idx):
        # a code past the bins (CSM's heads draw 2051 ways over Mimi's 2048)
        # takes the last row, as the JAX package's gather clamps it
        n = self.embedding_sum.shape[0]
        return self.embedding[idx.clamp(-n, n - 1)]


class VectorQuantization(nn.Module):
    def __init__(self, dim: int, codebook_size: int, device=None):
        super().__init__()
        self.codebook = EuclideanCodebook(dim, codebook_size, device=device)

    def encode(self, x):
        return self.codebook.encode(x)

    def decode(self, idx):
        return self.codebook.decode(idx)


class ResidualVectorQuantizer(nn.Module):
    def __init__(self, dim, input_dim, output_dim, nq, bins, force_projection=True,
                 device=None):
        super().__init__()
        input_dim = input_dim or dim
        output_dim = output_dim or dim
        if input_dim != dim or force_projection:
            self.input_proj = Linear(input_dim, dim, bias=False, device=device)
        if output_dim != dim or force_projection:
            self.output_proj = Linear(dim, output_dim, bias=False, device=device)
        self.layers = nn.ModuleList(VectorQuantization(dim, bins, device=device)
                                    for _ in range(nq))

    def encode(self, x):  # (B, T, D_in) → (B, nq, T)
        if hasattr(self, "input_proj"):
            x = self.input_proj(x)
        codes = []
        residual = x
        for layer in self.layers:
            idx = layer.encode(residual)
            residual = residual - layer.decode(idx)
            codes.append(idx)
        return torch.stack(codes, dim=1)

    def decode(self, codes):  # (B, nq, T) → (B, T, D_out)
        q = None
        for i in range(codes.shape[1]):
            d = self.layers[i].decode(codes[:, i])
            q = d if q is None else q + d
        if hasattr(self, "output_proj"):
            q = self.output_proj(q)
        return q


class SplitResidualVectorQuantizer(nn.Module):
    def __init__(self, dim, input_dim, output_dim, nq, bins, device=None):
        super().__init__()
        self.rvq_first = ResidualVectorQuantizer(dim, input_dim, output_dim, 1, bins,
                                                 force_projection=True, device=device)
        self.rvq_rest = ResidualVectorQuantizer(dim, input_dim, output_dim, nq - 1, bins,
                                                force_projection=True, device=device)
        self.nq = nq

    def encode(self, x):
        codes = self.rvq_first.encode(x)
        if self.nq > 1:
            codes = torch.cat([codes, self.rvq_rest.encode(x)], dim=1)
        return codes

    def decode(self, codes):
        q = self.rvq_first.decode(codes[:, :1])
        if self.nq > 1:
            q = q + self.rvq_rest.decode(codes[:, 1:])
        return q


# ---------------------------------------------------------------------------
# Mimi
# ---------------------------------------------------------------------------


def _squeeze_last(v):
    return v[..., 0]


def _concat0(parts):
    if isinstance(parts[0], torch.Tensor):
        return torch.cat([torch.as_tensor(p) for p in parts], dim=0)
    return np.concatenate([np.asarray(p) for p in parts], axis=0)


def _hf_mimi_to_kyutai(weights: dict) -> dict:
    """transformers `MimiModel` state-dict names → the kyutai names the
    main sanitize loop reads; the split q/k/v projections packed into the
    fused in_proj and the quantizers' 1×1 convolutions squeezed to Linears.
    Values may be numpy arrays or torch tensors."""
    out = {}
    qkv = {}
    dec_idxs = [int(mm.group(1)) for kk in weights
                if (mm := re.match(r"decoder\.layers\.(\d+)\.", kk))]
    for k, v in weights.items():
        if not isinstance(v, torch.Tensor):
            v = np.asarray(v)
        nk = (
            k.replace("encoder.layers.", "encoder.model.")
            .replace("decoder.layers.", "decoder.model.")
            .replace("quantizer.semantic_residual_vector_quantizer.", "quantizer.rvq_first.")
            .replace("quantizer.acoustic_residual_vector_quantizer.", "quantizer.rvq_rest.")
            .replace(".codebook.embed_sum", ".codebook.embedding_sum")
            .replace("_transformer.layers.", "_transformer.transformer_layers.")
            .replace(".self_attn.o_proj.", ".self_attn.out_proj.")
            .replace(".mlp.fc1.", ".linear1.")  # the main loop adds .gating.
            .replace(".mlp.fc2.", ".linear2.")
            .replace(".input_layernorm.", ".norm1.")
            .replace(".post_attention_layernorm.", ".norm2.")
            .replace(".self_attn_layer_scale.", ".layer_scale_1.")
            .replace(".mlp_layer_scale.", ".layer_scale_2.")
            .replace("upsample.conv.", "upsample.convtr.")
        )
        # the SEANet decoder's transposed convolutions are `.conv` in the
        # transformers names, `.convtr` in kyutai's: indices 2, 5, 8, … of
        # the flat decoder list, the final convolution aside
        m = re.match(r"decoder\.model\.(\d+)\.conv\.(.*)$", nk)
        if m and int(m.group(1)) >= 2 and (int(m.group(1)) - 2) % 3 == 0:
            if int(m.group(1)) < max(dec_idxs):
                nk = f"decoder.model.{m.group(1)}.convtr.{m.group(2)}"
        if ".self_attn." in nk and any(f".{p}_proj." in nk for p in ("q", "k", "v")):
            qkv[nk] = v
            continue
        if (".input_proj." in nk or ".output_proj." in nk) and v.ndim == 3:
            v = _squeeze_last(v)  # a 1×1 convolution → the Linear
        if nk.endswith(".codebook.initialized"):
            v = (v.reshape(1).float() if isinstance(v, torch.Tensor)
                 else v.reshape((1,)).astype(np.float32))
        out[nk] = v
    for qk in [k for k in qkv if ".q_proj." in k]:
        out[qk.replace(".q_proj.", ".in_proj.")] = _concat0(
            [qkv[qk], qkv[qk.replace(".q_proj.", ".k_proj.")],
             qkv[qk.replace(".q_proj.", ".v_proj.")]])
    return out


class Mimi(nn.Module):
    """Mimi on an explicit device (None: the card), in float32, with seeded
    weights drawn as the JAX package's initialisers draw them."""

    def __init__(self, cfg: MimiConfig, device=None, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.device = dev
        dim = cfg.seanet.dimension
        self.cfg = cfg
        encoder_frame_rate = cfg.sample_rate / math.prod(cfg.seanet.ratios)
        downsample_stride = int(encoder_frame_rate / cfg.frame_rate)
        self.encoder = SeanetEncoder(cfg.seanet, device=dev)
        self.decoder = SeanetDecoder(cfg.seanet, device=dev)
        self.quantizer = SplitResidualVectorQuantizer(
            dim=cfg.quantizer_dim, input_dim=dim, output_dim=dim, nq=cfg.quantizer_nq,
            bins=cfg.quantizer_bins, device=dev)
        self.encoder_transformer = ProjectedTransformer(cfg.transformer, input_dim=dim,
                                                        output_dims=[dim], device=dev)
        self.decoder_transformer = ProjectedTransformer(cfg.transformer, input_dim=dim,
                                                        output_dims=[dim], device=dev)
        self.downsample = StreamableConv1d(dim, dim, 2 * downsample_stride, downsample_stride,
                                           1, 1, False, True, "edge", device=dev)
        self.upsample = StreamableConvTranspose1d(dim, dim, 2 * downsample_stride,
                                                  downsample_stride, dim, False, True,
                                                  device=dev)
        self.downsample_stride = downsample_stride
        self.dim = dim
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        init_weights(self, gen)

    @property
    def frame_rate(self) -> float:
        return self.cfg.frame_rate

    @property
    def sample_rate(self) -> float:
        return self.cfg.sample_rate

    @property
    def frame_size(self) -> int:
        return int(self.cfg.sample_rate / self.cfg.frame_rate)

    def _input(self, x, dtype=None) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            return x.to(self.device, dtype) if dtype is not None else x.to(self.device)
        return torch.as_tensor(np.asarray(x), device=self.device, dtype=dtype)

    # ---- offline ----

    @torch.inference_mode()
    def encode(self, xs) -> torch.Tensor:
        """xs (B, 1, T) → codes (B, K, T') (int64, on the model's device)."""
        x = self._input(xs, torch.float32).transpose(1, 2)
        h = self.encoder(x)
        outs, _ = self.encoder_transformer(h)
        return self.quantizer.encode(self.downsample(outs[0]))

    @torch.inference_mode()
    def decode(self, codes) -> torch.Tensor:
        """codes (B, K, T') → audio (B, 1, T)."""
        h = self.quantizer.decode(self._input(codes).long())
        h = self.upsample(h)
        outs, _ = self.decoder_transformer(h)
        return self.decoder(outs[0]).transpose(1, 2)

    # ---- streaming ----

    def init_decode_state(self, batch: int = 1) -> dict:
        dev = self.device
        return {"decoder": self.decoder.init_state(batch, dev),
                "upsample": self.upsample.init_state(batch, dev),
                "caches": self.decoder_transformer.make_cache(batch, dev),
                "pos": 0}

    def init_encode_state(self, batch: int = 1) -> dict:
        dev = self.device
        return {"encoder": self.encoder.init_state(batch, dev),
                "downsample": self.downsample.init_state(batch, self.dim, dev),
                "caches": self.encoder_transformer.make_cache(batch, dev),
                "pos": 0}

    @torch.inference_mode()
    def decode_step(self, codes, state: dict):
        """codes (B, K, t) → (audio (B, 1, t·frame_size), state)."""
        h = self.quantizer.decode(self._input(codes).long())
        h, s_up = self.upsample.step(h, state["upsample"])
        outs, caches = self.decoder_transformer(h, state["caches"], pos0=state["pos"])
        y, s_dec = self.decoder.step(outs[0], state["decoder"])
        new_state = {"decoder": s_dec, "upsample": s_up, "caches": caches,
                     "pos": state["pos"] + h.shape[1]}
        return y.transpose(1, 2), new_state

    @torch.inference_mode()
    def encode_step(self, xs, state: dict):
        """xs (B, 1, t·frame_size) → (codes (B, K, t), state)."""
        x = self._input(xs, torch.float32).transpose(1, 2)
        h, s_enc = self.encoder.step(x, state["encoder"])
        outs, caches = self.encoder_transformer(h, state["caches"], pos0=state["pos"])
        h2, s_down = self.downsample.step(outs[0], state["downsample"])
        codes = self.quantizer.encode(h2)
        new_state = {"encoder": s_enc, "downsample": s_down, "caches": caches,
                     "pos": state["pos"] + h.shape[1]}
        return codes, new_state

    # ---- loading ----

    def sanitize(self, weights: dict) -> dict:
        """kyutai / moshi torch names → the JAX package's (its index map of
        the SEANet lists), convolution weights oriented to its layouts; a
        transformers `MimiModel` state dict is renamed first."""
        from ....nn.sanitize import orient_weights_to_model

        if any("semantic_residual_vector_quantizer" in k for k in weights):
            weights = _hf_mimi_to_kyutai(weights)
        out = {}
        for k, v in weights.items():
            k = ".".join(s.removeprefix("_") for s in k.split("."))
            k = k.replace("encoder.model.", "encoder.").replace("decoder.model.", "decoder.")
            k = k.replace(".in_proj_weight", ".in_proj.weight")
            k = k.replace(".linear1.weight", ".gating.linear1.weight")
            k = k.replace(".linear2.weight", ".gating.linear2.weight")
            for layer_idx, dec_idx in enumerate([2, 5, 8, 11]):
                k = k.replace(f"decoder.{dec_idx}.", f"decoder.layers.{layer_idx}.upsample.")
                k = k.replace(f"decoder.{dec_idx + 1}.",
                              f"decoder.layers.{layer_idx}.residuals.0.")
            for layer_idx, enc_idx in enumerate([1, 4, 7, 10]):
                k = k.replace(f"encoder.{enc_idx}.", f"encoder.layers.{layer_idx}.residuals.0.")
                k = k.replace(f"encoder.{enc_idx + 2}.",
                              f"encoder.layers.{layer_idx}.downsample.")
            k = k.replace("decoder.0.", "decoder.init_conv1d.")
            k = k.replace("decoder.14.", "decoder.final_conv1d.")
            k = k.replace("encoder.0.", "encoder.init_conv1d.")
            k = k.replace("encoder.14.", "encoder.final_conv1d.")
            k = k.replace(".block.1.", ".block.0.")
            k = k.replace(".block.3.", ".block.1.")
            k = k.replace("transformer.layers.", "transformer_layers.")
            # the reference's NormConv wrappers: .conv.conv / .convtr.convtr
            k = k.replace(".conv.conv.", ".conv.")
            k = k.replace(".convtr.convtr.", ".convtr.")
            out[k] = v
        return orient_weights_to_model(self, out)

    @classmethod
    def from_pretrained(cls, repo_id: str, filename: str = DEFAULT_FILENAME,
                        num_codebooks: int = 32, device=None) -> "Mimi":
        """Mimi at `mimi_202407(num_codebooks)` from a local directory that
        holds `filename` (kyutai's or transformers' safetensors names), or
        from that file itself. A hub id raises: the port does not
        download."""
        from ....nn.module import load_weights
        from ....safetensors_io import load_file
        from ....utils import get_model_path

        path = get_model_path(repo_id)
        model_file = path if path.is_file() else Path(path) / filename
        if not model_file.is_file():
            raise FileNotFoundError(f"no Mimi weights at {model_file}")
        model = cls(mimi_202407(num_codebooks), device=device)
        weights = model.sanitize(load_file(model_file))
        return load_weights(model, weights, strict=False).eval()


class MimiStreamingDecoder:
    """Incremental decoder: keeps the decode state across calls and decodes
    frames as they come."""

    def __init__(self, mimi: Mimi, batch: int = 1):
        self._mimi = mimi
        self._batch = batch
        self.reset()

    def reset(self):
        self._state = self._mimi.init_decode_state(self._batch)

    def decode_frames(self, tokens) -> torch.Tensor:
        tokens = self._mimi._input(tokens)
        if tokens.dim() == 2:
            tokens = tokens[None]
        pcm, self._state = self._mimi.decode_step(tokens, self._state)
        return pcm
