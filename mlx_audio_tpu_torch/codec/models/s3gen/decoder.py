"""The conditional U-Net velocity estimator of S3Gen's flow-matching decoder
(counterpart of `mlx_audio_tpu/codec/models/s3gen/decoder.py`).

Channels-last (B, T, C) throughout. The solver calls it once an Euler step
with the [cond, uncond] pair stacked on the batch axis."""

from __future__ import annotations

import math
from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ....nn import Conv1d, ConvTranspose1d, GroupNorm, LayerNorm, Linear
from .encoder import subsequent_chunk_mask

__all__ = ["ConditionalDecoder", "mish"]


def mish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.tanh(F.softplus(x))


class SinusoidalPosEmb(nn.Module):
    """The timestep embedding; its phase is float32 whatever t's dtype."""

    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim

    def forward(self, t: torch.Tensor, scale: float = 1000.0) -> torch.Tensor:
        if t.dim() < 1:
            t = t[None]
        half = self.dim // 2
        emb = torch.exp(torch.arange(half, dtype=torch.float32, device=t.device)
                        * -(math.log(10000.0) / (half - 1)))
        emb = scale * t.float()[:, None] * emb[None, :]
        return torch.cat([torch.sin(emb), torch.cos(emb)], dim=-1).to(t.dtype)


class TimestepEmbedding(nn.Module):
    def __init__(self, in_channels: int, time_embed_dim: int, device=None):
        super().__init__()
        self.linear_1 = Linear(in_channels, time_embed_dim, device=device)
        self.linear_2 = Linear(time_embed_dim, time_embed_dim, device=device)

    def forward(self, x):
        return self.linear_2(F.silu(self.linear_1(x)))


class Block1D(nn.Module):
    """Convolution, GroupNorm, Mish; x (B, T, C), mask (B, T, 1)."""

    def __init__(self, dim: int, dim_out: int, groups: int = 8, device=None):
        super().__init__()
        self.conv = Conv1d(dim, dim_out, 3, padding=1, device=device)
        self.norm = GroupNorm(groups, dim_out, device=device)

    def forward(self, x, mask):
        return mish(self.norm(self.conv(x * mask))) * mask


class CausalBlock1D(nn.Module):
    """Left-padded convolution, LayerNorm, Mish."""

    def __init__(self, dim: int, dim_out: int, device=None):
        super().__init__()
        self.conv = Conv1d(dim, dim_out, 3, device=device)
        self.norm = LayerNorm(dim_out, device=device)

    def forward(self, x, mask):
        return mish(self.norm(self.conv(F.pad(x * mask, (0, 0, 2, 0))))) * mask


class ResnetBlock1D(nn.Module):
    def __init__(self, dim: int, dim_out: int, time_emb_dim: int, groups: int = 8,
                 causal: bool = False, device=None):
        super().__init__()
        self.mlp_linear = Linear(time_emb_dim, dim_out, device=device)
        if causal:
            self.block1 = CausalBlock1D(dim, dim_out, device=device)
            self.block2 = CausalBlock1D(dim_out, dim_out, device=device)
        else:
            self.block1 = Block1D(dim, dim_out, groups, device=device)
            self.block2 = Block1D(dim_out, dim_out, groups, device=device)
        self.res_conv = Conv1d(dim, dim_out, 1, device=device)

    def forward(self, x, mask, t_emb):
        h = self.block1(x, mask) + self.mlp_linear(mish(t_emb))[:, None, :]
        return self.block2(h, mask) + self.res_conv(x * mask)


class DiffusersAttention(nn.Module):
    def __init__(self, query_dim: int, heads: int, dim_head: int, device=None):
        super().__init__()
        self.heads = heads
        self.dim_head = dim_head
        inner = heads * dim_head
        self.query_proj = Linear(query_dim, inner, bias=False, device=device)
        self.key_proj = Linear(query_dim, inner, bias=False, device=device)
        self.value_proj = Linear(query_dim, inner, bias=False, device=device)
        self.out_proj = Linear(inner, query_dim, device=device)

    def forward(self, x, bias):
        B, T, _ = x.shape
        q, k, v = (p(x).reshape(B, T, self.heads, self.dim_head).transpose(1, 2)
                   for p in (self.query_proj, self.key_proj, self.value_proj))
        scores = q @ k.transpose(-1, -2) * self.dim_head ** -0.5 + bias
        attn = torch.softmax(scores.float(), dim=-1).to(x.dtype)
        return self.out_proj((attn @ v).transpose(1, 2).reshape(B, T, -1))


class _Sequential(nn.Module):
    """The JAX package's `nn.Sequential`: its layers under `layers.N`."""

    def __init__(self, *layers):
        super().__init__()
        self.layers = nn.ModuleList(layers)

    def forward(self, x):
        for layer in self.layers:
            x = layer(x)
        return x


class FeedForward(nn.Module):
    """`Sequential(Linear, GELU(), Linear)` (keys `layers.layers.N`); the
    GELU is exact."""

    def __init__(self, dim: int, inner_dim: int, device=None):
        super().__init__()
        self.layers = _Sequential(Linear(dim, inner_dim, device=device), nn.GELU(),
                                  Linear(inner_dim, dim, device=device))

    def forward(self, x):
        return self.layers(x)


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, head_dim: int, device=None):
        super().__init__()
        self.norm1 = LayerNorm(dim, device=device)
        self.norm3 = LayerNorm(dim, device=device)
        self.attn = DiffusersAttention(dim, num_heads, head_dim, device=device)
        self.ff = FeedForward(dim, dim * 4, device=device)

    def forward(self, x, bias):
        x = x + self.attn(self.norm1(x), bias)
        return x + self.ff(self.norm3(x))


class Downsample1D(nn.Module):
    def __init__(self, dim: int, device=None):
        super().__init__()
        self.conv = Conv1d(dim, dim, 3, stride=2, padding=1, device=device)

    def forward(self, x):
        return self.conv(x)


class Upsample1D(nn.Module):
    def __init__(self, channels: int, device=None):
        super().__init__()
        self.conv = ConvTranspose1d(channels, channels, 4, stride=2, padding=1, device=device)

    def forward(self, x):
        return self.conv(x)


class CausalConv1d(nn.Module):
    def __init__(self, dim: int, dim_out: int, kernel: int = 3, device=None):
        super().__init__()
        self.conv = Conv1d(dim, dim_out, kernel, device=device)
        self.causal_padding = kernel - 1

    def forward(self, x):
        return self.conv(F.pad(x, (0, 0, self.causal_padding, 0)))


class _UNetBlock(nn.Module):
    """A resnet, its transformers (`transformer_N`) and an optional
    resample, under the JAX package's names."""

    def __init__(self, resnet, transformer_blocks, resample=None):
        super().__init__()
        self.resnet = resnet
        for i, b in enumerate(transformer_blocks):
            setattr(self, f"transformer_{i}", b)
        self.n_transformer = len(transformer_blocks)
        if resample is not None:
            self.resample = resample

    def transformers(self):
        return [getattr(self, f"transformer_{i}") for i in range(self.n_transformer)]


class ConditionalDecoder(nn.Module):
    """The U-Net velocity estimator: inputs and outputs (B, T, C)."""

    def __init__(self, in_channels: int = 320, out_channels: int = 80, causal: bool = True,
                 channels: Optional[List[int]] = None, attention_head_dim: int = 64,
                 n_blocks: int = 4, num_mid_blocks: int = 12, num_heads: int = 8,
                 static_chunk_size: int = 50, num_decoding_left_chunks: int = -1,
                 meanflow: bool = False, device=None, **_unused):
        super().__init__()
        channels = list(channels or [256])
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.causal = causal
        self.static_chunk_size = static_chunk_size
        self.num_decoding_left_chunks = num_decoding_left_chunks
        self.meanflow = meanflow
        dev = device

        self.time_embeddings = SinusoidalPosEmb(in_channels)
        time_embed_dim = channels[0] * 4
        self.time_mlp = TimestepEmbedding(in_channels, time_embed_dim, device=dev)
        if meanflow:  # distilled meanflow models mix the (t, r) embeddings
            self.time_embed_mixer = Linear(time_embed_dim * 2, time_embed_dim, bias=False,
                                           device=dev)

        def transformers(ch):
            return [BasicTransformerBlock(ch, num_heads, attention_head_dim, device=dev)
                    for _ in range(n_blocks)]

        def last_resample(ch):
            return (CausalConv1d(ch, ch, 3, device=dev) if causal
                    else Conv1d(ch, ch, 3, padding=1, device=dev))

        out_ch = in_channels
        for i, ch in enumerate(channels):
            in_ch, out_ch = out_ch, ch
            is_last = i == len(channels) - 1
            setattr(self, f"down_blocks_{i}", _UNetBlock(
                ResnetBlock1D(in_ch, out_ch, time_embed_dim, causal=causal, device=dev),
                transformers(out_ch),
                last_resample(out_ch) if is_last else Downsample1D(out_ch, device=dev)))
        self.n_down = len(channels)

        for i in range(num_mid_blocks):
            setattr(self, f"mid_blocks_{i}", _UNetBlock(
                ResnetBlock1D(channels[-1], channels[-1], time_embed_dim, causal=causal,
                              device=dev), transformers(channels[-1])))
        self.n_mid = num_mid_blocks

        rev = list(reversed(channels)) + [channels[0]]
        for i in range(len(rev) - 1):
            out_ch = rev[i + 1]
            is_last = i == len(rev) - 2
            setattr(self, f"up_blocks_{i}", _UNetBlock(
                ResnetBlock1D(rev[i] * 2, out_ch, time_embed_dim, causal=causal, device=dev),
                transformers(out_ch),
                last_resample(out_ch) if is_last else Upsample1D(out_ch, device=dev)))
        self.n_up = len(rev) - 1

        self.final_block = (CausalBlock1D(rev[-1], rev[-1], device=dev) if causal
                            else Block1D(rev[-1], rev[-1], device=dev))
        self.final_proj = Conv1d(rev[-1], out_channels, 1, device=dev)

    def _attn_bias(self, pad_mask: torch.Tensor, streaming: bool, dtype) -> torch.Tensor:
        """(B, T, 1) float pad mask → additive (B, 1, T, T) bias."""
        attend = pad_mask[:, :, 0] > 0
        B, T = attend.shape
        keys = attend[:, None, :]
        if streaming:
            keys = keys & subsequent_chunk_mask(T, self.static_chunk_size,
                                                self.num_decoding_left_chunks,
                                                pad_mask.device)[None]
        else:
            keys = keys.expand(B, T, T)
        zero = torch.zeros((), device=pad_mask.device)
        return torch.where(keys, zero, -1e10).to(dtype)[:, None]

    def forward(self, x, mask, mu, t, spks=None, cond=None, streaming: bool = False, r=None):
        """x, mu, cond (B, T, C); mask (B, T, 1); t (B,); spks (B, D); `r` the
        meanflow end time."""
        t_emb = self.time_mlp(self.time_embeddings(t))
        if self.meanflow and r is not None:
            r_emb = self.time_mlp(self.time_embeddings(r))
            t_emb = self.time_embed_mixer(torch.cat([t_emb, r_emb], dim=-1))
        parts = [x, mu]
        if spks is not None:
            parts.append(spks[:, None, :].expand(x.shape[0], x.shape[1], spks.shape[-1]))
        if cond is not None:
            parts.append(cond)
        x = torch.cat(parts, dim=-1)

        hiddens = []
        masks = [mask]
        for i in range(self.n_down):
            block = getattr(self, f"down_blocks_{i}")
            m = masks[-1]
            x = block.resnet(x, m, t_emb)
            bias = self._attn_bias(m, streaming, x.dtype)
            for tb in block.transformers():
                x = tb(x, bias)
            hiddens.append(x)
            x = block.resample(x * m)
            masks.append(m[:, ::2, :])
        masks = masks[:-1]
        m = masks[-1]

        bias = self._attn_bias(m, streaming, x.dtype)
        for i in range(self.n_mid):
            block = getattr(self, f"mid_blocks_{i}")
            x = block.resnet(x, m, t_emb)
            for tb in block.transformers():
                x = tb(x, bias)

        for i in range(self.n_up):
            block = getattr(self, f"up_blocks_{i}")
            m = masks.pop()
            skip = hiddens.pop()
            x = torch.cat([x[:, : skip.shape[1]], skip], dim=-1)
            x = block.resnet(x, m, t_emb)
            bias = self._attn_bias(m, streaming, x.dtype)
            for tb in block.transformers():
                x = tb(x, bias)
            x = block.resample(x * m)

        x = self.final_block(x, m)
        return self.final_proj(x * m) * m
