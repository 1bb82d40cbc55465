"""The upsampling conformer encoder of S3Gen's token-to-mel flow (counterpart
of `mlx_audio_tpu/codec/models/s3gen/encoder.py`).

Channels-last (B, T, C); the masks are made once a call. The relative
attention is espnet's: `pos_bias_u` / `pos_bias_v` over
`EspnetRelPositionalEncoding`'s 2T - 1 positions, with `_rel_shift`, as
the JAX package writes it."""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ....nn import BatchNorm, Conv1d, LayerNorm, Linear

__all__ = ["UpsampleConformerEncoder", "ConformerEncoderLayer", "RelPositionMultiHeadedAttention",
           "EspnetRelPositionalEncoding", "ConvolutionModule", "subsequent_chunk_mask",
           "chunk_attention_bias", "make_non_pad_mask"]


def make_non_pad_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    return torch.arange(max_len, device=lengths.device)[None, :] < lengths[:, None]


def subsequent_chunk_mask(size: int, chunk_size: int, num_left_chunks: int = -1,
                          device=None) -> torch.Tensor:
    """The chunk-causal attention mask (size, size), True where a query may
    attend."""
    pos = torch.arange(size, device=device)
    block_end = (pos // chunk_size + 1) * chunk_size
    mask = pos[None, :] < block_end[:, None]
    if num_left_chunks >= 0:
        block_start = (pos // chunk_size - num_left_chunks) * chunk_size
        mask = mask & (pos[None, :] >= block_start[:, None])
    return mask


def chunk_attention_bias(pad_mask: torch.Tensor, chunk_size: int, num_left_chunks: int = -1,
                         dtype=torch.float32) -> torch.Tensor:
    """(B, T) pad mask, and chunk causality where chunk_size > 0 →
    additive (B, 1, T, T) bias."""
    B, T = pad_mask.shape
    attend = pad_mask[:, None, :]
    if chunk_size > 0:
        attend = attend & subsequent_chunk_mask(T, chunk_size, num_left_chunks,
                                                pad_mask.device)[None]
    else:
        attend = attend.expand(B, T, T)
    zero = torch.zeros((), device=pad_mask.device)
    return torch.where(attend, zero, -1e9).to(dtype)[:, None]


class EspnetRelPositionalEncoding(nn.Module):
    """Relative positions T-1 … -(T-1), as the table
    [reversed positive ‖ negative[1:]]."""

    def __init__(self, d_model: int, max_len: int = 5000, device=None):
        super().__init__()
        self.d_model = d_model
        self.xscale = math.sqrt(d_model)
        # float32 arithmetic, as the JAX package's
        position = np.arange(max_len, dtype=np.float32)[:, None]
        div = np.exp(np.arange(0, d_model, 2, dtype=np.float32)
                     * np.float32(-(math.log(10000.0) / d_model)))
        pe_pos = np.zeros((max_len, d_model), np.float32)
        pe_pos[:, 0::2] = np.sin(position * div)
        pe_pos[:, 1::2] = np.cos(position * div)
        pe_neg = np.zeros((max_len, d_model), np.float32)
        pe_neg[:, 0::2] = np.sin(-position * div)
        pe_neg[:, 1::2] = np.cos(-position * div)
        pe = np.concatenate([pe_pos[::-1], pe_neg[1:]], axis=0)[None]
        self.register_buffer("pe", torch.from_numpy(np.ascontiguousarray(pe)).to(device),
                             persistent=False)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        T = x.shape[1]
        center = self.pe.shape[1] // 2
        return x * self.xscale, self.pe[:, center - T + 1: center + T].to(x.dtype)


class LinearNoSubsampling(nn.Module):
    """Linear and LayerNorm in front of the positions."""

    def __init__(self, idim: int, odim: int, device=None):
        super().__init__()
        self.linear = Linear(idim, odim, device=device)
        self.norm = LayerNorm(odim, eps=1e-5, device=device)
        self.pos_enc = EspnetRelPositionalEncoding(odim, device=device)

    def forward(self, x):
        return self.pos_enc(self.norm(self.linear(x)))


def _attend(scores: torch.Tensor, v: torch.Tensor, dtype) -> torch.Tensor:
    """softmax in float32, the weights cast back, then over v → (B, T, H·d)."""
    attn = torch.softmax(scores.float(), dim=-1).to(dtype)
    out = attn @ v
    return out.transpose(1, 2).reshape(out.shape[0], out.shape[2], -1)


class MultiHeadedAttention(nn.Module):
    def __init__(self, n_head: int, n_feat: int, key_bias: bool = True, device=None):
        super().__init__()
        self.d_k = n_feat // n_head
        self.h = n_head
        self.linear_q = Linear(n_feat, n_feat, device=device)
        self.linear_k = Linear(n_feat, n_feat, bias=key_bias, device=device)
        self.linear_v = Linear(n_feat, n_feat, device=device)
        self.linear_out = Linear(n_feat, n_feat, device=device)

    def _qkv(self, x):
        B, T, _ = x.shape
        return tuple(p(x).reshape(B, T, self.h, self.d_k).transpose(1, 2)
                     for p in (self.linear_q, self.linear_k, self.linear_v))

    def forward(self, x, bias, pos_emb=None):
        q, k, v = self._qkv(x)
        scores = q @ k.transpose(-1, -2) / math.sqrt(self.d_k) + bias
        return self.linear_out(_attend(scores, v, x.dtype))


class RelPositionMultiHeadedAttention(MultiHeadedAttention):
    """Transformer-XL relative attention, espnet's variant."""

    def __init__(self, n_head: int, n_feat: int, key_bias: bool = True, device=None):
        super().__init__(n_head, n_feat, key_bias, device)
        self.linear_pos = Linear(n_feat, n_feat, bias=False, device=device)
        self.pos_bias_u = nn.Parameter(torch.empty(n_head, self.d_k, device=device))
        self.pos_bias_v = nn.Parameter(torch.empty(n_head, self.d_k, device=device))

    def reset_parameters(self, generator=None) -> None:
        self.pos_bias_u.data.zero_()
        self.pos_bias_v.data.zero_()

    @staticmethod
    def _rel_shift(x: torch.Tensor) -> torch.Tensor:
        """(B, h, T, 2T-1) → (B, h, T, T)."""
        B, H, T, P = x.shape
        x = F.pad(x, (1, 0))
        x = x.reshape(B, H, P + 1, T)[:, :, 1:].reshape(B, H, T, P)
        return x[..., : P // 2 + 1]

    def forward(self, x, bias, pos_emb=None):
        q, k, v = self._qkv(x)
        p = self.linear_pos(pos_emb).reshape(1, -1, self.h, self.d_k).transpose(1, 2)
        q_u = q + self.pos_bias_u[None, :, None, :].to(q.dtype)
        q_v = q + self.pos_bias_v[None, :, None, :].to(q.dtype)
        matrix_ac = q_u @ k.transpose(-1, -2)
        matrix_bd = q_v @ p.transpose(-1, -2)
        if matrix_bd.shape[-1] != matrix_ac.shape[-1]:
            matrix_bd = self._rel_shift(matrix_bd)
        scores = (matrix_ac + matrix_bd) / math.sqrt(self.d_k) + bias
        return self.linear_out(_attend(scores, v, x.dtype))


class PositionwiseFeedForward(nn.Module):
    def __init__(self, idim: int, hidden: int, device=None):
        super().__init__()
        self.w_1 = Linear(idim, hidden, device=device)
        self.w_2 = Linear(hidden, idim, device=device)

    def forward(self, x):
        return self.w_2(F.silu(self.w_1(x)))


class ConvolutionModule(nn.Module):
    """The conformer convolution: pointwise, GLU (written inline), depthwise,
    norm, SiLU, pointwise."""

    def __init__(self, channels: int, kernel_size: int = 15, norm: str = "batch_norm",
                 causal: bool = False, bias: bool = True, device=None):
        super().__init__()
        self.pointwise_conv1 = Conv1d(channels, 2 * channels, 1, bias=bias, device=device)
        self.lorder = kernel_size - 1 if causal else 0
        self.depthwise_conv = Conv1d(channels, channels, kernel_size,
                                     padding=0 if causal else (kernel_size - 1) // 2,
                                     groups=channels, bias=bias, device=device)
        self.norm = (LayerNorm(channels, device=device) if norm == "layer_norm"
                     else BatchNorm(channels, device=device))
        self.pointwise_conv2 = Conv1d(channels, channels, 1, bias=bias, device=device)

    def forward(self, x, pad_mask=None):
        if pad_mask is not None:
            x = x * pad_mask[..., None]
        a, b = self.pointwise_conv1(x).chunk(2, dim=-1)
        x = a * torch.sigmoid(b)
        if self.lorder > 0:
            x = F.pad(x, (0, 0, self.lorder, 0))
        x = self.pointwise_conv2(F.silu(self.norm(self.depthwise_conv(x))))
        if pad_mask is not None:
            x = x * pad_mask[..., None]
        return x


class ConformerEncoderLayer(nn.Module):
    """The pre-norm inference path."""

    def __init__(self, size: int, self_attn: nn.Module, feed_forward: nn.Module,
                 feed_forward_macaron: Optional[nn.Module] = None,
                 conv_module: Optional[nn.Module] = None, device=None):
        super().__init__()
        self.self_attn = self_attn
        self.feed_forward = feed_forward
        self.feed_forward_macaron = feed_forward_macaron
        self.conv_module = conv_module
        self.norm_ff = LayerNorm(size, eps=1e-12, device=device)
        self.norm_mha = LayerNorm(size, eps=1e-12, device=device)
        if feed_forward_macaron is not None:
            self.norm_ff_macaron = LayerNorm(size, eps=1e-12, device=device)
        self.ff_scale = 0.5 if feed_forward_macaron is not None else 1.0
        if conv_module is not None:
            self.norm_conv = LayerNorm(size, eps=1e-12, device=device)
            self.norm_final = LayerNorm(size, eps=1e-12, device=device)

    def forward(self, x, bias, pos_emb, pad_mask=None):
        if self.feed_forward_macaron is not None:
            x = x + self.ff_scale * self.feed_forward_macaron(self.norm_ff_macaron(x))
        x = x + self.self_attn(self.norm_mha(x), bias, pos_emb)
        if self.conv_module is not None:
            x = x + self.conv_module(self.norm_conv(x), pad_mask)
        x = x + self.ff_scale * self.feed_forward(self.norm_ff(x))
        if self.conv_module is not None:
            x = self.norm_final(x)
        return x


class Upsample1D(nn.Module):
    """Nearest ×stride, then a left-padded convolution; (B, T, C) in and out."""

    def __init__(self, channels: int, out_channels: int, stride: int = 2, device=None):
        super().__init__()
        self.stride = stride
        self.conv = Conv1d(channels, out_channels, stride * 2 + 1, device=device)

    def forward(self, x):
        x = x.repeat_interleave(self.stride, dim=1)
        return self.conv(F.pad(x, (0, 0, self.stride * 2, 0)))


class PreLookaheadLayer(nn.Module):
    """A right-context convolution with a residual."""

    def __init__(self, channels: int, pre_lookahead_len: int = 3, device=None):
        super().__init__()
        self.pre_lookahead_len = pre_lookahead_len
        self.conv1 = Conv1d(channels, channels, pre_lookahead_len + 1, device=device)
        self.conv2 = Conv1d(channels, channels, 3, device=device)

    def forward(self, x, context: Optional[torch.Tensor] = None):
        if context is None or context.shape[1] == 0:
            h = F.pad(x, (0, 0, 0, self.pre_lookahead_len))
        else:
            h = torch.cat([x, context], dim=1)
            rem = self.pre_lookahead_len - context.shape[1]
            if rem > 0:
                h = F.pad(h, (0, 0, 0, rem))
        h = F.leaky_relu(self.conv1(h), negative_slope=0.01)
        return self.conv2(F.pad(h, (0, 0, 2, 0))) + x


class UpsampleConformerEncoder(nn.Module):
    """Token encoder: conformer stack, 2x upsample, conformer stack.
    `streaming=True` applies the static chunk mask."""

    def __init__(self, input_size: int = 512, output_size: int = 512, attention_heads: int = 8,
                 linear_units: int = 2048, num_blocks: int = 6, num_up_blocks: int = 4,
                 static_chunk_size: int = 25, macaron_style: bool = False,
                 use_cnn_module: bool = False, cnn_module_kernel: int = 15, causal: bool = False,
                 key_bias: bool = True, pre_lookahead_len: int = 3, upsample_stride: int = 2,
                 device=None, **_unused):
        super().__init__()
        self._output_size = output_size
        self.static_chunk_size = static_chunk_size
        self.embed = LinearNoSubsampling(input_size, output_size, device=device)
        self.up_embed = LinearNoSubsampling(input_size, output_size, device=device)
        self.after_norm = LayerNorm(output_size, eps=1e-5, device=device)
        self.pre_lookahead_layer = PreLookaheadLayer(output_size, pre_lookahead_len,
                                                     device=device)

        def make_layer():
            return ConformerEncoderLayer(
                output_size,
                RelPositionMultiHeadedAttention(attention_heads, output_size, key_bias,
                                                device=device),
                PositionwiseFeedForward(output_size, linear_units, device=device),
                (PositionwiseFeedForward(output_size, linear_units, device=device)
                 if macaron_style else None),
                (ConvolutionModule(output_size, cnn_module_kernel, causal=causal,
                                   device=device) if use_cnn_module else None),
                device=device)

        self.encoders = nn.ModuleList(make_layer() for _ in range(num_blocks))
        self.up_layer = Upsample1D(output_size, output_size, upsample_stride, device=device)
        self.up_encoders = nn.ModuleList(make_layer() for _ in range(num_up_blocks))

    def output_size(self) -> int:
        return self._output_size

    def forward(self, xs: torch.Tensor, xs_lens: torch.Tensor,
                context: Optional[torch.Tensor] = None, streaming: bool = False):
        pad = make_non_pad_mask(xs_lens, xs.shape[1])
        xs, pos_emb = self.embed(xs)
        embedded_context = None
        if context is not None and context.shape[1] > 0:
            embedded_context, _ = self.embed(context)
        chunk = self.static_chunk_size if streaming else 0
        bias = chunk_attention_bias(pad, chunk, dtype=xs.dtype)
        xs = self.pre_lookahead_layer(xs, context=embedded_context)
        for layer in self.encoders:
            xs = layer(xs, bias, pos_emb, pad)

        xs = self.up_layer(xs)
        up_lens = xs_lens * self.up_layer.stride
        pad = make_non_pad_mask(up_lens, xs.shape[1])
        xs, pos_emb = self.up_embed(xs)
        bias = chunk_attention_bias(pad, chunk * self.up_layer.stride if chunk > 0 else 0,
                                    dtype=xs.dtype)
        for layer in self.up_encoders:
            xs = layer(xs, bias, pos_emb, pad)
        return self.after_norm(xs), up_lens
