"""The Diffusion Transformer, CosyVoice3's flow-matching estimator
(counterpart of `mlx_audio_tpu/tts/models/cosyvoice3/dit.py`).

Channels-last (B, T, C) throughout. Each block is AdaLN-Zero attention and
a gated feed-forward, modulated by the timestep's embedding. The rope is
x_transformers' interleaved pairs, applied to the flattened (B, T, H·Dh)
queries and keys before the head split, so only the first head's dims turn
(the released checkpoint's convention). Attention goes through the port's
`ops.attention`: unmasked (offline) at T ≥ 1280 on the card it takes the
flash kernel (`flash_fwd_f32` or `flash_fwd_bf16`); streaming passes the
static chunk mask and takes the matmul path."""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ....nn import Conv1d, Linear
from ....ops.attention import scaled_dot_product_attention

__all__ = ["DiT", "DiTBlock", "TimestepEmbedding", "chunk_attention_mask", "apply_rope_flat",
           "rope_angles"]


def _layer_norm(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm without an affine part, in float32, cast back."""
    return F.layer_norm(x.float(), x.shape[-1:], eps=eps).to(x.dtype)


def _mish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.tanh(F.softplus(x))


def sinus_position_embedding(t: torch.Tensor, dim: int, scale: float = 1000.0) -> torch.Tensor:
    """The sinusoidal timestep embedding of t (B,) → (B, dim)."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, device=t.device) / (half - 1))
    ang = scale * t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


class TimestepEmbedding(nn.Module):
    def __init__(self, dim: int, freq_embed_dim: int = 256, device=None):
        super().__init__()
        self.freq_embed_dim = freq_embed_dim
        self.time_mlp_0 = Linear(freq_embed_dim, dim, device=device)
        self.time_mlp_2 = Linear(dim, dim, device=device)

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        h = sinus_position_embedding(t, self.freq_embed_dim)
        return self.time_mlp_2(F.silu(self.time_mlp_0(h)))


class CausalConvPositionEmbedding(nn.Module):
    """Two left-padded grouped convolutions with Mish; (B, T, D)."""

    def __init__(self, dim: int, kernel_size: int = 31, groups: int = 16, device=None):
        super().__init__()
        self.kernel_size = kernel_size
        self.conv1 = Conv1d(dim, dim, kernel_size, groups=groups, device=device)
        self.conv2 = Conv1d(dim, dim, kernel_size, groups=groups, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pad = (0, 0, self.kernel_size - 1, 0)
        h = _mish(self.conv1(F.pad(x, pad)))
        return _mish(self.conv2(F.pad(h, pad)))


class InputEmbedding(nn.Module):
    """[x, cond, mu, spk] projected, plus the convolutional position
    embedding."""

    def __init__(self, mel_dim: int, text_dim: int, out_dim: int,
                 spk_dim: Optional[int] = None, device=None):
        super().__init__()
        self.spk_dim = spk_dim or 0
        self.proj = Linear(mel_dim * 2 + text_dim + self.spk_dim, out_dim, device=device)
        self.conv_pos_embed = CausalConvPositionEmbedding(out_dim, device=device)

    def forward(self, x, cond, text_embed, spks) -> torch.Tensor:
        parts = [x, cond, text_embed]
        if self.spk_dim > 0:
            parts.append(spks[:, None, :].expand(x.shape[0], x.shape[1], spks.shape[-1]))
        h = self.proj(torch.cat(parts, dim=-1))
        return self.conv_pos_embed(h) + h


class FeedForward(nn.Module):
    def __init__(self, dim: int, mult: int = 4, dim_out: Optional[int] = None, device=None):
        super().__init__()
        inner = int(dim * mult)
        self.ff_0_0 = Linear(dim, inner, device=device)
        self.ff_2 = Linear(inner, dim_out or dim, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.ff_2(F.gelu(self.ff_0_0(x), approximate="tanh"))


class AdaLayerNormZero(nn.Module):
    """The six-way modulation from the time embedding."""

    def __init__(self, dim: int, device=None):
        super().__init__()
        self.linear = Linear(dim, dim * 6, device=device)

    def forward(self, x, emb):
        shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = \
            self.linear(F.silu(emb)).chunk(6, dim=-1)
        h = _layer_norm(x) * (1 + scale_msa[:, None]) + shift_msa[:, None]
        return h, gate_msa, shift_mlp, scale_mlp, gate_mlp


class AdaLayerNormZeroFinal(nn.Module):
    """The final AdaLN: scale and shift."""

    def __init__(self, dim: int, device=None):
        super().__init__()
        self.linear = Linear(dim, dim * 2, device=device)

    def forward(self, x, emb):
        scale, shift = self.linear(F.silu(emb)).chunk(2, dim=-1)
        return _layer_norm(x) * (1 + scale[:, None]) + shift[:, None]


def rope_angles(seq_len: int, dim: int, base: float = 10000.0, device=None) -> torch.Tensor:
    """x_transformers' rope angles, each frequency twice in a row → (T, dim)
    float32."""
    inv_freq = 1.0 / (base ** (torch.arange(0, dim, 2, dtype=torch.float32, device=device)
                               / dim))
    ang = torch.arange(seq_len, dtype=torch.float32, device=device)[:, None] * inv_freq[None]
    return torch.stack([ang, ang], dim=-1).reshape(seq_len, dim)


def _rotate_half_interleaved(x: torch.Tensor) -> torch.Tensor:
    """(a, b, c, d, ...) → (-b, a, -d, c, ...)."""
    x2 = x.reshape(*x.shape[:-1], x.shape[-1] // 2, 2)
    return torch.stack([-x2[..., 1], x2[..., 0]], dim=-1).reshape(x.shape)


def apply_rope_flat(t: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """Turn the first `angles.shape[-1]` dims of (B, T, H·Dh): the first
    head's."""
    rot = angles.shape[-1]
    t_rot, t_pass = t[..., :rot], t[..., rot:]
    a = angles[None].to(t.dtype)
    t_rot = t_rot * torch.cos(a) + _rotate_half_interleaved(t_rot) * torch.sin(a)
    return torch.cat([t_rot, t_pass], dim=-1)


def chunk_attention_mask(size: int, chunk_size: int, device=None) -> torch.Tensor:
    """Boolean (size, size): position i attends j < (i // chunk + 1)·chunk."""
    pos = torch.arange(size, device=device)
    block_end = (pos // chunk_size + 1) * chunk_size
    return pos[None, :] < block_end[:, None]


class Attention(nn.Module):
    def __init__(self, dim: int, heads: int = 8, dim_head: int = 64, device=None):
        super().__init__()
        self.heads = heads
        self.dim_head = dim_head
        inner = heads * dim_head
        self.to_q = Linear(dim, inner, device=device)
        self.to_k = Linear(dim, inner, device=device)
        self.to_v = Linear(dim, inner, device=device)
        self.to_out_0 = Linear(inner, dim, device=device)

    def forward(self, x, angles, mask=None):
        B, N, _ = x.shape

        def heads(t):
            return t.reshape(B, N, self.heads, self.dim_head).transpose(1, 2)

        q = heads(apply_rope_flat(self.to_q(x), angles))
        k = heads(apply_rope_flat(self.to_k(x), angles))
        v = heads(self.to_v(x))
        out = scaled_dot_product_attention(q, k, v, mask=mask)
        return self.to_out_0(out.transpose(1, 2).reshape(B, N, -1))


class DiTBlock(nn.Module):
    def __init__(self, dim: int, heads: int, dim_head: int, ff_mult: int = 4, device=None):
        super().__init__()
        self.attn_norm = AdaLayerNormZero(dim, device=device)
        self.attn = Attention(dim, heads, dim_head, device=device)
        self.ff = FeedForward(dim, mult=ff_mult, device=device)

    def forward(self, x, t, angles, mask=None):
        h, gate_msa, shift_mlp, scale_mlp, gate_mlp = self.attn_norm(x, t)
        x = x + gate_msa[:, None] * self.attn(h, angles, mask)
        h = _layer_norm(x) * (1 + scale_mlp[:, None]) + shift_mlp[:, None]
        return x + gate_mlp[:, None] * self.ff(h)


class DiT(nn.Module):
    """The velocity estimator: x and cond (B, T, mel), mu (B, T, mu_dim), t
    (B,), spks (B, spk_dim) → (B, T, out_channels)."""

    def __init__(self, dim: int = 1024, depth: int = 22, heads: int = 16, dim_head: int = 64,
                 ff_mult: int = 2, mel_dim: int = 80, mu_dim: Optional[int] = None,
                 spk_dim: Optional[int] = None, out_channels: Optional[int] = None,
                 static_chunk_size: int = 50, long_skip_connection: bool = False, device=None):
        super().__init__()
        self.dim = dim
        self.depth = depth
        self.dim_head = dim_head
        self.static_chunk_size = static_chunk_size
        self.time_embed = TimestepEmbedding(dim, device=device)
        self.input_embed = InputEmbedding(mel_dim, mu_dim or mel_dim, dim, spk_dim,
                                          device=device)
        self.transformer_blocks = nn.ModuleList(
            DiTBlock(dim, heads, dim_head, ff_mult, device=device) for _ in range(depth))
        self.long_skip_connection = (Linear(dim * 2, dim, bias=False, device=device)
                                     if long_skip_connection else None)
        self.norm_out = AdaLayerNormZeroFinal(dim, device=device)
        self.proj_out = Linear(dim, out_channels or mel_dim, device=device)

    def forward(self, x, mu, t, spks, cond, streaming: bool = False) -> torch.Tensor:
        B, N, _ = x.shape
        if t.dim() == 0:
            t = t.expand(B)
        h = self.input_embed(x, cond, mu, spks)
        temb = self.time_embed(t).to(h.dtype)  # an f32 modulation would upcast every block
        angles = rope_angles(N, self.dim_head, device=x.device)
        mask = (chunk_attention_mask(N, self.static_chunk_size, device=x.device) if streaming
                else None)
        residual = h
        for block in self.transformer_blocks:
            h = block(h, temb, angles, mask)
        if self.long_skip_connection is not None:
            h = self.long_skip_connection(torch.cat([h, residual], dim=-1))
        return self.proj_out(self.norm_out(h, temb))
