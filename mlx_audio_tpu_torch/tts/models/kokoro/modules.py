"""Kokoro prosody and text-encoder modules (counterpart of
`mlx_audio_tpu/tts/models/kokoro/modules.py`).

Channels-last (B, T, C) throughout, weight norm folded at load (so
`ConvWeighted` is a plain Conv1d). `valid_len` and `valid_frac` carry the
bucket padding: the norms' statistics and the reversed LSTM carries ignore
it, as in the JAX package.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ....nn import (BiLSTM, Conv1d, ConvTranspose1d, Embedding, InstanceNorm, LayerNorm,
                    Linear)

__all__ = ["TextEncoder", "DurationEncoder", "ProsodyPredictor", "AdaLayerNorm", "AdaIN1d",
           "AdainResBlk1d", "leaky_relu", "valid_len_at"]


def leaky_relu(x: torch.Tensor, slope: float = 0.2) -> torch.Tensor:
    return F.leaky_relu(x, slope)


class TextEncoder(nn.Module):
    """embedding → depth × (conv, LayerNorm, LeakyReLU) → BiLSTM, masked:
    ids (B, T) → (B, T, C)."""

    def __init__(self, channels: int, kernel_size: int, depth: int, n_symbols: int,
                 device=None):
        super().__init__()
        self.embedding = Embedding(n_symbols, channels, device=device)
        padding = (kernel_size - 1) // 2
        self.cnn = nn.ModuleList(
            nn.ModuleList([Conv1d(channels, channels, kernel_size, padding=padding,
                                  device=device),
                           LayerNorm(channels, device=device)])
            for _ in range(depth))
        self.lstm = BiLSTM(channels, channels // 2, device=device)

    def forward(self, x, input_lengths, mask):
        # mask: (B, T) True at padded positions
        m = mask[..., None]
        x = self.embedding(x).masked_fill(m, 0.0)
        for conv, norm in self.cnn:
            x = leaky_relu(norm(conv(x))).masked_fill(m, 0.0)
        x = self.lstm(x, valid_len=input_lengths)
        return x.masked_fill(m, 0.0)


class AdaLayerNorm(nn.Module):
    """LayerNorm over channels with a style-conditioned affine; two-pass
    variance in float32."""

    def __init__(self, style_dim: int, channels: int, eps: float = 1e-5, device=None):
        super().__init__()
        self.fc = Linear(style_dim, channels * 2, device=device)
        self.eps = eps

    def forward(self, x, s):
        gamma, beta = self.fc(s).chunk(2, dim=-1)
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = (xf - mean).square().mean(dim=-1, keepdim=True)
        xf = (xf - mean) * torch.rsqrt(var + self.eps)
        # a bf16 gamma and beta promote to float32, as in the JAX layer
        out = (1 + gamma[:, None, :]) * xf + beta[:, None, :]
        return out.to(x.dtype)


class DurationEncoder(nn.Module):
    """nlayers × (BiLSTM → AdaLayerNorm), the style concatenated at each
    stage: (B, T, d_model) → (B, T, d_model + sty_dim)."""

    def __init__(self, sty_dim: int, d_model: int, nlayers: int, dropout: float = 0.1,
                 device=None):
        super().__init__()
        blocks = []
        for _ in range(nlayers):
            blocks.append(BiLSTM(d_model + sty_dim, d_model // 2, device=device))
            blocks.append(AdaLayerNorm(sty_dim, d_model, device=device))
        self.lstms = nn.ModuleList(blocks)
        self.d_model = d_model
        self.sty_dim = sty_dim

    def forward(self, x, style, text_lengths, mask):
        B, T, _ = x.shape
        m = mask[..., None]
        s = style[:, None, :].expand(B, T, self.sty_dim).to(x.dtype)
        x = torch.cat([x, s], dim=-1).masked_fill(m, 0.0)
        for block in self.lstms:
            if isinstance(block, AdaLayerNorm):
                x = block(x, style)
                x = torch.cat([x, s], dim=-1).masked_fill(m, 0.0)
            else:
                x = block(x, valid_len=text_lengths)
        return x


def valid_len_at(T: int, valid_frac: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """Valid length at a temporal resolution T from a per-row valid fraction
    (B,); every stage of the decode path is an integer resampling of the
    frame axis. Rounds half to even, as `jnp.round`."""
    if valid_frac is None:
        return None
    return torch.round(valid_frac * T).int()


class AdaIN1d(nn.Module):
    """Instance norm over time with a style-conditioned affine."""

    def __init__(self, style_dim: int, num_features: int, device=None):
        super().__init__()
        self.norm = InstanceNorm(num_features, affine=False, device=device)
        self.fc = Linear(style_dim, num_features * 2, device=device)

    def forward(self, x, s, valid_len=None):
        gamma, beta = self.fc(s)[:, None, :].chunk(2, dim=-1)
        return (1 + gamma) * self.norm(x, valid_len) + beta


class AdainResBlk1d(nn.Module):
    """StyleTTS2 AdaIN residual block. With upsample: a depthwise transposed
    conv (stride 2) and a left pad of 1 on the residual path, nearest 2x on
    the shortcut."""

    def __init__(self, dim_in: int, dim_out: int, style_dim: int = 64,
                 upsample: bool = False, dropout_p: float = 0.0, device=None):
        super().__init__()
        self.upsample_type = upsample
        self.learned_sc = dim_in != dim_out
        self.conv1 = Conv1d(dim_in, dim_out, 3, padding=1, device=device)
        self.conv2 = Conv1d(dim_out, dim_out, 3, padding=1, device=device)
        self.norm1 = AdaIN1d(style_dim, dim_in, device=device)
        self.norm2 = AdaIN1d(style_dim, dim_out, device=device)
        if self.learned_sc:
            self.conv1x1 = Conv1d(dim_in, dim_out, 1, bias=False, device=device)
        if upsample:
            self.pool = ConvTranspose1d(dim_in, dim_in, 3, stride=2, padding=1,
                                        groups=dim_in, device=device)

    def _shortcut(self, x):
        if self.upsample_type:
            x = x.repeat_interleave(2, dim=1)
        if self.learned_sc:
            x = self.conv1x1(x)
        return x

    def _residual(self, x, s, valid_frac=None):
        x = leaky_relu(self.norm1(x, s, valid_len_at(x.shape[1], valid_frac)))
        if self.upsample_type:
            x = F.pad(self.pool(x), (0, 0, 1, 0))  # (B, 2T-1, C) → (B, 2T, C)
        x = self.conv1(x)
        x = leaky_relu(self.norm2(x, s, valid_len_at(x.shape[1], valid_frac)))
        return self.conv2(x)

    def forward(self, x, s, valid_frac=None):
        # √2 rounded to the activations' dtype first, as the JAX block
        sqrt2 = torch.tensor(math.sqrt(2.0), dtype=x.dtype, device=x.device)
        return (self._residual(x, s, valid_frac) + self._shortcut(x)) / sqrt2


class ProsodyPredictor(nn.Module):
    """Duration, F0 and energy predictor."""

    def __init__(self, style_dim: int, d_hid: int, nlayers: int, max_dur: int = 50,
                 dropout: float = 0.1, device=None):
        super().__init__()
        self.text_encoder = DurationEncoder(sty_dim=style_dim, d_model=d_hid,
                                            nlayers=nlayers, dropout=dropout, device=device)
        self.lstm = BiLSTM(d_hid + style_dim, d_hid // 2, device=device)
        self.duration_proj = Linear(d_hid, max_dur, device=device)
        self.shared = BiLSTM(d_hid + style_dim, d_hid // 2, device=device)

        def blocks():
            return nn.ModuleList([
                AdainResBlk1d(d_hid, d_hid, style_dim, dropout_p=dropout, device=device),
                AdainResBlk1d(d_hid, d_hid // 2, style_dim, upsample=True, dropout_p=dropout,
                              device=device),
                AdainResBlk1d(d_hid // 2, d_hid // 2, style_dim, dropout_p=dropout,
                              device=device),
            ])

        self.F0 = blocks()
        self.N = blocks()
        self.F0_proj = Conv1d(d_hid // 2, 1, 1, device=device)
        self.N_proj = Conv1d(d_hid // 2, 1, 1, device=device)

    def F0Ntrain(self, en, s, valid_frac=None):
        """en (B, frames, d_hid + sty) → the F0 and energy curves, each
        (B, 2·frames)."""
        x = self.shared(en, valid_len=valid_len_at(en.shape[1], valid_frac))
        F0 = x
        for block in self.F0:
            F0 = block(F0, s, valid_frac)
        N = x
        for block in self.N:
            N = block(N, s, valid_frac)
        return self.F0_proj(F0)[..., 0], self.N_proj(N)[..., 0]
