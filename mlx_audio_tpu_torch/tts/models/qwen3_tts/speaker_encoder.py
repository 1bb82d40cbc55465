"""The ECAPA-TDNN speaker encoder of Qwen3-TTS Base (counterpart of
`mlx_audio_tpu/tts/models/qwen3_tts/speaker_encoder.py`): TDNN and
SE-Res2Net blocks, multi-layer feature aggregation and attentive statistics
pooling, from a mel spectrogram to one x-vector. Channels-last (B, T, C)."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ....nn import Conv1d
from .config import Qwen3TTSSpeakerEncoderConfig

__all__ = ["Qwen3TTSSpeakerEncoder"]


def _reflect_pad(x, pad: int):
    if pad == 0:
        return x
    return F.pad(x.transpose(1, 2), (pad, pad), mode="reflect").transpose(1, 2)


class TimeDelayNetBlock(nn.Module):
    def __init__(self, in_channels, out_channels, kernel_size, dilation, device=None):
        super().__init__()
        self.conv = Conv1d(in_channels, out_channels, kernel_size, dilation=dilation,
                           device=device)
        self.pad = (kernel_size - 1) * dilation // 2

    def forward(self, x):
        return torch.relu(self.conv(_reflect_pad(x, self.pad)))


class Res2NetBlock(nn.Module):
    def __init__(self, in_channels, out_channels, scale=8, kernel_size=3, dilation=1,
                 device=None):
        super().__init__()
        self.blocks = nn.ModuleList(
            TimeDelayNetBlock(in_channels // scale, out_channels // scale, kernel_size,
                              dilation, device=device)
            for _ in range(scale - 1))
        self.scale = scale

    def forward(self, x):
        outs = []
        part = None
        for i, chunk in enumerate(x.chunk(self.scale, dim=-1)):
            if i == 0:
                part = chunk
            elif i == 1:
                part = self.blocks[0](chunk)
            else:
                part = self.blocks[i - 1](chunk + part)
            outs.append(part)
        return torch.cat(outs, dim=-1)


class SqueezeExcitationBlock(nn.Module):
    def __init__(self, in_channels, se_channels, out_channels, device=None):
        super().__init__()
        self.conv1 = Conv1d(in_channels, se_channels, 1, device=device)
        self.conv2 = Conv1d(se_channels, out_channels, 1, device=device)

    def forward(self, x):
        s = x.mean(dim=1, keepdim=True)
        return x * torch.sigmoid(self.conv2(torch.relu(self.conv1(s))))


class SqueezeExcitationRes2NetBlock(nn.Module):
    def __init__(self, in_channels, out_channels, res2net_scale=8, se_channels=128,
                 kernel_size=3, dilation=1, device=None):
        super().__init__()
        self.tdnn1 = TimeDelayNetBlock(in_channels, out_channels, 1, 1, device=device)
        self.res2net_block = Res2NetBlock(out_channels, out_channels, res2net_scale,
                                          kernel_size, dilation, device=device)
        self.tdnn2 = TimeDelayNetBlock(out_channels, out_channels, 1, 1, device=device)
        self.se_block = SqueezeExcitationBlock(out_channels, se_channels, out_channels,
                                               device=device)

    def forward(self, x):
        return self.se_block(self.tdnn2(self.res2net_block(self.tdnn1(x)))) + x


class AttentiveStatisticsPooling(nn.Module):
    def __init__(self, channels, attention_channels=128, device=None):
        super().__init__()
        self.tdnn = TimeDelayNetBlock(channels * 3, attention_channels, 1, 1, device=device)
        self.conv = Conv1d(attention_channels, channels, 1, device=device)
        self.eps = 1e-12

    def forward(self, x):  # (B, T, C) → (B, 1, 2C)
        mean = x.mean(dim=1, keepdim=True)
        std = torch.sqrt(x.var(dim=1, unbiased=False, keepdim=True) + self.eps)
        attn_in = torch.cat([x, mean.expand_as(x), std.expand_as(x)], dim=-1)
        attn = torch.softmax(self.conv(torch.tanh(self.tdnn(attn_in))), dim=1)
        mean = (attn * x).sum(dim=1, keepdim=True)
        var = (attn * (x - mean) ** 2).sum(dim=1, keepdim=True)
        return torch.cat([mean, torch.sqrt(var.clamp(min=self.eps))], dim=-1)


class Qwen3TTSSpeakerEncoder(nn.Module):
    def __init__(self, cfg: Qwen3TTSSpeakerEncoderConfig, device=None):
        super().__init__()
        ch, ks, dil = cfg.enc_channels, cfg.enc_kernel_sizes, cfg.enc_dilations
        blocks = [TimeDelayNetBlock(cfg.mel_dim, ch[0], ks[0], dil[0], device=device)]
        for i in range(1, len(ch) - 1):
            blocks.append(SqueezeExcitationRes2NetBlock(
                ch[i - 1], ch[i], cfg.enc_res2net_scale, cfg.enc_se_channels, ks[i], dil[i],
                device=device))
        self.blocks = nn.ModuleList(blocks)
        self.mfa = TimeDelayNetBlock(ch[-1], ch[-1], ks[-1], dil[-1], device=device)
        self.asp = AttentiveStatisticsPooling(ch[-1], cfg.enc_attention_channels,
                                              device=device)
        self.fc = Conv1d(ch[-1] * 2, cfg.enc_dim, 1, device=device)

    def forward(self, mel):  # (B, T, mel_dim) → (B, enc_dim)
        hs = []
        x = mel
        for block in self.blocks:
            x = block(x)
            hs.append(x)
        x = self.mfa(torch.cat(hs[1:], dim=-1))
        return self.fc(self.asp(x))[:, 0]
