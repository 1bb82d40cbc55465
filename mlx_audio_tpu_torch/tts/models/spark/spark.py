"""Spark-TTS: a Qwen2.5 LLM over BiCodec semantic and global tokens
(counterpart of `mlx_audio_tpu/tts/models/spark/spark.py`).

The LLM is the port's `CausalLM`, decoded by `lm.generate` (top-k 50,
top-p 0.95, repetition penalty 1.3 over 20 tokens by default) or, under a
server, by an `LMContinuousBatcher`. BiCodec (`tokenize`, `detokenize`)
runs its pieces on the card: the Vocos backbones, the factorized VQ, the
ECAPA-TDNN speaker encoder with its perceiver and residual FSQ, and the
DAC-style wave generator, which reuses the port's DAC `Snake1d` and
`ResidualUnit` and so runs channels-first (every other piece runs
channels-last, as the JAX package's). Parameter names and layouts are the
JAX package's; `BiCodec.sanitize` maps the published checkpoint onto them.

Where it differs:

- the tokenizer is the port's `tokenizer_json` reader on the checkpoint's
  `tokenizer.json` (eos from its `tokenizer_config.json`), where the JAX
  package builds `AutoTokenizer`;
- a voice clone needs the Wav2Vec2 features: where the checkpoint has no
  `wav2vec2-large-xlsr-53/` and none was set, the port raises, where the
  JAX package tokenizes zeros;
- the semantic codebook is read with its ids clamped, as the JAX package's
  gather reads it;
- sampled tokens match the JAX package's in distribution only.
"""

from __future__ import annotations

import inspect
import re
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Generator, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ....codec.models.base import Conv1d as Conv1dCF
from ....codec.models.base import ConvTranspose1d as ConvTranspose1dCF
from ....codec.models.base import fold_weight_norm_pairs
from ....codec.models.descript.dac import ResidualUnit, Snake1d
from ....codec.models.vocos.vocos import VocosBackbone
from ....device import resolve_device
from ....dsp import mel_filters, stft
from ....lm.generate import generate_tokens
from ....lm.transformer import CausalLM, LMConfig
from ....nn import BatchNorm, Conv1d, ConvTranspose1d, Embedding, Linear, RMSNorm
from ....nn.layers import clamp_ids
from ....nn.module import init_weights, load_weights
from ..base import GenerationResult, format_duration

__all__ = ["Model", "ModelConfig", "BiCodec", "FSQ", "ResidualFSQ",
           "FactorizedVectorQuantize", "SpeakerEncoder", "WaveGenerator", "load_bicodec"]

GENDER_MAP = {"female": 0, "male": 1}
# float control values → level names
PITCH_MAP = SPEED_MAP = {
    0.0: "very_low", 0.5: "low", 1.0: "moderate", 1.5: "high", 2.0: "very_high",
}
LEVELS_MAP = {"very_low": 0, "low": 1, "moderate": 2, "high": 3, "very_high": 4}


# ---------------------------------------------------------------------------
# FSQ and residual FSQ
# ---------------------------------------------------------------------------


class FSQ(nn.Module):
    """Finite scalar quantization over `levels` (no parameters)."""

    def __init__(self, levels: List[int]):
        super().__init__()
        self._levels = np.asarray(levels, np.int32)
        self._basis = np.concatenate([[1], np.cumprod(self._levels[:-1])]).astype(np.int32)
        self.codebook_size = int(np.prod(self._levels))
        self.codebook_dim = len(levels)

    def _half_width(self, device) -> torch.Tensor:
        return torch.as_tensor(self._levels // 2, dtype=torch.float32, device=device)

    def quantize(self, z: torch.Tensor) -> torch.Tensor:
        levels = torch.as_tensor(self._levels, dtype=torch.float32, device=z.device)
        eps = 1e-3
        half_l = (levels - 1) * (1 + eps) / 2
        offset = torch.where(levels % 2 == 0, 0.5, 0.0)
        shift = torch.atanh(offset / half_l)
        bounded = torch.tanh(z + shift) * half_l - offset
        return torch.round(bounded) / self._half_width(z.device)

    def codes_to_indices(self, zhat: torch.Tensor) -> torch.Tensor:
        half = self._half_width(zhat.device)
        basis = torch.as_tensor(self._basis, dtype=torch.float32, device=zhat.device)
        return ((zhat * half + half) * basis).sum(dim=-1).to(torch.int32)

    def indices_to_codes(self, indices: torch.Tensor) -> torch.Tensor:
        dev = indices.device
        basis = torch.as_tensor(self._basis, dtype=torch.long, device=dev)
        levels = torch.as_tensor(self._levels, dtype=torch.long, device=dev)
        codes = torch.div(indices.long()[..., None], basis, rounding_mode="floor") % levels
        half = self._half_width(dev)
        return (codes.float() - half) / half


class ResidualFSQ(nn.Module):
    def __init__(self, *, levels: List[int], num_quantizers: int, dim: Optional[int] = None,
                 device=None, **_):
        super().__init__()
        codebook_dim = len(levels)
        dim = dim or codebook_dim
        if codebook_dim != dim:
            self.project_in = Linear(dim, codebook_dim, device=device)
            self.project_out = Linear(codebook_dim, dim, device=device)
        self.layers = nn.ModuleList(FSQ(levels) for _ in range(num_quantizers))
        self.num_quantizers = num_quantizers
        lv = np.asarray(levels, np.float32)
        self._scales = np.stack([(lv - 1) ** -i for i in range(num_quantizers)])
        self.codebook_size = self.layers[0].codebook_size

    def forward(self, x: torch.Tensor):
        """x (B, T, dim) → (quantized (B, T, dim), indices (B, T, Q))."""
        if hasattr(self, "project_in"):
            x = self.project_in(x)
        x = x.float()
        residual = x
        out = torch.zeros_like(x)
        indices = []
        for i, layer in enumerate(self.layers):
            scale = torch.as_tensor(self._scales[i], device=x.device)
            q = layer.quantize(residual / scale) * scale
            indices.append(layer.codes_to_indices(q / scale))
            residual = residual - q
            out = out + q
        if hasattr(self, "project_out"):
            out = self.project_out(out)
        return out, torch.stack(indices, dim=-1)

    def get_output_from_indices(self, indices: torch.Tensor) -> torch.Tensor:
        """indices (B, T, Q) → (B, T, dim)."""
        total = 0.0
        for i, layer in enumerate(self.layers):
            codes = layer.indices_to_codes(indices[..., i])
            total = total + codes * torch.as_tensor(self._scales[i], device=indices.device)
        if hasattr(self, "project_out"):
            total = self.project_out(total)
        return total


class FactorizedVectorQuantize(nn.Module):
    """The semantic VQ: an l2-normalised nearest-code lookup over a
    projected space. Channels-last (B, T, D)."""

    def __init__(self, input_dim: int, codebook_size: int, codebook_dim: int, device=None,
                 **_):
        super().__init__()
        self.input_dim = input_dim
        self.codebook_size = codebook_size
        if input_dim != codebook_dim:
            self.in_project = Conv1d(input_dim, codebook_dim, 1, device=device)
            self.out_project = Conv1d(codebook_dim, input_dim, 1, device=device)
        self.codebook = Embedding(codebook_size, codebook_dim, device=device)

    @staticmethod
    def _norm(x: torch.Tensor) -> torch.Tensor:
        return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-12)

    def tokenize(self, z: torch.Tensor) -> torch.Tensor:
        z_e = self.in_project(z) if hasattr(self, "in_project") else z
        return torch.argmax(self._norm(z_e) @ self._norm(self.codebook.weight).T, dim=-1)

    def detokenize(self, indices: torch.Tensor) -> torch.Tensor:
        w = self.codebook.weight
        z_q = w[clamp_ids(indices.long(), w.shape[0])]
        if hasattr(self, "out_project"):
            z_q = self.out_project(z_q)
        return z_q


# ---------------------------------------------------------------------------
# The feature encoder and decoder, the wave generator
# ---------------------------------------------------------------------------


class SamplingBlock(nn.Module):
    """Up- or downsampling with skip paths, (B, T, C) in and out."""

    def __init__(self, dim: int, groups: int = 1, upsample_scale: int = 1,
                 downsample_scale: int = 1, device=None):
        super().__init__()
        self.upsample_scale = upsample_scale
        self.downsample_scale = downsample_scale
        if upsample_scale > 1:
            self.de_conv_upsampler = ConvTranspose1d(
                dim, dim, 2 * upsample_scale, stride=upsample_scale,
                padding=upsample_scale // 2 + upsample_scale % 2, groups=groups, device=device)
        if downsample_scale > 1:
            self.conv_downsampler = Conv1d(
                dim, dim, 2 * downsample_scale, stride=downsample_scale,
                padding=downsample_scale // 2 + downsample_scale % 2, groups=groups,
                device=device)

    @staticmethod
    def _avgpool(x: torch.Tensor, k: int) -> torch.Tensor:
        B, T, C = x.shape
        n = T // k
        return x[:, : n * k].reshape(B, n, k, C).mean(dim=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.upsample_scale > 1:
            repeat = torch.repeat_interleave(x, self.upsample_scale, dim=1)
            up = repeat + self.de_conv_upsampler(F.leaky_relu(x, 0.2))
        else:
            up = repeat = x
        if self.downsample_scale > 1:
            conv = self.conv_downsampler(F.leaky_relu(up, 0.2))
            return (conv + self._avgpool(up, self.downsample_scale)
                    + self._avgpool(repeat, self.downsample_scale))
        # no downsample: the conv residual and the two skips collapse to
        # up + 2·repeat
        return up + repeat + repeat


class FeatEncoder(nn.Module):
    def __init__(self, input_channels: int, vocos_dim: int, vocos_intermediate_dim: int,
                 vocos_num_layers: int, out_channels: int, sample_ratios: List[int] = (1, 1),
                 device=None):
        super().__init__()
        self.encoder = VocosBackbone(input_channels, vocos_dim, vocos_intermediate_dim,
                                     vocos_num_layers, device=device)
        self.downsample = nn.ModuleList(
            nn.ModuleList([SamplingBlock(vocos_dim, groups=vocos_dim, downsample_scale=r,
                                         device=device),
                           VocosBackbone(vocos_dim, vocos_dim, vocos_intermediate_dim, 2,
                                         device=device)])
            for r in sample_ratios)
        self.project = Linear(vocos_dim, out_channels, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T, input_channels) → (B, T', out_channels)."""
        x = self.encoder(x)
        for block, backbone in self.downsample:
            x = backbone(block(x))
        return self.project(x)


class FeatDecoder(nn.Module):
    def __init__(self, input_channels: int, vocos_dim: int, vocos_intermediate_dim: int,
                 vocos_num_layers: int, out_channels: int, condition_dim: Optional[int] = None,
                 sample_ratios: List[int] = (1, 1), use_tanh_at_final: bool = False,
                 device=None):
        super().__init__()
        self.linear_pre = Linear(input_channels, vocos_dim, device=device)
        # the upsampling list is named `downsample`, as in the checkpoint
        self.downsample = nn.ModuleList(
            nn.ModuleList([SamplingBlock(vocos_dim, groups=vocos_dim, upsample_scale=r,
                                         device=device),
                           VocosBackbone(vocos_dim, vocos_dim, vocos_intermediate_dim, 2,
                                         device=device)])
            for r in sample_ratios)
        # AdaLayerNorm on the d-vector inside every norm of the backbone
        self.vocos_backbone = VocosBackbone(vocos_dim, vocos_dim, vocos_intermediate_dim,
                                            vocos_num_layers,
                                            adanorm_num_embeddings=condition_dim,
                                            device=device)
        self.linear = Linear(vocos_dim, out_channels, device=device)
        self.use_tanh_at_final = use_tanh_at_final

    def forward(self, x: torch.Tensor, c: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, T, input_channels), condition (B, D) → (B, T', out_channels)."""
        x = self.linear_pre(x)
        for block, backbone in self.downsample:
            x = backbone(block(x))
        x = self.linear(self.vocos_backbone(x, bandwidth_id=c))
        return torch.tanh(x) if self.use_tanh_at_final else x


class WaveGenerator(nn.Module):
    """The DAC-style decoder, run channels-first on the port's DAC pieces:
    (B, T, C) → (B, T', 1)."""

    def __init__(self, input_channel: int, channels: int, rates: List[int],
                 kernel_sizes: List[int], d_out: int = 1, device=None):
        super().__init__()
        self.conv_in = Conv1dCF(input_channel, channels, 7, padding=3, device=device)
        blocks = []
        for i, (k, s) in enumerate(zip(kernel_sizes, rates)):
            in_d, out_d = channels // 2 ** i, channels // 2 ** (i + 1)
            blocks.append(nn.ModuleList([
                Snake1d(in_d, device=device),
                ConvTranspose1dCF(in_d, out_d, k, stride=s, padding=(k - s) // 2,
                                  device=device),
                ResidualUnit(out_d, dilation=1, device=device),
                ResidualUnit(out_d, dilation=3, device=device),
                ResidualUnit(out_d, dilation=9, device=device),
            ]))
        self.blocks = nn.ModuleList(blocks)
        final = channels // 2 ** len(rates)
        self.snake_out = Snake1d(final, device=device)
        self.conv_out = Conv1dCF(final, d_out, 7, padding=3, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv_in(x.transpose(1, 2))
        for block in self.blocks:
            for layer in block:
                x = layer(x)
        return torch.tanh(self.conv_out(self.snake_out(x))).transpose(1, 2)


# ---------------------------------------------------------------------------
# The speaker encoder: ECAPA-TDNN, a perceiver resampler, residual FSQ
# ---------------------------------------------------------------------------


class Conv1dReluBn(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 1, stride: int = 1,
                 padding: int = 0, dilation: int = 1, device=None):
        super().__init__()
        self.conv = Conv1d(in_ch, out_ch, kernel_size, stride=stride, padding=padding,
                           dilation=dilation, device=device)
        self.bn = BatchNorm(out_ch, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (B, T, C)
        return self.bn(F.relu(self.conv(x)))


class Res2Conv1dReluBn(nn.Module):
    """The Res2Net grouped convolution, channels-last."""

    def __init__(self, channels: int, kernel_size: int = 1, stride: int = 1,
                 padding: int = 0, dilation: int = 1, scale: int = 4, device=None):
        super().__init__()
        if channels % scale:
            raise ValueError(f"{channels} channels do not split into {scale}")
        self.scale = scale
        self.width = channels // scale
        self.nums = scale if scale == 1 else scale - 1
        self.convs = nn.ModuleList(
            Conv1d(self.width, self.width, kernel_size, stride=stride, padding=padding,
                   dilation=dilation, device=device) for _ in range(self.nums))
        self.bns = nn.ModuleList(BatchNorm(self.width, device=device)
                                 for _ in range(self.nums))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        spx = torch.split(x, self.width, dim=-1)
        out = []
        sp = spx[0]
        for i, (conv, bn) in enumerate(zip(self.convs, self.bns)):
            if i >= 1:
                sp = sp + spx[i]
            sp = bn(F.relu(conv(sp)))
            out.append(sp)
        if self.scale != 1:
            out.append(spx[self.nums])
        return torch.cat(out, dim=-1)


class SE_Connect(nn.Module):
    def __init__(self, channels: int, se_bottleneck_dim: int = 128, device=None):
        super().__init__()
        self.linear1 = Linear(channels, se_bottleneck_dim, device=device)
        self.linear2 = Linear(se_bottleneck_dim, channels, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (B, T, C)
        s = torch.sigmoid(self.linear2(F.relu(self.linear1(x.mean(dim=1)))))
        return x * s[:, None, :]


class SE_Res2Block(nn.Module):
    def __init__(self, channels: int, kernel_size: int, stride: int, padding: int,
                 dilation: int, scale: int, device=None):
        super().__init__()
        self.se_res2block = nn.ModuleList([
            Conv1dReluBn(channels, channels, 1, device=device),
            Res2Conv1dReluBn(channels, kernel_size, stride, padding, dilation, scale=scale,
                             device=device),
            Conv1dReluBn(channels, channels, 1, device=device),
            SE_Connect(channels, device=device),
        ])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        res = x
        for m in self.se_res2block:
            x = m(x)
        return x + res


class ASTP(nn.Module):
    """Attentive statistics pooling."""

    def __init__(self, in_dim: int, bottleneck_dim: int = 128, device=None):
        super().__init__()
        self.linear1 = Conv1d(in_dim, bottleneck_dim, 1, device=device)
        self.linear2 = Conv1d(bottleneck_dim, in_dim, 1, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (B, T, C)
        alpha = torch.tanh(self.linear1(x))
        alpha = torch.softmax(self.linear2(alpha).float(), dim=1).to(x.dtype)
        mean = (alpha * x).sum(dim=1)
        var = (alpha * x ** 2).sum(dim=1) - mean ** 2
        std = torch.sqrt(torch.clamp(var.float(), min=1e-7))
        return torch.cat([mean, std.to(x.dtype)], dim=-1)


class ECAPA_TDNN_GLOB(nn.Module):
    """ECAPA-TDNN at `channels` (upstream's ECAPA_TDNN_GLOB_c512 names 512).
    → (x-vector, latent), the latent relu(conv(cat(layers 2-4))) of width
    3·channels that the perceiver attends over."""

    def __init__(self, feat_dim: int = 100, embed_dim: int = 512, channels: int = 512,
                 res2_scale: int = 8, device=None):
        super().__init__()
        self.layer1 = Conv1dReluBn(feat_dim, channels, 5, padding=2, device=device)
        self.layer2 = SE_Res2Block(channels, 3, 1, 2, 2, res2_scale, device=device)
        self.layer3 = SE_Res2Block(channels, 3, 1, 3, 3, res2_scale, device=device)
        self.layer4 = SE_Res2Block(channels, 3, 1, 4, 4, res2_scale, device=device)
        cat = channels * 3
        self.conv = Conv1d(cat, cat, 1, device=device)
        self.pool = ASTP(cat, device=device)
        self.bn = BatchNorm(cat * 2, device=device)
        self.linear = Linear(cat * 2, embed_dim, device=device)

    def forward(self, mels: torch.Tensor, return_latent: bool = False):
        """mels (B, T, feat_dim)."""
        x1 = self.layer1(mels)
        x2 = self.layer2(x1)
        x3 = self.layer3(x2)
        x4 = self.layer4(x3)
        latent = F.relu(self.conv(torch.cat([x2, x3, x4], dim=-1)))
        x_vec = self.linear(self.bn(self.pool(latent)))
        return (x_vec, latent) if return_latent else x_vec


class _PerceiverAttn(nn.Module):
    def __init__(self, dim: int, dim_head: int = 64, heads: int = 8, device=None):
        super().__init__()
        inner = dim_head * heads
        self.heads = heads
        self.dim_head = dim_head
        self.to_q = Linear(dim, inner, bias=False, device=device)
        self.to_kv = Linear(dim, inner * 2, bias=False, device=device)
        self.to_out = Linear(inner, dim, bias=False, device=device)

    def forward(self, latents: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        B, Tq, _ = latents.shape
        # the queries attend over themselves and the context
        kv_in = torch.cat([latents, context], dim=1)
        q = self.to_q(latents).reshape(B, Tq, self.heads, self.dim_head)
        k, v = self.to_kv(kv_in).chunk(2, dim=-1)
        Tk = kv_in.shape[1]
        k = k.reshape(B, Tk, self.heads, self.dim_head)
        v = v.reshape(B, Tk, self.heads, self.dim_head)
        q, k, v = (a.transpose(1, 2) for a in (q, k, v))
        scores = q @ k.transpose(-1, -2) * self.dim_head ** -0.5
        attn = torch.softmax(scores.float(), dim=-1).to(latents.dtype)
        return self.to_out((attn @ v).transpose(1, 2).reshape(B, Tq, -1))


class _GEGLU(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a, gate = x.chunk(2, dim=-1)
        return a * F.gelu(gate, approximate="tanh")  # jax.nn.gelu's default


class PerceiverResampler(nn.Module):
    def __init__(self, *, dim: int, depth: int = 2, dim_context: Optional[int] = None,
                 num_latents: int = 32, dim_head: int = 64, heads: int = 8,
                 ff_mult: int = 4, device=None):
        super().__init__()
        dim_context = dim_context or dim
        if dim_context != dim:
            self.proj_context = Linear(dim_context, dim, device=device)
        self.latents = nn.Parameter(torch.empty(num_latents, dim, device=device))
        # the feed-forward is a bare [Linear, GEGLU, Linear], inner
        # dim·mult·2/3: checkpoint keys layers.N.1.{0,2}.{weight,bias}
        inner = int(dim * ff_mult * 2 / 3)
        self.layers = nn.ModuleList(
            nn.ModuleList([_PerceiverAttn(dim, dim_head, heads, device=device),
                           nn.ModuleList([Linear(dim, inner * 2, device=device), _GEGLU(),
                                          Linear(inner, dim, device=device)])])
            for _ in range(depth))
        self.norm = RMSNorm(dim, device=device)

    def reset_parameters(self, generator=None) -> None:
        self.latents.data.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B = x.shape[0]
        if hasattr(self, "proj_context"):
            x = self.proj_context(x)
        latents = self.latents.to(x.dtype).expand(B, -1, -1)
        for attn, ff in self.layers:
            latents = attn(latents, x) + latents
            h = latents
            for mod in ff:
                h = mod(h)
            latents = latents + h
        return self.norm(latents)


class SpeakerEncoder(nn.Module):
    def __init__(self, input_dim: int = 100, out_dim: int = 512, latent_dim: int = 128,
                 token_num: int = 32, fsq_levels: Optional[List[int]] = None,
                 fsq_num_quantizers: int = 1, ecapa_channels: int = 512, device=None):
        super().__init__()
        fsq_levels = fsq_levels or [4, 4, 4, 4, 4, 4]
        self.speaker_encoder = ECAPA_TDNN_GLOB(input_dim, out_dim, ecapa_channels,
                                               device=device)
        self.perceiver_sampler = PerceiverResampler(dim=latent_dim,
                                                    dim_context=ecapa_channels * 3,
                                                    num_latents=token_num, device=device)
        self.quantizer = ResidualFSQ(levels=fsq_levels, num_quantizers=fsq_num_quantizers,
                                     dim=latent_dim, device=device)
        self.project = Linear(latent_dim * token_num, out_dim, device=device)

    def tokenize(self, mels: torch.Tensor) -> torch.Tensor:
        """(B, T, n_mels) → global token indices (B, tokens, Q)."""
        _, feats = self.speaker_encoder(mels, True)
        _, indices = self.quantizer(self.perceiver_sampler(feats))
        return indices

    def detokenize(self, indices: torch.Tensor) -> torch.Tensor:
        """(B, tokens, Q) → the d-vector (B, out_dim); raises unless there
        are exactly `token_num` tokens."""
        zq = self.quantizer.get_output_from_indices(indices)
        return self.project(zq.reshape(zq.shape[0], -1))


# ---------------------------------------------------------------------------
# BiCodec
# ---------------------------------------------------------------------------


def bicodec_mel(audio, sample_rate: int = 16000, n_fft: int = 1024, hop_length: int = 320,
                num_mels: int = 128, fmin: float = 10, win_length: Optional[int] = None,
                **_) -> torch.Tensor:
    """log(max(mel(|STFT|), 1e-5)) on the slaney scale from `fmin`, with
    slaney norm: audio (..., T) → (..., frames, num_mels)."""
    x = torch.as_tensor(audio).float()
    spec = stft(x, n_fft=n_fft, hop_length=hop_length, win_length=win_length or n_fft,
                window="hann")
    filters = mel_filters(sample_rate, n_fft, num_mels, f_min=fmin, norm="slaney",
                          mel_scale="slaney", device=x.device)
    return torch.log(torch.clamp(spec.abs() @ filters.T, min=1e-5))


def _build(cls, kw: dict, device):
    """`cls` from a config section, keeping the keys its signature takes."""
    params = inspect.signature(cls.__init__).parameters
    if not any(p.kind == inspect.Parameter.VAR_KEYWORD for p in params.values()):
        kw = {k: v for k, v in kw.items() if k in params}
    return cls(**kw, device=device)


class BiCodec(nn.Module):
    def __init__(self, encoder, decoder, quantizer, speaker_encoder, prenet, postnet,
                 mel_params: Optional[dict] = None, ref_clip_params: Optional[dict] = None):
        super().__init__()
        self.encoder = encoder
        self.decoder = decoder
        self.quantizer = quantizer
        self.speaker_encoder = speaker_encoder
        self.prenet = prenet
        self.postnet = postnet
        self.mel_params = mel_params or {}
        # sample_rate, ref_segment_duration and latent_hop_length from the
        # checkpoint's top-level config
        self.ref_clip_params = ref_clip_params or {}

    @property
    def device(self) -> torch.device:
        return self.prenet.linear_pre.weight.device

    @classmethod
    def from_config(cls, cfg: dict, device=None, seed: int = 0,
                    ref_clip_params: Optional[dict] = None) -> "BiCodec":
        """A BiCodec from the `audio_tokenizer` section of its config.yaml on
        `device` (None: the card), weights drawn from `seed`."""
        device = resolve_device(device)
        mel = cfg.get("mel_params", {})
        mel_params = dict(sample_rate=mel.get("sample_rate", 16000),
                          n_fft=mel.get("n_fft", 1024), hop_length=mel.get("hop_length", 320),
                          win_length=mel.get("win_length"), num_mels=mel.get("num_mels", 128),
                          fmin=mel.get("mel_fmin", 10))
        bc = cls(encoder=_build(FeatEncoder, cfg["encoder"], device),
                 decoder=_build(WaveGenerator, cfg["decoder"], device),
                 quantizer=_build(FactorizedVectorQuantize, cfg["quantizer"], device),
                 speaker_encoder=_build(SpeakerEncoder, cfg["speaker_encoder"], device),
                 prenet=_build(FeatDecoder, cfg["prenet"], device),
                 postnet=_build(FeatDecoder, cfg["postnet"], device),
                 mel_params=mel_params, ref_clip_params=ref_clip_params)
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        return init_weights(bc, gen)

    def get_ref_clip(self, wav) -> np.ndarray:
        """The speaker reference: `ref_segment_duration` seconds rounded down
        to whole latent hops, the waveform tiled where it is shorter."""
        p = self.ref_clip_params
        sr = int(p.get("sample_rate", 16000))
        dur = float(p.get("ref_segment_duration", 6.0))
        hop = int(p.get("latent_hop_length", 320))
        ref_len = int(sr * dur) // hop * hop
        wav = np.asarray(wav).reshape(-1)
        if ref_len > wav.shape[0]:
            wav = np.tile(wav, ref_len // wav.shape[0] + 1)
        return wav[:ref_len]

    @torch.inference_mode()
    def tokenize(self, feat, ref_wav):
        """feat (B, T, D) Wav2Vec2-style features, ref_wav (B, T_ref) →
        (semantic tokens (B, T'), global tokens (B, tokens, Q))."""
        dev = self.device
        mel = bicodec_mel(torch.as_tensor(ref_wav, device=dev), **self.mel_params)
        z = self.encoder(torch.as_tensor(feat, device=dev).float())
        return self.quantizer.tokenize(z), self.speaker_encoder.tokenize(mel)

    @torch.inference_mode()
    def detokenize(self, semantic_tokens, global_tokens) -> torch.Tensor:
        """semantic (B, T), global (B, tokens, Q) → waveform (B, T_wav)."""
        dev = self.device
        z_q = self.quantizer.detokenize(torch.as_tensor(semantic_tokens, device=dev))
        d_vector = self.speaker_encoder.detokenize(torch.as_tensor(global_tokens, device=dev))
        x = self.prenet(z_q, d_vector) + d_vector[:, None, :]
        return self.decoder(x)[..., 0]

    def sanitize(self, weights: dict) -> dict:
        """The published checkpoint (upstream's module tree) → this tree: fold
        weight-norm pairs, strip the Sequential `.layers.N` wrappers, map the
        wave generator's flat `model.N` list onto conv_in, blocks, snake_out
        and conv_out, drop the FSQ geometry, and orient every layout to the
        JAX package's (Snake alphas (1, 1, C), convolutions (O, K, I))."""
        from ....nn.sanitize import as_float32, orient_weights_to_model

        n_rates = len(self.decoder.blocks)
        out = {}
        for k, v in fold_weight_norm_pairs(weights).items():
            if ("num_batches_tracked" in k or "_implicit_codebook" in k
                    or k.split(".")[-1] in ("_levels", "_basis", "_scales")):
                continue  # the FSQ geometry comes from the config
            k = re.sub(r"(conv_downsampler|de_conv_upsampler)\.layers\.1\.", r"\1.", k)
            m = re.match(r"^decoder\.model\.(\d+)\.(.+)$", k)
            if m:
                idx, rest = int(m.group(1)), m.group(2)
                rest = rest.replace("block.layers.", "block.")
                if idx == 0:
                    k = f"decoder.conv_in.{rest}"
                elif idx <= n_rates:
                    rest = rest[len("block."):] if rest.startswith("block.") else rest
                    k = f"decoder.blocks.{idx - 1}.{rest}"
                elif idx == n_rates + 1:
                    k = f"decoder.snake_out.{rest}"
                else:
                    k = f"decoder.conv_out.{rest}"
            k = k.replace(".block.layers.", ".block.")
            k = re.sub(r"\.norm\.gamma$", ".norm.weight", k)
            v = as_float32(v)
            if k.endswith(".alpha") and v.ndim == 3 and v.shape[1] > v.shape[2]:
                v = v.transpose(0, 2, 1)
            out[k] = v
        return orient_weights_to_model(self, out)


def load_bicodec(model_dir, device=None) -> BiCodec:
    """A BiCodec from a checkpoint's `BiCodec/` directory (config.yaml and
    weights), in float32 on `device` (None: the card)."""
    import yaml

    from ....utils import load_weight_files

    model_dir = Path(model_dir)
    raw = yaml.safe_load((model_dir / "config.yaml").read_text())
    cfg = raw.get("audio_tokenizer", raw)
    bc = BiCodec.from_config(cfg, device=device, ref_clip_params={
        k: raw[k] for k in ("sample_rate", "ref_segment_duration", "latent_hop_length",
                            "volume_normalize") if k in raw})
    return load_weights(bc, bc.sanitize(load_weight_files(model_dir)), strict=False).eval()


class SparkWav2VecFeatures:
    """BiCodec's semantic features: the Wav2Vec2-XLSR-53 encoder shipped in
    the Spark checkpoint, its hidden states 11, 14 and 16 averaged."""

    def __init__(self, model_dir, device=None):
        import json

        from ....stt.models.wav2vec.wav2vec import Model as W2VModel
        from ....stt.models.wav2vec.wav2vec import ModelConfig as W2VConfig
        from ....utils import load_weight_files

        model_dir = Path(model_dir)
        cfg = json.loads((model_dir / "config.json").read_text())
        cfg["vocab_size"] = 0  # the encoder alone, no CTC head
        model = W2VModel(W2VConfig.from_dict(cfg), device=device)
        weights = {k: v for k, v in model.sanitize(load_weight_files(model_dir)).items()
                   if not k.startswith("lm_head")}
        self.model = load_weights(model, weights, strict=False).eval()

    @torch.inference_mode()
    def __call__(self, wavs) -> torch.Tensor:
        """(B, T) waveform → (B, T', hidden) mixed hidden states."""
        x = torch.as_tensor(np.asarray(wavs, np.float32), device=self.model.device)
        # zero mean, unit variance per utterance (the processor's do_normalize)
        x = (x - x.mean(dim=-1, keepdim=True)) / (x.std(dim=-1, keepdim=True,
                                                        correction=0) + 1e-7)
        hs = self.model.wav2vec2.hidden_states(x)
        return (hs[11] + hs[14] + hs[16]) / 3


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------


@dataclass
class ModelConfig:
    model_type: str = "spark"
    sample_rate: int = 16000
    llm: dict = field(default_factory=dict)
    highpass_cutoff_freq: int = 40
    model_path: str = ""

    @classmethod
    def from_dict(cls, d: dict) -> "ModelConfig":
        return cls(**{k: v for k, v in d.items() if k in cls.__dataclass_fields__})


def _level(v, table) -> str:
    """A level name, or a float snapped to the nearest control level."""
    if isinstance(v, str):
        return v
    return table[min(table, key=lambda k: abs(k - float(v)))]


class Model(nn.Module):
    """Spark-TTS on an explicit device (None: the card); the LLM drawn from
    `seed`. BiCodec, the tokenizer and the Wav2Vec2 features come from the
    checkpoint directory (`BiCodec/`, `tokenizer.json`,
    `wav2vec2-large-xlsr-53/`) or from `set_runtime`."""

    def __init__(self, config: Any = None, device=None, seed: int = 0):
        super().__init__()
        if isinstance(config, dict):
            config = ModelConfig.from_dict(config)
        self.config = config or ModelConfig()
        self.sample_rate = self.config.sample_rate
        self.device = resolve_device(device)
        llm = self.config.llm or {}
        self.llm = CausalLM(LMConfig(
            model_type="qwen2", vocab_size=llm.get("vocab_size", 166000),
            hidden_size=llm.get("hidden_size", 896),
            intermediate_size=llm.get("intermediate_size", 4864),
            num_hidden_layers=llm.get("num_hidden_layers", 24),
            num_attention_heads=llm.get("num_attention_heads", 14),
            num_key_value_heads=llm.get("num_key_value_heads", 2),
            rope_theta=llm.get("rope_theta", 1000000.0), attention_bias=True,
            tie_word_embeddings=llm.get("tie_word_embeddings", True)),
            device=self.device, seed=seed)
        self._runtime = {}

    def set_runtime(self, tokenizer=None, bicodec=None, feature_extractor=None):
        if tokenizer is not None:
            self._runtime["tokenizer"] = tokenizer
        if bicodec is not None:
            self._runtime["bicodec"] = bicodec
        if feature_extractor is not None:
            self._runtime["feature_extractor"] = feature_extractor

    def _resolve_runtime(self) -> dict:
        """The tokenizer, BiCodec and Wav2Vec2 features, from the checkpoint
        directory where `set_runtime` gave none."""
        rt = self._runtime
        mp = self.config.model_path
        if mp:
            mp = Path(mp)
            if "tokenizer" not in rt and (mp / "tokenizer.json").is_file():
                from ....tokenizer_json import load

                rt["tokenizer"] = load(mp / "tokenizer.json")
            if "bicodec" not in rt and (mp / "BiCodec").is_dir():
                rt["bicodec"] = load_bicodec(mp / "BiCodec", device=self.device)
            w2v = mp / "wav2vec2-large-xlsr-53"
            if "feature_extractor" not in rt and w2v.is_dir():
                rt["feature_extractor"] = SparkWav2VecFeatures(w2v, device=self.device)
        return rt

    def _eos_ids(self, tokenizer) -> tuple:
        eos = getattr(tokenizer, "eos_token_id", None)
        if eos is None and self.config.model_path:
            from ....tokenizer_json import config_token_id

            eos = config_token_id(self.config.model_path, tokenizer, "eos_token")
        return () if eos is None else (int(eos),)

    def make_batcher(self, **kwargs):
        """Serving batcher: the semantic-token decode is a plain token-prompt
        LM, so concurrent requests ride continuous (slot-based) batching;
        BiCodec's detokenize stays per request."""
        from ....serving import LMContinuousBatcher

        return LMContinuousBatcher(self, lm=self.llm, **kwargs)

    def process_prompt_control(self, text: str, gender: str = "female",
                               pitch: str = "moderate", speed: str = "moderate") -> str:
        """The voice-creation prompt."""
        attrs = (f"<|gender_{GENDER_MAP[gender]}|><|pitch_label_{LEVELS_MAP[pitch]}|>"
                 f"<|speed_label_{LEVELS_MAP[speed]}|>")
        return ("<|task_controllable_tts|><|start_content|>" + text
                + "<|end_content|><|start_style_label|>" + attrs + "<|end_style_label|>")

    def process_prompt(self, text: str, global_token_ids,
                       semantic_token_ids=None, ref_text: Optional[str] = None) -> str:
        """The voice-clone prompt."""
        g = "".join(f"<|bicodec_global_{int(i)}|>"
                    for i in np.asarray(global_token_ids).reshape(-1))
        if ref_text is not None and semantic_token_ids is not None:
            s = "".join(f"<|bicodec_semantic_{int(i)}|>"
                        for i in np.asarray(semantic_token_ids).reshape(-1))
            return ("<|task_tts|><|start_content|>" + ref_text + text
                    + "<|end_content|><|start_global_token|>" + g
                    + "<|end_global_token|><|start_semantic_token|>" + s)
        return ("<|task_tts|><|start_content|>" + text
                + "<|end_content|><|start_global_token|>" + g + "<|end_global_token|>")

    def _reference_tokens(self, rt: dict, bicodec: BiCodec, ref_audio):
        """(semantic tokens, global tokens) of a reference clip: the global
        ones from a fixed-length clip, the semantic ones from the whole
        waveform's Wav2Vec2 features."""
        fe = rt.get("feature_extractor")
        if fe is None:
            raise RuntimeError(
                "a voice clone needs the Wav2Vec2 features: load Spark from a checkpoint "
                "directory with wav2vec2-large-xlsr-53/, or call set_runtime("
                "feature_extractor=...) (the JAX package tokenizes zeros here)")
        clip = bicodec.ref_clip_params or {}
        if isinstance(ref_audio, (str, Path)):
            from ....utils import load_audio

            ref_audio = load_audio(ref_audio, sample_rate=int(clip.get("sample_rate", 16000)),
                                   volume_normalize=bool(clip.get("volume_normalize", False)))
        wav = np.asarray(ref_audio, np.float32).reshape(1, -1)
        ref_wav = bicodec.get_ref_clip(wav)[None]
        return bicodec.tokenize(fe(wav), ref_wav)

    def generate(self, text: str, ref_audio=None, ref_text=None,
                 gender: Optional[str] = "male", pitch=1.0, speed=1.0,
                 max_tokens: int = 3000, temperature: float = 0.8, top_k: int = 50,
                 top_p: float = 0.95, split_pattern: str = "\n", verbose: bool = False,
                 seed: int = 0, **kwargs) -> Generator[GenerationResult, None, None]:
        """One GenerationResult a segment. Float pitch and speed snap to the
        nearest level; `ref_audio` switches to the voice clone."""
        from ....serving import get_infer_hook

        pitch, speed = _level(pitch, PITCH_MAP), _level(speed, SPEED_MAP)
        if ref_audio is not None:
            gender = None
        rt = self._resolve_runtime()
        tokenizer, bicodec = rt.get("tokenizer"), rt.get("bicodec")
        if tokenizer is None or bicodec is None:
            raise RuntimeError(
                "Spark runtime (tokenizer/bicodec) not set: call set_runtime(...) or load "
                "from a full checkpoint directory (tokenizer.json and BiCodec/) via "
                "load_model()")
        ref_global = ref_semantic = None
        if gender is None:
            if ref_audio is None:
                raise ValueError("Provide ref_audio or gender controls")
            ref_semantic, ref_global = self._reference_tokens(rt, bicodec, ref_audio)
            ref_semantic, ref_global = ref_semantic.cpu().numpy(), ref_global.cpu().numpy()
        eos_ids = self._eos_ids(tokenizer)
        sampling = dict(max_tokens=max_tokens, top_k=top_k, top_p=top_p,
                        repetition_penalty=kwargs.get("repetition_penalty", 1.3),
                        repetition_context_size=kwargs.get("repetition_context_size", 20),
                        seed=seed)
        splits = [s for s in text.split(split_pattern) if s.strip()] or [text]
        for segment_idx, text_split in enumerate(splits):
            start = time.perf_counter()
            global_token_ids = ref_global
            if gender is not None:
                prompt = self.process_prompt_control(text_split, gender, pitch, speed)
            else:
                prompt = self.process_prompt(text_split, ref_global,
                                             ref_semantic if ref_text else None, ref_text)
            ids = np.asarray(tokenizer.encode(prompt), np.int64).reshape(-1)
            # under a running server an LMContinuousBatcher may be installed:
            # concurrent requests' token streams then decode in lock-step
            hook = get_infer_hook(self)
            if hook is not None:
                out = hook.submit([int(t) for t in ids], temp=temperature, eos_ids=eos_ids,
                                  **sampling).result()
                out_ids = np.asarray([out], np.int64)
            else:
                out_ids, _ = generate_tokens(self.llm, ids, temp=temperature,
                                             eos_token_ids=eos_ids, **sampling)
            text_out = tokenizer.decode([int(t) for t in np.asarray(out_ids).reshape(-1)],
                                        skip_special_tokens=False)
            semantic_ids = [int(m) for m in re.findall(r"bicodec_semantic_(\d+)", text_out)]
            if gender is not None:
                g_ids = [int(m) for m in re.findall(r"bicodec_global_(\d+)", text_out)]
                global_token_ids = np.asarray(g_ids)[None, :, None]
            if not semantic_ids:
                raise RuntimeError("LLM produced no semantic tokens")
            gt = np.asarray(global_token_ids)
            if gt.ndim == 2:
                gt = gt[:, :, None]
            wav = bicodec.detokenize(np.asarray([semantic_ids], np.int64), gt.astype(np.int64))
            audio = wav.float().cpu().numpy().reshape(-1)
            elapsed = time.perf_counter() - start
            dur = len(audio) / self.sample_rate
            if verbose:
                print(f"[spark] segment {segment_idx}: {len(semantic_ids)} tokens, "
                      f"{dur:.2f}s audio")
            yield GenerationResult(
                audio=audio, samples=len(audio), sample_rate=self.sample_rate,
                segment_idx=segment_idx, token_count=len(semantic_ids),
                audio_duration=format_duration(dur),
                real_time_factor=round(elapsed / max(dur, 1e-9), 2),
                prompt={"tokens": int(ids.shape[0])}, audio_samples={},
                processing_time_seconds=elapsed, peak_memory_usage=0.0)

    def sanitize(self, weights: dict) -> dict:
        """The LLM's keys under `llm.` (a checkpoint may carry them bare); a
        tied head's `lm_head.weight` dropped."""
        out = {}
        tied = self.llm.config.tie_word_embeddings
        for k, v in weights.items():
            if not k.startswith("llm."):
                k = "llm." + k
            if tied and k == "llm.lm_head.weight":
                continue
            out[k] = v
        return out
