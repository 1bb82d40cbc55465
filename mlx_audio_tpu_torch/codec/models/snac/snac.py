"""SNAC, the multi-scale residual VQ codec (counterpart of
`mlx_audio_tpu/codec/models/snac/snac.py`): a convolutional encoder and
decoder around codebooks at several temporal strides, with optional
windowed local attention. Channels-last (B, T, C) inside; weight norm is
folded at load (`sanitize`).

One deliberate difference: the decoder's `NoiseBlock`s draw their Gaussian
noise from a `torch.Generator` seeded 0 at every decode (the JAX package
draws `jax.random.normal(PRNGKey(0))`, which torch cannot reproduce), or
take it from `noise_fn(shape)` where the caller gives one (the parity tests
pass the JAX draws in). Each block draws for its own shape, so the noise of
a decode depends only on its length, as in the JAX package.
"""

from __future__ import annotations

import json
import math
from pathlib import Path
from typing import Callable, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ....device import resolve_device
from ....nn import Conv1d, ConvTranspose1d, Embedding, LayerNorm, Linear
from ....nn.activations import snake
from ....nn.module import init_weights, load_weights
from ..base import fold_weight_norm_pairs

__all__ = ["SNAC", "NoiseFn"]

# noise_fn(shape) -> a float tensor of that shape (any device and dtype)
NoiseFn = Callable[[tuple], torch.Tensor]


class Snake1d(nn.Module):
    def __init__(self, channels: int, device=None):
        super().__init__()
        self.alpha = nn.Parameter(torch.empty(1, channels, 1, device=device))  # (1, C, 1)

    def reset_parameters(self, generator=None) -> None:
        self.alpha.data.fill_(1.0)

    def forward(self, x):  # (B, T, C)
        return snake(x, self.alpha.transpose(1, 2))


class ResidualUnit(nn.Module):
    def __init__(self, dim=16, dilation=1, kernel=7, groups=1, device=None):
        super().__init__()
        pad = ((kernel - 1) * dilation) // 2
        self.block = nn.ModuleList([
            Snake1d(dim, device=device),
            Conv1d(dim, dim, kernel, dilation=dilation, padding=pad, groups=groups,
                   device=device),
            Snake1d(dim, device=device),
            Conv1d(dim, dim, 1, device=device),
        ])

    def forward(self, x):
        y = x
        for layer in self.block:
            y = layer(y)
        pad = (x.shape[1] - y.shape[1]) // 2
        if pad > 0:
            x = x[:, pad:-pad]
        return x + y


class EncoderBlock(nn.Module):
    def __init__(self, output_dim=16, input_dim=None, stride=1, groups=1, device=None):
        super().__init__()
        input_dim = input_dim or output_dim // 2
        self.block = nn.ModuleList([
            ResidualUnit(input_dim, dilation=1, groups=groups, device=device),
            ResidualUnit(input_dim, dilation=3, groups=groups, device=device),
            ResidualUnit(input_dim, dilation=9, groups=groups, device=device),
            Snake1d(input_dim, device=device),
            Conv1d(input_dim, output_dim, 2 * stride, stride=stride,
                   padding=math.ceil(stride / 2), device=device),
        ])

    def forward(self, x):
        for layer in self.block:
            x = layer(x)
        return x


def _default_noise(device) -> NoiseFn:
    """A generator seeded 0, drawn from at every decode."""
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    return lambda shape: torch.randn(shape, generator=gen, device=device)


class NoiseBlock(nn.Module):
    def __init__(self, dim, device=None):
        super().__init__()
        self.linear = Conv1d(dim, dim, 1, bias=False, device=device)

    def forward(self, x, noise_fn: NoiseFn):
        B, T, _ = x.shape
        noise = noise_fn((B, T, 1)).to(device=x.device, dtype=x.dtype)
        return x + noise * self.linear(x)


class DecoderBlock(nn.Module):
    def __init__(self, input_dim=16, output_dim=8, stride=1, noise=False, groups=1,
                 device=None):
        super().__init__()
        layers = [
            Snake1d(input_dim, device=device),
            ConvTranspose1d(input_dim, output_dim, 2 * stride, stride=stride,
                            padding=math.ceil(stride / 2), output_padding=stride % 2,
                            device=device),
        ]
        if noise:
            layers.append(NoiseBlock(output_dim, device=device))
        layers += [
            ResidualUnit(output_dim, dilation=1, groups=groups, device=device),
            ResidualUnit(output_dim, dilation=3, groups=groups, device=device),
            ResidualUnit(output_dim, dilation=9, groups=groups, device=device),
        ]
        self.block = nn.ModuleList(layers)

    def forward(self, x, noise_fn: NoiseFn):
        for layer in self.block:
            x = layer(x, noise_fn) if isinstance(layer, NoiseBlock) else layer(x)
        return x


def _rotate_half(x):
    d = x.shape[-1] // 2
    return torch.cat([-x[..., d:], x[..., :d]], dim=-1)


class LocalMHA(nn.Module):
    """Attention within non-overlapping windows of `window_size` positions,
    one batched product over the windows, with rotary positions inside each
    window."""

    def __init__(self, dim=1024, window_size=32, dim_head=64, use_rotary_pos_emb=True,
                 device=None):
        super().__init__()
        self.norm = LayerNorm(dim, device=device)
        self.to_qkv = Linear(dim, dim * 3, bias=False, device=device)
        self.to_out = Linear(dim, dim, bias=False, device=device)
        self.rotary = use_rotary_pos_emb
        self.heads = dim // dim_head
        self.dim_head = dim_head
        self.window_size = window_size

    def _freqs(self, device) -> torch.Tensor:
        """(window, dim_head) rotary angles, as the JAX package's
        `SinusoidalEmbeddings`."""
        d = self.dim_head
        inv_freq = 1.0 / (10000 ** (torch.arange(0, d, 2, dtype=torch.float32,
                                                 device=device) / d))
        t = torch.arange(self.window_size, dtype=torch.float32, device=device)
        freqs = t[:, None] * inv_freq[None, :]
        return torch.cat([freqs, freqs], dim=-1)

    def forward(self, x):  # (B, T, C)
        B, T, C = x.shape
        W, n = T // self.window_size, self.window_size
        q, k, v = self.to_qkv(self.norm(x)).chunk(3, dim=-1)

        def windows(z):  # (B, H, W, n, d)
            return z.reshape(B, W, n, self.heads, self.dim_head).permute(0, 3, 1, 2, 4)

        q, k, v = windows(q), windows(k), windows(v)
        if self.rotary:
            freqs = self._freqs(x.device)
            cos, sin = torch.cos(freqs), torch.sin(freqs)
            q = (q * cos + _rotate_half(q) * sin).to(v.dtype)
            k = (k * cos + _rotate_half(k) * sin).to(v.dtype)
        scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(self.dim_head)
        attn = torch.softmax(scores, dim=-1).to(v.dtype)
        out = torch.matmul(attn, v).permute(0, 2, 3, 1, 4).reshape(B, T, C)
        return self.to_out(out) + x


class Encoder(nn.Module):
    def __init__(self, d_model=64, strides=(3, 3, 7, 7), depthwise=False,
                 attn_window_size=32, device=None):
        super().__init__()
        layers = [Conv1d(1, d_model, 7, padding=3, device=device)]
        for stride in strides:
            d_model *= 2
            groups = d_model // 2 if depthwise else 1
            layers.append(EncoderBlock(output_dim=d_model, stride=stride, groups=groups,
                                       device=device))
        if attn_window_size is not None:
            layers.append(LocalMHA(dim=d_model, window_size=attn_window_size, device=device))
        groups = d_model if depthwise else 1
        layers.append(Conv1d(d_model, d_model, 7, padding=3, groups=groups, device=device))
        self.block = nn.ModuleList(layers)

    def forward(self, x):
        for layer in self.block:
            x = layer(x)
        return x


class Decoder(nn.Module):
    def __init__(self, input_channel, channels, rates, noise=False, depthwise=False,
                 attn_window_size=32, d_out=1, device=None):
        super().__init__()
        if depthwise:
            layers = [
                Conv1d(input_channel, input_channel, 7, padding=3, groups=input_channel,
                       device=device),
                Conv1d(input_channel, channels, 1, device=device),
            ]
        else:
            layers = [Conv1d(input_channel, channels, 7, padding=3, device=device)]
        if attn_window_size is not None:
            layers.append(LocalMHA(dim=channels, window_size=attn_window_size, device=device))
        output_dim = channels
        for i, stride in enumerate(rates):
            input_dim = channels // (2 ** i)
            output_dim = channels // (2 ** (i + 1))
            groups = output_dim if depthwise else 1
            layers.append(DecoderBlock(input_dim, output_dim, stride, noise, groups,
                                       device=device))
        layers += [Snake1d(output_dim, device=device),
                   Conv1d(output_dim, d_out, 7, padding=3, device=device)]
        self.model = nn.ModuleList(layers)

    def forward(self, x, noise_fn: NoiseFn):
        for layer in self.model:
            x = layer(x, noise_fn) if isinstance(layer, DecoderBlock) else layer(x)
        return torch.tanh(x)


def _l2n(x, eps=1e-12):
    return x / x.norm(dim=-1, keepdim=True).clamp(min=eps)


class VectorQuantize(nn.Module):
    def __init__(self, input_dim, codebook_size, codebook_dim, stride: int = 1, device=None):
        super().__init__()
        self.in_proj = Conv1d(input_dim, codebook_dim, 1, device=device)
        self.out_proj = Conv1d(codebook_dim, input_dim, 1, device=device)
        self.codebook = Embedding(codebook_size, codebook_dim, device=device)
        self.stride = stride

    def forward(self, z):  # (B, T, D) → (z_q, indices)
        if self.stride > 1:
            B, T, D = z.shape
            z = z.reshape(B, T // self.stride, self.stride, D).mean(dim=2)
        z_q, indices = self.decode_latents(self.in_proj(z))
        z_q = self.out_proj(z_q)
        if self.stride > 1:
            z_q = z_q.repeat_interleave(self.stride, dim=1)
        return z_q, indices

    def decode_code(self, embed_id):
        """Codes → rows; a code past the codebook takes the last row, as the
        JAX package's gather clamps it (the embedding's own lookup)."""
        return self.codebook(embed_id)

    def decode_latents(self, latents):
        """The nearest codebook entries by cosine similarity, as float32
        scores."""
        sim = torch.matmul(_l2n(latents).float(), _l2n(self.codebook.weight).float().T)
        indices = torch.argmax(sim, dim=-1)
        return self.decode_code(indices), indices


class ResidualVectorQuantize(nn.Module):
    def __init__(self, input_dim=512, codebook_size=4096, codebook_dim=8,
                 vq_strides=(8, 4, 2, 1), device=None):
        super().__init__()
        self.n_codebooks = len(vq_strides)
        self.quantizers = nn.ModuleList(
            VectorQuantize(input_dim, codebook_size, codebook_dim, s, device=device)
            for s in vq_strides)

    def forward(self, z):
        z_q = torch.zeros_like(z)
        residual = z
        codes = []
        for q in self.quantizers:
            z_q_i, idx = q(residual)
            z_q = z_q + z_q_i
            residual = residual - z_q_i
            codes.append(idx)
        return z_q, codes

    def from_codes(self, codes: List[torch.Tensor]):
        z_q = None
        for i, q in enumerate(self.quantizers):
            z_q_i = q.out_proj(q.decode_code(codes[i]))
            if q.stride > 1:
                z_q_i = z_q_i.repeat_interleave(q.stride, dim=1)
            z_q = z_q_i if z_q is None else z_q + z_q_i
        return z_q


class SNAC(nn.Module):
    """The codec on an explicit device (None: the card), weights drawn from
    `seed`."""

    def __init__(self, sampling_rate=44100, encoder_dim=64, encoder_rates=(3, 3, 7, 7),
                 latent_dim=None, decoder_dim=1536, decoder_rates=(7, 7, 3, 3),
                 attn_window_size=32, codebook_size=4096, codebook_dim=8,
                 vq_strides=(8, 4, 2, 1), noise=True, depthwise=True, device=None,
                 seed: int = 0, **kwargs):
        super().__init__()
        self.device = resolve_device(device)
        if latent_dim is None:
            latent_dim = encoder_dim * (2 ** len(encoder_rates))
        self.sampling_rate = sampling_rate
        self.hop_length = int(np.prod(encoder_rates))
        self.vq_strides = list(vq_strides)
        self.attn_window_size = attn_window_size
        self.encoder = Encoder(encoder_dim, encoder_rates, depthwise, attn_window_size,
                               device=self.device)
        self.quantizer = ResidualVectorQuantize(latent_dim, codebook_size, codebook_dim,
                                                vq_strides, device=self.device)
        self.decoder = Decoder(latent_dim, decoder_dim, decoder_rates, noise, depthwise,
                               attn_window_size, device=self.device)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        init_weights(self, gen)

    def preprocess(self, audio_data: torch.Tensor) -> torch.Tensor:
        """Right-pad (B, 1, T) audio to a whole number of the strides' and
        the attention window's common period."""
        length = audio_data.shape[-1]
        lcm = self.vq_strides[0]
        for s in self.vq_strides[1:]:
            lcm = abs(lcm * s) // math.gcd(lcm, s)
        if self.attn_window_size:
            lcm = abs(lcm * self.attn_window_size) // math.gcd(lcm, self.attn_window_size)
        pad_to = self.hop_length * lcm
        right_pad = math.ceil(length / pad_to) * pad_to - length
        return F.pad(audio_data, (0, right_pad))

    def _codes(self, codes) -> List[torch.Tensor]:
        return [torch.as_tensor(np.array(c) if not isinstance(c, torch.Tensor) else c,
                                device=self.device).long() for c in codes]

    @torch.inference_mode()
    def encode(self, audio_data) -> List[torch.Tensor]:
        """audio (B, 1, T) → one (B, T_i) index tensor a codebook."""
        x = torch.as_tensor(np.asarray(audio_data) if not isinstance(audio_data, torch.Tensor)
                            else audio_data, device=self.device)
        x = self.preprocess(x.to(self.encoder.block[0].weight.dtype))
        _, codes = self.quantizer(self.encoder(x.transpose(1, 2)))
        return codes

    @torch.inference_mode()
    def decode(self, codes, noise_fn: Optional[NoiseFn] = None) -> torch.Tensor:
        """A code list → audio (B, 1, T). `noise_fn(shape)` gives the noise
        blocks' Gaussian draws (default: a generator seeded 0, anew each
        call)."""
        z_q = self.quantizer.from_codes(self._codes(codes))
        audio = self.decoder(z_q, noise_fn or _default_noise(self.device))
        return audio.transpose(1, 2)

    def decode_stream(self, codes, prev_codes=None, context_frames: int = 8,
                      noise_fn: Optional[NoiseFn] = None):
        """Chunked streaming decode with code context for seam-free output:
        the last `context_frames` (per codebook, divided by its stride) of
        the previous codes decode again with the new chunk, and only the
        samples past the context come back → (new audio (B, 1, T_new), the
        new context codes)."""
        codes = self._codes(codes)
        new_context = [c[:, -context_frames:] if c.shape[1] > context_frames else c
                       for c in codes]
        if prev_codes is None:
            return self.decode(codes, noise_fn), new_context
        combined = []
        for i, (prev, new) in enumerate(zip(self._codes(prev_codes), codes)):
            layer_context = max(1, context_frames // self.vq_strides[i])
            if prev.shape[1] > layer_context:
                prev = prev[:, -layer_context:]
            combined.append(torch.cat([prev, new], dim=1))
        full = self.decode(combined, noise_fn)
        context_samples = context_frames * self.hop_length
        new_audio = full[..., context_samples:] if full.shape[-1] > context_samples else full
        return new_audio, new_context

    def forward(self, audio_data):
        length = audio_data.shape[-1]
        codes = self.encode(audio_data)
        return self.decode(codes)[..., :length], codes

    def sanitize(self, weights: dict) -> dict:
        """Checkpoint weights → the JAX package's layout: weight norm folded,
        convolutions oriented."""
        from ....nn.sanitize import orient_weights_to_model

        return orient_weights_to_model(self, fold_weight_norm_pairs(weights))

    @classmethod
    def from_pretrained(cls, path, device=None) -> "SNAC":
        """A codec from a local directory (config.json and weights); a hub id
        raises, since the port does not download."""
        from ....utils import get_model_path, load_weight_files

        path = get_model_path(path)
        cfg_file = Path(path) / "config.json"
        config = json.loads(cfg_file.read_text()) if cfg_file.exists() else {}
        model = cls(**config, device=device)
        weights = model.sanitize(load_weight_files(path))
        return load_weights(model, weights, strict=False).eval()
