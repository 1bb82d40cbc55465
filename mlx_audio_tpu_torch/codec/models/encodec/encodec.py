"""EnCodec, the SEANet convolution + LSTM codec with a residual vector
quantizer (counterpart of `mlx_audio_tpu/codec/models/encodec/encodec.py`).

The JAX package runs channels-last; here every layer runs channels-first
(B, C, T), PyTorch's own convolution layout, as the port's DAC does, so no
activation is transposed but around the LSTM. Parameter names and the
checkpoint layout are the JAX package's (`nn.module.load_weights` turns its
(O, K, I) conv kernels into PyTorch's); the LSTMs keep its `lstm.{i}.Wx`
names. `sanitize` takes a `transformers` `EncodecModel` checkpoint: weight
norm folded, the packed `lstm.weight_ih_l{i}` names mapped, the codebooks'
EMA buffers dropped.

The padding copies the JAX package's, including its emulation of a reflect
pad longer than the input (a reflect that runs on past the input's end, as
numpy's, on the left; zeros past the reflectable part on the right).
Encode is the argmin of float32 squared distances; decode gathers the
codebooks with the ids clamped as the JAX package's gather clamps them (a
code of 1024 decodes as the last bin). With `chunk_length_s` (the 48 kHz
model) audio is encoded in chunks, each scaled by its own RMS where
`normalize` is set, a tail shorter than a chunk dropped, and decoded with a
linear overlap-add crossfade.

The API is the JAX package's: `encode(audio (B, C, T), bandwidth=)` →
(codes (frames, B, n_q, T'), scales), `decode(codes, scales)` → audio
(B, C, T). A hub id in `from_pretrained` raises: the port does not download.
"""

from __future__ import annotations

import json
import math
import re
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ....base import BaseModelArgs
from ....device import resolve_device
from ....nn import GroupNorm as _GroupNorm
from ....nn import LSTM
from ....nn.layers import clamp_ids
from ....nn.module import init_weights, load_weights
from ..base import Conv1d, ConvTranspose1d, fold_weight_norm_pairs

__all__ = ["Encodec", "EncodecConfig"]


@dataclass
class EncodecConfig(BaseModelArgs):
    """`facebook/encodec_24khz`'s settings by default."""

    model_type: str = "encodec"
    audio_channels: int = 1
    num_filters: int = 32
    kernel_size: int = 7
    num_residual_layers: int = 1
    dilation_growth_rate: int = 2
    codebook_size: int = 1024
    codebook_dim: int = 128
    hidden_size: int = 128
    num_lstm_layers: int = 2
    residual_kernel_size: int = 3
    use_causal_conv: bool = True
    normalize: bool = False
    pad_mode: str = "reflect"
    norm_type: str = "weight_norm"
    last_kernel_size: int = 7
    trim_right_ratio: float = 1.0
    compress: int = 2
    upsampling_ratios: List[int] = None
    target_bandwidths: List[float] = None
    sampling_rate: int = 24000
    chunk_length_s: Optional[float] = None
    overlap: Optional[float] = None

    def __post_init__(self):
        if self.upsampling_ratios is None:
            self.upsampling_ratios = [8, 5, 4, 2]
        if self.target_bandwidths is None:
            self.target_bandwidths = [1.5, 3.0, 6.0, 12.0, 24.0]

    @property
    def chunk_length(self) -> Optional[int]:
        if self.chunk_length_s is None:
            return None
        return int(self.chunk_length_s * self.sampling_rate)

    @property
    def chunk_stride(self) -> Optional[int]:
        if self.chunk_length_s is None or self.overlap is None:
            return None
        return max(1, int((1.0 - self.overlap) * self.chunk_length))


class GroupNorm(_GroupNorm):
    """The port's GroupNorm over channels-first (B, C, T): float32
    statistics over every position and the group's channels."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.group_norm(x.float(), self.num_groups, self.weight.float(), self.bias.float(),
                            self.eps).to(x.dtype)


def _reflect_index(length: int, left: int, right: int) -> torch.Tensor:
    """Source positions of numpy's reflect pad of `length` samples by
    (left, right): the reflection repeats with period 2·(length − 1), so a
    pad longer than the input reflects on (what `jnp.pad` gives)."""
    i = np.arange(-left, length + right)
    if length == 1:
        return torch.zeros(len(i), dtype=torch.long)
    period = 2 * (length - 1)
    j = np.mod(i, period)
    return torch.from_numpy(np.where(j >= length, period - j, j))


class EncodecConv1d(nn.Module):
    """Conv1d with causal or asymmetric padding, channels-first."""

    def __init__(self, config: EncodecConfig, in_channels: int, out_channels: int,
                 kernel_size: int, stride: int = 1, dilation: int = 1, device=None):
        super().__init__()
        self.conv = Conv1d(in_channels, out_channels, kernel_size, stride=stride,
                           dilation=dilation, device=device)
        if config.norm_type == "time_group_norm":
            self.norm = GroupNorm(1, out_channels, device=device)
        self.causal = config.use_causal_conv
        self.pad_mode = config.pad_mode
        self.stride = stride
        self.kernel_size_eff = (kernel_size - 1) * dilation + 1
        self.padding_total = self.kernel_size_eff - stride

    def _extra_padding(self, length: int) -> int:
        n_frames = (length - self.kernel_size_eff + self.padding_total) / self.stride + 1
        n_frames = int(math.ceil(n_frames)) - 1
        ideal = n_frames * self.stride + self.kernel_size_eff - self.padding_total
        return ideal - length

    def _pad(self, x: torch.Tensor, left: int, right: int) -> torch.Tensor:
        if self.pad_mode == "reflect":
            # the JAX package's emulation: reflect as far as the input
            # allows on the right, zeros past that
            L = x.shape[-1]
            r = min(right, L - 1)
            x = x[..., _reflect_index(L, left, r).to(x.device)]
            return F.pad(x, (0, right - r)) if right > r else x
        return F.pad(x, (left, right))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        extra = self._extra_padding(x.shape[-1])
        if self.causal:
            x = self._pad(x, self.padding_total, extra)
        else:
            pr = self.padding_total // 2
            x = self._pad(x, self.padding_total - pr, pr + extra)
        x = self.conv(x)
        if hasattr(self, "norm"):
            x = self.norm(x)
        return x


class EncodecConvTranspose1d(nn.Module):
    """A transposed convolution trimmed back to stride × the input's length."""

    def __init__(self, config: EncodecConfig, in_channels: int, out_channels: int,
                 kernel_size: int, stride: int = 1, device=None):
        super().__init__()
        self.conv = ConvTranspose1d(in_channels, out_channels, kernel_size, stride=stride,
                                    device=device)
        if config.norm_type == "time_group_norm":
            self.norm = GroupNorm(1, out_channels, device=device)
        self.causal = config.use_causal_conv
        self.trim_right_ratio = config.trim_right_ratio
        self.padding_total = kernel_size - stride

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        if hasattr(self, "norm"):
            x = self.norm(x)
        pr = (math.ceil(self.padding_total * self.trim_right_ratio) if self.causal
              else self.padding_total // 2)
        pl = self.padding_total - pr
        return x[..., pl: x.shape[-1] - pr]


class EncodecLSTM(nn.Module):
    """Stacked LSTMs over time with a residual, (B, C, T) → (B, C, T)."""

    def __init__(self, config: EncodecConfig, dimension: int, device=None):
        super().__init__()
        self.lstm = nn.ModuleList(LSTM(dimension, dimension, device=device)
                                  for _ in range(config.num_lstm_layers))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x.transpose(1, 2)
        for lstm in self.lstm:
            h, _ = lstm(h)
        return h.transpose(1, 2) + x


class EncodecResnetBlock(nn.Module):
    def __init__(self, config: EncodecConfig, dim: int, dilations, device=None):
        super().__init__()
        kernel_sizes = (config.residual_kernel_size, 1)
        hidden = dim // config.compress
        block = []
        for i, (k, d) in enumerate(zip(kernel_sizes, dilations)):
            in_chs = dim if i == 0 else hidden
            out_chs = dim if i == len(kernel_sizes) - 1 else hidden
            block += [nn.ELU(), EncodecConv1d(config, in_chs, out_chs, k, dilation=d,
                                              device=device)]
        self.block = nn.ModuleList(block)
        self.shortcut = EncodecConv1d(config, dim, dim, 1, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x
        for layer in self.block:
            x = layer(x)
        return self.shortcut(residual) + x


class EncodecEncoder(nn.Module):
    def __init__(self, config: EncodecConfig, device=None):
        super().__init__()
        model = [EncodecConv1d(config, config.audio_channels, config.num_filters,
                               config.kernel_size, device=device)]
        scaling = 1
        for ratio in reversed(config.upsampling_ratios):
            current = scaling * config.num_filters
            for j in range(config.num_residual_layers):
                model.append(EncodecResnetBlock(config, current,
                                                [config.dilation_growth_rate ** j, 1],
                                                device=device))
            model += [nn.ELU(), EncodecConv1d(config, current, current * 2, ratio * 2,
                                              stride=ratio, device=device)]
            scaling *= 2
        model += [EncodecLSTM(config, scaling * config.num_filters, device=device), nn.ELU(),
                  EncodecConv1d(config, scaling * config.num_filters, config.hidden_size,
                                config.last_kernel_size, device=device)]
        self.layers = nn.ModuleList(model)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x)
        return x


class EncodecDecoder(nn.Module):
    def __init__(self, config: EncodecConfig, device=None):
        super().__init__()
        scaling = int(2 ** len(config.upsampling_ratios))
        model = [EncodecConv1d(config, config.hidden_size, scaling * config.num_filters,
                               config.kernel_size, device=device),
                 EncodecLSTM(config, scaling * config.num_filters, device=device)]
        for ratio in config.upsampling_ratios:
            current = scaling * config.num_filters
            model += [nn.ELU(), EncodecConvTranspose1d(config, current, current // 2, ratio * 2,
                                                       stride=ratio, device=device)]
            for j in range(config.num_residual_layers):
                model.append(EncodecResnetBlock(config, current // 2,
                                                (config.dilation_growth_rate ** j, 1),
                                                device=device))
            scaling //= 2
        model += [nn.ELU(), EncodecConv1d(config, config.num_filters, config.audio_channels,
                                          config.last_kernel_size, device=device)]
        self.layers = nn.ModuleList(model)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x)
        return x


class EncodecEuclideanCodebook(nn.Module):
    def __init__(self, config: EncodecConfig, device=None):
        super().__init__()
        self.embed = nn.Parameter(torch.empty(config.codebook_size, config.codebook_dim,
                                              device=device))

    def reset_parameters(self, generator=None) -> None:
        self.embed.data.zero_()  # the JAX package starts the codebooks at zero

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """(B, D, T) → the nearest code a frame (B, T) by float32 squared
        distance (ties to the first index, as `jnp.argmin`)."""
        flat = x.transpose(1, 2).float()  # (B, T, D)
        embed = self.embed.float()
        dist = ((flat ** 2).sum(-1, keepdim=True) - 2 * flat @ embed.T
                + (embed ** 2).sum(-1)[None, None, :])
        return torch.argmin(dist, dim=-1)

    def decode(self, ind: torch.Tensor) -> torch.Tensor:
        """Codes (B, T) → (B, D, T); a code past the codebook takes the last
        row, as the JAX package's gather clamps it."""
        return self.embed[clamp_ids(ind, self.embed.shape[0])].transpose(1, 2)


class EncodecVectorQuantization(nn.Module):
    def __init__(self, config: EncodecConfig, device=None):
        super().__init__()
        self.codebook = EncodecEuclideanCodebook(config, device=device)

    def encode(self, x):
        return self.codebook.encode(x)

    def decode(self, ind):
        return self.codebook.decode(ind)


class EncodecResidualVectorQuantizer(nn.Module):
    def __init__(self, config: EncodecConfig, device=None):
        super().__init__()
        self.codebook_size = config.codebook_size
        hop_length = int(np.prod(config.upsampling_ratios))
        self.frame_rate = math.ceil(config.sampling_rate / hop_length)
        nbits = math.ceil(math.log2(config.codebook_size))
        self.num_quantizers = max(
            1, int(1000 * config.target_bandwidths[-1] // (self.frame_rate * nbits)))
        self.layers = nn.ModuleList(EncodecVectorQuantization(config, device=device)
                                    for _ in range(self.num_quantizers))

    def get_num_quantizers_for_bandwidth(self, bandwidth: Optional[float] = None) -> int:
        bw_per_q = math.log2(self.codebook_size) * self.frame_rate
        if bandwidth is not None and bandwidth > 0.0:
            return int(max(1, math.floor(bandwidth * 1000 / bw_per_q)))
        return self.num_quantizers

    def encode(self, embeddings: torch.Tensor, bandwidth=None, nq: Optional[int] = None):
        """(B, D, T) → codes (B, nq, T)."""
        if nq is None:
            nq = self.get_num_quantizers_for_bandwidth(bandwidth)
        residual = embeddings
        out = []
        for layer in self.layers[:nq]:
            idx = layer.encode(residual)
            residual = residual - layer.decode(idx).to(residual.dtype)
            out.append(idx)
        return torch.stack(out, dim=1)

    def decode(self, codes: torch.Tensor) -> torch.Tensor:
        """codes (B, nq, T) → (B, D, T)."""
        q = None
        for i in range(codes.shape[1]):
            dec = self.layers[i].decode(codes[:, i])
            q = dec if q is None else q + dec
        return q


class Encodec(nn.Module):
    """The codec on an explicit device (None: the card), weights drawn from
    `seed` (the codebooks at zero, as in the JAX package), in float32."""

    def __init__(self, config: Union[EncodecConfig, dict], device=None, seed: int = 0):
        super().__init__()
        if isinstance(config, dict):
            config = EncodecConfig.from_dict(config)
        self.config = config
        self.device = resolve_device(device)
        self.encoder = EncodecEncoder(config, device=self.device)
        self.decoder = EncodecDecoder(config, device=self.device)
        self.quantizer = EncodecResidualVectorQuantizer(config, device=self.device)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        init_weights(self, gen)

    @property
    def chunk_length(self) -> Optional[int]:
        return self.config.chunk_length

    @property
    def chunk_stride(self) -> Optional[int]:
        return self.config.chunk_stride

    @property
    def sample_rate(self) -> int:
        return self.config.sampling_rate

    def _tensor(self, x, dtype=None) -> torch.Tensor:
        if not isinstance(x, torch.Tensor):
            x = torch.as_tensor(np.asarray(x))
        return x.to(self.device, dtype) if dtype is not None else x.to(self.device)

    def _encode_frame(self, audio: torch.Tensor, nq: int):
        scale = None
        if self.config.normalize:
            mono = audio.mean(dim=1, keepdim=True)
            scale = torch.sqrt((mono ** 2).mean(dim=2, keepdim=True)) + 1e-8
            audio = audio / scale
        codes = self.quantizer.encode(self.encoder(audio), nq=nq)
        return codes, scale

    def _decode_frame(self, codes: torch.Tensor, scale=None) -> torch.Tensor:
        dtype = self.decoder.layers[0].conv.weight.dtype
        audio = self.decoder(self.quantizer.decode(codes).to(dtype))
        if scale is not None:
            audio = audio * self._tensor(scale, audio.dtype)
        return audio

    @torch.inference_mode()
    def encode(self, input_values, padding_mask=None, bandwidth=None):
        """input_values (B, C, T) → (codes (n_frames, B, nq, T'), scales):
        one frame without `chunk_length_s`, else one a whole chunk."""
        dtype = self.encoder.layers[0].conv.weight.dtype
        x = self._tensor(input_values, dtype)
        nq = self.quantizer.get_num_quantizers_for_bandwidth(bandwidth)
        chunk = self.chunk_length
        if chunk is None:
            codes, scale = self._encode_frame(x, nq)
            return codes[None], [scale]
        stride = self.chunk_stride
        frames, scales = [], []
        for start in range(0, x.shape[-1] - chunk + 1, stride):
            c, s = self._encode_frame(x[..., start: start + chunk], nq)
            frames.append(c)
            scales.append(s)
        return torch.stack(frames), scales

    @torch.inference_mode()
    def decode(self, audio_codes, audio_scales=None, padding_mask=None) -> torch.Tensor:
        """audio_codes (n_frames, B, nq, T') → audio (B, C, T)."""
        audio_codes = self._tensor(audio_codes).long()
        if audio_scales is None:
            audio_scales = [None] * audio_codes.shape[0]
        segments = [self._decode_frame(audio_codes[i], audio_scales[i])
                    for i in range(audio_codes.shape[0])]
        if len(segments) == 1:
            return segments[0]
        # overlap-add with a linear crossfade between chunks
        stride = self.chunk_stride
        B, C, L0 = segments[0].shape
        total = stride * (len(segments) - 1) + L0
        out = segments[0].new_zeros(B, C, total)
        wsum = segments[0].new_zeros(total)
        for i, seg in enumerate(segments):
            L = seg.shape[-1]
            w = torch.linspace(0, 1, L // 2 + 1, device=seg.device, dtype=seg.dtype)[1:]
            weight = torch.cat([w, w.flip(0)])[:L]
            out[..., i * stride: i * stride + L] += seg * weight
            wsum[i * stride: i * stride + L] += weight
        return out / wsum.clamp(min=1e-8)

    def forward(self, input_values, padding_mask=None, bandwidth=None):
        codes, scales = self.encode(input_values, padding_mask, bandwidth)
        return self.decode(codes, scales, padding_mask)

    # ---- loading ----

    def sanitize(self, weights: dict) -> dict:
        """A checkpoint (`transformers` names, weight norm) → the JAX
        package's layout."""
        from ....nn.sanitize import orient_weights_to_model

        weights = fold_weight_norm_pairs(weights)
        # HF packs the LSTM layers into one torch LSTM:
        # <prefix>.lstm.weight_ih_l{i} → <prefix>.lstm.{i}.Wx, and so on
        lstm_map = {"weight_ih": "Wx", "weight_hh": "Wh", "bias_ih": "bias_ih",
                    "bias_hh": "bias_hh"}
        lstm_re = re.compile(r"\.lstm\.(weight_ih|weight_hh|bias_ih|bias_hh)_l(\d+)$")
        out = {}
        for k, v in weights.items():
            if k.endswith((".inited", ".cluster_size", ".embed_avg")):
                continue  # the codebooks' EMA training buffers
            m = lstm_re.search(k)
            out[f"{k[: m.start()]}.lstm.{m.group(2)}.{lstm_map[m.group(1)]}" if m else k] = v
        return orient_weights_to_model(self, out)

    @classmethod
    def from_pretrained(cls, path, device=None) -> "Encodec":
        """A codec from a local directory (config.json and weights); a hub
        id raises, since the port does not download."""
        from ....utils import get_model_path, load_weight_files

        path = get_model_path(path)
        config = json.loads((Path(path) / "config.json").read_text())
        model = cls(config, device=device)
        weights = model.sanitize(load_weight_files(path))
        return load_weights(model, weights, strict=False).eval()
