"""BigVGAN: the anti-aliased Snake vocoder, mel → waveform (counterpart of
`mlx_audio_tpu/codec/models/bigvgan/bigvgan.py`).

The public boundary is the JAX package's channels-last (B, T, C); inside,
the generator runs channels-first (B, C, T), as the port's DAC and EnCodec
do, so every convolution takes PyTorch's own layout with no transposes.
The kaiser-sinc anti-aliasing filters are constants built on the host
(the port's own numpy copy of `_kaiser_sinc_filter1d`), held as
non-persistent buffers: no checkpoint carries them and `sanitize` drops
them. `UpSample1d` is a replicate pad, a depthwise transposed convolution
(the JAX package's lhs-dilated convolution), a gain of `ratio` and a crop;
`LowPassFilter1d` a replicate pad and a strided depthwise convolution.
Weight-norm pairs fold into plain weights at load time.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Literal, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ....device import resolve_device
from ....nn.module import init_weights
from ..base import Conv1d, ConvTranspose1d, fold_weight_norm_pairs

__all__ = ["BigVGAN", "BigVGANConfig", "Snake", "SnakeBeta", "Activation1d", "AMPBlock1",
           "AMPBlock2"]


@dataclass
class BigVGANConfig:
    num_mels: int = 80
    upsample_rates: List[int] = field(default_factory=lambda: [4, 4, 2, 2, 2, 2])
    upsample_kernel_sizes: List[int] = field(default_factory=lambda: [8, 8, 4, 4, 4, 4])
    upsample_initial_channel: int = 1536
    resblock: Literal["1", "2"] = "1"
    resblock_kernel_sizes: List[int] = field(default_factory=lambda: [3, 7, 11])
    resblock_dilation_sizes: List[List[int]] = field(
        default_factory=lambda: [[1, 3, 5]] * 3)
    activation: Literal["snakebeta", "snake"] = "snakebeta"
    snake_logscale: bool = True
    use_bias_at_final: bool = True
    use_tanh_at_final: bool = True
    sample_rate: int = 22050

    @classmethod
    def from_dict(cls, d: dict) -> "BigVGANConfig":
        return cls(**{k: v for k, v in d.items() if k in cls.__dataclass_fields__})


def _kaiser_sinc_filter1d(cutoff: float, half_width: float, kernel_size: int) -> np.ndarray:
    """(1, 1, kernel_size) float32 lowpass (the JAX package's filter, in
    PyTorch's depthwise layout)."""
    even = kernel_size % 2 == 0
    half_size = kernel_size // 2
    delta_f = 4 * half_width
    A = 2.285 * (half_size - 1) * math.pi * delta_f + 7.95
    if A > 50.0:
        beta = 0.1102 * (A - 8.7)
    elif A >= 21.0:
        beta = 0.5842 * (A - 21) ** 0.4 + 0.07886 * (A - 21.0)
    else:
        beta = 0.0
    window = np.kaiser(kernel_size, beta)
    if even:
        time = np.arange(-half_size, half_size) + 0.5
    else:
        time = np.arange(kernel_size) - half_size
    if cutoff == 0:
        filt = np.zeros_like(time)
    else:
        filt = 2 * cutoff * window * np.sinc(2 * cutoff * time)
        filt /= filt.sum()
    return filt.reshape(1, 1, kernel_size).astype(np.float32)


class Snake(nn.Module):
    """x + (1/α) sin²(αx) over channels-first (B, C, T); α is stored as
    log α under `alpha_logscale`."""

    def __init__(self, in_features: int, alpha: float = 1.0, alpha_logscale: bool = False,
                 device=None):
        super().__init__()
        self.alpha_logscale = alpha_logscale
        self.alpha_init = alpha
        self.alpha = nn.Parameter(torch.empty(in_features, device=device))

    def reset_parameters(self, generator=None) -> None:
        self.alpha.data.fill_(0.0 if self.alpha_logscale else self.alpha_init)

    def forward(self, x):
        alpha = self.alpha[None, :, None]
        if self.alpha_logscale:
            alpha = torch.exp(alpha)
        return x + (1.0 / (alpha + 1e-9)) * torch.sin(x * alpha) ** 2


class SnakeBeta(nn.Module):
    """x + (1/β) sin²(αx): a separate magnitude β."""

    def __init__(self, in_features: int, alpha: float = 1.0, alpha_logscale: bool = False,
                 device=None):
        super().__init__()
        self.alpha_logscale = alpha_logscale
        self.alpha_init = alpha
        self.alpha = nn.Parameter(torch.empty(in_features, device=device))
        self.beta = nn.Parameter(torch.empty(in_features, device=device))

    def reset_parameters(self, generator=None) -> None:
        init = 0.0 if self.alpha_logscale else self.alpha_init
        self.alpha.data.fill_(init)
        self.beta.data.fill_(init)

    def forward(self, x):
        alpha = self.alpha[None, :, None]
        beta = self.beta[None, :, None]
        if self.alpha_logscale:
            alpha = torch.exp(alpha)
            beta = torch.exp(beta)
        return x + (1.0 / (beta + 1e-9)) * torch.sin(x * alpha) ** 2


class UpSample1d(nn.Module):
    """Kaiser-sinc upsampling by `ratio` over (B, C, T)."""

    def __init__(self, ratio: int = 2, kernel_size: Optional[int] = None, device=None):
        super().__init__()
        self.ratio = ratio
        self.kernel_size = int(6 * ratio // 2) * 2 if kernel_size is None else kernel_size
        self.pad = self.kernel_size // ratio - 1
        self.pad_left = self.pad * ratio + (self.kernel_size - ratio) // 2
        self.pad_right = self.pad * ratio + (self.kernel_size - ratio + 1) // 2
        filt = _kaiser_sinc_filter1d(0.5 / ratio, 0.6 / ratio, self.kernel_size)
        # conv_transpose1d correlates with the flipped filter: flipping it here
        # gives the JAX package's lhs-dilated correlation exactly
        self.register_buffer("filter", torch.from_numpy(filt[..., ::-1].copy()).to(device),
                             persistent=False)

    def forward(self, x):
        C = x.shape[1]
        x = F.pad(x, (self.pad, self.pad), mode="replicate")
        w = self.filter.to(x.dtype).expand(C, 1, self.kernel_size)
        y = self.ratio * F.conv_transpose1d(x, w, stride=self.ratio, groups=C)
        return y[..., self.pad_left: y.shape[-1] - self.pad_right]


class LowPassFilter1d(nn.Module):
    def __init__(self, cutoff: float, half_width: float, stride: int = 1,
                 kernel_size: int = 12, device=None):
        super().__init__()
        even = kernel_size % 2 == 0
        self.stride = stride
        self.kernel_size = kernel_size
        self.pad_left = kernel_size // 2 - int(even)
        self.pad_right = kernel_size // 2
        self.register_buffer(
            "filter", torch.from_numpy(_kaiser_sinc_filter1d(cutoff, half_width,
                                                             kernel_size)).to(device),
            persistent=False)

    def forward(self, x):
        C = x.shape[1]
        x = F.pad(x, (self.pad_left, self.pad_right), mode="replicate")
        w = self.filter.to(x.dtype).expand(C, 1, self.kernel_size)
        return F.conv1d(x, w, stride=self.stride, groups=C)


class DownSample1d(nn.Module):
    def __init__(self, ratio: int = 2, kernel_size: Optional[int] = None, device=None):
        super().__init__()
        ks = int(6 * ratio // 2) * 2 if kernel_size is None else kernel_size
        self.lowpass = LowPassFilter1d(0.5 / ratio, 0.6 / ratio, stride=ratio, kernel_size=ks,
                                       device=device)

    def forward(self, x):
        return self.lowpass(x)


class Activation1d(nn.Module):
    """Anti-aliased activation: upsample, activate, downsample."""

    def __init__(self, activation: nn.Module, up_ratio: int = 2, down_ratio: int = 2,
                 up_kernel_size: int = 12, down_kernel_size: int = 12, device=None):
        super().__init__()
        self.act = activation
        self.upsample = UpSample1d(up_ratio, up_kernel_size, device=device)
        self.downsample = DownSample1d(down_ratio, down_kernel_size, device=device)

    def forward(self, x):
        return self.downsample(self.act(self.upsample(x)))


def _make_act(channels: int, kind: str, logscale: bool, device=None) -> Activation1d:
    cls = Snake if kind == "snake" else SnakeBeta
    return Activation1d(cls(channels, alpha_logscale=logscale, device=device), device=device)


class AMPBlock1(nn.Module):
    def __init__(self, channels: int, snake_logscale: bool, activation: str,
                 kernel_size: int = 3, dilation: Optional[List[int]] = None, device=None):
        super().__init__()
        dilation = dilation or [1, 3, 5]
        self.convs1 = nn.ModuleList(
            Conv1d(channels, channels, kernel_size, dilation=d,
                   padding=((kernel_size - 1) * d) // 2, device=device) for d in dilation)
        self.convs2 = nn.ModuleList(
            Conv1d(channels, channels, kernel_size, padding=(kernel_size - 1) // 2,
                   device=device) for _ in dilation)
        self.activations = nn.ModuleList(
            _make_act(channels, activation, snake_logscale, device)
            for _ in range(len(dilation) * 2))

    def forward(self, x):
        for c1, c2, a1, a2 in zip(self.convs1, self.convs2, self.activations[::2],
                                  self.activations[1::2]):
            x = x + c2(a2(c1(a1(x))))
        return x


class AMPBlock2(nn.Module):
    def __init__(self, channels: int, snake_logscale: bool, activation: str,
                 kernel_size: int = 3, dilation: Optional[List[int]] = None, device=None):
        super().__init__()
        dilation = dilation or [1, 3, 5]
        self.convs = nn.ModuleList(
            Conv1d(channels, channels, kernel_size, dilation=d,
                   padding=((kernel_size - 1) * d) // 2, device=device) for d in dilation)
        self.activations = nn.ModuleList(
            _make_act(channels, activation, snake_logscale, device) for _ in dilation)

    def forward(self, x):
        for conv, act in zip(self.convs, self.activations):
            x = x + conv(act(x))
        return x


class BigVGAN(nn.Module):
    """Mel (B, T, num_mels) → waveform (B, T', 1), on `device` (None: the
    card), the weights drawn from `seed`."""

    def __init__(self, config, device=None, seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self._build(config, device)
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        init_weights(self, gen)

    def _build(self, config, device) -> None:
        if isinstance(config, dict):
            config = BigVGANConfig.from_dict(config)
        self.config = config
        self.num_kernels = len(config.resblock_kernel_sizes)
        self.num_upsamples = len(config.upsample_rates)
        self.use_tanh_at_final = config.use_tanh_at_final
        C0 = config.upsample_initial_channel
        self.conv_pre = Conv1d(config.num_mels, C0, 7, padding=3, device=device)
        self.ups = nn.ModuleList(
            nn.ModuleList([ConvTranspose1d(C0 // (2 ** i), C0 // (2 ** (i + 1)), k, stride=u,
                                           padding=(k - u) // 2, device=device)])
            for i, (u, k) in enumerate(zip(config.upsample_rates,
                                           config.upsample_kernel_sizes)))
        block = AMPBlock1 if config.resblock == "1" else AMPBlock2
        self.resblocks = nn.ModuleList(
            block(C0 // (2 ** (i + 1)), config.snake_logscale, config.activation, k, list(d),
                  device=device)
            for i in range(self.num_upsamples)
            for k, d in zip(config.resblock_kernel_sizes, config.resblock_dilation_sizes))
        last = C0 // (2 ** self.num_upsamples)
        self.activation_post = _make_act(last, config.activation, config.snake_logscale,
                                         device)
        self.conv_post = Conv1d(last, 1, 7, padding=3, bias=config.use_bias_at_final,
                                device=device)

    @property
    def device(self) -> torch.device:
        return self.conv_pre.weight.device

    def _upsample_stages(self, x, cond=None):
        """The upsampling stages over channels-first x; `cond(step)` adds a
        per-stage condition after each upsample."""
        for step in range(self.num_upsamples):
            for up in self.ups[step]:
                x = up(x)
            if cond is not None:
                x = x + cond(step)
            xs = self.resblocks[step * self.num_kernels](x)
            for idx in range(1, self.num_kernels):
                xs = xs + self.resblocks[step * self.num_kernels + idx](x)
            x = xs / self.num_kernels
        x = self.conv_post(self.activation_post(x))
        return torch.tanh(x) if self.use_tanh_at_final else x.clamp(-1.0, 1.0)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        x = self.conv_pre(mel.transpose(1, 2))
        return self._upsample_stages(x).transpose(1, 2)

    def decode(self, mel: torch.Tensor) -> torch.Tensor:
        return self(mel)

    def sanitize(self, weights: dict) -> dict:
        """Drop the anti-aliasing filters and BatchNorm counters, fold
        weight-norm pairs, orient convolutions to the JAX layout."""
        from ....nn.sanitize import orient_weights_to_model

        out = {k: v for k, v in weights.items()
               if not ("num_batches_tracked" in k or "filter" in k or ".upsample." in k
                       or ".downsample." in k or ".lowpass." in k)}
        return orient_weights_to_model(self, fold_weight_norm_pairs(out))
