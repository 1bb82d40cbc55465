"""HiFT-Net, the HiFi-GAN generator with a neural source filter and an
ISTFT head, of S3Gen and CosyVoice2 (counterpart of
`mlx_audio_tpu/codec/models/s3gen/hifigan.py`).

Channels-last throughout; the n_fft = 16 STFT and ISTFT run on the port's
`dsp.stft` / `dsp.istft`. The source's harmonic phases and noise are drawn
from a `torch.Generator` (the JAX package's from a PRNG key), so they match
in distribution only; `draws` passes a draw in (`SineGen.draws`' layout).
The source and the ISTFT head run in float32 whatever the stack's dtype."""

from __future__ import annotations

import math
from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ....dsp import istft as dsp_istft
from ....dsp import stft as dsp_stft
from ....nn import Conv1d, ConvTranspose1d, Linear

__all__ = ["HiFTGenerator", "ConvRNNF0Predictor", "SineGen", "SourceModuleHnNSF", "Snake",
           "ResBlock"]


def get_padding(kernel_size: int, dilation: int = 1) -> int:
    return (kernel_size * dilation - dilation) // 2


def _hann_periodic(size: int) -> torch.Tensor:
    n = torch.arange(size, dtype=torch.float32)
    return 0.5 - 0.5 * torch.cos(2.0 * math.pi * n / size)


def _linear_interp_to(x: torch.Tensor, new_size: int) -> torch.Tensor:
    """Linear resample along the last axis."""
    T = x.shape[-1]
    if new_size == T:
        return x
    pos = torch.linspace(0.0, T - 1, new_size, device=x.device)
    lo = torch.floor(pos).long()
    hi = (lo + 1).clamp(max=T - 1)
    w = pos - lo
    return x[..., lo] * (1 - w) + x[..., hi] * w


class Snake(nn.Module):
    """x + (1/α)·sin²(αx), α per channel, its magnitude kept off zero;
    x (B, T, C)."""

    def __init__(self, in_features: int, alpha: float = 1.0, alpha_logscale: bool = False,
                 device=None):
        super().__init__()
        self.alpha_logscale = alpha_logscale
        self.alpha_init = alpha
        self.alpha = nn.Parameter(torch.empty(in_features, device=device))

    def reset_parameters(self, generator=None) -> None:
        self.alpha.data.fill_(0.0 if self.alpha_logscale else self.alpha_init)

    def forward(self, x):
        alpha = self.alpha[None, None, :].to(x.dtype)
        if self.alpha_logscale:
            alpha = torch.exp(alpha)
        safe = torch.where(alpha >= 0, 1.0, -1.0) * alpha.abs().clamp(min=1e-4)
        return x + (1.0 / safe) * torch.sin(x * alpha) ** 2


class ResBlock(nn.Module):
    """The dilated residual block with Snake activations; (B, T, C)."""

    def __init__(self, channels: int = 512, kernel_size: int = 3,
                 dilations: Optional[List[int]] = None, device=None):
        super().__init__()
        dilations = dilations or [1, 3, 5]
        self.convs1 = nn.ModuleList(
            Conv1d(channels, channels, kernel_size, dilation=d,
                   padding=get_padding(kernel_size, d), device=device) for d in dilations)
        self.convs2 = nn.ModuleList(
            Conv1d(channels, channels, kernel_size, padding=get_padding(kernel_size, 1),
                   device=device) for _ in dilations)
        self.activations1 = nn.ModuleList(Snake(channels, device=device) for _ in dilations)
        self.activations2 = nn.ModuleList(Snake(channels, device=device) for _ in dilations)

    def forward(self, x):
        for c1, c2, a1, a2 in zip(self.convs1, self.convs2, self.activations1,
                                  self.activations2):
            x = x + c2(a2(c1(a1(x))))
        return x


class SineGen(nn.Module):
    """The harmonic sine source: f0 (B, 1, T) in Hz → (sines (B, T, H+1),
    voiced (B, T, 1))."""

    def __init__(self, samp_rate: int, harmonic_num: int = 0, sine_amp: float = 0.1,
                 noise_std: float = 0.003, voiced_threshold: float = 0.0,
                 use_interpolation: bool = False, upsample_scale: int = 1):
        super().__init__()
        self.sine_amp = sine_amp
        self.noise_std = noise_std
        self.harmonic_num = harmonic_num
        self.sampling_rate = samp_rate
        self.voiced_threshold = voiced_threshold
        self.use_interpolation = use_interpolation
        self.upsample_scale = upsample_scale

    def draws(self, B: int, T: int, device, generator: Optional[torch.Generator] = None):
        """The random part of a call: (initial phases, noise (B, T, H+1)). The
        phases are (B, H+1, 1) uniform in [-π, π), or (B, H+1) uniform in
        [0, 1) with the interpolating source; the fundamental's is 0."""
        H = self.harmonic_num + 1
        if self.use_interpolation:
            phase = torch.rand(B, H, generator=generator, device=device)
            phase[:, 0] = 0.0
        else:
            phase = torch.rand(B, H, 1, generator=generator, device=device) * (2 * math.pi) - math.pi
            phase[:, 0] = 0.0
        return phase, torch.randn(B, T, H, generator=generator, device=device)

    def forward(self, f0: torch.Tensor, generator: Optional[torch.Generator] = None,
                draws=None):
        B, _, T = f0.shape
        H = self.harmonic_num + 1
        phase_init, noise = draws if draws is not None else self.draws(B, T, f0.device,
                                                                        generator)
        harmonics = torch.arange(1, H + 1, dtype=f0.dtype, device=f0.device)
        if self.use_interpolation:
            # the phase at frame rate, then upsampled (the 24 kHz variant)
            fn = f0[:, 0, :, None] * harmonics[None, None, :]  # (B, T, H)
            rad = torch.remainder(fn / self.sampling_rate, 1.0)
            rad[:, 0, :] = rad[:, 0, :] + phase_init.to(rad.dtype)
            rad_down = _linear_interp_to(rad.transpose(1, 2), max(1, T // self.upsample_scale))
            phase = torch.cumsum(rad_down, dim=-1) * 2.0 * math.pi
            phase = _linear_interp_to(phase * self.upsample_scale, T)
            sines = torch.sin(phase).transpose(1, 2) * self.sine_amp
        else:
            f_mat = f0 * harmonics[None, :, None] / self.sampling_rate
            theta = 2.0 * math.pi * torch.remainder(torch.cumsum(f_mat, dim=-1), 1.0)
            sines = (self.sine_amp * torch.sin(theta + phase_init.to(f0.dtype))).transpose(1, 2)
        uv = (f0 > self.voiced_threshold).to(f0.dtype).transpose(1, 2)  # (B, T, 1)
        noise_amp = uv * self.noise_std + (1 - uv) * self.sine_amp / 3
        return sines * uv + noise_amp * noise.to(sines.dtype), uv


class SourceModuleHnNSF(nn.Module):
    """The harmonics merged into one excitation."""

    def __init__(self, sampling_rate: int, upsample_scale: int, harmonic_num: int = 0,
                 sine_amp: float = 0.1, add_noise_std: float = 0.003,
                 voiced_threshod: float = 0.0, use_interpolation: bool = False, device=None):
        super().__init__()
        self.l_sin_gen = SineGen(sampling_rate, harmonic_num, sine_amp, add_noise_std,
                                 voiced_threshod, use_interpolation, upsample_scale)
        self.l_linear = Linear(harmonic_num + 1, 1, device=device)

    def forward(self, f0_up: torch.Tensor, generator=None, draws=None) -> torch.Tensor:
        """f0_up (B, T, 1) → source (B, T, 1)."""
        sines, _ = self.l_sin_gen(f0_up.transpose(1, 2), generator, draws)
        return torch.tanh(self.l_linear(sines))


class ConvRNNF0Predictor(nn.Module):
    """The convolutional F0 predictor: (B, T, n_mels) → f0 (B, T)."""

    def __init__(self, num_class: int = 1, in_channels: int = 80, cond_channels: int = 512,
                 device=None):
        super().__init__()
        self.condnet = nn.ModuleList(
            Conv1d(in_channels if i == 0 else cond_channels, cond_channels, 3, padding=1,
                   device=device) for i in range(5))
        self.classifier = Linear(cond_channels, num_class, device=device)

    def forward(self, x):
        for conv in self.condnet:
            x = F.elu(conv(x))
        return self.classifier(x)[..., 0].abs()


class HiFTGenerator(nn.Module):
    """HiFT-Net: mel (B, T, 80) → waveform (B, T·scale)."""

    def __init__(self, in_channels: int = 80, base_channels: int = 512, nb_harmonics: int = 8,
                 sampling_rate: int = 22050, nsf_alpha: float = 0.1, nsf_sigma: float = 0.003,
                 nsf_voiced_threshold: float = 10.0, upsample_rates: Optional[List[int]] = None,
                 upsample_kernel_sizes: Optional[List[int]] = None,
                 istft_params: Optional[dict] = None,
                 resblock_kernel_sizes: Optional[List[int]] = None,
                 resblock_dilation_sizes: Optional[List[List[int]]] = None,
                 source_resblock_kernel_sizes: Optional[List[int]] = None,
                 source_resblock_dilation_sizes: Optional[List[List[int]]] = None,
                 lrelu_slope: float = 0.1, audio_limit: float = 0.99,
                 f0_predictor: Optional[nn.Module] = None, use_interpolation: bool = False,
                 device=None):
        super().__init__()
        upsample_rates = upsample_rates or [8, 8]
        upsample_kernel_sizes = upsample_kernel_sizes or [16, 16]
        istft_params = istft_params or {"n_fft": 16, "hop_len": 4}
        resblock_kernel_sizes = resblock_kernel_sizes or [3, 7, 11]
        resblock_dilation_sizes = resblock_dilation_sizes or [[1, 3, 5]] * 3
        source_resblock_kernel_sizes = source_resblock_kernel_sizes or [7, 11]
        source_resblock_dilation_sizes = source_resblock_dilation_sizes or [[1, 3, 5]] * 2
        dev = device

        self.sampling_rate = sampling_rate
        self.istft_params = dict(istft_params)
        self.lrelu_slope = lrelu_slope
        self.audio_limit = audio_limit
        self.num_kernels = len(resblock_kernel_sizes)
        self.num_upsamples = len(upsample_rates)
        n_fft = istft_params["n_fft"]

        self.f0_upsample_scale = math.prod(upsample_rates) * istft_params["hop_len"]
        self.m_source = SourceModuleHnNSF(
            sampling_rate=sampling_rate, upsample_scale=self.f0_upsample_scale,
            harmonic_num=nb_harmonics, sine_amp=nsf_alpha, add_noise_std=nsf_sigma,
            voiced_threshod=nsf_voiced_threshold, use_interpolation=use_interpolation,
            device=dev)
        self.conv_pre = Conv1d(in_channels, base_channels, 7, padding=3, device=dev)
        self.ups = nn.ModuleList(
            ConvTranspose1d(base_channels // (2 ** i), base_channels // (2 ** (i + 1)), k,
                            stride=u, padding=(k - u) // 2, device=dev)
            for i, (u, k) in enumerate(zip(upsample_rates, upsample_kernel_sizes)))

        self.source_downs = nn.ModuleList()
        self.source_resblocks = nn.ModuleList()
        cum, p = [], 1
        for r in [1] + upsample_rates[::-1][:-1]:
            p *= r
            cum.append(p)
        for i, (u, k, d) in enumerate(zip(cum[::-1], source_resblock_kernel_sizes,
                                          source_resblock_dilation_sizes)):
            ch = base_channels // (2 ** (i + 1))
            self.source_downs.append(
                Conv1d(n_fft + 2, ch, 1, device=dev) if u == 1
                else Conv1d(n_fft + 2, ch, u * 2, stride=u, padding=u // 2, device=dev))
            self.source_resblocks.append(ResBlock(ch, k, d, device=dev))

        self.resblocks = nn.ModuleList(
            ResBlock(base_channels // (2 ** (i + 1)), k, d, device=dev)
            for i in range(len(self.ups))
            for k, d in zip(resblock_kernel_sizes, resblock_dilation_sizes))
        ch = base_channels // (2 ** len(self.ups))
        self.conv_post = Conv1d(ch, n_fft + 2, 7, padding=3, device=dev)
        self.register_buffer("stft_window", _hann_periodic(n_fft).to(dev), persistent=False)
        self.f0_predictor = f0_predictor or ConvRNNF0Predictor(in_channels=in_channels,
                                                               device=dev)

    def _stft(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T) → (B, frames, n_fft + 2): real ‖ imaginary."""
        n_fft = self.istft_params["n_fft"]
        spec = dsp_stft(x, n_fft=n_fft, hop_length=self.istft_params["hop_len"],
                        win_length=n_fft, window=self.stft_window, center=True)
        return torch.cat([spec.real, spec.imag], dim=-1)

    def _istft(self, magnitude: torch.Tensor, phase: torch.Tensor) -> torch.Tensor:
        """(B, frames, n_fft//2 + 1) twice → (B, T)."""
        magnitude = magnitude.clamp(max=1e2)
        spec = torch.complex(magnitude * torch.cos(phase), magnitude * torch.sin(phase))
        return dsp_istft(spec.transpose(-1, -2), hop_length=self.istft_params["hop_len"],
                         win_length=self.istft_params["n_fft"], window=self.stft_window,
                         center=True)

    def decode(self, mel: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
        """mel (B, T, C), source s (B, T_wav) → (B, T_wav')."""
        s_stft = self._stft(s).to(mel.dtype)
        x = self.conv_pre(mel)
        for i in range(self.num_upsamples):
            x = self.ups[i](F.leaky_relu(x, self.lrelu_slope))
            if i == self.num_upsamples - 1:
                x = torch.cat([x[:, 1:2], x], dim=1)  # reflect-pad by one
            si = self.source_resblocks[i](self.source_downs[i](s_stft))
            x = x + si[:, : x.shape[1]]
            x = sum(self.resblocks[i * self.num_kernels + j](x)
                    for j in range(self.num_kernels)) / self.num_kernels
        x = self.conv_post(F.leaky_relu(x, self.lrelu_slope)).float()
        half = self.istft_params["n_fft"] // 2 + 1
        wav = self._istft(torch.exp(x[..., :half]), torch.sin(x[..., half:]))
        return wav.clamp(-self.audio_limit, self.audio_limit)

    def forward(self, speech_feat: torch.Tensor, generator: Optional[torch.Generator] = None,
                cache_source: Optional[torch.Tensor] = None, draws=None):
        """speech_feat (B, T, n_mels) → (wav (B, T_wav), source (B, T_wav))."""
        speech_feat = speech_feat.to(self.conv_pre.weight.dtype)
        f0 = self.f0_predictor(speech_feat)  # (B, T)
        f0_up = f0[:, :, None].repeat_interleave(self.f0_upsample_scale, dim=1).float()
        s = self.m_source(f0_up, generator, draws)[..., 0]  # (B, T_wav) float32
        if cache_source is not None and cache_source.shape[-1] > 0:
            n = cache_source.shape[-1]
            s = torch.cat([cache_source, s[:, n:]], dim=-1)
        return self.decode(speech_feat, s), s

    def inference(self, speech_feat, generator=None, cache_source=None, draws=None):
        return self(speech_feat, generator=generator, cache_source=cache_source, draws=draws)
