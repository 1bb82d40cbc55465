"""CosyVoice3's causal HiFT vocoder at 24 kHz (counterpart of
`mlx_audio_tpu/tts/models/cosyvoice3/hifigan.py`).

Every convolution is causal (padded on one side), so the same weights
serve offline and streaming decode; channels-last (B, T, C) throughout;
the n_fft = 16 STFT and ISTFT of the NSF head run on the port's
`dsp.stft` (zero-padded centre frames) and `dsp.istft`. `SineGen2`
accumulates the harmonic phases at frame rate and repeats them up to the
sample rate; its initial phases and noise come from a `torch.Generator`
(the JAX package's from a key), matching in distribution only; `draws`
passes them in (`SineGen2.draws`' layout). The source and the ISTFT head
run in float32 whatever the stack's dtype."""

from __future__ import annotations

import math
from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ....codec.models.s3gen.hifigan import Snake, _hann_periodic
from ....dsp import istft as dsp_istft
from ....dsp import stft as dsp_stft
from ....nn import Conv1d, Linear

__all__ = ["CausalHiFTGenerator", "CausalConv1d", "CausalResBlock", "SineGen2",
           "SourceModuleHnNSF2", "CausalConvRNNF0Predictor"]


class CausalConv1d(nn.Module):
    """A valid convolution padded by (k − 1)·d on the left ("left") or the
    right ("right"); a `cache` takes the padding's place."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, dilation: int = 1,
                 groups: int = 1, bias: bool = True, causal_type: str = "left", device=None):
        super().__init__()
        assert causal_type in ("left", "right")
        self.causal_padding = (kernel_size - 1) * dilation
        self.causal_type = causal_type
        self.conv = Conv1d(in_channels, out_channels, kernel_size, dilation=dilation,
                           groups=groups, bias=bias, device=device)

    def forward(self, x: torch.Tensor, cache: Optional[torch.Tensor] = None) -> torch.Tensor:
        left = self.causal_type == "left"
        if cache is None:
            p = self.causal_padding
            x = F.pad(x, (0, 0, p, 0) if left else (0, 0, 0, p))
        else:
            x = torch.cat([cache, x] if left else [x, cache], dim=1)
        return self.conv(x)


class CausalConv1dDownSample(nn.Module):
    """A strided convolution, stride − 1 zeros on the left."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, stride: int,
                 device=None):
        super().__init__()
        assert stride != 1 and kernel_size % stride == 0
        self.causal_padding = stride - 1
        self.conv = Conv1d(in_channels, out_channels, kernel_size, stride=stride, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.pad(x, (0, 0, self.causal_padding, 0)))


class CausalConv1dUpsample(nn.Module):
    """A nearest ×stride repeat, then a causal convolution."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, stride: int,
                 device=None):
        super().__init__()
        self.causal_padding = kernel_size - 1
        self.upsample_factor = stride
        self.conv = Conv1d(in_channels, out_channels, kernel_size, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.repeat_interleave(self.upsample_factor, dim=1)
        return self.conv(F.pad(x, (0, 0, self.causal_padding, 0)))


class CausalResBlock(nn.Module):
    """The Snake residual block with causal convolutions."""

    def __init__(self, channels: int, kernel_size: int = 3,
                 dilations: Optional[List[int]] = None, device=None):
        super().__init__()
        dilations = dilations or [1, 3, 5]
        self.convs1 = nn.ModuleList(CausalConv1d(channels, channels, kernel_size, dilation=d,
                                                 device=device) for d in dilations)
        self.convs2 = nn.ModuleList(CausalConv1d(channels, channels, kernel_size, device=device)
                                    for _ in dilations)
        self.activations1 = nn.ModuleList(Snake(channels, device=device) for _ in dilations)
        self.activations2 = nn.ModuleList(Snake(channels, device=device) for _ in dilations)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for c1, c2, a1, a2 in zip(self.convs1, self.convs2, self.activations1,
                                  self.activations2):
            x = c2(a2(c1(a1(x)))) + x
        return x


def _interp_linear_pt(x: torch.Tensor, new_T: int) -> torch.Tensor:
    """`F.interpolate(mode="linear", align_corners=False)` along axis 1 as the
    JAX package writes it (its positions clipped to T − 1.001); (B, T, C)."""
    T = x.shape[1]
    pos = (torch.arange(new_T, device=x.device, dtype=torch.float32) + 0.5) * (T / new_T) - 0.5
    pos = pos.clamp(0.0, T - 1.001)
    lo = torch.floor(pos).long()
    hi = (lo + 1).clamp(max=T - 1)
    w = (pos - lo)[None, :, None].to(x.dtype)
    return x[:, lo] * (1 - w) + x[:, hi] * w


class SineGen2(nn.Module):
    """The harmonic sine source, phases accumulated at frame rate: f0 (B, T,
    1) at the sample rate → (sines (B, T, H+1), voiced (B, T, 1))."""

    def __init__(self, sampling_rate: int, upsample_scale: int, harmonic_num: int = 0,
                 sine_amp: float = 0.1, noise_std: float = 0.003, voiced_threshold: float = 0.0):
        super().__init__()
        self.sine_amp = sine_amp
        self.noise_std = noise_std
        self.harmonic_num = harmonic_num
        self.sampling_rate = sampling_rate
        self.voiced_threshold = voiced_threshold
        self.upsample_scale = upsample_scale

    def draws(self, B: int, T: int, device, generator: Optional[torch.Generator] = None):
        """The random part of a call: (initial phases (B, H+1) uniform in
        [0, 1), the fundamental's 0; noise (B, T, H+1))."""
        H = self.harmonic_num + 1
        phase = torch.rand(B, H, generator=generator, device=device)
        phase[:, 0] = 0.0
        return phase, torch.randn(B, T, H, generator=generator, device=device)

    def forward(self, f0: torch.Tensor, generator=None, draws=None):
        B, T, _ = f0.shape
        H = self.harmonic_num + 1
        rand_ini, noise = draws if draws is not None else self.draws(B, T, f0.device, generator)
        harmonics = torch.arange(1, H + 1, dtype=f0.dtype, device=f0.device)
        rad = torch.remainder(f0 * harmonics[None, None, :] / self.sampling_rate, 1.0)
        rad[:, 0, :] = rad[:, 0, :] + rand_ini.to(rad.dtype)
        rad_down = _interp_linear_pt(rad, max(1, T // self.upsample_scale))
        phase = torch.cumsum(rad_down, dim=1) * 2.0 * math.pi
        phase = phase.repeat_interleave(self.upsample_scale, dim=1)[:, :T]
        sines = torch.sin(phase * self.upsample_scale)
        uv = (f0 > self.voiced_threshold).to(f0.dtype)
        noise_amp = uv * self.noise_std + (1 - uv) * self.sine_amp / 3
        return sines * self.sine_amp * uv + noise_amp * noise.to(sines.dtype), uv


class SourceModuleHnNSF2(nn.Module):
    def __init__(self, sampling_rate: int, upsample_scale: int, harmonic_num: int = 0,
                 sine_amp: float = 0.1, add_noise_std: float = 0.003,
                 voiced_threshold: float = 0.0, device=None):
        super().__init__()
        self.l_sin_gen = SineGen2(sampling_rate, upsample_scale, harmonic_num, sine_amp,
                                  add_noise_std, voiced_threshold)
        self.l_linear = Linear(harmonic_num + 1, 1, device=device)

    def forward(self, f0_up: torch.Tensor, generator=None, draws=None) -> torch.Tensor:
        """f0_up (B, T, 1) → the excitation (B, T, 1)."""
        sines, _ = self.l_sin_gen(f0_up, generator, draws)
        return torch.tanh(self.l_linear(sines))


class CausalConvRNNF0Predictor(nn.Module):
    """The causal F0 predictor, its first convolution looking right: (B, T,
    n_mels) → f0 (B, T)."""

    def __init__(self, num_class: int = 1, in_channels: int = 80, cond_channels: int = 512,
                 device=None):
        super().__init__()
        self.condnet_0 = CausalConv1d(in_channels, cond_channels, 4, causal_type="right",
                                      device=device)
        for i in (2, 4, 6, 8):
            setattr(self, f"condnet_{i}", CausalConv1d(cond_channels, cond_channels, 3,
                                                       device=device))
        self.classifier = Linear(cond_channels, num_class, device=device)

    def forward(self, x: torch.Tensor, finalize: bool = True) -> torch.Tensor:
        if finalize:
            x = self.condnet_0(x)
        else:
            p = self.condnet_0.causal_padding
            x = self.condnet_0(x[:, :-p], cache=x[:, -p:])
        x = F.elu(x)
        for i in (2, 4, 6, 8):
            x = F.elu(getattr(self, f"condnet_{i}")(x))
        return self.classifier(x)[..., 0].abs()


class CausalHiFTGenerator(nn.Module):
    """The causal HiFT-Net: mel (B, T, 80) → waveform (B, T·480)."""

    def __init__(self, in_channels: int = 80, base_channels: int = 512, nb_harmonics: int = 8,
                 sampling_rate: int = 24000, nsf_alpha: float = 0.1, nsf_sigma: float = 0.003,
                 nsf_voiced_threshold: float = 10.0, upsample_rates: Optional[List[int]] = None,
                 upsample_kernel_sizes: Optional[List[int]] = None,
                 istft_params: Optional[dict] = None,
                 resblock_kernel_sizes: Optional[List[int]] = None,
                 resblock_dilation_sizes: Optional[List[List[int]]] = None,
                 source_resblock_kernel_sizes: Optional[List[int]] = None,
                 source_resblock_dilation_sizes: Optional[List[List[int]]] = None,
                 lrelu_slope: float = 0.1, audio_limit: float = 0.99,
                 conv_pre_look_right: int = 4, device=None):
        super().__init__()
        upsample_rates = upsample_rates or [8, 5, 3]
        upsample_kernel_sizes = upsample_kernel_sizes or [16, 11, 7]
        istft_params = istft_params or {"n_fft": 16, "hop_len": 4}
        resblock_kernel_sizes = resblock_kernel_sizes or [3, 7, 11]
        resblock_dilation_sizes = resblock_dilation_sizes or [[1, 3, 5]] * 3
        source_resblock_kernel_sizes = source_resblock_kernel_sizes or [7, 7, 11]
        source_resblock_dilation_sizes = source_resblock_dilation_sizes or [[1, 3, 5]] * 3
        assert len(source_resblock_kernel_sizes) == len(upsample_rates), \
            "one source-fusion block per upsample stage"
        dev = device
        n_fft = istft_params["n_fft"]
        self.sampling_rate = sampling_rate
        self.istft_params = dict(istft_params)
        self.lrelu_slope = lrelu_slope
        self.audio_limit = audio_limit
        self.num_kernels = len(resblock_kernel_sizes)
        self.num_upsamples = len(upsample_rates)
        self.upsample_rates = list(upsample_rates)
        self.conv_pre_look_right = conv_pre_look_right
        self.f0_upsample_scale = math.prod(upsample_rates) * istft_params["hop_len"]
        self.f0_predictor = CausalConvRNNF0Predictor(in_channels=in_channels,
                                                     cond_channels=base_channels, device=dev)
        self.m_source = SourceModuleHnNSF2(
            sampling_rate=sampling_rate, upsample_scale=self.f0_upsample_scale,
            harmonic_num=nb_harmonics, sine_amp=nsf_alpha, add_noise_std=nsf_sigma,
            voiced_threshold=nsf_voiced_threshold, device=dev)
        self.conv_pre = CausalConv1d(in_channels, base_channels, conv_pre_look_right + 1,
                                     causal_type="right", device=dev)
        self.ups = nn.ModuleList(
            CausalConv1dUpsample(base_channels // (2 ** i), base_channels // (2 ** (i + 1)), k, u,
                                 device=dev)
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
                CausalConv1d(n_fft + 2, ch, 1, device=dev) if u == 1
                else CausalConv1dDownSample(n_fft + 2, ch, u * 2, u, device=dev))
            self.source_resblocks.append(CausalResBlock(ch, k, d, device=dev))
        self.resblocks = nn.ModuleList(
            CausalResBlock(base_channels // (2 ** (i + 1)), k, d, device=dev)
            for i in range(len(self.ups))
            for k, d in zip(resblock_kernel_sizes, resblock_dilation_sizes))
        ch = base_channels // (2 ** len(self.ups))
        self.conv_post = CausalConv1d(ch, n_fft + 2, 7, device=dev)
        self.register_buffer("stft_window", _hann_periodic(n_fft).to(dev), persistent=False)

    def _stft(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T) → (B, frames, n_fft + 2): real ‖ imaginary, the centre frames
        zero-padded."""
        n_fft = self.istft_params["n_fft"]
        spec = dsp_stft(x, n_fft=n_fft, hop_length=self.istft_params["hop_len"],
                        win_length=n_fft, window=self.stft_window, center=True,
                        pad_mode="constant")
        return torch.cat([spec.real, spec.imag], dim=-1)

    def _istft(self, magnitude: torch.Tensor, phase: torch.Tensor) -> torch.Tensor:
        magnitude = magnitude.clamp(max=1e2)
        spec = torch.complex(magnitude * torch.cos(phase), magnitude * torch.sin(phase))
        return dsp_istft(spec.transpose(-1, -2), hop_length=self.istft_params["hop_len"],
                         win_length=self.istft_params["n_fft"], window=self.stft_window,
                         center=True)

    def decode(self, mel: torch.Tensor, s: torch.Tensor, finalize: bool = True) -> torch.Tensor:
        """mel (B, T, C), source s (B, T_wav) → waveform."""
        s_stft = self._stft(s).to(mel.dtype)
        if finalize:
            x = self.conv_pre(mel)
        else:
            p = self.conv_pre.causal_padding
            x = self.conv_pre(mel[:, :-p], cache=mel[:, -p:])
            s_stft = s_stft[:, :-math.prod(self.upsample_rates) * self.conv_pre_look_right]
        for i in range(self.num_upsamples):
            x = self.ups[i](F.leaky_relu(x, self.lrelu_slope))
            if i == self.num_upsamples - 1:
                x = torch.cat([x[:, 1:2], x], dim=1)  # reflect-pad by one
            si = self.source_resblocks[i](self.source_downs[i](s_stft))
            x = x + si[:, : x.shape[1]]
            x = sum(self.resblocks[i * self.num_kernels + j](x)
                    for j in range(self.num_kernels)) / self.num_kernels
        x = self.conv_post(F.leaky_relu(x, 0.01)).float()
        half = self.istft_params["n_fft"] // 2 + 1
        wav = self._istft(torch.exp(x[..., :half]), torch.sin(x[..., half:]))
        if not finalize:
            wav = wav[:, :-math.prod(self.upsample_rates) * self.istft_params["hop_len"]]
        return wav.clamp(-self.audio_limit, self.audio_limit)

    def forward(self, speech_feat: torch.Tensor, generator: Optional[torch.Generator] = None,
                finalize: bool = True, draws=None):
        """speech_feat (B, T, n_mels) → (waveform (B, T·480), source)."""
        speech_feat = speech_feat.to(self.conv_pre.conv.weight.dtype)
        f0 = self.f0_predictor(speech_feat, finalize=finalize)
        f0_up = f0[:, :, None].repeat_interleave(self.f0_upsample_scale, dim=1).float()
        s = self.m_source(f0_up, generator, draws)[..., 0]
        if finalize:
            return self.decode(speech_feat, s, finalize=True), s
        p = self.f0_predictor.condnet_0.causal_padding
        return self.decode(speech_feat[:, :-p], s, finalize=False), s
