"""Kokoro iSTFTNet decoder: HiFiGAN-NSF with an iSTFT head (counterpart of
`mlx_audio_tpu/tts/models/kokoro/istftnet.py`).

Channels-last throughout, weight norm folded at load. The STFT head and the
NSF source analysis are window-folded DFT matmuls with reshape framing and
shift-and-add overlap-add (n_fft % hop == 0; a gather/scatter path covers
other geometries). The analysis's first frame is symmetric, so its phase
below Nyquist is set exactly to 0 or π; the JAX package's is ±π there by
the sign of a rounding residue. Their DFT matrices are buffers, so `cast_floats` rounds
them to bf16 as it does the JAX package's; the head's arithmetic stays in
float32 on those rounded constants. The NSF source and its phase cumsum
run in float32 whatever the conv stack's dtype.

The sine source's normals come from an explicit `torch.Generator`, or are
passed in: they are not the JAX package's `jax.random` draws.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ....dsp import hanning
from ....nn import Conv1d, ConvTranspose1d, Linear
from ..interpolate import interpolate
from .modules import AdaIN1d, AdainResBlk1d, leaky_relu, valid_len_at

__all__ = ["Decoder", "Generator", "SineGen", "SourceModuleHnNSF", "STFTHead"]

# the sine source's randomness: a generator to draw from, or the draws
# themselves, (rand_ini (B, harmonics), normal (B, L, harmonics))
Noise = Union[torch.Generator, Tuple[torch.Tensor, torch.Tensor]]


class STFTHead(nn.Module):
    """Batched STFT / iSTFT (magnitude and phase) for the NSF source analysis
    and the output head."""

    def __init__(self, filter_length=800, hop_length=200, win_length=800, device=None):
        super().__init__()
        self.filter_length = filter_length
        self.hop_length = hop_length
        self.win_length = win_length
        N = filter_length
        n = np.arange(N)[:, None]
        f = np.arange(N // 2 + 1)[None, :]
        ang = 2.0 * np.pi * n * f / N
        win = np.asarray(hanning(win_length, periodic=True), np.float64)
        wf = np.full(N // 2 + 1, 2.0)
        wf[0] = 1.0
        if N % 2 == 0:
            wf[-1] = 1.0
        for name, value in (
                ("_window", hanning(win_length, periodic=True).numpy()),
                ("_fwd_re", win[:, None] * np.cos(ang)),
                ("_fwd_im", win[:, None] * -np.sin(ang)),
                ("_inv_re", (wf[:, None] * np.cos(ang.T) / N) * win[None, :]),
                ("_inv_im", (wf[:, None] * -np.sin(ang.T) / N) * win[None, :])):
            self.register_buffer(name, torch.tensor(value, dtype=torch.float32, device=device))
        self._cola: dict = {}  # (frames, device) → the overlap-add denominator

    def _frame(self, xp: torch.Tensor, num_frames: int) -> torch.Tensor:
        """xp (B, Lp) → frames (B, T, n_fft); reshape and shift when possible."""
        N, hop = self.filter_length, self.hop_length
        B, Lp = xp.shape
        if N % hop == 0 and Lp % hop == 0:
            xb = xp.reshape(B, Lp // hop, hop)
            return torch.cat([xb[:, q: q + num_frames, :] for q in range(N // hop)], dim=-1)
        idx = torch.arange(num_frames, device=xp.device)[:, None] * hop + torch.arange(
            N, device=xp.device)[None, :]
        return xp[:, idx]

    def transform(self, x: torch.Tensor):
        """x (B, L) → magnitude and phase, each (B, F, T), in float32."""
        pad = self.filter_length // 2
        xp = F.pad(x.float()[:, None], (pad, pad), mode="reflect")[:, 0]
        num_frames = 1 + (xp.shape[-1] - self.filter_length) // self.hop_length
        frames = self._frame(xp, num_frames)
        re = frames @ self._fwd_re.float()
        im = frames @ self._fwd_im.float()
        # The first frame is symmetric (reflect padding by n_fft/2), so its
        # DFT is real: its imaginary part below the Nyquist bin is set to
        # exactly +0, and its phase there is exactly 0 or π on every device.
        # The product leaves a rounding residue whose sign picks +π or −π.
        im[:, 0, : (self.filter_length + 1) // 2] = 0.0
        mag = torch.sqrt(re * re + im * im)
        phase = torch.atan2(im, re)
        return mag.transpose(-1, -2), phase.transpose(-1, -2)

    def _denominator(self, T: int, device) -> torch.Tensor:
        """The COLA denominator: it depends on the frame count only, so it is
        computed once per count on the host (float64, as the JAX package)."""
        key = (T, str(device))
        if key not in self._cola:
            N, hop = self.filter_length, self.hop_length
            nwin = np.arange(self.win_length)
            win2 = (0.5 * (1 - np.cos(2 * np.pi * nwin / self.win_length))) ** 2
            idx = (np.arange(T)[:, None] * hop + np.arange(N)[None, :]).reshape(-1)
            wsum = np.bincount(idx, np.broadcast_to(win2, (T, N)).reshape(-1),
                               minlength=(T - 1) * hop + N)
            self._cola[key] = torch.tensor(np.maximum(wsum, 1e-10), dtype=torch.float32,
                                           device=device)
        return self._cola[key]

    def inverse(self, magnitude: torch.Tensor, phase: torch.Tensor) -> torch.Tensor:
        """(B, F, T) magnitude and phase → (B, L) waveform, COLA-normalised
        overlap-add, in float32."""
        re = (magnitude * torch.cos(phase)).float().transpose(-1, -2)  # (B, T, F)
        im = (magnitude * torch.sin(phase)).float().transpose(-1, -2)
        frames = re @ self._inv_re.float() + im @ self._inv_im.float()  # (B, T, n_fft)
        B, T, N = frames.shape
        hop = self.hop_length
        out_len = (T - 1) * hop + N
        if N % hop == 0:
            r = N // hop
            fwr = frames.reshape(B, T, r, hop)
            out = sum(F.pad(fwr[:, :, q, :], (0, 0, q, r - 1 - q))
                      for q in range(r)).reshape(B, out_len)
        else:
            idx = (torch.arange(T, device=frames.device)[:, None] * hop
                   + torch.arange(N, device=frames.device)[None, :]).reshape(-1)
            out = frames.new_zeros(B, out_len).index_add_(1, idx, frames.reshape(B, -1))
        out = out / self._denominator(T, out.device)
        pad = self.filter_length // 2
        return out[:, pad:-pad]


class SineGen(nn.Module):
    """Harmonic sine source for NSF."""

    def __init__(self, samp_rate: int, upsample_scale: int, harmonic_num: int = 0,
                 sine_amp: float = 0.1, noise_std: float = 0.003,
                 voiced_threshold: float = 0.0):
        super().__init__()
        self.sine_amp = sine_amp
        self.noise_std = noise_std
        self.harmonic_num = harmonic_num
        self.dim = harmonic_num + 1
        self.sampling_rate = samp_rate
        self.voiced_threshold = voiced_threshold
        self.upsample_scale = int(upsample_scale)

    def _f02sine(self, f0_values: torch.Tensor, rand_ini: torch.Tensor) -> torch.Tensor:
        # f0_values (B, L, dim) at the audio rate; rand_ini (B, dim)
        rad = torch.remainder(f0_values / self.sampling_rate, 1.0)
        ini = rand_ini.clone()
        ini[:, 0] = 0.0  # the fundamental starts at phase 0
        rad[:, 0] += ini
        # phase increments down to the frame rate, integrated, back up
        rad_down = interpolate(rad.transpose(1, 2), scale_factor=1 / self.upsample_scale,
                               mode="linear")
        phase = torch.cumsum(rad_down, dim=-1) * 2 * math.pi
        phase_up = interpolate(phase * self.upsample_scale,
                               scale_factor=self.upsample_scale, mode="linear")
        return torch.sin(phase_up.transpose(1, 2))

    def forward(self, f0: torch.Tensor, noise: Noise):
        """f0 (B, L, 1) at the audio rate → (sine waves + noise (B, L, dim),
        voiced flags (B, L, 1))."""
        B, L, _ = f0.shape
        if isinstance(noise, torch.Generator):
            noise = (torch.randn(B, self.dim, generator=noise, device=f0.device),
                     torch.randn(B, L, self.dim, generator=noise, device=f0.device))
        rand_ini, normal = noise
        harmonics = torch.arange(1, self.harmonic_num + 2, dtype=f0.dtype, device=f0.device)
        sine_waves = self._f02sine(f0 * harmonics, rand_ini) * self.sine_amp
        uv = (f0 > self.voiced_threshold).float()
        noise_amp = uv * self.noise_std + (1 - uv) * self.sine_amp / 3
        return sine_waves * uv + noise_amp * normal, uv


class SourceModuleHnNSF(nn.Module):
    def __init__(self, sampling_rate: int, upsample_scale: int, harmonic_num: int = 0,
                 sine_amp: float = 0.1, add_noise_std: float = 0.003,
                 voiced_threshod: float = 0.0, device=None):
        super().__init__()
        self.sine_amp = sine_amp
        self.l_sin_gen = SineGen(sampling_rate, upsample_scale, harmonic_num, sine_amp,
                                 add_noise_std, voiced_threshod)
        self.l_linear = Linear(harmonic_num + 1, 1, device=device)

    def forward(self, x: torch.Tensor, noise: Noise):
        sine_wavs, uv = self.l_sin_gen(x, noise)
        return torch.tanh(self.l_linear(sine_wavs)), uv


class ResBlockAdaINSnake(nn.Module):
    """AdaINResBlock1: 3 × (AdaIN → Snake → dilated conv → AdaIN → Snake →
    conv), with a learnable per-channel snake alpha stored (1, C, 1)."""

    def __init__(self, channels: int, kernel_size: int, dilations, style_dim: int,
                 device=None):
        super().__init__()

        def pad(d):
            return (kernel_size * d - d) // 2

        self.convs1 = nn.ModuleList(
            Conv1d(channels, channels, kernel_size, padding=pad(d), dilation=d, device=device)
            for d in dilations)
        self.convs2 = nn.ModuleList(
            Conv1d(channels, channels, kernel_size, padding=pad(1), device=device)
            for _ in dilations)
        self.adain1 = nn.ModuleList(AdaIN1d(style_dim, channels, device=device)
                                    for _ in dilations)
        self.adain2 = nn.ModuleList(AdaIN1d(style_dim, channels, device=device)
                                    for _ in dilations)
        self.alpha1 = nn.ParameterList(
            nn.Parameter(torch.empty(1, channels, 1, device=device)) for _ in dilations)
        self.alpha2 = nn.ParameterList(
            nn.Parameter(torch.empty(1, channels, 1, device=device)) for _ in dilations)

    def reset_parameters(self, generator: Optional[torch.Generator]) -> None:
        for a in list(self.alpha1) + list(self.alpha2):
            a.data.fill_(1.0)

    def forward(self, x: torch.Tensor, s: torch.Tensor, valid_frac=None) -> torch.Tensor:
        vl = valid_len_at(x.shape[1], valid_frac)
        for c1, c2, n1, n2, a1, a2 in zip(self.convs1, self.convs2, self.adain1, self.adain2,
                                          self.alpha1, self.alpha2):
            a1v = a1.transpose(1, 2).to(x.dtype)  # (1, 1, C)
            a2v = a2.transpose(1, 2).to(x.dtype)
            xt = n1(x, s, vl)
            xt = xt + (1.0 / a1v) * torch.sin(a1v * xt) ** 2
            xt = n2(c1(xt), s, vl)
            xt = xt + (1.0 / a2v) * torch.sin(a2v * xt) ** 2
            x = c2(xt) + x
        return x


class Generator(nn.Module):
    """HiFiGAN-NSF generator with an iSTFT output head."""

    def __init__(self, style_dim, resblock_kernel_sizes, upsample_rates,
                 upsample_initial_channel, resblock_dilation_sizes, upsample_kernel_sizes,
                 gen_istft_n_fft, gen_istft_hop_size, sample_rate: int = 24000, device=None):
        super().__init__()
        self.num_kernels = len(resblock_kernel_sizes)
        self.num_upsamples = len(upsample_rates)
        self.total_upsample = int(np.prod(upsample_rates)) * gen_istft_hop_size
        self.m_source = SourceModuleHnNSF(sampling_rate=sample_rate,
                                          upsample_scale=self.total_upsample, harmonic_num=8,
                                          voiced_threshod=10, device=device)
        self.ups = nn.ModuleList(
            ConvTranspose1d(upsample_initial_channel // (2 ** i),
                            upsample_initial_channel // (2 ** (i + 1)), k, stride=u,
                            padding=(k - u) // 2, device=device)
            for i, (u, k) in enumerate(zip(upsample_rates, upsample_kernel_sizes)))
        self.resblocks = nn.ModuleList()
        self.noise_convs = nn.ModuleList()
        self.noise_res = nn.ModuleList()
        for i in range(len(self.ups)):
            ch = upsample_initial_channel // (2 ** (i + 1))
            for k, d in zip(resblock_kernel_sizes, resblock_dilation_sizes):
                self.resblocks.append(ResBlockAdaINSnake(ch, k, d, style_dim, device=device))
            if i + 1 < len(upsample_rates):
                stride_f0 = int(np.prod(upsample_rates[i + 1:]))
                self.noise_convs.append(Conv1d(
                    gen_istft_n_fft + 2, ch, kernel_size=stride_f0 * 2, stride=stride_f0,
                    padding=(stride_f0 + 1) // 2, device=device))
                self.noise_res.append(ResBlockAdaINSnake(ch, 7, [1, 3, 5], style_dim,
                                                         device=device))
            else:
                self.noise_convs.append(Conv1d(gen_istft_n_fft + 2, ch, kernel_size=1,
                                               device=device))
                self.noise_res.append(ResBlockAdaINSnake(ch, 11, [1, 3, 5], style_dim,
                                                         device=device))
        self.post_n_fft = gen_istft_n_fft
        self.conv_post = Conv1d(ch, gen_istft_n_fft + 2, 7, padding=3, device=device)
        self.stft = STFTHead(filter_length=gen_istft_n_fft, hop_length=gen_istft_hop_size,
                             win_length=gen_istft_n_fft, device=device)

    def forward(self, x: torch.Tensor, s: torch.Tensor, f0: torch.Tensor, noise: Noise,
                valid_frac=None) -> torch.Tensor:
        """x (B, T, C); f0 (B, T_f0) the frame-rate F0 curve → (B, L) float32
        waveform."""
        f0_up = interpolate(f0.float()[:, None, :], scale_factor=self.total_upsample,
                            mode="nearest")  # (B, 1, L)
        har_source, _ = self.m_source(f0_up.transpose(1, 2), noise)  # (B, L, 1)
        har_spec, har_phase = self.stft.transform(har_source[..., 0])
        har = torch.cat([har_spec, har_phase], dim=1).transpose(1, 2).to(x.dtype)

        for i in range(self.num_upsamples):
            x = leaky_relu(x, 0.1)
            x_source = self.noise_res[i](self.noise_convs[i](har), s, valid_frac)
            x = self.ups[i](x)
            if i == self.num_upsamples - 1:
                x = F.pad(x, (0, 0, 1, 0))  # one zero in front
            x = x + x_source
            xs = None
            for j in range(self.num_kernels):
                r = self.resblocks[i * self.num_kernels + j](x, s, valid_frac)
                xs = r if xs is None else xs + r
            x = xs / self.num_kernels

        x = self.conv_post(leaky_relu(x, 0.01))  # (B, T', n_fft + 2)
        x = x.transpose(1, 2).float()  # the head's arithmetic stays float32
        spec = torch.exp(x[:, : self.post_n_fft // 2 + 1, :])
        phase = torch.sin(x[:, self.post_n_fft // 2 + 1:, :])
        return self.stft.inverse(spec, phase)


class Decoder(nn.Module):
    """AdaIN encode → 4 decode blocks with the (asr_res, F0, N) skips → NSF
    generator."""

    def __init__(self, dim_in, style_dim, dim_out, resblock_kernel_sizes, upsample_rates,
                 upsample_initial_channel, resblock_dilation_sizes, upsample_kernel_sizes,
                 gen_istft_n_fft, gen_istft_hop_size, sample_rate: int = 24000, device=None):
        super().__init__()
        bottleneck = 2 * max(dim_in, upsample_initial_channel)  # 1024 for Kokoro-82M
        skip = bottleneck + 2 + 64
        self.encode = AdainResBlk1d(dim_in + 2, bottleneck, style_dim, device=device)
        self.decode = nn.ModuleList([
            AdainResBlk1d(skip, bottleneck, style_dim, device=device),
            AdainResBlk1d(skip, bottleneck, style_dim, device=device),
            AdainResBlk1d(skip, bottleneck, style_dim, device=device),
            AdainResBlk1d(skip, upsample_initial_channel, style_dim, upsample=True,
                          device=device),
        ])
        self.F0_conv = Conv1d(1, 1, 3, stride=2, padding=1, device=device)
        self.N_conv = Conv1d(1, 1, 3, stride=2, padding=1, device=device)
        self.asr_res = nn.ModuleList([Conv1d(dim_in, 64, 1, device=device)])
        self.generator = Generator(style_dim, resblock_kernel_sizes, upsample_rates,
                                   upsample_initial_channel, resblock_dilation_sizes,
                                   upsample_kernel_sizes, gen_istft_n_fft, gen_istft_hop_size,
                                   sample_rate=sample_rate, device=device)

    def forward(self, asr, F0_curve, N, s, noise: Noise, valid_frac=None):
        """asr (B, T, dim_in); F0_curve, N (B, 2T); s (B, style) → (B, L)."""
        F0 = self.F0_conv(F0_curve[..., None])  # (B, T, 1)
        Nd = self.N_conv(N[..., None])
        x = self.encode(torch.cat([asr, F0, Nd], dim=-1), s, valid_frac)
        asr_res = self.asr_res[0](asr)
        res = True
        for block in self.decode:
            if res:
                x = torch.cat([x, asr_res, F0, Nd], dim=-1)
            x = block(x, s, valid_frac)
            if block.upsample_type:
                res = False
        return self.generator(x, s, F0_curve, noise, valid_frac)
