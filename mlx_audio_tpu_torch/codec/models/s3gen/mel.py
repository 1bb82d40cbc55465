"""The prompt mel of S3Gen and CosyVoice2: 24 kHz, 80 bins, hop 480
(counterpart of `mlx_audio_tpu/codec/models/s3gen/mel.py`)."""

from __future__ import annotations

import numpy as np
import torch

from ....dsp import mel_filters, stft

__all__ = ["mel_spectrogram"]


def mel_spectrogram(y, n_fft: int = 1920, num_mels: int = 80, sampling_rate: int = 24000,
                    hop_size: int = 480, win_size: int = 1920, fmin: float = 0.0,
                    fmax: float = 8000.0, device=None) -> torch.Tensor:
    """Waveform (B, T) or (T,) → log-mel (B, T', num_mels), channels-last:
    reflect-padded by (n_fft - hop)/2 on each side, uncentred STFT."""
    if not isinstance(y, torch.Tensor):
        y = torch.from_numpy(np.asarray(y, np.float32))
    y = y.to(device=device, dtype=torch.float32)
    if y.dim() == 1:
        y = y[None]
    pad = (n_fft - hop_size) // 2
    y = torch.cat([y[:, 1: pad + 1].flip(1), y, y[:, -(pad + 1): -1].flip(1)], dim=1)
    mag = stft(y, n_fft=n_fft, hop_length=hop_size, win_length=win_size, window="hann",
               center=False).abs()
    filters = mel_filters(sampling_rate, n_fft, num_mels, f_min=fmin, f_max=fmax,
                          norm="slaney", mel_scale="slaney", device=y.device)
    return torch.log((mag @ filters.T).clamp(min=1e-5))
