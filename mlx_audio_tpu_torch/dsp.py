"""Audio DSP front-end, the Whisper part (counterpart of
`mlx_audio_tpu/dsp.py`): Hann window, centered reflect-padded STFT, slaney
mel filterbank and the Whisper-normalised log-mel.

The Kaldi fbank, ISTFT and loudness parts of the JAX module are not ported
yet. `torch.fft.rfft` takes the place of the JAX module's DFT-by-matmul.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Optional, Union

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["hanning", "stft", "mel_filters", "log_mel_spectrogram"]


@lru_cache(maxsize=None)
def _hanning_np(size: int, periodic: bool) -> np.ndarray:
    denom = size if periodic else size - 1
    n = np.arange(size)
    return (0.5 * (1 - np.cos(2 * np.pi * n / denom))).astype(np.float32)


def hanning(size: int, periodic: bool = False, device=None) -> torch.Tensor:
    return torch.from_numpy(_hanning_np(size, periodic)).to(device)


def stft(x: torch.Tensor, n_fft: int = 800, hop_length: Optional[int] = None,
         window: Union[torch.Tensor, str] = "hann") -> torch.Tensor:
    """Centered, reflect-padded STFT of the last axis → complex
    (..., num_frames, n_fft//2 + 1)."""
    if hop_length is None:
        hop_length = n_fft // 4
    if isinstance(window, str):
        if window.lower() not in ("hann", "hanning"):
            raise ValueError(f"Unknown window function: {window}")
        window = hanning(n_fft, device=x.device)
    if window.shape[0] < n_fft:
        window = F.pad(window, (0, n_fft - window.shape[0]))
    pad = n_fft // 2
    if x.shape[-1] <= pad:
        raise ValueError(f"Input too short (length={x.shape[-1]}) to reflect-pad by {pad}")
    lead = x.shape[:-1]
    x = F.pad(x.reshape(-1, 1, x.shape[-1]), (pad, pad), mode="reflect")
    x = x.reshape(*lead, x.shape[-1])
    frames = (x.unfold(-1, n_fft, hop_length) * window).float()
    return torch.fft.rfft(frames, dim=-1)


@lru_cache(maxsize=None)
def _mel_filters_np(sample_rate: int, n_fft: int, n_mels: int) -> np.ndarray:
    """Slaney-scale triangular mel filterbank with slaney area
    normalisation, shape (n_mels, n_fft//2 + 1), as librosa and Whisper."""
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = math.log(6.4) / 27.0

    def hz_to_mel(freq: float) -> float:
        if freq >= min_log_hz:
            return min_log_mel + math.log(freq / min_log_hz) / logstep
        return freq / f_sp

    def mel_to_hz(mels: np.ndarray) -> np.ndarray:
        return np.where(
            mels >= min_log_mel,
            min_log_hz * np.exp(logstep * (mels - min_log_mel)),
            f_sp * mels,
        )

    n_freqs = n_fft // 2 + 1
    all_freqs = np.linspace(0, sample_rate // 2, n_freqs)
    m_pts = np.linspace(hz_to_mel(0.0), hz_to_mel(sample_rate / 2), n_mels + 2)
    f_pts = mel_to_hz(m_pts)

    f_diff = f_pts[1:] - f_pts[:-1]
    slopes = f_pts[None, :] - all_freqs[:, None]
    down_slopes = (-slopes[:, :-2]) / f_diff[:-1]
    up_slopes = slopes[:, 2:] / f_diff[1:]
    fb = np.maximum(0.0, np.minimum(down_slopes, up_slopes))
    fb = fb * (2.0 / (f_pts[2 : n_mels + 2] - f_pts[:n_mels]))[None, :]
    return fb.T.astype(np.float32)


def mel_filters(sample_rate: int, n_fft: int, n_mels: int, device=None) -> torch.Tensor:
    return torch.from_numpy(_mel_filters_np(sample_rate, n_fft, n_mels)).to(device)


def log_mel_spectrogram(
    audio: torch.Tensor,
    n_mels: int = 80,
    n_fft: int = 400,
    hop_length: int = 160,
    sample_rate: int = 16000,
    padding: int = 0,
) -> torch.Tensor:
    """Whisper-style log-mel: log10(clip(mel @ |stft|^2)), normalised.

    audio (..., N) → (..., frames, n_mels). The dynamic-range clip takes the
    max over each signal's own spectrogram, so a batch of chunks gives each
    row what the single-chunk call would."""
    if padding > 0:
        audio = F.pad(audio, (0, padding))
    window = hanning(n_fft + 1, periodic=False, device=audio.device)[:-1]
    spec = stft(audio, n_fft, hop_length, window=window)
    magnitudes = spec[..., :-1, :].abs() ** 2  # drop the last frame, as whisper
    fb = mel_filters(sample_rate, n_fft, n_mels, device=audio.device)
    mel_spec = torch.matmul(magnitudes, fb.T)
    log_spec = torch.log10(torch.clamp(mel_spec, min=1e-10))
    row_max = log_spec.amax(dim=(-2, -1), keepdim=True)
    log_spec = torch.maximum(log_spec, row_max - 8.0)
    return (log_spec + 4.0) / 4.0
