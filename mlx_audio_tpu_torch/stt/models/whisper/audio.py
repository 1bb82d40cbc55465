"""Whisper audio front-end constants + mel extraction (counterpart of
`mlx_audio_tpu/stt/models/whisper/audio.py`)."""

from __future__ import annotations

import torch

from ....dsp import log_mel_spectrogram as _log_mel

SAMPLE_RATE = 16000
N_FFT = 400
HOP_LENGTH = 160
CHUNK_LENGTH = 30
N_SAMPLES = CHUNK_LENGTH * SAMPLE_RATE  # 480000
N_FRAMES = N_SAMPLES // HOP_LENGTH  # 3000
N_SAMPLES_PER_TOKEN = HOP_LENGTH * 2
FRAMES_PER_SECOND = SAMPLE_RATE // HOP_LENGTH
TOKENS_PER_SECOND = SAMPLE_RATE // N_SAMPLES_PER_TOKEN


def log_mel_spectrogram(audio, n_mels: int = 80, padding: int = 0, device=None):
    """Whisper-normalised log-mel, shape (..., T, n_mels)."""
    x = torch.as_tensor(audio, dtype=torch.float32, device=device)
    return _log_mel(
        x, n_mels=n_mels, n_fft=N_FFT, hop_length=HOP_LENGTH,
        sample_rate=SAMPLE_RATE, padding=padding,
    )
