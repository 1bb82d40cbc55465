"""Shared STT result type (counterpart of `mlx_audio_tpu/stt/models/base.py`)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional


@dataclass
class STTOutput:
    text: str
    segments: Optional[List[dict]] = None
    language: Optional[str] = None
    prompt_tokens: int = 0
    generation_tokens: int = 0
    prompt_tps: float = 0.0
    generation_tps: float = 0.0
    total_tps: float = 0.0
    duration: float = 0.0
    peak_memory_gb: float = 0.0
    extra: dict = field(default_factory=dict)


def ensure_waveform(audio, sample_rate: int):
    """A file path, encoded bytes or array-like as a mono float32 waveform
    at `sample_rate` (arrays pass through)."""
    import numpy as np

    if isinstance(audio, str) or hasattr(audio, "__fspath__"):
        from ...utils import load_audio

        audio = load_audio(audio, sample_rate=sample_rate)
    elif isinstance(audio, (bytes, bytearray)):
        from ... import audio_io
        from ...utils import resample_audio

        x, sr = audio_io.read(bytes(audio))
        if x.ndim == 2:
            x = x.mean(axis=1)
        audio = resample_audio(x, sr, sample_rate) if sr != sample_rate else x
    return np.asarray(audio, np.float32).reshape(-1)
