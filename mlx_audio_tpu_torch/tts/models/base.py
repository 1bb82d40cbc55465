"""Shared TTS result type and checkpoint helpers (counterpart of
`mlx_audio_tpu/tts/models/base.py`)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

from ...nn.sanitize import orient_to  # re-export, as the JAX package's base

__all__ = ["GenerationResult", "check_array_shape", "format_duration", "orient_to"]


@dataclass
class GenerationResult:
    audio: Any  # np.ndarray (samples,) float32
    samples: int
    sample_rate: int
    segment_idx: int = 0
    token_count: int = 0
    audio_duration: str = ""
    real_time_factor: float = 0.0
    prompt: dict = field(default_factory=dict)
    audio_samples: dict = field(default_factory=dict)
    processing_time_seconds: float = 0.0
    peak_memory_usage: float = 0.0
    is_streaming_chunk: bool = False
    is_final_chunk: bool = False

    def __post_init__(self):
        # 0.0 means "unknown": fill in the card's high-water mark (GiB; 0.0
        # on the host)
        if not self.peak_memory_usage:
            from ...profiling import peak_memory_gb

            self.peak_memory_usage = peak_memory_gb()


def format_duration(seconds: float) -> str:
    hours = int(seconds // 3600)
    mins = int((seconds % 3600) // 60)
    secs = int(seconds % 60)
    ms = int((seconds % 1) * 1000)
    return f"{hours:02d}:{mins:02d}:{secs:02d}.{ms:03d}"


def check_array_shape(arr) -> bool:
    """Heuristic: is a conv weight already in (out, k, in) layout?
    (The same check the reference uses for an idempotent sanitize.)"""
    shape = arr.shape
    if len(shape) != 3:
        return False
    out_channels, kH, kW = shape
    return (out_channels >= kH) and (out_channels >= kW) and (kH == kW)
