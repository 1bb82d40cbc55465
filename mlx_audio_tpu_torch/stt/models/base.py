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
