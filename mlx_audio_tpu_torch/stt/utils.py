"""STT model registry and 16 kHz audio loading (counterpart of
`mlx_audio_tpu/stt/utils.py`)."""

from __future__ import annotations

import sys
from pathlib import Path
from typing import Optional, Union

import numpy as np

from ..utils import base_load_model, load_audio as _load_audio_generic, resample_audio

SAMPLE_RATE = 16000

MODEL_REMAPPING = {
    "glm": "glmasr",
    "voxtral": "voxtral",
    "voxtral_realtime": "voxtral_realtime",
    "vibevoice": "vibevoice_asr",
    "qwen3_asr": "qwen3_asr",
    "medasr": "funasr",
}


def load_audio(file: Optional[str] = None, sr: int = SAMPLE_RATE, from_stdin: bool = False,
               dtype=np.float32) -> np.ndarray:
    """An audio file (or the bytes on standard input) as a mono waveform at `sr`."""
    if from_stdin:
        from .. import audio_io

        x, orig_sr = audio_io.read(sys.stdin.buffer.read())
        if x.ndim == 2:
            x = x.mean(axis=1)
        if orig_sr != sr:
            x = resample_audio(x, orig_sr, sr)
        return x.astype(dtype)
    return _load_audio_generic(file, sample_rate=sr, dtype=dtype)


def load_model(model_path: Union[str, Path], lazy: bool = False, strict: bool = False,
               **kwargs):
    """`utils.base_load_model` for the STT families; `device` and `dtype`
    pass through (None: the card, the checkpoint's dtype)."""
    return base_load_model(model_path=model_path, category="stt",
                           model_remapping=MODEL_REMAPPING, lazy=lazy, strict=strict,
                           **kwargs)


def load(model_path: Union[str, Path], lazy: bool = False, strict: bool = False, **kwargs):
    """Alias of load_model."""
    return load_model(model_path, lazy=lazy, **kwargs)
