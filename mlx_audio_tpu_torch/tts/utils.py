"""TTS model registry (counterpart of `mlx_audio_tpu/tts/utils.py`)."""

from __future__ import annotations

from pathlib import Path
from typing import List, Union

from ..utils import base_load_model

MODEL_REMAPPING = {
    "qwen3_tts": "qwen3_tts",
    "outetts": "outetts",
    "spark": "spark",
    "marvis": "sesame",
    "csm": "sesame",
    "voxcpm": "voxcpm",
    "voxcpm1.5": "voxcpm",
    "vibevoice_streaming": "vibevoice",
    "chatterbox_turbo": "chatterbox_turbo",
    "soprano": "soprano",
    "echo_tts": "echo_tts",
    "orpheus": "llama",
    "vyvo": "qwen3",
}


def get_available_models() -> List[str]:
    """The TTS families under `tts/models/`."""
    models_dir = Path(__file__).parent / "models"
    return sorted(
        d.name
        for d in models_dir.iterdir()
        if d.is_dir() and not d.name.startswith("__")
    )


def load_model(model_path: Union[str, Path], lazy: bool = False, strict: bool = False,
               **kwargs):
    """`utils.base_load_model` for the TTS families; `device` and `dtype`
    pass through (None: the card, the checkpoint's dtype)."""
    return base_load_model(model_path=model_path, category="tts",
                           model_remapping=MODEL_REMAPPING, lazy=lazy, strict=strict,
                           **kwargs)


def convert(hf_path: str, mlx_path: str = "converted_model", quantize: bool = False,
            q_group_size: int = 64, q_bits: int = 4, dtype: str = None,
            upload_repo: str = None, revision=None, dequantize: bool = False,
            quant_predicate: str = None, **kwargs):
    """The per-domain convert wrapper: delegates to `convert.convert`."""
    from ..convert import convert as _convert

    return _convert(hf_path, mlx_path, quantize=quantize, q_bits=q_bits,
                    q_group_size=q_group_size, q_recipe=quant_predicate,
                    dequantize=dequantize, dtype=dtype, upload_repo=upload_repo,
                    revision=revision)


def load(model_path: Union[str, Path], lazy: bool = False, strict: bool = True, **kwargs):
    """Alias of load_model."""
    return load_model(model_path, lazy=lazy, strict=strict, **kwargs)
