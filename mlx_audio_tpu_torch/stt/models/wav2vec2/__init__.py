"""The `wav2vec2` model type: the `wav2vec` family under its Hugging Face
name."""

from ..wav2vec.wav2vec import Model, ModelConfig

__all__ = ["Model", "ModelConfig"]
