from .wav2vec import Model, ModelConfig

__all__ = ["Model", "ModelConfig"]
