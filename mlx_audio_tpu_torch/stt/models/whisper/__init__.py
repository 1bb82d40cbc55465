from .whisper import Model, ModelConfig, ModelDimensions

__all__ = ["Model", "ModelConfig", "ModelDimensions"]
