from .outetts import Model, ModelConfig

__all__ = ["Model", "ModelConfig"]
