from .llama import Model, ModelConfig

__all__ = ["Model", "ModelConfig"]
