from .qwen3 import Model, ModelConfig

__all__ = ["Model", "ModelConfig"]
