from .config import ModelConfig
from .qwen3_tts import Model

__all__ = ["Model", "ModelConfig"]
