from .kokoro import Model, ModelConfig
from .pipeline import KokoroPipeline

__all__ = ["KokoroPipeline", "Model", "ModelConfig"]
