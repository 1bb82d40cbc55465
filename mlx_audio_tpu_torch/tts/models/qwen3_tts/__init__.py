from .config import ModelConfig
from .qwen3_tts import Model, checkpoint_quant_predicate

__all__ = ["Model", "ModelConfig", "checkpoint_quant_predicate"]
