from .bark import GPTConfig, Model, ModelConfig

__all__ = ["GPTConfig", "Model", "ModelConfig"]
