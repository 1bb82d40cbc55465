from .batcher import RASBatcher
from .config import CosyVoice2Config, FlowConfig, HiFiGANConfig, LLMConfig, ModelConfig
from .cosyvoice2 import CosyVoice2, Model, build_cosyvoice2
from .llm import Qwen2LM, ras_sample

__all__ = ["CosyVoice2", "CosyVoice2Config", "FlowConfig", "HiFiGANConfig", "LLMConfig", "Model",
           "ModelConfig", "Qwen2LM", "RASBatcher", "build_cosyvoice2", "ras_sample"]
