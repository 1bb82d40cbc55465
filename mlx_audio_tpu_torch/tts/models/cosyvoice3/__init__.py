from .config import CosyVoice3Config, DiTConfig, FlowConfig, HiFiGANConfig, LLMConfig, ModelConfig
from .cosyvoice3 import CosyVoice3, Model, build_cosyvoice3, normalize_text, split_text
from .dit import DiT
from .flow import CausalMaskedDiffWithDiT, CosyVoice3ConditionalCFM
from .hifigan import CausalHiFTGenerator
from .llm import CosyVoice3LM

__all__ = ["CausalHiFTGenerator", "CausalMaskedDiffWithDiT", "CosyVoice3",
           "CosyVoice3ConditionalCFM", "CosyVoice3Config", "CosyVoice3LM", "DiT", "DiTConfig",
           "FlowConfig", "HiFiGANConfig", "LLMConfig", "Model", "ModelConfig", "build_cosyvoice3",
           "normalize_text", "split_text"]
