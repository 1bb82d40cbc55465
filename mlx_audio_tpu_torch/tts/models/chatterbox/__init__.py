from .chatterbox import Conditionals, Model, drop_invalid_tokens, punc_norm, sanitize_weights
from .config import LLAMA_CONFIGS, ModelConfig, T3Config
from .t3 import T3, T3Cond
from .tokenizer import EnTokenizer, MTLTokenizer
from .voice_encoder import VoiceEncConfig, VoiceEncoder

__all__ = ["Conditionals", "EnTokenizer", "LLAMA_CONFIGS", "MTLTokenizer", "Model",
           "ModelConfig", "T3", "T3Cond", "T3Config", "VoiceEncConfig", "VoiceEncoder",
           "drop_invalid_tokens", "punc_norm", "sanitize_weights"]
