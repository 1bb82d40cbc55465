"""The LM core (counterpart of `mlx_audio_tpu/lm/`): the Llama / Qwen2 /
Qwen3 transformer, KV caches, samplers, the generate loops and the
continuous batcher."""

from .cache import KVCache, RingKVCache, make_caches
from .continuous import ContinuousBatcher, SlotKVCache
from .generate import GenerationResponse, generate_tokens, stream_generate
from .sample import apply_repetition_penalty, make_sampler
from .transformer import CausalLM, CausalSelfAttention, LMConfig, TransformerBlock

__all__ = ["KVCache", "RingKVCache", "make_caches", "LMConfig", "CausalLM", "TransformerBlock",
           "CausalSelfAttention", "make_sampler", "apply_repetition_penalty",
           "stream_generate", "generate_tokens", "GenerationResponse", "ContinuousBatcher",
           "SlotKVCache"]
