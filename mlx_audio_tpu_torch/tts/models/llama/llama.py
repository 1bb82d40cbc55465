"""Orpheus TTS, a Llama-3B AR over 7-token SNAC frames (counterpart of
`mlx_audio_tpu/tts/models/llama/llama.py`): the port's `CausalLM` with
Orpheus's special tokens, generating through `snac_lm.SnacARModel`."""

from __future__ import annotations

from dataclasses import dataclass

from ....lm.transformer import LMConfig
from ..snac_lm import SnacARModel

__all__ = ["Model", "ModelConfig"]


@dataclass
class ModelConfig(LMConfig):
    model_type: str = "llama"
    tokenizer_name: str = "mlx-community/orpheus-3b-0.1-ft-bf16"
    sample_rate: int = 24000
    model_path: str = ""


class Model(SnacARModel):
    START_OF_HUMAN = 128259
    END_OF_TEXT = 128009
    END_OF_HUMAN = 128260
    START_OF_AI = 128261
    START_OF_SPEECH = 128257
    END_OF_SPEECH = 128258
    END_OF_AI = 128262
    AUDIO_TOKENS_START = 128266

    _tokenizer = None
    _codec = None

    def __init__(self, config: ModelConfig, device=None, seed: int = 0, **kwargs):
        if isinstance(config, dict):
            config = ModelConfig.from_dict(config)
        super().__init__(config, device=device, seed=seed)
