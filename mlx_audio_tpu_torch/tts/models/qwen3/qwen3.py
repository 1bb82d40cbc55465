"""VyvoTTS, a Qwen3 AR over 7-token SNAC frames (counterpart of
`mlx_audio_tpu/tts/models/qwen3/qwen3.py`): Orpheus's frame pattern with the
Qwen3 tokenizer's special-token block."""

from __future__ import annotations

from dataclasses import dataclass

from ....lm.transformer import LMConfig
from ..snac_lm import SnacARModel

__all__ = ["Model", "ModelConfig"]

TOKENIZER_LENGTH = 151669


@dataclass
class ModelConfig(LMConfig):
    model_type: str = "qwen3"
    tokenizer_name: str = None
    sample_rate: int = 24000
    model_path: str = ""


class Model(SnacARModel):
    START_OF_TEXT = 151643
    END_OF_TEXT = 151645
    START_OF_SPEECH = TOKENIZER_LENGTH + 1
    END_OF_SPEECH = TOKENIZER_LENGTH + 2
    START_OF_HUMAN = TOKENIZER_LENGTH + 3
    END_OF_HUMAN = TOKENIZER_LENGTH + 4
    START_OF_AI = TOKENIZER_LENGTH + 5
    END_OF_AI = TOKENIZER_LENGTH + 6
    PAD_TOKEN = TOKENIZER_LENGTH + 7
    AUDIO_TOKENS_START = TOKENIZER_LENGTH + 10

    _tokenizer = None
    _codec = None

    def __init__(self, config: ModelConfig, device=None, seed: int = 0, **kwargs):
        if isinstance(config, dict):
            config = ModelConfig.from_dict(config)
        super().__init__(config, device=device, seed=seed)

    @classmethod
    def post_load_hook(cls, model, model_path):
        # the tokenizer lives beside the checkpoint
        model.config.tokenizer_name = model.config.tokenizer_name or str(model_path)
        return model
