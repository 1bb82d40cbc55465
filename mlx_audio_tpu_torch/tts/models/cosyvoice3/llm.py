"""CosyVoice3's speech-token LM (counterpart of
`mlx_audio_tpu/tts/models/cosyvoice3/llm.py`).

CosyVoice2's LM (`cosyvoice2.llm.Qwen2LM`: the same Qwen2 backbone, the
eager decode loop and `ras_sample`) with one unified `speech_embedding`
holding the speech tokens and 200 extended ones (sos V, eos V + 1, task
V + 2, fill V + 3), an `llm_decoder` without bias over all of them, and the
stop on any token ≥ V. The prompt's sos and task rows are read through the
embedding's call, so they clamp as the JAX gather does."""

from __future__ import annotations

from typing import Optional

import torch

from ....nn import Embedding, Linear
from ..cosyvoice2.llm import Qwen2LM
from .config import LLMConfig as CV3LLMConfig

__all__ = ["CosyVoice3LM"]


class CosyVoice3LM(Qwen2LM):
    V3 = True  # any token ≥ V stops

    def __init__(self, config: Optional[CV3LLMConfig] = None, device=None):
        config = config or CV3LLMConfig()
        super().__init__(config, device=device)
        V = config.speech_token_size
        self.extended_vocab_size = config.extended_vocab_size
        self.sos, self.eos_token, self.task_id, self.fill_token = V, V + 1, V + 2, V + 3

    def _build_tables(self, config, dev) -> None:
        n_vocab = config.speech_token_size + config.extended_vocab_size
        self.llm_decoder = Linear(config.llm_output_size, n_vocab, bias=False, device=dev)
        self.speech_embedding = Embedding(n_vocab, config.llm_input_size, device=dev)
        self.n_out = n_vocab

    def build_prompt_embeds(self, text, prompt_text=None, prompt_speech_token=None
                            ) -> torch.Tensor:
        """[sos, prompt_text + text, task_id, prompt_speech] → (1, T0, D), sos
        and task from the unified speech embedding."""
        text_part, *speech = self._text_and_speech(text, prompt_text, prompt_speech_token)
        sos = self.speech_embedding(self._ids([self.sos]))
        task = self.speech_embedding(self._ids([self.task_id]))
        return torch.cat([sos, text_part, task] + speech, dim=1)
