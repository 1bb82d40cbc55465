"""Chatterbox's text tokenizers (counterpart of
`mlx_audio_tpu/tts/models/chatterbox/tokenizer.py`), on the port's
`tokenizer.json` reader instead of `tokenizers`.

EnTokenizer writes spaces as `[SPACE]` before encoding and back on decode;
MTLTokenizer puts a `[lang]` prefix in front. The per-language
normalizers are optional there (pykakasi); here Japanese text goes through
unconverted where pykakasi is missing, as there."""

from __future__ import annotations

import logging
from typing import Optional

import numpy as np

from ....tokenizer_json import load

logger = logging.getLogger(__name__)

SOT = "[START]"
EOT = "[STOP]"
UNK = "[UNK]"
SPACE = "[SPACE]"
SPECIAL_TOKENS = [SOT, EOT, UNK, SPACE, "[PAD]", "[SEP]", "[CLS]", "[MASK]"]

__all__ = ["EnTokenizer", "MTLTokenizer", "SOT", "EOT", "UNK", "SPACE"]


class EnTokenizer:
    """The English tokenizer of a `tokenizer.json`."""

    def __init__(self, vocab_file_path):
        self.tokenizer = load(vocab_file_path)
        if self.tokenizer.token_to_id(SOT) is None or self.tokenizer.token_to_id(EOT) is None:
            raise ValueError(f"{vocab_file_path}: no {SOT} or {EOT} token")

    def text_to_tokens(self, text: str) -> np.ndarray:
        return self.encode(text)

    def encode(self, txt: str) -> np.ndarray:
        return np.asarray([self.tokenizer.encode(txt.replace(" ", SPACE))], np.int32)

    def decode(self, seq) -> str:
        txt = self.tokenizer.decode([int(i) for i in np.asarray(seq).reshape(-1)],
                                    skip_special_tokens=False)
        txt = txt.replace(" ", "").replace(SPACE, " ")
        return txt.replace(EOT, "").replace(UNK, "")


class MTLTokenizer(EnTokenizer):
    """The multilingual variant: a `[lang]text` prefix."""

    def text_to_tokens(self, text: str, language_id: Optional[str] = None) -> np.ndarray:
        return self.encode(text, language_id=language_id)

    def encode(self, txt: str, language_id: Optional[str] = None) -> np.ndarray:
        if language_id:
            txt = f"[{language_id}]{self._normalize(txt, language_id)}"
        return super().encode(txt)

    @staticmethod
    def _normalize(txt: str, language_id: str) -> str:
        if language_id == "ja":
            try:
                import pykakasi

                kakasi = pykakasi.kakasi()
                txt = "".join(item["hira"] for item in kakasi.convert(txt))
            except ImportError:
                logger.debug("pykakasi unavailable; skipping kana conversion")
        return txt
