"""OuteTTS's prompt construction and audio-token extraction (a host copy of
`mlx_audio_tpu/tts/models/outetts/prompt_processor.py`): the c1/c2 maps
name codes 0..1024, 1025 of them, over the DAC's 1024-entry codebooks (the
DAC's decode clamps the last)."""

from __future__ import annotations

import re
from typing import List, Optional

from .tokens import SpecialTokens


class PromptProcessor:
    def __init__(self, tokenizer):
        self.special_tokens = SpecialTokens()
        self.tokenizer = tokenizer
        self.c1: dict = {}
        self.c2: dict = {}
        if tokenizer is not None:
            self._build_audio_token_map()
        self.input_prompt = "{bos}\n{text_start}{text}{text_end}\n{audio_start}\n"

    def _build_audio_token_map(self):
        for i in range(1025):
            ids1 = self.tokenizer.encode(
                self.special_tokens.c1.format(i), add_special_tokens=False
            )
            ids2 = self.tokenizer.encode(
                self.special_tokens.c2.format(i), add_special_tokens=False
            )
            if len(ids1) == 1:
                self.c1[ids1[0]] = i
            if len(ids2) == 1:
                self.c2[ids2[0]] = i

    # ---- prompt building ----

    @staticmethod
    def text_normalizations(text: str) -> str:
        text = re.sub(r"\s+", " ", text).replace("…", "...").strip()
        text = re.sub(r"[“”]", '"', text)
        text = re.sub(r"[‘’]", "'", text)
        text = re.sub(r"[–—]", "-", text)
        return re.sub(r"[\x00-\x1F\x7F-\x9F]", "", text)

    def _feature_tokens(self, f: dict) -> List[str]:
        feats = {
            "energy": f.get("energy", 0),
            "spectral_centroid": f.get("spectral_centroid", 0),
            "pitch": f.get("pitch", 0),
        }
        return [f"<|{k}_{v}|>" for k, v in feats.items()]

    def create_codes(self, words: List[dict]) -> str:
        st = self.special_tokens
        lines = []
        for w in words:
            body = (
                w["word"] + st.features + st.time.format(w["duration"])
                + "".join(self._feature_tokens(w.get("features", {})))
            )
            pairs = [
                st.c1.format(c1) + st.c2.format(c2)
                for c1, c2 in zip(w["c1"], w["c2"])
            ]
            body += st.code + "".join(pairs)
            lines.append(st.word_start + body + st.word_end)
        return "\n".join(lines)

    def _separator_for(self, text: str) -> str:
        if any("぀" <= c <= "ヿ" or "一" <= c <= "鿿" for c in text):
            return "。"
        return ". "

    def merge_speaker_text(self, input_text: str, speaker_text: str):
        speaker_text = speaker_text.strip()
        sep = self._separator_for(speaker_text)
        allowed = ["。", "？", "！", "?", "!"] if sep == "。" else [".", "?", "!"]
        rs = ""
        if speaker_text:
            if speaker_text[-1] not in allowed:
                rs = sep
            elif sep != "。":
                rs = " "
        return speaker_text + rs + input_text.strip(), rs.strip()

    def get_completion_prompt(self, text: str, speaker: Optional[dict] = None) -> str:
        st = self.special_tokens
        text = self.text_normalizations(text)
        codes = None
        if speaker is not None:
            text, sep = self.merge_speaker_text(text, speaker["text"])
            speaker = dict(speaker)
            speaker["words"] = [dict(w) for w in speaker["words"]]
            speaker["words"][-1]["word"] += sep
            codes = self.create_codes(speaker["words"])
        prompt = self.input_prompt.format(
            bos=st.bos, text_start=st.text_start, text=text,
            text_end=st.text_end, audio_start=st.audio_start,
        )
        if codes is not None:
            prompt += codes + "\n" + st.word_start
        return prompt

    # ---- output parsing ----

    def extract_audio_from_tokens(self, tokens: List[int]):
        cb1 = [self.c1[t] for t in tokens if t in self.c1]
        cb2 = [self.c2[t] for t in tokens if t in self.c2]
        t = min(len(cb1), len(cb2))
        return [cb1[:t], cb2[:t]]
