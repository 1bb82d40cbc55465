"""Kokoro language pipeline: G2P, 510-phoneme chunking, voice packs,
timestamps. Contract of reference tts/models/kokoro/pipeline.py:47-460.

Host-only; a copy of `mlx_audio_tpu/tts/models/kokoro/pipeline.py`, its
serving hook included (`infer` routes through an installed KokoroBatcher),
kept here so that the port imports nothing of the JAX package. A voice is read from
`<repo_id>/voices/` (the checkpoint directory's, through
`config.model_path`); a voice that is not there raises, since the port
does not download."""

from __future__ import annotations

import logging
import re
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Generator, List, Optional, Tuple, Union

import numpy as np
import torch

from ....nn.sanitize import as_float32
from ....safetensors_io import load_file
from ....serving import get_infer_hook
from ....utils import NO_DOWNLOAD
from .g2p import PhonemeToken, get_g2p

logger = logging.getLogger(__name__)

ALIASES = {
    "en": "a", "en-us": "a", "en-gb": "b", "es": "e", "fr-fr": "f", "fr": "f",
    "hi": "h", "it": "i", "pt-br": "p", "pt": "p", "ja": "j", "zh": "z",
}

LANG_CODES = dict(
    a="American English", b="British English", e="es", f="fr-fr", h="hi",
    i="it", p="pt-br", j="Japanese", z="Mandarin Chinese",
)


def load_voice_tensor(path: str) -> np.ndarray:
    """Load a voice pack (.safetensors `voice` tensor, or .npz/.npy/.pt)."""
    p = Path(path)
    if p.suffix == ".safetensors":
        w = load_file(p)
        v = w.get("voice", next(iter(w.values())))
        return as_float32(v) if isinstance(v, torch.Tensor) else np.array(v)
    if p.suffix == ".npz":
        with np.load(str(p)) as data:
            return np.asarray(data[data.files[0]])
    if p.suffix == ".npy":
        return np.load(str(p))
    if p.suffix in (".pt", ".pth", ".bin"):
        t = torch.load(str(p), map_location="cpu", weights_only=True)
        if isinstance(t, dict):
            t = next(iter(t.values()))
        return t.numpy()
    raise ValueError(f"Unknown voice pack format: {p.suffix}")


class KokoroPipeline:
    def __init__(self, lang_code: str, model, repo_id: str, trf: bool = False):
        lang_code = ALIASES.get(lang_code.lower(), lang_code.lower())
        assert lang_code in LANG_CODES, (lang_code, LANG_CODES)
        self.lang_code = lang_code
        self.repo_id = repo_id
        if repo_id is None:
            raise ValueError("repo_id is required to load voices")
        self.model = model
        self.voices: dict = {}
        self.g2p = get_g2p(lang_code)

    # ---- voices ----

    def load_single_voice(self, voice: str) -> np.ndarray:
        if voice in self.voices:
            return self.voices[voice]
        if voice.endswith((".safetensors", ".npz", ".npy", ".pt")):
            f = voice
        else:
            local = Path(self.repo_id) / "voices"
            cand = None
            if local.is_dir():
                for ext in (".safetensors", ".npz", ".npy", ".pt", ".bin"):
                    if (local / f"{voice}{ext}").exists():
                        cand = local / f"{voice}{ext}"
                        break
            if cand is None:
                raise ValueError(
                    f"voice {voice!r} is not in {local}: "
                    + NO_DOWNLOAD.format(f"{self.repo_id}/voices/{voice}.safetensors"))
            f = str(cand)
        pack = load_voice_tensor(f)
        self.voices[voice] = pack
        return pack

    def load_voice(self, voice: str, delimiter: str = ",") -> np.ndarray:
        if voice in self.voices:
            return self.voices[voice]
        packs = [self.load_single_voice(v) for v in voice.split(delimiter)]
        if len(packs) == 1:
            return packs[0]
        self.voices[voice] = np.mean(np.stack(packs), axis=0)
        return self.voices[voice]

    # ---- chunking ----

    @classmethod
    def tokens_to_ps(cls, tokens: List[PhonemeToken]) -> str:
        return "".join(
            (t.phonemes or "") + (" " if t.whitespace else "") for t in tokens
        ).strip()

    @classmethod
    def tokens_to_text(cls, tokens: List[PhonemeToken]) -> str:
        return "".join(t.text + t.whitespace for t in tokens).strip()

    @classmethod
    def waterfall_last(cls, tokens, next_count, waterfall=("!.?…", ":;", ",—"),
                       bumps=(")", "”")) -> int:
        for w in waterfall:
            z = next(
                (i for i, t in reversed(list(enumerate(tokens)))
                 if t.phonemes in set(w)),
                None,
            )
            if z is None:
                continue
            z += 1
            if z < len(tokens) and tokens[z].phonemes in bumps:
                z += 1
            if next_count - len(cls.tokens_to_ps(tokens[:z])) <= 510:
                return z
        return len(tokens)

    def en_tokenize(self, tokens: List[PhonemeToken]):
        tks: List[PhonemeToken] = []
        pcount = 0
        for t in tokens:
            t.phonemes = "" if t.phonemes is None else t.phonemes.replace("ɾ", "T")
            next_ps = t.phonemes + (" " if t.whitespace else "")
            next_pcount = pcount + len(next_ps.rstrip())
            if next_pcount > 510:
                z = self.waterfall_last(tks, next_pcount)
                text = self.tokens_to_text(tks[:z])
                ps = self.tokens_to_ps(tks[:z])
                yield text, ps, tks[:z]
                tks = tks[z:]
                pcount = len(self.tokens_to_ps(tks))
                if not tks:
                    next_ps = next_ps.lstrip()
            tks.append(t)
            pcount += len(next_ps)
        if tks:
            yield self.tokens_to_text(tks), self.tokens_to_ps(tks), tks

    # ---- timestamps ----

    @classmethod
    def join_timestamps(cls, tokens: List[PhonemeToken], pred_dur: np.ndarray):
        # 2 half-frames per frame @ 40 fps → divisor 80 (reference :327)
        MAGIC_DIVISOR = 80
        if not tokens or len(pred_dur) < 3:
            return
        left = right = 2 * int(pred_dur[0])  # <bos> half-frames
        i = 1
        for t in tokens:
            if i >= len(pred_dur) - 1:
                break
            if not t.phonemes:
                if t.whitespace:
                    i += 1
                    left = right = right + int(pred_dur[i]) if i < len(pred_dur) else right
                continue
            j = i + len(t.phonemes)
            if j >= len(pred_dur):
                break
            t.start_ts = left / MAGIC_DIVISOR
            token_dur = int(pred_dur[i:j].sum())
            space_dur = int(pred_dur[j]) if t.whitespace else 0
            left = right + (2 * token_dur) + space_dur
            t.end_ts = left / MAGIC_DIVISOR
            right = left + space_dur
            i = j + (1 if t.whitespace else 0)

    # ---- inference ----

    @classmethod
    def infer(cls, model, ps: str, pack: np.ndarray, speed: float = 1.0):
        ref_s = pack[len(ps) - 1]
        # under a running server a KokoroBatcher may be installed for this
        # model: concurrent requests then share one frontend and synthesis
        hook = get_infer_hook(model)
        if hook is not None:
            return hook(ps, ref_s, speed)
        return model(ps, ref_s, speed, return_output=True)

    @dataclass
    class Result:
        graphemes: str
        phonemes: str
        tokens: Optional[List[PhonemeToken]] = None
        output: Optional[Any] = None
        text_index: Optional[int] = None

        @property
        def audio(self):
            return None if self.output is None else self.output.audio

        @property
        def pred_dur(self):
            return None if self.output is None else self.output.pred_dur

        def __iter__(self):
            yield self.graphemes
            yield self.phonemes
            yield self.audio

        def __getitem__(self, index):
            return [self.graphemes, self.phonemes, self.audio][index]

        def __len__(self):
            return 3

    def generate_from_tokens(self, tokens, voice: str, speed: float = 1.0,
                             model=None):
        """Synthesize from raw phonemes (str) or pre-processed
        PhonemeTokens, bypassing G2P (reference pipeline.py:268-320)."""
        model = model or self.model
        if model and voice is None:
            raise ValueError(
                "Specify a voice: pipeline.generate_from_tokens(..., "
                'voice="af_heart")')
        pack = self.load_voice(voice) if model else None

        if isinstance(tokens, str):
            if len(tokens) > 510:
                raise ValueError(
                    f"Phoneme string too long: {len(tokens)} > 510")
            output = self.infer(model, tokens, pack, speed) if model else None
            yield self.Result(graphemes="", phonemes=tokens, output=output)
            return

        for gs, ps, tks in self.en_tokenize(tokens):
            if not ps:
                continue
            if len(ps) > 510:
                logger.warning(f"len(ps)=={len(ps)} > 510; truncating")
                ps = ps[:510]
            output = self.infer(model, ps, pack, speed) if model else None
            if output is not None and output.pred_dur is not None:
                self.join_timestamps(tks, output.pred_dur)
            yield self.Result(graphemes=gs, phonemes=ps, tokens=tks,
                              output=output)

    def __call__(self, text: Union[str, List[str]], voice: Optional[str] = None,
                 speed: float = 1.0, split_pattern: Optional[str] = r"\n+"):
        if voice is None:
            raise ValueError("Specify a voice, e.g. voice='af_heart'")
        pack = self.load_voice(voice) if self.model else None
        if isinstance(text, str):
            text = re.split(split_pattern, text.strip()) if split_pattern else [text]
        for text_index, graphemes in enumerate(text):
            if not graphemes.strip():
                continue
            _, tokens = self.g2p(graphemes)
            for gs, ps, tks in self.en_tokenize(tokens):
                if not ps:
                    continue
                if len(ps) > 510:
                    logger.warning(f"len(ps)=={len(ps)} > 510; truncating")
                    ps = ps[:510]
                output = self.infer(self.model, ps, pack, speed) if self.model else None
                if output is not None and output.pred_dur is not None:
                    self.join_timestamps(tks, output.pred_dur)
                yield self.Result(
                    graphemes=gs, phonemes=ps, tokens=tks, output=output,
                    text_index=text_index,
                )
