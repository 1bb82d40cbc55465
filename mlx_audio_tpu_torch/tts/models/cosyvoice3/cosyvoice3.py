"""CosyVoice3: the Qwen2 speech-token LM, the DiT flow and the causal HiFT
(counterpart of `mlx_audio_tpu/tts/models/cosyvoice3/cosyvoice3.py`).

The modes are CosyVoice2's (`cosyvoice2.CosyVoice2`, whose pipeline this
model keeps): zero-shot (the transcript behind the system prompt),
cross-lingual (the text itself behind it), instruct and voice conversion,
and streaming with the DiT's static chunk mask. Long text is split into
sentence groups by the JAX package's frontend, copied here
(`normalize_text`, `split_text`). The LM stops on any token ≥ V; the
`RASBatcher` takes CosyVoice3's stop rule. The S3TokenizerV3 comes from
`set_runtime` or the checkpoint's `s3tokenizer/` directory, CAM++ from its
`campplus.*` keys (the port downloads nothing); a chunk's seed seeds each
stage's own `torch.Generator`."""

from __future__ import annotations

import re
import time
import unicodedata
from pathlib import Path
from typing import List, Optional

import numpy as np

from ....device import resolve_device
from ..cosyvoice2.cosyvoice2 import CosyVoice2
from ..cosyvoice2.cosyvoice2 import Model as CosyVoice2Model
from .config import CosyVoice3Config, ModelConfig
from .flow import build_flow_model
from .hifigan import CausalHiFTGenerator
from .llm import CosyVoice3LM

__all__ = ["CosyVoice3", "Model", "build_cosyvoice3", "normalize_text", "split_text"]

SILENT_TOKENS = {1, 2, 28, 29, 55, 248, 494, 2241, 2242, 2322, 2323}
MAX_PROMPT_AUDIO_SECONDS = 30
SYSTEM_PROMPT = "You are a helpful assistant."
END_OF_PROMPT = "<|endofprompt|>"
ZERO_SHOT_PROMPT_PREFIX = f"{SYSTEM_PROMPT}{END_OF_PROMPT}"
INSTRUCT_PROMPT_PREFIX = f"{SYSTEM_PROMPT} "


# ----------------------------------------------------------------------
# the text frontend (the JAX package's, copied)
def _contains_chinese(text: str) -> bool:
    return any("一" <= c <= "鿿" for c in text)


def _is_only_punctuation(text: str) -> bool:
    t = text.strip()
    if not t:
        return True
    return all(unicodedata.category(c)[0] in {"P", "S"} for c in t)


def _replace_blank(text: str) -> str:
    out = []
    for i, c in enumerate(text):
        if c != " ":
            out.append(c)
            continue
        if i == 0 or i == len(text) - 1:
            continue
        p, n = text[i - 1], text[i + 1]
        if p.isascii() and p != " " and n.isascii() and n != " ":
            out.append(c)
    return "".join(out)


def _replace_corner_mark(text: str) -> str:
    return text.replace("²", "平方").replace("³", "立方")


def _remove_bracket(text: str) -> str:
    return (text.replace("（", "").replace("）", "").replace("【", "")
            .replace("】", "").replace("`", "").replace("——", " "))


_ONES = ["zero", "one", "two", "three", "four", "five", "six", "seven",
         "eight", "nine", "ten", "eleven", "twelve", "thirteen", "fourteen",
         "fifteen", "sixteen", "seventeen", "eighteen", "nineteen"]
_TENS = ["", "", "twenty", "thirty", "forty", "fifty", "sixty", "seventy",
         "eighty", "ninety"]
_SCALE = [(10**9, "billion"), (10**6, "million"), (10**3, "thousand"),
          (100, "hundred")]


def _num_to_words(n: int) -> str:
    """Small English number speller (stand-in for num2words,
    reference cosyvoice3.py:110-130)."""
    if n < 20:
        return _ONES[n]
    if n < 100:
        t, r = divmod(n, 10)
        return _TENS[t] + (f"-{_ONES[r]}" if r else "")
    for base, name in _SCALE:
        if n >= base:
            q, r = divmod(n, base)
            head = f"{_num_to_words(q)} {name}"
            return head + (f" {_num_to_words(r)}" if r else "")
    return str(n)


def _spell_out_number(text: str) -> str:
    return re.sub(r"\d+", lambda m: _num_to_words(int(m.group())), text)


def normalize_text(text: str) -> str:
    """Lightweight normalization (reference cosyvoice3.py:1101-1127)."""
    t = text.strip()
    if not t:
        return t
    if "<|" in t and "|>" in t:
        return t
    if _contains_chinese(t):
        t = t.replace("\n", "")
        t = _replace_blank(t)
        t = _replace_corner_mark(t)
        t = t.replace(".", "。").replace(" - ", "，")
        t = _remove_bracket(t)
        return re.sub(r"[，,、]+$", "。", t)
    return _spell_out_number(t)


def split_text(text: str, tokenize=None) -> List[str]:
    """Sentence-group splitting (reference cosyvoice3.py:1128-1191)."""
    t = normalize_text(text)
    if not t:
        return []
    if "<|" in t and "|>" in t:
        return [t]
    is_zh = _contains_chinese(t)
    punc = ({"。", "？", "！", "；", "：", "、", ".", "?", "!", ";"}
            if is_zh else {".", "?", "!", ";", ":"})
    if t[-1] not in punc:
        t += "。" if is_zh else "."
    utts, start = [], 0
    for i, c in enumerate(t):
        if c not in punc:
            continue
        end = i + 1
        if end < len(t) and t[end] in {'"', "”"}:
            end += 1
        if t[start:end].strip():
            utts.append(t[start:end])
        start = end

    def length(v: str) -> int:
        if not v:
            return 0
        if is_zh or tokenize is None:
            return len(v)
        return len(tokenize(v))

    chunks: List[str] = []
    cur = ""
    for u in utts:
        if length(cur + u) > 80 and length(cur) > 60:
            if not _is_only_punctuation(cur):
                chunks.append(cur)
            cur = ""
        cur += u
    if cur:
        if length(cur) < 20 and chunks:
            chunks[-1] += cur
        elif not _is_only_punctuation(cur):
            chunks.append(cur)
    return chunks or [t]


def build_cosyvoice3(config: CosyVoice3Config, device=None) -> "CosyVoice3":
    """The three stages from a CosyVoice3Config, on `device` (None: the
    card); their weights are drawn by the caller."""
    dev = resolve_device(device)
    f, d, h = config.flow, config.flow.dit, config.hifigan
    flow = build_flow_model(
        input_size=f.input_size, output_size=f.output_size, spk_embed_dim=f.spk_embed_dim,
        vocab_size=f.vocab_size, input_frame_rate=f.input_frame_rate,
        token_mel_ratio=f.token_mel_ratio, pre_lookahead_len=f.pre_lookahead_len,
        dit_dim=d.dim, dit_depth=d.depth, dit_heads=d.heads, dit_dim_head=d.dim_head,
        dit_ff_mult=d.ff_mult, cfm_sigma_min=f.cfm_sigma_min,
        cfm_t_scheduler=f.cfm_t_scheduler, cfm_inference_cfg_rate=f.cfm_inference_cfg_rate,
        n_timesteps=f.n_timesteps, static_chunk_size=d.static_chunk_size, device=dev)
    hifigan = CausalHiFTGenerator(
        in_channels=h.in_channels, base_channels=h.base_channels, nb_harmonics=h.nb_harmonics,
        sampling_rate=h.sampling_rate, nsf_alpha=h.nsf_alpha, nsf_sigma=h.nsf_sigma,
        nsf_voiced_threshold=h.nsf_voiced_threshold, upsample_rates=list(h.upsample_rates),
        upsample_kernel_sizes=list(h.upsample_kernel_sizes),
        istft_params={"n_fft": h.istft_n_fft, "hop_len": h.istft_hop_len},
        resblock_kernel_sizes=list(h.resblock_kernel_sizes),
        resblock_dilation_sizes=[list(x) for x in h.resblock_dilation_sizes],
        source_resblock_kernel_sizes=list(h.source_resblock_kernel_sizes),
        source_resblock_dilation_sizes=[list(x) for x in h.source_resblock_dilation_sizes],
        conv_pre_look_right=h.conv_pre_look_right, device=dev)
    return CosyVoice3(config, CosyVoice3LM(config.llm, device=dev), flow, hifigan)


class CosyVoice3(CosyVoice2):
    """CosyVoice2's pipeline over CosyVoice3's LM, flow and vocoder; its
    stream chunks 25 tokens, and its batcher stops on any token ≥ V."""

    STREAM_CHUNK = 25

    def __init__(self, config: Optional[CosyVoice3Config] = None, llm=None, flow=None,
                 hifigan=None):
        super().__init__(config or CosyVoice3Config(), llm, flow, hifigan)

    @property
    def sample_rate(self) -> int:
        return self.config.hifigan.sampling_rate

    def make_batcher(self, **kwargs):
        from ..cosyvoice2.batcher import RASBatcher

        return RASBatcher(self, lm=self.llm, v3=True, **kwargs)


class Model(CosyVoice2Model):
    """The `generate` wrapper on an explicit device (None: the card), the
    weights drawn from `seed`."""

    FAMILY = "CosyVoice3"

    def __init__(self, config=None, device=None, seed: int = 0):
        if isinstance(config, dict):
            config = ModelConfig.from_dict(config)
        super().__init__(config or ModelConfig(), device=device, seed=seed)

    PROMPT_MEL = dict(fmax=12000.0)  # the prompt mel up to Nyquist

    def _build(self, device):
        return build_cosyvoice3(self.config.cosyvoice3 or CosyVoice3Config(), device)

    def prompt_text(self, ref_text: str) -> str:
        """The transcript normalised, behind the system prompt."""
        rt = normalize_text(ref_text)
        return rt if rt.startswith(ZERO_SHOT_PROMPT_PREFIX) else ZERO_SHOT_PROMPT_PREFIX + rt

    def prompt(self, ref_audio):
        """`reference`, the tokens cut to half the prompt mel's frames where
        it is shorter, the mel to twice the tokens."""
        tokens, prompt_mel, embedding = self.reference(ref_audio)
        n = min(int(tokens.shape[1]), prompt_mel.shape[1] // 2)
        return np.asarray(tokens)[:, :n], prompt_mel[:, : 2 * n], embedding

    def _tokenizer(self, mp: Path):
        from ....tokenizer_json import load
        from .special_tokens import COSYVOICE3_TOKENIZER_SPECIAL_TOKENS as SPECIAL

        tok_dir = mp / "tokenizer"
        return load(tok_dir if tok_dir.is_dir() else mp).with_added_tokens(
            [SPECIAL["eos_token"]] + list(SPECIAL["additional_special_tokens"]))

    def _s3_tokenizer(self, mp: Optional[Path]):
        from ....codec.models.s3tokenizer import S3TokenizerV3

        return S3TokenizerV3.from_pretrained(repo_id=str(mp), device=self.device)

    def generate(self, text: str, ref_audio=None, ref_text: Optional[str] = None,
                 instruct_text: Optional[str] = None, source_audio=None, max_tokens: int = 2000,
                 stream: bool = False, seed: int = 0, split_long_text: bool = True, **kwargs):
        """Zero-shot, cross-lingual, instruct or voice conversion, one result
        a sentence group; ref_audio 16 kHz mono, at most 30 s. Chunk i runs
        with seed `seed + i`."""
        from ..base import GenerationResult

        if ref_audio is None:
            raise ValueError("ref_audio is required for CosyVoice3")
        tokenizer = self._runtime_part("tokenizer")
        ref_audio = np.asarray(ref_audio, np.float32).reshape(-1)
        if len(ref_audio) > MAX_PROMPT_AUDIO_SECONDS * 16000:
            raise ValueError("CosyVoice3 reference audio longer than 30 s is not supported")
        prompt_speech_token, prompt_mel, embedding = self.prompt(ref_audio)

        def tok(s: str) -> np.ndarray:
            return np.asarray(tokenizer.encode(s), np.int32)

        chunks = [text] if not split_long_text or source_audio is not None else split_text(
            text, tokenize=tokenizer.encode)
        m = self.model
        for idx, chunk in enumerate(chunks):
            start = time.time()
            sub = seed + idx
            if source_audio is not None:
                audio = m.synthesize_vc(self.source_tokens(source_audio), prompt_speech_token,
                                        prompt_mel, embedding, seed=sub)
                n_text = 0
            elif instruct_text is not None:
                it = instruct_text
                if not it.startswith(INSTRUCT_PROMPT_PREFIX):
                    it = INSTRUCT_PROMPT_PREFIX + it
                if not it.endswith(END_OF_PROMPT):
                    it += END_OF_PROMPT
                text_ids = tok(chunk)
                audio = m.synthesize_instruct(text_ids, tok(it), prompt_speech_token,
                                              prompt_mel, embedding, seed=sub)
                n_text = text_ids.size
            elif ref_text:
                text_ids = tok(chunk)
                audio = m.synthesize(text_ids, tok(self.prompt_text(ref_text)),
                                     prompt_speech_token, prompt_mel, embedding, seed=sub)
                n_text = text_ids.size
            else:
                c = (chunk if chunk.startswith(ZERO_SHOT_PROMPT_PREFIX)
                     else ZERO_SHOT_PROMPT_PREFIX + chunk)
                text_ids = tok(c)
                audio = m.synthesize_cross_lingual(text_ids, prompt_speech_token, prompt_mel,
                                                   embedding, seed=sub)
                n_text = text_ids.size
            audio = np.asarray(audio).reshape(-1)
            elapsed = time.time() - start
            dur = len(audio) / self.sample_rate
            mins, secs = divmod(dur, 60.0)
            yield GenerationResult(
                audio=audio, samples=len(audio), sample_rate=self.sample_rate,
                segment_idx=idx, token_count=int(n_text),
                audio_duration=f"{int(mins):02d}:{secs:06.3f}",
                real_time_factor=elapsed / max(dur, 1e-9), prompt={"tokens": int(n_text)},
                audio_samples={"samples-per-sec": len(audio) / max(elapsed, 1e-9)},
                processing_time_seconds=elapsed, peak_memory_usage=0.0)
