"""Chatterbox TTS: the T3 speech-token LM, S3Gen (flow and HiFT) and the
voice encoder (counterpart of
`mlx_audio_tpu/tts/models/chatterbox/chatterbox.py`).

The reference clip gives T3 its speaker embedding (the voice encoder) and
its prompt tokens (S3TokenizerV2 on the first 6 s at 16 kHz), and S3Gen
its prompt mel, tokens and x-vector (the first 10 s at 24 kHz). T3's CFG
decode runs on the card (`T3.decode`), through an installed `T3Batcher`
where there is one; S3Gen turns its tokens into 24 kHz audio.

The S3Tokenizer comes from `set_runtime(s3_tokenizer=...)` or from the
checkpoint's `s3tokenizer/` directory; with neither, `prepare_conditionals`
raises (the JAX package downloads `mlx-community/S3TokenizerV2`, and the
port downloads nothing). The request's seed draws T3's samples and HiFT's
source; the flow's noise is fixed (seed 42), as there."""

from __future__ import annotations

import time
from dataclasses import dataclass
from pathlib import Path
from typing import Generator, Optional

import numpy as np
import torch
from torch import nn

from ....codec.models.s3gen import S3_SR, S3GEN_SR, S3Token2Wav
from ....codec.models.s3tokenizer import (SPEECH_VOCAB_SIZE, S3TokenizerV2, log_mel_spectrogram,
                                          padding)
from ....device import resolve_device
from ....nn.module import init_weights
from ..base import GenerationResult, format_duration
from .config import ModelConfig
from .t3 import T3, T3Cond
from .tokenizer import EnTokenizer, MTLTokenizer
from .voice_encoder import VoiceEncoder

__all__ = ["Model", "Conditionals", "punc_norm", "drop_invalid_tokens", "sanitize_weights",
           "S3TOKENIZER_DIR"]

S3TOKENIZER_DIR = "s3tokenizer"  # the S3Tokenizer's weights inside a checkpoint


def punc_norm(text: str) -> str:
    """Clean up punctuation the way the reference does."""
    if len(text) == 0:
        return "You need to add some text for me to talk."
    if text[0].islower():
        text = text[0].upper() + text[1:]
    text = " ".join(text.split())
    for old, new in [("...", ", "), ("…", ", "), (":", ","), (" - ", ", "), (";", ", "),
                     ("—", "-"), ("–", "-"), (" ,", ","), ("“", '"'), ("”", '"'),
                     ("‘", "'"), ("’", "'")]:
        text = text.replace(old, new)
    text = text.rstrip(" ")
    if not any(text.endswith(p) for p in {".", "!", "?", "-", ","}):
        text += "."
    return text


def drop_invalid_tokens(x, sos: int = SPEECH_VOCAB_SIZE,
                        eos: int = SPEECH_VOCAB_SIZE + 1) -> np.ndarray:
    """The tokens after the first SOS and before the first EOS, less any
    at or above SOS."""
    x = np.asarray(x).reshape(-1)
    s = int(np.argmax(x == sos)) + 1 if (x == sos).any() else 0
    e = int(np.argmax(x == eos)) if (x == eos).any() else len(x)
    x = x[s:e]
    return x[x < sos]


@dataclass
class Conditionals:
    """T3's and S3Gen's conditioning."""

    t3: T3Cond
    gen: dict


class Model(nn.Module):
    """Chatterbox on an explicit device (None: the card), the weights drawn
    from `seed`."""

    def __init__(self, config: Optional[ModelConfig] = None, device=None, seed: int = 0,
                 s3gen_sizes: Optional[dict] = None):
        super().__init__()
        if isinstance(config, dict):
            config = ModelConfig.from_dict(config)
        self.config = config or ModelConfig()
        self.device = resolve_device(device)
        self.sample_rate = S3GEN_SR
        self.t3 = T3(self.config.t3_config, device=self.device)
        self.ve = VoiceEncoder(device=self.device)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        init_weights(self, gen)
        self.s3gen = S3Token2Wav(device=self.device, seed=seed + 1, sizes=s3gen_sizes)
        self.conds: Optional[Conditionals] = None
        # host objects and the S3Tokenizer: a plain dict, so the tokenizer's
        # weights are neither this model's parameters nor in its state dict
        self._runtime: dict = {}

    # ------------------------------------------------------------------
    def set_runtime(self, tokenizer=None, mtl_tokenizer=None, s3_tokenizer=None):
        rt = self._runtime
        if tokenizer is not None:
            rt["tokenizer"] = tokenizer
        if mtl_tokenizer is not None:
            rt["mtl_tokenizer"] = mtl_tokenizer
        if s3_tokenizer is not None:
            rt["s3_tokenizer"] = s3_tokenizer

    def _s3_tokenizer(self):
        """The S3Tokenizer set by `set_runtime`, else the checkpoint's
        `s3tokenizer/` directory; else this raises."""
        rt = self._runtime
        if "s3_tokenizer" not in rt:
            mp = getattr(self.config, "model_path", None)
            local = Path(mp) / S3TOKENIZER_DIR if mp else None
            if local is None or not local.is_dir():
                raise RuntimeError(
                    "Chatterbox needs an S3Tokenizer: pass one with "
                    "set_runtime(s3_tokenizer=S3TokenizerV2.from_pretrained(repo_id=<dir>)) or "
                    f"put its weights in the checkpoint's {S3TOKENIZER_DIR}/ directory (the "
                    "port downloads nothing)")
            rt["s3_tokenizer"] = S3TokenizerV2.from_pretrained(
                "speech_tokenizer_v2_25hz", repo_id=str(local), device=self.device)
        return rt["s3_tokenizer"]

    def post_load_hook(self, model_path):
        """Attach the tokenizer found beside the weights."""
        tok = Path(model_path) / "tokenizer.json"
        if tok.exists():
            try:
                self.set_runtime(tokenizer=EnTokenizer(tok))
            except Exception:  # a multilingual vocabulary
                self.set_runtime(mtl_tokenizer=MTLTokenizer(tok))
        return self

    def make_batcher(self, **kwargs):
        """Serving batcher: concurrent requests' T3 CFG decodes run in
        lock-step, each slot a cond/uncond cache-row pair; the conditioning
        and S3Gen stay per request."""
        from .batcher import T3Batcher

        return T3Batcher(self, **kwargs)

    # ------------------------------------------------------------------
    @torch.inference_mode()
    def prepare_conditionals(self, ref_wav, ref_sr: int,
                             exaggeration: float = 0.5) -> Conditionals:
        """A reference clip → T3's and S3Gen's conditioning."""
        from ....utils import resample_audio

        ref_wav = np.asarray(ref_wav, np.float32).reshape(-1)
        wav_24 = ref_wav if ref_sr == S3GEN_SR else resample_audio(ref_wav, ref_sr, S3GEN_SR)
        wav_24 = wav_24[: self.config.dec_cond_len]
        wav_16_from_24 = resample_audio(wav_24, S3GEN_SR, S3_SR)
        wav_16_full = ref_wav if ref_sr == S3_SR else resample_audio(ref_wav, ref_sr, S3_SR)
        wav_16 = wav_16_full[: self.config.enc_cond_len]

        s3tok = self._s3_tokenizer()
        mel, mel_len = padding([log_mel_spectrogram(wav_16_from_24, device=self.device)])
        s3gen_tokens, _ = s3tok.quantize(mel, mel_len)
        gen_ref = self.s3gen.embed_ref(wav_24, S3GEN_SR, s3gen_tokens)

        t3_mel, t3_mel_len = padding([log_mel_spectrogram(wav_16, device=self.device)])
        t3_tokens, _ = s3tok.quantize(t3_mel, t3_mel_len)
        t3_tokens = t3_tokens[:, : self.t3.hp.speech_cond_prompt_len]

        ve_embed = self.ve.embeds_from_wavs([wav_16_full], sample_rate=S3_SR)
        t3_cond = T3Cond(
            speaker_emb=ve_embed.mean(dim=0, keepdim=True),
            cond_prompt_speech_tokens=torch.as_tensor(t3_tokens, device=self.device),
            emotion_adv=torch.full((1, 1, 1), float(exaggeration), device=self.device))
        return Conditionals(t3_cond, gen_ref)

    def text_ids(self, text: str, lang_code: str = "en") -> np.ndarray:
        """[start] + the tokenizer's ids of the normalised text + [stop] →
        (1, n)."""
        text = punc_norm(text)
        rt = self._runtime
        if lang_code == "en" and "tokenizer" in rt:
            toks = rt["tokenizer"].text_to_tokens(text)
        elif "mtl_tokenizer" in rt:
            toks = rt["mtl_tokenizer"].text_to_tokens(text, language_id=lang_code)
        else:
            raise RuntimeError("Text tokenizer not initialized — call set_runtime() or "
                               "post_load_hook().")
        hp = self.t3.hp
        return np.concatenate([[[hp.start_text_token]], np.asarray(toks).reshape(1, -1),
                               [[hp.stop_text_token]]], axis=1)

    # ------------------------------------------------------------------
    @torch.inference_mode()
    def generate(self, text: str, ref_audio=None, audio_prompt=None,
                 audio_prompt_sr: Optional[int] = None, conds: Optional[Conditionals] = None,
                 exaggeration: float = 0.1, cfg_weight: float = 0.5, temperature: float = 0.8,
                 repetition_penalty: float = 1.2, min_p: float = 0.05, top_p: float = 1.0,
                 max_new_tokens: int = 1000, lang_code: str = "en", seed: Optional[int] = None,
                 max_tokens: Optional[int] = None,
                 **kwargs) -> Generator[GenerationResult, None, None]:
        """One GenerationResult. `max_tokens` aliases max_new_tokens;
        `voice`, `speed` and `stream` are accepted and ignored, as there."""
        from ....serving import get_infer_hook

        start = time.time()
        if max_tokens is not None and max_new_tokens == 1000:
            max_new_tokens = max_tokens
        if audio_prompt is None and ref_audio is not None:
            audio_prompt = ref_audio
            audio_prompt_sr = audio_prompt_sr or self.sample_rate
        if conds is None:
            if audio_prompt is not None:
                conds = self.prepare_conditionals(audio_prompt, audio_prompt_sr, exaggeration)
            elif self.conds is not None:
                conds = self.conds
            else:
                raise ValueError("Reference audio is required for Chatterbox voice cloning.")

        ids = self.text_ids(text, lang_code)
        token_count = ids.shape[1] - 2
        if seed is None:
            seed = int(np.random.randint(0, 2 ** 31 - 1))
        # under a running server a T3Batcher may be installed: concurrent
        # requests' CFG decodes then run in lock-step (paired cache rows)
        hook = get_infer_hook(self)
        if hook is not None:
            embeds = self.t3.build_prefill_embeds(conds.t3, ids, cfg_on=True)
            toks = hook.submit(embeds.float().cpu().numpy(), max_tokens=max_new_tokens,
                               temperature=temperature, top_p=top_p, min_p=min_p,
                               repetition_penalty=repetition_penalty, cfg_weight=cfg_weight,
                               seed=seed).result()
            speech_tokens = np.asarray(toks, np.int64)[None]
        else:
            speech_tokens = self.t3.inference(
                t3_cond=conds.t3, text_tokens=ids, max_new_tokens=max_new_tokens,
                temperature=temperature, cfg_weight=cfg_weight,
                repetition_penalty=repetition_penalty, min_p=min_p, top_p=top_p, seed=seed)

        tokens = drop_invalid_tokens(speech_tokens, sos=self.t3.hp.start_speech_token,
                                     eos=self.t3.hp.stop_speech_token)
        if tokens.size == 0:
            raise RuntimeError("T3 produced no valid speech tokens")
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        wav = self.s3gen(tokens[None], ref_dict=conds.gen, finalize=True, generator=gen)
        wav = wav.reshape(-1).float().cpu().numpy()

        elapsed = time.time() - start
        dur = len(wav) / self.sample_rate
        yield GenerationResult(
            audio=wav, samples=len(wav), sample_rate=self.sample_rate, segment_idx=0,
            token_count=token_count, audio_duration=format_duration(dur),
            real_time_factor=round(elapsed / max(dur, 1e-9), 2),
            prompt={"tokens": token_count,
                    "tokens-per-sec": round(token_count / max(elapsed, 1e-9), 2)},
            audio_samples={"samples": len(wav),
                           "samples-per-sec": round(len(wav) / max(elapsed, 1e-9), 2)},
            processing_time_seconds=elapsed, peak_memory_usage=0.0)

    def sanitize(self, weights: dict) -> dict:
        return sanitize_weights(weights)


def sanitize_weights(weights: dict) -> dict:
    """Split by component prefix: T3's and the voice encoder's own key maps,
    S3Gen's keys as they are (the JAX package's). Needs no model: the
    family's `convert` calls it directly."""
    t3_w, ve_w, gen_w, out = {}, {}, {}, {}
    for key, value in weights.items():
        if key.startswith("t3."):
            t3_w[key[3:]] = value
        elif key.startswith("ve."):
            ve_w[key[3:]] = value
        elif key.startswith("s3gen."):
            gen_w[key[6:]] = value
        else:
            out[key] = value
    out.update({f"t3.{k}": v for k, v in T3.sanitize(None, t3_w).items()})
    out.update({f"ve.{k}": v for k, v in VoiceEncoder.sanitize(None, ve_w).items()})
    out.update({f"s3gen.{k}": v for k, v in gen_w.items()})
    return out
