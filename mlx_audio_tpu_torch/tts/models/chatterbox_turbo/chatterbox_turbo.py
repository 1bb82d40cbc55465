"""Chatterbox-Turbo: a GPT-2 medium T3 and the meanflow-distilled S3Gen
(counterpart of `mlx_audio_tpu/tts/models/chatterbox_turbo/chatterbox_turbo.py`).

Against Chatterbox: a GPT-2 backbone (`lm.gpt2`) with learned positions in
place of Llama, no perceiver and no emotion conditioning, no CFG, and a
flow whose estimator is distilled to two meanflow steps. The decode is an
eager loop on the card over a compact float32 cache: the prompt [cond |
text | bos] is prefilled unpadded (the JAX package pads it to a multiple of
32 and masks the padding) and step s reads position T0 + s, as there. The
loop reads its done flag every `POLL_STEPS` steps; the streaming decode
hands back each chunk of tokens as it completes, the same tokens as one
decode.

`sample_rows` (shared with `TurboBatcher`) is the JAX package's order: the
repetition penalty over the last 128 tokens, 1/max(temp, 1e-5), top-k by
the k-th largest logit, top-p with its cutoff rule, then a Gumbel-max draw
from the row's `torch.Generator` (the JAX package's categorical draw from a
key), so sampled tokens match in distribution only; at temperature 0 it
takes the argmax. A request's seed seeds T3's generator and HiFT's; the
flow's noise is fixed (seed 42), as there. The S3TokenizerV2 comes from
`set_runtime` or the checkpoint's `s3tokenizer/` directory (the JAX package
downloads it; the port downloads nothing), the text tokenizer from
`set_runtime` or the checkpoint's `tokenizer.json` (the port's reader)."""

from __future__ import annotations

import logging
import re
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Generator, List, Optional

import numpy as np
import torch
from torch import nn

from ....codec.models.s3gen import S3_SR, S3GEN_SR, S3Token2Wav
from ....codec.models.s3tokenizer import (SPEECH_VOCAB_SIZE, S3TokenizerV2, log_mel_spectrogram,
                                          padding)
from ....device import resolve_device
from ....lm.cache import make_caches
from ....lm.generate import POLL_STEPS
from ....lm.gpt2 import GPT2Config, GPT2Model
from ....lm.sample import apply_repetition_penalty
from ....nn import Embedding, Linear
from ....nn.module import init_weights
from ..base import GenerationResult, format_duration
from ..chatterbox.chatterbox import Conditionals, punc_norm
from ..chatterbox.t3 import T3Cond
from ..chatterbox.voice_encoder import VoiceEncoder

__all__ = ["Model", "ModelConfig", "T3Turbo", "T3TurboConfig", "GPT2_MEDIUM_CONFIG",
           "sample_rows", "REP_HIST", "S3TOKENIZER_DIR"]

S3GEN_SIL = 4299  # the silence token appended before vocoding
REP_HIST = 128  # the repetition penalty's window
S3TOKENIZER_DIR = "s3tokenizer"

GPT2_MEDIUM_CONFIG = {
    "n_embd": 1024,
    "n_head": 16,
    "n_layer": 24,
    "n_positions": 8196,
    "vocab_size": 50276,
    "layer_norm_epsilon": 1e-05,
}


@dataclass
class T3TurboConfig:
    start_text_token: int = 255
    stop_text_token: int = 0
    text_tokens_dict_size: int = 50276
    max_text_tokens: int = 2048
    start_speech_token: int = 6561
    stop_speech_token: int = 6562
    speech_tokens_dict_size: int = 6563
    max_speech_tokens: int = 4096
    speech_cond_prompt_len: int = 375
    speaker_embed_size: int = 256
    use_perceiver_resampler: bool = False
    emotion_adv: bool = False
    encoder_type: str = "voice_encoder"
    input_pos_emb: Optional[str] = None
    gpt2_overrides: Optional[dict] = None

    @property
    def gpt2_config(self) -> dict:
        cfg = dict(GPT2_MEDIUM_CONFIG)
        if self.gpt2_overrides:
            cfg.update(self.gpt2_overrides)
        return cfg

    @property
    def n_channels(self) -> int:
        return self.gpt2_config["n_embd"]


def sample_rows(logits: torch.Tensor, generators: List[Optional[torch.Generator]], hist, temps,
                top_ks, top_ps, rep_pens, gumbel: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
    """The Turbo sampler over (B, V) logits → (B,): `hist` (B, W) the recent
    tokens, -1 padded; temps, top_ks, top_ps (B,) tensors, rep_pens one
    float or a (B,) tensor. A row at temperature 0, or with no generator,
    takes the argmax of the penalised logits. `gumbel` (B, V) replaces the
    generators' draws (the JAX package's are `jax.random.gumbel` of its
    key)."""
    V = logits.shape[-1]
    z = apply_repetition_penalty(logits.float(), hist, rep_pens)
    greedy = torch.argmax(z, dim=-1)
    rows = [b for b, g in enumerate(generators) if g is not None]
    if not rows and gumbel is None:
        return greedy
    x = z / temps.float().clamp(min=1e-5)[:, None]
    srt = torch.sort(x, dim=-1, descending=True).values
    k = top_ks.long()
    kth = torch.gather(srt, 1, (k.clamp(1, V) - 1)[:, None])
    x = torch.where(((k > 0) & (k < V))[:, None] & (x < kth), float("-inf"), x)
    probs = torch.softmax(x, dim=-1)
    psrt = torch.sort(probs, dim=-1, descending=True).values
    idx = (torch.cumsum(psrt, dim=-1) < top_ps[:, None]).sum(-1, keepdim=True).clamp(max=V - 1)
    cutoff = torch.gather(psrt, 1, idx)
    x = torch.where((top_ps[:, None] < 1.0) & (probs < cutoff), float("-inf"), x)
    if gumbel is None:
        e = torch.ones_like(x)
        for b in rows:
            e[b:b + 1].exponential_(generator=generators[b])
        gumbel = -torch.log(e)
    sampled = torch.argmax(x + gumbel.to(x.device), dim=-1)
    return torch.where(temps == 0, greedy, sampled)


class _TurboCondEnc(nn.Module):
    """The speaker embedding and the raw prompt speech: no perceiver, no
    emotion."""

    def __init__(self, hp: T3TurboConfig, device=None):
        super().__init__()
        self.hp = hp
        self.spkr_enc = Linear(hp.speaker_embed_size, hp.n_channels, device=device)

    def forward(self, cond: T3Cond) -> torch.Tensor:
        B = cond.speaker_emb.shape[0]
        parts = [self.spkr_enc(cond.speaker_emb.reshape(B, self.hp.speaker_embed_size))[:, None]]
        if cond.cond_prompt_speech_emb is not None:
            parts.append(cond.cond_prompt_speech_emb)
        return torch.cat(parts, dim=1)


class T3Turbo(nn.Module):
    """The GPT-2 medium speech-token LM on an explicit device (None: the
    card); the family's Model draws the weights."""

    def __init__(self, hp: Optional[T3TurboConfig] = None, device=None):
        super().__init__()
        hp = hp or T3TurboConfig()
        self.hp = hp
        self.cfg = GPT2Config(**{k: v for k, v in hp.gpt2_config.items()
                                 if k in GPT2Config.__dataclass_fields__})
        dev = resolve_device(device)
        self.tfmr = GPT2Model(self.cfg, device=dev)
        self.dim = self.cfg.n_embd
        self.cond_enc = _TurboCondEnc(hp, device=dev)
        self.text_emb = Embedding(hp.text_tokens_dict_size, self.dim, device=dev)
        self.speech_emb = Embedding(hp.speech_tokens_dict_size, self.dim, device=dev)
        self.text_head = Linear(self.dim, hp.text_tokens_dict_size, bias=False, device=dev)
        self.speech_head = Linear(self.dim, hp.speech_tokens_dict_size, bias=False, device=dev)

    @property
    def device(self) -> torch.device:
        return self.tfmr.ln_f.weight.device

    def prepare_input_embeds(self, t3_cond: T3Cond, text_tokens, speech_tokens) -> torch.Tensor:
        """[cond | text | speech] → (1, T0, D)."""
        dev = self.device
        text = torch.as_tensor(np.asarray(text_tokens), dtype=torch.long, device=dev)
        speech = torch.as_tensor(np.asarray(speech_tokens), dtype=torch.long, device=dev)
        return torch.cat([self.cond_enc(t3_cond), self.text_emb(text), self.speech_emb(speech)],
                         dim=1)

    def prefill_embeds(self, t3_cond: T3Cond, text_tokens) -> torch.Tensor:
        """The [cond | text | bos] prompt (1, T0, D)."""
        text_tokens = np.asarray(text_tokens)
        if text_tokens.ndim == 1:
            text_tokens = text_tokens[None]
        bos = np.full((1, 1), self.hp.start_speech_token, np.int64)
        return self.prepare_input_embeds(t3_cond, text_tokens, bos)

    @torch.inference_mode()
    def decode_chunks(self, embeds: torch.Tensor, max_gen_len: int, temperature: float,
                      top_k: int, top_p: float, repetition_penalty: float, seed: int,
                      chunk: Optional[int] = None, sampler=None):
        """The decode over a prompt (1, T0, D): yields (tokens before the stop
        (n,) on the host, is_final) each `chunk` steps (None: once, at the
        end). `sampler(penalised logits (1, V), generator) → (1,)` replaces
        the draw (the tests and the chip check replay tokens through it)."""
        dev = embeds.device
        stop = self.hp.stop_speech_token
        max_gen = min(max_gen_len, self.hp.max_speech_tokens)
        chunk = max(1, int(chunk)) if chunk else max_gen
        cfg = self.cfg
        T0 = embeds.shape[1]
        caches = make_caches(cfg.n_layer, 1, cfg.n_head, T0 + max_gen + 1,
                             cfg.n_embd // cfg.n_head, dtype=torch.float32, device=dev)
        hidden, _ = self.tfmr(embeds, caches)
        h_last = hidden[:, -1]
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        temps, top_ks, top_ps = (torch.tensor([p], device=dev) for p in (
            float(temperature), int(top_k), float(top_p)))
        hist = torch.full((1, REP_HIST), -1, dtype=torch.long, device=dev)
        out = torch.empty(max_gen, dtype=torch.long, device=dev)
        done = torch.zeros((), dtype=torch.bool, device=dev)
        done_at = torch.full((), max_gen, dtype=torch.long, device=dev)
        given = 0
        step = 0
        while step < max_gen:
            logits = self.speech_head(h_last).float()
            if sampler is not None:
                tok = sampler(apply_repetition_penalty(logits, hist, repetition_penalty), gen)
            else:
                tok = sample_rows(logits, [gen], hist, temps, top_ks, top_ps,
                                  repetition_penalty)
            out[step] = tok[0]
            newly = (tok[0] == stop) & ~done
            done_at = torch.where(newly, step, done_at)
            done = done | newly
            hist = torch.cat([hist[:, 1:], tok.reshape(1, 1)], dim=1)
            hidden, _ = self.tfmr(self.speech_emb(tok)[None].to(embeds.dtype), caches)
            h_last = hidden[:, -1]
            step += 1
            boundary = step % chunk == 0 or step == max_gen
            if (boundary or step % POLL_STEPS == 0) and bool(done):
                n = int(done_at)
                yield out[given:n].cpu().numpy(), True
                return
            if boundary:
                yield out[given:step].cpu().numpy(), step >= max_gen
                given = step

    def inference_turbo(self, t3_cond: T3Cond, text_tokens, temperature: float = 0.8,
                        top_k: int = 1000, top_p: float = 0.95,
                        repetition_penalty: float = 1.2, max_gen_len: int = 1000,
                        seed: Optional[int] = None) -> np.ndarray:
        """Speech tokens (1, n) before the stop."""
        with torch.inference_mode():
            embeds = self.prefill_embeds(t3_cond, text_tokens)
        if seed is None:
            seed = int(np.random.randint(0, 2 ** 31 - 1))
        toks = np.concatenate([t for t, _ in self.decode_chunks(
            embeds, max_gen_len, temperature, top_k, top_p, repetition_penalty, seed)])
        return toks[None]

    def inference_turbo_stream(self, t3_cond: T3Cond, text_tokens, temperature: float = 0.8,
                               top_k: int = 1000, top_p: float = 0.95,
                               repetition_penalty: float = 1.2, chunk_size: int = 40,
                               max_gen_len: int = 1000, seed: Optional[int] = None):
        """(new tokens, is_final) a chunk of `chunk_size` steps at a time; the
        tokens of one `inference_turbo` decode with the same seed."""
        with torch.inference_mode():
            embeds = self.prefill_embeds(t3_cond, text_tokens)
        if seed is None:
            seed = int(np.random.randint(0, 2 ** 31 - 1))
        yield from self.decode_chunks(embeds, max_gen_len, temperature, top_k, top_p,
                                      repetition_penalty, seed, chunk=chunk_size)

    def sanitize(self, weights: dict) -> dict:
        return {k.replace("tfmr.transformer.", "tfmr."): v for k, v in weights.items()}


def build_turbo_s3gen(device=None, seed: int = 0, sizes: Optional[dict] = None) -> S3Token2Wav:
    """S3Token2Wav with the meanflow estimator and two flow steps; `sizes`
    as S3Token2Wav's (small test models; None: the published widths)."""
    sizes = dict(sizes or {})
    sizes["estimator"] = {**sizes.get("estimator", {}), "meanflow": True}
    sizes["flow"] = {**sizes.get("flow", {}), "n_timesteps": 2}
    return S3Token2Wav(device=device, seed=seed, sizes=sizes)


@dataclass
class ModelConfig:
    model_type: str = "chatterbox_turbo"
    sample_rate: int = S3GEN_SR
    t3_config: Optional[T3TurboConfig] = None
    model_path: Optional[str] = None

    def __post_init__(self):
        if self.t3_config is None:
            self.t3_config = T3TurboConfig()

    @classmethod
    def from_dict(cls, config: dict) -> "ModelConfig":
        t3 = None
        if config.get("t3_config"):
            t3 = T3TurboConfig(**{k: v for k, v in config["t3_config"].items()
                                  if k in T3TurboConfig.__dataclass_fields__})
        return cls(model_type=config.get("model_type", "chatterbox_turbo"),
                   sample_rate=config.get("sample_rate", S3GEN_SR), t3_config=t3,
                   model_path=config.get("model_path"))


class Model(nn.Module):
    """Chatterbox-Turbo on an explicit device (None: the card), the weights
    drawn from `seed`; `s3gen_sizes` as S3Token2Wav's."""

    def __init__(self, config=None, device=None, seed: int = 0,
                 s3gen_sizes: Optional[dict] = None):
        super().__init__()
        if isinstance(config, dict):
            config = ModelConfig.from_dict(config)
        self.config = config or ModelConfig()
        self.sample_rate = self.config.sample_rate
        self.device = resolve_device(device)
        self.t3 = T3Turbo(self.config.t3_config, device=self.device)
        self.ve = VoiceEncoder(device=self.device)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        init_weights(self, gen)
        self.s3gen = build_turbo_s3gen(self.device, seed + 1, s3gen_sizes)
        self._conds: Optional[Conditionals] = None
        # host objects and the S3Tokenizer: a plain dict, so the tokenizer's
        # weights are neither this model's parameters nor in its state dict
        self._runtime: dict = {}

    def set_runtime(self, tokenizer=None, s3_tokenizer=None):
        if tokenizer is not None:
            self._runtime["tokenizer"] = tokenizer
        if s3_tokenizer is not None:
            self._runtime["s3_tokenizer"] = s3_tokenizer

    def make_batcher(self, **kwargs):
        """Serving batcher: concurrent requests' T3 decodes run in lock-step,
        one cache row a request; S3Gen stays per request."""
        from .batcher import TurboBatcher

        return TurboBatcher(self, **kwargs)

    def _prefill_embeds(self, ids) -> np.ndarray:
        """The (1, T0, D) [cond | text | bos] prompt on the host, for the
        batcher."""
        with torch.inference_mode():
            return self.t3.prefill_embeds(self._conds.t3, ids).float().cpu().numpy()

    def norm_loudness(self, wav: np.ndarray, sr: int, target_lufs: float = -27.0) -> np.ndarray:
        """The reference clip normalised to `target_lufs` (BS.1770)."""
        from ....dsp import normalize_loudness

        return np.asarray(normalize_loudness(wav, sr, target_lufs), np.float32)

    def _s3_tokenizer(self):
        rt = self._runtime
        if "s3_tokenizer" not in rt:
            mp = getattr(self.config, "model_path", None)
            local = Path(mp) / S3TOKENIZER_DIR if mp else None
            if local is None or not local.is_dir():
                raise RuntimeError(
                    "Chatterbox-Turbo needs an S3Tokenizer: pass one with "
                    "set_runtime(s3_tokenizer=...) or put its weights in the checkpoint's "
                    f"{S3TOKENIZER_DIR}/ directory (the port downloads nothing)")
            rt["s3_tokenizer"] = S3TokenizerV2.from_pretrained(
                "speech_tokenizer_v2_25hz", repo_id=str(local), device=self.device)
        return rt["s3_tokenizer"]

    @torch.inference_mode()
    def prepare_conditionals(self, ref_wav, sample_rate: Optional[int] = None,
                             exaggeration: float = 0.5, norm_loudness: bool = True,
                             **_) -> Conditionals:
        """A reference clip → T3's conditioning (the speaker embedding and
        the first 375 prompt tokens' embeddings) and S3Gen's prompt."""
        from ....utils import resample_audio

        ref_wav = np.asarray(ref_wav, np.float32).reshape(-1)
        sr = sample_rate or self.sample_rate
        wav_24 = ref_wav if sr == S3GEN_SR else resample_audio(ref_wav, sr, S3GEN_SR)
        if norm_loudness:
            wav_24 = self.norm_loudness(wav_24, S3GEN_SR)
        wav_24 = wav_24[: 10 * S3GEN_SR]
        wav_16 = resample_audio(wav_24, S3GEN_SR, S3_SR)
        mel, mel_len = padding([log_mel_spectrogram(wav_16, device=self.device)])
        tokens, _ = self._s3_tokenizer().quantize(mel, mel_len)
        gen_ref = self.s3gen.embed_ref(wav_24, S3GEN_SR, tokens)
        prompt = torch.as_tensor(tokens[:, : self.t3.hp.speech_cond_prompt_len],
                                 device=self.device)
        ve_embed = self.ve.embeds_from_wavs([wav_16], sample_rate=S3_SR)
        t3_cond = T3Cond(speaker_emb=ve_embed.mean(dim=0, keepdim=True),
                         cond_prompt_speech_tokens=prompt,
                         cond_prompt_speech_emb=self.t3.speech_emb(prompt), emotion_adv=None)
        self._conds = Conditionals(t3_cond, gen_ref)
        return self._conds

    def _tokenize_text(self, text: str) -> np.ndarray:
        """text → (1, n) ids between the start and stop text tokens: the
        tokenizer `set_runtime` set, else the checkpoint's `tokenizer.json`."""
        rt = self._runtime
        if "tokenizer" not in rt:
            mp = getattr(self.config, "model_path", None)
            if mp and (Path(mp) / "tokenizer.json").is_file():
                from ....tokenizer_json import load

                rt["tokenizer"] = load(mp)
        if "tokenizer" not in rt:
            raise RuntimeError("Text tokenizer not initialized — call set_runtime() or load via "
                               "load_model()")
        tok = rt["tokenizer"]
        raw = (tok.text_to_tokens(text) if hasattr(tok, "text_to_tokens")
               else tok.encode(text, add_special_tokens=False))
        ids = np.asarray(raw).reshape(1, -1)
        hp = self.t3.hp
        return np.concatenate([np.full((1, 1), hp.start_text_token), ids,
                               np.full((1, 1), hp.stop_text_token)], axis=1)

    @staticmethod
    def _split_text(text: str, split_pattern: Optional[str], max_tokens: int) -> list:
        """Sentences packed greedily so each chunk's speech stays under
        max_tokens (about 8 speech tokens a text token, 4 characters a text
        token)."""
        max_chars = (max_tokens // 8) * 4
        if not split_pattern:
            return [text]
        chunks, current = [], ""
        for sentence in re.split(split_pattern, text):
            sentence = sentence.strip()
            if not sentence:
                continue
            if current and len(current) + len(sentence) + 1 > max_chars:
                chunks.append(current)
                current = sentence
            else:
                current = f"{current} {sentence}" if current else sentence
        if current:
            chunks.append(current)
        return chunks or [text]

    def _filter_speech_tokens(self, tokens: np.ndarray, n_silence: int = 3) -> np.ndarray:
        """The tokens inside the codebook, then `n_silence` silence tokens."""
        tokens = np.asarray(tokens).reshape(-1)
        tokens = tokens[tokens < min(SPEECH_VOCAB_SIZE, self.t3.hp.start_speech_token)]
        if n_silence:
            tokens = np.concatenate([tokens, np.full(n_silence, S3GEN_SIL, tokens.dtype)])
        return tokens

    @torch.inference_mode()
    def tokens_to_mel(self, tokens: np.ndarray, noise=None) -> torch.Tensor:
        """Speech tokens → mel (1, 2n, 80) by the two-step meanflow solve."""
        g = self._conds.gen
        dev = self.device
        mels, _ = self.s3gen.flow.inference(
            token=torch.as_tensor(np.asarray(tokens)[None], dtype=torch.long, device=dev),
            token_len=torch.tensor([len(tokens)], device=dev),
            prompt_token=torch.as_tensor(g["prompt_token"], device=dev).long(),
            prompt_token_len=torch.as_tensor(g["prompt_token_len"], device=dev),
            prompt_feat=torch.as_tensor(g["prompt_feat"], device=dev),
            embedding=torch.as_tensor(g["embedding"], device=dev), n_timesteps=2,
            meanflow=True, noise=noise)
        return mels

    @torch.inference_mode()
    def _synthesize(self, tokens: np.ndarray, seed: int) -> np.ndarray:
        """Speech tokens → waveform: the meanflow flow, then HiFT."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        wav, _ = self.s3gen.hift_inference(self.tokens_to_mel(tokens), generator=gen)
        return wav.reshape(-1).float().cpu().numpy()

    @staticmethod
    def _warn_unsupported(cfg_weight: float, exaggeration: float, min_p: float) -> None:
        if cfg_weight > 0.0 or exaggeration > 0.0 or min_p > 0.0:
            logging.getLogger(__name__).warning(
                "CFG, min_p and exaggeration are not supported by the Turbo version and will be "
                "ignored.")

    def _result(self, wav, start, segment_idx, token_count, total_samples):
        elapsed = time.time() - start
        dur = len(wav) / self.sample_rate
        total_dur = total_samples / self.sample_rate
        return GenerationResult(
            audio=wav, samples=len(wav), sample_rate=self.sample_rate,
            segment_idx=segment_idx, token_count=token_count,
            audio_duration=format_duration(dur),
            real_time_factor=round(elapsed / max(total_dur, 1e-9), 2),
            prompt={"tokens": token_count},
            audio_samples={"samples-per-sec": round(total_samples / max(elapsed, 1e-9), 2)},
            processing_time_seconds=elapsed, peak_memory_usage=0.0)

    def _begin(self, ref_audio, sample_rate, exaggeration, norm_loudness, cfg_weight, min_p):
        if ref_audio is not None:
            self.prepare_conditionals(ref_audio, sample_rate, exaggeration=exaggeration,
                                      norm_loudness=norm_loudness)
        if self._conds is None:
            raise ValueError("prepare_conditionals first or pass ref_audio")
        self._warn_unsupported(cfg_weight, exaggeration, min_p)

    def generate(self, text: str, ref_audio=None, sample_rate: Optional[int] = None,
                 temperature: float = 0.8, top_k: int = 1000, top_p: float = 0.95,
                 repetition_penalty: float = 1.2, min_p: float = 0.0, exaggeration: float = 0.0,
                 cfg_weight: float = 0.0, norm_loudness: bool = True, stream: bool = False,
                 streaming_interval: float = 2.0,
                 split_pattern: Optional[str] = r"(?<=[.!?])\s+", max_tokens: int = 800,
                 seed: Optional[int] = None, **kwargs
                 ) -> Generator[GenerationResult, None, None]:
        """One GenerationResult a text chunk (chunk i's T3 and HiFT seeded
        `seed + i`), or with `stream` a result every `streaming_interval`
        seconds of tokens."""
        if stream:
            yield from self.stream_generate(
                text, ref_audio=ref_audio, sample_rate=sample_rate, temperature=temperature,
                top_k=top_k, top_p=top_p, repetition_penalty=repetition_penalty, min_p=min_p,
                exaggeration=exaggeration, cfg_weight=cfg_weight, norm_loudness=norm_loudness,
                chunk_size=max(10, int(streaming_interval * 25)), split_pattern=split_pattern,
                max_tokens=max_tokens, seed=seed)
            return
        from ....serving import get_infer_hook

        start = time.time()
        self._begin(ref_audio, sample_rate, exaggeration, norm_loudness, cfg_weight, min_p)
        text = punc_norm(text)
        if seed is None:
            seed = int(np.random.randint(0, 2 ** 31 - 1))
        total_samples = 0
        for segment_idx, chunk in enumerate(self._split_text(text, split_pattern, max_tokens)):
            ids = self._tokenize_text(chunk)
            sub = seed + segment_idx
            # under a running server a TurboBatcher may be installed:
            # concurrent requests' T3 decodes then run in lock-step
            hook = get_infer_hook(self)
            if hook is not None:
                tokens = hook.submit(self._prefill_embeds(ids), max_tokens=max_tokens,
                                     temperature=temperature, top_k=top_k, top_p=top_p,
                                     repetition_penalty=repetition_penalty,
                                     seed=sub).result()[None]
            else:
                tokens = self.t3.inference_turbo(
                    self._conds.t3, ids, temperature=temperature, top_k=top_k, top_p=top_p,
                    repetition_penalty=repetition_penalty, max_gen_len=max_tokens, seed=sub)
            tokens = self._filter_speech_tokens(tokens)
            if tokens.size <= 3:
                raise RuntimeError("T3 turbo produced no valid speech tokens")
            wav = self._synthesize(tokens, sub)
            total_samples += len(wav)
            yield self._result(wav, start, segment_idx, int(ids.shape[1]), total_samples)

    def stream_generate(self, text: str, ref_audio=None, sample_rate: Optional[int] = None,
                        temperature: float = 0.8, top_k: int = 1000, top_p: float = 0.95,
                        repetition_penalty: float = 1.2, min_p: float = 0.0,
                        exaggeration: float = 0.0, cfg_weight: float = 0.0,
                        norm_loudness: bool = True, chunk_size: int = 40,
                        split_pattern: Optional[str] = r"(?<=[.!?])\s+", max_tokens: int = 800,
                        seed: Optional[int] = None, **kwargs
                        ) -> Generator[GenerationResult, None, None]:
        """Every `chunk_size` new speech tokens the tokens so far are
        synthesized again and only the samples past what was given are
        yielded; HiFT's seed is held for a text chunk, so the prefix is the
        same each time."""
        from ....serving import get_infer_hook

        start = time.time()
        self._begin(ref_audio, sample_rate, exaggeration, norm_loudness, cfg_weight, min_p)
        text = punc_norm(text)
        if seed is None:
            seed = int(np.random.randint(0, 2 ** 31 - 1))
        segment_idx = 0
        global_samples = 0
        hook = get_infer_hook(self)
        for i, chunk in enumerate(self._split_text(text, split_pattern, max_tokens)):
            ids = self._tokenize_text(chunk)
            sub = seed + i
            acc = np.zeros(0, np.int64)
            prev_samples = 0
            if hook is not None:
                token_src = self._hook_stream_chunks(hook, ids, chunk_size, max_tokens,
                                                     temperature, top_k, top_p,
                                                     repetition_penalty, sub)
            else:
                token_src = self.t3.inference_turbo_stream(
                    self._conds.t3, ids, temperature=temperature, top_k=top_k, top_p=top_p,
                    repetition_penalty=repetition_penalty, chunk_size=chunk_size,
                    max_gen_len=max_tokens, seed=sub)
            for new_tokens, is_final in token_src:
                acc = np.concatenate([acc, np.asarray(new_tokens, np.int64)])
                tokens = self._filter_speech_tokens(acc, n_silence=5 if is_final else 0)
                if tokens.size == 0:
                    continue
                wav = self._synthesize(tokens, sub)
                if prev_samples < len(wav):
                    new_wav = wav[prev_samples:]
                    prev_samples = len(wav)
                    global_samples += len(new_wav)
                    yield self._result(new_wav, start, segment_idx, int(ids.shape[1]),
                                       global_samples)
                segment_idx += 1

    def _hook_stream_chunks(self, hook, ids, chunk_size, max_tokens, temperature, top_k, top_p,
                            repetition_penalty, seed):
        """(new tokens, is_final) chunks from an installed TurboBatcher: the
        contract of `T3Turbo.inference_turbo_stream`."""
        from ....serving import stream_chunks

        it = stream_chunks(hook.submit, self._prefill_embeds(ids), chunk_size=chunk_size,
                           callback_kw="on_frame", max_tokens=max_tokens,
                           temperature=temperature, top_k=top_k, top_p=top_p,
                           repetition_penalty=repetition_penalty, seed=seed)
        prev = None
        for c in it:
            if prev is not None:
                yield np.asarray(prev, np.int64), False
            prev = c
        yield (np.asarray(prev, np.int64) if prev is not None else np.zeros(0, np.int64)), True

    def sanitize(self, weights: dict) -> dict:
        """T3's key map under `t3.`; the flow's parts, which the release keeps
        at S3Gen's top level, nested under `s3gen.flow.`."""
        out = {}
        flow_parts = ("input_embedding.", "spk_embed_affine_layer.", "encoder.",
                      "encoder_proj.", "decoder.")
        for key, value in weights.items():
            k = key
            if k.startswith("t3."):
                k = "t3." + self.t3.sanitize({k[3:]: value}).popitem()[0]
            for part in flow_parts:
                if k.startswith(f"s3gen.{part}"):
                    k = f"s3gen.flow.{k[len('s3gen.'):]}"
                    break
            out[k] = value
        return out
