"""OuteTTS: a Llama (or Qwen) LM over interleaved c1/c2 DAC tokens, with
speaker profiles from reference audio (counterpart of
`mlx_audio_tpu/tts/models/outetts/outetts.py`). The backbone is the port's
`CausalLM`, decoded by `lm.generate`; the 24 kHz speech DAC (2 codebooks)
decodes the c1/c2 pairs.

Text goes in through the port's `tokenizer_json` reader on the checkpoint
directory's `tokenizer.json`, OuteTTS's added tokens included (the JAX
package builds `AutoTokenizer`); `set_runtime` may give a tokenizer
(anything with `encode(text, add_special_tokens=...)`) or a codec instead,
shared by every instance of the class, as in the JAX package. The DAC comes
from `set_runtime(codec=...)` or a `dac/` directory in the checkpoint; a hub
id for it, the tokenizer or a speaker raises (the port does not download).

Sampled tokens match the JAX package's in distribution only (Gumbel-max
from a `torch.Generator`, `lm/sample.py`); greedy ones are its tokens.
"""

from __future__ import annotations

import json
import logging
import re
import time
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from ....lm.generate import _default_model_call, _generate_chunks, generate_tokens
from ....lm.sample import make_sampler
from ....lm.transformer import CausalLM, LMConfig
from ....serving import get_infer_hook, stream_chunks
from ..base import GenerationResult, format_duration
from .prompt_processor import PromptProcessor

__all__ = ["Model", "ModelConfig"]

DAC_REPO = "mlx-community/dac-speech-24khz-1.5kbps"


@dataclass
class ModelConfig(LMConfig):
    tokenizer_name: str = "OuteAI/Llama-OuteTTS-1.0-1B"
    sample_rate: int = 24000
    model_path: str = ""


class Model(CausalLM):
    _tokenizer = None
    _codec = None
    _prompt_processor = None

    def __init__(self, config: ModelConfig, device=None, seed: int = 0, **kwargs):
        if isinstance(config, dict):
            config = ModelConfig.from_dict(config)
        super().__init__(config, device=device, seed=seed)

    @property
    def sample_rate(self) -> int:
        return self.config.sample_rate

    def make_batcher(self, **kwargs):
        """Serving batcher: OuteTTS is a token-prompt CausalLM, so concurrent
        requests' code decodes ride continuous (slot-based) batching; the DAC
        decode stays per request."""
        from ....serving import LMContinuousBatcher

        return LMContinuousBatcher(self, **kwargs)

    # ---- host-side pieces: the tokenizer, the codec, the prompts ----

    @property
    def tokenizer(self):
        """`set_runtime`'s tokenizer, else the reader of `tokenizer.json` in
        the config's `tokenizer_name` (a local directory) or the checkpoint
        directory; a hub id raises."""
        if Model._tokenizer is not None:
            return Model._tokenizer
        from ....tokenizer_json import load
        from ....utils import NO_DOWNLOAD

        for where in (self.config.tokenizer_name, self.config.model_path):
            if where and (Path(where) / "tokenizer.json").is_file():
                return load(Path(where) / "tokenizer.json")
        raise ValueError(NO_DOWNLOAD.format(self.config.tokenizer_name or "a tokenizer")
                         + " (or call set_runtime(tokenizer=...))")

    @property
    def codec(self):
        """`set_runtime`'s DAC, else the `dac/` directory of the checkpoint
        (the JAX package downloads DAC_REPO, whose hub id raises here)."""
        if Model._codec is None:
            from ....codec.models import DAC

            root = self.config.model_path
            where = Path(root or "") / "dac"
            Model._codec = DAC.from_pretrained(str(where) if root and where.is_dir()
                                               else DAC_REPO, device=self.device)
        return Model._codec

    @property
    def prompt_processor(self) -> PromptProcessor:
        tok = self.tokenizer
        if Model._prompt_processor is None or Model._prompt_processor.tokenizer is not tok:
            Model._prompt_processor = PromptProcessor(tok)
        return Model._prompt_processor

    def set_runtime(self, tokenizer=None, codec=None):
        if tokenizer is not None:
            Model._tokenizer = tokenizer
            Model._prompt_processor = PromptProcessor(tokenizer)
        if codec is not None:
            Model._codec = codec

    # ---- speakers ----

    def load_speaker(self, path: str) -> dict:
        return json.loads(Path(path).read_text())

    def get_speaker(self, voice: Optional[str], ref_audio=None,
                    ref_text: Optional[str] = None) -> Optional[dict]:
        """A speaker profile: `voice` as a local .json profile, else one made
        from `ref_audio` and `ref_text`, else none. Any other `voice` names a
        hosted default speaker, which the port does not download: it raises
        (the JAX package ignores it)."""
        if voice is not None and voice.endswith(".json"):
            return self.load_speaker(voice)
        if voice is not None:
            from ....utils import NO_DOWNLOAD

            raise ValueError(NO_DOWNLOAD.format(f"the speaker {voice!r}")
                             + " (or give a speaker .json, or ref_audio with ref_text)")
        if ref_audio is not None and ref_text is not None:
            return self.create_speaker(ref_audio, ref_text)
        return None

    def _codes_of(self, wav: np.ndarray) -> np.ndarray:
        """The DAC's codes (n_q, T) of a mono waveform, on the host."""
        _, codes, _, _, _ = self.codec.encode(np.asarray(wav, np.float32).reshape(1, 1, -1))
        return np.asarray(torch.as_tensor(codes).cpu())[0]

    def create_speaker(self, ref_audio, ref_text: str) -> dict:
        """A speaker profile from reference audio: DAC-encode it and split the
        codes evenly across the transcript's words (the alignment-free
        approximation; `create_speaker_from_whisper` aligns)."""
        from ....utils import load_audio

        if isinstance(ref_audio, str):
            ref_audio = load_audio(ref_audio, sample_rate=self.sample_rate)
        codes = self._codes_of(ref_audio)  # c1, c2 rows
        words = [w for w in ref_text.split() if w]
        T = codes.shape[1]
        wav = np.asarray(ref_audio, np.float32).reshape(-1)
        spw = len(wav) / max(len(words), 1)
        dur = spw / self.sample_rate
        out_words = []
        for i, w in enumerate(words):
            lo = i * T // len(words)
            hi = (i + 1) * T // len(words)
            seg = wav[int(i * spw): int((i + 1) * spw)]
            out_words.append({
                "word": w, "duration": round(dur, 2),
                "features": self.extract_audio_features(seg, self.sample_rate),
                "c1": codes[0, lo:hi].tolist(),
                "c2": codes[1, lo:hi].tolist(),
            })
        return {"text": ref_text, "words": out_words,
                "global_features": self.extract_audio_features(wav, self.sample_rate)}

    # ---- audio features for speaker prompts ----

    @staticmethod
    def calculate_pitch(audio: np.ndarray, sr: int, min_freq: float = 75.0,
                        max_freq: float = 600.0, frame_length: int = 400,
                        hop_length: int = 160, threshold: float = 0.3) -> np.ndarray:
        """Per-frame pitch by FFT autocorrelation with parabolic peak
        interpolation and a voicing threshold, vectorised over frames."""
        x = np.asarray(audio, np.float32)
        if x.ndim > 1:
            x = x.mean(axis=0)
        x = np.squeeze(x)
        pad = (frame_length - (x.shape[-1] % hop_length)) % hop_length
        x = np.pad(x, (0, pad))
        n_frames = (len(x) - frame_length) // hop_length + 1
        if n_frames <= 0:
            return np.zeros((0,), np.float32)
        frames = np.lib.stride_tricks.sliding_window_view(
            x, frame_length)[::hop_length][:n_frames]
        frames = frames * np.hanning(frame_length)

        fft = np.fft.rfft(frames, n=2 * frame_length, axis=1)
        autocorr = np.fft.irfft(fft.real ** 2 + fft.imag ** 2, axis=1)[:, :frame_length]

        min_idx = max(1, int(sr / max_freq))
        max_idx = min(frame_length, int(sr / min_freq))
        peak_idx = autocorr[:, min_idx:max_idx].argmax(axis=1) + min_idx
        peak_val = np.take_along_axis(autocorr, peak_idx[:, None], axis=1)[:, 0]

        idx = np.clip(peak_idx, 1, frame_length - 2)
        alpha = np.take_along_axis(autocorr, idx[:, None] - 1, axis=1)[:, 0]
        beta = np.take_along_axis(autocorr, idx[:, None], axis=1)[:, 0]
        gamma = np.take_along_axis(autocorr, idx[:, None] + 1, axis=1)[:, 0]
        delta = 0.5 * (alpha - gamma) / (alpha - 2 * beta + gamma + 1e-8)
        delta = np.where((peak_idx > 0) & (peak_idx < frame_length - 1), delta, 0.0)

        period = (peak_idx + delta) / sr
        pitch = np.where(period > 0, 1.0 / np.maximum(period, 1e-12), 0.0)
        voiced = peak_val / (autocorr[:, 0] + 1e-8) > threshold
        return np.clip(np.where(voiced, pitch, 0.0), min_freq, max_freq).astype(np.float32)

    @classmethod
    def extract_audio_features(cls, audio, sr: int) -> dict:
        """{energy, spectral_centroid, pitch}, each scaled to 0-100, for the
        speaker prompt's feature tokens."""
        x = np.asarray(audio, np.float32)
        if x.size == 0 or not np.isfinite(x).all():
            return {"energy": 0, "spectral_centroid": 0, "pitch": 0}
        if x.ndim == 2 and x.shape[0] > 1:
            x = x.mean(axis=0, keepdims=True)
        energy = float(np.sqrt(np.mean(x ** 2)))
        spec = np.abs(np.fft.rfft(x))
        freqs = np.linspace(0, sr / 2, spec.shape[-1])
        centroid = float(np.sum(freqs * spec.squeeze()) / (np.sum(spec) + 1e-10) / (sr / 2))
        pitches = cls.calculate_pitch(x, sr)
        avg = float(pitches.mean()) if pitches.size else 0.0
        pitch = min(max((avg - 75.0) / (600.0 - 75.0), 0.0), 1.0)
        return {name: round(min(max(v, 0.0), 1.0) * 100)
                for name, v in (("energy", energy), ("spectral_centroid", centroid),
                                ("pitch", pitch))}

    def save_speaker(self, speaker: dict, path: str) -> None:
        """A speaker profile as JSON; `~` expands, directories are made."""
        import os

        path = os.path.expanduser(path)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        Path(path).write_text(json.dumps(speaker))

    def create_speaker_from_dict(self, data: dict) -> dict:
        """A speaker profile from `{"audio": {"bytes"|array}, "text", "words":
        [{word, start, end}]}` with real word timings: DAC codes split at the
        word boundaries at 75 tokens/s, 20 tokens more at the clip's edges."""
        from ....stt.models.base import ensure_waveform

        audio = data["audio"]
        if isinstance(audio, dict):
            audio = audio.get("bytes", audio.get("array"))
        audio = ensure_waveform(audio, self.sample_rate)
        codes = self._codes_of(audio)
        c1, c2 = codes[0], codes[1]

        tps = 75
        max_extension = 20
        words = data["words"]
        out_words = []
        start = None
        for idx, w in enumerate(words):
            if start is None:
                start = max(0, int(w["start"] * tps) - max_extension)
            if idx == len(words) - 1:
                end = min(len(c1), int(w["end"] * tps) + max_extension)
            else:
                end = int(w["end"] * tps)
            seg = audio[int(w["start"] * self.sample_rate): int(w["end"] * self.sample_rate)]
            out_words.append({
                "word": w["word"].strip(),
                "duration": round((end - start) / tps, 2),
                "features": self.extract_audio_features(seg, self.sample_rate),
                "c1": c1[start:end].tolist(),
                "c2": c2[start:end].tolist(),
            })
            start = end
        return {"text": data["text"], "words": out_words,
                "global_features": self.extract_audio_features(audio, self.sample_rate)}

    def create_speaker_from_whisper(self, audio, stt_model) -> dict:
        """Transcribe the reference clip with word timestamps (`stt_model`: a
        loaded STT model whose `generate(..., word_timestamps=True)` gives
        segments with words, the port's Whisper) and build the profile from
        that alignment; without words, split evenly."""
        from ....stt.models.base import ensure_waveform
        from ....utils import resample_audio

        wav = ensure_waveform(audio, self.sample_rate)
        if len(wav) / self.sample_rate > 15:
            logging.getLogger(__name__).warning(
                "Speaker audio is longer than 15 seconds; for best results "
                "use a clip up to 15 seconds.")
        wav16 = resample_audio(np.asarray(wav, np.float32), self.sample_rate, 16000)
        result = stt_model.generate(wav16, word_timestamps=True)
        words = []
        for seg in result.segments or []:
            for w in seg.get("words", []):
                words.append({"word": str(w["word"]).strip(), "start": float(w["start"]),
                              "end": float(w["end"])})
        if not words:
            return self.create_speaker(wav, result.text)
        return self.create_speaker_from_dict({"audio": wav, "text": result.text,
                                              "words": words})

    # ---- generation ----

    def chunk_text(self, text: str, max_words: int = 30) -> List[str]:
        sentences = [s.strip() for s in re.split(r"[.!?。！？︕︖]+", text) if s.strip()]
        chunks, cur, n = [], [], 0
        for s in sentences:
            words = s.split()
            if n + len(words) > max_words and cur:
                chunks.append(" ".join(cur))
                cur, n = [], 0
            cur.extend(words)
            n += len(words)
        if cur:
            chunks.append(" ".join(cur))
        return chunks

    def _decode_tokens_to_audio(self, token_ids) -> Optional[np.ndarray]:
        cb = self.prompt_processor.extract_audio_from_tokens([int(t) for t in token_ids])
        if not cb[0]:
            return None
        audio = self.codec.decode_codes(torch.as_tensor([cb], dtype=torch.long))
        return torch.as_tensor(audio).float().cpu().numpy().reshape(-1)

    def _result(self, audio, t0, segment_idx, token_count, prompt_tokens):
        elapsed = time.perf_counter() - t0
        dur = len(audio) / self.sample_rate
        return GenerationResult(
            audio=audio, samples=len(audio), sample_rate=self.sample_rate,
            segment_idx=segment_idx, token_count=token_count,
            audio_duration=format_duration(dur),
            real_time_factor=round(elapsed / dur, 3) if dur else 0.0,
            prompt={"tokens": prompt_tokens,
                    "tokens-per-sec": round(prompt_tokens / elapsed, 2)},
            audio_samples={"samples": len(audio),
                           "samples-per-sec": round(len(audio) / elapsed, 2)},
            processing_time_seconds=elapsed, peak_memory_usage=0.0)

    @torch.inference_mode()
    def generate(self, text: str, voice: Optional[str] = None, temperature: float = 0.4,
                 top_p: float = 0.9, split_pattern: Optional[str] = None,
                 max_tokens: int = 1200, ref_audio=None, ref_text: Optional[str] = None,
                 stream: bool = False, streaming_interval: float = 2.0,
                 verbose: bool = False, **kwargs):
        """One GenerationResult a text chunk. Sampler defaults min_p 0.05,
        top_k 40, repetition penalty 1.1 over 64 tokens (kwargs override).
        stream=True re-decodes the growing code
        prefix every `streaming_interval` seconds of tokens (137.5 tokens a
        second) and yields only the new samples."""
        speaker = self.get_speaker(voice, ref_audio, ref_text)
        pp = self.prompt_processor
        eos = self.tokenizer.encode(pp.special_tokens.audio_end, add_special_tokens=False)
        eos_ids = tuple(eos[:1]) if eos else ()
        top_k, min_p = kwargs.get("top_k", 40), kwargs.get("min_p", 0.05)
        sampler = make_sampler(temperature, top_p, top_k=top_k, min_p=min_p)
        rep_p = kwargs.get("repetition_penalty", 1.1)
        rep_ctx = kwargs.get("repetition_context_size", 64)
        sampling = dict(max_tokens=max_tokens, temp=temperature, top_p=top_p, top_k=top_k,
                        min_p=min_p, repetition_penalty=rep_p,
                        repetition_context_size=rep_ctx, eos_ids=eos_ids)
        # under a running server an LMContinuousBatcher may be installed:
        # concurrent requests then decode in lock-step
        hook = get_infer_hook(self)

        if split_pattern:
            chunks = [c for c in re.split(split_pattern, text) if c.strip()]
        else:
            chunks = self.chunk_text(text)
        for segment_idx, chunk in enumerate(chunks):
            t0 = time.perf_counter()
            prompt = pp.get_completion_prompt(chunk, speaker)
            ids = [int(t) for t in self.tokenizer.encode(prompt, add_special_tokens=False)]
            if not stream:
                if hook is not None:
                    out = hook.submit(ids, **sampling).result()
                    toks, n = np.asarray([out], np.int64), len(out)
                else:
                    toks, n = generate_tokens(self, ids, max_tokens=max_tokens, sampler=sampler,
                                              repetition_penalty=rep_p,
                                              repetition_context_size=rep_ctx,
                                              eos_token_ids=eos_ids)
                if verbose:
                    print(f"[outetts] segment {segment_idx}: {n} tokens")
                audio = self._decode_tokens_to_audio(toks[0])
                if audio is None:
                    continue
                yield self._result(audio, t0, segment_idx, n, len(ids))
                continue

            interval_tokens = max(1, int(streaming_interval * 137.5))
            if hook is not None:
                # each token comes through `on_token` as its tick completes,
                # regrouped into interval_tokens chunks, so the prefix
                # re-decode below is the single stream's
                token_src = stream_chunks(hook.submit, ids, chunk_size=interval_tokens,
                                          callback_kw="on_token", **sampling)
            else:
                token_src = ([int(t) for t in toks_chunk[0]]
                             for toks_chunk, _meta in _generate_chunks(
                                 self, ids, max_tokens, sampler, 0.0, 1.0, 0, rep_p, rep_ctx,
                                 eos_ids, None, 0, _default_model_call,
                                 chunk_size=interval_tokens))
            acc: list = []
            yielded_samples = yielded_tokens = 0
            for tok_chunk in token_src:
                acc.extend(tok_chunk)
                audio = self._decode_tokens_to_audio(acc)
                if audio is None or len(audio) <= yielded_samples:
                    continue
                yield self._result(audio[yielded_samples:], t0, segment_idx,
                                   len(acc) - yielded_tokens, len(ids))
                yielded_samples = len(audio)
                yielded_tokens = len(acc)
                t0 = time.perf_counter()

    def sanitize(self, weights: dict) -> dict:
        # checkpoints may or may not carry the `model.` prefix
        out = {}
        for k, v in weights.items():
            if not k.startswith(("model.", "lm_head.")):
                k = "model." + k
            out[k] = v
        return out
