"""Shared base of the SNAC-token AR TTS models, Orpheus and VyvoTTS
(counterpart of `mlx_audio_tpu/tts/models/snac_lm.py`): an LLM generates
flat 7-token SNAC frames (layer 1, 2, 3, 3, 2, 3, 3, each slot with its own
codebook offset), and the 24 kHz SNAC codec decodes them.

Text goes in through the port's `tokenizer_json` reader on the checkpoint
directory's `tokenizer.json` (where the JAX package builds `AutoTokenizer`);
`set_runtime` may give a tokenizer (anything with `encode`) or a codec
instead, shared by every instance of the class, as in the JAX package. The
codec is not downloaded: give it with `set_runtime(codec=...)` or load it
from a local directory with `SNAC.from_pretrained`.

`generate` takes one of three routes, as in the JAX package: `generate_tokens`
(the whole segment, then one codec decode), `stream_generate` with
`decode_audio_stream` (audio every `streaming_interval` seconds of frames,
decoded with code context), or the installed serving hook
(`make_batcher`, `serving.LMContinuousBatcher`).
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from ...lm.generate import generate_tokens, stream_generate
from ...lm.transformer import CausalLM
from ...serving import get_infer_hook
from .base import GenerationResult, format_duration

__all__ = ["SnacARModel", "codes_to_layers", "layers_to_codes"]


def codes_to_layers(code_list: List[int], codebook_size: int = 4096) -> List[torch.Tensor]:
    """A flat 7-a-frame code list → the 3 SNAC layers, (1, n), (1, 2n),
    (1, 4n) int64 on the host."""
    n = (len(code_list) + 1) // 7
    l1, l2, l3 = [], [], []
    for i in range(n):
        c = code_list[7 * i: 7 * i + 7]
        l1.append(c[0])
        l2.append(c[1] - codebook_size)
        l3.append(c[2] - 2 * codebook_size)
        l3.append(c[3] - 3 * codebook_size)
        l2.append(c[4] - 4 * codebook_size)
        l3.append(c[5] - 5 * codebook_size)
        l3.append(c[6] - 6 * codebook_size)
    return [torch.tensor(l, dtype=torch.long)[None] for l in (l1, l2, l3)]


def layers_to_codes(layers, codebook_size: int = 4096) -> List[int]:
    """The inverse of `codes_to_layers` (voice-cloning prompts)."""
    l1, l2, l3 = (np.asarray(torch.as_tensor(l).cpu()).reshape(-1).tolist() for l in layers[:3])
    out = []
    for i in range(len(l1)):
        out += [l1[i], l2[2 * i] + codebook_size, l3[4 * i] + 2 * codebook_size,
                l3[4 * i + 1] + 3 * codebook_size, l2[2 * i + 1] + 4 * codebook_size,
                l3[4 * i + 2] + 5 * codebook_size, l3[4 * i + 3] + 6 * codebook_size]
    return out


class SnacARModel(CausalLM):
    """An LLM over SNAC audio tokens; subclasses set the special-token
    layout."""

    START_OF_HUMAN: int
    END_OF_TEXT: int
    END_OF_HUMAN: int
    START_OF_AI: int = None
    START_OF_SPEECH: int
    END_OF_SPEECH: int
    END_OF_AI: int = None
    AUDIO_TOKENS_START: int
    SNAC_REPO: str = "mlx-community/snac_24khz"

    _tokenizer = None
    _codec = None

    @property
    def sample_rate(self) -> int:
        return getattr(self.config, "sample_rate", 24000)

    # ---- host-side pieces: the tokenizer and the codec ----

    @property
    def tokenizer(self):
        """`set_runtime`'s tokenizer, else the reader of `tokenizer.json` in
        the config's `tokenizer_name` (a local directory) or the checkpoint
        directory."""
        if type(self)._tokenizer is not None:
            return type(self)._tokenizer
        from ...tokenizer_json import load

        for where in (getattr(self.config, "tokenizer_name", None),
                      getattr(self.config, "model_path", None)):
            if where and (Path(where) / "tokenizer.json").is_file():
                return load(Path(where) / "tokenizer.json")
        raise RuntimeError(
            "no text tokenizer: neither the config's tokenizer_name nor its model_path is a "
            "directory with a tokenizer.json; load the model from such a checkpoint "
            "directory, or call set_runtime(tokenizer=...)")

    @property
    def codec(self):
        if type(self)._codec is None:
            from ...codec.models import SNAC

            type(self)._codec = SNAC.from_pretrained(self.SNAC_REPO, device=self.device)
        return type(self)._codec

    def set_runtime(self, tokenizer=None, codec=None):
        if tokenizer is not None:
            type(self)._tokenizer = tokenizer
        if codec is not None:
            type(self)._codec = codec

    # ---- prompts ----

    def prepare_input_ids(self, prompt: str, voice: Optional[str] = None,
                          zeroprompt: Optional[List[int]] = None) -> List[int]:
        if voice is not None and zeroprompt is None:
            prompt = f"{voice}: {prompt}"
        text_ids = list(self.tokenizer.encode(prompt))
        ids = [self.START_OF_HUMAN] + text_ids + [self.END_OF_TEXT, self.END_OF_HUMAN]
        if zeroprompt:
            ids = list(zeroprompt) + ids
        return ids

    def prepare_zeroprompt(self, ref_audio, ref_text: str) -> List[int]:
        """The voice-cloning prefix: [SOH] ref text [EOT EOH] [SOA SOS] the
        reference's codes [EOS EOA]."""
        audio = np.asarray(ref_audio, np.float32).reshape(1, 1, -1)
        layers = self.codec.encode(audio)
        codes = [c + self.AUDIO_TOKENS_START for c in layers_to_codes(layers)]
        text_ids = list(self.tokenizer.encode(ref_text))
        soa = self.START_OF_AI if self.START_OF_AI is not None else self.START_OF_SPEECH
        eoa = self.END_OF_AI if self.END_OF_AI is not None else self.END_OF_SPEECH
        return ([self.START_OF_HUMAN] + text_ids + [self.END_OF_TEXT, self.END_OF_HUMAN]
                + [soa, self.START_OF_SPEECH] + codes + [self.END_OF_SPEECH, eoa])

    # ---- outputs ----

    def parse_output(self, tokens) -> List[int]:
        """The codes after the last START_OF_SPEECH, whole frames only,
        offset to 0."""
        toks = [int(t) for t in np.asarray(tokens).reshape(-1)]
        if self.START_OF_SPEECH in toks:
            toks = toks[len(toks) - toks[::-1].index(self.START_OF_SPEECH):]
        toks = [t for t in toks if t != self.END_OF_SPEECH and t >= self.AUDIO_TOKENS_START]
        n = (len(toks) // 7) * 7
        return [t - self.AUDIO_TOKENS_START for t in toks[:n]]

    def make_batcher(self, **kwargs):
        """Serving batcher: continuous (slot-based) batching of concurrent
        token streams, one lock-step decode for every live request."""
        from ...serving import LMContinuousBatcher

        return LMContinuousBatcher(self, **kwargs)

    def decode_audio(self, code_list: List[int]) -> Optional[np.ndarray]:
        if len(code_list) < 7:
            return None
        audio = self.codec.decode(codes_to_layers(code_list))
        return audio.float().cpu().numpy().reshape(-1)

    def decode_audio_stream(self, code_list: List[int], prev_codes=None,
                            context_frames: int = 8):
        """Decode new flat codes with the previous chunk's codes as context
        → (audio (samples,) or None, the new context)."""
        if len(code_list) < 7:
            return None, prev_codes
        audio, ctx = self.codec.decode_stream(codes_to_layers(code_list), prev_codes,
                                              context_frames)
        return audio.float().cpu().numpy().reshape(-1), ctx

    # ---- generation ----

    def _result(self, audio, segment_idx, n, ids, t0, final: bool = True):
        elapsed = time.perf_counter() - t0
        dur = len(audio) / self.sample_rate
        prompt = {"tokens": len(ids)}
        samples = {"samples": len(audio)}
        if final:
            prompt["tokens-per-sec"] = round(len(ids) / elapsed, 2)
            samples["samples-per-sec"] = round(len(audio) / elapsed, 2)
        return GenerationResult(
            audio=audio, samples=len(audio), sample_rate=self.sample_rate,
            segment_idx=segment_idx, token_count=n, audio_duration=format_duration(dur),
            real_time_factor=elapsed / dur if dur > 0 else 0.0, prompt=prompt,
            audio_samples=samples, processing_time_seconds=elapsed, peak_memory_usage=0.0)

    @torch.inference_mode()
    def _stream_segment(self, ids, segment_idx, t0, max_tokens, sampling, interval: float):
        """Audio every ~`interval` seconds of new frames (137.5 tokens a
        second), each chunk decoded with code context for seam-free joins."""
        interval_toks = max(7, int(interval * 137.5) // 7 * 7)
        raw, emitted, prev_ctx, n = [], 0, None, 0
        for resp in stream_generate(self, ids, max_tokens=max_tokens,
                                    eos_token_ids=(self.END_OF_SPEECH,), **sampling):
            raw.append(int(resp.token))
            n += 1
            codes = self.parse_output(np.asarray(raw))
            if len(codes) - emitted >= interval_toks:
                new = codes[emitted: emitted + (len(codes) - emitted) // 7 * 7]
                audio, prev_ctx = self.decode_audio_stream(new, prev_ctx)
                if audio is not None:
                    emitted += len(new)
                    yield self._result(audio, segment_idx, n, ids, t0, final=False)
        tail = self.parse_output(np.asarray(raw))[emitted:]
        if tail:
            audio, _ = self.decode_audio_stream(tail, prev_ctx)
            if audio is not None:
                yield self._result(audio, segment_idx, n, ids, t0, final=False)

    def generate(self, text: str, voice: Optional[str] = None, temperature: float = 0.6,
                 top_p: float = 0.8, split_pattern: str = "\n", max_tokens: int = 1200,
                 verbose: bool = False, ref_audio=None, ref_text: Optional[str] = None,
                 stream: bool = False, **kwargs):
        from ...utils import load_audio

        if ref_audio is not None and isinstance(ref_audio, str):
            ref_audio = load_audio(ref_audio, sample_rate=self.sample_rate)
        prompt_text = text.replace("\\n", "\n").replace("\\t", "\t")
        prompts = [p for p in prompt_text.split(split_pattern) if p.strip()]
        zeroprompt = (self.prepare_zeroprompt(ref_audio, ref_text)
                      if ref_audio is not None and ref_text is not None else None)
        sampling = dict(temp=temperature, top_p=top_p, top_k=kwargs.get("top_k", 0),
                        repetition_penalty=kwargs.get("repetition_penalty", 1.3),
                        repetition_context_size=kwargs.get("repetition_context_size", 20))
        # under a running server an LMContinuousBatcher may be installed:
        # concurrent requests' token streams then decode in lock-step
        hook = get_infer_hook(self)

        for segment_idx, segment in enumerate(prompts):
            t0 = time.perf_counter()
            ids = self.prepare_input_ids(segment, voice, zeroprompt)
            if stream and hook is None:
                yield from self._stream_segment(
                    ids, segment_idx, t0, max_tokens, sampling,
                    float(kwargs.get("streaming_interval", 2.0)))
                continue
            if hook is not None:
                out = hook.submit(ids, max_tokens=max_tokens,
                                  eos_ids=(self.END_OF_SPEECH,), **sampling).result()
                toks, n = np.asarray([out], np.int64), len(out)
            else:
                with torch.inference_mode():
                    toks, n = generate_tokens(self, ids, max_tokens=max_tokens,
                                              eos_token_ids=(self.END_OF_SPEECH,), **sampling)
            audio = self.decode_audio(self.parse_output(toks[0]))
            if audio is None:
                continue
            yield self._result(audio, segment_idx, n, ids, t0)
