"""Dia: a byte-level encoder-decoder TTS over 9 DAC codebooks with
classifier-free guidance and a per-channel delay pattern (counterpart of
`mlx_audio_tpu/tts/models/dia/dia.py`).

The JAX package runs the whole decode (the step over the [uncond, cond]
pair, the CFG combine, top-k sampling, delay-BOS forcing, the EOS cascade
and the stop rule) as one `lax.while_loop`. Here `_generate_loop` is an
eager loop that keeps every frame on the card and reads the EOS step back
every `POLL_STEPS` steps (`lm.generate`'s rhythm): up to POLL_STEPS - 1
steps past the stop are computed and dropped, so the frames returned are
the JAX loop's `buf[1:n+1]`. The self-attention caches are float32 whatever
the weights' dtype, masked over written slots only, as in the JAX package.

Sampling differs by design: each draw is Gumbel-max with noise from a
`torch.Generator` seeded by the request (the JAX package splits PRNG keys),
so sampled frames match the JAX package's in distribution only; greedy
frames (temperature 0) are its frames. `top_p` is taken and ignored, as in
the JAX package.

The DAC comes from `set_runtime(dac=...)` or from a `dac/` directory in the
checkpoint; the JAX package downloads it, and here its hub id raises.
"""

from __future__ import annotations

import re
import time
from pathlib import Path
from typing import List, Optional, Union

import numpy as np
import torch
from torch import nn

from ....device import resolve_device
from ....lm.cache import KVCache
from ....lm.generate import POLL_STEPS
from ....lm.sample import top_k_filter
from ....nn.module import cast_floats, init_weights
from ....serving import get_infer_hook
from ..base import GenerationResult, format_duration
from .audio import audio_to_codebook, codebook_to_audio
from .config import DiaConfig
from .layers import DiaModel

__all__ = ["Model"]

DAC_REPO = "mlx-community/descript-audio-codec-44khz"


def _additive(ok: torch.Tensor) -> torch.Tensor:
    return torch.where(ok, torch.zeros((), device=ok.device), float("-inf"))


def _text_pair(src: np.ndarray, src_mask: np.ndarray, device):
    """One request's [uncond, cond] encoder inputs: the byte tokens (2, S),
    the uncond row all padding; positions (2, S); the segment-compatible
    encoder mask (2, 1, S, S) (pad attends to pad, text to text) and the
    cross-attention mask (2, 1, 1, S).

    Both rows take the cond text's padding mask. The JAX package masks the
    uncond row by its own all-pad tokens, so its cross-attention masks every
    key, its logits are NaN and every CFG code is 0 (ROADMAP Queue 3); that
    fault is not copied."""
    S = src.shape[0]
    src2 = torch.as_tensor(np.stack([np.zeros_like(src), src]), dtype=torch.long, device=device)
    pos = torch.arange(S, device=device)[None].expand(2, S)
    pmask = torch.as_tensor(np.stack([src_mask, src_mask]), device=device)
    enc_mask = _additive(pmask[:, :, None] == pmask[:, None, :])[:, None]
    cross_mask = _additive(pmask[:, None, None, :])
    return src2, pos, enc_mask, cross_mask


def _encode_text(model: DiaModel, src, src_pos, enc_mask):
    encoder_out = model.encoder(src, src_pos, enc_mask)
    return encoder_out, model.decoder.precompute_cross_kv(encoder_out, src_pos)


def _cfg_pred(last, cfg_scale, eos: int, temperature: float, top_k: int, generator):
    """CFG logits of the [uncond, cond] pair (2, C, V) → one code a channel
    (C,): codes past EOS masked out, then the argmax, or a Gumbel-max draw
    from `generator` over the top-k of logits / temperature."""
    cfg = last[1] + cfg_scale * (last[1] - last[0])
    cfg[:, eos + 1:] = float("-inf")
    if temperature == 0.0:
        return torch.argmax(cfg, dim=-1)
    x = top_k_filter(cfg / temperature, top_k) if top_k > 0 else cfg / temperature
    e = torch.empty_like(x).exponential_(generator=generator)
    return torch.argmax(x - torch.log(e), dim=-1)


def _force(pred, gen_step, eos_step, delay, eos: int, pad: int, bos: int):
    """Delay-BOS forcing and the EOS cascade over rows (..., C): a channel
    still inside its delay emits BOS; from channel 0's EOS on, each channel
    emits EOS at its delay past it and PAD after. gen_step and eos_step are
    (...,) tensors; → (pred, eos_step)."""
    pred = torch.where(gen_step[..., None] >= delay, pred, bos)
    new_eos = (eos_step < 0) & (pred[..., 0] == eos)
    eos_step = torch.where(new_eos, gen_step, eos_step)
    after = (gen_step - eos_step)[..., None]
    in_cascade = (eos_step >= 0)[..., None]
    pred = torch.where(in_cascade & (after == delay), eos, pred)
    pred = torch.where(in_cascade & (after > delay), pad, pred)
    return pred, eos_step


def _generate_loop(model: DiaModel, self_caches: List[KVCache], cross_kvs, cross_mask,
                   start_tokens: torch.Tensor, start_step: int, generator, max_tokens: int,
                   cfg_scale: float, temperature: float, top_k: int, eos: int, pad: int,
                   bos: int, delay_pattern: tuple):
    """The CFG decode of one request → (frames (n, C) on the card, n): the
    JAX loop's `buf[1:n+1]`. It stops at max_tokens, or once
    `step - eos_step > max_delay` (the cascade's last row written)."""
    dev = start_tokens.device
    C = len(delay_pattern)
    delay = torch.as_tensor(delay_pattern, device=dev)
    max_delay = max(delay_pattern)
    S = self_caches[0].max_len
    k_idx = torch.arange(S, device=dev)
    frames = torch.empty(max_tokens, C, dtype=torch.long, device=dev)
    tok = start_tokens.long()
    eos_step = torch.full((), -1, dtype=torch.long, device=dev)
    step = 0
    while step < max_tokens:
        pos = start_step + step
        self_mask = _additive(k_idx <= pos)[None, None, None]
        logits, self_caches = model.decoder(
            tok[None, None].expand(2, 1, C), torch.full((2, 1), pos, device=dev), self_caches,
            cross_kvs, self_mask=self_mask, cross_mask=cross_mask)
        pred = _cfg_pred(logits[:, -1], cfg_scale, eos, temperature, top_k, generator)
        tok, eos_step = _force(pred, torch.full((), step, device=dev), eos_step, delay, eos,
                               pad, bos)
        frames[step] = tok
        step += 1
        if step % POLL_STEPS == 0 or step == max_tokens:
            e = int(eos_step)
            if e >= 0 and step - e > max_delay:
                break
    e = int(eos_step)
    n = min(step, e + max_delay + 1) if e >= 0 else step
    return frames[:n], n


class Model(nn.Module):
    """Dia on an explicit device (None: the card); weights drawn from `seed`
    and cast to `dtype`."""

    _dac = None

    def __init__(self, config: Union[DiaConfig, dict], device=None, dtype=torch.float32,
                 seed: int = 0):
        super().__init__()
        self.config = DiaConfig.load_dict(config)
        self.device = resolve_device(device)
        self.model = DiaModel(self.config, device=self.device)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        init_weights(self, gen)
        if dtype != torch.float32:
            cast_floats(self, dtype)

    @property
    def sample_rate(self) -> int:
        return self.config.model.sample_rate

    @property
    def dac_model(self):
        """`set_runtime`'s DAC, else the `dac/` directory of the checkpoint
        (the JAX package downloads DAC_REPO, whose hub id raises here)."""
        if Model._dac is None:
            from ....codec.models import DAC

            root = getattr(self.config, "model_path", "") or ""
            where = Path(root) / "dac"
            Model._dac = DAC.from_pretrained(str(where) if root and where.is_dir() else DAC_REPO,
                                             device=self.device)
        return Model._dac

    def set_runtime(self, dac=None):
        if dac is not None:
            Model._dac = dac

    def make_batcher(self, **kwargs):
        """Serving batcher: concurrent requests' CFG decodes run in lock-step
        (batcher.DiaBatcher); the DAC decode stays per request."""
        from .batcher import DiaBatcher

        return DiaBatcher(self, **kwargs)

    def _prepare_text(self, text: str):
        S = self.config.data.text_length
        pad_val = self.config.data.text_pad_value
        b = text.encode("utf-8").replace(b"[S1]", b"\x01").replace(b"[S2]", b"\x02")
        toks = list(b)[:S]
        toks = toks + [pad_val] * (S - len(toks))
        src = np.asarray(toks, np.int32)
        return src, src != pad_val

    def _split_turns(self, text: str) -> List[str]:
        pattern = re.compile(r"\[S1\]\s*(.*?)\s*\[S2\]\s*(.*?)(?=(?:\[S1\])|$)", re.DOTALL)
        segments = [f"[S1] {a.strip()} [S2] {b.strip()}" for a, b in pattern.findall(text)]
        merged = []
        for i in range(0, len(segments), 2):
            merged.append(" ".join(segments[i: i + 2]) if i + 1 < len(segments)
                          else segments[i])
        return merged or [text]

    def _decode_codes(self, src, src_mask, max_tokens: int, cfg_scale: float,
                      temperature: float, cfg_filter_top_k: int, ref_audio=None,
                      seed: int = 0):
        """One text's frames (n, C) (numpy), the EOS cascade's rows included:
        encode the [uncond, cond] pair, prefill a voice-clone prompt, decode."""
        data = self.config.data
        dec = self.config.model.decoder
        dev = self.device
        src2, pos, enc_mask, cross_mask = _text_pair(src, src_mask, dev)
        _, cross_kvs = _encode_text(self.model, src2, pos, enc_mask)
        start_tokens = torch.full((data.channels,), data.audio_bos_value, dtype=torch.long,
                                  device=dev)
        prompt, start_step = None, 0
        if ref_audio is not None:
            audio = torch.as_tensor(np.asarray(ref_audio, np.float32))[None, None]
            prompt_codes = audio_to_codebook(self.dac_model, audio, data).to(dev)  # (1, Tp, C)
            prompt = torch.cat([start_tokens[None, None], prompt_codes], dim=1)
            start_step = prompt.shape[1] - 1
        # the prompt's rows counted in (the JAX package sizes the cache
        # without them, and a reference longer than max_delay + 64 frames
        # overflows it: ROADMAP Queue 3)
        kv_len = start_step + max_tokens + max(data.delay_pattern) + 64
        self_caches = [KVCache(2, dec.kv_heads, kv_len, dec.gqa_head_dim, dtype=torch.float32,
                               device=dev) for _ in range(dec.n_layer)]
        if prompt is not None:
            Tp = prompt.shape[1]
            tgt_pos = torch.arange(Tp, device=dev)[None].expand(2, Tp)
            self.model.decoder(prompt.expand(2, Tp, -1)[:, :-1], tgt_pos[:, :-1], self_caches,
                               cross_kvs, self_mask=self_caches[0].attention_mask(Tp - 1),
                               cross_mask=cross_mask)
            start_tokens = prompt[0, -1]
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
        frames, n = _generate_loop(
            self.model, self_caches, cross_kvs, cross_mask, start_tokens, start_step, gen,
            int(max_tokens), float(cfg_scale), float(temperature), int(cfg_filter_top_k),
            int(data.audio_eos_value), int(data.audio_pad_value), int(data.audio_bos_value),
            tuple(data.delay_pattern))
        return frames.cpu().numpy().astype(np.int32)

    @torch.inference_mode()
    def _generate(self, text: str, max_tokens=None, cfg_scale=3.0, temperature=1.3,
                  top_p=0.95, cfg_filter_top_k=35, ref_audio=None, ref_text=None,
                  seed: int = 0):
        data = self.config.data
        max_tokens = max_tokens or data.audio_length
        if ref_text is not None:
            text = ref_text.strip() + " " + text
        src, src_mask = self._prepare_text(text)
        # under a running server a DiaBatcher may be installed: concurrent
        # requests' CFG decodes then run in lock-step; a voice-clone prompt
        # and another top-k than the batcher's take the single-request loop
        hook = get_infer_hook(self)
        if hook is not None and ref_audio is None and int(cfg_filter_top_k) == hook.top_k:
            codes = hook.submit(src, src_mask, max_tokens=max_tokens, cfg_scale=cfg_scale,
                                temperature=temperature, seed=seed).result()
        else:
            codes = self._decode_codes(src, src_mask, max_tokens, cfg_scale, temperature,
                                       cfg_filter_top_k, ref_audio, seed)
        audio = codebook_to_audio(codes, self.dac_model, list(data.delay_pattern),
                                  C=data.channels)
        return audio, int(codes.shape[0])

    def generate(self, text, voice: Optional[str] = None, temperature: float = 1.3,
                 top_p: float = 0.95, split_pattern: str = "\n",
                 max_tokens: Optional[int] = None, verbose: bool = False, ref_audio=None,
                 ref_text: Optional[str] = None, **kwargs):
        """One GenerationResult a segment: the text split at `split_pattern`,
        and a two-speaker text into `[S1] … [S2] …` turns, two a segment.
        kwargs: cfg_scale (3.0), cfg_filter_top_k (35)."""
        from ....utils import load_audio

        if ref_audio is not None and isinstance(ref_audio, str):
            ref_audio = load_audio(ref_audio, sample_rate=self.sample_rate)

        prompts = text.replace("\\n", "\n").split(split_pattern)
        segments = []
        for p in prompts:
            if "[S1]" in p and "[S2]" in p:
                segments.extend(self._split_turns(p))
            elif p.strip():
                segments.append(p)

        for segment_idx, segment in enumerate(segments):
            t0 = time.perf_counter()
            audio, n = self._generate(
                segment, max_tokens=max_tokens, temperature=temperature, top_p=top_p,
                ref_audio=ref_audio, ref_text=ref_text,
                cfg_scale=kwargs.get("cfg_scale", 3.0),
                cfg_filter_top_k=kwargs.get("cfg_filter_top_k", 35))
            elapsed = time.perf_counter() - t0
            dur = len(audio) / self.sample_rate
            yield GenerationResult(
                audio=audio, samples=len(audio), sample_rate=self.sample_rate,
                segment_idx=segment_idx, token_count=n, audio_duration=format_duration(dur),
                real_time_factor=round(elapsed / max(dur, 1e-9), 3),
                prompt={"tokens": n, "tokens-per-sec": round(n / elapsed, 2)},
                audio_samples={"samples": len(audio),
                               "samples-per-sec": round(len(audio) / elapsed, 2)},
                processing_time_seconds=elapsed, peak_memory_usage=0.0)

    def sanitize(self, weights: dict) -> dict:
        out = {}
        for k, v in weights.items():
            if not k.startswith("model."):
                k = "model." + k
            out[k] = v
        return out
