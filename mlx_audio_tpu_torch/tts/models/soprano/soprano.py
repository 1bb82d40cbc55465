"""Soprano: a Qwen3 LM whose hidden states drive a Vocos-style ISTFT decoder,
with no discrete audio codec (counterpart of
`mlx_audio_tpu/tts/models/soprano/soprano.py`).

The LM is the port's `CausalLM`. `_decode_with_hidden` is an eager loop on
the card: each step samples a token from the last logits, feeds it back
and writes its hidden state into a fixed buffer; the loop reads the done
flag (a stop id drawn) every `POLL_STEPS` steps and the buffer once at its
end, so the hidden states and their count are the JAX loop's. The decoder
upsamples the hidden sequence 4x (linear, `align_corners`), runs the
ConvNeXt backbone and an ISTFT head (n_fft 2048, hop 512).

Text goes in through the port's `tokenizer_json` reader on the checkpoint's
`tokenizer.json` (byte-level BPE with `[STOP]`, `[TEXT]` and `[START]` as
added tokens; pad and eos from its `tokenizer_config.json`), where the JAX
package builds `AutoTokenizer`. Sampled tokens match the JAX package's in
distribution only (Gumbel-max from a `torch.Generator`); greedy ones are
its tokens.
"""

from __future__ import annotations

import re
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import numpy as np
import torch
from torch import nn

from ....base import BaseModelArgs
from ....device import resolve_device
from ....lm.cache import make_caches
from ....lm.generate import POLL_STEPS
from ....lm.sample import make_sampler
from ....lm.transformer import CausalLM, LMConfig
from ....nn.module import init_weights
from ...models.interpolate import interpolate
from ..base import GenerationResult, format_duration

__all__ = ["DecoderConfig", "Model", "ModelConfig", "SopranoDecoder"]


@dataclass
class DecoderConfig(BaseModelArgs):
    decoder_num_layers: int = 8
    decoder_dim: int = 768
    decoder_intermediate_dim: int = 2304
    hop_length: int = 512
    n_fft: int = 2048
    upscale: int = 4
    input_kernel: int = 1
    dw_kernel: int = 3
    token_size: int = 2048
    receptive_field: int = 4


@dataclass
class ModelConfig(LMConfig):
    model_type: str = "qwen3"
    sample_rate: int = 32000
    decoder_config: DecoderConfig = None
    model_path: str = ""

    def __post_init__(self):
        super().__post_init__()
        if self.decoder_config is None:
            self.decoder_config = DecoderConfig()
        elif isinstance(self.decoder_config, dict):
            self.decoder_config = DecoderConfig.from_dict(self.decoder_config)
        # Soprano-80M's narrower decoder, unless the path names soprano-1.1
        if self.model_path and "soprano-1.1" not in self.model_path.lower():
            self.decoder_config.decoder_dim = 512
            self.decoder_config.decoder_intermediate_dim = 1536
            self.decoder_config.input_kernel = 3


class SopranoDecoder(nn.Module):
    def __init__(self, num_input_channels: int = 2048, decoder_num_layers: int = 8,
                 decoder_dim: int = 768, decoder_intermediate_dim: int = 2304,
                 hop_length: int = 512, n_fft: int = 2048, upscale: int = 4,
                 input_kernel: int = 1, dw_kernel: int = 3, device=None):
        super().__init__()
        from ....codec.models.vocos.vocos import ISTFTHead, VocosBackbone

        self.decoder = VocosBackbone(
            input_channels=num_input_channels, dim=decoder_dim,
            intermediate_dim=decoder_intermediate_dim, num_layers=decoder_num_layers,
            input_kernel_size=input_kernel, dw_kernel_size=dw_kernel, device=device)
        self.head = ISTFTHead(decoder_dim, n_fft, hop_length, device=device)
        self.upscale = upscale

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """LM hidden states (B, L, C) → waveform (B, samples)."""
        target = self.upscale * (x.shape[1] - 1) + 1
        xt = interpolate(x.transpose(1, 2), size=target, mode="linear", align_corners=True)
        return self.head(self.decoder(xt.transpose(1, 2)))


@torch.inference_mode()
def _decode_with_hidden(lm: CausalLM, prompt, max_tokens: int, temp: float, top_p: float,
                        stop_ids, seed: int = 0):
    """The autoregressive loop collecting hidden states → (hidden (1, n + 1,
    D) on the card, n): the prompt's last hidden state, then one per
    accepted token (a stop id ends the loop and is not accepted)."""
    cfg = lm.config
    dev = lm.device
    ids = torch.as_tensor(np.asarray(prompt), dtype=torch.long, device=dev).reshape(1, -1)
    caches = make_caches(cfg.num_hidden_layers, 1, cfg.num_key_value_heads,
                         ids.shape[1] + max_tokens + 1, cfg.head_dim, dtype=torch.float32,
                         device=dev)
    h_all, caches = lm.model(ids, caches)
    logits = lm.logits(h_all[:, -1:])[:, -1].float()
    hidden = h_all.new_zeros(1, max_tokens + 1, h_all.shape[-1])
    hidden[:, 0] = h_all[:, -1]
    stop = torch.as_tensor(list(stop_ids), device=dev)
    sampler = make_sampler(temp=temp, top_p=top_p)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    done_at = torch.full((), max_tokens, dtype=torch.long, device=dev)
    i = 0
    while i < max_tokens:
        tok = sampler(logits, gen)
        newly = torch.isin(tok[0], stop) & ~done
        done_at = torch.where(newly, i, done_at)
        done = done | newly
        h, caches = lm.model(tok[:, None], caches)
        logits = lm.logits(h)[:, -1].float()
        hidden[:, i + 1] = h[:, -1]
        i += 1
        if i % POLL_STEPS == 0 and i < max_tokens and bool(done):
            break
    n = int(done_at) if bool(done) else i
    return hidden[:, : n + 1], n


class Model(nn.Module):
    """Soprano on an explicit device (None: the card), weights drawn from
    `seed`."""

    _tokenizer = None

    def __init__(self, config, device=None, seed: int = 0, tokenizer=None):
        super().__init__()
        if isinstance(config, dict):
            config = ModelConfig.from_dict(config)
        self.config = config
        self.device = resolve_device(device)
        self.language_model = CausalLM(config, device=self.device, seed=seed)
        dc = config.decoder_config
        self.decoder = SopranoDecoder(
            num_input_channels=config.hidden_size, decoder_num_layers=dc.decoder_num_layers,
            decoder_dim=dc.decoder_dim, decoder_intermediate_dim=dc.decoder_intermediate_dim,
            hop_length=dc.hop_length, n_fft=dc.n_fft, upscale=dc.upscale,
            input_kernel=dc.input_kernel, dw_kernel=dc.dw_kernel, device=self.device)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed + 1)
        init_weights(self.decoder, gen)
        if tokenizer is not None:
            Model._tokenizer = tokenizer

    @property
    def sample_rate(self) -> int:
        return self.config.sample_rate

    def make_batcher(self, **kwargs):
        """Serving batcher: concurrent sentence decodes (token sampling and
        hidden-state collection) run in lock-step; the vocoder decode stays
        per request."""
        from .batcher import SopranoBatcher

        return SopranoBatcher(self, **kwargs)

    @property
    def tokenizer(self):
        """The class's tokenizer where one was given, else the reader of the
        checkpoint directory's `tokenizer.json`."""
        if Model._tokenizer is not None:
            return Model._tokenizer
        from ....tokenizer_json import load

        path = Path(self.config.model_path or "") / "tokenizer.json"
        if not self.config.model_path or not path.is_file():
            raise RuntimeError(f"no tokenizer: {path} does not exist; load the model from a "
                               "checkpoint directory that has one, or pass tokenizer=")
        return load(path)

    def _stop_ids(self):
        """(pad id, else `[STOP]`'s; eos id, else -1), as the JAX package
        takes them from `AutoTokenizer`."""
        from ....tokenizer_json import config_token_id

        tok = self.tokenizer
        pad, eos = getattr(tok, "pad_token_id", None), getattr(tok, "eos_token_id", None)
        if not hasattr(tok, "pad_token_id") and self.config.model_path:
            pad = config_token_id(self.config.model_path, tok, "pad_token")
            eos = config_token_id(self.config.model_path, tok, "eos_token")
        stop = tok.encode("[STOP]", add_special_tokens=False)
        s1 = pad if pad is not None else (stop[0] if stop else -1)
        s2 = eos if eos is not None else -1
        return int(s1), int(s2)

    @staticmethod
    def _clean_text(text: str) -> str:
        from .text import clean_text

        return clean_text(text)

    def _sentences(self, text: str):
        parts = re.split(r"(?<=[.!?])\s+", self._clean_text(text))
        return [p for p in parts if p.strip()]

    @torch.inference_mode()
    def _decode_audio(self, hidden: torch.Tensor) -> np.ndarray:
        """Hidden states (1, n + 1, D) → float32 samples on the host."""
        dtype = self.decoder.head.out.weight.dtype
        return self.decoder(hidden.to(self.device, dtype)).float().cpu().numpy().reshape(-1)

    def generate(self, text: str, voice: Optional[str] = None, temperature: float = 0.3,
                 top_p: float = 0.95, split_pattern: str = "\n", max_tokens: int = 512,
                 verbose: bool = False, **kwargs):
        """One GenerationResult a segment (text split on `split_pattern`),
        each the concatenated audio of its sentences. A sentence whose
        decode accepts no token is skipped."""
        from ....serving import get_infer_hook

        prompts = text.replace("\\n", "\n").split(split_pattern)
        s1, s2 = self._stop_ids()
        for segment_idx, segment in enumerate(p for p in prompts if p.strip()):
            t0 = time.perf_counter()
            pcm = []
            n_toks = 0
            # under a running server a SopranoBatcher may be installed:
            # concurrent requests' hidden-collecting decodes then run in
            # lock-step
            hook = get_infer_hook(self)
            for sentence in self._sentences(segment):
                prompt = f"[STOP][TEXT]{sentence}[START]"
                ids = self.tokenizer.encode(prompt, add_special_tokens=False)
                if hook is not None:
                    hid = hook.submit(ids, max_tokens=max_tokens, temperature=temperature,
                                      top_p=top_p, stop_ids=(s1, s2)).result()
                    if hid.shape[0] < 2:
                        continue
                    pcm.append(self._decode_audio(torch.as_tensor(hid)[None]))
                    n_toks += hid.shape[0] - 1
                    continue
                hidden, n = _decode_with_hidden(self.language_model, ids, max_tokens,
                                                float(temperature), float(top_p), (s1, s2))
                if n + 1 < 2:
                    continue
                pcm.append(self._decode_audio(hidden))
                n_toks += n
            if not pcm:
                continue
            audio = np.concatenate(pcm)
            elapsed = time.perf_counter() - t0
            dur = len(audio) / self.sample_rate
            if verbose:
                print(f"[soprano] segment {segment_idx}: {n_toks} tokens, {dur:.2f} s")
            yield GenerationResult(
                audio=audio, samples=len(audio), sample_rate=self.sample_rate,
                segment_idx=segment_idx, token_count=n_toks,
                audio_duration=format_duration(dur),
                real_time_factor=round(elapsed / dur, 3) if dur else 0.0,
                prompt={"tokens": n_toks, "tokens-per-sec": round(n_toks / elapsed, 2)},
                audio_samples={"samples": len(audio),
                               "samples-per-sec": round(len(audio) / elapsed, 2)},
                processing_time_seconds=elapsed, peak_memory_usage=0.0)

    def sanitize(self, weights: dict) -> dict:
        """The LM's `model.*` and `lm_head.*` under `language_model.`; the
        decoder's convolutions oriented to the JAX layout."""
        from ....nn.sanitize import orient_weights_to_model

        out = {}
        for k, v in weights.items():
            if k.startswith(("model.", "lm_head.")):
                k = "language_model." + k
            out[k] = v
        return orient_weights_to_model(self, out)
