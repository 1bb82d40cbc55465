"""Autoregressive generation (counterpart of `mlx_audio_tpu/lm/generate.py`).

The JAX package runs the decode as one on-device `lax.while_loop` a chunk,
with one host fetch a chunk. Here the chunk is an eager loop: each step
penalises, samples and feeds the token back on the card; the loop reads one
flag back (whether every row has drawn EOS) every `POLL_STEPS` steps and the
chunk's tokens once at its end. Steps taken after the last row's EOS and
before the next poll are dropped on the host, so the tokens and their count
are the JAX loop's; only their card time is spent.

Sampling draws from a `torch.Generator` seeded with `seed` (Gumbel-max, see
`lm/sample.py`): greedy tokens equal the JAX package's, sampled ones match
it in distribution only.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Iterator, Optional, Tuple

import numpy as np
import torch

from .sample import apply_repetition_penalty, make_sampler

__all__ = ["stream_generate", "generate_tokens", "GenerationResponse", "POLL_STEPS"]

# decode steps between two reads of the all-rows-done flag
POLL_STEPS = 8


@dataclass
class GenerationResponse:
    token: int
    text: str = ""
    prompt_tokens: int = 0
    generation_tokens: int = 0
    prompt_tps: float = 0.0
    generation_tps: float = 0.0
    finish_reason: Optional[str] = None


def _default_model_call(model, ids, caches):
    return model(ids, caches)


class _Decoder:
    """The decode state of one generation: caches, the next token's float32
    logits (B, V), the repetition window (B, W), the done flags and the
    generator, advanced in place chunk by chunk."""

    def __init__(self, model, caches, logits, history, eos_ids, model_call, sampler,
                 rep_penalty: float, generator):
        self.model = model
        self.caches = caches
        self.logits = logits
        self.history = history
        self.done = torch.zeros(logits.shape[0], dtype=torch.bool, device=logits.device)
        self.eos = eos_ids
        self.model_call = model_call
        self.sampler = sampler
        self.rep_penalty = rep_penalty
        self.generator = generator

    def chunk(self, num_steps: int) -> Tuple[np.ndarray, int, bool]:
        """Up to `num_steps` tokens → (tokens (B, n) on the host, n, every row
        done). n stops at the step where the last row drew EOS."""
        B = self.logits.shape[0]
        out = torch.empty(B, num_steps, dtype=torch.long, device=self.logits.device)
        # the step each row draws EOS at; -1 for a row done in an earlier chunk
        done_at = torch.where(self.done, -1, num_steps)
        i = 0
        while i < num_steps:
            lg = self.logits
            if self.rep_penalty != 1.0:
                lg = apply_repetition_penalty(lg, self.history, self.rep_penalty)
            token = self.sampler(lg, self.generator)
            self.history = torch.cat([self.history[:, 1:], token[:, None]], dim=1)
            newly = torch.isin(token, self.eos) & ~self.done
            done_at = torch.where(newly, i, done_at)
            self.done = self.done | newly
            out[:, i] = token
            i += 1
            logits, self.caches = self.model_call(self.model, token[:, None], self.caches)
            self.logits = logits[:, -1, :].float()
            if i % POLL_STEPS == 0 and i < num_steps and bool(self.done.all()):
                break
        all_done = bool(self.done.all())
        n = int(done_at.max()) + 1 if all_done else i
        return out[:, :n].cpu().numpy(), n, all_done


def generate_tokens(model, prompt, max_tokens: int = 512, sampler: Optional[Callable] = None,
                    temp: float = 0.0, top_p: float = 1.0, top_k: int = 0,
                    repetition_penalty: float = 1.0, repetition_context_size: int = 64,
                    eos_token_ids=(), max_kv_size: Optional[int] = None, seed: int = 0,
                    model_call: Callable = _default_model_call) -> Tuple[np.ndarray, int]:
    """Non-streaming decode → (tokens (B, n), n), a generated EOS included
    (and for B = 1 the tokens end at the first one)."""
    toks = None
    n = 0
    for chunk, _meta in _generate_chunks(
            model, prompt, max_tokens, sampler, temp, top_p, top_k, repetition_penalty,
            repetition_context_size, eos_token_ids, max_kv_size, seed, model_call,
            chunk_size=max_tokens):
        toks = chunk if toks is None else np.concatenate([toks, chunk], axis=1)
        n += chunk.shape[1]
    return toks, n


def _generate_chunks(model, prompt, max_tokens, sampler, temp, top_p, top_k,
                     repetition_penalty, repetition_context_size, eos_token_ids,
                     max_kv_size, seed, model_call, chunk_size):
    """Yield (tokens (B, ≤ chunk_size) numpy, meta dict) until EOS or
    max_tokens."""
    dev = model.device
    prompt = torch.as_tensor(np.asarray(prompt), dtype=torch.long, device=dev)
    if prompt.dim() == 1:
        prompt = prompt[None]
    B, T = prompt.shape
    if sampler is None:
        sampler = make_sampler(temp=temp, top_p=top_p, top_k=top_k)
    eos = torch.as_tensor(list(eos_token_ids) if eos_token_ids else [-2], device=dev)
    kv_len = max_kv_size or (T + max_tokens + 1)
    caches = model.make_caches(batch=B, max_len=kv_len)

    W = repetition_context_size
    if T >= W:
        history = prompt[:, T - W:]
    else:
        history = torch.cat([torch.full((B, W - T), -1, dtype=torch.long, device=dev),
                             prompt], dim=1)
    generator = torch.Generator(device=dev)
    generator.manual_seed(seed)

    tic = time.perf_counter()
    logits, caches = model_call(model, prompt, caches)
    dec = _Decoder(model, caches, logits[:, -1, :].float(), history, eos, model_call,
                   sampler, repetition_penalty, generator)
    prompt_time = time.perf_counter() - tic

    produced = 0
    gen_tic = time.perf_counter()
    while produced < max_tokens:
        steps = min(chunk_size, max_tokens - produced)
        chunk, n_valid, finished = dec.chunk(steps)
        # trim at the first EOS for B == 1
        if finished and B == 1 and len(eos_token_ids):
            hits = np.isin(chunk[0], list(eos_token_ids)).nonzero()[0]
            if len(hits):
                chunk = chunk[:, :hits[0] + 1]
        produced += chunk.shape[1]
        meta = {"prompt_tokens": T, "prompt_time": prompt_time,
                "generation_time": time.perf_counter() - gen_tic, "finished": finished}
        yield chunk, meta
        if finished or n_valid < steps:
            return


def stream_generate(model, prompt, max_tokens: int = 512, sampler: Optional[Callable] = None,
                    temp: float = 0.0, top_p: float = 1.0, top_k: int = 0,
                    repetition_penalty: float = 1.0, repetition_context_size: int = 64,
                    eos_token_ids: Optional[set] = None, max_kv_size: Optional[int] = None,
                    seed: int = 0, model_call: Callable = _default_model_call,
                    chunk_size: int = 32) -> Iterator[GenerationResponse]:
    """Yield tokens one at a time (decoded in `chunk_size` blocks)."""
    eos = tuple(sorted(eos_token_ids)) if eos_token_ids else ()
    n = 0
    for chunk, meta in _generate_chunks(
            model, prompt, max_tokens, sampler, temp, top_p, top_k, repetition_penalty,
            repetition_context_size, eos, max_kv_size, seed, model_call, chunk_size):
        toks = chunk[0] if chunk.shape[0] == 1 else chunk.T
        for j, tok in enumerate(toks):
            n += 1
            last_of_chunk = j == len(toks) - 1
            yield GenerationResponse(
                token=int(tok) if np.ndim(tok) == 0 else tok,
                prompt_tokens=meta["prompt_tokens"],
                generation_tokens=n,
                prompt_tps=meta["prompt_tokens"] / max(meta["prompt_time"], 1e-9),
                generation_tps=n / max(meta["generation_time"], 1e-9),
                finish_reason=("stop" if meta["finished"] and last_of_chunk
                               else ("length" if n >= max_tokens and last_of_chunk else None)),
            )
