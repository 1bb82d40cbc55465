"""Slot-based continuous batching of IndexTTS's latent-collecting GPT
(counterpart of `mlx_audio_tpu/tts/models/indextts/batcher.py`).

A pool of cache slots advances in lock-step; a tick of n steps is an eager
loop on the card, read back once a tick. Each step mirrors
`_indextts_decode`: record the final-norm latent, sample the next mel code
(`lm.continuous`'s per-row sampler: temperature and top-k per row, greedy
rows the argmax), feed the code's embedding plus the row's own step's
position row. The GPT's `wpe` is the one-row zero table, so per-row cache
positions cost nothing. A request's prompt embedding is prefilled at B = 1
into caches of its bucket's length (the GPT's `make_caches` at batch 1,
the JAX package's `_B1Cache`) and copied into its slot.

As in the JAX batcher, the stop step's latent is kept: a row's latent is
appended before its code is checked for the stop. The caches are float32.
A sampled row draws from its own `torch.Generator`, seeded by its request,
so its codes depend only on its seed.
"""

from __future__ import annotations

from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from ....lm.continuous import (SlotKVCache, _bucket, _install_slot, _sample_rows_core,
                               _slot_mask, stages_used)
from ....serving import FrameBatcherBase

__all__ = ["IndexTTSBatcher"]


def _prefill_b1(model, caches, embedding: torch.Tensor, length: int) -> torch.Tensor:
    """A bucketed B = 1 prompt embedding (1, P, D) → the GPT's hidden state
    (D,) at its last real row. The right padding is masked causally, and the
    K/V it leaves are overwritten before any query can see them."""
    h, _ = model.gpt(embedding, caches)
    return h[0, length - 1]


def _tick_n(model, caches: List[SlotKVCache], h_last, pos, step, generators, temps, top_ks,
            n: int, stages):
    """n lock-step latent + sample steps → (codes (B, n), latents (B, n, D),
    the last hidden states (B, D)), all on the card."""
    B = pos.shape[0]
    dev = pos.device
    no_hist = torch.full((B, 1), -1, dtype=torch.long, device=dev)
    no_win = torch.zeros(B, dtype=torch.long, device=dev)
    ones = torch.ones(B, dtype=torch.float32, device=dev)
    toks, lats = [], []
    for _ in range(n):
        h_norm = model.final_norm(h_last)
        logits = model.mel_head(h_norm).float()
        tok = _sample_rows_core(logits, generators, no_hist, temps, ones, top_ks, ones, no_win,
                                None, stages)
        emb = (model.mel_embedding(tok) + model.mel_pos_embedding(step))[:, None]
        for c in caches:
            c.pos = pos
        h, _ = model.gpt(emb.to(h_last.dtype), caches, positions=pos[:, None],
                         mask=_slot_mask(pos, caches[0].max_len))
        h_last = h[:, -1]
        toks.append(tok)
        lats.append(h_norm)
        pos = pos + 1
        step = step + 1
    return torch.stack(toks, dim=1), torch.stack(lats, dim=1), h_last


@dataclass
class _IdxRequest:
    embedding: np.ndarray  # (1, T0, D): the [conditioning ‖ text] prompt
    max_tokens: int
    temp: float
    top_k: int
    seed: int
    future: Future = field(default_factory=Future)
    latents: list = field(default_factory=list)  # (D,) rows, the stop step's included
    on_frame: object = None  # streaming sink, one (D,) latent a call


class IndexTTSBatcher(FrameBatcherBase):
    """Slot-based continuous batching over an IndexTTS model. `submit`
    takes the prepared (1, T0, D) prompt embedding (the conditioning
    encoder and the tokenizer run on the caller's thread) and resolves to
    the collected GPT latents (n, D) float32; the BigVGAN decode stays on
    the caller's thread."""

    def __init__(self, model, slots: int = 4, max_len: int = 2048, tick_frames: int = 16,
                 **_ignored):
        self._owner = model
        self.model = model
        g = model.args.gpt
        self.max_len = max_len
        self.stop = int(g.stop_mel_token)
        self._hdim = g.model_dim
        self.slots = slots
        self._build_device_state(slots)
        self.pos = np.full(slots, max_len - 1, np.int64)  # a free slot's scratch index
        self.step = np.zeros(slots, np.int64)
        self.temps = np.zeros(slots, np.float32)
        self.top_ks = np.zeros(slots, np.int64)
        self.generators: List[Optional[torch.Generator]] = [None] * slots
        super().__init__(slots=slots, tick_frames=tick_frames, device=model.device)

    def _build_device_state(self, slots: int) -> None:
        g = self.model.args.gpt
        dev = self.model.device
        self.caches = [SlotKVCache(slots, g.heads, self.max_len, g.model_dim // g.heads,
                                   torch.float32, dev) for _ in range(g.layers)]
        self.h_last = torch.zeros(slots, g.model_dim, device=dev)

    def submit(self, embedding, *, max_tokens: int = 5000, temperature: float = 0.8,
               top_k: int = 30, seed: int = 0, on_frame=None) -> Future:
        emb = np.array(embedding, np.float32)  # a copy: the caller's may be read-only
        if emb.ndim == 2:
            emb = emb[None]
        g = self.model.args.gpt
        req = _IdxRequest(embedding=emb, max_tokens=min(int(max_tokens), g.max_mel_tokens),
                          temp=float(temperature), top_k=int(top_k), seed=int(seed),
                          on_frame=on_frame)
        return self.submit_request(req)

    # -- FrameBatcherBase hooks ---------------------------------------

    def _admit(self, req: _IdxRequest, slot: int) -> None:
        T = req.embedding.shape[1]
        if T >= self.max_len:
            raise ValueError(f"prompt length {T} >= capacity {self.max_len}")
        dev = self.model.device
        P = min(_bucket(T), self.max_len)
        x = torch.zeros(1, P, req.embedding.shape[-1], device=dev)
        x[:, :T] = torch.as_tensor(req.embedding, device=dev)
        single = self.model.gpt.make_caches(1, P, torch.float32)
        h0 = _prefill_b1(self.model, single, x, T)
        _install_slot(self.caches, single, slot, T)
        self.h_last[slot] = h0.to(self.h_last.dtype)
        self.pos[slot] = T
        self.step[slot] = 0
        gen = None
        if req.temp > 0:
            gen = torch.Generator(device=dev)
            gen.manual_seed(req.seed)
        self.generators[slot] = gen
        self.temps[slot] = req.temp
        self.top_ks[slot] = req.top_k

    def _tick(self, n: int) -> None:
        dev = self.model.device
        stages = stages_used(self.temps, np.ones(self.slots), self.top_ks, np.ones(self.slots))
        toks, lats, self.h_last = _tick_n(
            self.model, self.caches, self.h_last, torch.from_numpy(self.pos).to(dev),
            torch.from_numpy(self.step).to(dev), list(self.generators),
            torch.from_numpy(self.temps).to(dev), torch.from_numpy(self.top_ks).to(dev), n,
            stages)
        toks_np = toks.cpu().numpy()  # (slots, n)
        lats_np = lats.float().cpu().numpy()
        self.steps += 1  # before _finish: future observers see the count
        for slot, req in enumerate(self.active):
            if req is None:
                continue
            for j in range(n):
                tok = int(toks_np[slot, j])
                # the stop step's latent is kept (the reference's n + 1)
                req.latents.append(lats_np[slot, j])
                self._emit(req, lats_np[slot, j])
                self.pos[slot] += 1
                self.step[slot] += 1
                if (tok == self.stop or len(req.latents) >= req.max_tokens
                        or self.pos[slot] >= self.max_len - 1):
                    self._finish_slot(slot)
                    break

    def _finish_slot(self, slot: int) -> None:
        req = self.active[slot]
        self.pos[slot] = self.max_len - 1
        self.temps[slot] = 0.0
        self.top_ks[slot] = 0
        self.generators[slot] = None
        result = (np.stack(req.latents) if req and req.latents
                  else np.zeros((0, self._hdim), np.float32))
        self._finish(slot, result)

    def _fail_all(self, e: Exception) -> None:
        for slot, req in enumerate(self.active):
            if req is not None and not req.future.done():
                req.future.set_exception(e)
            self.active[slot] = None
            self.pos[slot] = self.max_len - 1
            self.generators[slot] = None
        self._build_device_state(self.slots)

    # -- pipeline integration -----------------------------------------

    def warmup(self):
        """A concurrent wave of tiny requests, one a slot: the smallest
        prefill bucket, every slot's install and a tick run before live
        traffic."""
        D = self._hdim
        reqs = [_IdxRequest(embedding=np.zeros((1, 8, D), np.float32),
                            max_tokens=self.tick_frames, temp=0.8, top_k=30, seed=0)
                for _ in range(self.slots)]
        self.warmup_requests(reqs)

    def install(self):
        from ....serving import register_infer_hook

        register_infer_hook(self._owner, self)
        return self

    def close(self):
        from ....serving import unregister_infer_hook

        unregister_infer_hook(self._owner)
        super().close()
