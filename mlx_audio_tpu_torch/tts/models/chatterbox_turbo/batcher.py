"""Slot-based continuous batching of Chatterbox-Turbo's GPT-2 T3 decode
(counterpart of `mlx_audio_tpu/tts/models/chatterbox_turbo/batcher.py`).

Turbo has no CFG, so each request is one cache row: a pool of request
slots decodes in lock-step, a tick of n steps an eager loop on the card,
read back once a tick. Each step samples every slot with
`chatterbox_turbo.sample_rows` (the single-request decode's sampler:
repetition penalty over 128 tokens, temperature, top-k, top-p); a sampled
slot draws from its own `torch.Generator`, seeded by its request, so its
tokens are `T3Turbo.decode_chunks`' for that seed. The caches are float32,
the prompt prefilled at B = 1 into caches of its bucket's length and copied
into the slot's row; the decode goes on right after the prompt, at the
single-request decode's positions (`wpe` rows T0 + s).
"""

from __future__ import annotations

from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from ....lm.cache import make_caches
from ....lm.continuous import SlotKVCache, _bucket, _slot_mask
from ....serving import FrameBatcherBase
from .chatterbox_turbo import REP_HIST, sample_rows

__all__ = ["TurboBatcher"]


def _tick_n(t3, caches: List[SlotKVCache], h_last, pos, generators, hist, temps, top_ks,
            top_ps, rep_pens, n: int):
    """n lock-step steps of every slot → (tokens (B, n), h_last) on the card;
    `h_last` (B, D) carries each slot's last hidden state from tick to
    tick."""
    out = []
    for _ in range(n):
        tok = sample_rows(t3.speech_head(h_last).float(), generators, hist, temps, top_ks,
                          top_ps, rep_pens)
        hist = torch.cat([hist[:, 1:], tok[:, None]], dim=1)
        for c in caches:
            c.pos = pos
        hidden, _ = t3.tfmr(t3.speech_emb(tok)[:, None].to(h_last.dtype), caches,
                            positions=pos[:, None], mask=_slot_mask(pos, caches[0].max_len))
        h_last = hidden[:, -1]
        out.append(tok)
        pos = pos + 1
    return torch.stack(out, dim=1), h_last


@dataclass
class _TurboRequest:
    embeds: np.ndarray  # (1, T0, D): [cond | text | bos]
    max_tokens: int
    temp: float
    top_k: int
    top_p: float
    rep_penalty: float
    seed: int
    future: Future = field(default_factory=Future)
    tokens: list = field(default_factory=list)
    on_frame: object = None  # streaming sink, one speech token a call


class TurboBatcher(FrameBatcherBase):
    """Slot-based continuous batching over Chatterbox-Turbo's T3. `submit`
    takes the prepared (1, T0, D) prompt (the conditioning and the text run
    on the caller's thread) and resolves to the speech tokens (n,) int32,
    the stop excluded; S3Gen stays on the caller's thread."""

    def __init__(self, model, slots: int = 4, max_len: int = 2048, tick_frames: int = 16,
                 **_ignored):
        self._owner = model
        self.t3 = model.t3
        self.max_len = max_len
        self.slots = slots
        self.stop = int(self.t3.hp.stop_speech_token)
        self._build_device_state(slots)
        self.pos = np.full(slots, max_len - 1, np.int64)  # a free slot's scratch index
        self.hist = np.full((slots, REP_HIST), -1, np.int64)
        self.temps = np.zeros(slots, np.float32)
        self.top_ps = np.ones(slots, np.float32)
        self.top_ks = np.zeros(slots, np.int64)
        self.rep_pens = np.ones(slots, np.float32)
        self.generators: List[Optional[torch.Generator]] = [None] * slots
        super().__init__(slots=slots, tick_frames=tick_frames, device=self.t3.device)

    def _build_device_state(self, slots: int) -> None:
        cfg = self.t3.cfg
        self.caches = [SlotKVCache(slots, cfg.n_head, self.max_len, cfg.n_embd // cfg.n_head,
                                   torch.float32, self.t3.device) for _ in range(cfg.n_layer)]
        self.h_last = torch.zeros(slots, cfg.n_embd, device=self.t3.device)

    def submit(self, embeds, *, max_tokens: int = 800, temperature: float = 0.8,
               top_k: int = 1000, top_p: float = 0.95, repetition_penalty: float = 1.2,
               seed: int = 0, on_frame=None) -> Future:
        emb = np.array(embeds, np.float32)  # a copy: the caller's may be read-only
        if emb.ndim == 2:
            emb = emb[None]
        return self.submit_request(_TurboRequest(
            embeds=emb, max_tokens=min(int(max_tokens), self.t3.hp.max_speech_tokens),
            temp=float(temperature), top_k=int(top_k), top_p=float(top_p),
            rep_penalty=float(repetition_penalty), seed=int(seed), on_frame=on_frame))

    def _t(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.t3.device)

    # -- FrameBatcherBase hooks ---------------------------------------

    def _admit(self, req: _TurboRequest, slot: int) -> None:
        T = req.embeds.shape[1]
        if T >= self.max_len:
            raise ValueError(f"prompt length {T} >= capacity {self.max_len}")
        cfg = self.t3.cfg
        dev = self.t3.device
        P = min(_bucket(T), self.max_len)
        x = torch.zeros(1, P, req.embeds.shape[-1], device=dev)
        x[:, :T] = torch.as_tensor(req.embeds, device=dev)
        # the right padding is masked causally; the K/V it leaves are
        # overwritten before any query can see them
        single = make_caches(cfg.n_layer, 1, cfg.n_head, P, cfg.n_embd // cfg.n_head,
                             dtype=torch.float32, device=dev)
        hidden, _ = self.t3.tfmr(x.to(self.h_last.dtype), single)
        for sc, c in zip(self.caches, single):
            sc.k[slot, :, :P] = c.k[0]
            sc.v[slot, :, :P] = c.v[0]
        self.h_last[slot] = hidden[0, T - 1]
        gen = None
        if req.temp > 0:
            gen = torch.Generator(device=dev)
            gen.manual_seed(req.seed)
        self.generators[slot] = gen
        self.pos[slot] = T
        self.hist[slot] = -1
        self.temps[slot] = req.temp
        self.top_ps[slot] = req.top_p
        self.top_ks[slot] = req.top_k
        self.rep_pens[slot] = req.rep_penalty

    def _tick(self, n: int) -> None:
        toks, self.h_last = _tick_n(
            self.t3, self.caches, self.h_last, self._t(self.pos), list(self.generators),
            self._t(self.hist), self._t(self.temps), self._t(self.top_ks), self._t(self.top_ps),
            self._t(self.rep_pens), n)
        toks_np = toks.cpu().numpy()  # (slots, n)
        self.steps += 1  # before _finish: future observers see the count
        for slot, req in enumerate(self.active):
            if req is None:
                continue
            for j in range(n):
                tok = int(toks_np[slot, j])
                self.hist[slot] = np.roll(self.hist[slot], -1)
                self.hist[slot, -1] = tok
                if tok == self.stop:  # the stop is not part of the result
                    self._finish_slot(slot)
                    break
                req.tokens.append(tok)
                self._emit(req, tok)
                self.pos[slot] += 1
                if len(req.tokens) >= req.max_tokens or self.pos[slot] >= self.max_len - 1:
                    self._finish_slot(slot)
                    break

    def _finish_slot(self, slot: int) -> None:
        req = self.active[slot]
        self.pos[slot] = self.max_len - 1
        self.temps[slot] = 0.0
        self.top_ps[slot] = 1.0
        self.top_ks[slot] = 0
        self.rep_pens[slot] = 1.0
        self.generators[slot] = None
        self._finish(slot, np.asarray(req.tokens if req else [], np.int32))

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
        """A concurrent wave of tiny seeded prompts, one a slot: the smallest
        prefill bucket, every slot's install and a tick run before live
        traffic."""
        emb = np.random.default_rng(0).standard_normal((1, 16, self.t3.dim)).astype(
            np.float32) * 0.02
        self.warmup_requests([_TurboRequest(embeds=emb, max_tokens=self.tick_frames, temp=0.8,
                                            top_k=50, top_p=0.95, rep_penalty=1.2, seed=0)
                              for _ in range(self.slots)])

    def install(self):
        from ....serving import register_infer_hook

        register_infer_hook(self._owner, self)
        return self

    def close(self):
        from ....serving import unregister_infer_hook

        unregister_infer_hook(self._owner)
        super().close()
