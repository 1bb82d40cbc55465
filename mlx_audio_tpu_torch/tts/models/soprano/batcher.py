"""Slot-based continuous batching of Soprano's sentence decodes (counterpart
of `mlx_audio_tpu/tts/models/soprano/batcher.py`).

Soprano's autoregressive stage samples tokens AND collects each accepted
token's LM hidden state (the vocoder's input), so it cannot ride the
token-only `lm.ContinuousBatcher`. A pool of cache slots advances in
lock-step; a tick of n steps returns every step's token and hidden state,
read from the card once a tick, and each request resolves to its (n + 1,
D) hidden matrix (the prompt's last hidden state, then one per accepted
token), what `Model.decoder` takes. A request's prompt is prefilled at
B = 1 into caches of its bucket's length (`make_caches` at batch 1, the
JAX package's `_B1Cache`) and copied into its slot.

The caches are float32, as the JAX batcher's. A sampled row draws from its
own `torch.Generator`, seeded by its request (`lm.continuous`'s per-row
sampler), so its tokens depend only on its seed; greedy rows take the
argmax.
"""

from __future__ import annotations

from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from ....lm.cache import make_caches
from ....lm.continuous import (SlotKVCache, _bucket, _install_slot, _sample_rows_core,
                               _slot_mask, stages_used)
from ....serving import FrameBatcherBase

__all__ = ["SopranoBatcher"]


def _prefill_b1(lm, caches, ids: torch.Tensor, length: int):
    """A bucketed B = 1 prompt (1, P) → (float32 logits (V,), the hidden
    state (D,) of its last real token)."""
    h, _ = lm.model(ids, caches)
    last = h[:, length - 1: length]
    return lm.logits(last)[0, -1].float(), last[0, -1]


def _tick_n(lm, caches: List[SlotKVCache], logits, pos, generators, temps, top_ps,
            n: int, stages):
    """n lock-step steps, each sampled from the logits the step before left
    (`logits` (B, V) carries them across ticks, as the single-request loop
    samples from the previous step's logits) → (tokens (B, n), hidden
    states (B, n, D), the last logits), all on the card."""
    B = pos.shape[0]
    dev = pos.device
    no_hist = torch.full((B, 1), -1, dtype=torch.long, device=dev)
    no_k = torch.zeros(B, dtype=torch.long, device=dev)
    no_pen = torch.ones(B, dtype=torch.float32, device=dev)
    toks, hiddens = [], []
    for _ in range(n):
        tok = _sample_rows_core(logits, generators, no_hist, temps, top_ps, no_k, no_pen,
                                no_k, None, stages)
        for c in caches:
            c.pos = pos
        h, _ = lm.model(tok[:, None], caches, positions=pos[:, None],
                        mask=_slot_mask(pos, caches[0].max_len))
        logits = lm.logits(h)[:, -1].float()
        toks.append(tok)
        hiddens.append(h[:, -1])
        pos = pos + 1
    return torch.stack(toks, dim=1), torch.stack(hiddens, dim=1), logits


@dataclass
class _SopranoRequest:
    prompt: np.ndarray  # (T,) token ids
    max_tokens: int
    temp: float
    top_p: float
    stop_ids: tuple
    seed: int
    future: Future = field(default_factory=Future)
    hiddens: list = field(default_factory=list)  # (D,) rows, prompt-first
    n_tokens: int = 0
    on_frame: object = None  # streaming sink, one (D,) hidden row a call


class SopranoBatcher(FrameBatcherBase):
    """Slot-based continuous batching over Soprano's LM. `submit` takes a
    sentence's token ids and resolves to its (n + 1, D) float32 hidden
    matrix; the vocoder decode stays on the caller's thread."""

    def __init__(self, model, slots: int = 4, max_len: int = 1024, tick_frames: int = 16,
                 **_ignored):
        self._owner = model
        self.lm = model.language_model
        cfg = self.lm.config
        self.max_len = max_len
        self._n_vocab = cfg.vocab_size
        self._hdim = cfg.hidden_size
        self.slots = slots
        self._build_device_state(slots)
        self.pos = np.full(slots, max_len - 1, np.int64)
        self.temps = np.zeros(slots, np.float32)
        self.top_ps = np.ones(slots, np.float32)
        self.generators: List[Optional[torch.Generator]] = [None] * slots
        super().__init__(slots=slots, tick_frames=tick_frames, device=model.device)

    def _build_device_state(self, slots: int) -> None:
        cfg = self.lm.config
        dev = self.lm.device
        self.caches = [SlotKVCache(slots, cfg.num_key_value_heads, self.max_len, cfg.head_dim,
                                   torch.float32, dev)
                       for _ in range(cfg.num_hidden_layers)]
        self.logits = torch.zeros(slots, self._n_vocab, device=dev)

    def submit(self, prompt, *, max_tokens: int = 512, temperature: float = 0.3,
               top_p: float = 0.95, stop_ids=(), seed: int = 0, on_frame=None) -> Future:
        req = _SopranoRequest(
            prompt=np.asarray(prompt, np.int64).reshape(-1), max_tokens=int(max_tokens),
            temp=float(temperature), top_p=float(top_p),
            stop_ids=tuple(int(s) for s in stop_ids), seed=int(seed), on_frame=on_frame)
        return self.submit_request(req)

    # -- FrameBatcherBase hooks ---------------------------------------

    def _admit(self, req: _SopranoRequest, slot: int) -> None:
        T = len(req.prompt)
        if T >= self.max_len:
            raise ValueError(f"prompt length {T} >= capacity {self.max_len}")
        cfg = self.lm.config
        dev = self.lm.device
        P = min(_bucket(T), self.max_len)
        ids = torch.zeros(1, P, dtype=torch.long, device=dev)
        ids[0, :T] = torch.as_tensor(req.prompt, device=dev)
        single = make_caches(cfg.num_hidden_layers, 1, cfg.num_key_value_heads, P,
                             cfg.head_dim, torch.float32, dev)
        l0, h0 = _prefill_b1(self.lm, single, ids, T)
        _install_slot(self.caches, single, slot, T)
        self.logits[slot] = l0
        h0_np = h0.float().cpu().numpy()
        req.hiddens.append(h0_np)
        self._emit(req, h0_np)
        self.pos[slot] = T
        gen = None
        if req.temp > 0:
            gen = torch.Generator(device=dev)
            gen.manual_seed(req.seed)
        self.generators[slot] = gen
        self.temps[slot] = req.temp
        self.top_ps[slot] = req.top_p

    def _tick(self, n: int) -> None:
        dev = self.lm.device
        stages = stages_used(self.temps, self.top_ps, np.zeros(self.slots), np.ones(self.slots))
        toks, hiddens, self.logits = _tick_n(
            self.lm, self.caches, self.logits, torch.from_numpy(self.pos).to(dev),
            list(self.generators), torch.from_numpy(self.temps).to(dev),
            torch.from_numpy(self.top_ps).to(dev), n, stages)
        toks_np = toks.cpu().numpy()  # (slots, n)
        hid_np = hiddens.float().cpu().numpy()
        self.steps += 1  # before _finish: future observers see the count
        for slot, req in enumerate(self.active):
            if req is None:
                continue
            for j in range(n):
                tok = int(toks_np[slot, j])
                if tok in req.stop_ids:
                    self._finish_slot(slot)
                    break
                req.hiddens.append(hid_np[slot, j])
                self._emit(req, hid_np[slot, j])
                req.n_tokens += 1
                self.pos[slot] += 1
                if req.n_tokens >= req.max_tokens or self.pos[slot] >= self.max_len - 1:
                    self._finish_slot(slot)
                    break

    def _finish_slot(self, slot: int) -> None:
        req = self.active[slot]
        self.pos[slot] = self.max_len - 1
        self.temps[slot] = 0.0
        self.top_ps[slot] = 1.0
        self.generators[slot] = None
        result = (np.stack(req.hiddens) if req and req.hiddens
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
        reqs = [_SopranoRequest(prompt=np.ones(8, np.int64), max_tokens=self.tick_frames + 1,
                                temp=0.3, top_p=0.95, stop_ids=(), seed=0)
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
