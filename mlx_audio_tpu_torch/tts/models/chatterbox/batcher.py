"""Slot-based continuous batching of Chatterbox's T3 decode (counterpart of
`mlx_audio_tpu/tts/models/chatterbox/batcher.py`).

A pool of request slots decodes in lock-step, a tick of n steps an eager
loop on the card, read back once a tick. T3's classifier-free guidance
pairs every request with an unconditional row, so slot i owns the two
adjacent cache rows 2i (cond) and 2i + 1 (uncond): each step runs the
transformer once over all 2B rows, combines each pair's logits
(cond + w·(cond − uncond)) and samples each slot with T3's own filter
order (`t3.sample_rows`, which `T3.decode` runs too: the repetition
penalty, then 1/max(temp, 1e-5), min-p on the probabilities, top-p with
its cutoff rule; temperature 0 the argmax). A request's pair is
prefilled at B = 2 into caches of its prompt bucket's length and copied
into its rows; the decode goes on right after the prompt, so the rope
positions and the learned speech positions are the single-request
decode's. The caches are float32. A sampled slot draws from its own
`torch.Generator`, seeded by its request, so its tokens depend only on
its seed, and are `T3.decode`'s for that seed.
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
from .t3 import REP_HIST, sample_rows

__all__ = ["T3Batcher"]


def _tick_n(t3, caches: List[SlotKVCache], tokens, pos_rows, emb_idx, generators, hist, temps,
            top_ps, min_ps, rep_pens, cfg_ws, n: int):
    """n lock-step CFG steps of every slot → tokens (B, n) on the card.
    tokens, emb_idx and the sampler's parameters are per slot (B,), top_ps
    None where no slot filters by top-p; pos_rows per row (2B,): both rows
    of a pair share a position."""
    out = []
    for _ in range(n):
        emb = t3.speech_emb(tokens) + t3.speech_pos_emb.emb(emb_idx)  # (B, D)
        for c in caches:
            c.pos = pos_rows
        h, _ = t3.tfmr(emb.repeat_interleave(2, dim=0)[:, None], caches,
                       positions=pos_rows[:, None], mask=_slot_mask(pos_rows, caches[0].max_len))
        logits = t3.speech_head(h[:, -1]).float()  # (2B, V)
        lc, lu = logits[0::2], logits[1::2]
        tokens = sample_rows(lc + cfg_ws[:, None] * (lc - lu), generators, hist, temps,
                             top_ps, min_ps, rep_pens)
        hist = torch.cat([hist[:, 1:], tokens[:, None]], dim=1)
        out.append(tokens)
        pos_rows = pos_rows + 1
        emb_idx = emb_idx + 1
    return torch.stack(out, dim=1)


@dataclass
class _T3Request:
    embeds: np.ndarray  # (2, T0, D): the [cond | text | bos] pair
    max_tokens: int
    temp: float
    top_p: float
    min_p: float
    rep_penalty: float
    cfg_weight: float
    seed: int
    future: Future = field(default_factory=Future)
    tokens: list = field(default_factory=list)
    on_frame: object = None  # streaming sink, one speech token a call


class T3Batcher(FrameBatcherBase):
    """Slot-based continuous batching over Chatterbox's T3. `submit` takes
    the prepared (2, T0, D) prompt pair (the conditioning and the text run
    on the caller's thread) and resolves to the speech tokens (n,) int32,
    the stop excluded; S3Gen stays on the caller's thread."""

    def __init__(self, model, slots: int = 4, max_len: int = 2048, tick_frames: int = 16,
                 **_ignored):
        self._owner = model
        self.t3 = model.t3
        self.max_len = max_len
        self.stop = int(self.t3.hp.stop_speech_token)
        self.slots = slots
        self._build_device_state(slots)
        rows = 2 * slots
        self.cur_tok = np.zeros(slots, np.int64)
        self.pos = np.full(rows, max_len - 1, np.int64)  # a free slot's scratch index
        self.emb_idx = np.zeros(slots, np.int64)
        self.hist = np.full((slots, REP_HIST), -1, np.int64)
        self.temps = np.zeros(slots, np.float32)
        self.top_ps = np.ones(slots, np.float32)
        self.min_ps = np.zeros(slots, np.float32)
        self.rep_pens = np.ones(slots, np.float32)
        self.cfg_ws = np.zeros(slots, np.float32)
        self.generators: List[Optional[torch.Generator]] = [None] * slots
        super().__init__(slots=slots, tick_frames=tick_frames, device=model.device)

    def _build_device_state(self, slots: int) -> None:
        cfg = self.t3.cfg
        self.caches = [SlotKVCache(2 * slots, cfg.num_key_value_heads, self.max_len,
                                   cfg.head_dim, torch.float32, self.t3.device)
                       for _ in range(cfg.num_hidden_layers)]

    def submit(self, embeds, *, max_tokens: int = 1000, temperature: float = 0.8,
               top_p: float = 0.95, min_p: float = 0.05, repetition_penalty: float = 1.2,
               cfg_weight: float = 0.5, seed: int = 0, on_frame=None) -> Future:
        emb = np.array(embeds, np.float32)  # a copy: the caller's may be read-only
        if emb.ndim != 3 or emb.shape[0] != 2:
            raise ValueError(f"submit takes a (2, T0, D) CFG prompt pair, not {emb.shape}")
        req = _T3Request(
            embeds=emb, max_tokens=min(int(max_tokens), self.t3.hp.max_speech_tokens),
            temp=float(temperature), top_p=float(top_p), min_p=float(min_p),
            rep_penalty=float(repetition_penalty), cfg_weight=float(cfg_weight),
            seed=int(seed), on_frame=on_frame)
        return self.submit_request(req)

    def _t(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.t3.device)

    # -- FrameBatcherBase hooks ---------------------------------------

    def _admit(self, req: _T3Request, slot: int) -> None:
        T = req.embeds.shape[1]
        if T >= self.max_len:
            raise ValueError(f"prompt length {T} >= capacity {self.max_len}")
        cfg = self.t3.cfg
        dev = self.t3.device
        P = min(_bucket(T), self.max_len)
        x = torch.zeros(2, P, req.embeds.shape[-1], device=dev)
        x[:, :T] = torch.as_tensor(req.embeds, device=dev)
        # the right padding is masked causally; the K/V it leaves are
        # overwritten before any query can see them
        pair = make_caches(cfg.num_hidden_layers, 2, cfg.num_key_value_heads, P, cfg.head_dim,
                           dtype=torch.float32, device=dev)
        h, _ = self.t3.tfmr(x, pair)
        for sc, c in zip(self.caches, pair):  # rows 2·slot (cond) and 2·slot + 1 (uncond)
            sc.k[2 * slot:2 * slot + 2, :, :P] = c.k
            sc.v[2 * slot:2 * slot + 2, :, :P] = c.v
        lg = self.t3.cfg_logits(h[:, T - 1], req.cfg_weight, True)
        gen = None
        if req.temp > 0:
            gen = torch.Generator(device=dev)
            gen.manual_seed(req.seed)
        top_p = self._t(np.array([req.top_p], np.float32)) if req.top_p < 1.0 else None
        first = int(sample_rows(
            lg, [gen], torch.full((1, REP_HIST), -1, dtype=torch.long, device=dev),
            self._t(np.array([req.temp], np.float32)), top_p,
            self._t(np.array([req.min_p], np.float32)), req.rep_penalty)[0])
        self.hist[slot] = -1
        if first == self.stop or req.max_tokens <= 1:
            # resolved at admit; `_tick` frees a slot whose future is done
            if first != self.stop:
                req.tokens.append(first)
                self._emit(req, first)
            req.future.set_result(np.asarray(req.tokens, np.int32))
            self.pos[2 * slot:2 * slot + 2] = self.max_len - 1
            self.temps[slot] = 0.0
            self.generators[slot] = None
            return
        req.tokens.append(first)
        self._emit(req, first)
        self.hist[slot, -1] = first
        self.cur_tok[slot] = first
        self.pos[2 * slot:2 * slot + 2] = T
        self.emb_idx[slot] = 1
        self.temps[slot] = req.temp
        self.top_ps[slot] = req.top_p
        self.min_ps[slot] = req.min_p
        self.rep_pens[slot] = req.rep_penalty
        self.cfg_ws[slot] = req.cfg_weight
        self.generators[slot] = gen

    def _tick(self, n: int) -> None:
        toks = _tick_n(self.t3, self.caches, self._t(self.cur_tok), self._t(self.pos),
                       self._t(self.emb_idx), list(self.generators), self._t(self.hist),
                       self._t(self.temps),
                       self._t(self.top_ps) if (self.top_ps < 1.0).any() else None,
                       self._t(self.min_ps),
                       self._t(self.rep_pens), self._t(self.cfg_ws), n)
        toks_np = toks.cpu().numpy()  # (slots, n)
        self.steps += 1  # before _finish: future observers see the count
        for slot, req in enumerate(self.active):
            if req is None:
                continue
            if req.future.done():  # resolved at admit: free the slot
                self.active[slot] = None
                continue
            for j in range(n):
                tok = int(toks_np[slot, j])
                if tok == self.stop:  # the stop is not part of the result
                    self._finish_slot(slot)
                    break
                req.tokens.append(tok)
                self._emit(req, tok)
                self.hist[slot] = np.roll(self.hist[slot], -1)
                self.hist[slot, -1] = tok
                self.cur_tok[slot] = tok
                self.pos[2 * slot:2 * slot + 2] += 1
                self.emb_idx[slot] += 1
                if len(req.tokens) >= req.max_tokens or self.pos[2 * slot] >= self.max_len - 1:
                    self._finish_slot(slot)
                    break

    def _finish_slot(self, slot: int) -> None:
        req = self.active[slot]
        self.pos[2 * slot:2 * slot + 2] = self.max_len - 1
        self.temps[slot] = 0.0
        self.top_ps[slot] = 1.0
        self.min_ps[slot] = 0.0
        self.rep_pens[slot] = 1.0
        self.cfg_ws[slot] = 0.0
        self.generators[slot] = None
        self._finish(slot, np.asarray(req.tokens if req else [], np.int32))

    def _fail_all(self, e: Exception) -> None:
        for slot, req in enumerate(self.active):
            if req is not None and not req.future.done():
                req.future.set_exception(e)
            self.active[slot] = None
            self.pos[2 * slot:2 * slot + 2] = self.max_len - 1
            self.generators[slot] = None
        self._build_device_state(self.slots)

    # -- pipeline integration -----------------------------------------

    def warmup(self):
        """A concurrent wave of tiny zero prompts, one a slot: the smallest
        prefill bucket, every slot's install and a tick run before live
        traffic."""
        emb = np.zeros((2, 8, self.t3.dim), np.float32)
        self.warmup_requests([
            _T3Request(embeds=emb, max_tokens=self.tick_frames + 1, temp=0.8, top_p=0.95,
                       min_p=0.05, rep_penalty=1.2, cfg_weight=0.5, seed=0)
            for _ in range(self.slots)])

    def install(self):
        from ....serving import register_infer_hook

        register_infer_hook(self._owner, self)
        return self

    def close(self):
        from ....serving import unregister_infer_hook

        unregister_infer_hook(self._owner)
        super().close()

