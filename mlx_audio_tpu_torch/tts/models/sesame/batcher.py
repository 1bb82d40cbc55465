"""Continuous (slot-based) batching for Sesame/CSM frame generation
(counterpart of `mlx_audio_tpu/tts/models/sesame/batcher.py`): a pool of B
backbone-cache slots advances in lock-step. Each frame step runs the
batched backbone step and the depth decoder's K - 1 steps for every live
request at once.

A request joins a free slot at a tick boundary: its prompt is prefilled at
B = 1 into a cache of its bucket's length and copied into the slot. Every
sampler parameter is a per-row tensor (`lm.continuous._sample_rows_core`)
and each sampled slot draws from its own `torch.Generator`, seeded by its
request, so a request's frames depend only on its own seed; greedy slots
take the argmax, so their frames are the direct loop's. The JAX package
fuses a tick into one scan; here `_tick_n` is an eager loop over the tick's
frames that reads nothing back from the card until the tick's frames come to
the host, once a tick. The caches are float32, as the direct loop's.
"""

from __future__ import annotations

from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from ....lm.cache import KVCache
from ....lm.continuous import (SlotKVCache, _bucket, _install_slot, _sample_rows_core,
                               stages_used)
from ....serving import FrameBatcherBase, register_infer_hook, unregister_infer_hook
from .sesame import SesameModel

__all__ = ["SesameBatcher"]


def _additive(ok: torch.Tensor) -> torch.Tensor:
    return torch.where(ok, torch.zeros((), device=ok.device), float("-inf"))


def _prefill_b1(model: SesameModel, caches, tokens, tokens_mask, length: int) -> torch.Tensor:
    """The bucketed B = 1 prompt prefill → h_last (D,) of the last real
    position; the caches (of the bucket's length) fill in place."""
    emb = model.embed_frames(tokens, tokens_mask)
    T = emb.shape[1]
    S = caches[0].max_len
    q = torch.arange(T, device=emb.device)[:, None]
    k = torch.arange(S, device=emb.device)[None, :]
    mask = _additive((k <= q) & (k < length))[None, None]
    h, _ = model.backbone(emb, caches, mask=mask)
    return h[0, length - 1]


def _set_row(buf: torch.Tensor, slot: int, row: torch.Tensor) -> torch.Tensor:
    buf[slot] = row.to(buf.dtype)
    return buf


def _sample_frame_rows(model: SesameModel, h_last, state) -> torch.Tensor:
    """`SesameModel.sample_frame` for every slot at once: one frame (B, K)
    with per-row temperature / top-k and each sampled row's own
    generator."""
    B = h_last.shape[0]
    dev = h_last.device
    ones = torch.ones(B, device=dev)
    no_win = torch.zeros(B, dtype=torch.long, device=dev)
    no_hist = torch.full((B, 1), -1, dtype=torch.long, device=dev)

    def samp(logits, _generator):
        return _sample_rows_core(logits.float(), state.generators, no_hist, state.temps, ones,
                                 state.top_ks, ones, no_win, stages=state.stages)

    return model.sample_frame(h_last, None, 0.0, 0, sampler=samp)


def _tick_n(model: SesameModel, state, n: int) -> torch.Tensor:
    """`n` lock-step frame steps for every slot → frames (B, n, K) on the
    card. `state` advances in place: the caches, h_last and pos."""
    s = state
    k_idx = torch.arange(s.caches[0].max_len, device=s.pos.device)[None, :]
    out = []
    for _ in range(n):
        frame = _sample_frame_rows(model, s.h_last, s)
        for c in s.caches:
            c.pos = s.pos
        mask = _additive(k_idx <= s.pos[:, None])[:, None, None, :]
        h, _ = model.backbone(model.frame_embedding(frame), s.caches,
                              positions=s.pos[:, None], mask=mask)
        # the carry keeps its dtype under bf16 weights
        s.h_last = h[:, -1].to(s.h_last.dtype)
        s.pos = s.pos + 1
        out.append(frame)
    return torch.stack(out, dim=1)


@dataclass
class _FrameRequest:
    tokens: np.ndarray  # (1, T, K + 1) prompt token frames
    tokens_mask: np.ndarray
    max_frames: int
    temp: float
    top_k: int
    seed: int
    future: Future = field(default_factory=Future)
    frames: list = field(default_factory=list)  # emitted (K,) rows
    on_frame: object = None  # streaming sink, one (K,) row a call


class _SlotState:
    """The pool's tensors on the card: the caches and h_last (kept there
    across ticks), and the positions and sampler parameters (uploaded from
    the host at each tick)."""


class SesameBatcher(FrameBatcherBase):
    """Slot-based continuous batching over a `SesameModel`. `submit`
    resolves to the generated code frames (n, K) np.int32; the Mimi decode
    and the watermark stay on the caller's thread."""

    def __init__(self, model, slots: int = 4, max_len: int = 2048, tick_frames: int = 8):
        # the outer `Model` (the hook's key) or a bare SesameModel
        self._owner = model
        self.model = model if isinstance(model, SesameModel) else model.model
        self.max_len = max_len
        self.pos = np.full(slots, max_len - 1, np.int64)  # a free slot's scratch index
        self.temps = np.zeros(slots, np.float32)
        self.top_ks = np.zeros(slots, np.int64)
        self.generators: List[Optional[torch.Generator]] = [None] * slots
        self._build_device_state(slots)
        super().__init__(slots=slots, tick_frames=tick_frames, device=self.model.device)

    def _build_device_state(self, slots):
        cfg = self.model.args
        dev = self.model.device
        s = _SlotState()
        s.caches = [SlotKVCache(slots, cfg.num_key_value_heads, self.max_len, cfg.head_dim,
                                torch.float32, dev)
                    for _ in range(cfg.num_hidden_layers)]
        s.h_last = torch.zeros(slots, cfg.hidden_size, dtype=self.model.audio_head.dtype,
                               device=dev)
        self.state = s

    def submit(self, tokens, tokens_mask, max_frames: int = 1024, temp: float = 0.9,
               top_k: int = 50, seed: int = 0, on_frame=None) -> Future:
        req = _FrameRequest(tokens=np.asarray(tokens, np.int64),
                            tokens_mask=np.asarray(tokens_mask, bool),
                            max_frames=int(max_frames), temp=float(temp), top_k=int(top_k),
                            seed=int(seed), on_frame=on_frame)
        return self.submit_request(req)

    # -- FrameBatcherBase hooks ---------------------------------------

    def _admit(self, req: _FrameRequest, slot: int) -> None:
        T = req.tokens.shape[1]
        if T >= self.max_len:
            raise ValueError(f"prompt length {T} >= capacity {self.max_len}")
        dev = self.model.device
        P = min(_bucket(T), self.max_len)
        cfg = self.model.args
        toks = np.zeros((1, P, req.tokens.shape[2]), np.int64)
        toks[:, :T] = req.tokens
        mask = np.zeros((1, P, req.tokens.shape[2]), bool)
        mask[:, :T] = req.tokens_mask
        single = [KVCache(1, cfg.num_key_value_heads, P, cfg.head_dim,
                          dtype=torch.float32, device=dev)
                  for _ in range(cfg.num_hidden_layers)]
        h0 = _prefill_b1(self.model, single, torch.as_tensor(toks, device=dev),
                         torch.as_tensor(mask, device=dev), T)
        s = self.state
        _install_slot(s.caches, single, slot, T)
        _set_row(s.h_last, slot, h0)
        self.pos[slot] = T
        self.temps[slot] = req.temp
        self.top_ks[slot] = req.top_k
        gen = None
        if req.temp > 0:
            gen = torch.Generator(device=dev)
            gen.manual_seed(req.seed)
        self.generators[slot] = gen

    def _upload(self) -> None:
        """The host's positions and sampler parameters to the card, and the
        sampler stages some row uses (the others are skipped)."""
        s = self.state
        dev = self.model.device
        s.pos = torch.from_numpy(self.pos.copy()).to(dev)
        s.top_ks = torch.from_numpy(self.top_ks.copy()).to(dev)
        s.temps = torch.from_numpy(self.temps.copy()).to(dev)
        s.generators = list(self.generators)
        n = len(self.temps)
        s.stages = stages_used(self.temps, np.ones(n), self.top_ks, np.ones(n))

    def _tick(self, n: int) -> None:
        self._upload()
        frames = _tick_n(self.model, self.state, n)
        frames_np = frames.cpu().numpy().astype(np.int32)  # the tick's one read
        self.steps += 1  # before _finish: future observers see the count
        for slot, req in enumerate(self.active):
            if req is None:
                continue
            for j in range(n):
                f = frames_np[slot, j]
                if (f == 0).all():  # the EOS frame is not kept
                    self._finish_slot(slot)
                    break
                req.frames.append(f)
                self._emit(req, f)
                self.pos[slot] += 1
                if len(req.frames) >= req.max_frames or self.pos[slot] >= self.max_len - 1:
                    self._finish_slot(slot)
                    break

    def _free_slot(self, slot: int) -> None:
        self.pos[slot] = self.max_len - 1
        self.temps[slot] = 0.0
        self.top_ks[slot] = 0
        self.generators[slot] = None

    def _finish_slot(self, slot: int) -> None:
        req = self.active[slot]
        self._free_slot(slot)
        K = self.model.args.audio_num_codebooks
        result = (np.stack(req.frames).astype(np.int32) if req.frames
                  else np.zeros((0, K), np.int32))
        self._finish(slot, result)

    def _fail_all(self, e: Exception) -> None:
        for slot, req in enumerate(self.active):
            if req is not None and not req.future.done():
                req.future.set_exception(e)
            self.active[slot] = None
            self._free_slot(slot)
        self._build_device_state(self.slots)

    # -- pipeline integration -----------------------------------------

    def warmup(self):
        """One concurrent wave of tiny requests, one a slot: every slot's
        prefill, install and a tick run before live traffic."""
        K = self.model.args.audio_num_codebooks
        T = 8
        toks = np.zeros((1, T, K + 1), np.int64)
        toks[:, :, -1] = np.arange(1, T + 1)
        mask = np.zeros((1, T, K + 1), bool)
        mask[:, :, -1] = True
        reqs = [_FrameRequest(tokens=toks, tokens_mask=mask, max_frames=self.tick_frames,
                              temp=0.9, top_k=50, seed=0)
                for _ in range(self.slots)]
        self.warmup_requests(reqs)

    def install(self):
        register_infer_hook(self._owner, self)
        return self

    def close(self):
        unregister_infer_hook(self._owner)
        super().close()
