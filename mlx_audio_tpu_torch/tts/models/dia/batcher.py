"""Continuous (slot-based) batching for Dia's CFG decode (counterpart of
`mlx_audio_tpu/tts/models/dia/batcher.py`): a pool of B request slots, each
owning a CFG pair of decoder cache rows (rows 2i and 2i + 1: uncond and
cond, as `_generate_loop`'s pair) and its own cross-attention K/V, advances
in lock-step, `tick_frames` frames a tick.

The per-step math (CFG combine, top-k filter, delay-BOS forcing, the EOS
cascade) is `_generate_loop`'s. The JAX package fuses a tick into one scan;
here `_tick_n` is an eager loop over the tick's frames that reads nothing
back from the card until the tick's frames come to the host, once a tick.
Each sampled slot draws from its own `torch.Generator`, seeded by its
request, one (C, V) Gumbel draw a step, as `_generate_loop` draws: a
request's frames depend only on its own seed; greedy slots take the argmax,
so their frames are the direct loop's.

The self caches are float32 (`SlotKVCache`), as the direct loop's; the
cross K/V keep the model's dtype, as the direct loop's do (the JAX package
stores them in float32). The text length is the config's `text_length`, so
every slot's cross K/V has one shape. A slot never admitted attends to zero
K/V (the JAX package masks all its keys, which gives NaN in rows nobody
reads).
"""

from __future__ import annotations

from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from ....lm.continuous import SlotKVCache
from ....lm.sample import top_k_filter
from ....serving import FrameBatcherBase, register_infer_hook, unregister_infer_hook
from .dia import _additive, _encode_text, _force, _text_pair

__all__ = ["DiaBatcher"]


def _tick_n(model, state, n: int, top_k: int, eos: int, pad: int, bos: int,
            delay: torch.Tensor) -> torch.Tensor:
    """`n` lock-step CFG frame steps for every slot → preds (B, n, C) on the
    card. `state` advances in place: the caches, cur_tok, pos, gen_step and
    eos_step."""
    s = state
    B, C = s.cur_tok.shape
    k_idx = torch.arange(s.caches[0].max_len, device=s.pos.device)[None, :]
    cross_kvs = list(zip(s.cross_ks, s.cross_vs))
    out = []
    for _ in range(n):
        tok2 = s.cur_tok.repeat_interleave(2, dim=0)[:, None]  # (2B, 1, C)
        for c in s.caches:
            c.pos = s.pos
        amask = _additive(k_idx <= s.pos[:, None])[:, None, None, :]
        logits, _ = model.decoder(tok2, s.pos[:, None], s.caches, cross_kvs, self_mask=amask,
                                  cross_mask=s.cross_mask)
        last = logits[:, -1].reshape(B, 2, C, -1)
        cfg = last[:, 1] + s.cfg_scales[:, None, None] * (last[:, 1] - last[:, 0])
        cfg[:, :, eos + 1:] = float("-inf")
        pred = torch.argmax(cfg, dim=-1)
        if s.sampled:
            x = cfg / s.temps.clamp(min=1e-6)[:, None, None]
            if top_k > 0:
                x = top_k_filter(x, top_k)
            e = torch.ones_like(x)
            for b in s.sampled:
                e[b].exponential_(generator=s.generators[b])
            sampled = torch.argmax(x - torch.log(e), dim=-1)
            pred = torch.where((s.temps == 0)[:, None], pred, sampled)
        pred, s.eos_step = _force(pred, s.gen_step, s.eos_step, delay, eos, pad, bos)
        s.cur_tok = pred
        s.pos = s.pos + 1
        s.gen_step = s.gen_step + 1
        out.append(pred)
    return torch.stack(out, dim=1)


@dataclass
class _DiaRequest:
    src: np.ndarray  # (S,) padded byte tokens
    src_mask: np.ndarray  # (S,) bool
    max_tokens: int
    cfg_scale: float
    temp: float
    seed: int
    future: Future = field(default_factory=Future)
    frames: list = field(default_factory=list)  # emitted (C,) rows
    on_frame: object = None  # streaming sink, one (C,) row a call


class _SlotState:
    """The pool's tensors on the card: the caches, the cross K/V and mask
    (kept there across ticks), and each tick's inputs uploaded from the host
    (tokens, positions, steps, sampler parameters)."""


class DiaBatcher(FrameBatcherBase):
    """Slot-based continuous batching over a Dia model. `submit` takes the
    padded byte tokens and mask (`Model._prepare_text`, on the caller's
    thread) and resolves to the generated delay-pattern frames (n, C)
    np.int32, the EOS cascade's rows included (`_generate_loop`'s frames);
    the DAC decode stays on the caller's thread.

    `cfg_filter_top_k` is one value a batcher (the server's default 35); a
    request wanting another takes the single-request loop."""

    def __init__(self, model, slots: int = 4, tick_frames: int = 8,
                 max_tokens_cap: Optional[int] = None, cfg_filter_top_k: int = 35,
                 **_ignored):
        self._owner = model
        self.model = model.model  # DiaModel
        self.config = model.config
        self.device = model.device
        data = self.config.data
        self.top_k = int(cfg_filter_top_k)
        self.C = data.channels
        self.delay = tuple(data.delay_pattern)
        self.max_delay = max(self.delay)
        self.eos = int(data.audio_eos_value)
        self.pad = int(data.audio_pad_value)
        self.bos = int(data.audio_bos_value)
        self.S_text = data.text_length
        self.kv_len = (max_tokens_cap or data.audio_length) + self.max_delay + 64
        self.pos = np.full(2 * slots, self.kv_len - 1, np.int64)  # a free slot's scratch
        self.gen_step = np.zeros(slots, np.int64)
        self.eos_step = np.full(slots, -1, np.int64)
        self.cur_tok = np.zeros((slots, self.C), np.int64)
        self.cfg_scales = np.zeros(slots, np.float32)
        self.temps = np.zeros(slots, np.float32)
        self.generators: List[Optional[torch.Generator]] = [None] * slots
        self._build_device_state(slots)
        super().__init__(slots=slots, tick_frames=tick_frames, device=self.device)

    def _build_device_state(self, slots):
        dec = self.config.model.decoder
        dev = self.device
        dtype = self.model.decoder.norm.weight.dtype
        s = _SlotState()
        s.caches = [SlotKVCache(2 * slots, dec.kv_heads, self.kv_len, dec.gqa_head_dim,
                                torch.float32, dev) for _ in range(dec.n_layer)]
        shape = (2 * slots, dec.cross_query_heads, self.S_text, dec.cross_head_dim)
        s.cross_ks = [torch.zeros(shape, dtype=dtype, device=dev) for _ in range(dec.n_layer)]
        s.cross_vs = [torch.zeros(shape, dtype=dtype, device=dev) for _ in range(dec.n_layer)]
        s.cross_mask = torch.zeros(2 * slots, 1, 1, self.S_text, device=dev)
        self.state = s

    def submit(self, src, src_mask, *, max_tokens: Optional[int] = None,
               cfg_scale: float = 3.0, temperature: float = 1.3, seed: int = 0,
               on_frame=None) -> Future:
        data = self.config.data
        max_tokens = min(int(max_tokens or data.audio_length),
                         self.kv_len - self.max_delay - 64)
        req = _DiaRequest(src=np.asarray(src, np.int32).reshape(-1),
                          src_mask=np.asarray(src_mask, bool).reshape(-1),
                          max_tokens=max_tokens, cfg_scale=float(cfg_scale),
                          temp=float(temperature), seed=int(seed), on_frame=on_frame)
        return self.submit_request(req)

    # -- FrameBatcherBase hooks ---------------------------------------

    def _admit(self, req: _DiaRequest, slot: int) -> None:
        if req.src.shape[0] != self.S_text:
            raise ValueError(f"src length {req.src.shape[0]} != config text_length "
                             f"{self.S_text}")
        src2, pos, enc_mask, cmask = _text_pair(req.src, req.src_mask, self.device)
        _, cross_kvs = _encode_text(self.model, src2, pos, enc_mask)
        s = self.state
        rows = slice(2 * slot, 2 * slot + 2)
        for i, (k, v) in enumerate(cross_kvs):
            s.cross_ks[i][rows] = k
            s.cross_vs[i][rows] = v
        s.cross_mask[rows] = cmask
        self.pos[rows] = 0
        self.gen_step[slot] = 0
        self.eos_step[slot] = -1
        self.cur_tok[slot] = self.bos
        self.cfg_scales[slot] = req.cfg_scale
        self.temps[slot] = req.temp
        gen = None
        if req.temp > 0:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(req.seed)
        self.generators[slot] = gen

    def _upload(self) -> None:
        s = self.state
        dev = self.device
        for name in ("cur_tok", "pos", "gen_step", "eos_step", "cfg_scales", "temps"):
            setattr(s, name, torch.from_numpy(getattr(self, name).copy()).to(dev))
        s.generators = list(self.generators)
        s.sampled = [b for b, g in enumerate(self.generators) if g is not None]

    def _tick(self, n: int) -> None:
        self._upload()
        delay = torch.as_tensor(self.delay, device=self.device)
        preds = _tick_n(self.model, self.state, n, self.top_k, self.eos, self.pad, self.bos,
                        delay)
        preds_np = preds.cpu().numpy().astype(np.int32)  # the tick's one read
        self.steps += 1  # before _finish: future observers see the count
        for slot, req in enumerate(self.active):
            if req is None:
                continue
            for j in range(n):
                row = preds_np[slot, j]
                s = int(self.gen_step[slot])  # this frame's 0-based index
                req.frames.append(row)
                self._emit(req, row)
                self.cur_tok[slot] = row
                self.pos[2 * slot:2 * slot + 2] += 1
                self.gen_step[slot] += 1
                if self.eos_step[slot] < 0 and int(row[0]) == self.eos:
                    self.eos_step[slot] = s
                # _generate_loop's stop: the cascade's last row is step
                # eos_step + max_delay; max_tokens bounds the frames
                if ((self.eos_step[slot] >= 0 and s - int(self.eos_step[slot]) >= self.max_delay)
                        or self.gen_step[slot] >= req.max_tokens
                        or self.pos[2 * slot] >= self.kv_len - 1):
                    self._finish_slot(slot)
                    break

    def _free_slot(self, slot: int) -> None:
        self.pos[2 * slot:2 * slot + 2] = self.kv_len - 1
        self.temps[slot] = 0.0
        self.cfg_scales[slot] = 0.0
        self.eos_step[slot] = -1
        self.gen_step[slot] = 0
        self.generators[slot] = None

    def _finish_slot(self, slot: int) -> None:
        req = self.active[slot]
        self._free_slot(slot)
        result = (np.stack(req.frames).astype(np.int32) if req and req.frames
                  else np.zeros((0, self.C), np.int32))
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
        encode, install and a tick run before live traffic."""
        src = np.zeros(self.S_text, np.int32)
        src[:8] = np.arange(3, 11)
        reqs = [_DiaRequest(src=src, src_mask=src != 0, max_tokens=self.tick_frames,
                            cfg_scale=3.0, temp=1.3, seed=0)
                for _ in range(self.slots)]
        self.warmup_requests(reqs)

    def install(self):
        register_infer_hook(self._owner, self)
        return self

    def close(self):
        unregister_infer_hook(self._owner)
        super().close()
