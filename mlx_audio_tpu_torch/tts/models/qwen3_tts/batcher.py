"""Continuous (slot-based) batching for Qwen3-TTS frame generation
(counterpart of `mlx_audio_tpu/tts/models/qwen3_tts/batcher.py`): a pool of
B talker-cache slots advances in lock-step. Each frame step batches, across
every slot, the talker step, the specials suppression, the per-slot
min-length, repetition penalty and sampling, and the code predictor's inner
loop over the codebooks.

As in the JAX package, the slot caches are compact: the bucketed prefill is
installed as a contiguous prefix and decode continues right after it, so the
attention mask is `k <= pos[b]` per row; and every sampler parameter is a
per-row tensor (`lm.continuous._sample_rows_core`), so any request mix goes
through one code path and a request's frames depend only on its own seed.
The caches are float32, as the single-request path's.

The JAX package fuses a tick into one scan; here `_tick_n` is an eager loop
over the tick's frames that reads nothing back from the card until the
tick's codes come to the host, once a tick. The sampler draws each sampled
slot's noise from the slot's own `torch.Generator` (see `lm/continuous.py`):
one launch per sampled slot per draw, 16 draws a frame.
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

__all__ = ["Qwen3TTSBatcher"]

REP_HIST = 64  # the single-request path's fixed (1, 64) window


def _additive(ok: torch.Tensor) -> torch.Tensor:
    return torch.where(ok, torch.zeros((), device=ok.device), float("-inf"))


def _prefill_b1(talker, caches, input_embeds, length: int):
    """Bucketed B=1 prompt prefill → (float32 logits (V,), hidden (D,)); the
    caches (of the bucket's length) fill in place."""
    Tp = input_embeds.shape[1]
    S = caches[0].max_len
    q = torch.arange(Tp, device=input_embeds.device)[:, None]
    k = torch.arange(S, device=input_embeds.device)[None, :]
    mask = _additive((k <= q) & (k < length))[None, None]
    logits, hidden = talker(input_embeds, caches, mask)
    last = min(max(length - 1, 0), Tp - 1)
    return logits[0, last].float(), hidden[0, last]


def _specials_lo(cfg) -> int:
    """The start of the suppressed specials block at the top of the vocab
    (its lowest special id for vocabularies of 1024 or less), as the
    single-request path."""
    lo = cfg.vocab_size - 1024
    if lo <= 0:
        lo = min(cfg.codec_eos_token_id, cfg.codec_think_id, cfg.codec_nothink_id,
                 cfg.codec_think_bos_id, cfg.codec_think_eos_id, cfg.codec_pad_id,
                 cfg.codec_bos_id)
    return lo


def _tick_n(model, state, n: int) -> torch.Tensor:
    """`n` lock-step frame steps for every slot → codes (B, n, G) on the
    card (column 0 is the talker's c0; a row that drew EOS goes on producing
    frames for the rest of the tick, which the host drops). `state` (a
    `_SlotState`) advances in place: caches, logits, hidden, the history
    window and the per-row counters. Nothing is read back from the card."""
    talker = model.talker
    cfg = talker.config
    cp = talker.code_predictor
    G, eos, V = cfg.num_code_groups, cfg.codec_eos_token_id, cfg.vocab_size
    s = state
    B = s.pos.shape[0]
    dev = s.pos.device

    vocab_idx = torch.arange(V, device=dev)
    suppress = (vocab_idx >= _specials_lo(cfg)) & (vocab_idx != eos)
    is_eos = vocab_idx == eos
    heads = model._stacked_heads()
    full_win = torch.full((B,), REP_HIST, dtype=torch.long, device=dev)
    no_pen = torch.ones(B, device=dev)
    no_win = torch.zeros(B, dtype=torch.long, device=dev)
    no_hist = torch.full((B, 1), -1, dtype=torch.long, device=dev)
    rows = torch.arange(B, device=dev)
    k_idx = torch.arange(s.caches[0].max_len, device=dev)[None, :]
    cp_stages = s.stages - {"penalty"}  # the codebooks take no repetition penalty

    def frame_codes(hidden_last, c0):
        """The code predictor's inner AR, batched across slots (the
        two-token seed, then one step a codebook, the last computed and
        unused, as the single-request path)."""
        cp_cos, cp_sin, tri = s.cp_tables
        for c in s.cp_caches:  # stale entries past `pos` are masked out
            c.pos = 0
        c0_embed = talker.model.codec_embedding(c0)  # (B, D)
        dt = torch.promote_types(hidden_last.dtype, c0_embed.dtype)
        seq = torch.stack([hidden_last.to(dt), c0_embed.to(dt)], dim=1)
        h = cp.model(cp.project(seq), s.cp_caches, mask=tri[None, None, 0:2],
                     cos_sin=(cp_cos[:, 0:2], cp_sin[:, 0:2]))
        codes = [c0]
        emb_sum = c0_embed
        for i in range(1, G):
            logits_i = torch.matmul(h[:, -1].float(), heads[i - 1].T)
            ci = _sample_rows_core(logits_i, s.generators, no_hist, s.temps, s.top_ps,
                                   s.top_ks, no_pen, no_win, stages=cp_stages)
            codes.append(ci)
            emb_i = cp.codec_embedding[i - 1](ci)  # (B, D)
            emb_sum = emb_sum + emb_i
            p = i + 1  # the cache slot this token takes
            h = cp.model(cp.project(emb_i[:, None]), s.cp_caches, mask=tri[None, None, p:p + 1],
                         cos_sin=(cp_cos[:, p:p + 1], cp_sin[:, p:p + 1]))
        return torch.stack(codes, dim=1), emb_sum

    out = []
    Ttr = s.trailing.shape[1]
    for _ in range(n):
        lg = s.logits.masked_fill(suppress, float("-inf"))
        # per-row min-length: EOS unreachable before min_toks[b] frames
        lg = lg.masked_fill((s.steps < s.min_toks)[:, None] & is_eos[None], float("-inf"))
        c0 = _sample_rows_core(lg, s.generators, s.hist, s.temps, s.top_ps, s.top_ks,
                               s.rep_pens, full_win, stages=s.stages)
        codes, emb_sum = frame_codes(s.hidden, c0)
        out.append(codes)
        s.hist = torch.cat([s.hist[:, 1:], c0[:, None]], dim=1)

        # the next input: the trailing text (then tts_pad) plus the frame's
        # codec embeddings
        text_embed = s.trailing[rows, s.tr_idx.clamp(0, Ttr - 1)]
        text_embed = torch.where((s.tr_idx < s.trailing_len)[:, None], text_embed,
                                 s.tts_pad[None, :])
        for c in s.caches:
            c.pos = s.pos
        mask = _additive(k_idx <= s.pos[:, None])[:, None, None, :]
        # a position past the capacity only feeds frames the host drops
        q_pos = s.pos.clamp(max=s.rope[0].shape[1] - 1)
        cos_sin = (s.rope[0][0, q_pos][:, None], s.rope[1][0, q_pos][:, None])
        new_logits, new_hidden = talker((text_embed + emb_sum)[:, None], s.caches, mask,
                                        cos_sin=cos_sin)
        s.logits = new_logits[:, -1].float()
        s.hidden = new_hidden[:, -1]
        s.pos = s.pos + 1
        s.tr_idx = s.tr_idx + 1
        s.steps = s.steps + 1
    return torch.stack(out, dim=1)


@dataclass
class _FrameRequest:
    input_embeds: object  # (1, T, D) prefill embeddings
    trailing: object  # (1, Ttr, D)
    max_tokens: int
    min_tokens: int
    temp: float
    top_k: int
    top_p: float
    rep_penalty: float
    seed: int
    future: Future = field(default_factory=Future)
    frames: list = field(default_factory=list)  # emitted (G,) rows
    on_frame: Optional[callable] = None  # streaming sink, one (G,) row a call


class _SlotState:
    """The pool's tensors on the card: the caches and the carried logits,
    hidden and history (kept there across ticks), and the per-row counters
    and sampler parameters (uploaded from the host at each tick)."""


class Qwen3TTSBatcher(FrameBatcherBase):
    """Slot-based continuous batching over a Qwen3-TTS model. `submit` takes
    prepared prefill and trailing embeddings (host prep, the tokenizer,
    happens on the caller's thread) and resolves to the generated codec
    frames (n, G) np.int32; the codec decode stays on the caller's thread."""

    def __init__(self, model, slots: int = 4, max_len: int = 4096,
                 tick_frames: int = 16, trailing_max: int = 512):
        self._owner = model
        self.talker = model.talker
        self.max_len = max_len
        self.trailing_max = trailing_max
        with torch.inference_mode():
            # model-constant tts_pad embedding, fed after the trailing text runs out
            self.tts_pad = model._text_embed([model.config.tts_pad_token_id])[0, 0]
        self._dtype = self.talker.model.codec_embedding.weight.dtype
        self.pos = np.full(slots, max_len - 1, np.int64)  # a free slot's scratch index
        self.trailing_len = np.zeros(slots, np.int64)
        self.tr_idx = np.zeros(slots, np.int64)
        self.frame_steps = np.zeros(slots, np.int64)
        self.min_toks = np.zeros(slots, np.int64)
        self.temps = np.zeros(slots, np.float32)
        self.top_ps = np.ones(slots, np.float32)
        self.top_ks = np.zeros(slots, np.int64)
        self.rep_pens = np.ones(slots, np.float32)
        self.generators: List[Optional[torch.Generator]] = [None] * slots
        self._build_device_state(slots)
        super().__init__(slots=slots, tick_frames=tick_frames, device=model.device)

    def _build_device_state(self, slots):
        cfg = self.talker.config
        dev = self._owner.device
        s = _SlotState()
        s.caches = [SlotKVCache(slots, cfg.num_key_value_heads, self.max_len, cfg.head_dim,
                                torch.float32, dev)
                    for _ in range(cfg.num_hidden_layers)]
        s.logits = torch.zeros(slots, cfg.vocab_size, device=dev)
        s.hidden = None  # the talker's output dtype, made at the first admission
        s.hist = torch.full((slots, REP_HIST), -1, dtype=torch.long, device=dev)
        s.trailing = torch.zeros(slots, self.trailing_max, cfg.hidden_size, dtype=self._dtype,
                                 device=dev)
        s.tts_pad = self.tts_pad
        with torch.inference_mode():
            # rope of every position a slot can hold; the code predictor's
            # tables, as the single-request path makes them
            s.rope = self.talker.model.rotary_emb(torch.arange(self.max_len, device=dev)[None])
            cp = self.talker.code_predictor
            G = cfg.num_code_groups
            s.cp_caches = cp.model.make_caches(slots, G + 2)
            cp_cos, cp_sin = cp.model.rope(torch.arange(G + 2, device=dev)[None])
            j = torch.arange(G + 2, device=dev)
            s.cp_tables = (cp_cos, cp_sin, _additive(j[None, :] <= j[:, None]))
        self.state = s

    def submit(self, input_embeds, trailing, *, max_tokens: int = 4096,
               min_tokens: int = 0, temperature: float = 0.9, top_k: int = 50,
               top_p: float = 1.0, repetition_penalty: float = 1.05, seed: int = 0,
               on_frame=None) -> Future:
        req = _FrameRequest(
            input_embeds=input_embeds, trailing=trailing,
            max_tokens=int(max_tokens), min_tokens=int(min_tokens),
            temp=float(temperature), top_k=int(top_k), top_p=float(top_p),
            rep_penalty=float(repetition_penalty), seed=int(seed), on_frame=on_frame,
        )
        return self.submit_request(req)

    # -- FrameBatcherBase hooks ---------------------------------------

    def _admit(self, req: _FrameRequest, slot: int) -> None:
        dev = self._owner.device
        emb = torch.as_tensor(req.input_embeds, device=dev)
        tr = torch.as_tensor(req.trailing, device=dev)
        T, Ttr = emb.shape[1], tr.shape[1]
        if T >= self.max_len:
            raise ValueError(f"prompt length {T} >= capacity {self.max_len}")
        if Ttr > self.trailing_max:
            raise ValueError(f"trailing text length {Ttr} > batcher trailing_max "
                             f"{self.trailing_max}")
        cfg = self.talker.config
        P = min(_bucket(T), self.max_len)
        inp = emb.new_zeros(1, P, emb.shape[-1])
        inp[:, :T] = emb
        single = [KVCache(1, cfg.num_key_value_heads, P, cfg.head_dim, dtype=torch.float32,
                          device=dev)
                  for _ in range(cfg.num_hidden_layers)]
        l0, h0 = _prefill_b1(self.talker, single, inp, T)
        s = self.state
        _install_slot(s.caches, single, slot, T)
        s.logits[slot] = l0
        if s.hidden is None:
            s.hidden = torch.zeros(self.slots, h0.shape[-1], dtype=h0.dtype, device=dev)
        s.hidden[slot] = h0
        s.trailing[slot].zero_()
        s.trailing[slot, :Ttr] = tr[0].to(s.trailing.dtype)
        s.hist[slot] = -1
        self.pos[slot] = T
        self.trailing_len[slot] = Ttr
        self.tr_idx[slot] = 0
        self.frame_steps[slot] = 0
        self.min_toks[slot] = req.min_tokens
        self.temps[slot] = req.temp
        self.top_ps[slot] = req.top_p
        self.top_ks[slot] = req.top_k
        self.rep_pens[slot] = req.rep_penalty
        gen = None
        if req.temp > 0:
            gen = torch.Generator(device=dev)
            gen.manual_seed(req.seed)
        self.generators[slot] = gen

    def _upload(self) -> None:
        """The host's per-row counters and sampler parameters to the card,
        two copies a tick (the previous tick's read has emptied the queue),
        and the sampler stages some row uses (the others are skipped)."""
        s = self.state
        dev = self._owner.device
        ints = torch.from_numpy(np.stack([self.pos, self.tr_idx, self.frame_steps,
                                          self.min_toks, self.trailing_len,
                                          self.top_ks])).to(dev)
        floats = torch.from_numpy(np.stack([self.temps, self.top_ps, self.rep_pens])).to(dev)
        s.pos, s.tr_idx, s.steps, s.min_toks, s.trailing_len, s.top_ks = ints
        s.temps, s.top_ps, s.rep_pens = floats
        s.generators = list(self.generators)
        s.stages = stages_used(self.temps, self.top_ps, self.top_ks, self.rep_pens)

    def _tick(self, n: int) -> None:
        self._upload()
        codes = _tick_n(self._owner, self.state, n)
        codes_np = codes.cpu().numpy().astype(np.int32)  # the tick's one read
        self.steps += 1  # before _finish: future observers see the count
        eos = self.talker.config.codec_eos_token_id
        for slot, req in enumerate(self.active):
            if req is None:
                continue
            for j in range(n):
                if int(codes_np[slot, j, 0]) == eos:  # the EOS frame is not kept
                    self._finish_slot(slot)
                    break
                req.frames.append(codes_np[slot, j])
                self._emit(req, codes_np[slot, j])
                self.pos[slot] += 1
                self.tr_idx[slot] += 1
                self.frame_steps[slot] += 1
                if len(req.frames) >= req.max_tokens or self.pos[slot] >= self.max_len - 1:
                    self._finish_slot(slot)
                    break

    def _free_slot(self, slot: int) -> None:
        self.pos[slot] = self.max_len - 1
        self.temps[slot] = 0.0
        self.top_ps[slot] = 1.0
        self.top_ks[slot] = 0
        self.rep_pens[slot] = 1.0
        self.generators[slot] = None

    def _finish_slot(self, slot: int) -> None:
        req = self.active[slot]
        self._free_slot(slot)
        G = self.talker.config.num_code_groups
        result = (np.stack(req.frames).astype(np.int32) if req.frames
                  else np.zeros((0, G), np.int32))
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
        emb, tr, _pad = self._owner._prepare_generation_inputs("Warm up the batcher.")
        reqs = [_FrameRequest(input_embeds=emb, trailing=tr, max_tokens=self.tick_frames,
                              min_tokens=self.tick_frames, temp=0.9, top_k=50, top_p=1.0,
                              rep_penalty=1.05, seed=0)
                for _ in range(self.slots)]
        self.warmup_requests(reqs)

    def install(self):
        register_infer_hook(self._owner, self)
        return self

    def close(self):
        unregister_infer_hook(self._owner)
        super().close()
