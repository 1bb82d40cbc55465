"""Slot-based continuous batching of the CosyVoice2 and CosyVoice3
speech-token decode (counterpart of
`mlx_audio_tpu/tts/models/cosyvoice2/batcher.py`).

A pool of request slots decodes in lock-step, a tick of n steps an eager
loop on the card, read back once a tick. Each step samples every slot with
`llm.ras_sample` (the single-request decode's sampler), the EOS index masked
below a slot's minimum length; a sampled slot draws from its own
`torch.Generator`, seeded by its request, in the single-request decode's
order, so a request's tokens are that decode's for the same seed. The
caches are float32, the prompt prefilled at B = 1 into caches of its
bucket's length and copied into the slot's row; the decode goes on right
after the prompt, at the single-request decode's positions.

One batcher serves both generations (`v3`): CosyVoice2 stops on the token
V and feeds its fill tokens (V + 1, V + 2) without emitting them;
CosyVoice3 stops on any token ≥ V. The recent-token window follows the
emitted tokens only, on the card and on the host alike.
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
from .llm import WIN_SIZE, ras_sample

__all__ = ["RASBatcher"]


def _tick_n(lm, caches: List[SlotKVCache], logits, pos, steps, min_lens, hist,
            generators: List[Optional[torch.Generator]], eos: int, n: int):
    """n lock-step RAS steps of every slot → (tokens (B, n), logits, hist)
    on the card. `logits` (B, V) carries each slot's next-token logits from
    tick to tick; pos, steps and min_lens are per slot (B,)."""
    col = torch.arange(logits.shape[-1], device=logits.device)[None, :]
    out = []
    for _ in range(n):
        logp = torch.log_softmax(logits, dim=-1)
        logp = torch.where((col == eos) & (steps < min_lens)[:, None], float("-inf"), logp)
        tok = ras_sample(logp, hist, generators)
        emit = tok < eos
        hist = torch.where(emit[:, None], torch.cat([hist[:, 1:], tok[:, None]], dim=1), hist)
        for c in caches:
            c.pos = pos
        h, _ = lm.llm.hidden_states(lm.speech_embedding(tok)[:, None], caches,
                                    positions=pos[:, None],
                                    mask=_slot_mask(pos, caches[0].max_len))
        logits = lm.llm_decoder(h[:, -1]).float()
        out.append(tok)
        pos = pos + 1
        steps = steps + 1
    return torch.stack(out, dim=1), logits, hist


@dataclass
class _RASRequest:
    embeds: np.ndarray  # (1, T0, D): [sos | text | task | prompt speech]
    min_tokens: int
    max_steps: int  # the cap on decode steps (the text's length times the ratio)
    seed: int
    future: Future = field(default_factory=Future)
    tokens: list = field(default_factory=list)  # the emitted speech tokens
    on_frame: object = None  # streaming sink, one speech token a call


class RASBatcher(FrameBatcherBase):
    """Slot-based continuous batching over a CosyVoice2 or CosyVoice3 LM.
    `submit` takes the prepared (1, T0, D) prompt embeddings (built on the
    caller's thread) and resolves to the emitted speech tokens (n,) int32;
    the flow and the vocoder stay on the caller's thread."""

    def __init__(self, model, lm=None, v3: bool = False, slots: int = 4, max_len: int = 4096,
                 tick_frames: int = 16, **_ignored):
        self._owner = model
        self.lm = lm if lm is not None else model.llm
        self.v3 = bool(v3)
        self.eos = int(self.lm.speech_token_size)
        self.max_len = max_len
        self.slots = slots
        self._build_device_state(slots)
        self.pos = np.full(slots, max_len - 1, np.int64)  # a free slot's scratch index
        self.steps_ctr = np.zeros(slots, np.int64)
        self.hist = np.full((slots, WIN_SIZE), -1, np.int64)
        self.min_lens = np.zeros(slots, np.int64)
        self.generators: List[Optional[torch.Generator]] = [None] * slots
        super().__init__(slots=slots, tick_frames=tick_frames, device=self.lm.device)

    def _build_device_state(self, slots: int) -> None:
        cfg = self.lm.llm.config
        dev = self.lm.device
        self.caches = [SlotKVCache(slots, cfg.num_key_value_heads, self.max_len, cfg.head_dim,
                                   torch.float32, dev) for _ in range(cfg.num_hidden_layers)]
        self.logits = torch.zeros(slots, self.lm.n_out, device=dev)

    def submit(self, embeds, *, min_tokens: int = 0, max_steps: int = 2048, seed: int = 0,
               on_frame=None) -> Future:
        emb = np.array(embeds, np.float32)  # a copy: the caller's may be read-only
        if emb.ndim == 2:
            emb = emb[None]
        return self.submit_request(_RASRequest(embeds=emb, min_tokens=int(min_tokens),
                                               max_steps=int(max_steps), seed=int(seed),
                                               on_frame=on_frame))

    def _t(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.lm.device)

    # -- FrameBatcherBase hooks ---------------------------------------

    def _admit(self, req: _RASRequest, slot: int) -> None:
        T = req.embeds.shape[1]
        if T >= self.max_len:
            raise ValueError(f"prompt length {T} >= capacity {self.max_len}")
        cfg = self.lm.llm.config
        dev = self.lm.device
        P = min(_bucket(T), self.max_len)
        x = torch.zeros(1, P, req.embeds.shape[-1], device=dev)
        x[:, :T] = torch.as_tensor(req.embeds, device=dev)
        # the right padding is masked causally; the K/V it leaves are
        # overwritten before any query can see them
        single = make_caches(cfg.num_hidden_layers, 1, cfg.num_key_value_heads, P,
                             cfg.head_dim, dtype=torch.float32, device=dev)
        h, _ = self.lm.llm.hidden_states(x.to(self.lm.dtype), single)
        for sc, c in zip(self.caches, single):
            sc.k[slot, :, :P] = c.k[0]
            sc.v[slot, :, :P] = c.v[0]
        self.logits[slot] = self.lm.llm_decoder(h[:, T - 1]).float()[0]
        gen = torch.Generator(device=dev)
        gen.manual_seed(req.seed)
        self.generators[slot] = gen
        self.pos[slot] = T
        self.steps_ctr[slot] = 0
        self.hist[slot] = -1
        self.min_lens[slot] = req.min_tokens

    def _tick(self, n: int) -> None:
        toks, self.logits, hist = _tick_n(
            self.lm, self.caches, self.logits, self._t(self.pos), self._t(self.steps_ctr),
            self._t(self.min_lens), self._t(self.hist), list(self.generators), self.eos, n)
        toks_np = toks.cpu().numpy()  # (slots, n)
        self.hist = hist.cpu().numpy()
        self.steps += 1  # before _finish: future observers see the count
        for slot, req in enumerate(self.active):
            if req is None:
                continue
            for j in range(n):
                tok = int(toks_np[slot, j])
                if (tok >= self.eos) if self.v3 else (tok == self.eos):
                    self._finish_slot(slot)
                    break
                if tok < self.eos:  # CosyVoice2's fill tokens are fed, not emitted
                    req.tokens.append(tok)
                    self._emit(req, tok)
                self.pos[slot] += 1
                self.steps_ctr[slot] += 1
                if (self.steps_ctr[slot] >= req.max_steps
                        or self.pos[slot] >= self.max_len - 1):
                    self._finish_slot(slot)
                    break

    def _finish_slot(self, slot: int) -> None:
        req = self.active[slot]
        self.pos[slot] = self.max_len - 1
        self.min_lens[slot] = 0
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
        """A concurrent wave of tiny zero prompts, one a slot: the smallest
        prefill bucket, every slot's install and a tick run before live
        traffic."""
        D = int(self.lm.config.llm_input_size)
        emb = np.zeros((1, 8, D), np.float32)
        self.warmup_requests([_RASRequest(embeds=emb, min_tokens=0,
                                          max_steps=self.tick_frames + 1, seed=0)
                              for _ in range(self.slots)])

    def install(self):
        from ....serving import register_infer_hook

        register_infer_hook(self._owner, self)
        return self

    def close(self):
        from ....serving import unregister_infer_hook

        unregister_infer_hook(self._owner)
        super().close()
