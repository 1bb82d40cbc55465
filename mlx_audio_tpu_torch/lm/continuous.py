"""Continuous (slot-based) batching for autoregressive decode (counterpart
of `mlx_audio_tpu/lm/continuous.py`): the prompt buckets, `SlotKVCache` (one
independent stream per batch row), the per-row sampler, and
`ContinuousBatcher`, the token-level scheduler over a `CausalLM`. The frame
batchers of Qwen3-TTS (`tts/models/qwen3_tts/batcher.py`) and Soprano
(`tts/models/soprano/batcher.py`) use the same pieces.

`ContinuousBatcher` keeps a pool of B cache slots that decode in lock-step:
a request joins a free slot at a tick boundary (its prompt prefilled at
B = 1 into a cache of its bucket's length, the JAX package's `_B1Cache`,
which is the port's `KVCache`, then copied into the slot) and leaves at EOS
or its token cap. The JAX package fuses a tick of n steps into one scan;
here a tick is an eager loop of n steps that reads nothing back from the
card until the tick's tokens come to the host, once a tick.

The sampler's random draws differ by design from the JAX package's per-row
PRNG keys, which have no torch counterpart. Each sampled row owns a
`torch.Generator` on the card, seeded from its request, and draws its own
Gumbel noise (an exponential draw, as `qwen3_tts._sample` draws it) in the
order a sequential run of that request draws it. So a request's tokens
depend only on its seed and its own step count, never on its slot or its
co-tenants; with one live slot they are the draws of the request run alone.
The cost is one small launch per sampled row per draw, on top of the
sampler's shared launches. The filters (repetition penalty, temperature,
top-k, top-p, min-p) are the JAX package's, per row, with every parameter a
(B,) tensor. Greedy rows take the argmax: their tokens are the JAX
package's.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..device import pinned, thread_setup
from .cache import CACHE_DTYPE, KVCache, make_caches

__all__ = ["SlotKVCache", "ContinuousBatcher", "PROMPT_BUCKETS", "STAGES", "stages_used"]


PROMPT_BUCKETS = (16, 32, 64, 128, 256, 512, 1024)


def _bucket(n: int) -> int:
    for b in PROMPT_BUCKETS:
        if n <= b:
            return b
    # beyond the table: the next power of two
    return 1 << (n - 1).bit_length()


class SlotKVCache:
    """KV cache with one independent stream per batch row.

    `pos` is a (B,) long tensor on the cache's device; `update` with one new
    token writes each row at its own position, with several (a windowed
    append) token i of row b at pos[b] + i. Writes past the capacity land on
    the last index, which the slot batcher keeps as a free slot's scratch
    (the JAX package drops them). Buffers update in place; masks come from
    the step function.
    """

    def __init__(self, slots: int, num_kv_heads: int, max_len: int, head_dim: int,
                 dtype=torch.bfloat16, device=None):
        shape = (slots, num_kv_heads, max_len, head_dim)
        self.k = torch.zeros(shape, dtype=dtype, device=device)
        self.v = torch.zeros(shape, dtype=dtype, device=device)
        self.pos = torch.zeros(slots, dtype=torch.long, device=device)

    @property
    def max_len(self) -> int:
        return self.k.shape[2]

    def update(self, k: torch.Tensor, v: torch.Tensor):
        B, t = k.shape[0], k.shape[2]
        b = torch.arange(B, device=k.device)
        if t == 1:  # decode
            p = self.pos.clamp(max=self.max_len - 1)
            self.k[b, :, p] = k[:, :, 0].to(self.k.dtype)
            self.v[b, :, p] = v[:, :, 0].to(self.v.dtype)
        else:
            idx = (self.pos[:, None] + torch.arange(t, device=k.device)).clamp(
                max=self.max_len - 1)
            self.k[b[:, None], :, idx] = k.transpose(1, 2).to(self.k.dtype)
            self.v[b[:, None], :, idx] = v.transpose(1, 2).to(self.v.dtype)
        self.pos = self.pos + t
        return self.k, self.v, self


def _install_slot(slot_caches: Sequence[SlotKVCache], single_caches: Sequence[KVCache],
                  slot: int, true_len: int) -> None:
    """Copy a B=1 prefilled cache into `slot` (its first P positions) and
    set the slot's pos, in place."""
    for sc, c1 in zip(slot_caches, single_caches):
        P = c1.k.shape[2]  # the prompt bucket, at most the slot capacity
        sc.k[slot, :, :P] = c1.k[0].to(sc.k.dtype)
        sc.v[slot, :, :P] = c1.v[0].to(sc.v.dtype)
        sc.pos[slot] = true_len


# ---------------------------------------------------------------------------
# Per-row sampling
# ---------------------------------------------------------------------------


# the filter stages of `_filter_rows`; a caller that knows on the host that
# no row uses a stage (every penalty 1, every top-p 1, ...) leaves it out,
# which skips its launches and changes no token
STAGES = frozenset(("penalty", "sample", "top_k", "top_p", "min_p"))


def stages_used(temps, top_ps, top_ks, rep_pens, min_ps=None) -> frozenset:
    """The stages some row uses, from the host's (B,) parameter arrays."""
    used = set()
    if (np.asarray(rep_pens) != 1.0).any():
        used.add("penalty")
    if (np.asarray(temps) > 0).any():
        used.add("sample")
        if (np.asarray(top_ks) > 0).any():
            used.add("top_k")
        if (np.asarray(top_ps) < 1.0).any():
            used.add("top_p")
        if min_ps is not None and (np.asarray(min_ps) > 0).any():
            used.add("min_p")
    return frozenset(used)


def _filter_rows(logits, hist, temps, top_ps, top_ks, rep_pens, rep_windows,
                 min_ps=None, stages=STAGES):
    """The per-row filters of `_sample_rows_core` → (greedy tokens (B,),
    filtered scaled logits x (B, V), -inf where a row's filters remove a
    token; None when no row samples).

    Every parameter is a (B,) tensor, so any mix of greedy and sampled rows
    goes through one code path (top-k by per-row ranks over one descending
    sort). `hist` is a (B, W) right-aligned token window (-1 padded); only
    the last `rep_windows[b]` entries of row b are penalized. `stages`: the
    filters some row uses (`stages_used`); the others are identities."""
    B, V = logits.shape
    dev = logits.device
    z = logits.float()
    if "penalty" in stages:
        W = hist.shape[1]
        age = (W - 1) - torch.arange(W, device=dev)
        valid = (age[None, :] < rep_windows[:, None]) & (hist >= 0) & (hist < V)
        hist_c = torch.where(valid, hist, V).long()  # pads land on the V scratch column
        seen = torch.zeros(B, V + 1, dtype=torch.bool, device=dev).scatter_(1, hist_c, True)
        pen = rep_pens[:, None].float()
        penalized = torch.where(z > 0, z / pen, z * pen)
        z = torch.where(seen[:, :V] & (pen != 1.0), penalized, z)

    greedy = torch.argmax(z, dim=-1)
    if "sample" not in stages:
        return greedy, None

    x = z / temps.float().clamp(min=1e-6)[:, None]
    if "top_k" in stages or "top_p" in stages:
        x = _top_k_top_p(x, top_ps, top_ks, "top_p" in stages)
    if min_ps is not None and "min_p" in stages:
        # min-p over the survivors: probs >= min_p * max_prob ⟺ x >= max_x + log(min_p)
        cutoff = x.amax(dim=-1, keepdim=True) + torch.log(min_ps.float().clamp(min=1e-9))[:, None]
        x = torch.where((min_ps[:, None] > 0.0) & (x < cutoff), float("-inf"), x)
    return greedy, x


def _top_k_top_p(x, top_ps, top_ks, nucleus: bool):
    """Per-row top-k, then (`nucleus`) top-p over the survivors
    (lm.sample's order)."""
    B, V = x.shape
    dev = x.device
    sorted_desc = torch.sort(x, dim=-1, descending=True).values
    # top-k: masking with -inf keeps the survivors' order, so the top-k
    # sorted row is the first k_eff columns of sorted_desc
    k_eff = torch.where(top_ks > 0, top_ks, V).clamp(1, V).long()
    kth = torch.gather(sorted_desc, 1, (k_eff - 1)[:, None])
    x = torch.where((top_ks[:, None] > 0) & (x < kth), float("-inf"), x)
    if not nucleus:
        return x
    col = torch.arange(V, device=dev)[None, :]
    sorted_k = torch.where(col < k_eff[:, None], sorted_desc, float("-inf"))
    # top-p over the top-k survivors (lm.sample's filter order)
    probs = torch.softmax(sorted_k, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = cum - probs < top_ps[:, None]  # always keeps the top-1
    threshold = torch.where(keep, sorted_k, float("inf")).amin(dim=-1, keepdim=True)
    return torch.where((top_ps[:, None] < 1.0) & (x < threshold), float("-inf"), x)


def _sample_rows_core(logits, generators: List[Optional[torch.Generator]], hist, temps,
                      top_ps, top_ks, rep_pens, rep_windows, min_ps=None, stages=STAGES):
    """Per-row temperature / top-k / top-p / min-p / repetition-penalty
    sampling → tokens (B,).

    `generators[b]` is row b's own generator, or None for a row that does
    not sample (temperature 0: greedy, or a free slot): the host knows which
    rows sample, so no value is read back from the card. A sampled row draws
    one exponential row of V values from its generator (Gumbel-max:
    argmax(x - log e)), as `qwen3_tts._sample` draws for one request."""
    greedy, x = _filter_rows(logits, hist, temps, top_ps, top_ks, rep_pens, rep_windows,
                             min_ps, stages)
    rows = [b for b, g in enumerate(generators) if g is not None]
    if not rows:
        return greedy
    e = torch.ones_like(x)
    for b in rows:
        e[b:b + 1].exponential_(generator=generators[b])
    sampled = torch.argmax(x - torch.log(e), dim=-1)
    return torch.where(temps == 0, greedy, sampled)


# ---------------------------------------------------------------------------
# The token-level batcher
# ---------------------------------------------------------------------------


def _slot_mask(pos: torch.Tensor, max_len: int) -> torch.Tensor:
    """Additive (B, 1, 1, S) mask: row b attends to its first pos[b] + 1
    cache positions (the current token lands at pos[b])."""
    k_idx = torch.arange(max_len, device=pos.device)[None, :]
    zero = torch.zeros((), device=pos.device)
    return torch.where(k_idx <= pos[:, None], zero, float("-inf"))[:, None, None, :]


def _step(model, caches: Sequence[SlotKVCache], tokens: torch.Tensor,
          pos: torch.Tensor) -> torch.Tensor:
    """One lock-step decode step of every slot: tokens (B,) at positions pos
    (B,) → float32 logits (B, V); the caches fill in place."""
    for c in caches:
        c.pos = pos
    logits, _ = model(tokens[:, None], caches, positions=pos[:, None],
                      mask=_slot_mask(pos, caches[0].max_len))
    return logits[:, -1, :].float()


def _step_n(model, caches, tokens, pos, generators, hist, temps, top_ps, top_ks, rep_pens,
            rep_windows, min_ps, n: int, stages=STAGES) -> torch.Tensor:
    """`n` lock-step decode steps, each sampled on the card and fed back →
    tokens (B, n) on the card. The history window rides along as the JAX
    scan's carry does."""
    out = []
    for _ in range(n):
        logits = _step(model, caches, tokens, pos)
        tokens = _sample_rows_core(logits, generators, hist, temps, top_ps, top_ks, rep_pens,
                                   rep_windows, min_ps, stages)
        hist = torch.cat([hist[:, 1:], tokens[:, None]], dim=1)
        out.append(tokens)
        pos = pos + 1
    return torch.stack(out, dim=1)


def _prefill_b1(model, caches, ids: torch.Tensor, length: int) -> torch.Tensor:
    """A bucketed B = 1 prompt (1, P) → float32 logits (V,) of its last real
    token. The right padding is masked causally, and the K/V it leaves are
    overwritten before any query can see them."""
    logits, _ = model(ids, caches)
    return logits[0, length - 1, :].float()


def _prefill_b1_embeds(model, caches, x: torch.Tensor, length: int) -> torch.Tensor:
    """The same for an embedding prompt x (1, P, D): the audio-conditioned
    LLMs' path, past the embedding table."""
    h, _ = model.model(x, caches)
    return model.logits(h)[0, length - 1, :].float()


@dataclass
class _Request:
    prompt: np.ndarray  # token ids; empty when prompt_embeds is set
    max_tokens: int
    eos_ids: frozenset
    temp: float
    top_p: float = 1.0
    top_k: int = 0
    min_p: float = 0.0
    rep_penalty: float = 1.0
    rep_window: int = 64
    seed: int = 0
    host_sampling: bool = False  # rep_window exceeds the batcher's history width
    future: Future = field(default_factory=Future)
    on_token: Optional[callable] = None
    tokens: list = field(default_factory=list)
    prompt_tail: tuple = ()  # the last rep_window prompt tokens
    prompt_embeds: Optional[np.ndarray] = None  # (T, D) embedding prompt


class ContinuousBatcher:
    """Slot-based continuous batching over a `CausalLM`-style model (its
    `config`, `device`, `logits` and the `model(ids, caches, positions,
    mask)` calling convention). `submit` resolves to the request's tokens,
    EOS included when drawn.

    `tick_tokens` decode steps run between two reads of the card (one
    dispatch a tick in the JAX package); while a request whose repetition
    window exceeds `rep_hist` is live, it is sampled on the host from its
    logits and every tick is one step, as in the JAX package."""

    def __init__(self, model, slots: int = 4, max_len: int = 2048, seed: int = 0,
                 tick_tokens: int = 1, rep_hist: int = 64):
        cfg = model.config
        self.model = model
        self.device = pinned(model.device)
        self.slots = slots
        self.max_len = max_len
        self.tick_tokens = max(1, int(tick_tokens))
        self.rep_hist = max(1, int(rep_hist))
        self.caches = self._new_caches()
        self.active: List[Optional[_Request]] = [None] * slots
        self.cur_tok = np.zeros(slots, np.int64)
        self.pos = np.full(slots, max_len - 1, np.int64)  # a free slot's scratch index
        self.generators: List[Optional[torch.Generator]] = [None] * slots
        self._joinq: "queue.Queue[_Request]" = queue.Queue()
        self.seed = seed
        self._req_counter = 0
        self._rng = np.random.default_rng(seed)
        self._stop = threading.Event()
        self._wake = threading.Event()
        self.steps = 0  # ticks (for tests and metrics)
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _new_caches(self) -> List[SlotKVCache]:
        cfg = self.model.config
        return [SlotKVCache(self.slots, cfg.num_key_value_heads, self.max_len, cfg.head_dim,
                            CACHE_DTYPE, self.model.device)
                for _ in range(cfg.num_hidden_layers)]

    # ------------------------------------------------------------------

    def _request(self, prompt, prompt_embeds, max_tokens, eos_ids, temp, top_p, top_k,
                 min_p, repetition_penalty, repetition_context_size, seed,
                 on_token) -> Future:
        if seed is None:
            self._req_counter += 1
            seed = int(np.uint32(hash((self.seed, self._req_counter)) & 0xFFFFFFFF))
        req = _Request(
            prompt=np.asarray(prompt, np.int64), max_tokens=max_tokens,
            eos_ids=frozenset(int(e) for e in eos_ids), temp=temp, top_p=top_p, top_k=top_k,
            min_p=min_p, rep_penalty=repetition_penalty, rep_window=repetition_context_size,
            seed=seed,
            host_sampling=(repetition_penalty != 1.0
                           and repetition_context_size > self.rep_hist),
            on_token=on_token,
            prompt_tail=(tuple(prompt[-repetition_context_size:])
                         if repetition_context_size > 0 else ()),
            prompt_embeds=prompt_embeds)
        self._joinq.put(req)
        self._wake.set()
        return req.future

    def submit(self, prompt: Sequence[int], max_tokens: int = 128, eos_ids: Sequence[int] = (),
               temp: float = 0.0, top_p: float = 1.0, top_k: int = 0, min_p: float = 0.0,
               repetition_penalty: float = 1.0, repetition_context_size: int = 64,
               seed: Optional[int] = None, on_token=None) -> Future:
        """Queue a token-prompt request. `seed` pins the request's own
        generator, so a sampled request draws the same tokens alone or
        beside any co-tenants; by default each request gets a fresh seed
        from the batcher's."""
        prompt = [int(t) for t in prompt]
        return self._request(prompt, None, max_tokens, eos_ids, temp, top_p, top_k, min_p,
                             repetition_penalty, repetition_context_size, seed, on_token)

    def submit_embeds(self, prompt_embeds, max_tokens: int = 128,
                      eos_ids: Sequence[int] = (), temp: float = 0.0, top_p: float = 1.0,
                      top_k: int = 0, min_p: float = 0.0, repetition_penalty: float = 1.0,
                      repetition_context_size: int = 64, seed: Optional[int] = None,
                      on_token=None) -> Future:
        """Queue a request whose prompt is an embedding matrix (T, D) (the
        audio-conditioned LLMs' prefixes); decode then runs on token ids as
        for any request. The repetition window starts empty."""
        emb = np.asarray(prompt_embeds)
        if emb.ndim == 3:
            if emb.shape[0] != 1:
                raise ValueError(f"prompt_embeds must be (T, D), got {emb.shape}")
            emb = emb[0]
        return self._request([], emb, max_tokens, eos_ids, temp, top_p, top_k, min_p,
                             repetition_penalty, repetition_context_size, seed, on_token)

    def close(self):
        self._stop.set()
        self._wake.set()
        self._thread.join(timeout=10)
        # fail whatever still waits for a slot: its future would hang
        while True:
            try:
                req = self._joinq.get_nowait()
            except queue.Empty:
                break
            if not req.future.done():
                req.future.set_exception(RuntimeError("ContinuousBatcher closed"))

    # ------------------------------------------------------------------

    def _sample(self, logits_row: np.ndarray, req: _Request) -> int:
        """The host sampler of the rep_window > rep_hist case: the repetition
        penalty over the request's whole window, then temperature, top-k,
        top-p and min-p, as `lm.sample` orders them."""
        z = logits_row.astype(np.float64).copy()
        if req.rep_penalty != 1.0 and req.rep_window > 0:
            window = (list(req.prompt_tail) + req.tokens)[-req.rep_window:]
            idx = np.unique(np.asarray(window, np.int64))
            idx = idx[(idx >= 0) & (idx < z.shape[0])]
            pos = z[idx] > 0
            z[idx[pos]] /= req.rep_penalty
            z[idx[~pos]] *= req.rep_penalty
        if req.temp == 0.0:
            return int(np.argmax(z))
        z = z / req.temp  # scaled before the filters
        if 0 < req.top_k < z.shape[0]:
            kth = np.partition(z, -req.top_k)[-req.top_k]
            z[z < kth] = -np.inf
        if req.top_p < 1.0:
            order = np.argsort(z)[::-1]
            zs = z[order]
            probs = np.exp(zs - zs.max())
            probs /= probs.sum()
            cum = np.cumsum(probs)
            keep = (cum - probs) < req.top_p  # always keeps the top one
            z[z < zs[keep][-1]] = -np.inf
        if req.min_p > 0.0:
            z[z < z.max() + np.log(req.min_p)] = -np.inf
        z -= z.max()
        p = np.exp(z)
        p /= p.sum()
        return int(self._rng.choice(len(p), p=p))

    def _hist_row(self, req: Optional[_Request]) -> np.ndarray:
        row = np.full(self.rep_hist, -1, np.int64)
        if req is None:
            return row
        seq = (list(req.prompt_tail) + req.tokens)[-self.rep_hist:]
        if seq:
            row[-len(seq):] = seq
        return row

    def _sampler_state(self, reqs: Sequence[Optional[_Request]]):
        """The rows' sampler parameters and history windows on the card, and
        the filter stages some row uses (free slots are greedy and inert; a
        host-sampled row takes no penalty on the card)."""
        B = len(reqs)
        temps = np.zeros(B, np.float32)
        top_ps = np.ones(B, np.float32)
        top_ks = np.zeros(B, np.int64)
        min_ps = np.zeros(B, np.float32)
        rep_pens = np.ones(B, np.float32)
        rep_windows = np.zeros(B, np.int64)
        hist = np.full((B, self.rep_hist), -1, np.int64)
        for i, req in enumerate(reqs):
            if req is None:
                continue
            temps[i], top_ps[i], top_ks[i], min_ps[i] = req.temp, req.top_p, req.top_k, req.min_p
            if not req.host_sampling:
                rep_pens[i] = req.rep_penalty
                rep_windows[i] = min(req.rep_window, self.rep_hist)
                hist[i] = self._hist_row(req)
        dev = self.model.device
        floats = torch.from_numpy(np.stack([temps, top_ps, min_ps, rep_pens])).to(dev)
        ints = torch.from_numpy(np.stack([top_ks, rep_windows])).to(dev)
        stages = stages_used(temps, top_ps, top_ks, rep_pens, min_ps)
        return (floats[0], floats[1], ints[0], floats[3], ints[1], floats[2],
                torch.from_numpy(hist).to(dev), stages)

    def _admit(self, req: _Request, slot: int) -> None:
        T = req.prompt_embeds.shape[0] if req.prompt_embeds is not None else len(req.prompt)
        if T >= self.max_len:
            raise ValueError(f"prompt length {T} >= cache capacity {self.max_len}")
        P = min(_bucket(T), self.max_len)
        cfg = self.model.config
        dev = self.model.device
        single = make_caches(cfg.num_hidden_layers, 1, cfg.num_key_value_heads, P,
                             cfg.head_dim, device=dev)
        if req.prompt_embeds is not None:
            emb = torch.as_tensor(req.prompt_embeds, device=dev)
            x = emb.new_zeros(1, P, emb.shape[1])
            x[0, :T] = emb
            logits = _prefill_b1_embeds(self.model, single, x, T)
        else:
            ids = torch.zeros(1, P, dtype=torch.long, device=dev)
            ids[0, :T] = torch.as_tensor(req.prompt, device=dev)
            logits = _prefill_b1(self.model, single, ids, T)
        _install_slot(self.caches, single, slot, T)
        gen = None
        if req.temp > 0:
            gen = torch.Generator(device=dev)
            gen.manual_seed(req.seed)
        if req.host_sampling:
            first = self._sample(logits.cpu().numpy(), req)
        else:
            temps, top_ps, top_ks, rep_pens, rep_windows, min_ps, hist, stages = (
                self._sampler_state([req]))
            first = int(_sample_rows_core(logits[None], [gen], hist, temps, top_ps, top_ks,
                                          rep_pens, rep_windows, min_ps, stages)[0])
        self.active[slot] = req
        self.generators[slot] = gen
        req.tokens.append(first)
        self._emit(req, first)
        if first in req.eos_ids or req.max_tokens <= 1:
            self._finish(slot)
            return
        self.cur_tok[slot] = first
        self.pos[slot] = T

    @staticmethod
    def _emit(req: _Request, tok: int) -> None:
        """The streaming callback; a sink that raises (a closed socket) is
        dropped, never the worker."""
        if req.on_token:
            try:
                req.on_token(tok)
            except Exception:
                req.on_token = None

    def _finish(self, slot: int):
        req = self.active[slot]
        self.active[slot] = None
        self.generators[slot] = None
        self.pos[slot] = self.max_len - 1  # back on the scratch index
        if req is not None and not req.future.done():
            req.future.set_result(req.tokens)

    def _fail_all(self, e: Exception) -> None:
        """Fail every live stream and rebuild the cache pool, which a failed
        tick leaves half written."""
        for slot, req in enumerate(self.active):
            if req is not None and not req.future.done():
                req.future.set_exception(e)
            self.active[slot] = None
            self.generators[slot] = None
            self.pos[slot] = self.max_len - 1
        self.caches = self._new_caches()

    def _take(self, slot: int, req: _Request, tok: int) -> bool:
        """Append one token to a live slot; whether the slot finished."""
        req.tokens.append(tok)
        self._emit(req, tok)
        self.pos[slot] += 1
        self.cur_tok[slot] = tok
        if (tok in req.eos_ids or len(req.tokens) >= req.max_tokens
                or self.pos[slot] >= self.max_len - 1):
            self._finish(slot)
            return True
        return False

    def _inputs(self):
        dev = self.model.device
        return (torch.from_numpy(self.cur_tok).to(dev), torch.from_numpy(self.pos).to(dev))

    def _fused_tick(self, n: int) -> None:
        """n steps of every live slot, sampled on the card; one read of the
        (slots, n) tokens; a slot's tokens past its EOS or cap are dropped."""
        temps, top_ps, top_ks, rep_pens, rep_windows, min_ps, hist, stages = (
            self._sampler_state(self.active))
        try:
            tokens, pos = self._inputs()
            toks = _step_n(self.model, self.caches, tokens, pos, list(self.generators), hist,
                           temps, top_ps, top_ks, rep_pens, rep_windows, min_ps, n, stages)
            toks_np = toks.cpu().numpy()
            self.steps += 1
        except Exception as e:
            self._fail_all(e)
            return
        for slot, req in enumerate(self.active):
            if req is None:
                continue
            for j in range(n):
                if self._take(slot, req, int(toks_np[slot, j])):
                    break

    def _host_tick(self) -> None:
        """One step of every live slot, with the logits of host-sampled rows
        read back."""
        temps, top_ps, top_ks, rep_pens, rep_windows, min_ps, hist, stages = (
            self._sampler_state(self.active))
        any_host = any(r is not None and r.host_sampling for r in self.active)
        try:
            tokens, pos = self._inputs()
            logits = _step(self.model, self.caches, tokens, pos)
            toks = _sample_rows_core(logits, list(self.generators), hist, temps, top_ps,
                                     top_ks, rep_pens, rep_windows, min_ps, stages)
            toks_np = toks.cpu().numpy()
            logits_np = logits.cpu().numpy() if any_host else None
            self.steps += 1
        except Exception as e:
            self._fail_all(e)
            return
        for slot, req in enumerate(self.active):
            if req is None:
                continue
            try:
                tok = (self._sample(logits_np[slot], req) if req.host_sampling
                       else int(toks_np[slot]))
            except Exception as e:  # NaN logits under temp > 0, and the like
                self.active[slot] = None
                self.generators[slot] = None
                self.pos[slot] = self.max_len - 1
                if not req.future.done():
                    req.future.set_exception(e)
                continue
            self._take(slot, req, tok)

    def _worker(self):
        thread_setup(self.device)
        with torch.inference_mode():
            while not self._stop.is_set():
                while any(a is None for a in self.active):
                    try:
                        req = self._joinq.get_nowait()
                    except queue.Empty:
                        break
                    slot = self.active.index(None)
                    try:
                        self._admit(req, slot)
                    except Exception as e:  # the request is refused, not the pool
                        self.active[slot] = None
                        self.generators[slot] = None
                        if not req.future.done():
                            req.future.set_exception(e)
                if not any(self.active):
                    self._wake.wait(timeout=0.05)
                    self._wake.clear()
                    continue
                if any(r is not None and r.host_sampling for r in self.active):
                    self._host_tick()
                else:
                    self._fused_tick(self.tick_tokens)
