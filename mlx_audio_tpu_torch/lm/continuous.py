"""Slot-based batching pieces for autoregressive decode (counterpart of
`mlx_audio_tpu/lm/continuous.py`): the prompt buckets, `SlotKVCache` (one
independent stream per batch row) and the per-row sampler, as the frame
batcher of Qwen3-TTS (`tts/models/qwen3_tts/batcher.py`) uses them. The
token-level `ContinuousBatcher` waits for the LM core.

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
(B,) tensor.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from .cache import KVCache

__all__ = ["SlotKVCache", "PROMPT_BUCKETS", "STAGES", "stages_used"]


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
