"""Logit filters, the repetition penalty and `make_sampler` (counterpart of
`mlx_audio_tpu/lm/sample.py`). Sampling itself is Gumbel-max with a
`torch.Generator`: no host sync, but not the bits of
`jax.random.categorical`, so sampled tokens match the JAX package's only in
distribution (greedy ones exactly)."""

from __future__ import annotations

from typing import Callable, Optional, Union

import torch

__all__ = ["make_sampler", "top_k_filter", "top_p_filter", "min_p_filter",
           "apply_repetition_penalty"]


def top_k_filter(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Mask everything below the k-th largest logit."""
    if k <= 0 or k >= logits.shape[-1]:
        return logits
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return logits.masked_fill(logits < kth, float("-inf"))


def top_p_filter(logits: torch.Tensor, p: float) -> torch.Tensor:
    """Nucleus filtering: keep the smallest prefix of sorted probs ≥ p
    (always the top-1)."""
    if p >= 1.0:
        return logits
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    keep = probs.cumsum(-1) - probs < p
    inf = torch.full_like(sorted_logits, float("inf"))
    threshold = torch.where(keep, sorted_logits, inf).amin(-1, keepdim=True)
    return logits.masked_fill(logits < threshold, float("-inf"))


def min_p_filter(logits: torch.Tensor, min_p: float,
                 min_tokens_to_keep: int = 1) -> torch.Tensor:
    """Keep the tokens whose probability is at least min_p times the top
    one's, and never fewer than the `min_tokens_to_keep` largest (mlx-lm's
    semantics)."""
    if min_p <= 0.0:
        return logits
    probs = torch.softmax(logits, dim=-1)
    keep = probs >= min_p * probs.amax(-1, keepdim=True)
    if min_tokens_to_keep > 1:
        kth = torch.sort(logits, dim=-1).values[..., -min_tokens_to_keep][..., None]
        keep = keep | (logits >= kth)
    return logits.masked_fill(~keep, float("-inf"))


def apply_repetition_penalty(logits: torch.Tensor, history: torch.Tensor,
                             penalty: Union[float, torch.Tensor]) -> torch.Tensor:
    """Divide positive and multiply negative logits of the tokens in
    `history` (B, W), a fixed window padded with -1. Pads map out of range,
    as in the JAX package: a torch index of -1 would wrap to the last
    token. `penalty` is one float, or a (B,) tensor of per-row penalties
    (a row at 1.0 is left as it is)."""
    if isinstance(penalty, torch.Tensor):
        penalty = penalty.to(logits.dtype)[:, None]
    elif penalty == 1.0:
        return logits
    B, V = logits.shape
    hist = torch.where(history < 0, V, history).long()
    seen = torch.zeros(B, V + 1, dtype=torch.bool, device=logits.device)
    seen.scatter_(1, hist, True)
    penalized = torch.where(logits > 0, logits / penalty, logits * penalty)
    return torch.where(seen[:, :V], penalized, logits)


def make_sampler(temp: float = 0.0, top_p: float = 1.0, top_k: int = 0, min_p: float = 0.0,
                 min_tokens_to_keep: int = 1
                 ) -> Callable[[torch.Tensor, Optional[torch.Generator]], torch.Tensor]:
    """sampler(logits (..., V), generator) → token ids (...,) (int64): the
    argmax at temp 0, else the filters in the JAX package's order (top-k,
    top-p, min-p over the logits scaled by 1/temp) and one Gumbel-max draw
    from `generator`, on the logits' device."""

    def sampler(logits: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        if temp == 0.0:
            return torch.argmax(logits, dim=-1)
        x = logits.float() / temp
        if top_k:
            x = top_k_filter(x, top_k)
        if top_p < 1.0:
            x = top_p_filter(x, top_p)
        if min_p > 0.0:
            x = min_p_filter(x, min_p, min_tokens_to_keep)
        e = torch.empty_like(x).exponential_(generator=generator)
        return torch.argmax(x - torch.log(e), dim=-1)

    return sampler
