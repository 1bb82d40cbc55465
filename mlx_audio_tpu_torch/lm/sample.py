"""Logit filters and the repetition penalty (counterpart of
`mlx_audio_tpu/lm/sample.py`). Sampling itself is Gumbel-max with a
`torch.Generator` (see `tts/models/qwen3_tts/qwen3_tts.py` `_sample`): no
host sync, but not the bits of `jax.random.categorical`."""

from __future__ import annotations

import torch

__all__ = ["top_k_filter", "top_p_filter", "apply_repetition_penalty"]


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


def apply_repetition_penalty(logits: torch.Tensor, history: torch.Tensor,
                             penalty: float) -> torch.Tensor:
    """Divide positive and multiply negative logits of the tokens in
    `history` (B, W), a fixed window padded with -1. Pads map out of range,
    as in the JAX package: a torch index of -1 would wrap to the last
    token."""
    if penalty == 1.0:
        return logits
    B, V = logits.shape
    hist = torch.where(history < 0, V, history).long()
    seen = torch.zeros(B, V + 1, dtype=torch.bool, device=logits.device)
    seen.scatter_(1, hist, True)
    penalized = torch.where(logits > 0, logits / penalty, logits * penalty)
    return torch.where(seen[:, :V], penalized, logits)
