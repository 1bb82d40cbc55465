"""Attention ops (counterpart of `mlx_audio_tpu/ops/attention.py`).

The default path is a plain matmul + float32 softmax. Long full (or T == S
causal) attention on a CUDA tensor routes to the hand-written flash kernel
(`ops.cuda.flash_attention`) under the same shape guard as the JAX
package's Pallas route; the guard picks the path before any launch.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["scaled_dot_product_attention", "make_causal_mask"]


def make_causal_mask(t: int, s: int, device=None) -> torch.Tensor:
    """Additive float32 causal mask of shape (t, s); offset so the last query
    attends to everything (standard KV-cache decode alignment)."""
    q_idx = torch.arange(t, device=device)[:, None] + (s - t)
    k_idx = torch.arange(s, device=device)[None, :]
    zero = torch.zeros((), device=device)
    return torch.where(k_idx <= q_idx, zero, float("-inf"))


def scaled_dot_product_attention(
    q: torch.Tensor,  # (B, H, T, D)
    k: torch.Tensor,  # (B, H_kv, S, D)
    v: torch.Tensor,  # (B, H_kv, S, D)
    scale: Optional[float] = None,
    mask: Optional[Union[torch.Tensor, str]] = None,
) -> torch.Tensor:
    """SDPA with GQA support. `mask` may be an additive tensor broadcastable
    to (B, H, T, S), a boolean tensor (True = attend), or the string
    "causal"."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    B, H, T, D = q.shape
    H_kv, S = k.shape[1], k.shape[2]

    rep = H // H_kv

    # Long full attention on the card: the streaming-softmax kernel never
    # materialises the (T, S) score matrix. Decode-step queries (T ~ 1) and
    # masked or offset variants take the matmul path below.
    causal_str = isinstance(mask, str) and mask == "causal"
    if (
        q.is_cuda
        and S >= 1280
        and T >= 1280
        and D <= 128
        and (mask is None or (causal_str and T == S))
        and q.dtype in (torch.float32, torch.bfloat16)
    ):
        from .cuda import flash_attention

        if rep != 1:
            k = k.repeat_interleave(rep, dim=1)
            v = v.repeat_interleave(rep, dim=1)
        return flash_attention(q, k, v, causal=causal_str, scale=scale)

    # GQA without copying k/v: the rep query heads that share a kv head are
    # stacked along the rows, (B, H_kv, rep·T, D), so a cache is read as it
    # lies. Scores in float32 from the input-dtype operands (products of
    # bf16 values are exact in float32), as the JAX package's
    # preferred_element_type=float32 einsum.
    qg = (q * scale).float().reshape(B, H_kv, rep * T, D)
    scores = torch.matmul(qg, k.float().transpose(-1, -2)).view(B, H, T, S)
    if isinstance(mask, str):
        if mask != "causal":
            raise ValueError(f"Unknown mask type: {mask}")
        scores = scores + make_causal_mask(T, S, device=q.device)
    elif mask is not None:
        if mask.dtype == torch.bool:
            scores = scores.masked_fill(~mask, float("-inf"))
        else:
            scores = scores + mask.to(scores.dtype)

    probs = torch.softmax(scores, dim=-1).to(q.dtype).reshape(B, H_kv, rep * T, S)
    if v.dtype != probs.dtype:
        # a float32 cache under bf16 queries, or a bf16 cache under float32
        # ones: the product runs in the wider type and returns the query's,
        # as JAX promotes
        wide = torch.promote_types(probs.dtype, v.dtype)
        out = torch.matmul(probs.to(wide), v.to(wide)).to(q.dtype)
    else:
        out = torch.matmul(probs, v)
    return out.view(B, H, T, D)
