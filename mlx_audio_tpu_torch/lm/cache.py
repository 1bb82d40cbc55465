"""Fixed-capacity KV cache (counterpart of `mlx_audio_tpu/lm/cache.py`).

Unlike the JAX cache, which is a functional pytree with a traced `pos`,
this one updates its buffers IN PLACE and keeps `pos` as a Python int: the
port runs eagerly, so an int cursor costs no host sync per step.
"""

from __future__ import annotations

import torch

__all__ = ["KVCache", "RingKVCache", "make_caches", "CACHE_DTYPE"]

# the LM's caches' dtype whatever the model's, as the JAX package's default
CACHE_DTYPE = torch.bfloat16


class KVCache:
    """Fixed-capacity KV cache for one attention layer.

    `keys, values, cache = cache.update(k, v)` writes k/v at `pos` in place
    and returns the whole buffers, the cache itself, and advances `pos`.
    """

    def __init__(self, batch: int, num_kv_heads: int, max_len: int,
                 head_dim: int, dtype=torch.bfloat16, device=None):
        shape = (batch, num_kv_heads, max_len, head_dim)
        self.k = torch.zeros(shape, dtype=dtype, device=device)
        self.v = torch.zeros(shape, dtype=dtype, device=device)
        self.pos = 0

    @property
    def max_len(self) -> int:
        return self.k.shape[2]

    def update(self, k: torch.Tensor, v: torch.Tensor):
        t = k.shape[2]
        if self.pos + t > self.max_len:
            raise ValueError(
                f"KV cache overflow: pos {self.pos} + {t} > capacity {self.max_len}")
        self.k[:, :, self.pos:self.pos + t] = k
        self.v[:, :, self.pos:self.pos + t] = v
        self.pos += t
        return self.k, self.v, self

    def reorder(self, idx: torch.Tensor) -> None:
        """Gather batch rows in place (beam search): row b takes the
        written part of row idx[b]. Every row shares `pos`."""
        self.k[:, :, :self.pos] = self.k[idx, :, :self.pos]
        self.v[:, :, :self.pos] = self.v[idx, :, :self.pos]

    def attention_mask(self, t: int) -> torch.Tensor:
        """Additive float32 mask (1, 1, t, max_len): causal within the new
        block and excluding not-yet-written positions."""
        dev = self.k.device
        q_pos = self.pos + torch.arange(t, device=dev)[:, None]
        k_idx = torch.arange(self.max_len, device=dev)[None, :]
        zero = torch.zeros((), device=dev)
        return torch.where(k_idx <= q_pos, zero, float("-inf"))[None, None]


class RingKVCache:
    """Sliding-window KV cache (a ring of `window` slots) for windowed
    attention, such as Mimi's context-250 transformer.

    `pos_buf` holds each slot's absolute position (a large negative number
    for a slot never written), so rope stays absolute and the mask is driven
    by positions. A write of t <= window rows lands at
    `(pos + arange(t)) % window`, in place; `pos` is a Python int.
    """

    EMPTY = -(10 ** 9)

    def __init__(self, batch: int, num_kv_heads: int, window: int, head_dim: int,
                 dtype=torch.float32, device=None):
        shape = (batch, num_kv_heads, window, head_dim)
        self.k = torch.zeros(shape, dtype=dtype, device=device)
        self.v = torch.zeros(shape, dtype=dtype, device=device)
        self.pos_buf = torch.full((window,), self.EMPTY, dtype=torch.long, device=device)
        self.pos = 0

    @property
    def window(self) -> int:
        return self.k.shape[2]

    def update(self, k: torch.Tensor, v: torch.Tensor):
        """k/v (B, H, t, D), t <= window → (the whole k and v rings, self)."""
        t = k.shape[2]
        if t > self.window:
            raise ValueError(f"a write of {t} rows exceeds the ring's {self.window} slots")
        written = self.pos + torch.arange(t, device=self.k.device)
        slots = written % self.window
        self.k[:, :, slots] = k.to(self.k.dtype)
        self.v[:, :, slots] = v.to(self.v.dtype)
        self.pos_buf[slots] = written
        self.pos += t
        return self.k, self.v, self

    def attention_mask(self, t: int, context: int, q0: int) -> torch.Tensor:
        """Additive float32 mask (1, 1, t, window) for queries at absolute
        positions q0 .. q0 + t - 1 against the ring after its update: a slot
        is seen where 0 <= q - k < context and it was written (k >= 0)."""
        dev = self.k.device
        q_pos = q0 + torch.arange(t, device=dev)[:, None]
        k_pos = self.pos_buf[None, :]
        delta = q_pos - k_pos
        ok = (delta >= 0) & (delta < context) & (k_pos >= 0)
        zero = torch.zeros((), device=dev)
        return torch.where(ok, zero, float("-inf"))[None, None]


def make_caches(num_layers: int, batch: int, num_kv_heads: int, max_len: int,
                head_dim: int, dtype=CACHE_DTYPE, device=None):
    """One `KVCache` a layer."""
    return [KVCache(batch, num_kv_heads, max_len, head_dim, dtype, device)
            for _ in range(num_layers)]
