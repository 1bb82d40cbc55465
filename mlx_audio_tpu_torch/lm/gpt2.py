"""GPT-2 backbone (counterpart of `mlx_audio_tpu/lm/gpt2.py`): learned
positional embeddings, pre-LN blocks, a fused q/k/v projection and a tanh
GELU MLP, under Hugging Face's gpt2 names (`wte`, `wpe`, `h.N.*`, `ln_f`)
after the Conv1D → Linear transpose that a model's `sanitize` makes.

IndexTTS builds it with a one-row `wpe` of zeros and feeds it embeddings;
Chatterbox-Turbo's T3 is its next user. The caches update in place
(`lm/cache.py`) and are returned, as the JAX package's functional ones are.
Positions read `wpe` through the embedding's own call, so a position past
the table reads its last row, as the JAX gather does.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..base import BaseModelArgs
from ..nn import Embedding, LayerNorm, Linear
from ..ops.attention import make_causal_mask, scaled_dot_product_attention
from .cache import KVCache

__all__ = ["GPT2Config", "GPT2Model"]


@dataclass
class GPT2Config(BaseModelArgs):
    n_embd: int = 768
    n_head: int = 12
    n_layer: int = 12
    n_positions: int = 1024
    vocab_size: int = 50257
    layer_norm_epsilon: float = 1e-5


class GPT2Attention(nn.Module):
    def __init__(self, cfg: GPT2Config, device=None):
        super().__init__()
        self.c_attn = Linear(cfg.n_embd, 3 * cfg.n_embd, device=device)
        self.c_proj = Linear(cfg.n_embd, cfg.n_embd, device=device)
        self.n_head = cfg.n_head

    def forward(self, x, mask, cache=None):
        B, T, D = x.shape
        hd = D // self.n_head
        q, k, v = (t.reshape(B, T, self.n_head, hd).transpose(1, 2)
                   for t in self.c_attn(x).split(D, dim=-1))
        if cache is not None:
            k, v, cache = cache.update(k, v)
        out = scaled_dot_product_attention(q, k, v, mask=mask)
        return self.c_proj(out.transpose(1, 2).reshape(B, T, D)), cache


class GPT2MLP(nn.Module):
    def __init__(self, cfg: GPT2Config, device=None):
        super().__init__()
        self.c_fc = Linear(cfg.n_embd, 4 * cfg.n_embd, device=device)
        self.c_proj = Linear(4 * cfg.n_embd, cfg.n_embd, device=device)

    def forward(self, x):
        return self.c_proj(F.gelu(self.c_fc(x), approximate="tanh"))


class GPT2Block(nn.Module):
    def __init__(self, cfg: GPT2Config, device=None):
        super().__init__()
        self.ln_1 = LayerNorm(cfg.n_embd, eps=cfg.layer_norm_epsilon, device=device)
        self.attn = GPT2Attention(cfg, device=device)
        self.ln_2 = LayerNorm(cfg.n_embd, eps=cfg.layer_norm_epsilon, device=device)
        self.mlp = GPT2MLP(cfg, device=device)

    def forward(self, x, mask, cache=None):
        a, cache = self.attn(self.ln_1(x), mask, cache)
        x = x + a
        return x + self.mlp(self.ln_2(x)), cache


class GPT2Model(nn.Module):
    """Output = hidden states after `ln_f`; tie to `wte` for LM logits
    through `wte.as_linear`. Parameters are drawn by the owner
    (`nn.module.init_weights`)."""

    def __init__(self, cfg: GPT2Config, device=None):
        super().__init__()
        self.wte = Embedding(cfg.vocab_size, cfg.n_embd, device=device)
        self.wpe = Embedding(cfg.n_positions, cfg.n_embd, device=device)
        self.h = nn.ModuleList(GPT2Block(cfg, device=device) for _ in range(cfg.n_layer))
        self.ln_f = LayerNorm(cfg.n_embd, eps=cfg.layer_norm_epsilon, device=device)
        self.config = cfg

    def make_caches(self, batch: int = 1, max_len: int = 1024,
                    dtype=torch.bfloat16) -> List[KVCache]:
        cfg = self.config
        return [KVCache(batch, cfg.n_head, max_len, cfg.n_embd // cfg.n_head, dtype,
                        self.wpe.weight.device)
                for _ in range(cfg.n_layer)]

    def forward(self, inputs, caches: Optional[list] = None, positions=None, mask=None):
        """`inputs` token ids (B, T) or embeddings (B, T, D); `positions`
        (T,) or (B, T), by default the caches' cursor onwards; `mask` an
        additive mask, by default causal over the caches' written rows."""
        h = self.wte(inputs) if inputs.ndim == 2 else inputs
        T = h.shape[1]
        if positions is None:
            start = caches[0].pos if caches is not None else 0
            positions = torch.arange(start, start + T, device=h.device)
        h = h + self.wpe(positions)
        if mask is None:
            if caches is not None:
                mask = caches[0].attention_mask(T)
            elif T > 1:
                mask = make_causal_mask(T, T, device=h.device)
        for i, blk in enumerate(self.h):
            h, _ = blk(h, mask, caches[i] if caches is not None else None)
        return self.ln_f(h), caches
