"""Generic causal transformer of the Llama / Qwen2 / Qwen3 / Mistral family
(counterpart of `mlx_audio_tpu/lm/transformer.py`).

One config-driven implementation: GQA attention with rope (optional
per-head q/k RMSNorm for Qwen3, q/k/v bias for Qwen2, Llama-3 frequency
scaling), SwiGLU MLP, RMSNorm, optional tied embeddings. Parameter names are
the Hugging Face checkpoint's (`model.layers.N.self_attn.q_proj.weight`,
...), so a converted checkpoint loads without remapping.

The caches update in place (`lm/cache.py`); calls still return them, as the
JAX package's functional ones do, so callers read alike in both packages.
Quantized q/k/v and gate/up are row-stacked after loading
(`nn.quantized.fuse_quantized_projections`); on the card the MLP then takes
the fused SwiGLU kernel where its guard admits the shape.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..base import BaseModelArgs
from ..device import resolve_device
from ..nn import Embedding, Linear, RMSNorm
from ..nn.module import init_weights
from ..nn.quantized import fused_mlp_call
from ..ops.attention import make_causal_mask, scaled_dot_product_attention
from ..ops.rope import apply_rope, llama3_rope_freqs, rope_cos_sin
from .cache import KVCache, make_caches

__all__ = ["LMConfig", "CausalLM", "Transformer", "TransformerBlock", "CausalSelfAttention",
           "MLP"]


@dataclass
class LMConfig(BaseModelArgs):
    model_type: str = "llama"
    hidden_size: int = 2048
    num_hidden_layers: int = 16
    intermediate_size: int = 8192
    num_attention_heads: int = 32
    num_key_value_heads: Optional[int] = None
    head_dim: Optional[int] = None
    rms_norm_eps: float = 1e-5
    vocab_size: int = 32000
    rope_theta: float = 10000.0
    rope_traditional: bool = False
    rope_scaling: Optional[dict] = None
    attention_bias: bool = False
    mlp_bias: bool = False
    qk_norm: bool = False
    tie_word_embeddings: bool = False
    max_position_embeddings: int = 8192

    def __post_init__(self):
        if self.num_key_value_heads is None:
            self.num_key_value_heads = self.num_attention_heads
        if self.head_dim is None:
            self.head_dim = self.hidden_size // self.num_attention_heads
        if self.model_type in ("qwen3", "qwen3_moe") and not self.qk_norm:
            self.qk_norm = True
        if self.model_type == "qwen2":
            # Hugging Face's Qwen2 always has q/k/v bias (o_proj none)
            self.attention_bias = True


class CausalSelfAttention(nn.Module):
    # row-stacked after loading by nn.quantized.fuse_quantized_projections:
    # one dequant-matmul launch for q, k and v
    _FUSE_GROUPS = (("qkv_fused", ("q_proj", "k_proj", "v_proj")),)

    def __init__(self, cfg: LMConfig, device=None):
        super().__init__()
        dim = cfg.hidden_size
        self.n_heads = cfg.num_attention_heads
        self.n_kv_heads = cfg.num_key_value_heads
        self.head_dim = cfg.head_dim
        bias = cfg.attention_bias
        self.q_proj = Linear(dim, self.n_heads * self.head_dim, bias=bias, device=device)
        self.k_proj = Linear(dim, self.n_kv_heads * self.head_dim, bias=bias, device=device)
        self.v_proj = Linear(dim, self.n_kv_heads * self.head_dim, bias=bias, device=device)
        self.o_proj = Linear(self.n_heads * self.head_dim, dim, bias=False, device=device)
        if cfg.qk_norm:
            self.q_norm = RMSNorm(self.head_dim, eps=cfg.rms_norm_eps, device=device)
            self.k_norm = RMSNorm(self.head_dim, eps=cfg.rms_norm_eps, device=device)
        self.scale = self.head_dim ** -0.5
        self.rope_traditional = cfg.rope_traditional

    def forward(self, x, cos, sin, mask, cache=None):
        B, T, _ = x.shape
        if hasattr(self, "qkv_fused"):
            q, k, v = self.qkv_fused(x)
        else:
            q, k, v = self.q_proj(x), self.k_proj(x), self.v_proj(x)
        q = q.reshape(B, T, self.n_heads, self.head_dim)
        k = k.reshape(B, T, self.n_kv_heads, self.head_dim)
        v = v.reshape(B, T, self.n_kv_heads, self.head_dim)
        if hasattr(self, "q_norm"):
            q = self.q_norm(q)
            k = self.k_norm(k)
        q, k, v = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        q = apply_rope(q, cos, sin, self.rope_traditional)
        k = apply_rope(k, cos, sin, self.rope_traditional)
        if cache is not None:
            k, v, cache = cache.update(k, v)
        out = scaled_dot_product_attention(q, k, v, scale=self.scale, mask=mask)
        return self.o_proj(out.transpose(1, 2).reshape(B, T, -1)), cache


class MLP(nn.Module):
    _FUSE_GROUPS = (("gate_up_fused", ("gate_proj", "up_proj")),)

    def __init__(self, cfg: LMConfig, device=None):
        super().__init__()
        d, i, b = cfg.hidden_size, cfg.intermediate_size, cfg.mlp_bias
        self.gate_proj = Linear(d, i, bias=b, device=device)
        self.up_proj = Linear(d, i, bias=b, device=device)
        self.down_proj = Linear(i, d, bias=b, device=device)

    def forward(self, x):
        if hasattr(self, "gate_up_fused"):
            y = fused_mlp_call(self.gate_up_fused, self.down_proj, x)
            if y is not None:
                return y
            g, u = self.gate_up_fused(x)
        else:
            g, u = self.gate_proj(x), self.up_proj(x)
        return self.down_proj(F.silu(g) * u)


class TransformerBlock(nn.Module):
    def __init__(self, cfg: LMConfig, device=None):
        super().__init__()
        self.self_attn = CausalSelfAttention(cfg, device=device)
        self.mlp = MLP(cfg, device=device)
        self.input_layernorm = RMSNorm(cfg.hidden_size, eps=cfg.rms_norm_eps, device=device)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size, eps=cfg.rms_norm_eps,
                                                device=device)

    def forward(self, x, cos, sin, mask, cache=None):
        attn_out, cache = self.self_attn(self.input_layernorm(x), cos, sin, mask, cache)
        x = x + attn_out
        x = x + self.mlp(self.post_attention_layernorm(x))
        return x, cache


def _is_llama3(rope_scaling: Optional[dict]) -> bool:
    return bool(rope_scaling) and rope_scaling.get(
        "rope_type", rope_scaling.get("type")) == "llama3"


class Transformer(nn.Module):
    """The `model.*` part: embed_tokens, layers, final norm."""

    def __init__(self, cfg: LMConfig, device=None):
        super().__init__()
        self.embed_tokens = Embedding(cfg.vocab_size, cfg.hidden_size, device=device)
        self.layers = nn.ModuleList(TransformerBlock(cfg, device=device)
                                    for _ in range(cfg.num_hidden_layers))
        self.norm = RMSNorm(cfg.hidden_size, eps=cfg.rms_norm_eps, device=device)
        freqs = None
        if _is_llama3(cfg.rope_scaling):
            rs = cfg.rope_scaling
            freqs = llama3_rope_freqs(
                cfg.head_dim, cfg.rope_theta, factor=rs.get("factor", 8.0),
                low_freq_factor=rs.get("low_freq_factor", 1.0),
                high_freq_factor=rs.get("high_freq_factor", 4.0),
                original_max_position=rs.get("original_max_position_embeddings", 8192),
                device=device)
        # a float32 constant, neither a parameter nor a buffer: no dtype cast
        # of the model reaches it, as none reaches the JAX package's
        self._rope_freqs = freqs
        self.head_dim = cfg.head_dim
        self.rope_theta = cfg.rope_theta

    def rope_tables(self, positions: torch.Tensor):
        """float32 cos/sin (..., head_dim/2) of integer `positions`."""
        return rope_cos_sin(positions, self.head_dim, base=self.rope_theta,
                            freqs=self._rope_freqs, dtype=torch.float32)

    def forward(self, inputs, caches: Optional[List[KVCache]] = None,
                positions: Optional[torch.Tensor] = None, mask=None):
        """inputs (B, T) token ids or (B, T, D) embeddings → (normed hidden
        states, caches). `positions` (T,) or per-row (B, T) default to the
        cache's position onwards; `mask` to the cache's, else causal."""
        h = self.embed_tokens(inputs) if inputs.dim() == 2 else inputs
        T = h.shape[1]
        if positions is None:
            start = caches[0].pos if caches is not None else 0
            positions = torch.arange(start, start + T, device=h.device)
        cos, sin = self.rope_tables(positions)
        if cos.dim() == 3:  # per-row positions (B, T): broadcast over heads
            cos, sin = cos[:, None], sin[:, None]
        if mask is None:
            if caches is not None:
                mask = caches[0].attention_mask(T)
            elif T > 1:
                mask = make_causal_mask(T, T, device=h.device)
        new_caches = [] if caches is not None else None
        for i, layer in enumerate(self.layers):
            h, c = layer(h, cos, sin, mask, caches[i] if caches is not None else None)
            if new_caches is not None:
                new_caches.append(c)
        return self.norm(h), new_caches


class CausalLM(nn.Module):
    """Top-level LM: `model` and an `lm_head` (the tied embeddings where the
    config ties them). Built on an explicit device (None: the card) with
    weights drawn from `seed`."""

    def __init__(self, cfg: LMConfig, device=None, seed: int = 0):
        super().__init__()
        if isinstance(cfg, dict):
            cfg = LMConfig.from_dict(cfg)
        self.config = cfg
        self.device = resolve_device(device)
        self.model = Transformer(cfg, device=self.device)
        if not cfg.tie_word_embeddings:
            self.lm_head = Linear(cfg.hidden_size, cfg.vocab_size, bias=False,
                                  device=self.device)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        init_weights(self, gen)

    def make_caches(self, batch: int = 1, max_len: int = 2048) -> List[KVCache]:
        """One `KVCache` a layer, in `CACHE_DTYPE` whatever the model's dtype."""
        cfg = self.config
        return make_caches(cfg.num_hidden_layers, batch, cfg.num_key_value_heads, max_len,
                           cfg.head_dim, device=self.device)

    def logits(self, h: torch.Tensor) -> torch.Tensor:
        """The output projection of hidden states h."""
        if hasattr(self, "lm_head"):
            return self.lm_head(h)
        return self.model.embed_tokens.as_linear(h)

    def forward(self, inputs, caches=None, positions=None, mask=None):
        h, caches = self.model(inputs, caches, positions, mask)
        return self.logits(h), caches

    def hidden_states(self, inputs, caches=None, positions=None, mask=None):
        return self.model(inputs, caches, positions, mask)
