"""Qwen3-TTS talker (AR over codec frames, interleaved MRoPE) and code
predictor (AR across the codebooks of one frame). Counterpart of
`mlx_audio_tpu/tts/models/qwen3_tts/talker.py`, with the same parameter
names.

KV caches are float32 and update in place (`lm.cache.KVCache`). The
forward passes take precomputed rope tables and masks (`cos_sin`, `mask`)
so the eager decode loop does not rebuild them at every step.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ....lm.cache import KVCache
from ....nn import Embedding, Linear, RMSNorm
from ....nn.quantized import fused_mlp_call
from ....ops.attention import scaled_dot_product_attention
from .config import Qwen3TTSTalkerCodePredictorConfig, Qwen3TTSTalkerConfig

__all__ = ["Qwen3TTSTalkerForConditionalGeneration", "CodePredictorModel"]


def _rotate_half(x):
    h = x.shape[-1] // 2
    return torch.cat([-x[..., h:], x[..., :h]], dim=-1)


def _apply_rope(q, k, cos, sin):
    # cos/sin (B, T, head_dim), float32, broadcast over heads: as in the JAX
    # package the rotated q and k come out float32 whatever their dtype
    cos = cos[:, None]
    sin = sin[:, None]
    return q * cos + _rotate_half(q) * sin, k * cos + _rotate_half(k) * sin


class TalkerRotaryEmbedding(nn.Module):
    """Interleaved multimodal rope: half-dim index h takes its angle from
    position stream 1 (h % 3 == 1, h < 3·section[1]), stream 2 (h % 3 == 2,
    h < 3·section[2]) or stream 0. For TTS the three streams are equal."""

    def __init__(self, dim: int, base: float = 10000.0,
                 mrope_section: Optional[List[int]] = None, device=None):
        super().__init__()
        inv = 1.0 / (base ** (torch.arange(0, dim, 2, dtype=torch.float32) / dim))
        section = mrope_section or [24, 20, 20]
        idx = np.arange(dim // 2)
        h_mask = (idx % 3 == 1) & (idx < section[1] * 3)
        w_mask = (idx % 3 == 2) & (idx < section[2] * 3)
        select = np.where(h_mask, 1, np.where(w_mask, 2, 0))
        self.register_buffer("_inv_freq", inv.to(device), persistent=False)
        self.register_buffer("_select", torch.from_numpy(select).to(device), persistent=False)

    def forward(self, positions: torch.Tensor):
        """positions (3, B, T) or (B, T) → cos, sin (B, T, dim) float32."""
        if positions.dim() == 2:
            positions = positions[None].expand(3, *positions.shape)
        freqs = positions[..., None].float() * self._inv_freq  # (3, B, T, half)
        idx = self._select.expand(1, *freqs.shape[1:])
        combined = torch.gather(freqs, 0, idx)[0]
        emb = torch.cat([combined, combined], dim=-1)
        return torch.cos(emb), torch.sin(emb)


class TalkerAttention(nn.Module):
    # row-stacked after loading by nn.quantized.fuse_quantized_projections
    _FUSE_GROUPS = (("qkv_fused", ("q_proj", "k_proj", "v_proj")),)

    def __init__(self, cfg, qk_norm: bool = True, device=None):
        super().__init__()
        d, hd = cfg.hidden_size, cfg.head_dim
        b = cfg.attention_bias
        self.q_proj = Linear(d, cfg.num_attention_heads * hd, bias=b, device=device)
        self.k_proj = Linear(d, cfg.num_key_value_heads * hd, bias=b, device=device)
        self.v_proj = Linear(d, cfg.num_key_value_heads * hd, bias=b, device=device)
        self.o_proj = Linear(cfg.num_attention_heads * hd, d, bias=b, device=device)
        if qk_norm:
            self.q_norm = RMSNorm(hd, eps=cfg.rms_norm_eps, device=device)
            self.k_norm = RMSNorm(hd, eps=cfg.rms_norm_eps, device=device)
        self.nh = cfg.num_attention_heads
        self.nkv = cfg.num_key_value_heads
        self.hd = hd

    def forward(self, x, cos, sin, mask=None, cache: Optional[KVCache] = None):
        B, T, _ = x.shape
        if hasattr(self, "qkv_fused"):
            q, k, v = self.qkv_fused(x)
        else:
            q, k, v = self.q_proj(x), self.k_proj(x), self.v_proj(x)
        q = q.reshape(B, T, self.nh, self.hd)
        k = k.reshape(B, T, self.nkv, self.hd)
        v = v.reshape(B, T, self.nkv, self.hd)
        if hasattr(self, "q_norm"):
            q = self.q_norm(q)
            k = self.k_norm(k)
        q, k, v = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        q, k = _apply_rope(q, k, cos, sin)
        if cache is not None:
            k, v, _ = cache.update(k, v)
        out = scaled_dot_product_attention(q, k, v, scale=self.hd ** -0.5, mask=mask)
        return self.o_proj(out.transpose(1, 2).reshape(B, T, -1))


class TalkerMLP(nn.Module):
    _FUSE_GROUPS = (("gate_up_fused", ("gate_proj", "up_proj")),)

    def __init__(self, cfg, device=None):
        super().__init__()
        d, i = cfg.hidden_size, cfg.intermediate_size
        self.gate_proj = Linear(d, i, bias=False, device=device)
        self.up_proj = Linear(d, i, bias=False, device=device)
        self.down_proj = Linear(i, d, bias=False, device=device)

    def forward(self, x):
        if hasattr(self, "gate_up_fused"):
            y = fused_mlp_call(self.gate_up_fused, self.down_proj, x)
            if y is not None:
                return y
            g, u = self.gate_up_fused(x)
        else:
            g, u = self.gate_proj(x), self.up_proj(x)
        return self.down_proj(F.silu(g) * u)


class ResizeMLP(nn.Module):
    def __init__(self, input_size, intermediate_size, output_size, bias=True, device=None):
        super().__init__()
        self.linear_fc1 = Linear(input_size, intermediate_size, bias=bias, device=device)
        self.linear_fc2 = Linear(intermediate_size, output_size, bias=bias, device=device)

    def forward(self, x):
        return self.linear_fc2(F.silu(self.linear_fc1(x)))


class TalkerDecoderLayer(nn.Module):
    def __init__(self, cfg, qk_norm=True, device=None):
        super().__init__()
        self.self_attn = TalkerAttention(cfg, qk_norm, device=device)
        self.mlp = TalkerMLP(cfg, device=device)
        self.input_layernorm = RMSNorm(cfg.hidden_size, eps=cfg.rms_norm_eps, device=device)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size, eps=cfg.rms_norm_eps,
                                                device=device)

    def forward(self, x, cos, sin, mask=None, cache=None):
        x = x + self.self_attn(self.input_layernorm(x), cos, sin, mask, cache)
        return x + self.mlp(self.post_attention_layernorm(x))


def _run_layers(layers, x, cos, sin, mask, caches):
    for i, layer in enumerate(layers):
        x = layer(x, cos, sin, mask, caches[i] if caches is not None else None)
    return x


class Qwen3TTSTalkerModel(nn.Module):
    def __init__(self, cfg: Qwen3TTSTalkerConfig, device=None):
        super().__init__()
        self.codec_embedding = Embedding(cfg.vocab_size, cfg.hidden_size, device=device)
        self.text_embedding = Embedding(cfg.text_vocab_size, cfg.text_hidden_size,
                                        device=device)
        self.layers = nn.ModuleList(TalkerDecoderLayer(cfg, device=device)
                                    for _ in range(cfg.num_hidden_layers))
        self.norm = RMSNorm(cfg.hidden_size, eps=cfg.rms_norm_eps, device=device)
        mrope = None
        if cfg.rope_scaling and "mrope_section" in cfg.rope_scaling:
            mrope = cfg.rope_scaling["mrope_section"]
        self.rotary_emb = TalkerRotaryEmbedding(cfg.head_dim, cfg.rope_theta, mrope,
                                                device=device)
        self.config = cfg

    def forward(self, inputs_embeds, caches: Optional[List[KVCache]] = None,
                mask=None, positions=None, cos_sin=None):
        """→ normed hidden states. `cos_sin` replaces the rope of
        `positions` (default: from the cache's position)."""
        B, T, _ = inputs_embeds.shape
        if cos_sin is None:
            if positions is None:
                start = caches[0].pos if caches is not None else 0
                positions = torch.arange(start, start + T,
                                         device=inputs_embeds.device)[None].expand(B, T)
            cos_sin = self.rotary_emb(positions)
        if mask is None and caches is not None:
            mask = caches[0].attention_mask(T)
        x = _run_layers(self.layers, inputs_embeds, *cos_sin, mask, caches)
        return self.norm(x)

    def make_caches(self, batch: int, max_len: int) -> List[KVCache]:
        cfg = self.config
        dev = self.norm.weight.device
        return [KVCache(batch, cfg.num_key_value_heads, max_len, cfg.head_dim,
                        dtype=torch.float32, device=dev)
                for _ in range(cfg.num_hidden_layers)]


class CodePredictorModel(nn.Module):
    def __init__(self, cfg: Qwen3TTSTalkerCodePredictorConfig, talker_hidden_size: int,
                 device=None):
        super().__init__()
        self.codec_embedding = nn.ModuleList(
            Embedding(cfg.vocab_size, talker_hidden_size, device=device)
            for _ in range(cfg.num_code_groups - 1))
        self.layers = nn.ModuleList(TalkerDecoderLayer(cfg, device=device)
                                    for _ in range(cfg.num_hidden_layers))
        self.norm = RMSNorm(cfg.hidden_size, eps=cfg.rms_norm_eps, device=device)
        inv = 1.0 / (cfg.rope_theta ** (
            torch.arange(0, cfg.head_dim, 2, dtype=torch.float32) / cfg.head_dim))
        self.register_buffer("_inv_freq", inv.to(device), persistent=False)
        self.config = cfg

    def rope(self, positions):
        freqs = positions[..., None].float() * self._inv_freq
        emb = torch.cat([freqs, freqs], dim=-1)
        return torch.cos(emb), torch.sin(emb)

    def forward(self, inputs_embeds, caches=None, mask=None, cos_sin=None):
        B, T, _ = inputs_embeds.shape
        if cos_sin is None:
            start = caches[0].pos if caches is not None else 0
            positions = torch.arange(start, start + T,
                                     device=inputs_embeds.device)[None].expand(B, T)
            cos_sin = self.rope(positions)
        if mask is None and caches is not None:
            mask = caches[0].attention_mask(T)
        x = _run_layers(self.layers, inputs_embeds, *cos_sin, mask, caches)
        return self.norm(x)

    def make_caches(self, batch: int, max_len: int) -> List[KVCache]:
        cfg = self.config
        dev = self.norm.weight.device
        return [KVCache(batch, cfg.num_key_value_heads, max_len, cfg.head_dim,
                        dtype=torch.float32, device=dev)
                for _ in range(cfg.num_hidden_layers)]


class Qwen3TTSTalkerCodePredictor(nn.Module):
    def __init__(self, cfg: Qwen3TTSTalkerCodePredictorConfig, talker_hidden_size: int,
                 device=None):
        super().__init__()
        if cfg.hidden_size != talker_hidden_size:
            self.small_to_mtp_projection = Linear(talker_hidden_size, cfg.hidden_size,
                                                  bias=True, device=device)
        self.model = CodePredictorModel(cfg, talker_hidden_size, device=device)
        self.lm_head = nn.ModuleList(
            Linear(cfg.hidden_size, cfg.vocab_size, bias=False, device=device)
            for _ in range(cfg.num_code_groups - 1))
        self.config = cfg

    @property
    def codec_embedding(self):
        return self.model.codec_embedding

    def project(self, x):
        if hasattr(self, "small_to_mtp_projection"):
            return self.small_to_mtp_projection(x)
        return x


class Qwen3TTSTalkerForConditionalGeneration(nn.Module):
    def __init__(self, cfg: Qwen3TTSTalkerConfig, device=None):
        super().__init__()
        self.model = Qwen3TTSTalkerModel(cfg, device=device)
        self.text_projection = ResizeMLP(cfg.text_hidden_size, cfg.text_hidden_size,
                                         cfg.hidden_size, bias=True, device=device)
        self.codec_head = Linear(cfg.hidden_size, cfg.vocab_size, bias=False, device=device)
        self.code_predictor = Qwen3TTSTalkerCodePredictor(
            cfg.code_predictor_config, cfg.hidden_size, device=device)
        self.config = cfg

    def forward(self, inputs_embeds, caches=None, mask=None, positions=None,
                cos_sin=None):
        """→ (codec logits, normed hidden states)."""
        h = self.model(inputs_embeds, caches, mask, positions, cos_sin)
        return self.codec_head(h), h
