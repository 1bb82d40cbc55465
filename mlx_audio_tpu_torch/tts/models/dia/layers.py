"""Dia's transformer layers (counterpart of
`mlx_audio_tpu/tts/models/dia/layers.py`, with the same parameter names):
DenseGeneral projections, timescale rope, the gated MLP, the encoder and
the GQA decoder with cross-attention. Channels-last (B, T, D)."""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ....nn import Embedding, RMSNorm
from ....ops.attention import scaled_dot_product_attention
from .config import DiaConfig

__all__ = ["DiaModel", "Encoder", "Decoder", "DenseGeneral"]


class DenseGeneral(nn.Module):
    """A tensordot projection with the weight shaped (in..., out...), in the
    input's dtype."""

    def __init__(self, in_shapes: tuple, out_features: tuple, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(*in_shapes, *out_features, device=device))
        self.in_rank = len(in_shapes)

    def reset_parameters(self, generator=None) -> None:
        self.weight.data.normal_(0.0, 0.02, generator=generator)

    def forward(self, x):
        axes = list(range(x.dim() - self.in_rank, x.dim()))
        return torch.tensordot(x, self.weight.to(x.dtype), dims=(axes, list(range(self.in_rank))))


def _rope_timescale(x, positions, min_ts=1.0, max_ts=10000.0):
    """Dia's rope over (B, T, N, H): timescale-interpolated frequencies,
    angles in float32, cos/sin in x's dtype."""
    H = x.shape[-1]
    half = H // 2
    fraction = (2.0 * np.arange(half)) / H
    timescale = torch.as_tensor(min_ts * (max_ts / min_ts) ** fraction, dtype=torch.float32,
                                device=x.device)
    angles = positions[:, :, None, None].float() / timescale
    cos = torch.cos(angles).to(x.dtype)
    sin = torch.sin(angles).to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


class MlpBlock(nn.Module):
    def __init__(self, embed_dim: int, intermediate_dim: int, device=None):
        super().__init__()
        self.wi_fused = DenseGeneral((embed_dim,), (2, intermediate_dim), device=device)
        self.wo = DenseGeneral((intermediate_dim,), (embed_dim,), device=device)

    def forward(self, x):
        h = self.wi_fused(x)  # (..., 2, inter)
        return self.wo(F.silu(h[..., 0, :]) * h[..., 1, :])


class Attention(nn.Module):
    def __init__(self, q_dim, kv_dim, nq, nkv, head_dim, out_dim, device=None):
        super().__init__()
        self.q_proj = DenseGeneral((q_dim,), (nq, head_dim), device=device)
        self.k_proj = DenseGeneral((kv_dim,), (nkv, head_dim), device=device)
        self.v_proj = DenseGeneral((kv_dim,), (nkv, head_dim), device=device)
        self.o_proj = DenseGeneral((nq, head_dim), (out_dim,), device=device)
        self.nq = nq
        self.nkv = nkv
        self.head_dim = head_dim

    def forward(self, xq, xkv, q_pos, kv_pos=None, mask=None, cache=None, cross_kv=None):
        if kv_pos is None:
            kv_pos = q_pos
        q = _rope_timescale(self.q_proj(xq), q_pos).transpose(1, 2)  # (B, Nq, T, H)
        new_cache = None
        if cross_kv is not None:
            k, v = cross_kv
        else:
            k = _rope_timescale(self.k_proj(xkv), kv_pos).transpose(1, 2)
            v = self.v_proj(xkv).transpose(1, 2)
            if cache is not None:
                k, v, new_cache = cache.update(k, v)
        # scale 1.0, as the JAX package passes it
        out = scaled_dot_product_attention(q, k, v, scale=1.0, mask=mask)
        return self.o_proj(out.transpose(1, 2)), new_cache

    def cross_kv(self, encoder_out, src_pos):
        k = _rope_timescale(self.k_proj(encoder_out), src_pos).transpose(1, 2)
        v = self.v_proj(encoder_out).transpose(1, 2)
        return k, v


class EncoderLayer(nn.Module):
    def __init__(self, cfg: DiaConfig, device=None):
        super().__init__()
        e = cfg.model.encoder
        eps = cfg.model.normalization_layer_epsilon
        self.pre_sa_norm = RMSNorm(e.n_embd, eps=eps, device=device)
        self.self_attention = Attention(e.n_embd, e.n_embd, e.n_head, e.n_head, e.head_dim,
                                        e.n_embd, device=device)
        self.post_sa_norm = RMSNorm(e.n_embd, eps=eps, device=device)
        self.mlp = MlpBlock(e.n_embd, e.n_hidden, device=device)

    def forward(self, x, src_pos, mask=None):
        h = self.pre_sa_norm(x)
        a, _ = self.self_attention(h, h, src_pos, mask=mask)
        x = x + a
        return x + self.mlp(self.post_sa_norm(x))


class Encoder(nn.Module):
    def __init__(self, cfg: DiaConfig, device=None):
        super().__init__()
        e = cfg.model.encoder
        self.embedding = Embedding(cfg.model.src_vocab_size, e.n_embd, device=device)
        self.layers = nn.ModuleList(EncoderLayer(cfg, device=device) for _ in range(e.n_layer))
        self.norm = RMSNorm(e.n_embd, eps=cfg.model.normalization_layer_epsilon, device=device)

    def forward(self, x_ids, src_pos, mask=None):
        x = self.embedding(x_ids)
        for layer in self.layers:
            x = layer(x, src_pos, mask)
        return self.norm(x)


class DecoderLayer(nn.Module):
    def __init__(self, cfg: DiaConfig, device=None):
        super().__init__()
        d, e = cfg.model.decoder, cfg.model.encoder
        eps = cfg.model.normalization_layer_epsilon
        self.pre_sa_norm = RMSNorm(d.n_embd, eps=eps, device=device)
        self.self_attention = Attention(d.n_embd, d.n_embd, d.gqa_query_heads, d.kv_heads,
                                        d.gqa_head_dim, d.n_embd, device=device)
        self.pre_ca_norm = RMSNorm(d.n_embd, eps=eps, device=device)
        self.cross_attention = Attention(d.n_embd, e.n_embd, d.cross_query_heads,
                                         d.cross_query_heads, d.cross_head_dim, d.n_embd,
                                         device=device)
        self.pre_mlp_norm = RMSNorm(d.n_embd, eps=eps, device=device)
        self.mlp = MlpBlock(d.n_embd, d.n_hidden, device=device)

    def forward(self, x, tgt_pos, self_mask, cross_mask, self_cache, cross_kv):
        h = self.pre_sa_norm(x)
        a, new_cache = self.self_attention(h, h, tgt_pos, mask=self_mask, cache=self_cache)
        x = x + a
        c, _ = self.cross_attention(self.pre_ca_norm(x), None, tgt_pos, mask=cross_mask,
                                    cross_kv=cross_kv)
        x = x + c
        return x + self.mlp(self.pre_mlp_norm(x)), new_cache


class Decoder(nn.Module):
    def __init__(self, cfg: DiaConfig, device=None):
        super().__init__()
        d = cfg.model.decoder
        self.embeddings = nn.ModuleList(
            Embedding(cfg.model.tgt_vocab_size, d.n_embd, device=device)
            for _ in range(cfg.data.channels))
        self.layers = nn.ModuleList(DecoderLayer(cfg, device=device) for _ in range(d.n_layer))
        self.norm = RMSNorm(d.n_embd, eps=cfg.model.normalization_layer_epsilon, device=device)
        self.logits_dense = DenseGeneral((d.n_embd,), (cfg.data.channels,
                                                       cfg.model.tgt_vocab_size), device=device)
        self.num_channels = cfg.data.channels

    def precompute_cross_kv(self, encoder_out, src_pos):
        return [layer.cross_attention.cross_kv(encoder_out, src_pos) for layer in self.layers]

    def forward(self, tgt_ids, tgt_pos, self_caches, cross_kvs, self_mask=None,
                cross_mask=None):
        """tgt_ids (B, T, C) → float32 logits (B, T, C, V) and the caches."""
        x = None
        for i in range(self.num_channels):
            e = self.embeddings[i](tgt_ids[..., i])
            x = e if x is None else x + e
        new_caches: List[Optional[object]] = []
        for i, layer in enumerate(self.layers):
            x, nc = layer(x, tgt_pos, self_mask, cross_mask,
                          self_caches[i] if self_caches else None, cross_kvs[i])
            new_caches.append(nc)
        return self.logits_dense(self.norm(x)).float(), new_caches


class DiaModel(nn.Module):
    def __init__(self, cfg: DiaConfig, device=None):
        super().__init__()
        self.encoder = Encoder(cfg, device=device)
        self.decoder = Decoder(cfg, device=device)
