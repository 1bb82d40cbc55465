"""ALBERT (PL-BERT) text encoder for Kokoro (counterpart of
`mlx_audio_tpu/tts/models/kokoro/albert.py`).

HF ALBERT naming, so the checkpoint's `bert.*` keys map 1:1. Attention is
the port's `ops.attention.scaled_dot_product_attention` with an additive
float32 -inf padding mask; at Kokoro's T <= 512 with a mask it takes the
matmul path."""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from ....base import BaseModelArgs
from ....nn import Embedding, LayerNorm, Linear
from ....ops.attention import scaled_dot_product_attention

__all__ = ["AlbertModelArgs", "CustomAlbert"]


@dataclass
class AlbertModelArgs(BaseModelArgs):
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    hidden_size: int = 768
    intermediate_size: int = 2048
    max_position_embeddings: int = 512
    model_type: str = "albert"
    embedding_size: int = 128
    inner_group_num: int = 1
    num_hidden_groups: int = 1
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    vocab_size: int = 178
    dropout: float = 0.0


class AlbertEmbeddings(nn.Module):
    def __init__(self, config: AlbertModelArgs, device=None):
        super().__init__()
        e = config.embedding_size
        self.word_embeddings = Embedding(config.vocab_size, e, device=device)
        self.position_embeddings = Embedding(config.max_position_embeddings, e, device=device)
        self.token_type_embeddings = Embedding(config.type_vocab_size, e, device=device)
        self.LayerNorm = LayerNorm(e, eps=config.layer_norm_eps, device=device)

    def forward(self, input_ids, token_type_ids=None, position_ids=None):
        T = input_ids.shape[1]
        if position_ids is None:
            position_ids = torch.arange(T, device=input_ids.device)[None]
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        emb = (self.word_embeddings(input_ids) + self.position_embeddings(position_ids)
               + self.token_type_embeddings(token_type_ids))
        return self.LayerNorm(emb)


class AlbertAttention(nn.Module):
    def __init__(self, config: AlbertModelArgs, device=None):
        super().__init__()
        d = config.hidden_size
        self.query = Linear(d, d, device=device)
        self.key = Linear(d, d, device=device)
        self.value = Linear(d, d, device=device)
        self.dense = Linear(d, d, device=device)
        self.LayerNorm = LayerNorm(d, eps=config.layer_norm_eps, device=device)
        self.num_heads = config.num_attention_heads

    def forward(self, x, mask=None):
        B, T, D = x.shape
        hd = D // self.num_heads

        def heads(t):
            return t.reshape(B, T, self.num_heads, hd).transpose(1, 2)

        out = scaled_dot_product_attention(heads(self.query(x)), heads(self.key(x)),
                                           heads(self.value(x)), mask=mask)
        out = out.transpose(1, 2).reshape(B, T, D)
        return self.LayerNorm(x + self.dense(out))


class AlbertLayer(nn.Module):
    def __init__(self, config: AlbertModelArgs, device=None):
        super().__init__()
        self.attention = AlbertAttention(config, device=device)
        self.ffn = Linear(config.hidden_size, config.intermediate_size, device=device)
        self.ffn_output = Linear(config.intermediate_size, config.hidden_size, device=device)
        self.full_layer_layer_norm = LayerNorm(config.hidden_size, eps=config.layer_norm_eps,
                                               device=device)

    def forward(self, x, mask=None):
        a = self.attention(x, mask)
        h = self.ffn_output(F.gelu(self.ffn(a)))  # exact (erf) GELU
        return self.full_layer_layer_norm(a + h)


class AlbertLayerGroup(nn.Module):
    def __init__(self, config: AlbertModelArgs, device=None):
        super().__init__()
        self.albert_layers = nn.ModuleList(
            AlbertLayer(config, device=device) for _ in range(config.inner_group_num))

    def forward(self, x, mask=None):
        for layer in self.albert_layers:
            x = layer(x, mask)
        return x


class AlbertEncoder(nn.Module):
    def __init__(self, config: AlbertModelArgs, device=None):
        super().__init__()
        self.embedding_hidden_mapping_in = Linear(config.embedding_size, config.hidden_size,
                                                  device=device)
        self.albert_layer_groups = nn.ModuleList(
            AlbertLayerGroup(config, device=device) for _ in range(config.num_hidden_groups))
        self.num_hidden_layers = config.num_hidden_layers
        self.num_hidden_groups = config.num_hidden_groups

    def forward(self, x, mask=None):
        x = self.embedding_hidden_mapping_in(x)
        per_group = self.num_hidden_layers // self.num_hidden_groups
        for i in range(self.num_hidden_layers):
            x = self.albert_layer_groups[i // per_group](x, mask)
        return x


class CustomAlbert(nn.Module):
    def __init__(self, config: AlbertModelArgs, device=None):
        super().__init__()
        self.embeddings = AlbertEmbeddings(config, device=device)
        self.encoder = AlbertEncoder(config, device=device)
        self.pooler = Linear(config.hidden_size, config.hidden_size, device=device)
        self.config = config

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        """input_ids (B, T); attention_mask (B, T), 1 = attend → the
        sequence (B, T, hidden) and the pooled first position (B, hidden)."""
        x = self.embeddings(input_ids, token_type_ids)
        mask = None
        if attention_mask is not None:
            mask = torch.zeros(attention_mask.shape, dtype=torch.float32,
                               device=attention_mask.device)
            mask = mask.masked_fill(attention_mask <= 0, float("-inf"))[:, None, None, :]
        seq = self.encoder(x, mask)
        pooled = torch.tanh(self.pooler(seq[:, 0]))
        return seq, pooled
