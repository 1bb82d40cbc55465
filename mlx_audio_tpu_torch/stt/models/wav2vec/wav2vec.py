"""Wav2Vec2: a convolutional feature encoder and a transformer, with a CTC
head (counterpart of `mlx_audio_tpu/stt/models/wav2vec/wav2vec.py`).

The Hugging Face architecture: the group- or layer-norm conv feature
extractor, the weight-normed positional conv embedding (folded at load),
the standard or stable-layer-norm encoder. Channels-last throughout, as in
the JAX package. Self-attention goes through `ops.attention`, so on the
card a window of 1280 frames or more (25.6 s and up) takes the flash
kernel, one launch a layer.

Where it differs: CTC text comes from the checkpoint's `vocab.json` (the
`Wav2Vec2CTCTokenizer` file) read here, where the JAX package builds the
`transformers` tokenizer; without one both spell ids as letters.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ....base import BaseModelArgs
from ....device import resolve_device
from ....nn import Conv1d, GroupNorm, LayerNorm, Linear
from ....nn.module import init_weights
from ....ops.attention import scaled_dot_product_attention
from ..base import STTOutput, ensure_waveform

__all__ = ["Model", "ModelConfig"]


@dataclass
class ModelConfig(BaseModelArgs):
    model_type: str = "wav2vec2"
    vocab_size: int = 32
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    conv_dim: List[int] = None
    conv_stride: List[int] = None
    conv_kernel: List[int] = None
    conv_bias: bool = False
    num_conv_pos_embeddings: int = 128
    num_conv_pos_embedding_groups: int = 16
    feat_extract_norm: str = "group"
    do_stable_layer_norm: bool = False
    layer_norm_eps: float = 1e-5
    pad_token_id: int = 0
    model_path: str = ""

    def __post_init__(self):
        if self.conv_dim is None:
            self.conv_dim = [512, 512, 512, 512, 512, 512, 512]
        if self.conv_stride is None:
            self.conv_stride = [5, 2, 2, 2, 2, 2, 2]
        if self.conv_kernel is None:
            self.conv_kernel = [10, 3, 3, 3, 3, 2, 2]


class ConvLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, layer_id: int, device=None):
        super().__init__()
        in_dim = cfg.conv_dim[layer_id - 1] if layer_id > 0 else 1
        out_dim = cfg.conv_dim[layer_id]
        self.conv = Conv1d(in_dim, out_dim, cfg.conv_kernel[layer_id],
                           stride=cfg.conv_stride[layer_id], bias=cfg.conv_bias, device=device)
        if cfg.feat_extract_norm == "group" and layer_id == 0:
            self.layer_norm = GroupNorm(out_dim, out_dim, device=device)
            self.norm_kind = "group"
        elif cfg.feat_extract_norm == "layer":
            self.layer_norm = LayerNorm(out_dim, device=device)
            self.norm_kind = "layer"
        else:
            self.norm_kind = "none"

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        if self.norm_kind != "none":
            x = self.layer_norm(x)
        return F.gelu(x)


class PositionalConvEmbedding(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.conv = Conv1d(cfg.hidden_size, cfg.hidden_size, cfg.num_conv_pos_embeddings,
                           padding=cfg.num_conv_pos_embeddings // 2,
                           groups=cfg.num_conv_pos_embedding_groups, device=device)
        self.num_pad_remove = 1 if cfg.num_conv_pos_embeddings % 2 == 0 else 0

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv(x)
        if self.num_pad_remove:
            h = h[:, : -self.num_pad_remove]
        return F.gelu(h)


class Attention(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        d = cfg.hidden_size
        self.q_proj = Linear(d, d, device=device)
        self.k_proj = Linear(d, d, device=device)
        self.v_proj = Linear(d, d, device=device)
        self.out_proj = Linear(d, d, device=device)
        self.heads = cfg.num_attention_heads
        self.hd = d // self.heads

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, T, D = x.shape

        def sp(z):
            return z.reshape(B, T, self.heads, self.hd).transpose(1, 2)

        out = scaled_dot_product_attention(sp(self.q_proj(x)), sp(self.k_proj(x)),
                                           sp(self.v_proj(x)))
        return self.out_proj(out.transpose(1, 2).reshape(B, T, D))


class FeedForward(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.intermediate_dense = Linear(cfg.hidden_size, cfg.intermediate_size, device=device)
        self.output_dense = Linear(cfg.intermediate_size, cfg.hidden_size, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.output_dense(F.gelu(self.intermediate_dense(x)))


class EncoderLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.attention = Attention(cfg, device=device)
        self.layer_norm = LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps, device=device)
        self.feed_forward = FeedForward(cfg, device=device)
        self.final_layer_norm = LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps,
                                          device=device)
        self.stable = cfg.do_stable_layer_norm

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.stable:
            x = x + self.attention(self.layer_norm(x))
            return x + self.feed_forward(self.final_layer_norm(x))
        x = self.layer_norm(x + self.attention(x))
        return self.final_layer_norm(x + self.feed_forward(x))


class _FeatureExtractor(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.conv_layers = nn.ModuleList(ConvLayer(cfg, i, device=device)
                                         for i in range(len(cfg.conv_dim)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.conv_layers:
            x = layer(x)
        return x


class _FeatureProjection(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.layer_norm = LayerNorm(cfg.conv_dim[-1], eps=cfg.layer_norm_eps, device=device)
        self.projection = Linear(cfg.conv_dim[-1], cfg.hidden_size, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.projection(self.layer_norm(x))


class _Encoder(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.pos_conv_embed = PositionalConvEmbedding(cfg, device=device)
        self.layer_norm = LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps, device=device)
        self.layers = nn.ModuleList(EncoderLayer(cfg, device=device)
                                    for _ in range(cfg.num_hidden_layers))
        self.stable = cfg.do_stable_layer_norm

    def forward(self, x: torch.Tensor,
                states: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
        """`states`, where given, gathers the hidden states in Hugging Face's
        order: the input after the positional embedding, then each layer's
        output; with stable layer norm the last one has the final norm."""
        x = x + self.pos_conv_embed(x)
        if not self.stable:
            x = self.layer_norm(x)
        if states is not None:
            states.append(x)
        for layer in self.layers:
            x = layer(x)
            if states is not None:
                states.append(x)
        if self.stable:
            x = self.layer_norm(x)
            if states is not None:
                states[-1] = x
        return x


class Wav2Vec2Model(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.feature_extractor = _FeatureExtractor(cfg, device=device)
        self.feature_projection = _FeatureProjection(cfg, device=device)
        self.encoder = _Encoder(cfg, device=device)

    def _features(self, input_values: torch.Tensor) -> torch.Tensor:
        w = self.feature_projection.projection.weight
        return self.feature_projection(self.feature_extractor(input_values[..., None].to(w.dtype)))

    def forward(self, input_values: torch.Tensor) -> torch.Tensor:
        """(B, T) samples → (B, frames, hidden)."""
        return self.encoder(self._features(input_values))

    def hidden_states(self, input_values: torch.Tensor) -> List[torch.Tensor]:
        """Every encoder hidden state in Hugging Face's order: index 0 the
        input after the positional embedding, index i the output of layer i;
        with stable layer norm the last entry has the final norm applied.
        Spark's BiCodec features average states 11, 14 and 16."""
        states: List[torch.Tensor] = []
        self.encoder(self._features(input_values), states)
        return states


class _CTCVocab:
    """`vocab.json` ids → text: the pad (blank) dropped, `|` a space."""

    def __init__(self, path: Path):
        vocab = json.loads(path.read_text(encoding="utf-8"))
        self.id_to_token = {int(i): t for t, i in vocab.items()}

    def decode(self, ids) -> str:
        toks = [self.id_to_token.get(int(i), "") for i in ids]
        return "".join(t for t in toks if t != "<pad>").replace("|", " ")


class Model(nn.Module):
    """Wav2Vec2 on an explicit device (None: the card), weights drawn from
    `seed`, in float32."""

    def __init__(self, config: ModelConfig, device=None, seed: int = 0):
        super().__init__()
        if isinstance(config, dict):
            config = ModelConfig.from_dict(config)
        self.config = config
        self.device = resolve_device(device)
        self.wav2vec2 = Wav2Vec2Model(config, device=self.device)
        if config.vocab_size:
            self.lm_head = Linear(config.hidden_size, config.vocab_size, device=self.device)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        init_weights(self, gen)

    @torch.inference_mode()
    def forward(self, input_values):
        """(B, T) samples → (hidden (B, frames, hidden), CTC logits or None)."""
        x = torch.as_tensor(np.asarray(input_values) if not isinstance(
            input_values, torch.Tensor) else input_values, device=self.device).float()
        h = self.wav2vec2(x)
        return h, (self.lm_head(h) if hasattr(self, "lm_head") else None)

    def embeddings(self, audio) -> np.ndarray:
        h, _ = self(np.asarray(audio, np.float32).reshape(1, -1))
        return h[0].float().cpu().numpy()

    def make_batcher(self, **kwargs):
        """Serving batcher: concurrent equal-length windows run as one
        batched CTC forward (rows are independent)."""
        from ....serving import StackBatcher

        def run_batch(items):
            _, logits = self(np.stack([np.asarray(a, np.float32) for a in items]))
            return list(torch.argmax(logits, dim=-1).cpu().numpy())

        return StackBatcher(self, run_batch, device=self.device, **kwargs)

    def _tokenizer(self):
        path = Path(self.config.model_path or "") / "vocab.json"
        return _CTCVocab(path) if self.config.model_path and path.is_file() else None

    def generate(self, audio, *, tokenizer=None, **kwargs) -> STTOutput:
        """Greedy CTC: the argmax a frame, repeats and blanks collapsed."""
        from ....serving import get_infer_hook

        t0 = time.perf_counter()
        audio = ensure_waveform(audio, 16000).reshape(1, -1)
        # zero mean, unit variance (the processor's default)
        audio = (audio - audio.mean()) / (audio.std() + 1e-7)
        # under a running server a StackBatcher may be installed: concurrent
        # equal-length windows fuse into one CTC forward
        hook = get_infer_hook(self)
        if hook is not None and hasattr(self, "lm_head"):
            pred = np.asarray(hook(audio[0].astype(np.float32)))
        else:
            _, logits = self(audio.astype(np.float32))
            if logits is None:
                return STTOutput(text="")
            pred = torch.argmax(logits, dim=-1).cpu().numpy()[0]
        blank = self.config.pad_token_id
        collapsed = []
        prev = -1
        for p in pred:
            if p != blank and p != prev:
                collapsed.append(int(p))
            prev = p
        tokenizer = tokenizer or self._tokenizer()
        text = (tokenizer.decode(collapsed) if tokenizer is not None
                else "".join(map(chr, (c + 97 for c in collapsed))))
        wall = time.perf_counter() - t0
        dur = audio.shape[-1] / 16000
        return STTOutput(text=text.strip(), duration=dur, generation_tokens=len(collapsed),
                         extra={"xrt": dur / max(wall, 1e-9)})

    def sanitize(self, weights: dict) -> dict:
        """Fold the positional conv's weight norm; drop the pretraining heads
        (quantizer, project_q, project_hid, masked_spec_embed, adapter)."""
        from ....codec.models.base import fold_weight_norm_pairs
        from ....nn.sanitize import orient_weights_to_model

        out = {k: v for k, v in fold_weight_norm_pairs(weights).items()
               if not any(s in k for s in ("quantizer", "project_q", "project_hid",
                                           "masked_spec_embed", "adapter"))}
        return orient_weights_to_model(self, out)
