"""Whisper model for PyTorch/CUDA (counterpart of
`mlx_audio_tpu/stt/models/whisper/whisper.py`).

Parameter names follow the JAX package (encoder.blocks.N.attn.query...), so
`nn.load_weights` carries its weights and checkpoints across. The encoder's
self-attention (T = S = 1500) takes the hand-written flash kernel on the
card through `ops.attention`; the decoder's steps take the matmul path.

Entry points: `generate` (the sequential 30 s seek loop), `generate_chunked`
(batched 30 s windows, with and without previous-text conditioning) and
`generate_streaming` (AlignAtt, `streaming.py`); beam search
(`decoding.py`) and word timestamps (`timing.py`) serve the first two.
`make_batcher` gives the serving batcher that `generate` routes its windows
through once it is installed.
Audio is a 16 kHz mono waveform, or a path that `utils.load_audio` reads,
downmixes and resamples to one.
"""

from __future__ import annotations

import math
import time
import warnings
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ....base import BaseModelArgs
from ....device import resolve_device
from ....lm.cache import KVCache
from ....nn import Conv1d, Embedding, LayerNorm, Linear
from ....nn.module import cast_floats, init_weights
from ....nn.sanitize import permute
from ....ops.attention import make_causal_mask, scaled_dot_product_attention
from ....serving import get_infer_hook
from ..base import STTOutput
from . import audio as A
from .decoding import DecodingOptions, DecodingResult, decode_window, decode_window_batch

__all__ = ["Model", "ModelConfig", "ModelDimensions"]


def _waveform(audio) -> np.ndarray:
    """The entry points' audio argument as float32 samples: a path is read
    at 16 kHz mono, as the JAX package's entry points read it."""
    if isinstance(audio, str) or hasattr(audio, "__fspath__"):
        from ....utils import load_audio

        audio = load_audio(audio, sample_rate=A.SAMPLE_RATE)
    return np.asarray(audio, np.float32).reshape(-1)


@dataclass
class ModelDimensions(BaseModelArgs):
    n_mels: int = 80
    n_audio_ctx: int = 1500
    n_audio_state: int = 512
    n_audio_head: int = 8
    n_audio_layer: int = 6
    n_vocab: int = 51865
    n_text_ctx: int = 448
    n_text_state: int = 512
    n_text_head: int = 8
    n_text_layer: int = 6
    model_path: str = ""

    @classmethod
    def from_dict(cls, config: dict):
        config = dict(config)
        if "d_model" in config:  # HF transformers naming
            config.setdefault("n_mels", config.get("num_mel_bins", 80))
            config.setdefault("n_audio_state", config["d_model"])
            config.setdefault("n_text_state", config["d_model"])
            config.setdefault("n_audio_head", config.get("encoder_attention_heads", 8))
            config.setdefault("n_text_head", config.get("decoder_attention_heads", 8))
            config.setdefault("n_audio_layer", config.get("encoder_layers", 6))
            config.setdefault("n_text_layer", config.get("decoder_layers", 6))
            config.setdefault("n_vocab", config.get("vocab_size", 51865))
            config.setdefault("n_text_ctx", config.get("max_target_positions", 448))
            config.setdefault("n_audio_ctx", config.get("max_source_positions", 1500))
        return super(ModelDimensions, cls).from_dict(config)


ModelConfig = ModelDimensions


def sinusoids(length: int, channels: int, max_timescale: int = 10000) -> np.ndarray:
    assert channels % 2 == 0
    log_ts_inc = math.log(max_timescale) / (channels // 2 - 1)
    inv = np.exp(-log_ts_inc * np.arange(channels // 2))
    scaled = np.arange(length)[:, None] * inv[None, :]
    return np.concatenate([np.sin(scaled), np.cos(scaled)], axis=1).astype(np.float32)


class MultiHeadAttention(nn.Module):
    # post-load quantized q/k/v row-stack (`fuse_quantized_projections`):
    # valid only when all three read the same activation, so the
    # cross-attention sets `_fuse_veto` (its key/value read encoder state)
    _FUSE_GROUPS = (("qkv_fused", ("query", "key", "value")),)

    def __init__(self, n_state: int, n_head: int, device=None):
        super().__init__()
        self.query = Linear(n_state, n_state, device=device)
        self.key = Linear(n_state, n_state, bias=False, device=device)
        self.value = Linear(n_state, n_state, device=device)
        self.out = Linear(n_state, n_state, device=device)
        self.n_head = n_head

    def _split(self, x):
        # (B, T, D) → (B, H, T, Dh) as a view: the flash kernel takes the
        # strides as they are
        B, T, D = x.shape
        return x.view(B, T, self.n_head, D // self.n_head).transpose(1, 2)

    def forward(self, x, xa=None, mask=None, cache: Optional[KVCache] = None,
                cross_kv: Optional[Tuple] = None):
        new_cache = None
        if hasattr(self, "qkv_fused") and xa is None and cross_kv is None:
            q, k, v = (self._split(p) for p in self.qkv_fused(x))
            if cache is not None:
                k, v, new_cache = cache.update(k, v)
        else:
            q = self._split(self.query(x))
            if cross_kv is not None:
                k, v = cross_kv
            else:
                src = xa if xa is not None else x
                k = self._split(self.key(src))
                v = self._split(self.value(src))
                if cache is not None:
                    k, v, new_cache = cache.update(k, v)
        out = scaled_dot_product_attention(q, k, v, mask=mask)
        B, H, T, Dh = out.shape
        return self.out(out.transpose(1, 2).reshape(B, T, H * Dh)), new_cache

    def cross_kv(self, xa):
        return self._split(self.key(xa)), self._split(self.value(xa))

    def call_with_qk(self, x, cross_kv):
        """Cross-attention returning (out, qk): qk are the pre-softmax scaled
        scores in float32, the products of the operands in their own dtype
        summed in float32 and then scaled, as the JAX package's einsum with
        preferred_element_type=float32 (the word-alignment input)."""
        q = self._split(self.query(x))
        k, v = cross_kv
        scale = q.shape[-1] ** -0.5
        qk = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
        out = torch.matmul(torch.softmax(qk, dim=-1).to(v.dtype), v)
        B, H, T, Dh = out.shape
        return self.out(out.transpose(1, 2).reshape(B, T, H * Dh)), qk


class ResidualAttentionBlock(nn.Module):
    def __init__(self, n_state: int, n_head: int, cross_attention: bool = False,
                 device=None):
        super().__init__()
        self.attn = MultiHeadAttention(n_state, n_head, device=device)
        self.attn_ln = LayerNorm(n_state, device=device)
        if cross_attention:
            self.cross_attn = MultiHeadAttention(n_state, n_head, device=device)
            self.cross_attn._fuse_veto = True  # key/value read encoder state
            self.cross_attn_ln = LayerNorm(n_state, device=device)
        else:
            self.cross_attn = None
        self.mlp1 = Linear(n_state, 4 * n_state, device=device)
        self.mlp2 = Linear(4 * n_state, n_state, device=device)
        self.mlp_ln = LayerNorm(n_state, device=device)

    def forward(self, x, xa=None, mask=None, cache=None, cross_kv=None):
        a, new_cache = self.attn(self.attn_ln(x), mask=mask, cache=cache)
        x = x + a
        if self.cross_attn is not None:
            c, _ = self.cross_attn(self.cross_attn_ln(x), xa=xa, cross_kv=cross_kv)
            x = x + c
        x = x + self.mlp2(F.gelu(self.mlp1(self.mlp_ln(x))))  # exact (erf) GELU
        return x, new_cache

    def cross_mlp_with_qk(self, x, cross_kv):
        """The cross-attention and MLP halves of the block, returning the
        cross-attention scores too (the score-capturing decoder passes)."""
        c, qk = self.cross_attn.call_with_qk(self.cross_attn_ln(x), cross_kv)
        x = x + c
        return x + self.mlp2(F.gelu(self.mlp1(self.mlp_ln(x)))), qk


class AudioEncoder(nn.Module):
    def __init__(self, dims: ModelDimensions, device=None):
        super().__init__()
        self.conv1 = Conv1d(dims.n_mels, dims.n_audio_state, 3, padding=1, device=device)
        self.conv2 = Conv1d(dims.n_audio_state, dims.n_audio_state, 3, stride=2,
                            padding=1, device=device)
        self.blocks = nn.ModuleList(
            ResidualAttentionBlock(dims.n_audio_state, dims.n_audio_head, device=device)
            for _ in range(dims.n_audio_layer)
        )
        self.ln_post = LayerNorm(dims.n_audio_state, device=device)
        # recomputed constant: not a parameter, never loaded or saved
        self.register_buffer(
            "_positional_embedding",
            torch.from_numpy(sinusoids(dims.n_audio_ctx, dims.n_audio_state)).to(device),
            persistent=False,
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # x: (B, T=3000, n_mels); compute in the parameter dtype (bf16 after
        # cast_floats) whatever the float32 mel front-end gives
        x = x.to(self.conv1.weight.dtype)
        x = F.gelu(self.conv1(x))
        x = F.gelu(self.conv2(x))
        x = x + self._positional_embedding[: x.shape[1]].to(x.dtype)
        for block in self.blocks:
            x, _ = block(x)
        return self.ln_post(x)


class TextDecoder(nn.Module):
    def __init__(self, dims: ModelDimensions, device=None):
        super().__init__()
        self.token_embedding = Embedding(dims.n_vocab, dims.n_text_state, device=device)
        self.positional_embedding = nn.Parameter(
            torch.empty(dims.n_text_ctx, dims.n_text_state, device=device))
        self.blocks = nn.ModuleList(
            ResidualAttentionBlock(dims.n_text_state, dims.n_text_head,
                                   cross_attention=True, device=device)
            for _ in range(dims.n_text_layer)
        )
        self.ln = LayerNorm(dims.n_text_state, device=device)

    def reset_parameters(self, generator: Optional[torch.Generator]) -> None:
        self.positional_embedding.data.normal_(0.0, 0.01, generator=generator)

    def cross_kv(self, xa):
        return [blk.cross_attn.cross_kv(xa) for blk in self.blocks]

    def forward(self, tokens, pos0: int, caches, cross_kv):
        """tokens (B, t); pos0: starting position; caches: per-layer KVCache
        or None; cross_kv: list of (k, v). Returns (logits, new_caches)."""
        B, t = tokens.shape
        x = self.token_embedding(tokens)
        x = x + self.positional_embedding[pos0:pos0 + t].to(x.dtype)
        if caches is not None:
            mask = caches[0].attention_mask(t)
        elif t > 1:
            mask = make_causal_mask(t, t, device=x.device)
        else:
            mask = None
        new_caches = []
        for i, blk in enumerate(self.blocks):
            x, nc = blk(
                x, mask=mask,
                cache=caches[i] if caches is not None else None,
                cross_kv=cross_kv[i],
            )
            new_caches.append(nc)
        x = self.ln(x)
        return self.token_embedding.as_linear(x), new_caches

    def step_with_qk(self, tokens, pos0: int, caches, cross_kv):
        """Incremental decode step that also returns each layer's
        cross-attention scores for the new tokens (AlignAtt streaming)."""
        B, t = tokens.shape
        x = self.token_embedding(tokens)
        x = x + self.positional_embedding[pos0:pos0 + t].to(x.dtype)
        mask = caches[0].attention_mask(t) if caches is not None else None
        new_caches, qks = [], []
        for i, blk in enumerate(self.blocks):
            a, nc = blk.attn(blk.attn_ln(x), mask=mask,
                             cache=caches[i] if caches is not None else None)
            new_caches.append(nc)
            x, qk = blk.cross_mlp_with_qk(x + a, cross_kv[i])
            qks.append(qk)
        x = self.ln(x)
        return self.token_embedding.as_linear(x), new_caches, qks

    def forward_with_cross_qk(self, tokens, cross_kv):
        """Full-sequence decode capturing each layer's cross-attention
        scores (word alignment)."""
        B, t = tokens.shape
        x = self.token_embedding(tokens)
        x = x + self.positional_embedding[:t].to(x.dtype)
        mask = make_causal_mask(t, t, device=x.device) if t > 1 else None
        qks = []
        for i, blk in enumerate(self.blocks):
            a, _ = blk.attn(blk.attn_ln(x), mask=mask)
            x, qk = blk.cross_mlp_with_qk(x + a, cross_kv[i])
            qks.append(qk)
        x = self.ln(x)
        return self.token_embedding.as_linear(x), qks


def _get_end(segments: List[dict]) -> Optional[float]:
    """Last word-level end time across segments, falling back to the last
    segment end."""
    for s in reversed(segments):
        for w in reversed(s.get("words") or []):
            return w["end"]
    return segments[-1]["end"] if segments else None


# hallucination heuristics: anomalous words are very short, very long or
# improbable; a segment whose first words are mostly anomalous is treated as
# hallucinated when silence surrounds it
_ANOMALY_PUNCTUATION = "\"'“¿([{-\"'.。,，!！?？:：”)]}、"


def _word_anomaly_score(word: dict) -> float:
    probability = word.get("probability", 0.0)
    duration = word["end"] - word["start"]
    score = 0.0
    if probability < 0.15:
        score += 1.0
    if duration < 0.133:
        score += (0.133 - duration) * 15
    if duration > 2.0:
        score += duration - 2.0
    return score


def _is_segment_anomaly(segment: Optional[dict]) -> bool:
    if segment is None or not segment.get("words"):
        return False
    words = [
        w for w in segment["words"] if w["word"] not in _ANOMALY_PUNCTUATION
    ][:8]
    score = sum(_word_anomaly_score(w) for w in words)
    return score >= 3 or score + 0.01 >= len(words)


def _next_words_segment(segments: List[dict]) -> Optional[dict]:
    return next((s for s in segments if s.get("words")), None)


def _result_ok(res, compression_ratio_threshold, logprob_threshold) -> bool:
    """A decode passes the temperature fallback's thresholds (None turns
    one off)."""
    if (compression_ratio_threshold is not None
            and res.compression_ratio > compression_ratio_threshold):
        return False
    return not (logprob_threshold is not None and res.avg_logprob < logprob_threshold)


def _is_silent(res, no_speech_threshold, logprob_threshold) -> bool:
    """The no-speech skip: such a window emits no segment."""
    return (no_speech_threshold is not None
            and res.no_speech_prob > no_speech_threshold
            and (logprob_threshold is None or res.avg_logprob < logprob_threshold))


def _hf_to_native(weights: dict) -> dict:
    """Map HF transformers whisper keys → native (openai/mlx) naming."""
    out = {}
    rules = [
        ("model.encoder.", "encoder."), ("model.decoder.", "decoder."),
        ("encoder.layers.", "encoder.blocks."), ("decoder.layers.", "decoder.blocks."),
        (".self_attn.q_proj.", ".attn.query."), (".self_attn.k_proj.", ".attn.key."),
        (".self_attn.v_proj.", ".attn.value."), (".self_attn.out_proj.", ".attn.out."),
        (".self_attn_layer_norm.", ".attn_ln."),
        (".encoder_attn.q_proj.", ".cross_attn.query."),
        (".encoder_attn.k_proj.", ".cross_attn.key."),
        (".encoder_attn.v_proj.", ".cross_attn.value."),
        (".encoder_attn.out_proj.", ".cross_attn.out."),
        (".encoder_attn_layer_norm.", ".cross_attn_ln."),
        (".fc1.", ".mlp1."), (".fc2.", ".mlp2."),
        (".final_layer_norm.", ".mlp_ln."),
        ("encoder.layer_norm.", "encoder.ln_post."),
        ("decoder.layer_norm.", "decoder.ln."),
        ("decoder.embed_tokens.", "decoder.token_embedding."),
        ("decoder.embed_positions.weight", "decoder.positional_embedding"),
    ]
    for k, v in weights.items():
        nk = k
        for old, new in rules:
            nk = nk.replace(old, new)
        out[nk] = v
    return out


class Model(nn.Module):
    """Whisper on an explicit device: `Model(dims)` builds on the card and
    raises when there is none; tests pass `device="cpu"`. Weights are drawn
    from `seed` and then cast to `dtype`. A dict `dims` may carry
    `alignment_heads` (the (layer, head) pairs word timing reads)."""

    PROMPT_BUCKETS = (8, 16, 32, 64, 128, 227)

    def __init__(self, dims: Union[ModelDimensions, dict], device=None,
                 dtype=torch.float32, seed: int = 0):
        super().__init__()
        heads = None
        if isinstance(dims, dict):
            dims = dict(dims)
            heads = dims.pop("alignment_heads", None)
            dims = ModelDimensions.from_dict(dims)
        self.dims = dims
        self.device = resolve_device(device)
        self.encoder = AudioEncoder(dims, device=self.device)
        self.decoder = TextDecoder(dims, device=self.device)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        init_weights(self, gen)
        if dtype != torch.float32:
            cast_floats(self, dtype)
        if heads:
            self.set_alignment_heads(heads)

    # ---- loading ----

    def sanitize(self, weights: dict) -> dict:
        """HF or MLX-converted checkpoint dict → the JAX package's names and
        layouts, which `nn.load_weights` takes: convolution weights
        (O, K, I), turned from torch's (O, I, K) by shape, as there. A
        convolution weight whose two inner axes have one length > 1 fits
        both layouts and raises."""
        if any(k.startswith("model.") for k in weights):
            weights = _hf_to_native(weights)
        out = {}
        for k, v in weights.items():
            if k.startswith("encoder") and "token" not in k and (
                "positional_embedding" in k or "embed_positions" in k
            ):
                continue  # encoder sinusoids are recomputed
            if (k.endswith("conv1.weight") or k.endswith("conv2.weight")) and v.ndim == 3:
                if v.shape[1] == v.shape[2] > 1:
                    raise ValueError(
                        f"{k} of shape {tuple(v.shape)} fits both (O, I, K) and (O, K, I): "
                        f"its layout cannot be told from its shape")
                if v.shape[1] > v.shape[2]:
                    v = permute(v, (0, 2, 1))  # torch (O,I,K) -> (O,K,I)
            if k == "decoder.positional_embedding.weight":
                k = "decoder.positional_embedding"
            # the OpenAI release's MLP names (`convert` writes them as they are)
            out[k.replace(".mlp.0.", ".mlp1.").replace(".mlp.2.", ".mlp2.")] = v
        out.pop("proj_out.weight", None)
        return out

    @property
    def is_multilingual(self) -> bool:
        return self.dims.n_vocab >= 51865

    @property
    def num_languages(self) -> int:
        return self.dims.n_vocab - 51765 - int(self.is_multilingual)

    # ---- word-alignment support ----

    def set_alignment_heads(self, heads) -> None:
        """heads: iterable of (layer, head) pairs used for DTW alignment."""
        self.alignment_heads_static = tuple(tuple(int(i) for i in h) for h in heads)

    @property
    def alignment_heads(self):
        """Configured heads, or every head of the top half of the decoder
        layers."""
        heads = getattr(self, "alignment_heads_static", None)
        if heads:
            return heads
        d = self.dims
        return tuple((l, h) for l in range(d.n_text_layer // 2, d.n_text_layer)
                     for h in range(d.n_text_head))

    def _tokens(self, tokens) -> torch.Tensor:
        return torch.as_tensor(tokens, dtype=torch.long, device=self.device)

    @torch.inference_mode()
    def forward_with_cross_qk(self, mel, tokens):
        """mel (B, 3000, n_mels), tokens (B, T) → (logits, [qk per layer])."""
        _xa, cross_kv = self._encode(torch.as_tensor(mel, device=self.device))
        return self.decoder.forward_with_cross_qk(self._tokens(tokens), cross_kv)

    @torch.inference_mode()
    def decoder_cross_qk(self, cross_kv, tokens):
        """`forward_with_cross_qk` on already computed encoder K/V (chunked
        mode: word timing reuses the batched encode's)."""
        return self.decoder.forward_with_cross_qk(self._tokens(tokens), cross_kv)

    def embed_audio(self, mel):
        """mel (B, 3000, n_mels) → encoder features."""
        return self._encode(torch.as_tensor(mel, device=self.device))[0]

    @torch.inference_mode()
    def logits(self, tokens, audio_features):
        """Decoder logits over a token prefix given encoder features."""
        cross_kv = self.decoder.cross_kv(torch.as_tensor(audio_features, device=self.device))
        return self.decoder.forward_with_cross_qk(self._tokens(tokens), cross_kv)[0]

    # ---- pieces ----

    @torch.inference_mode()
    def _encode(self, mel: torch.Tensor):
        xa = self.encoder(mel)
        return xa, self.decoder.cross_kv(xa)

    def _make_caches(self, batch: int, capacity: int):
        """Decoder KV caches; `capacity` trims the self-attention window to
        what the decode will write instead of the full n_text_ctx."""
        d = self.dims
        cap = min(capacity, d.n_text_ctx)
        # the compute dtype: a quantized token embedding's weight holds
        # packed int32 words (the JAX package takes that dtype, ROADMAP Queue 3)
        w = self.decoder.positional_embedding
        return [
            KVCache(batch, d.n_text_head, cap, d.n_text_state // d.n_text_head,
                    dtype=w.dtype, device=w.device)
            for _ in range(d.n_text_layer)
        ]

    @staticmethod
    @torch.inference_mode()
    def _decoder_step(model: "Model", tokens, pos0, caches, cross_kv):
        return model.decoder(tokens, pos0, caches, cross_kv)

    def _mel_chunks_device(self, audio: np.ndarray):
        """Stacked per-30 s-chunk log-mel on the model's device:
        (n_chunks, N_FRAMES, n_mels). Audio is quantised to int16 on the
        host (the PCM16 writer's quantiser) and goes to the device as int16,
        as in the JAX package, so both packages see the same samples."""
        total = len(audio) + A.N_SAMPLES
        n_chunks = (total + A.N_SAMPLES - 1) // A.N_SAMPLES
        padded = np.zeros(n_chunks * A.N_SAMPLES, np.int16)
        padded[: len(audio)] = np.clip(
            np.round(audio * 32768.0), -32768, 32767
        ).astype(np.int16)
        chunks = torch.from_numpy(padded.reshape(n_chunks, A.N_SAMPLES))
        chunks = chunks.to(self.device).float() / 32768.0
        return A.log_mel_spectrogram(chunks, n_mels=self.dims.n_mels), n_chunks

    def _mel_chunk(self, audio_chunk) -> torch.Tensor:
        """One fixed-length chunk of samples → (frames, n_mels) log-mel on
        the model's device (normalised over the chunk)."""
        x = torch.as_tensor(np.asarray(audio_chunk, np.float32)).to(self.device)
        return A.log_mel_spectrogram(x, n_mels=self.dims.n_mels)

    @staticmethod
    def _window_slice(mel_flat: torch.Tensor, seek: int, seg: int) -> torch.Tensor:
        """The N_FRAMES window at frame `seek` of the whole-audio mel, rows
        >= `seg` zeroed, without the mel leaving the device."""
        w = mel_flat[seek:seek + A.N_FRAMES]
        keep = torch.arange(A.N_FRAMES, device=w.device) < seg
        return w * keep[:, None].to(w.dtype)

    @torch.inference_mode()
    def detect_language(self, cross_kv, tokenizer) -> Tuple[str, dict]:
        tokens = torch.tensor([[tokenizer.sot]], dtype=torch.long, device=self.device)
        logits = self.decoder(tokens, 0, None, cross_kv)[0]
        logits = logits[0, -1].float().cpu().numpy()
        lang_tokens = list(tokenizer.all_language_tokens)
        lang_logits = logits[lang_tokens]
        probs = np.exp(lang_logits - lang_logits.max())
        probs = probs / probs.sum()
        best = int(np.argmax(probs))
        code = tokenizer.all_language_codes[best]
        return code, dict(zip(tokenizer.all_language_codes, probs.tolist()))

    def _check_fp16_option(self, decode_options: dict) -> None:
        """Half precision is the weights' dtype, fixed at build time; say so
        when an explicit fp16 request disagrees with it."""
        if "fp16" not in decode_options:
            return
        dtype = self.decoder.positional_embedding.dtype
        half = dtype in (torch.bfloat16, torch.float16)
        if bool(decode_options["fp16"]) != half:
            warnings.warn(
                f"fp16={decode_options['fp16']} requested but model weights "
                f"are {dtype}; the compute precision is the weights' dtype "
                f"(build with dtype=torch.bfloat16 for half precision)."
            )

    def get_tokenizer(self, language: str = "en", task: str = "transcribe"):
        from .tokenizer import WhisperTokenizer

        return WhisperTokenizer(
            self.dims.model_path, multilingual=self.is_multilingual,
            language=language, task=task,
        )

    # ---- transcription ----

    def _fallback_options(self, decode_options: dict, task: str, language,
                          temperature: float, without_timestamps: bool) -> DecodingOptions:
        """Options for one temperature of the fallback: beam options apply
        only at t = 0, best_of only at t > 0."""
        kw = {k: v for k, v in decode_options.items()
              if k in DecodingOptions.__dataclass_fields__}
        if temperature > 0:
            kw.pop("beam_size", None)
            kw.pop("patience", None)
        else:
            kw.pop("best_of", None)
        return DecodingOptions(task=task, language=language, temperature=float(temperature),
                               without_timestamps=without_timestamps, **kw)

    @torch.inference_mode()
    def generate(
        self,
        audio,
        *,
        language: Optional[str] = None,
        task: str = "transcribe",
        temperature: Union[float, Sequence[float]] = (0.0, 0.2, 0.4, 0.6, 0.8, 1.0),
        compression_ratio_threshold: Optional[float] = 2.4,
        logprob_threshold: Optional[float] = -1.0,
        no_speech_threshold: Optional[float] = 0.6,
        condition_on_previous_text: bool = True,
        initial_prompt: Optional[str] = None,
        word_timestamps: bool = False,
        prepend_punctuations: str = "\"'“¿([{-",
        append_punctuations: str = "\"'.。,，!！?？:：”)]}、",
        clip_timestamps: Union[str, Sequence[float]] = "0",
        hallucination_silence_threshold: Optional[float] = None,
        verbose: Optional[bool] = None,
        without_timestamps: bool = False,
        stream: bool = False,
        chunk_duration: float = 1.0,
        tokenizer=None,
        on_segment=None,
        **decode_options,
    ):
        """Sequential 30 s seek-loop transcription, the JAX package's default
        entry point: each window is encoded (batch 1) and decoded with the
        temperature fallback, segmented at its timestamps, and the seek
        pointer moves to where the window's text ends.

        ``stream=True`` hands off to `generate_streaming`. Under a running
        server a `WhisperBatcher` may be installed (`make_batcher`): each
        window's encode and decode then go through it, fused with the
        windows of concurrent requests."""
        if stream:
            return self.generate_streaming(
                audio, chunk_duration=chunk_duration, language=language,
                task=task, tokenizer=tokenizer)
        start_t = time.perf_counter()
        decode_options.pop("max_tokens", None)
        decode_options.pop("generation_stream", None)
        unknown = set(decode_options) - set(DecodingOptions.__dataclass_fields__)
        if unknown:
            raise TypeError(f"unknown decode options: {sorted(unknown)}")
        self._check_fp16_option(decode_options)
        audio = _waveform(audio)

        # the whole-audio mel stays on the device; each window is a slice
        mel_dev, _ = self._mel_chunks_device(audio)
        mel_flat = mel_dev.reshape(-1, mel_dev.shape[-1])
        content_frames = (len(audio) + A.N_SAMPLES) // A.HOP_LENGTH - A.N_FRAMES
        content_duration = content_frames * A.HOP_LENGTH / A.SAMPLE_RATE

        if tokenizer is None:
            tokenizer = self.get_tokenizer(language or "en", task)
        temps = ([temperature] if isinstance(temperature, (int, float))
                 else list(temperature))

        all_tokens: List[int] = []
        all_segments: List[dict] = []
        prompt_reset_since = 0
        detected_language = language
        if initial_prompt:
            all_tokens.extend(tokenizer.encode(" " + initial_prompt.strip()))
        time_precision = 0.02
        n_gen_tokens = 0
        last_speech_timestamp = 0.0
        hook = get_infer_hook(self)

        # clip_timestamps → (start, end) frame ranges: comma-separated
        # seconds, an odd count ends at the end of the audio, the last end
        # clamped to the content length
        if isinstance(clip_timestamps, str):
            clip_timestamps = [float(ts) for ts in
                               (clip_timestamps.split(",") if clip_timestamps else [])]
        seek_points = [round(ts * A.FRAMES_PER_SECOND) for ts in clip_timestamps]
        if not seek_points:
            seek_points.append(0)
        if len(seek_points) % 2 == 1:
            seek_points.append(content_frames)
        else:
            seek_points[-1] = min(content_frames, seek_points[-1])
        seek_clips = list(zip(seek_points[::2], seek_points[1::2]))
        seek = seek_clips[0][0]
        clip_idx = 0

        while clip_idx < len(seek_clips):
            clip_start, clip_end = seek_clips[clip_idx]
            seek = max(seek, clip_start)
            if seek >= clip_end:
                clip_idx += 1
                continue
            segment_size = min(A.N_FRAMES, content_frames - seek, clip_end - seek)
            window = self._window_slice(mel_flat, seek, segment_size)
            seg_duration = segment_size * A.HOP_LENGTH / A.SAMPLE_RATE
            time_offset = seek * A.HOP_LENGTH / A.SAMPLE_RATE
            window_end_time = (seek + A.N_FRAMES) * A.HOP_LENGTH / A.SAMPLE_RATE
            previous_seek = seek

            cross_kv = None
            if hook is None or detected_language is None:  # the batcher encodes itself
                _xa, cross_kv = self._encode(window[None])
            if detected_language is None:
                detected_language, _ = self.detect_language(cross_kv, tokenizer)
                tokenizer.language = detected_language
                if hasattr(tokenizer, "__dict__"):
                    tokenizer.__dict__.pop("sot_sequence", None)

            prev = all_tokens[prompt_reset_since:] if condition_on_previous_text else []
            sot_seq = (tokenizer.sot_sequence_including_notimestamps
                       if without_timestamps else tokenizer.sot_sequence)
            prompt = self._build_prompt(prev, sot_seq, tokenizer)

            result = None
            for t in temps:
                opts = self._fallback_options(decode_options, task, detected_language,
                                              t, without_timestamps)
                if hook is not None:
                    result = hook(window, prompt, opts, tokenizer)
                else:
                    result = decode_window(
                        self, cross_kv, tokenizer, prompt, opts,
                        n_ctx=self.dims.n_text_ctx, n_vocab=self.dims.n_vocab,
                        decoder_step=type(self)._decoder_step,
                        make_caches=self._make_caches,
                    )
                if _result_ok(result, compression_ratio_threshold, logprob_threshold):
                    break

            if _is_silent(result, no_speech_threshold, logprob_threshold):
                seek += segment_size
                continue

            tokens = result.tokens
            n_gen_tokens += len(tokens) + 1

            # timestamp segmentation
            ts = tokenizer.timestamp_begin
            consecutive = [i + 1 for i in range(len(tokens) - 1)
                           if tokens[i] >= ts and tokens[i + 1] >= ts]
            # a lone timestamp at the very end means "no speech after it":
            # keep the trailing segment and advance the full window
            single_timestamp_ending = len(tokens) >= 2 and tokens[-2] < ts <= tokens[-1]
            segments_here = []
            if consecutive:
                slices = list(consecutive)
                if single_timestamp_ending:
                    slices.append(len(tokens))
                last_slice = 0
                for cut in slices:
                    seg = tokens[last_slice:cut]
                    start_ts = (seg[0] - ts) * time_precision
                    end_ts = (seg[-1] - ts) * time_precision
                    segments_here.append(self._segment(
                        time_offset + start_ts, time_offset + end_ts, seg,
                        tokenizer, result))
                    last_slice = cut
                if single_timestamp_ending:
                    seek += segment_size
                else:
                    last_ts_tok = tokens[last_slice - 1] - ts
                    seek += max(1, round(last_ts_tok * time_precision * A.FRAMES_PER_SECOND))
            else:
                ts_tokens = [t for t in tokens if t >= ts]
                end_ts = seg_duration
                if ts_tokens and ts_tokens[-1] != ts:
                    end_ts = (ts_tokens[-1] - ts) * time_precision
                segments_here.append(self._segment(
                    time_offset, time_offset + end_ts, tokens, tokenizer, result))
                seek += segment_size

            if word_timestamps:
                from .timing import add_word_timestamps

                for s in segments_here:
                    s["seek"] = previous_seek
                # a second encoder pass over the window, as the JAX package
                add_word_timestamps(
                    segments=segments_here, model=self, tokenizer=tokenizer,
                    mel=window, num_frames=segment_size,
                    prepend_punctuations=prepend_punctuations,
                    append_punctuations=append_punctuations,
                    last_speech_timestamp=last_speech_timestamp,
                )
                # the final timestamp may overshoot the last word: re-seek to
                # the last attested word end
                if not single_timestamp_ending:
                    last_word_end = _get_end(segments_here)
                    if last_word_end is not None and last_word_end > time_offset:
                        seek = round(last_word_end * A.FRAMES_PER_SECOND)

                # skip silence around likely hallucinations: a window whose
                # words are anomalously short, long or improbable, with
                # silence around it, is dropped and the seek jumps the gap
                if hallucination_silence_threshold is not None:
                    threshold = hallucination_silence_threshold
                    if not single_timestamp_ending:
                        last_word_end = _get_end(segments_here)
                        if last_word_end is not None and last_word_end > time_offset:
                            remaining = window_end_time - last_word_end
                            if remaining > threshold:
                                seek = round(last_word_end * A.FRAMES_PER_SECOND)
                            else:
                                seek = previous_seek + segment_size

                    # a leading hallucination: decode again from past the gap
                    first_segment = _next_words_segment(segments_here)
                    if first_segment is not None and _is_segment_anomaly(first_segment):
                        gap = first_segment["start"] - time_offset
                        if gap > threshold:
                            seek = previous_seek + round(gap * A.FRAMES_PER_SECOND)
                            continue

                    # a hallucination surrounded by silence (or by more of them)
                    hal_last_end = last_speech_timestamp
                    for si, segment in enumerate(segments_here):
                        if not segment.get("words"):
                            continue
                        if _is_segment_anomaly(segment):
                            next_segment = _next_words_segment(segments_here[si + 1:])
                            if next_segment is not None:
                                hal_next_start = next_segment["words"][0]["start"]
                            else:
                                hal_next_start = time_offset + seg_duration
                            silence_before = (
                                segment["start"] - hal_last_end > threshold
                                or segment["start"] < threshold
                                or segment["start"] - time_offset < 2.0
                            )
                            silence_after = (
                                hal_next_start - segment["end"] > threshold
                                or _is_segment_anomaly(next_segment)
                                or window_end_time - segment["end"] < 2.0
                            )
                            if silence_before and silence_after:
                                seek = round(max(time_offset + 1, segment["start"])
                                             * A.FRAMES_PER_SECOND)
                                if content_duration - segment["end"] < threshold:
                                    seek = content_frames
                                segments_here[si:] = []
                                break
                        hal_last_end = segment["end"]

                last_word_end = _get_end(segments_here)
                if last_word_end is not None:
                    last_speech_timestamp = last_word_end

            # instantaneous or text-free segments carry no content: blank them
            for s in segments_here:
                if s["start"] == s["end"] or not s["text"].strip():
                    s["text"] = ""
                    s["tokens"] = []
                    s["words"] = []

            for s in segments_here:
                s["id"] = len(all_segments)
                all_segments.append(s)
                all_tokens.extend(s["tokens"])
                if on_segment is not None:
                    on_segment(s)
            if not condition_on_previous_text or result.temperature > 0.5:
                prompt_reset_since = len(all_tokens)

            if verbose:
                for s in segments_here:
                    print(f"[{s['start']:.2f} → {s['end']:.2f}] {s['text']}")

        wall = time.perf_counter() - start_t
        text = "".join(s["text"] for s in all_segments).strip()
        return STTOutput(
            text=text,
            segments=all_segments,
            language=detected_language,
            generation_tokens=n_gen_tokens,
            generation_tps=n_gen_tokens / max(wall, 1e-9),
            total_tps=n_gen_tokens / max(wall, 1e-9),
            duration=content_duration,
            extra={"wall_seconds": wall, "xrt": content_duration / max(wall, 1e-9)},
        )

    def make_batcher(self, **kwargs):
        """Serving batcher: fuses concurrent requests' seek-loop windows into
        one batched encode and decode (`serving.WhisperBatcher`)."""
        from ....serving import WhisperBatcher

        return WhisperBatcher(self, **kwargs)

    @torch.inference_mode()
    def generate_chunked(
        self,
        audio,
        *,
        language: Optional[str] = None,
        task: str = "transcribe",
        temperature: Union[float, Sequence[float]] = 0.0,
        compression_ratio_threshold: Optional[float] = 2.4,
        logprob_threshold: Optional[float] = -1.0,
        no_speech_threshold: Optional[float] = 0.6,
        condition_on_previous_text: bool = False,
        initial_prompt: Optional[str] = None,
        without_timestamps: bool = False,
        word_timestamps: bool = False,
        prepend_punctuations: str = "\"'“¿([{-",
        append_punctuations: str = "\"'.。,，!！?？:：”)]}、",
        tokenizer=None,
        max_batch: int = 8,
        max_sweeps: int = 4,
        strict_conditioning: bool = True,
        **decode_options,
    ) -> STTOutput:
        """Batch-parallel long-form transcription: every 30 s window is
        encoded in one batch and decoded in one batched loop.

        A temperature sequence enables the quality fallback: the group
        re-decodes at the next temperature while each window keeps its
        first result that passes the compression-ratio / logprob
        thresholds. Windows judged silent emit no segment.

        ``condition_on_previous_text=True`` keeps the seek loop's rolling
        previous-text prompt as a parallel fixpoint: sweep 1 decodes every
        window unconditioned, each later sweep rebuilds the prompts from the
        current estimates and re-decodes only windows whose prompt changed.
        Window k's prompt depends only on windows < k, so the result is the
        sequential one; after ``max_sweeps`` sweeps a still-unstable tail is
        finished window by window.

        ``word_timestamps=True`` aligns each window's words by DTW over its
        cross-attention: unconditioned, on the slice of the batch's encoder
        K/V; conditioned, after one more encoder pass per group."""
        start_t = time.perf_counter()
        unknown = set(decode_options) - set(DecodingOptions.__dataclass_fields__)
        if unknown:
            raise TypeError(f"unknown decode options: {sorted(unknown)}")
        self._check_fp16_option(decode_options)
        audio = _waveform(audio)

        mel_dev, _ = self._mel_chunks_device(audio)
        n_audio_frames = (len(audio) + A.N_SAMPLES) // A.HOP_LENGTH
        content_frames = n_audio_frames - A.N_FRAMES
        content_duration = content_frames * A.HOP_LENGTH / A.SAMPLE_RATE

        if tokenizer is None:
            tokenizer = self.get_tokenizer(language or "en", task)

        # windows at fixed 30 s stride == mel chunk rows
        starts = list(range(0, max(content_frames, 1), A.N_FRAMES))
        n_windows = len(starts)

        if language is None:
            _xa, ckv = self._encode(mel_dev[:1])
            language, _ = self.detect_language(ckv, tokenizer)
            tokenizer.language = language
            if hasattr(tokenizer, "__dict__"):
                tokenizer.__dict__.pop("sot_sequence", None)

        sot_seq = list(
            tokenizer.sot_sequence_including_notimestamps
            if without_timestamps
            else tokenizer.sot_sequence
        )
        # initial_prompt biases every window (windows are independent here)
        prompt_row = sot_seq
        if initial_prompt:
            prompt_row = self._build_prompt(
                tokenizer.encode(" " + initial_prompt.strip()), sot_seq, tokenizer)

        temps = (
            [temperature] if isinstance(temperature, (int, float))
            else list(temperature)
        )

        all_segments: List[dict] = []
        n_gen = 0
        time_precision = 0.02
        n_sweeps = 0  # batched conditioning sweeps
        n_tail = 0  # windows re-decoded by the strict sequential finish

        def is_silent(res) -> bool:
            # silent windows emit no segment (and no rolling context)
            return _is_silent(res, no_speech_threshold, logprob_threshold)

        def decode_idxs(idxs, rows):
            """Encode + temperature-fallback decode of the given windows as
            one batch; rows must share a length."""
            if list(idxs) == list(range(idxs[0], idxs[0] + len(idxs))):
                group = mel_dev[idxs[0]:idxs[0] + len(idxs)]
            else:
                group = mel_dev[torch.tensor(idxs, device=mel_dev.device)]
            _xa, cross_kv = self._encode(group)
            got: List = [None] * len(idxs)
            for t in temps:
                batch = decode_window_batch(
                    self, cross_kv, tokenizer, rows,
                    self._fallback_options(decode_options, task, language, t,
                                           without_timestamps),
                    n_ctx=self.dims.n_text_ctx, n_vocab=self.dims.n_vocab,
                    decoder_step=type(self)._decoder_step,
                    make_caches=self._make_caches,
                )
                for j, res in enumerate(batch):
                    if got[j] is None and (
                            _result_ok(res, compression_ratio_threshold, logprob_threshold)
                            or t == temps[-1]):
                        got[j] = res
                if all(r is not None for r in got):
                    break
            return got, cross_kv

        def window_kv(cross_kv, j):
            return [(k[j:j + 1], v[j:j + 1]) for k, v in cross_kv]

        def assemble(seek, res, win_kv) -> None:
            """Silence skip + segment build for one window, and its word
            timing on `win_kv`, the window's encoder K/V, if given."""
            nonlocal n_gen
            if is_silent(res):
                return
            time_offset = seek * A.HOP_LENGTH / A.SAMPLE_RATE
            seg_duration = min(
                (content_frames - seek) * A.HOP_LENGTH / A.SAMPLE_RATE, 30.0)
            tokens = res.tokens
            n_gen += len(tokens) + 1
            ts = tokenizer.timestamp_begin
            ts_tokens = [t for t in tokens if t >= ts]
            end_ts = seg_duration
            if ts_tokens and ts_tokens[-1] != ts:
                end_ts = min((ts_tokens[-1] - ts) * time_precision, seg_duration)
            seg = self._segment(time_offset, time_offset + end_ts, tokens, tokenizer, res)
            seg["id"] = len(all_segments)
            seg["seek"] = seek
            if win_kv is not None:
                from .timing import add_word_timestamps

                add_word_timestamps(
                    segments=[seg], model=self, tokenizer=tokenizer, mel=None,
                    num_frames=min(content_frames - seek, A.N_FRAMES),
                    prepend_punctuations=prepend_punctuations,
                    append_punctuations=append_punctuations,
                    cross_kv=win_kv,
                )
            all_segments.append(seg)

        if condition_on_previous_text:
            init_tokens = (
                tokenizer.encode(" " + initial_prompt.strip())
                if initial_prompt else []
            )

            def desired_row(k, cur) -> List[int]:
                """Prompt row window k would receive in the sequential seek
                loop, given current estimates `cur` of earlier windows."""
                toks = list(init_tokens)
                for j in range(k):
                    r = cur[j]
                    if r is None or is_silent(r):
                        continue
                    toks.extend(r.tokens)
                    if r.temperature > 0.5:
                        toks = []  # high-temperature fallback resets context
                return (self._build_prompt(toks, sot_seq, tokenizer)
                        if toks else list(sot_seq))

            results: List = [None] * n_windows
            used: List = [None] * n_windows
            while True:
                desired = [desired_row(k, results) for k in range(n_windows)]
                todo = [k for k in range(n_windows) if used[k] != desired[k]]
                if not todo:
                    break
                if n_sweeps >= max_sweeps and not strict_conditioning:
                    break  # approximation mode: accept the last sweep
                if n_sweeps >= max_sweeps:
                    # exact sequential finish for a still-unstable tail
                    n_tail += len(todo)
                    for k in todo:
                        row = desired_row(k, results)
                        results[k], used[k] = decode_idxs([k], [row])[0][0], row
                    continue
                n_sweeps += 1
                by_len: dict = {}
                for k in todo:
                    by_len.setdefault(len(desired[k]), []).append(k)
                for _L, idxs in sorted(by_len.items()):
                    for g0 in range(0, len(idxs), max_batch):
                        sub = idxs[g0:g0 + max_batch]
                        got, _ = decode_idxs(sub, [desired[k] for k in sub])
                        for k, r in zip(sub, got):
                            results[k], used[k] = r, desired[k]

            for i0 in range(0, n_windows, max_batch):
                idxs = list(range(i0, min(i0 + max_batch, n_windows)))
                win_kvs = [None] * len(idxs)
                if word_timestamps:
                    # one more encoder pass per group for the DTW K/V
                    _xa, ckv = self._encode(mel_dev[i0:i0 + len(idxs)])
                    win_kvs = [window_kv(ckv, j) for j in range(len(idxs))]
                for j, k in enumerate(idxs):
                    assemble(starts[k], results[k], win_kvs[j])
        else:
            for i0 in range(0, n_windows, max_batch):
                idxs = list(range(i0, min(i0 + max_batch, n_windows)))
                got, cross_kv = decode_idxs(idxs, [prompt_row] * len(idxs))
                for j, k in enumerate(idxs):
                    assemble(starts[k], got[j],
                             window_kv(cross_kv, j) if word_timestamps else None)

        wall = time.perf_counter() - start_t
        text = "".join(s["text"] for s in all_segments).strip()
        return STTOutput(
            text=text,
            segments=all_segments,
            language=language,
            generation_tokens=n_gen,
            generation_tps=n_gen / max(wall, 1e-9),
            total_tps=n_gen / max(wall, 1e-9),
            duration=content_duration,
            extra={"wall_seconds": wall,
                   "xrt": content_duration / max(wall, 1e-9),
                   "mode": ("chunked+conditioned"
                            if condition_on_previous_text else "chunked"),
                   **({"sweeps": n_sweeps, "tail_windows": n_tail}
                      if condition_on_previous_text else {})},
        )

    def generate_streaming(
        self,
        audio,
        *,
        chunk_duration: float = 1.0,
        language: Optional[str] = None,
        task: str = "transcribe",
        frame_threshold: int = 25,
        tokenizer=None,
    ):
        """Streaming transcription with AlignAtt: yields a `StreamingResult`
        per `chunk_duration` of audio that adds text, and one for the last
        chunk. Each chunk encodes the audio heard so far (the last 30 s) as
        one window. Without a language or a tokenizer, the language is
        detected on the first 30 s first."""
        from .streaming import StreamingConfig, StreamingDecoder

        audio = _waveform(audio)
        if language is None and tokenizer is None:
            probe_tok = self.get_tokenizer("en", task)
            first = np.zeros(A.N_SAMPLES, np.float32)
            n0 = min(len(audio), A.N_SAMPLES)
            first[:n0] = audio[:n0]
            _, cross_kv = self._encode(self._mel_chunk(first)[None])
            language, _ = self.detect_language(cross_kv, probe_tok)
        language = language or "en"

        decoder = StreamingDecoder(
            self, StreamingConfig(frame_threshold=frame_threshold),
            language=language, task=task, tokenizer=tokenizer,
        )
        chunk_samples = int(chunk_duration * A.SAMPLE_RATE)
        total = len(audio)
        duration = total / A.SAMPLE_RATE
        for start in range(0, total, chunk_samples):
            end = min(start + chunk_samples, total)
            chunk = np.zeros(chunk_samples, np.float32)
            chunk[: end - start] = audio[start:end]
            mel = self._mel_chunk(chunk)[: (end - start) // A.HOP_LENGTH]
            is_last = end >= total
            result = decoder.decode_chunk(mel, is_last=is_last)
            result.progress = end / total
            result.audio_position = end / A.SAMPLE_RATE
            result.audio_duration = duration
            result.language = language
            if result.text.strip() or is_last:
                yield result
            if is_last:
                break

    def _build_prompt(self, prev_tokens, sot_seq, tokenizer):
        """Previous-context prompt with bucketed length (left-trim + left-pad
        with sot_prev so positions stay exact)."""
        sot_seq = list(sot_seq)
        if not prev_tokens:
            return sot_seq
        max_prev = self.dims.n_text_ctx // 2 - 1 - len(sot_seq) - 1
        prev = list(prev_tokens)[-max_prev:]
        total = 1 + len(prev) + len(sot_seq)
        bucket = next((b for b in self.PROMPT_BUCKETS if total <= b), total)
        pad = bucket - total
        return [tokenizer.sot_prev] * (1 + pad) + prev + sot_seq

    @staticmethod
    def _segment(start, end, tokens, tokenizer, result: DecodingResult) -> dict:
        text_tokens = [t for t in tokens if t < tokenizer.timestamp_begin]
        return {
            "seek": 0,
            "start": float(start),
            "end": float(end),
            "text": tokenizer.decode(text_tokens),
            "tokens": list(tokens),
            "temperature": result.temperature,
            "avg_logprob": result.avg_logprob,
            "compression_ratio": result.compression_ratio,
            "no_speech_prob": result.no_speech_prob,
        }
