"""S3Tokenizer, the supervised speech tokenizer in front of CosyVoice and
Chatterbox (counterpart of
`mlx_audio_tpu/codec/models/s3tokenizer/s3tokenizer.py`).

* v1 (`speech_tokenizer_v1` / `_v1_25hz`): a Whisper-style encoder with
  sinusoidal positions and an L2-normalised Euclidean codebook of 4096;
* v2 (`speech_tokenizer_v2_25hz`): FSMN attention (a depthwise-convolution
  memory on the values) with rotate-half rope, and an FSQ quantizer of
  3^8 = 6561 codes;
* v3: v2 with 12 encoder layers.

Every segment is padded to a 30 s window (3000 mel frames) and encoded
under its length mask, as in the JAX package; audio past 30 s is cut into
30 s windows with 4 s of overlap, all encoded in one batch, and merged on
the host (`merge_tokenized_segments`). The convolutions' GELU is the tanh
approximation (`jax.nn.gelu`'s default), the blocks' MLP GELU exact
(`nn.GELU()`), as each is written there.

`from_pretrained` reads a local directory; a hub id raises, as the port's
`get_model_path` does.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ....device import resolve_device
from ....dsp import hanning, mel_filters, stft
from ....nn import Conv1d, LayerNorm, Linear
from ....nn.module import init_weights
from ....nn.sanitize import orient_weights_to_model
from ....ops.attention import scaled_dot_product_attention as sdpa

__all__ = ["S3_SR", "S3_HOP", "S3_TOKEN_HOP", "S3_TOKEN_RATE", "SPEECH_VOCAB_SIZE",
           "S3_V1_VOCAB_SIZE", "ModelConfig", "S3Tokenizer", "S3TokenizerV2", "S3TokenizerV3",
           "log_mel_spectrogram", "make_non_pad_mask", "merge_tokenized_segments", "padding"]

S3_SR = 16_000
S3_HOP = 160  # 100 mel frames a second
S3_TOKEN_HOP = 640  # 25 tokens a second
S3_TOKEN_RATE = 25
SPEECH_VOCAB_SIZE = 6561  # 3^8 (v2, v3)
S3_V1_VOCAB_SIZE = 4096

MAX_FRAMES = 3000  # the 30 s window
OVERLAP_SECONDS = 4


@dataclass
class ModelConfig:
    n_mels: int = 128
    n_audio_ctx: int = 1500
    n_audio_state: int = 1280
    n_audio_head: int = 20
    n_audio_layer: int = 6
    n_codebook_size: int = 3 ** 8


def log_mel_spectrogram(audio, sample_rate: int = S3_SR, n_mels: int = 128, n_fft: int = 400,
                        hop_length: int = S3_HOP, padding: int = 0, device=None) -> torch.Tensor:
    """Whisper-style log-mel with slaney filters → (n_mels, T) float32."""
    x = torch.as_tensor(np.asarray(audio, np.float32), device=device)
    if padding > 0:
        x = F.pad(x, (0, padding))
    window = hanning(n_fft + 1, device=x.device)[:-1]
    mag = stft(x, n_fft=n_fft, hop_length=hop_length, win_length=n_fft,
               window=window).abs() ** 2  # (frames, freq)
    filters = mel_filters(sample_rate, n_fft, n_mels, norm="slaney", mel_scale="slaney",
                          device=x.device)
    log_spec = torch.log10((filters @ mag.T).clamp(min=1e-10))
    log_spec = torch.maximum(log_spec, log_spec.max() - 8.0)
    return (log_spec + 4.0) / 4.0


def make_non_pad_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """(B,) lengths → (B, max_len) bool, True inside the valid region."""
    return torch.arange(max_len, device=lengths.device)[None, :] < lengths[:, None]


def merge_tokenized_segments(segments: List[List[int]], overlap: int,
                             token_rate: int) -> List[int]:
    """Drop half the overlapped tokens on each side of every interior
    boundary."""
    merged: List[int] = []
    half = (overlap // 2) * token_rate
    for i, toks in enumerate(segments):
        left = 0 if i == 0 else half
        right = len(toks) if i == len(segments) - 1 else len(toks) - half
        merged.extend(toks[left:right])
    return merged


def _sinusoids(length: int, channels: int, max_timescale: float = 10000.0) -> np.ndarray:
    # float32 arithmetic throughout, as the JAX package's
    inv = np.exp(np.float32(-math.log(max_timescale) / (channels // 2 - 1))
                 * np.arange(channels // 2, dtype=np.float32))
    angles = np.arange(length, dtype=np.float32)[:, None] * inv[None, :]
    return np.concatenate([np.sin(angles), np.cos(angles)], axis=1).astype(np.float32)


def _s3_rope(dim: int, end: int, theta: float = 10000.0) -> Tuple[np.ndarray, np.ndarray]:
    """Rotate-half rope tables in the [cos|cos] / [sin|sin] layout."""
    freqs = (1.0 / theta ** (np.arange(0, dim, 2, dtype=np.float32) / dim)).astype(np.float32)
    angles = np.outer(np.arange(end, dtype=np.float32), freqs).astype(np.float32)
    cos = np.concatenate([np.cos(angles), np.cos(angles)], axis=-1)
    sin = np.concatenate([np.sin(angles), np.sin(angles)], axis=-1)
    return cos, sin


def _apply_s3_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (B, T, H, D); the rotation is [-right, left]."""
    half = x.shape[-1] // 2
    rotated = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * cos[None, :, None, :] + rotated * sin[None, :, None, :]


class FSMNAttention(nn.Module):
    """Self-attention plus a depthwise-convolution memory on the values."""

    def __init__(self, n_state: int, n_head: int, kernel_size: int = 31, device=None):
        super().__init__()
        self.n_head = n_head
        self.query = Linear(n_state, n_state, device=device)
        self.key = Linear(n_state, n_state, bias=False, device=device)
        self.value = Linear(n_state, n_state, device=device)
        self.out = Linear(n_state, n_state, device=device)
        self.fsmn_block = Conv1d(n_state, n_state, kernel_size, groups=n_state, bias=False,
                                 device=device)
        self.left_padding = (kernel_size - 1) // 2
        self.right_padding = kernel_size - 1 - self.left_padding

    def _fsmn(self, v: torch.Tensor, mask_pad: torch.Tensor) -> torch.Tensor:
        v = v * mask_pad
        x = F.pad(v, (0, 0, self.left_padding, self.right_padding))
        return (self.fsmn_block(x) + v) * mask_pad

    def forward(self, x, bias_mask, mask_pad, rope):
        B, T, D = x.shape
        q = self.query(x).reshape(B, T, self.n_head, -1)
        k = self.key(x).reshape(B, T, self.n_head, -1)
        v = self.value(x).reshape(B, T, self.n_head, -1)
        if rope is not None:
            cos, sin = rope
            q = _apply_s3_rope(q, cos[:T], sin[:T])
            k = _apply_s3_rope(k, cos[:T], sin[:T])
        fsm = self._fsmn(v.reshape(B, T, D), mask_pad)
        o = sdpa(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), mask=bias_mask)
        return self.out(o.transpose(1, 2).reshape(B, T, D)) + fsm


class PlainAttention(nn.Module):
    """v1's attention: no memory, no rope."""

    def __init__(self, n_state: int, n_head: int, device=None):
        super().__init__()
        self.n_head = n_head
        self.query = Linear(n_state, n_state, device=device)
        self.key = Linear(n_state, n_state, bias=False, device=device)
        self.value = Linear(n_state, n_state, device=device)
        self.out = Linear(n_state, n_state, device=device)

    def forward(self, x, bias_mask, mask_pad=None, rope=None):
        B, T, D = x.shape
        q = self.query(x).reshape(B, T, self.n_head, -1).transpose(1, 2)
        k = self.key(x).reshape(B, T, self.n_head, -1).transpose(1, 2)
        v = self.value(x).reshape(B, T, self.n_head, -1).transpose(1, 2)
        o = sdpa(q, k, v, mask=bias_mask)
        return self.out(o.transpose(1, 2).reshape(B, T, D))


class _MLP(nn.Module):
    """The JAX package's `Sequential(Linear, GELU(), Linear)` under its
    `layers.N` names; the GELU is exact."""

    def __init__(self, d: int, hidden: int, device=None):
        super().__init__()
        self.layers = nn.ModuleList([Linear(d, hidden, device=device), nn.GELU(),
                                     Linear(hidden, d, device=device)])

    def forward(self, x):
        for layer in self.layers:
            x = layer(x)
        return x


class ResidualAttentionBlock(nn.Module):
    def __init__(self, n_state: int, n_head: int, fsmn: bool = True, device=None):
        super().__init__()
        self.attn = (FSMNAttention(n_state, n_head, device=device) if fsmn
                     else PlainAttention(n_state, n_head, device=device))
        self.attn_ln = LayerNorm(n_state, eps=1e-5, device=device)
        self.mlp = _MLP(n_state, n_state * 4, device=device)
        self.mlp_ln = LayerNorm(n_state, eps=1e-5, device=device)

    def forward(self, x, bias_mask, mask_pad, rope):
        x = x + self.attn(self.attn_ln(x), bias_mask, mask_pad, rope)
        return x + self.mlp(self.mlp_ln(x))


class AudioEncoder(nn.Module):
    """Two strided convolutions (4x or 2x down in all), then the
    transformer stack."""

    def __init__(self, config: ModelConfig, stride: int, version: int, device=None):
        super().__init__()
        self.stride = stride
        self.version = version
        self.conv1 = Conv1d(config.n_mels, config.n_audio_state, 3, stride=stride, padding=1,
                            device=device)
        self.conv2 = Conv1d(config.n_audio_state, config.n_audio_state, 3, stride=2,
                            padding=1, device=device)
        self.blocks = nn.ModuleList(
            ResidualAttentionBlock(config.n_audio_state, config.n_audio_head,
                                   fsmn=version >= 2, device=device)
            for _ in range(config.n_audio_layer))
        if version == 1:
            pe = _sinusoids(config.n_audio_ctx, config.n_audio_state)
            self.register_buffer("positional_embedding", torch.from_numpy(pe).to(device),
                                 persistent=False)
        else:
            cos, sin = _s3_rope(config.n_audio_state // config.n_audio_head, 2048)
            self.register_buffer("rope_cos", torch.from_numpy(cos).to(device), persistent=False)
            self.register_buffer("rope_sin", torch.from_numpy(sin).to(device), persistent=False)

    def forward(self, mel: torch.Tensor, mel_len: torch.Tensor):
        """mel (B, n_mels, T) → hidden (B, T', D), lengths (B,)."""
        T = mel.shape[2]
        x = mel.transpose(1, 2)
        x = F.gelu(self.conv1(x * make_non_pad_mask(mel_len, T)[..., None]),
                   approximate="tanh")
        x_len = (mel_len - 1) // self.stride + 1
        x = F.gelu(self.conv2(x * make_non_pad_mask(x_len, x.shape[1])[..., None]),
                   approximate="tanh")
        x_len = (x_len - 1) // 2 + 1

        pad = make_non_pad_mask(x_len, x.shape[1])
        mask_pad = pad[..., None].to(x.dtype)
        zero = torch.zeros((), device=x.device)
        bias_mask = torch.where(pad, zero, -1e9)[:, None, None, :]
        if self.version == 1:
            x = x + self.positional_embedding[: x.shape[1]].to(x.dtype)
            rope = None
        else:
            rope = (self.rope_cos.to(x.dtype), self.rope_sin.to(x.dtype))
        for block in self.blocks:
            x = block(x, bias_mask, mask_pad, rope)
        return x, x_len


class FSQCodebook(nn.Module):
    """Project to 8 dims, tanh, round to {-1, 0, 1}, base-3 code. Rounding
    is half to even in both packages."""

    def __init__(self, dim: int, level: int = 3, device=None):
        super().__init__()
        self.project_down = Linear(dim, 8, device=device)
        self.level = level

    def project(self, x: torch.Tensor) -> torch.Tensor:
        """The float32 pre-round value tanh(h)·0.999 (B, T, 8)."""
        return torch.tanh(self.project_down(x).float()) * 0.9990000128746033

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        h = torch.round(self.project(x)) + 1.0
        powers = float(self.level) ** torch.arange(8, dtype=torch.float32, device=x.device)
        return (h * powers).sum(-1).to(torch.int32)


class EuclideanCodebook(nn.Module):
    """v1: the nearest of codebook_size L2-normalised codes."""

    def __init__(self, dim: int, codebook_size: int, device=None):
        super().__init__()
        self.embed = nn.Parameter(torch.empty(codebook_size, dim, device=device))

    def reset_parameters(self, generator=None) -> None:
        self.embed.data.zero_()

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        x = x / torch.sqrt((x ** 2).sum(-1, keepdim=True) + 1e-8)
        x32 = x.float()
        e = self.embed.float()
        dist = (2.0 * x32 @ e.T - (x32 ** 2).sum(-1, keepdim=True)
                - (e ** 2).sum(-1)[None, None, :])
        return torch.argmax(dist, dim=-1).to(torch.int32)


class S3TokenizerV2(nn.Module):
    """The v2/v3 tokenizer (25 Hz FSQ) on an explicit device (None: the
    card), the weights drawn from `seed`."""

    version = 2
    DEFAULT_REPO = "mlx-community/S3TokenizerV2"

    def __init__(self, name: str = "speech_tokenizer_v2_25hz",
                 config: Optional[ModelConfig] = None, device=None, seed: int = 0):
        super().__init__()
        config = config or ModelConfig()
        if self.version == 3 and config.n_audio_layer == 6:
            config.n_audio_layer = 12
        self.config = config
        self.name = name
        self.device = resolve_device(device)
        self._build(config)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        init_weights(self, gen)

    def _build(self, config: ModelConfig) -> None:
        self.encoder = AudioEncoder(config, stride=2, version=max(self.version, 2),
                                    device=self.device)
        self.fsq_codebook = FSQCodebook(config.n_audio_state, device=self.device)

    def _quantize_hidden(self, hidden: torch.Tensor) -> torch.Tensor:
        return self.fsq_codebook.encode(hidden)

    def encode_windows(self, mel: torch.Tensor, mel_len: torch.Tensor):
        """A batch of windows (B, n_mels, T) with lengths (B,) → codes (B, T'),
        code lengths (B,), on the model's device."""
        hidden, code_len = self.encoder(mel, mel_len)
        return self._quantize_hidden(hidden), code_len

    @torch.inference_mode()
    def quantize(self, mel, mel_len) -> Tuple[np.ndarray, np.ndarray]:
        """mel (B, n_mels, T), mel_len (B,) → codes (B, T') int64, code_len
        (B,) on the host. Every segment is padded to MAX_FRAMES; a mel past
        it is cut into windows with OVERLAP_SECONDS of overlap, and the
        windows' codes are merged."""
        mel = np.asarray(mel.cpu() if isinstance(mel, torch.Tensor) else mel, np.float32)
        mel_len = np.asarray(mel_len.cpu() if isinstance(mel_len, torch.Tensor) else mel_len,
                             np.int64)
        B = mel.shape[0]
        stride_frames = MAX_FRAMES - OVERLAP_SECONDS * 100
        segments, seg_lens, owners = [], [], []
        for b in range(B):
            L = int(mel_len[b])
            if L <= MAX_FRAMES:
                starts = [0]
            else:
                starts = list(range(0, L, stride_frames))
                # a trailing window the one before covers whole is dropped
                if len(starts) > 1 and starts[-1] + OVERLAP_SECONDS * 100 >= L:
                    starts.pop()
            for s in starts:
                e = min(s + MAX_FRAMES, L)
                seg = mel[b, :, s:e]
                if seg.shape[1] < MAX_FRAMES:
                    seg = np.pad(seg, ((0, 0), (0, MAX_FRAMES - seg.shape[1])))
                segments.append(seg)
                seg_lens.append(e - s)
                owners.append(b)
        codes, code_len = self.encode_windows(
            torch.as_tensor(np.stack(segments), device=self.device),
            torch.as_tensor(np.asarray(seg_lens, np.int64), device=self.device))
        codes = codes.cpu().numpy()
        code_len = code_len.cpu().numpy()
        per_owner: List[List[List[int]]] = [[] for _ in range(B)]
        for i, b in enumerate(owners):
            per_owner[b].append(codes[i, : int(code_len[i])].tolist())
        merged = [p[0] if len(p) == 1
                  else merge_tokenized_segments(p, OVERLAP_SECONDS, S3_TOKEN_RATE)
                  for p in per_owner]
        out_len = np.asarray([len(m) for m in merged], np.int64)
        out = np.zeros((B, int(out_len.max())), np.int64)
        for b in range(B):
            out[b, : out_len[b]] = merged[b]
        return out, out_len

    def forward(self, mel, mel_len):
        return self.quantize(mel, mel_len)

    # ---- loading ----

    _DROP = ("freqs_cis", "_mel_filters")
    _CODEBOOK = "fsq_codebook."

    def sanitize(self, weights: dict) -> dict:
        """The JAX package's key map: the quantizer's codebook names folded
        into one, torch's `mlp.N` into `mlp.layers.N`, constants dropped;
        convolutions oriented to the JAX layout."""
        out = {}
        for key, value in weights.items():
            if any(d in key for d in self._DROP) or key.startswith("onnx::"):
                continue
            k = key
            for old in ("quantizer._codebook.", "quantizer.codebook.",
                        "quantizer.fsq_codebook."):
                k = k.replace(old, self._CODEBOOK)
            out[re.sub(r"\.mlp\.(\d+)\.", r".mlp.layers.\1.", k)] = value
        return orient_weights_to_model(self, out)

    @classmethod
    def from_pretrained(cls, name: Optional[str] = None, repo_id: Optional[str] = None,
                        device=None):
        """The tokenizer from a local directory of weights (`repo_id`); a
        hub id raises, as the port downloads nothing. A `config.json` there
        with ModelConfig's fields sets the widths (the published ones
        otherwise)."""
        from ....nn.module import load_weights
        from ....utils import get_model_path, load_weight_files

        path = get_model_path(repo_id or cls.DEFAULT_REPO)
        config = None
        if (path / "config.json").is_file():
            import json

            d = json.loads((path / "config.json").read_text())
            config = ModelConfig(**{k: v for k, v in d.items()
                                    if k in ModelConfig.__dataclass_fields__})
        model = cls(name, config, device=device) if name else cls(config=config, device=device)
        load_weights(model, model.sanitize(load_weight_files(path)), strict=False)
        return model.eval()


class S3TokenizerV3(S3TokenizerV2):
    """v3: 12 layers."""

    version = 3
    DEFAULT_REPO = "mlx-community/S3TokenizerV3"

    def __init__(self, name: str = "speech_tokenizer_v3", config=None, device=None,
                 seed: int = 0):
        super().__init__(name, config or ModelConfig(n_audio_layer=12), device, seed)


class S3Tokenizer(S3TokenizerV2):
    """v1: the Euclidean codebook and sinusoidal positions."""

    version = 1
    _DROP = ("positional_embedding",)
    _CODEBOOK = "euclid_codebook."

    def __init__(self, name: str = "speech_tokenizer_v1_25hz",
                 config: Optional[ModelConfig] = None, device=None, seed: int = 0):
        super().__init__(name, config or ModelConfig(n_codebook_size=S3_V1_VOCAB_SIZE), device,
                         seed)

    def _build(self, config: ModelConfig) -> None:
        stride = 2 if self.name == "speech_tokenizer_v1_25hz" else 1
        self.encoder = AudioEncoder(config, stride=stride, version=1, device=self.device)
        self.euclid_codebook = EuclideanCodebook(config.n_audio_state, config.n_codebook_size,
                                                 device=self.device)

    def _quantize_hidden(self, hidden: torch.Tensor) -> torch.Tensor:
        return self.euclid_codebook.encode(hidden)


def padding(mels: List[np.ndarray]) -> Tuple[np.ndarray, np.ndarray]:
    """Pad a list of (n_mels, T) mels into a batch → (mels (B, n_mels, T),
    lengths (B,))."""
    mels = [np.asarray(m.cpu() if isinstance(m, torch.Tensor) else m, np.float32) for m in mels]
    lens = np.asarray([m.shape[-1] for m in mels], np.int64)
    out = np.zeros((len(mels), mels[0].shape[0], int(lens.max())), np.float32)
    for i, m in enumerate(mels):
        out[i, :, : m.shape[-1]] = m
    return out, lens
