"""IndexTTS: a conformer- and perceiver-conditioned GPT-2 mel-code LM whose
latents drive a speaker-conditioned BigVGAN (counterpart of
`mlx_audio_tpu/tts/models/indextts/indextts.py`).

The reference clip's log-mel feeds both the conditioning encoder
(`Conformer` → `PerceiverResampler`, 32 latents) and BigVGAN's ECAPA-TDNN
speaker encoder. The prompt is [conditioning ‖ text + text positions];
`_indextts_decode` is an eager loop on the card that records each step's
final-norm latent, samples the next mel code, and feeds its embedding plus
its step's position row back. It reads the done flag (the stop code drawn)
every `POLL_STEPS` steps and the latents once at its end, so the latents
and their count are the JAX loop's (the stop step's latent kept, n + 1).
The GPT's `wpe` is one row of zeros: positions come from the text and mel
position tables, and every table is read through its embedding's call,
so ids past a table clamp as the JAX gather does and an int4 model reads
its packed tables correctly.

Sampled codes are drawn from a `torch.Generator` seeded by the request
(Gumbel-max over the top-k survivors at max(temperature, 1e-5)), so they
match the JAX package's in distribution only; at top_k = 1 they are its
codes. The text goes through the model's tokenizer (`set_runtime`, else
`tokenizer.model` through `sentencepiece` where that package is
installed) after the port's copy of `normalize.py`.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Any, Generator, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ....codec.models.bigvgan.bigvgan import BigVGAN
from ....codec.models.base import Conv1d as ConvCF
from ....device import resolve_device
from ....dsp import mel_filters, stft
from ....lm.generate import POLL_STEPS
from ....lm.gpt2 import GPT2Config, GPT2Model
from ....nn import BatchNorm, Conv1d, Conv2d, Embedding, LayerNorm, Linear, RMSNorm
from ....nn.module import init_weights
from ..base import GenerationResult, format_duration

__all__ = ["Model", "ModelArgs", "GPTConfig", "ConformerArgs", "BigVGANConditioning",
           "ECPATDNN", "PerceiverResampler", "log_mel_spectrogram"]


def log_mel_spectrogram(audio, sample_rate: int = 24_000, n_mels: int = 100,
                        n_fft: int = 1024, hop_length: int = 256, device=None):
    """(samples,) → (1, T, n_mels) float32 log-mel (htk scale, no norm)."""
    x = torch.as_tensor(np.asarray(audio, np.float32), device=device)
    mag = stft(x, n_fft=n_fft, hop_length=hop_length, win_length=n_fft, window="hann").abs()
    filters = mel_filters(sample_rate, n_fft, n_mels, norm=None, mel_scale="htk",
                          device=x.device)
    return torch.log((mag @ filters.T).clamp(min=1e-5))[None]


# ---------------------------------------------------------------------------
# ECAPA-TDNN speaker encoder (channels-last)
# ---------------------------------------------------------------------------
class TDNN(nn.Module):
    """Reflect-padded convolution, ReLU, BatchNorm."""

    def __init__(self, in_channels, out_channels, kernel_size, dilation=1, groups=1,
                 bias=True, device=None):
        super().__init__()
        self.conv = Conv1d(in_channels, out_channels, kernel_size, dilation=dilation,
                           groups=groups, bias=bias, device=device)
        self.norm = BatchNorm(out_channels, device=device)
        self.padding = ((kernel_size - 1) * dilation) // 2

    def forward(self, x):
        p = self.padding
        if p > 0:
            x = torch.cat([x[:, 1: p + 1].flip(1), x, x[:, -(p + 1): -1].flip(1)], dim=1)
        return self.norm(torch.relu(self.conv(x)))


class Res2Net(nn.Module):
    def __init__(self, in_channels, out_channels, kernel_size, scale, dilation=1,
                 device=None):
        super().__init__()
        self.scale = scale
        self.blocks = nn.ModuleList(
            TDNN(in_channels // scale, out_channels // scale, kernel_size, dilation,
                 device=device) for _ in range(scale - 1))

    def forward(self, x):
        segs = x.chunk(self.scale, dim=-1)
        y = [segs[0]]
        for i in range(1, len(segs)):
            y.append(self.blocks[i - 1](segs[i] + y[-1] if i > 1 else segs[i]))
        return torch.cat(y, dim=-1)


class SE(nn.Module):
    def __init__(self, in_channels, se_channels, out_channels, device=None):
        super().__init__()
        self.conv1 = Conv1d(in_channels, se_channels, 1, device=device)
        self.conv2 = Conv1d(se_channels, out_channels, 1, device=device)

    def forward(self, x):
        s = x.mean(dim=1, keepdim=True)
        return torch.sigmoid(self.conv2(torch.relu(self.conv1(s)))) * x


class SeRes2Net(nn.Module):
    def __init__(self, in_channels, out_channels, scale, attention_channels, kernel_size=1,
                 dilation=1, device=None):
        super().__init__()
        self.tdnn1 = TDNN(in_channels, out_channels, 1, device=device)
        self.res2net_block = Res2Net(out_channels, out_channels, kernel_size, scale, dilation,
                                     device=device)
        self.tdnn2 = TDNN(out_channels, out_channels, 1, device=device)
        self.se_block = SE(out_channels, attention_channels, out_channels, device=device)
        self.shortcut = (Conv1d(in_channels, out_channels, 1, device=device)
                         if in_channels != out_channels else None)

    def forward(self, x):
        if self.shortcut is not None:
            x = self.shortcut(x)
        return x + self.se_block(self.tdnn2(self.res2net_block(self.tdnn1(x))))


class AttentiveStatisticsPooling(nn.Module):
    def __init__(self, channels, attention_channels, global_context=True, device=None):
        super().__init__()
        self.global_context = global_context
        self.tdnn = TDNN(channels * 3 if global_context else channels, attention_channels, 1,
                         device=device)
        self.conv = Conv1d(attention_channels, channels, 1, device=device)

    def forward(self, x):
        L = x.shape[1]
        if self.global_context:
            gm = x.mean(dim=1, keepdim=True)
            gs = torch.sqrt(((x - gm) ** 2).mean(dim=1, keepdim=True) + 1e-12)
            attn_in = torch.cat([x, gm.expand(-1, L, -1), gs.expand(-1, L, -1)], dim=2)
        else:
            attn_in = x
        attn = torch.softmax(self.conv(torch.tanh(self.tdnn(attn_in))), dim=1)
        mean = (x * attn).sum(dim=1, keepdim=True)
        std = torch.sqrt(((x - mean) ** 2 * attn).sum(dim=1, keepdim=True) + 1e-12)
        return torch.cat([mean, std], dim=2)


@dataclass
class ECPATDNNArgs:
    input_size: int
    lin_neurons: int = 192
    channels: List[int] = field(default_factory=lambda: [512, 512, 512, 512, 1536])
    kernel_sizes: List[int] = field(default_factory=lambda: [5, 3, 3, 3, 1])
    dilations: List[int] = field(default_factory=lambda: [1, 2, 3, 4, 1])
    attention_channels: int = 128
    res2net_scale: int = 8
    se_channels: int = 128
    global_context: bool = True


class ECPATDNN(nn.Module):
    """Mel (N, L, C) → speaker embedding (N, 1, lin_neurons)."""

    def __init__(self, args: ECPATDNNArgs, device=None):
        super().__init__()
        ch, ks, dl = args.channels, args.kernel_sizes, args.dilations
        self.blocks = nn.ModuleList(
            [TDNN(args.input_size, ch[0], ks[0], dilation=dl[0], device=device)]
            + [SeRes2Net(ch[i - 1], ch[i], args.res2net_scale, args.se_channels, ks[i], dl[i],
                         device=device) for i in range(1, len(ch) - 1)])
        self.mfa = TDNN(ch[-2] * (len(ch) - 2), ch[-1], ks[-1], dilation=dl[-1], device=device)
        self.asp = AttentiveStatisticsPooling(ch[-1], args.attention_channels,
                                              args.global_context, device=device)
        self.asp_bn = BatchNorm(ch[-1] * 2, device=device)
        self.fc = Conv1d(ch[-1] * 2, args.lin_neurons, 1, device=device)

    def forward(self, x):
        xl = []
        for layer in self.blocks:
            x = layer(x)
            if isinstance(layer, SeRes2Net):
                xl.append(x)
        x = self.mfa(torch.cat(xl, dim=2))
        return self.fc(self.asp_bn(self.asp(x)))


# ---------------------------------------------------------------------------
# the conformer conditioner
# ---------------------------------------------------------------------------
@dataclass
class ConformerArgs:
    input_size: int = 100
    output_size: int = 256
    num_blocks: int = 6
    linear_units: int = 2048
    attention_heads: int = 4
    pos_enc_layer_type: str = "rel_pos"
    input_layer: str = "conv2d"
    cnn_module_kernel: int = 15
    pos_emb_max_len: int = 2048
    use_bias: bool = True
    xscaling: bool = True
    macaron_style: bool = False
    perceiver_mult: int = 2

    @classmethod
    def from_dict(cls, d):
        return cls(**{k: v for k, v in d.items() if k in cls.__dataclass_fields__})


def _attention(q, k, v, bias=None):
    """softmax(q kᵀ·d^-½ + bias) v over (B, H, T, D), the scores and the
    softmax in float32, the weights cast back to v's dtype."""
    scores = (q @ k.transpose(-1, -2)) * q.shape[-1] ** -0.5
    if bias is not None:
        scores = scores + bias
    return torch.softmax(scores.float(), dim=-1).to(v.dtype) @ v


class RelPositionMHA(nn.Module):
    """The JAX package's relative-position attention: `matrix_bd` (the
    queries with `pos_bias_v` against the projected absolute sinusoids) is
    added to the scores as a plain bias, with no relative shift."""

    def __init__(self, n_head, n_feat, bias=True, device=None):
        super().__init__()
        self.n_head = n_head
        self.head_dim = n_feat // n_head
        self.linear_q = Linear(n_feat, n_feat, bias=bias, device=device)
        self.linear_k = Linear(n_feat, n_feat, bias=bias, device=device)
        self.linear_v = Linear(n_feat, n_feat, bias=bias, device=device)
        self.linear_out = Linear(n_feat, n_feat, bias=bias, device=device)
        self.linear_pos = Linear(n_feat, n_feat, bias=False, device=device)
        self.pos_bias_u = nn.Parameter(torch.empty(n_head, self.head_dim, device=device))
        self.pos_bias_v = nn.Parameter(torch.empty(n_head, self.head_dim, device=device))

    def reset_parameters(self, generator=None) -> None:
        self.pos_bias_u.data.zero_()
        self.pos_bias_v.data.zero_()

    def forward(self, x, pos_emb):
        B, T, _ = x.shape
        H, hd = self.n_head, self.head_dim
        q = self.linear_q(x).reshape(B, T, H, hd)
        k = self.linear_k(x).reshape(B, T, H, hd).transpose(1, 2)
        v = self.linear_v(x).reshape(B, T, H, hd).transpose(1, 2)
        p = self.linear_pos(pos_emb).reshape(1, -1, H, hd).transpose(1, 2)
        q_u = (q + self.pos_bias_u).transpose(1, 2)
        q_v = (q + self.pos_bias_v).transpose(1, 2)
        bd = (q_v @ p.transpose(-1, -2)) * hd ** -0.5
        o = _attention(q_u, k, v, bd)
        return self.linear_out(o.transpose(1, 2).reshape(B, T, -1))


class ConformerConv(nn.Module):
    def __init__(self, args: ConformerArgs, device=None):
        super().__init__()
        d, k = args.output_size, args.cnn_module_kernel
        self.pointwise_conv1 = Conv1d(d, 2 * d, 1, bias=args.use_bias, device=device)
        self.depthwise_conv = Conv1d(d, d, k, padding=(k - 1) // 2, groups=d,
                                     bias=args.use_bias, device=device)
        self.norm = LayerNorm(d, device=device)
        self.pointwise_conv2 = Conv1d(d, d, 1, bias=args.use_bias, device=device)

    def forward(self, x):
        a, b = self.pointwise_conv1(x).chunk(2, dim=-1)
        x = F.silu(self.norm(self.depthwise_conv(a * torch.sigmoid(b))))
        return self.pointwise_conv2(x)


class _FeedForward(nn.Module):
    """The JAX package's `Sequential(Linear, SiLU, Linear)`, under its
    `layers.N` names."""

    def __init__(self, d, units, bias, device=None):
        super().__init__()
        self.layers = nn.ModuleList([Linear(d, units, bias=bias, device=device), nn.SiLU(),
                                     Linear(units, d, bias=bias, device=device)])

    def forward(self, x):
        for layer in self.layers:
            x = layer(x)
        return x


class ConformerBlock(nn.Module):
    def __init__(self, args: ConformerArgs, device=None):
        super().__init__()
        d = args.output_size
        self.norm_mha = LayerNorm(d, device=device)
        self.self_attn = RelPositionMHA(args.attention_heads, d, args.use_bias, device=device)
        self.norm_conv = LayerNorm(d, device=device)
        self.conv_module = ConformerConv(args, device=device)
        self.norm_ff = LayerNorm(d, device=device)
        self.feed_forward = _FeedForward(d, args.linear_units, args.use_bias, device=device)
        self.norm_final = LayerNorm(d, device=device)

    def forward(self, x, pos_emb):
        x = x + self.self_attn(self.norm_mha(x), pos_emb)
        x = x + self.conv_module(self.norm_conv(x))
        x = x + self.feed_forward(self.norm_ff(x))
        return self.norm_final(x)


class Conv2dSubsampling(nn.Module):
    """The strided conv2d front over (B, T, F)."""

    _LAYERS = {"conv2d2": [(3, 2)], "conv2d3": [(5, 3)], "conv2d4": [(3, 2), (3, 2)],
               "conv2d": [(3, 2), (3, 2)], "conv2d6": [(3, 2), (5, 3)],
               "conv2d8": [(3, 2), (3, 2), (3, 2)]}

    def __init__(self, args: ConformerArgs, device=None):
        super().__init__()
        self.conv = nn.ModuleList()
        in_ch, out_freq = 1, args.input_size
        for ks, stride in self._LAYERS[args.input_layer]:
            self.conv.append(Conv2d(in_ch, args.output_size, ks, stride=stride, device=device))
            in_ch = args.output_size
            out_freq = (out_freq - ks + stride) // stride
        self.out = nn.ModuleList([Linear(args.output_size * out_freq, args.output_size,
                                         device=device)])

    def forward(self, x):
        h = x[..., None]  # NHWC (B, T, F, 1)
        for conv in self.conv:
            h = torch.relu(conv(h))
        B, T, Fq, C = h.shape
        # channel-major, then frequency: the JAX package's swapaxes(2, 3)
        return self.out[0](h.transpose(2, 3).reshape(B, T, C * Fq))


class Conformer(nn.Module):
    def __init__(self, args: ConformerArgs, device=None):
        super().__init__()
        self.args = args
        self.embed = Conv2dSubsampling(args, device=device)
        self.encoders = nn.ModuleList(ConformerBlock(args, device=device)
                                      for _ in range(args.num_blocks))
        self.after_norm = LayerNorm(args.output_size, eps=1e-5, device=device)
        d = args.output_size
        pos = np.arange(args.pos_emb_max_len)[:, None].astype(np.float32)
        div = np.exp(np.arange(0, d, 2) * -(math.log(10000.0) / d))
        pe = np.zeros((args.pos_emb_max_len, d), np.float32)
        pe[:, 0::2] = np.sin(pos * div)
        pe[:, 1::2] = np.cos(pos * div)
        self.register_buffer("pe", torch.from_numpy(pe[None]).to(device), persistent=False)
        self.xscale = math.sqrt(d) if args.xscaling else 1.0

    def forward(self, x):
        x = self.embed(x)
        pos_emb = self.pe[:, : x.shape[1]].to(x.dtype)
        x = x * self.xscale
        for layer in self.encoders:
            x = layer(x, pos_emb)
        return self.after_norm(x)


class _PerceiverAttention(nn.Module):
    def __init__(self, n_head, n_feat, head_dim, device=None):
        super().__init__()
        inner = n_head * head_dim
        self.n_head = n_head
        self.head_dim = head_dim
        self.linear_q = Linear(n_feat, inner, bias=False, device=device)
        self.linear_k = Linear(n_feat, inner, bias=False, device=device)
        self.linear_v = Linear(n_feat, inner, bias=False, device=device)
        self.linear_out = Linear(inner, n_feat, bias=False, device=device)

    def forward(self, q_in, kv):
        B, Tq, _ = q_in.shape
        Tk = kv.shape[1]
        H, hd = self.n_head, self.head_dim
        q = self.linear_q(q_in).reshape(B, Tq, H, hd).transpose(1, 2)
        k = self.linear_k(kv).reshape(B, Tk, H, hd).transpose(1, 2)
        v = self.linear_v(kv).reshape(B, Tk, H, hd).transpose(1, 2)
        return self.linear_out(_attention(q, k, v).transpose(1, 2).reshape(B, Tq, -1))


class _GatedGeluFF(nn.Module):
    def __init__(self, dim, d_ff, device=None):
        super().__init__()
        self.w_1 = Linear(dim, d_ff * 2, device=device)
        self.w_2 = Linear(d_ff, dim, device=device)

    def forward(self, x):
        a, gate = self.w_1(x).chunk(2, dim=-1)
        return self.w_2(F.gelu(gate, approximate="tanh") * a)


class PerceiverResampler(nn.Module):
    """Context (B, T, n_dim_context) → n_latents learned queries (B,
    n_latents, n_dim)."""

    def __init__(self, n_dim, n_dim_context, n_ff_mult=2, n_heads=8, n_latents=32,
                 n_dim_head=64, n_depth=2, device=None):
        super().__init__()
        self.proj_context = (Linear(n_dim_context, n_dim, device=device)
                             if n_dim_context != n_dim else None)
        self.latents = nn.Parameter(torch.empty(n_latents, n_dim, device=device))
        self.layers = nn.ModuleList(
            nn.ModuleList([_PerceiverAttention(n_heads, n_dim, n_dim_head, device=device),
                           _GatedGeluFF(n_dim, (n_dim * n_ff_mult * 2) // 3, device=device)])
            for _ in range(n_depth))
        self.norm = RMSNorm(n_dim, device=device)

    def reset_parameters(self, generator=None) -> None:
        self.latents.data.zero_()

    def forward(self, x):
        latents = self.latents.expand(x.shape[0], -1, -1)
        if self.proj_context is not None:
            x = self.proj_context(x)
        for attn, ff in self.layers:
            latents = latents + attn(latents, torch.cat([x, latents], dim=-2))
            latents = latents + ff(latents)
        return self.norm(latents)


# ---------------------------------------------------------------------------
# the speaker-conditioned BigVGAN
# ---------------------------------------------------------------------------
class BigVGANConditioning(BigVGAN):
    """BigVGAN over GPT latents (B, T, gpt_dim), conditioned on the ECAPA
    embedding of the reference mel (B, T_ref, num_mels) before the first
    stage and after each upsample."""

    def _build(self, config, device) -> None:
        def get(key):
            return (config.get(key, 1) if isinstance(config, dict)
                    else getattr(config, key, 1))

        gpt_dim, spk_dim = get("gpt_dim"), get("speaker_embedding_dim")
        super()._build(config, device)
        C0 = self.config.upsample_initial_channel
        self.conv_pre = ConvCF(gpt_dim, C0, 7, padding=3, device=device)
        self.speaker_encoder = ECPATDNN(ECPATDNNArgs(self.config.num_mels,
                                                     lin_neurons=spk_dim), device=device)
        self.cond_layer = ConvCF(spk_dim, C0, 1, device=device)
        self.conds = nn.ModuleList(ConvCF(spk_dim, C0 // (2 ** (i + 1)), 1, device=device)
                                   for i in range(len(self.ups)))

    def forward(self, latents, mel_refer):
        spk = self.speaker_encoder(mel_refer).transpose(1, 2)  # (B, spk_dim, 1)
        x = self.conv_pre(latents.transpose(1, 2)) + self.cond_layer(spk)
        return self._upsample_stages(x, lambda step: self.conds[step](spk)).transpose(1, 2)


# ---------------------------------------------------------------------------
# the GPT mel-code LM
# ---------------------------------------------------------------------------
@dataclass
class GPTConfig:
    model_dim: int = 1024
    heads: int = 16
    layers: int = 20
    max_mel_tokens: int = 800
    max_text_tokens: int = 600
    number_text_tokens: int = 12000
    number_mel_codes: int = 8194
    start_mel_token: int = 8192
    stop_mel_token: int = 8193
    start_text_token: int = 0
    stop_text_token: int = 1
    use_mel_codes_as_input: bool = True
    mel_length_compression: int = 1024
    condition_type: str = "conformer_perceiver"
    condition_module: Any = None
    max_conditioning_inputs: int = 1
    condition_num_latent: int = 32

    def __post_init__(self):
        if isinstance(self.condition_module, dict):
            self.condition_module = ConformerArgs.from_dict(self.condition_module)
        self.condition_module = self.condition_module or ConformerArgs()


@dataclass
class ModelArgs:
    gpt: Any = None
    bigvgan: Any = None
    tokenizer_name: str = ""
    sample_rate: int = 24000

    def __post_init__(self):
        if isinstance(self.gpt, dict):
            self.gpt = GPTConfig(**{k: v for k, v in self.gpt.items()
                                    if k in GPTConfig.__dataclass_fields__})
        self.gpt = self.gpt or GPTConfig()


def sample_code(logits: torch.Tensor, generator: torch.Generator, temp: float,
                top_k: int) -> torch.Tensor:
    """The JAX loop's draw over (B, V) float32 logits: the top-k threshold
    by sort (ties kept), then a categorical draw at max(temp, 1e-5), here
    Gumbel-max with exponential noise from `generator` → (B,)."""
    if top_k > 0:
        kth = torch.sort(logits, dim=-1).values[..., -top_k, None]
        logits = torch.where(logits < kth, float("-inf"), logits)
    e = torch.empty_like(logits).exponential_(generator=generator)
    return torch.argmax(logits / max(temp, 1e-5) - torch.log(e), dim=-1)


@torch.inference_mode()
def _indextts_decode(model, embedding: torch.Tensor, max_tokens: int, temp: float,
                     top_k: int, seed: int, sampler=None):
    """The autoregressive mel-code loop over a (1, T0, D) prompt → (latents
    (max_tokens, D) float32 on the card, n + 1): each step's final-norm
    latent, the stop step's included. `sampler(logits (1, V), generator) →
    (1,)` replaces the default draw."""
    g = model.args.gpt
    dev = embedding.device
    caches = model.gpt.make_caches(1, embedding.shape[1] + max_tokens + 1, torch.float32)
    h, _ = model.gpt(embedding, caches)
    h_last = h[:, -1]
    latents = torch.zeros(max_tokens, g.model_dim, device=dev)
    steps = torch.arange(max_tokens, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    done_at = torch.full((), max_tokens, dtype=torch.long, device=dev)
    i = 0
    while i < max_tokens:
        h_norm = model.final_norm(h_last)
        latents[i] = h_norm[0]
        logits = model.mel_head(h_norm).float()
        tok = (sampler(logits, gen) if sampler is not None
               else sample_code(logits, gen, temp, top_k))
        newly = (tok[0] == g.stop_mel_token) & ~done
        done_at = torch.where(newly, i, done_at)
        done = done | newly
        emb = model.mel_embedding(tok) + model.mel_pos_embedding(steps[i: i + 1])
        h, _ = model.gpt(emb[:, None], caches)
        h_last = h[:, -1]
        i += 1
        if i % POLL_STEPS == 0 and i < max_tokens and bool(done):
            break
    n = int(done_at) if bool(done) else max_tokens
    return latents, n + 1


class Model(nn.Module):
    """IndexTTS on an explicit device (None: the card), the weights drawn
    from `seed` (the GPT's `wpe` is a row of zeros, as in the JAX
    package)."""

    def __init__(self, args: Any = None, device=None, seed: int = 0):
        super().__init__()
        if isinstance(args, dict):
            args = ModelArgs(**{k: v for k, v in args.items()
                                if k in ModelArgs.__dataclass_fields__})
        self.args = args or ModelArgs()
        self.device = resolve_device(device)
        dev = self.device
        g = self.args.gpt
        cm = g.condition_module
        self.sample_rate = self.args.sample_rate
        self.text_embedding = Embedding(g.number_text_tokens + 1, g.model_dim, device=dev)
        self.mel_embedding = Embedding(g.number_mel_codes, g.model_dim, device=dev)
        self.mel_pos_embedding = Embedding(g.max_mel_tokens + 2 + g.max_conditioning_inputs,
                                           g.model_dim, device=dev)
        self.text_pos_embedding = Embedding(g.max_text_tokens + 2, g.model_dim, device=dev)
        self.text_head = Linear(g.model_dim, g.number_text_tokens + 1, device=dev)
        self.mel_head = Linear(g.model_dim, g.number_mel_codes, device=dev)
        self.conditioning_encoder = Conformer(cm, device=dev)
        self.perceiver_encoder = PerceiverResampler(
            g.model_dim, n_dim_context=cm.output_size, n_ff_mult=cm.perceiver_mult,
            n_heads=cm.attention_heads, n_latents=g.condition_num_latent, device=dev)
        self.gpt = GPT2Model(GPT2Config(n_embd=g.model_dim, n_head=g.heads, n_layer=g.layers,
                                        n_positions=1, vocab_size=1), device=dev)
        self.final_norm = LayerNorm(g.model_dim, device=dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        init_weights(self, gen)
        # positions come from the learned text and mel position tables
        self.gpt.wpe.weight.data.zero_()
        if self.args.bigvgan is not None:
            self.bigvgan = BigVGANConditioning(self.args.bigvgan, device=dev, seed=seed + 1)
        # host objects and a vocoder from `set_runtime`: a plain dict, so a
        # vocoder set there is neither a parameter nor in the state dict
        self._runtime: dict = {}

    def set_runtime(self, tokenizer=None, bigvgan=None):
        rt = self._runtime
        if tokenizer is not None:
            rt["tokenizer"] = tokenizer
        if bigvgan is not None:
            rt["bigvgan"] = bigvgan

    def make_batcher(self, **kwargs):
        """Serving batcher: concurrent requests' latent decodes run in
        lock-step; BigVGAN vocoding stays per request."""
        from .batcher import IndexTTSBatcher

        return IndexTTSBatcher(self, **kwargs)

    def get_conditioning(self, mel: torch.Tensor) -> torch.Tensor:
        return self.perceiver_encoder(self.conditioning_encoder(mel))

    @torch.inference_mode()
    def prepare_input_embedding(self, text_tokens: List[int], ref_mel) -> torch.Tensor:
        """[conditioning latents ‖ text embeddings + text positions] → (1, T0, D)."""
        g = self.args.gpt
        cond = self.get_conditioning(torch.as_tensor(ref_mel, dtype=torch.float32,
                                                     device=self.device))
        tokens = ([g.start_text_token] + [int(t) for t in text_tokens]
                  + [g.stop_text_token, g.start_mel_token])
        ids = torch.tensor([tokens], device=self.device)
        text_emb = (self.text_embedding(ids)
                    + self.text_pos_embedding(torch.arange(len(tokens), device=self.device)))
        return torch.cat([cond, text_emb], dim=1)

    def _tokenizer(self):
        """The tokenizer set by `set_runtime`, else the checkpoint's
        `tokenizer.model` through `sentencepiece` (where it is installed)."""
        tokenizer = self._runtime.get("tokenizer")
        mp = getattr(self.args, "model_path", None)
        if tokenizer is None and mp:
            from pathlib import Path

            tok_file = Path(mp) / "tokenizer.model"
            if tok_file.exists():
                try:
                    import sentencepiece as spm
                except ImportError:
                    raise RuntimeError(
                        "IndexTTS needs the `sentencepiece` package to load "
                        f"{tok_file}; install it or pass a tokenizer via set_runtime()"
                    ) from None
                tokenizer = spm.SentencePieceProcessor(model_file=str(tok_file))
                self._runtime["tokenizer"] = tokenizer
        if tokenizer is None:
            raise RuntimeError("IndexTTS tokenizer not set — call set_runtime() or load "
                               "via load_model()")
        return tokenizer

    @torch.inference_mode()
    def generate(self, text: str, ref_audio=None, ref_mel=None, max_tokens: int = 5000,
                 temperature: float = 0.8, top_k: int = 30, seed: Optional[int] = None,
                 sampler=None, verbose: bool = False,
                 **kwargs) -> Generator[GenerationResult, None, None]:
        """One GenerationResult: the reference clip's (or `ref_mel`'s)
        conditioning, the latent decode (through an installed
        `IndexTTSBatcher` where there is one and no `sampler`), then the
        conditioned BigVGAN."""
        from ....serving import get_infer_hook
        from . import normalize as _norm

        start = time.perf_counter()
        if ref_audio is not None:
            ref_mel = log_mel_spectrogram(np.asarray(ref_audio, np.float32).reshape(-1),
                                          n_mels=self.args.gpt.condition_module.input_size,
                                          device=self.device)
        if ref_mel is None:
            raise ValueError("Must provide ref_audio or ref_mel")
        ref_mel = torch.as_tensor(ref_mel, dtype=torch.float32, device=self.device)
        tokenizer = self._tokenizer()
        tokens = tokenizer.encode(_norm.tokenize_by_CJK_char(_norm.normalize(text)))
        embedding = self.prepare_input_embedding(tokens, ref_mel)
        g = self.args.gpt
        max_steps = min(max_tokens, g.max_mel_tokens)
        if seed is None:
            seed = int(np.random.randint(0, 2 ** 31 - 1))
        # under a running server an IndexTTSBatcher may be installed:
        # concurrent requests' latent decodes then run in lock-step
        hook = get_infer_hook(self)
        if hook is not None and sampler is None:
            lat = hook.submit(embedding[0].float().cpu().numpy(), max_tokens=max_steps,
                              temperature=temperature, top_k=top_k, seed=seed).result()
            n = int(lat.shape[0])
            latents = torch.as_tensor(lat, device=self.device)[None]
        else:
            latents, n = _indextts_decode(self, embedding, max_steps, float(temperature),
                                          int(top_k), seed, sampler)
            latents = latents[:n][None]
        if verbose:
            print(f"[indextts] {n} mel tokens")
        vocoder = self._runtime.get("bigvgan", getattr(self, "bigvgan", None))
        if vocoder is None:
            raise RuntimeError("IndexTTS BigVGAN vocoder not attached")
        audio = vocoder(latents, ref_mel)[0, :, 0].float().cpu().numpy()
        elapsed = time.perf_counter() - start
        dur = len(audio) / self.sample_rate
        yield GenerationResult(
            audio=audio, samples=len(audio), sample_rate=self.sample_rate, segment_idx=0,
            token_count=n, audio_duration=format_duration(dur),
            real_time_factor=round(elapsed / max(dur, 1e-9), 2),
            prompt={"tokens": len(tokens)}, audio_samples={},
            processing_time_seconds=elapsed, peak_memory_usage=0.0)

    def sanitize(self, weights: dict) -> dict:
        """The JAX package's key map (the GPT's `wte` and `wpe` dropped, the
        `.emb.` position tables and the doubled norm / conv names folded),
        convolutions oriented to the JAX layout."""
        from ....nn.sanitize import orient_weights_to_model

        out = {}
        for k, v in weights.items():
            if ".wte." in k or ".wpe." in k:
                continue
            k = k.replace("mel_pos_embedding.emb.", "mel_pos_embedding.")
            k = k.replace("text_pos_embedding.emb.", "text_pos_embedding.")
            k = k.replace("norm.norm", "norm").replace("conv.conv", "conv")
            out[k] = v
        return orient_weights_to_model(self, out)
