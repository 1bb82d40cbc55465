"""Qwen3-TTS speech tokenizer: RVQ codes ↔ 24 kHz waveform. Counterpart of
`mlx_audio_tpu/tts/models/qwen3_tts/speech_tokenizer.py`, with the same
parameter names.

The decoder: split RVQ dequantize → causal pre-conv → sliding-window
transformer → ConvNeXt upsampling → SnakeBeta conv decoder; channels-last
(B, T, C). The encoder (reference codes for ICL voice cloning) is built
from Mimi's pieces (`codec/models/mimi`): a SEANet encoder, a windowed
transformer, the `edge`-padded downsample and a split RVQ, of whose 32
quantizers the first 16 are kept.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ....nn import Conv1d, ConvTranspose1d, Embedding, LayerNorm, Linear, RMSNorm
from ....ops.attention import scaled_dot_product_attention
from ....ops.rope import apply_rope, rope_cos_sin
from .config import (Qwen3TTSTokenizerConfig, Qwen3TTSTokenizerDecoderConfig,
                     Qwen3TTSTokenizerEncoderConfig)
from .talker import TalkerMLP

__all__ = ["Qwen3TTSSpeechTokenizer"]


class CausalConv1d(nn.Module):
    """Left-padded conv; the right pad makes the frame count whole, with the
    reference's float-division arithmetic."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1, dilation=1,
                 groups=1, device=None):
        super().__init__()
        self.conv = Conv1d(in_channels, out_channels, kernel_size, stride=stride,
                           dilation=dilation, groups=groups, device=device)
        self.keff = (kernel_size - 1) * dilation + 1
        self.stride = stride

    def forward(self, x):  # (B, T, C)
        pad = self.keff - self.stride
        L = x.shape[1]
        n_frames = (L - self.keff + pad) / self.stride + 1
        ideal = (math.ceil(n_frames) - 1) * self.stride + (self.keff - pad)
        extra = max(0, int(ideal - L))
        return self.conv(F.pad(x, (0, 0, pad, extra)))


class CausalTransposeConv1d(nn.Module):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1, device=None):
        super().__init__()
        self.conv = ConvTranspose1d(in_channels, out_channels, kernel_size, stride=stride,
                                    device=device)
        self.trim_right = kernel_size - stride

    def forward(self, x):
        y = self.conv(x)
        return y[:, :-self.trim_right] if self.trim_right > 0 else y


class SnakeBeta(nn.Module):
    def __init__(self, channels: int, device=None):
        super().__init__()
        self.alpha = nn.Parameter(torch.empty(channels, device=device))
        self.beta = nn.Parameter(torch.empty(channels, device=device))

    def reset_parameters(self, generator=None) -> None:
        self.alpha.data.zero_()
        self.beta.data.zero_()

    def forward(self, x):  # (B, T, C)
        alpha = torch.exp(self.alpha)
        beta = torch.exp(self.beta)
        return x + (1.0 / (beta + 1e-9)) * torch.sin(x * alpha) ** 2


class ConvNeXtBlock(nn.Module):
    def __init__(self, dim: int, device=None):
        super().__init__()
        self.dwconv = CausalConv1d(dim, dim, 7, groups=dim, device=device)
        self.norm = LayerNorm(dim, eps=1e-6, device=device)
        self.pwconv1 = Linear(dim, 4 * dim, device=device)
        self.pwconv2 = Linear(4 * dim, dim, device=device)
        self.gamma = nn.Parameter(torch.empty(dim, device=device))

    def reset_parameters(self, generator=None) -> None:
        self.gamma.data.fill_(1e-6)

    def forward(self, x):
        r = x
        x = self.dwconv(x)
        x = self.pwconv2(F.gelu(self.pwconv1(self.norm(x))))  # exact (erf) GELU
        return r + self.gamma * x


class LayerScale(nn.Module):
    def __init__(self, channels: int, initial_scale: float = 0.01, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.empty(channels, device=device))
        self.initial_scale = initial_scale

    def reset_parameters(self, generator=None) -> None:
        self.scale.data.fill_(self.initial_scale)

    def forward(self, x):
        return self.scale * x


class DecoderAttention(nn.Module):
    # the 512 x 512 projections row-stack into one 1536 x 512 launch
    _FUSE_GROUPS = (("qkv_fused", ("q_proj", "k_proj", "v_proj")),)

    def __init__(self, cfg: Qwen3TTSTokenizerDecoderConfig, device=None):
        super().__init__()
        d, hd, b = cfg.hidden_size, cfg.head_dim, cfg.attention_bias
        self.q_proj = Linear(d, cfg.num_attention_heads * hd, bias=b, device=device)
        self.k_proj = Linear(d, cfg.num_key_value_heads * hd, bias=b, device=device)
        self.v_proj = Linear(d, cfg.num_key_value_heads * hd, bias=b, device=device)
        self.o_proj = Linear(cfg.num_attention_heads * hd, d, bias=b, device=device)
        self.nh = cfg.num_attention_heads
        self.nkv = cfg.num_key_value_heads
        self.hd = hd
        self.rope_theta = cfg.rope_theta

    def forward(self, x, mask=None):
        B, T, _ = x.shape
        if hasattr(self, "qkv_fused"):
            q, k, v = self.qkv_fused(x)
        else:
            q, k, v = self.q_proj(x), self.k_proj(x), self.v_proj(x)
        q = q.reshape(B, T, self.nh, self.hd).transpose(1, 2)
        k = k.reshape(B, T, self.nkv, self.hd).transpose(1, 2)
        v = v.reshape(B, T, self.nkv, self.hd).transpose(1, 2)
        cos, sin = rope_cos_sin(torch.arange(T, device=x.device), self.hd,
                                base=self.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        out = scaled_dot_product_attention(q, k, v, scale=self.hd ** -0.5, mask=mask)
        return self.o_proj(out.transpose(1, 2).reshape(B, T, -1))


class DecoderTransformerLayer(nn.Module):
    def __init__(self, cfg, device=None):
        super().__init__()
        self.self_attn = DecoderAttention(cfg, device=device)
        self.mlp = TalkerMLP(cfg, device=device)  # the same SwiGLU, fused the same way
        self.input_layernorm = RMSNorm(cfg.hidden_size, eps=cfg.rms_norm_eps, device=device)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size, eps=cfg.rms_norm_eps,
                                                device=device)
        self.self_attn_layer_scale = LayerScale(cfg.hidden_size,
                                                cfg.layer_scale_initial_scale, device)
        self.mlp_layer_scale = LayerScale(cfg.hidden_size, cfg.layer_scale_initial_scale,
                                          device)

    def forward(self, x, mask=None):
        x = x + self.self_attn_layer_scale(self.self_attn(self.input_layernorm(x), mask))
        return x + self.mlp_layer_scale(self.mlp(self.post_attention_layernorm(x)))


class DecoderTransformer(nn.Module):
    def __init__(self, cfg: Qwen3TTSTokenizerDecoderConfig, device=None):
        super().__init__()
        self.layers = nn.ModuleList(DecoderTransformerLayer(cfg, device)
                                    for _ in range(cfg.num_hidden_layers))
        self.norm = RMSNorm(cfg.hidden_size, eps=cfg.rms_norm_eps, device=device)
        self.input_proj = Linear(cfg.latent_dim, cfg.hidden_size, device=device)
        self.output_proj = Linear(cfg.hidden_size, cfg.latent_dim, device=device)
        self.sliding_window = cfg.sliding_window

    def forward(self, x):  # (B, T, latent)
        x = self.input_proj(x)
        T = x.shape[1]
        q = torch.arange(T, device=x.device)[:, None]
        k = torch.arange(T, device=x.device)[None, :]
        ok = (k <= q) & (q - k < self.sliding_window)
        zero = torch.zeros((), device=x.device)
        mask = torch.where(ok, zero, float("-inf"))[None, None]
        for layer in self.layers:
            x = layer(x, mask)
        return self.output_proj(self.norm(x))


class EuclideanCodebook(nn.Module):
    def __init__(self, dim: int, codebook_size: int, device=None):
        super().__init__()
        self.embed = Embedding(codebook_size, dim, device=device)

    def decode(self, codes):
        return self.embed(codes)


class VectorQuantization(nn.Module):
    def __init__(self, dim, codebook_size, codebook_dim=None, device=None):
        super().__init__()
        codebook_dim = codebook_dim or dim
        if codebook_dim != dim:
            self.project_out = Linear(codebook_dim, dim, device=device)
        self.codebook = EuclideanCodebook(codebook_dim, codebook_size, device)

    def decode(self, codes):  # (B, T) → (B, T, dim)
        q = self.codebook.decode(codes)
        if hasattr(self, "project_out"):
            q = self.project_out(q)
        return q


class ResidualVectorQuantization(nn.Module):
    def __init__(self, num_quantizers, dim, codebook_size, codebook_dim=None, device=None):
        super().__init__()
        self.layers = nn.ModuleList(
            VectorQuantization(dim, codebook_size, codebook_dim, device)
            for _ in range(num_quantizers))

    def decode(self, codes):  # (B, nq, T) → (B, T, dim)
        q = None
        for i in range(codes.shape[1]):
            d = self.layers[i].decode(codes[:, i])
            q = d if q is None else q + d
        return q


class ResidualVectorQuantizer(nn.Module):
    def __init__(self, dimension, n_q, bins, input_dimension=None, output_dimension=None,
                 force_projection=True, device=None):
        super().__init__()
        input_dimension = input_dimension or dimension
        output_dimension = output_dimension or dimension
        if input_dimension != dimension or force_projection:
            self.input_proj = Conv1d(input_dimension, dimension, 1, bias=False, device=device)
        if output_dimension != dimension or force_projection:
            self.output_proj = Conv1d(dimension, output_dimension, 1, bias=False,
                                      device=device)
        self.vq = ResidualVectorQuantization(n_q, dimension, bins, device=device)

    def decode(self, codes):  # (B, nq, T) → (B, T, out_dim)
        q = self.vq.decode(codes)
        if hasattr(self, "output_proj"):
            q = self.output_proj(q)
        return q


class SplitResidualVectorQuantizer(nn.Module):
    def __init__(self, dimension, n_q, n_q_semantic, bins, input_dimension,
                 output_dimension, device=None):
        super().__init__()
        self.n_q_semantic = n_q_semantic
        self.rvq_first = ResidualVectorQuantizer(dimension, n_q_semantic, bins,
                                                 input_dimension, output_dimension,
                                                 device=device)
        self.rvq_rest = ResidualVectorQuantizer(dimension, n_q - n_q_semantic, bins,
                                                input_dimension, output_dimension,
                                                device=device)

    def decode(self, codes):
        q = self.rvq_first.decode(codes[:, :self.n_q_semantic])
        if codes.shape[1] > self.n_q_semantic:
            q = q + self.rvq_rest.decode(codes[:, self.n_q_semantic:])
        return q


class DecoderResidualUnit(nn.Module):
    def __init__(self, dim: int, dilation: int = 1, device=None):
        super().__init__()
        self.act1 = SnakeBeta(dim, device)
        self.conv1 = CausalConv1d(dim, dim, 7, dilation=dilation, device=device)
        self.act2 = SnakeBeta(dim, device)
        self.conv2 = CausalConv1d(dim, dim, 1, device=device)

    def forward(self, x):
        return x + self.conv2(self.act2(self.conv1(self.act1(x))))


class DecoderBlockUpsample(nn.Module):
    def __init__(self, in_dim, out_dim, upsample_rate, device=None):
        super().__init__()
        self.conv = ConvTranspose1d(in_dim, out_dim, 2 * upsample_rate,
                                    stride=upsample_rate, device=device)
        self.trim_right = upsample_rate

    def forward(self, x):
        y = self.conv(x)
        return y[:, :-self.trim_right] if self.trim_right > 0 else y


class DecoderBlock(nn.Module):
    def __init__(self, cfg: Qwen3TTSTokenizerDecoderConfig, layer_idx: int, device=None):
        super().__init__()
        in_dim = cfg.decoder_dim // (2 ** layer_idx)
        out_dim = cfg.decoder_dim // (2 ** (layer_idx + 1))
        self.block = nn.ModuleList([
            SnakeBeta(in_dim, device),
            DecoderBlockUpsample(in_dim, out_dim, cfg.upsample_rates[layer_idx], device),
            DecoderResidualUnit(out_dim, 1, device),
            DecoderResidualUnit(out_dim, 3, device),
            DecoderResidualUnit(out_dim, 9, device),
        ])

    def forward(self, x):
        for layer in self.block:
            x = layer(x)
        return x


class DecoderInitialConv(nn.Module):
    def __init__(self, latent_dim, decoder_dim, kernel_size=7, device=None):
        super().__init__()
        self.conv = Conv1d(latent_dim, decoder_dim, kernel_size, device=device)
        self.kernel_size = kernel_size

    def forward(self, x):
        return self.conv(F.pad(x, (0, 0, self.kernel_size - 1, 0)))


class DecoderOutputSnake(nn.Module):
    def __init__(self, channels, device=None):
        super().__init__()
        self.act = SnakeBeta(channels, device)

    def forward(self, x):
        return self.act(x)


class DecoderOutputConv(DecoderInitialConv):
    def __init__(self, channels, kernel_size=7, device=None):
        super().__init__(channels, 1, kernel_size, device)


class Qwen3TTSSpeechTokenizerDecoder(nn.Module):
    def __init__(self, cfg: Qwen3TTSTokenizerDecoderConfig, device=None):
        super().__init__()
        self.config = cfg
        self.total_upsample = int(np.prod(list(cfg.upsample_rates)
                                          + list(cfg.upsampling_ratios)))
        self.pre_transformer = DecoderTransformer(cfg, device)
        self.quantizer = SplitResidualVectorQuantizer(
            dimension=cfg.codebook_dim // 2, n_q=cfg.num_quantizers,
            n_q_semantic=cfg.num_semantic_quantizers, bins=cfg.codebook_size,
            input_dimension=cfg.codebook_dim, output_dimension=cfg.codebook_dim,
            device=device)
        self.pre_conv = CausalConv1d(cfg.codebook_dim, cfg.latent_dim, 3, device=device)
        self.upsample = nn.ModuleList(
            nn.ModuleList([
                CausalTransposeConv1d(cfg.latent_dim, cfg.latent_dim, factor, factor, device),
                ConvNeXtBlock(cfg.latent_dim, device),
            ])
            for factor in cfg.upsampling_ratios)
        output_dim = cfg.decoder_dim // (2 ** len(cfg.upsample_rates))
        self.decoder = nn.ModuleList([
            DecoderInitialConv(cfg.latent_dim, cfg.decoder_dim, 7, device),
            *[DecoderBlock(cfg, i, device) for i in range(len(cfg.upsample_rates))],
            DecoderOutputSnake(output_dim, device),
            DecoderOutputConv(output_dim, 7, device),
        ])

    def forward(self, codes):  # (B, nq, T) → (B, samples)
        h = self.quantizer.decode(codes)
        h = self.pre_conv(h)
        h = self.pre_transformer(h)
        for up in self.upsample:
            for layer in up:
                h = layer(h)
        for layer in self.decoder:
            h = layer(h)
        return torch.clamp(h[..., 0], -1.0, 1.0)


class Qwen3TTSSpeechTokenizerEncoder(nn.Module):
    """The Mimi-architecture encoder of ICL reference codes."""

    def __init__(self, cfg: Qwen3TTSTokenizerEncoderConfig, device=None):
        super().__init__()
        from ....codec.models.mimi.mimi import (ProjectedTransformer, SeanetConfig,
                                                SeanetEncoder, StreamableConv1d,
                                                TransformerConfig)
        from ....codec.models.mimi.mimi import SplitResidualVectorQuantizer as MimiSplitRVQ

        seanet = SeanetConfig(
            dimension=cfg.hidden_size, channels=cfg.audio_channels, causal=True,
            nfilters=cfg.num_filters, nresidual_layers=cfg.num_residual_layers,
            ratios=list(cfg.upsampling_ratios), ksize=cfg.kernel_size,
            residual_ksize=cfg.residual_kernel_size, last_ksize=cfg.last_kernel_size,
            dilation_base=cfg.dilation_growth_rate, pad_mode="constant",
            true_skip=not cfg.use_conv_shortcut, compress=cfg.compress)
        self.encoder = SeanetEncoder(seanet, device=device)
        tcfg = TransformerConfig(
            d_model=cfg.hidden_size, num_heads=cfg.num_attention_heads,
            num_layers=cfg.num_hidden_layers, context=cfg.sliding_window,
            max_period=cfg.rope_theta, dim_feedforward=cfg.intermediate_size,
            layer_scale=cfg.layer_scale_initial_scale)
        self.encoder_transformer = ProjectedTransformer(
            tcfg, input_dim=cfg.hidden_size, output_dims=[cfg.hidden_size], device=device)
        encoder_frame_rate = cfg.sampling_rate / math.prod(cfg.upsampling_ratios)
        stride = int(encoder_frame_rate / cfg.frame_rate)
        self.downsample = StreamableConv1d(cfg.hidden_size, cfg.hidden_size, 2 * stride,
                                           stride, 1, 1, False, True, "edge", device=device)
        self.quantizer = MimiSplitRVQ(dim=cfg.codebook_dim, input_dim=cfg.hidden_size,
                                      output_dim=cfg.hidden_size, nq=cfg.num_quantizers,
                                      bins=cfg.codebook_size, device=device)
        self.valid_num_quantizers = 16

    def encode(self, audio: torch.Tensor) -> torch.Tensor:
        """audio (B, 1, T) → codes (B, 16, T') int64."""
        x = audio.transpose(1, 2)
        w = self.encoder.init_conv1d.conv.weight
        h = self.encoder(x.to(w.dtype))
        outs, _ = self.encoder_transformer(h)
        codes = self.quantizer.encode(self.downsample(outs[0]))
        return codes[:, :self.valid_num_quantizers]


class Qwen3TTSSpeechTokenizer(nn.Module):
    """The decoder, and the encoder once `build_encoder` is called (the
    loader calls it for a checkpoint that carries the encoder's weights)."""

    def __init__(self, cfg: Qwen3TTSTokenizerConfig, device=None):
        super().__init__()
        self.config = cfg
        self.decoder = Qwen3TTSSpeechTokenizerDecoder(cfg.decoder_config, device)

    def build_encoder(self, seed: int = 0) -> "Qwen3TTSSpeechTokenizerEncoder":
        """Build the encoder at the config's widths on the decoder's device
        and in its dtype, with weights drawn from `seed` (a checkpoint's
        replace them)."""
        if not hasattr(self, "encoder"):
            from ....nn.module import cast_floats, init_weights

            w = self.decoder.pre_conv.conv.weight
            enc = Qwen3TTSSpeechTokenizerEncoder(self.config.encoder_config, w.device)
            gen = torch.Generator(device=w.device)
            gen.manual_seed(seed)
            init_weights(enc, gen)
            self.encoder = cast_floats(enc, w.dtype)
        return self.encoder

    @torch.inference_mode()
    def encode(self, audio) -> torch.Tensor:
        """audio (B, 1, T) (numpy or tensor) → reference codes (B, 16, T')."""
        dev = self.decoder.pre_conv.conv.weight.device
        return self.encoder.encode(torch.as_tensor(np.asarray(audio, np.float32), device=dev)
                                   if not isinstance(audio, torch.Tensor) else audio.to(dev))

    @property
    def decode_upsample_rate(self) -> int:
        return self.decoder.total_upsample

    @torch.inference_mode()
    def decode(self, codes: torch.Tensor) -> torch.Tensor:
        return self.decoder(codes)

    def chunked_decode(self, codes: torch.Tensor, chunk_size: int = 300,
                       left_context_size: int = 25) -> np.ndarray:
        """codes (B, nq, T) → waveform (B, T·upsample) as numpy, decoded in
        chunks of `chunk_size` frames with up to `left_context_size` frames
        of left context, which are cut from each chunk's audio."""
        wavs = []
        start = 0
        up = self.decoder.total_upsample
        while start < codes.shape[-1]:
            end = min(start + chunk_size, codes.shape[-1])
            ctx = left_context_size if start - left_context_size > 0 else start
            wav = self.decode(codes[..., start - ctx:end])
            wavs.append(wav[..., ctx * up:].float().cpu().numpy())
            start = end
        return np.concatenate(wavs, axis=-1)
