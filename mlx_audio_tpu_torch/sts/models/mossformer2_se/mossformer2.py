"""MossFormer2 mask network for 48 kHz speech enhancement (counterpart of
`mlx_audio_tpu/sts/models/mossformer2_se/mossformer2.py`).

Everything is channels-last (B, T, C), as in the JAX package. The quadratic
ReLU²-attention branch goes through `ops.cuda.relu2_attention`: on the card
always the hand-written kernel (the JAX package takes its Pallas kernel only
under MLX_AUDIO_TPU_FORCE_RELU2_KERNEL=1, a choice measured on a TPU), on
the CPU its plain version. Both compute the same function.

Parameters that the JAX constructors set to constants (norm gains, the
depthwise convolution weights, PReLU) get the same constants from
`reset_parameters`; Linear and Conv1d draw from their JAX distributions.
The depthwise weights keep the JAX layout (C, K, 1), so `load_jax_params`
carries them as they are and a weight in another layout fails its shape
check.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ....nn.layers import Conv1d, GroupNorm, LayerNorm, Linear
from ....ops.cuda.relu2_attention import relu2_attention

__all__ = ["MossFormerMaskNet", "MossFormer2SE", "TestNet"]


# ---------------------------------------------------------------------------
# small layers
# ---------------------------------------------------------------------------
class ScaleNorm(nn.Module):
    """x · g / max(‖x‖ · dim^-1/2, eps) over the last axis."""

    def __init__(self, dim: int, eps: float = 1e-8, device=None):
        super().__init__()
        self.scale = dim ** -0.5
        self.eps = eps
        self.g = nn.Parameter(torch.empty(1, device=device))

    def reset_parameters(self, generator=None) -> None:
        self.g.data.fill_(1.0)

    def forward(self, x):
        norm = torch.linalg.vector_norm(x, dim=-1, keepdim=True) * self.scale
        return x * (self.g / torch.clamp(norm, min=self.eps))


class GlobalLayerNorm(nn.Module):
    """gLN over (T, C) jointly; x (B, T, C), parameters (C, 1)."""

    def __init__(self, dim: int, eps: float = 1e-8, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(dim, 1, device=device))
        self.bias = nn.Parameter(torch.empty(dim, 1, device=device))
        self.eps = eps

    def reset_parameters(self, generator=None) -> None:
        self.weight.data.fill_(1.0)
        self.bias.data.zero_()

    def forward(self, x):
        mean = x.mean(dim=(1, 2), keepdim=True)
        var = (x - mean).square().mean(dim=(1, 2), keepdim=True)
        return (self.weight.reshape(1, 1, -1) * (x - mean) * torch.rsqrt(var + self.eps)
                + self.bias.reshape(1, 1, -1))


class CLayerNorm(LayerNorm):
    """Per-step LayerNorm with the population variance, eps 1e-8."""

    def __init__(self, dim: int, eps: float = 1e-8, device=None):
        super().__init__(dim, eps=eps, device=device)


def _inverse_powers(base: float, exponents: np.ndarray) -> np.ndarray:
    """base ** -exponents, rounded once to float32 from float64, so that
    the card and the host start from the same table."""
    return (base ** -exponents.astype(np.float64)).astype(np.float32)


class ScaledSinuEmbedding(nn.Module):
    """Sinusoidal positions (T, dim) times a learned scale."""

    def __init__(self, dim: int, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.empty(1, device=device))
        inv = _inverse_powers(10000.0, np.arange(0, dim, 2) / dim)
        self.register_buffer("_inv_freq", torch.from_numpy(inv).to(device), persistent=False)

    def reset_parameters(self, generator=None) -> None:
        self.scale.data.fill_(1.0)

    def forward(self, x):
        t = torch.arange(x.shape[1], dtype=torch.float32, device=x.device)
        sinu = t[:, None] * self._inv_freq
        return torch.cat([sinu.sin(), sinu.cos()], dim=-1) * self.scale


class OffsetScale(nn.Module):
    """Per-head affine: x (…, dim) → `heads` tensors x · gamma_h + beta_h."""

    def __init__(self, dim: int, heads: int = 1, device=None):
        super().__init__()
        self.gamma = nn.Parameter(torch.empty(heads, dim, device=device))
        self.beta = nn.Parameter(torch.empty(heads, dim, device=device))

    def reset_parameters(self, generator=None) -> None:
        self.gamma.data.fill_(1.0)
        self.beta.data.zero_()

    def forward(self, x) -> List[torch.Tensor]:
        return list((x[..., None, :] * self.gamma + self.beta).unbind(dim=-2))


def _depthwise(x, weight, pad: int):
    """Same-length depthwise convolution of (B, T, C) with a (C, K, 1)
    weight, `pad` zeros on both sides."""
    y = F.conv1d(x.transpose(1, 2), weight.permute(0, 2, 1), padding=pad,
                 groups=weight.shape[0])
    return y.transpose(1, 2)


class ConvModule(nn.Module):
    """x + depthwise conv(x); weight (C, K, 1), zero at construction."""

    def __init__(self, in_channels: int, kernel_size: int = 17, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(in_channels, kernel_size, 1, device=device))
        self.padding = (kernel_size - 1) // 2

    def reset_parameters(self, generator=None) -> None:
        self.weight.data.zero_()

    def forward(self, x):
        return x + _depthwise(x, self.weight, self.padding)


class FFConvM(nn.Module):
    """norm → linear → silu → conv module."""

    def __init__(self, dim_in: int, dim_out: int, norm: str = "scalenorm", device=None):
        super().__init__()
        self.norm = (LayerNorm(dim_in, device=device) if norm == "layernorm"
                     else ScaleNorm(dim_in, device=device))
        self.linear = Linear(dim_in, dim_out, device=device)
        self.conv_module = ConvModule(dim_out, device=device)

    def forward(self, x):
        return self.conv_module(F.silu(self.linear(self.norm(x))))


# ---------------------------------------------------------------------------
# FSMN
# ---------------------------------------------------------------------------
class UniDeepFsmn(nn.Module):
    """Depthwise time-memory FSMN: p = project(relu(linear(x))), out =
    p + depthwise conv(p) over 2·lorder − 1 steps, plus x when the widths
    agree. conv1 (output_dim, 2·lorder − 1, 1), zero at construction."""

    def __init__(self, input_dim: int, output_dim: int, lorder: int = 20,
                 hidden_size: Optional[int] = None, device=None):
        super().__init__()
        hidden_size = hidden_size or output_dim
        self.residual = input_dim == output_dim
        self.lorder = lorder
        self.linear = Linear(input_dim, hidden_size, device=device)
        self.project = Linear(hidden_size, output_dim, bias=False, device=device)
        self.conv1 = nn.Parameter(torch.empty(output_dim, 2 * lorder - 1, 1, device=device))

    def reset_parameters(self, generator=None) -> None:
        self.conv1.data.zero_()

    def forward(self, x):
        p1 = self.project(F.relu(self.linear(x)))
        out = p1 + _depthwise(p1, self.conv1, self.lorder - 1)
        return x + out if self.residual else out


class GatedFSMN(nn.Module):
    """to_v(x) · fsmn(to_u(x)) + x."""

    def __init__(self, in_channels: int, out_channels: int, lorder: int, hidden_size: int,
                 device=None):
        super().__init__()
        self.to_u = FFConvM(in_channels, hidden_size, norm="layernorm", device=device)
        self.to_v = FFConvM(in_channels, hidden_size, norm="layernorm", device=device)
        self.fsmn = UniDeepFsmn(in_channels, out_channels, lorder, hidden_size, device=device)

    def forward(self, x):
        return self.to_v(x) * self.fsmn(self.to_u(x)) + x


class GatedFSMNBlock(nn.Module):
    """conv1 → PReLU (one shared weight) → norm → gated FSMN → norm →
    conv2, plus the input."""

    def __init__(self, dim: int, inner_channels: int = 256, device=None):
        super().__init__()
        self.conv1 = Conv1d(dim, inner_channels, 1, device=device)
        self.prelu_weight = nn.Parameter(torch.empty(1, device=device))
        self.norm1 = CLayerNorm(inner_channels, device=device)
        self.norm2 = CLayerNorm(inner_channels, device=device)
        self.gated_fsmn = GatedFSMN(inner_channels, inner_channels, 20, inner_channels,
                                    device=device)
        self.conv2 = Conv1d(inner_channels, dim, 1, device=device)

    def reset_parameters(self, generator=None) -> None:
        self.prelu_weight.data.fill_(0.25)

    def forward(self, x):
        h = self.conv1(x)
        h = torch.where(h >= 0, h, self.prelu_weight * h)
        h = self.norm2(self.gated_fsmn(self.norm1(h)))
        return self.conv2(h) + x


# ---------------------------------------------------------------------------
# FLASH attention layer
# ---------------------------------------------------------------------------
def _rope_rotate(x: torch.Tensor, dims: int, base: float = 10000.0) -> torch.Tensor:
    """Rotate the first `dims` features in the rotate-half layout, position
    = sequence index, frequencies base ** (-i / half)."""
    T = x.shape[-2]
    half = dims // 2
    freqs = torch.from_numpy(_inverse_powers(base, np.arange(half) / half)).to(x.device)
    angles = torch.arange(T, dtype=torch.float32, device=x.device)[:, None] * freqs[None, :]
    cos, sin = angles.cos(), angles.sin()
    x1, x2, x_pass = x[..., :half], x[..., half:dims], x[..., dims:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin, x_pass], dim=-1)


class FlashShareAFFConvM(nn.Module):
    """Shared dual attention: a quadratic ReLU² branch within groups of
    `group_size` steps plus a linear branch over the whole sequence (or,
    causal, over the preceding groups)."""

    def __init__(self, dim: int, group_size: int = 256, query_key_dim: int = 128,
                 expansion_factor: float = 4.0, causal: bool = False, device=None):
        super().__init__()
        self.group_size = group_size
        self.causal = causal
        self.rope_dims = min(32, query_key_dim)
        hidden = int(dim * expansion_factor)
        self.to_hidden = FFConvM(dim, hidden, device=device)
        self.to_qk = FFConvM(dim, query_key_dim, device=device)
        self.qk_offset_scale = OffsetScale(query_key_dim, heads=4, device=device)
        self.to_out = FFConvM(dim * 2, dim, device=device)

    def forward(self, x):
        # token shift: the first half of the features one step later
        x_shift, x_pass = x.chunk(2, dim=-1)
        normed = torch.cat([F.pad(x_shift, (0, 0, 1, 0))[:, :-1], x_pass], dim=-1)
        hidden = self.to_hidden(normed)
        quad_q, lin_q, quad_k, lin_k = self.qk_offset_scale(self.to_qk(normed))
        att_v, att_u = self._attention(quad_q, lin_q, quad_k, lin_k, hidden)
        v, u = hidden.chunk(2, dim=-1)
        out = (att_u * v) * torch.sigmoid(att_v * u)
        return x + self.to_out(out)

    def _attention(self, quad_q, lin_q, quad_k, lin_k, hidden):
        """`hidden` is to_hidden's output, v;u. It is padded to whole groups
        once, and the quadratic branch takes v and u in one kernel call on
        all of it (E = 2 × its half): per column that is the function the
        JAX package computes in two calls, with q and k read and the
        weights computed once. Its output is split into views."""
        B, n = hidden.shape[:2]
        g = self.group_size
        quad_q, lin_q, quad_k, lin_k = (_rope_rotate(t, self.rope_dims)
                                        for t in (quad_q, lin_q, quad_k, lin_k))
        pad = (-n) % g
        if pad:
            quad_q, lin_q, quad_k, lin_k, hidden = (
                F.pad(t, (0, 0, 0, pad)) for t in (quad_q, lin_q, quad_k, lin_k, hidden))
        G = (n + pad) // g
        v, u = hidden.chunk(2, dim=-1)  # (B, G·g, E) views
        grp = lambda t: t.view(B, G, g, t.shape[-1])  # noqa: E731
        gq, gk = grp(quad_q), grp(quad_k)

        quad_v, quad_u = relu2_attention(gq, gk, grp(hidden), g).chunk(2, dim=-1)

        if self.causal:
            def linear(t):
                kv = torch.matmul(grp(lin_k).transpose(-1, -2), grp(t)) / g
                kv = kv.cumsum(dim=1)
                kv = torch.cat([torch.zeros_like(kv[:, :1]), kv[:, :-1]], dim=1)
                return torch.matmul(grp(lin_q), kv)
        else:
            def linear(t):
                kv = torch.matmul(lin_k.transpose(-1, -2), t) / n
                return grp(torch.matmul(lin_q, kv))

        ung = lambda t: t.reshape(B, G * g, t.shape[-1])[:, :n]  # noqa: E731
        return ung(quad_v + linear(v)), ung(quad_u + linear(u))


# ---------------------------------------------------------------------------
# blocks & mask net
# ---------------------------------------------------------------------------
class MossFormerBlockGFSMN(nn.Module):
    """depth × (FLASH layer, then gated FSMN block)."""

    def __init__(self, dim: int, depth: int, group_size: int = 256,
                 query_key_dim: int = 128, expansion_factor: float = 4.0,
                 causal: bool = False, device=None):
        super().__init__()
        self.fsmn = nn.ModuleList([GatedFSMNBlock(dim, 256, device=device)
                                   for _ in range(depth)])
        self.layers = nn.ModuleList([
            FlashShareAFFConvM(dim, group_size, query_key_dim, expansion_factor, causal,
                               device=device)
            for _ in range(depth)])

    def forward(self, x):
        for layer, fsmn in zip(self.layers, self.fsmn):
            x = fsmn(layer(x))
        return x


class MossFormerM(nn.Module):
    """Block stack and a final LayerNorm."""

    def __init__(self, num_blocks: int, d_model: int, causal: bool = False,
                 group_size: int = 256, query_key_dim: int = 128,
                 expansion_factor: float = 4.0, device=None):
        super().__init__()
        self.mossformerM = MossFormerBlockGFSMN(d_model, num_blocks, group_size,
                                                query_key_dim, expansion_factor, causal,
                                                device=device)
        self.norm = LayerNorm(d_model, eps=1e-8, device=device)

    def forward(self, x):
        return self.norm(self.mossformerM(x))


class ComputationBlock(nn.Module):
    """MossFormer, GroupNorm(1) and a skip connection."""

    def __init__(self, num_blocks: int, out_channels: int, skip_around_intra: bool = True,
                 device=None):
        super().__init__()
        self.intra_mdl = MossFormerM(num_blocks=num_blocks, d_model=out_channels,
                                     device=device)
        self.intra_norm = GroupNorm(1, out_channels, eps=1e-8, device=device)
        self.skip_around_intra = skip_around_intra

    def forward(self, x):
        intra = self.intra_norm(self.intra_mdl(x))
        return intra + x if self.skip_around_intra else intra


class MossFormerMaskNet(nn.Module):
    """Fbank features (B, T, in_channels) → mask (B, T, out_channels_final)."""

    def __init__(self, in_channels: int = 180, out_channels: int = 512,
                 out_channels_final: int = 961, num_blocks: int = 24, num_spks: int = 2,
                 device=None):
        super().__init__()
        self.num_spks = num_spks
        self.norm = GlobalLayerNorm(in_channels, device=device)
        self.conv1d_encoder = Conv1d(in_channels, out_channels, 1, bias=False, device=device)
        self.pos_enc = ScaledSinuEmbedding(out_channels, device=device)
        self.mdl = ComputationBlock(num_blocks, out_channels, device=device)
        self.conv1d_out = Conv1d(out_channels, out_channels * num_spks, 1, device=device)
        self.conv1_decoder = Conv1d(out_channels, out_channels_final, 1, bias=False,
                                    device=device)
        self.prelu_weight = nn.Parameter(torch.empty(1, device=device))
        self.output = Conv1d(out_channels, out_channels, 1, device=device)
        self.output_gate = Conv1d(out_channels, out_channels, 1, device=device)

    def reset_parameters(self, generator=None) -> None:
        self.prelu_weight.data.fill_(0.25)

    def forward(self, x):
        x = self.conv1d_encoder(self.norm(x))
        x = x + self.pos_enc(x)[None]
        x = self.mdl(x)
        x = torch.where(x >= 0, x, self.prelu_weight * x)
        x = self.conv1d_out(x)  # (B, T, spks·C)
        B, T, _ = x.shape
        # torch's (B, C·spks, T) → (B·spks, C, T), channels-last: the channel
        # axis splits speaker-major
        x = x.reshape(B, T, self.num_spks, -1).transpose(1, 2).reshape(B * self.num_spks, T, -1)
        x = torch.tanh(self.output(x)) * torch.sigmoid(self.output_gate(x))
        x = F.relu(self.conv1_decoder(x))
        return x.reshape(B, self.num_spks, T, -1)[:, 0]  # the first speaker


class TestNet(nn.Module):
    """The mask net, its output in a list."""

    def __init__(self, in_channels: int = 180, out_channels: int = 512,
                 out_channels_final: int = 961, num_blocks: int = 24, device=None):
        super().__init__()
        self.mossformer = MossFormerMaskNet(in_channels, out_channels, out_channels_final,
                                            num_blocks, device=device)

    def forward(self, x) -> List[torch.Tensor]:
        return [self.mossformer(x)]


class MossFormer2SE(nn.Module):
    def __init__(self, config=None, device=None):
        super().__init__()
        self.model = TestNet(getattr(config, "in_channels", 180),
                             getattr(config, "out_channels", 512),
                             getattr(config, "out_channels_final", 961),
                             getattr(config, "num_blocks", 24), device=device)

    def forward(self, x):
        return self.model(x)
