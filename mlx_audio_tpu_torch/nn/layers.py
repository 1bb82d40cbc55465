"""Core layers (counterpart of `mlx_audio_tpu/nn/layers.py`).

Sequence layout is channels-last (N, L, C) at every public boundary, as in
the JAX package. Parameters are stored in PyTorch's own layouts (Linear
(out, in); Conv1d (out, in/groups, k); Conv2d (out, in/groups, kh, kw);
ConvTranspose1d (in, out, k)); `nn.module.load_jax_params` carries the JAX
package's (out, k, in) and (out, kh, kw, in) convolution weights across.

Every layer is created with empty storage on an explicit device and filled
by `reset_parameters(generator)`, which draws from the same distributions
as the JAX package's initialisers.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["clamp_ids", "Linear", "Embedding", "Conv1d", "Conv2d", "ConvTranspose1d",
           "LayerNorm", "RMSNorm", "GroupNorm", "InstanceNorm", "BatchNorm"]


def _he_uniform_(w: torch.Tensor, fan_in: int, generator) -> None:
    bound = math.sqrt(1.0 / max(fan_in, 1))
    w.uniform_(-bound, bound, generator=generator)


class Linear(nn.Module):
    """y = x @ W.T + b with W stored (out_features, in_features); the
    product runs in the input's dtype."""

    def __init__(self, input_dims: int, output_dims: int, bias: bool = True,
                 device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(output_dims, input_dims, device=device))
        self.bias = (nn.Parameter(torch.empty(output_dims, device=device))
                     if bias else None)

    def reset_parameters(self, generator: Optional[torch.Generator]) -> None:
        _he_uniform_(self.weight.data, self.weight.shape[1], generator)
        if self.bias is not None:
            self.bias.data.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), b)


def clamp_ids(ids: torch.Tensor, n: int) -> torch.Tensor:
    """Ids into an n-row table as the JAX package's gather reads them: a
    negative id counts from the end once (torch's own wrap), and then every
    id is clamped into the table, so -1 is the last row, -n - 5 the first
    and n + 5 the last. An unclamped id past the table raises on the CPU
    and is a device-side assert on the card, which ends the process's CUDA
    context."""
    return ids.clamp(-n, n - 1)


class Embedding(nn.Module):
    """A lookup table whose ids are clamped as the JAX package's gather
    clamps them (`clamp_ids`)."""

    def __init__(self, num_embeddings: int, dims: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(num_embeddings, dims, device=device))

    def reset_parameters(self, generator: Optional[torch.Generator]) -> None:
        self.weight.data.normal_(0.0, 0.02, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.weight[clamp_ids(x, self.weight.shape[0])]

    def as_linear(self, x: torch.Tensor) -> torch.Tensor:
        """Tied-weight output projection: x @ W.T in the input's dtype."""
        return F.linear(x, self.weight.to(x.dtype))


class Conv1d(nn.Module):
    """1-D convolution over (N, L, C_in) → (N, L', C_out). The weight is
    stored in PyTorch's (C_out, C_in/groups, K) layout."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, dilation: int = 1,
                 groups: int = 1, bias: bool = True, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(
            out_channels, in_channels // groups, kernel_size, device=device))
        self.bias = (nn.Parameter(torch.empty(out_channels, device=device))
                     if bias else None)
        self.stride = stride
        self.padding = padding
        self.dilation = dilation
        self.groups = groups

    def reset_parameters(self, generator: Optional[torch.Generator]) -> None:
        o, i, k = self.weight.shape
        _he_uniform_(self.weight.data, i * k, generator)
        if self.bias is not None:
            self.bias.data.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = None if self.bias is None else self.bias.to(x.dtype)
        y = F.conv1d(x.transpose(1, 2), self.weight.to(x.dtype), b,
                     stride=self.stride, padding=self.padding,
                     dilation=self.dilation, groups=self.groups)
        return y.transpose(1, 2)


class Conv2d(nn.Module):
    """2-D convolution over (N, H, W, C_in) → (N, H', W', C_out), as the JAX
    package's NHWC layer. The weight is stored in PyTorch's (C_out,
    C_in/groups, KH, KW) layout."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size, stride=1,
                 padding=0, dilation=1, groups: int = 1, bias: bool = True, device=None):
        super().__init__()
        kh, kw = (kernel_size,) * 2 if isinstance(kernel_size, int) else tuple(kernel_size)
        self.weight = nn.Parameter(torch.empty(
            out_channels, in_channels // groups, kh, kw, device=device))
        self.bias = (nn.Parameter(torch.empty(out_channels, device=device))
                     if bias else None)
        self.stride = (stride,) * 2 if isinstance(stride, int) else tuple(stride)
        self.padding = (padding,) * 2 if isinstance(padding, int) else tuple(padding)
        self.dilation = (dilation,) * 2 if isinstance(dilation, int) else tuple(dilation)
        self.groups = groups

    def reset_parameters(self, generator: Optional[torch.Generator]) -> None:
        o, i, kh, kw = self.weight.shape
        _he_uniform_(self.weight.data, i * kh * kw, generator)
        if self.bias is not None:
            self.bias.data.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = None if self.bias is None else self.bias.to(x.dtype)
        y = F.conv2d(x.permute(0, 3, 1, 2), self.weight.to(x.dtype), b, stride=self.stride,
                     padding=self.padding, dilation=self.dilation, groups=self.groups)
        return y.permute(0, 2, 3, 1)


class ConvTranspose1d(nn.Module):
    """Transposed 1-D convolution with torch semantics over (N, L, C_in) →
    (N, L', C_out), L' = (L-1)·stride - 2·padding + K + output_padding. The
    weight is stored in PyTorch's (C_in, C_out/groups, K) layout; the JAX
    package keeps (C_out, K, C_in)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, output_padding: int = 0,
                 groups: int = 1, bias: bool = True, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(
            in_channels, out_channels // groups, kernel_size, device=device))
        self.bias = (nn.Parameter(torch.empty(out_channels, device=device))
                     if bias else None)
        self.stride = stride
        self.padding = padding
        self.output_padding = output_padding
        self.groups = groups

    def reset_parameters(self, generator: Optional[torch.Generator]) -> None:
        # the JAX package's fan-in: in_channels/groups · K
        i, o, k = self.weight.shape
        _he_uniform_(self.weight.data, i // self.groups * k, generator)
        if self.bias is not None:
            self.bias.data.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = None if self.bias is None else self.bias.to(x.dtype)
        y = F.conv_transpose1d(x.transpose(1, 2), self.weight.to(x.dtype), b,
                               stride=self.stride, padding=self.padding,
                               output_padding=self.output_padding,
                               groups=self.groups)
        return y.transpose(1, 2)


class LayerNorm(nn.Module):
    """Affine LayerNorm that normalises in float32 and casts back to the
    input's dtype; `bias=False` leaves the shift out (nanoGPT's)."""

    def __init__(self, dims: int, eps: float = 1e-5, bias: bool = True, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(dims, device=device))
        self.bias = nn.Parameter(torch.empty(dims, device=device)) if bias else None
        self.eps = eps

    def reset_parameters(self, generator: Optional[torch.Generator]) -> None:
        self.weight.data.fill_(1.0)
        if self.bias is not None:
            self.bias.data.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = None if self.bias is None else self.bias.float()
        return F.layer_norm(x.float(), self.weight.shape, self.weight.float(), b,
                            self.eps).to(x.dtype)


class RMSNorm(nn.Module):
    """RMSNorm with float32 statistics, cast back to the input's dtype."""

    def __init__(self, dims: int, eps: float = 1e-5, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(dims, device=device))
        self.eps = eps

    def reset_parameters(self, generator: Optional[torch.Generator]) -> None:
        self.weight.data.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        y = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + self.eps)
        # a bf16 weight promotes inside the product, exactly, with no copy
        return (y * self.weight).to(x.dtype)


class GroupNorm(nn.Module):
    """GroupNorm over channels-last input (N, ..., C): the statistics of
    each group run over every spatial position and the group's C/G
    contiguous channels, in float32, cast back to the input's dtype."""

    def __init__(self, num_groups: int, dims: int, eps: float = 1e-5, device=None):
        super().__init__()
        if dims % num_groups:
            raise ValueError(f"{dims} channels do not split into {num_groups} groups")
        self.weight = nn.Parameter(torch.empty(dims, device=device))
        self.bias = nn.Parameter(torch.empty(dims, device=device))
        self.num_groups = num_groups
        self.eps = eps

    def reset_parameters(self, generator: Optional[torch.Generator]) -> None:
        self.weight.data.fill_(1.0)
        self.bias.data.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, c, g = x.shape[0], x.shape[-1], self.num_groups
        xf = x.float().reshape(n, -1, g, c // g)
        mean = xf.mean(dim=(1, 3), keepdim=True)
        var = (xf - mean).square().mean(dim=(1, 3), keepdim=True)
        y = ((xf - mean) * torch.rsqrt(var + self.eps)).reshape(x.shape)
        return (y * self.weight.float() + self.bias.float()).to(x.dtype)


class InstanceNorm(nn.Module):
    """InstanceNorm1d over (N, L, C): statistics per (N, C) across L, in
    float32, cast back to the input's dtype.

    `valid_len` (N,) restricts the statistics to each row's first valid_len
    positions, so that the bucket padding does not change the output. The
    statistics are single-pass E[x²]−E[x]², as in the JAX layer (not
    `F.instance_norm`, which is two-pass and takes no length mask)."""

    def __init__(self, dims: int, eps: float = 1e-5, affine: bool = True, device=None):
        super().__init__()
        if affine:
            self.weight = nn.Parameter(torch.empty(dims, device=device))
            self.bias = nn.Parameter(torch.empty(dims, device=device))
        else:
            self.weight = self.bias = None
        self.eps = eps

    def reset_parameters(self, generator: Optional[torch.Generator]) -> None:
        if self.weight is not None:
            self.weight.data.fill_(1.0)
            self.bias.data.zero_()

    def forward(self, x: torch.Tensor, valid_len: Optional[torch.Tensor] = None) -> torch.Tensor:
        xf = x.float()
        if valid_len is None:
            s1 = xf.mean(dim=-2, keepdim=True)
            s2 = (xf * xf).mean(dim=-2, keepdim=True)
        else:
            pos = torch.arange(x.shape[-2], device=x.device)
            m = (pos[None, :] < valid_len[:, None])[..., None]
            cnt = valid_len.clamp(min=1).float()[:, None, None]
            s1 = torch.where(m, xf, 0.0).sum(dim=-2, keepdim=True) / cnt
            s2 = torch.where(m, xf * xf, 0.0).sum(dim=-2, keepdim=True) / cnt
        var = (s2 - s1 * s1).clamp(min=0.0)
        y = (xf - s1) * torch.rsqrt(var + self.eps)
        if self.weight is not None:
            y = y * self.weight.float() + self.bias.float()
        return y.to(x.dtype)


class BatchNorm(nn.Module):
    """Inference-mode BatchNorm over channels-last input (..., C), from the
    running statistics, in float32, cast back to the input's dtype. The
    running mean and variance are parameters (never trained), so that
    `load_weights` carries them across as the JAX package's module holds
    them."""

    def __init__(self, num_features: int, eps: float = 1e-5, affine: bool = True,
                 device=None):
        super().__init__()
        if affine:
            self.weight = nn.Parameter(torch.empty(num_features, device=device))
            self.bias = nn.Parameter(torch.empty(num_features, device=device))
        else:
            self.weight = self.bias = None
        self.running_mean = nn.Parameter(torch.empty(num_features, device=device),
                                         requires_grad=False)
        self.running_var = nn.Parameter(torch.empty(num_features, device=device),
                                        requires_grad=False)
        self.eps = eps

    def reset_parameters(self, generator: Optional[torch.Generator]) -> None:
        if self.weight is not None:
            self.weight.data.fill_(1.0)
            self.bias.data.zero_()
        self.running_mean.data.zero_()
        self.running_var.data.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = (x.float() - self.running_mean.float()) * torch.rsqrt(
            self.running_var.float() + self.eps)
        if self.weight is not None:
            y = y * self.weight.float() + self.bias.float()
        return y.to(x.dtype)
