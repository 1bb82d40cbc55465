"""CAM++, the x-vector speaker network of S3Gen and CosyVoice2 (counterpart
of `mlx_audio_tpu/codec/models/s3gen/xvector.py`).

Channels-last (B, T, C) throughout, the 2-D front NHWC with the frequency
axis as height; BatchNorm from its running statistics."""

from __future__ import annotations

import re

import torch
import torch.nn.functional as F
from torch import nn

from ....dsp import compute_fbank_kaldi
from ....nn import BatchNorm, Conv1d, Conv2d
from ....nn.sanitize import orient_weights_to_model

__all__ = ["CAMPPlus", "kaldi_fbank", "statistics_pooling"]


def kaldi_fbank(audio: torch.Tensor, sample_rate: int = 16000,
                num_mel_bins: int = 80) -> torch.Tensor:
    """torchaudio's Kaldi fbank (povey window, no dither) → (T, n_mels)."""
    return compute_fbank_kaldi(audio, sample_rate=sample_rate,
                               win_len=int(sample_rate * 25 / 1000),
                               win_inc=int(sample_rate * 10 / 1000), num_mels=num_mel_bins,
                               win_type="povey", dither=0.0, snip_edges=True, low_freq=20.0,
                               high_freq=0.0)


class _NonLinear(nn.Module):
    """A 'batchnorm-relu' style stack; its norms are children "0", "1", ...
    so that torch's `.nonlinear.0.` keys line up."""

    def __init__(self, config_str: str, channels: int, device=None):
        super().__init__()
        self._ops = []
        idx = 0
        for name in config_str.split("-"):
            if name == "relu":
                self._ops.append(None)
            elif name in ("batchnorm", "batchnorm_"):
                self.add_module(str(idx), BatchNorm(channels, affine=(name == "batchnorm"),
                                                    device=device))
                self._ops.append(str(idx))
                idx += 1
            else:
                raise ValueError(f"Unsupported nonlinear: {name}")

    def forward(self, x):
        for op in self._ops:
            x = torch.relu(x) if op is None else self._modules[op](x)
        return x


class BasicResBlock(nn.Module):
    """A 2-D residual block, strided along the frequency axis only; x (B, F,
    T, C)."""

    def __init__(self, in_planes: int, planes: int, stride: int = 1, device=None):
        super().__init__()
        self.conv1 = Conv2d(in_planes, planes, 3, stride=(stride, 1), padding=1, bias=False,
                            device=device)
        self.bn1 = BatchNorm(planes, device=device)
        self.conv2 = Conv2d(planes, planes, 3, padding=1, bias=False, device=device)
        self.bn2 = BatchNorm(planes, device=device)
        self.shortcut = nn.ModuleList()
        if stride != 1 or in_planes != planes:
            self.shortcut.extend([Conv2d(in_planes, planes, 1, stride=(stride, 1), bias=False,
                                         device=device), BatchNorm(planes, device=device)])

    def forward(self, x):
        out = self.bn2(self.conv2(torch.relu(self.bn1(self.conv1(x)))))
        sc = x
        for layer in self.shortcut:
            sc = layer(sc)
        return torch.relu(out + sc)


class FCM(nn.Module):
    """The 2-D front: (B, T, F) → (B, T, C·F/8)."""

    def __init__(self, m_channels: int = 32, feat_dim: int = 80, device=None):
        super().__init__()
        self.conv1 = Conv2d(1, m_channels, 3, padding=1, bias=False, device=device)
        self.bn1 = BatchNorm(m_channels, device=device)
        self.layer1 = nn.ModuleList(BasicResBlock(m_channels, m_channels, s, device=device)
                                    for s in (2, 1))
        self.layer2 = nn.ModuleList(BasicResBlock(m_channels, m_channels, s, device=device)
                                    for s in (2, 1))
        self.conv2 = Conv2d(m_channels, m_channels, 3, stride=(2, 1), padding=1, bias=False,
                            device=device)
        self.bn2 = BatchNorm(m_channels, device=device)
        self.out_channels = m_channels * (feat_dim // 8)

    def forward(self, x):
        out = torch.relu(self.bn1(self.conv1(x.transpose(1, 2)[..., None])))  # (B, F, T, 1)
        for layer in list(self.layer1) + list(self.layer2):
            out = layer(out)
        out = torch.relu(self.bn2(self.conv2(out)))
        B, H, W, C = out.shape
        # torch reshapes (B, C, H, W) → (B, C·H, W): channel-major
        return out.permute(0, 2, 3, 1).reshape(B, W, C * H)


class TDNNLayer(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, stride: int = 1,
                 dilation: int = 1, padding: int = -1, config_str: str = "batchnorm-relu",
                 device=None):
        super().__init__()
        if padding < 0:
            padding = (kernel_size - 1) // 2 * dilation
        self.linear = Conv1d(in_channels, out_channels, kernel_size, stride=stride,
                             padding=padding, dilation=dilation, bias=False, device=device)
        self.nonlinear = _NonLinear(config_str, out_channels, device=device)

    def forward(self, x):
        return self.nonlinear(self.linear(x))


class CAMLayer(nn.Module):
    """Context-aware masking: a local convolution gated by the utterance
    mean plus 100-frame segment means."""

    def __init__(self, bn_channels: int, out_channels: int, kernel_size: int, dilation: int,
                 reduction: int = 2, device=None):
        super().__init__()
        self.linear_local = Conv1d(bn_channels, out_channels, kernel_size,
                                   padding=(kernel_size - 1) // 2 * dilation, dilation=dilation,
                                   bias=False, device=device)
        self.linear1 = Conv1d(bn_channels, bn_channels // reduction, 1, device=device)
        self.linear2 = Conv1d(bn_channels // reduction, out_channels, 1, device=device)

    @staticmethod
    def _seg_pooling(x: torch.Tensor, seg_len: int = 100) -> torch.Tensor:
        """Each frame's segment mean; the last segment's mean counts its
        zero padding, as the JAX package's does."""
        B, T, C = x.shape
        n_segs = -(-T // seg_len)
        xp = F.pad(x, (0, 0, 0, n_segs * seg_len - T))
        seg = xp.reshape(B, n_segs, seg_len, C).mean(dim=2)
        return seg.repeat_interleave(seg_len, dim=1)[:, :T]

    def forward(self, x):
        y = self.linear_local(x)
        context = x.mean(dim=1, keepdim=True) + self._seg_pooling(x)
        return y * torch.sigmoid(self.linear2(torch.relu(self.linear1(context))))


class CAMDenseTDNNLayer(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, bn_channels: int, kernel_size: int,
                 dilation: int = 1, config_str: str = "batchnorm-relu", device=None):
        super().__init__()
        self.nonlinear1 = _NonLinear(config_str, in_channels, device=device)
        self.linear1 = Conv1d(in_channels, bn_channels, 1, bias=False, device=device)
        self.nonlinear2 = _NonLinear(config_str, bn_channels, device=device)
        self.cam_layer = CAMLayer(bn_channels, out_channels, kernel_size, dilation,
                                  device=device)

    def forward(self, x):
        return self.cam_layer(self.nonlinear2(self.linear1(self.nonlinear1(x))))


class CAMDenseTDNNBlock(nn.Module):
    def __init__(self, num_layers: int, in_channels: int, out_channels: int, bn_channels: int,
                 kernel_size: int, dilation: int = 1, config_str: str = "batchnorm-relu",
                 device=None):
        super().__init__()
        self.layers = nn.ModuleList(
            CAMDenseTDNNLayer(in_channels + i * out_channels, out_channels, bn_channels,
                              kernel_size, dilation, config_str, device=device)
            for i in range(num_layers))

    def forward(self, x):
        for layer in self.layers:
            x = torch.cat([x, layer(x)], dim=-1)
        return x


class TransitLayer(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, config_str: str = "batchnorm-relu",
                 device=None):
        super().__init__()
        self.nonlinear = _NonLinear(config_str, in_channels, device=device)
        self.linear = Conv1d(in_channels, out_channels, 1, bias=False, device=device)

    def forward(self, x):
        return self.linear(self.nonlinear(x))


class DenseLayer(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, config_str: str = "batchnorm_",
                 device=None):
        super().__init__()
        self.linear = Conv1d(in_channels, out_channels, 1, bias=False, device=device)
        self.nonlinear = _NonLinear(config_str, out_channels, device=device)

    def forward(self, x):
        if x.dim() == 2:
            return self.nonlinear(self.linear(x[:, None, :]))[:, 0]
        return self.nonlinear(self.linear(x))


def statistics_pooling(x: torch.Tensor) -> torch.Tensor:
    """(B, T, C) → (B, 2C): the mean and the population std."""
    return torch.cat([x.mean(dim=1), torch.sqrt(x.var(dim=1, unbiased=False) + 1e-5)], dim=-1)


class CAMPPlus(nn.Module):
    """CAM++: fbank (B, T, 80) → embedding (B, 192)."""

    def __init__(self, feat_dim: int = 80, embedding_size: int = 192, growth_rate: int = 32,
                 bn_size: int = 4, init_channels: int = 128,
                 config_str: str = "batchnorm-relu", device=None, **_unused):
        super().__init__()
        self.feat_dim = feat_dim
        self.head = FCM(feat_dim=feat_dim, device=device)
        channels = self.head.out_channels
        self.tdnn = TDNNLayer(channels, init_channels, 5, stride=2, dilation=1, padding=-1,
                              config_str=config_str, device=device)
        channels = init_channels
        self.blocks = nn.ModuleList()
        self.transits = nn.ModuleList()
        for num_layers, kernel_size, dilation in zip((12, 24, 16), (3, 3, 3), (1, 2, 2)):
            self.blocks.append(CAMDenseTDNNBlock(num_layers, channels, growth_rate,
                                                 bn_size * growth_rate, kernel_size, dilation,
                                                 config_str, device=device))
            channels += num_layers * growth_rate
            self.transits.append(TransitLayer(channels, channels // 2, config_str,
                                              device=device))
            channels //= 2
        self.out_nonlinear = _NonLinear(config_str, channels, device=device)
        self.dense = DenseLayer(channels * 2, embedding_size, config_str="batchnorm_",
                                device=device)

    def forward(self, x):
        x = self.tdnn(self.head(x))
        for block, transit in zip(self.blocks, self.transits):
            x = transit(block(x))
        return self.dense(statistics_pooling(self.out_nonlinear(x)))

    def inference(self, audio: torch.Tensor) -> torch.Tensor:
        """Raw 16 kHz audio (T,) or (B, T) → (B, 192): each row's fbank less
        its mean, zero-padded to the longest."""
        if audio.dim() == 1:
            audio = audio[None]
        feats = []
        for row in audio:
            f = kaldi_fbank(row, num_mel_bins=self.feat_dim)
            feats.append(f - f.mean(dim=0, keepdim=True))
        T = max(f.shape[0] for f in feats)
        return self(torch.stack([F.pad(f, (0, 0, 0, T - f.shape[0])) for f in feats]))

    def sanitize(self, weights: dict) -> dict:
        """The JAX package's map of torch's `xvector.*` keys."""
        out = {}
        for key, value in weights.items():
            if "num_batches_tracked" in key:
                continue
            k = re.sub(r"xvector\.block(\d+)\.",
                       lambda m: f"blocks.{int(m.group(1)) - 1}.", key)
            k = re.sub(r"xvector\.transit(\d+)\.",
                       lambda m: f"transits.{int(m.group(1)) - 1}.", k)
            for part in ("tdnn", "dense", "out_nonlinear"):
                k = k.replace(f"xvector.{part}.", f"{part}.")
            k = re.sub(r"\.tdnnd(\d+)\.", lambda m: f".layers.{int(m.group(1)) - 1}.", k)
            k = re.sub(r"\.nonlinear(\d*)\.batchnorm\.", r".nonlinear\1.0.", k)
            if k.startswith("out_nonlinear.batchnorm."):
                k = k.replace("out_nonlinear.batchnorm.", "out_nonlinear.0.", 1)
            out[k] = value
        return orient_weights_to_model(self, out)
