"""Vocos, a ConvNeXt backbone and an ISTFT head, driven by mel or EnCodec
features (counterpart of `mlx_audio_tpu/codec/models/vocos/vocos.py`).

Channels-last (B, T, C) at every boundary, as in the JAX package; the
head's inverse STFT is `dsp.istft` with the JAX module's window-sum
semantics. Parameter names and layouts are the JAX package's.

Where it differs:

- `AdaLayerNorm` takes an integer id, a (B,) id tensor or a (B, E)
  condition. An id reads its column of the scale and shift weights (plus
  their biases), which is what the JAX module computes at the one-hot
  input, and what upstream Vocos's `nn.Embedding` tables read; the JAX
  module applies its Linear to the id itself and raises on an integer id
  or a (B,) id tensor. Spark's BiCodec passes a continuous d-vector through
  the same class.
- `EncodecFeatures` takes the port's EnCodec from a local directory (or an
  instance): the JAX package downloads `mlx-community/encodec-24khz-float32`.
  `Vocos.from_pretrained` looks for it in the checkpoint's `encodec/`.
- `log_mel_spectrogram` of a batch (B, T) drops each row's last frame; the
  JAX function drops the last row (it is written for one signal, where the
  two agree).
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from ....device import resolve_device
from ....dsp import hanning, istft, mel_filters, stft
from ....nn import Conv1d, LayerNorm, Linear
from ....nn.layers import clamp_ids
from ....nn.module import init_weights, load_weights

__all__ = ["Vocos", "MelSpectrogramFeatures", "EncodecFeatures", "ISTFTHead", "AdaLayerNorm",
           "ConvNeXtBlock", "VocosBackbone", "log_mel_spectrogram"]


def log_mel_spectrogram(audio, sample_rate: int = 24_000, n_mels: int = 100,
                        n_fft: int = 1024, hop_length: int = 256,
                        padding: int = 0) -> torch.Tensor:
    """log(max(mel(|STFT|), 1e-5)) of audio (T,) → (1, frames − 1, n_mels),
    or of (B, T) → (B, frames − 1, n_mels): the last frame is dropped, as
    upstream's mel.py does. htk mel scale, no norm."""
    x = torch.as_tensor(audio).float()
    if padding > 0:
        x = F.pad(x, (0, padding))
    spec = stft(x, n_fft=n_fft, hop_length=hop_length, window=hanning(n_fft, device=x.device))
    mags = spec[..., :-1, :].abs()
    fb = mel_filters(sample_rate, n_fft, n_mels, norm=None, mel_scale="htk", device=x.device)
    mel = torch.matmul(mags, fb.T)
    out = torch.log(torch.clamp(mel, min=1e-5))
    return out[None] if out.dim() == 2 else out


class MelSpectrogramFeatures(nn.Module):
    def __init__(self, sample_rate: int = 24_000, n_fft: int = 1024, hop_length: int = 256,
                 n_mels: int = 100, padding: str = "center", **kwargs):
        super().__init__()
        self.sample_rate = sample_rate
        self.n_fft = n_fft
        self.hop_length = hop_length
        self.n_mels = n_mels
        self.padding = padding

    def forward(self, audio, **kwargs) -> torch.Tensor:
        return log_mel_spectrogram(audio, self.sample_rate, self.n_mels, self.n_fft,
                                   self.hop_length)


class EncodecFeatures(nn.Module):
    """EnCodec codes → summed codebook embeddings (B, T, D). `encodec_model`
    is a local directory of the port's EnCodec or an `Encodec` instance; a
    name such as "encodec_24khz" raises (the port does not download)."""

    def __init__(self, encodec_model: Union[str, nn.Module] = "encodec_24khz",
                 bandwidths: Sequence[float] = (1.5, 3.0, 6.0, 12.0), device=None, **kwargs):
        super().__init__()
        from ..encodec.encodec import Encodec

        if isinstance(encodec_model, nn.Module):
            self.encodec = encodec_model
        else:
            from ....utils import NO_DOWNLOAD

            if not Path(str(encodec_model)).is_dir():
                raise ValueError(NO_DOWNLOAD.format(str(encodec_model))
                                 + " (or pass an Encodec as encodec_model)")
            self.encodec = Encodec.from_pretrained(str(encodec_model), device=device)
        self.num_q = self.encodec.quantizer.get_num_quantizers_for_bandwidth(
            bandwidth=max(bandwidths))
        self.bandwidths = list(bandwidths)

    @torch.inference_mode()
    def get_encodec_codes(self, audio, bandwidth_id: int) -> torch.Tensor:
        """Audio (T,) → codes (nq, B, T')."""
        x = torch.as_tensor(audio).float().reshape(1, 1, -1)
        codes, _ = self.encodec.encode(x, bandwidth=self.bandwidths[int(bandwidth_id)])
        return codes[0].transpose(0, 1)

    @torch.inference_mode()
    def get_features_from_codes(self, codes) -> torch.Tensor:
        """codes (nq, B, T) → (B, T, D); a code past a codebook reads its
        last entry, as the JAX package's gather clamps it."""
        codes = torch.as_tensor(codes, device=self.encodec.device).long()
        emb = None
        for i in range(codes.shape[0]):
            e = self.encodec.quantizer.layers[i].decode(codes[i])
            emb = e if emb is None else emb + e
        return emb.transpose(1, 2)

    def forward(self, audio, **kwargs) -> torch.Tensor:
        bandwidth_id = kwargs.get("bandwidth_id")
        if bandwidth_id is None:
            raise ValueError("The 'bandwidth_id' argument is required")
        return self.get_features_from_codes(self.get_encodec_codes(audio, bandwidth_id))


class ISTFTHead(nn.Module):
    def __init__(self, dim: int, n_fft: int, hop_length: int, padding: str = "center",
                 device=None):
        super().__init__()
        self.out = Linear(dim, n_fft + 2, device=device)
        self.n_fft = n_fft
        self.hop_length = hop_length

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T, dim) → waveform (B, (T − 1)·hop)."""
        h = self.out(x).transpose(1, 2).float()  # (B, n_fft + 2, T)
        mag, p = h.chunk(2, dim=1)
        mag = torch.clamp(torch.exp(mag), max=1e2)
        S = torch.complex(mag * torch.cos(p), mag * torch.sin(p))
        return istft(S, hop_length=self.hop_length, win_length=self.n_fft,
                     window=hanning(self.n_fft, device=x.device), normalized=True)


class _Filled(Linear):
    """A Linear whose weight starts at a constant and its bias at zero."""

    def __init__(self, input_dims: int, output_dims: int, fill: float, device=None):
        super().__init__(input_dims, output_dims, device=device)
        self.fill = fill

    def reset_parameters(self, generator=None) -> None:
        self.weight.data.fill_(self.fill)
        self.bias.data.zero_()


class AdaLayerNorm(nn.Module):
    """LayerNorm (eps 1e-6, no affine) whose scale and shift come from a
    condition: Linear(E → dim) of a (B, E) condition, or, for an integer id
    or a (B,) id tensor, that id's column of each weight plus its bias (the
    one-hot input's product; ids clamp into the E columns)."""

    def __init__(self, num_embeddings: int, embedding_dim: int, eps: float = 1e-6,
                 device=None):
        super().__init__()
        # the JAX package's ones and zeros
        self.scale = _Filled(num_embeddings, embedding_dim, 1.0, device=device)
        self.shift = _Filled(num_embeddings, embedding_dim, 0.0, device=device)
        self.eps = eps

    def _affine(self, layer: Linear, cond: torch.Tensor) -> torch.Tensor:
        if cond.is_floating_point():
            return layer(cond.to(layer.weight.dtype)).float()
        ids = clamp_ids(cond.reshape(-1).long(), layer.weight.shape[1])
        w = layer.weight.t()[ids].float()
        return w if layer.bias is None else w + layer.bias.float()

    def forward(self, x: torch.Tensor, cond) -> torch.Tensor:
        if cond is None:
            raise ValueError("AdaLayerNorm needs a condition (a bandwidth id or a vector)")
        cond = torch.as_tensor(cond, device=x.device)
        scale, shift = self._affine(self.scale, cond), self._affine(self.shift, cond)
        xn = F.layer_norm(x.float(), x.shape[-1:], eps=self.eps)
        return (xn * scale[:, None, :] + shift[:, None, :]).to(x.dtype)


class ConvNeXtBlock(nn.Module):
    def __init__(self, dim: int, intermediate_dim: int, layer_scale_init_value: float,
                 adanorm_num_embeddings: Optional[int] = None, dw_kernel_size: int = 7,
                 device=None):
        super().__init__()
        self.dwconv = Conv1d(dim, dim, dw_kernel_size, padding=dw_kernel_size // 2,
                             groups=dim, device=device)
        self.adanorm = adanorm_num_embeddings is not None
        if adanorm_num_embeddings:
            self.norm = AdaLayerNorm(adanorm_num_embeddings, dim, device=device)
        else:
            self.norm = LayerNorm(dim, eps=1e-6, device=device)
        self.pwconv1 = Linear(dim, intermediate_dim, device=device)
        self.pwconv2 = Linear(intermediate_dim, dim, device=device)
        self._lsiv = layer_scale_init_value
        self.gamma = (nn.Parameter(torch.empty(dim, device=device))
                      if layer_scale_init_value > 0 else None)

    def reset_parameters(self, generator=None) -> None:
        if self.gamma is not None:
            self.gamma.data.fill_(self._lsiv)

    def forward(self, x: torch.Tensor, cond_embedding_id=None) -> torch.Tensor:
        residual = x
        x = self.dwconv(x)
        x = self.norm(x, cond_embedding_id) if self.adanorm else self.norm(x)
        x = self.pwconv2(F.gelu(self.pwconv1(x)))
        if self.gamma is not None:
            x = self.gamma.to(x.dtype) * x
        return residual + x


class VocosBackbone(nn.Module):
    def __init__(self, input_channels: int, dim: int, intermediate_dim: int, num_layers: int,
                 layer_scale_init_value: Optional[float] = None,
                 adanorm_num_embeddings: Optional[int] = None, bias: bool = True,
                 input_kernel_size: int = 7, dw_kernel_size: int = 7, device=None, **kwargs):
        super().__init__()
        self.input_channels = input_channels
        self.embed = Conv1d(input_channels, dim, input_kernel_size,
                            padding=input_kernel_size // 2, device=device)
        self.adanorm = adanorm_num_embeddings is not None
        if adanorm_num_embeddings:
            self.norm = AdaLayerNorm(adanorm_num_embeddings, dim, device=device)
        else:
            self.norm = LayerNorm(dim, eps=1e-6, device=device)
        lsiv = layer_scale_init_value or 1 / num_layers
        self.convnext = nn.ModuleList(
            ConvNeXtBlock(dim, intermediate_dim, lsiv, adanorm_num_embeddings, dw_kernel_size,
                          device=device)
            for _ in range(num_layers))
        self.final_layer_norm = LayerNorm(dim, eps=1e-6, bias=bias, device=device)

    def forward(self, x: torch.Tensor, **kwargs) -> torch.Tensor:
        """(B, T, C_in), or (B, C_in, T), → (B, T, dim)."""
        bandwidth_id = kwargs.get("bandwidth_id", None)
        if x.shape[-1] != self.input_channels:
            x = x.transpose(1, 2)
        x = self.embed(x)
        x = self.norm(x, bandwidth_id) if self.adanorm else self.norm(x)
        for blk in self.convnext:
            x = blk(x, cond_embedding_id=bandwidth_id)
        return self.final_layer_norm(x)


def _orient_upstream(model: nn.Module, weights: dict) -> dict:
    """Upstream Vocos's AdaLayerNorm tables are `nn.Embedding`s, (E, dim):
    the port's Linear holds their transpose."""
    params = dict(model.named_parameters())
    out = {}
    for k, v in weights.items():
        p = params.get(k)
        if (p is not None and k.endswith((".scale.weight", ".shift.weight"))
                and tuple(v.shape) == tuple(p.shape[::-1]) and p.shape[0] != p.shape[1]):
            v = v.T
        out[k] = v
    return out


class Vocos(nn.Module):
    def __init__(self, feature_extractor: nn.Module, backbone: VocosBackbone,
                 head: ISTFTHead):
        super().__init__()
        self.feature_extractor = feature_extractor
        self.backbone = backbone
        self.head = head

    @property
    def device(self) -> torch.device:
        return self.head.out.weight.device

    @classmethod
    def from_hparams(cls, config: dict, device=None, seed: int = 0,
                     encodec: Union[str, nn.Module, None] = None) -> "Vocos":
        """Build from upstream's config.yaml contents on `device` (None: the
        card), the backbone and head drawn from `seed`. An EnCodec-driven
        config takes `encodec` (a local directory or an `Encodec`) in place
        of the name its init_args give."""
        device = resolve_device(device)
        fe_cfg = config["feature_extractor"]
        backbone = VocosBackbone(**config["backbone"]["init_args"], device=device)
        head = ISTFTHead(**config["head"]["init_args"], device=device)
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        for m in (backbone, head):
            init_weights(m, gen)
        if "MelSpectrogramFeatures" in fe_cfg["class_path"]:
            fe = MelSpectrogramFeatures(**fe_cfg["init_args"])
        else:
            args = dict(fe_cfg["init_args"])
            if encodec is not None:
                args["encodec_model"] = encodec
            fe = EncodecFeatures(**args, device=device)
        return cls(fe, backbone, head)

    @classmethod
    def from_pretrained(cls, path, device=None) -> "Vocos":
        """A local directory with upstream's config.yaml and weights (an
        EnCodec-driven model's codec in its `encodec/`); a hub id raises."""
        import yaml

        from ....nn.sanitize import orient_weights_to_model
        from ....utils import get_model_path, load_weight_files

        path = Path(get_model_path(path))
        config = yaml.safe_load((path / "config.yaml").read_text())
        encodec = path / "encodec"
        model = cls.from_hparams(config, device=device,
                                 encodec=str(encodec) if encodec.is_dir() else None)
        weights = load_weight_files(path)
        weights.pop("feature_extractor.mel_spec.spectrogram.window", None)
        weights.pop("head.istft.window", None)
        weights = {k: v for k, v in weights.items()
                   if not k.startswith("feature_extractor.encodec")}
        weights = orient_weights_to_model(model, _orient_upstream(model, weights))
        return load_weights(model, weights, strict=False,
                            not_built=("feature_extractor.",)).eval()

    @torch.inference_mode()
    def decode(self, features_input, **kwargs) -> torch.Tensor:
        """Features (B, T, C) → waveform (B, samples); an adanorm backbone
        takes `bandwidth_id` (an id, (B,) ids, or a (B, E) condition)."""
        x = torch.as_tensor(features_input, device=self.device)
        if x.is_floating_point():
            x = x.to(self.head.out.weight.dtype)
        return self.head(self.backbone(x, **kwargs))

    def decode_from_codes(self, codes, **kwargs) -> torch.Tensor:
        return self.decode(self.feature_extractor.get_features_from_codes(codes), **kwargs)

    def get_encodec_codes(self, audio_input, bandwidth_id: int) -> torch.Tensor:
        if not isinstance(self.feature_extractor, EncodecFeatures):
            raise ValueError("This model does not support getting encodec codes.")
        return self.feature_extractor.get_encodec_codes(audio_input, bandwidth_id)

    @torch.inference_mode()
    def forward(self, audio_input, **kwargs) -> torch.Tensor:
        audio = torch.as_tensor(audio_input, device=self.device)
        return self.decode(self.feature_extractor(audio, **kwargs), **kwargs)
