"""DAC, the Descript Audio Codec (counterpart of
`mlx_audio_tpu/codec/models/descript/dac.py`): a convolutional encoder, a
residual vector quantizer over factorised, l2-normalised codebooks, and a
convolutional decoder with transposed-conv upsampling.

The JAX package runs channels-last; here every layer runs channels-first
(B, C, T), PyTorch's own convolution layout, so no activation is
transposed between layers. Parameter names and the checkpoint layout are
the JAX package's (`nn.module.load_weights` turns its (O, K, I) conv
kernels into PyTorch's); Snake's alpha keeps its (1, 1, C) shape. Weight
norm is folded at load (`sanitize`), and a checkpoint in the `transformers`
`DacModel` naming is renamed to the descript one first.

A code past a codebook's end (OuteTTS names `<|c1_1024|>` over 1024-entry
codebooks) decodes as the last entry, as the JAX package's gather clamps
it; an unclamped index would be a device-side assert on the card.

The audio API is the JAX package's: audio (B, 1, T), `encode` → (z (B, D,
T'), codes (B, n_q, T'), latents (B, n_q·D_c, T'), 0, 0), `decode(z)` and
`decode_codes(codes)` → audio (B, 1, T), and `compress` / `decompress`
through a `.dac` file (`DACFile`).
"""

from __future__ import annotations

import json
import math
import re
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ....device import resolve_device
from ....nn import Embedding
from ....nn.activations import snake
from ....nn.module import init_weights, load_weights
from ..base import Conv1d, ConvTranspose1d, fold_weight_norm_pairs

__all__ = ["DAC", "DACFile"]


class Snake1d(nn.Module):
    def __init__(self, channels: int, device=None):
        super().__init__()
        self.alpha = nn.Parameter(torch.empty(1, 1, channels, device=device))

    def reset_parameters(self, generator=None) -> None:
        self.alpha.data.fill_(1.0)

    def forward(self, x):  # (B, C, T)
        return snake(x, self.alpha.transpose(1, 2))


class ResidualUnit(nn.Module):
    def __init__(self, dim: int = 16, dilation: int = 1, device=None):
        super().__init__()
        pad = ((7 - 1) * dilation) // 2
        self.block = nn.ModuleList([
            Snake1d(dim, device=device),
            Conv1d(dim, dim, 7, dilation=dilation, padding=pad, device=device),
            Snake1d(dim, device=device),
            Conv1d(dim, dim, 1, device=device),
        ])

    def forward(self, x):
        y = x
        for layer in self.block:
            y = layer(y)
        pad = (x.shape[-1] - y.shape[-1]) // 2
        if pad > 0:  # the centre crop
            x = x[..., pad:-pad]
        return x + y


class EncoderBlock(nn.Module):
    def __init__(self, dim: int = 16, stride: int = 1, device=None):
        super().__init__()
        self.block = nn.ModuleList([
            ResidualUnit(dim // 2, dilation=1, device=device),
            ResidualUnit(dim // 2, dilation=3, device=device),
            ResidualUnit(dim // 2, dilation=9, device=device),
            Snake1d(dim // 2, device=device),
            Conv1d(dim // 2, dim, 2 * stride, stride=stride, padding=math.ceil(stride / 2),
                   device=device),
        ])

    def forward(self, x):
        for layer in self.block:
            x = layer(x)
        return x


class Encoder(nn.Module):
    def __init__(self, d_model: int = 64, strides=(2, 4, 8, 8), d_latent: int = 64,
                 device=None):
        super().__init__()
        block = [Conv1d(1, d_model, 7, padding=3, device=device)]
        for stride in strides:
            d_model *= 2
            block.append(EncoderBlock(d_model, stride=stride, device=device))
        block += [Snake1d(d_model, device=device),
                  Conv1d(d_model, d_latent, 3, padding=1, device=device)]
        self.block = nn.ModuleList(block)
        self.enc_dim = d_model

    def forward(self, x):
        for layer in self.block:
            x = layer(x)
        return x


class DecoderBlock(nn.Module):
    def __init__(self, input_dim: int, output_dim: int, stride: int, device=None):
        super().__init__()
        self.block = nn.ModuleList([
            Snake1d(input_dim, device=device),
            ConvTranspose1d(input_dim, output_dim, 2 * stride, stride=stride,
                            padding=math.ceil(stride / 2), device=device),
            ResidualUnit(output_dim, dilation=1, device=device),
            ResidualUnit(output_dim, dilation=3, device=device),
            ResidualUnit(output_dim, dilation=9, device=device),
        ])

    def forward(self, x):
        for layer in self.block:
            x = layer(x)
        return x


class Decoder(nn.Module):
    def __init__(self, input_channel, channels, rates, d_out: int = 1, device=None):
        super().__init__()
        layers = [Conv1d(input_channel, channels, 7, padding=3, device=device)]
        output_dim = channels
        for i, stride in enumerate(rates):
            input_dim = channels // 2 ** i
            output_dim = channels // 2 ** (i + 1)
            layers.append(DecoderBlock(input_dim, output_dim, stride, device=device))
        layers += [Snake1d(output_dim, device=device),
                   Conv1d(output_dim, d_out, 7, padding=3, device=device), nn.Tanh()]
        self.model = nn.ModuleList(layers)

    def forward(self, x):
        for layer in self.model:
            x = layer(x)
        return x


def _l2_normalize(x, dim=-1, eps=1e-12):
    return x / x.norm(dim=dim, keepdim=True).clamp(min=eps)


class VectorQuantize(nn.Module):
    def __init__(self, input_dim: int, codebook_size: int, codebook_dim: int, device=None):
        super().__init__()
        self.in_proj = Conv1d(input_dim, codebook_dim, 1, device=device)
        self.out_proj = Conv1d(codebook_dim, input_dim, 1, device=device)
        self.codebook = Embedding(codebook_size, codebook_dim, device=device)
        self.codebook_size = codebook_size
        self.codebook_dim = codebook_dim

    def forward(self, z):  # (B, D, T) → (z_q (B, D, T), indices (B, T), z_e (B, Dc, T))
        z_e = self.in_proj(z)
        z_q, indices = self.decode_latents(z_e)
        return self.out_proj(z_q), indices, z_e

    def decode_code(self, embed_id):
        """Codes (B, T) → (B, Dc, T). An index past the end takes the last
        row (below -N the first), as the JAX package's gather clamps it."""
        return self.codebook(embed_id).transpose(1, 2)

    def decode_latents(self, latents):
        """The nearest code by cosine similarity: the argmax of a float32
        product of the l2-normalised latents and codebook (ties go to the
        first index, as `jnp.argmax`)."""
        enc = _l2_normalize(latents.float(), dim=1)  # (B, Dc, T)
        cb = _l2_normalize(self.codebook.weight.float())  # (N, Dc)
        sim = torch.einsum("bdt,nd->btn", enc, cb)
        indices = torch.argmax(sim, dim=-1)
        return self.decode_code(indices), indices


class ResidualVectorQuantize(nn.Module):
    def __init__(self, input_dim: int = 512, n_codebooks: int = 9, codebook_size: int = 1024,
                 codebook_dim: Union[int, list] = 8, device=None):
        super().__init__()
        if isinstance(codebook_dim, int):
            codebook_dim = [codebook_dim] * n_codebooks
        self.n_codebooks = n_codebooks
        self.quantizers = nn.ModuleList(
            VectorQuantize(input_dim, codebook_size, codebook_dim[i], device=device)
            for i in range(n_codebooks))

    def forward(self, z, n_quantizers: Optional[int] = None):
        if n_quantizers is None:
            n_quantizers = self.n_codebooks
        z_q = torch.zeros_like(z)
        residual = z
        codes, latents = [], []
        for i, q in enumerate(self.quantizers):
            if i >= n_quantizers:
                break
            z_q_i, indices_i, z_e_i = q(residual)
            z_q = z_q + z_q_i
            residual = residual - z_q_i
            codes.append(indices_i)
            latents.append(z_e_i)
        return z_q, torch.stack(codes, dim=1), torch.cat(latents, dim=1)

    def from_codes(self, codes):
        """codes (B, n_q, T) → (z_q (B, D, T), z_p (B, n_q·Dc, T), codes)."""
        z_q, z_p = None, []
        for i in range(codes.shape[1]):
            z_p_i = self.quantizers[i].decode_code(codes[:, i])
            z_p.append(z_p_i)
            z_q_i = self.quantizers[i].out_proj(z_p_i)
            z_q = z_q_i if z_q is None else z_q + z_q_i
        return z_q, torch.cat(z_p, dim=1), codes


def _hf_to_descript(weights: dict) -> dict:
    """`transformers` `DacModel` state-dict names → the descript names this
    module uses. Encoder: conv1, block.{i}(res_unit1..3, snake1, conv1),
    snake1, conv2; decoder: conv1, block.{i}(snake1, conv_t1, res_unit1..3),
    snake1, conv2."""
    n_enc = 1 + max((int(m.group(1)) for k in weights
                     if (m := re.match(r"encoder\.block\.(\d+)\.", k))), default=-1)
    n_dec = 1 + max((int(m.group(1)) for k in weights
                     if (m := re.match(r"decoder\.block\.(\d+)\.", k))), default=-1)

    def map_res_unit(rest: str) -> str:
        part, leaf = rest.split(".", 1)
        idx = {"snake1": 0, "conv1": 1, "snake2": 2, "conv2": 3}[part]
        return f"block.{idx}.{leaf}"

    out = {}
    for k, v in weights.items():
        nk = k
        for side, seq, n, first_res, inner in (
                ("encoder", "block", n_enc, 0, {"snake1": 3, "conv1": 4}),
                ("decoder", "model", n_dec, 2, {"snake1": 0, "conv_t1": 1})):
            if not k.startswith(side + "."):
                continue
            rest = k[len(side) + 1:]
            if rest.startswith("conv1."):
                nk = f"{side}.{seq}.0." + rest[len("conv1."):]
            elif rest.startswith("snake1."):
                nk = f"{side}.{seq}.{n + 1}." + rest[len("snake1."):]
            elif rest.startswith("conv2."):
                nk = f"{side}.{seq}.{n + 2}." + rest[len("conv2."):]
            elif (m := re.match(r"block\.(\d+)\.(.*)$", rest)):
                i, sub = int(m.group(1)), m.group(2)
                if (mu := re.match(r"res_unit(\d)\.(.*)$", sub)):
                    j = int(mu.group(1))
                    nk = (f"{side}.{seq}.{i + 1}.block.{j - 1 + first_res}."
                          + map_res_unit(mu.group(2)))
                else:
                    part, _, leaf = sub.partition(".")
                    if part in inner:
                        nk = f"{side}.{seq}.{i + 1}.block.{inner[part]}.{leaf}"
        out[nk] = v
    return out


class DAC(nn.Module):
    """The codec on an explicit device (None: the card), weights drawn from
    `seed`, in float32."""

    def __init__(self, encoder_dim: int = 64, encoder_rates: List[int] = (2, 4, 5, 8),
                 latent_dim: Optional[int] = None, decoder_dim: int = 1536,
                 decoder_rates: List[int] = (8, 5, 4, 2), n_codebooks: int = 9,
                 codebook_size: int = 1024, codebook_dim: Union[int, list] = 8,
                 sample_rate: int = 44100, device=None, seed: int = 0, **kwargs):
        super().__init__()
        self.device = resolve_device(device)
        if latent_dim is None:
            latent_dim = encoder_dim * (2 ** len(encoder_rates))
        self.latent_dim = latent_dim
        self.hop_length = int(np.prod(encoder_rates))
        self.encoder = Encoder(encoder_dim, encoder_rates, latent_dim, device=self.device)
        self.quantizer = ResidualVectorQuantize(latent_dim, n_codebooks, codebook_size,
                                                codebook_dim, device=self.device)
        self.decoder = Decoder(latent_dim, decoder_dim, decoder_rates, device=self.device)
        self.sample_rate = sample_rate
        self.n_codebooks = n_codebooks
        self.codebook_size = codebook_size
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        init_weights(self, gen)

    def _tensor(self, x, dtype=None) -> torch.Tensor:
        if not isinstance(x, torch.Tensor):
            x = torch.as_tensor(np.asarray(x))
        return x.to(self.device, dtype) if dtype is not None else x.to(self.device)

    # ---- the JAX package's API: audio (B, 1, T), z (B, D, T) ----

    def preprocess(self, audio_data, sample_rate=None):
        """Right-pad (B, 1, T) audio to a whole number of hops."""
        if sample_rate is not None:
            assert sample_rate == self.sample_rate
        x = self._tensor(audio_data)
        length = x.shape[-1]
        right_pad = math.ceil(length / self.hop_length) * self.hop_length - length
        return F.pad(x, (0, right_pad))

    @torch.inference_mode()
    def encode(self, audio_data, n_quantizers: Optional[int] = None):
        z = self.encoder(self._tensor(audio_data, self.encoder.block[0].weight.dtype))
        z_q, codes, latents = self.quantizer(z, n_quantizers)
        zero = torch.zeros((), device=self.device)
        return z_q, codes, latents, zero, zero

    @torch.inference_mode()
    def decode(self, z):
        return self.decoder(self._tensor(z, self.decoder.model[0].weight.dtype))

    @torch.inference_mode()
    def decode_codes(self, codes):
        """codes (B, n_q, T) → audio (B, 1, T·hop)."""
        z_q, _, _ = self.quantizer.from_codes(self._tensor(codes).long())
        return self.decoder(z_q)

    def forward(self, audio_data, sample_rate=None, n_quantizers=None):
        length = audio_data.shape[-1]
        audio_data = self.preprocess(audio_data, sample_rate)
        z, codes, latents, _, _ = self.encode(audio_data, n_quantizers)
        x = self.decode(z)
        return {"audio": x[..., :length], "z": z, "codes": codes, "latents": latents}

    # ---- loading ----

    def sanitize(self, weights: dict) -> dict:
        """Checkpoint weights → the JAX package's layout: weight norm folded,
        `transformers` names renamed, convolutions and Snake's alpha
        oriented."""
        from ....nn.sanitize import orient_weights_to_model

        weights = fold_weight_norm_pairs(weights)
        if any(".res_unit" in k for k in weights):
            weights = _hf_to_descript(weights)
        return orient_weights_to_model(self, weights)

    @classmethod
    def from_pretrained(cls, path, device=None) -> "DAC":
        """A codec from a local directory (config.json, if any, and weights);
        a hub id raises, since the port does not download."""
        from ....utils import get_model_path, load_weight_files

        path = get_model_path(path)
        cfg_file = Path(path) / "config.json"
        config = json.loads(cfg_file.read_text()) if cfg_file.exists() else {}
        model = cls(**config, device=device)
        weights = model.sanitize(load_weight_files(path))
        return load_weights(model, weights, strict=False).eval()

    # ---- .dac files ----

    def compress(self, audio, win_duration: float = 1.0, normalize_db: float = -16,
                 n_quantizers: Optional[int] = None) -> "DACFile":
        """Encode a file or waveform into a portable DACFile: the loudness
        normalised to `normalize_db`, the signal encoded in hop-aligned
        windows of `win_duration` seconds, the original level kept for
        `decompress`."""
        if isinstance(audio, (str, Path)):
            from ....audio_io import read as audio_read

            signal, sr = audio_read(audio)
            if signal.ndim == 2:
                signal = signal.mean(axis=1)
            if sr != self.sample_rate:
                raise ValueError(
                    f"Sample rate of the audio signal ({sr}) does not match "
                    f"the sample rate of the model ({self.sample_rate}).")
        else:
            signal = np.asarray(audio, np.float32).reshape(-1)
        duration = signal.shape[-1] / self.sample_rate

        rms = float(np.sqrt(np.mean(signal.astype(np.float64) ** 2) + 1e-12))
        input_db = 20 * math.log10(rms + 1e-12)
        if normalize_db is not None:
            signal = signal * 10 ** ((normalize_db - input_db) / 20)

        x = signal[None, None, :].astype(np.float32)
        nt = x.shape[-1]
        if win_duration is None or duration <= win_duration:
            n_samples, hop, padding = nt, max(nt, 1), True
        else:
            n_samples = int(win_duration * self.sample_rate)
            n_samples = int(math.ceil(n_samples / self.hop_length) * self.hop_length)
            hop, padding = n_samples, False

        codes, chunk_length = [], 0
        for i in range(0, nt, hop):
            chunk = x[..., i: i + n_samples]
            pad = n_samples - chunk.shape[-1] if not padding else 0
            if pad > 0:
                chunk = np.pad(chunk, [(0, 0), (0, 0), (0, pad)])
            chunk = self.preprocess(chunk, self.sample_rate)
            _, c, _, _, _ = self.encode(chunk, n_quantizers)
            codes.append(c.cpu().numpy())
            chunk_length = codes[-1].shape[-1]

        all_codes = np.concatenate(codes, axis=-1)
        if n_quantizers is not None:
            all_codes = all_codes[:, :n_quantizers, :]
        return DACFile(codes=all_codes, chunk_length=chunk_length, original_length=duration,
                       input_db=input_db, channels=1, sample_rate=self.sample_rate,
                       padding=padding)

    def decompress(self, obj) -> np.ndarray:
        """A DACFile (or its path) → waveform (1, T) at the original
        loudness."""
        if isinstance(obj, (str, Path)):
            obj = DACFile.load(obj)
        if self.sample_rate != obj.sample_rate:
            raise ValueError(
                f"Sample rate of the audio signal ({obj.sample_rate}) does not "
                f"match the sample rate of the model ({self.sample_rate}).")
        codes = np.asarray(obj.codes, np.int64)
        recons = [self.decode_codes(codes[..., i: i + obj.chunk_length]).float().cpu().numpy()
                  for i in range(0, codes.shape[-1], obj.chunk_length)]
        out = np.concatenate(recons, axis=-1)[:, 0]
        out = out * 10 ** ((obj.input_db - (-16)) / 20)
        n = int(obj.original_length * obj.sample_rate)
        return out[..., :n] if n > 0 else out


SUPPORTED_VERSIONS = ["1.0.0"]


@dataclass
class DACFile:
    """A compressed-audio artifact in the `.dac` format: an np.save'd dict of
    uint16 codes and their metadata."""

    codes: np.ndarray
    chunk_length: int
    original_length: float
    input_db: float
    channels: int
    sample_rate: int
    padding: bool
    dac_version: str = SUPPORTED_VERSIONS[-1]

    def save(self, path) -> Path:
        artifacts = {
            "codes": np.asarray(self.codes).astype(np.uint16),
            "metadata": {
                "input_db": float(self.input_db),
                "original_length": self.original_length,
                "sample_rate": self.sample_rate,
                "chunk_length": self.chunk_length,
                "channels": self.channels,
                "padding": self.padding,
                "dac_version": SUPPORTED_VERSIONS[-1],
            },
        }
        path = Path(path).with_suffix(".dac")
        with open(path, "wb") as f:
            np.save(f, artifacts)
        return path

    @classmethod
    def load(cls, path) -> "DACFile":
        artifacts = np.load(path, allow_pickle=True)[()]
        meta = artifacts["metadata"]
        if meta.get("dac_version") not in SUPPORTED_VERSIONS:
            raise RuntimeError(
                f"{path} can't be loaded with this version of the codec "
                f"(dac_version={meta.get('dac_version')})")
        return cls(codes=artifacts["codes"].astype(np.int32), **meta)
