"""MossFormer2-SE 48 kHz processor: fbank + deltas → mask net → masked
iSTFT (counterpart of `mlx_audio_tpu/sts/models/mossformer2_se/model.py`).

Each chunk runs eagerly on the model's device. The segmented and chunked
modes for long audio cut and reassemble on the host in numpy, exactly as
the JAX package does. The chunk core is one batched forward over (B, T)
(`_process_batch_core`, the JAX package's vmapped batch); a lone chunk is
the batch of one. Under an installed serving batcher (`make_batcher`, a
`serving.StackBatcher`) concurrent equal-length chunks, a long request's
own among them, stack into one forward.

The fbank's dither is `dsp.kaldi_dither`: a fixed draw per chunk length,
as the JAX package's PRNGKey(0), but not the same numbers; every row of a
batch takes the draw it takes alone.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from ....device import resolve_device
from ....dsp import compute_deltas_kaldi, compute_fbank_kaldi_rows, hamming, istft, stft
from ....nn.module import init_weights
from ....serving import StackBatcher, get_infer_hook, register_infer_hook, unregister_infer_hook
from .config import MossFormer2SEConfig
from .mossformer2 import MossFormer2SE, TestNet

MAX_WAV_VALUE = 32768.0

__all__ = ["MossFormer2SEModel", "Model", "MossFormer2SEConfig"]


def _features(audio: torch.Tensor, cfg: MossFormer2SEConfig,
              noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(T,) or (B, T) samples scaled by MAX_WAV_VALUE → (B, frames,
    3·num_mels): the Kaldi fbank, its deltas and delta-deltas."""
    fb = compute_fbank_kaldi_rows(audio.reshape(-1, audio.shape[-1]),
                                  sample_rate=cfg.sample_rate, win_len=cfg.win_len,
                                  win_inc=cfg.win_inc, num_mels=cfg.num_mels,
                                  win_type=cfg.win_type, preemphasis=cfg.preemphasis,
                                  noise=noise)
    d1 = compute_deltas_kaldi(fb.transpose(1, 2), win_length=5)
    d2 = compute_deltas_kaldi(d1, win_length=5)
    return torch.cat([fb, d1.transpose(1, 2), d2.transpose(1, 2)], dim=2)


def _process_batch_core(model: TestNet, audio: torch.Tensor, cfg: MossFormer2SEConfig,
                        noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, T) equal-length chunks scaled by MAX_WAV_VALUE → the enhanced
    (B, T), as one forward (the ReLU² kernel takes the B rows in each
    launch). `noise` replaces the fbank's dither draw of every row."""
    mask = model(_features(audio, cfg, noise))[-1]  # (B, frames, out_final)
    window = hamming(cfg.win_len, device=audio.device)
    spec = stft(audio, n_fft=cfg.fft_len, hop_length=cfg.win_inc, win_length=cfg.win_len,
                window=window, center=False)  # (B, frames, freq)
    frames = min(spec.shape[1], mask.shape[1])
    masked = spec[:, :frames] * mask[:, :frames]
    return istft(masked.transpose(1, 2), hop_length=cfg.win_inc, win_length=cfg.win_len,
                 window=window, center=False, length=audio.shape[-1])


def _process_chunk_core(model: TestNet, audio: torch.Tensor, cfg: MossFormer2SEConfig,
                        noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(T,) samples scaled by MAX_WAV_VALUE → the enhanced (T,): the batch
    of one."""
    return _process_batch_core(model, audio[None], cfg, noise)[0]


class MossFormer2SEModel:
    """Enhancement front end over a mask net on its device."""

    def __init__(self, model: TestNet, config: MossFormer2SEConfig):
        self.model = model
        self.config = config

    def _hook(self):
        """The serving hook: `Model.make_batcher`'s batcher registers on
        this processor, whose two methods below are the device call sites."""
        return get_infer_hook(self)

    def _process_chunk(self, audio: np.ndarray) -> np.ndarray:
        # under a running server a StackBatcher may be installed: concurrent
        # equal-length chunks enhance as one batched forward
        hook = self._hook()
        if hook is not None:
            return np.asarray(hook(np.asarray(audio, np.float32)))
        device = next(self.model.parameters()).device
        x = torch.from_numpy(np.asarray(audio, np.float32)).to(device)
        with torch.inference_mode():
            out = _process_chunk_core(self.model, x, self.config)
        return out.cpu().numpy()

    def _process_many(self, segments) -> list:
        """Enhance several segments. Under an installed batcher they are
        submitted together, so one long request's own windows fuse into
        batched forwards (and with co-tenant requests')."""
        hook = self._hook()
        if hook is not None:
            futs = [hook.submit(np.asarray(s, np.float32)) for s in segments]
            return [np.asarray(f.result()) for f in futs]
        return [self._process_chunk(s) for s in segments]

    def enhance(self, audio: np.ndarray, chunked: Optional[bool] = None) -> np.ndarray:
        """Noisy waveform (T,) at 48 kHz → enhanced waveform (T,)."""
        audio = np.asarray(audio, np.float32).reshape(-1)
        duration = audio.shape[0] / self.config.sample_rate
        use_chunked = (chunked if chunked is not None
                       else duration >= self.config.auto_chunk_threshold)
        if use_chunked:
            return self._decode_chunked(audio)
        return self._decode_one_audio(audio)

    def _decode_one_audio(self, audio: np.ndarray) -> np.ndarray:
        """One shot up to `one_time_decode_length` seconds, else windows of
        `decode_window` seconds at a 3/4 stride, edges given up."""
        cfg = self.config
        original_len = audio.shape[0]
        x = audio * MAX_WAV_VALUE
        limit = cfg.sample_rate * cfg.one_time_decode_length
        if original_len <= limit:
            return self._process_chunk(x) / MAX_WAV_VALUE

        window_size = int(cfg.sample_rate * cfg.decode_window)
        stride = int(window_size * 0.75)
        t = x.shape[0]
        if t < window_size:
            x = np.pad(x, (0, window_size - t))
        elif t < window_size + stride:
            x = np.pad(x, (0, window_size + stride - t))
        elif (t - window_size) % stride != 0:
            x = np.pad(x, (0, stride - (t - window_size) % stride))
        t = x.shape[0]
        give_up = (window_size - stride) // 2
        out = np.zeros(t)
        starts = list(range(0, t - window_size + 1, stride))
        segs = self._process_many([x[i: i + window_size] for i in starts])
        for idx, seg in zip(starts, segs):
            if idx == 0:
                out[idx: idx + window_size - give_up] = seg[:-give_up]
            else:
                out[idx + give_up: idx + window_size - give_up] = seg[give_up:-give_up]
        return out[:original_len] / MAX_WAV_VALUE

    def _decode_chunked(self, audio: np.ndarray) -> np.ndarray:
        """Chunks of `chunk_seconds` overlapping by `chunk_overlap`, half of
        each overlap discarded on either side."""
        cfg = self.config
        original_len = audio.shape[0]
        x = audio * MAX_WAV_VALUE
        chunk_samples = int(cfg.sample_rate * cfg.chunk_seconds)
        overlap = int(chunk_samples * cfg.chunk_overlap)
        stride = chunk_samples - overlap
        give_up = overlap // 2
        if original_len <= chunk_samples:
            return self._process_chunk(x) / MAX_WAV_VALUE

        starts = list(range(0, original_len - chunk_samples + 1, stride))
        idx = starts[-1] + stride if starts else 0
        segs = [x[i: i + chunk_samples] for i in starts]
        if idx < original_len:
            segs.append(x[idx:])
            starts.append(idx)
        chunks = self._process_many(segs)

        out = np.zeros(original_len)
        for i, (chunk, start) in enumerate(zip(chunks, starts)):
            L = len(chunk)
            first, last = i == 0, i == len(chunks) - 1
            if last and L < chunk_samples:
                ks = give_up if not first else 0
                ke = L
            else:
                ks = 0 if first else give_up
                ke = L - give_up
            s = start + ks
            e = min(start + ke, original_len)
            out[s:e] = chunk[ks: ks + (e - s)]
        return out / MAX_WAV_VALUE


class Model(nn.Module):
    """Loader-facing wrapper (weights key root: net.model.mossformer.*) on an
    explicit device: `Model(config)` builds on the card and raises when
    there is none; tests pass `device="cpu"`. Weights are drawn from `seed`
    with the JAX constructors' distributions and constants."""

    def __init__(self, config=None, device=None, seed: int = 0):
        super().__init__()
        if isinstance(config, dict):
            config = MossFormer2SEConfig.from_dict(config)
        self.config = config or MossFormer2SEConfig()
        self.device = resolve_device(device)
        self.net = MossFormer2SE(self.config, device=self.device)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        init_weights(self, gen)
        self.processor = MossFormer2SEModel(self.net.model, self.config)

    def enhance(self, audio: Optional[np.ndarray] = None, chunked: Optional[bool] = None,
                audio_input: Optional[np.ndarray] = None) -> np.ndarray:
        """Noisy waveform (T,) at 48 kHz → enhanced waveform (T,); `chunked`
        None picks the chunked route from `auto_chunk_threshold` seconds.
        `audio_input` is the upstream name of `audio`."""
        if audio is None:
            audio = audio_input
        return self.processor.enhance(audio, chunked=chunked)

    def make_batcher(self, **kwargs):
        """Serving batcher: concurrent equal-length enhancement chunks run as
        one batched forward (`_process_batch_core`). It registers on the
        processor, whose `_process_chunk` / `_process_many` are the device
        call sites, and on this wrapper too, where a server looks it up to
        tear it down."""
        proc = self.processor
        cfg, dev = self.config, self.device

        def run_batch(items):
            x = torch.from_numpy(np.stack([np.asarray(a, np.float32) for a in items])).to(dev)
            return list(_process_batch_core(proc.model, x, cfg).cpu().numpy())

        return _WrapperStackBatcher(self, proc, run_batch, device=dev, **kwargs)

    def sanitize(self, weights: dict) -> dict:
        out = {}
        for key, value in weights.items():
            k = key
            if not k.startswith("net.") and not k.startswith("model."):
                k = "net.model." + k
            elif k.startswith("model."):
                k = "net." + k
            # torch's UniDeepFsmn conv1 is a Conv2d (O, 39, 1, I/g) → (O, 39, 1)
            if k.endswith(".fsmn.conv1.weight") and value.ndim == 4:
                value = value.reshape(value.shape[0], -1, 1)
            # ConvModule stores the raw depthwise weight
            k = k.replace(".conv_module.conv.weight", ".conv_module.weight")
            k = k.replace(".prelu.weight", ".prelu_weight")
            out[k] = value
        return out


class _WrapperStackBatcher(StackBatcher):
    """A StackBatcher keyed on the processor that installs itself on the
    loader-facing wrapper as well."""

    def __init__(self, wrapper, proc, run_batch, **kwargs):
        super().__init__(proc, run_batch, **kwargs)
        self.wrapper = wrapper

    def install(self):
        super().install()
        register_infer_hook(self.wrapper, self)
        return self

    def close(self):
        unregister_infer_hook(self.wrapper)
        super().close()
