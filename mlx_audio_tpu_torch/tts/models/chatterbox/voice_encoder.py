"""Chatterbox's LSTM voice encoder (counterpart of
`mlx_audio_tpu/tts/models/chatterbox/voice_encoder.py`): 160-frame partial
windows of a 40-bin mel, all encoded in one batch by a 3-layer LSTM (the
port's `nn.LSTM`, torch's fused operator), each utterance the normalised
mean of its partials' embeddings."""

from __future__ import annotations

import math
import re
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ....dsp import mel_filters, stft
from ....nn import LSTM, Linear

__all__ = ["VoiceEncoder", "VoiceEncConfig", "melspectrogram"]


@dataclass
class VoiceEncConfig:
    num_mels: int = 40
    sample_rate: int = 16000
    speaker_embed_size: int = 256
    ve_hidden_size: int = 256
    n_fft: int = 400
    hop_size: int = 160
    win_size: int = 400
    fmax: int = 8000
    fmin: int = 0
    mel_power: float = 2.0
    mel_type: str = "amp"
    normalized_mels: bool = False
    ve_partial_frames: int = 160
    ve_final_relu: bool = True
    stft_magnitude_min: float = 1e-4


def melspectrogram(wav, hp: Optional[VoiceEncConfig] = None, device=None) -> torch.Tensor:
    """Waveform → (B, T', num_mels) mel, channels-last."""
    hp = hp or VoiceEncConfig()
    if not isinstance(wav, torch.Tensor):
        wav = torch.from_numpy(np.asarray(wav, np.float32))
    wav = wav.to(device=device, dtype=torch.float32)
    if wav.dim() == 1:
        wav = wav[None]
    mag = stft(wav, n_fft=hp.n_fft, hop_length=hp.hop_size, win_length=hp.win_size,
               window="hann").abs() ** hp.mel_power
    filters = mel_filters(hp.sample_rate, hp.n_fft, hp.num_mels, f_min=hp.fmin, f_max=hp.fmax,
                          norm="slaney", mel_scale="slaney", device=wav.device)
    mel = mag @ filters.T
    if hp.mel_type == "db":
        mel = 20 * torch.log10(mel.clamp(min=hp.stft_magnitude_min))
    if hp.normalized_mels:
        min_db = 20 * math.log10(hp.stft_magnitude_min)
        mel = (mel - min_db) / (-min_db + 15)
    return mel


def get_frame_step(overlap: float, rate: Optional[float], hp: VoiceEncConfig) -> int:
    if rate is None:
        frame_step = int(round(hp.ve_partial_frames * (1 - overlap)))
    else:
        frame_step = int(round(hp.sample_rate / rate / hp.hop_size))
    return max(1, min(frame_step, hp.ve_partial_frames))


def get_num_wins(n_frames: int, step: int, min_coverage: float, hp: VoiceEncConfig):
    win_size = hp.ve_partial_frames
    n_wins, remainder = divmod(max(n_frames - win_size + step, 0), step)
    if n_wins == 0 or (remainder + (win_size - step)) / win_size >= min_coverage:
        n_wins += 1
    return n_wins, win_size + step * (n_wins - 1)


class VoiceEncoder(nn.Module):
    """The 3-layer LSTM and its projection."""

    def __init__(self, hp: Optional[VoiceEncConfig] = None, device=None):
        super().__init__()
        hp = hp or VoiceEncConfig()
        self.hp = hp
        self.lstm = nn.ModuleList(
            LSTM(hp.num_mels if i == 0 else hp.ve_hidden_size, hp.ve_hidden_size, device=device)
            for i in range(3))
        self.proj = Linear(hp.ve_hidden_size, hp.speaker_embed_size, device=device)

    def forward(self, mels: torch.Tensor) -> torch.Tensor:
        """(B, ve_partial_frames, M) → L2-normalised (B, E)."""
        h = mels
        for layer in self.lstm:
            h, _ = layer(h)
        emb = self.proj(h[:, -1])
        if self.hp.ve_final_relu:
            emb = torch.relu(emb)
        return emb / torch.linalg.vector_norm(emb, dim=1, keepdim=True)

    def inference(self, mels: torch.Tensor, mel_lens: List[int], overlap: float = 0.5,
                  rate: Optional[float] = None, min_coverage: float = 0.8) -> torch.Tensor:
        """Whole utterances (B, T, M) → (B, E), each the normalised mean of
        its partials."""
        step = get_frame_step(overlap, rate, self.hp)
        wins = [get_num_wins(n, step, min_coverage, self.hp) for n in mel_lens]
        target = max(t for _, t in wins)
        if target > mels.shape[1]:
            mels = F.pad(mels, (0, 0, 0, target - mels.shape[1]))
        partials, owners = [], []
        for b, (n_win, _) in enumerate(wins):
            for w in range(n_win):
                partials.append(mels[b, w * step: w * step + self.hp.ve_partial_frames])
                owners.append(b)
        embeds = self(torch.stack(partials))
        owners = torch.tensor(owners, device=embeds.device)
        out = []
        for b in range(len(mel_lens)):
            raw = embeds[owners == b].mean(dim=0)
            out.append(raw / torch.linalg.vector_norm(raw))
        return torch.stack(out)

    def embeds_from_wavs(self, wavs: List[np.ndarray], sample_rate: int = 16000,
                         as_spk: bool = False, **kwargs) -> torch.Tensor:
        """Waveforms → partial-averaged embeddings (B, E) on the encoder's
        device."""
        from ....utils import resample_audio

        hp = self.hp
        dev = self.proj.weight.device
        mels = []
        for w in wavs:
            w = np.asarray(w, np.float32).reshape(-1)
            if sample_rate != hp.sample_rate:
                w = resample_audio(w, sample_rate, hp.sample_rate)
            mels.append(melspectrogram(w, hp, device=dev)[0])
        T = max(m.shape[0] for m in mels)
        batch = torch.stack([F.pad(m, (0, 0, 0, T - m.shape[0])) for m in mels])
        return self.inference(batch, [m.shape[0] for m in mels], **kwargs)

    def sanitize(self, weights: dict) -> dict:
        """torch's LSTM keys → the JAX package's (`lstm.N.Wx` ...); the
        training-only similarity scalars dropped."""
        remap = {"weight_ih": "Wx", "weight_hh": "Wh", "bias_ih": "bias_ih",
                 "bias_hh": "bias_hh"}
        out = {}
        for key, value in weights.items():
            m = re.search(r"lstm\.(weight_ih|weight_hh|bias_ih|bias_hh)_l(\d+)", key)
            if m:
                out[f"lstm.{int(m.group(2))}.{remap[m.group(1)]}"] = value
            elif not key.startswith("similarity_"):
                out[key] = value
        return out
