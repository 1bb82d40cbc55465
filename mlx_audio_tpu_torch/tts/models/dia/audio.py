"""Dia's delay-pattern codebook transforms (counterpart of
`mlx_audio_tpu/tts/models/dia/audio.py`): vectorised gathers over (B, T, C)
int tensors."""

from __future__ import annotations

from typing import List

import numpy as np
import torch

__all__ = ["apply_audio_delay", "revert_audio_delay", "audio_to_codebook",
           "codebook_to_audio"]


def _shifted(codes: torch.Tensor, t_idx: torch.Tensor) -> torch.Tensor:
    """codes (B, T, C) gathered at rows t_idx (T, C), clipped into range."""
    B, T, C = codes.shape
    gather_t = t_idx.clamp(0, T - 1)
    return torch.gather(codes, 1, gather_t[None].expand(B, T, C))


def apply_audio_delay(codes, delay_pattern: List[int], bos_value: int, pad_value: int):
    """codes (B, T, C) → delayed: out[t, c] = in[t - delay[c], c]; positions
    before the start become BOS, beyond the end PAD."""
    codes = torch.as_tensor(codes)
    B, T, C = codes.shape
    delay = torch.as_tensor(delay_pattern, device=codes.device)
    t_idx = torch.arange(T, device=codes.device)[:, None] - delay[None, :]
    out = _shifted(codes, t_idx)
    out = torch.where(t_idx[None] < 0, bos_value, out)
    return torch.where(t_idx[None] >= T, pad_value, out)


def revert_audio_delay(codes, delay_pattern: List[int], pad_value: int, total_len: int):
    """The inverse: out[t, c] = in[t + delay[c], c] (PAD beyond total_len)."""
    codes = torch.as_tensor(codes)
    B, T, C = codes.shape
    delay = torch.as_tensor(delay_pattern, device=codes.device)
    t_idx = torch.arange(T, device=codes.device)[:, None] + delay[None, :]
    out = _shifted(codes, t_idx)
    return torch.where(t_idx[None] >= total_len, pad_value, out)


def audio_to_codebook(dac_model, audio, data_config):
    """Audio (B, 1, T) → DAC codes, delayed, (B, T', C)."""
    _, codes, _, _, _ = dac_model.encode(audio)
    return apply_audio_delay(torch.as_tensor(codes).transpose(1, 2).long(),
                             data_config.delay_pattern, data_config.audio_bos_value,
                             data_config.audio_pad_value)


def codebook_to_audio(codes_TxC, dac_model, delay_pattern, B=1, T=None, C=9) -> np.ndarray:
    """Generated frames (T, C) → the delays reverted, the trailing max-delay
    rows dropped, codes clipped to 0..1023, DAC-decoded → samples (N,)."""
    codes = torch.as_tensor(np.asarray(codes_TxC)).long()[None]  # (1, T, C)
    total = codes.shape[1]
    reverted = revert_audio_delay(codes, delay_pattern, 0, total)
    max_delay = max(delay_pattern)
    if total > max_delay:
        reverted = reverted[:, : total - max_delay]
    reverted = reverted.clamp(0, 1023)
    wav = dac_model.decode_codes(reverted.transpose(1, 2))  # (1, 1, N)
    return torch.as_tensor(wav).float().cpu().numpy().reshape(-1)
