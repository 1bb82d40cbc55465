"""MossFormer2-SE 48 kHz configuration (counterpart of
`mlx_audio_tpu/sts/models/mossformer2_se/config.py`; the defaults are the
published model's)."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class MossFormer2SEConfig:
    sample_rate: int = 48000
    win_len: int = 1920
    win_inc: int = 384
    fft_len: int = 1920
    win_type: str = "hamming"
    num_mels: int = 60
    preemphasis: float = 0.97
    one_time_decode_length: int = 20
    decode_window: int = 4
    chunk_seconds: float = 4.0
    chunk_overlap: float = 0.25
    auto_chunk_threshold: float = 60.0
    in_channels: int = 180
    out_channels: int = 512
    out_channels_final: int = 961
    num_blocks: int = 24

    @classmethod
    def from_dict(cls, d: dict) -> "MossFormer2SEConfig":
        return cls(**{k: v for k, v in d.items() if k in cls.__dataclass_fields__})

    @property
    def sampling_rate(self) -> int:
        return self.sample_rate
