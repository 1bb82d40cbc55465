"""Dia configuration (a host copy of `mlx_audio_tpu/tts/models/dia/config.py`):
Dia-1.6B's published widths by default."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

from ....utils import from_dict

__all__ = ["DiaConfig", "DataConfig", "EncoderConfig", "DecoderConfig", "DiaModelConfig"]


@dataclass
class DataConfig:
    text_length: int = 1024
    audio_length: int = 3072
    channels: int = 9
    text_pad_value: int = 0
    audio_eos_value: int = 1024
    audio_pad_value: int = 1025
    audio_bos_value: int = 1026
    delay_pattern: List[int] = field(
        default_factory=lambda: [0, 8, 9, 10, 11, 12, 13, 14, 15]
    )

    def __post_init__(self):
        self.text_length = (self.text_length + 127) // 128 * 128
        self.audio_length = (self.audio_length + 127) // 128 * 128


@dataclass
class EncoderConfig:
    n_layer: int = 12
    n_embd: int = 1024
    n_hidden: int = 4096
    n_head: int = 16
    head_dim: int = 128


@dataclass
class DecoderConfig:
    n_layer: int = 18
    n_embd: int = 2048
    n_hidden: int = 8192
    gqa_query_heads: int = 16
    kv_heads: int = 4
    gqa_head_dim: int = 128
    cross_query_heads: int = 16
    cross_head_dim: int = 128


@dataclass
class DiaModelConfig:
    encoder: EncoderConfig = field(default_factory=EncoderConfig)
    decoder: DecoderConfig = field(default_factory=DecoderConfig)
    src_vocab_size: int = 128
    tgt_vocab_size: int = 1028
    dropout: float = 0.0
    normalization_layer_epsilon: float = 1e-5
    rope_min_timescale: int = 1
    rope_max_timescale: int = 10_000
    sample_rate: int = 44100


@dataclass
class DiaConfig:
    model: DiaModelConfig = field(default_factory=DiaModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    version: str = "1.0"

    @classmethod
    def load_dict(cls, config: dict) -> "DiaConfig":
        if isinstance(config, cls):
            return config
        cfg = from_dict(cls, {k: v for k, v in config.items() if k != "training"})
        if cfg.model is None:
            cfg.model = DiaModelConfig()
        if cfg.data is None:
            cfg.data = DataConfig()
        return cfg
