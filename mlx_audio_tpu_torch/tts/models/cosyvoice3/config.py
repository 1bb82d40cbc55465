"""CosyVoice3 configuration (counterpart of
`mlx_audio_tpu/tts/models/cosyvoice3/config.py`, copied)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple


@dataclass
class LLMConfig:
    """Qwen2 LM config (reference config.py:13-31)."""

    llm_input_size: int = 896
    llm_output_size: int = 896
    speech_token_size: int = 6561
    extended_vocab_size: int = 200
    mix_ratio: Tuple[int, int] = (5, 15)

    hidden_size: int = 896
    num_hidden_layers: int = 24
    intermediate_size: int = 4864
    num_attention_heads: int = 14
    num_key_value_heads: int = 2
    rms_norm_eps: float = 1e-6
    vocab_size: int = 151936
    rope_theta: float = 1000000.0
    tie_word_embeddings: bool = True


@dataclass
class DiTConfig:
    """Diffusion Transformer config (reference config.py:34-50)."""

    dim: int = 1024
    depth: int = 22
    heads: int = 16
    dim_head: int = 64
    ff_mult: int = 2
    mel_dim: int = 80
    mu_dim: int = 80
    spk_dim: int = 80
    out_channels: int = 80
    static_chunk_size: int = 50
    long_skip_connection: bool = False


@dataclass
class FlowConfig:
    """Flow-matching config (reference config.py:53-79)."""

    input_size: int = 80
    output_size: int = 80
    spk_embed_dim: int = 192
    vocab_size: int = 6561
    input_frame_rate: int = 25
    token_mel_ratio: int = 2
    pre_lookahead_len: int = 3
    n_timesteps: int = 10
    pre_lookahead_channels: int = 1024
    dit: DiTConfig = field(default_factory=DiTConfig)
    cfm_sigma_min: float = 1e-6
    cfm_t_scheduler: str = "cosine"
    cfm_inference_cfg_rate: float = 0.7


@dataclass
class HiFiGANConfig:
    """Causal HiFT vocoder config, 24 kHz (reference config.py:82-107)."""

    in_channels: int = 80
    base_channels: int = 512
    nb_harmonics: int = 8
    sampling_rate: int = 24000
    nsf_alpha: float = 0.1
    nsf_sigma: float = 0.003
    nsf_voiced_threshold: float = 10.0
    upsample_rates: Tuple[int, ...] = (8, 5, 3)
    upsample_kernel_sizes: Tuple[int, ...] = (16, 11, 7)
    istft_n_fft: int = 16
    istft_hop_len: int = 4
    resblock_kernel_sizes: Tuple[int, ...] = (3, 7, 11)
    resblock_dilation_sizes: Tuple[Tuple[int, ...], ...] = (
        (1, 3, 5), (1, 3, 5), (1, 3, 5))
    # one source-fusion block per upsample stage. (The reference default
    # lists only two entries for three stages — config.py:101-105 — which
    # its own decode loop would index past; checkpoints supply all three.)
    source_resblock_kernel_sizes: Tuple[int, ...] = (7, 7, 11)
    source_resblock_dilation_sizes: Tuple[Tuple[int, ...], ...] = (
        (1, 3, 5), (1, 3, 5), (1, 3, 5))
    conv_pre_look_right: int = 4


@dataclass
class CosyVoice3Config:
    """Full model config (reference config.py:110-163)."""

    llm: LLMConfig = field(default_factory=LLMConfig)
    flow: FlowConfig = field(default_factory=FlowConfig)
    hifigan: HiFiGANConfig = field(default_factory=HiFiGANConfig)

    default_sampling: int = 25
    max_token_text_ratio: float = 20.0
    min_token_text_ratio: float = 2.0


@dataclass
class ModelConfig:
    """generate()-API config (reference config.py:166-177)."""

    model_type: str = "cosyvoice3"
    sample_rate: int = 24000
    model_path: Optional[str] = None
    cosyvoice3: Optional[CosyVoice3Config] = None

    @classmethod
    def from_dict(cls, config: Dict[str, Any]) -> "ModelConfig":
        return cls(
            model_type=config.get("model_type", "cosyvoice3"),
            sample_rate=config.get("sample_rate", 24000),
            model_path=config.get("model_path"),
        )
