"""CosyVoice2 configuration (counterpart of
`mlx_audio_tpu/tts/models/cosyvoice2/config.py`, copied)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


@dataclass
class LLMConfig:
    llm_input_size: int = 896
    llm_output_size: int = 896
    speech_token_size: int = 6561
    mix_ratio: List[int] = field(default_factory=lambda: [5, 15])

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
class FlowConfig:
    input_size: int = 512
    output_size: int = 80
    spk_embed_dim: int = 192
    vocab_size: int = 6561
    input_frame_rate: int = 25
    token_mel_ratio: int = 2
    pre_lookahead_len: int = 3
    n_timesteps: int = 10

    encoder_output_size: int = 512
    encoder_attention_heads: int = 8
    encoder_linear_units: int = 2048
    encoder_num_blocks: int = 6
    encoder_num_up_blocks: int = 4
    encoder_static_chunk_size: int = 25
    encoder_upsample_stride: int = 2

    decoder_in_channels: int = 320
    decoder_out_channel: int = 80
    decoder_channels: List[int] = field(default_factory=lambda: [256])
    decoder_attention_head_dim: int = 64
    decoder_n_blocks: int = 4
    decoder_num_mid_blocks: int = 12
    decoder_num_heads: int = 8
    decoder_static_chunk_size: int = 50
    decoder_num_decoding_left_chunks: int = -1

    cfm_in_channels: int = 240
    cfm_sigma_min: float = 1e-6
    cfm_t_scheduler: str = "cosine"
    cfm_inference_cfg_rate: float = 0.7


@dataclass
class HiFiGANConfig:
    in_channels: int = 80
    base_channels: int = 512
    nb_harmonics: int = 8
    sampling_rate: int = 24000
    nsf_alpha: float = 0.1
    nsf_sigma: float = 0.003
    nsf_voiced_threshold: float = 10.0
    upsample_rates: List[int] = field(default_factory=lambda: [8, 5, 3])
    upsample_kernel_sizes: List[int] = field(default_factory=lambda: [16, 11, 7])
    istft_n_fft: int = 16
    istft_hop_len: int = 4
    resblock_kernel_sizes: List[int] = field(default_factory=lambda: [3, 7, 11])
    resblock_dilation_sizes: List[List[int]] = field(
        default_factory=lambda: [[1, 3, 5]] * 3)
    source_resblock_kernel_sizes: List[int] = field(
        default_factory=lambda: [7, 7, 11])
    source_resblock_dilation_sizes: List[List[int]] = field(
        default_factory=lambda: [[1, 3, 5]] * 3)
    use_interpolation: bool = True


@dataclass
class CosyVoice2Config:
    llm: LLMConfig = field(default_factory=LLMConfig)
    flow: FlowConfig = field(default_factory=FlowConfig)
    hifigan: HiFiGANConfig = field(default_factory=HiFiGANConfig)

    default_sampling: int = 25
    max_token_text_ratio: float = 20.0
    min_token_text_ratio: float = 2.0

    @classmethod
    def from_dict(cls, config: Dict[str, Any]) -> "CosyVoice2Config":
        llm = LLMConfig(**{k: v for k, v in config.get("llm", {}).items()
                           if k in LLMConfig.__dataclass_fields__})
        flow_dict = config.get("flow", {})
        flow_kwargs = {}
        for k, v in flow_dict.items():
            if k == "encoder" and isinstance(v, dict):
                for ek, ev in v.items():
                    flow_kwargs[f"encoder_{ek}"] = ev
            elif k == "decoder" and isinstance(v, dict):
                for dk, dv in v.items():
                    key = ("decoder_out_channel" if dk == "out_channels"
                           else f"decoder_{dk}")
                    flow_kwargs[key] = dv
            else:
                flow_kwargs[k] = v
        flow = FlowConfig(**{k: v for k, v in flow_kwargs.items()
                             if k in FlowConfig.__dataclass_fields__})
        hifi_dict = config.get("hifigan", config.get("hift", {}))
        hifigan = HiFiGANConfig(**{k: v for k, v in hifi_dict.items()
                                   if k in HiFiGANConfig.__dataclass_fields__})
        return cls(llm=llm, flow=flow, hifigan=hifigan)


@dataclass
class ModelConfig:
    model_type: str = "cosyvoice2"
    sample_rate: int = 24000
    model_path: Optional[str] = None
    cosyvoice2: Optional[CosyVoice2Config] = None

    @classmethod
    def from_dict(cls, config: Dict[str, Any]) -> "ModelConfig":
        inner = None
        if "llm" in config or "flow" in config:
            inner = CosyVoice2Config.from_dict(config)
        return cls(
            model_type=config.get("model_type", "cosyvoice2"),
            sample_rate=config.get("sample_rate", 24000),
            model_path=config.get("model_path"),
            cosyvoice2=inner,
        )
