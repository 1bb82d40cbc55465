"""Qwen3-TTS configuration (counterpart of
`mlx_audio_tpu/tts/models/qwen3_tts/config.py`; the defaults are the 0.6B
model's published widths)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ....base import BaseModelArgs


@dataclass
class Qwen3TTSSpeakerEncoderConfig(BaseModelArgs):
    mel_dim: int = 128
    enc_dim: int = 1024
    enc_channels: List[int] = field(default_factory=lambda: [512, 512, 512, 512, 1536])
    enc_kernel_sizes: List[int] = field(default_factory=lambda: [5, 3, 3, 3, 1])
    enc_dilations: List[int] = field(default_factory=lambda: [1, 2, 3, 4, 1])
    enc_attention_channels: int = 128
    enc_res2net_scale: int = 8
    enc_se_channels: int = 128
    sample_rate: int = 24000


@dataclass
class Qwen3TTSTalkerCodePredictorConfig(BaseModelArgs):
    vocab_size: int = 2048
    hidden_size: int = 1024
    intermediate_size: int = 3072
    num_hidden_layers: int = 5
    num_attention_heads: int = 16
    num_key_value_heads: int = 8
    head_dim: int = 128
    max_position_embeddings: int = 65536
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1000000.0
    attention_bias: bool = False
    num_code_groups: int = 16


@dataclass
class Qwen3TTSTalkerConfig(BaseModelArgs):
    vocab_size: int = 3072
    hidden_size: int = 1024
    intermediate_size: int = 3072
    num_hidden_layers: int = 28
    num_attention_heads: int = 16
    num_key_value_heads: int = 8
    head_dim: int = 128
    max_position_embeddings: int = 32768
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1000000.0
    rope_scaling: Optional[dict] = None
    attention_bias: bool = False
    num_code_groups: int = 16
    text_hidden_size: int = 2048
    text_vocab_size: int = 151936
    codec_eos_token_id: int = 2150
    codec_think_id: int = 2154
    codec_nothink_id: int = 2155
    codec_think_bos_id: int = 2156
    codec_think_eos_id: int = 2157
    codec_pad_id: int = 2148
    codec_bos_id: int = 2149
    spk_id: Optional[Dict[str, int]] = None
    spk_is_dialect: Optional[Dict[str, str]] = None
    codec_language_id: Optional[Dict[str, int]] = None
    code_predictor_config: Qwen3TTSTalkerCodePredictorConfig = None

    def __post_init__(self):
        if self.code_predictor_config is None:
            self.code_predictor_config = Qwen3TTSTalkerCodePredictorConfig()
        elif isinstance(self.code_predictor_config, dict):
            self.code_predictor_config = Qwen3TTSTalkerCodePredictorConfig.from_dict(
                self.code_predictor_config
            )


@dataclass
class Qwen3TTSTokenizerDecoderConfig(BaseModelArgs):
    attention_bias: bool = False
    latent_dim: int = 1024
    codebook_dim: int = 512
    codebook_size: int = 2048
    decoder_dim: int = 1536
    hidden_size: int = 512
    intermediate_size: int = 1024
    layer_scale_initial_scale: float = 0.01
    max_position_embeddings: int = 8000
    head_dim: int = 64
    num_attention_heads: int = 16
    num_hidden_layers: int = 8
    num_key_value_heads: int = 16
    num_quantizers: int = 16
    num_semantic_quantizers: int = 1
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    semantic_codebook_size: int = 4096
    sliding_window: int = 72
    upsample_rates: List[int] = field(default_factory=lambda: [8, 5, 4, 3])
    upsampling_ratios: List[int] = field(default_factory=lambda: [2, 2])


@dataclass
class Qwen3TTSTokenizerEncoderConfig(BaseModelArgs):
    frame_rate: float = 12.5
    audio_channels: int = 1
    codebook_dim: int = 256
    codebook_size: int = 2048
    compress: int = 2
    dilation_growth_rate: int = 2
    head_dim: int = 64
    hidden_size: int = 512
    intermediate_size: int = 2048
    kernel_size: int = 7
    last_kernel_size: int = 3
    layer_scale_initial_scale: float = 0.01
    max_position_embeddings: int = 8000
    num_attention_heads: int = 8
    num_filters: int = 64
    num_hidden_layers: int = 8
    num_key_value_heads: int = 8
    num_quantizers: int = 32
    num_residual_layers: int = 1
    residual_kernel_size: int = 3
    rope_theta: float = 10000.0
    sampling_rate: int = 24000
    sliding_window: int = 250
    upsampling_ratios: List[int] = field(default_factory=lambda: [8, 6, 5, 4])
    use_causal_conv: bool = True
    use_conv_shortcut: bool = False


@dataclass
class Qwen3TTSTokenizerConfig(BaseModelArgs):
    encoder_config: Qwen3TTSTokenizerEncoderConfig = None
    decoder_config: Qwen3TTSTokenizerDecoderConfig = None

    def __post_init__(self):
        if isinstance(self.encoder_config, dict):
            self.encoder_config = Qwen3TTSTokenizerEncoderConfig.from_dict(
                self.encoder_config
            )
        if self.encoder_config is None:
            self.encoder_config = Qwen3TTSTokenizerEncoderConfig()
        if isinstance(self.decoder_config, dict):
            self.decoder_config = Qwen3TTSTokenizerDecoderConfig.from_dict(
                self.decoder_config
            )
        if self.decoder_config is None:
            self.decoder_config = Qwen3TTSTokenizerDecoderConfig()


@dataclass
class ModelConfig(BaseModelArgs):
    model_type: str = "qwen3_tts"
    talker_config: Qwen3TTSTalkerConfig = None
    speaker_encoder_config: Qwen3TTSSpeakerEncoderConfig = None
    tokenizer_config: Qwen3TTSTokenizerConfig = None
    tokenizer_type: str = "qwen3_tts_tokenizer_12hz"
    tts_model_size: str = "0b6"
    tts_model_type: str = "base"
    im_start_token_id: int = 151644
    im_end_token_id: int = 151645
    tts_pad_token_id: int = 151671
    tts_bos_token_id: int = 151672
    tts_eos_token_id: int = 151673
    sample_rate: int = 24000
    model_path: str = ""

    def __post_init__(self):
        if isinstance(self.talker_config, dict):
            self.talker_config = Qwen3TTSTalkerConfig.from_dict(self.talker_config)
        if self.talker_config is None:
            self.talker_config = Qwen3TTSTalkerConfig()
        if isinstance(self.speaker_encoder_config, dict):
            self.speaker_encoder_config = Qwen3TTSSpeakerEncoderConfig.from_dict(
                self.speaker_encoder_config
            )
        if isinstance(self.tokenizer_config, dict):
            self.tokenizer_config = Qwen3TTSTokenizerConfig.from_dict(
                self.tokenizer_config
            )
        if self.tokenizer_config is None:
            self.tokenizer_config = Qwen3TTSTokenizerConfig()
