from .batcher import TurboBatcher
from .chatterbox_turbo import (GPT2_MEDIUM_CONFIG, Model, ModelConfig, T3Turbo, T3TurboConfig,
                               build_turbo_s3gen, sample_rows)

__all__ = ["GPT2_MEDIUM_CONFIG", "Model", "ModelConfig", "T3Turbo", "T3TurboConfig",
           "TurboBatcher", "build_turbo_s3gen", "sample_rows"]
