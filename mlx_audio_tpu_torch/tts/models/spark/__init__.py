from .spark import (FSQ, BiCodec, FactorizedVectorQuantize, Model, ModelConfig, ResidualFSQ,
                    SpeakerEncoder, WaveGenerator, load_bicodec)

__all__ = ["BiCodec", "FSQ", "FactorizedVectorQuantize", "Model", "ModelConfig",
           "ResidualFSQ", "SpeakerEncoder", "WaveGenerator", "load_bicodec"]
