from .soprano import DecoderConfig, Model, ModelConfig, SopranoDecoder

__all__ = ["DecoderConfig", "Model", "ModelConfig", "SopranoDecoder"]
