from .sesame import Model, ModelConfig, Segment, SesameModel

__all__ = ["Model", "ModelConfig", "Segment", "SesameModel"]
