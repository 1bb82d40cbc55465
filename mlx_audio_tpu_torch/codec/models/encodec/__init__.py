from .encodec import Encodec, EncodecConfig

__all__ = ["Encodec", "EncodecConfig"]
