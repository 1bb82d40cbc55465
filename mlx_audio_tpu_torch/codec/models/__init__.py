"""Neural audio codecs (counterpart of `mlx_audio_tpu/codec/models/`): SNAC
so far."""

from .snac import SNAC

__all__ = ["SNAC"]
