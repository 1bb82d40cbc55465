"""Neural audio codecs (counterpart of `mlx_audio_tpu/codec/models/`): SNAC
and Mimi so far."""

from .mimi import Mimi, MimiStreamingDecoder
from .snac import SNAC

__all__ = ["Mimi", "MimiStreamingDecoder", "SNAC"]
