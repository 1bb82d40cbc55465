"""Neural audio codecs (counterpart of `mlx_audio_tpu/codec/models/`): SNAC,
Mimi and DAC so far."""

from .descript import DAC
from .mimi import Mimi, MimiStreamingDecoder
from .snac import SNAC

__all__ = ["DAC", "Mimi", "MimiStreamingDecoder", "SNAC"]
