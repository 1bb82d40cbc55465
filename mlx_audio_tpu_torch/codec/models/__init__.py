"""Neural audio codecs (counterpart of `mlx_audio_tpu/codec/models/`): SNAC,
Mimi, DAC and EnCodec so far."""

from .descript import DAC
from .encodec import Encodec, EncodecConfig
from .mimi import Mimi, MimiStreamingDecoder
from .snac import SNAC

__all__ = ["DAC", "Encodec", "EncodecConfig", "Mimi", "MimiStreamingDecoder", "SNAC"]
