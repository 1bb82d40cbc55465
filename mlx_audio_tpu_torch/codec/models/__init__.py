"""Neural audio codecs (counterpart of `mlx_audio_tpu/codec/models/`): SNAC,
Mimi, DAC, EnCodec, Vocos and BigVGAN so far."""

from .bigvgan import BigVGAN
from .descript import DAC
from .encodec import Encodec, EncodecConfig
from .mimi import Mimi, MimiStreamingDecoder
from .snac import SNAC
from .vocos import Vocos

__all__ = ["BigVGAN", "DAC", "Encodec", "EncodecConfig", "Mimi", "MimiStreamingDecoder", "SNAC",
           "Vocos"]
