"""Neural audio codecs (counterpart of `mlx_audio_tpu/codec/models/`): SNAC,
Mimi, DAC, EnCodec, Vocos, BigVGAN, S3TokenizerV2 and S3Gen so far."""

from .bigvgan import BigVGAN
from .descript import DAC
from .encodec import Encodec, EncodecConfig
from .mimi import Mimi, MimiStreamingDecoder
from .s3gen import S3Token2Wav
from .s3tokenizer import S3TokenizerV2
from .snac import SNAC
from .vocos import Vocos

__all__ = ["BigVGAN", "DAC", "Encodec", "EncodecConfig", "Mimi", "MimiStreamingDecoder",
           "S3Token2Wav", "S3TokenizerV2", "SNAC", "Vocos"]
