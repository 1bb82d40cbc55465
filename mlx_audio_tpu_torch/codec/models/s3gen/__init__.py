from .decoder import ConditionalDecoder
from .encoder import UpsampleConformerEncoder
from .flow import CausalMaskedDiffWithXvec
from .flow_matching import CFMParams, ConditionalCFM
from .hifigan import ConvRNNF0Predictor, HiFTGenerator, ResBlock, SineGen, Snake, SourceModuleHnNSF
from .mel import mel_spectrogram
from .s3gen import S3_SR, S3GEN_SR, CausalConditionalCFM, S3Token2Mel, S3Token2Wav
from .xvector import CAMPPlus, kaldi_fbank

__all__ = ["CAMPPlus", "CFMParams", "CausalConditionalCFM", "CausalMaskedDiffWithXvec",
           "ConditionalCFM", "ConditionalDecoder", "ConvRNNF0Predictor", "HiFTGenerator",
           "ResBlock", "S3GEN_SR", "S3_SR", "S3Token2Mel", "S3Token2Wav", "SineGen", "Snake",
           "SourceModuleHnNSF", "UpsampleConformerEncoder", "kaldi_fbank", "mel_spectrogram"]
