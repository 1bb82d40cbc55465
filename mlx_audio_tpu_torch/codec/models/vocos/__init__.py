from .vocos import (AdaLayerNorm, ConvNeXtBlock, EncodecFeatures, ISTFTHead,
                    MelSpectrogramFeatures, Vocos, VocosBackbone)

__all__ = ["AdaLayerNorm", "ConvNeXtBlock", "EncodecFeatures", "ISTFTHead",
           "MelSpectrogramFeatures", "Vocos", "VocosBackbone"]
