from .indextts import (BigVGANConditioning, ConformerArgs, ECPATDNN, GPTConfig, Model, ModelArgs,
                       PerceiverResampler, log_mel_spectrogram)

__all__ = ["BigVGANConditioning", "ConformerArgs", "ECPATDNN", "GPTConfig", "Model",
           "ModelArgs", "PerceiverResampler", "log_mel_spectrogram"]
