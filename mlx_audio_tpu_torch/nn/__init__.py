from .layers import (Conv1d, ConvTranspose1d, Embedding, GroupNorm, InstanceNorm, LayerNorm,
                     Linear, RMSNorm)
from .module import cast_floats, load_jax_params
from .recurrent import LSTM, BiLSTM

__all__ = ["BiLSTM", "Conv1d", "ConvTranspose1d", "Embedding", "GroupNorm", "InstanceNorm",
           "LSTM", "LayerNorm", "Linear", "RMSNorm", "cast_floats", "load_jax_params"]
