from .layers import (BatchNorm, Conv1d, Conv2d, ConvTranspose1d, Embedding, GroupNorm,
                     InstanceNorm, LayerNorm, Linear, RMSNorm)
from .module import cast_floats, flatten_params, load_jax_params, load_weights
from .recurrent import LSTM, BiLSTM

__all__ = ["BatchNorm", "BiLSTM", "Conv1d", "Conv2d", "ConvTranspose1d", "Embedding",
           "GroupNorm", "InstanceNorm", "LSTM", "LayerNorm", "Linear", "RMSNorm", "cast_floats",
           "flatten_params", "load_jax_params", "load_weights"]
