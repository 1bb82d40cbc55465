from .layers import (Conv1d, ConvTranspose1d, Embedding, GroupNorm, LayerNorm, Linear,
                     RMSNorm)
from .module import cast_floats, load_jax_params

__all__ = ["Conv1d", "ConvTranspose1d", "Embedding", "GroupNorm", "LayerNorm", "Linear",
           "RMSNorm", "cast_floats", "load_jax_params"]
