from .layers import Conv1d, Embedding, LayerNorm, Linear
from .module import cast_floats, load_jax_params

__all__ = ["Conv1d", "Embedding", "LayerNorm", "Linear", "cast_floats",
           "load_jax_params"]
