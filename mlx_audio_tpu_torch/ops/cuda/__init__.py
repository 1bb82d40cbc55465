"""Hand-written Hopper kernels (sources in `mlx_audio_tpu_torch/csrc/`).

Each wrapper takes its plain PyTorch version for a CPU tensor and launches
its kernel, or raises, for a CUDA tensor. There is no fallback from a
failed build or launch to the plain version.
"""

from .flash_attention import flash_attention, flash_attention_reference
from .quant_matmul import (quantized_matmul, quantized_matmul6,
                           quantized_matmul_reference, quantized_mlp,
                           quantized_mlp_reference)
from .relu2_attention import relu2_attention, relu2_attention_reference

__all__ = ["flash_attention", "flash_attention_reference", "quantized_matmul",
           "quantized_matmul6", "quantized_matmul_reference", "quantized_mlp",
           "quantized_mlp_reference", "relu2_attention", "relu2_attention_reference"]
