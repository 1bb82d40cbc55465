"""mlx_audio_tpu_torch — the PyTorch/CUDA port of `mlx_audio_tpu`.

The JAX package stays the reference; this package mirrors its module paths
and class names and runs on an NVIDIA Hopper card (sm_90a). Each TPU Pallas
kernel on a ported path becomes a hand-written CUDA kernel under `csrc/`,
built at first use by `ops.cuda._build` and held against a plain PyTorch
version of the same function.

Entry points run on `cuda` unless the caller passes `device="cpu"`; a CUDA
tensor that meets a kernel's routing guard goes through the kernel or
raises. This package imports neither `jax` nor `mlx_audio_tpu`.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
