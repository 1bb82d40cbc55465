"""Device resolution shared by the port's entry points."""

from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device", "pinned", "thread_setup"]


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """`None` means the card. A CUDA device without a visible GPU raises:
    the port never carries on quietly on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "a CUDA device was requested (the default) but "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "the plain PyTorch path on the host"
        )
    return dev


def pinned(device) -> Optional[torch.device]:
    """The model's device with its index: a bare "cuda" means the device
    current on the thread that builds the batcher."""
    if device is None:
        return None
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def thread_setup(device: Optional[torch.device]) -> None:
    """A worker thread's own device setup: the current CUDA device is per
    thread, and the kernels launch on the current device's stream."""
    if device is not None and device.type == "cuda":
        torch.cuda.set_device(device)
