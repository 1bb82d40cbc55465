"""Profiling and observability (counterpart of `mlx_audio_tpu/profiling.py`).

    with profiling.trace("/tmp/torch-trace"):        # host + card timeline
        model.generate(...)

    with profiling.annotate("decoder"):              # named span
        ...

    gb = profiling.peak_memory_gb()                   # the card's high-water mark

`trace` writes a Chrome trace (open it in Perfetto or chrome://tracing)
where the JAX package writes an XProf one. On the CPU the memory functions
return what the JAX package returns on a backend without stats: `{}` and
0.0.
"""

from __future__ import annotations

import contextlib
import os
import time
from pathlib import Path
from typing import Iterator, Optional, Union

import torch

__all__ = ["trace", "annotate", "peak_memory_gb", "memory_stats"]

Device = Union[None, str, int, torch.device]


@contextlib.contextmanager
def trace(log_dir: Union[str, Path]) -> Iterator[torch.profiler.profile]:
    """Profile the block (CPU activity, and CUDA where there is a card) and
    write it to `log_dir/trace_<pid>_<ns>.json`. Yields the profiler, whose
    `key_averages()` sums the block's time by kernel."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(str(log_dir / f"trace_{os.getpid()}_{time.time_ns()}.json"))


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """A named span inside a `trace()` (`record_function`), and an NVTX range
    on the card for external profilers."""
    with torch.profiler.record_function(name):
        if not torch.cuda.is_available():
            yield
            return
        torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            torch.cuda.nvtx.range_pop()


def _card(device: Device) -> Optional[torch.device]:
    """The CUDA device meant, or None on the host."""
    if not torch.cuda.is_available():
        return None
    dev = torch.device("cuda" if device is None else device)
    return dev if dev.type == "cuda" else None


def memory_stats(device: Device = None) -> dict:
    """The caching allocator's statistics for a card ({} on the CPU)."""
    dev = _card(device)
    return dict(torch.cuda.memory_stats(dev)) if dev is not None else {}


def peak_memory_gb(device: Device = None) -> float:
    """Peak memory allocated on a card in GiB, rounded to 3 places, the JAX
    package's unit (0.0 on the CPU)."""
    dev = _card(device)
    if dev is None:
        return 0.0
    return round(torch.cuda.max_memory_allocated(dev) / 1024**3, 3)
