"""The port's `profiling` module on the CPU: the JAX package's four cases
(tests/test_profiling.py), and the trace naming the annotated span."""

import json

import numpy as np
import torch

from mlx_audio_tpu import profiling as jprof
from mlx_audio_tpu_torch import profiling
from mlx_audio_tpu_torch.tts.models.base import GenerationResult


def test_peak_memory_gb_no_crash():
    gb = profiling.peak_memory_gb()
    assert isinstance(gb, float) and gb >= 0.0
    assert gb == 0.0 == jprof.peak_memory_gb()  # no stats on the host, in both packages


def test_memory_stats_dict():
    assert profiling.memory_stats() == {} == jprof.memory_stats()
    assert profiling.memory_stats("cpu") == {}


def test_trace_capture(tmp_path):
    log_dir = tmp_path / "trace"
    with profiling.trace(str(log_dir)) as prof:
        with profiling.annotate("matmul"):
            x = torch.ones(64, 64)
            (x @ x).sum().item()
    files = list(log_dir.iterdir())
    assert len(files) == 1 and files[0].suffix == ".json"
    trace = json.loads(files[0].read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "matmul" in names and any("mm" in str(n) for n in names)
    assert any(e.key == "matmul" for e in prof.key_averages())


def test_generation_result_fills_peak_memory(monkeypatch):
    r = GenerationResult(audio=np.zeros(10, np.float32), samples=10, sample_rate=24000)
    assert r.peak_memory_usage == 0.0  # the host: no card, no stats
    r2 = GenerationResult(audio=np.zeros(10, np.float32), samples=10, sample_rate=24000,
                          peak_memory_usage=1.25)
    assert r2.peak_memory_usage == 1.25
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda device=None: 3 * 2**30)
    assert GenerationResult(audio=np.zeros(1, np.float32), samples=1,
                            sample_rate=24000).peak_memory_usage == 3.0
