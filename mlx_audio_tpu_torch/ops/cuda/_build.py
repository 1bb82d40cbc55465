"""Build the port's CUDA sources with nvcc into a shared library with a
plain C interface and load it with ctypes.

The library is built at first use into `build_dir()`, named by a hash of
the sources and flags, so an unchanged tree reuses it. Each source compiles
in its own nvcc process, all started together, and one more links the
objects. A failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

__all__ = ["load_library", "build_dir", "last_build", "error_string", "SIGNATURES"]

_PKG = Path(__file__).resolve().parents[2]
_SOURCES = [_PKG / "csrc" / name
            for name in ("flash_attention.cu", "quant_matmul.cu", "relu2_attention.cu")]
_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
          "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIB: Optional[ctypes.CDLL] = None
# what the last build in this process did: seconds, path, ptxas report
last_build: dict = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float

# The C interface of csrc/*.cu: name -> (restype, argtypes). ctypes passes
# an argument by the type given here, so a pointer typed as an int would be
# cut to 32 bits; tests/test_torch_kernel_abi.py holds this table to the
# `extern "C"` declarations in the sources.
SIGNATURES = {
    "flash_attention_fwd": (_I, [_P, _P, _P, _P] + [_I] * 5 + [_L] * 12 + [_F, _I, _I, _P]),
    "qmm_fwd": (_I, [_P] * 5 + [_I] * 6 + [_L, _I, _P, _P]),
    "qmlp_fwd": (_I, [_P] * 10 + [_I] * 8 + [_L, _P]),
    "relu2_attention_fwd": (_I, [_P] * 5 + [_I] * 5 + [_L] * 12 + [_F, _I, _P]),
    "cuda_error_string": (ctypes.c_char_p, [_I]),
}


def build_dir() -> Path:
    """`build/kernels/` in a checkout; for an installed package, whose
    site-packages may be shared or read-only, the user's cache directory."""
    root = _PKG.parent
    if (root / "pyproject.toml").is_file():
        return root / "build" / "kernels"
    cache = os.environ.get("XDG_CACHE_HOME") or Path.home() / ".cache"
    return Path(cache) / "mlx_audio_tpu_torch" / "kernels"


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return found


def _build() -> Path:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for src in _SOURCES:
        h.update(src.read_bytes())
    out = build_dir() / f"libmlx_audio_kernels_{h.hexdigest()[:16]}.so"
    if out.exists():
        last_build.update(seconds=0.0, path=str(out), cached=True, log="")
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    objs = [out.with_name(f"{out.stem}.{src.stem}.{os.getpid()}.o") for src in _SOURCES]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([nvcc, *_FLAGS, "-c", "-o", str(obj), str(src)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(_SOURCES, objs)]
    logs = [proc.communicate()[0] for proc in procs]  # waits for every process
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        for src, proc, log in zip(_SOURCES, procs, logs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}) on {src.name}:\n{log}")
        link = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
        res = subprocess.run(link, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}): {' '.join(link)}\n"
                               f"{res.stdout}\n{res.stderr}")
        os.replace(tmp, out)
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    last_build.update(seconds=time.perf_counter() - t0, path=str(out), cached=False,
                      log="".join(logs))
    return out


# one build, and exact launch counts, when several threads launch (a
# serving batcher's worker beside its callers)
_LOCK = threading.Lock()


def load_library() -> ctypes.CDLL:
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(_build()))
            for name, (restype, argtypes) in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype, fn.argtypes = restype, argtypes
            _LIB = lib
    return _LIB


def count_launch(fn, kernel: Optional[str] = None, shape=None) -> None:
    """Add one to a wrapper's launch count (and to `fn.kernels[kernel]`, and
    to `fn.shapes[shape]`), under a lock: `+=` on an attribute is not
    atomic across threads."""
    with _LOCK:
        fn.launches += 1
        if kernel is not None:
            fn.kernels[kernel] += 1
        if shape is not None:
            fn.shapes[shape] = fn.shapes.get(shape, 0) + 1


def error_string(err: int) -> str:
    return f"{err} ({load_library().cuda_error_string(err).decode()})"
