"""Reader and writer of the safetensors format, without the `safetensors`
package (the port's copy of what the JAX package takes from it).

A file is an 8-byte little-endian header length N, N bytes of JSON
(`{"__metadata__": {...}, name: {"dtype", "shape", "data_offsets"}}`,
offsets relative to the end of the header), then the tensors' raw
little-endian bytes. Files are read through a memory map: each array is a
view of the mapped pages, so a large checkpoint is not copied on the host
before it goes to the card.

Arrays come back as numpy arrays, except BF16, which numpy has no dtype
for: it comes back as a `torch.bfloat16` tensor over the same pages. The
writer takes numpy arrays and torch tensors and writes what
`safetensors.numpy.save_file` writes for the same tensors, byte for byte
(tensors ordered by dtype, then name; the header padded with spaces to a
multiple of 8).
"""

from __future__ import annotations

import json
import mmap
import struct
from pathlib import Path
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

__all__ = ["load_file", "load_sharded", "save_file", "INDEX_NAME"]

INDEX_NAME = "model.safetensors.index.json"

# the format's dtype names → numpy dtypes (little-endian); BF16 is torch's
_NP_DTYPES = {
    "F64": "<f8", "F32": "<f4", "F16": "<f2", "I64": "<i8", "I32": "<i4", "I16": "<i2",
    "I8": "i1", "U64": "<u8", "U32": "<u4", "U16": "<u2", "U8": "u1", "BOOL": "?",
}
_ITEMSIZE = {"BF16": 2, **{k: np.dtype(v).itemsize for k, v in _NP_DTYPES.items()}}
# the reference writer's order: descending by this rank, then by name
_RANK = {name: i for i, name in enumerate(
    ("BOOL", "U8", "I8", "I16", "U16", "F16", "BF16", "I32", "U32", "F32", "F64", "I64",
     "U64"))}
_TORCH_NAMES = {
    torch.float64: "F64", torch.float32: "F32", torch.float16: "F16",
    torch.bfloat16: "BF16", torch.int64: "I64", torch.int32: "I32", torch.int16: "I16",
    torch.int8: "I8", torch.uint8: "U8", torch.bool: "BOOL",
}
_MAX_HEADER = 100 * 1024 * 1024

Array = Union[np.ndarray, torch.Tensor]


def _malformed(path, why: str) -> ValueError:
    return ValueError(f"{path}: not a valid safetensors file ({why})")


def _parse_header(path, buf) -> Tuple[dict, int]:
    """(tensor entries, data start) of a file whose bytes are `buf`, every
    entry checked against the file's size and the other entries' offsets
    (`__metadata__` is skipped)."""
    file_size = len(buf)
    if file_size < 8:
        raise _malformed(path, f"{file_size} bytes, shorter than the 8-byte header length")
    (n,) = struct.unpack("<Q", buf[:8])
    if n > _MAX_HEADER or 8 + n > file_size:
        raise _malformed(path, f"header length {n} exceeds the file's {file_size} bytes")
    try:
        header = json.loads(bytes(buf[8:8 + n]).decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise _malformed(path, f"header is not JSON: {e}") from None
    if not isinstance(header, dict):
        raise _malformed(path, "header is not a JSON object")
    header.pop("__metadata__", None)
    start, size = 8 + n, file_size - 8 - n
    spans = []
    for name, e in header.items():
        if not isinstance(e, dict) or set(e) != {"dtype", "shape", "data_offsets"}:
            raise _malformed(path, f"entry {name!r} is not dtype/shape/data_offsets")
        if e["dtype"] not in _ITEMSIZE:
            raise _malformed(path, f"entry {name!r} has unsupported dtype {e['dtype']!r}")
        shape, off = e["shape"], e["data_offsets"]
        if not (isinstance(shape, list) and all(isinstance(d, int) and d >= 0 for d in shape)):
            raise _malformed(path, f"entry {name!r} has shape {shape!r}")
        if not (isinstance(off, list) and len(off) == 2
                and all(isinstance(o, int) for o in off) and 0 <= off[0] <= off[1]):
            raise _malformed(path, f"entry {name!r} has data_offsets {off!r}")
        want = int(np.prod(shape, dtype=np.int64)) * _ITEMSIZE[e["dtype"]]
        if off[1] - off[0] != want:
            raise _malformed(path, f"entry {name!r}: {off[1] - off[0]} bytes for "
                                   f"{e['dtype']}{shape} ({want} bytes)")
        if off[1] > size:
            raise _malformed(path, f"entry {name!r} ends at byte {off[1]} of a "
                                   f"{size}-byte data section (file cut short?)")
        spans.append((off[0], off[1], name))
    spans.sort()
    for (b0, e0, n0), (b1, _, n1) in zip(spans, spans[1:]):
        if b1 < e0:
            raise _malformed(path, f"entries {n0!r} and {n1!r} overlap")
    return header, start


def _view(buf, start: int, e: dict) -> Array:
    b0, b1 = e["data_offsets"]
    shape = tuple(e["shape"])
    count = (b1 - b0) // _ITEMSIZE[e["dtype"]]
    if e["dtype"] == "BF16":
        if count == 0:
            return torch.empty(shape, dtype=torch.bfloat16)
        return torch.frombuffer(buf, dtype=torch.bfloat16, count=count,
                                offset=start + b0).reshape(shape)
    return np.frombuffer(buf, dtype=_NP_DTYPES[e["dtype"]], count=count,
                         offset=start + b0).reshape(shape)


def load_file(path: Union[str, Path]) -> Dict[str, Array]:
    """Every tensor of one file, as views of a private memory map of it
    (copy-on-write: writing to an array never reaches the file)."""
    path = Path(path)
    if path.stat().st_size == 0:  # mmap refuses an empty file
        raise _malformed(path, "empty file")
    with open(path, "rb") as f:
        buf = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    header, start = _parse_header(path, buf)
    return {name: _view(buf, start, e) for name, e in header.items()}


def load_sharded(index_path: Union[str, Path]) -> Dict[str, Array]:
    """Every tensor of a sharded checkpoint, through its
    `model.safetensors.index.json` (`weight_map`: tensor → shard file). A
    tensor the index names must be in its shard, and only there."""
    index_path = Path(index_path)
    index = json.loads(index_path.read_text(encoding="utf-8"))
    weight_map = index.get("weight_map")
    if not isinstance(weight_map, dict):
        raise ValueError(f"{index_path}: no weight_map")
    out: Dict[str, Array] = {}
    for shard in sorted(set(weight_map.values())):
        tensors = load_file(index_path.parent / shard)
        for name, t in tensors.items():
            where = weight_map.get(name)
            if where is None:
                raise ValueError(f"{index_path}: {shard} holds {name!r}, which the index "
                                 f"does not name")
            if where != shard:
                raise ValueError(f"{index_path}: {name!r} is in {shard}, the index says "
                                 f"{where}")
            out[name] = t
    missing = sorted(set(weight_map) - set(out))
    if missing:
        raise ValueError(f"{index_path}: tensors missing from their shards: {missing[:10]}")
    return out


def _dtype_name(t: Array) -> str:
    if isinstance(t, torch.Tensor):
        if t.dtype not in _TORCH_NAMES:
            raise ValueError(f"dtype {t.dtype} has no safetensors name")
        return _TORCH_NAMES[t.dtype]
    if t.dtype.name == "bfloat16":  # ml_dtypes' numpy bfloat16
        return "BF16"
    for name, np_dtype in _NP_DTYPES.items():
        if t.dtype == np.dtype(np_dtype):
            return name
    raise ValueError(f"dtype {t.dtype} has no safetensors name")


def _contiguous(t: Array) -> np.ndarray:
    """The tensor's little-endian bytes as a contiguous numpy array (a view
    where the tensor already is one)."""
    if isinstance(t, torch.Tensor):
        t = t.detach().to("cpu").contiguous()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.numpy()
    t = np.ascontiguousarray(t)
    if t.dtype.byteorder == ">":
        t = t.astype(t.dtype.newbyteorder("<"))
    return t


def save_file(tensors: Dict[str, Array], path: Union[str, Path],
              metadata: Optional[Dict[str, str]] = None) -> None:
    """Write `tensors` (numpy arrays or torch tensors) to `path`, one
    tensor's bytes at a time."""
    items = []
    for name, t in tensors.items():
        if not isinstance(t, torch.Tensor):
            t = np.asarray(t)
        items.append((name, _dtype_name(t), t))
    items.sort(key=lambda it: (-_RANK[it[1]], it[0]))
    header: dict = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    offset = 0
    for name, dtype, t in items:
        nbytes = int(np.prod(t.shape, dtype=np.int64)) * _ITEMSIZE[dtype]
        header[name] = {"dtype": dtype, "shape": [int(d) for d in t.shape],
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    head = json.dumps(header, separators=(",", ":"), ensure_ascii=False).encode("utf-8")
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for _, _, t in items:
            f.write(_contiguous(t).reshape(-1).view(np.uint8).data)
