"""The ctypes table of the port's kernel library against its C sources.

`mlx_audio_tpu_torch/ops/cuda/_build.py` declares, for each `extern "C"`
function of `mlx_audio_tpu_torch/csrc/*.cu`, the types ctypes passes its
arguments as. A pointer declared as an int, or a dropped argument, shifts or
cuts every argument after it, and nothing but a run on the card would show
it. These tests read the declarations from the sources (no nvcc needed) and
hold the table to them: names, argument counts and the kind of each
argument.
"""

from __future__ import annotations

import ctypes
import re
from pathlib import Path

import pytest

from mlx_audio_tpu_torch.ops.cuda import _build

CSRC = Path(_build.__file__).resolve().parents[2] / "csrc"
_DECL = re.compile(r'extern\s+"C"\s+([^(]*?)\s*\b(\w+)\s*\(([^)]*)\)\s*\{', re.S)


def _kind(decl: str) -> str:
    """The ctypes kind a C parameter or return type needs."""
    decl = " ".join(decl.split())
    if "*" in decl:
        return "char_p" if re.match(r"(const )?char\s*\*", decl) else "pointer"
    words = decl.split()
    if words[:2] == ["long", "long"]:
        return "longlong"
    if words[0] in ("int", "float"):
        return words[0]
    raise ValueError(f"no ctypes kind for C type {decl!r}")


def c_declarations() -> dict:
    """name -> (return kind, [parameter kinds]) of every extern "C" function."""
    out = {}
    for src in sorted(CSRC.glob("*.cu")):
        for ret, name, params in _DECL.findall(src.read_text()):
            # a parameter is its type and then its name: drop the name
            kinds = [_kind(re.sub(r"\w+\s*$", "", p)) for p in params.split(",") if p.strip()]
            out[name] = (_kind(ret), kinds)
    return out


_CTYPES_KIND = {ctypes.c_void_p: "pointer", ctypes.c_int: "int", ctypes.c_longlong: "longlong",
                ctypes.c_float: "float", ctypes.c_char_p: "char_p"}


def mismatches(table: dict, decls: dict) -> list:
    """What differs between a ctypes table and the C declarations."""
    bad = [f"{name}: in the sources, not in the table" for name in decls if name not in table]
    bad += [f"{name}: in the table, not in the sources" for name in table if name not in decls]
    for name in sorted(set(table) & set(decls)):
        restype, argtypes = table[name]
        ret, kinds = decls[name]
        got = [_CTYPES_KIND.get(t, repr(t)) for t in argtypes]
        if _CTYPES_KIND.get(restype, repr(restype)) != ret:
            bad.append(f"{name}: returns {ret}, the table says {restype}")
        if got != kinds:
            bad.append(f"{name}: parameters {kinds}, the table says {got}")
    return bad


DECLS = c_declarations()
NAMES = sorted(_build.SIGNATURES)


def test_every_c_function_is_in_the_table():
    assert sorted(DECLS) == NAMES


@pytest.mark.parametrize("name", NAMES)
def test_table_matches_c_declaration(name):
    assert mismatches({name: _build.SIGNATURES[name]}, {name: DECLS[name]}) == []


@pytest.mark.parametrize("name", NAMES)
def test_dropped_argtype_is_caught(name):
    restype, argtypes = _build.SIGNATURES[name]
    table = {**_build.SIGNATURES, name: (restype, argtypes[:-1])}
    assert mismatches(table, DECLS) == [
        f"{name}: parameters {DECLS[name][1]}, the table says "
        f"{[_CTYPES_KIND[t] for t in argtypes[:-1]]}"]


def test_pointer_typed_as_int_is_caught():
    restype, argtypes = _build.SIGNATURES["qmlp_fwd"]
    table = {**_build.SIGNATURES, "qmlp_fwd": (restype, [ctypes.c_int] + argtypes[1:])}
    assert len(mismatches(table, DECLS)) == 1


def test_declarations_are_parsed():
    # the parser sees the known interface, pointers and 64-bit strides included
    ret, kinds = DECLS["flash_attention_fwd"]
    assert ret == "int" and kinds[:4] == ["pointer"] * 4 and kinds.count("longlong") == 12
    assert DECLS["cuda_error_string"] == ("char_p", ["int"])
