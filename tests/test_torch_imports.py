"""The port imports neither jax nor anything of the JAX package, at run
time (every module imported in a fresh interpreter) or in its source (a
static scan of every import, chip_smoke.py included)."""

import ast
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "mlx_audio_tpu_torch"


def _modules():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(REPO).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        yield path, ".".join(parts)


def test_import_every_module_without_jax():
    names = [name for _, name in _modules()]
    code = (
        "import importlib, sys\n"
        f"sys.path.insert(0, {str(REPO)!r})\n"
        f"for n in {names!r}:\n"
        "    importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'mlx_audio_tpu'))\n"
        "assert not bad, bad\n"
        "print('OK', len(" + repr(names) + "))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("OK")


def _absolute_imports(path: Path, module: str):
    tree = ast.parse(path.read_text())
    pkg_parts = module.split(".") if path.name == "__init__.py" else module.split(".")[:-1]
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield node.lineno, a.name
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base = pkg_parts[: len(pkg_parts) - node.level + 1]
                yield node.lineno, ".".join(base + ([node.module] if node.module else []))
            else:
                yield node.lineno, node.module


def test_static_scan_of_imports():
    files = list(_modules()) + [(REPO / "chip_smoke.py", "chip_smoke")]
    bad = []
    for path, module in files:
        for line, name in _absolute_imports(path, module):
            top = name.split(".")[0]
            if top in ("jax", "jaxlib", "mlx_audio_tpu"):
                bad.append(f"{path.relative_to(REPO)}:{line}: {name}")
    assert not bad, bad
