"""The port stands alone: no module of ``torchft_tpu_torch``, and not
``chip_smoke.py``, imports JAX or the JAX package, in its source or at run
time (a GPU host may have neither)."""

import ast
import os
import subprocess
import sys

import pytest

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_FORBIDDEN = ("jax", "jaxlib", "torchft_tpu", "optax", "flax")


def _sources():
    pkg = os.path.join(_ROOT, "torchft_tpu_torch")
    for dirpath, _, files in os.walk(pkg):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(_ROOT, "chip_smoke.py")


def _imported(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", list(_sources()),
                         ids=lambda p: os.path.relpath(p, _ROOT))
def test_source_imports_no_jax(path) -> None:
    bad = [m for m in _imported(path) if m.split(".")[0] in _FORBIDDEN]
    assert not bad, f"{os.path.relpath(path, _ROOT)} imports {bad}"


def test_every_module_imports_without_jax() -> None:
    # a fresh interpreter in which importing a forbidden package fails:
    # every module of the port must still import
    code = f"""
import importlib, pkgutil, sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in {_FORBIDDEN!r}:
            raise ImportError("forbidden import: " + name)
sys.meta_path.insert(0, Block())
import torchft_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    torchft_tpu_torch.__path__, "torchft_tpu_torch.")]
for name in names:
    importlib.import_module(name)
print(len(names))
"""
    r = subprocess.run([sys.executable, "-c", code], cwd=_ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert int(r.stdout.split()[-1]) > 30
