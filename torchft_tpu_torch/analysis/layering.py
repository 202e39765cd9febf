"""Layering lint: the port's import DAG, machine-enforced.

The port's instance of ``torchft_tpu/analysis/layering.py`` (whose table is
hard-wired to ``torchft_tpu``). The layers, bottom-up: ``utils`` (leaf
helpers: metrics, events, net, profiling, serialization) sits under
everything; ``futures`` and ``comm`` form the data plane; ``control`` is
the native control-plane binding; ``ops``/``parallel``/``models`` are the
model zoo and its Hopper kernels; ``examples``, ``fused`` and ``serve`` are
orchestration over them. The orchestration layer (manager, ddp, optim,
local_sgd, checkpointing, ...) may import any of them, never the reverse.

Modules of a layer listed in :data:`ALLOWED` may import (within the
package) only the named layers, or a single module of another layer where
the table names that module (a dotted entry such as ``"control._native"``);
modules of a layer not listed are unconstrained. All imports count, function-scoped lazy ones
included: a lazy import is still a layering edge.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Sequence, Set

from .base import Finding, Source

__all__ = ["check", "ALLOWED", "PACKAGE"]

CHECKER = "layering"

PACKAGE = "torchft_tpu_torch"

# layer (first path segment under the package, or the module name for
# top-level modules) -> layers it may import from the package, and single
# modules of other layers (dotted entries). comm adds ops to the reference's
# table: the card plane launches the Hopper codec kernels of ops/quant.py
# and counts the flash kernels' launches in its captured graphs (the
# reference's Pallas quantizer lives inside comm/xla_backend.py); ops
# imports nothing of comm. The two single modules: utils/crc32c.py calls
# the wire's CRC32C linked into the port's native library, which
# control/_native.py builds and loads; DevicePool.mesh_for builds the
# port's Mesh (parallel/mesh.py, a leaf module of numpy and torch), as the
# reference's MeshManager builds jax's.
ALLOWED: Dict[str, Set[str]] = {
    "utils": {"utils", "control._native"},
    "futures": {"futures", "utils"},
    "comm": {"comm", "utils", "futures", "ops", "parallel.mesh"},
    "control": {"control", "utils"},
    "analysis": {"analysis"},
    "ops": {"ops", "utils"},
    "parallel": {"parallel", "ops", "comm", "futures", "utils"},
    "models": {"models", "ops", "parallel", "utils"},
    "examples": {"examples", "checkpoint_io", "checkpointing", "comm",
                 "control", "data", "ddp", "launcher", "local_sgd",
                 "manager", "models", "ops", "optim", "parallel", "utils"},
    "fused": {"comm", "optim", "utils"},
    "serve": {"checkpointing", "comm", "control", "utils"},
}


def _layer_of(rel: str) -> Optional[str]:
    """torchft_tpu_torch/comm/transport.py -> 'comm';
    torchft_tpu_torch/manager.py -> 'manager'; other files -> None."""
    parts = rel.split("/")
    if parts[0] != PACKAGE or len(parts) < 2:
        return None
    if len(parts) == 2:
        name = parts[1]
        if name in ("__init__.py", "__main__.py"):
            return None  # the root facade re-exports everything
        return name[:-3] if name.endswith(".py") else name
    return parts[1]


def _module_of_import(node: ast.AST, rel: str) -> List[str]:
    """Fully-qualified package module names imported by this node."""
    mods: List[str] = []
    if isinstance(node, ast.Import):
        mods = [a.name for a in node.names]
    elif isinstance(node, ast.ImportFrom):
        if node.level == 0:
            mods = [node.module or ""]
        else:
            # resolve relative: the containing package, then up
            # `level-1` more packages
            pkg = rel[:-3].split("/")[:-1]
            base = pkg[: len(pkg) - (node.level - 1)]
            mod = ".".join(base + ([node.module] if node.module else []))
            mods = [mod]
    return [m for m in mods if m == PACKAGE or m.startswith(PACKAGE + ".")]


def _imported_layer(mod: str) -> str:
    segs = mod.split(".")
    return segs[1] if len(segs) > 1 else ""


def check(sources: Sequence[Source]) -> List[Finding]:
    findings: List[Finding] = []
    for src in sources:
        layer = _layer_of(src.rel)
        if layer is None or layer not in ALLOWED:
            continue
        tree = src.tree
        if tree is None:
            continue
        allowed = ALLOWED[layer]
        for node in ast.walk(tree):
            if not isinstance(node, (ast.Import, ast.ImportFrom)):
                continue
            for mod in _module_of_import(node, src.rel):
                target = _imported_layer(mod)
                if target == "":
                    # the package root pulls every layer
                    target = "<root facade>"
                if target in allowed or mod[len(PACKAGE) + 1:] in allowed:
                    continue
                findings.append(Finding(
                    CHECKER, src.rel, node.lineno,
                    f"layer {layer!r} imports {mod!r} ({target}); "
                    f"allowed layers for {layer!r}: "
                    + ", ".join(sorted(allowed)),
                ))
    return findings
