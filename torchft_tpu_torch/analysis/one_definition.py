"""One-definition lint: blessed contract functions may not be re-defined
or inlined elsewhere.

The port's instance of ``torchft_tpu/analysis/one_definition.py``, over
the port's paths. The cross-layer bitwise oracles depend on a handful of
functions having exactly ONE definition:

* ``codec_roundtrip``  — comm/transport.py: the wire's local image;
  the device EF path computes residuals against this exact function.
* ``_grid_step``       — comm/cuda_backend.py: the device-side chunk
  grid (the reference's ``_grid_bounds``); moving one builder's grid
  off the host codec's breaks the card plane's bit-match oracle.
* ``_ef_gate``         — ddp.py: THE error-feedback activation rule
  shared by the bucketed arena and the sharded reducer.
* ``supports``         — comm/context.py: the capability query; data
  planes extend by overriding ``unsupported_reason``, never by
  redefining ``supports`` itself.

Two rules:

1. **def rule** — a ``def <name>`` for any blessed symbol outside its
   blessed module is a violation (a drifting copy waiting to happen).
2. **fingerprint rule** — touching the *implementation surface* of a
   blessed contract outside its home modules is a violation even
   without a ``def``: calling the codec internals
   (``encode_iovecs``/``decode_into``/``_chunk_grid``) outside the two
   data planes, or consulting ``wire_compensable``/``wire_is_lossy``
   (the EF-gate inputs) outside ``ddp._ef_gate``. Providers may still
   *define* methods with those names anywhere — only reads/calls are
   restricted.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Sequence, Set, Tuple

from .base import Finding, Source, const_str

__all__ = ["check", "BLESSED_DEFS", "FINGERPRINTS"]

CHECKER = "one-definition"

# blessed symbol -> set of repo-relative modules allowed to define it
BLESSED_DEFS: Dict[str, Set[str]] = {
    "codec_roundtrip": {"torchft_tpu_torch/comm/transport.py"},
    "_grid_step": {"torchft_tpu_torch/comm/cuda_backend.py"},
    "_ef_gate": {"torchft_tpu_torch/ddp.py"},
    "supports": {"torchft_tpu_torch/comm/context.py"},
}

_PLANES = {"torchft_tpu_torch/comm/transport.py",
           "torchft_tpu_torch/comm/cuda_backend.py"}
_EF_HOMES = {"torchft_tpu_torch/ddp.py", "torchft_tpu_torch/manager.py",
             "torchft_tpu_torch/comm/context.py",
             "torchft_tpu_torch/comm/transport.py",
             "torchft_tpu_torch/comm/cuda_backend.py",
             "torchft_tpu_torch/comm/subproc.py",
             "torchft_tpu_torch/comm/wire_stub.py"}

# attribute/name usages (reads/calls, not defs) restricted to the
# modules that own the contract's implementation.
FINGERPRINTS: Dict[str, Tuple[Set[str], str]] = {
    "encode_iovecs": (
        _PLANES,
        "wire-codec internals: encode through codec_roundtrip / the "
        "transport APIs (comm/transport.py) instead of inlining codec "
        "math",
    ),
    "decode_into": (
        _PLANES,
        "wire-codec internals: decode through codec_roundtrip / the "
        "transport APIs (comm/transport.py) instead of inlining codec "
        "math",
    ),
    "_chunk_grid": (
        _PLANES,
        "the chunk grid is owned by the data planes; consume "
        "codec_roundtrip / _grid_step instead of re-gridding",
    ),
    # EF-gate inputs: the comm data planes PROVIDE these accessors (and
    # use them inside their own roundtrip/nbytes helpers); the manager
    # facade forwards them; ddp._ef_gate is the only CONSUMER allowed
    # to turn them into an error-feedback decision.
    "wire_compensable": (
        _EF_HOMES,
        "EF gating input: route error-feedback decisions through "
        "ddp._ef_gate (THE activation rule) instead of consulting "
        "wire_compensable directly",
    ),
    "wire_is_lossy": (
        _EF_HOMES,
        "EF gating input: route error-feedback decisions through "
        "ddp._ef_gate (THE activation rule) instead of consulting "
        "wire_is_lossy directly",
    ),
}


def check(sources: Sequence[Source]) -> List[Finding]:
    findings: List[Finding] = []
    for src in sources:
        tree = src.tree
        if tree is None:
            continue
        in_blessed = {
            name for name, mods in BLESSED_DEFS.items() if src.rel in mods
        }
        fp_home = {
            name for name, (mods, _) in FINGERPRINTS.items()
            if src.rel in mods
        }
        # method defs named like a fingerprint are provider
        # implementations, not consultations — collect their line spans
        # so reads inside them (self-delegation) are exempt too.
        def_spans: List[Tuple[int, int]] = []
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if node.name in BLESSED_DEFS and node.name not in in_blessed:
                    findings.append(Finding(
                        CHECKER, src.rel, node.lineno,
                        f"re-definition of blessed symbol {node.name!r}: "
                        "the one true definition lives in "
                        + "/".join(sorted(BLESSED_DEFS[node.name]))
                        + " — import it instead of copying it",
                    ))
                if node.name in FINGERPRINTS:
                    def_spans.append(
                        (node.lineno, node.end_lineno or node.lineno)
                    )
        for node in ast.walk(tree):
            name = None
            # Load context only: a Store (`self.wire_compensable = ...`)
            # is a provider DEFINING the accessor, which the contract
            # permits anywhere — only reads/calls are restricted.
            if isinstance(node, ast.Attribute):
                if isinstance(node.ctx, ast.Load):
                    name = node.attr
            elif isinstance(node, ast.Name):
                if isinstance(node.ctx, ast.Load):
                    name = node.id
            elif (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Name)
                and node.func.id in ("getattr", "hasattr")
                and len(node.args) >= 2
            ):
                name = const_str(node.args[1])
            if name is None or name not in FINGERPRINTS:
                continue
            if name in fp_home:
                continue
            if any(lo <= node.lineno <= hi for lo, hi in def_spans):
                continue  # inside a provider's own def
            mods, hint = FINGERPRINTS[name]
            findings.append(Finding(
                CHECKER, src.rel, node.lineno,
                f"inline use of contract surface {name!r} outside "
                + "/".join(sorted(mods)) + f": {hint}",
            ))
    return findings
