"""The port's invariant lint suite: AST checkers for its own contracts.

The port's instance of ``torchft_tpu/analysis``, stdlib only (it imports
neither torch nor the JAX package, so it loads in a bare interpreter):

* ``donation``        — no use-after-donate of collective inputs
* ``one_definition``  — blessed contract functions defined exactly once
* ``name_registry``   — metric/event names ↔ docs/operations.md §6 and
                        the port's own table
* ``layering``        — the package import DAG
* ``lockcheck``       — runtime lock acquisition-order cycles
                        (``TORCHFT_TPU_LOCKCHECK=1``; not an AST pass)

``python -m torchft_tpu_torch.analysis`` runs the four static checkers
over the tree (the twin of ``scripts/check.py``).
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Sequence

# Checker submodules load lazily (inside run_all): the package root imports
# this package on every `import torchft_tpu_torch` to reach
# lockcheck.maybe_install, and must not pay for the AST machinery.
from .base import Finding, Source, format_findings, iter_sources

__all__ = [
    "Finding",
    "Source",
    "iter_sources",
    "format_findings",
    "run_all",
    "CHECKERS",
]

# checker name -> scope (subpaths under the repo root it lints)
CHECKERS: Dict[str, Sequence[str]] = {
    "donation": ("torchft_tpu_torch", "chip_smoke.py"),
    "one-definition": ("torchft_tpu_torch", "chip_smoke.py"),
    "name-registry": ("torchft_tpu_torch",),
    "layering": ("torchft_tpu_torch",),
}


def run_all(
    root: Path, only: Optional[Sequence[str]] = None
) -> List[Finding]:
    """Run the static checkers over the tree at ``root``."""
    selected = set(only or CHECKERS)
    unknown = selected - set(CHECKERS)
    if unknown:
        raise ValueError(
            f"unknown checkers {sorted(unknown)}; "
            f"available: {sorted(CHECKERS)}"
        )
    cache: Dict[Sequence[str], List[Source]] = {}

    def sources(scope: Sequence[str]) -> List[Source]:
        if scope not in cache:
            cache[scope] = iter_sources(root, scope)
        return cache[scope]

    from . import donation, layering, name_registry, one_definition

    findings: List[Finding] = []
    # parse errors anywhere in scope are findings (a checker that silently
    # skips unparsable files is a checker that can be dodged)
    seen: set = set()
    for name in sorted(selected):
        for src in sources(CHECKERS[name]):
            if src.tree is None and src.parse_error and src.rel not in seen:
                seen.add(src.rel)
                findings.append(Finding(
                    "parse", src.rel, src.parse_error.lineno or 1,
                    f"syntax error: {src.parse_error.msg}",
                ))
    if "donation" in selected:
        findings.extend(donation.check(sources(CHECKERS["donation"])))
    if "one-definition" in selected:
        findings.extend(
            one_definition.check(sources(CHECKERS["one-definition"]))
        )
    if "name-registry" in selected:
        findings.extend(name_registry.check(
            sources(CHECKERS["name-registry"]), root=root
        ))
    if "layering" in selected:
        findings.extend(layering.check(sources(CHECKERS["layering"])))
    return findings
