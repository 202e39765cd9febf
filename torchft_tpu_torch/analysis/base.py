"""Shared plumbing for the port's invariant lint suite.

The port's instance of ``torchft_tpu/analysis/base.py``. The checkers
encode the port's own contracts — the donation rule on
``allreduce_arrays``, the one-definition rules for codec/grid/capability/
EF-gate math, the metric/event name registry (docs/operations.md §6 plus
the port's own names), and the import layering — as AST passes over the
source tree. They know nothing about the runtime: every checker consumes
:class:`Source` objects (path + text + parsed tree), so tests feed
seeded-violation fixtures from strings and ``python -m
torchft_tpu_torch.analysis`` feeds the real tree. Nothing in this package
imports the runtime, torch, or the JAX package (the layering checker
enforces the first on this package too).
"""

from __future__ import annotations

import ast
import dataclasses
from pathlib import Path
from typing import Iterable, List, Optional, Sequence

__all__ = ["Finding", "Source", "iter_sources", "format_findings"]


@dataclasses.dataclass(frozen=True)
class Finding:
    """One checker verdict, pointing at a file:line."""

    checker: str
    path: str  # repo-relative, forward slashes
    line: int
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line}: [{self.checker}] {self.message}"


class Source:
    """One Python source unit: repo-relative path + text + lazy AST."""

    def __init__(self, rel: str, text: str) -> None:
        self.rel = rel.replace("\\", "/")
        self.text = text
        self._tree: Optional[ast.AST] = None
        self.parse_error: Optional[SyntaxError] = None

    @classmethod
    def from_file(cls, root: Path, path: Path) -> "Source":
        rel = str(path.relative_to(root))
        return cls(rel, path.read_text(encoding="utf-8"))

    @property
    def tree(self) -> Optional[ast.AST]:
        if self._tree is None and self.parse_error is None:
            try:
                self._tree = ast.parse(self.text, filename=self.rel)
            except SyntaxError as e:  # surfaced as a finding by callers
                self.parse_error = e
        return self._tree


_SKIP_DIRS = {"__pycache__", ".git", ".pytest_cache", "build"}


def iter_sources(
    root: Path, subpaths: Sequence[str] = ("torchft_tpu_torch",
                                           "chip_smoke.py")
) -> List[Source]:
    """Collect the lintable Python sources under ``root``.

    ``subpaths`` entries may be directories (walked recursively) or
    single files. Missing entries are skipped so fixture trees can be
    partial."""
    out: List[Source] = []
    for sub in subpaths:
        p = root / sub
        if p.is_file() and p.suffix == ".py":
            out.append(Source.from_file(root, p))
            continue
        if not p.is_dir():
            continue
        for f in sorted(p.rglob("*.py")):
            if any(part in _SKIP_DIRS for part in f.parts):
                continue
            out.append(Source.from_file(root, f))
    return out


def format_findings(findings: Iterable[Finding]) -> str:
    return "\n".join(f.render() for f in findings)


def const_str(node: ast.AST) -> Optional[str]:
    """The literal string of a Constant-str node, else None."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None
