"""Donation lint: no use-after-donate of collective input arrays.

The port's instance of ``torchft_tpu/analysis/donation.py``.
``Manager.allreduce_arrays`` / ``reduce_scatter_arrays`` (and the raw
``CommContext.allreduce`` / ``reduce_scatter`` under them) DONATE their
input arrays: the transport reduces in place and the returned work's
future may resolve to the very arrays submitted, so between submit and
resolution the caller must treat the donated buffers as unreadable
(after a latched error their contents are unspecified). The port's
``Manager.allreduce_arrays`` docstring (torchft_tpu_torch/manager.py,
"The caller DONATES") is the authoritative statement of this contract.

This checker walks every function body in statement order and flags a
Load of a donated name between the donating call and the first
resolution of its work handle. The analysis is deliberately local and
conservative — it only tracks the patterns the repo actually uses, and
it drops tracking rather than guess:

* tracked donation shape: ``w = <expr>.allreduce_arrays(arg, ...)``
  where ``arg`` is a plain name or a list/tuple of plain names (the
  staging-arena idiom). Anything fancier is untrackable and skipped.
* resolution: ``w.wait()`` / ``w.result()`` / ``w.future()`` — once the
  caller touches the resolution surface, reads are legal again.
* escape: the work handle or a donated name passed to another call,
  stored on an object, subscripted-into, yielded or returned ends
  tracking for it (ownership moved somewhere this pass cannot see —
  e.g. ``add_done_callback`` continuations).
* rebinding a donated name (``arr = ...``, ``del arr``) ends tracking.
* nested ``def``/``lambda`` bodies count for NOTHING — not resolution
  (a ``w.wait()`` in a callback has not run yet), not reads: the repo's
  continuations (``_on_wire``/``_land``) run after the future resolved.
* branches are path-joined with a no-false-positive bias: each
  If/loop/except body is scanned from a copy of the state and a
  donation survives the join only if EVERY path kept it — so a rebind
  or resolution on any path makes later reads legal, at the cost of
  missing a use-after-donate that is only wrong on the path that
  skipped the wait.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Sequence, Set

from .base import Finding, Source

__all__ = ["check", "DONATING_CALLS"]

CHECKER = "donation"

# Methods whose first positional argument is donated.
DONATING_CALLS = {
    "allreduce_arrays",
    "reduce_scatter_arrays",
    "allreduce",
    "reduce_scatter",
}

# Receivers whose .allreduce/.reduce_scatter are NOT collectives (avoid
# flagging unrelated APIs with the same method names on exotic objects):
# we key on the method name only, which in this repo is unambiguous.

_RESOLVING_ATTRS = {"wait", "result", "future"}


def _donated_names(arg: ast.AST) -> Optional[Set[str]]:
    """Names donated by the first positional arg, or None = untrackable."""
    if isinstance(arg, ast.Name):
        return {arg.id}
    if isinstance(arg, (ast.List, ast.Tuple)):
        names: Set[str] = set()
        for elt in arg.elts:
            if isinstance(elt, ast.Name):
                names.add(elt.id)
            else:
                return None
        return names or None
    return None


def _donating_call(node: ast.AST) -> Optional[ast.Call]:
    if (
        isinstance(node, ast.Call)
        and isinstance(node.func, ast.Attribute)
        and node.func.attr in DONATING_CALLS
        and node.args
    ):
        return node
    return None


class _FuncScan:
    """Linear statement-order scan of one function body."""

    def __init__(self, src: Source, findings: List[Finding]) -> None:
        self.src = src
        self.findings = findings
        # donated name -> (work var name or None, donate lineno)
        self.donated: Dict[str, tuple] = {}

    # -- helpers ---------------------------------------------------------

    def _work_vars(self) -> Set[str]:
        return {w for (w, _) in self.donated.values() if w is not None}

    def _resolve_work(self, work: str) -> None:
        self.donated = {
            n: v for n, v in self.donated.items() if v[0] != work
        }

    def _drop(self, name: str) -> None:
        self.donated.pop(name, None)

    # -- statement walk --------------------------------------------------

    def scan_body(self, stmts: Sequence[ast.stmt]) -> None:
        for stmt in stmts:
            self.scan_stmt(stmt)

    def scan_stmt(self, stmt: ast.stmt) -> None:
        if isinstance(
            stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
        ):
            return  # nested scopes are scanned as their own functions
        if isinstance(stmt, ast.If):
            self._run_passes(stmt, [stmt.test])
            self._branch_merge([stmt.body, stmt.orelse])
            return
        if isinstance(stmt, (ast.While,)):
            self._run_passes(stmt, [stmt.test])
            self._branch_merge([stmt.body, []])  # body may run 0 times
            return
        if isinstance(stmt, (ast.For, ast.AsyncFor)):
            self._run_passes(stmt, [stmt.iter])
            for name in _store_names(stmt.target):
                self._drop(name)  # loop var rebinds per iteration
            self._branch_merge([stmt.body, []])
            return
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            self._run_passes(
                stmt, [item.context_expr for item in stmt.items]
            )
            for item in stmt.items:
                if item.optional_vars is not None:
                    for name in _store_names(item.optional_vars):
                        self._drop(name)
            self.scan_body(stmt.body)  # runs exactly once
            return
        if isinstance(stmt, ast.Try):
            pre = dict(self.donated)
            self.scan_body(stmt.body)
            self.scan_body(stmt.orelse)
            after_body = self.donated
            # handlers start from the PRE state (body may have failed
            # anywhere); merged result = what survives on every path
            branch_results = [after_body]
            for handler in stmt.handlers:
                self.donated = dict(pre)
                self.scan_body(handler.body)
                branch_results.append(self.donated)
            self.donated = _merge(branch_results)
            self.scan_body(stmt.finalbody)
            return
        # simple statement: all passes over the whole statement
        self._run_passes(stmt, [stmt])
        self._apply_assignments(stmt)

    def _run_passes(self, stmt: ast.stmt, roots: Sequence[ast.AST]) -> None:
        """Resolution, escape, and read passes over ``roots`` (a whole
        simple statement, or just a compound statement's header
        expressions — bodies are scanned branch-aware by the caller).
        Nothing inside a nested def/lambda counts for ANY pass: not as
        a resolution (a ``w.wait()`` in a callback has not run yet),
        not as an escape, not as a read (continuations run
        post-resolve)."""
        nodes: List[ast.AST] = []
        nested: Set[int] = set()
        for root in roots:
            for node in ast.walk(root):
                if isinstance(node, (ast.Lambda, ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                    for sub in ast.walk(node):
                        if sub is not node:
                            nested.add(id(sub))
        for root in roots:
            nodes.extend(
                n for n in ast.walk(root) if id(n) not in nested
            )
        # 1) resolutions lift the embargo before reads are judged
        for node in nodes:
            if (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in _RESOLVING_ATTRS
                and isinstance(node.func.value, ast.Name)
                and node.func.value.id in self._work_vars()
            ):
                self._resolve_work(node.func.value.id)
        # 2) escapes end tracking; 3) remaining reads are findings
        self._apply_escapes(nodes)
        self._check_reads(nodes)

    def _branch_merge(self, bodies: Sequence[Sequence[ast.stmt]]) -> None:
        """Scan each body from a copy of the current state; afterwards a
        donation survives only if EVERY path kept it (intersection).
        The no-false-positive bias: a rebind/resolution on any path
        ends tracking, so a read after the join is never flagged when
        some path made it legal — at the cost of missing a
        use-after-donate that is only illegal on the path that skipped
        the wait."""
        pre = dict(self.donated)
        results = []
        for body in bodies:
            self.donated = dict(pre)
            self.scan_body(body)
            results.append(self.donated)
        self.donated = _merge(results)

    def _apply_escapes(self, nodes: Sequence[ast.AST]) -> None:
        tracked = set(self.donated) | self._work_vars()
        if not tracked:
            return
        for node in nodes:
            if isinstance(node, ast.Call):
                callee_recv = (
                    node.func.value.id
                    if isinstance(node.func, ast.Attribute)
                    and isinstance(node.func.value, ast.Name)
                    else None
                )
                if _donating_call(node) is not None:
                    continue  # the donation itself is not an escape
                for arg in list(node.args) + [k.value for k in node.keywords]:
                    for name in _plain_names(arg):
                        if name in tracked and name not in (callee_recv,):
                            self._escape(name)
            elif isinstance(node, (ast.Return, ast.Yield, ast.YieldFrom)):
                val = node.value
                if val is not None:
                    for name in _plain_names(val):
                        if name in tracked:
                            self._escape(name)

    def _escape(self, name: str) -> None:
        self._drop(name)
        # a work var escaping ends tracking for everything donated to it
        self.donated = {
            n: v for n, v in self.donated.items() if v[0] != name
        }

    def _check_reads(self, nodes: Sequence[ast.AST]) -> None:
        if not self.donated:
            return
        skip: Set[int] = set()
        for node in nodes:
            call = _donating_call(node)
            if call is not None:
                # the donating call's own argument names are not "reads"
                for sub in ast.walk(call.args[0]):
                    skip.add(id(sub))
        for node in nodes:
            if id(node) in skip:
                continue
            if (
                isinstance(node, ast.Name)
                and isinstance(node.ctx, ast.Load)
                and node.id in self.donated
            ):
                work, lineno = self.donated[node.id]
                self.findings.append(Finding(
                    CHECKER, self.src.rel, node.lineno,
                    f"use-after-donate: {node.id!r} was donated to "
                    f"{'the collective' if work is None else work!r} at "
                    f"line {lineno} and is read before the work resolves "
                    "(.wait()/.result()); donated buffers are "
                    "unspecified until then",
                ))
                self._drop(node.id)  # one finding per donation

    def _apply_assignments(self, stmt: ast.stmt) -> None:
        targets: List[ast.expr] = []
        value: Optional[ast.expr] = None
        if isinstance(stmt, ast.Assign):
            targets, value = stmt.targets, stmt.value
        elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign)):
            targets = [stmt.target]
            value = getattr(stmt, "value", None)
        elif isinstance(stmt, ast.Delete):
            for t in stmt.targets:
                if isinstance(t, ast.Name):
                    self._drop(t.id)
            return
        elif isinstance(stmt, ast.Expr):
            value = stmt.value
        # new donation?
        call = _donating_call(value) if value is not None else None
        if call is not None:
            names = _donated_names(call.args[0])
            work = (
                targets[0].id
                if len(targets) == 1 and isinstance(targets[0], ast.Name)
                else None
            )
            if names:
                if work is None and not isinstance(stmt, ast.Expr):
                    # result stored somewhere this pass cannot track
                    # (self.x = ..., container[i] = ...): skip.
                    return
                for n in names:
                    self.donated[n] = (work, call.lineno)
            return
        # rebinds end tracking for the target names
        for t in targets:
            for name in _store_names(t):
                self._drop(name)
                # rebinding a work var also forgets its donations
                self.donated = {
                    n: v for n, v in self.donated.items() if v[0] != name
                }


def _plain_names(node: ast.expr) -> List[str]:
    if isinstance(node, ast.Name):
        return [node.id]
    if isinstance(node, (ast.List, ast.Tuple)):
        out: List[str] = []
        for e in node.elts:
            out.extend(_plain_names(e))
        return out
    if isinstance(node, ast.Starred):
        return _plain_names(node.value)
    return []


def _store_names(node: ast.expr) -> List[str]:
    if isinstance(node, ast.Name):
        return [node.id]
    if isinstance(node, (ast.List, ast.Tuple)):
        out: List[str] = []
        for e in node.elts:
            out.extend(_store_names(e))
        return out
    return []


def _merge(states: Sequence[Dict[str, tuple]]) -> Dict[str, tuple]:
    """Path join: a donation survives only if every path kept it with
    the same work handle."""
    if not states:
        return {}
    out = dict(states[0])
    for st in states[1:]:
        out = {
            n: v for n, v in out.items() if st.get(n, None) == v
        }
    return out


def check(sources: Sequence[Source]) -> List[Finding]:
    findings: List[Finding] = []
    for src in sources:
        tree = src.tree
        if tree is None:
            continue
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                _FuncScan(src, findings).scan_body(node.body)
    return findings
