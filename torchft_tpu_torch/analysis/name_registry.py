"""Name-registry lint: code ↔ docs/operations.md §6 metric/event drift.

The port's instance of ``torchft_tpu/analysis/name_registry.py``. It reads
docs/operations.md §6 read-only, plus :data:`PORT_ONLY_METRICS`, the table
of names only the port emits. Every metric name emitted through the
Metrics sink
(``incr``/``gauge``/``observe``/``timed``/``label``, plus the
``timed_span``/``throughput_span`` helpers that feed it) and every
event kind emitted through ``EventRecorder.emit`` must appear in the
reference tables of docs/operations.md §6 — and every name the docs
promise must actually be emitted somewhere. Drift in EITHER direction
is a finding: an undocumented name is invisible to operators, a
documented-but-gone name is a dashboard lying about coverage.

Matching supports placeholders: the docs' ``comm_l{i}_wire_reduce``
matches the code's ``f"{tag}_wire_reduce"`` (formatted fragments
normalize to ``*`` on both sides; a match is an fnmatch hit in either
direction).

The lighthouse "control" counters are native-side: each name in that
table must appear as a ``"literal"`` in native/*.cc|h.

Event kinds are additionally cross-checked against the
``EVENT_KINDS`` tuple in the port's utils/events.py (extracted from its
AST, so this package stays import-free of the runtime): emitted ⊆
EVENT_KINDS, and the docs' event table must equal EVENT_KINDS exactly.

A name of :data:`PORT_ONLY_METRICS` counts as documented; it must be
emitted, and must not be in the docs (it would then belong there alone).
A name of :data:`REFERENCE_ONLY_METRICS` is documented for the reference
and not emitted by the port; it must be in the docs and emitted nowhere.
"""

from __future__ import annotations

import ast
import fnmatch
import re
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .base import Finding, Source, const_str

__all__ = ["check", "parse_docs_registry", "collect_code_names",
           "PORT_ONLY_METRICS", "REFERENCE_ONLY_METRICS"]

CHECKER = "name-registry"

# ``_fused_timed``, ``_classic_timed``: OptimizerWrapper's timers over
# both of their sinks
_METRIC_METHODS = {"incr", "gauge", "observe", "timed", "label",
                   "_fused_timed", "_classic_timed"}
_HELPER_DERIVED = {
    "timed_span": ("{}",),
    "throughput_span": ("{}", "{}_bytes", "{}_bytes_per_s"),
}
# The generic helpers themselves forward caller-supplied names; their
# internals would only contribute wildcards.
_EXCLUDED_FILES = {"torchft_tpu_torch/utils/profiling.py",
                   "torchft_tpu_torch/utils/metrics.py",
                   "torchft_tpu_torch/utils/events.py"}

_EVENTS_PY = "torchft_tpu_torch/utils/events.py"

# The metric names only the port emits (docs/operations.md §6 documents the
# reference's and is not edited): name -> what it counts.
PORT_ONLY_METRICS: Dict[str, str] = {
    "quorum_fast": "span: a quorum answered on the epoch lease's fast "
                   "path (manager.py), beside the full path's `quorum`",
    "commit_fast": "span: a commit on the lease's fast path, no barrier "
                   "RPC (manager.py), beside `commit_barrier`",
    "heal_served_bytes": "counter: tensor bytes a donor's checkpoint "
                         "server wrote to healers (checkpointing.py)",
    "forward_backward": "span: one forward and backward pass of the "
                        "example trainers, device-synchronized "
                        "(examples/, train loops)",
    "probe_forward": "span: an observer group's forward-only probe "
                     "(examples/train_ddp.py)",
    "reshard": "span: one redistribution of the sharded update's grid "
               "(optim.py, local_sgd.py), beside the `reshard` event",
    "deploy_publish_d2h": "span: a publication's host copies of the "
                          "units, a D2H from the card (serve.py)",
    "deploy_publish_digest": "span: a publication's sha256 of every "
                             "unit (serve.py)",
    "deploy_upload": "span: a serving replica's upload of its fetched "
                     "shard to the card, whole (serve.py)",
    "serve_answer": "span: one answer of a serving replica: the live "
                    "unit's digest read back from the card and its sum "
                    "(serve.py)",
}

# The documented names the port does not emit: name -> why the port's
# series of the same interval serves instead.
REFERENCE_ONLY_METRICS: Dict[str, str] = {
    "comm_l{i}_wire_reduce": "the TCP wire observes each lane's share of "
                             "a striped op once, as `comm_wire_reduce`",
    "comm_reduce_future": "the delivery of a gradient op's future: the "
                          "port's `comm_wire_reduce` ends where it is set",
    "comm_striped_ops": "a striped op is counted by its sub-ops' "
                        "`comm_wire_reduce` observations",
}

_NAME_RE = re.compile(r"`([A-Za-z_][A-Za-z0-9_{}]*)`")


# --------------------------------------------------------------- docs side


def parse_docs_registry(text: str) -> Dict[str, List[Tuple[str, int]]]:
    """Parse §6's tables into ``{table: [(name, line)]}``.

    Tables are keyed by the ``**Bold**`` caption that precedes them
    (``Counters``, ``Spans``, ``Gauges``, ``Lighthouse control
    counters``, ``Lifecycle events``). A row's names are every
    backticked token in its FIRST cell (slash-separated alternatives
    each count)."""
    lines = text.splitlines()
    # §6 bounds: from "## 6." to the next "## " heading
    start = end = None
    for i, ln in enumerate(lines):
        if ln.startswith("## ") and start is not None and end is None:
            end = i
        if re.match(r"##\s*6[.\s]", ln):
            start = i
    if start is None:
        return {}
    section = lines[start:end]
    tables: Dict[str, List[Tuple[str, int]]] = {}
    current: Optional[str] = None
    for off, ln in enumerate(section):
        m = re.match(r"\*\*([^*]+)\*\*", ln.strip())
        if m:
            current = m.group(1).strip()
            continue
        s = ln.strip()
        if not (s.startswith("|") and current):
            continue
        cells = [c.strip() for c in s.strip("|").split("|")]
        if not cells or set(cells[0]) <= {"-", " ", ":"}:
            continue  # separator row
        if cells[0] in ("Name", "Kind"):
            continue  # header row
        for name in _NAME_RE.findall(cells[0]):
            tables.setdefault(current, []).append(
                (name, start + off + 1)
            )
    return tables


# --------------------------------------------------------------- code side


def _joined_pattern(node: ast.JoinedStr) -> str:
    parts: List[str] = []
    for v in node.values:
        if isinstance(v, ast.Constant) and isinstance(v.value, str):
            parts.append(v.value)
        else:
            parts.append("*")
    return "".join(parts)


def _first_arg_names(node: ast.expr) -> List[str]:
    """Metric/event name candidates from a call's first argument:
    literal str, f-string (wildcarded), or an IfExp of two literals
    (``"step_commit" if ok else "step_discard"``)."""
    lit = const_str(node)
    if lit is not None:
        return [lit]
    if isinstance(node, ast.JoinedStr):
        return [_joined_pattern(node)]
    if isinstance(node, ast.IfExp):
        return _first_arg_names(node.body) + _first_arg_names(node.orelse)
    return []


def collect_code_names(
    sources: Sequence[Source],
) -> Tuple[Dict[str, List[Tuple[str, int]]], Dict[str, List[Tuple[str, int]]]]:
    """Scan sources for emitted metric names and event kinds.

    Returns ``(metrics, events)`` as ``{name_or_pattern: [(rel, line)]}``.
    Calls with entirely dynamic names (plain variables) are skipped —
    the helpers that take them are excluded files, and direct dynamic
    emission sites are rare enough to police by review."""
    metrics: Dict[str, List[Tuple[str, int]]] = {}
    events: Dict[str, List[Tuple[str, int]]] = {}

    def _add(d, name, src, line):
        d.setdefault(name, []).append((src.rel, line))

    for src in sources:
        if src.rel in _EXCLUDED_FILES:
            continue
        tree = src.tree
        if tree is None:
            continue
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            fname = None
            if isinstance(node.func, ast.Attribute):
                fname = node.func.attr
            elif isinstance(node.func, ast.Name):
                fname = node.func.id
            if fname in _METRIC_METHODS and node.args:
                for nm in _first_arg_names(node.args[0]):
                    _add(metrics, nm, src, node.lineno)
            elif fname in _HELPER_DERIVED and len(node.args) >= 2:
                base = const_str(node.args[1])
                if base is not None:
                    for tmpl in _HELPER_DERIVED[fname]:
                        _add(metrics, tmpl.format(base), src, node.lineno)
            elif fname == "emit" and node.args:
                for nm in _first_arg_names(node.args[0]):
                    _add(events, nm, src, node.lineno)
    return metrics, events


def extract_event_kinds(events_src: Optional[Source]) -> Set[str]:
    """The EVENT_KINDS tuple literal, read from utils/events.py's AST."""
    if events_src is None or events_src.tree is None:
        return set()
    for node in ast.walk(events_src.tree):
        if (
            isinstance(node, ast.Assign)
            and any(
                isinstance(t, ast.Name) and t.id == "EVENT_KINDS"
                for t in node.targets
            )
            and isinstance(node.value, (ast.Tuple, ast.List))
        ):
            return {
                v for v in (const_str(e) for e in node.value.elts)
                if v is not None
            }
    return set()


# --------------------------------------------------------------- matching


def _norm(name: str) -> str:
    """Docs placeholders ``{i}`` and code f-string holes both become
    ``*`` so either side can wildcard-match the other."""
    return re.sub(r"\{[^}]*\}", "*", name)


def _matches(a: str, b: str) -> bool:
    na, nb = _norm(a), _norm(b)
    return fnmatch.fnmatchcase(na, nb) or fnmatch.fnmatchcase(nb, na)


def _any_match(name: str, pool: Sequence[str]) -> bool:
    return any(_matches(name, p) for p in pool)


# --------------------------------------------------------------- checker


_METRIC_TABLES = ("Counters", "Spans", "Gauges")
_NAME_REGISTRY_PY = "torchft_tpu_torch/analysis/name_registry.py"
_EVENT_TABLE = "Lifecycle events"
_CONTROL_TABLE = "Lighthouse control counters"


def check(
    sources: Sequence[Source],
    docs_text: Optional[str] = None,
    root: Optional[Path] = None,
    native_text: Optional[str] = None,
    port_only: Optional[Dict[str, str]] = None,
    reference_only: Optional[Dict[str, str]] = None,
) -> List[Finding]:
    """``docs_text``/``native_text`` may be supplied directly (fixtures)
    or read from ``root`` (docs/operations.md, native/*.cc|h);
    ``port_only`` and ``reference_only`` replace :data:`PORT_ONLY_METRICS`
    and :data:`REFERENCE_ONLY_METRICS`, which describe the real docs and
    so apply by default only when the docs are read from ``root`` (a
    supplied ``docs_text`` is a fixture: no table unless given)."""
    real_docs = docs_text is None
    if port_only is None:
        port_only = PORT_ONLY_METRICS if real_docs else {}
    if reference_only is None:
        reference_only = REFERENCE_ONLY_METRICS if real_docs else {}
    findings: List[Finding] = []
    docs_rel = "docs/operations.md"
    if docs_text is None:
        if root is None:
            return [Finding(CHECKER, docs_rel, 1,
                            "no docs text and no root to read it from")]
        p = root / docs_rel
        if not p.exists():
            return [Finding(CHECKER, docs_rel, 1, "docs/operations.md missing")]
        docs_text = p.read_text(encoding="utf-8")
    if native_text is None and root is not None:
        native_dir = root / "native"
        chunks = []
        if native_dir.is_dir():
            for f in sorted(native_dir.glob("*.cc")) + sorted(
                native_dir.glob("*.h")
            ):
                chunks.append(f.read_text(encoding="utf-8", errors="replace"))
        native_text = "\n".join(chunks)

    tables = parse_docs_registry(docs_text)
    if not tables:
        return [Finding(CHECKER, docs_rel, 1,
                        "could not locate §6 'Metrics & events reference'")]
    doc_metrics: List[Tuple[str, int]] = []
    for t in _METRIC_TABLES:
        doc_metrics.extend(tables.get(t, []))
    doc_events = tables.get(_EVENT_TABLE, [])
    doc_control = tables.get(_CONTROL_TABLE, [])

    code_metrics, code_events = collect_code_names(sources)
    events_src = next(
        (s for s in sources if s.rel == _EVENTS_PY), None
    )
    kinds = extract_event_kinds(events_src)

    doc_metric_names = [n for n, _ in doc_metrics]
    # -- the port's own table: emitted, and not also in the docs
    for name in sorted(port_only):
        if _any_match(name, doc_metric_names):
            findings.append(Finding(
                CHECKER, _NAME_REGISTRY_PY, 1,
                f"PORT_ONLY_METRICS entry {name!r} is documented in "
                "docs/operations.md §6: drop it from the port's table",
            ))
        if not _any_match(name, list(code_metrics)):
            findings.append(Finding(
                CHECKER, _NAME_REGISTRY_PY, 1,
                f"PORT_ONLY_METRICS entry {name!r} is emitted nowhere in "
                "torchft_tpu_torch/",
            ))
    # -- the reference's names: documented, and emitted nowhere here
    for name in sorted(reference_only):
        if name not in doc_metric_names:
            findings.append(Finding(
                CHECKER, _NAME_REGISTRY_PY, 1,
                f"REFERENCE_ONLY_METRICS entry {name!r} is not documented "
                "in docs/operations.md §6: drop it from the table",
            ))
        if _any_match(name, list(code_metrics)):
            findings.append(Finding(
                CHECKER, _NAME_REGISTRY_PY, 1,
                f"REFERENCE_ONLY_METRICS entry {name!r} is emitted in "
                "torchft_tpu_torch/: drop it from the table",
            ))
    doc_metric_names = doc_metric_names + sorted(port_only)
    # -- metrics: code -> docs
    for name, sites in sorted(code_metrics.items()):
        if not _any_match(name, doc_metric_names):
            rel, line = sites[0]
            findings.append(Finding(
                CHECKER, rel, line,
                f"metric {name!r} is emitted here but missing from the "
                "docs/operations.md §6 reference tables — document it "
                "(or stop emitting it)",
            ))
    # -- metrics: docs -> code
    code_metric_names = list(code_metrics)
    for name, line in doc_metrics:
        if name not in reference_only and \
                not _any_match(name, code_metric_names):
            findings.append(Finding(
                CHECKER, docs_rel, line,
                f"documented metric {name!r} is emitted nowhere in "
                "torchft_tpu_torch/ — the §6 table promises a series the "
                "sink never produces",
            ))
    # -- events: code -> docs + EVENT_KINDS
    doc_event_names = [n for n, _ in doc_events]
    for kind, sites in sorted(code_events.items()):
        rel, line = sites[0]
        if kinds and kind not in kinds:
            findings.append(Finding(
                CHECKER, rel, line,
                f"event kind {kind!r} is emitted here but absent from "
                "utils/events.py EVENT_KINDS",
            ))
        if not _any_match(kind, doc_event_names):
            findings.append(Finding(
                CHECKER, rel, line,
                f"event kind {kind!r} is emitted here but missing from "
                "the §6 'Lifecycle events' table",
            ))
    # -- events: docs -> EVENT_KINDS + emitted-somewhere
    for kind, line in doc_events:
        if kinds and kind not in kinds:
            findings.append(Finding(
                CHECKER, docs_rel, line,
                f"documented event kind {kind!r} is not in "
                "utils/events.py EVENT_KINDS",
            ))
        if not _any_match(kind, list(code_events)):
            findings.append(Finding(
                CHECKER, docs_rel, line,
                f"documented event kind {kind!r} is emitted nowhere",
            ))
    for kind in sorted(kinds):
        if not _any_match(kind, doc_event_names):
            findings.append(Finding(
                CHECKER, _EVENTS_PY, 1,
                f"EVENT_KINDS entry {kind!r} missing from the §6 "
                "'Lifecycle events' table",
            ))
    # -- control counters: docs -> native literals
    if native_text is not None and doc_control:
        for name, line in doc_control:
            if f'"{_norm(name)}"' not in native_text and \
                    f'"{name}"' not in native_text:
                findings.append(Finding(
                    CHECKER, docs_rel, line,
                    f"documented control counter {name!r} does not "
                    "appear as a string literal in native/*.cc|h",
                ))
    return findings
