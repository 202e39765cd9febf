"""Flight recorder: a bounded ring buffer of structured lifecycle events.

Twin of ``torchft_tpu/utils/events.py``: the recorder and its Chrome-trace
export (``to_chrome_trace``, ``validate_chrome_trace``). The metrics sink
(utils/metrics.py) answers "how long do things take"; this answers "what
happened when": a discarded step, a heal, a latched error, a broken lease
each leave one structured event. The Manager owns
one recorder per process (``manager.events``).

Event vocabulary of the port (``EVENT_KINDS``, a subset of the JAX
package's, with the same fields):

    quorum_start / quorum_complete   the async quorum RPC
    step_commit / step_discard       the commit barrier, or a fast-path
                                     commit (``fastpath=True``)
    heal_start / heal_done           heal assignment -> healed state applied
    round_abort                      a LocalSGD/DiLoCo round rolled back
    error_latched                    first latch of an error episode
    mesh_reconfigure / mesh_compile  the device plane's group and plans
    hier_exchange                    the hierarchical tier's roles
    lease_break                      the epoch lease broke (``reason``)
    job_preempted                    the lighthouse evicted this group
                                     (``job_id``; epoch = membership epoch)

Every event is stamped with a process-monotonic sequence number, wall and
monotonic clocks, the replica_id/rank, and the step and quorum epoch when
the emitter knows them. ``since(seq)`` reads are seq-cursored; overwritten
events are reported as a ``dropped`` count, never silently.

Overhead: ``emit`` is one lock, one dict and one ring-slot store; hot call
sites guard with ``if ev: ev.emit(...)`` so the disabled path allocates
nothing (``TORCHFT_TPU_EVENTS=0`` disables).
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

__all__ = ["EVENT_KINDS", "EventRecorder", "to_chrome_trace",
           "validate_chrome_trace"]

EVENT_KINDS = (
    "quorum_start",
    "quorum_complete",
    "step_commit",
    "step_discard",
    "heal_start",
    "heal_done",
    "round_abort",
    "error_latched",
    "mesh_reconfigure",
    "mesh_compile",
    "hier_exchange",
    "lease_break",
    "job_preempted",
)


_DEFAULT_CAPACITY = 4096

# span start -> end kinds the Chrome export pairs into duration slices
_SPAN_PAIRS = {
    "quorum_start": "quorum_complete",
    "heal_start": "heal_done",
    "deploy_start": "deploy_done",
}
_SPAN_ENDS = {v: k for k, v in _SPAN_PAIRS.items()}
_SPAN_NAMES = {
    "quorum_start": "quorum",
    "heal_start": "heal",
    "deploy_start": "deploy",
}


class EventRecorder:
    """Bounded, lock-cheap ring of lifecycle events.

    ``capacity``: ring size (oldest events are overwritten; reads report
    how many were dropped past a cursor). ``enabled``: None reads the
    ``TORCHFT_TPU_EVENTS`` env var ("0" disables; default enabled) —
    the recorder is cheap enough to stay on, the switch exists for
    overhead A/Bs and paranoid jobs. ``replica_id``/``rank`` are stamped
    onto every event (rebindable via :meth:`bind` once known)."""

    def __init__(self, capacity: int = _DEFAULT_CAPACITY,
                 enabled: Optional[bool] = None,
                 replica_id: str = "", rank: int = 0) -> None:
        if enabled is None:
            enabled = os.environ.get("TORCHFT_TPU_EVENTS", "1") != "0"
        capacity = int(capacity)
        if capacity < 1:
            enabled = False
            capacity = 1
        self._enabled = bool(enabled)
        self._cap = capacity
        self._buf: List[Optional[Dict[str, Any]]] = [None] * capacity
        self._seq = 0
        self._lock = threading.Lock()
        self.replica_id = str(replica_id)
        self.rank = int(rank)

    # -- write side ---------------------------------------------------------

    @property
    def enabled(self) -> bool:
        return self._enabled

    def __bool__(self) -> bool:
        """The hot-path guard: ``if recorder: recorder.emit(...)`` keeps
        the disabled path allocation-free (no kwargs dict is ever
        built)."""
        return self._enabled

    @property
    def next_seq(self) -> int:
        """Total events ever emitted (== the next event's seq)."""
        with self._lock:
            return self._seq

    def bind(self, replica_id: str, rank: int) -> None:
        """(Re)bind the identity stamped onto subsequent events."""
        self.replica_id = str(replica_id)
        self.rank = int(rank)

    def emit(self, kind: str, step: Optional[int] = None,
             epoch: Optional[int] = None, **fields: Any) -> int:
        """Record one event; returns its seq (-1 when disabled).

        ``fields`` must be JSON-safe (strings/numbers/None) — events ride
        ``/telemetry/events`` verbatim. O(append): one lock, one dict,
        one slot store."""
        if not self._enabled:
            return -1
        rec: Dict[str, Any] = {
            "kind": kind,
            "t_wall": time.time(),
            "t_mono": time.monotonic(),
            "replica_id": self.replica_id,
            "rank": self.rank,
            "step": step,
            "epoch": epoch,
        }
        if fields:
            rec.update(fields)
        with self._lock:
            seq = self._seq
            rec["seq"] = seq
            self._buf[seq % self._cap] = rec
            self._seq = seq + 1
        return seq

    # -- read side ----------------------------------------------------------

    def since(self, seq: int = 0) -> "Tuple[List[Dict[str, Any]], int, int]":
        """Events with ``event.seq >= seq``, oldest first.

        Returns ``(events, next_seq, dropped)``: pass ``next_seq`` back
        as the next poll's cursor; ``dropped`` counts events past the
        cursor that the ring already overwrote (poll faster or raise
        capacity)."""
        seq = max(0, int(seq))
        with self._lock:
            end = self._seq
            first_avail = max(0, end - self._cap)
            start = max(seq, first_avail)
            out = [self._buf[i % self._cap] for i in range(start, end)]
        dropped = max(0, min(first_avail, end) - seq) if seq < end else 0
        return out, end, dropped

    def dump(self) -> Dict[str, Any]:
        """Full snapshot: identity, cursor, drop count and events."""
        events, nxt, dropped = self.since(0)
        return {
            "replica_id": self.replica_id,
            "rank": self.rank,
            "enabled": self._enabled,
            "capacity": self._cap,
            "next": nxt,
            "dropped": dropped,
            "events": events,
        }


# ------------------------------------------------------------ chrome export


def _track_ids(dumps: Sequence[Dict[str, Any]]) -> Dict[str, int]:
    """One Chrome 'process' per replica_id, in first-seen order."""
    pids: Dict[str, int] = {}
    for d in dumps:
        rid = str(d.get("replica_id", ""))
        if rid not in pids:
            pids[rid] = len(pids) + 1
    return pids


def to_chrome_trace(dumps: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    """Merge per-replica event dumps into one Chrome ``trace_event`` JSON.

    ``dumps``: any mix of ``EventRecorder.dump()`` payloads and
    ``/telemetry/events`` response bodies (same shape). One process (pid)
    per replica, one thread (tid) per rank; ``quorum_start ->
    quorum_complete`` and ``heal_start -> heal_done`` become duration
    slices, everything else an instant. Timestamps are wall-clock
    microseconds, so dumps from several processes share one timeline."""
    pids = _track_ids(dumps)
    trace_events: List[Dict[str, Any]] = []
    for rid, pid in pids.items():
        trace_events.append({
            "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
            "args": {"name": f"replica {rid or '?'}"},
        })
    for d in dumps:
        rid = str(d.get("replica_id", ""))
        pid = pids[rid]
        rank = int(d.get("rank", 0) or 0)
        tid = rank + 1  # Chrome treats tid 0 oddly; keep ranks 1-based
        trace_events.append({
            "name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
            "args": {"name": f"rank {rank}"},
        })
        open_spans: Dict[str, Dict[str, Any]] = {}
        events = sorted(d.get("events", []), key=lambda e: e.get("seq", 0))
        for ev in events:
            kind = ev.get("kind", "?")
            ts = float(ev.get("t_wall", 0.0)) * 1e6
            args = {
                k: v for k, v in ev.items()
                if k not in ("kind", "t_wall", "replica_id", "rank")
                and v is not None
            }
            if kind in _SPAN_PAIRS:
                # held until its end arrives; a start whose end never came
                # (a crash mid-quorum) degrades to an instant
                prev = open_spans.pop(kind, None)
                if prev is not None:
                    trace_events.append(prev["instant"])
                open_spans[kind] = {
                    "ts": ts, "args": args,
                    "instant": _instant(kind, ts, pid, tid, args),
                }
                continue
            if kind in _SPAN_ENDS:
                start = open_spans.pop(_SPAN_ENDS[kind], None)
                if start is not None:
                    merged = dict(start["args"])
                    merged.update(args)
                    trace_events.append({
                        "name": _SPAN_NAMES[_SPAN_ENDS[kind]], "ph": "X",
                        "cat": "torchft_tpu",
                        "ts": start["ts"],
                        "dur": max(0.0, ts - start["ts"]),
                        "pid": pid, "tid": tid, "args": merged,
                    })
                    continue
                # an end whose start the ring dropped: a plain instant
            trace_events.append(_instant(kind, ts, pid, tid, args))
        for pending in open_spans.values():  # unclosed starts
            trace_events.append(pending["instant"])
    trace_events.sort(key=lambda e: (e["ph"] == "M" and -1, e.get("ts", 0)))
    return {"traceEvents": trace_events, "displayTimeUnit": "ms"}


def _instant(kind: str, ts: float, pid: int, tid: int,
             args: Dict[str, Any]) -> Dict[str, Any]:
    return {
        "name": kind, "ph": "i", "s": "t", "cat": "torchft_tpu",
        "ts": ts, "pid": pid, "tid": tid, "args": args,
    }


def validate_chrome_trace(trace: Any) -> List[str]:
    """Structural check of a ``to_chrome_trace`` result: the list of
    problems, empty when ``trace`` is a valid Chrome trace_event JSON
    container."""
    problems: List[str] = []
    if not isinstance(trace, dict):
        return [f"trace is {type(trace).__name__}, not a dict"]
    evs = trace.get("traceEvents")
    if not isinstance(evs, list):
        return ["traceEvents missing or not a list"]
    for i, ev in enumerate(evs):
        if not isinstance(ev, dict):
            problems.append(f"traceEvents[{i}] not a dict")
            continue
        for key in ("name", "ph", "pid"):
            if key not in ev:
                problems.append(f"traceEvents[{i}] missing {key!r}")
        ph = ev.get("ph")
        if ph not in ("M", "i", "X", "B", "E"):
            problems.append(f"traceEvents[{i}] bad ph {ph!r}")
        if ph in ("i", "X") and not isinstance(ev.get("ts"), (int, float)):
            problems.append(f"traceEvents[{i}] missing numeric ts")
        if ph == "X" and not isinstance(ev.get("dur"), (int, float)):
            problems.append(f"traceEvents[{i}] X event missing dur")
    return problems
