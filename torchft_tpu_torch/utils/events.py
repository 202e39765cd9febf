"""Flight recorder: a bounded ring buffer of structured lifecycle events.

Twin of ``torchft_tpu/utils/events.py`` (the recorder; the Chrome-trace
export is not ported). The metrics sink (utils/metrics.py) answers "how
long do things take"; this answers "what happened when": a discarded step,
a heal, a latched error each leave one structured event. The Manager owns
one recorder per process (``manager.events``).

Event vocabulary of the port (all emitted by manager.py):

    quorum_start / quorum_complete   the async quorum RPC
    step_commit / step_discard       the commit barrier
    heal_start / heal_done           heal assignment -> healed state applied
    error_latched                    first latch of an error episode

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
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["EventRecorder"]


_DEFAULT_CAPACITY = 4096


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
