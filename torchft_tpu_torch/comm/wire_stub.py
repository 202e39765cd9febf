"""Manager facade over a raw CommContext for single-process harnesses.

Twin of ``torchft_tpu/comm/wire_stub.py``. Tests and drills drive the
LocalSGD/DiLoCo round machinery and the sharded weight update over a real
loopback transport without a control plane. Those wrappers probe the
manager surface by name (``wire_compensable``, ``quorum_fence``,
``wire_nbytes``, ``reduce_scatter_arrays``, ``allgather_arrays``,
``wire_generation``, ``transport_world_size``, ``transport_rank``), so a
hand-rolled copy that drifted would silently exercise the fallback path
instead of the real one: one shared stub keeps every harness on the same
surface.

Semantics: quorum, fence and heal are no-ops, AVG divides float payloads by
the wire world, and ``should_commit`` mirrors the Manager's error-latch vote
(a reported error aborts the round). ``events`` and ``metrics`` are the
port's ``EventRecorder`` and ``Metrics``.
"""

from __future__ import annotations

import threading
from concurrent.futures import Future
from typing import Any, Callable, List, Optional, Sequence

import numpy as np

from torchft_tpu_torch.comm.context import ReduceOp, Work
from torchft_tpu_torch.futures import future_chain
from torchft_tpu_torch.utils.events import EventRecorder
from torchft_tpu_torch.utils.metrics import Metrics

__all__ = ["WireStubManager", "run_stub_ranks"]

_FLOATS = (np.float32, np.float64)


def run_stub_ranks(store_addr: str, prefix: str, world: int,
                   fn: Callable[["WireStubManager", int], Any],
                   ctx_factory: Callable[[], Any],
                   timeout: float = 120.0) -> List[Any]:
    """Thread-per-rank loopback harness: one context per rank
    (``ctx_factory()``), configured against ``store_addr/prefix``, wrapped
    in a :class:`WireStubManager`, running ``fn(mgr, rank)`` concurrently.
    Returns the per-rank results; any rank's exception aggregates into one
    RuntimeError; the contexts always shut down."""
    ctxs = [ctx_factory() for _ in range(world)]
    results: List[Any] = [None] * world
    errors: List[str] = []

    def _worker(rank: int) -> None:
        try:
            ctxs[rank].configure(f"{store_addr}/{prefix}", rank, world)
            results[rank] = fn(WireStubManager(ctxs[rank], world), rank)
        except Exception as e:  # noqa: BLE001 — aggregated below
            errors.append(f"rank {rank}: {e!r}")

    threads = [threading.Thread(target=_worker, args=(r,))
               for r in range(world)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=timeout)
    for ctx in ctxs:
        ctx.shutdown()
    if errors or any(r is None for r in results):
        raise RuntimeError("; ".join(errors) or "a rank hung")
    return results


class WireStubManager:
    """The Manager surface the outer-sync and sharded-update wrappers read,
    over ``ctx`` alone, at a fixed wire world of ``world``."""

    def __init__(self, ctx: Any, world: int) -> None:
        self._ctx = ctx
        self._world = int(world)
        self.metrics = Metrics()
        self.metrics.label("comm_backend", self.comm_backend())
        # the wrappers emit round_abort, reshard and redist_plan through
        # manager.events: a live recorder keeps harnesses on that path
        self.events = EventRecorder(replica_id="stub", rank=0)
        set_events = getattr(ctx, "set_events", None)
        if callable(set_events):
            set_events(self.events)
        self._use_async_quorum = True
        self._error: Optional[BaseException] = None
        self._stage_index = 0
        self._stage_count = 1

    def comm_backend(self) -> str:
        return str(getattr(self._ctx, "backend_name", "none"))

    # -- quorum and commit ---------------------------------------------------

    def start_quorum(self, **kw: Any) -> None:
        self._error = None

    def quorum_fence(self) -> None:
        pass

    def wait_quorum(self) -> None:
        pass

    def did_heal(self) -> bool:
        return False

    def errored(self) -> Optional[BaseException]:
        return self._error

    def report_error(self, e: BaseException) -> None:
        if self._error is None:
            self._error = e

    def should_commit(self) -> bool:
        return self._error is None

    def is_participating(self) -> bool:
        return True

    def num_participants(self) -> int:
        return self._world

    # -- wire introspection --------------------------------------------------

    def transport_world_size(self) -> int:
        return self._world

    def transport_rank(self) -> int:
        rank = getattr(self._ctx, "rank", None)
        return int(rank()) if callable(rank) else 0

    def is_solo_wire(self) -> bool:
        return self._error is None and self._world == 1

    def wire_is_lossy(self) -> bool:
        return self._ctx.wire_is_lossy()

    def wire_compensable(self) -> bool:
        return self._ctx.wire_compensable()

    def wire_generation(self) -> int:
        return self._ctx.wire_generation()

    def wire_roundtrip(self, src: np.ndarray, out: np.ndarray) -> None:
        self._ctx.wire_roundtrip(src, out)

    def wire_nbytes(self, a: np.ndarray) -> int:
        return self._ctx.wire_nbytes(a)

    def comm_unsupported_reason(self, algorithm: str, compression: str,
                                op: str = ReduceOp.SUM,
                                topology: str = "flat") -> Optional[str]:
        return self._ctx.unsupported_reason(algorithm, compression, op,
                                            topology)

    def comm_supports(self, algorithm: str, compression: str,
                      op: str = ReduceOp.SUM, topology: str = "flat") -> bool:
        return self._ctx.supports(algorithm, compression, op, topology)

    # -- pipeline-plane surface (the Manager's bind_stage) -------------------

    def bind_stage(self, stage_index: int, stage_count: int) -> None:
        stage_index, stage_count = int(stage_index), int(stage_count)
        if not 0 <= stage_index < stage_count:
            raise ValueError(
                f"stage_index {stage_index} outside [0, {stage_count})")
        self._stage_index = stage_index
        self._stage_count = stage_count
        self.metrics.gauge("pipe_stage_index", float(stage_index))
        self.metrics.gauge("pipe_stage_count", float(stage_count))

    def stage_index(self) -> int:
        return self._stage_index

    def stage_count(self) -> int:
        return self._stage_count

    # -- collectives ---------------------------------------------------------

    def _scaled(self, reduced: Sequence[np.ndarray],
                which: Callable[[int], bool]) -> List[np.ndarray]:
        scale = np.float32(1.0 / self._world)
        reduced = list(reduced)
        for i, a in enumerate(reduced):
            if which(i) and a.dtype in _FLOATS:
                np.multiply(a, a.dtype.type(scale), out=a)
        return reduced

    def allreduce_arrays(self, arrays: Sequence[np.ndarray],
                         op: str = ReduceOp.SUM,
                         topology: Optional[str] = None) -> Work:
        # the keyword is passed only when set, as the Manager does, so a
        # context without it keeps working
        if topology is None:
            work = self._ctx.allreduce(list(arrays), ReduceOp.SUM)
        else:
            work = self._ctx.allreduce(list(arrays), ReduceOp.SUM,
                                       topology=topology)
        return Work(future_chain(
            work.future(), lambda f: self._scaled(f.result(),
                                                  lambda i: True)))

    def reduce_scatter_arrays(self, arrays: Sequence[np.ndarray],
                              op: str = ReduceOp.SUM,
                              owners: Optional[Sequence[int]] = None
                              ) -> Work:
        """The allreduce's scaling, applied to this rank's OWNED arrays
        only (the others are unspecified after a reduce_scatter, the
        Manager's rule)."""
        arrays = list(arrays)
        if owners is None:
            owners = [i % self._world for i in range(len(arrays))]
        owners = [int(o) for o in owners]
        work = self._ctx.reduce_scatter(arrays, ReduceOp.SUM, owners)
        my = self.transport_rank()

        def _avg(f: Future) -> List[np.ndarray]:
            return self._scaled(f.result(), lambda i: owners[i] == my)

        return Work(future_chain(work.future(), _avg))

    def allgather_arrays(self, arrays: Sequence[np.ndarray]) -> Work:
        return self._ctx.allgather(list(arrays))
