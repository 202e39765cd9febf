"""Reconfigurable cross-replica communication contexts.

Twin of ``torchft_tpu/comm/context.py``. Gradient averaging across replica
groups is the plane whose membership changes per step with the quorum; a
``CommContext`` abstracts it: host-side collectives that are torn down and
rebuilt at step boundaries (``configure``), with error-latching futures
instead of job-killing exceptions.

Buffers are numpy arrays in host memory (zero-copy views of CPU tensors);
CUDA gradients are staged through pinned host buffers by ``ddp.py`` before
they reach a context.
"""

from __future__ import annotations

import logging
import threading
from abc import ABC, abstractmethod
from concurrent.futures import Future
from datetime import timedelta
from typing import List, Optional, Sequence

import numpy as np

from torchft_tpu_torch.futures import completed_future, failed_future

logger = logging.getLogger(__name__)

__all__ = [
    "Work",
    "CompletedWork",
    "FailedWork",
    "CommContext",
    "DummyCommContext",
    "ErrorSwallowingCommContext",
    "ManagedCommContext",
    "ReduceOp",
]


class ReduceOp:
    SUM = "sum"
    AVG = "avg"
    MAX = "max"
    MIN = "min"


class Work:
    """Handle for an in-flight collective. ``future()`` resolves to the
    op's result (list of np.ndarray) or raises the transport error."""

    def __init__(self, fut: "Future[List[np.ndarray]]") -> None:
        self._fut = fut

    def wait(self, timeout: "float | timedelta | None" = None) -> bool:
        if isinstance(timeout, timedelta):
            timeout = timeout.total_seconds()
        self._fut.result(timeout=timeout)
        return True

    def future(self) -> "Future[List[np.ndarray]]":
        return self._fut

    def add_done_callback(self, fn) -> None:
        """``fn(future)`` runs on the completing thread (a transport lane
        for TcpCommContext): keep it cheap."""
        self._fut.add_done_callback(fn)


class CompletedWork(Work):
    """Immediately-successful work."""

    def __init__(self, result: Optional[List[np.ndarray]] = None) -> None:
        super().__init__(completed_future(result if result is not None else []))


class FailedWork(Work):
    def __init__(self, exc: Exception) -> None:
        super().__init__(failed_future(exc))


class CommContext(ABC):
    """Abstract reconfigurable cross-replica collective context.

    ``configure(store_addr, rank, world_size)`` tears down any previous
    transport state and rebuilds for the new membership. The store address
    carries a per-quorum prefix (``host:port/torchft/{quorum_id}/...``) so
    stale rounds cannot cross-talk.
    """

    # "host" for the socket transport, "cuda" for the on-device plane
    # (comm/cuda_backend.py), "none" for identity/test contexts.
    backend_name = "none"

    def __init__(self) -> None:
        self._rank = 0
        self._world_size = 1

    # ------------------------------------------------- capability query
    # One definition of which (algorithm, compression, op, topology) combos
    # each backend runs, shared by ctor validation and
    # Manager.comm_unsupported_reason.

    @classmethod
    def unsupported_reason(
        cls, algorithm: str, compression: str, op: str = ReduceOp.SUM,
        topology: str = "flat",
    ) -> Optional[str]:
        """``None`` when this backend can run ``algorithm`` with
        ``compression`` for ``op`` over ``topology``, else a prescriptive
        error string. Identity/test contexts move no bytes, so they
        "support" every combo; real data planes override."""
        return None

    @classmethod
    def supports(
        cls, algorithm: str, compression: str, op: str = ReduceOp.SUM,
        topology: str = "flat",
    ) -> bool:
        return cls.unsupported_reason(
            algorithm, compression, op, topology
        ) is None

    @staticmethod
    def _prepare(a) -> np.ndarray:
        """Donation contract: allreduce reduces in place, so the submitted
        array must be contiguous and writable — anything else is copied once
        here; caller-owned staging buffers pass through untouched and the
        future resolves to those same arrays, reduced."""
        a = np.asarray(a)
        if not (a.flags["C_CONTIGUOUS"] and a.flags["WRITEABLE"]):
            a = np.array(a)
        return a

    @abstractmethod
    def configure(self, store_addr: str, rank: int, world_size: int) -> None:
        ...

    @abstractmethod
    def allreduce(
        self, arrays: Sequence[np.ndarray], op: str = ReduceOp.SUM,
        topology: Optional[str] = None,
    ) -> Work:
        """Reduce arrays across ranks. The caller DONATES ``arrays``: the
        implementation may reduce in place and resolve the future to the
        submitted arrays themselves. Do not read a donated array until the
        future resolves; on error its contents are unspecified.

        ``topology`` selects the data path of this op: "flat" (one tier
        spanning the wire), "hier" (reduce within each domain, exchange
        across domains through the egress ranks, broadcast within; needs a
        context configured for it) or None (the context's default).
        Identity contexts ignore it."""

    def reduce_scatter(
        self, arrays: Sequence[np.ndarray], op: str = ReduceOp.SUM,
        owners: "Optional[Sequence[int]]" = None,
    ) -> Work:
        """Reduce ``arrays`` across ranks, delivering each array's result
        only to its owner rank (``owners[i]``, default ``i % world_size``):
        bitwise what :meth:`allreduce` gives there; the other arrays'
        contents are unspecified (donation contract)."""
        raise NotImplementedError(
            f"{type(self).__name__} does not implement reduce_scatter; use "
            "the host (TcpCommContext) or cuda (CudaCommContext) data plane"
        )

    def allgather(self, arrays: Sequence[np.ndarray]) -> Work:
        """Future resolves to a list of per-rank lists of arrays."""
        raise NotImplementedError(
            f"{type(self).__name__} does not implement allgather"
        )

    def broadcast(self, arrays: Sequence[np.ndarray], root: int = 0) -> Work:
        """Future resolves to root's arrays on every rank."""
        raise NotImplementedError(
            f"{type(self).__name__} does not implement broadcast"
        )

    def size(self) -> int:
        return self._world_size

    def rank(self) -> int:
        return self._rank

    def shutdown(self) -> None:  # noqa: B027 — optional hook
        pass

    def errored(self) -> Optional[Exception]:
        """Latched transport error, if any (cleared by configure)."""
        return None

    # ------------------------------------------- data-plane commit votes
    # Backends that fold a 1-byte health vote into their collectives (the
    # TCP wire) override these. The defaults describe a backend with no
    # vote channel, which the Manager's fast path treats as ABSENT: it
    # falls back to the full commit barrier.

    def set_vote_health(self, fn) -> None:  # noqa: B027 — optional hook
        """Install the local health provider for data-plane votes:
        ``fn() -> bool`` (True = healthy). Backends without a vote channel
        ignore it."""

    def take_commit_vote(self) -> "Optional[bool]":
        """Windowed aggregate of the health votes that rode this backend's
        collectives since the last call: True when at least one voted op
        completed and every participant was healthy, False on any dissent,
        None when no voted op completed. Default: never present."""
        return None

    # ----------------------------------------------- wire introspection
    # The defaults describe an identity wire; the on-device plane
    # overrides. The DDP error-feedback arena keys off these.

    def wire_codec_name(self) -> str:
        """Name of the allreduce wire codec ("none": payloads untouched)."""
        return "none"

    def wire_is_lossy(self) -> bool:
        """True when the wire codec loses precision (bf16/fp16/int8)."""
        return False

    def wire_compensable(self) -> bool:
        """True when THIS rank's contribution crosses the wire through the
        lossy codec (role-aware) — the gate for error feedback."""
        return False

    def wire_generation(self) -> int:
        """Transport incarnation, bumped by configure: wire-derived
        step-persistent state (error-feedback residuals) resets on it."""
        return 0

    def wire_roundtrip(self, src: np.ndarray, out: np.ndarray) -> None:
        """Write the wire's local image of ``src`` (decode(encode(src)) on
        the chunk grid) into ``out``. Identity wire: a copy."""
        np.copyto(out, src)

    def wire_nbytes(self, a: np.ndarray) -> int:
        """Encoded size of ``a`` as one allreduce contribution. Identity
        wire: the raw byte count."""
        return int(np.asarray(a).nbytes)


class DummyCommContext(CommContext):
    """Context that completes every op with its own inputs — the
    cross-replica context when only one replica group participates."""

    def __init__(self, rank: int = 0, world_size: int = 1) -> None:
        super().__init__()
        self._rank = rank
        self._world_size = world_size
        self.configure_count = 0

    def configure(self, store_addr: str, rank: int, world_size: int) -> None:
        self._rank = rank
        self._world_size = world_size
        self.configure_count += 1

    def allreduce(
        self, arrays: Sequence[np.ndarray], op: str = ReduceOp.SUM,
        topology: Optional[str] = None,
    ) -> Work:
        return CompletedWork(list(arrays))

    def reduce_scatter(
        self, arrays: Sequence[np.ndarray], op: str = ReduceOp.SUM,
        owners: "Optional[Sequence[int]]" = None,
    ) -> Work:
        return CompletedWork(list(arrays))

    def allgather(self, arrays: Sequence[np.ndarray]) -> Work:
        return CompletedWork([list(arrays)])

    def broadcast(self, arrays: Sequence[np.ndarray], root: int = 0) -> Work:
        return CompletedWork(list(arrays))


class ErrorSwallowingCommContext(CommContext):
    """Wrapper that latches the first transport error and turns subsequent
    ops into no-ops until the next configure — one failed collective
    poisons the step, not the process."""

    def __init__(self, inner: CommContext) -> None:
        super().__init__()
        self._inner = inner
        self._error: Optional[Exception] = None
        self._lock = threading.Lock()

    @property
    def backend_name(self) -> str:  # type: ignore[override]
        return self._inner.backend_name

    def configure(self, store_addr: str, rank: int, world_size: int) -> None:
        with self._lock:
            self._error = None
        self._inner.configure(store_addr, rank, world_size)

    def errored(self) -> Optional[Exception]:
        with self._lock:
            return self._error

    def report_error(self, exc: Exception) -> None:
        with self._lock:
            if self._error is None:
                self._error = exc
                logger.warning("comm context error latched: %s", exc)

    def _wrap(self, work: Work, fallback: list) -> Work:
        out: "Future[List[np.ndarray]]" = Future()
        out.set_running_or_notify_cancel()

        def _done(f: Future) -> None:
            exc = f.exception()
            if exc is not None:
                self.report_error(exc)  # type: ignore[arg-type]
                out.set_result(fallback)  # swallowed: op becomes identity
            else:
                out.set_result(f.result())

        work.future().add_done_callback(_done)
        return Work(out)

    def allreduce(
        self, arrays: Sequence[np.ndarray], op: str = ReduceOp.SUM,
        topology: Optional[str] = None,
    ) -> Work:
        if self.errored() is not None:
            return CompletedWork(list(arrays))
        return self._wrap(
            self._inner.allreduce(arrays, op, topology=topology),
            list(arrays))

    def reduce_scatter(
        self, arrays: Sequence[np.ndarray], op: str = ReduceOp.SUM,
        owners: "Optional[Sequence[int]]" = None,
    ) -> Work:
        if self.errored() is not None:
            return CompletedWork(list(arrays))
        return self._wrap(self._inner.reduce_scatter(arrays, op, owners),
                          list(arrays))

    def allgather(self, arrays: Sequence[np.ndarray]) -> Work:
        if self.errored() is not None:
            return CompletedWork([list(arrays)])
        return self._wrap(self._inner.allgather(arrays), [list(arrays)])

    def broadcast(self, arrays: Sequence[np.ndarray], root: int = 0) -> Work:
        if self.errored() is not None:
            return CompletedWork(list(arrays))
        return self._wrap(self._inner.broadcast(arrays, root), list(arrays))

    def size(self) -> int:
        return self._inner.size()

    def rank(self) -> int:
        return self._inner.rank()

    def shutdown(self) -> None:
        self._inner.shutdown()

    def wire_codec_name(self) -> str:
        return self._inner.wire_codec_name()

    def wire_is_lossy(self) -> bool:
        return self._inner.wire_is_lossy()

    def wire_compensable(self) -> bool:
        return self._inner.wire_compensable()

    def wire_generation(self) -> int:
        return self._inner.wire_generation()

    def wire_roundtrip(self, src: np.ndarray, out: np.ndarray) -> None:
        self._inner.wire_roundtrip(src, out)

    def wire_nbytes(self, a: np.ndarray) -> int:
        return self._inner.wire_nbytes(a)

    def set_vote_health(self, fn) -> None:
        self._inner.set_vote_health(fn)

    def take_commit_vote(self) -> "Optional[bool]":
        return self._inner.take_commit_vote()

    # instance-level shadows of the classmethods: capability follows the
    # wrapped backend, not this wrapper's identity default
    def unsupported_reason(  # type: ignore[override]
        self, algorithm: str, compression: str, op: str = ReduceOp.SUM,
        topology: str = "flat",
    ) -> Optional[str]:
        return self._inner.unsupported_reason(
            algorithm, compression, op, topology
        )

    def supports(  # type: ignore[override]
        self, algorithm: str, compression: str, op: str = ReduceOp.SUM,
        topology: str = "flat",
    ) -> bool:
        return self._inner.supports(algorithm, compression, op, topology)


class ManagedCommContext(CommContext):
    """Context that routes every collective through a Manager so errors and
    quorum state are handled centrally. size() reports the number of
    participating replicas in the current quorum."""

    def __init__(self, manager) -> None:  # torchft_tpu_torch.manager.Manager
        super().__init__()
        self._manager = manager

    @property
    def backend_name(self) -> str:  # type: ignore[override]
        return self._manager.comm_backend()

    def configure(self, store_addr: str, rank: int, world_size: int) -> None:
        raise RuntimeError(
            "ManagedCommContext is configured by its Manager, not directly"
        )

    def allreduce(
        self, arrays: Sequence[np.ndarray], op: str = ReduceOp.SUM,
        topology: Optional[str] = None,
    ) -> Work:
        return self._manager.allreduce_arrays(arrays, op=op,
                                              topology=topology)

    def reduce_scatter(
        self, arrays: Sequence[np.ndarray], op: str = ReduceOp.SUM,
        owners: "Optional[Sequence[int]]" = None,
    ) -> Work:
        return self._manager.reduce_scatter_arrays(arrays, op=op,
                                                   owners=owners)

    def allgather(self, arrays: Sequence[np.ndarray]) -> Work:
        return self._manager.allgather_arrays(arrays)

    def broadcast(self, arrays: Sequence[np.ndarray], root: int = 0) -> Work:
        raise NotImplementedError(
            "managed broadcast is not part of the manager surface"
        )

    def size(self) -> int:
        return self._manager.num_participants()

    def rank(self) -> int:
        return self._manager.participating_rank() or 0

    def wire_codec_name(self) -> str:
        return self._manager.wire_codec_name()

    def wire_is_lossy(self) -> bool:
        return self._manager.wire_is_lossy()

    def wire_compensable(self) -> bool:
        return self._manager.wire_compensable()

    def wire_generation(self) -> int:
        return self._manager.wire_generation()

    def wire_roundtrip(self, src: np.ndarray, out: np.ndarray) -> None:
        self._manager.wire_roundtrip(src, out)

    def wire_nbytes(self, a: np.ndarray) -> int:
        return self._manager.wire_nbytes(a)

    def unsupported_reason(  # type: ignore[override]
        self, algorithm: str, compression: str, op: str = ReduceOp.SUM,
        topology: str = "flat",
    ) -> Optional[str]:
        return self._manager.comm_unsupported_reason(
            algorithm, compression, op, topology
        )

    def supports(  # type: ignore[override]
        self, algorithm: str, compression: str, op: str = ReduceOp.SUM,
        topology: str = "flat",
    ) -> bool:
        return self.unsupported_reason(
            algorithm, compression, op, topology
        ) is None
