"""Manager — the per-step fault-tolerance runtime.

Twin of ``torchft_tpu/manager.py``. One Manager runs in every worker process
of a replica group; rank 0 additionally embeds the native manager server
(``control.ManagerServer``) that talks to the lighthouse.

Per-step protocol (driven by ``optim.OptimizerWrapper``):

    start_quorum     — async quorum on a 1-thread executor, overlapping the
                       forward pass; reconfigures the data plane when the
                       wire membership changes; serves or fetches a heal
    allreduce_arrays — fault-tolerant cross-replica gradient averaging;
                       errors are latched, not raised
    should_commit    — drain pending work, apply a pending heal, two-phase
                       commit barrier; True => apply the optimizer update

Steady-state fast path (the JAX package's epoch lease): a full quorum from
a lighthouse started with ``lease_ms`` grants a lease on the membership
epoch it announced, renewed off the step path by an EpochWatch long-poll.
While it stands, ``start_quorum`` is a local check and ``should_commit``
commits on the 1-byte health vote that rode the step's own collective:
zero control RPCs per step. Any epoch bump, latch, expiry, or an absent or
dissenting vote breaks the lease, and the step takes the full barrier.
``TORCHFT_TPU_FASTPATH=0`` disables it. Gradient normalization uses the
runtime ``num_participants``.

Multi-tenancy (the JAX package's job-scoped managers): ``job_id`` places
the group in one job of a shared lighthouse, and every group-store key the
Manager writes is prefixed ``job:<id>/`` ("default" keeps the unprefixed
keys). A quorum answer that evicts the group (a higher-priority job claimed
its capacity) latches an error, so the step does not commit, and
``is_evicted()`` turns True for good. ``data_plane=False`` makes the group
an observer: in every quorum and commit barrier, never on the gradient
wire, never a participant, never healed.
"""

from __future__ import annotations

import hashlib
import logging
import os
import socket as _socket
import threading
import time
import uuid
from concurrent.futures import Future, ThreadPoolExecutor
from datetime import timedelta
from enum import Enum
from typing import Any, Callable, Dict, List, Optional, Sequence, TypeVar

import numpy as np
import torch

from torchft_tpu_torch.checkpointing import CheckpointServer, CheckpointTransport
from torchft_tpu_torch.comm.context import CommContext, CompletedWork, ReduceOp, Work
from torchft_tpu_torch.comm.store import StoreClient
from torchft_tpu_torch.comm.topology import DomainTopology
from torchft_tpu_torch.control import ManagerClient, ManagerServer
from torchft_tpu_torch.futures import future_chain, future_timeout
from torchft_tpu_torch.utils.events import EventRecorder
from torchft_tpu_torch.utils.metrics import Metrics
from torchft_tpu_torch.utils.serialization import (
    from_host,
    host_view,
    is_tensor_leaf,
    to_host,
    to_numpy,
    tree_leaves,
    tree_map,
)

logger = logging.getLogger(__name__)

T = TypeVar("T")

MANAGER_ADDR_KEY: str = "manager_addr"
REPLICA_ID_KEY: str = "replica_id"
MANAGER_PORT_ENV: str = "TORCHFT_TPU_MANAGER_PORT"
LIGHTHOUSE_ENV: str = "TORCHFT_TPU_LIGHTHOUSE"

__all__ = ["Manager", "WorldSizeMode"]


def _is_float_dtype(dt: np.dtype) -> bool:
    """True for numpy's floats and for ml_dtypes' (bfloat16, the float8
    types), which ``np.issubdtype`` does not class under ``np.floating``:
    a bf16 bucket on the host wire is scaled like any other float."""
    return np.issubdtype(dt, np.floating) or "float" in np.dtype(dt).name


def _host_array(leaf: Any) -> np.ndarray:
    """A leaf of :meth:`Manager.allreduce_pytree` on the host: a tensor
    copied (bfloat16 as ml_dtypes' bfloat16), a sharded leaf assembled, a
    numpy array as it is (donated)."""
    if isinstance(leaf, torch.Tensor):
        return host_view(to_host(leaf))
    if is_tensor_leaf(leaf):
        return to_numpy(leaf)
    return np.asarray(leaf)


def _cohort_fingerprint(replica_ids: "Sequence[str]") -> str:
    """Short stable digest of the wire membership, part of the transport
    rendezvous prefix (the same digest as the JAX package's)."""
    return hashlib.sha1("\x00".join(replica_ids).encode()).hexdigest()[:12]


def _seconds(t: "float | timedelta") -> float:
    return t.total_seconds() if isinstance(t, timedelta) else float(t)


def _build_comm_context(
    backend: str, options: "Optional[Dict[str, Any]]", timeout: float
) -> CommContext:
    """The Manager's ``comm_backend`` selector: the gradient data plane by
    name, built with ``options`` as its constructor's keyword arguments."""
    options = dict(options or {})
    options.setdefault("timeout", timeout)
    if backend == "host":
        from torchft_tpu_torch.comm.transport import TcpCommContext

        return TcpCommContext(**options)
    if backend == "cuda":
        from torchft_tpu_torch.comm.cuda_backend import CudaCommContext

        return CudaCommContext(**options)
    raise ValueError(
        f"unknown comm_backend {backend!r}; have 'host' (socket "
        "transport) and 'cuda' (the on-device plane)"
    )


class WorldSizeMode(Enum):
    """DYNAMIC: every healthy replica contributes; gradients are normalized
    by the actual participant count. FIXED_WITH_SPARES: exactly
    ``min_replica_size`` replicas contribute; spares contribute zeros."""

    DYNAMIC = 0
    FIXED_WITH_SPARES = 1


class Manager:
    """Fault-tolerant training loop manager.

    ``comm`` is the cross-replica CommContext; without one, ``comm_backend``
    selects the data plane to build, "host" (TcpCommContext, the default)
    or "cuda" (CudaCommContext, comm/cuda_backend.py), with
    ``comm_options`` as its constructor's keyword arguments (algorithm,
    compression, chunk_bytes, ...). ``load_state_dict``/``state_dict``
    restore/capture the user's training state (model, optimizer,
    sampler...) for heals.

    ``data_plane=False``: an observer (a probe or an evaluator) that joins
    every quorum and commit barrier but stays off the gradient wire, out
    of the participant count and out of heals. ``job_id``: the job this
    group belongs to on a shared lighthouse. ``model_shards``: the devices
    one replica group spans, labelled with the wire world as
    ``mesh_shape`` ("{wire world}x{model_shards}").
    """

    def __init__(
        self,
        comm: Optional[CommContext] = None,
        load_state_dict: Optional[Callable[[T], None]] = None,
        state_dict: Optional[Callable[[], T]] = None,
        min_replica_size: Optional[int] = None,
        use_async_quorum: bool = True,
        timeout: "float | timedelta" = 60.0,
        quorum_timeout: "float | timedelta" = 60.0,
        connect_timeout: "float | timedelta" = 60.0,
        rank: Optional[int] = None,
        world_size: Optional[int] = None,
        world_size_mode: WorldSizeMode = WorldSizeMode.DYNAMIC,
        store_addr: Optional[str] = None,
        lighthouse_addr: Optional[str] = None,
        replica_id: Optional[str] = None,
        port: Optional[int] = None,
        hostname: Optional[str] = None,
        heartbeat_interval: "float | timedelta" = 0.1,
        checkpoint_transport: Optional[CheckpointTransport] = None,
        data_plane: bool = True,
        comm_backend: Optional[str] = None,
        comm_options: Optional[Dict[str, Any]] = None,
        model_shards: int = 1,
        job_id: str = "default",
    ) -> None:
        if min_replica_size is None:
            # a silently defaulted quorum floor of 1 would let every
            # partition-isolated replica keep committing (split brain)
            raise TypeError(
                "Manager() missing required argument: 'min_replica_size' "
                "(the quorum floor; there is no safe default)"
            )
        if (load_state_dict is None) != (state_dict is None):
            raise ValueError(
                "load_state_dict and state_dict must be provided together "
                "(or both omitted for a manager that never serves or "
                "receives a heal)"
            )
        self._timeout = _seconds(timeout)
        if comm is None:
            comm = _build_comm_context(comm_backend or "host", comm_options,
                                       self._timeout)
        else:
            if comm_options is not None:
                raise ValueError(
                    "comm_options applies only when the Manager builds the "
                    "context; pass the options to your own comm ctor"
                )
            actual = getattr(comm, "backend_name", None)
            if comm_backend is not None and actual != comm_backend:
                raise ValueError(
                    f"comm_backend={comm_backend!r} but the provided comm "
                    f"context is backend {actual!r}"
                )
        self._load_state_dict = load_state_dict
        self._user_state_dict = state_dict
        self._pending_state_dict: Optional[Dict[str, Any]] = None
        self._use_async_quorum = use_async_quorum
        self._quorum_timeout = _seconds(quorum_timeout)
        self._connect_timeout = _seconds(connect_timeout)
        self._world_size_mode = world_size_mode
        self._min_replica_size = min_replica_size
        self._data_plane = data_plane
        # the job rides every lighthouse request (the ManagerServer stamps
        # it) and prefixes every group-store key, so two jobs sharing one
        # store never collide; "default" keeps the unprefixed keys
        self._job_id = job_id or "default"
        self._store_prefix = ("" if self._job_id == "default"
                              else f"job:{self._job_id}/")
        # set for good when a quorum answer evicts this group
        self._evicted = False
        # the pipeline stage this group serves, of how many (bind_stage)
        self._stage_index = 0
        self._stage_count = 1

        store_addr = store_addr or (
            f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
        )
        self._rank = rank if rank is not None else int(os.environ.get("RANK", "0"))
        self._world_size = world_size or int(os.environ.get("WORLD_SIZE", "1"))

        if checkpoint_transport is None:
            checkpoint_transport = CheckpointServer(
                timeout=self._timeout, num_chunks=2
            )
        self._checkpoint_transport = checkpoint_transport
        self._commit_hook: "Optional[Callable[[int, int], None]]" = None
        self._executor = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="async_quorum"
        )
        self._quorum_future: Optional[Future] = None
        self._store = StoreClient(store_addr,
                                  connect_timeout=self._connect_timeout)
        self._comm = comm
        self._manager: Optional[ManagerServer] = None
        # the lighthouse this group is homed to, served by /telemetry
        self._lighthouse_addr: Optional[str] = None

        if self._rank == 0:
            if port is None:
                port = int(os.environ.get(MANAGER_PORT_ENV, 0))
            lighthouse_addr = lighthouse_addr or os.environ[LIGHTHOUSE_ENV]
            self._lighthouse_addr = lighthouse_addr
            replica_id = (replica_id or "") + str(uuid.uuid4())
            self._manager = ManagerServer(
                replica_id=replica_id,
                lighthouse_addr=lighthouse_addr,
                hostname=hostname or _socket.gethostname(),
                bind=f"0.0.0.0:{port}",
                store_addr=store_addr,
                world_size=self._world_size,
                heartbeat_interval=_seconds(heartbeat_interval),
                connect_timeout=self._connect_timeout,
                job_id=self._job_id,
            )
            self._store.set(self._store_prefix + MANAGER_ADDR_KEY,
                            self._manager.address())
            self._store.set(self._store_prefix + REPLICA_ID_KEY, replica_id)
        # every rank advertises its checkpoint (and telemetry) server on
        # the group store, where scripts/fleet_top.py discovers it and a
        # donor rank finds its peers: their addresses ride its manifests,
        # so a healer can fetch a region from every rank that holds it
        self._store.set(f"{self._store_prefix}checkpoint_addr_{self._rank}",
                        self._checkpoint_transport.metadata())
        self._ckpt_fanout = self._world_size > 1 and hasattr(
            self._checkpoint_transport, "set_peers")

        addr = self._store.wait(
            self._store_prefix + MANAGER_ADDR_KEY,
            timeout=self._connect_timeout,
        ).decode()
        self._client = ManagerClient(addr, connect_timeout=self._connect_timeout)
        self._replica_id = self._store.wait(
            self._store_prefix + REPLICA_ID_KEY,
            timeout=self._connect_timeout,
        ).decode()
        self._logger = _ManagerLogger(self, self._replica_id, self._rank)
        # lifecycle events (quorum, heal, commit, errors); TORCHFT_TPU_EVENTS=0
        # disables the recorder
        self.events = EventRecorder(replica_id=self._replica_id,
                                    rank=self._rank)
        self._quorum_epoch: Optional[int] = None
        # wire membership (transport_replica_ids) of the last quorum: the
        # diff against the next quorum gives the member_dead events
        self._wire_members: "tuple" = ()

        self._step = 0
        # (quorum_id, wire fingerprint, in_transport) of the last successful
        # comm.configure: the transport reconfigures exactly when it changes
        self._transport_key: "Optional[tuple]" = None
        # Data-plane incarnation sent with every quorum request, bumped when
        # our transport latched an error that membership change alone would
        # not clear; the lighthouse then issues a fresh quorum_id so every
        # wire member reconfigures together.
        self._comm_epoch = 0
        self._transport_world_size = 1
        self._errored: Optional[Exception] = None
        self._errored_lock = threading.Lock()
        self._healing = False
        self._pending_work: List[Future] = []
        self._batches_committed = 0
        self._participating_rank: Optional[int] = None
        self._participating_world_size: int = 0
        self._replica_world_size: int = 0
        self._did_heal = False
        self._heal_t0: Optional[float] = None
        # one sink for the quorum / commit_barrier / allreduce timers, the
        # transport's lane timers and the heal gauges
        self.metrics = Metrics()
        # replicas x model shards, re-labelled at every reconfigure
        self.model_shards = max(1, int(model_shards))
        self._label_mesh_shape()
        for target in (comm, self._checkpoint_transport):
            set_metrics = getattr(target, "set_metrics", None)
            if callable(set_metrics):
                set_metrics(self.metrics)
        for target in (comm, self._checkpoint_transport):
            set_events = getattr(target, "set_events", None)
            if callable(set_events):
                set_events(self.events)
        # GET /telemetry/* frames its payload with this identity probe
        set_telemetry = getattr(self._checkpoint_transport, "set_telemetry",
                                None)
        if callable(set_telemetry):
            set_telemetry(self._telemetry_info)

        # --- steady-state fast path (epoch lease + data-plane votes) ------
        # Only a single-rank group steps fast: the ManagerServer's fan-in
        # across local ranks is itself a control RPC per rank.
        self._lease_enabled = (
            os.environ.get("TORCHFT_TPU_FASTPATH", "1") not in ("0", "false")
            and self._world_size == 1
            # an observer's vote rides a private one-member wire, which
            # proves nothing about the cohort
            and self._data_plane
        )
        self._lease_lock = threading.Lock()
        self._lease_epoch: Optional[int] = None
        self._lease_ms = 0
        self._lease_deadline = 0.0  # monotonic
        self._lease_live = False
        self._lease_thread: Optional[threading.Thread] = None
        self._lease_stop = threading.Event()
        # armed by a fast start_quorum, consumed by the next should_commit
        self._fastpath_active = False
        # control RPCs of the current step (quorum + barrier), gauged as
        # control_rpcs_per_step: 0 on a fast-path step
        self._control_rpcs = 0
        self.metrics.gauge("control_rpcs_per_step", 0.0)
        # Domain discovery for topology="hier": home the comm's resolver to
        # the job's lighthouse /status.json on every rank (rank k's wire
        # spans rank-k processes, which hold no ManagerServer), unless the
        # caller installed one. A flat context never consults it.
        set_resolver = getattr(comm, "set_domain_resolver", None)
        lh_addr = self._lighthouse_addr or os.environ.get(LIGHTHOUSE_ENV)
        if callable(set_resolver) and lh_addr:
            set_resolver(DomainTopology(status_url=lh_addr))
        # the transport samples this when it stamps a step's vote byte
        set_vote_health = getattr(comm, "set_vote_health", None)
        if callable(set_vote_health):
            set_vote_health(lambda: self.errored() is None)

    # ------------------------------------------------------------- lifecycle

    def set_state_dict_fns(self, load_state_dict: Callable[[T], None],
                           state_dict: Callable[[], T]) -> None:
        self._load_state_dict = load_state_dict
        self._user_state_dict = state_dict

    def shutdown(self, wait: bool = True) -> None:
        """Shut down the manager server, checkpoint transport and comm."""
        # break the lease and stop the epoch watch first: a poll parked on
        # our own server would error when it goes down, and a restarted
        # group must not meet a stale watcher
        self._break_lease("shutdown")
        self._lease_stop.set()
        self._checkpoint_transport.shutdown(wait=wait)
        if self._manager is not None:
            self._manager.shutdown()
        self._executor.shutdown(wait=wait)
        self._comm.shutdown()
        thread = self._lease_thread
        if thread is not None and thread is not threading.current_thread():
            # the parked poll fails as soon as our server is down
            thread.join(timeout=max(1.0, self._lease_ms / 1000.0))

    # ------------------------------------------------------------ collectives

    def allreduce_arrays(self, arrays: Sequence[np.ndarray],
                         op: str = ReduceOp.SUM,
                         topology: Optional[str] = None) -> Work:
        """Fault-tolerant cross-replica allreduce of host arrays, scaled by
        1/num_participants for SUM and AVG:

        * after the first error this step, returns the input unchanged;
        * while healing or not participating, contributes zeros;
        * transport errors are latched, never raised — the future always
          completes (with the unused input as the default).

        The caller DONATES ``arrays``: the transport reduces in place, so the
        future may resolve to the very arrays submitted. ``topology``
        ("flat"/"hier") overrides the context's default data path for this
        op; None passes no override.
        """
        arrays = [np.asarray(a) for a in arrays]
        if not self._reduction_ready(arrays, op, "allreduce"):
            return CompletedWork(list(arrays))
        if not self.is_participating():
            arrays = [np.zeros_like(a) for a in arrays]
        try:
            submit_time = time.perf_counter()
            # AVG averages over participants, not the transport world
            # (healing members contribute zeros): reduce as SUM and scale.
            transport_op = ReduceOp.SUM if op == ReduceOp.AVG else op
            if topology is None:
                work = self._comm.allreduce(arrays, transport_op)
            else:
                work = self._comm.allreduce(arrays, transport_op,
                                            topology=topology)
            fut = future_chain(work.future(),
                               self._scaled(op, submit_time, None))
            return Work(self.wrap_future(fut, list(arrays)))
        except Exception as e:  # noqa: BLE001
            self._logger.exception(f"allreduce submit failed: {e}")
            self.report_error(e)
            return CompletedWork(list(arrays))

    def _reduction_ready(self, arrays: List[np.ndarray], op: str,
                         what: str) -> bool:
        """The reductions' prologue: AVG takes floating-point arrays only
        (raises); False, the op then returning its inputs, once this step
        has errored or when its quorum fails (latched)."""
        if op == ReduceOp.AVG and any(
            not _is_float_dtype(a.dtype) for a in arrays
        ):
            raise ValueError(
                "ReduceOp.AVG requires floating-point arrays; got "
                + str([str(a.dtype) for a in arrays])
            )
        if self.errored() is not None:
            return False
        try:
            self.wait_quorum()
        except Exception as e:  # quorum failed: latch and skip the step
            self._logger.exception(f"quorum failed in {what}: {e}")
            self.report_error(e)
            return False
        return True

    def _scaled(self, op: str, submit_time: float,
                owned: "Optional[Sequence[int]]"):
        """The continuation of a reduction: observe ``allreduce`` and scale
        the float results by 1/num_participants for SUM and AVG (only the
        arrays in ``owned``, when given: a reduce_scatter's others are
        unspecified)."""

        def _normalize(f: Future) -> List[np.ndarray]:
            self.metrics.observe("allreduce",
                                 time.perf_counter() - submit_time)
            reduced = list(f.result())
            if op not in (ReduceOp.SUM, ReduceOp.AVG):
                return reduced
            scale = 1.0 / max(1, self.num_participants())
            for i in (range(len(reduced)) if owned is None else owned):
                a = reduced[i]
                if _is_float_dtype(a.dtype):
                    s = np.asarray(scale).astype(a.dtype)
                    if a.flags.writeable:
                        np.multiply(a, s, out=a)
                    else:
                        reduced[i] = a * s
            return reduced

        return _normalize

    def reduce_scatter_arrays(self, arrays: Sequence[np.ndarray],
                              op: str = ReduceOp.SUM,
                              owners: "Optional[Sequence[int]]" = None
                              ) -> Work:
        """Fault-tolerant reduce_scatter: as :meth:`allreduce_arrays` (zeros
        while healing, errors latched and never raised, 1/num_participants
        scaling) except that each array's result lands only on its owner
        (``owners[i]``, default ``i % transport_world_size``). Owned arrays
        come back bitwise what the allreduce would give; the others are
        unspecified, and only owned arrays are scaled."""
        arrays = [np.asarray(a) for a in arrays]
        if not self._reduction_ready(arrays, op, "reduce_scatter"):
            return CompletedWork(list(arrays))
        world = max(1, self._transport_world_size)
        if owners is None:
            owners = [i % world for i in range(len(arrays))]
        owners = [int(o) for o in owners]
        my_rank = self._comm.rank()
        owned = [i for i, o in enumerate(owners) if o == my_rank]
        if not self.is_participating():
            arrays = [np.zeros_like(a) for a in arrays]
        try:
            submit_time = time.perf_counter()
            transport_op = ReduceOp.SUM if op == ReduceOp.AVG else op
            work = self._comm.reduce_scatter(arrays, transport_op, owners)
            fut = future_chain(work.future(),
                               self._scaled(op, submit_time, owned))
            return Work(self.wrap_future(fut, list(arrays)))
        except Exception as e:  # noqa: BLE001
            self._logger.exception(f"reduce_scatter submit failed: {e}")
            self.report_error(e)
            return CompletedWork(list(arrays))

    def allgather_arrays(self, arrays: Sequence[np.ndarray]) -> Work:
        """Fault-tolerant allgather with the allreduce error model (errors
        latched, never raised; ``[own arrays]`` is the degraded result). No
        scaling and no zeros: allgather carries state, and a healing
        member's contribution is whatever it advertises. Resolves to a
        list of per-rank array lists, by transport rank."""
        arrays = [np.asarray(a) for a in arrays]
        fallback = [list(arrays)]
        if self.errored() is not None:
            return CompletedWork(fallback)
        try:
            self.wait_quorum()
        except Exception as e:
            self._logger.exception(f"quorum failed in allgather: {e}")
            self.report_error(e)
            return CompletedWork(fallback)
        try:
            work = self._comm.allgather(arrays)
            return Work(self.wrap_future(work.future(), fallback))
        except Exception as e:  # noqa: BLE001
            self._logger.exception(f"allgather submit failed: {e}")
            self.report_error(e)
            return CompletedWork(fallback)

    def allreduce_pytree(self, tree: Any, op: str = ReduceOp.SUM) -> Future:
        """Reduce a tree of tensors and arrays across replica groups (the
        analog of DDP's comm hook). Its leaves, in ``jax.tree_util``'s
        order, go through :meth:`allreduce_arrays` under all of its rules.
        A tensor leaf is copied to the host and never written in place; it
        comes back as a tensor of its dtype on its own device (a sharded
        leaf in its own layout). A numpy leaf is donated and comes back
        numpy, any other leaf as a numpy array. The future resolves to the
        tree rebuilt as ``jax.tree_util`` rebuilds it (a dict's keys
        sorted)."""
        leaves = tree_leaves(tree)
        work = self.allreduce_arrays([_host_array(x) for x in leaves], op=op)

        def _back(leaf: Any, reduced: np.ndarray) -> Any:
            if isinstance(leaf, torch.Tensor):
                return from_host(reduced).reshape(leaf.shape).to(leaf.device)
            if is_tensor_leaf(leaf) and not isinstance(leaf, np.ndarray):
                return type(leaf).from_full(from_host(reduced),
                                            leaf.sharding)
            return reduced

        def _rebuild(f: Future) -> Any:
            it = iter(zip(leaves, f.result()))
            return tree_map(lambda _: _back(*next(it)), tree)

        return future_chain(work.future(), _rebuild)

    # ------------------------------------------------------------- telemetry

    def _telemetry_info(self) -> Dict[str, Any]:
        """Identity and live state framing every /telemetry response, in
        the JAX package's keys (plain attribute reads)."""
        return {
            "replica_id": self._replica_id,
            "rank": self._rank,
            "job_id": self._job_id,
            "evicted": self._evicted,
            "step": self._step,
            "epoch": self._quorum_epoch,
            "comm_backend": self.comm_backend(),
            "participating": self._participating_rank is not None,
            "healing": self._healing,
            "batches_committed": self._batches_committed,
            "stage_index": self._stage_index,
            "stage_count": self._stage_count,
            "lighthouse_addr": self._lighthouse_addr,
            "lease_live": self._lease_valid(),
            "lease_epoch": self._lease_epoch,
            "control_rpcs_per_step": self._control_rpcs,
        }

    # ---------------------------------------------------------- error model

    def report_error(self, e: Exception) -> None:
        """Latch an error: this step will not commit and the comm context
        reconfigures at the next quorum."""
        with self._errored_lock:
            first = self._errored is None
            self._errored = e
        if first and self.events:
            self.events.emit(
                "error_latched", step=self._step, epoch=self._quorum_epoch,
                source="manager", error=repr(e)[:200],
            )

    def errored(self) -> Optional[Exception]:
        with self._errored_lock:
            return self._errored

    def wrap_future(self, fut: Future, default: Any,
                    timeout: "float | timedelta | None" = None) -> Future:
        """Timeout + error-swallow continuation: on failure the future
        completes with ``default`` and the error is latched."""
        timed = future_timeout(
            fut, _seconds(timeout) if timeout else self._timeout
        )

        def _swallow(f: Future) -> Any:
            exc = f.exception()
            if exc is None:
                return f.result()
            self._logger.exception(f"got exception in future: {exc}")
            self.report_error(exc)  # type: ignore[arg-type]
            return default

        out = future_chain(timed, _swallow)
        self._pending_work.append(out)
        return out

    # ----------------------------------------------------------- epoch lease

    def _lease_valid(self) -> bool:
        with self._lease_lock:
            return (self._lease_live and self._lease_epoch is not None
                    and time.monotonic() < self._lease_deadline)

    def _grant_lease(self, epoch: int, lease_ms: int) -> None:
        """Arm (or re-arm) the lease from a full quorum's announcement and
        make sure the EpochWatch renewal thread runs."""
        with self._lease_lock:
            self._lease_epoch = epoch
            self._lease_ms = lease_ms
            self._lease_deadline = time.monotonic() + lease_ms / 1000.0
            self._lease_live = True
            self.metrics.incr("lease_grants")
            if self._lease_thread is None or not self._lease_thread.is_alive():
                self._lease_thread = threading.Thread(
                    target=self._epoch_watch_loop, name="epoch_watch",
                    daemon=True,
                )
                self._lease_thread.start()

    def _break_lease(self, reason: str, epoch: Optional[int] = None) -> None:
        """Invalidate the lease (idempotent). ``epoch`` keeps the watch
        thread from breaking a fresher lease than the one it watched."""
        with self._lease_lock:
            if not self._lease_live:
                return
            if epoch is not None and self._lease_epoch != epoch:
                return
            self._lease_live = False
            broken_epoch = self._lease_epoch
        self.metrics.incr("lease_breaks")
        if self.events:
            self.events.emit("lease_break", step=self._step,
                             epoch=self._quorum_epoch,
                             lease_epoch=broken_epoch, reason=reason)
        self._logger.info(f"lease broken ({reason}) lease_epoch={broken_epoch}")

    def _epoch_watch_loop(self) -> None:
        """Renew the lease off the step path: park an EpochWatch long-poll
        on the lighthouse (through our ManagerServer) at half the lease;
        an unchanged epoch re-stamps the deadline. A change, an error or
        shutdown breaks the lease and ends the loop; the next full
        quorum's grant starts it again."""
        while not self._lease_stop.is_set():
            with self._lease_lock:
                live, epoch = self._lease_live, self._lease_epoch
                lease_s = self._lease_ms / 1000.0
            if not live or epoch is None:
                return
            try:
                _, changed = self._client.epoch_watch(
                    epoch, timeout=max(0.05, lease_s / 2.0)
                )
            except Exception as e:  # noqa: BLE001 — an absent liveness signal
                self._break_lease(f"watch_error: {e!r}", epoch=epoch)
                return
            if changed:
                self._break_lease("epoch_advanced", epoch=epoch)
                return
            with self._lease_lock:
                if self._lease_live and self._lease_epoch == epoch:
                    self._lease_deadline = time.monotonic() + lease_s

    def _count_control_rpc(self) -> None:
        self._control_rpcs += 1
        self.metrics.gauge("control_rpcs_per_step", float(self._control_rpcs))

    # --------------------------------------------------------------- quorum

    def start_quorum(self, allow_heal: bool = True, shrink_only: bool = False,
                     timeout: "float | timedelta | None" = None) -> None:
        """Compute a new quorum (async by default, overlapping the forward
        pass) and ready the manager for a new step. Under a live lease
        this is a local check: no RPC. An observer never heals or donates
        (``allow_heal`` is forced False): it trains nothing, and in an
        all-observer quorum the native kernel would elect one."""
        if not self._data_plane:
            allow_heal = False
        if self._quorum_future is not None:
            try:
                self._quorum_future.result()
            except Exception as e:  # superseded by the quorum below
                self._logger.exception(
                    f"previous quorum failed, starting fresh: {e}"
                )

        # --- steady-state fast path ---------------------------------------
        # Lease live, watched epoch unchanged, no latch: the last full
        # quorum's membership and configured transport still describe the
        # fleet. Every invalidation edge falls through to the full path.
        self._fastpath_active = False
        self._control_rpcs = 0
        self.metrics.gauge("control_rpcs_per_step", 0.0)
        if self._lease_enabled and not shrink_only:
            t0 = time.perf_counter()
            if self.errored() is not None or self._comm.errored() is not None:
                self._break_lease("latch_edge")
            elif (not self._healing and self._transport_key is not None
                    and self._lease_valid()):
                # votes left over from an earlier step prove nothing about
                # this one: a step with no collective must find none (the
                # JAX package keeps them, and would commit such a step on
                # the last full-path step's vote)
                take_vote = getattr(self._comm, "take_commit_vote", None)
                if callable(take_vote):
                    take_vote()
                fast: Future = Future()
                fast.set_result(None)
                self._quorum_future = fast
                self._fastpath_active = True
                self.metrics.observe("quorum_fast", time.perf_counter() - t0)
                return

        with self._errored_lock:
            self._errored = None
        self._healing = False
        self._did_heal = False
        if self._comm.errored() is not None:
            # latched transport: request a coordinated reconfigure
            self._comm_epoch += 1
            self._logger.warn(
                f"transport latched ({self._comm.errored()}); bumping "
                f"comm_epoch to {self._comm_epoch}"
            )
        self._quorum_future = self._executor.submit(
            self._async_quorum,
            allow_heal=allow_heal,
            shrink_only=shrink_only,
            quorum_timeout=_seconds(timeout) if timeout else self._quorum_timeout,
        )
        if not self._use_async_quorum:
            self.wait_quorum()
            if self._healing:
                # sync mode: apply the fetched state before the forward pass
                self._apply_pending_state_dict()
                self._healing = False

    def wait_quorum(self) -> None:
        """Block until the in-flight quorum completes; the comm context is
        configured for the new membership after this returns."""
        assert self._quorum_future is not None, (
            "must call start_quorum before wait_quorum"
        )
        self._quorum_future.result()

    def quorum_fence(self) -> None:
        """Wait the in-flight quorum and apply a pending heal now, not at
        ``should_commit``: for loops that read the state between the
        quorum and the commit. ``did_heal()`` then tells the caller to
        re-read it. Raises whatever the quorum raised."""
        self.wait_quorum()
        if self._healing:
            self._apply_pending_state_dict()
            self._healing = False

    def _async_quorum(self, allow_heal: bool, shrink_only: bool,
                      quorum_timeout: float) -> None:
        if self.events:
            self.events.emit("quorum_start", step=self._step,
                             epoch=self._quorum_epoch)
        with self.metrics.timed("quorum"):
            self._count_control_rpc()
            quorum = self._client.quorum(
                rank=self._rank,
                step=self._step,
                checkpoint_metadata=self._checkpoint_transport.metadata(),
                shrink_only=shrink_only,
                timeout=quorum_timeout,
                data_plane=self._data_plane,
                comm_epoch=self._comm_epoch,
            )
        self._finish_quorum(quorum, allow_heal)

    def _evict(self, quorum) -> None:
        """The lighthouse's prescriptive preemption: a higher-priority job
        claimed this group's capacity, said in the quorum answer and not
        by a timeout. Latch (this step does not commit), leave the
        participant count, break the lease, and stay evicted."""
        self._evicted = True
        self._participating_rank = None
        self._participating_world_size = 0
        self._break_lease("job_preempted")
        if self.events:
            self.events.emit("job_preempted", step=self._step,
                             epoch=quorum.membership_epoch,
                             job_id=self._job_id)
        self._logger.warn(f"evicted from job {self._job_id!r} by a "
                          "higher-priority job; the step will not commit")
        self.report_error(RuntimeError(
            f"evicted: job {self._job_id!r} preempted by a higher-priority "
            "job"))

    def _finish_quorum(self, quorum, allow_heal: bool) -> None:
        if quorum.evicted:
            self._evict(quorum)
            return
        self._quorum_epoch = quorum.quorum_id
        # Async quorum: only the up-to-date (max-step) cohort participates;
        # healing replicas contribute zeros this step. Sync quorum: every
        # wire member participates. Both counts are of data-plane members:
        # an observer counted here would under-scale every average.
        if self._use_async_quorum or not allow_heal:
            self._participating_rank = quorum.max_rank
            self._participating_world_size = quorum.max_world_size
        elif quorum.transport_replica_ids:
            self._participating_rank = quorum.transport_rank
            self._participating_world_size = quorum.transport_world_size
        else:  # an answer without data-plane membership: every replica
            self._participating_rank = quorum.replica_rank
            self._participating_world_size = quorum.replica_world_size
        self._replica_world_size = quorum.replica_world_size
        if not self._data_plane:
            # off the wire, an observer contributes nothing, whatever its
            # step says
            self._participating_rank = None
        if self._world_size_mode == WorldSizeMode.FIXED_WITH_SPARES:
            self._participating_world_size = min(
                self._participating_world_size, self._min_replica_size
            )
            if (self._participating_rank is not None
                    and self._participating_rank >= self._min_replica_size):
                self._participating_rank = None

        # --- data-plane (re)configuration ---------------------------------
        # The wire spans the quorum's data-plane members. Healing replicas
        # stay members: in the heal step they receive the cohort's average
        # and apply it on top of the fetched state, which is what makes
        # recovery bitwise exact.
        if quorum.transport_replica_ids:
            in_transport = quorum.transport_rank is not None
            t_rank = quorum.transport_rank if in_transport else 0
            t_world = quorum.transport_world_size if in_transport else 1
            fingerprint = _cohort_fingerprint(quorum.transport_replica_ids)
        else:
            # an answer without data-plane membership: the wire spans the
            # whole quorum, as the JAX package reads it
            in_transport = True
            t_rank, t_world = quorum.replica_rank, quorum.replica_world_size
            fingerprint = "all"
        self._transport_world_size = t_world
        self._label_mesh_shape()
        # a replica that was on the wire last quorum and is absent now left
        # the fleet (death, kill or departure): with the epoch stamps, this
        # is what lets a merged recording show "epoch N -> member_dead ->
        # epoch N+1" without scraping a log
        members = tuple(quorum.transport_replica_ids or ())
        if self.events:
            for gone in sorted(set(self._wire_members) - set(members)):
                self.events.emit("member_dead", step=self._step,
                                 epoch=quorum.quorum_id, member=gone)
        self._wire_members = members
        if self.events:
            self.events.emit(
                "quorum_complete", step=self._step, epoch=quorum.quorum_id,
                wire_world=t_world, replica_world=quorum.replica_world_size,
                participants=self._participating_world_size,
                max_step=quorum.max_step, heal=bool(quorum.heal),
            )
        transport_key = (quorum.quorum_id, fingerprint, in_transport)
        if transport_key != self._transport_key:
            # the JAX package's rendezvous key shape, so a mixed cohort
            # meets on the same store keys; an observer configures a
            # private one-member wire (its replica id keeps several apart)
            store_prefixed_addr = (
                f"{quorum.store_address}/torchft/{quorum.quorum_id}"
                f"/{fingerprint}/{self._rank}" if in_transport else
                f"{quorum.store_address}/torchft/{quorum.quorum_id}"
                f"/{fingerprint}/observer/{self._replica_id}/{self._rank}"
            )
            self._logger.info(
                f"reconfiguring for quorum_id={quorum.quorum_id} "
                f"wire={fingerprint} store={store_prefixed_addr}"
            )
            # the cohort's replica ids in transport rank order, which the
            # hier tier's domain resolver maps to domains
            set_members = getattr(self._comm, "set_wire_members", None)
            if callable(set_members) and quorum.transport_replica_ids:
                set_members(list(quorum.transport_replica_ids))
            try:
                self._comm.configure(store_prefixed_addr, t_rank, t_world)
                self._transport_key = transport_key
            except Exception as e:  # noqa: BLE001
                # a peer died between announcement and rendezvous: latch;
                # the unchanged key forces a reconfigure next quorum
                self._logger.exception(f"comm configure failed: {e}")
                self.report_error(e)

        if allow_heal:
            self._heal_exchange(quorum)

        # --- lease grant --------------------------------------------------
        # A clean full quorum arms the lease for the epoch it announced;
        # never off a latched step (the transport may not match this
        # membership), and never off a quorum in which any member heals:
        # the healer takes a full quorum next step, which needs every
        # member's request, so no member may step on a lease from this
        # one. A member heals when some member is behind the max step
        # (replica_world_size > max_world_size) and, in the step-0
        # bootstrap, when the donor serves the others (recover_dst_ranks).
        # (The JAX package denies only the healer, and its donor then
        # waits in the next step's collective for a healer that waits in
        # the quorum.) An observer asks for a quorum every step, so a job
        # with one (replica_world_size > max_world_size) grants no lease
        # either.
        if (self._lease_enabled and quorum.lease_ms > 0
                and quorum.membership_epoch >= 0 and not self._healing
                and not (allow_heal and quorum.recover_dst_ranks)
                and quorum.max_world_size >= quorum.replica_world_size
                and self.errored() is None):
            self._grant_lease(quorum.membership_epoch, quorum.lease_ms)

    def _heal_exchange(self, quorum) -> None:
        """Serve our state to the peers this quorum assigned us as donor,
        or fetch the donor's when it assigned us a heal."""
        if quorum.recover_dst_ranks:
            self._logger.info(
                f"peers need recovery from us {quorum.recover_dst_ranks}"
            )
            if self._ckpt_fanout:
                # read on every donor event: a rank that died and restarted
                # advertises a new address
                try:
                    self._checkpoint_transport.set_peers([
                        self._store.wait(
                            f"{self._store_prefix}checkpoint_addr_{r}",
                            timeout=self._connect_timeout,
                        ).decode()
                        for r in range(self._world_size) if r != self._rank
                    ])
                except Exception as e:  # noqa: BLE001 — the heal proceeds
                    # without peers; the next donor event reads them again
                    self._logger.warn(f"checkpoint peer discovery failed: {e}")
            self._checkpoint_transport.send_checkpoint(
                dst_ranks=quorum.recover_dst_ranks,
                step=quorum.max_step,
                state_dict=self._manager_state_dict(),
                timeout=self._timeout,
            )
        if quorum.heal:
            try:
                self._healing = True
                self._heal_t0 = time.perf_counter()
                if self.events:
                    self.events.emit(
                        "heal_start", step=self._step,
                        epoch=self._quorum_epoch,
                        src_rank=quorum.recover_src_rank,
                        max_step=quorum.max_step,
                    )
                src_client = ManagerClient(
                    quorum.recover_src_manager_address,
                    connect_timeout=self._connect_timeout,
                )
                metadata = src_client.checkpoint_metadata(
                    self._rank, timeout=self._timeout
                )
                assert quorum.recover_src_rank is not None, (
                    "must have a recover rank when healing"
                )
                self._logger.info(
                    f"healing from rank {quorum.recover_src_rank} "
                    f"metadata={metadata} max_step={quorum.max_step}"
                )
                # the user state applies later on the main thread
                # (should_commit); only the manager's own state loads here
                self._pending_state_dict = (
                    self._checkpoint_transport.recv_checkpoint(
                        src_rank=quorum.recover_src_rank,
                        metadata=metadata,
                        step=quorum.max_step,
                        timeout=self._timeout,
                    )
                )
                self.load_state_dict(self._pending_state_dict["torchft"])
                self._step = quorum.max_step
            except Exception as e:  # noqa: BLE001
                # donor vanished mid-heal: latch (this step votes False and
                # the next quorum retries the heal)
                self._logger.exception(f"heal failed: {e}")
                self._healing = False
                self._pending_state_dict = None
                self.report_error(e)

    def _apply_pending_state_dict(self) -> None:
        assert self._healing, "must be in healing state"
        assert self._quorum_future is not None, (
            "must call start_quorum before should_commit"
        )
        self._quorum_future.result()
        assert self._pending_state_dict is not None, "checkpoint was not staged"
        assert self._load_state_dict is not None, (
            "user load_state_dict is not initialized"
        )
        self._load_state_dict(self._pending_state_dict["user"])
        self._pending_state_dict = None
        self._did_heal = True
        wall_ms = None
        if self._heal_t0 is not None:
            wall_ms = (time.perf_counter() - self._heal_t0) * 1000.0
            self.metrics.gauge("heal_wall_ms", wall_ms)
            self._heal_t0 = None
        if self.events:
            self.events.emit("heal_done", step=self._step,
                             epoch=self._quorum_epoch, wall_ms=wall_ms)
        self._logger.info("loaded state dict")

    # ---------------------------------------------------------------- commit

    def should_commit(self, timeout: "float | timedelta | None" = None) -> bool:
        """Two-phase commit: drain pending collectives, apply a pending
        heal, then vote across the local ranks of this replica group. True
        => the optimizer may be stepped."""
        return self.should_commit_async(timeout=timeout).result()

    def finish_staging(self) -> None:
        """Return once the checkpoint this replica serves to healers has
        been copied off the training state, which the caller may then
        update in place before the barrier closes the serving gate (the
        overlapped ``OptimizerWrapper.step``). A transport without the
        hook stages nothing lazily."""
        finish = getattr(self._checkpoint_transport, "finish_staging", None)
        if finish is not None:
            finish()

    def set_commit_hook(
        self, hook: "Optional[Callable[[int, int], None]]"
    ) -> None:
        """Register ``hook(step, num_participants)`` to run after every
        committed step, fast path and barrier alike. It runs on the commit
        path's thread; its exceptions are logged, never raised."""
        self._commit_hook = hook

    def _fire_commit_hook(self, step: int) -> None:
        hook = self._commit_hook
        if hook is None:
            return
        try:
            hook(step, self.num_participants())
        except Exception as e:  # noqa: BLE001 — never discard a commit
            self._logger.warn(f"commit hook failed at step {step}: {e!r}")

    def should_commit_async(
        self, timeout: "float | timedelta | None" = None
    ) -> Future:
        """The prologue (drain this step's collectives, apply a pending
        heal, cast the local vote) runs on the caller's thread; the barrier
        RPC rides the executor. The returned future resolves to the global
        decision; its ``local_should_commit`` attribute is this replica's
        ballot."""
        for work in self._pending_work:
            if self.errored() is not None:
                break
            try:
                work.result()  # wrap_future never raises
            except Exception:  # pragma: no cover — defensive
                pass
        self._pending_work = []
        if self._healing:
            self._apply_pending_state_dict()
        enough_replicas = self.num_participants() >= self._min_replica_size
        local_should_commit = enough_replicas and self.errored() is None

        # --- steady-state fast path ---------------------------------------
        # Armed by this step's local start_quorum and consumed once: commit
        # without the barrier only on a True local ballot, a True wire vote
        # (every wire member healthy; None when no voted op ran) and a
        # lease valid at this instant. Otherwise break the lease and take
        # the full barrier.
        fastpath, self._fastpath_active = self._fastpath_active, False
        if fastpath:
            t0 = time.perf_counter()
            take_vote = getattr(self._comm, "take_commit_vote", None)
            wire_vote = take_vote() if callable(take_vote) else None
            if local_should_commit and wire_vote is True and self._lease_valid():
                self.metrics.incr("fastpath_steps")
                self.metrics.incr("steps_committed")
                if self.events:
                    self.events.emit(
                        "step_commit", step=self._step,
                        epoch=self._quorum_epoch,
                        participants=self.num_participants(), fastpath=True,
                    )
                self._checkpoint_transport.disallow_checkpoint()
                self._step += 1
                self._batches_committed += self.num_participants()
                self._fire_commit_hook(self._step - 1)
                self.metrics.observe("commit_fast", time.perf_counter() - t0)
                fast: Future = Future()
                fast.set_result(True)
                fast.local_should_commit = True  # type: ignore[attr-defined]
                return fast
            if wire_vote is False:
                reason = "vote_dissent"
            elif wire_vote is None:
                reason = "vote_absent"
            elif not local_should_commit:
                reason = "local_vote_false"
            else:
                reason = "lease_expired"
            self._break_lease(reason)
        if self._lease_enabled:
            self.metrics.incr("fallback_steps")

        def _barrier() -> bool:
            t0 = time.perf_counter()
            self._count_control_rpc()
            should_commit = self._client.should_commit(
                self._rank, self._step, local_should_commit,
                timeout=_seconds(timeout) if timeout else self._timeout,
            )
            self.metrics.observe("commit_barrier", time.perf_counter() - t0)
            self._logger.info(
                f"should_commit={should_commit} "
                f"enough_replicas={enough_replicas} errored={self.errored()}"
            )
            self.metrics.incr(
                "steps_committed" if should_commit else "steps_discarded"
            )
            if self.events:
                self.events.emit(
                    "step_commit" if should_commit else "step_discard",
                    step=self._step, epoch=self._quorum_epoch,
                    participants=self.num_participants(),
                )
            self._checkpoint_transport.disallow_checkpoint()
            if should_commit:
                self._step += 1
                self._batches_committed += self.num_participants()
                self._fire_commit_hook(self._step - 1)
            return should_commit

        fut = self._executor.submit(_barrier)
        fut.local_should_commit = local_should_commit  # type: ignore[attr-defined]
        return fut

    # ----------------------------------------------------------------- state

    def load_state_dict(self, state_dict: Dict[str, int]) -> None:
        self._step = state_dict["step"]
        self._batches_committed = state_dict["batches_committed"]

    def _manager_state_dict(self) -> Dict[str, Any]:
        assert self._user_state_dict is not None, (
            "user state_dict is not initialized"
        )
        return {"user": self._user_state_dict(), "torchft": self.state_dict()}

    def state_dict(self) -> Dict[str, int]:
        return {"step": self._step, "batches_committed": self._batches_committed}

    def current_step(self) -> int:
        return self._step

    def control_rpcs(self) -> int:
        """Control RPCs (quorum, commit barrier) this step has made so
        far: 0 on a fast-path step."""
        return self._control_rpcs

    def lease_live(self) -> bool:
        """True while an epoch lease lets steps skip the control plane."""
        return self._lease_valid()

    def batches_committed(self) -> int:
        return self._batches_committed

    def num_participants(self) -> int:
        return self._participating_world_size

    def did_heal(self) -> bool:
        """True once this step's fetched checkpoint was applied through the
        user load_state_dict (reset by the next start_quorum)."""
        return self._did_heal

    def job_id(self) -> str:
        """The job this group belongs to on the lighthouse ("default" for
        a single-job fleet, with the unprefixed store keys)."""
        return self._job_id

    def is_evicted(self) -> bool:
        """True once a quorum answer evicted this group (a higher-priority
        job claimed its capacity): it never commits again, and the training
        loop shrinks the job or exits."""
        return self._evicted

    def bind_stage(self, stage_index: int, stage_count: int) -> None:
        """Declare this group pipeline stage ``stage_index`` of
        ``stage_count``: the ``pipe_stage_index``/``pipe_stage_count``
        gauges and the telemetry's stage fields."""
        stage_index, stage_count = int(stage_index), int(stage_count)
        if not 0 <= stage_index < stage_count:
            raise ValueError(
                f"stage_index {stage_index} outside [0, {stage_count})")
        self._stage_index = stage_index
        self._stage_count = stage_count
        self.metrics.gauge("pipe_stage_index", float(stage_index))
        self.metrics.gauge("pipe_stage_count", float(stage_count))

    def stage_index(self) -> int:
        """This group's pipeline stage (0 when not pipelined)."""
        return self._stage_index

    def stage_count(self) -> int:
        """The pipeline's depth (1 when not pipelined)."""
        return self._stage_count

    def _label_mesh_shape(self) -> None:
        self.metrics.label("mesh_shape",
                           f"{self._transport_world_size}x{self.model_shards}")

    def replica_world_size(self) -> int:
        return self._replica_world_size

    def comm_backend(self) -> str:
        """Name of the gradient data plane ("host", "cuda", or "none" for
        identity contexts), also the ``comm_backend`` metrics label."""
        return str(getattr(self._comm, "backend_name", "none"))

    # the wire introspection error feedback keys off (comm/context.py)

    def wire_codec_name(self) -> str:
        return self._comm.wire_codec_name()

    def wire_is_lossy(self) -> bool:
        return self._comm.wire_is_lossy()

    def wire_compensable(self) -> bool:
        return self._comm.wire_compensable()

    def wire_generation(self) -> int:
        return self._comm.wire_generation()

    def wire_roundtrip(self, src: np.ndarray, out: np.ndarray) -> None:
        self._comm.wire_roundtrip(src, out)

    def wire_nbytes(self, a: np.ndarray) -> int:
        return self._comm.wire_nbytes(a)

    def comm_unsupported_reason(
        self, algorithm: str, compression: str, op: str = ReduceOp.SUM,
        topology: str = "flat",
    ) -> Optional[str]:
        """Capability query against the active data plane (one definition
        per backend, ``CommContext.unsupported_reason``): None when the
        combo runs, else a prescriptive error string."""
        return self._comm.unsupported_reason(algorithm, compression, op,
                                             topology)

    def comm_supports(
        self, algorithm: str, compression: str, op: str = ReduceOp.SUM,
        topology: str = "flat",
    ) -> bool:
        return self.comm_unsupported_reason(
            algorithm, compression, op, topology
        ) is None

    def transport_world_size(self) -> int:
        """Members of the gradient wire for the current quorum."""
        return self._transport_world_size

    def transport_rank(self) -> int:
        """This replica's rank on the gradient wire for the current quorum
        (the comm context's configured rank). Valid after ``wait_quorum``;
        0 on a solo wire."""
        return int(self._comm.rank())

    def is_solo_wire(self) -> bool:
        """True when this quorum's wire is an identity for this replica: no
        error latched, no data-plane peer, and participating. Valid after
        ``wait_quorum``."""
        return (
            self.errored() is None
            and self._transport_world_size == 1
            and self.is_participating()
        )

    def participating_rank(self) -> Optional[int]:
        return self._participating_rank

    def is_participating(self) -> bool:
        """False while healing or parked as a spare: such replicas
        contribute zero gradients."""
        if self._participating_rank is None:
            return False
        if self._healing:
            assert self._use_async_quorum
            return False
        return True

    def replica_id(self) -> str:
        return self._replica_id


class _ManagerLogger:
    """``[replica/rank - step N]`` log prefixing."""

    def __init__(self, manager: Manager, replica_id: str, rank: int) -> None:
        self._logger = logging.getLogger(__name__)
        self._replica_id = replica_id
        self._rank = rank
        self._manager = manager

    def prefix(self) -> str:
        return (f"[{self._replica_id}/{self._rank} - "
                f"step {self._manager.current_step()}]")

    def info(self, msg: str) -> None:
        self._logger.info(f"{self.prefix()} {msg}")

    def warn(self, msg: str) -> None:
        self._logger.warning(f"{self.prefix()} {msg}")

    def exception(self, msg: str) -> None:
        self._logger.exception(f"{self.prefix()} {msg}")
