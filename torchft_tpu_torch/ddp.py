"""Cross-replica gradient averaging over ``nn.Module`` gradients.

Twin of ``torchft_tpu/ddp.py``, for torch modules: after ``loss.backward()``,
``average_gradients(model)`` averages every parameter's ``.grad`` across
replica groups through the Manager (error-latching) and writes the average
back in place. ``average_gradients_async`` returns a
``concurrent.futures.Future`` instead, resolving to the gradient tensors once
every bucket has landed; ``OptimizerWrapper.step`` takes that future.

Gradients are packed into dtype-homogeneous buckets by a plan frozen at the
first call (parameter order, <= ``bucket_bytes`` each), so every replica,
a recovering one included, reduces identical buckets; a bfloat16 bucket
rides the host wire as ml_dtypes' bfloat16, as the JAX package's does.
Healing replicas contribute zeros and receive the average, which is how
they end the heal step bitwise identical to their donor. With no
data-plane peer (a solo wire) the average is an identity and the copies
are skipped; the quorum still runs.

Streamed pipeline (the default; ``streamed=False`` keeps the lock-step
shape as the A/B lever and bitwise oracle). The stages of each bucket run
concurrently instead of serializing on the caller's thread:

    d2h   every bucket's device -> host copy into pinned staging is issued
          at once (one event per bucket); the caller waits for bucket k's
          event only, so bucket k rides the wire while later copies land
    ef    the error-feedback residual of bucket k, on a bounded worker
          against a snapshot of the transmitted bucket (the wire reduces
          the staging buffer in place the moment it takes it)
    wire  the transport round trip
    h2d   as each bucket's wire future lands, a worker copies it back into
          ``.grad`` on a dedicated copy stream and waits for that copy

The step future resolves when the last bucket's copy has completed and
every EF task has finished: the staging arena and the residuals are then
quiescent, so no later D2H can race a DMA out of pinned staging. Per-stage
wall times land in the Manager's metrics (``ddp_d2h``/``ddp_ef``/
``ddp_wire``/``ddp_h2d``, one observation per bucket) with two per-step
ones, ``ddp_wire_total`` (the buckets' wire times summed) and
``ddp_wire_exposed`` (wire time left after the submit loop ended).

Staging arenas: ``staging_arenas`` generations (default 2) of per-bucket
staging buffers and residuals. A second ``average_gradients_async`` over
another set of gradient tensors may pack into a free generation while the
first is on the wire; every generation in flight is a hard error. A
sequential caller always reuses generation 0. Overlapping calls must come
from one submitter thread, in the same order on every rank: the transport
pairs collectives across ranks by submission order.

Error feedback (``error_feedback="auto"``): when this rank's contribution
crosses the wire through a lossy codec (``manager.wire_compensable()``,
role-aware: a star peer, or every rank of the quantized psum) and this
replica contributes real gradients, each f32 bucket carries a residual e:
the bucket ships g + e and keeps e = (g + e) - C(g + e), C being the
wire's own image of one contribution (``manager.wire_roundtrip``). The
residuals reset whenever the transport reconfigures (``wire_generation``
changes). Over ``topology="hier"`` the gate is role-aware by itself.

:class:`ShardedGradReducer` is the gradient stage of the sharded weight
update (optim.ShardedOptimizerWrapper): the same buckets cut on the shard
grid (:func:`shard_ranges`), reduce-scattered so each rank receives its
1/N leaf shard. :class:`PureDistributedDataParallel` allreduces leaf by
leaf.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from torchft_tpu_torch.futures import FutureGroup, completed_future
from torchft_tpu_torch.utils.profiling import timed_span

__all__ = ["DistributedDataParallel", "PureDistributedDataParallel",
           "ShardedGradReducer", "shard_ranges"]

_DEFAULT_BUCKET_BYTES = 32 * 1024 * 1024

# Process-wide bounded workers for the off-thread stages: EF tasks and
# bucket landings get separate pools, so a quantizer roundtrip never queues
# a landed bucket behind it. Tasks never wait on other tasks.
_PIPELINE_LOCK = threading.Lock()
_PIPELINE_EXECUTORS: Dict[str, ThreadPoolExecutor] = {}


def _pipeline_executor(kind: str) -> ThreadPoolExecutor:
    with _PIPELINE_LOCK:
        ex = _PIPELINE_EXECUTORS.get(kind)
        if ex is None:
            ex = ThreadPoolExecutor(
                max_workers=2, thread_name_prefix=f"torchft_tpu_torch_{kind}")
            _PIPELINE_EXECUTORS[kind] = ex
        return ex


def _ef_dtype(dt: np.dtype) -> bool:
    """Buckets the wire codecs compress (transport ``_is_compressible``):
    integer buckets pass losslessly and carry no residual."""
    return dt in (np.float32, np.float64)


def _ef_gate(manager, error_feedback: "bool | str" = "auto") -> bool:
    """The error-feedback activation rule of DDP and the sharded reducer:
    enabled, AND (under "auto") this rank's contribution crosses the wire
    through a lossy codec, AND this replica contributes real values this
    step (a healing or spare replica ships zeros, whose "error" would bank
    the whole gradient). ``error_feedback=True`` forces it on; False turns
    it off."""
    if error_feedback is False:
        return False
    if error_feedback == "auto" and not manager.wire_compensable():
        return False
    return bool(manager.is_participating())


def _ef_residual(manager, transmitted: np.ndarray, res: np.ndarray) -> None:
    """e = g' - C(g'), with g' the contribution donated to the wire (or a
    snapshot of it: the wire reduces the donated buffer in place)."""
    manager.wire_roundtrip(transmitted, res)  # res = C(g')
    np.subtract(transmitted, res, out=res)
    if not np.all(np.isfinite(res)):
        # a non-finite gradient poisons its wire image and the step is
        # discarded, but the residual persists: drop that error rather
        # than re-inject the spike into every later step
        np.nan_to_num(res, copy=False, nan=0.0, posinf=0.0, neginf=0.0)


def _wire_healthy(manager) -> bool:
    """The wire timers mean something only while ops ride the wire: after
    a latched error every op resolves inline."""
    errored = getattr(manager, "errored", None)
    return not callable(errored) or errored() is None


def _host_view(t: torch.Tensor) -> np.ndarray:
    """The numpy view of a CPU tensor the host wire reduces in place: a
    bfloat16 tensor as ml_dtypes' bfloat16, what the JAX package's bf16
    buckets are (numpy has no bfloat16 of its own)."""
    if t.dtype != torch.bfloat16:
        return t.numpy()
    try:
        import ml_dtypes
    except ImportError:
        raise TypeError(
            "bfloat16 gradients ride the host wire as ml_dtypes' bfloat16, "
            "and the ml_dtypes package is missing; keep the gradients "
            "float32 (the models' param_dtype)") from None
    return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)


def _from_host(a: np.ndarray) -> torch.Tensor:
    """A CPU tensor over a reduced numpy array (inverse of
    :func:`_host_view`)."""
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _itemsize(dtype) -> int:
    if isinstance(dtype, torch.dtype):
        return torch.empty((), dtype=dtype).element_size()
    return np.dtype(dtype).itemsize


class _BucketPlan:
    """Fixed mapping of parameter indices into dtype-homogeneous buckets,
    built from shapes and dtypes only; order within a dtype follows the
    parameter order, so it is identical on every replica."""

    def __init__(self, params: Sequence[torch.Tensor],
                 bucket_bytes: int) -> None:
        self.shapes = [tuple(p.shape) for p in params]
        self.dtypes = [p.dtype for p in params]
        self.sizes = [p.numel() for p in params]
        by_dtype: Dict[torch.dtype, List[int]] = {}
        for i, dt in enumerate(self.dtypes):
            by_dtype.setdefault(dt, []).append(i)
        self.buckets: List[List[int]] = []
        for dt, indices in sorted(by_dtype.items(), key=lambda kv: str(kv[0])):
            current: List[int] = []
            current_bytes = 0
            itemsize = _itemsize(dt)
            for i in indices:
                nbytes = self.sizes[i] * itemsize
                if current and current_bytes + nbytes > bucket_bytes:
                    self.buckets.append(current)
                    current, current_bytes = [], 0
                current.append(i)
                current_bytes += nbytes
            if current:
                self.buckets.append(current)

    def signature(self) -> Tuple:
        return tuple(zip(self.shapes, self.dtypes))

    def alloc_staging(self, pin: bool) -> List[torch.Tensor]:
        return [
            torch.empty(sum(self.sizes[i] for i in bucket),
                        dtype=self.dtypes[bucket[0]], pin_memory=pin)
            for bucket in self.buckets
        ]

    def slices(self, k: int):
        """``(param index, offset, size)`` of bucket k's slices."""
        offset = 0
        for i in self.buckets[k]:
            yield i, offset, self.sizes[i]
            offset += self.sizes[i]


class _Arena:
    """One staging generation: per-bucket staging tensors (pinned for CUDA
    gradients) and their numpy views, the EF residuals and snapshots, and
    the in-flight future of the last average that used it (the
    corruption guard)."""

    __slots__ = ("staging", "views", "residuals", "ef_scratch",
                 "ef_generation", "inflight")

    def __init__(self) -> None:
        self.staging: Optional[List[torch.Tensor]] = None
        self.views: Optional[List[np.ndarray]] = None
        self.residuals: Optional[List[Optional[np.ndarray]]] = None
        self.ef_scratch: Optional[List[Optional[np.ndarray]]] = None
        self.ef_generation: Optional[int] = None
        self.inflight: Optional[Future] = None


def _gradients(model) -> List[torch.Tensor]:
    """The gradient tensors of ``model``: a module's or a parameter
    sequence's ``.grad`` (zeros where a parameter has none), or a sequence
    of plain tensors taken as the gradients themselves."""
    items = (list(model.parameters())
             if isinstance(model, torch.nn.Module) else list(model))
    grads = []
    for p in items:
        if isinstance(p, torch.nn.Parameter):
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            grads.append(p.grad)
        else:
            grads.append(p)
    return grads


class DistributedDataParallel:
    """Bucketed fault-tolerant gradient averager. ``error_feedback``:
    "auto" (a residual exactly where this rank's contribution crosses a
    lossy codec), True or False. ``staging_arenas``: staging generations
    (>= 1); all of them in flight is a hard error. ``streamed``: the
    per-bucket pipeline (True) or the lock-step arm (False), bitwise equal.
    ``topology``: the data path of every bucket's allreduce
    ("flat"/"hier"; None passes no override)."""

    def __init__(self, manager,
                 bucket_bytes: int = _DEFAULT_BUCKET_BYTES,
                 error_feedback: "bool | str" = "auto",
                 staging_arenas: int = 2,
                 streamed: bool = True,
                 topology: Optional[str] = None) -> None:
        if error_feedback not in (True, False, "auto"):
            raise ValueError(f"error_feedback must be True/False/'auto', "
                             f"got {error_feedback!r}")
        if staging_arenas < 1:
            raise ValueError("staging_arenas must be >= 1")
        self._manager = manager
        self._bucket_bytes = bucket_bytes
        self._error_feedback = error_feedback
        self._streamed = bool(streamed)
        # passed only when set, so managers without the keyword work
        self._ar_kwargs = {} if topology is None else {"topology": topology}
        self._plan: "_BucketPlan | None" = None
        self._arenas = [_Arena() for _ in range(int(staging_arenas))]
        self._plan_lock = threading.Lock()
        self._arena_lock = threading.Lock()
        self._copy_streams: Dict[torch.device, "torch.cuda.Stream"] = {}

    # a sequential caller only ever uses arena 0
    @property
    def _residuals(self):
        return self._arenas[0].residuals

    @property
    def _ef_generation(self):
        return self._arenas[0].ef_generation

    def bucket_sizes(self) -> List[int]:
        """Element counts of the frozen plan's buckets (empty before the
        first average): one allreduce each per step with a wire peer."""
        if self._plan is None:
            return []
        return [sum(self._plan.sizes[i] for i in b)
                for b in self._plan.buckets]

    def _get_plan(self, grads: Sequence[torch.Tensor]) -> _BucketPlan:
        with self._plan_lock:
            if self._plan is None:
                self._plan = _BucketPlan(grads, self._bucket_bytes)
            elif tuple((tuple(g.shape), g.dtype) for g in grads) \
                    != self._plan.signature():
                raise ValueError(
                    "gradient shapes/dtypes changed between steps; the DDP "
                    "bucket layout is frozen by design"
                )
            return self._plan

    def _acquire_arena(self) -> Tuple[_Arena, Future]:
        """First free generation, arena 0 preferred, claimed atomically
        with a placeholder future (the real step future exists only after
        the submit loop); every generation in flight raises."""
        with self._arena_lock:
            for arena in self._arenas:
                f = arena.inflight
                if f is None or f.done():
                    placeholder: Future = Future()
                    placeholder.set_running_or_notify_cancel()
                    arena.inflight = placeholder
                    return arena, placeholder
            raise RuntimeError(
                f"average_gradients_async called with all "
                f"{len(self._arenas)} staging arena generations in flight; "
                "await a prior result first or raise staging_arenas"
            )

    def _copy_stream(self, device: torch.device) -> "torch.cuda.Stream":
        with self._arena_lock:
            stream = self._copy_streams.get(device)
            if stream is None:
                stream = torch.cuda.Stream(device)
                self._copy_streams[device] = stream
            return stream

    def average_gradients(self, model) -> List[torch.Tensor]:
        """Average the gradients of ``model`` (a module, a sequence of
        parameters, or a sequence of gradient tensors) across replica
        groups, in place, and return the gradient tensors. Blocking. On a
        transport error the error is latched and the gradients are
        UNSPECIFIED; the commit gate then discards the step."""
        return self.average_gradients_async(model).result()

    def average_gradients_async(self, model) -> Future:
        """As :meth:`average_gradients`, returning a future that resolves
        to the gradient tensors once every bucket has landed in them."""
        grads = _gradients(model)
        try:
            self._manager.wait_quorum()
        except Exception as e:  # noqa: BLE001 — latch so the step discards
            self._manager.report_error(e)
            return completed_future(grads)
        if self._manager.is_solo_wire() or not grads:
            return completed_future(grads)
        plan = self._get_plan(grads)
        arena, placeholder = self._acquire_arena()
        try:
            if arena.staging is None:
                arena.staging = plan.alloc_staging(pin=grads[0].is_cuda)
                arena.views = [_host_view(s) for s in arena.staging]
            ef = _ef_gate(self._manager, self._error_feedback)
            if ef:
                # zeroed on first use and whenever the transport
                # reconfigured: a new membership's wire made none of the
                # old error
                gen = self._manager.wire_generation()
                if arena.residuals is None or gen != arena.ef_generation:
                    arena.residuals = [np.zeros_like(v) if _ef_dtype(v.dtype)
                                       else None for v in arena.views]
                    arena.ef_generation = gen
            # both paths store the real in-flight future themselves, also
            # on a mid-loop failure: buckets already submitted keep
            # reducing in place into this arena
            if self._streamed:
                return self._average_streamed(arena, plan, grads, ef)
            return self._average_lockstep(arena, plan, grads, ef)
        except BaseException:
            if arena.inflight is placeholder:
                arena.inflight = None  # nothing reached the wire
            raise

    # ------------------------------------------------------------- stages

    def _issue_d2h(self, arena: _Arena, plan: _BucketPlan,
                   grads: List[torch.Tensor]) -> "List[Optional[torch.cuda.Event]]":
        """Issue every bucket's device -> host copy into staging; on CUDA
        one event per bucket marks its copies (synchronous on the CPU)."""
        cuda = grads[0].is_cuda
        events: "List[Optional[torch.cuda.Event]]" = []
        for k in range(len(plan.buckets)):
            for i, off, n in plan.slices(k):
                arena.staging[k][off: off + n].copy_(grads[i].reshape(-1),
                                                     non_blocking=cuda)
            if cuda:
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(grads[0].device))
                events.append(event)
            else:
                events.append(None)
        return events

    def _land_bucket(self, arena: _Arena, plan: _BucketPlan, k: int,
                     reduced: np.ndarray, grads: List[torch.Tensor],
                     metrics) -> None:
        """Copy bucket k's reduced values back into the gradients and wait
        for the copy: on CUDA on the copy stream, from pinned staging when
        the wire reduced in place (while healing, the Manager's zeros
        stand in for it)."""
        with timed_span(metrics, "ddp_h2d", span=f"ddp_unpack_bucket{k}"):
            staged = arena.views[k]
            if reduced.ctypes.data == staged.ctypes.data \
                    and reduced.shape == staged.shape:
                src = arena.staging[k]
            else:
                src = _from_host(reduced)
            device = grads[plan.buckets[k][0]].device
            if device.type == "cuda":
                stream = self._copy_stream(device)
                with torch.cuda.stream(stream):
                    for i, off, n in plan.slices(k):
                        grads[i].view(-1).copy_(src[off: off + n],
                                                non_blocking=True)
                    done = torch.cuda.Event()
                    done.record(stream)
                # staging stays claimed until its DMA completed
                done.synchronize()
            else:
                for i, off, n in plan.slices(k):
                    grads[i].view(-1).copy_(src[off: off + n])

    # --------------------------------------------------------- code paths

    def _average_streamed(self, arena: _Arena, plan: _BucketPlan,
                          grads: List[torch.Tensor], ef: bool) -> Future:
        manager = self._manager
        metrics = getattr(manager, "metrics", None)
        land_pool = _pipeline_executor("ddp_land")
        ef_pool = _pipeline_executor("ddp_ef")
        group = FutureGroup()
        n_buckets = len(plan.buckets)
        submit_t = [0.0] * n_buckets
        wire_done_t = [0.0] * n_buckets
        try:
            events = self._issue_d2h(arena, plan, grads)
            for k in range(n_buckets):
                with timed_span(metrics, "ddp_d2h", span=f"ddp_pack_bucket{k}"):
                    if events[k] is not None:
                        events[k].synchronize()
                packed = arena.views[k]
                if ef and arena.residuals[k] is not None:
                    res = arena.residuals[k]
                    # g' = g + e stays inline; the quantizer roundtrip
                    # reads a snapshot of g' on the worker
                    np.add(packed, res, out=packed)
                    if arena.ef_scratch is None:
                        arena.ef_scratch = [None] * n_buckets
                    if arena.ef_scratch[k] is None:
                        arena.ef_scratch[k] = np.empty_like(packed)
                    scratch = arena.ef_scratch[k]
                    np.copyto(scratch, packed)

                    def _ef_task(scratch=scratch, res=res) -> None:
                        with timed_span(metrics, "ddp_ef"):
                            _ef_residual(manager, scratch, res)

                    group.add(ef_pool.submit(_ef_task))
                submit_t[k] = time.perf_counter()
                work = manager.allreduce_arrays([packed], **self._ar_kwargs)
                landed: Future = Future()
                landed.set_running_or_notify_cancel()
                group.add(landed)

                def _on_wire(wf: Future, k: int = k,
                             landed: Future = landed) -> None:
                    # transport continuation: timestamp and enqueue only
                    wire_done_t[k] = time.perf_counter()
                    if metrics is not None and _wire_healthy(manager):
                        metrics.observe("ddp_wire",
                                        wire_done_t[k] - submit_t[k])

                    def _land() -> None:
                        try:
                            self._land_bucket(arena, plan, k,
                                              wf.result()[0], grads, metrics)
                            landed.set_result(None)
                        except Exception as e:  # noqa: BLE001
                            landed.set_exception(e)

                    land_pool.submit(_land)

                work.future().add_done_callback(_on_wire)
        except BaseException as e:
            # buckets already on the wire reduce in place into this arena:
            # seal the group over them as the arena's guard before
            # re-raising, failing with a RuntimeError (a BaseException
            # would never resolve the guard)
            def _fail() -> None:
                raise RuntimeError(
                    "average_gradients submit loop failed mid-flight") from e

            arena.inflight = group.seal(_fail)
            events_ = getattr(manager, "events", None)
            if events_:
                events_.emit("round_abort", source="ddp_submit",
                             error=repr(e)[:200])
            raise
        t_submitted = time.perf_counter()

        def _assemble() -> List[torch.Tensor]:
            if metrics is not None and _wire_healthy(manager):
                metrics.observe("ddp_wire_total", sum(
                    wire_done_t[k] - submit_t[k] for k in range(n_buckets)))
                metrics.observe("ddp_wire_exposed",
                                max(0.0, max(wire_done_t) - t_submitted))
            return grads

        fut = group.seal(_assemble)
        arena.inflight = fut
        return fut

    def _average_lockstep(self, arena: _Arena, plan: _BucketPlan,
                          grads: List[torch.Tensor], ef: bool) -> Future:
        """The A/B arm and bitwise oracle of the streamed path, on the
        caller's thread: every D2H, then per bucket the inline EF and the
        submit, one drain, then every H2D. Same math, buffers and
        submission order; only the schedule differs. ``ddp_d2h`` is one
        observation a step here (all buckets' copies), not one a bucket."""
        manager = self._manager
        metrics = getattr(manager, "metrics", None)
        n_buckets = len(plan.buckets)
        submit_t = [0.0] * n_buckets
        wire_done_t = [0.0] * n_buckets
        works: List[Future] = []
        try:
            with timed_span(metrics, "ddp_d2h"):
                for event in self._issue_d2h(arena, plan, grads):
                    if event is not None:
                        event.synchronize()
            for k in range(n_buckets):
                packed = arena.views[k]
                if ef and arena.residuals[k] is not None:
                    res = arena.residuals[k]
                    np.add(packed, res, out=packed)
                    with timed_span(metrics, "ddp_ef"):
                        _ef_residual(manager, packed, res)
                submit_t[k] = time.perf_counter()
                works.append(manager.allreduce_arrays(
                    [packed], **self._ar_kwargs).future())

                def _mark(_f: Future, k: int = k) -> None:
                    wire_done_t[k] = time.perf_counter()
                    if metrics is not None and _wire_healthy(manager):
                        metrics.observe("ddp_wire",
                                        wire_done_t[k] - submit_t[k])

                works[-1].add_done_callback(_mark)
            t_submitted = time.perf_counter()
            reduced = [w.result()[0] for w in works]
            for k in range(n_buckets):
                self._land_bucket(arena, plan, k, reduced[k], grads, metrics)
            if metrics is not None and _wire_healthy(manager):
                metrics.observe("ddp_wire_total", sum(
                    wire_done_t[k] - submit_t[k] for k in range(n_buckets)))
                metrics.observe("ddp_wire_exposed",
                                max(0.0, max(wire_done_t) - t_submitted))
        except BaseException as e:
            group = FutureGroup()
            for w in works:
                group.add(w)

            def _fail() -> None:
                raise RuntimeError(
                    "average_gradients submit loop failed mid-flight") from e

            arena.inflight = group.seal(_fail)
            raise
        fut = completed_future(grads)
        arena.inflight = fut
        return fut


# ----------------------------------------------------- sharded weight update


def shard_ranges(sizes: Sequence[int], dtypes: Sequence,
                 world_size: int) -> List[Tuple[int, int]]:
    """The shard grid of the cross-replica sharded weight update:
    contiguous, byte-balanced leaf ranges over the flat leaf list, one per
    wire rank (``comm.wire.split_weighted``, a pure function of sizes and
    dtypes, torch or numpy). Fewer leaves than ranks leaves the tail ranks
    owning nothing."""
    from torchft_tpu_torch.comm.wire import split_weighted

    nbytes = [int(sz) * _itemsize(dt) for sz, dt in zip(sizes, dtypes)]
    return split_weighted(nbytes, max(1, int(world_size)))


class _ShardPlan(_BucketPlan):
    """Shard-aligned bucket plan: the leaves split into ``world_size``
    byte-balanced ranges (:func:`shard_ranges`), each range's leaves packed
    into dtype-grouped buckets owned by that range's rank. The byte layout
    is :class:`_BucketPlan`'s, so the sharded and replicated arms submit
    identical payloads over identical chunk grids."""

    def __init__(self, leaves: Sequence[torch.Tensor],
                 world_size: int) -> None:
        self.shapes = [tuple(l.shape) for l in leaves]
        self.dtypes = [l.dtype for l in leaves]
        self.sizes = [l.numel() for l in leaves]
        self.world_size = int(world_size)
        self.ranges = shard_ranges(self.sizes, self.dtypes, world_size)
        self.buckets: List[List[int]] = []
        self.owners: List[int] = []
        for shard, (start, stop) in enumerate(self.ranges):
            by_dtype: Dict[str, List[int]] = {}
            for i in range(start, stop):
                by_dtype.setdefault(str(self.dtypes[i]), []).append(i)
            for _, indices in sorted(by_dtype.items()):
                self.buckets.append(indices)
                self.owners.append(shard)

    def shard_spec(self, model_shards: int = 1):
        """This grid as a redistribution destination spec; with
        ``model_shards > 1`` each leaf is ``model_shards`` sub-units (the
        2-D replica x model layout)."""
        from torchft_tpu_torch.comm.redistribute import ShardSpec

        if model_shards > 1:
            return ShardSpec.from_ranges_2d(self.ranges, model_shards,
                                            len(self.sizes))
        return ShardSpec.from_ranges(self.ranges, len(self.sizes))

    def owned_leaves(self, rank: int) -> List[int]:
        if rank >= len(self.ranges):
            return []
        start, stop = self.ranges[rank]
        return list(range(start, stop))


class _ShardArena:
    """The staging and EF residuals of one wire world size, allocated at
    the first transport use."""

    __slots__ = ("plan", "staging", "views", "residuals", "ef_generation")

    def __init__(self, plan: _ShardPlan) -> None:
        self.plan = plan
        self.staging: Optional[List[torch.Tensor]] = None
        self.views: Optional[List[np.ndarray]] = None
        self.residuals: Optional[List[Optional[np.ndarray]]] = None
        self.ef_generation: Optional[int] = None


class ShardedGradReducer:
    """The gradient stage of the sharded weight update.

    ``reduce(grads, sharded=True)`` packs every gradient into shard-aligned
    buckets (every rank contributes everything), reduce-scatters them so
    each rank receives the leaf shard its optimizer shard consumes, and
    returns host views of the received leaves. ``sharded=False``
    allreduces the same buckets over the same chunk grid, the replicated
    arm, whose values on any rank's shard are bitwise the sharded arm's.
    DDP's error feedback rides the upload side unchanged. The plan and its
    staging are cached per wire world size, with one
    ``shard_grid_rebuild`` event per new world."""

    def __init__(self, manager,
                 error_feedback: "bool | str" = "auto") -> None:
        if error_feedback not in (True, False, "auto"):
            raise ValueError(f"error_feedback must be True/False/'auto', "
                             f"got {error_feedback!r}")
        self._manager = manager
        self._error_feedback = error_feedback
        self._arenas: Dict[int, _ShardArena] = {}
        self._signature: Optional[Tuple] = None
        self._last_world: Optional[int] = None
        self._lock = threading.Lock()

    def last_plan(self) -> Optional[_ShardPlan]:
        """The plan of the last wire world seen, or None."""
        with self._lock:
            arena = self._arenas.get(self._last_world)
            return None if arena is None else arena.plan

    def plan_for(self, leaves: Sequence[torch.Tensor],
                 world: int) -> _ShardPlan:
        """The cached shard plan for ``world``; the leaf layout is frozen."""
        sig = tuple((tuple(l.shape), l.dtype) for l in leaves)
        with self._lock:
            if self._signature is None:
                self._signature = sig
            elif sig != self._signature:
                raise ValueError(
                    "gradient shapes/dtypes changed between steps; the "
                    "sharded-update leaf grid is frozen by design")
            arena = self._arenas.get(world)
            if arena is None:
                arena = _ShardArena(_ShardPlan(leaves, world))
                self._arenas[world] = arena
                ev = getattr(self._manager, "events", None)
                if ev:
                    ev.emit("shard_grid_rebuild", old_world=self._last_world,
                            new_world=world, shards=len(arena.plan.ranges),
                            buckets=len(arena.plan.buckets))
            self._last_world = world
            return arena.plan

    def reduce(self, grads: Sequence[torch.Tensor], sharded: bool = True
               ) -> Tuple[_ShardPlan, int, Dict[int, np.ndarray]]:
        """Blocking reduce of the gradient tensors. Returns ``(plan,
        my_rank, leaves)``, ``leaves`` mapping a leaf index to a host view
        of its reduced, participant-scaled gradient: this rank's shard
        when ``sharded``, every leaf otherwise. The views alias staging:
        copy them before the next reduce. After a latched error the values
        are unspecified (the step never commits)."""
        mgr = self._manager
        grads = list(grads)
        try:
            mgr.wait_quorum()
        except Exception as e:  # noqa: BLE001 — latch, never raise
            mgr.report_error(e)
            # a throwaway plan, not cached: a transient failure pins no
            # arena and emits no rebuild event
            return _ShardPlan(grads, 1), 0, {}
        world = max(1, int(mgr.transport_world_size()))
        rank_fn = getattr(mgr, "transport_rank", None)
        my_rank = int(rank_fn()) if callable(rank_fn) else 0
        plan = self.plan_for(grads, world)
        metrics = getattr(mgr, "metrics", None)
        if world == 1:
            # solo wire: the average is an identity
            return plan, 0, {i: g.detach().cpu().numpy()
                             for i, g in enumerate(grads)}
        with self._lock:
            arena = self._arenas[world]
        if arena.staging is None:
            arena.staging = plan.alloc_staging(
                pin=bool(grads) and grads[0].is_cuda)
            arena.views = [s.numpy() for s in arena.staging]
        views = arena.views
        ef = _ef_gate(mgr, self._error_feedback)
        if ef:
            gen = int(mgr.wire_generation())
            if arena.residuals is None or gen != arena.ef_generation:
                arena.residuals = [np.zeros_like(v) if _ef_dtype(v.dtype)
                                   else None for v in views]
                arena.ef_generation = gen
        cuda = bool(grads) and grads[0].is_cuda
        with timed_span(metrics, "ddp_d2h", span="shard_pack"):
            for k in range(len(plan.buckets)):
                for i, off, n in plan.slices(k):
                    arena.staging[k][off: off + n].copy_(
                        grads[i].detach().reshape(-1), non_blocking=cuda)
            if cuda:
                torch.cuda.current_stream(grads[0].device).synchronize()
        if ef:
            for k, packed in enumerate(views):
                res = arena.residuals[k]
                if res is None:
                    continue
                np.add(packed, res, out=packed)
                with timed_span(metrics, "ddp_ef"):
                    _ef_residual(mgr, packed, res)
        if sharded:
            work = mgr.reduce_scatter_arrays(views, owners=plan.owners)
        else:
            work = mgr.allreduce_arrays(views)
        reduced = work.future().result()
        out: Dict[int, np.ndarray] = {}
        for k, bucket in enumerate(plan.buckets):
            if sharded and plan.owners[k] != my_rank:
                continue
            for i, off, n in plan.slices(k):
                out[i] = reduced[k][off: off + n].reshape(plan.shapes[i])
        return plan, my_rank, out


class PureDistributedDataParallel:
    """Per-parameter (unbucketed) variant: one allreduce per gradient.
    The quorum gates the reduce (a failed quorum latches, so the step
    discards), and a solo wire skips the copies and the transport."""

    def __init__(self, manager) -> None:
        self._manager = manager

    def average_gradients(self, model) -> List[torch.Tensor]:
        """Average each gradient of ``model`` (as for
        :class:`DistributedDataParallel`) in place; returns them."""
        grads = _gradients(model)
        try:
            self._manager.wait_quorum()
        except Exception as e:  # noqa: BLE001 — latch, never raise
            self._manager.report_error(e)
            return grads
        if self._manager.is_solo_wire():
            return grads
        host = [_host_view(g.detach().cpu().reshape(-1)).copy()
                for g in grads]
        works = [self._manager.allreduce_arrays([h]) for h in host]
        for g, w in zip(grads, works):
            reduced = w.future().result()[0]
            g.copy_(_from_host(reduced).reshape(g.shape))
        return grads
