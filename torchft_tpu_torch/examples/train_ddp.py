"""Fault-tolerant DDP training of the GPT with torch (twin of
``examples/train_ddp.py``, both arms).

Run one replica group per process (repeat per group):

    python -m torchft_tpu_torch.lighthouse_cli --min_replicas 1 &
    REPLICA_GROUP_ID=0 NUM_REPLICA_GROUPS=2 MODEL=125m \\
    TORCHFT_TPU_LIGHTHOUSE=http://host:29510 \\
    CKPT_PATH=/data/run0.ckpt \\
        python -m torchft_tpu_torch.examples.train_ddp

(``SHARDED=1`` for the sharded weight update, ``MODEL_SHARDS=M`` with it,
``STREAMED=0`` for DDP's lock-step arm.)

Kill any replica group at any time: survivors keep committing; the
relaunched group heals from a live peer and rejoins. Kill every group, and
each resumes from its newest durable checkpoint (``CKPT_PATH``, written
every ``CKPT_EVERY`` steps). The loop below needs no failure-handling code
for either. It runs on CUDA (``DEVICE=cpu`` for the CPU).

Each step takes one of the reference's two paths: on a solo wire (no
data-plane peer) ``opt.can_fuse()`` -> ``opt.fused_step(train_step, ...)``,
forward, backward and AdamW as one CUDA graph; otherwise forward/backward,
``ddp.average_gradients`` (the streamed per-bucket pipeline; ``streamed=
False`` is its lock-step arm), ``opt.step()``: the reference's default
overlapped commit, the update beside the barrier RPC behind a backup that
a discard restores (``train_group(donate_update=True)`` decides first and
updates in place). Losses come back through the optimizer wrapper's
fence, in batches, never one sync per step.

``SHARDED=1`` switches the weight update to the cross-replica sharded path
(``optim.ShardedOptimizerWrapper``: reduce-scatter, a 1/N update with
optax-order ``adamw(3e-4)``, weight decay 1e-4, then a params allgather),
which never fuses. Optimizer state and its heal bytes divide by the wire
world size; every membership change reshards through comm/redistribute.py,
and a healer fetches the donor's optimizer shard with
``checkpointing.fetch_opt_shard``. ``MODEL_SHARDS=M`` prices reshards on
the 2-D (replica x model) sub-unit grid. Both must match across groups.

``train_group`` is the loop as a function. ``run_kill_and_heal`` drives
replica groups in threads (two by default) through a failure, a restart
from a poisoned init and a heal, on a fixed schedule of steps, and checks
that the groups, the healed one included, are bitwise equal at every step
they commit; with a domain map it drives the hierarchical wire
(``topology="hier"``), resolving each group's domain as the groups start;
with ``sharded=True`` it drives the sharded update through a shrink and a
grow. ``run_joint`` runs groups a few steps together, with no failure (the
A/B arms' runs).
``run_resume_drill`` adds the durable half:
a fused solo phase, a heal, steps on the epoch lease's fast path,
checkpoints, a kill of every group, and a resume that must equal the
checkpoint bitwise. ``run_multijob_drill`` puts two jobs on one lighthouse
(one with an observer, ``data_plane=False``), kills and heals a group of
one while the other stays on its lease, then lets a higher-priority job
evict a group of the second. ``run_process_drill`` runs two groups as OS
processes, as the lines above tell users to: one is SIGKILLed inside a
step and relaunched on the same ports, and heals from the survivor; the
kill-to-heal lifecycle is then read back from the survivor's and the
relaunch's ``/telemetry`` alone (``check_lifecycle``).
``run_churn_drill`` kills repeatedly while the job commits (five groups,
three kills, one group twice; or a latched wire under stable membership)
and holds every heal bitwise and every dead life's memory freed
(``check_churn``). ``run_kill_and_heal`` and ``run_churn_drill`` take
``comm_backend`` and ``comm_options`` for the
Manager: the default is the TCP gradient wire; ``comm_backend="cuda"`` with
e.g. ``comm_options={"algorithm": "psum", "compression": "int8"}`` reduces
on the training device instead (comm/cuda_backend.py), where groups that
share a process share the device's plans.
"""

from __future__ import annotations

import gc
import json
import logging
import math
import os
import shutil
import tempfile
import threading
import time
import urllib.request
import weakref
from contextlib import contextmanager
from dataclasses import dataclass, field
from concurrent.futures import Future
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from torchft_tpu_torch.checkpoint_io import (
    AsyncCheckpointWriter,
    latest_checkpoint,
    load_checkpoint,
)
from torchft_tpu_torch.comm.context import (
    CommContext,
    ErrorSwallowingCommContext,
    ReduceOp,
    Work,
)
from torchft_tpu_torch.comm.cuda_backend import (
    DevicePool,
    default_device_pool,
)
from torchft_tpu_torch.comm.store import StoreClient, StoreServer
from torchft_tpu_torch.comm.topology import DomainTopology
from torchft_tpu_torch.control import Lighthouse, LighthouseClient
from torchft_tpu_torch.data import DistributedSampler
from torchft_tpu_torch.checkpointing import CheckpointServer
from torchft_tpu_torch.ddp import (
    _DEFAULT_BUCKET_BYTES,
    DistributedDataParallel,
    _BucketPlan,
)
from torchft_tpu_torch.manager import (
    LIGHTHOUSE_ENV,
    Manager,
    _build_comm_context,
)
from torchft_tpu_torch.models import (
    CONFIGS,
    GPT,
    TransformerConfig,
    make_train_step,
)
from torchft_tpu_torch.ops.flash import LAUNCHES, check_head_dim
from torchft_tpu_torch.optim import (
    OptimizerWrapper,
    ShardedOptimizerWrapper,
    adamw,
    init_adam_state,
    load_optimizer_state_dict,
)
from torchft_tpu_torch.utils.device import resolve_device
from torchft_tpu_torch.utils.events import (
    to_chrome_trace,
    validate_chrome_trace,
)

logger = logging.getLogger(__name__)

__all__ = ["FaultyCommContext", "InjectedFailure", "GroupRun",
           "check_churn", "run_churn_drill", "run_joint",
           "run_kill_and_heal", "run_multijob_drill", "run_process_drill",
           "run_resume_drill", "train_group"]

# the manifest paths of the sharded optimizer's slots: a heal leaves them
# on the donor, and the healer fetches them with fetch_opt_shard
OPT_SLOTS_PATH_RE = r".*\['slots'\]\[(\d+)\]\[(\d+)\]$"


class InjectedFailure(Exception):
    """Raised by ``train_group`` at ``fail_at_step``: a simulated crash.
    ``run`` is what the group did until then, ``step`` the
    ``fail_at_step`` that fired."""

    def __init__(self, msg: str, run: "GroupRun",
                 step: Optional[int] = None) -> None:
        super().__init__(msg)
        self.run = run
        self.step = step


class FaultyCommContext(ErrorSwallowingCommContext):
    """A comm context that runs every allreduce on ``inner`` and fails the
    ``fail_at_op``-th one (counted from 1) after it completed: the
    collective ran for every peer, and this rank's Manager sees an error
    (as the JAX package's test stub's ``fail_at_op``, which latches the
    round). ``record_ops`` lists op numbers whose inputs and raw reduced
    outputs are kept (``recorded[op] = (inputs, outputs)``)."""

    def __init__(self, inner: CommContext, fail_at_op: Optional[int] = None,
                 record_ops: Sequence[int] = ()) -> None:
        super().__init__(inner)
        self.fail_at_op = fail_at_op
        self.record_ops = set(record_ops)
        self.recorded: Dict[int, Tuple[List[np.ndarray],
                                       List[np.ndarray]]] = {}
        self.ops = 0

    def errored(self):
        # the wrapped plane's own latch: the Manager reconfigures on it
        return self._inner.errored()

    def set_metrics(self, metrics) -> None:
        fn = getattr(self._inner, "set_metrics", None)
        if callable(fn):
            fn(metrics)

    def set_events(self, events) -> None:
        fn = getattr(self._inner, "set_events", None)
        if callable(fn):
            fn(events)

    def set_wire_members(self, members) -> None:
        fn = getattr(self._inner, "set_wire_members", None)
        if callable(fn):
            fn(members)

    def set_domain_resolver(self, resolver) -> None:
        fn = getattr(self._inner, "set_domain_resolver", None)
        if callable(fn):
            fn(resolver)

    def allreduce(self, arrays: Sequence[np.ndarray],
                  op: str = ReduceOp.SUM,
                  topology: Optional[str] = None) -> Work:
        self.ops += 1
        n = self.ops
        inputs = ([np.array(a, copy=True) for a in arrays]
                  if n in self.record_ops else None)
        inner = self._inner.allreduce(arrays, op, topology=topology).future()
        if n != self.fail_at_op and inputs is None:
            return Work(inner)
        out: Future = Future()
        out.set_running_or_notify_cancel()

        def _done(f: Future) -> None:
            exc = f.exception()
            if exc is None and inputs is not None:
                self.recorded[n] = (inputs,
                                    [np.array(a, copy=True)
                                     for a in f.result()])
            if exc is None and n == self.fail_at_op:
                exc = RuntimeError(f"injected allreduce fault at op {n}")
            if exc is not None:
                out.set_exception(exc)
            else:
                out.set_result(f.result())

        inner.add_done_callback(_done)
        return Work(out)

    # the other collectives run on ``inner`` as they are: a swallowed
    # failure would hide the latch from the Manager's commit vote

    def reduce_scatter(self, arrays: Sequence[np.ndarray],
                       op: str = ReduceOp.SUM,
                       owners: "Optional[Sequence[int]]" = None) -> Work:
        return self._inner.reduce_scatter(arrays, op, owners)

    def allgather(self, arrays: Sequence[np.ndarray]) -> Work:
        return self._inner.allgather(arrays)

    def broadcast(self, arrays: Sequence[np.ndarray], root: int = 0) -> Work:
        return self._inner.broadcast(arrays, root)


@dataclass
class GroupRun:
    """What one replica group did: loss, host wall time, control RPCs and
    wire world per committed step (keyed by the step count after the
    commit; 0 RPCs is a fast-path step), the step count after each step in
    which it applied a healed state, its forward/backward passes (committed
    or not, graph replays and the captures' warm-up passes included) and,
    for an observer, its forward-only probe passes, its replica id, the
    step count at which a quorum answer evicted it and how long that answer
    took (``evict_seconds``, from the step's start), its
    committed fused steps and the CUDA graphs it captured, its committed
    steps whose gradient wire had a peer (``wire_steps``), the element
    counts of DDP's gradient buckets, its resume (step, seconds, and the
    paths where the loaded state differs from the file, when verified),
    its checkpoint writes, its final metrics, and the ops its comm context
    recorded (``record_ops``: op number -> (inputs, raw reduced outputs)).
    """

    passes: int = 0
    probe_passes: int = 0
    wire_steps: int = 0
    fused_steps: int = 0
    captures: int = 0
    buckets: List[int] = field(default_factory=list)
    losses: Dict[int, float] = field(default_factory=dict)
    step_seconds: Dict[int, float] = field(default_factory=dict)
    participants: Dict[int, int] = field(default_factory=dict)
    control_rpcs: Dict[int, int] = field(default_factory=dict)
    wire_world: Dict[int, int] = field(default_factory=dict)
    healed_at: List[int] = field(default_factory=list)
    replica_id: str = ""
    evicted_at: Optional[int] = None
    evict_seconds: Optional[float] = None
    resumed_step: Optional[int] = None
    resume_seconds: Optional[float] = None
    resume_mismatches: List[str] = field(default_factory=list)
    checkpoints: List[Dict[str, Any]] = field(default_factory=list)
    # the manager's metrics snapshot at the end (phase timers, heal gauges,
    # lease counters) and the optimizer wrapper's of its fused steps
    # (barrier, dispatch, fence, transition_drain) and of its classic ones
    # (prologue, dispatch, barrier, fence)
    metrics: Dict[str, object] = field(default_factory=dict)
    fused_metrics: Dict[str, object] = field(default_factory=dict)
    classic_metrics: Dict[str, object] = field(default_factory=dict)
    recorded: Dict[int, Tuple[List[np.ndarray], List[np.ndarray]]] = field(
        default_factory=dict)
    # digests (sha256) of the parameters after each committed step, and of
    # the averaged gradients with DDP's residuals after each average, keyed
    # by the step count after the step (``digest_params``/``digest_averages``)
    param_digests: Dict[int, str] = field(default_factory=dict)
    average_digests: Dict[int, str] = field(default_factory=dict)
    # the Manager's flight recorder at the end (what GET /telemetry/events
    # serves): quorums, heals, commits, the sharded update's reshards
    events: List[Dict[str, Any]] = field(default_factory=list)
    # the same recording read over HTTP before the manager went down, with
    # the metrics (``capture_flight_recording``), when asked for
    telemetry: Dict[str, Any] = field(default_factory=dict)
    # the step count at whose start ``latch_at`` latched the wire
    latched_at: Optional[int] = None


def _digest(tensors: Sequence[Any]) -> str:
    """sha256 over the bytes of tensors and arrays, in order (None skipped)."""
    import hashlib

    h = hashlib.sha256()
    for t in tensors:
        if t is None:
            continue
        if isinstance(t, torch.Tensor):
            t = t.detach().cpu().contiguous().reshape(-1).view(torch.uint8) \
                .numpy()
        h.update(np.ascontiguousarray(t).view(np.uint8).data)
    return h.hexdigest()


def _bytes_of(t: torch.Tensor) -> torch.Tensor:
    return t.detach().cpu().contiguous().reshape(-1).view(torch.uint8)


def _mismatches(got: Any, want: Any, path: str = "") -> List[str]:
    """Paths at which ``got`` differs from ``want``: tensors bitwise
    (dtype, shape and every bit), other values by ``==``."""
    if isinstance(want, dict):
        if not isinstance(got, dict) or set(got) != set(want):
            return [path or "."]
        return [m for k in want
                for m in _mismatches(got[k], want[k], f"{path}/{k}")]
    if isinstance(want, (list, tuple)):
        if not isinstance(got, (list, tuple)) or len(got) != len(want):
            return [path or "."]
        return [m for i, (g, w) in enumerate(zip(got, want))
                for m in _mismatches(g, w, f"{path}/{i}")]
    if isinstance(want, torch.Tensor):
        ok = (isinstance(got, torch.Tensor) and got.dtype == want.dtype
              and got.shape == want.shape
              and torch.equal(_bytes_of(got), _bytes_of(want)))
        return [] if ok else [path]
    return [] if got == want else [path]


def train_group(
    cfg: TransformerConfig,
    *,
    replica_group: int,
    num_groups: int,
    total_steps: int,
    lighthouse_addr: Optional[str] = None,
    device: "Optional[str | torch.device]" = None,
    batch_size: int = 8,
    init_seed: int = 0,
    init_state: Optional[Dict[str, torch.Tensor]] = None,
    data_seed: int = 0,
    dataset_size: int = 4096,
    fail_at_step: Optional[int] = None,
    on_start: Optional[Callable[[Manager], None]] = None,
    on_commit: Optional[Callable[[int, Manager, GPT, Any], None]] = None,
    stop: Optional[threading.Event] = None,
    timeout: float = 60.0,
    rank: int = 0,
    world_size: int = 1,
    store_addr: Optional[str] = None,
    comm_backend: str = "host",
    comm_options: Optional[Dict[str, Any]] = None,
    ckpt_path: Optional[str] = None,
    ckpt_every: int = 0,
    verify_resume: bool = False,
    record_ops: Sequence[int] = (),
    job_id: str = "default",
    data_plane: bool = True,
    model_shards: int = 1,
    on_evicted: Optional[Callable[[Manager, GPT], None]] = None,
    streamed: bool = True,
    sharded: Optional[bool] = None,
    digest_params: bool = False,
    digest_averages: bool = False,
    donate_update: bool = False,
    update_window: Optional[Callable[[], Any]] = None,
    run: Optional[GroupRun] = None,
    capture_telemetry: bool = False,
    use_async_quorum: bool = True,
    latch_at: Optional[int] = None,
) -> GroupRun:
    """Train one replica group until ``total_steps`` steps are committed
    (or ``stop`` is set).

    ``fail_at_step``: raise :class:`InjectedFailure` (after the last
    checkpoint write has persisted, then shutting this group's manager and
    store down) at the top of the first step that starts with
    ``fail_at_step`` or more steps committed. ``init_state``: a model state
    dict to start from instead of the ``init_seed`` draw. ``on_start(
    manager)`` runs once the manager exists; ``on_commit(step, manager,
    model, loss)`` after every commit, ``loss`` being the step's loss on
    the device (reading it syncs). ``comm_backend`` / ``comm_options``: the
    Manager's data plane; the cuda plane reduces on ``device`` unless
    ``comm_options`` names a ``device_pool``.

    ``ckpt_path``: resume from ``latest_checkpoint(ckpt_path)`` if there
    is one (the user state and the Manager's), and write
    ``{ckpt_path}.{step}`` through ``AsyncCheckpointWriter(keep=2)`` after
    every ``ckpt_every``-th committed step. ``verify_resume``: compare the
    resumed state with the file, bitwise (``GroupRun.resume_mismatches``).
    ``record_ops``: numbers (from 1) of this group's gradient allreduces
    whose inputs and raw reduced outputs are kept (``GroupRun.recorded``).

    ``job_id``, ``data_plane`` and ``model_shards`` go to the Manager. With
    ``data_plane=False`` the group is an observer running an evaluation
    probe: each step a forward pass of its own model under
    ``torch.no_grad()`` between the quorum and the commit barrier, and no
    optimizer step. When a quorum answer evicts the group, it stops before
    the step's forward pass, after ``on_evicted(manager, model)``.

    ``streamed``: DDP's per-bucket pipeline (True) or its lock-step arm.
    ``sharded``: None for the classic arm (DDP and ``torch.optim.AdamW``);
    True for ``ShardedOptimizerWrapper`` (optax-order ``adamw``), False for
    that wrapper's replicated arm, its bitwise oracle.
    ``digest_params``/``digest_averages``: keep
    sha256 digests of the parameters after each commit, and of the averaged
    gradients with DDP's residuals after each average.
    ``donate_update``/``update_window``: ``OptimizerWrapper``'s commit
    arm (False: the update overlaps the barrier behind a backup; True:
    decide, then update in place) and the context entered around each
    classic update. ``run``: the
    :class:`GroupRun` to fill (a new one by default), so that a hook can
    read it while the group trains: its ``passes`` count every pass so far,
    the captures' warm-up passes included. ``capture_telemetry``: before the
    manager shuts down, however the run ends, read its flight recording
    and metrics over HTTP into ``run.telemetry``
    (:func:`capture_flight_recording`). ``use_async_quorum`` goes to the
    Manager. ``latch_at``: at the first step that starts with ``latch_at``
    or more steps committed, once that step's quorum is in, latch this
    group's own wire (``_latch_error(RuntimeError("injected transport
    fault"))``: the state a timed-out collective leaves, with the
    membership unchanged), once (``run.latched_at``).

    A CUDA run of a config whose head_dim the flash kernels do not take
    raises ValueError here, before anything is built.
    """
    if torch.device("cuda" if device is None else device).type == "cuda":
        check_head_dim(f"train_group: config with d_model {cfg.d_model} and "
                       f"{cfg.n_heads} heads", cfg.head_dim)
    device = resolve_device(device)
    comm_options = dict(comm_options or {})
    if comm_backend == "cuda":
        comm_options.setdefault("device_pool", default_device_pool(device))
    model = GPT(cfg, device=device, seed=init_seed)
    if init_state is not None:
        model.load_state_dict(init_state)
    # one optimizer for both classic paths; on the card its step count
    # lives on the device, which the fused step's CUDA graph needs
    optimizer = torch.optim.AdamW(model.parameters(), lr=3e-4,
                                  weight_decay=1e-4,
                                  capturable=device.type == "cuda")
    if sharded is None:
        # its state now, as optax's init: no update allocates the moments
        init_adam_state(optimizer)
    sharded_opt: Optional[ShardedOptimizerWrapper] = None
    # synthetic next-token dataset, sharded across groups x local ranks
    rng = np.random.default_rng(data_seed)
    dataset = rng.integers(0, cfg.vocab_size, (dataset_size, cfg.max_seq_len))
    sampler = DistributedSampler(
        len(dataset), replica_group=replica_group,
        num_replica_groups=num_groups, rank=rank, num_replicas=world_size,
        shuffle=True, seed=1,
    )

    def state_dict():
        if sharded is not None:
            # the sharded arm's optimizer shard rides under train.opt
            return {"train": {"params": model.state_dict(),
                              "opt": sharded_opt.opt_state_dict()},
                    "sampler": sampler.state_dict()}
        return {"model": model.state_dict(), "optim": optimizer.state_dict(),
                "sampler": sampler.state_dict()}

    def load_state_dict(sd):
        # in place where the tensors exist, so the fused step's graph stays
        # valid across heals and resumes
        if sharded is not None:
            model.load_state_dict(sd["train"]["params"])
            sharded_opt.load_opt_state_dict(sd["train"]["opt"])
        else:
            model.load_state_dict(sd["model"])
            load_optimizer_state_dict(optimizer, sd["optim"])
        sampler.load_state_dict(sd["sampler"])

    # per-group rendezvous store: rank 0 binds it
    store = StoreServer() if rank == 0 and store_addr is None else None
    comm: Optional[FaultyCommContext] = None
    if record_ops:
        comm = FaultyCommContext(
            _build_comm_context(comm_backend, comm_options, timeout),
            record_ops=record_ops)
    manager = Manager(
        comm=comm,
        comm_backend=None if comm is not None else comm_backend,
        comm_options=None if comm is not None else comm_options,
        load_state_dict=load_state_dict,
        state_dict=state_dict,
        min_replica_size=1,
        use_async_quorum=use_async_quorum,
        timeout=timeout,
        quorum_timeout=timeout,
        connect_timeout=timeout,
        rank=rank,
        world_size=world_size,
        store_addr=store.addr if store is not None else store_addr,
        lighthouse_addr=lighthouse_addr,
        replica_id=(f"train_ddp_{replica_group}_" if job_id == "default"
                    else f"train_ddp_{job_id}_{replica_group}_"),
        heartbeat_interval=0.05,
        data_plane=data_plane,
        model_shards=model_shards,
        job_id=job_id,
        checkpoint_transport=None if sharded is None else CheckpointServer(
            timeout=timeout, defer_paths=OPT_SLOTS_PATH_RE),
    )
    ddp = DistributedDataParallel(manager, streamed=streamed)
    opt = OptimizerWrapper(manager, optimizer, donate_update=donate_update,
                           update_window=update_window)
    if sharded is not None:
        sharded_opt = ShardedOptimizerWrapper(
            manager, adamw(3e-4, weight_decay=1e-4), model, sharded=sharded)
    # the solo-wire step: forward, backward and AdamW as one CUDA graph
    train_step = make_train_step(model, optimizer)
    run = run if run is not None else GroupRun()
    run.replica_id = manager.replica_id()
    warmups = 0  # the captures' warm-up passes already in run.passes
    writer: Optional[AsyncCheckpointWriter] = None

    try:
        if ckpt_path is not None:
            # durable resume (the user's job in the reference torchft): the
            # Manager's state_dict rides in the same file
            newest = latest_checkpoint(ckpt_path)
            if newest is not None:
                t0 = time.perf_counter()
                saved = load_checkpoint(newest)
                load_state_dict(saved["user"])
                manager.load_state_dict(saved["manager"])
                if device.type == "cuda":
                    torch.cuda.current_stream(device).synchronize()
                run.resume_seconds = time.perf_counter() - t0
                run.resumed_step = manager.current_step()
                if verify_resume:
                    run.resume_mismatches = _mismatches(
                        {"user": state_dict(),
                         "manager": manager.state_dict()}, saved)
                del saved
            # stage on call, persist in the background: training never
            # waits on the disk, only on the device-to-host copy
            writer = AsyncCheckpointWriter(keep=2)
        it = iter(sampler)

        def next_batch():
            nonlocal it
            idx: List[int] = []
            while len(idx) < batch_size:
                try:
                    idx.append(next(it))
                except StopIteration:
                    sampler.set_epoch(sampler.epoch + 1)
                    it = iter(sampler)
            tokens = torch.as_tensor(dataset[idx], device=device)
            return tokens, torch.roll(tokens, -1, dims=1)

        if on_start is not None:
            on_start(manager)
        while manager.current_step() < total_steps and not (
                stop is not None and stop.is_set()):
            if (fail_at_step is not None
                    and manager.current_step() >= fail_at_step):
                if writer is not None:
                    writer.wait()  # the kill lands once the write persisted
                raise InjectedFailure(
                    f"group {replica_group} at step {fail_at_step}", run,
                    fail_at_step)
            tokens, targets = next_batch()
            t0 = time.perf_counter()
            if sharded_opt is not None:
                # the sharded update never fuses
                sharded_opt.begin_step()
                fuse = False
                try:
                    manager.wait_quorum()
                except Exception as e:  # noqa: BLE001 — the barrier discards
                    manager.report_error(e)
            elif data_plane:
                opt.begin_step()
                fuse = opt.can_fuse()  # waits the quorum; latches on failure
            else:
                manager.start_quorum()
                try:
                    manager.wait_quorum()
                except Exception as e:  # noqa: BLE001 — the barrier discards
                    manager.report_error(e)
            if (latch_at is not None and run.latched_at is None
                    and manager.current_step() >= latch_at):
                run.latched_at = manager.current_step()
                manager._comm._latch_error(
                    RuntimeError("injected transport fault"))
            if manager.is_evicted():
                run.evicted_at = manager.current_step()
                run.evict_seconds = time.perf_counter() - t0
                if on_evicted is not None:
                    on_evicted(manager, model)
                break
            if not data_plane:
                # the observer's probe: a forward pass of its own model
                # between the quorum and the barrier; no gradient, no update
                with manager.metrics.timed("probe_forward"), torch.no_grad():
                    loss = model.loss(tokens, targets)
                run.probe_passes += 1
                committed = manager.should_commit()
                if committed:
                    run.losses[manager.current_step()] = float(loss)
            elif fuse:
                loss, committed = opt.fused_step(train_step, tokens, targets)
                if committed:
                    run.passes += 1
                    run.fused_steps += 1
            elif sharded_opt is not None:
                run.passes += 1
                with manager.metrics.timed("forward_backward"):
                    loss = model.loss(tokens, targets)
                    loss.backward()
                    if device.type == "cuda":
                        torch.cuda.current_stream(device).synchronize()
                loss = loss.detach()
                committed = sharded_opt.step()
                if committed:
                    run.losses[manager.current_step()] = float(loss)
            else:
                run.passes += 1
                with manager.metrics.timed("forward_backward"):
                    loss = model.loss(tokens, targets)
                    loss.backward()
                    if device.type == "cuda":
                        torch.cuda.current_stream(device).synchronize()
                ddp.average_gradients(model)
                if digest_averages:
                    run.average_digests[manager.current_step() + 1] = _digest(
                        [p.grad for p in model.parameters()]
                        + list(ddp._residuals or ()))
                loss = loss.detach()
                committed = opt.step(loss)
            run.passes += train_step.warmup_passes - warmups
            warmups = train_step.warmup_passes
            run.losses.update(opt.take_losses())
            step = manager.current_step()
            if manager.did_heal():
                run.healed_at.append(step)
            if not committed:
                continue
            run.step_seconds[step] = time.perf_counter() - t0
            run.participants[step] = manager.num_participants()
            run.control_rpcs[step] = manager.control_rpcs()
            run.wire_world[step] = manager.transport_world_size()
            if manager.transport_world_size() > 1:
                run.wire_steps += 1
            if digest_params:
                run.param_digests[step] = _digest(list(model.parameters()))
            if writer is not None and ckpt_every and step % ckpt_every == 0:
                writer.save_step(ckpt_path, step, {
                    "user": state_dict(), "manager": manager.state_dict(),
                })
            if on_commit is not None:
                on_commit(step, manager, model, loss)
        if writer is not None:
            writer.wait()  # surface a write error before returning
    finally:
        try:
            run.losses.update(opt.drain())
        except Exception as e:  # noqa: BLE001 — keep the step's own error
            logger.warning(f"group {replica_group}: loss readback failed: {e}")
        run.passes += train_step.warmup_passes - warmups
        run.captures = train_step.captures
        if writer is not None:
            try:
                writer.close()
            except Exception as e:  # noqa: BLE001 — raised by wait() above
                logger.warning(f"group {replica_group}: checkpoint: {e}")
            run.checkpoints = list(writer.saves)
        run.metrics = manager.metrics.snapshot()
        run.fused_metrics = opt.fused_metrics.snapshot()
        run.classic_metrics = opt.classic_metrics.snapshot()
        run.buckets = (ddp.bucket_sizes() if sharded_opt is None
                       else sharded_opt.bucket_sizes())
        if manager.events:
            run.events = manager.events.since(0)[0]
        if capture_telemetry:
            run.telemetry = capture_flight_recording(
                store.addr if store is not None else store_addr, rank=rank,
                job_id=job_id, timeout=min(timeout, 10.0))
        if comm is not None:
            run.recorded = comm.recorded
        manager.shutdown(wait=False)
        if store is not None:
            store.shutdown()
    return run


def group_devices(groups: int,
                  device: "Optional[str | torch.device]" = None,
                  devices: "Optional[Sequence[str | torch.device]]" = None,
                  comm_backend: str = "host",
                  comm_options: Optional[Dict[str, Any]] = None
                  ) -> Tuple[list, Dict[str, Any]]:
    """Each drill group's device and the groups' wire options. Without
    ``devices`` every group runs on ``device``. With a list, group g's
    model, optimizer and batches live on ``devices[g % len(devices)]``,
    and on the cuda plane every group shares one
    ``DevicePool(devices=...)`` over those cards (position g is group g's
    card; rank r of the wire lies on position r), unless ``comm_options``
    names a ``device_pool``."""
    options = dict(comm_options or {})
    if devices is None:
        return [device] * groups, options
    if device is not None:
        raise ValueError("pass `device` or `devices`, not both")
    devs = [devices[g % len(devices)] for g in range(groups)]
    if comm_backend == "cuda":
        options.setdefault("device_pool", DevicePool(devices=devs))
    return devs, options


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def _wait_for(pred: Callable[[], bool], what: str, timeout: float,
              stop: threading.Event) -> None:
    """Poll ``pred`` until it holds; TimeoutError(``what``) after
    ``timeout`` s, RuntimeError once another group of the drill failed
    (``stop``)."""
    deadline = time.monotonic() + timeout
    while not pred():
        if stop.is_set():
            raise RuntimeError("another replica group failed")
        if time.monotonic() > deadline:
            raise TimeoutError(what)
        time.sleep(0.01)


def _wait_lighthouse(addr: str, key: str, count: int, timeout: float,
                     stop: threading.Event, at_most: bool = False,
                     job: str = "default") -> None:
    """Wait until the lighthouse's ``/status.json`` counts at least (with
    ``at_most``: at most) ``count`` ``key`` (``healthy`` heartbeating
    replicas, or ``participants`` waiting in a quorum request) in ``job``."""
    deadline = time.monotonic() + timeout
    while True:
        with urllib.request.urlopen(f"{addr}/status.json",
                                    timeout=timeout) as r:
            n = json.load(r)["jobs"].get(job, {}).get(key, 0)
            if (n <= count) if at_most else (n >= count):
                return
        if stop.is_set():
            raise RuntimeError("the other replica group failed")
        if time.monotonic() > deadline:
            raise TimeoutError(f"lighthouse never counted {count} {key}")
        time.sleep(0.01)


def _run_groups(bodies: Sequence[Callable[[], None]], lighthouse: Lighthouse,
                stop: threading.Event,
                on_error: Callable[[], None] = lambda: None) -> None:
    """Run each replica group's body on a thread of its own (``group{g}``)
    and wait for all; then shut the drill's lighthouse down and raise the
    first group's error. A group that fails sets ``stop`` and calls
    ``on_error``, so that no other group waits for it."""
    errors: List[BaseException] = []

    def guarded(fn: Callable[[], None]) -> Callable[[], None]:
        def _run():
            try:
                fn()
            except BaseException as e:  # noqa: BLE001 — re-raised below
                errors.append(e)
                stop.set()  # never strand the other groups
                on_error()
        return _run

    threads = [threading.Thread(target=guarded(fn), name=f"group{g}")
               for g, fn in enumerate(bodies)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        lighthouse.shutdown()
    if errors:
        raise errors[0]


def _group_lives(train: Callable[[int, Optional[int]], GroupRun],
                 fails: Sequence[int], restart: Callable[[int, int], None],
                 lives: List[GroupRun]) -> None:
    """One replica group's lives, appended to ``lives`` as each ends:
    ``train(life, fail_at_step)`` runs life ``life`` (from its own init,
    ``seed + 1000 * life`` in the drills), armed with the first kill of
    ``fails`` that has not fired. A life killed by :class:`InjectedFailure`
    at step s is followed by the next once ``restart(life, s)`` returns;
    a life that ends with its kill unfired raises AssertionError."""
    fired: List[int] = []
    life = 0
    while True:
        fail = next((s for s in fails if s not in fired), None)
        try:
            lives.append(train(life, fail))
        except InjectedFailure as e:
            # keep the run, not the exception: its traceback holds the
            # dead life's frames
            lives.append(e.run)
            fired.append(e.step)
        else:
            _require(fail is None, f"{threading.current_thread().name} "
                     f"was never failed at step {fail}")
            return
        restart(life, fired[-1])
        life += 1


class _DrillDomains:
    """The drill's domain tree, served to a :class:`DomainTopology` through
    its ``fetch`` hook as a root ``/status.json`` with one aggregator per
    domain, each listing the replica ids of its groups. Replica ids are
    uuid-suffixed, so a group registers its id when its Manager starts (a
    restarted group registers a new one); the resolver pins each id at
    first sight, as it does on a live tree."""

    ROOT = "drill://domains"

    def __init__(self, domains: Dict[str, Sequence[int]]) -> None:
        self._domains = {str(k): [int(g) for g in v]
                         for k, v in domains.items()}
        self._ids: Dict[int, List[str]] = {}
        self._lock = threading.Lock()
        self.resolver = DomainTopology(status_url=self.ROOT,
                                       fetch=self._fetch)

    def register(self, group: int, replica_id: str) -> None:
        with self._lock:
            self._ids.setdefault(group, []).append(replica_id)

    def _fetch(self, url: str, timeout: float) -> Dict[str, Any]:
        if url == f"{self.ROOT}/status.json":
            return {"domains": {name: {"address": f"{self.ROOT}/{name}"}
                                for name in self._domains}}
        name = url[len(self.ROOT) + 1:-len("/status.json")]
        with self._lock:
            ids = [rid for g in self._domains[name]
                   for rid in self._ids.get(g, ())]
        return {"quorum": {"participants": [{"replica_id": rid}
                                            for rid in ids]}}


def run_kill_and_heal(
    cfg: TransformerConfig,
    *,
    kill_step: int = 3,
    steps_after: int = 2,
    groups: int = 2,
    kill_group: int = 1,
    steps_alone: int = 1,
    domains: Optional[Dict[str, Sequence[int]]] = None,
    record_step: Optional[int] = None,
    device: "Optional[str | torch.device]" = None,
    batch_size: int = 8,
    seed: int = 0,
    timeout: float = 60.0,
    log: Callable[[str], None] = logger.info,
    comm_backend: str = "host",
    comm_options: Optional[Dict[str, Any]] = None,
    streamed: bool = True,
    sharded: Optional[bool] = None,
    model_shards: int = 1,
    digest_params: bool = False,
    devices: "Optional[Sequence[str | torch.device]]" = None,
) -> Dict[str, object]:
    """``groups`` replica groups under an in-process lighthouse, on a fixed
    schedule (k = ``kill_step``, s = ``steps_alone``, a = ``steps_after``):

    - every group commits steps 1..k;
    - group ``kill_group`` fails; the others commit k + 1..k + s without it;
    - it restarts from a poisoned init (another seed) at step 0, heals from
      a peer in its first step and commits k + s + 1 with them;
    - all commit steps k + s + 2..k + s + 1 + a, and stop.

    The groups wait for each other at the lighthouse where the schedule
    needs it (all heartbeating before the first quorum; the restarted
    group's quorum request pending before the survivors ask for step
    k + s + 1), so every run makes the same forward/backward passes:
    groups * (k + s + 1 + a) - s (2k + 2a + 3 at the defaults).

    ``domains`` (``{name: [group, ...]}``) maps the groups to domains for
    ``topology="hier"``: every group's context resolves through one
    :class:`DomainTopology` over the drill's domain tree
    (:class:`_DrillDomains`), given as its ``domain_resolver``.
    ``record_step``: each group's first life records its gradient
    allreduces of that step (a joint step up to k) in ``GroupRun.recorded``.
    ``comm_backend`` / ``comm_options`` select the wire, ``streamed`` DDP's
    arm, ``sharded`` the weight update, ``model_shards`` its mesh and
    ``digest_params`` the digests, as for :func:`train_group`.
    ``devices``: group g on ``devices[g % len(devices)]`` and one shared
    ``DevicePool`` over them on the cuda plane (:func:`group_devices`); a
    heal moves the donor's state to the healer's card over HTTP. With
    ``sharded=True`` the survivors reshard onto the shrunken wire after the
    kill, the restarted group heals its optimizer shard with
    ``fetch_opt_shard``, and all reshard back.

    Raises AssertionError unless, at every committed step, the parameters
    of every group that committed it are bitwise equal (the healed group
    included, from its heal on), and every loss is finite. Returns the
    groups' last runs (``runs``) and all their lives (``lives``), the heal
    step, the steps from the heal on at which every group was compared
    (``checked_steps``), the number of groups compared at each step
    (``compared``), the forward/backward passes of all runs and the domain
    tree (``domains``)."""
    if not 0 <= kill_group < groups or groups < 2:
        raise ValueError(f"kill_group {kill_group} of {groups} groups")
    s_alone = steps_alone
    if record_step is not None and not 1 <= record_step <= kill_step:
        raise ValueError(f"record_step {record_step} is not a joint step "
                         f"in 1..{kill_step}")
    # the default two-group drill keeps the lighthouse's 200 ms join
    # window; more groups, started one after another, wait for each other
    lighthouse = Lighthouse(
        min_replicas=1, heartbeat_timeout_ms=1000,
        join_timeout_ms=200 if groups == 2 else int(timeout * 1000))
    addr = lighthouse.address()
    total = kill_step + s_alone + 1 + steps_after
    survivors = [g for g in range(groups) if g != kill_group]
    ahead, stop = threading.Event(), threading.Event()
    survivors_done = threading.Barrier(len(survivors))
    runs: Dict[int, List[GroupRun]] = {g: [] for g in range(groups)}
    tree = _DrillDomains(domains) if domains is not None else None
    devs, comm_options = group_devices(groups, device, devices, comm_backend,
                                       comm_options)
    if tree is not None:
        comm_options["domain_resolver"] = tree.resolver
    # bitwise comparison per step, as soon as every group of it committed
    lock = threading.Lock()
    pending: Dict[int, Dict[int, List[torch.Tensor]]] = {}
    compared: Dict[int, int] = {}

    def expected(step: int) -> int:
        alone = kill_step < step <= kill_step + s_alone
        return groups - 1 if alone else groups

    def deposit(group: int, step: int, model) -> None:
        snap = [p.detach().clone() for p in model.parameters()]
        with lock:
            held = pending.setdefault(step, {})
            held[group] = snap
            if len(held) < expected(step):
                return
            del pending[step]
        first = min(held)
        for g in sorted(held):
            for a, b in zip(held[first], held[g]):
                _require(torch.equal(a, b.to(a.device)), f"group {g} "
                         f"diverged from group {first} at step {step}")
        compared[step] = len(held)

    def started(group: int, wait_all: bool):
        def _start(manager):
            if tree is not None:
                tree.register(group, manager.replica_id())
            if wait_all:
                _wait_lighthouse(addr, "healthy", groups, timeout, stop)
        return _start

    def on_commit(group: int):
        def _hook(step, manager, model, loss):
            log(f"group {group} committed step {step} "
                f"participants {manager.num_participants()}"
                + (" (healed)" if manager.did_heal() else ""))
            deposit(group, step, model)
            if group != kill_group and step == kill_step + s_alone:
                # let the failed group restart, then take the next quorum
                # with it: no survivor asks before all have committed
                survivors_done.wait(timeout)
                ahead.set()
                _wait_lighthouse(addr, "participants", 1, timeout, stop)
        return _hook

    common = dict(num_groups=groups, lighthouse_addr=addr,
                  batch_size=batch_size, data_seed=seed, timeout=timeout,
                  total_steps=total, stop=stop, comm_backend=comm_backend,
                  comm_options=comm_options, streamed=streamed,
                  sharded=sharded, model_shards=model_shards,
                  digest_params=digest_params)
    record = ()
    if record_step is not None:
        n_buckets = len(_BucketPlan(list(GPT(cfg, device="meta")
                                         .parameters()),
                                    _DEFAULT_BUCKET_BYTES).buckets)
        record = range((record_step - 1) * n_buckets + 1,
                       record_step * n_buckets + 1)

    def group(g: int):
        def train(life: int, fail: Optional[int]) -> GroupRun:
            return train_group(
                cfg, replica_group=g, init_seed=seed + 1000 * life,
                device=devs[g], fail_at_step=fail,
                on_start=started(g, not life), on_commit=on_commit(g),
                record_ops=() if life else record, **common)

        def restart(life: int, step: int) -> None:
            log(f"injected failure: group {g} at step {step}; restarting "
                "from a poisoned init")
            if not ahead.wait(timeout) or stop.is_set():
                raise TimeoutError(
                    f"the survivors never committed step {kill_step + s_alone}")

        return lambda: _group_lives(
            train, (kill_step,) if g == kill_group else (), restart, runs[g])

    def unblock() -> None:
        ahead.set()
        survivors_done.abort()

    _run_groups([group(g) for g in range(groups)], lighthouse, stop,
                unblock)

    restarted = runs[kill_group][-1]
    _require(restarted.healed_at == [kill_step + s_alone + 1],
             f"the restarted group healed at {restarted.healed_at}, not at "
             f"step {kill_step + s_alone + 1}")
    heal_step = restarted.healed_at[0]
    _require(not pending and sorted(compared) == list(range(1, total + 1)),
             f"steps compared {sorted(compared)}, left {sorted(pending)}")
    steps = [s for s in range(heal_step, total + 1)
             if compared[s] == groups]
    _require(steps == list(range(heal_step, total + 1)),
             f"heal at {heal_step}; steps all groups committed: {steps}")
    losses = [v for g in runs for r in runs[g] for v in r.losses.values()]
    _require(all(math.isfinite(v) for v in losses), "non-finite loss")
    return {"runs": {g: runs[g][-1] for g in runs}, "lives": runs,
            "heal_step": heal_step, "checked_steps": steps,
            "compared": dict(sorted(compared.items())),
            "passes": sum(r.passes for g in runs for r in runs[g]),
            "domains": tree}


def run_joint(cfg: TransformerConfig, *, groups: int = 2, steps: int = 3,
              device: "Optional[str | torch.device]" = None,
              batch_size: int = 8, seed: int = 0, timeout: float = 60.0,
              **kwargs) -> Dict[int, GroupRun]:
    """``groups`` replica groups under an in-process lighthouse commit
    ``steps`` steps together from the same seed, with no failure: the run
    an A/B arm is compared on (``kwargs`` go to :func:`train_group`, e.g.
    ``streamed``, ``sharded``, ``comm_backend``, ``digest_params``).
    Every group waits for all to heartbeat before its first quorum.
    Returns each group's run; raises the first group's error."""
    lighthouse = Lighthouse(min_replicas=1, heartbeat_timeout_ms=1000,
                            join_timeout_ms=int(timeout * 1000))
    addr = lighthouse.address()
    stop = threading.Event()
    runs: Dict[int, GroupRun] = {}

    def started(manager) -> None:
        _wait_lighthouse(addr, "healthy", groups, timeout, stop)

    def group(g: int):
        def _run() -> None:
            runs[g] = train_group(
                cfg, replica_group=g, num_groups=groups, total_steps=steps,
                lighthouse_addr=addr, device=device, batch_size=batch_size,
                init_seed=seed, data_seed=seed, timeout=timeout, stop=stop,
                on_start=started, **kwargs)
        return _run

    _run_groups([group(g) for g in range(groups)], lighthouse, stop)
    return runs


# run_process_drill's schedule (k, s, a) and its slack on the card's memory
PROC_KILL, PROC_SOLO, PROC_AFTER = 3, 2, 3
PROC_MEMORY_SLACK = 1 << 30
# what each drill commit carries of its life's recording: enough to say,
# when two lives' parameters differ, which one moved first
LIFE_KINDS = ("quorum_complete", "member_dead", "step_commit", "step_discard",
              "heal_start", "heal_done", "error_latched")
LIFE_FIELDS = ("kind", "step", "epoch", "wire_world", "member")


def _life_history(events: Sequence[Dict[str, Any]]) -> str:
    """One life's recorded quorums, deaths, commits, discards, heals and
    latches, compact, each at the step count it was recorded at:
    ``q3/w2@2`` is a quorum of epoch 3 with a wire of 2, ``c@2`` the commit
    that took the count from 2 to 3."""
    short = {"quorum_complete": "q", "member_dead": "dead",
             "step_commit": "c", "step_discard": "x", "heal_start": "hs",
             "heal_done": "hd", "error_latched": "err"}
    out = []
    for e in events:
        tag = short.get(e["kind"], e["kind"])
        if e["kind"] == "quorum_complete":
            tag += f"{e.get('epoch')}/w{e.get('wire_world')}"
        elif e["kind"] == "member_dead":
            tag += f"({e.get('member')})"
        out.append(f"{tag}@{e.get('step')}")
    return " ".join(out) or "(none)"


def check_digests(commits: Dict[Tuple[int, int],
                                 Dict[int, Dict[str, Any]]]) -> List[int]:
    """The steps that more than one life of the drill committed (``commits``
    by (group, life), then by step, as :func:`run_process_drill` gathers
    them), after checking that their parameter digests are equal. On a
    difference the AssertionError gives each life's recorded quorums,
    deaths, commits, discards and heals up to that step, from its commit
    messages, so the message says which group moved first."""
    by_step: Dict[int, List[Tuple[Tuple[int, int], str]]] = {}
    for key, steps in commits.items():
        for step, body in steps.items():
            by_step.setdefault(step, []).append((key, body["digest"]))
    overlap = []
    for step, entries in sorted(by_step.items()):
        if len(entries) < 2:
            continue
        overlap.append(step)
        (g0, i0), digest0 = entries[0]
        for (g, i), digest in entries[1:]:
            if digest != digest0:
                raise AssertionError(
                    f"group {g} life {i} diverged from group {g0} life {i0} "
                    f"at step {step}; each life's recording up to it:\n"
                    + "\n".join(
                        f"  group {gk} life {ik}: " + _life_history(
                            [e for s in sorted(c) if s <= step
                             for e in c[s]["events"]])
                        for (gk, ik), c in sorted(commits.items())))
    return overlap


def _recording(dump: Dict[str, Any], what: str) -> List[Dict[str, Any]]:
    _require("capture_error" not in dump,
             f"{what}: no flight recording: {dump.get('capture_error')}")
    return sorted(dump["events"]["events"], key=lambda e: e["seq"])


def check_lifecycle(survivor: Dict[str, Any], relaunch: Dict[str, Any], *,
                    dead_id: str, relaunch_id: str, kill_step: int,
                    total: int) -> Dict[str, Any]:
    """The kill-to-heal lifecycle from two flight recordings alone (the
    survivor's and the relaunch's, as :func:`capture_flight_recording`
    returns them), by the checks of the JAX package's
    tests/test_telemetry_integration.py. The survivor: a quorum with two
    on the wire, then ``member_dead`` naming ``dead_id`` at a higher epoch,
    a later quorum at an epoch no lower, a commit after the death and a
    two-member wire again. The relaunch: ``heal_start`` before
    ``heal_done`` at an epoch no lower than the death's, then a commit
    beyond ``kill_step``, every event stamped ``relaunch_id`` and rank 0.
    The survivor's metrics: ``steps_committed`` at least ``total`` and a
    finite ``allreduce_p50_ms``. The two recordings make one valid Chrome
    trace. Extra events are allowed, missing ones are not. Raises
    AssertionError on the first check that fails; returns the epochs, the
    walls of the death, the heal and the first resumed commit, and the
    counts."""
    surv = _recording(survivor, "the survivor")
    heal = _recording(relaunch, "the relaunch")
    brief = f"the survivor's recording: {_life_history(surv)}"
    quorums = [e for e in surv if e["kind"] == "quorum_complete"]
    deaths = [e for e in surv
              if e["kind"] == "member_dead" and e["member"] == dead_id]
    _require(bool(deaths), f"no member_dead naming {dead_id}; {brief}")
    death = deaths[0]
    before = [e for e in quorums
              if e["seq"] < death["seq"] and e["wire_world"] == 2]
    _require(bool(before) and death["epoch"] > before[-1]["epoch"],
             f"member_dead at epoch {death['epoch']} is not above a "
             f"two-wire quorum before it; {brief}")
    after = [e for e in quorums if e["seq"] > death["seq"]]
    _require(bool(after) and after[0]["epoch"] >= death["epoch"],
             f"no quorum at epoch >= {death['epoch']} after the death; "
             f"{brief}")
    _require(any(e["kind"] == "step_commit" and e["seq"] > death["seq"]
                 for e in surv), f"no commit after the death; {brief}")
    rejoin = [e for e in after if e["wire_world"] == 2]
    _require(bool(rejoin), f"the relaunch never re-entered the survivor's "
             f"wire; {brief}")
    hs = [e for e in heal if e["kind"] == "heal_start"]
    hd = [e for e in heal if e["kind"] == "heal_done"]
    brief = f"the relaunch's recording: {_life_history(heal)}"
    _require(bool(hs) and bool(hd) and hs[0]["seq"] < hd[0]["seq"],
             f"no heal_start before heal_done; {brief}")
    _require(hs[0]["epoch"] >= death["epoch"],
             f"heal_start at epoch {hs[0]['epoch']}, below the death's "
             f"{death['epoch']}; {brief}")
    resumed = [e for e in heal
               if e["kind"] == "step_commit" and e["seq"] > hd[0]["seq"]]
    _require(bool(resumed) and max(e["step"] for e in resumed) > kill_step,
             f"no commit beyond step {kill_step} after the heal; {brief}")
    stamps = {(e["replica_id"], e["rank"]) for e in heal}
    _require(stamps == {(relaunch_id, 0)},
             f"the relaunch's events carry {stamps}, want "
             f"{{({relaunch_id!r}, 0)}}")
    metrics = survivor["metrics"]["metrics"]
    p50 = metrics.get("allreduce_p50_ms")
    _require(metrics.get("steps_committed", 0) >= total,
             f"the survivor's steps_committed "
             f"{metrics.get('steps_committed')}, want >= {total}")
    _require(p50 is not None and math.isfinite(p50),
             f"the survivor's allreduce_p50_ms is {p50}")
    trace = json.loads(json.dumps(to_chrome_trace(
        [survivor["events"], relaunch["events"]])))
    problems = validate_chrome_trace(trace)
    _require(problems == [], f"the merged Chrome trace: {problems}")
    counts: Dict[str, Dict[str, int]] = {}
    for life, evs in (("survivor", surv), ("relaunch", heal)):
        for e in evs:
            kinds = counts.setdefault(life, {})
            kinds[e["kind"]] = kinds.get(e["kind"], 0) + 1
    return dict(
        last_two_wire_epoch=before[-1]["epoch"], death_epoch=death["epoch"],
        death_step=death["step"], rejoin_epoch=rejoin[0]["epoch"],
        heal_epoch=hs[0]["epoch"], member_dead_wall=death["t_wall"],
        heal_start_wall=hs[0]["t_wall"], heal_done_wall=hd[0]["t_wall"],
        first_resumed_commit=resumed[0]["step"],
        first_resumed_wall=resumed[0]["t_wall"],
        allreduce_p50_ms=p50, steps_committed=metrics["steps_committed"],
        event_counts=counts, trace_events=len(trace["traceEvents"]),
        trace_valid=True)


def _free_port_base(count: int, preferred: Optional[int] = None,
                    avoid: Sequence[int] = ()) -> int:
    """A port p such that p .. p + count - 1 all bind on every interface
    now (as the ManagerServer binds) and none is in ``avoid``:
    ``preferred`` if so, else a random one below the ephemeral range."""
    import random
    import socket

    def free(base: int) -> bool:
        if any(base <= a < base + count for a in avoid):
            return False
        socks = []
        try:
            for port in range(base, base + count):
                s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
                socks.append(s)
                s.bind(("0.0.0.0", port))
            return True
        except OSError:
            return False
        finally:
            for s in socks:
                s.close()

    if preferred is not None and free(preferred):
        return preferred
    rng = random.Random()
    for _ in range(500):
        base = rng.randrange(20000, 32000 - count)
        if free(base):
            return base
    raise RuntimeError(f"no {count} consecutive free ports")


def _drill_wait(what: tuple, addr: str, timeout: float, stop) -> None:
    """One gate of the process drill's schedule: ``("event", ev, what)``
    waits for a multiprocessing event, ``("lighthouse", key, count)`` for
    the lighthouse's ``/status.json`` to count ``count`` ``key``."""
    if what[0] == "event":
        _wait_for(what[1].is_set, what[2], timeout, stop)
    else:
        _wait_lighthouse(addr, what[1], what[2], timeout, stop)


def _proc_group_main(cfg: TransformerConfig, env: Dict[str, str],
                     incarnation: int, train_kwargs: Dict[str, Any],
                     waits: Dict[Any, Sequence[tuple]], queue, stop) -> None:
    """One replica group of :func:`run_process_drill` as its own OS
    process (the spawn target): the launcher's environment for its group
    (``env``: the lighthouse, ``REPLICA_GROUP_ID``, the store and manager
    ports), its own store on ``MASTER_PORT``, and :func:`train_group`. It
    posts to ``queue``, its own (one writer a queue): ``("started", group,
    incarnation, wall, {"startup": ..., "replica_id": ...})`` once its
    manager exists, with the seconds of CUDA's initialisation, the kernels'
    load and the model's build, and the manager's replica id (the victim's
    first life, SIGKILLed, says nothing after this); ``("commit", ...)``
    after every commit (participants, heal, parameter digest, passes so
    far, cumulative flash launches, device memory, loss, ``update_rise``:
    the bytes a classic update allocated beyond those allocated as it
    began, None for a fused commit and on the CPU, and ``events``: the
    lifecycle events recorded since the last commit, ``LIFE_KINDS``);
    ``("done", ...)`` with the run's summary and its flight recording
    read over HTTP before the manager went down (``telemetry``), or
    ``("error", ..., traceback)``, a failed capture included. ``waits``
    gates the schedule: ``waits["start"]`` before the first quorum,
    ``waits[step]`` after the commit of ``step`` (:func:`_drill_wait`)."""
    import traceback

    t_entry = time.time()
    group, store = -1, None
    try:
        os.environ.update(env)
        group = int(os.environ["REPLICA_GROUP_ID"])
        device = resolve_device(train_kwargs["device"])
        cuda = device.type == "cuda"
        startup: Dict[str, float] = {"entry": t_entry}
        if cuda:
            # f32 products stay f32, as in main()
            torch.backends.cuda.matmul.allow_tf32 = False
            t0 = time.perf_counter()
            torch.empty(1, device=device)
            torch.cuda.synchronize(device)
            startup["cuda_init_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            from torchft_tpu_torch.ops import _build

            _build.load_kernels()
            startup["kernel_load_s"] = time.perf_counter() - t0
        store = StoreServer(port=int(os.environ["MASTER_PORT"]))
        addr, timeout = os.environ[LIGHTHOUSE_ENV], train_kwargs["timeout"]
        run = GroupRun()
        t_build = time.perf_counter()

        # the peak before the last reset of the allocator's statistics,
        # the manager, and each classic commit's update rise by step
        held: Dict[str, Any] = {"peak": 0, "manager": None, "rises": {},
                                "cursor": 0}

        def memory() -> Dict[str, Optional[int]]:
            if not cuda:
                return {"peak": None, "allocated": None, "reserved": None}
            return {"peak": max(held["peak"],
                                torch.cuda.max_memory_allocated(device)),
                    "allocated": torch.cuda.memory_allocated(device),
                    "reserved": torch.cuda.memory_reserved(device)}

        @contextmanager
        def update_window():
            # a classic update's rise: the most allocated in its window
            # beyond what was allocated as it began
            if not cuda:
                yield
                return
            held["peak"] = memory()["peak"]
            torch.cuda.reset_peak_memory_stats(device)
            base = torch.cuda.memory_allocated(device)
            yield
            held["rises"][held["manager"].current_step()] = (
                torch.cuda.max_memory_allocated(device) - base)

        def on_start(manager: Manager) -> None:
            held["manager"] = manager
            startup["model_build_s"] = time.perf_counter() - t_build
            queue.put(("started", group, incarnation, time.time(), dict(
                startup=startup, replica_id=manager.replica_id())))
            for what in waits.get("start", ()):
                _drill_wait(what, addr, timeout, stop)

        def recorded(manager: Manager) -> List[Dict[str, Any]]:
            # the lifecycle events since the last commit
            if not manager.events:
                return []
            evs, held["cursor"], _ = manager.events.since(held["cursor"])
            return [{k: e[k] for k in LIFE_FIELDS if k in e} for e in evs
                    if e["kind"] in LIFE_KINDS]

        def on_commit(step, manager, model, loss) -> None:
            queue.put(("commit", group, incarnation, time.time(), dict(
                step=step, participants=manager.num_participants(),
                healed=manager.did_heal(), digest=run.param_digests[step],
                passes=run.passes, launches=dict(LAUNCHES),
                loss=float(loss), update_rise=held["rises"].pop(step, None),
                events=recorded(manager), **memory())))
            for what in waits.get(step, ()):
                _drill_wait(what, addr, timeout, stop)

        train_group(
            cfg, replica_group=group,
            num_groups=int(os.environ["NUM_REPLICA_GROUPS"]),
            store_addr=store.addr, on_start=on_start, on_commit=on_commit,
            stop=stop, digest_params=True, update_window=update_window,
            run=run, capture_telemetry=True, **train_kwargs)
        if "capture_error" in run.telemetry:
            raise RuntimeError("the flight recording's capture failed: "
                               + run.telemetry["capture_error"])
        keep = ("heal_wall_ms", "heal_wire_bytes", "heal_bytes_per_s",
                "quorum_p50_ms", "forward_backward_p50_ms", "ddp_wire_p50_ms",
                "commit_barrier_p50_ms")
        queue.put(("done", group, incarnation, time.time(), dict(
            passes=run.passes, launches=dict(LAUNCHES),
            healed_at=run.healed_at, participants=run.participants,
            losses=run.losses, fused_steps=run.fused_steps,
            captures=run.captures, step_seconds=run.step_seconds,
            metrics={k: run.metrics[k] for k in keep if k in run.metrics},
            classic_metrics={k: v for k, v in run.classic_metrics.items()
                             if k.endswith("_p50_ms")},
            telemetry=run.telemetry, **memory())))
    except BaseException:
        queue.put(("error", group, incarnation, time.time(),
                   traceback.format_exc()))
        raise
    finally:
        if store is not None:
            store.shutdown()


def run_process_drill(
    cfg: TransformerConfig,
    *,
    kill_step: int = PROC_KILL,
    solo_steps: int = PROC_SOLO,
    steps_after: int = PROC_AFTER,
    device: "Optional[str | torch.device]" = None,
    batch_size: int = 8,
    seed: int = 0,
    timeout: float = 60.0,
    base_manager_port: Optional[int] = None,
    base_store_port: Optional[int] = None,
    donate_update: Sequence[bool] = (False, False),
    log: Callable[[str], None] = logger.info,
) -> Dict[str, object]:
    """Two replica groups, each its own OS process (multiprocessing's
    spawn, never fork: the caller may hold a CUDA context), under a
    lighthouse in this process, through a real SIGKILL and a relaunch, on
    a fixed schedule (k = ``kill_step``, s = ``solo_steps``, a =
    ``steps_after``):

    - both groups commit steps 1..k together;
    - group 0 begins step k + 1 (its quorum request waits at the
      lighthouse) while group 1 holds in its commit hook of k; this
      process SIGKILLs group 0 there (its manager server, store,
      checkpoint server, transport sockets and CUDA context go down
      together, with no cleanup), reaps it and releases group 1;
    - group 1 latches the dead peer, forms its next quorum alone and
      commits k + 1..k + s with 1 participant, then holds in its commit
      hook (its manager heartbeating) until the relaunch has started;
    - group 0 relaunches as a fresh process from a poisoned init (another
      seed) with the same group, environment and ports, holds before its
      first quorum until group 1 has committed k + s, heals from group 1
      over HTTP at k + s + 1, and both commit a more steps.

    Each group runs :func:`train_group` in :func:`_proc_group_main`, in
    the environment ``launcher.hsdp_spec`` writes for it (manager port
    ``base_manager_port + i``, store port ``base_store_port + i``; free
    ports are found when these are None or taken), and posts its commits
    to a queue of its own; group ``g`` commits by ``OptimizerWrapper``'s
    arm ``donate_update[g]`` in both its lives, so the digests also hold
    the two arms equal. On the card this process reads the card's free
    memory (``torch.cuda.mem_get_info``) before the groups start, at the
    kill, once the victim is reaped and after the drill.

    Raises AssertionError unless: at every step that more than one (group,
    incarnation) commits, the parameter digests are equal (else the message
    gives each life's recorded quorums, commits, discards and heals up to
    that step, ``_life_history``); the relaunch's
    first commit comes after step k and reports a heal; group 1 commits no
    step after k with 2 participants before the heal; every loss is
    finite; every incarnation's flash launches are layers x its passes (0
    on the CPU); and on the card, once the victim is reaped, the free
    memory is within 1 GiB of its value before the groups started less
    group 1's share (its allocator's reserved bytes and one CUDA context,
    the two contexts reckoned equal from the reading at the kill), and
    within 1 GiB of that value after the drill; and the lifecycle holds, read
    from the flight recordings that the survivor and the relaunch fetched
    over HTTP before their managers went down (:func:`check_lifecycle`,
    the victim's replica id from its "started" message). Returns the
    commits by (group, incarnation), the started and done messages, the
    kill-to-heal timeline (``timeline``: with ``member_dead_s``, from the
    kill to the survivor's ``member_dead``, and the epochs of the death
    and of the rejoin), the lifecycle (``lifecycle``), the memory readings
    (``memory``), the heal
    step, the steps more than one life committed, the passes and each
    group's arm (``donate_update``)."""
    import multiprocessing as mp
    import queue as queue_mod

    from torchft_tpu_torch.launcher import hsdp_spec

    device = resolve_device(device)
    cuda = device.type == "cuda"
    if cuda:
        check_head_dim(f"run_process_drill: config with d_model "
                       f"{cfg.d_model} and {cfg.n_heads} heads", cfg.head_dim)
    total = kill_step + solo_steps + 1 + steps_after
    victim, survivor, relaunch = (0, 0), (1, 0), (0, 1)
    ctx = mp.get_context("spawn")
    lighthouse = Lighthouse(min_replicas=1, heartbeat_timeout_ms=1000,
                            join_timeout_ms=200)
    addr = lighthouse.address()
    mport = _free_port_base(2, base_manager_port)
    sport = _free_port_base(2, base_store_port, avoid=(mport, mport + 1))
    env = {s.replica_group_id: s.env for s in hsdp_spec(
        script=os.path.abspath(__file__), num_replica_groups=2,
        lighthouse_addr=addr, base_manager_port=mport,
        base_store_port=sport)}
    stop, killed, solo_done, relaunched = (ctx.Event() for _ in range(4))
    waits = {
        victim: {"start": [("lighthouse", "healthy", 2)]},
        survivor: {"start": [("lighthouse", "healthy", 2)],
                   kill_step: [("event", killed,
                                "the drill never released the survivor")],
                   kill_step + solo_steps: [
                       ("event", relaunched, "the relaunch never started"),
                       ("lighthouse", "participants", 1)]},
        relaunch: {"start": [("event", solo_done,
                              "the survivor never committed its solo "
                              "steps")]},
    }
    queues: Dict[Tuple[int, int], Any] = {}
    procs: Dict[Tuple[int, int], Any] = {}
    launched: Dict[Tuple[int, int], float] = {}
    commits: Dict[Tuple[int, int], Dict[int, Dict[str, Any]]] = {}
    started: Dict[Tuple[int, int], Tuple[float, Dict[str, float]]] = {}
    done: Dict[Tuple[int, int], Tuple[float, Dict[str, Any]]] = {}
    errors: List[str] = []
    memory: Dict[str, Any] = {}
    timeline: Dict[str, Any] = {}

    def free_bytes() -> int:
        return torch.cuda.mem_get_info(device)[0]

    def launch(key: Tuple[int, int]) -> None:
        group, inc = key
        queues[key] = ctx.Queue()
        kwargs = dict(device=str(device), batch_size=batch_size,
                      init_seed=seed + 1000 * inc, data_seed=seed,
                      timeout=timeout, total_steps=total,
                      donate_update=bool(donate_update[group]))
        p = ctx.Process(
            target=_proc_group_main, name=f"group{group}_life{inc}",
            args=(cfg, env[group], inc, kwargs, waits[key], queues[key],
                  stop),
            daemon=True)
        launched[key] = time.time()
        p.start()
        procs[key] = p

    def drain() -> None:
        for q in queues.values():
            while True:
                try:
                    kind, group, inc, wall, body = q.get_nowait()
                except (queue_mod.Empty, OSError, EOFError):
                    break
                key = (group, inc)
                if kind == "started":
                    started[key] = (wall, body)
                elif kind == "commit":
                    commits.setdefault(key, {})[body["step"]] = dict(
                        body, wall=wall)
                    log(f"group {group} life {inc} committed step "
                        f"{body['step']} participants {body['participants']}"
                        + (" (healed)" if body["healed"] else ""))
                elif kind == "done":
                    done[key] = (wall, body)
                else:
                    errors.append(f"group {group} life {inc}:\n{body}")

    def committed(key: Tuple[int, int], step: int) -> bool:
        return step in commits.get(key, {})

    def reclaim(want: int) -> Tuple[int, float]:
        """The free memory once it reaches ``want``, polled for 30 s at
        most, and the seconds it took."""
        t0 = time.perf_counter()
        free = free_bytes()
        while free < want and time.perf_counter() - t0 < 30.0:
            time.sleep(0.05)
            free = free_bytes()
        return free, time.perf_counter() - t0

    t_start = time.perf_counter()
    deadline = time.monotonic() + 10 * timeout
    try:
        if cuda:
            torch.cuda.empty_cache()
            memory["before"] = free_bytes()
        launch(victim)
        launch(survivor)
        while not (survivor in done and relaunch in done):
            drain()
            if errors:
                raise RuntimeError("a replica group failed:\n"
                                   + "\n".join(errors))
            for key, p in procs.items():
                if p.exitcode is not None and p.exitcode != 0 and not (
                        key == victim and "kill" in timeline):
                    drain()
                    raise RuntimeError(f"group {key[0]} life {key[1]} exited "
                                       f"with {p.exitcode}: {errors}")
            if (not killed.is_set() and committed(victim, kill_step)
                    and committed(survivor, kill_step)):
                # the victim's step k + 1 has begun: its quorum request
                # waits for the survivor, which holds in its commit hook
                _wait_lighthouse(addr, "participants", 1, timeout, stop)
                if cuda:
                    memory["at_kill"] = free_bytes()
                timeline["kill"] = time.time()
                procs[victim].kill()
                procs[victim].join(timeout)
                timeline["reaped"] = time.time()
                if cuda:
                    # the survivor's share: its allocator's pool and one
                    # CUDA context, the two contexts reckoned equal
                    pools = (commits[victim][kill_step]["reserved"]
                             + commits[survivor][kill_step]["reserved"])
                    held = memory["before"] - memory["at_kill"]
                    context = max(0, (held - pools) // 2)
                    share = commits[survivor][kill_step]["reserved"] + context
                    memory.update(context=context, survivor_share=share,
                                  want_after_kill=memory["before"] - share)
                    memory["after_kill"], memory["reclaim_s"] = reclaim(
                        memory["want_after_kill"] - PROC_MEMORY_SLACK)
                killed.set()
                log(f"SIGKILLed group 0 in its step {kill_step + 1}; "
                    "relaunching it")
                launch(relaunch)
            if committed(survivor, kill_step + solo_steps):
                solo_done.set()
            if relaunch in started:
                relaunched.set()
            if time.monotonic() > deadline:
                raise TimeoutError(
                    "the process drill stalled: commits "
                    f"{ {k: sorted(v) for k, v in commits.items()} }")
            time.sleep(0.01)
        for key, p in procs.items():
            p.join(timeout)
            want = -9 if key == victim else 0  # -SIGKILL
            _require(p.exitcode == want, f"group {key[0]} life {key[1]} "
                     f"exited with {p.exitcode}, not {want}")
        drain()
        if cuda:
            memory["after"], memory["final_reclaim_s"] = reclaim(
                memory["before"] - PROC_MEMORY_SLACK)
    finally:
        stop.set()
        for ev in (killed, solo_done, relaunched):
            ev.set()
        for p in procs.values():
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        for q in queues.values():
            q.cancel_join_thread()
            q.close()
        lighthouse.shutdown()

    overlap = check_digests(commits)
    first = min(commits.get(relaunch) or [0])
    _require(first > kill_step and commits[relaunch][first]["healed"],
             f"the relaunch's first commit is at step {first}, healed "
             f"{commits.get(relaunch, {}).get(first, {}).get('healed')}")
    _require(overlap == list(range(1, kill_step + 1))
             + list(range(first, total + 1)),
             f"steps committed by more than one life: {overlap}")
    window = {s: commits[survivor][s]["participants"]
              for s in range(kill_step + 1, first)}
    _require(set(window.values()) <= {1},
             f"the survivor's participants in the dead window: {window}")
    losses = [b["loss"] for c in commits.values() for b in c.values()]
    losses += [v for _, b in done.values() for v in b["losses"].values()]
    _require(all(math.isfinite(v) for v in losses), "non-finite loss")
    # every incarnation's flash launches: layers x its passes so far
    last = {victim: commits[victim][max(commits[victim])]}
    last.update({key: body for key, (_, body) in done.items()})
    for key, body in last.items():
        want = cfg.n_layers * body["passes"] if cuda else 0
        _require(set(body["launches"].values()) <= {want},
                 f"group {key[0]} life {key[1]}: flash launches "
                 f"{body['launches']}, want {want} each ({body['passes']} "
                 "passes)")
    if cuda:
        _require(memory["after_kill"] >= memory["want_after_kill"]
                 - PROC_MEMORY_SLACK,
                 f"the card's free memory after the kill, "
                 f"{memory['after_kill']}, is not within 1 GiB of "
                 f"{memory['want_after_kill']}")
        _require(memory["after"] >= memory["before"] - PROC_MEMORY_SLACK,
                 f"the card's free memory after the drill, "
                 f"{memory['after']}, is not within 1 GiB of "
                 f"{memory['before']}")
    lifecycle = check_lifecycle(
        done[survivor][1]["telemetry"], done[relaunch][1]["telemetry"],
        dead_id=started[victim][1]["replica_id"],
        relaunch_id=started[relaunch][1]["replica_id"],
        kill_step=kill_step, total=total)
    t_kill = timeline["kill"]
    latch = [e["t_wall"] for e in
             done[survivor][1]["telemetry"]["events"]["events"]
             if e["kind"] in ("error_latched", "step_discard")
             and e["t_wall"] >= t_kill]
    r_wall, r_startup = started[relaunch][0], started[relaunch][1]["startup"]
    timeline.update(
        reap_s=timeline["reaped"] - t_kill,
        survivor_latch_s=(min(latch) - t_kill) if latch else None,
        solo_commit_s=[commits[survivor][s]["wall"] - t_kill
                       for s in range(kill_step + 1, first)],
        relaunch_after_kill_s=launched[relaunch] - t_kill,
        relaunch_spawn_s=r_startup["entry"] - launched[relaunch],
        relaunch_started_s=r_wall - launched[relaunch],
        relaunch_startup=r_startup,
        heal=done[relaunch][1]["metrics"],
        first_joint_commit_s=commits[relaunch][first]["wall"] - t_kill,
        member_dead_s=lifecycle["member_dead_wall"] - t_kill,
        heal_start_s=lifecycle["heal_start_wall"] - t_kill,
        heal_done_s=lifecycle["heal_done_wall"] - t_kill,
        first_resumed_s=lifecycle["first_resumed_wall"] - t_kill,
        death_epoch=lifecycle["death_epoch"],
        rejoin_epoch=lifecycle["rejoin_epoch"])
    return {"commits": commits, "started": started, "done": done,
            "timeline": timeline, "lifecycle": lifecycle, "memory": memory,
            "heal_step": first,
            "overlap": overlap,
            "passes": {key: body["passes"] for key, body in last.items()},
            "launches": {key: body["launches"] for key, body in last.items()},
            "peaks": {key: body["peak"] for key, body in last.items()},
            "donate_update": tuple(bool(d) for d in donate_update),
            "total": total, "seconds": time.perf_counter() - t_start}


# run_churn_drill's defaults: the reference's churn test
# (tests/test_integration.py:415), five groups under min_replicas 3 for 10
# steps, killed at (group, step) (1, 2), (3, 4) and (1, 6); its floors are 6
# of 10 steps committed by a group never killed and 3 by a killed one
CHURN_GROUPS, CHURN_MIN_REPLICAS, CHURN_STEPS = 5, 3, 10
CHURN_KILLS = ((1, 2), (3, 4), (1, 6))
CHURN_FLOORS = (6, 3)
# commits every group makes after a latch, as the reference's latch test
CHURN_LATCH_COMMITS = 3


class _Meetings:
    """The churn drill's rendezvous in the commit hooks: the groups that
    commit a step wait there for each other (``members``: the step's wire
    world, which every member of the quorum reads alike), and the last to
    arrive runs ``fn(step)`` while every group is between steps."""

    def __init__(self, timeout: float, stop: threading.Event) -> None:
        self._cond = threading.Condition()
        self._arrived: Dict[int, int] = {}
        self._done: set = set()
        self._timeout, self._stop = timeout, stop

    def meet(self, step: int, members: int,
             fn: Callable[[int], None]) -> None:
        deadline = time.monotonic() + self._timeout
        with self._cond:
            self._arrived[step] = self._arrived.get(step, 0) + 1
            if self._arrived[step] == members:
                try:
                    fn(step)
                finally:
                    self._done.add(step)
                    self._cond.notify_all()
                return
            while step not in self._done:
                if self._stop.is_set():
                    raise RuntimeError("another replica group failed")
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"{self._arrived[step]} of {members} groups met in "
                        f"their commit hooks of step {step}")
                self._cond.wait(min(0.05, left))


def run_churn_drill(
    cfg: TransformerConfig,
    *,
    groups: int = CHURN_GROUPS,
    kills: Sequence[Tuple[int, int]] = CHURN_KILLS,
    min_replicas: int = CHURN_MIN_REPLICAS,
    total_steps: int = CHURN_STEPS,
    use_async_quorum: bool = True,
    latch: Optional[Tuple[int, int]] = None,
    comm_backend: str = "host",
    comm_options: Optional[Dict[str, Any]] = None,
    device: "Optional[str | torch.device]" = None,
    devices: "Optional[Sequence[str | torch.device]]" = None,
    batch_size: int = 8,
    seed: int = 0,
    timeout: float = 60.0,
    log: Callable[[str], None] = logger.info,
) -> Dict[str, Any]:
    """Repeated kills while the job commits (the twin of the reference's
    churn test, tests/test_integration.py:415, with the GPT): ``groups``
    replica groups, one thread each, under one lighthouse in this process
    with ``min_replicas``, until every group has committed
    ``total_steps`` steps.

    Each ``(group, step)`` of ``kills`` fires once, in that group's life
    that reaches the step: :func:`train_group` raises
    :class:`InjectedFailure` at the top of its next step (its manager,
    store and checkpoint server shut down), and the group restarts from a
    poisoned init (``seed + 1000 * life``) and heals from a live peer, as
    the reference's ``Runner.run_replica`` does, once a survivor has
    committed a step without it (a gate on commits, not on time). The
    survivors hold in that commit hook until the new life's quorum
    request waits at the lighthouse, so it takes the next quorum with them
    and heals there; a kill at step s therefore needs s + 2 <=
    ``total_steps``. The lighthouse's join window is ``timeout``: a quorum
    waits for every healthy group, and a dead one drops out after its 1 s
    heartbeat timeout. ``latch=(group, step)``: that group latches its own
    wire once, at the first step that starts with ``step`` commits, after
    its quorum (``train_group(latch_at=)``); its peers' ops of that step
    wait out the wire's timeout (``comm_options["timeout"]``, below
    ``timeout``), the latched member bumps its ``comm_epoch`` in the next
    quorum request and every wire reconfigures.
    ``use_async_quorum``, ``comm_backend`` and ``comm_options`` go to every
    group's Manager; ``devices``: group g on ``devices[g % len]``
    (:func:`group_devices`).

    The groups that commit a step meet in their commit hooks, and the last
    to arrive collects the garbage and reads the device memory
    (``torch.cuda.memory_allocated`` summed over the cards, on the card)
    with every group between steps; it also records every life that is
    dead and restarted whose parameters are still alive (weak
    references). Raises AssertionError unless :func:`check_churn` holds.
    Returns every life's :class:`GroupRun` (``lives``), the commits by
    (group, life) (digest, loss, wall, participants, wire world, heal,
    ``comm_epoch``, the recorded events), each kill's timeline
    (``kills``: from the kill, the survivors' first commit without the dead
    group, the restart's start, its heal's start and end and its first
    commit, with the heal's bytes and seconds and the device memory
    before the kill and after the heal), the latch (``latch``), the
    committed tokens per second before the first kill and over the whole
    run (``tokens_per_s``: the gated drill's pace, the meetings in the
    commit hooks and the survivors' holds for each restart included, not
    a rate under ungated traffic), the steps more than one life committed
    (``overlap``), the passes and the seconds."""
    kills = [tuple(int(v) for v in k) for k in kills]
    for g, s in kills:
        if not (0 <= g < groups and 1 <= s and s + 2 <= total_steps):
            raise ValueError(f"kill {(g, s)}: a group of {groups} and a step "
                             f"with room to rejoin before {total_steps}")
    if len(set(kills)) != len(kills):
        raise ValueError(f"a kill is scheduled twice: {kills}")
    if latch is not None and not (0 <= latch[0] < groups
                                  and 1 <= latch[1] < total_steps):
        raise ValueError(f"latch {latch} outside {groups} groups and "
                         f"{total_steps} steps")
    if latch is not None and (comm_options or {}).get(
            "timeout", timeout) >= timeout:
        # the peers' ops wait out the wire's timeout while the latched
        # group's next quorum waits for them
        raise ValueError("a latch needs a wire timeout (comm_options"
                         "['timeout']) below the quorum's (timeout)")
    devs, comm_options = group_devices(groups, device, devices, comm_backend,
                                       comm_options)
    cards = sorted({d for d in (resolve_device(v) for v in devs)
                    if d.type == "cuda"}, key=str)
    param_bytes = sum(p.numel() * p.element_size()
                      for p in GPT(cfg, device="meta").parameters())
    lighthouse = Lighthouse(min_replicas=min_replicas,
                            heartbeat_timeout_ms=1000,
                            join_timeout_ms=int(timeout * 1000))
    addr = lighthouse.address()
    stop = threading.Event()
    lock = threading.Lock()
    meetings = _Meetings(timeout, stop)
    lives: Dict[int, List[GroupRun]] = {g: [] for g in range(groups)}
    commits: Dict[Tuple[int, int], Dict[int, Dict[str, Any]]] = {}
    started: Dict[Tuple[int, int], float] = {}
    deaths: List[Dict[str, Any]] = []
    # a dead group's gates: its death step, a survivor's commit past it
    # (the restart waits for it) and its next life's start (the survivors
    # wait for it)
    gates: Dict[int, Tuple[int, threading.Event, threading.Event]] = {}
    refs: Dict[Tuple[int, int], list] = {}
    memory: Dict[int, int] = {}
    leaks: Dict[int, List[Tuple[int, int]]] = {}
    latched: List[Tuple[int, int]] = []

    def sample(step: int) -> None:
        # every group is between steps: what is allocated now is the
        # live lives' state, and a dead life's only if it leaked
        gc.collect()
        with lock:
            restarted = [(d["group"], d["life"]) for d in deaths
                         if (d["group"], d["life"] + 1) in started]
        held = [key for key in restarted
                if any(r() is not None for r in refs.get(key, ()))]
        if held:
            leaks[step] = held
        if cards:
            for d in cards:
                torch.cuda.synchronize(d)
            memory[step] = sum(torch.cuda.memory_allocated(d) for d in cards)

    def hooks(g: int, life: int, run: GroupRun):
        cursor = [0]

        def on_start(manager: Manager) -> None:
            with lock:
                started[(g, life)] = time.time()
                if life:
                    gates[g][2].set()
            if not life:
                _wait_lighthouse(addr, "healthy", groups, timeout, stop)

        def on_commit(step, manager, model, loss) -> None:
            wall = time.time()
            evs: List[Dict[str, Any]] = []
            if manager.events:
                got, cursor[0], _ = manager.events.since(cursor[0])
                evs = [{k: e[k] for k in LIFE_FIELDS if k in e} for e in got
                       if e["kind"] in LIFE_KINDS]
            body = dict(digest=run.param_digests[step], events=evs,
                        wall=wall, loss=float(loss),
                        participants=manager.num_participants(),
                        wire=manager.transport_world_size(),
                        healed=manager.did_heal(),
                        comm_epoch=manager._comm_epoch)
            with lock:
                refs.setdefault((g, life), [weakref.ref(p)
                                            for p in model.parameters()])
                first = (g, life) not in commits
                commits.setdefault((g, life), {})[step] = body
                if first and life:
                    gates.pop(g, None)
            log(f"group {g} life {life} committed step {step} participants "
                f"{body['participants']} wire {body['wire']}"
                + (" (healed)" if body["healed"] else ""))
            meetings.meet(step, body["wire"], sample)
            with lock:
                waits = [(h, past, back) for h, (d, past, back)
                         in gates.items() if h != g and step > d]
            for h, past, back in waits:
                # the survivors committed without group h: let it restart,
                # and hold until its next life asks for a quorum (every
                # survivor holds here after the step's meeting, so the
                # request waiting at the lighthouse is the new life's)
                past.set()
                _wait_for(back.is_set, f"group {h} never restarted",
                          timeout, stop)
                _wait_lighthouse(addr, "participants", 1, timeout, stop)

        return on_start, on_commit

    def group_main(g: int):
        def train(life: int, fail: Optional[int]) -> GroupRun:
            run = GroupRun()
            on_start, on_commit = hooks(g, life, run)
            latch_at = (latch[1] if latch is not None and latch[0] == g
                        and not latched else None)
            try:
                return train_group(
                    cfg, replica_group=g, num_groups=groups,
                    total_steps=total_steps, lighthouse_addr=addr,
                    device=devs[g], batch_size=batch_size,
                    init_seed=seed + 1000 * life, data_seed=seed,
                    fail_at_step=fail, on_start=on_start,
                    on_commit=on_commit, stop=stop, timeout=timeout,
                    comm_backend=comm_backend, comm_options=comm_options,
                    digest_params=True, run=run,
                    use_async_quorum=use_async_quorum, latch_at=latch_at)
            finally:
                if run.latched_at is not None:
                    latched.append((g, run.latched_at))

        def restart(life: int, step: int) -> None:
            t_kill = time.time()
            with lock:
                death = max(commits.get((g, life), {0: None}))
                deaths.append(dict(group=g, life=life, step=step,
                                   death_step=death, t_kill=t_kill))
                gates[g] = (death, threading.Event(), threading.Event())
            log(f"group {g} life {life} killed after step {death}; "
                "restarting from a poisoned init once a survivor commits")
            gc.collect()
            _wait_for(gates[g][1].is_set, f"no survivor committed past step "
                      f"{death} without group {g}", timeout, stop)

        return lambda: _group_lives(train, [s for k, s in kills if k == g],
                                    restart, lives[g])

    t_start = time.perf_counter()
    _run_groups([group_main(g) for g in range(groups)], lighthouse, stop)
    seconds = time.perf_counter() - t_start

    timeline = []
    for d in deaths:
        # every death has a next life, which committed: the drill ended
        g, life, step, t_kill = (d["group"], d["life"], d["death_step"],
                                 d["t_kill"])
        survivors = [c[step + 1]["wall"] for key, c in commits.items()
                     if key[0] != g and step + 1 in c]
        new, run = commits[(g, life + 1)], lives[g][life + 1]
        first = min(new)
        heal_walls = {e["kind"]: e["t_wall"] for e in reversed(run.events)
                      if e["kind"] in ("heal_start", "heal_done")}
        metrics = run.metrics
        timeline.append(dict(
            d, survivors_first_commit_s=min(survivors) - t_kill,
            restart_started_s=started[(g, life + 1)] - t_kill,
            heal_start_s=(heal_walls["heal_start"] - t_kill
                          if "heal_start" in heal_walls else None),
            heal_done_s=(heal_walls["heal_done"] - t_kill
                         if "heal_done" in heal_walls else None),
            heal_step=first, healed=new[first]["healed"],
            first_commit_s=new[first]["wall"] - t_kill,
            heal_ms=metrics.get("heal_wall_ms"),
            heal_bytes=metrics.get("heal_wire_bytes"),
            heal_bytes_per_s=metrics.get("heal_bytes_per_s"),
            memory_before=memory.get(step),
            memory_after=memory.get(first)))

    tokens = batch_size * cfg.max_seq_len
    walls = sorted(b["wall"] for c in commits.values() for b in c.values())
    step1 = [c[1]["wall"] for c in commits.values() if 1 in c]
    t0 = max(step1) if step1 else walls[0]
    first_kill = min((d["t_kill"] for d in deaths), default=walls[-1])

    def rate(end: float) -> Optional[float]:
        n = sum(1 for w in walls if t0 < w <= end)
        return n * tokens / (end - t0) if n and end > t0 else None

    latch_info = None
    if latch is not None:
        lg, at = latched[0] if latched else (latch[0], None)
        latch_info = dict(
            group=lg, step=at,
            comm_epoch=max((b["comm_epoch"] for (h, _), c in commits.items()
                            if h == lg for b in c.values()), default=0),
            post_commits={g: sum(1 for (h, _), c in commits.items() if h == g
                                 for s in c if at is not None and s > at)
                          for g in range(groups)},
            fired=len(latched))
    result = dict(
        lives=lives, commits=commits, kills=timeline, latch=latch_info,
        schedule=kills, memory=memory, leaks=leaks, param_bytes=param_bytes,
        cuda=bool(cards), groups=groups, total=total_steps,
        tokens_per_s=dict(before_first_kill=rate(first_kill),
                          whole_run=rate(walls[-1])),
        passes=sum(r.passes for rs in lives.values() for r in rs),
        seconds=seconds)
    result["overlap"] = check_churn(result)
    return result


def check_churn(result: Dict[str, Any]) -> List[int]:
    """The churn drill's oracle (:func:`run_churn_drill`'s result): each
    scheduled kill fired exactly once and no other; at every step that
    more than one life committed, their parameter digests are equal
    (:func:`check_digests`, whose message names each life's quorums,
    commits and heals); every loss is finite; a group never killed
    committed at least 6 of every 10 steps and a killed one at least 3
    (``CHURN_FLOORS``); each restarted life healed in its first commit;
    every dead life's parameters were freed once its group restarted, and
    on the card the device memory after each heal is at most its value
    at the kill's last commit plus one model's parameters; with a latch,
    it fired once, every group committed ``CHURN_LATCH_COMMITS`` steps
    after it and the latched group's ``comm_epoch`` rose to at least 1.
    Returns the steps more than one life committed; raises
    AssertionError on the first miss."""
    from collections import Counter

    fired = Counter((d["group"], d["step"]) for d in result["kills"])
    want = Counter(tuple(k) for k in result["schedule"])
    _require(fired == want, f"kills fired {dict(fired)}, scheduled "
             f"{dict(want)}: each once")
    overlap = check_digests(result["commits"])
    _require(bool(overlap), "no step was committed by two lives")
    losses = [b["loss"] for c in result["commits"].values()
              for b in c.values()]
    losses += [v for rs in result["lives"].values() for r in rs
               for v in r.losses.values()]
    _require(all(math.isfinite(v) for v in losses), "non-finite loss")
    total, killed = result["total"], {g for g, _ in result["schedule"]}
    for g in range(result["groups"]):
        steps = {s for (h, _), c in result["commits"].items() if h == g
                 for s in c}
        floor = (CHURN_FLOORS[1] if g in killed
                 else CHURN_FLOORS[0] * total // 10)
        _require(len(steps) >= floor and max(steps, default=0) >= total,
                 f"group {g} committed {len(steps)} steps "
                 f"(to {max(steps, default=0)}), want at least {floor} "
                 f"and step {total}")
    for k in result["kills"]:
        _require(k["healed"], f"group {k['group']} life {k['life'] + 1} "
                 f"did not heal in its first commit (step {k['heal_step']})")
    _require(not result["leaks"], "a dead life's parameters outlived it: "
             + "; ".join(f"at step {s}: (group, life) {v}"
                         for s, v in sorted(result["leaks"].items())))
    if result["cuda"]:
        for k in result["kills"]:
            before, after = k["memory_before"], k["memory_after"]
            _require(before is not None and after is not None
                     and after <= before + result["param_bytes"],
                     f"group {k['group']}'s heal at step {k['heal_step']}: "
                     f"{after} bytes allocated, {before} at the kill's last "
                     f"commit (step {k['death_step']}) plus "
                     f"{result['param_bytes']} of parameters")
    latch = result["latch"]
    if latch is not None:
        _require(latch["fired"] == 1, f"the latch fired {latch['fired']} "
                 "times, want once")
        _require(all(n >= CHURN_LATCH_COMMITS
                     for n in latch["post_commits"].values()),
                 f"commits after the latch {latch['post_commits']}, want "
                 f"{CHURN_LATCH_COMMITS} on every group")
        _require(latch["comm_epoch"] >= 1, f"group {latch['group']}'s "
                 f"comm_epoch is {latch['comm_epoch']}, want >= 1")
    return overlap


# run_multijob_drill's schedule: a1 fails after step 3, heals at 5, the
# jobs' last joint step is 7; b0 and hi0 then commit 2 more
_MJ_KILL, _MJ_AFTER, _MJ_MORE = 3, 2, 2
# run_multijob_drill's jobs: name -> (priority, group budget or None)
MULTIJOB_JOBS = {"a": (5, None), "b": (0, 1), "hi": (10, None)}
# the fleet before hi0 arrives: a0, a1, the observer, b0, b1 (the native
# lighthouse counts every heartbeating group, observers included)
MULTIJOB_CAPACITY = 5


def _job_status(addr: str, job: str, timeout: float) -> Dict[str, Any]:
    with urllib.request.urlopen(f"{addr}/status.json", timeout=timeout) as r:
        return json.load(r)["jobs"].get(job, {})


def _get_json(url: str, timeout: float) -> Dict[str, Any]:
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.load(r)


def _telemetry(manager: Manager, what: str, timeout: float) -> Dict[str, Any]:
    """GET /telemetry/{what} from the manager's checkpoint server."""
    return _get_json(
        f"{manager._checkpoint_transport.metadata()}/telemetry/{what}",
        timeout)


def capture_flight_recording(store_addr: str, rank: int = 0,
                             job_id: str = "default",
                             timeout: float = 10.0) -> Dict[str, Any]:
    """A live manager's flight recording, read as scripts/fleet_top.py
    reads it: the address of rank ``rank``'s checkpoint server from the
    group store (``checkpoint_addr_{rank}``, under the job's prefix), then
    ``GET /telemetry/events?since=0`` and ``/telemetry/metrics``, and a
    check that ``?since=<next>`` returns an empty tail. Returns ``{"events":
    ..., "metrics": ...}`` (the two response bodies), or ``{"capture_error":
    ...}`` when any of it fails; every read is bounded by ``timeout``."""
    try:
        prefix = "" if job_id == "default" else f"job:{job_id}/"
        addr = StoreClient(store_addr, connect_timeout=timeout).get(
            f"{prefix}checkpoint_addr_{rank}")
        if addr is None:
            raise KeyError(f"no {prefix}checkpoint_addr_{rank} in the store")
        url = addr.decode()
        events = _get_json(f"{url}/telemetry/events?since=0", timeout)
        metrics = _get_json(f"{url}/telemetry/metrics", timeout)
        tail = _get_json(f"{url}/telemetry/events?since={events['next']}",
                         timeout)
        if tail["events"]:
            raise AssertionError(
                f"the cursor {events['next']} returned "
                f"{len(tail['events'])} stale events")
        return {"events": events, "metrics": metrics}
    except Exception as e:  # noqa: BLE001 — the caller fails on it
        return {"capture_error": repr(e)}


def run_multijob_drill(
    cfg: TransformerConfig,
    *,
    hi_cfg: Optional[TransformerConfig] = None,
    device: "Optional[str | torch.device]" = None,
    batch_size: int = 8,
    seed: int = 0,
    timeout: float = 60.0,
    log: Callable[[str], None] = logger.info,
) -> Dict[str, object]:
    """Two jobs on one lighthouse (2 s epoch leases, ``fleet_capacity``
    ``MULTIJOB_CAPACITY``), and a third that preempts one of them, over the
    TCP wire at codec none (k = 3, the kill; h = 5, the heal; t = 7, the
    jobs' last joint step; m = 2):

    - job "a" (priority 5, no group budget): groups a0 and a1 train DDP,
      and a_obs is an observer (``data_plane=False``) running the forward
      probe. All commit 1..k; a1 fails; a0 commits k + 1 alone once the
      lighthouse has seen a1 die; a1 restarts from a poisoned init, heals
      from a0 at h, and both commit h..t. The observer commits every step's
      barrier and trains nothing.
    - job "b" (priority 0, group budget 1): b0 and b1 train DDP on the
      lease's fast path from step 3 on, each step waiting for a0 to commit
      the same step, so that steps k..h + 1 overlap a1's death and heal.
    - once every group of "a" and "b" committed t, hi0 joins job "hi"
      (priority 10) with ``hi_cfg`` (``cfg`` by default): its first quorum
      request puts the fleet one over capacity, and the lighthouse evicts
      b1 (job "b" is over its budget; b1 has the greater replica id). b1
      learns it from its next quorum answer and stops; b0 commits t + 1..
      t + m on a wire of one; hi0 commits 1..m.

    Raises AssertionError unless: a0 and a1 are bitwise equal at every step
    both commit and a1 healed at h; a0 counted 2 participants and a wire
    of 2 at every joint step, and 1 at k + 1 and h (the healer contributes
    zeros), never the observer; the observer committed 1..t, was never
    participating, healed or on a wire of more than itself, and its
    parameters never changed; b0 and b1 are bitwise equal at every step
    both commit, made 0 control RPCs at steps k..h + 1, and job "b"'s
    ``membership_epoch``, ``quorum_compute_count`` and ``lease_breaks`` in
    ``/status.json`` did not move from before step k to after step h + 1;
    b1 was evicted at step t within 5 s of asking, with a ``job_preempted``
    event on its ``/telemetry/events`` and its parameters bitwise as it
    committed them; ``jobs.b`` shows one preemption and b1's id evicted;
    b0 and hi0 committed their m steps; every loss is finite. Returns the
    runs (``runs[name]``: its lives), the forward/backward passes of the
    ``cfg`` groups (``passes``) and of hi0 (``hi_passes``), the observer's
    probe passes, job b's counters before and after the window, each b
    group's phase metrics over the window (``b_window``), the eviction
    (``eviction``: seconds and the ``jobs.b`` status), the steps at which
    a0 and b0 were bitwise equal (``cross_job_equal``: the jobs run the
    same seeds and data, so these are 1..k unless the observer changed
    a0's average or the device's arithmetic is not deterministic), and the
    drill's wall seconds."""
    kill_step, steps_after, steps_more = _MJ_KILL, _MJ_AFTER, _MJ_MORE
    hi_cfg = hi_cfg or cfg
    heal = kill_step + 2
    total = heal + steps_after
    t_start = time.perf_counter()
    lighthouse = Lighthouse(
        min_replicas=1, heartbeat_timeout_ms=1000,
        join_timeout_ms=int(timeout * 1000), lease_ms=_LEASE_MS,
        fleet_capacity=MULTIJOB_CAPACITY)
    addr = lighthouse.address()
    client = LighthouseClient(addr)
    for job, (priority, budget) in MULTIJOB_JOBS.items():
        client.register_job(job, priority=priority, group_budget=budget)
    stop = threading.Event()
    ahead, b_go, release = (threading.Event() for _ in range(3))
    b_barrier = threading.Barrier(2)
    errors: List[BaseException] = []
    runs: Dict[str, List[GroupRun]] = {n: [] for n in
                                      ("a0", "a1", "a_obs", "b0", "b1", "hi0")}
    ids: Dict[str, str] = {}
    a0_steps: set = set()
    lock = threading.Lock()
    pending: Dict[Tuple[str, int], Dict[str, List[torch.Tensor]]] = {}
    compared: Dict[str, Dict[int, int]] = {"a": {}, "b": {}}
    cross: Dict[int, Dict[str, List[torch.Tensor]]] = {}
    cross_equal: List[int] = []
    b_status: Dict[str, Dict[str, Any]] = {}
    b_window: Dict[str, Dict[str, object]] = {}
    b_last: Dict[str, List[torch.Tensor]] = {}
    obs_first: List[torch.Tensor] = []
    obs_steps: List[int] = []
    eviction: Dict[str, Any] = {}

    def snap(model) -> List[torch.Tensor]:
        return [p.detach().clone() for p in model.parameters()]

    def same(a: List[torch.Tensor], b: List[torch.Tensor]) -> bool:
        return all(torch.equal(x, y) for x, y in zip(a, b))

    def expected(job: str, step: int) -> int:
        if job == "a":
            return 1 if step == kill_step + 1 else 2
        return 2 if step <= total else 1

    def deposit(job: str, name: str, step: int, model) -> None:
        params = snap(model)
        with lock:
            held = pending.setdefault((job, step), {})
            held[name] = params
            if len(held) < expected(job, step):
                return
            del pending[(job, step)]
        first = min(held)
        for n in sorted(held):
            _require(same(held[first], held[n]),
                     f"{n} diverged from {first} at step {step}")
        compared[job][step] = len(held)

    def cross_deposit(name: str, step: int, model) -> None:
        # a0 and b0 run the same seeds and data up to the kill
        with lock:
            held = cross.setdefault(step, {})
            held[name] = snap(model)
            if len(held) < 2:
                return
            del cross[step]
        if same(held["a0"], held["b0"]):
            cross_equal.append(step)

    def started(name: str, job: str, healthy: int = 0):
        def _start(manager):
            ids[name] = manager.replica_id()
            if healthy:
                _wait_lighthouse(addr, "healthy", healthy, timeout, stop,
                                 job=job)
        return _start

    def a_hook(name: str):
        def _hook(step, manager, model, loss):
            log(f"{name} committed step {step} participants "
                f"{manager.num_participants()} wire "
                f"{manager.transport_world_size()}"
                + (" (healed)" if manager.did_heal() else ""))
            deposit("a", name, step, model)
            if name == "a0":
                if step <= kill_step:
                    cross_deposit("a0", step, model)
                with lock:
                    a0_steps.add(step)
                if step == kill_step:
                    # a1 dies at the top of its next step: take k + 1 once
                    # the lighthouse has seen it go
                    _wait_lighthouse(addr, "healthy", 2, timeout, stop,
                                     at_most=True, job="a")
                elif step == kill_step + 1:
                    # let a1 restart; take the heal quorum with it and the
                    # observer, both asking
                    ahead.set()
                    _wait_lighthouse(addr, "participants", 2, timeout, stop,
                                     job="a")
            if step == total:
                _wait_for(release.is_set, "the drill never released job a",
                          timeout, stop)
        return _hook

    def obs_hook(step, manager, model, loss):
        _require(not manager.is_participating()
                 and manager.transport_world_size() == 1
                 and not manager.did_heal(),
                 f"observer at step {step}: participating "
                 f"{manager.is_participating()}, wire "
                 f"{manager.transport_world_size()}, healed "
                 f"{manager.did_heal()}")
        if not obs_first:
            obs_first.extend(snap(model))
        _require(same(obs_first, list(model.parameters())),
                 f"the observer's parameters changed at step {step}")
        obs_steps.append(step)
        if step == total:
            _wait_for(release.is_set,
                      "the drill never released the observer", timeout, stop)

    def b_hook(name: str):
        def _hook(step, manager, model, loss):
            log(f"{name} committed step {step} participants "
                f"{manager.num_participants()} control RPCs "
                f"{manager.control_rpcs()}")
            deposit("b", name, step, model)
            if name == "b0" and step <= kill_step:
                cross_deposit("b0", step, model)
            if step > total:
                return
            # lockstep with job a: step s + 1 starts once a0 committed s
            _wait_for(lambda: step in a0_steps, f"a0 never committed {step}",
                      timeout, stop)
            if step in (kill_step - 1, heal + 1):
                when = "before" if step == kill_step - 1 else "after"
                b_barrier.wait(timeout)
                if name == "b0":
                    # an install's recompute lands on the next tick
                    time.sleep(0.3)
                    b_status[when] = _job_status(addr, "b", timeout)
                if when == "before":
                    manager.metrics.reset_timings()
                else:
                    b_window[name] = manager.metrics.snapshot()
                b_barrier.wait(timeout)
            if step == total:
                b_last[name] = snap(model)
                _wait_for(b_go.is_set, "hi0 never preempted job b", timeout,
                          stop)
                # the eviction bumped job b's epoch: both leases break
                _wait_for(lambda: not manager.lease_live(),
                          f"{name}'s lease outlived the eviction", timeout,
                          stop)
        return _hook

    def b_evicted(name: str):
        def _hook(manager, model):
            events = _telemetry(manager, "events", timeout)["events"]
            eviction["events"] = [e for e in events
                                  if e["kind"] == "job_preempted"]
            eviction["unchanged"] = same(b_last[name],
                                         list(model.parameters()))
            eviction["is_evicted"] = manager.is_evicted()
            eviction["telemetry_evicted"] = _telemetry(
                manager, "metrics", timeout).get("evicted")
        return _hook

    def hi_hook(step, manager, model, loss):
        log(f"hi0 committed step {step} wire {manager.transport_world_size()}")

    common = dict(lighthouse_addr=addr, device=device, batch_size=batch_size,
                  data_seed=seed, timeout=timeout, stop=stop)

    def group_a(name: str):
        def _run():
            g = int(name[1])
            if name == "a0":
                runs[name].append(train_group(
                    cfg, replica_group=0, num_groups=2, total_steps=total,
                    job_id="a", init_seed=seed,
                    on_start=started(name, "a", 3), on_commit=a_hook(name),
                    **common))
                return
            try:
                train_group(cfg, replica_group=g, num_groups=2,
                            total_steps=total, job_id="a", init_seed=seed,
                            fail_at_step=kill_step,
                            on_start=started(name, "a", 3),
                            on_commit=a_hook(name), **common)
                raise AssertionError("a1 was never failed")
            except InjectedFailure as e:
                runs[name].append(e.run)
                log(f"injected failure: {e}; a1 restarts from a poisoned "
                    "init")
            _wait_for(ahead.is_set, f"a0 never committed {kill_step + 1}",
                      timeout, stop)
            runs[name].append(train_group(
                cfg, replica_group=g, num_groups=2, total_steps=total,
                job_id="a", init_seed=seed + 1000,
                on_start=started(name, "a"), on_commit=a_hook(name),
                **common))
        return _run

    def observer():
        runs["a_obs"].append(train_group(
            cfg, replica_group=2, num_groups=3, total_steps=total,
            job_id="a", data_plane=False, init_seed=seed + 2000,
            on_start=started("a_obs", "a", 3), on_commit=obs_hook,
            **common))

    def group_b(name: str):
        def _run():
            runs[name].append(train_group(
                cfg, replica_group=int(name[1]), num_groups=2,
                total_steps=total + steps_more, job_id="b", init_seed=seed,
                on_start=started(name, "b", 2), on_commit=b_hook(name),
                on_evicted=b_evicted(name), **common))
        return _run

    def hi0():
        runs["hi0"].append(train_group(
            hi_cfg, replica_group=0, num_groups=1, total_steps=steps_more,
            job_id="hi", init_seed=seed + 3000, on_start=started("hi0", "hi"),
            on_commit=hi_hook, **common))

    def guarded(fn):
        def _run():
            try:
                fn()
            except BaseException as e:  # noqa: BLE001 — re-raised below
                errors.append(e)
                stop.set()  # never strand the other groups
                for ev in (ahead, b_go, release):
                    ev.set()
                b_barrier.abort()
        return _run

    names = {"a0": group_a("a0"), "a1": group_a("a1"), "a_obs": observer,
             "b0": group_b("b0"), "b1": group_b("b1")}
    threads = {n: threading.Thread(target=guarded(fn), name=n)
               for n, fn in names.items()}
    try:
        for t in threads.values():
            t.start()
        # every group of a and b parked at its step t before hi0 arrives
        _wait_for(lambda: (len(obs_steps) == total
                           and all(n in b_last for n in ("b0", "b1"))
                           and compared["a"].get(total) == 2),
                  f"jobs a and b never committed step {total}", timeout, stop)
        threads["hi0"] = threading.Thread(target=guarded(hi0), name="hi0")
        threads["hi0"].start()
        _wait_for(lambda: _job_status(addr, "b", timeout).get("preemptions"),
                  "hi0's arrival never preempted job b", timeout, stop)
        eviction["status"] = _job_status(addr, "b", timeout)
        b_go.set()
        for n in ("b0", "b1", "hi0"):
            threads[n].join(timeout=10 * timeout)
        release.set()
        for t in threads.values():
            t.join(timeout=10 * timeout)
            _require(not t.is_alive(), f"{t.name} never finished")
    finally:
        for ev in (ahead, b_go, release):
            ev.set()
        lighthouse.shutdown()
    if errors:
        raise errors[0]

    a0, a1, obs = runs["a0"][0], runs["a1"][-1], runs["a_obs"][0]
    b0, b1, hi = runs["b0"][0], runs["b1"][0], runs["hi0"][0]
    _require(a1.healed_at == [heal],
             f"a1 healed at {a1.healed_at}, not at step {heal}")
    _require(not pending and sorted(compared["a"]) == list(range(1, total + 1))
             and sorted(compared["b"]) == list(range(1, total + steps_more
                                                     + 1)),
             f"steps compared {compared}, left {sorted(pending)}")
    alone = (kill_step + 1, heal)
    want = {s: 1 if s in alone else 2 for s in range(1, total + 1)}
    _require(a0.participants == want,
             f"a0's participants {a0.participants}, want {want}")
    want = {s: 1 if s == kill_step + 1 else 2 for s in range(1, total + 1)}
    _require(a0.wire_world == want,
             f"a0's wire world {a0.wire_world}, want {want}")
    _require(obs_steps == list(range(1, total + 1)) and not obs.healed_at
             and obs.passes == 0,
             f"observer committed {obs_steps}, healed at {obs.healed_at}")
    window = range(kill_step, heal + 2)
    for run, name in ((b0, "b0"), (b1, "b1")):
        rpcs = [run.control_rpcs.get(s) for s in window]
        _require(rpcs == [0] * len(window),
                 f"{name}'s control RPCs at steps {list(window)}: {rpcs}")
    keys = ("membership_epoch", "quorum_compute_count", "lease_breaks")
    before = {k: b_status["before"][k] for k in keys}
    after = {k: b_status["after"][k] for k in keys}
    _require(before == after,
             f"job b's counters moved during a's kill and heal: {before} -> "
             f"{after}")
    status = eviction["status"]
    _require(b1.evicted_at == total and b1.evict_seconds is not None
             and b1.evict_seconds < 5.0 and eviction.get("is_evicted")
             and eviction.get("telemetry_evicted") is True
             and [e.get("job_id") for e in eviction["events"]] == ["b"]
             and eviction.get("unchanged"),
             f"b1's eviction: at {b1.evicted_at} in {b1.evict_seconds} s, "
             f"{ {k: v for k, v in eviction.items() if k != 'status'} }")
    _require(status.get("preemptions") == 1
             and status.get("evicted") == [ids["b1"]],
             f"jobs.b after the eviction: preemptions "
             f"{status.get('preemptions')}, evicted {status.get('evicted')}")
    more = list(range(total + 1, total + steps_more + 1))
    _require([b0.wire_world.get(s) for s in more] == [1] * steps_more
             and sorted(hi.participants) == list(range(1, steps_more + 1)),
             f"b0's wire after the eviction {b0.wire_world}; hi0 committed "
             f"{sorted(hi.participants)}")
    losses = [v for n in runs for r in runs[n] for v in r.losses.values()]
    _require(all(math.isfinite(v) for v in losses), "non-finite loss")
    cfg_runs = [r for n in runs if n != "hi0" for r in runs[n]]
    return {"runs": runs, "heal_step": heal, "total": total,
            "compared": compared, "ids": ids,
            "passes": sum(r.passes for r in cfg_runs),
            "hi_passes": hi.passes, "probe_passes": obs.probe_passes,
            "b_status": b_status, "b_window": b_window,
            "eviction": dict(eviction, seconds=b1.evict_seconds),
            "cross_job_equal": sorted(cross_equal),
            "seconds": time.perf_counter() - t_start}


# run_resume_drill's schedule: solo, joint and resumed steps, checkpoint
# cadence, and the lighthouse's lease
_SOLO_STEPS, _JOINT_STEPS, _STEPS_AFTER, _CKPT_EVERY = 3, 4, 2, 2
_LEASE_MS = 2000


def run_resume_drill(
    cfg: TransformerConfig,
    *,
    device: "Optional[str | torch.device]" = None,
    batch_size: int = 8,
    seed: int = 0,
    timeout: float = 60.0,
    ckpt_dir: Optional[str] = None,
    log: Callable[[str], None] = logger.info,
) -> Dict[str, object]:
    """The durable half of the fault-tolerance story over the TCP wire, on
    a fixed schedule under an in-process lighthouse that grants 2 s epoch
    leases (s = 3 solo steps, j = 4 joint steps, a = 2 steps after the
    resume, every group checkpointing through
    ``AsyncCheckpointWriter(keep=2)`` after every 2nd step):

    - group 0 commits steps 1..s alone, each a fused step (a CUDA graph on
      the card);
    - group 1 starts from a poisoned init, heals from group 0 in step
      s + 1, and both commit steps s + 1..s + j together: from the second
      joint quorum on, steady steps ride the lease (no control RPC);
    - once both have committed s + j, and their last checkpoint has
      persisted, both are killed; both restart from another poisoned init,
      resume from their newest checkpoint (step c = 6, the last multiple
      of 2 up to s + j) and commit c + 1..c + a together.

    During group 0's first joint fast-path step it reads its own GET
    /telemetry/metrics. Raises AssertionError unless: group 0's solo steps
    were all fused; the healed and the resumed groups are bitwise equal at
    every step both commit; each group committed at least 2 steps on the
    fast path before the kill, each with 0 control RPCs; the telemetry read
    showed the lease live and 0 control RPCs; both resumed at step c with
    parameters, AdamW state, sampler position and step equal to the file's
    bitwise; every loss is finite. ``ckpt_dir`` (a temporary directory by
    default, removed at the end) holds the checkpoints. Returns the runs
    (``runs[g]`` = [before the kill, after the resume]), the heal and
    resume steps, the checked steps, the telemetry read, whether the
    resumed run's first step repeated the first run's bitwise
    (``replay_equal``), and the forward/backward passes of all runs."""
    solo_steps, ckpt_every = _SOLO_STEPS, _CKPT_EVERY
    lighthouse = Lighthouse(min_replicas=1, join_timeout_ms=200,
                            heartbeat_timeout_ms=1000, lease_ms=_LEASE_MS)
    addr = lighthouse.address()
    kill_at = solo_steps + _JOINT_STEPS
    resume_at = kill_at // ckpt_every * ckpt_every
    total = resume_at + _STEPS_AFTER
    own_dir = ckpt_dir is None
    ckpt_dir = ckpt_dir or tempfile.mkdtemp(prefix="torchft_tpu_torch_ckpt_")
    solo_done, stop = threading.Event(), threading.Event()
    # snapshots[life][group][step]: parameters after each joint commit
    snapshots: Dict[int, Dict[int, Dict[int, List[torch.Tensor]]]] = {
        0: {0: {}, 1: {}}, 1: {0: {}, 1: {}}}
    runs: Dict[int, List[GroupRun]] = {0: [], 1: []}
    telemetry: Dict[str, Any] = {}
    errors: List[BaseException] = []

    def both_heartbeating(manager):
        _wait_lighthouse(addr, "healthy", 2, timeout, stop)

    def on_commit(life: int, group: int):
        def _hook(step, manager, model, loss):
            rpcs = manager.control_rpcs()
            log(f"life {life} group {group} committed step {step} "
                f"participants {manager.num_participants()} control RPCs "
                f"{rpcs}" + (" (healed)" if manager.did_heal() else ""))
            if life == 0 and group == 0 and step == solo_steps:
                # let group 1 start; take the next quorum with it, once its
                # arrival has broken our lease
                solo_done.set()
                _wait_lighthouse(addr, "participants", 1, timeout, stop)
                _wait_for(lambda: not manager.lease_live(),
                          "group 1's arrival never broke group 0's lease",
                          timeout, stop)
            if step > solo_steps:
                snapshots[life][group][step] = [
                    p.detach().clone() for p in model.parameters()]
            if (group == 0 and life == 0 and not telemetry and rpcs == 0
                    and step > solo_steps + 1):
                telemetry.update(_telemetry(manager, "metrics", timeout))
        return _hook

    common = dict(num_groups=2, lighthouse_addr=addr, device=device,
                  batch_size=batch_size, data_seed=seed, timeout=timeout,
                  stop=stop, ckpt_every=ckpt_every)

    def group(g: int):
        def _run():
            path = os.path.join(ckpt_dir, f"group{g}", "ckpt")
            if g == 1 and not (solo_done.wait(timeout) and not stop.is_set()):
                raise TimeoutError(f"group 0 never committed {solo_steps}")
            try:
                train_group(cfg, replica_group=g, init_seed=seed + 1000 * g,
                            total_steps=total, fail_at_step=kill_at,
                            ckpt_path=path, on_commit=on_commit(0, g),
                            **common)
                raise AssertionError(f"group {g} was never failed")
            except InjectedFailure as e:
                runs[g].append(e.run)
                log(f"group {g} killed: {e}")
            killed.wait()  # both down before either restarts
            if stop.is_set():
                return
            runs[g].append(train_group(
                cfg, replica_group=g, init_seed=seed + 2000 + g,
                total_steps=total, ckpt_path=path, verify_resume=True,
                on_start=both_heartbeating, on_commit=on_commit(1, g),
                **common))
        return _run

    killed = threading.Event()

    def guarded(fn):
        def _run():
            try:
                fn()
            except BaseException as e:  # noqa: BLE001 — re-raised below
                errors.append(e)
                stop.set()  # never strand the other group
                solo_done.set()
                killed.set()
        return _run

    threads = [threading.Thread(target=guarded(group(g)), name=f"group{g}")
               for g in (0, 1)]
    try:
        for t in threads:
            t.start()
        # the kill: both groups down, and gone from the lighthouse, before
        # either restarts, so both resume together from the same step
        _wait_for(lambda: bool(errors)
                  or (len(runs[0]), len(runs[1])) == (1, 1),
                  "the groups were never killed", timeout, stop)
        if not errors:
            _wait_lighthouse(addr, "healthy", 0, timeout, stop, at_most=True)
        killed.set()
        for t in threads:
            t.join()
    finally:
        killed.set()
        lighthouse.shutdown()
        if own_dir:
            shutil.rmtree(ckpt_dir, ignore_errors=True)
    if errors:
        raise errors[0]

    first, resumed = ({g: runs[g][i] for g in (0, 1)} for i in (0, 1))
    _require(first[0].fused_steps == solo_steps
             and sorted(first[0].losses)[:solo_steps]
             == list(range(1, solo_steps + 1)),
             f"group 0 fused {first[0].fused_steps} of its {solo_steps} "
             "solo steps")
    _require(first[1].healed_at == [solo_steps + 1],
             f"group 1 healed at {first[1].healed_at}, not at step "
             f"{solo_steps + 1}")
    for g in (0, 1):
        fast = [s for s, n in first[g].control_rpcs.items() if n == 0]
        _require(len(fast) >= 2 and
                 first[g].metrics.get("fastpath_steps") == float(len(fast)),
                 f"group {g}: fast-path steps {fast}, counter "
                 f"{first[g].metrics.get('fastpath_steps')}")
        _require(resumed[g].resumed_step == resume_at,
                 f"group {g} resumed at {resumed[g].resumed_step}, not at "
                 f"{resume_at}")
        _require(not resumed[g].resume_mismatches,
                 f"group {g}'s resumed state differs from its checkpoint at "
                 f"{resumed[g].resume_mismatches[:5]}")
    _require(bool(telemetry) and telemetry.get("lease_live") is True
             and telemetry.get("control_rpcs_per_step") == 0,
             f"telemetry during a fast-path step: {telemetry or 'none'}")
    checked = []
    for life, lo, hi in ((0, solo_steps + 1, kill_at), (1, resume_at + 1, total)):
        steps = sorted(set(snapshots[life][0]) & set(snapshots[life][1]))
        _require(steps == list(range(lo, hi + 1)),
                 f"life {life}: steps both groups committed {steps}")
        for s in steps:
            for a, b in zip(snapshots[life][0][s], snapshots[life][1][s]):
                _require(torch.equal(a, b),
                         f"life {life}: the groups diverged at step {s}")
        checked.append(steps)
    replay_equal = all(
        torch.equal(a, b)
        for a, b in zip(snapshots[0][0][resume_at + 1],
                        snapshots[1][0][resume_at + 1])
    ) if resume_at + 1 <= kill_at else None
    losses = [v for g in runs for r in runs[g] for v in r.losses.values()]
    _require(all(math.isfinite(v) for v in losses), "non-finite loss")
    return {"runs": runs, "heal_step": solo_steps + 1,
            "resume_step": resume_at, "checked_steps": checked,
            "telemetry": telemetry, "replay_equal": replay_equal,
            "passes": sum(r.passes for g in runs for r in runs[g])}


def main() -> None:
    logging.basicConfig(level=os.environ.get("LOGLEVEL", "WARNING"),
                        format="%(asctime)s %(name)s: %(message)s")
    if os.environ.get("DEVICE", "cuda") != "cpu":
        # f32 products stay f32 (the loss's lm-head product)
        torch.backends.cuda.matmul.allow_tf32 = False
    replica_group = int(os.environ.get("REPLICA_GROUP_ID", "0"))
    rank = int(os.environ.get("RANK", "0"))

    def on_commit(step, manager, model, loss):
        # the loss is read only every 10th step: a read syncs with the card
        loss_part = f" loss {float(loss):.4f}" if step % 10 == 0 else ""
        print(f"[group {replica_group}] step {step}{loss_part} "
              f"participants {manager.num_participants()}", flush=True)

    store_addr = None
    if rank != 0:
        store_addr = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    run = train_group(
        CONFIGS[os.environ.get("MODEL", "tiny")],
        replica_group=replica_group,
        num_groups=int(os.environ.get("NUM_REPLICA_GROUPS", "2")),
        total_steps=int(os.environ.get("TOTAL_STEPS", "50")),
        device=os.environ.get("DEVICE"),
        rank=rank,
        world_size=int(os.environ.get("WORLD_SIZE", "1")),
        store_addr=store_addr,
        on_commit=on_commit,
        ckpt_path=os.environ.get(
            "CKPT_PATH", os.path.join(tempfile.gettempdir(),
                                      f"torchft_tpu_torch_ddp_{replica_group}"
                                      ".ckpt")),
        ckpt_every=int(os.environ.get("CKPT_EVERY", "10")),
        # SHARDED=1 and MODEL_SHARDS=M must match across groups
        sharded=True if os.environ.get("SHARDED", "0") == "1" else None,
        model_shards=int(os.environ.get("MODEL_SHARDS", "1")),
        streamed=os.environ.get("STREAMED", "1") != "0",
    )
    if run.resumed_step is not None:
        print(f"[group {replica_group}] resumed at step {run.resumed_step}",
              flush=True)
    print(f"[group {replica_group}] done", flush=True)


if __name__ == "__main__":
    main()
