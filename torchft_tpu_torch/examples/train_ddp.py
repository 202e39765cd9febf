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
False`` is its lock-step arm), ``opt.step()``. Losses come back through the
optimizer wrapper's fence, in batches, never one sync per step.

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
evict a group of the second. The first two take ``comm_backend`` and ``comm_options`` for the
Manager: the default is the TCP gradient wire; ``comm_backend="cuda"`` with
e.g. ``comm_options={"algorithm": "psum", "compression": "int8"}`` reduces
on the training device instead (comm/cuda_backend.py), where groups that
share a process share the device's plans.
"""

from __future__ import annotations

import json
import logging
import math
import os
import shutil
import tempfile
import threading
import time
import urllib.request
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
from torchft_tpu_torch.comm.cuda_backend import default_device_pool
from torchft_tpu_torch.comm.store import StoreServer
from torchft_tpu_torch.comm.topology import DomainTopology
from torchft_tpu_torch.control import Lighthouse, LighthouseClient
from torchft_tpu_torch.data import DistributedSampler
from torchft_tpu_torch.checkpointing import CheckpointServer
from torchft_tpu_torch.ddp import (
    _DEFAULT_BUCKET_BYTES,
    DistributedDataParallel,
    _BucketPlan,
)
from torchft_tpu_torch.manager import Manager, _build_comm_context
from torchft_tpu_torch.models import (
    CONFIGS,
    GPT,
    TransformerConfig,
    make_train_step,
)
from torchft_tpu_torch.ops.flash import check_head_dim
from torchft_tpu_torch.optim import (
    OptimizerWrapper,
    ShardedOptimizerWrapper,
    adamw,
    load_optimizer_state_dict,
)
from torchft_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)

__all__ = ["FaultyCommContext", "InjectedFailure", "GroupRun",
           "run_joint", "run_kill_and_heal", "run_multijob_drill",
           "run_resume_drill", "train_group"]

# the manifest paths of the sharded optimizer's slots: a heal leaves them
# on the donor, and the healer fetches them with fetch_opt_shard
OPT_SLOTS_PATH_RE = r".*\['slots'\]\[(\d+)\]\[(\d+)\]$"


class InjectedFailure(Exception):
    """Raised by ``train_group`` at ``fail_at_step``: a simulated crash.
    ``run`` is what the group did until then."""

    def __init__(self, msg: str, run: "GroupRun") -> None:
        super().__init__(msg)
        self.run = run


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
    # (barrier, dispatch, fence, transition_drain)
    metrics: Dict[str, object] = field(default_factory=dict)
    fused_metrics: Dict[str, object] = field(default_factory=dict)
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
    opt = OptimizerWrapper(manager, optimizer)
    if sharded is not None:
        sharded_opt = ShardedOptimizerWrapper(
            manager, adamw(3e-4, weight_decay=1e-4), model, sharded=sharded)
    # the solo-wire step: forward, backward and AdamW as one CUDA graph
    train_step = make_train_step(model, optimizer)
    run = GroupRun(replica_id=manager.replica_id())
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
                    f"group {replica_group} at step {fail_at_step}", run
                )
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
        run.passes += train_step.warmup_passes
        run.captures = train_step.captures
        if writer is not None:
            try:
                writer.close()
            except Exception as e:  # noqa: BLE001 — raised by wait() above
                logger.warning(f"group {replica_group}: checkpoint: {e}")
            run.checkpoints = list(writer.saves)
        run.metrics = manager.metrics.snapshot()
        run.fused_metrics = opt.fused_metrics.snapshot()
        run.buckets = (ddp.bucket_sizes() if sharded_opt is None
                       else sharded_opt.bucket_sizes())
        if manager.events:
            run.events = manager.events.since(0)[0]
        if comm is not None:
            run.recorded = comm.recorded
        manager.shutdown(wait=False)
        if store is not None:
            store.shutdown()
    return run


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
    ``digest_params`` the digests, as for :func:`train_group`. With
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
    errors: List[BaseException] = []
    tree = _DrillDomains(domains) if domains is not None else None
    comm_options = dict(comm_options or {})
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
                _require(torch.equal(a, b), f"group {g} diverged from "
                         f"group {first} at step {step}")
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

    common = dict(num_groups=groups, lighthouse_addr=addr, device=device,
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

    def survivor(g: int):
        def _run():
            runs[g].append(train_group(
                cfg, replica_group=g, init_seed=seed,
                on_start=started(g, True), on_commit=on_commit(g),
                record_ops=record, **common))
        return _run

    def killed():
        g = kill_group
        try:
            train_group(cfg, replica_group=g, init_seed=seed,
                        fail_at_step=kill_step, on_start=started(g, True),
                        on_commit=on_commit(g), record_ops=record, **common)
            raise AssertionError(f"group {g} was never failed")
        except InjectedFailure as e:
            runs[g].append(e.run)
            log(f"injected failure: {e}; restarting from a poisoned init")
        if not ahead.wait(timeout) or stop.is_set():
            raise TimeoutError(
                f"the survivors never committed step {kill_step + s_alone}")
        runs[g].append(train_group(
            cfg, replica_group=g, init_seed=seed + 1000,
            on_start=started(g, False), on_commit=on_commit(g), **common))

    def guarded(fn):
        def _run():
            try:
                fn()
            except BaseException as e:  # noqa: BLE001 — re-raised below
                errors.append(e)
                stop.set()  # never strand the other groups
                ahead.set()
                survivors_done.abort()
        return _run

    threads = [threading.Thread(
        target=guarded(killed if g == kill_group else survivor(g)),
        name=f"group{g}") for g in range(groups)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        lighthouse.shutdown()
    if errors:
        raise errors[0]

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
    errors: List[BaseException] = []

    def started(manager) -> None:
        _wait_lighthouse(addr, "healthy", groups, timeout, stop)

    def group(g: int) -> None:
        try:
            runs[g] = train_group(
                cfg, replica_group=g, num_groups=groups, total_steps=steps,
                lighthouse_addr=addr, device=device, batch_size=batch_size,
                init_seed=seed, data_seed=seed, timeout=timeout, stop=stop,
                on_start=started, **kwargs)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append(e)
            stop.set()

    threads = [threading.Thread(target=group, args=(g,), name=f"group{g}")
               for g in range(groups)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        lighthouse.shutdown()
    if errors:
        raise errors[0]
    return runs


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


def _telemetry(manager: Manager, what: str, timeout: float) -> Dict[str, Any]:
    """GET /telemetry/{what} from the manager's checkpoint server."""
    url = f"{manager._checkpoint_transport.metadata()}/telemetry/{what}"
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.load(r)


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
