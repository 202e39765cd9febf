"""Fault-tolerant DiLoCo (or LocalSGD) training of the GPT with torch (twin
of ``examples/train_diloco.py``, BASELINE config 4's shape; LocalSGD with
``ALGO=local_sgd``, config 3's).

Run one replica group per process (repeat per group):

    python -m torchft_tpu_torch.lighthouse_cli --min_replicas 2 &
    REPLICA_GROUP_ID=0 NUM_REPLICA_GROUPS=2 \\
    TORCHFT_TPU_LIGHTHOUSE=http://host:29510 \\
        python -m torchft_tpu_torch.examples.train_diloco

Inner steps run locally at full speed, each one replay of a CUDA graph of
forward, backward and AdamW (``models.make_train_step``); every
``SYNC_EVERY`` steps the groups average pseudogradients (DiLoCo) or weights
(LocalSGD) through the Manager, with commit and rollback per round. The
outer sync rides the streaming fragment scheduler: ``NUM_FRAGMENTS``
(default 2) byte-balanced fragments stagger across the round and overlap
the wire with inner compute; ``STREAMING=0`` pins the blocking arm. The
Manager runs sync quorums (``use_async_quorum=False``), so a restarted
group heals at the next round's quorum. It runs on CUDA (``DEVICE=cpu``
for the CPU).

``train_group`` is the loop as a function, with a failure schedule: a kill
at an inner step of a round, and a fault injected into one fragment op
(:class:`FaultyCommContext`). ``run_diloco_drill`` drives several groups as
threads under an in-process lighthouse through such a schedule and checks
that every group that commits a round holds the same bits. Both take
``sharded_outer`` (the outer update sharded by fragment, local_sgd.py) and
``subproc_groups`` (those groups' wires in a killable child process,
``comm.subproc.SubprocessCommContext``); the drill's ``wedge`` SIGSTOPs such
a child in the middle of a round.
"""

from __future__ import annotations

import logging
import math
import os
import signal
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from torchft_tpu_torch.comm.context import CommContext
from torchft_tpu_torch.comm.store import StoreServer
from torchft_tpu_torch.control import Lighthouse
from torchft_tpu_torch.data import DistributedSampler
from torchft_tpu_torch.examples.train_ddp import (
    FaultyCommContext,
    InjectedFailure,
    _wait_lighthouse,
)
from torchft_tpu_torch.local_sgd import DiLoCo, LocalSGD, fragment_boundaries
from torchft_tpu_torch.manager import Manager
from torchft_tpu_torch.models import CONFIGS, GPT, TransformerConfig, make_train_step
from torchft_tpu_torch.ops.flash import check_head_dim
from torchft_tpu_torch.optim import load_optimizer_state_dict, sgd
from torchft_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)

__all__ = ["DiLoCoRun", "FaultyCommContext", "run_diloco_drill",
           "train_group"]


@dataclass
class DiLoCoRun:
    """What one replica group did: its forward/backward passes (inner
    steps, committed rounds or not, plus the CUDA graph captures' warm-up
    passes), the captures, the round outcomes in order (``(manager step
    after the round, committed)``), the wall seconds of each committed
    round (keyed by the manager step after it), the manager step after each
    round in which it applied a healed state, its committed rounds whose
    wire had a peer, every inner step's loss, its final metrics, the
    fragment ops its comm context recorded (``FaultyCommContext``), and its
    manager's flight-recorder events."""

    passes: int = 0
    captures: int = 0
    rounds: List[Tuple[int, bool]] = field(default_factory=list)
    round_seconds: Dict[int, float] = field(default_factory=dict)
    healed_at: List[int] = field(default_factory=list)
    wire_rounds: int = 0
    losses: List[float] = field(default_factory=list)
    metrics: Dict[str, object] = field(default_factory=dict)
    recorded: Dict[int, Tuple[List[np.ndarray], List[np.ndarray]]] = field(
        default_factory=dict)
    events: List[Dict[str, Any]] = field(default_factory=list)


def _clone_tree(x: Any) -> Any:
    """Tensors cloned, containers rebuilt: a state the heal plane stages
    lazily while the inner loop keeps updating the live tensors in place."""
    if isinstance(x, torch.Tensor):
        return x.detach().clone()
    if isinstance(x, dict):
        return {k: _clone_tree(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_clone_tree(v) for v in x)
    return x


def train_group(
    cfg: TransformerConfig,
    *,
    replica_group: int,
    num_groups: int,
    total_syncs: int,
    algo: str = "diloco",
    sync_every: int = 8,
    num_fragments: int = 2,
    streaming: bool = True,
    lighthouse_addr: Optional[str] = None,
    device: "Optional[str | torch.device]" = None,
    batch_size: int = 8,
    init_seed: int = 0,
    data_seed: int = 0,
    dataset_size: int = 4096,
    kill_at: Optional[Tuple[int, int]] = None,
    fail_at_op: Optional[int] = None,
    record_ops: Sequence[int] = (),
    on_start: Optional[Callable[[Manager], None]] = None,
    on_round: Optional[Callable[..., None]] = None,
    stop: Optional[threading.Event] = None,
    timeout: float = 60.0,
    comm_backend: str = "host",
    comm_options: Optional[Dict[str, Any]] = None,
    sharded_outer: bool = False,
    subproc_groups: Sequence[int] = (),
    on_comm: Optional[Callable[[CommContext], None]] = None,
    on_fence: Optional[Callable[[Manager, LocalSGD], None]] = None,
) -> DiLoCoRun:
    """Train one replica group until ``total_syncs`` rounds are committed
    (or ``stop`` is set), as the JAX package's example does: AdamW(3e-4,
    weight decay 0.1, betas 0.9/0.95) inner steps, DiLoCo with the outer
    ``sgd(0.7, momentum=0.9, nesterov=True)`` or LocalSGD (``algo``), a
    sampler over ``dataset_size`` sequences (seed 1), data from
    ``default_rng(data_seed)``.

    Failure schedule: ``kill_at=(syncs, inner_step)`` raises
    :class:`InjectedFailure` (after shutting this group's manager down) at
    the top of inner step ``inner_step`` of the first round that starts
    with ``syncs`` or more rounds committed; ``fail_at_op`` fails that
    fragment op on this group's wire (:class:`FaultyCommContext`, which
    also records ``record_ops``). ``on_start(manager)`` runs once the
    manager exists; ``on_round(step, committed, manager, wrapper, model,
    loss)`` after every round (``loss``: its last inner step's);
    ``on_fence(manager, wrapper)`` after the inner step whose round-start
    fence ran (the quorum resolved, a heal and the sharded reshard applied),
    when that step does not also end the round. ``comm_backend`` /
    ``comm_options``: the Manager's data plane, "host" (TCP, codec none) or
    "cuda". ``sharded_outer``: the outer update sharded by fragment.
    ``subproc_groups``: when ``replica_group`` is among them, the host wire
    runs in a killable child process (``SubprocessCommContext``, the same
    options). ``on_comm(comm)`` sees the data-plane context once it exists.
    """
    if algo not in ("diloco", "local_sgd"):
        raise ValueError(f"algo must be diloco or local_sgd, got {algo!r}")
    if torch.device("cuda" if device is None else device).type == "cuda":
        check_head_dim(f"train_diloco: config with d_model {cfg.d_model} and "
                       f"{cfg.n_heads} heads", cfg.head_dim)
    if comm_backend != "host" and replica_group in subproc_groups:
        raise ValueError("subproc_groups runs the host wire in a child; "
                         f"comm_backend {comm_backend!r} has no such arm")
    device = resolve_device(device)
    options = dict(comm_options or {})
    options.setdefault("timeout", timeout)
    if comm_backend == "cuda":
        from torchft_tpu_torch.comm.cuda_backend import (
            CudaCommContext,
            default_device_pool,
        )

        options.setdefault("device_pool", default_device_pool(device))
        comm: CommContext = CudaCommContext(**options)
    elif comm_backend == "host" and replica_group in subproc_groups:
        from torchft_tpu_torch.comm.subproc import SubprocessCommContext

        comm = SubprocessCommContext(**options)
    elif comm_backend == "host":
        from torchft_tpu_torch.comm.transport import TcpCommContext

        comm = TcpCommContext(**options)
    else:
        raise ValueError(f"unknown comm_backend {comm_backend!r}")
    if on_comm is not None:
        on_comm(comm)
    comm = FaultyCommContext(comm, fail_at_op=fail_at_op,
                             record_ops=record_ops)

    model = GPT(cfg, device=device, seed=init_seed)
    optimizer = torch.optim.AdamW(model.parameters(), lr=3e-4,
                                  weight_decay=0.1, betas=(0.9, 0.95),
                                  capturable=device.type == "cuda")
    rng = np.random.default_rng(data_seed)
    dataset = rng.integers(0, cfg.vocab_size, (dataset_size, cfg.max_seq_len))
    sampler = DistributedSampler(
        len(dataset), replica_group=replica_group,
        num_replica_groups=num_groups, shuffle=True, seed=1,
    )
    wrapper_ref: Dict[str, LocalSGD] = {}

    def state_dict():
        # clones: the inner loop keeps stepping in place while the heal
        # plane stages this state (until the round's commit closes the gate)
        sd = {"model": _clone_tree(model.state_dict()),
              "optim": _clone_tree(optimizer.state_dict()),
              "sampler": sampler.state_dict()}
        if "w" in wrapper_ref:
            sd["wrapper"] = wrapper_ref["w"].state_dict()
        return sd

    def load_state_dict(sd):
        # in place, so the inner step's CUDA graph stays valid
        model.load_state_dict(sd["model"])
        load_optimizer_state_dict(optimizer, sd["optim"])
        sampler.load_state_dict(sd["sampler"])
        if "wrapper" in sd and "w" in wrapper_ref:
            wrapper_ref["w"].load_state_dict(sd["wrapper"])

    store = StoreServer()
    manager = Manager(
        comm=comm,
        load_state_dict=load_state_dict,
        state_dict=state_dict,
        min_replica_size=1,
        use_async_quorum=False,  # the round's quorum heals eagerly
        timeout=timeout,
        quorum_timeout=timeout,  # must cover sync_every inner steps
        connect_timeout=timeout,
        rank=0,
        world_size=1,
        store_addr=store.addr,
        lighthouse_addr=lighthouse_addr,
        replica_id=f"diloco_{replica_group}_",
        heartbeat_interval=0.05,
    )
    if algo == "diloco":
        # Nesterov-momentum SGD outer optimizer, the DiLoCo paper's default
        wrapper: LocalSGD = DiLoCo(
            manager, sgd(0.7, momentum=0.9, nesterov=True),
            sync_every=sync_every, params_fn=lambda: model,
            num_fragments=num_fragments, streaming=streaming,
            sharded_outer=sharded_outer)
    else:
        wrapper = LocalSGD(manager, sync_every=sync_every,
                           params_fn=lambda: model,
                           num_fragments=num_fragments, streaming=streaming,
                           sharded_outer=sharded_outer)
    wrapper.register(model)  # the host arenas (pinned on CUDA)
    wrapper_ref["w"] = wrapper
    # a sync-quorum manager fences at the first fragment's boundary
    fence_step = fragment_boundaries(sync_every, wrapper.num_fragments)[0]
    train_step = make_train_step(model, optimizer)
    run = DiLoCoRun(recorded=comm.recorded)
    pending: List[torch.Tensor] = []  # this round's losses, on the device

    try:
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
        t_round = time.perf_counter()
        while manager.current_step() < total_syncs and not (
                stop is not None and stop.is_set()):
            if (kill_at is not None and manager.current_step() >= kill_at[0]
                    and wrapper.local_step == kill_at[1] - 1):
                raise InjectedFailure(
                    f"group {replica_group} at inner step {kill_at[1]} "
                    f"after {kill_at[0]} syncs", run)
            tokens, targets = next_batch()
            pending.append(train_step(tokens, targets))
            run.passes += 1
            step_before = manager.current_step()
            wrapper.step()
            if on_fence is not None and wrapper.local_step == fence_step:
                on_fence(manager, wrapper)
            if wrapper.local_step != 0:
                continue
            # a round just ended: one read of its losses
            run.losses.extend(torch.stack(pending).float().cpu().tolist())
            pending.clear()
            step = manager.current_step()
            committed = step > step_before
            run.rounds.append((step, committed))
            if manager.did_heal():
                run.healed_at.append(step)
            if committed:
                run.round_seconds[step] = time.perf_counter() - t_round
                if manager.transport_world_size() > 1:
                    run.wire_rounds += 1
            if on_round is not None:
                on_round(step, committed, manager, wrapper, model,
                         run.losses[-1])
            t_round = time.perf_counter()
    finally:
        run.passes += train_step.warmup_passes
        run.captures = train_step.captures
        run.metrics = manager.metrics.snapshot()
        if manager.events:
            run.events = manager.events.since(0)[0]
        manager.shutdown(wait=False)
        store.shutdown()
    return run


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def _host_copy(model: GPT) -> List[torch.Tensor]:
    return [p.detach().to("cpu", copy=True) for p in model.parameters()]


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    return True


def _held(outer: Any) -> List[int]:
    """The fragments whose outer state a (sharded) DiLoCo holds."""
    return [f for f, state in enumerate(outer or ()) if state is not None]


def run_diloco_drill(
    cfg: TransformerConfig,
    *,
    algo: str = "diloco",
    groups: int = 2,
    rounds: int = 5,
    kill: Optional[Tuple[int, int, int]] = (1, 2, 4),
    fault: Optional[Tuple[int, int]] = None,
    record_ops: Sequence[int] = (),
    sync_every: int = 8,
    num_fragments: int = 2,
    device: "Optional[str | torch.device]" = None,
    batch_size: int = 8,
    seed: int = 0,
    timeout: float = 60.0,
    log: Callable[[str], None] = logger.info,
    comm_backend: str = "host",
    comm_options: Optional[Dict[str, Any]] = None,
    sharded_outer: bool = False,
    subproc_groups: Sequence[int] = (),
    wedge: Optional[Tuple[int, int]] = None,
    keep_params: Sequence[int] = (),
) -> Dict[str, object]:
    """``groups`` replica groups as threads under an in-process lighthouse
    (no lease; every quorum waits for every live group), ``rounds``
    committed rounds each, on a fixed schedule:

    - ``kill=(g, syncs, inner_step)``: group ``g`` is killed at inner step
      ``inner_step`` of round ``syncs + 1``; the others' round goes on
      without it once the lighthouse counts it dead (they commit it alone,
      after an aborted attempt when the kill came after the round's
      quorum); ``g`` restarts from a poisoned init (another seed) once
      they have committed that round, and heals from a peer at the quorum
      of its first round; then every group commits the remaining rounds
      together.
    - ``fault=(g, op)``: group ``g``'s ``op``-th fragment op fails after
      the collective ran (:class:`FaultyCommContext`): ``g``'s round
      aborts and rolls back, the others commit it, and ``g`` heals at the
      next round's quorum, as the JAX package's Manager rules have it.
    - ``wedge=(g, syncs)``: group ``g``'s wire child (``g`` in
      ``subproc_groups``) is SIGSTOPped at the fence of the first round
      that starts with ``syncs`` rounds committed, with that round's first
      fragment op in flight: every group's round aborts (the peers' wire
      times out, then ``g``'s child is given up on), ``g``'s next quorum
      bumps ``comm_epoch``, and every group reconfigures, which SIGKILLs
      the stopped child.

    Every group but the quorum's first also heals in its first round (the
    step-0 heal that gives every group the same initial state).
    ``sharded_outer`` and ``subproc_groups`` go to :func:`train_group`.

    Raises AssertionError unless: every group that commits a round holds
    parameters bitwise equal to every other group that commits it (and, for
    a replicated DiLoCo, outer states too); a killed group healed exactly
    once, in its first round; an aborted round left parameters bitwise at
    the backup and the outer states as its fence left them; a faulted
    group's aborted round was its only one; every loss is finite. Sharded
    besides: after every committed round the groups that commit it hold
    each fragment's outer state exactly once; every ``reshard`` moved
    exactly its lower bound; a killed group's wire child is gone after the
    kill; the restarted group's fragments' outer states after its first
    fence equal, bitwise, those their holders committed before it came
    back; a wedged child is gone after the reconfigure, with a new one in
    its place.

    Returns the runs (``runs[g]``: one per life), the checked rounds, the
    passes of all runs, the CPU copies of the recorded fragment ops
    (``recorded[g]``), host copies of the parameters committed at the
    rounds in ``keep_params`` (``params``), the fragments each committing
    group held after each round (``held``), the wire children's pids at
    every fence (``pids[(g, life)]``), the killed child (``killed_pid``),
    the wedge (``wedged``: ``pid``, ``next_pid``) and the grow (``grow``:
    the restarted group's fragments and their holders)."""
    if wedge is not None and wedge[0] not in subproc_groups:
        raise ValueError(f"wedge needs group {wedge[0]}'s wire in a child "
                         "(subproc_groups)")
    # a quorum waits for every live group (a dead one drops out after the
    # 1 s heartbeat timeout), so no group is left out of a round by
    # arriving late
    lighthouse = Lighthouse(min_replicas=1,
                            join_timeout_ms=int(timeout * 1000),
                            heartbeat_timeout_ms=1000)
    addr = lighthouse.address()
    stop = threading.Event()
    survivor_ahead = threading.Event()
    lock = threading.Lock()
    # the first group to commit round s leaves its bits; the rest compare
    firsts: Dict[int, Tuple[int, List[torch.Tensor], Any]] = {}
    checked: Dict[int, int] = {}
    rollbacks: List[int] = []
    runs: Dict[int, List[DiLoCoRun]] = {g: [] for g in range(groups)}
    errors: List[BaseException] = []
    kill_group = kill[0] if kill is not None else None
    kept: Dict[int, List[torch.Tensor]] = {}
    held: Dict[int, Dict[int, List[int]]] = {}
    n_frags: List[int] = []
    comms: Dict[Tuple[int, int], CommContext] = {}
    pids: Dict[Tuple[int, int], List[int]] = {}
    # per group: (step, outer states) at its latest fence; per survivor:
    # the outer states it committed in the kill's round
    fenced: Dict[int, Tuple[int, Any]] = {}
    before_grow: Dict[int, Any] = {}
    grow: Dict[str, Any] = {}
    wedged: Dict[str, Any] = {}
    killed_pid: List[int] = []

    # every group's first life has registered (allocated its pinned
    # arenas) before any captures its inner step's CUDA graph
    registered = threading.Barrier(groups)

    def on_start(manager):
        registered.wait(timeout)
        _wait_lighthouse(addr, "healthy", groups, timeout, stop)

    def on_comm(g: int, life: int):
        return lambda comm: comms.__setitem__((g, life), comm)

    def on_fence(g: int, life: int):
        def _hook(manager, wrapper):
            step = manager.current_step()
            child_pid = getattr(comms.get((g, life)), "child_pid", None)
            pid = child_pid() if callable(child_pid) else None
            if pid is not None:
                pids.setdefault((g, life), []).append(pid)
            outer = _clone_tree(getattr(wrapper, "outer_state", None))
            fenced[g] = (step, outer)
            if (sharded_outer and kill is not None and g == kill_group
                    and life == 1 and not grow):
                holders = {f: h for f in _held(outer)
                           for h, theirs in before_grow.items()
                           if f in _held(theirs)}
                grow.update(
                    group=g, step=step, fragments=_held(outer),
                    holders=holders,
                    equal=all(_tree_equal(outer[f], before_grow[h][f])
                              for f, h in holders.items())
                    and len(holders) == len(_held(outer)))
            if wedge is None or g != wedge[0] or pid is None:
                return
            if "pid" in wedged and "next_pid" not in wedged:
                # the reconfigure after the wedge: a new child
                wedged.update(next_pid=pid,
                              old_alive=_pid_alive(wedged["pid"]))
            elif step == wedge[1] and "pid" not in wedged:
                os.kill(pid, signal.SIGSTOP)
                wedged.update(pid=pid, step=step)
                log(f"group {g}: wire child {pid} SIGSTOPped in round "
                    f"{step + 1} with its first fragment op in flight")
        return _hook

    def on_round(g: int, life: int):
        def _hook(step, committed, manager, wrapper, model, loss):
            log(f"group {g} life {life} round -> step {step} "
                f"{'committed' if committed else 'ABORTED'} participants "
                f"{manager.num_participants()}"
                + (" (healed)" if manager.did_heal() else ""))
            outer_now = getattr(wrapper, "outer_state", None)
            if not committed:
                # an aborted round writes the backup back, bitwise, and
                # adopts no outer state
                back = [b for b in wrapper._backup]
                _require(all(torch.equal(p.detach().cpu(), b)
                             for p, b in zip(model.parameters(), back)),
                         f"group {g}'s aborted round left parameters "
                         "that differ from its backup")
                at_fence = fenced.get(g)
                if at_fence is not None and at_fence[0] == step:
                    _require(_tree_equal(outer_now, at_fence[1]),
                             f"group {g}'s aborted round changed its outer "
                             "states")
                rollbacks.append(g)
                return
            params = _host_copy(model)
            outer = _clone_tree(outer_now)
            with lock:
                if step in keep_params and step not in kept:
                    kept[step] = params
                if sharded_outer:
                    held.setdefault(step, {})[g] = _held(outer)
                    n_frags[:] = [wrapper.num_fragments]
                if (kill is not None and g != kill_group
                        and step == kill[1] + 1):
                    before_grow[g] = outer
                first = firsts.get(step)
                if first is None:
                    firsts[step] = (g, params, outer)
                    # every group commits round s before any commits s + 2
                    for old in [s for s in firsts if s < step - 1]:
                        del firsts[old]
                else:
                    g0, want, want_outer = first
                    _require(all(torch.equal(a, b)
                                 for a, b in zip(params, want)),
                             f"group {g} and group {g0} committed round "
                             f"{step} with different parameters")
                    # sharded, each group holds only its own fragments
                    _require(sharded_outer or _tree_equal(outer, want_outer),
                             f"group {g} and group {g0} committed round "
                             f"{step} with different outer states")
                    checked[step] = checked.get(step, 1) + 1
            if kill is not None and g != kill_group and step == kill[1] + 1:
                # let the killed group restart, and take the next quorum
                # with it: its first quorum request must be pending before
                # any survivor asks (a quorum of the previous round's
                # members alone would form at once)
                survivor_ahead.set()
                _wait_lighthouse(addr, "participants", 1, timeout, stop)
        return _hook

    common = dict(num_groups=groups, lighthouse_addr=addr, device=device,
                  batch_size=batch_size, data_seed=seed, timeout=timeout,
                  total_syncs=rounds, stop=stop, algo=algo,
                  sync_every=sync_every, num_fragments=num_fragments,
                  comm_backend=comm_backend, comm_options=comm_options,
                  sharded_outer=sharded_outer, subproc_groups=subproc_groups)

    def group(g: int):
        def _run():
            kwargs = dict(common, replica_group=g, init_seed=seed,
                          on_start=on_start, on_round=on_round(g, 0),
                          on_fence=on_fence(g, 0), on_comm=on_comm(g, 0))
            if fault is not None and fault[0] == g:
                kwargs.update(fail_at_op=fault[1])
            kwargs.update(record_ops=record_ops)
            if g != kill_group:
                runs[g].append(train_group(cfg, **kwargs))
                return
            try:
                train_group(cfg, kill_at=(kill[1], kill[2]), **kwargs)
                raise AssertionError(f"group {g} was never killed")
            except InjectedFailure as e:
                runs[g].append(e.run)
                log(f"injected failure: {e}; restarting from a poisoned init")
            if pids.get((g, 0)):
                # the manager's shutdown took the wire child with it
                killed_pid.append(pids[(g, 0)][-1])
                _require(not _pid_alive(killed_pid[0]),
                         f"group {g}'s wire child {killed_pid[0]} outlived "
                         "the kill")
            if not survivor_ahead.wait(timeout * 4) or stop.is_set():
                raise TimeoutError("the survivors never committed round "
                                   f"{kill[1] + 1}")
            runs[g].append(train_group(
                cfg, **dict(kwargs, init_seed=seed + 1000, on_start=None,
                            on_round=on_round(g, 1), on_fence=on_fence(g, 1),
                            on_comm=on_comm(g, 1), record_ops=())))
        return _run

    def guarded(fn):
        def _run():
            try:
                fn()
            except BaseException as e:  # noqa: BLE001 — re-raised below
                errors.append(e)
                stop.set()  # never strand the other groups
                survivor_ahead.set()
                registered.abort()
        return _run

    threads = [threading.Thread(target=guarded(group(g)), name=f"group{g}")
               for g in range(groups)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        lighthouse.shutdown()
        if wedged.get("pid") is not None and _pid_alive(wedged["pid"]):
            os.kill(wedged["pid"], signal.SIGKILL)  # never leave it stopped
    if errors:
        raise errors[0]

    donor = None
    if kill is not None:
        restarted = runs[kill_group][1]
        _require(len(restarted.healed_at) == 1
                 and restarted.rounds[0] == (restarted.healed_at[0], True),
                 f"the restarted group healed at {restarted.healed_at} "
                 f"(rounds {restarted.rounds}), not in its first round")
        donor = next((e.get("src_rank") for e in restarted.events
                      if e["kind"] == "heal_start"), None)
    if fault is not None:
        _require(rollbacks == [fault[0]],
                 f"aborted rounds {rollbacks}, want one of group {fault[0]}")
        faulted = runs[fault[0]][0]
        aborted = [i for i, (_, committed) in enumerate(faulted.rounds)
                   if not committed]
        _require(len(aborted) == 1 and aborted[0] + 1 < len(faulted.rounds)
                 and faulted.rounds[aborted[0] + 1][0] in faulted.healed_at,
                 f"the faulted group's rounds {faulted.rounds}, heals at "
                 f"{faulted.healed_at}: no heal in the round after its "
                 "abort")
    if sharded_outer:
        every = list(range(n_frags[0])) if n_frags else []
        for step, by_group in sorted(held.items()):
            _require(sorted(f for fs in by_group.values() for f in fs)
                     == every,
                     f"round {step}: the committing groups hold fragments "
                     f"{by_group}, not each of {every} once")
        for g in runs:
            for life, r in enumerate(runs[g]):
                for e in r.events:
                    _require(e["kind"] != "reshard"
                             or e["wire_bytes"] == e["lower_bound_bytes"],
                             f"group {g} life {life} resharded {e}: moved "
                             "bytes differ from the lower bound")
        if kill is not None and len(every) > 1:
            _require(grow.get("equal", False),
                     f"the restarted group's fragments after its first "
                     f"fence {grow} differ from their holders' states")
    if wedge is not None:
        _require("next_pid" in wedged and not wedged["old_alive"]
                 and wedged["next_pid"] != wedged["pid"],
                 f"the wedged child was not replaced: {wedged}")
    losses = [v for g in runs for r in runs[g] for v in r.losses]
    _require(all(math.isfinite(v) for v in losses), "non-finite loss")
    return {"runs": runs, "checked_rounds": dict(sorted(checked.items())),
            "passes": sum(r.passes for g in runs for r in runs[g]),
            "recorded": {g: runs[g][0].recorded for g in runs},
            "params": kept, "held": dict(sorted(held.items())),
            "pids": pids, "killed_pid": killed_pid[0] if killed_pid else None,
            "wedged": wedged, "grow": grow, "donor": donor}


def _tree_equal(a: Any, b: Any) -> bool:
    if isinstance(a, torch.Tensor):
        return (isinstance(b, torch.Tensor) and a.dtype == b.dtype
                and torch.equal(a, b))
    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(_tree_equal(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return (isinstance(b, (list, tuple)) and len(a) == len(b)
                and all(_tree_equal(x, y) for x, y in zip(a, b)))
    return a == b


def main() -> None:
    logging.basicConfig(level=os.environ.get("LOGLEVEL", "WARNING"),
                        format="%(asctime)s %(name)s: %(message)s")
    if os.environ.get("DEVICE", "cuda") != "cpu":
        # f32 products stay f32 (the loss's lm-head product)
        torch.backends.cuda.matmul.allow_tf32 = False
    replica_group = int(os.environ.get("REPLICA_GROUP_ID", "0"))
    sync_every = int(os.environ.get("SYNC_EVERY", "8"))
    num_fragments = max(1, min(int(os.environ.get("NUM_FRAGMENTS", "2")),
                               sync_every))

    def on_round(step, committed, manager, wrapper, model, loss):
        if committed:
            print(f"[group {replica_group}] sync committed (step {step}) "
                  f"loss {loss:.4f} participants "
                  f"{manager.num_participants()}", flush=True)
        else:
            print(f"[group {replica_group}] sync ABORTED at step {step}; "
                  f"rolled back {sync_every} inner steps", flush=True)

    run = train_group(
        CONFIGS[os.environ.get("MODEL", "tiny")],
        replica_group=replica_group,
        num_groups=int(os.environ.get("NUM_REPLICA_GROUPS", "2")),
        total_syncs=int(os.environ.get("TOTAL_SYNCS", "10")),
        algo=os.environ.get("ALGO", "diloco"),
        sync_every=sync_every,
        num_fragments=num_fragments,
        streaming=os.environ.get("STREAMING", "1") != "0",
        device=os.environ.get("DEVICE"),
        on_round=on_round,
        timeout=600.0,
    )
    done = run.rounds[-1][0] if run.rounds else 0
    print(f"[group {replica_group}] done after {done} committed syncs",
          flush=True)


if __name__ == "__main__":
    main()
