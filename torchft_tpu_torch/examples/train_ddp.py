"""Fault-tolerant DDP training of the GPT with torch (twin of the
non-sharded, non-fused arm of ``examples/train_ddp.py``).

Run one replica group per process (repeat per group):

    python -m torchft_tpu_torch.lighthouse_cli --min_replicas 1 &
    REPLICA_GROUP_ID=0 NUM_REPLICA_GROUPS=2 MODEL=125m \\
    TORCHFT_TPU_LIGHTHOUSE=http://host:29510 \\
        python -m torchft_tpu_torch.examples.train_ddp

Kill any replica group at any time: survivors keep committing; the
relaunched group heals from a live peer and rejoins. The loop below needs
no failure-handling code for that. It runs on CUDA (``DEVICE=cpu`` for the
CPU).

``train_group`` is the loop as a function; ``run_kill_and_heal`` drives two
groups in threads through a failure, a restart from a poisoned init and a
heal, on a fixed schedule of steps, and checks that the healed group is
bitwise equal to its donor. Both take ``comm_backend`` and ``comm_options``
for the Manager: the default is the TCP gradient wire; ``comm_backend=
"cuda"`` with e.g. ``comm_options={"algorithm": "psum", "compression":
"int8"}`` reduces on the training device instead (comm/cuda_backend.py),
where groups that share a process share the device's plans.
"""

from __future__ import annotations

import json
import logging
import math
import os
import threading
import time
import urllib.request
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from torchft_tpu_torch.comm.cuda_backend import default_device_pool
from torchft_tpu_torch.comm.store import StoreServer
from torchft_tpu_torch.control import Lighthouse
from torchft_tpu_torch.data import DistributedSampler
from torchft_tpu_torch.ddp import DistributedDataParallel
from torchft_tpu_torch.manager import Manager
from torchft_tpu_torch.models import CONFIGS, GPT, TransformerConfig
from torchft_tpu_torch.ops.flash import check_head_dim
from torchft_tpu_torch.optim import OptimizerWrapper
from torchft_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)

__all__ = ["InjectedFailure", "GroupRun", "run_kill_and_heal", "train_group"]


class InjectedFailure(Exception):
    """Raised by ``train_group`` at ``fail_at_step``: a simulated crash.
    ``run`` is what the group did until then."""

    def __init__(self, msg: str, run: "GroupRun") -> None:
        super().__init__(msg)
        self.run = run


@dataclass
class GroupRun:
    """What one replica group did: loss and wall time per committed step
    (keyed by the step count after the commit), the step count after each
    step in which it applied a healed state, its forward/backward passes
    (committed or not), its committed steps whose gradient wire had a peer
    (``wire_steps``), the element counts of DDP's gradient buckets, and
    its final metrics."""

    passes: int = 0
    wire_steps: int = 0
    buckets: List[int] = field(default_factory=list)
    losses: Dict[int, float] = field(default_factory=dict)
    step_seconds: Dict[int, float] = field(default_factory=dict)
    participants: Dict[int, int] = field(default_factory=dict)
    healed_at: List[int] = field(default_factory=list)
    # the manager's metrics snapshot at the end (phase timers, heal gauges)
    metrics: Dict[str, object] = field(default_factory=dict)


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
    on_commit: Optional[Callable[[int, Manager, GPT, float], None]] = None,
    stop: Optional[threading.Event] = None,
    timeout: float = 60.0,
    rank: int = 0,
    world_size: int = 1,
    store_addr: Optional[str] = None,
    comm_backend: str = "host",
    comm_options: Optional[Dict[str, Any]] = None,
) -> GroupRun:
    """Train one replica group until ``total_steps`` steps are committed
    (or ``stop`` is set).

    ``fail_at_step``: raise :class:`InjectedFailure` (after shutting this
    group's manager and store down) at the top of the first step that
    starts with ``fail_at_step`` or more steps committed. ``init_state``: a
    model state dict to start from instead of the ``init_seed`` draw.
    ``on_start(manager)`` runs once the manager exists; ``on_commit(step,
    manager, model, loss)`` after every commit. ``comm_backend`` /
    ``comm_options``: the Manager's data plane; the cuda plane reduces on
    ``device`` unless ``comm_options`` names a ``device_pool``.

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
    optimizer = torch.optim.AdamW(model.parameters(), lr=3e-4,
                                  weight_decay=1e-4)
    # synthetic next-token dataset, sharded across groups x local ranks
    rng = np.random.default_rng(data_seed)
    dataset = rng.integers(0, cfg.vocab_size, (dataset_size, cfg.max_seq_len))
    sampler = DistributedSampler(
        len(dataset), replica_group=replica_group,
        num_replica_groups=num_groups, rank=rank, num_replicas=world_size,
        shuffle=True, seed=1,
    )

    def state_dict():
        return {"model": model.state_dict(), "optim": optimizer.state_dict(),
                "sampler": sampler.state_dict()}

    def load_state_dict(sd):
        model.load_state_dict(sd["model"])
        optimizer.load_state_dict(sd["optim"])
        sampler.load_state_dict(sd["sampler"])

    # per-group rendezvous store: rank 0 binds it
    store = StoreServer() if rank == 0 and store_addr is None else None
    manager = Manager(
        comm_backend=comm_backend,
        comm_options=comm_options,
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
        replica_id=f"train_ddp_{replica_group}_",
        heartbeat_interval=0.05,
    )
    ddp = DistributedDataParallel(manager)
    opt = OptimizerWrapper(manager, optimizer)
    run = GroupRun()
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

    try:
        if on_start is not None:
            on_start(manager)
        while manager.current_step() < total_steps and not (
                stop is not None and stop.is_set()):
            if (fail_at_step is not None
                    and manager.current_step() >= fail_at_step):
                raise InjectedFailure(
                    f"group {replica_group} at step {fail_at_step}", run
                )
            tokens, targets = next_batch()
            t0 = time.perf_counter()
            opt.begin_step()
            run.passes += 1
            with manager.metrics.timed("forward_backward"):
                loss = model.loss(tokens, targets)
                loss.backward()
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
            ddp.average_gradients(model)
            committed = opt.step()
            loss_value = loss.detach().item()  # waits for the device
            step = manager.current_step()
            if manager.did_heal():
                run.healed_at.append(step)
            if not committed:
                continue
            run.losses[step] = loss_value
            run.step_seconds[step] = time.perf_counter() - t0
            run.participants[step] = manager.num_participants()
            if manager.transport_world_size() > 1:
                run.wire_steps += 1
            if on_commit is not None:
                on_commit(step, manager, model, loss_value)
    finally:
        run.metrics = manager.metrics.snapshot()
        run.buckets = ddp.bucket_sizes()
        manager.shutdown(wait=False)
        if store is not None:
            store.shutdown()
    return run


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def _wait_lighthouse(addr: str, key: str, count: int, timeout: float,
                     stop: threading.Event) -> None:
    """Wait until the lighthouse's ``/status.json`` counts at least
    ``count`` ``key`` (``healthy`` heartbeating replicas, or
    ``participants`` waiting in a quorum request)."""
    deadline = time.monotonic() + timeout
    while True:
        with urllib.request.urlopen(f"{addr}/status.json",
                                    timeout=timeout) as r:
            if json.load(r)["jobs"]["default"][key] >= count:
                return
        if stop.is_set():
            raise RuntimeError("the other replica group failed")
        if time.monotonic() > deadline:
            raise TimeoutError(f"lighthouse never counted {count} {key}")
        time.sleep(0.01)


def run_kill_and_heal(
    cfg: TransformerConfig,
    *,
    kill_step: int = 3,
    steps_after: int = 2,
    device: "Optional[str | torch.device]" = None,
    batch_size: int = 8,
    seed: int = 0,
    timeout: float = 60.0,
    log: Callable[[str], None] = logger.info,
    comm_backend: str = "host",
    comm_options: Optional[Dict[str, Any]] = None,
) -> Dict[str, object]:
    """Two replica groups under an in-process lighthouse, on a fixed
    schedule (k = ``kill_step``, a = ``steps_after``):

    - both groups commit steps 1..k together;
    - group 1 fails; group 0 commits step k + 1 alone;
    - group 1 restarts from a poisoned init (another seed) at step 0, heals
      from group 0 in its first step and commits step k + 2 with it;
    - both commit steps k + 3..k + 2 + a together, and stop.

    Each group waits for the other at the lighthouse where the schedule
    needs it (both heartbeating before the first quorum; the restarted
    group's quorum request pending before group 0 asks for step k + 2), so
    every run makes the same 2k + 2a + 3 forward/backward passes.

    The gradient wire has a peer in k + 1 + a of those steps (all but the
    survivor's solo step k + 1); ``comm_backend`` / ``comm_options`` select
    it as for :func:`train_group`.

    Raises AssertionError unless the healed group's parameters equal the
    donor's bitwise at every step from the heal on, and every loss is
    finite. Returns the per-group runs (group 1's restarted one), the heal
    step, the checked steps and the forward/backward passes of all runs."""
    lighthouse = Lighthouse(min_replicas=1, join_timeout_ms=200,
                            heartbeat_timeout_ms=1000)
    addr = lighthouse.address()
    total = kill_step + 2 + steps_after
    survivor_ahead, stop = threading.Event(), threading.Event()
    snapshots: Dict[int, Dict[int, List[torch.Tensor]]] = {0: {}, 1: {}}
    runs: Dict[int, List[GroupRun]] = {0: [], 1: []}
    errors: List[BaseException] = []

    def both_heartbeating(manager):
        _wait_lighthouse(addr, "healthy", 2, timeout, stop)

    def on_commit(group: int):
        def _hook(step, manager, model, loss):
            log(f"group {group} committed step {step} loss {loss:.4f} "
                f"participants {manager.num_participants()}"
                + (" (healed)" if manager.did_heal() else ""))
            if step > kill_step:
                snapshots[group][step] = [
                    p.detach().clone() for p in model.parameters()
                ]
            if group == 0 and step == kill_step + 1:
                # let group 1 restart, and take the next quorum with it
                survivor_ahead.set()
                _wait_lighthouse(addr, "participants", 1, timeout, stop)
        return _hook

    common = dict(num_groups=2, lighthouse_addr=addr, device=device,
                  batch_size=batch_size, data_seed=seed, timeout=timeout,
                  total_steps=total, stop=stop, comm_backend=comm_backend,
                  comm_options=comm_options)

    def group0():
        runs[0].append(train_group(
            cfg, replica_group=0, init_seed=seed, on_start=both_heartbeating,
            on_commit=on_commit(0), **common))

    def group1():
        try:
            train_group(cfg, replica_group=1, init_seed=seed,
                        fail_at_step=kill_step, on_start=both_heartbeating,
                        on_commit=on_commit(1), **common)
            raise AssertionError("group 1 was never failed")
        except InjectedFailure as e:
            runs[1].append(e.run)
            log(f"injected failure: {e}; restarting from a poisoned init")
        if not survivor_ahead.wait(timeout) or stop.is_set():
            raise TimeoutError(f"group 0 never committed step {kill_step + 1}")
        runs[1].append(train_group(
            cfg, replica_group=1, init_seed=seed + 1000,
            on_commit=on_commit(1), **common))

    def guarded(fn):
        def _run():
            try:
                fn()
            except BaseException as e:  # noqa: BLE001 — re-raised below
                errors.append(e)
                stop.set()  # never strand the other group
                survivor_ahead.set()
        return _run

    threads = [threading.Thread(target=guarded(f), name=f"group{i}")
               for i, f in enumerate((group0, group1))]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        lighthouse.shutdown()
    if errors:
        raise errors[0]

    survivor, restarted = runs[0][0], runs[1][1]
    _require(restarted.healed_at == [kill_step + 2],
             f"the restarted group healed at {restarted.healed_at}, not at "
             f"step {kill_step + 2}")
    heal_step = restarted.healed_at[0]
    steps = sorted(set(snapshots[0]) & set(snapshots[1]))
    _require(steps == list(range(heal_step, total + 1)),
             f"heal at {heal_step}; steps both groups committed: {steps}")
    for s in steps:
        for a, b in zip(snapshots[0][s], snapshots[1][s]):
            _require(torch.equal(a, b),
                     f"group 1 diverged from its donor at step {s}")
    losses = [v for r in (survivor, restarted) for v in r.losses.values()]
    _require(all(math.isfinite(v) for v in losses), "non-finite loss")
    return {"runs": {0: survivor, 1: restarted}, "heal_step": heal_step,
            "checked_steps": steps,
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
        print(f"[group {replica_group}] step {step} loss {loss:.4f} "
              f"participants {manager.num_participants()}", flush=True)

    store_addr = None
    if rank != 0:
        store_addr = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    train_group(
        CONFIGS[os.environ.get("MODEL", "tiny")],
        replica_group=replica_group,
        num_groups=int(os.environ.get("NUM_REPLICA_GROUPS", "2")),
        total_steps=int(os.environ.get("TOTAL_STEPS", "50")),
        device=os.environ.get("DEVICE"),
        rank=rank,
        world_size=int(os.environ.get("WORLD_SIZE", "1")),
        store_addr=store_addr,
        on_commit=on_commit,
    )
    print(f"[group {replica_group}] done", flush=True)


if __name__ == "__main__":
    main()
