"""Fault-tolerant MoE training with torch (twin of ``examples/train_moe.py``).

Run one replica group per process, each rank a process of its own (repeat
per rank and per group):

    python -m torchft_tpu_torch.lighthouse_cli --min_replicas 1 &
    REPLICA_GROUP_ID=0 NUM_REPLICA_GROUPS=2 MODEL=moe-8x125m \\
    TORCHFT_TPU_LIGHTHOUSE=http://host:29510 \\
        python -m torchft_tpu_torch.examples.train_moe

``RANK``/``WORLD_SIZE`` name the rank and its group's size,
``TOTAL_STEPS`` the steps to commit and ``MODEL`` the config (``MOE_CONFIGS``: "moe-tiny", "moe-8x125m"). It runs on CUDA
(``DEVICE=cpu`` for the CPU).

Each rank holds the whole model: the experts sit on its one device (the
reference's expert axis of width 1, which one chip gives it). The loop is
the reference's: ``Manager`` over the TCP gradient wire, DDP, AdamW
(3e-4, weight decay 1e-4) behind ``OptimizerWrapper``, and a
``CheckpointServer(template_fn=...)`` returning the live state, so a
restarted rank heals through ``checkpointing.recv_checkpoint_sharded``:
its leaves matched by path, each region striped over the donor group's
ranks (the Manager hands every donor its peers from the group store) and
uploaded to the card as it lands. All ranks of a group draw the same
batches (the data is seeded by the group), so they hold the same bits and
any of them can serve any stripe.

``train_moe_group`` is one rank's loop as a function; ``run_moe_drill``
drives two groups of two ranks in threads through a kill of one whole
group, its restart from a poisoned init and its heal, and checks that
every live rank holds the same parameters and AdamW state, bitwise, at
every committed step.
"""

from __future__ import annotations

import logging
import math
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from torchft_tpu_torch.checkpointing import CheckpointServer
from torchft_tpu_torch.comm.store import StoreServer
from torchft_tpu_torch.control import Lighthouse
from torchft_tpu_torch.ddp import DistributedDataParallel
from torchft_tpu_torch.examples.train_ddp import (
    GroupRun,
    InjectedFailure,
    _require,
    _wait_lighthouse,
)
from torchft_tpu_torch.manager import Manager
from torchft_tpu_torch.models import MOE_CONFIGS, MoETransformer
from torchft_tpu_torch.models.moe_transformer import MoETransformerConfig
from torchft_tpu_torch.ops.flash import check_head_dim
from torchft_tpu_torch.optim import (
    OptimizerWrapper,
    init_adam_state,
    load_optimizer_state_dict,
)
from torchft_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)

__all__ = ["run_moe_drill", "train_moe_group"]


def train_moe_group(
    cfg: MoETransformerConfig,
    *,
    replica_group: int,
    total_steps: int,
    rank: int = 0,
    world_size: int = 1,
    store_addr: Optional[str] = None,
    lighthouse_addr: Optional[str] = None,
    device: "Optional[str | torch.device]" = None,
    batch_size: int = 8,
    init_seed: int = 0,
    init_state: Optional[Dict[str, torch.Tensor]] = None,
    fail_at_step: Optional[int] = None,
    on_commit: Optional[Callable[..., None]] = None,
    stop: Optional[threading.Event] = None,
    timeout: float = 60.0,
) -> GroupRun:
    """One rank of replica group ``replica_group`` trains until
    ``total_steps`` steps are committed (or ``stop`` is set).

    Batches: ``batch_size`` x ``max_seq_len`` tokens a step from
    ``np.random.default_rng(replica_group)``, as the reference example.
    ``init_state``: a model state dict to start from instead of the
    ``init_seed`` draw. ``fail_at_step``: raise :class:`InjectedFailure`
    at the top of the first step that starts with that many steps
    committed. ``on_commit(step, manager, model, optimizer, loss)`` runs
    after every commit. Without ``store_addr`` the rank binds its own group store. A
    CUDA run of a config whose head_dim the flash kernels do not take
    raises ValueError here."""
    if torch.device("cuda" if device is None else device).type == "cuda":
        check_head_dim(f"train_moe_group: config with d_model {cfg.d_model} "
                       f"and {cfg.n_heads} heads", cfg.head_dim)
    device = resolve_device(device)
    model = MoETransformer(cfg, device=device, seed=init_seed)
    if init_state is not None:
        model.load_state_dict(init_state)
    optimizer = torch.optim.AdamW(model.parameters(), lr=3e-4,
                                  weight_decay=1e-4)
    # the state exists before the first step (as optax's), so a restarted
    # rank's template lists every leaf its donor serves
    init_adam_state(optimizer)

    def state_dict():
        return {"model": model.state_dict(), "optim": optimizer.state_dict()}

    def load_state_dict(sd):
        # the healed leaves arrive on this rank's device; copied in place
        model.load_state_dict(sd["model"])
        load_optimizer_state_dict(optimizer, sd["optim"])

    transport = CheckpointServer(
        timeout=timeout,
        template_fn=lambda: {"user": state_dict(),
                             "torchft": {"step": 0, "batches_committed": 0}},
    )
    store = StoreServer() if store_addr is None else None
    manager = Manager(
        load_state_dict=load_state_dict,
        state_dict=state_dict,
        checkpoint_transport=transport,
        min_replica_size=1,
        timeout=timeout,
        quorum_timeout=timeout,
        connect_timeout=timeout,
        rank=rank,
        world_size=world_size,
        store_addr=store.addr if store is not None else store_addr,
        lighthouse_addr=lighthouse_addr,
        replica_id=f"moe_{replica_group}_",
        heartbeat_interval=0.05,
    )
    ddp = DistributedDataParallel(manager)
    opt = OptimizerWrapper(manager, optimizer)
    run = GroupRun(replica_id=manager.replica_id())
    rng = np.random.default_rng(replica_group)
    try:
        while manager.current_step() < total_steps and not (
                stop is not None and stop.is_set()):
            if (fail_at_step is not None
                    and manager.current_step() >= fail_at_step):
                raise InjectedFailure(
                    f"group {replica_group} rank {rank} at step "
                    f"{fail_at_step}", run)
            tokens = torch.as_tensor(
                rng.integers(0, cfg.vocab_size, (batch_size, cfg.max_seq_len)),
                device=device)
            targets = torch.roll(tokens, -1, dims=1)
            t0 = time.perf_counter()
            opt.begin_step()
            run.passes += 1
            with manager.metrics.timed("forward_backward"):
                loss = model.loss(tokens, targets)
                loss.backward()
                if device.type == "cuda":
                    torch.cuda.current_stream(device).synchronize()
            ddp.average_gradients(model)
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
            run.wire_world[step] = manager.transport_world_size()
            if on_commit is not None:
                on_commit(step, manager, model, optimizer, loss)
    finally:
        try:
            run.losses.update(opt.drain())
        except Exception as e:  # noqa: BLE001 — keep the step's own error
            logger.warning(f"group {replica_group} rank {rank}: loss "
                           f"readback failed: {e}")
        run.metrics = manager.metrics.snapshot()
        manager.shutdown(wait=False)
        if store is not None:
            store.shutdown()
    return run


def _state_tensors(model, optimizer) -> List[torch.Tensor]:
    """The parameters, then every AdamW state tensor, in a fixed order."""
    out = [p.detach() for p in model.parameters()]
    for p in model.parameters():
        out += [v for _, v in sorted(optimizer.state[p].items())
                if isinstance(v, torch.Tensor)]
    return out


def run_moe_drill(
    cfg: MoETransformerConfig,
    *,
    kill_step: int = 3,
    steps_alone: int = 1,
    steps_after: int = 2,
    ranks: int = 2,
    device: "Optional[str | torch.device]" = None,
    batch_size: int = 8,
    seed: int = 0,
    init_state: Optional[Dict[str, torch.Tensor]] = None,
    timeout: float = 60.0,
    log: Callable[[str], None] = logger.info,
) -> Dict[str, Any]:
    """Two replica groups of ``ranks`` ranks each, every rank a thread
    holding the whole model, under an in-process lighthouse, on a fixed
    schedule (k = ``kill_step`` >= 2, s = ``steps_alone``, a =
    ``steps_after``):

    - group 0 commits step 1 alone; group 1 then joins and heals at step 2
      (its first quorum), and both commit 2..k;
    - every rank of group 1 fails; group 0 commits k + 1..k + s alone;
    - group 1 restarts from a poisoned init (another seed) at step 0, heals
      again and commits k + s + 1 with group 0;
    - both commit k + s + 2..k + s + 1 + a, and stop.

    Group 1 joins behind group 0 because the native manager spreads the
    step-0 bootstrap heal over ranks (rank r's donor group depends on r):
    joined at once, the two groups' ranks would heal in opposite
    directions, and the ranks of one group would average different
    gradients. Behind, every rank of group 1 heals, each from group 0's
    rank of the same number through ``recv_checkpoint_sharded``, its
    stripes spread over all of group 0's ranks (their manifests name each
    other: the Manager's fan-out from the group store).

    At every committed step the first rank to commit it keeps a copy of
    its parameters and AdamW state (on its device), and every other rank
    that commits it must hold the same bits. Raises AssertionError on any
    difference, a heal at another step, a donor rank that served nothing
    in the second heal, or a non-finite loss. Returns the ranks' last runs
    (``runs``, keyed ``(group, rank)``) and all lives (``lives``), the
    heal step, the ranks compared at each step (``compared``), the bytes
    each of group 0's ranks served in the second heal (``served``), that
    heal's gauges per healer rank (``heals``), the passes of all runs and
    the drill's wall time (``seconds``)."""
    if kill_step < 2:
        raise ValueError(f"kill_step {kill_step}: group 1 joins at step 2")
    t_start = time.perf_counter()
    lighthouse = Lighthouse(min_replicas=1, heartbeat_timeout_ms=1000,
                            join_timeout_ms=int(timeout * 1000))
    addr = lighthouse.address()
    heal_step = kill_step + steps_alone + 1
    total = heal_step + steps_after
    joined = {1: threading.Event(), heal_step - 1: threading.Event()}
    stop = threading.Event()
    donors = threading.Barrier(ranks)
    lives: Dict[tuple, List[GroupRun]] = {(g, r): [] for g in range(2)
                                          for r in range(ranks)}
    errors: List[BaseException] = []
    lock = threading.Lock()
    held: Dict[int, List[torch.Tensor]] = {}
    compared: Dict[int, int] = {}
    served: Dict[int, Dict[int, float]] = {0: {}, 1: {}}

    def expected(step: int) -> int:
        alone = step == 1 or kill_step < step < heal_step
        return ranks if alone else 2 * ranks

    def on_commit(group: int, rank: int):
        def _hook(step, manager, model, optimizer, loss):
            if rank == 0:
                log(f"group {group} committed step {step} participants "
                    f"{manager.num_participants()}"
                    + (" (healed)" if manager.did_heal() else ""))
            state = _state_tensors(model, optimizer)
            with lock:
                first = held.get(step)
                if first is None:
                    held[step] = [t.clone() for t in state]
                    compared[step] = 1
                else:
                    for i, (a, b) in enumerate(zip(first, state)):
                        _require(torch.equal(a, b),
                                 f"group {group} rank {rank} differs at step "
                                 f"{step} in state tensor {i}")
                    compared[step] += 1
                if compared[step] == expected(step):
                    del held[step]
            if group != 0:
                return
            if step in (heal_step - 1, heal_step):
                served[step - heal_step + 1][rank] = \
                    manager.metrics.snapshot().get("heal_served_bytes", 0.0)
            if step in joined:
                # group 1 starts (or restarts) now; no rank of group 0 asks
                # for the next quorum before group 1 is asking
                donors.wait(timeout)
                joined[step].set()
                _wait_lighthouse(addr, "participants", 1, timeout, stop)
        return _hook

    common = dict(device=device, batch_size=batch_size, timeout=timeout,
                  total_steps=total, stop=stop, lighthouse_addr=addr,
                  world_size=ranks, init_state=init_state)

    def group_life(group: int, life: int) -> None:
        store = StoreServer()

        def rank_main(rank: int) -> None:
            kw = dict(common, replica_group=group, rank=rank,
                      store_addr=store.addr, on_commit=on_commit(group, rank))
            try:
                if (group, life) == (1, 1):
                    kw["init_state"] = None
                    run = train_moe_group(cfg, init_seed=seed + 1000, **kw)
                else:
                    run = train_moe_group(
                        cfg, init_seed=seed,
                        fail_at_step=kill_step if group == 1 else None, **kw)
                _require((group, life) != (1, 0),
                         f"group 1 rank {rank} never failed")
            except InjectedFailure as e:
                run = e.run
            except BaseException as e:  # noqa: BLE001 — re-raised below
                errors.append(e)
                stop.set()
                for ev in joined.values():
                    ev.set()
                donors.abort()
                return
            lives[(group, rank)].append(run)

        threads = [threading.Thread(target=rank_main, args=(r,),
                                    name=f"moe{group}.{r}")
                   for r in range(ranks)]
        try:
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        finally:
            store.shutdown()

    def group1() -> None:
        for life, step in enumerate(joined):
            if not joined[step].wait(timeout) or stop.is_set():
                errors.append(TimeoutError(
                    f"group 0 never committed step {step}"))
                stop.set()
                return
            if life:
                log("injected failure: group 1 restarts from a poisoned "
                    "init")
            group_life(1, life)

    threads = [threading.Thread(target=group_life, args=(0, 0)),
               threading.Thread(target=group1)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        lighthouse.shutdown()
    if errors:
        raise errors[0]

    for r in range(ranks):
        for life, want in ((0, 2), (1, heal_step)):
            got = lives[(1, r)][life].healed_at
            _require(got == [want], f"group 1 rank {r} healed at {got} in "
                                    f"life {life}, not at step {want}")
    _require(not held and compared == {
        s: expected(s) for s in range(1, total + 1)},
        f"ranks compared per step {compared}, left {sorted(held)}")
    second = {r: served[1][r] - served[0].get(r, 0.0) for r in served[1]}
    _require(len(second) == ranks and all(v > 0 for v in second.values()),
             f"bytes served by group 0's ranks in the second heal: {second}")
    losses = [v for runs in lives.values() for r in runs
              for v in r.losses.values()]
    _require(all(math.isfinite(v) for v in losses), "non-finite loss")
    return {
        "runs": {k: v[-1] for k, v in lives.items()}, "lives": lives,
        "heal_step": heal_step, "compared": dict(sorted(compared.items())),
        "served": dict(sorted(second.items())),
        "heals": {r: {k: lives[(1, r)][-1].metrics.get(k) for k in
                      ("heal_wall_ms", "heal_bytes_per_s", "heal_wire_bytes",
                       "heal_h2d_p50_ms")}
                  for r in range(ranks)},
        "passes": sum(r.passes for runs in lives.values() for r in runs),
        "seconds": time.perf_counter() - t_start,
    }


def main() -> None:
    logging.basicConfig(level=os.environ.get("LOGLEVEL", "WARNING"),
                        format="%(asctime)s %(name)s: %(message)s")
    replica_group = int(os.environ.get("REPLICA_GROUP_ID", "0"))
    cfg = MOE_CONFIGS[os.environ.get("MODEL", "moe-tiny")]

    def on_commit(step, manager, model, optimizer, loss):
        print(f"[group {replica_group}] step {step} loss {float(loss):.4f} "
              f"participants {manager.num_participants()}", flush=True)

    run = train_moe_group(
        cfg, replica_group=replica_group,
        total_steps=int(os.environ.get("TOTAL_STEPS", "30")),
        rank=int(os.environ.get("RANK", "0")),
        world_size=int(os.environ.get("WORLD_SIZE", "1")),
        device=os.environ.get("DEVICE"), on_commit=on_commit)
    print(f"[group {replica_group}] done after {len(run.step_seconds)} "
          "committed steps")


if __name__ == "__main__":
    main()
