"""Fault-tolerant long-context training with torch (twin of
``examples/train_llama_ring.py``): Llama + ring attention + chunked cross
entropy + the FT manager loop, composed in one trainer.

The sequence is split over the ``seq`` axis of the group's in-group mesh:
K/V blocks rotate around the ring while each shard attends to the blocks
passing through it (``parallel/ring.py``: the einsum ring by default, the
flash-block ring with ``RING_IMPL=flash``), the Llama family supplies
RMSNorm/RoPE/SwiGLU/GQA, the loss never materializes [B, S, V] logits
(the online logsumexp over 4 vocab chunks), and gradients average across
replica groups through the Manager, so killing a group shrinks the quorum
and survivors keep committing.

Run one replica group per process (repeat per group):

    python -m torchft_tpu_torch.lighthouse_cli --min_replicas 1 &
    REPLICA_GROUP_ID=0 SEQ_SHARDS=4 RING_IMPL=flash \\
    TORCHFT_TPU_LIGHTHOUSE=http://host:29510 \\
        python -m torchft_tpu_torch.examples.train_llama_ring

``TOTAL_STEPS`` (20) and ``SEQ_LEN`` (256) as the reference. The ``seq``
axis has ``SEQ_SHARDS`` shards, the visible cards by default (1 on the
CPU), one card each while there are cards enough (:func:`make_seq_ring`).
Where the reference asks for ``--xla_force_host_platform_device_count``,
``SEQ_SHARDS`` larger than the cards gives a virtual mesh: the shards
share the model's card, run in lock-step and rotate without moving a
byte. It runs on CUDA (``DEVICE=cpu`` for the CPU).

The loop is the reference's: a ``Manager`` over the TCP gradient wire,
DDP, ``OptimizerWrapper`` over AdamW (3e-4) in optax's order
(``optim.adamw`` through ``optim.TransformationOptimizer``), batches of 2
drawn from ``np.random.default_rng(group)``. The state a heal moves is
``{"opt": ..., "params": llama_param_tree(model)}``, the parameters in
the reference's pytree structure.

``train_llama_ring_group`` is one group's loop as a function;
``run_llama_ring_drill`` drives two groups in threads through a kill of
group 1, its restart from a poisoned init and its heal from group 0, and
checks that both groups hold the same parameters and AdamW state, bitwise,
at every step both commit.
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

from torchft_tpu_torch.comm.store import StoreServer
from torchft_tpu_torch.comm.transport import TcpCommContext
from torchft_tpu_torch.control import Lighthouse
from torchft_tpu_torch.ddp import DistributedDataParallel
from torchft_tpu_torch.examples.train_ddp import (
    GroupRun,
    InjectedFailure,
    _require,
    _wait_lighthouse,
)
from torchft_tpu_torch.manager import Manager
from torchft_tpu_torch.models import Llama, LlamaConfig, from_jax_params
from torchft_tpu_torch.models.llama import llama_param_tree
from torchft_tpu_torch.ops.flash import check_head_dim
from torchft_tpu_torch.optim import (
    OptimizerWrapper,
    TransformationOptimizer,
    adamw,
    load_optimizer_state_dict,
)
from torchft_tpu_torch.parallel import ft_mesh, make_ring_attention
from torchft_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)

__all__ = ["example_config", "make_seq_ring", "run_llama_ring_drill",
           "train_llama_ring_group"]


def example_config(seq_len: int) -> LlamaConfig:
    """The reference example's model: "llama_tiny"'s widths at
    ``max_seq_len=seq_len``, the fused loss over 4 vocab chunks."""
    return LlamaConfig(
        vocab_size=512, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
        d_ff=176, max_seq_len=seq_len, remat=False, xent_chunks=4,
    )


def make_seq_ring(cfg: LlamaConfig, device: torch.device, seq_shards: int,
                  ring_impl: str = "einsum"):
    """The causal ring over a ``seq`` axis of ``seq_shards`` shards: one
    card each (``cuda:0``, ``cuda:1``, ...) when ``device`` is a card and
    there are that many, else ``seq_shards`` positions of ``device`` (a
    virtual mesh). Blocks of ``min(128, S / seq_shards)``, as the
    reference."""
    if cfg.max_seq_len % seq_shards:
        raise ValueError(f"seq len {cfg.max_seq_len} does not split over "
                         f"{seq_shards} shards")
    if device.type == "cuda" and seq_shards <= torch.cuda.device_count():
        devices = [torch.device("cuda", i) for i in range(seq_shards)]
    else:
        devices = [device] * seq_shards
    mesh = ft_mesh({"seq": seq_shards}, devices=devices)
    b = min(128, cfg.max_seq_len // seq_shards)
    return make_ring_attention(mesh, "seq", causal=True,
                               block_impl=ring_impl, block_q=b, block_k=b)


def _state_tensors(model: Llama, optimizer: TransformationOptimizer
                   ) -> List[torch.Tensor]:
    """The parameters, then every optimizer state tensor, in a fixed
    order: what a heal must carry bitwise."""
    out = [p.detach() for p in model.parameters()]
    for p in model.parameters():
        out += [v for _, v in sorted(optimizer.state[p].items())]
    return out


def train_llama_ring_group(
    cfg: LlamaConfig,
    *,
    replica_group: int,
    total_steps: int,
    ring_impl: str = "einsum",
    seq_shards: int = 1,
    lighthouse_addr: Optional[str] = None,
    device: "Optional[str | torch.device]" = None,
    batch_size: int = 2,
    init_seed: int = 0,
    init_state: Optional[Dict[str, torch.Tensor]] = None,
    fail_at_step: Optional[int] = None,
    on_start: Optional[Callable[[Manager], None]] = None,
    on_commit: Optional[Callable[..., None]] = None,
    stop: Optional[threading.Event] = None,
    timeout: float = 60.0,
) -> GroupRun:
    """Train replica group ``replica_group`` until ``total_steps`` steps
    are committed (or ``stop`` is set), its attention a causal ring of
    ``ring_impl`` blocks over ``seq_shards`` shards (:func:`make_seq_ring`).

    Batches: ``batch_size`` x ``max_seq_len`` tokens a step from
    ``np.random.default_rng(replica_group)``, as the reference example.
    ``init_state``: a model state dict to start from instead of the
    ``init_seed`` draw. ``fail_at_step``: raise :class:`InjectedFailure`
    at the top of the first step that starts with that many steps
    committed. ``on_start(manager)`` runs once the manager exists;
    ``on_commit(step, manager, model, optimizer, loss)`` after every
    commit. A CUDA run of a config whose head_dim the flash kernels do not
    take raises ValueError here."""
    if torch.device("cuda" if device is None else device).type == "cuda":
        check_head_dim(f"train_llama_ring_group: config with d_model "
                       f"{cfg.d_model} and {cfg.n_heads} heads", cfg.head_dim)
    device = resolve_device(device)
    ring_fn = make_seq_ring(cfg, device, seq_shards, ring_impl)
    model = Llama(cfg, device=device, seed=init_seed)
    if init_state is not None:
        model.load_state_dict(init_state)
    optimizer = TransformationOptimizer(model.parameters(), adamw(3e-4))

    def state_dict():
        return {"params": llama_param_tree(model),
                "opt": optimizer.state_dict()}

    def load_state_dict(sd):
        # copied in place, onto this group's device
        model.load_state_dict(from_jax_params(sd["params"]))
        load_optimizer_state_dict(optimizer, sd["opt"])

    store = StoreServer()
    manager = Manager(
        comm=TcpCommContext(timeout=timeout),
        load_state_dict=load_state_dict,
        state_dict=state_dict,
        min_replica_size=1,
        timeout=timeout,
        quorum_timeout=timeout,
        connect_timeout=timeout,
        rank=0,
        world_size=1,
        store_addr=store.addr,
        lighthouse_addr=lighthouse_addr,
        replica_id=f"train_llama_ring_{replica_group}_",
        heartbeat_interval=0.05,
    )
    ddp = DistributedDataParallel(manager)
    opt = OptimizerWrapper(manager, optimizer)
    run = GroupRun(replica_id=manager.replica_id())
    rng = np.random.default_rng(replica_group)
    try:
        if on_start is not None:
            on_start(manager)
        while manager.current_step() < total_steps and not (
                stop is not None and stop.is_set()):
            if (fail_at_step is not None
                    and manager.current_step() >= fail_at_step):
                raise InjectedFailure(
                    f"group {replica_group} at step {fail_at_step}", run)
            tokens = torch.as_tensor(
                rng.integers(0, cfg.vocab_size, (batch_size, cfg.max_seq_len)),
                device=device)
            targets = torch.roll(tokens, -1, dims=1)
            t0 = time.perf_counter()
            opt.begin_step()
            run.passes += 1
            with manager.metrics.timed("forward_backward"):
                loss = model.loss(tokens, targets, attn_fn=ring_fn)
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
            logger.warning(f"group {replica_group}: loss readback failed: "
                           f"{e}")
        run.metrics = manager.metrics.snapshot()
        manager.shutdown(wait=False)
        store.shutdown()
    return run


def run_llama_ring_drill(
    cfg: LlamaConfig,
    *,
    ring_impl: str = "einsum",
    seq_shards: int = 4,
    kill_step: int = 3,
    steps_alone: int = 1,
    steps_after: int = 2,
    device: "Optional[str | torch.device]" = None,
    batch_size: int = 2,
    seed: int = 0,
    init_state: Optional[Dict[str, torch.Tensor]] = None,
    timeout: float = 60.0,
    log: Callable[[str], None] = logger.info,
) -> Dict[str, Any]:
    """Two replica groups in threads under an in-process lighthouse, on a
    fixed schedule (k = ``kill_step``, s = ``steps_alone``, a =
    ``steps_after``):

    - both groups commit steps 1..k;
    - group 1 fails; group 0 commits k + 1..k + s alone;
    - group 1 restarts from a poisoned init (another seed) at step 0, heals
      from group 0 in its first step and commits k + s + 1 with it;
    - both commit k + s + 2..k + s + 1 + a, and stop.

    Both groups start from ``init_state`` (or the ``seed`` draw). The
    groups wait for each other at the lighthouse where the schedule needs
    it, so every run makes the same forward/backward passes: 2 (k + s + 1
    + a) - s (13 at the defaults).

    At every committed step the first group to commit it keeps a copy of
    its parameters and AdamW state, and the other, if it commits the step,
    must hold the same bits. Raises AssertionError on any difference, a
    heal of the restarted group at another step, or a non-finite loss.
    Returns the groups' last runs (``runs``) and all lives (``lives``),
    the heal step, the groups compared at each step (``compared``), the
    steps both committed (``checked_steps``), the restarted group's heal
    gauges (``heal``), the passes of all runs and the drill's wall time
    (``seconds``)."""
    t_start = time.perf_counter()
    lighthouse = Lighthouse(min_replicas=1, heartbeat_timeout_ms=1000,
                            join_timeout_ms=200)
    addr = lighthouse.address()
    heal_step = kill_step + steps_alone + 1
    total = heal_step + steps_after
    ahead, stop = threading.Event(), threading.Event()
    lives: Dict[int, List[GroupRun]] = {0: [], 1: []}
    errors: List[BaseException] = []
    lock = threading.Lock()
    held: Dict[int, List[torch.Tensor]] = {}
    compared: Dict[int, int] = {}

    def expected(step: int) -> int:
        return 1 if kill_step < step < heal_step else 2

    def on_commit(group: int):
        def _hook(step, manager, model, optimizer, loss):
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
                                 f"group {group} differs at step {step} in "
                                 f"state tensor {i}")
                    compared[step] += 1
                if compared[step] == expected(step):
                    del held[step]
            if group == 0 and step == heal_step - 1:
                # let group 1 restart, then take the next quorum with it
                ahead.set()
                _wait_lighthouse(addr, "participants", 1, timeout, stop)
        return _hook

    def wait_both(manager) -> None:
        _wait_lighthouse(addr, "healthy", 2, timeout, stop)

    common = dict(ring_impl=ring_impl, seq_shards=seq_shards,
                  lighthouse_addr=addr, device=device, batch_size=batch_size,
                  timeout=timeout, total_steps=total, stop=stop)

    def group0() -> None:
        lives[0].append(train_llama_ring_group(
            cfg, replica_group=0, init_seed=seed, init_state=init_state,
            on_start=wait_both, on_commit=on_commit(0), **common))

    def group1() -> None:
        try:
            train_llama_ring_group(
                cfg, replica_group=1, init_seed=seed, init_state=init_state,
                fail_at_step=kill_step, on_start=wait_both,
                on_commit=on_commit(1), **common)
            raise AssertionError("group 1 was never failed")
        except InjectedFailure as e:
            lives[1].append(e.run)
            log(f"injected failure: {e}; restarting from a poisoned init")
        if not ahead.wait(timeout) or stop.is_set():
            raise TimeoutError(f"group 0 never committed step "
                               f"{heal_step - 1}")
        lives[1].append(train_llama_ring_group(
            cfg, replica_group=1, init_seed=seed + 1000,
            on_commit=on_commit(1), **common))

    def guarded(fn):
        def _run():
            try:
                fn()
            except BaseException as e:  # noqa: BLE001 — re-raised below
                errors.append(e)
                stop.set()  # never strand the other group
                ahead.set()
        return _run

    threads = [threading.Thread(target=guarded(fn), name=f"llama{g}")
               for g, fn in enumerate((group0, group1))]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        lighthouse.shutdown()
    if errors:
        raise errors[0]

    restarted = lives[1][-1]
    _require(restarted.healed_at == [heal_step],
             f"the restarted group healed at {restarted.healed_at}, not at "
             f"step {heal_step}")
    _require(not held and compared == {s: expected(s)
                                       for s in range(1, total + 1)},
             f"groups compared per step {compared}, left {sorted(held)}")
    losses = [v for runs in lives.values() for r in runs
              for v in r.losses.values()]
    _require(all(math.isfinite(v) for v in losses), "non-finite loss")
    return {
        "runs": {g: runs[-1] for g, runs in lives.items()}, "lives": lives,
        "heal_step": heal_step, "compared": dict(sorted(compared.items())),
        "checked_steps": [s for s in range(1, total + 1)
                          if compared[s] == 2],
        "heal": {k: restarted.metrics.get(k) for k in
                 ("heal_wall_ms", "heal_bytes_per_s")},
        "passes": sum(r.passes for runs in lives.values() for r in runs),
        "seconds": time.perf_counter() - t_start,
    }


def main() -> None:
    logging.basicConfig(level=os.environ.get("LOGLEVEL", "WARNING"),
                        format="%(asctime)s %(name)s: %(message)s")
    replica_group = int(os.environ.get("REPLICA_GROUP_ID", "0"))
    total_steps = int(os.environ.get("TOTAL_STEPS", "20"))
    seq_len = int(os.environ.get("SEQ_LEN", "256"))
    device = resolve_device(os.environ.get("DEVICE"))
    cards = torch.cuda.device_count() if device.type == "cuda" else 1
    seq_shards = int(os.environ.get("SEQ_SHARDS", cards))

    def on_commit(step, manager, model, optimizer, loss):
        print(f"[group {replica_group}] step {step} loss {float(loss):.4f} "
              f"participants {manager.num_participants()}", flush=True)

    train_llama_ring_group(
        example_config(seq_len), replica_group=replica_group,
        total_steps=total_steps,
        ring_impl=os.environ.get("RING_IMPL", "einsum"),
        seq_shards=seq_shards, device=device, on_commit=on_commit)
    print(f"[group {replica_group}] done")


if __name__ == "__main__":
    main()
