"""Fault-tolerant HSDP training with torch (twin of
``examples/train_hsdp.py``): the GPT sharded over the ``fsdp`` and
``tensor`` axes inside each replica group, torchft-style fault tolerance
across groups.

Inside a group, every parameter is cut by ``tp_rules_gpt`` and the fsdp
rule into pieces over the group's mesh (``parallel/sharding.py``) and the
mesh's positions run in lock-step (``models.transformer.ShardedGPT``:
fsdp gathers and reduce-scatters, Megatron's column and row splits, the
vocab-parallel loss); across groups, gradients average through the
Manager over TCP. A relaunched group heals through the sharded checkpoint
path: it fetches only the bounds of its own pieces and lands each on its
piece's device (``CheckpointServer(template_fn=...)``).

Run one replica group per process (repeat per group):

    python -m torchft_tpu_torch.lighthouse_cli --min_replicas 1 &
    REPLICA_GROUP_ID=0 TORCHFT_TPU_LIGHTHOUSE=http://host:29510 \\
        python -m torchft_tpu_torch.examples.train_hsdp

``REPLICA_GROUP_ID``, ``TOTAL_STEPS`` (30), ``MODEL`` ("tiny"), ``RANK``
and ``WORLD_SIZE`` as the reference. The mesh spans the visible cards,
``tensor = 2`` when their count is even and ``fsdp`` the rest;
``MESH_DEVICES=n`` lays it over n positions of the one device instead (a
virtual mesh, the reference's ``--xla_force_host_platform_device_count``).
It runs on CUDA (``DEVICE=cpu`` for the CPU). The loop is the reference's:
DDP, ``OptimizerWrapper`` over AdamW (3e-4) in optax's order, stepped on
the pieces (``optim.TransformationOptimizer``), batches of 8 from
``np.random.default_rng(group)``. ``TORCHFT_TPU_DONATE_UPDATE=1`` picks
the wrapper's decide-then-apply arm, for a model that barely fits: no
transient backup of the parameters and state, the barrier RPC exposed.

``train_hsdp_group`` is one group's loop as a function;
``run_hsdp_drill`` drives two groups in threads through a kill of group 1
after its third commit, its restart from a poisoned init and its heal into
its sharded template, and checks every piece of both groups (parameters
and AdamW moments) bitwise at every step both commit.
"""

from __future__ import annotations

import dataclasses
import gc
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
from torchft_tpu_torch.models import CONFIGS, ShardedGPT, TransformerConfig
from torchft_tpu_torch.models.transformer import _tree_get
from torchft_tpu_torch.ops.flash import check_head_dim
from torchft_tpu_torch.optim import (
    OptimizerWrapper,
    TransformationOptimizer,
    adamw,
)
from torchft_tpu_torch.parallel import ShardedTensor, ft_mesh
from torchft_tpu_torch.utils.device import resolve_device
from torchft_tpu_torch.utils.serialization import (
    is_tensor_leaf,
    tree_flatten_with_path,
)

logger = logging.getLogger(__name__)

__all__ = ["default_axes", "hsdp_mesh", "run_hsdp_drill", "state_bytes",
           "train_hsdp_group"]


def default_axes(n: int) -> Dict[str, int]:
    """The reference's in-group mesh over ``n`` devices: ``tensor = 2``
    when ``n`` is even, ``fsdp`` the rest."""
    tensor = 2 if n % 2 == 0 else 1
    return {"fsdp": n // tensor, "tensor": tensor}


def hsdp_mesh(axes: Dict[str, int], device: torch.device):
    """The group's mesh of ``axes``: one card a position over ``cuda:0``
    .. when ``device`` is a card and there are cards enough, else the
    positions of ``device`` (a virtual mesh)."""
    n = int(np.prod(list(axes.values())))
    if device.type == "cuda" and n <= torch.cuda.device_count():
        return ft_mesh(axes, devices=[torch.device("cuda", i)
                                      for i in range(n)])
    return ft_mesh(axes, devices=[device] * n)


def state_bytes(state: Any) -> int:
    """Bytes of a state's tensor leaves: what a heal of it moves."""
    total = 0
    for _, leaf in tree_flatten_with_path(state)[0]:
        if isinstance(leaf, ShardedTensor):
            total += leaf.nbytes
        elif isinstance(leaf, torch.Tensor):
            total += leaf.numel() * leaf.element_size()
        elif is_tensor_leaf(leaf):
            total += int(leaf.nbytes)
    return total


def _state_tensors(model: ShardedGPT, optimizer) -> List[torch.Tensor]:
    """Every piece, then every piece's AdamW state, in a fixed order: what
    a heal must carry bitwise."""
    out = [p.detach() for p in model.parameters()]
    for p in model.parameters():
        out += [v for _, v in sorted(optimizer.state[p].items())]
    return out


def train_hsdp_group(
    cfg: TransformerConfig,
    mesh,
    *,
    replica_group: int,
    model_fn: Callable[..., ShardedGPT] = ShardedGPT,
    params: Any = None,
    total_steps: int,
    lighthouse_addr: Optional[str] = None,
    device: "Optional[str | torch.device]" = None,
    batch_size: int = 8,
    init_seed: int = 0,
    fail_at_step: Optional[int] = None,
    rank: int = 0,
    world_size: int = 1,
    on_start: Optional[Callable[[Manager], None]] = None,
    on_commit: Optional[Callable[..., None]] = None,
    on_heal: Optional[Callable[[Dict[str, Any], ShardedGPT], None]] = None,
    stop: Optional[threading.Event] = None,
    timeout: float = 60.0,
    donate_update: bool = False,
) -> GroupRun:
    """Train replica group ``replica_group`` until ``total_steps`` steps
    are committed (or ``stop`` is set), its GPT sharded over ``mesh`` (a
    ``parallel.mesh.Mesh`` of ``device``'s kind, :func:`hsdp_mesh`).

    ``model_fn(cfg, mesh, params=..., seed=...)`` builds the sharded model
    (``ShardedGPT``, or another with its state API, as
    ``models.ShardedMoETransformer``). ``params``: whole leaves to start
    from (a tree in the reference's structure), else ``init_seed``: the
    weights' draw. ``fail_at_step``: raise
    :class:`InjectedFailure` at the top of the first step that starts with
    that many steps committed; the model, the optimizer and the staged
    checkpoint are released first. ``on_start(manager)`` runs once the
    manager exists, ``on_commit(step, manager, model, optimizer, loss)``
    after every commit, ``on_heal(state, model)`` with a healed state
    before it is loaded. ``donate_update``: ``OptimizerWrapper``'s arm. A
    CUDA run of a config whose head_dim the flash kernels do not take
    raises ValueError here."""
    device = resolve_device(device)
    if device.type == "cuda":
        check_head_dim(f"train_hsdp_group: config with d_model "
                       f"{cfg.d_model} and {cfg.n_heads} heads", cfg.head_dim)
    model = model_fn(cfg, mesh, params=params, seed=init_seed)
    optimizer = TransformationOptimizer(model.parameters(), adamw(3e-4))
    first = torch.device(mesh.devices.flat[0])

    def state_dict():
        return model.state_tree(optimizer)

    def load_state_dict(sd):
        # a sharded heal: the leaves arrive in this group's own layout
        if on_heal is not None:
            on_heal(sd, model)
        model.load_state_tree(sd, optimizer)

    # template_fn -> the heal fetches only the bounds of this group's pieces
    transport = CheckpointServer(
        timeout=timeout,
        template_fn=lambda: {"user": state_dict(),
                             "torchft": {"step": 0, "batches_committed": 0}})
    store = StoreServer()
    manager = Manager(
        comm=TcpCommContext(timeout=timeout),
        load_state_dict=load_state_dict,
        state_dict=state_dict,
        checkpoint_transport=transport,
        min_replica_size=1,
        timeout=timeout,
        quorum_timeout=timeout,
        connect_timeout=timeout,
        rank=rank,
        world_size=world_size,
        store_addr=store.addr,
        lighthouse_addr=lighthouse_addr,
        replica_id=f"hsdp_{replica_group}_",
        heartbeat_interval=0.05,
    )
    ddp = DistributedDataParallel(manager)
    opt = OptimizerWrapper(manager, optimizer, donate_update=donate_update)
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
                device=first)
            targets = torch.roll(tokens, -1, dims=1)
            t0 = time.perf_counter()
            opt.begin_step()
            run.passes += 1
            with manager.metrics.timed("forward_backward"):
                loss = model.loss(tokens, targets)
                loss.backward()
                if first.type == "cuda":
                    for dev in {torch.device(d) for d in mesh.devices.flat}:
                        torch.cuda.current_stream(dev).synchronize()
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
        transport.disallow_checkpoint()  # drops the staged state
        manager.shutdown(wait=False)
        store.shutdown()
        # a failed group's frames outlive this call in its traceback:
        # release the model, its optimizer and DDP's buffers here
        del model, optimizer, opt, ddp
    return run


def run_hsdp_drill(
    config: TransformerConfig,
    axes: Dict[str, int],
    steps: int = 7,
    kill_after: int = 3,
    device: "Optional[str | torch.device]" = None,
    layers: Optional[int] = None,
    *,
    batch_size: int = 8,
    seed: int = 0,
    model_fn: Callable[..., ShardedGPT] = ShardedGPT,
    params: Any = None,
    timeout: float = 60.0,
    log: Callable[[str], None] = logger.info,
) -> Dict[str, Any]:
    """Two replica groups in threads under an in-process lighthouse, each
    a GPT of ``config`` (``layers`` cuts its depth; ``model_fn`` another
    sharded model, as :func:`train_hsdp_group`) sharded over
    :func:`hsdp_mesh` of ``axes`` (virtual on ``device`` unless there are
    cards for it), starting from ``params`` (else the ``seed`` draw), on a
    fixed schedule (k = ``kill_after``):

    - both groups commit steps 1..k;
    - group 1 fails; group 0 commits k + 1 alone;
    - group 1 restarts from a poisoned init (another seed) at step 0, heals
      from group 0 into its sharded template in its first step and
      commits k + 2 with it;
    - both commit up to ``steps``, and stop.

    At every step both commit, the two groups meet in their commit hooks
    and every piece (parameters and AdamW state) of one must equal the
    other's, bitwise; the failed group's model, optimizer and staged
    state are released (and the device's cache emptied) before it
    restarts. Raises AssertionError on any difference, a heal at another
    step, a healed leaf without the healer's sharding, heal wire bytes
    other than the state's, or a non-finite loss. Returns the groups' last
    runs (``runs``) and all lives, the heal step, the steps both committed
    (``checked_steps``), the restarted group's heal gauges and wire bytes
    beside its state's (``heal``), the passes of all runs, the bytes of
    pieces per mesh position and the drill's wall time (``seconds``)."""
    if steps < kill_after + 2:
        raise ValueError(f"{steps} steps leave no joint step after a heal "
                         f"at {kill_after + 2}")
    t_start = time.perf_counter()
    cfg = config if layers is None else dataclasses.replace(config,
                                                            n_layers=layers)
    dev = resolve_device(device)
    lighthouse = Lighthouse(min_replicas=1, heartbeat_timeout_ms=1000,
                            join_timeout_ms=200)
    addr = lighthouse.address()
    heal_step = kill_after + 2
    ahead, stop = threading.Event(), threading.Event()
    lives: Dict[int, List[GroupRun]] = {0: [], 1: []}
    errors: List[BaseException] = []
    lock = threading.Lock()
    meets: Dict[int, Dict[str, Any]] = {}
    checked: List[int] = []
    healed: Dict[str, Any] = {}
    info: Dict[str, Any] = {}

    def joint(step: int) -> bool:
        return not kill_after < step < heal_step

    def on_commit(group: int):
        def _hook(step, manager, model, optimizer, loss):
            log(f"group {group} committed step {step} loss "
                f"{float(loss):.4f} participants "
                f"{manager.num_participants()}"
                + (" (healed)" if manager.did_heal() else ""))
            if "piece_bytes" not in info:
                info["piece_bytes"] = _position_bytes(model)
            if joint(step):
                # the two groups meet here: the first waits (its state
                # untouched) while the second compares every piece
                state = _state_tensors(model, optimizer)
                with lock:
                    meet = meets.setdefault(step, {"event": threading.Event(),
                                                   "state": None})
                    other = meet["state"]
                    if other is None:
                        meet["state"] = state
                if other is None:
                    if not meet["event"].wait(timeout) or stop.is_set():
                        raise TimeoutError(f"group {group}: the other group "
                                           f"never committed step {step}")
                else:
                    try:
                        _require(len(other) == len(state),
                                 f"step {step}: {len(other)} state tensors "
                                 f"against {len(state)}")
                        for i, (a, b) in enumerate(zip(other, state)):
                            _require(torch.equal(a, b),
                                     f"group {group} differs at step {step} "
                                     f"in state tensor {i}")
                        checked.append(step)
                    finally:
                        meet["state"] = None
                        meet["event"].set()
            if group == 0 and step == heal_step - 1:
                # let group 1 restart, then take the next quorum with it
                ahead.set()
                _wait_lighthouse(addr, "participants", 1, timeout, stop)
        return _hook

    def on_heal(state, model) -> None:
        wrong = []
        for name, tree in (("params", state["params"]),
                           ("mu", state["opt"]["mu"]),
                           ("nu", state["opt"]["nu"])):
            for path in model.paths:
                got = _tree_get(tree, path)
                if not (isinstance(got, ShardedTensor)
                        and got.sharding == model.layouts[path].sharding):
                    wrong.append(f"{name}/{path}")
        healed["wrong"] = wrong
        healed["bytes"] = state_bytes(state)

    def wait_both(manager) -> None:
        _wait_lighthouse(addr, "healthy", 2, timeout, stop)

    common = dict(lighthouse_addr=addr, device=dev, batch_size=batch_size,
                  timeout=timeout, total_steps=steps, stop=stop,
                  model_fn=model_fn)

    def group0() -> None:
        lives[0].append(train_hsdp_group(
            cfg, hsdp_mesh(axes, dev), replica_group=0, init_seed=seed,
            params=params, on_start=wait_both, on_commit=on_commit(0),
            **common))

    def group1() -> None:
        try:
            train_hsdp_group(
                cfg, hsdp_mesh(axes, dev), replica_group=1, init_seed=seed,
                params=params, fail_at_step=kill_after, on_start=wait_both,
                on_commit=on_commit(1), **common)
            raise AssertionError("group 1 was never failed")
        except InjectedFailure as e:
            lives[1].append(e.run)
            log(f"injected failure: {e}; releasing its state, restarting "
                f"from a poisoned init")
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        if not ahead.wait(timeout) or stop.is_set():
            raise TimeoutError(f"group 0 never committed step "
                               f"{heal_step - 1}")
        lives[1].append(train_hsdp_group(
            cfg, hsdp_mesh(axes, dev), replica_group=1,
            init_seed=seed + 1000,
            on_commit=on_commit(1), on_heal=on_heal, **common))

    def guarded(fn):
        def _run():
            try:
                fn()
            except BaseException as e:  # noqa: BLE001 — re-raised below
                errors.append(e)
                stop.set()  # never strand the other group
                ahead.set()
                with lock:
                    for meet in meets.values():
                        meet["event"].set()
        return _run

    threads = [threading.Thread(target=guarded(fn), name=f"hsdp{g}")
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
    want_checked = [s for s in range(1, steps + 1) if joint(s)]
    _require(restarted.healed_at == [heal_step],
             f"the restarted group healed at {restarted.healed_at}, not at "
             f"step {heal_step}")
    _require(sorted(checked) == want_checked,
             f"groups compared at steps {sorted(checked)}, want "
             f"{want_checked}")
    _require(not healed.get("wrong"),
             f"healed leaves without the healer's sharding: "
             f"{healed.get('wrong')}")
    wire = restarted.metrics.get("heal_wire_bytes")
    _require(wire == healed.get("bytes"),
             f"the heal moved {wire} wire bytes, the state holds "
             f"{healed.get('bytes')}")
    losses = [v for runs in lives.values() for r in runs
              for v in r.losses.values()]
    _require(all(math.isfinite(v) for v in losses), "non-finite loss")
    return {
        "runs": {g: runs[-1] for g, runs in lives.items()}, "lives": lives,
        "heal_step": heal_step, "checked_steps": sorted(checked),
        "heal": {"heal_wall_ms": restarted.metrics.get("heal_wall_ms"),
                 "heal_bytes_per_s": restarted.metrics.get(
                     "heal_bytes_per_s"),
                 "wire_bytes": wire, "state_bytes": healed.get("bytes")},
        "passes": sum(r.passes for runs in lives.values() for r in runs),
        "piece_bytes": info.get("piece_bytes"),
        "seconds": time.perf_counter() - t_start,
    }


def _position_bytes(model: ShardedGPT) -> List[int]:
    """Bytes of parameter pieces each mesh position holds."""
    out = [0] * model.mesh.size
    for path in model.paths:
        layout = model.layouts[path]
        for pos in range(model.mesh.size):
            p = layout.piece_at(pos)
            out[pos] += p.numel() * p.element_size()
    return out


def main(mesh_devices: Optional[int] = None) -> None:
    logging.basicConfig(level=os.environ.get("LOGLEVEL", "WARNING"),
                        format="%(asctime)s %(name)s: %(message)s")
    replica_group = int(os.environ.get("REPLICA_GROUP_ID", "0"))
    total_steps = int(os.environ.get("TOTAL_STEPS", "30"))
    cfg = CONFIGS[os.environ.get("MODEL", "tiny")]
    device = resolve_device(os.environ.get("DEVICE"))
    if mesh_devices is None and "MESH_DEVICES" in os.environ:
        mesh_devices = int(os.environ["MESH_DEVICES"])
    if mesh_devices is not None:
        mesh = ft_mesh(default_axes(mesh_devices),
                       devices=[device] * mesh_devices)
    else:
        n = torch.cuda.device_count() if device.type == "cuda" else 1
        mesh = hsdp_mesh(default_axes(n), device)

    def on_commit(step, manager, model, optimizer, loss):
        print(f"[group {replica_group}] step {step} loss {float(loss):.4f} "
              f"participants {manager.num_participants()}", flush=True)

    train_hsdp_group(
        cfg, mesh, replica_group=replica_group, total_steps=total_steps,
        device=device, rank=int(os.environ.get("RANK", "0")),
        world_size=int(os.environ.get("WORLD_SIZE", "1")),
        on_commit=on_commit,
        # the HBM-bound shape: decide first, no transient backup
        donate_update=os.environ.get("TORCHFT_TPU_DONATE_UPDATE") == "1")
    print(f"[group {replica_group}] done")


if __name__ == "__main__":
    main()
