"""HSDP and TP composed with the port's Manager: kills and sharded heals.

Twins of ``tests/test_integration_hsdp.py``'s and
``tests/test_integration_tp.py``'s drills: replica groups whose state is
sharded over an in-group mesh (here a virtual ``["cpu"] * n`` mesh, its
pieces ``ShardedTensor`` s) average gradients through the Manager over
TCP; one group is killed and heals through the sharded checkpoint path,
its healed leaves landing in its own layout. The trajectories of the
groups must agree at every step both commit, within the reference's
tolerance (rtol 1e-5, atol 1e-6). Then the example's own drill,
``run_hsdp_drill``, at "tiny" on the CPU (the kill, the heal, every piece
bitwise at every joint step, the healed leaves' sharding, the heal's wire
bytes equal to the state's), its mesh selection, and the example run as
a process on a virtual mesh.
"""

import logging
import os
import subprocess
import sys
import threading
import time
from typing import Dict

import numpy as np
import pytest
import torch

import torchft_tpu_torch.checkpointing as cp
from torchft_tpu_torch.comm.store import StoreServer
from torchft_tpu_torch.comm.transport import TcpCommContext
from torchft_tpu_torch.control import Lighthouse
from torchft_tpu_torch.manager import Manager
from torchft_tpu_torch.parallel import (
    PartitionSpec as P,
    ShardedTensor,
    ft_mesh,
    make_sharding_fn,
    shard_pytree,
    tp_rules_gpt,
)

logger = logging.getLogger(__name__)

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

D_IN, D_HID = 8, 16
D, D_FF = 8, 16


class _Killed(Exception):
    pass


def _assemble(leaf: ShardedTensor) -> torch.Tensor:
    """The whole leaf from its pieces, differentiable in each piece."""
    out = torch.zeros(leaf.shape, dtype=leaf.dtype)
    done = set()
    for piece, b in zip(leaf.pieces, leaf.bounds):
        if b not in done:
            out = out.clone()
            out[tuple(slice(a, c) for a, c in b)] = piece
            done.add(b)
    return out


def _flat(tree, prefix=""):
    out = []
    for k in sorted(tree):
        v = tree[k]
        key = f"{prefix}/{k}" if prefix else k
        out += _flat(v, key) if isinstance(v, dict) else [(key, v)]
    return out


def _unflat(items):
    tree: dict = {}
    for path, v in items:
        *keys, last = path.split("/")
        node = tree
        for k in keys:
            node = node.setdefault(k, {})
        node[last] = v
    return tree


class _Replica:
    """One replica group (or rank of one): sharded params, the FT loop of
    the reference's harness (start_quorum, grads, allreduce, should_commit,
    an SGD update of every piece)."""

    def __init__(self, *, make_params, make_mesh, shard, loss_fn, specs,
                 lr, group, rank=0, world_size=1, store_addr=None,
                 lighthouse_addr, fail_at_step=-1, on_commit,
                 stop: threading.Event, killed=None) -> None:
        self.__dict__.update(locals())
        del self.__dict__["self"]
        self.history: Dict[int, np.ndarray] = {}
        self.healed_ok = None

    def run(self, restarted: bool) -> None:
        mesh = self.make_mesh()
        holder = {"params": self.shard(self.make_params(
            99.0 if restarted else 1.0), mesh)}

        def state_dict():
            return {"params": holder["params"]}

        def load_state_dict(sd):
            ok = all(isinstance(leaf, ShardedTensor)
                     and leaf.sharding.spec == self.specs[path]
                     and leaf.sharding.mesh is mesh
                     for path, leaf in _flat(sd["params"]))
            self.healed_ok = ok if self.healed_ok is None \
                else self.healed_ok and ok
            holder["params"] = sd["params"]

        transport = cp.CheckpointServer(
            timeout=5.0, template_fn=lambda: {
                "user": state_dict(),
                "torchft": {"step": 0, "batches_committed": 0}})
        store = None
        if self.store_addr is None:
            store = StoreServer()
        manager = Manager(
            comm=TcpCommContext(timeout=5.0), load_state_dict=load_state_dict,
            state_dict=state_dict, checkpoint_transport=transport,
            min_replica_size=1, use_async_quorum=True, timeout=10.0,
            quorum_timeout=10.0, connect_timeout=10.0, rank=self.rank,
            world_size=self.world_size,
            store_addr=store.addr if store else self.store_addr,
            lighthouse_addr=self.lighthouse_addr,
            replica_id=f"hsdp_{self.group}_", heartbeat_interval=0.05)
        try:
            while not self.stop.is_set() and not (
                    self.killed is not None and self.killed.is_set()):
                if not restarted and manager.current_step() \
                        >= self.fail_at_step >= 0:
                    raise _Killed()
                try:
                    manager.start_quorum()
                    items = _flat(holder["params"])
                    pieces = [[p.detach().clone().requires_grad_(True)
                               for p in leaf.pieces] for _, leaf in items]
                    whole = {path: _assemble(leaf.like(ps))
                             for (path, leaf), ps in zip(items, pieces)}
                    self.loss_fn(whole).backward()
                    grads = [p.grad.numpy() for ps in pieces for p in ps]
                    avg = manager.allreduce_arrays(grads).future().result(20)
                    committed = manager.should_commit()
                except (TimeoutError, RuntimeError) as e:
                    logger.info("step retry g%d r%d: %s", self.group,
                                self.rank, e)
                    continue
                if not committed:
                    time.sleep(0.01)
                    continue
                it = iter(avg)
                holder["params"] = _unflat(
                    (path, leaf.like([
                        p.detach() - self.lr * torch.from_numpy(
                            np.asarray(next(it)))
                        for p in leaf.pieces]))
                    for path, leaf in _flat(holder["params"]))
                step = manager.current_step()
                first = _flat(holder["params"])[0][1]
                self.history[step] = first.full().numpy().copy()
                self.on_commit(self)
        finally:
            manager.shutdown(wait=False)
            if store is not None:
                store.shutdown()


def _run_groups(replicas_by_group, restart_after_kill, timeout=120.0):
    """Each group runs in its thread (its ranks in threads of their own),
    restarting once after a kill."""
    errors = []

    def group_main(replicas):
        restarted = False
        while True:
            killed = threading.Event()
            store = StoreServer() if len(replicas) > 1 else None

            def rank_main(r):
                try:
                    r.killed = killed
                    r.store_addr = store.addr if store else None
                    r.run(restarted)
                except _Killed:
                    killed.set()
                except Exception as e:  # noqa: BLE001
                    errors.append(e)
                    r.stop.set()

            threads = [threading.Thread(target=rank_main, args=(r,),
                                        daemon=True) for r in replicas]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout)
            if store is not None:
                store.shutdown()
            if killed.is_set() and not replicas[0].stop.is_set():
                restarted = True
                continue
            return

    threads = [threading.Thread(target=group_main, args=(rs,), daemon=True)
               for rs in replicas_by_group]
    deadline = time.monotonic() + timeout
    for t in threads:
        t.start()
    for t in threads:
        t.join(max(1.0, deadline - time.monotonic()))
    return errors


def _drill(make_params, make_mesh, shard, loss_fn, specs, lr, ranks=1,
           target=6, kill_at=3):
    lighthouse = Lighthouse(min_replicas=1, join_timeout_ms=300,
                            heartbeat_timeout_ms=1000)
    stop, lock = threading.Event(), threading.Lock()
    commits: Dict[tuple, int] = {}

    def on_commit(r):
        with lock:
            commits[(r.group, r.rank)] = commits.get((r.group, r.rank), 0) + 1
            if len(commits) == 2 * ranks and all(
                    c >= target for c in commits.values()):
                stop.set()

    groups = [[_Replica(make_params=make_params(rank),
                        make_mesh=make_mesh, shard=shard,
                        loss_fn=loss_fn(rank), specs=specs, lr=lr, group=g,
                        rank=rank, world_size=ranks,
                        lighthouse_addr=lighthouse.address(),
                        fail_at_step=kill_at if g == 1 else -1,
                        on_commit=on_commit, stop=stop)
               for rank in range(ranks)] for g in range(2)]
    try:
        errors = _run_groups(groups, True)
    finally:
        stop.set()
        lighthouse.shutdown()
    assert not errors, errors
    for g in range(2):
        for r in range(ranks):
            assert commits.get((g, r), 0) >= target, commits
    for r in range(ranks):
        # the restarted group healed, onto its own sharding
        assert groups[1][r].healed_ok is True
        h0, h1 = groups[0][r].history, groups[1][r].history
        common = sorted(set(h0) & set(h1))
        assert len(common) >= 3, f"too few common steps: {common}"
        assert [s for s in common if s > kill_at + 1], common
        for s in common:
            np.testing.assert_allclose(h0[s], h1[s], rtol=1e-5, atol=1e-6,
                                       err_msg=f"rank {r} step {s}")


def test_hsdp_ft_kill_and_sharded_heal() -> None:
    def make_params(rank):
        return lambda seed: {
            "layer1": {"w": np.full((D_IN, D_HID), seed, np.float32)},
            "layer2": {"w": np.full((D_HID, D_IN), seed / 2, np.float32)}}

    x = torch.ones(4, D_IN)

    def loss_fn(rank):
        def f(p):
            h = torch.tanh(x @ p["layer1/w"])
            return ((h @ p["layer2/w"] - 1.0) ** 2).mean()
        return f

    _drill(make_params,
           lambda: ft_mesh({"fsdp": 4}, devices=["cpu"] * 4),
           lambda t, m: shard_pytree(t, m, tp_rules=None, fsdp_axis="fsdp"),
           loss_fn, {"layer1/w": P(None, "fsdp"),
                     "layer2/w": P("fsdp", None)}, lr=0.05)


def test_hsdp_multirank_kill_and_per_rank_sharded_heal() -> None:
    # two ranks a group, each rank a thread with its own ["cpu"] * 2 fsdp
    # sub-mesh and its own, rank-distinct state: a rank-mixed heal (rank 0
    # fetching rank 1's state) would diverge at once
    def make_params(rank):
        return lambda seed: {"w": np.full((D_IN, D_HID), seed + 100.0 * rank,
                                          np.float32)}

    def loss_fn(rank):
        target = torch.full((D_IN, D_HID), 10.0 * (rank + 1))
        return lambda p: ((p["w"] - target) ** 2).mean()

    _drill(make_params, lambda: ft_mesh({"fsdp": 2}, devices=["cpu"] * 2),
           lambda t, m: shard_pytree(t, m, tp_rules=None, fsdp_axis="fsdp"),
           loss_fn, {"w": P(None, "fsdp")}, lr=0.2, ranks=2)


def test_tp_ft_kill_and_sharded_heal() -> None:
    # a {"tensor": 4} mesh under tp_rules_gpt: q/up column-parallel, o/down
    # row-parallel
    def make_params(rank):
        def f(seed):
            def full(shape, v):
                return np.full(shape, v, np.float32)
            return {"layers_0": {
                "attn": {"q_proj": {"kernel": full((D, D), seed)},
                         "o_proj": {"kernel": full((D, D), seed / 2)}},
                "mlp": {"up_proj": {"kernel": full((D, D_FF), seed / 3)},
                        "down_proj": {"kernel": full((D_FF, D),
                                                     seed / 4)}}}}
        return f

    x = torch.ones(4, D)

    def loss_fn(rank):
        def f(p):
            pre = "layers_0/"
            h = torch.tanh(x @ p[pre + "attn/q_proj/kernel"])
            h = h @ p[pre + "attn/o_proj/kernel"]
            h = torch.tanh(h @ p[pre + "mlp/up_proj/kernel"])
            return ((h @ p[pre + "mlp/down_proj/kernel"] - 1.0) ** 2).mean()
        return f

    _drill(make_params, lambda: ft_mesh({"tensor": 4}, devices=["cpu"] * 4),
           lambda t, m: shard_pytree(t, m, tp_rules=tp_rules_gpt(),
                                     fsdp_axis=None),
           loss_fn, {"layers_0/attn/q_proj/kernel": P(None, "tensor"),
                     "layers_0/attn/o_proj/kernel": P("tensor", None),
                     "layers_0/mlp/up_proj/kernel": P(None, "tensor"),
                     "layers_0/mlp/down_proj/kernel": P("tensor", None)},
           lr=0.05)


# ------------------------------------------------------- the example's drill


def test_run_hsdp_drill_at_tiny_heals_bitwise() -> None:
    from torchft_tpu_torch.examples.train_hsdp import run_hsdp_drill
    from torchft_tpu_torch.models import CONFIGS

    result = run_hsdp_drill(CONFIGS["tiny"], {"fsdp": 2, "tensor": 2},
                            steps=7, kill_after=3, device="cpu",
                            batch_size=8, timeout=30.0)
    # kill after 3, group 0 alone at 4, the heal at 5, both at 5-7
    assert result["heal_step"] == 5
    assert result["checked_steps"] == [1, 2, 3, 5, 6, 7]
    assert result["passes"] == 13
    runs = result["runs"]
    assert runs[1].healed_at == [5]
    assert runs[0].participants[4] == 1 and runs[0].participants[6] == 2
    heal = result["heal"]
    # parameters and both moments (3 x the 4 bytes of tiny's parameters)
    # and the step count's 4 bytes, each region once
    n = sum(int(np.prod(s)) for s in _tiny_shapes())
    assert heal["wire_bytes"] == heal["state_bytes"] == 12 * n + 4
    # every position holds each leaf's bytes over the shards of its spec:
    # a quarter of a matrix, half of a norm (replicated over tensor)
    mesh = ft_mesh({"fsdp": 2, "tensor": 2}, devices=["cpu"] * 4)
    fn = make_sharding_fn(mesh, tp_rules_gpt())
    want = 0
    for path, shape in _tiny_paths().items():
        spec = fn(path, torch.empty(shape, device="meta")).spec
        want += 4 * int(np.prod(shape)) // int(np.prod(
            [mesh.shape[a] for a in spec if a is not None]))
    assert want > n
    assert result["piece_bytes"] == [want] * 4


def _tiny_paths():
    from torchft_tpu_torch.models.transformer import CONFIGS, gpt_param_shapes

    return gpt_param_shapes(CONFIGS["tiny"])


def _tiny_shapes():
    return list(_tiny_paths().values())


def test_run_hsdp_drill_refuses_a_schedule_without_a_joint_step() -> None:
    from torchft_tpu_torch.examples.train_hsdp import run_hsdp_drill
    from torchft_tpu_torch.models import CONFIGS

    with pytest.raises(ValueError, match="no joint step"):
        run_hsdp_drill(CONFIGS["tiny"], {"fsdp": 2}, steps=4, kill_after=3,
                       device="cpu")


@pytest.mark.parametrize("device, axes, cards, want", [
    ("cuda:0", {"fsdp": 2, "tensor": 2}, 4,
     ["cuda:0", "cuda:1", "cuda:2", "cuda:3"]),
    ("cuda:0", {"fsdp": 2, "tensor": 2}, 1, ["cuda:0"] * 4),
    ("cpu", {"fsdp": 2, "tensor": 2}, 0, ["cpu"] * 4),
])
def test_hsdp_mesh_takes_a_card_a_position_while_there_are_cards(
        monkeypatch, device, axes, cards, want) -> None:
    import torchft_tpu_torch.examples.train_hsdp as example

    meshes = []

    def spy(axes, devices=None):
        meshes.append([str(d) for d in devices])
        return ft_mesh(axes, devices=devices)

    monkeypatch.setattr(example, "ft_mesh", spy)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    example.hsdp_mesh(axes, torch.device(device))
    assert meshes == [want]
    assert example.default_axes(4) == {"fsdp": 2, "tensor": 2}
    assert example.default_axes(3) == {"fsdp": 3, "tensor": 1}


def _run_example(**extra_env):
    lh = Lighthouse(min_replicas=1, join_timeout_ms=200)
    env = dict(os.environ, TORCHFT_TPU_LIGHTHOUSE=lh.address(),
               REPLICA_GROUP_ID="0", LOGLEVEL="ERROR", DEVICE="cpu",
               TOTAL_STEPS="3", MESH_DEVICES="4", **extra_env)
    try:
        return subprocess.run(
            [sys.executable, "-m", "torchft_tpu_torch.examples.train_hsdp"],
            env=env, capture_output=True, text=True, timeout=180, cwd=_ROOT)
    finally:
        lh.shutdown()


def test_train_hsdp_example_runs() -> None:
    # the example end to end as a process against a fresh lighthouse, on a
    # virtual mesh of 4 CPU positions (MESH_DEVICES), where the reference
    # forces 8 host devices
    proc = _run_example()
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "step 3" in proc.stdout and "done" in proc.stdout, proc.stdout


def test_train_hsdp_example_donated_update() -> None:
    # the twin of tests/test_apps.py's: the same example with the
    # decide-then-apply commit (TORCHFT_TPU_DONATE_UPDATE=1, no transient
    # backup) trains end to end over the sharded state
    proc = _run_example(TORCHFT_TPU_DONATE_UPDATE="1")
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "step 3" in proc.stdout and "done" in proc.stdout, proc.stdout
