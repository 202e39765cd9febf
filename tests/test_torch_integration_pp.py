"""PP x FT end to end with the port: a GPipe pipeline as the in-group
mesh, composed with the Manager's fault tolerance, a kill and a heal onto
the stage-split layout.

Twin of ``tests/test_integration_pp.py`` at its sizes (S = 4 stages, width
D = 6, batch 8, M = 4 microbatches, a kill at step 3, 6 commits a group):
each replica group runs a 4-stage microbatched pipeline over its own
virtual ``{"stage": 4}`` mesh of the CPU, its stage-stacked parameters
``ShardedTensor`` s split on dim 0 over ``"stage"`` (each position holds
exactly its stage's weights), its gradients from ``backward()`` through
``make_pipeline``; gradients average across groups through the Manager
over TCP. Group 1 is killed, restarts from a poisoned init and heals
through its template (``CheckpointServer(template_fn=...)``) onto its own
stage-split layout. The reference holds the two groups within rtol 1e-5;
the port's run the same code on one CPU, so they must be bitwise equal at
every step both commit.

Then the card's drill (``chip_smoke.run_pp_drill``) at "tiny" widths,
depth 4 (one layer a stage): the GPT's blocks pipelined over the stage
axis, the embedding and head outside, AdamW on the pieces, two groups
bitwise at every joint step through a kill after 3 and a heal at 5.
"""

import dataclasses
import importlib.util
import logging
import os
import threading
import time
from typing import Dict

import numpy as np
import torch

from torchft_tpu_torch.checkpointing import CheckpointServer
from torchft_tpu_torch.comm.store import StoreServer
from torchft_tpu_torch.comm.transport import TcpCommContext
from torchft_tpu_torch.control import Lighthouse
from torchft_tpu_torch.manager import Manager
from torchft_tpu_torch.models import CONFIGS
from torchft_tpu_torch.parallel import (
    NamedSharding,
    PartitionSpec as P,
    ShardedTensor,
    ft_mesh,
    make_pipeline,
    merge_microbatches,
    split_microbatches,
    stack_stage_params,
)

logger = logging.getLogger(__name__)

S, D, BATCH, M = 4, 6, 8, 4  # stages, width, batch, microbatches
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _stage_fn(params, h):
    return torch.tanh(h @ params["w"] + params["b"])


def group_mesh():
    return ft_mesh({"stage": S}, devices=["cpu"] * S)


def stage_split(leaf, mesh) -> NamedSharding:
    return NamedSharding(mesh, P("stage", *([None] * (leaf.ndim - 1))))


def make_stacked_params(seed: float, mesh):
    """Stage-stacked params, the leading dim split over the stage axis:
    each position holds exactly its stage's weights."""
    stages = [{"w": torch.full((D, D), seed / (i + 1)),
               "b": torch.full((D,), seed / 10.0)} for i in range(S)]
    stacked = stack_stage_params(stages)
    return {k: ShardedTensor.from_full(v, stage_split(v, mesh))
            for k, v in stacked.items()}


class _Killed(Exception):
    pass


class _PpReplica:
    def __init__(self, harness, group: int, lighthouse_addr: str,
                 fail_at_step: int = -1):
        self.harness = harness
        self.group = group
        self.lighthouse_addr = lighthouse_addr
        self.fail_at_step = fail_at_step
        self.history: Dict[int, Dict[str, bytes]] = {}
        self.healed_shardings_ok = True
        self.healed = False

    def run(self) -> None:
        restarted = False
        while not self.harness["stop"].is_set():
            try:
                self._main(restarted)
                return
            except _Killed:
                logger.warning("pp group %d restarting after kill",
                               self.group)
                restarted = True

    def _main(self, restarted: bool) -> None:
        mesh = group_mesh()
        store = StoreServer()
        seed = 99.0 if restarted else 1.0
        holder = {"params": make_stacked_params(seed, mesh)}

        def state_dict():
            return {"params": holder["params"]}

        def load_state_dict(sd):
            for name, leaf in sd["params"].items():
                if not (isinstance(leaf, ShardedTensor)
                        and leaf.sharding == holder["params"][name].sharding
                        and leaf.sharding.spec[0] == "stage"):
                    self.healed_shardings_ok = False
            holder["params"] = sd["params"]
            self.healed = True

        transport = CheckpointServer(
            timeout=5.0, template_fn=lambda: {
                "user": state_dict(),
                "torchft": {"step": 0, "batches_committed": 0},
            })
        pp = make_pipeline(mesh, _stage_fn)
        mb = split_microbatches(torch.ones(BATCH, D), M)

        def grad_step(params):
            live = {k: v.like([p.detach().requires_grad_(True)
                               for p in v.pieces])
                    for k, v in params.items()}
            out = merge_microbatches(pp(live, mb))
            loss = torch.mean((out - 1.0) ** 2)
            pieces = [p for v in live.values() for p in v.pieces]
            return loss, torch.autograd.grad(loss, pieces)

        manager = Manager(
            comm=TcpCommContext(timeout=5.0),
            load_state_dict=load_state_dict,
            state_dict=state_dict,
            checkpoint_transport=transport,
            min_replica_size=1,
            use_async_quorum=True,
            timeout=10.0, quorum_timeout=10.0, connect_timeout=10.0,
            rank=0, world_size=1,
            store_addr=store.addr,
            lighthouse_addr=self.lighthouse_addr,
            replica_id=f"pp_{self.group}_",
            heartbeat_interval=0.05,
        )
        try:
            while not self.harness["stop"].is_set():
                if (not restarted
                        and manager.current_step() == self.fail_at_step):
                    raise _Killed()
                try:
                    manager.start_quorum()
                except (TimeoutError, RuntimeError) as e:
                    logger.info("quorum retry: %s", e)
                    continue
                _, grads = grad_step(holder["params"])
                avg = manager.allreduce_arrays(
                    [g.numpy() for g in grads]).future().result(20)
                if not manager.should_commit():
                    continue
                it = iter(avg)
                holder["params"] = {
                    k: v.like([p - 0.1 * torch.from_numpy(next(it))
                               for p in v.pieces])
                    for k, v in holder["params"].items()}
                self.history[manager.current_step()] = {
                    k: v.full().numpy().tobytes()
                    for k, v in holder["params"].items()}
                with self.harness["lock"]:
                    counts = self.harness["commits"]
                    counts[self.group] = counts.get(self.group, 0) + 1
                    if all(counts.get(g, 0) >= self.harness["target"]
                           for g in range(2)):
                        self.harness["stop"].set()
        finally:
            manager.shutdown(wait=False)
            store.shutdown()


def test_pp_ft_kill_and_sharded_heal() -> None:
    lighthouse = Lighthouse(min_replicas=1, join_timeout_ms=300,
                            heartbeat_timeout_ms=1000)
    harness = {"stop": threading.Event(), "lock": threading.Lock(),
               "commits": {}, "target": 6}
    replicas = [_PpReplica(harness, 0, lighthouse.address()),
                _PpReplica(harness, 1, lighthouse.address(),
                           fail_at_step=3)]
    threads = [threading.Thread(target=r.run, name=f"pp{r.group}",
                                daemon=True) for r in replicas]
    deadline = time.time() + 150
    for t in threads:
        t.start()
    for t in threads:
        t.join(max(1.0, deadline - time.time()))
    harness["stop"].set()
    lighthouse.shutdown()
    assert not any(t.is_alive() for t in threads)

    assert harness["commits"].get(0, 0) >= harness["target"]
    assert harness["commits"].get(1, 0) >= harness["target"]
    assert replicas[1].healed, "killed group never healed"
    assert all(r.healed_shardings_ok for r in replicas)
    common = sorted(set(replicas[0].history) & set(replicas[1].history))
    assert len(common) >= 3, f"too few common steps: {common}"
    assert [s for s in common if s > 4], "no common steps after the heal"
    for s in common:
        assert replicas[0].history[s] == replicas[1].history[s], \
            f"divergence at step {s}"


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(_ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_gpt_pp_drill_at_tiny_depth_4() -> None:
    smoke = _smoke()
    cfg = dataclasses.replace(CONFIGS["tiny"], n_layers=4)
    result = smoke.run_pp_drill(cfg, device="cpu", timeout=30.0,
                                log=lambda m: None)
    # run_hsdp_drill raises on any difference, a heal at another step, a
    # healed leaf outside the healer's sharding or heal wire bytes other
    # than the state's
    assert result["checked_steps"] == [1, 2, 3, 5, 6, 7]
    assert result["heal_step"] == 5
    assert result["heal"]["wire_bytes"] == result["heal"]["state_bytes"]
    # every position holds its stage's layer and one copy of the
    # replicated leaves sits at the first
    per_pos = result["piece_bytes"]
    assert len(per_pos) == 4 and len(set(per_pos)) == 1
    model = smoke.pipelined_gpt()(cfg, group_mesh())
    for path in model.paths:
        leaf = model.layouts[path]
        if path.startswith("stages/"):
            assert leaf.sharding.spec[0] == "stage"
            assert [b[0] for b in leaf.bounds] == [(s, s + 1)
                                                   for s in range(S)]
        else:
            assert len(leaf.pieces) == 1
    assert np.isfinite([v for r in result["runs"].values()
                        for v in r.losses.values()]).all()
