"""The sharded weight update end to end: kill, shrink, rejoin.

Twins of tests/test_sharded_e2e.py over the port: three replica groups
train the "tiny" GPT through ``ShardedOptimizerWrapper`` (real Managers,
a real lighthouse, TCP and HTTP heals) in ``run_kill_and_heal(...,
sharded=True)``. Group 0 is killed after step 3, the survivors shrink to a
wire of 2 and reshard, group 0 restarts from a poisoned init, heals its
optimizer shard with ``fetch_opt_shard`` and the three reshard back. The
lifecycle is read off the groups' flight recorders (what GET
/telemetry/events serves). The 2-D twin prices the shrink at
``model_shards=2`` against an independently built ``TransferPlan``.
Tolerance: none; the drill itself holds every committed step bitwise
equal across the live groups.
"""

from typing import Dict, List

import numpy as np

from torchft_tpu_torch.checkpointing import split_leaf_payload
from torchft_tpu_torch.comm.redistribute import ShardSpec, TransferPlan
from torchft_tpu_torch.ddp import shard_ranges
from torchft_tpu_torch.examples.train_ddp import run_kill_and_heal
from torchft_tpu_torch.models import CONFIGS, GPT


def _drill(model_shards: int = 1) -> Dict[str, object]:
    return run_kill_and_heal(CONFIGS["tiny"], device="cpu", batch_size=2,
                             timeout=30.0, groups=3, kill_group=0,
                             kill_step=3, steps_alone=1, steps_after=2,
                             sharded=True, model_shards=model_shards)


def _kinds(events: List[dict], kind: str, **match) -> List[dict]:
    return [e for e in events if e["kind"] == kind
            and all(e.get(k) == v for k, v in match.items())]


def test_sharded_kill_shrink_rejoin_lifecycle() -> None:
    result = _drill()
    assert result["heal_step"] == 5
    assert result["checked_steps"] == [5, 6, 7]
    lives = result["lives"]
    assert len(lives[0]) == 2  # the killed group restarted once
    # a survivor's recorder: the full wire, the death, the shrink reshard,
    # commits at 2, the grow reshard, commits past it
    surv = sorted(lives[1][0].events, key=lambda e: e["seq"])
    assert _kinds(surv, "shard_grid_rebuild")
    assert _kinds(surv, "quorum_complete", wire_world=3)
    death = min(e["seq"] for e in surv
                if e["kind"] in ("member_dead", "error_latched")
                or (e["kind"] == "quorum_complete"
                    and e.get("wire_world") == 2))
    shrink = [e for e in _kinds(surv, "reshard", new_world=2)
              if e["seq"] > death]
    assert shrink and shrink[0]["reinit_leaves"] > 0
    assert [e for e in _kinds(surv, "step_commit")
            if e["seq"] > shrink[0]["seq"]]
    grow = [e for e in _kinds(surv, "reshard", new_world=3)
            if e["seq"] > shrink[0]["seq"]]
    assert grow
    assert [e for e in _kinds(surv, "step_commit")
            if e["seq"] > grow[0]["seq"]]
    # every reshard and plan on every life moved exactly its lower bound
    for runs in lives.values():
        for run in runs:
            for e in _kinds(run.events, "reshard"):
                assert e["wire_bytes"] == e["lower_bound_bytes"]
            for e in _kinds(run.events, "redist_plan"):
                assert e["moved_bytes"] == e["lower_bound_bytes"]
    # the rejoiner healed (its optimizer shard through fetch_opt_shard),
    # resharded onto the live grid and committed past the kill point
    rejoin = sorted(lives[0][-1].events, key=lambda e: e["seq"])
    heal_done = _kinds(rejoin, "heal_done")
    assert heal_done and _kinds(rejoin, "heal_start")[0]["seq"] < \
        heal_done[0]["seq"]
    fetched = _kinds(rejoin, "redist_plan", source="opt_shard_heal")
    assert fetched and fetched[0]["moved_bytes"] > 0
    assert lives[0][-1].metrics["heal_opt_bytes"] == \
        fetched[0]["moved_bytes"]
    assert _kinds(rejoin, "reshard")
    assert [e for e in _kinds(rejoin, "step_commit")
            if e["seq"] > heal_done[0]["seq"]]
    # the shards are 1/3 of the replicated state at a wire of 3
    held = [run.metrics["opt_state_bytes"] for run in
            (lives[0][-1], lives[1][0], lives[2][0])]
    n = sum(p.numel() for p in GPT(CONFIGS["tiny"], device="meta")
            .parameters())
    replicated = 8 * n + 4 * len(list(GPT(CONFIGS["tiny"], device="meta")
                                      .parameters()))
    assert sum(held) == replicated


def _sub_unit_bytes(model_shards: int) -> List[int]:
    """Per-sub-unit bytes of the tiny GPT's adamw leaf states, split as
    the wrapper ships them (count, mu, nu per leaf)."""
    out = []
    for p in GPT(CONFIGS["tiny"], device="meta").parameters():
        slots = [np.zeros((), np.int32), np.zeros(p.numel(), np.float32),
                 np.zeros(p.numel(), np.float32)]
        for shard in split_leaf_payload(slots, model_shards):
            out.append(sum(int(a.nbytes) for a in shard))
    return out


def test_sharded_2d_kill_shrink_rejoin_lower_bound() -> None:
    # the shrink at model_shards=2 moves exactly the bound of the 2-D spec
    # transition, priced independently from the shard grid
    m = 2
    result = _drill(model_shards=m)
    lives = result["lives"]

    def rank_at(events, world):
        resh = _kinds(events, "reshard", new_world=world)
        assert resh, f"no reshard onto the {world}-wire grid"
        return int(resh[0]["rank"])

    surv = {g: lives[g][0].events for g in (1, 2)}
    old_rank = {g: rank_at(ev, 3) for g, ev in surv.items()}
    new_rank = {g: rank_at(ev, 2) for g, ev in surv.items()}
    assert sorted(new_rank.values()) == [0, 1]
    params = list(GPT(CONFIGS["tiny"], device="meta").parameters())
    sizes = [p.numel() for p in params]
    dtypes = [p.dtype for p in params]
    n = len(params)
    spec3 = ShardSpec.from_ranges_2d(shard_ranges(sizes, dtypes, 3), m, n)
    spec2 = ShardSpec.from_ranges_2d(shard_ranges(sizes, dtypes, 2), m, n)
    src = ShardSpec(n * m, {new_rank[g]: spec3.units_of(old_rank[g])
                            for g in (1, 2)})
    plan = TransferPlan(src, spec2, _sub_unit_bytes(m))
    assert plan.lower_bound_bytes == plan.moved_bytes
    for g in (1, 2):
        shrink = _kinds(surv[g], "reshard", new_world=2)[0]
        want = plan.lower_bound_bytes.get(new_rank[g], 0)
        assert shrink["mesh_shape"] == f"2x{m}"
        assert shrink["lower_bound_bytes"] == want == shrink["wire_bytes"]
        assert shrink["reinit_leaves"] == \
            len(plan.receiver_unsourced(new_rank[g])) // m
    assert any(plan.moved_bytes.get(new_rank[g], 0) > 0 for g in (1, 2))
    assert any(plan.receiver_unsourced(new_rank[g]) for g in (1, 2))
