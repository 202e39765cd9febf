"""Repeated kills while the job commits: the twins of the rest of
tests/test_integration.py, and the port's churn drill at "tiny".

The reference file's harness (``FailureInjector``, ``Harness``,
``Runner``: one replica group a thread, restarted on an injected failure,
with the numpy toy W -> target) runs here over the port's ``Manager``,
``TcpCommContext``, ``StoreServer`` and native lighthouse (``arm``
"torch"), and over a **mixed** cohort (``arm`` "mixed"): port and
reference replicas in one quorum on the port's lighthouse. In a mixed
cohort every replica the schedule kills, and the one that latches its
wire, is the port's, so each heal and the comm-epoch recovery land on the
port; the others alternate, the reference's first. Their trajectories
must be bitwise equal across the two packages at every step both
committed (their wires are byte-compatible). The twins, each at the
reference's timeouts and tolerance (``rtol=1e-6``; bitwise for the
compressed wire and across the packages):

- ``test_two_replicas_healthy_converge``
- ``test_three_replicas_one_killed_others_continue``
- ``test_recovery_with_sync_quorum``
- ``test_multi_rank_groups`` (per-rank targets)
- ``test_chaos_churn_five_replicas``
- ``test_chaos_multi_rank_groups_kill_and_heal``
- ``test_recovery_with_compressed_multilane_transport``
- ``test_latched_transport_recovers_via_comm_epoch``

One difference from the reference harness: a restarted replica rejoins
only once a survivor has committed a step past its death, where the
survivors can form a quorum without it (a gate on commits, never on time),
so every kill is seen by the survivors before the heal.

The drill tests run ``examples.train_ddp.run_churn_drill`` at "tiny" on the
CPU: the default schedule (five groups, three kills, group 1 twice), a
synchronous quorum, a latched wire over two groups, and two fabricated
faults its oracle must refuse (a dead life's state kept alive, a kill that
fires twice).
"""

import logging
import math
import threading
import time
import types
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence

import numpy as np
import pytest

logger = logging.getLogger(__name__)

ARMS = ("torch", "mixed")


def _pkg(name: str) -> types.SimpleNamespace:
    """One package's Manager, TcpCommContext, StoreServer and Lighthouse."""
    if name == "torch":
        from torchft_tpu_torch.checkpointing import CheckpointServer
        from torchft_tpu_torch.comm.store import StoreServer
        from torchft_tpu_torch.comm.transport import TcpCommContext
        from torchft_tpu_torch.control import Lighthouse
        from torchft_tpu_torch.manager import Manager
    else:
        from torchft_tpu.checkpointing import CheckpointServer
        from torchft_tpu.comm.store import StoreServer
        from torchft_tpu.comm.transport import TcpCommContext
        from torchft_tpu.control import Lighthouse
        from torchft_tpu.manager import Manager
    return types.SimpleNamespace(name=name, Manager=Manager,
                                 TcpCommContext=TcpCommContext,
                                 StoreServer=StoreServer,
                                 Lighthouse=Lighthouse,
                                 CheckpointServer=CheckpointServer)


def _cohort(arm: str, n: int,
            port: Sequence[int] = ()) -> List[types.SimpleNamespace]:
    """Each replica's package: the port's for "torch"; for "mixed" the
    port's at each replica of ``port`` (those the schedule kills, or the
    one that latches) and the others alternating, the reference's first."""
    if arm == "torch":
        return [_pkg("torch")] * n
    rest = [i for i in range(n) if i not in port]
    ported = set(port) | set(rest[1::2])
    return [_pkg("torch" if i in ported else "jax") for i in range(n)]


def _template(p: types.SimpleNamespace, state: dict):
    """A checkpoint server that heals through a template of ``state``'s
    f32 ``w``: a heal crosses the packages only so (F7 in ROADMAP), and a
    mixed cohort's replicas all heal through one."""
    return p.CheckpointServer(timeout=5.0, template_fn=lambda: {
        "user": {"w": state["w"]},
        "torchft": {"step": 0, "batches_committed": 0}})


class InjectedFailure(Exception):
    pass


class FailureInjector:
    """Deterministic fault injection at (rank, step) (ref
    manager_integ_test.py:39-61)."""

    def __init__(self) -> None:
        self._failures = set()
        self._lock = threading.Lock()
        self.count = 0

    def fail_at(self, rank: int, step: int) -> "FailureInjector":
        with self._lock:
            self._failures.add((rank, step))
        return self

    def check(self, rank: int, step: int) -> None:
        with self._lock:
            if (rank, step) in self._failures:
                self._failures.remove((rank, step))
                self.count += 1
                raise InjectedFailure(f"injected failure {rank=} {step=}")


class Harness:
    """Shared coordination: per-replica progress, the collective stop, and
    the rejoin gate (a survivor's commit past a death)."""

    def __init__(self, num_replicas: int, total_steps: int) -> None:
        self.num_replicas = num_replicas
        self.total_steps = total_steps
        self.stop = threading.Event()
        self.progress: Dict[int, int] = {}
        self._cond = threading.Condition()

    def report(self, replica_id: int, step: int) -> None:
        with self._cond:
            self.progress[replica_id] = max(
                self.progress.get(replica_id, 0), step)
            if len(self.progress) == self.num_replicas and all(
                    s >= self.total_steps for s in self.progress.values()):
                self.stop.set()
            self._cond.notify_all()

    def wait_survivor_past(self, dead: int, step: int) -> None:
        """Block until a replica other than ``dead`` has committed a step
        after ``step``, or the run stops."""
        with self._cond:
            while not self.stop.is_set() and not any(
                    s > step for r, s in self.progress.items() if r != dead):
                self._cond.wait(timeout=0.05)


class Runner:
    """One replica group over ``pkg``; restarts the whole replica on
    InjectedFailure (ref manager_integ_test.py:70-126). ``gate``: a
    restart waits for a survivor's commit past the death. ``template``:
    heal through :func:`_template`."""

    def __init__(self, replica_id: int, pkg: types.SimpleNamespace,
                 lighthouse_addr: str, failure_injector: FailureInjector,
                 harness: Harness, target: Optional[np.ndarray] = None,
                 lr: float = 0.5, comm_kwargs: Optional[dict] = None,
                 replica_prefix: str = "replica", use_async_quorum=True,
                 gate: bool = True, template: bool = False) -> None:
        self.replica_id = replica_id
        self.pkg = pkg
        self.lighthouse_addr = lighthouse_addr
        self.failure_injector = failure_injector
        self.harness = harness
        self.target = target if target is not None else np.full((2, 3), 10.0)
        self.lr = lr
        self.comm_kwargs = {"timeout": 5.0, **(comm_kwargs or {})}
        self.replica_prefix = replica_prefix
        self.use_async_quorum = use_async_quorum
        self.gate = gate
        self.template = template
        # committed step -> post-update weights
        self.history: Dict[int, np.ndarray] = {}

    def run_replica(self) -> None:
        while not self.harness.stop.is_set():
            try:
                self._replica_main()
                return
            except InjectedFailure as e:
                logger.warning("replica %s restarting after %s",
                               self.replica_id, e)
                if self.gate:
                    self.harness.wait_survivor_past(
                        self.replica_id, max(self.history, default=0))

    def _replica_main(self) -> None:
        pkg = self.pkg
        store = pkg.StoreServer()
        state = {"w": np.zeros((2, 3), dtype=np.float32)}

        def load_state_dict(sd):
            state["w"] = np.array(sd["w"], dtype=np.float32)

        manager = pkg.Manager(
            comm=pkg.TcpCommContext(**self.comm_kwargs),
            load_state_dict=load_state_dict,
            state_dict=lambda: {"w": state["w"]},
            checkpoint_transport=(_template(pkg, state) if self.template
                                  else None),
            min_replica_size=1,
            use_async_quorum=self.use_async_quorum,
            timeout=5.0,
            quorum_timeout=5.0,
            connect_timeout=5.0,
            rank=0,
            world_size=1,
            store_addr=store.addr,
            lighthouse_addr=self.lighthouse_addr,
            replica_id=f"{self.replica_prefix}_{self.replica_id}_",
            heartbeat_interval=0.05,
        )
        try:
            while not self.harness.stop.is_set():
                self.failure_injector.check(0, manager.current_step())
                try:
                    manager.start_quorum()
                except (TimeoutError, RuntimeError) as e:
                    logger.info("quorum attempt failed, retrying: %s", e)
                    continue
                grad = state["w"] - self.target  # dL/dW for 0.5||W-T||^2
                avg = manager.allreduce_arrays([grad]).future().result(
                    timeout=20)[0]
                if manager.should_commit():
                    # every replica applies the average, a healed one too
                    state["w"] = state["w"] - self.lr * avg
                    step = manager.current_step()
                    self.history[step] = np.array(state["w"])
                    self.harness.report(self.replica_id, step)
                else:
                    time.sleep(0.01)
        finally:
            manager.shutdown(wait=False)
            store.shutdown()


def _run(arm: str, num_replicas: int, total_steps: int, fail_at=(),
         min_replicas: int = 1, heartbeat_timeout_ms: int = 1000,
         timeout: float = 90.0, **runner_kw):
    # every cohort meets on the port's native lighthouse
    lighthouse = _pkg("torch").Lighthouse(
        min_replicas=min_replicas, join_timeout_ms=200,
        heartbeat_timeout_ms=heartbeat_timeout_ms)
    harness = Harness(num_replicas, total_steps)
    injectors = [FailureInjector() for _ in range(num_replicas)]
    for rid, step in fail_at:
        injectors[rid].fail_at(0, step)
    if arm == "mixed":
        # a template fixes the healed leaf's dtype: f32 all along
        runner_kw.update(template=True,
                         target=np.full((2, 3), 10.0, np.float32))
    cohort = _cohort(arm, num_replicas, port=[rid for rid, _ in fail_at])
    runners = [Runner(i, p, lighthouse.address(), injectors[i], harness,
                      **runner_kw)
               for i, p in enumerate(cohort)]
    try:
        with ThreadPoolExecutor(max_workers=num_replicas) as pool:
            futs = [pool.submit(r.run_replica) for r in runners]
            deadline = time.monotonic() + timeout
            try:
                for f in futs:
                    f.result(timeout=max(1.0, deadline - time.monotonic()))
            finally:
                harness.stop.set()  # never leave the pool waiting
    finally:
        lighthouse.shutdown()
    return runners, injectors


def _assert_trajectories_consistent(runners: List[Runner],
                                    bitwise: bool = False) -> int:
    """For every step committed by more than one replica, the post-update
    weights match (``rtol=1e-6``, or bit for bit); returns how many steps
    were compared."""
    all_steps: Dict[int, list] = {}
    for r in runners:
        for step, w in r.history.items():
            all_steps.setdefault(step, []).append((r.replica_id, w))
    overlapping = 0
    for step, entries in sorted(all_steps.items()):
        if len(entries) > 1:
            overlapping += 1
            base_id, base = entries[0]
            for rid, w in entries[1:]:
                msg = f"divergence at step {step}: replica {rid} vs {base_id}"
                if bitwise:
                    np.testing.assert_array_equal(w, base, err_msg=msg)
                else:
                    np.testing.assert_allclose(w, base, rtol=1e-6,
                                               err_msg=msg)
    assert overlapping > 0, "no overlapping committed steps to compare"
    return overlapping


def _cross_package_steps(histories: Dict[str, List[Dict[int, np.ndarray]]]
                         ) -> List[int]:
    """The steps that a port replica and a reference replica both
    committed (``histories``: each package's replicas' committed step ->
    weights), after checking every port replica's weights bitwise equal
    to every reference replica's there."""
    both = []
    steps = {s for hs in histories.values() for h in hs for s in h}
    for step in sorted(steps):
        port = [h[step] for h in histories.get("torch", ()) if step in h]
        ref = [h[step] for h in histories.get("jax", ()) if step in h]
        for a in port:
            for b in ref:
                np.testing.assert_array_equal(
                    a, b, err_msg=f"the packages diverged at step {step}")
        if port and ref:
            both.append(step)
    return both


def _by_package(runners: List[Runner]) -> Dict[str, list]:
    out: Dict[str, list] = {}
    for r in runners:
        out.setdefault(r.pkg.name, []).append(r.history)
    return out


def _check_mixed(arm: str, runners: List[Runner], steps) -> None:
    """In a mixed cohort, the packages committed every step of ``steps``
    together, bitwise equal there (and at every other step both did)."""
    if arm == "mixed":
        both = _cross_package_steps(_by_package(runners))
        assert set(steps) <= set(both), (sorted(steps), both)


@pytest.mark.parametrize("arm", ARMS)
def test_two_replicas_healthy_converge(arm) -> None:
    runners, _ = _run(arm, num_replicas=2, total_steps=5, min_replicas=2)
    _assert_trajectories_consistent(runners)
    final = runners[0].history[max(runners[0].history)]
    # the loss decreased toward the target
    assert np.abs(final - 10.0).max() < 10.0
    assert max(runners[0].history) >= 5
    _check_mixed(arm, runners, range(1, 6))


@pytest.mark.parametrize("arm", ARMS)
def test_three_replicas_one_killed_others_continue(arm) -> None:
    runners, injectors = _run(arm, num_replicas=3, total_steps=7,
                              fail_at=[(0, 3)], min_replicas=2)
    assert injectors[0].count == 1
    _assert_trajectories_consistent(runners)
    for r in runners:
        assert max(r.history) >= 7
    # replicas 1 and 2, one of each package, commit every step; replica
    # 0, the port's, heals from either
    _check_mixed(arm, runners, range(1, 8))


@pytest.mark.parametrize("arm", ARMS)
def test_recovery_with_sync_quorum(arm) -> None:
    # the survivor alone is below min_replicas=2, so the restart cannot
    # wait for its commit: the reference harness's immediate restart
    runners, injectors = _run(arm, num_replicas=2, total_steps=6,
                              fail_at=[(0, 2)], min_replicas=2,
                              use_async_quorum=False, gate=False)
    assert injectors[0].count == 1
    _assert_trajectories_consistent(runners)
    for r in runners:
        assert max(r.history) >= 6
    # under min_replicas 2 every commit is joint: the port's steps before
    # the kill, and its healed life's to the end
    _check_mixed(arm, runners, runners[0].history)


@pytest.mark.parametrize("arm", ARMS)
def test_multi_rank_groups(arm) -> None:
    # 2 replica groups x 2 local ranks: the manager server fans in both
    # local ranks before one lighthouse RPC; each local rank forms its own
    # cross-group wire (mixed: group 0 the reference's, group 1 the port's)
    pkgs = _cohort(arm, 2)
    lighthouse = _pkg("torch").Lighthouse(min_replicas=2,
                                          join_timeout_ms=300)
    num_groups, ranks_per_group = 2, 2
    results = {}
    errors = []

    def worker(group, rank, store_addr):
        p = pkgs[group]
        try:
            state = {"w": np.zeros(4, dtype=np.float32)}
            manager = p.Manager(
                comm=p.TcpCommContext(timeout=10.0),
                load_state_dict=lambda sd: state.update(sd),
                state_dict=lambda: dict(state),
                checkpoint_transport=(_template(p, state)
                                      if arm == "mixed" else None),
                min_replica_size=2, rank=rank, world_size=ranks_per_group,
                store_addr=store_addr, lighthouse_addr=lighthouse.address(),
                replica_id=f"mr_{group}_", timeout=10.0,
                quorum_timeout=15.0, connect_timeout=10.0,
                heartbeat_interval=0.05)
            try:
                for _ in range(3):
                    manager.start_quorum()
                    # rank-dependent grads: counterpart ranks across groups
                    # average among themselves
                    grad = np.full(4, float(group * 10 + rank), np.float32)
                    avg = manager.allreduce_arrays([grad]).future().result(
                        timeout=30)[0]
                    committed = manager.should_commit()
                    results[(group, rank, manager.current_step())] = (
                        avg.copy(), committed)
            finally:
                manager.shutdown(wait=False)
        except Exception as e:  # noqa: BLE001 — asserted empty below
            errors.append((group, rank, e))

    stores = [pkgs[g].StoreServer() for g in range(num_groups)]
    try:
        with ThreadPoolExecutor(max_workers=4) as pool:
            futs = [pool.submit(worker, g, r, stores[g].addr)
                    for g in range(num_groups)
                    for r in range(ranks_per_group)]
            for f in futs:
                f.result(timeout=120)
    finally:
        lighthouse.shutdown()
        for s in stores:
            s.shutdown()

    assert not errors, errors
    for (group, rank, step), (avg, committed) in results.items():
        assert committed, (group, rank, step)
        if step >= 2:
            # after the bootstrap, rank r of each group averages with its
            # counterpart: (r + 10 + r) / 2 = 5 + r
            np.testing.assert_allclose(avg, np.full(4, 5.0 + rank))
            # counterpart ranks read the same average, across the packages
            # in a mixed cohort
            np.testing.assert_array_equal(
                avg, results[(1 - group, rank, step)][0])
    assert {1, 2, 3} <= {s for (_, _, s) in results}


@pytest.mark.parametrize("arm", ARMS)
def test_chaos_churn_five_replicas(arm) -> None:
    # the north-star shape: repeated kills while the job keeps committing,
    # every rejoiner healing back in; replica 1 dies twice
    runners, injectors = _run(arm, num_replicas=5, total_steps=10,
                              fail_at=[(1, 2), (3, 4), (1, 6)],
                              min_replicas=3, timeout=150.0)
    assert injectors[1].count == 2
    assert injectors[3].count == 1
    _assert_trajectories_consistent(runners)
    for r in runners:
        assert max(r.history) >= 10
    # a heal fast-forwards past the steps missed while dead, so killed
    # replicas commit fewer
    for r in runners:
        floor = 3 if r.replica_id in (1, 3) else 6
        assert len(r.history) >= floor, (
            f"replica {r.replica_id} committed only {len(r.history)} steps")
    # replica 2 (the port's) and replica 0 (the reference's) were never
    # killed and commit every step together
    _check_mixed(arm, runners, range(1, 11))


@pytest.mark.parametrize("arm", ARMS)
def test_chaos_multi_rank_groups_kill_and_heal(arm) -> None:
    # a whole 2-rank group is killed, restarts (both ranks) and heals per
    # rank from the survivor group; per-rank targets, so a cross-rank wire
    # mix-up would show (mixed: group 1, killed, is the port's)
    kill_group, kill_at_step = 1, 3
    pkgs = _cohort(arm, 2, port=(kill_group,))
    lighthouse = _pkg("torch").Lighthouse(
        min_replicas=1, join_timeout_ms=300, heartbeat_timeout_ms=800)
    num_groups, ranks_per_group, target_commits = 2, 2, 6
    stop = threading.Event()
    lock = threading.Lock()
    commits: Dict[tuple, int] = {}
    history: Dict[tuple, Dict[int, np.ndarray]] = {
        (g, r): {} for g in range(num_groups) for r in range(ranks_per_group)}
    kill_count = [0]
    # the rejoin gate: the survivor group committed past the kill
    survivor_past = threading.Event()

    def rank_main(group, rank, store_addr, restarted, killed, errors):
        p = pkgs[group]
        target = np.full(4, 10.0 * (rank + 1), np.float32)
        w0 = 99.0 if restarted else 0.0
        state = {"w": np.full(4, w0, np.float32)}

        def load_state_dict(sd):
            state["w"] = np.array(sd["w"], dtype=np.float32)

        manager = p.Manager(
            comm=p.TcpCommContext(timeout=5.0),
            load_state_dict=load_state_dict,
            state_dict=lambda: {"w": state["w"]},
            checkpoint_transport=(_template(p, state)
                                  if arm == "mixed" else None),
            min_replica_size=1, use_async_quorum=True,
            timeout=8.0, quorum_timeout=8.0, connect_timeout=8.0,
            rank=rank, world_size=ranks_per_group, store_addr=store_addr,
            lighthouse_addr=lighthouse.address(),
            replica_id=f"chaos_mr_{group}_", heartbeat_interval=0.05)
        try:
            while not stop.is_set() and not killed.is_set():
                if (group == kill_group and not restarted
                        and manager.current_step() >= kill_at_step):
                    with lock:  # one kill of the group, whichever rank
                        kill_count[0] += not killed.is_set()
                        killed.set()
                    return
                try:
                    manager.start_quorum()
                    grad = state["w"] - target
                    avg = manager.allreduce_arrays([grad]).future().result(
                        timeout=20)[0]
                    committed = manager.should_commit()
                except (TimeoutError, RuntimeError) as e:
                    # quorum/commit RPCs race the peer group's shutdown
                    logger.info("step retry g%d r%d: %s", group, rank, e)
                    continue
                if committed:
                    state["w"] = state["w"] - 0.2 * avg
                    step = manager.current_step()
                    history[(group, rank)][step] = np.array(state["w"])
                    with lock:
                        commits[(group, rank)] = commits.get(
                            (group, rank), 0) + 1
                        if group != kill_group and step > kill_at_step:
                            survivor_past.set()
                        if all(commits.get((g, r), 0) >= target_commits
                               for g in range(num_groups)
                               for r in range(ranks_per_group)):
                            stop.set()
                else:
                    time.sleep(0.01)
        except Exception as e:  # noqa: BLE001 — asserted empty below
            errors.append((group, rank, e))
        finally:
            manager.shutdown(wait=False)

    def group_main(group, errors):
        restarted = False
        while not stop.is_set():
            store = pkgs[group].StoreServer()
            killed = threading.Event()
            threads = [threading.Thread(
                target=rank_main,
                args=(group, r, store.addr, restarted, killed, errors),
                daemon=True) for r in range(ranks_per_group)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            store.shutdown()
            if killed.is_set() and not stop.is_set():
                while not (survivor_past.wait(0.05) or stop.is_set()):
                    pass
                restarted = True
                continue
            return

    errors: list = []
    group_threads = [threading.Thread(target=group_main, args=(g, errors),
                                      daemon=True)
                     for g in range(num_groups)]
    try:
        for t in group_threads:
            t.start()
        deadline = time.monotonic() + 120
        for t in group_threads:
            t.join(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        stop.set()
        lighthouse.shutdown()

    assert not errors, errors
    assert kill_count[0] == 1, "kill never fired"
    for g in range(num_groups):
        for r in range(ranks_per_group):
            assert commits.get((g, r), 0) >= target_commits, (g, r, commits)
    # counterpart ranks share a wire: their weights match step for step,
    # bit for bit across the packages in a mixed cohort
    overlapping = 0
    for r in range(ranks_per_group):
        h0, h1 = history[(0, r)], history[(1, r)]
        common = sorted(set(h0) & set(h1))
        assert [s for s in common if s > kill_at_step + 1], (
            f"rank {r}: no common steps after the heal: {common}")
        for s in common:
            overlapping += 1
            if arm == "mixed":
                np.testing.assert_array_equal(
                    h0[s], h1[s], err_msg=f"rank {r}: the packages diverged "
                    f"at {s}")
            else:
                np.testing.assert_allclose(h0[s], h1[s], rtol=1e-5,
                                           err_msg=f"rank {r} diverged at {s}")
    assert overlapping >= 4


@pytest.mark.parametrize("arm", ARMS)
def test_recovery_with_compressed_multilane_transport(arm) -> None:
    # bf16 on the wire, 4 lanes, a kill and a heal: the encoded bytes are
    # fanned out verbatim, so every replica decodes the same average
    runners, injectors = _run(
        arm, num_replicas=2, total_steps=6, fail_at=[(0, 2)],
        comm_kwargs={"algorithm": "star", "channels": 4,
                     "compression": "bf16"},
        replica_prefix="creplica")
    assert injectors[0].count == 1
    assert _assert_trajectories_consistent(runners, bitwise=True) >= 3
    for r in runners:
        assert max(r.history) >= 6
    if arm == "mixed":
        assert len(_cross_package_steps(_by_package(runners))) >= 3


@pytest.mark.parametrize("arm", ARMS)
def test_latched_transport_recovers_via_comm_epoch(arm) -> None:
    """A transport fault under stable membership: replica 0 (the port's
    in either arm) latches its own wire after a quorum (the state a
    timed-out collective leaves), bumps its comm_epoch in the next quorum
    request, and the lighthouse's fresh quorum id reconfigures both wires
    together; in a mixed cohort replica 1's is the reference's wire."""
    pkgs = _cohort(arm, 2, port=(0,))
    lighthouse = _pkg("torch").Lighthouse(
        min_replicas=2, join_timeout_ms=200, heartbeat_timeout_ms=2000)
    stop = threading.Event()
    histories: Dict[int, Dict[int, np.ndarray]] = {0: {}, 1: {}}
    post_latch_commits = {0: 0, 1: 0}
    latch_fired = threading.Event()
    epochs_seen = {0: 0, 1: 0}
    latched_at: List[int] = []
    errors: List[str] = []
    target_post = 3

    def replica(rid: int) -> None:
        p = pkgs[rid]
        store = p.StoreServer()
        state = {"w": np.zeros(3, dtype=np.float32)}
        comm = p.TcpCommContext(timeout=3.0)
        manager = p.Manager(
            comm=comm,
            load_state_dict=lambda sd: state.update(
                w=np.array(sd["w"], dtype=np.float32)),
            state_dict=lambda: {"w": state["w"]},
            checkpoint_transport=(_template(p, state)
                                  if arm == "mixed" else None),
            min_replica_size=2, use_async_quorum=True, timeout=5.0,
            quorum_timeout=10.0, connect_timeout=5.0, rank=0, world_size=1,
            store_addr=store.addr, lighthouse_addr=lighthouse.address(),
            replica_id=f"epoch_{rid}_", heartbeat_interval=0.05)
        try:
            while not stop.is_set():
                try:
                    manager.start_quorum()
                except (TimeoutError, RuntimeError):
                    continue
                if (rid == 0 and len(histories[0]) >= 2
                        and not latch_fired.is_set()):
                    latch_fired.set()
                    latched_at.append(manager.current_step())
                    comm._latch_error(RuntimeError("injected transport fault"))
                grad = state["w"] - np.full(3, 10.0, np.float32)
                avg = manager.allreduce_arrays([grad]).future().result(
                    timeout=20)[0]
                if manager.should_commit():
                    state["w"] = state["w"] - 0.5 * avg
                    histories[rid][manager.current_step()] = np.array(
                        state["w"])
                    if latch_fired.is_set():
                        post_latch_commits[rid] += 1
                    epochs_seen[rid] = manager._comm_epoch
                    if all(v >= target_post
                           for v in post_latch_commits.values()):
                        stop.set()
                else:
                    time.sleep(0.01)
        except Exception:  # noqa: BLE001 — asserted empty below
            import traceback

            errors.append(f"replica {rid}:\n{traceback.format_exc()}")
            stop.set()
        finally:
            manager.shutdown(wait=False)
            store.shutdown()

    threads = [threading.Thread(target=replica, args=(r,), daemon=True)
               for r in (0, 1)]
    for t in threads:
        t.start()
    deadline = time.monotonic() + 90.0
    for t in threads:
        t.join(max(1.0, deadline - time.monotonic()))
    stop.set()
    for t in threads:
        t.join(10.0)
    lighthouse.shutdown()

    assert not errors, "\n".join(errors)
    assert latch_fired.is_set()
    assert all(v >= target_post for v in post_latch_commits.values()), (
        f"the wire never recovered from the latch: {post_latch_commits}")
    # the latched member asked for one coordinated reconfigure
    assert epochs_seen[0] >= 1, epochs_seen
    common = sorted(set(histories[0]) & set(histories[1]))
    assert common, "no overlapping committed steps"
    for s in common:
        np.testing.assert_allclose(histories[0][s], histories[1][s],
                                   rtol=1e-6, err_msg=f"divergence at {s}")
    if arm == "mixed":
        # every step both committed, the reconfigured wire's included, bit
        # for bit across the packages
        both = _cross_package_steps({p.name: [histories[i]]
                                     for i, p in enumerate(pkgs)})
        assert both == common, (both, common)
        assert len([s for s in both if s > latched_at[0]]) >= target_post


# --- the port's churn drill at "tiny" ----------------------------------------


def _drill(**kw):
    from torchft_tpu_torch.examples.train_ddp import run_churn_drill
    from torchft_tpu_torch.models import CONFIGS

    return run_churn_drill(CONFIGS["tiny"], device="cpu", batch_size=2,
                           timeout=30.0, **kw)


@pytest.mark.parametrize("use_async_quorum", [True, False])
def test_churn_drill_default_schedule(use_async_quorum) -> None:
    # five groups under min_replicas 3; group 1 dies after 2 and 6, group
    # 3 after 4; each restart waits for the survivors' commit without it
    # and heals in the next quorum, so the schedule is fixed
    result = _drill(use_async_quorum=use_async_quorum)
    kills = result["kills"]
    assert [(k["group"], k["life"], k["step"], k["death_step"],
             k["heal_step"]) for k in kills] == [
        (1, 0, 2, 2, 4), (3, 0, 4, 4, 6), (1, 1, 6, 6, 8)]
    assert result["overlap"] == list(range(1, 11))
    # 3 x 10 by the groups never killed, 2 + 3 + 3 by group 1, 4 + 5 by 3
    assert result["passes"] == 47
    assert [len(result["lives"][g]) for g in range(5)] == [1, 3, 1, 2, 1]
    for k in kills:
        assert k["healed"] and k["heal_bytes"] > 0
        assert 0 < k["survivors_first_commit_s"] < k["restart_started_s"] \
            < k["heal_start_s"] <= k["heal_done_s"] <= k["first_commit_s"]
        # the CPU has no device memory to read
        assert k["memory_before"] is None and k["memory_after"] is None
    # participants and wire world of a survivor at every step: the dead
    # group is off the wire the step after each death; at its heal step
    # the healer is on the wire, and a participant only with a synchronous
    # quorum (which applies the heal before the forward pass)
    survivor = result["commits"][(0, 0)]
    heal = 4 if use_async_quorum else 5
    assert {s: (b["participants"], b["wire"])
            for s, b in survivor.items()} == {
        1: (5, 5), 2: (5, 5), 3: (4, 4), 4: (heal, 5), 5: (4, 4),
        6: (heal, 5), 7: (4, 4), 8: (heal, 5), 9: (5, 5), 10: (5, 5)}
    rates = result["tokens_per_s"]
    assert rates["before_first_kill"] > 0 and rates["whole_run"] > 0
    assert result["leaks"] == {} and result["latch"] is None
    assert all(math.isfinite(v) for rs in result["lives"].values()
               for r in rs for v in r.losses.values())


@pytest.mark.parametrize("backend", ["host", "cuda"])
def test_churn_drill_recovers_a_latched_wire(backend) -> None:
    # two groups under min_replicas 2: group 0 latches its own wire at the
    # start of step 4, the step is discarded by both (the peer's ops wait
    # out the 3 s wire timeout), the latched group bumps its comm_epoch
    # and both wires reconfigure; on the CPU pool the card plane does the
    # same through its int8 psum
    options = {"timeout": 3.0}
    if backend == "cuda":
        options.update(algorithm="psum", compression="int8")
    result = _drill(groups=2, kills=(), min_replicas=2, total_steps=6,
                    latch=(0, 3), comm_backend=backend, comm_options=options)
    latch = result["latch"]
    assert latch["group"] == 0 and latch["step"] == 3 and latch["fired"] == 1
    assert latch["post_commits"] == {0: 3, 1: 3}
    assert latch["comm_epoch"] >= 1
    assert result["overlap"] == list(range(1, 7))
    # 6 commits and the discarded step's pass, a group
    assert result["passes"] == 14
    for g in (0, 1):
        run = result["lives"][g][0]
        assert run.wire_steps == 6
        assert run.metrics["comm_backend"] == backend
        assert sorted(run.losses) == list(range(1, 7))
    # the discarded step was the latched one: every commit after it sees
    # the new epoch on the latched group
    epochs = {s: b["comm_epoch"] for s, b in result["commits"][(0, 0)].items()}
    assert epochs[3] == 0 and min(epochs[s] for s in (4, 5, 6)) >= 1


def test_churn_drill_refuses_a_latch_without_a_shorter_wire_timeout() -> None:
    with pytest.raises(ValueError, match="wire timeout"):
        _drill(groups=2, kills=(), min_replicas=2, total_steps=6,
               latch=(0, 3))


def _wrapped_train_group(monkeypatch, wrap):
    import torchft_tpu_torch.examples.train_ddp as train_ddp

    real = train_ddp.train_group
    monkeypatch.setattr(train_ddp, "train_group",
                        lambda cfg, **kw: real(cfg, **wrap(kw)))


def test_churn_oracle_catches_a_dead_life_kept_alive(monkeypatch) -> None:
    # a hook that keeps every life's model, as a leak would: the dead
    # life's parameters outlive it and the drill fails
    kept = []

    def wrap(kw):
        inner = kw["on_commit"]

        def on_commit(step, manager, model, loss):
            kept.append(model)
            inner(step, manager, model, loss)
        return dict(kw, on_commit=on_commit)

    _wrapped_train_group(monkeypatch, wrap)
    with pytest.raises(AssertionError, match="outlived it"):
        _drill(groups=3, kills=((1, 2),), min_replicas=2, total_steps=6)
    assert kept


def test_churn_oracle_catches_a_kill_that_fires_twice(monkeypatch) -> None:
    # group 1's restarted life is armed again with the kill its first
    # life already took: it dies after its heal, and the oracle counts
    # the kill twice
    def wrap(kw):
        if kw["replica_group"] == 1 and kw["fail_at_step"] is None:
            kw = dict(kw, fail_at_step=2)
        return kw

    _wrapped_train_group(monkeypatch, wrap)
    with pytest.raises(AssertionError, match=r"kills fired .*\(1, 2\): 2"):
        _drill(groups=3, kills=((1, 2),), min_replicas=2, total_steps=6)
