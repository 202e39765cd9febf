"""The port's LocalSGD/DiLoCo with the real control plane, against the JAX
package's (twins of tests/test_integration_localsgd.py).

Real Managers over a live lighthouse and loopback TCP wires, on the CPU:
two replicas stay consistent under LocalSGD and DiLoCo, and recover after a
kill. The example's drill (``run_diloco_drill``) runs at "tiny": two DiLoCo
groups through a kill, a poisoned restart and a heal at the next round's
fence, and four LocalSGD groups on the cuda plane's int8 psum (on the CPU)
through a fragment op that fails on one group, whose outcome, round by
round, is the JAX package's for the same schedule. A mixed cohort (one
JAX-package rank and one port rank over their own TCP contexts) ends every
round with bitwise-equal parameters, and a leased LocalSGD round whose
fragment ops fail never commits.
"""

import logging
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict

import numpy as np
import torch

from tests.test_torch_local_sgd import (
    _KEYS,
    _PortWireStub,
    _increments,
    _jax_params,
    _port_params,
    _snap_jax,
    _snap_port,
)
from torchft_tpu.comm import StoreServer as JaxStoreServer
from torchft_tpu.comm import TcpCommContext as JaxTcp
from torchft_tpu.comm.context import ErrorSwallowingCommContext as JaxSwallow
from torchft_tpu.comm.context import Work as JaxWork
from torchft_tpu.comm.wire_stub import WireStubManager as JaxWireStub
from torchft_tpu.control import Lighthouse as JaxLighthouse
from torchft_tpu.local_sgd import LocalSGD as JaxLocalSGD
from torchft_tpu.manager import Manager as JaxManager
from torchft_tpu_torch import optim as outer
from torchft_tpu_torch.comm.store import StoreServer
from torchft_tpu_torch.comm.transport import TcpCommContext
from torchft_tpu_torch.control import Lighthouse
from torchft_tpu_torch.examples.train_diloco import (
    FaultyCommContext,
    run_diloco_drill,
)
from torchft_tpu_torch.local_sgd import DiLoCo, LocalSGD
from torchft_tpu_torch.manager import Manager
from torchft_tpu_torch.models import CONFIGS

logger = logging.getLogger(__name__)


class _Stop(Exception):
    pass


def _run_local_sgd_replicas(num_replicas, total_syncs, algorithm,
                            kill_replica=None, kill_at_sync=2, sync_every=3,
                            timeout=120.0):
    """The reference harness over the port: ``w`` (4 f32) decays toward 8
    by inner steps identical on every replica; the wrapper's state rides
    every heal."""
    lighthouse = Lighthouse(min_replicas=num_replicas, join_timeout_ms=200,
                            heartbeat_timeout_ms=1000)
    histories: Dict[int, Dict[int, np.ndarray]] = {
        i: {} for i in range(num_replicas)}
    stop = threading.Event()
    sync_counts = {i: 0 for i in range(num_replicas)}
    killed = {"count": 0}

    def replica(rid: int) -> None:
        store = StoreServer()
        w = torch.zeros(4, dtype=torch.float32)
        wrapper_ref = {}

        def state_dict():
            sd = {"params": [w.clone()]}
            if "w" in wrapper_ref:
                sd["wrapper"] = wrapper_ref["w"].state_dict()
            return sd

        def load_state_dict(sd):
            w.copy_(sd["params"][0])
            if "wrapper" in sd and "w" in wrapper_ref:
                wrapper_ref["w"].load_state_dict(sd["wrapper"])

        manager = Manager(
            comm=TcpCommContext(timeout=5.0),
            load_state_dict=load_state_dict, state_dict=state_dict,
            min_replica_size=num_replicas, use_async_quorum=False,
            timeout=5.0, quorum_timeout=10.0, connect_timeout=5.0,
            rank=0, world_size=1, store_addr=store.addr,
            lighthouse_addr=lighthouse.address(),
            replica_id=f"lsgd_{rid}_", heartbeat_interval=0.05,
        )
        if algorithm == "local_sgd":
            wrapper = LocalSGD(manager, sync_every=sync_every,
                               params_fn=lambda: [w])
        else:
            wrapper = DiLoCo(manager, outer.sgd(0.7), sync_every=sync_every,
                             params_fn=lambda: [w])
        wrapper_ref["w"] = wrapper
        wrapper.register([w])
        try:
            while not stop.is_set():
                if (rid == kill_replica and killed["count"] == 0
                        and sync_counts[rid] == kill_at_sync):
                    killed["count"] += 1
                    raise _Stop()
                w.copy_(w + 0.25 * (8.0 - w))
                wrapper.step()
                if wrapper.local_step == 0:
                    sync_counts[rid] += 1
                    histories[rid][sync_counts[rid]] = w.numpy().copy()
                    if (sync_counts[rid] >= total_syncs and all(
                            c >= total_syncs for c in sync_counts.values())):
                        stop.set()
                time.sleep(0.01)
        except _Stop:
            manager.shutdown(wait=False)
            store.shutdown()
            time.sleep(0.3)
            return replica(rid)  # restart: the heal path
        manager.shutdown(wait=False)
        store.shutdown()

    try:
        with ThreadPoolExecutor(max_workers=num_replicas) as pool:
            futs = [pool.submit(replica, i) for i in range(num_replicas)]
            deadline = time.monotonic() + timeout
            for f in futs:
                f.result(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        stop.set()
        lighthouse.shutdown()
    return histories, killed["count"]


def _assert_bitwise(histories, syncs, what):
    for s in syncs:
        assert histories[0][s].tobytes() == histories[1][s].tobytes(), (
            f"{what}: divergence at sync {s}")


def test_local_sgd_two_replicas_consistent() -> None:
    histories, _ = _run_local_sgd_replicas(2, 4, "local_sgd")
    common = set(histories[0]) & set(histories[1])
    assert len(common) >= 3
    _assert_bitwise(histories, common, "local_sgd")
    last = max(histories[0])
    assert abs(float(histories[0][last][0]) - 8.0) < 8.0  # converging


def test_diloco_two_replicas_consistent() -> None:
    histories, _ = _run_local_sgd_replicas(2, 4, "diloco")
    common = set(histories[0]) & set(histories[1])
    assert len(common) >= 3
    _assert_bitwise(histories, common, "diloco")


def test_local_sgd_recovery_after_kill() -> None:
    histories, kill_count = _run_local_sgd_replicas(
        2, 5, "local_sgd", kill_replica=0, kill_at_sync=2, timeout=180.0)
    assert kill_count == 1
    common = sorted(set(histories[0]) & set(histories[1]))
    post = [s for s in common if s >= 3]
    assert post, f"no post-recovery syncs to compare: {common}"
    _assert_bitwise(histories, post, "after recovery")


# ------------------------------------------------- the example's drills


def test_diloco_drill_tiny_kill_and_heal() -> None:
    # the chip's train_diloco schedule at "tiny": group 1 killed at inner
    # step 4 of round 3, group 0 commits round 3 alone, group 1 restarts
    # poisoned, heals at round 4's fence, both commit rounds 4 and 5
    result = run_diloco_drill(CONFIGS["tiny"], device="cpu", batch_size=2,
                              timeout=30.0)
    assert result["checked_rounds"] == {1: 2, 2: 2, 4: 2, 5: 2}
    survivor, (first, restarted) = result["runs"][0][0], result["runs"][1]
    assert survivor.rounds == [(s, True) for s in range(1, 6)]
    assert survivor.wire_rounds == 4  # round 3 had no peer
    assert first.rounds == [(1, True), (2, True)] and first.passes == 19
    assert restarted.rounds == [(4, True), (5, True)]
    assert restarted.healed_at == [4]
    assert result["passes"] == 40 + 19 + 16  # no graph warm-up on the CPU
    m = survivor.metrics
    for name in ("outer_d2h", "outer_wire", "outer_land"):
        assert m[f"{name}_p50_ms"] >= 0.0
    assert 0.0 <= m["outer_overlap"] <= 1.0
    assert restarted.metrics["heal_wall_ms"] > 0.0


def _fault_outcome(runs):
    return {g: [r.rounds for r in runs[g]] for g in runs}


def test_localsgd_int8_drill_tiny_fault() -> None:
    # the chip's train_localsgd_int8 schedule at "tiny": four groups on the
    # cuda plane (on the CPU), psum int8 with error feedback; group 3's
    # second fragment op of round 2 fails after the collective ran
    result = run_diloco_drill(
        CONFIGS["tiny"], algo="local_sgd", groups=4, rounds=3, kill=None,
        fault=(3, 4), record_ops=(1, 2), device="cpu", batch_size=2,
        timeout=30.0, comm_backend="cuda",
        comm_options={"algorithm": "psum", "compression": "int8"})
    assert _fault_outcome(result["runs"]) == _REFERENCE_FAULT_OUTCOME
    assert result["checked_rounds"] == {1: 4, 2: 3, 3: 4}
    for g in range(4):
        run = result["runs"][g][0]
        assert run.metrics["comm_encoded_bytes"] > 0
        assert "outer_ef_p50_ms" in run.metrics  # psum: every rank's EF
        assert sorted(result["recorded"][g]) == [1, 2]
    assert result["runs"][3][0].healed_at == [1, 3]


# What the JAX package does on the same schedule (pinned by the next
# test): the faulted group alone aborts round 2 and heals in round 3.
_REFERENCE_FAULT_OUTCOME = {
    0: [[(1, True), (2, True), (3, True)]],
    1: [[(1, True), (2, True), (3, True)]],
    2: [[(1, True), (2, True), (3, True)]],
    3: [[(1, True), (1, False), (3, True)]],
}


class _JaxFaulty(JaxSwallow):
    """The JAX package's twin of ``FaultyCommContext``: runs every op and
    fails the ``fail_at_op``-th after it completed."""

    def __init__(self, inner, fail_at_op=None):
        super().__init__(inner)
        self.fail_at_op = fail_at_op
        self.ops = 0

    def errored(self):
        return self._inner.errored()

    def allreduce(self, arrays, op="sum", topology=None):
        self.ops += 1
        inner = self._inner.allreduce(arrays, op, topology=topology).future()
        if self.ops != self.fail_at_op:
            return JaxWork(inner)
        out = Future()
        out.set_running_or_notify_cancel()

        def _done(f):
            if f.exception() is not None:
                out.set_exception(f.exception())
            else:
                out.set_exception(RuntimeError("injected allreduce fault"))

        inner.add_done_callback(_done)
        return JaxWork(out)


def test_reference_outcome_of_the_fault_schedule() -> None:
    # four JAX-package LocalSGD groups with real Managers, sync_every 8 and
    # 2 fragments, group 3's 4th fragment op failing: the outcome the port's
    # drill must reproduce
    lighthouse = JaxLighthouse(min_replicas=1, join_timeout_ms=200,
                               heartbeat_timeout_ms=1000)
    rounds = {g: [] for g in range(4)}
    ready = threading.Barrier(4, timeout=30)

    def group(g):
        store = JaxStoreServer()
        holder = {"p": _jax_params()}
        wrapper_ref = {}

        def state_dict():
            return {"p": holder["p"], "w": wrapper_ref["w"].state_dict()}

        def load_state_dict(sd):
            holder["p"] = sd["p"]
            wrapper_ref["w"].load_state_dict(sd["w"])

        manager = JaxManager(
            comm=_JaxFaulty(JaxTcp(timeout=10.0),
                            fail_at_op=4 if g == 3 else None),
            load_state_dict=load_state_dict, state_dict=state_dict,
            min_replica_size=1, use_async_quorum=False, timeout=10.0,
            quorum_timeout=30.0, connect_timeout=10.0, rank=0, world_size=1,
            store_addr=store.addr, lighthouse_addr=lighthouse.address(),
            replica_id=f"ref_fault_{g}_", heartbeat_interval=0.05)
        wrapper = JaxLocalSGD(manager, sync_every=8, num_fragments=2,
                              params_fn=lambda: holder["p"])
        wrapper_ref["w"] = wrapper
        holder["p"] = wrapper.register(holder["p"])
        incs = _increments(g, 8)
        try:
            ready.wait()
            t = 0
            while manager.current_step() < 3:
                p = holder["p"]
                holder["p"] = {k: p[k] + incs[t % 8][k] for k in p}
                t += 1
                before = manager.current_step()
                holder["p"] = wrapper.step(holder["p"])
                if wrapper.local_step == 0:
                    step = manager.current_step()
                    rounds[g].append((step, step > before))
        finally:
            manager.shutdown(wait=False)
            store.shutdown()

    try:
        with ThreadPoolExecutor(max_workers=4) as pool:
            for f in [pool.submit(group, g) for g in range(4)]:
                f.result(timeout=120)
    finally:
        lighthouse.shutdown()
    assert {g: [r] for g, r in rounds.items()} == _REFERENCE_FAULT_OUTCOME


# ---------------------------------------------------------- mixed cohort


def test_mixed_cohort_round_bitwise() -> None:
    # rank 0 runs the JAX package's LocalSGD over its TcpCommContext, rank 1
    # the port's over the port's, at codec none: every round both end with
    # the same bits (and the same bits as a JAX-only cohort)
    def run(kinds):
        store = JaxStoreServer()
        ctxs = [(JaxTcp if k == "jax" else TcpCommContext)(timeout=15.0)
                for k in kinds]
        outs = [None, None]

        def worker(rank):
            ctx = ctxs[rank]
            ctx.configure(f"{store.addr}/mixed_{'_'.join(kinds)}", rank, 2)
            incs = _increments(rank, 8)
            per_round = []
            if kinds[rank] == "jax":
                wrapper = JaxLocalSGD(JaxWireStub(ctx, 2), sync_every=4,
                                      num_fragments=2)
                params = wrapper.register(_jax_params())
                for t in range(8):
                    params = {k: params[k] + incs[t][k] for k in params}
                    params = wrapper.step(params)
                    if wrapper.local_step == 0:
                        per_round.append(_snap_jax(params))
            else:
                wrapper = LocalSGD(_PortWireStub(ctx, 2), sync_every=4,
                                   num_fragments=2)
                params = _port_params()
                wrapper.register(params)
                for t in range(8):
                    for k, p in zip(_KEYS, params):
                        p.add_(torch.from_numpy(incs[t][k]))
                    wrapper.step()
                    if wrapper.local_step == 0:
                        per_round.append(_snap_port(params))
            outs[rank] = per_round

        try:
            with ThreadPoolExecutor(max_workers=2) as ex:
                for f in [ex.submit(worker, r) for r in range(2)]:
                    f.result(timeout=60)
        finally:
            for c in ctxs:
                c.shutdown()
            store.shutdown()
        return outs

    mixed = run(("jax", "port"))
    reference = run(("jax", "jax"))
    assert len(mixed[0]) == len(mixed[1]) == 2
    for t in range(2):
        for k in _KEYS:
            assert mixed[0][t][k].tobytes() == mixed[1][t][k].tobytes(), (t, k)
            assert mixed[0][t][k].tobytes() == reference[0][t][k].tobytes()


# ------------------------------------------------- the epoch lease (R2)


def test_leased_round_with_failed_fragment_ops_never_commits(
        monkeypatch) -> None:
    # R2's guard for a LocalSGD round: a round on a live lease whose
    # fragment ops fail never commits on the wire's vote; it takes the full
    # barrier, discards, rolls back bitwise, and the next rounds commit
    monkeypatch.setenv("TORCHFT_TPU_FASTPATH", "1")
    lighthouse = Lighthouse(min_replicas=1, join_timeout_ms=100,
                            quorum_tick_ms=10, lease_ms=2000)
    store = StoreServer()
    comm = FaultyCommContext(TcpCommContext(timeout=10.0))
    manager = Manager(
        comm=comm, min_replica_size=1, rank=0, world_size=1,
        store_addr=store.addr, lighthouse_addr=lighthouse.address(),
        replica_id="lsgd_lease_", timeout=20.0, quorum_timeout=20.0,
        connect_timeout=20.0, heartbeat_interval=0.05,
        use_async_quorum=False)
    try:
        wrapper = LocalSGD(manager, sync_every=2, num_fragments=2)
        params = _port_params()
        wrapper.register(params)

        def round_():
            for _ in range(2):
                for p in params:
                    p.add_(0.5)
                wrapper.step()
            assert wrapper.local_step == 0

        round_()
        round_()
        assert manager.current_step() == 2
        assert manager.control_rpcs() == 0  # round 2 rode the lease
        synced = _snap_port(params)
        # round 3's first fragment op fails after its collective ran (its
        # vote byte said healthy). Whether the second reaches the wire
        # depends on the schedule: the Manager skips it only once the
        # first op's failure has latched, and the TCP op samples its vote
        # byte when it runs, after that latch
        ops_before = comm.ops
        comm.fail_at_op = ops_before + 1
        round_()
        second_shipped = comm.ops - ops_before == 2
        assert manager.current_step() == 2  # discarded on the barrier
        assert manager.control_rpcs() >= 1
        for k, p in zip(_KEYS, params):
            assert p.numpy().tobytes() == synced[k].tobytes(), k
        reasons = [e.get("reason") for e in manager.events.since(0)[0]
                   if e["kind"] == "lease_break"]
        assert reasons
        if second_shipped:
            # the second op carried this rank's unhealthy vote byte
            assert reasons[-1] == "vote_dissent", reasons
        else:
            # no op after the failure voted: the local ballot decides
            assert reasons[-1] in ("local_vote_false", "vote_absent"), reasons
        round_()
        round_()
        assert manager.current_step() == 4
    finally:
        manager.shutdown(wait=False)
        store.shutdown()
        lighthouse.shutdown()
