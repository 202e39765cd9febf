"""The port's zero-RPC steady-state fast path against the JAX package's.

Twins of tests/test_fastpath.py over the port's Manager and TCP wire:
epoch-leased quorum plus data-plane commit votes, so while a lease is live
a step makes no control RPC; every invalidation edge (epoch bump, latch,
lease expiry, an absent or dissenting vote) falls back to the full quorum
and barrier, never commits on weaker evidence and never hangs. Real native
lighthouse, HTTP control plane and loopback TCP wires throughout.

The mixed cohort runs a JAX-package Manager over its own TcpCommContext
and a port Manager over the port's, under one lease-granting lighthouse:
both reach 0 control RPCs per steady step, decide every commit alike and
reduce to the same bytes.
"""

import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from torchft_tpu_torch.comm.cuda_backend import CudaCommContext, DevicePool
from torchft_tpu_torch.comm.store import StoreServer
from torchft_tpu_torch.comm.transport import TcpCommContext
from torchft_tpu_torch.control import Lighthouse, LighthouseClient
from torchft_tpu_torch.manager import Manager


@pytest.fixture(autouse=True)
def _fastpath_env(monkeypatch):
    monkeypatch.setenv("TORCHFT_TPU_FASTPATH", "1")


@pytest.fixture()
def lease_lighthouse():
    lh = Lighthouse(min_replicas=1, join_timeout_ms=100, quorum_tick_ms=10,
                    lease_ms=2000)
    yield lh
    lh.shutdown()


@pytest.fixture()
def store():
    server = StoreServer()
    yield server
    server.shutdown()


def _make_solo(store, lighthouse, replica_id="fp_rep_", **kwargs):
    defaults = dict(
        min_replica_size=1, rank=0, world_size=1, store_addr=store.addr,
        lighthouse_addr=lighthouse.address(), replica_id=replica_id,
        timeout=20.0, quorum_timeout=20.0, connect_timeout=20.0,
        heartbeat_interval=0.05, use_async_quorum=False,
    )
    defaults.update(kwargs)
    return Manager(**defaults)


def _step(manager):
    manager.start_quorum(allow_heal=False)
    manager.allreduce_arrays([np.ones(8, np.float32)]).future().result(
        timeout=20)
    return manager.should_commit()


def _break_reasons(manager):
    return [e.get("reason") for e in manager.events.since(0)[0]
            if e["kind"] == "lease_break"]


def _wait_lease_broken(manager, timeout=5.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if not manager.lease_live():
            return True
        time.sleep(0.02)
    return False


def _stranger_heartbeat(lighthouse, rid="stranger"):
    """A heartbeat from an unrelated replica id grows the membership, so
    the lighthouse bumps the epoch and every parked EpochWatch fires."""
    LighthouseClient(lighthouse.address()).heartbeat(rid)


def test_steady_state_steps_are_zero_rpc(store, lease_lighthouse) -> None:
    manager = _make_solo(store, lease_lighthouse)
    try:
        # step 0 pays the full path and arms the lease; every later step
        # makes no control RPC
        assert _step(manager)
        assert manager.control_rpcs() >= 2
        for i in range(1, 5):
            assert _step(manager), f"step {i} did not commit"
            assert manager.control_rpcs() == 0, i
        snap = manager.metrics.snapshot()
        assert snap["fastpath_steps"] == 4.0
        assert snap["fallback_steps"] == 1.0
        assert snap["lease_grants"] >= 1.0
        assert snap["control_rpcs_per_step"] == 0.0
        assert snap["quorum_fast_p50_ms"] < snap["quorum_p50_ms"]
        assert manager.current_step() == 5
        info = manager._telemetry_info()
        assert info["lease_live"] is True
        assert isinstance(info["lease_epoch"], int)
        assert info["control_rpcs_per_step"] == 0
    finally:
        manager.shutdown(wait=False)


@pytest.mark.parametrize("lever", ["0", "false"])
def test_fastpath_disabled_by_env(store, lease_lighthouse, monkeypatch,
                                  lever) -> None:
    monkeypatch.setenv("TORCHFT_TPU_FASTPATH", lever)
    manager = _make_solo(store, lease_lighthouse, replica_id="fp_off_")
    try:
        for _ in range(3):
            assert _step(manager)
            assert manager.control_rpcs() >= 2
        snap = manager.metrics.snapshot()
        assert snap.get("fastpath_steps") is None
        assert snap.get("lease_grants") is None
    finally:
        manager.shutdown(wait=False)


def test_epoch_bump_mid_vote_falls_back(store, lease_lighthouse) -> None:
    # the vote is on the wire when the epoch moves: should_commit must not
    # consume it; the step re-runs the full barrier
    manager = _make_solo(store, lease_lighthouse, replica_id="fp_bump_")
    try:
        assert _step(manager)
        assert _step(manager) and manager.control_rpcs() == 0
        step_before = manager.current_step()
        manager.start_quorum(allow_heal=False)
        assert manager._fastpath_active
        manager.allreduce_arrays([np.ones(8, np.float32)]).future().result(
            timeout=20)
        _stranger_heartbeat(lease_lighthouse)
        assert _wait_lease_broken(manager), "epoch bump did not break lease"
        assert manager.should_commit()
        assert manager.control_rpcs() >= 1
        assert manager.current_step() == step_before + 1
        assert "epoch_advanced" in _break_reasons(manager)
    finally:
        manager.shutdown(wait=False)


def test_latch_edge_during_local_start_quorum(store, lease_lighthouse) -> None:
    manager = _make_solo(store, lease_lighthouse, replica_id="fp_latch_")
    try:
        assert _step(manager)
        assert _step(manager) and manager.control_rpcs() == 0
        manager.report_error(RuntimeError("latched between steps"))
        manager.start_quorum(allow_heal=False)
        assert not manager._fastpath_active
        assert manager.control_rpcs() >= 1
        assert "latch_edge" in _break_reasons(manager)
        manager.allreduce_arrays([np.ones(8, np.float32)]).future().result(
            timeout=20)
        assert manager.should_commit()
        assert manager.control_rpcs() >= 2
    finally:
        manager.shutdown(wait=False)


def test_injected_error_mid_lease_never_fast_commits(
        store, lease_lighthouse) -> None:
    manager = _make_solo(store, lease_lighthouse, replica_id="fp_err_")
    try:
        assert _step(manager)
        assert _step(manager) and manager.control_rpcs() == 0
        manager.start_quorum(allow_heal=False)
        assert manager._fastpath_active
        manager.allreduce_arrays([np.ones(8, np.float32)]).future().result(
            timeout=20)
        manager.report_error(RuntimeError("fault after the collective"))
        assert manager.should_commit() is False
        assert not manager.lease_live()
        snap = manager.metrics.snapshot()
        assert snap["steps_discarded"] >= 1.0
        assert snap["lease_breaks"] >= 1.0
        assert "local_vote_false" in _break_reasons(manager)
        assert _step(manager)
        assert _step(manager) and manager.control_rpcs() == 0
    finally:
        manager.shutdown(wait=False)


def test_lease_expiry_racing_should_commit(store, lease_lighthouse) -> None:
    manager = _make_solo(store, lease_lighthouse, replica_id="fp_exp_")
    try:
        assert _step(manager)
        assert _step(manager) and manager.control_rpcs() == 0
        manager.start_quorum(allow_heal=False)
        assert manager._fastpath_active
        manager.allreduce_arrays([np.ones(8, np.float32)]).future().result(
            timeout=20)
        with manager._lease_lock:
            manager._lease_deadline = 0.0
        assert manager.should_commit()
        assert manager.control_rpcs() >= 1
        assert "lease_expired" in _break_reasons(manager)
    finally:
        manager.shutdown(wait=False)


def test_step_without_a_collective_falls_back_on_an_absent_vote(
        store, lease_lighthouse) -> None:
    # a fused step runs no collective: no vote, so the full barrier
    manager = _make_solo(store, lease_lighthouse, replica_id="fp_absent_")
    try:
        assert _step(manager)
        manager.start_quorum(allow_heal=False)
        assert manager._fastpath_active
        assert manager.should_commit()
        assert manager.control_rpcs() == 1
        assert _break_reasons(manager) == ["vote_absent"]
    finally:
        manager.shutdown(wait=False)


def test_kill_mid_lease_before_vote_lands(lease_lighthouse) -> None:
    # two replicas under one lease; the second dies mid-step (after the
    # lease check, before its vote reaches the wire): the survivor discards
    # exactly that step, then commits solo once the dead peer ages out
    stores = [StoreServer(), StoreServer()]
    managers = [None, None]
    barrier = threading.Barrier(2, timeout=60.0)
    kill_at, post_kill = 3, 6
    results = [None, None]

    def _replica(idx: int) -> None:
        mgr = Manager(min_replica_size=1, rank=0, world_size=1,
                      store_addr=stores[idx].addr,
                      lighthouse_addr=lease_lighthouse.address(),
                      replica_id=f"fp_kill{idx}_", timeout=5.0,
                      quorum_timeout=5.0, connect_timeout=5.0,
                      heartbeat_interval=0.05, use_async_quorum=False)
        managers[idx] = mgr
        commits = discards = post_kill_commits = 0
        for step in range(kill_at + post_kill):
            if step <= kill_at:
                barrier.wait()
            if idx == 1 and step == kill_at:
                mgr.start_quorum(allow_heal=False)
                mgr.shutdown(wait=False)
                break
            mgr.start_quorum(allow_heal=False)
            mgr.allreduce_arrays([np.ones(8, np.float32)]).future().result(
                timeout=30)
            if mgr.should_commit():
                commits += 1
                if step > kill_at:
                    post_kill_commits += 1
            else:
                discards += 1
                time.sleep(0.5)  # let the dead peer age out
        results[idx] = {"commits": commits, "discards": discards,
                        "post_kill_commits": post_kill_commits}

    threads = [threading.Thread(target=_replica, args=(i,)) for i in range(2)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120.0)
            assert not t.is_alive(), "replica hung after mid-lease kill"
    finally:
        for mgr in managers:
            if mgr is not None:
                try:
                    mgr.shutdown(wait=False)
                except Exception:  # noqa: BLE001
                    pass
        for s in stores:
            s.shutdown()
    survivor = results[0]
    assert survivor is not None
    assert survivor["discards"] == 1
    assert survivor["post_kill_commits"] >= 2
    # the dead replica's shutdown broke its lease and stopped its watcher
    dead = managers[1]
    assert not dead.lease_live()
    assert dead._lease_thread is None or not dead._lease_thread.is_alive()


def test_epoch_watch_renews_and_reports_change(store, lease_lighthouse) -> None:
    manager = _make_solo(store, lease_lighthouse, replica_id="fp_watch_")
    try:
        assert _step(manager)
        epoch = manager._lease_epoch
        assert epoch is not None
        t0 = time.monotonic()
        new_epoch, changed = manager._client.epoch_watch(epoch, timeout=0.3)
        assert not changed and new_epoch == epoch
        assert time.monotonic() - t0 >= 0.1  # it parked, not spun
        waker = threading.Timer(0.2, _stranger_heartbeat,
                                (lease_lighthouse, "watch_stranger"))
        waker.start()
        try:
            new_epoch, changed = manager._client.epoch_watch(epoch,
                                                             timeout=10.0)
        finally:
            waker.join()
        assert changed and new_epoch > epoch
    finally:
        manager.shutdown(wait=False)


def test_lighthouse_without_lease_grants_none(store) -> None:
    lh = Lighthouse(min_replicas=1, join_timeout_ms=100)
    manager = _make_solo(store, lh, replica_id="fp_nolease_")
    try:
        for _ in range(3):
            assert _step(manager)
            assert manager.control_rpcs() >= 2
        assert manager.metrics.snapshot().get("lease_grants") is None
    finally:
        manager.shutdown(wait=False)
        lh.shutdown()


# ------------------------------------------------------- vote wire semantics


_CPU_POOL = DevicePool("cpu")


def _make_ctx(kind: str):
    """A context of ``kind``: "port" (the port's TCP wire), "jax" (the JAX
    package's) or "cuda" (the port's device plane, run on the CPU)."""
    from torchft_tpu.comm.transport import TcpCommContext as JaxTcp

    if kind == "cuda":
        # the ranks of one group must share a pool (its device and plans)
        return CudaCommContext(timeout=10.0, device_pool=_CPU_POOL)
    return (TcpCommContext if kind == "port" else JaxTcp)(timeout=10.0)


def _run_ranks(store, world_size, fn, prefix="vote", kinds=None):
    kinds = kinds or ("port",) * world_size
    ctxs = [_make_ctx(k) for k in kinds]
    results = [None] * world_size

    def _worker(rank):
        ctxs[rank].configure(f"{store.addr}/{prefix}", rank, world_size)
        results[rank] = fn(ctxs[rank], rank)

    with ThreadPoolExecutor(max_workers=world_size) as pool:
        for f in [pool.submit(_worker, r) for r in range(world_size)]:
            f.result(timeout=30)
    for ctx in ctxs:
        ctx.shutdown()
    return results


@pytest.mark.parametrize("kinds", [("port", "port"), ("port", "jax"),
                                   ("jax", "port"), ("port", "jax", "port"),
                                   ("port",), ("cuda", "cuda"),
                                   ("cuda", "cuda", "cuda"), ("cuda",)])
def test_take_commit_vote_semantics(store, kinds) -> None:
    # absent -> None; all healthy -> True on every rank; one dissenter ->
    # False on every rank (the vote rides the collective); consumed once.
    # Mixed with the JAX package's wire, star and ring: the same verdicts.
    # The device plane folds the same votes into its group rendezvous.
    world = len(kinds)
    dissenter = world - 1

    def _fn(ctx, rank):
        out = {"initial": ctx.take_commit_vote()}
        ctx.allreduce([np.ones(4, np.float32)]).future().result(timeout=10)
        out["healthy"] = ctx.take_commit_vote()
        out["consumed"] = ctx.take_commit_vote()
        if rank == dissenter:
            ctx.set_vote_health(lambda: False)
        ctx.allreduce([np.ones(4, np.float32)]).future().result(timeout=10)
        out["dissent"] = ctx.take_commit_vote()
        return out

    for r in _run_ranks(store, world, _fn, kinds=kinds):
        assert r["initial"] is None
        assert r["healthy"] is True
        assert r["consumed"] is None
        assert r["dissent"] is False


def test_a_raising_health_provider_votes_unhealthy(store) -> None:
    def _fn(ctx, rank):
        def broken():
            raise RuntimeError("provider down")

        ctx.set_vote_health(broken)
        ctx.allreduce([np.ones(4, np.float32)]).future().result(timeout=10)
        return ctx.take_commit_vote()

    assert _run_ranks(store, 2, _fn) == [False, False]


def test_vote_window_under_concurrent_lanes() -> None:
    # every lane thread records its op's vote while the Manager takes the
    # window: no vote is lost, and one dissent anywhere makes it False
    import sys

    ctx = TcpCommContext(timeout=10.0)
    threads, per = 16, 500
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(
            target=lambda t=t: [ctx._record_vote(int(t == 7 and i == 250))
                                for i in range(per)]) for t in range(threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=30)
            assert not w.is_alive()
    finally:
        sys.setswitchinterval(interval)
    assert ctx._vote_ops == threads * per
    assert ctx.take_commit_vote() is False
    assert ctx.take_commit_vote() is None


def test_vote_window_resets_on_configure(store) -> None:
    def _fn(ctx, rank):
        ctx.allreduce([np.ones(4, np.float32)]).future().result(timeout=10)
        ctx.configure(f"{store.addr}/vote2", rank, 2)
        return ctx.take_commit_vote()

    assert _run_ranks(store, 2, _fn) == [None, None]


# ------------------------------------------------------------ mixed cohort


def test_mixed_cohort_steady_steps_are_zero_rpc(lease_lighthouse) -> None:
    from torchft_tpu.comm.transport import TcpCommContext as JaxTcp
    from torchft_tpu.manager import Manager as JaxManager

    steps = 5
    stores = [StoreServer(), StoreServer()]
    kinds = ("jax", "port")
    managers = [None, None]
    out = {k: {"commits": [], "rpcs": [], "reduced": []} for k in kinds}
    barrier = threading.Barrier(2, timeout=60.0)

    def _replica(idx: int) -> None:
        kind = kinds[idx]
        cls, comm = ((JaxManager, JaxTcp(timeout=20.0)) if kind == "jax"
                     else (Manager, TcpCommContext(timeout=20.0)))
        mgr = cls(comm=comm, min_replica_size=1, rank=0, world_size=1,
                  store_addr=stores[idx].addr,
                  lighthouse_addr=lease_lighthouse.address(),
                  replica_id=f"mixed_{kind}_", timeout=20.0,
                  quorum_timeout=20.0, connect_timeout=20.0,
                  heartbeat_interval=0.05, use_async_quorum=False)
        managers[idx] = mgr
        rng = np.random.default_rng(100 + idx)
        for _ in range(steps):
            barrier.wait()
            mgr.start_quorum(allow_heal=False)
            arrays = [rng.standard_normal(3000).astype(np.float32),
                      rng.standard_normal(17).astype(np.float32)]
            reduced = mgr.allreduce_arrays(arrays).future().result(timeout=30)
            out[kind]["reduced"].append([a.tobytes() for a in reduced])
            out[kind]["commits"].append(mgr.should_commit())
            out[kind]["rpcs"].append(mgr._control_rpcs)

    threads = [threading.Thread(target=_replica, args=(i,)) for i in range(2)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120.0)
            assert not t.is_alive()
    finally:
        for mgr in managers:
            if mgr is not None:
                mgr.shutdown(wait=False)
        for s in stores:
            s.shutdown()
    jax_run, port_run = out["jax"], out["port"]
    assert jax_run["commits"] == port_run["commits"] == [True] * steps
    assert jax_run["reduced"] == port_run["reduced"]
    # the first step takes the full path (it grants the leases); every
    # steady step after it rides the lease on both sides
    assert port_run["rpcs"][0] >= 2 and jax_run["rpcs"][0] >= 2
    assert port_run["rpcs"][2:] == jax_run["rpcs"][2:] == [0] * (steps - 2)
    assert managers[1].metrics.snapshot()["fastpath_steps"] >= steps - 2


# ------------------------------------------- the device plane's vote (F6)


@pytest.mark.parametrize("case", ["raising_provider", "reduce_scatter",
                                  "resets_on_configure", "after_a_latch"])
def test_cuda_plane_vote_window(store, case) -> None:
    # CudaCommContext keeps the TCP wire's window: a raising provider votes
    # unhealthy, reduce_scatter votes as allreduce does, a configure
    # empties the window, and a failed op records no vote while the latch
    # makes this rank's next submissions vote unhealthy
    def _fn(ctx, rank):
        if case == "raising_provider":
            def broken():
                raise RuntimeError("provider down")

            ctx.set_vote_health(broken)
            ctx.allreduce([np.ones(4, np.float32)]).future().result(10)
            return ctx.take_commit_vote()
        if case == "reduce_scatter":
            ctx.reduce_scatter([np.ones(4, np.float32),
                                np.ones(4, np.float32)]).future().result(10)
            healthy = ctx.take_commit_vote()
            ctx.set_vote_health(lambda: rank != 0)
            ctx.reduce_scatter([np.ones(4, np.float32),
                                np.ones(4, np.float32)]).future().result(10)
            return healthy, ctx.take_commit_vote()
        if case == "resets_on_configure":
            ctx.allreduce([np.ones(4, np.float32)]).future().result(10)
            ctx.configure(f"{store.addr}/vote2_cuda", rank, 2)
            return ctx.take_commit_vote()
        # after_a_latch: a mismatched op fails for both ranks and records
        # nothing; the latch then votes unhealthy on the solo re-form
        bad = ctx.allreduce([np.ones(4 + rank, np.float32)]).future()
        failed = bad.exception(10) is not None
        absent = ctx.take_commit_vote()
        ctx.configure(f"{store.addr}/vote3_cuda_{rank}", 0, 1)
        ctx._error = RuntimeError("latched")
        ctx._record_vote(ctx._vote_health_bit())
        return failed, absent, ctx.take_commit_vote()

    got = _run_ranks(store, 2, _fn, prefix=f"vote_{case}",
                     kinds=("cuda", "cuda"))
    want = {"raising_provider": [False, False],
            "reduce_scatter": [(True, False), (True, False)],
            "resets_on_configure": [None, None],
            "after_a_latch": [(True, None, False), (True, None, False)]}
    assert got == want[case]


def test_cuda_plane_vote_window_under_concurrent_recorders() -> None:
    # the executor records on every member while Managers take their
    # windows: no vote is lost, one dissent makes the window False
    ctx = CudaCommContext(timeout=10.0, device_pool=DevicePool("cpu"))
    threads, per = 8, 500
    workers = [threading.Thread(
        target=lambda t=t: [ctx._record_vote(int(t == 3 and i == 100))
                            for i in range(per)]) for t in range(threads)]
    for w in workers:
        w.start()
    for w in workers:
        w.join(timeout=30)
        assert not w.is_alive()
    assert ctx._vote_ops == threads * per
    assert ctx.take_commit_vote() is False
    assert ctx.take_commit_vote() is None


@pytest.mark.parametrize("comm_options", [
    {"algorithm": "star"},
    {"algorithm": "psum", "compression": "int8"},
], ids=["star", "psum_int8"])
def test_leased_ddp_on_the_cuda_plane_is_zero_rpc(lease_lighthouse,
                                                   comm_options) -> None:
    # two groups averaging gradients with DDP over comm_backend="cuda": the
    # first step grants the leases, and every steady step after it commits
    # on the device plane's vote with no control RPC, as over TCP
    import torch

    from torchft_tpu_torch.ddp import DistributedDataParallel

    steps = 5
    stores = [StoreServer(), StoreServer()]
    pool = DevicePool("cpu")
    managers = [None, None]
    out = [{"commits": [], "rpcs": [], "grads": []} for _ in range(2)]
    barrier = threading.Barrier(2, timeout=60.0)

    def _replica(idx: int) -> None:
        mgr = Manager(comm_backend="cuda",
                      comm_options=dict(comm_options, device_pool=pool,
                                        timeout=20.0),
                      min_replica_size=1, rank=0, world_size=1,
                      store_addr=stores[idx].addr,
                      lighthouse_addr=lease_lighthouse.address(),
                      replica_id=f"cuda_lease_{idx}_", timeout=20.0,
                      quorum_timeout=20.0, connect_timeout=20.0,
                      heartbeat_interval=0.05, use_async_quorum=False)
        managers[idx] = mgr
        ddp = DistributedDataParallel(mgr)
        params = [torch.nn.Parameter(torch.zeros(300)),
                  torch.nn.Parameter(torch.zeros(7))]
        gen = torch.Generator().manual_seed(idx)
        for _ in range(steps):
            barrier.wait()
            mgr.start_quorum(allow_heal=False)
            for p in params:
                p.grad = torch.randn(p.shape, generator=gen)
            ddp.average_gradients(params)
            out[idx]["grads"].append([p.grad.clone() for p in params])
            out[idx]["commits"].append(mgr.should_commit())
            out[idx]["rpcs"].append(mgr.control_rpcs())

    errors = []

    def _guarded(idx: int) -> None:
        try:
            _replica(idx)
        except Exception as e:  # noqa: BLE001 — asserted below
            errors.append(e)
            barrier.abort()

    threads = [threading.Thread(target=_guarded, args=(i,)) for i in range(2)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120.0)
            assert not t.is_alive()
    finally:
        for mgr in managers:
            if mgr is not None:
                mgr.shutdown(wait=False)
        for s in stores:
            s.shutdown()
    assert not errors, errors
    for run in out:
        assert run["commits"] == [True] * steps
        assert run["rpcs"][0] >= 2
        assert run["rpcs"][2:] == [0] * (steps - 2), run["rpcs"]
    for a, b in zip(out[0]["grads"], out[1]["grads"]):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert managers[0].metrics.snapshot()["fastpath_steps"] >= steps - 2
