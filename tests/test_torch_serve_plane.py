"""The port's train-to-serve plane (torchft_tpu_torch/serve.py) on the CPU.

Twins of the nine tests of tests/test_serve_plane.py, with every member on
``device="cpu"``: a deploy moves exactly the planner's lower bound per
member and ``replication x`` the model in all; a holder staged at version
V answers any other version with an HTTP error; zero dropped and zero
stale answers across a kill and a concurrent deploy, read from the
``/telemetry`` surface alone; a rejoin heals from serve peers
(``deploy_train_bytes`` delta 0); growth drops nothing and the joiner
adopts a shard; ``Manager.set_commit_hook`` fires once per committed step
and never raises into it; a failed adoption latches the old version.

Against the JAX package's plane (the wire is the same): ``serve_layout``
equal over a grid of unit sizes, member counts and replication factors;
``unit_digest`` equal for the same bytes as arrays and as tensors; the
reference's publisher feeding a port cohort and the port's feeding a
reference cohort, digests and moved bytes bitwise; port answers within
``ANSWER_TOL`` of the reference replica's on the same version.
"""

import json
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from torchft_tpu import serve as ref
from torchft_tpu_torch.serve import (
    SERVE_JOB_ID,
    DeployPublisher,
    ServeCohort,
    ServingReplica,
    serve_layout,
    unit_digest,
)

N_UNITS = 8
ELEMS = 1024
# An answer is sum(unit) * x, summed in f32 (numpy's pairwise sum in the
# reference, the device's reduction in the port): |got - want| <=
# ANSWER_TOL * sum(|unit|) * |x| against a float64 sum.
ANSWER_TOL = 1e-5


def _leaves(version: int, n_units: int = N_UNITS, elems: int = ELEMS):
    rng = np.random.default_rng(100 + version)
    return [
        rng.standard_normal(elems + 8 * i).astype(np.float32)
        for i in range(n_units)
    ]


def _telemetry(addr: str, path: str = "metrics") -> dict:
    with urllib.request.urlopen(
        f"{addr}/telemetry/{path}?since=0" if path == "events"
        else f"{addr}/telemetry/{path}", timeout=5
    ) as resp:
        return json.load(resp)


def _cohort(n: int, **kw) -> ServeCohort:
    return ServeCohort(n, device="cpu", **kw)


def _check_answer(got: float, unit, x: float) -> None:
    want = float(np.sum(np.asarray(unit, np.float64))) * x
    bound = ANSWER_TOL * float(np.sum(np.abs(np.asarray(unit, np.float64)))) \
        * abs(x)
    assert abs(got - want) <= bound, (got, want, bound)


# ------------------------------------------------------------------- layout


def test_serve_layout_replication() -> None:
    unit_bytes = [int(a.nbytes) for a in _leaves(1)]
    layout = serve_layout(unit_bytes, 4, replication=2)
    for u in range(N_UNITS):
        assert len(set(layout.holders_of(u))) == 2
    covered = set()
    for m in range(4):
        covered |= set(layout.units_of(m))
    assert covered == set(range(N_UNITS))
    # replication is clamped to the member count
    solo = serve_layout(unit_bytes, 1, replication=2)
    assert set(solo.units_of(0)) == set(range(N_UNITS))
    assert SERVE_JOB_ID == ref.SERVE_JOB_ID


@pytest.mark.parametrize("n_units", [1, 3, 8, 125])
@pytest.mark.parametrize("members", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("replication", [1, 2, 3])
def test_serve_layout_equals_reference(n_units, members, replication) -> None:
    rng = np.random.default_rng(n_units * 31 + members)
    unit_bytes = [int(b) for b in rng.integers(4, 1 << 20, n_units)]
    got = serve_layout(unit_bytes, members, replication)
    want = ref.serve_layout(unit_bytes, members, replication)
    assert got.fingerprint() == want.fingerprint()
    assert {h: got.units_of(h) for h in got.holders()} == \
        {h: want.units_of(h) for h in want.holders()}


def test_unit_digest_same_for_arrays_and_tensors() -> None:
    leaves = _leaves(9)
    tensors = [torch.from_numpy(a.copy()) for a in leaves]
    assert unit_digest(tensors) == unit_digest(leaves) == \
        ref.unit_digest(leaves)
    bf16 = torch.linspace(-2, 2, 77).to(torch.bfloat16)
    assert unit_digest([bf16]) == ref.unit_digest(
        [bf16.view(torch.int16).numpy()])
    assert unit_digest([leaves[0]]) != unit_digest([leaves[1]])


# ------------------------------------------------- lower-bound byte counters


def test_deploy_moved_pinned_at_lower_bound_vs_naive() -> None:
    leaves = _leaves(1)
    unit_bytes = [int(a.nbytes) for a in leaves]
    model_bytes = sum(unit_bytes)
    pub = DeployPublisher()
    cohort = _cohort(4, replication=2)
    try:
        addr = pub.publish(1, leaves)
        moved = cohort.deploy(1, [addr], unit_bytes)
        for m in cohort.members:
            snap = m.metrics.snapshot()
            assert snap["deploy_bytes_moved"] == snap[
                "deploy_lower_bound_bytes"
            ], snap
            assert snap["deploy_bytes_moved"] > 0
        assert moved == 2 * model_bytes
        naive = 4 * model_bytes
        assert naive / moved >= 2.0
        digests = pub.digests(1)
        for m in cohort.members:
            live = m._live
            assert live is not None and live.version == 1
            for u, d in live.digests.items():
                assert d == digests[u]
                assert unit_digest(live.buffers[u]) == d
                assert live.buffers[u][0].device.type == "cpu"
            assert m.live_digests() == live.digests
    finally:
        cohort.shutdown()
        pub.close()


def test_publish_takes_tensors_and_snapshots_them() -> None:
    # the trainer keeps updating its parameters after a publish: the
    # publication is the host copy taken at the call
    params = [torch.from_numpy(a.copy()) for a in _leaves(3)]
    pub = DeployPublisher()
    try:
        pub.publish(3, params)
        want = pub.digests(3)
        for p in params:
            p.add_(1.0)
        cohort = _cohort(2, replication=2)
        try:
            cohort.deploy(3, [pub.address()], pub.unit_bytes)
            for m in cohort.members:
                for u, d in m.live_digests().items():
                    assert d == want[u]
        finally:
            cohort.shutdown()
    finally:
        pub.close()


def test_version_gate_rejects_wrong_version() -> None:
    from torchft_tpu_torch.checkpointing import RedistFetcher

    leaves = _leaves(2)
    pub = DeployPublisher()
    try:
        addr = pub.publish(2, leaves)
        good = RedistFetcher(5.0, step=2)
        try:
            got = good.fetch(addr, 0)
            assert b"".join(
                a.tobytes() for a in got
            ) == leaves[0].tobytes()
        finally:
            good.close()
        wrong = RedistFetcher(5.0, step=7)
        try:
            with pytest.raises(Exception) as ei:
                wrong.fetch(addr, 0)
            assert not isinstance(ei.value, AssertionError)
        finally:
            wrong.close()
    finally:
        pub.close()


# ------------------------------------- kill + concurrent deploy, zero loss


def test_kill_and_concurrent_deploy_zero_drop_zero_stale() -> None:
    from torchft_tpu_torch.control import Lighthouse

    lh = Lighthouse(
        min_replicas=1, join_timeout_ms=100, quorum_tick_ms=10,
        heartbeat_timeout_ms=1200, lease_ms=2000,
    )
    leaves1, leaves2 = _leaves(1), _leaves(2)
    unit_bytes = [int(a.nbytes) for a in leaves1]
    pub = DeployPublisher()
    cohort = _cohort(
        3, lighthouse_addr=lh.address(), replication=2,
        heartbeat_interval=0.1,
    )
    stop = threading.Event()
    local_drops = [0]
    answered = [0]

    def _hammer() -> None:
        u = 0
        while not stop.is_set():
            try:
                cohort.answer(u % N_UNITS, 1.0)
                answered[0] += 1
            except ConnectionError:
                local_drops[0] += 1
            u += 1

    try:
        cohort.deploy(1, [pub.publish(1, leaves1)], unit_bytes)
        t = threading.Thread(target=_hammer, daemon=True)
        t.start()
        time.sleep(0.15)
        victim = cohort.members[1]
        victim.kill()
        addr2 = pub.publish(2, leaves2)
        cohort.deploy(2, [addr2], unit_bytes)
        time.sleep(0.15)
        stop.set()
        t.join(timeout=5.0)

        assert answered[0] > 0
        assert local_drops[0] == 0

        router = _telemetry(cohort.router_address())
        members = [
            _telemetry(m.address) for m in cohort.members if m.alive
        ]
        dropped = float(router["metrics"].get("serve_dropped") or 0)
        stale = sum(
            float(t["metrics"].get("serve_stale_reads") or 0)
            for t in members
        )
        assert dropped == 0.0, router["metrics"]
        assert stale == 0.0, [t["metrics"] for t in members]
        assert float(router["metrics"].get("serve_reroutes") or 0) > 0
        ev = _telemetry(cohort.router_address(), "events")
        kinds = [e["kind"] for e in ev["events"]]
        assert "serve_reroute" in kinds
        for m, tel in zip(
            [m for m in cohort.members if m.alive], members
        ):
            assert tel["step"] == 2, tel
            mev = _telemetry(m.address, "events")
            dones = [
                e for e in mev["events"] if e["kind"] == "deploy_done"
            ]
            assert dones
            for e in dones:
                assert e["moved_bytes"] == e["lower_bound_bytes"]
            assert any(
                e["kind"] == "serve_flip" and e["step"] == 2
                for e in mev["events"]
            )
    finally:
        stop.set()
        cohort.shutdown()
        pub.close()
        lh.shutdown()


# ------------------------------------------------------ rejoin from peers


def test_rejoin_heals_from_serve_peers_not_training_job() -> None:
    leaves = _leaves(3)
    unit_bytes = [int(a.nbytes) for a in leaves]
    pub = DeployPublisher()
    cohort = _cohort(3, replication=2)
    try:
        cohort.deploy(3, [pub.publish(3, leaves)], unit_bytes)
        victim = cohort.members[0]
        before = victim.metrics.snapshot()
        victim.kill()
        assert not victim.alive
        moved = cohort.rejoin_member(0)
        after = victim.metrics.snapshot()
        train_delta = (after.get("deploy_train_bytes") or 0) - (
            before.get("deploy_train_bytes") or 0
        )
        peer_delta = (after.get("deploy_peer_bytes") or 0) - (
            before.get("deploy_peer_bytes") or 0
        )
        assert train_delta == 0.0, (before, after)
        assert peer_delta == moved > 0
        assert after["deploy_bytes_moved"] == after[
            "deploy_lower_bound_bytes"
        ]
        assert victim.version == 3
        for u in cohort.layout.units_of(0):
            v, _ = cohort.answer(u, 1.0)
            assert v == 3
        ev = victim.events.dump()["events"]
        join = [e for e in ev if e["kind"] == "serve_join"]
        assert join and join[-1]["healed_from"]
        assert victim.live_digests() == {
            u: d for u, d in pub.digests(3).items()
            if u in cohort.layout.units_of(0)}
    finally:
        cohort.shutdown()
        pub.close()


# -------------------------------------------------------------- growth


def test_growth_transition_is_drop_free_and_sharded() -> None:
    leaves1, leaves2 = _leaves(4), _leaves(5)
    unit_bytes = [int(a.nbytes) for a in leaves1]
    model_bytes = sum(unit_bytes)
    pub = DeployPublisher()
    cohort = _cohort(3, replication=2)
    stop = threading.Event()
    drops = [0]
    answered = [0]

    def _hammer() -> None:
        u = 0
        while not stop.is_set():
            try:
                cohort.answer(u % N_UNITS, 1.0)
                answered[0] += 1
            except ConnectionError:
                drops[0] += 1
            u += 1

    try:
        cohort.deploy(4, [pub.publish(4, leaves1)], unit_bytes)
        t = threading.Thread(target=_hammer, daemon=True)
        t.start()
        time.sleep(0.1)
        joiner = cohort.grow()
        pre = joiner.metrics.snapshot()
        assert not pre.get("serve_requests")
        cohort.deploy(5, [pub.publish(5, leaves2)], unit_bytes)
        time.sleep(0.1)
        stop.set()
        t.join(timeout=5.0)

        assert answered[0] > 0 and drops[0] == 0
        assert float(
            cohort.metrics.snapshot().get("serve_dropped") or 0
        ) == 0.0
        assert sum(
            float(m.metrics.snapshot().get("serve_stale_reads") or 0)
            for m in cohort.members
        ) == 0.0
        snap = joiner.metrics.snapshot()
        assert 0 < snap["deploy_bytes_moved"] < model_bytes
        assert snap["deploy_bytes_moved"] == snap[
            "deploy_lower_bound_bytes"
        ]
        assert joiner.version == 5
        assert cohort.layout is not None
        for u in cohort.layout.units_of(joiner.member_index):
            v, _ = cohort.answer(u, 1.0)
            assert v == 5
    finally:
        stop.set()
        cohort.shutdown()
        pub.close()


# ----------------------------------------------------- the train-side seam


def test_manager_commit_hook_fires_per_committed_step() -> None:
    from torchft_tpu_torch.comm.store import StoreServer
    from torchft_tpu_torch.control import Lighthouse
    from torchft_tpu_torch.manager import Manager

    lh = Lighthouse(min_replicas=1, join_timeout_ms=100)
    store = StoreServer()
    manager = None
    calls = []
    try:
        manager = Manager(
            min_replica_size=1,
            timeout=20.0, quorum_timeout=20.0, connect_timeout=20.0,
            rank=0, world_size=1,
            store_addr=store.addr,
            lighthouse_addr=lh.address(),
            replica_id="serve_hook_test_",
            heartbeat_interval=0.05,
        )
        manager.set_commit_hook(
            lambda step, parts: calls.append((step, parts))
        )
        for _ in range(3):
            manager.start_quorum(allow_heal=False)
            manager.allreduce_arrays(
                [np.ones(4, np.float32)]
            ).future().result(timeout=20)
            assert manager.should_commit()
        assert [s for s, _ in calls] == sorted(
            {s for s, _ in calls}
        ) and len(calls) == 3
        # the hook sees the step it commits, before the count moves on
        assert [s for s, _ in calls] == [0, 1, 2]
        assert manager.current_step() == 3
        assert all(p >= 1 for _, p in calls)
        manager.set_commit_hook(
            lambda step, parts: (_ for _ in ()).throw(
                RuntimeError("publish exploded")
            )
        )
        manager.start_quorum(allow_heal=False)
        manager.allreduce_arrays(
            [np.ones(4, np.float32)]
        ).future().result(timeout=20)
        assert manager.should_commit()
    finally:
        if manager is not None:
            manager.shutdown(wait=False)
        store.shutdown()
        lh.shutdown()


# ------------------------------------------------- replica-level invariants


def test_answer_paths_raise_prescriptively() -> None:
    r = ServingReplica(0, device="cpu")
    try:
        with pytest.raises(ConnectionError):  # nothing adopted yet
            r.answer(0, 1.0)
        r.kill()
        with pytest.raises(ConnectionError):
            r.answer(0, 1.0)
        with pytest.raises(ConnectionError):
            r.address
    finally:
        r.shutdown()


def test_failed_adopt_latches_old_version() -> None:
    leaves = _leaves(6)
    unit_bytes = [int(a.nbytes) for a in leaves]
    pub = DeployPublisher()
    cohort = _cohort(2, replication=2)
    try:
        cohort.deploy(6, [pub.publish(6, leaves)], unit_bytes)
        m = cohort.members[0]
        with pytest.raises(ConnectionError, match="no holder"):
            m.adopt(7, cohort.layout, unit_bytes, donor_addrs=())
        assert m.version == 6  # latched
        v, _ = m.answer(next(iter(cohort.layout.units_of(0))), 1.0)
        assert v == 6
        assert m.metrics.snapshot().get("serve_stale_reads", 0) == 0
    finally:
        cohort.shutdown()
        pub.close()


def test_failed_upload_latches_old_version(monkeypatch) -> None:
    # whole-or-latch on the device side: an upload that fails after the
    # fetch leaves V live and answering, and moves no counter
    leaves = _leaves(7)
    unit_bytes = [int(a.nbytes) for a in leaves]
    pub = DeployPublisher()
    cohort = _cohort(2, replication=2)
    try:
        cohort.deploy(7, [pub.publish(7, leaves)], unit_bytes)
        m = cohort.members[1]
        before = m.metrics.snapshot()["deploy_bytes_moved"]

        def _oom(host):
            raise RuntimeError("out of memory on the device")

        monkeypatch.setattr(m, "_upload", _oom)
        with pytest.raises(RuntimeError, match="out of memory"):
            m.adopt(8, cohort.layout, unit_bytes,
                    donor_addrs=[pub.publish(8, _leaves(8))])
        assert m.version == 7
        assert m.metrics.snapshot()["deploy_bytes_moved"] == before
        u = next(iter(cohort.layout.units_of(1)))
        v, got = m.answer(u, 2.0)
        assert v == 7
        _check_answer(got, leaves[u], 2.0)
    finally:
        cohort.shutdown()
        pub.close()


def test_cuda_by_default() -> None:
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default is satisfied")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingReplica(0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeCohort(1)


# ------------------------------------------------- against the JAX package


def _deploy_through(pub_cls, cohort_fn, leaves, version: int):
    unit_bytes = [int(a.nbytes) for a in leaves]
    pub = pub_cls()
    cohort = cohort_fn(4)
    try:
        moved = cohort.deploy(version, [pub.publish(version, leaves)],
                              unit_bytes)
        per_member = [
            (m.metrics.snapshot()["deploy_bytes_moved"],
             m.metrics.snapshot()["deploy_lower_bound_bytes"],
             dict(m._live.digests)) for m in cohort.members]
        live = {m.member_index: m._live for m in cohort.members}
        return moved, per_member, pub.digests(version), live, cohort, pub
    except BaseException:
        cohort.shutdown()
        pub.close()
        raise


@pytest.mark.parametrize("direction", ["reference_publisher_port_cohort",
                                       "port_publisher_reference_cohort"])
def test_cross_package_deploy_is_bitwise(direction: str) -> None:
    leaves = _leaves(11, n_units=12, elems=3000)
    port_cohort = lambda n: _cohort(n, replication=2)  # noqa: E731
    ref_cohort = lambda n: ref.ServeCohort(n, replication=2)  # noqa: E731
    mixed = ((ref.DeployPublisher, port_cohort)
             if direction.startswith("reference")
             else (DeployPublisher, ref_cohort))
    same = ((DeployPublisher, port_cohort)
            if direction.startswith("reference")
            else (ref.DeployPublisher, ref_cohort))
    runs = []
    try:
        for pub_cls, cohort_fn in (mixed, same):
            runs.append(_deploy_through(pub_cls, cohort_fn, leaves, 11))
        (m_moved, m_members, m_pub, m_live, _, _), \
            (s_moved, s_members, s_pub, _, _, _) = runs
        assert m_moved == s_moved == 2 * sum(a.nbytes for a in leaves)
        assert m_members == s_members
        assert m_pub == s_pub
        for mo, lo, digests in m_members:
            assert mo == lo
            assert all(d == m_pub[u] for u, d in digests.items())
        # the bytes that landed, read back from the live buffers
        for live in m_live.values():
            for u, bufs in live.buffers.items():
                assert b"".join(
                    np.asarray(b if isinstance(b, np.ndarray)
                               else b.numpy()).tobytes() for b in bufs
                ) == leaves[u].tobytes()
    finally:
        for run in runs:
            run[4].shutdown()
            run[5].close()


def test_answers_match_reference_replica() -> None:
    leaves = _leaves(12, n_units=6, elems=50_000)
    unit_bytes = [int(a.nbytes) for a in leaves]
    pub = ref.DeployPublisher()
    port = _cohort(2, replication=2)
    refc = ref.ServeCohort(2, replication=2)
    try:
        addr = pub.publish(12, leaves)
        port.deploy(12, [addr], unit_bytes)
        refc.deploy(12, [addr], unit_bytes)
        for u in range(len(leaves)):
            for x in (1.0, -0.37, 12.5):
                pv, pa = port.answer(u, x)
                rv, ra = refc.members[0].answer(u, x) \
                    if u in refc.layout.units_of(0) \
                    else refc.members[1].answer(u, x)
                assert pv == rv == 12
                _check_answer(pa, leaves[u], x)
                _check_answer(ra, leaves[u], x)
                scale = float(np.sum(np.abs(leaves[u]))) * abs(x)
                assert abs(pa - ra) <= 2 * ANSWER_TOL * scale
    finally:
        port.shutdown()
        refc.shutdown()
        pub.close()
