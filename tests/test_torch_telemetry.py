"""The port's telemetry plane against the JAX package's.

Twins of the Manager and server parts of tests/test_telemetry.py (the
/telemetry routes of the checkpoint server, fleet_top's rows from a live
endpoint, the Chrome-trace export) and of
``test_telemetry_metrics_serve_fastpath_counters`` (tests/test_fastpath.py).
Each route is asked of a server of each package fed the same metrics and
events: the payloads have the same key sets, ``scripts/fleet_top.py``
builds its row from a port replica unchanged, and the port's chrome trace
passes both packages' ``validate_chrome_trace``. Then the event ring
(stamps and cursor, the bound and its drop count, the disabled no-op and
its switch) on the same emits into both packages' recorders, and the
port's under racing writers, its emit cost, its overhead on a live
allreduce, fleet_top's mesh and mode columns, and ``Metrics`` under racing
writers (twins of tests/test_telemetry.py).
"""

import importlib.util
import json
import os
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from torchft_tpu.checkpointing import CheckpointServer as JaxCheckpointServer
from torchft_tpu.utils.events import EventRecorder as JaxEventRecorder
from torchft_tpu.utils.events import to_chrome_trace as jax_to_chrome_trace
from torchft_tpu.utils.events import (
    validate_chrome_trace as jax_validate_chrome_trace,
)
from torchft_tpu.utils.metrics import Metrics as JaxMetrics
from torchft_tpu_torch.checkpointing import CheckpointServer
from torchft_tpu_torch.comm.store import StoreClient, StoreServer
from torchft_tpu_torch.control import Lighthouse
from torchft_tpu_torch.manager import Manager
from torchft_tpu_torch.utils.events import (
    EventRecorder,
    to_chrome_trace,
    validate_chrome_trace,
)
from torchft_tpu_torch.utils.metrics import Metrics

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PACKAGES = {
    "port": (CheckpointServer, Metrics, EventRecorder),
    "jax": (JaxCheckpointServer, JaxMetrics, JaxEventRecorder),
}


def _load_fleet_top():
    spec = importlib.util.spec_from_file_location(
        "fleet_top", os.path.join(_REPO, "scripts", "fleet_top.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _get(url):
    with urllib.request.urlopen(url, timeout=5) as resp:
        assert resp.headers["Content-Type"] == "application/json"
        return json.load(resp)


def _wired(pkg, replica_id):
    server_cls, metrics_cls, recorder_cls = PACKAGES[pkg]
    server = server_cls(timeout=5.0)
    metrics = metrics_cls()
    rec = recorder_cls(capacity=64, enabled=True, replica_id=replica_id,
                       rank=0)
    server.set_metrics(metrics)
    server.set_events(rec)
    server.set_telemetry(lambda: {
        "replica_id": replica_id, "rank": 0, "step": 7, "epoch": 3,
        "comm_backend": "host",
    })
    metrics.incr("steps_committed", 5)
    metrics.gauge("heal_wall_ms", 17.0)
    metrics.observe("allreduce", 0.002)
    metrics.label("comm_backend", "host")
    rec.emit("quorum_start", step=7, epoch=3)
    rec.emit("quorum_complete", step=7, epoch=3, wire_world=2)
    return server, metrics, rec


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_telemetry_endpoints_serve_without_checkpoint_gate(pkg) -> None:
    """/telemetry answers while the checkpoint gate is closed (nothing
    staged), framed by the identity probe, seq-cursored, 400 on a bad
    cursor and 404 on an unknown route: the same in both packages."""
    server, metrics, rec = _wired(pkg, f"rep_{pkg}")
    try:
        base = server.metadata()
        m = _get(base + "/telemetry/metrics")
        assert m["replica_id"] == f"rep_{pkg}" and m["step"] == 7
        assert m["epoch"] == 3
        assert m["metrics"]["steps_committed"] == 5.0
        assert m["metrics"]["heal_wall_ms"] == 17.0
        assert m["metrics"]["comm_backend"] == "host"
        assert m["metrics"]["allreduce_p50_ms"] > 0
        ev = _get(base + "/telemetry/events?since=0")
        assert ev["replica_id"] == f"rep_{pkg}" and ev["enabled"] is True
        assert [e["kind"] for e in ev["events"]] == [
            "quorum_start", "quorum_complete"]
        assert ev["next"] == 2 and ev["dropped"] == 0
        rec.emit("step_commit", step=7, epoch=3)
        tail = _get(base + f"/telemetry/events?since={ev['next']}")
        assert [e["kind"] for e in tail["events"]] == ["step_commit"]
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(base + "/telemetry/events?since=abc",
                                   timeout=5)
        assert ei.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(base + "/telemetry/nope", timeout=5)
        assert ei.value.code == 404
    finally:
        server.shutdown()


def test_telemetry_payloads_have_the_reference_key_sets() -> None:
    payloads = {}
    servers = []
    try:
        for pkg in PACKAGES:
            server, _, _ = _wired(pkg, "rep_same")
            servers.append(server)
            base = server.metadata()
            payloads[pkg] = (_get(base + "/telemetry/metrics"),
                             _get(base + "/telemetry/events?since=0"))
    finally:
        for server in servers:
            server.shutdown()
    (pm, pe), (jm, je) = payloads["port"], payloads["jax"]
    assert set(pm) == set(jm)
    assert set(pm["metrics"]) == set(jm["metrics"])
    assert set(pe) == set(je)
    assert [set(e) for e in pe["events"]] == [set(e) for e in je["events"]]
    assert [e["kind"] for e in pe["events"]] == [e["kind"] for e in je["events"]]


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_telemetry_endpoints_unwired_server_still_answers(pkg) -> None:
    server = PACKAGES[pkg][0](timeout=5.0)
    try:
        base = server.metadata()
        ev = _get(base + "/telemetry/events")
        assert ev["events"] == [] and ev["enabled"] is False
        assert _get(base + "/telemetry/metrics")["metrics"] == {}
    finally:
        server.shutdown()


def test_telemetry_probe_error_still_answers() -> None:
    server = CheckpointServer(timeout=5.0)

    def broken():
        raise RuntimeError("probe down")

    server.set_telemetry(broken)
    try:
        m = _get(server.metadata() + "/telemetry/metrics")
        assert "probe down" in m["telemetry_info_error"]
        assert m["metrics"] == {}
    finally:
        server.shutdown()


def test_fleet_top_rows_from_live_port_endpoint() -> None:
    ft = _load_fleet_top()
    server = CheckpointServer(timeout=5.0)
    metrics = Metrics()
    rec = EventRecorder(capacity=64, enabled=True, replica_id="rep_f", rank=0)
    server.set_metrics(metrics)
    server.set_events(rec)
    server.set_telemetry(lambda: {
        "replica_id": "rep_f", "rank": 0, "step": 11, "epoch": 4,
        "healing": False,
    })
    try:
        metrics.incr("steps_committed", 9)
        metrics.incr("steps_discarded", 1)
        metrics.observe("allreduce", 0.004)
        rec.emit("step_commit", step=11, epoch=4)
        polled = ft.poll_manager(server.metadata(), 0, timeout=5.0)
        ep = {"replica_id": "rep_f", "rank": 0, "url": server.metadata()}
        row = ft.build_row(ep, polled)
        assert row["step"] == 11 and row["epoch"] == 4
        assert row["committed"] == 9.0 and row["discarded"] == 1.0
        assert row["allreduce_p50_ms"] > 0
        assert row["last_event"].startswith("step_commit")
        text = ft.render({"quorum": {"participants": [{}]}}, [row])
        assert "rep_f" in text and "step_commit" in text
        trace = ft.gather_trace([ep], timeout=5.0)
        assert validate_chrome_trace(trace) == []
        assert jax_validate_chrome_trace(trace) == []
        assert any(e["name"] == "step_commit" for e in trace["traceEvents"])
    finally:
        server.shutdown()


def _mk_dump(recorder_cls, rid, rank, events):
    rec = recorder_cls(capacity=256, enabled=True, replica_id=rid, rank=rank)
    for kind, kw in events:
        rec.emit(kind, **kw)
    return rec.dump()


_EVENTS = {
    "rep_a": [("quorum_start", dict(step=1, epoch=1)),
              ("quorum_complete", dict(step=1, epoch=1, wire_world=2)),
              ("step_commit", dict(step=1, epoch=1)),
              ("lease_break", dict(step=2, epoch=2, reason="vote_absent"))],
    "rep_b": [("heal_start", dict(step=0, epoch=2)),
              ("heal_done", dict(step=3, epoch=2, wall_ms=12.5)),
              ("step_commit", dict(step=3, epoch=2, fastpath=True))],
}


def _strip_times(trace):
    return [{k: v for k, v in e.items() if k not in ("ts", "dur")}
            | {"args": {k: v for k, v in e.get("args", {}).items()
                        if k not in ("t_mono",)}}
            for e in trace["traceEvents"]]


def test_to_chrome_trace_pairs_and_tracks() -> None:
    dumps = [_mk_dump(EventRecorder, rid, 0, evs)
             for rid, evs in _EVENTS.items()]
    trace = json.loads(json.dumps(to_chrome_trace(dumps)))
    assert validate_chrome_trace(trace) == []
    assert jax_validate_chrome_trace(trace) == []
    evs = trace["traceEvents"]
    procs = {e["args"]["name"] for e in evs if e["name"] == "process_name"}
    assert procs == {"replica rep_a", "replica rep_b"}
    spans = {e["name"]: e for e in evs if e["ph"] == "X"}
    assert set(spans) == {"quorum", "heal"}
    assert spans["heal"]["args"]["wall_ms"] == 12.5
    instants = {e["name"] for e in evs if e["ph"] == "i"}
    assert {"step_commit", "lease_break"} <= instants
    # the reference's export of the same dumps: same events, same shape
    ref = jax_to_chrome_trace(dumps)
    assert sorted(map(json.dumps, _strip_times(ref)), key=str) == sorted(
        map(json.dumps, _strip_times(trace)), key=str)


def test_to_chrome_trace_unclosed_span_degrades_to_instant() -> None:
    d = _mk_dump(EventRecorder, "rep_c", 1,
                 [("quorum_start", dict(step=9, epoch=4))])
    trace = to_chrome_trace([d])
    assert validate_chrome_trace(trace) == []
    names = [(e["name"], e["ph"]) for e in trace["traceEvents"]
             if e["ph"] != "M"]
    assert ("quorum_start", "i") in names
    assert not any(ph == "X" for _, ph in names)


@pytest.mark.parametrize("garbage", [[], {"traceEvents": "nope"},
                                     {"traceEvents": [{"ph": "X", "pid": 1}]},
                                     {"traceEvents": [{"name": "a", "ph": "Q",
                                                       "pid": 1}]}])
def test_validate_chrome_trace_catches_garbage(garbage) -> None:
    assert validate_chrome_trace(garbage) != []
    assert validate_chrome_trace(garbage) == jax_validate_chrome_trace(garbage)


def test_metrics_labels_and_reset_timings_match_the_reference() -> None:
    got, want = Metrics(), JaxMetrics()
    for m in (got, want):
        m.label("comm_backend", "host")
        m.incr("steps_committed", 3)
        m.observe("quorum", 0.001)
        m.reset_timings()
        m.observe("commit_barrier", 0.002)
    assert got.labels() == want.labels() == {"comm_backend": "host"}
    assert got.snapshot() == want.snapshot()


# ---------------------------------------------- a live port Manager's plane


def test_manager_telemetry_metrics_serve_fastpath_counters(monkeypatch) -> None:
    """The discovery and fetch path fleet_top uses: the group store names
    the checkpoint server, whose /telemetry/metrics carries the lease
    fields and the fast-path counters after steady steps."""
    monkeypatch.setenv("TORCHFT_TPU_FASTPATH", "1")
    lh = Lighthouse(min_replicas=1, join_timeout_ms=100, quorum_tick_ms=10,
                    lease_ms=2000)
    store = StoreServer()
    manager = Manager(min_replica_size=1, rank=0, world_size=1,
                      store_addr=store.addr, lighthouse_addr=lh.address(),
                      replica_id="torch_tel_", timeout=20.0,
                      quorum_timeout=20.0, connect_timeout=20.0,
                      heartbeat_interval=0.05, use_async_quorum=False)
    try:
        for _ in range(3):
            manager.start_quorum(allow_heal=False)
            manager.allreduce_arrays(
                [np.ones(8, np.float32)]).future().result(timeout=20)
            assert manager.should_commit()
        url = StoreClient(store.addr, connect_timeout=5.0).get(
            "checkpoint_addr_0").decode()
        tel = _get(url + "/telemetry/metrics")
        assert tel["lease_live"] is True
        assert isinstance(tel["lease_epoch"], int)
        assert tel["control_rpcs_per_step"] == 0
        m = tel["metrics"]
        assert m["fastpath_steps"] == 2.0
        assert m["fallback_steps"] == 1.0
        assert m["lease_grants"] >= 1.0
        assert m["control_rpcs_per_step"] == 0.0
        # fleet_top's row reads the lease columns off the port's payload
        ft = _load_fleet_top()
        ep = {"replica_id": manager.replica_id(), "rank": 0, "url": url}
        row = ft.build_row(ep, ft.poll_manager(url, 0, timeout=5.0))
        assert row["lease"] == f"e{tel['lease_epoch']}"
        assert row["rpc_step"] == 0
        events = _get(url + "/telemetry/events?since=0")
        trace = to_chrome_trace([events])
        assert validate_chrome_trace(trace) == []
        assert jax_validate_chrome_trace(trace) == []
        kinds = {e["kind"] for e in events["events"]}
        assert {"quorum_start", "quorum_complete", "step_commit"} <= kinds
        # the reference Manager frames its payload with the same keys (its
        # arrival moves the membership epoch, so it comes last)
        from torchft_tpu.manager import Manager as JaxManager

        jstore = StoreServer()
        jm = JaxManager(min_replica_size=1, rank=0, world_size=1,
                        store_addr=jstore.addr, lighthouse_addr=lh.address(),
                        replica_id="jax_tel_", timeout=20.0,
                        quorum_timeout=20.0, connect_timeout=20.0)
        try:
            assert set(jm._telemetry_info()) == set(manager._telemetry_info())
        finally:
            jm.shutdown(wait=False)
            jstore.shutdown()
    finally:
        manager.shutdown(wait=False)
        store.shutdown()
        lh.shutdown()


def test_fleet_top_tags_port_rows_by_job_with_the_observer() -> None:
    """fleet_top's read-only collection over port managers in two jobs,
    one with an observer: every row is found through the job-prefixed
    store keys, tagged with its job, and the observer's row is there with
    its telemetry saying it does not participate."""
    import threading

    ft = _load_fleet_top()
    lh = Lighthouse(min_replicas=1, join_timeout_ms=100)
    stores = [StoreServer() for _ in range(3)]
    specs = (("a", "fa0", True), ("a", "fobs", False), ("b", "fb0", True))
    managers = [Manager(min_replica_size=1, rank=0, world_size=1,
                        store_addr=s.addr, lighthouse_addr=lh.address(),
                        replica_id=f"{name}_", job_id=job, data_plane=dp,
                        timeout=10.0, quorum_timeout=10.0,
                        connect_timeout=10.0, heartbeat_interval=0.05)
                for s, (job, name, dp) in zip(stores, specs)]

    def step(m):
        m.start_quorum(allow_heal=False)
        m.allreduce_arrays([np.ones(4, np.float32)]).future().result(
            timeout=20)
        assert m.should_commit()

    try:
        threads = [threading.Thread(target=step, args=(m,)) for m in managers]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
            assert not t.is_alive()
        status, endpoints = ft.discover_managers(lh.address(), timeout=5.0)
        assert set(status["jobs"]) >= {"a", "b"}
        by_id = {ep["replica_id"]: ep for ep in endpoints}
        ids = {m.replica_id(): job for m, (job, _, _) in zip(managers, specs)}
        assert {rid: ep["job"] for rid, ep in by_id.items()} == ids
        rows = []
        for ep in endpoints:
            assert ep.get("url"), ep
            polled = ft.poll_manager(ep["url"], 0, timeout=5.0)
            rows.append((ft.build_row(ep, polled), polled))
        obs_id = managers[1].replica_id()
        obs_rows = [(r, p) for r, p in rows if obs_id[:20] in r["replica"]]
        assert len(obs_rows) == 1
        row, polled = obs_rows[0]
        assert row["replica"].startswith("a/")
        assert polled["metrics"]["participating"] is False
        assert polled["metrics"]["job_id"] == "a"
        assert sorted(r["replica"].split("/")[0] for r, _ in rows) == [
            "a", "a", "b"]
        assert "a/" in ft.render(status, [r for r, _ in rows])
    finally:
        for m in managers:
            m.shutdown(wait=False)
        for s in stores:
            s.shutdown()
        lh.shutdown()


# --- the event ring and the satellites, against the JAX package -------------
# Twins of tests/test_telemetry.py's recorder and satellite cases: the same
# emits into each package's EventRecorder give the same events, cursors and
# drop counts (the clock stamps aside); the concurrency, cost and overhead
# pins hold for the port's recorder and Metrics; fleet_top reads the mesh
# and mode columns from a live port endpoint.


def _projected(result):
    events, nxt, dropped = result
    return ([{k: v for k, v in e.items() if k not in ("t_wall", "t_mono")}
             for e in events], nxt, dropped)


def _recorder_trace(recorder_cls):
    rec = recorder_cls(capacity=64, enabled=True, replica_id="rep_a", rank=3)
    seqs = [rec.emit("quorum_start", step=5, epoch=2),
            rec.emit("quorum_complete", step=5, epoch=2, wire_world=2)]
    first = rec.since(0)
    assert all(e["t_wall"] > 0 and e["t_mono"] > 0 for e in first[0])
    rec.emit("step_commit", step=5, epoch=2)
    tail = rec.since(first[1])
    return seqs, _projected(first), _projected(tail), rec.since(tail[1])


def test_recorder_stamps_and_cursor() -> None:
    got = _recorder_trace(EventRecorder)
    assert got == _recorder_trace(JaxEventRecorder)
    seqs, (events, nxt, dropped), (tail, nxt2, _), rest = got
    assert seqs == [0, 1] and nxt == 2 and dropped == 0
    assert events[1] == {"seq": 1, "kind": "quorum_complete",
                         "replica_id": "rep_a", "rank": 3, "step": 5,
                         "epoch": 2, "wire_world": 2}
    assert [e["kind"] for e in tail] == ["step_commit"] and nxt2 == 3
    assert rest == ([], 3, 0)


def _ring_trace(recorder_cls):
    rec = recorder_cls(capacity=8, enabled=True)
    for i in range(20):
        rec.emit("step_commit", step=i)
    return _projected(rec.since(0)), _projected(rec.since(15))


def test_recorder_ring_bound_and_drop_accounting() -> None:
    got = _ring_trace(EventRecorder)
    assert got == _ring_trace(JaxEventRecorder)
    (events, nxt, dropped), (inside, _, inside_dropped) = got
    assert nxt == 20 and len(events) == 8 and dropped == 12
    assert [e["seq"] for e in events] == list(range(12, 20))
    assert inside_dropped == 0
    assert [e["seq"] for e in inside] == [15, 16, 17, 18, 19]


def test_recorder_disabled_is_noop(monkeypatch) -> None:
    for recorder_cls in (EventRecorder, JaxEventRecorder):
        rec = recorder_cls(capacity=16, enabled=False)
        assert not rec
        assert rec.emit("step_commit", step=1) == -1
        assert rec.next_seq == 0
        assert rec.since(0) == ([], 0, 0)
        assert rec.dump()["events"] == []
        monkeypatch.setenv("TORCHFT_TPU_EVENTS", "0")
        assert not recorder_cls().enabled
        monkeypatch.delenv("TORCHFT_TPU_EVENTS")
        assert recorder_cls().enabled


def test_recorder_concurrent_writers_ordered_and_bounded() -> None:
    # writers racing a reader: the sequence numbers stay unique and
    # ordered, the ring within its bound, no emit lost or duplicated
    rec = EventRecorder(capacity=128, enabled=True)
    writers, per = 8, 500
    errors, cursor = [], [0]
    stop = threading.Event()

    def write(w):
        try:
            for i in range(per):
                rec.emit("step_commit", step=i, writer=w)
        except Exception as e:  # noqa: BLE001 — asserted below
            errors.append(e)

    def read():
        try:
            while not stop.is_set():
                events, nxt, _ = rec.since(max(0, cursor[0] - 50))
                seqs = [e["seq"] for e in events]
                assert seqs == sorted(seqs) and len(seqs) == len(set(seqs))
                assert len(events) <= 128
                cursor[0] = nxt
        except Exception as e:  # noqa: BLE001 — asserted below
            errors.append(e)

    threads = [threading.Thread(target=write, args=(w,))
               for w in range(writers)]
    reader = threading.Thread(target=read)
    reader.start()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    stop.set()
    reader.join(timeout=30)
    assert not errors
    assert rec.next_seq == writers * per
    events, nxt, dropped = rec.since(0)
    assert nxt == writers * per
    assert len(events) == 128 and dropped == writers * per - 128
    assert [e["seq"] for e in events] == list(range(nxt - 128, nxt))


def test_emit_overhead_envelope() -> None:
    # the reference's bounds, about 25x above an emit's measured cost on
    # the host: an enabled emit under 50 us, the disabled guard under 10
    rec = EventRecorder(capacity=4096, enabled=True)
    n = 20000
    t0 = time.perf_counter()
    for i in range(n):
        rec.emit("step_commit", step=i, epoch=7)
    per_emit = (time.perf_counter() - t0) / n
    assert per_emit < 50e-6, f"enabled emit cost {per_emit * 1e6:.1f} us"
    off = EventRecorder(capacity=4096, enabled=False)
    t0 = time.perf_counter()
    for i in range(n):
        if off:
            off.emit("step_commit", step=i)
    per_guard = (time.perf_counter() - t0) / n
    assert per_guard < 10e-6, f"disabled guard cost {per_guard * 1e6:.2f} us"
    assert off.next_seq == 0


def test_allreduce_p50_unmoved_by_enabled_recorder() -> None:
    # the Manager's per-step emits around a live two-rank loopback
    # allreduce of the port's wire, the arms interleaved on one configured
    # transport, under the reference's bound (2.5x + 2 ms)
    from torchft_tpu_torch.comm.transport import TcpCommContext

    store = StoreServer()
    world = 2
    ctxs = [TcpCommContext(timeout=20.0, algorithm="star", channels=2)
            for _ in range(world)]
    rec = EventRecorder(capacity=4096, enabled=True)
    payload = [np.ones(1 << 15, np.float32) for _ in range(world)]
    times = {False: [], True: []}
    try:
        configure = [threading.Thread(
            target=ctxs[r].configure, args=(f"{store.addr}/events_ab", r,
                                            world)) for r in range(world)]
        for t in configure:
            t.start()
        for t in configure:
            t.join(timeout=30)

        def rank_loop(rank, emit):
            for i in range(10):
                t0 = time.perf_counter()
                work = ctxs[rank].allreduce([payload[rank]])
                if emit and rank == 0:
                    for _ in range(4):
                        rec.emit("step_commit", step=i, epoch=1)
                work.future().result(timeout=30)
                if rank == 0:
                    times[emit].append(time.perf_counter() - t0)

        for _ in range(2):
            for emit in (False, True):
                ts = [threading.Thread(target=rank_loop, args=(r, emit))
                      for r in range(world)]
                for t in ts:
                    t.start()
                for t in ts:
                    t.join(timeout=60)
    finally:
        for c in ctxs:
            c.shutdown()
        store.shutdown()
    p50 = {k: sorted(v)[len(v) // 2] for k, v in times.items()}
    assert p50[True] <= p50[False] * 2.5 + 2e-3, p50


def test_fleet_top_mesh_and_mode_columns_live() -> None:
    # the mesh column is the "{replicas}x{model}" label, the mode the
    # fused plane's step_executable_count gauge, read from a port server
    ft = _load_fleet_top()
    server = CheckpointServer(timeout=5.0)
    metrics = Metrics()
    server.set_metrics(metrics)
    server.set_telemetry(lambda: {
        "replica_id": "rep_m", "rank": 0, "step": 3, "healing": False})
    try:
        metrics.label("mesh_shape", "2x2")
        metrics.gauge("step_executable_count", 1.0)
        ep = {"replica_id": "rep_m", "rank": 0, "url": server.metadata()}
        row = ft.build_row(ep, ft.poll_manager(server.metadata(), 0,
                                               timeout=5.0))
        assert row["mesh"] == "2×2" and row["mode"] == "fused"
        text = ft.render({"quorum": {"participants": [{}]}}, [row])
        assert "2×2" in text and "fused" in text
        metrics.gauge("step_executable_count", 4.0)
        row = ft.build_row(ep, ft.poll_manager(server.metadata(), 0,
                                               timeout=5.0))
        assert row["mode"] == "staged"
    finally:
        server.shutdown()


def test_metrics_concurrent_writers_exact_counters() -> None:
    # writers racing snapshot and reset_timings: no raise, exact counters
    m = Metrics(window=64)
    writers, per = 8, 400
    errors = []
    stop = threading.Event()

    def write(w):
        try:
            for i in range(per):
                m.incr("c")
                m.incr("bytes", 3.0)
                m.observe(f"t{w % 2}", 0.001)
                m.gauge("g", float(i))
                m.label("backend", "host")
        except Exception as e:  # noqa: BLE001 — asserted below
            errors.append(e)

    def read():
        try:
            while not stop.is_set():
                assert m.snapshot().get("c", 0) <= writers * per
                m.reset_timings()
        except Exception as e:  # noqa: BLE001 — asserted below
            errors.append(e)

    threads = [threading.Thread(target=write, args=(w,))
               for w in range(writers)]
    reader = threading.Thread(target=read)
    reader.start()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    stop.set()
    reader.join(timeout=30)
    assert not errors
    snap = m.snapshot()
    assert snap["c"] == writers * per
    assert snap["bytes"] == writers * per * 3.0
    assert snap["backend"] == "host"
