"""The port's telemetry plane against the JAX package's.

Twins of the Manager and server parts of tests/test_telemetry.py (the
/telemetry routes of the checkpoint server, fleet_top's rows from a live
endpoint, the Chrome-trace export) and of
``test_telemetry_metrics_serve_fastpath_counters`` (tests/test_fastpath.py).
Each route is asked of a server of each package fed the same metrics and
events: the payloads have the same key sets, ``scripts/fleet_top.py``
builds its row from a port replica unchanged, and the port's chrome trace
passes both packages' ``validate_chrome_trace``.
"""

import importlib.util
import json
import os
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
