"""The port's control-plane binding, store and futures against the JAX
package's.

Both bindings drive the same native sources (the JAX package loads the
``make -C native`` build, the port its own build of those sources), so the
quorum decision JSON must be byte-identical; the rendezvous store speaks one
protocol, so a client of either package works against a server of the
other.
"""

import dataclasses
import random
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor

import pytest

from torchft_tpu import control as jcontrol
from torchft_tpu.comm import store as jstore
from torchft_tpu_torch import control
from torchft_tpu_torch import futures
from torchft_tpu_torch.comm import store


def _member(replica_id, step=0, shrink_only=False):
    return {
        "replica_id": replica_id,
        "address": f"addr_{replica_id}",
        "store_address": f"store_addr_{replica_id}",
        "step": step,
        "world_size": 1,
        "shrink_only": shrink_only,
    }


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quorum_decisions_byte_identical(seed) -> None:
    rng = random.Random(seed)
    opts = {"min_replicas": rng.choice([1, 2, 3]),
            "join_timeout_ms": rng.choice([50, 60000]),
            "heartbeat_timeout_ms": 5000}
    ours = control.IncrementalQuorum(opts)
    theirs = jcontrol.IncrementalQuorum(opts)
    ids = [f"r_{i:02d}" for i in range(6)]
    now = 1_000_000
    for _ in range(300):
        now += rng.choice([0, 1, 7, 100])
        op, rid = rng.random(), rng.choice(ids)
        member = _member(rid, step=rng.randrange(3),
                         shrink_only=rng.random() < 0.05)
        for iq in (ours, theirs):
            if op < 0.35:
                iq.heartbeat(rid, now)
            elif op < 0.75:
                iq.heartbeat(rid, now)
                iq.join(now, member)
            elif op >= 0.85:
                assert iq.install(now, wall_ms=now) is not None
        if 0.75 <= op < 0.85:
            now += rng.choice([5001, 10000, 70000])
        decision = ours.decision(now)
        assert decision == theirs.decision(now)
        assert ours.state() == theirs.state()
        raw = control.quorum_compute_raw(now, ours.state(), opts)
        assert raw == jcontrol.quorum_compute_raw(now, theirs.state(), opts)
        assert raw == decision


def test_mixed_bindings_one_quorum() -> None:
    # a port lighthouse, one manager server of each binding: both clients
    # see the same quorum, and the behind replica is told to heal
    lh = control.Lighthouse(min_replicas=2, join_timeout_ms=200)
    servers = []
    try:
        servers.append(control.ManagerServer(
            "rep_a", lh.address(), store_addr="store:a", world_size=1,
            exit_on_kill=False))
        servers.append(jcontrol.ManagerServer(
            "rep_b", lh.address(), store_addr="store:b", world_size=1,
            exit_on_kill=False))
        clients = [control.ManagerClient(servers[0].address()),
                   jcontrol.ManagerClient(servers[1].address())]
        with ThreadPoolExecutor(max_workers=2) as pool:
            fa = pool.submit(clients[0].quorum, 0, 7, "ckpt_a", False, 10.0)
            fb = pool.submit(clients[1].quorum, 0, 3, "ckpt_b", False, 10.0)
            ra, rb = fa.result(timeout=15), fb.result(timeout=15)
        assert ra.quorum_id == rb.quorum_id
        assert ra.replica_world_size == rb.replica_world_size == 2
        assert ra.max_step == rb.max_step == 7
        assert not ra.heal and ra.recover_dst_ranks == [1]
        assert rb.heal and rb.recover_src_rank == 0
        assert rb.recover_src_manager_address == servers[0].address()
        assert ra.transport_replica_ids == rb.transport_replica_ids
        # the two QuorumResult types parse the same JSON the same way
        fields = [f.name for f in dataclasses.fields(control.QuorumResult)]
        assert fields == [f.name for f in
                          dataclasses.fields(jcontrol.QuorumResult)]
    finally:
        for s in servers:
            s.shutdown()
        lh.shutdown()


def test_should_commit_and_checkpoint_metadata_roundtrip() -> None:
    lh = control.Lighthouse(min_replicas=1, join_timeout_ms=100)
    mgr = control.ManagerServer("rep_0", lh.address(), store_addr="s:0",
                                world_size=1, exit_on_kill=False)
    try:
        c = control.ManagerClient(mgr.address())
        q = c.quorum(rank=0, step=0, checkpoint_metadata="http://donor:1",
                     shrink_only=False, timeout=10.0)
        assert q.quorum_id >= 1 and not q.heal
        assert c.checkpoint_metadata(0, timeout=5.0) == "http://donor:1"
        assert c.should_commit(0, 0, True, timeout=5.0)
        assert not c.should_commit(0, 1, False, timeout=5.0)
    finally:
        mgr.shutdown()
        lh.shutdown()


def test_lighthouse_client_heartbeat_and_quorum() -> None:
    lh = control.Lighthouse(min_replicas=1, join_timeout_ms=100)
    try:
        client = control.LighthouseClient(lh.address())
        client.heartbeat("rep_x")
        client.heartbeat(["rep_x"])  # the batch form: one RPC for a list
        got = client.quorum(_member("rep_x", step=4), timeout=10.0)
        ids = [m["replica_id"] for m in got["quorum"]["participants"]]
        assert ids == ["rep_x"] and got["quorum"]["quorum_id"] >= 1
        # the same RPC through the JAX package's client
        theirs = jcontrol.LighthouseClient(lh.address())
        again = theirs.quorum(_member("rep_x", step=5), timeout=10.0)
        assert [m["replica_id"]
                for m in again["quorum"]["participants"]] == ["rep_x"]
    finally:
        lh.shutdown()


@pytest.mark.parametrize("direction", ["port_client", "jax_client"])
def test_store_interop(direction) -> None:
    server_mod, client_mod = (
        (jstore, store) if direction == "port_client" else (store, jstore)
    )
    server = server_mod.StoreServer()
    client = client_mod.StoreClient(server.addr)
    other = server_mod.StoreClient(server.addr)
    try:
        client.set("a", b"1")
        assert other.get("a") == b"1"
        assert client.get("missing") is None
        threading.Timer(0.1, lambda: other.set("k", b"v")).start()
        assert client.wait("k", timeout=5.0) == b"v"
        assert client.add("ctr", 2) == 2
        assert other.add("ctr", 3) == 5
        client.set("p/a", b"x")
        client.set("p/b", b"y")
        assert other.list_keys("p/") == ["p/a", "p/b"]
        assert client.delete("p/a")
        blob = bytes(range(256)) * 4096
        other.set("blob", blob)
        assert client.get("blob") == blob
        pre = client_mod.create_store_client(f"{server.addr}/torchft/7")
        pre.set("x", b"y")
        assert other.get("torchft/7/x") == b"y"
        with pytest.raises(TimeoutError):
            client.wait("never", timeout=0.1)
    finally:
        client.close()
        other.close()
        server.shutdown()


def test_future_timeout_and_chain() -> None:
    f: Future = Future()
    timed = futures.future_timeout(f, 5.0)
    f.set_result(3)
    assert timed.result(timeout=1) == 3
    slow: Future = Future()
    with pytest.raises(TimeoutError):
        futures.future_timeout(slow, 0.05).result(timeout=2)
    chained = futures.future_chain(futures.completed_future(2),
                                   lambda x: x.result() * 10)
    assert chained.result() == 20
    failed = futures.future_chain(
        futures.failed_future(ValueError("boom")), lambda x: x.result())
    with pytest.raises(ValueError):
        failed.result()


def test_stealable_task_runs_once() -> None:
    calls = []
    task = futures.StealableTask(lambda: calls.append(1) or 7)
    assert task.result() == 7
    task.run()  # already claimed: no second execution
    assert calls == [1]


def test_timer_stress() -> None:
    # 200 deadlines on one timer thread, half of them cancelled by their
    # future resolving. Arming and resolving take this thread longer than
    # the shortest deadline (50 ms) when the host is loaded, so a future
    # resolved after its own deadline may legitimately have timed out:
    # the check follows each future's schedule. One resolved before its
    # deadline must pass through, one never resolved must time out
    fs = [Future() for _ in range(200)]
    deadlines, timed = [], []
    for i, f in enumerate(fs):
        seconds = 0.05 + (i % 5) * 0.01
        deadlines.append(time.monotonic() + seconds)
        timed.append(futures.future_timeout(f, seconds))
    in_time = []
    for i in range(0, 200, 2):
        fs[i].set_result(1)
        if time.monotonic() < deadlines[i]:
            in_time.append(i)
    time.sleep(0.3)
    assert all(t.done() for t in timed)
    for i in in_time:
        assert timed[i].exception() is None, i
    for t in timed[1::2]:
        assert isinstance(t.exception(), TimeoutError)
    ok = sum(1 for t in timed if t.exception() is None)
    assert len(in_time) <= ok <= 100


# --- the observer cases of the quorum kernel, through both bindings ---------


def _results(replica_id, parts, rank=0):
    """compute_quorum_results through the port's binding, held equal to the
    JAX package's native entry point on the same quorum."""
    import ctypes
    import json

    from torchft_tpu.control._native import check_error, get_lib, take_string

    q = {"quorum_id": 1, "participants": parts, "created_ms": 0}
    got = control.compute_quorum_results(replica_id, rank, q)
    err = ctypes.c_char_p()
    ptr = get_lib().ft_compute_quorum_results(
        replica_id.encode(), rank, json.dumps(q).encode(), ctypes.byref(err))
    check_error(err)
    assert got == json.loads(take_string(ptr))
    return got


def _observer(replica_id, step=0):
    return {**_member(replica_id, step=step), "data_plane": False}


def test_transport_membership_excludes_observers() -> None:
    # observers join the quorum, not the wire; wire ranks are contiguous
    # in replica order
    parts = [_member("a", step=5), _observer("b"), _member("c", step=5)]
    res_a = _results("a", parts)
    assert res_a["transport_replica_ids"] == ["a", "c"]
    assert res_a["transport_rank"] == 0
    assert res_a["transport_world_size"] == 2
    assert res_a["max_replica_ids"] == ["a", "c"]
    assert _results("c", parts)["transport_rank"] == 1
    res_b = _results("b", parts)
    assert res_b["transport_rank"] is None
    assert res_b["transport_world_size"] == 2
    assert res_b["replica_world_size"] == 3


def test_transport_membership_includes_healing_members() -> None:
    # a behind data-plane member stays on the wire: it receives the
    # cohort's average in its heal step
    res_b = _results("b", [_member("a", step=9), _member("b", step=2)])
    assert res_b["heal"] is True
    assert res_b["transport_replica_ids"] == ["a", "b"]
    assert res_b["transport_rank"] == 1
    assert res_b["max_replica_ids"] == ["a"]


def test_observers_invisible_to_step_and_recovery_logic() -> None:
    # never the bootstrap primary or a donor, never a recovery
    # destination, never defining max_step, never in the cohort
    parts0 = [_observer("_obs"), _member("a"), _member("b")]
    res_a = _results("a", parts0)
    assert res_a["recover_dst_ranks"] == [2]
    assert res_a["max_world_size"] == 2
    assert res_a["store_address"] == "store_addr_a"
    parts_ahead = [_observer("obs", step=99), _member("a", step=5),
                   _member("b", step=5)]
    res = _results("a", parts_ahead)
    assert res["max_step"] == 5
    assert res["max_replica_ids"] == ["a", "b"]
    assert res["heal"] is False


def test_all_observer_fallback_emits_coherent_transport() -> None:
    # every member an observer: the kernel takes them all as the data
    # plane, and the transport fields describe that same membership
    parts = [_observer("a", step=3), _observer("b", step=3)]
    res_a = _results("a", parts)
    assert res_a["transport_replica_ids"] == ["a", "b"]
    assert res_a["transport_rank"] == 0
    assert res_a["transport_world_size"] == 2
    res_b = _results("b", parts)
    assert res_b["transport_rank"] == 1
    assert res_b["max_replica_ids"] == ["a", "b"]


def test_incremental_quorum_counters_match_the_reference() -> None:
    opts = {"min_replicas": 1, "join_timeout_ms": 100,
            "heartbeat_timeout_ms": 50}
    port, ref = (mod.IncrementalQuorum(opts, prune_after_ms=100)
                 for mod in (control, jcontrol))
    for iq in (port, ref):
        for i, rid in enumerate(("x", "y", "z")):
            iq.heartbeat(rid, 1000 + i)
            iq.join(1000 + i, _member(rid))
        iq.decision(1010)
        iq.heartbeat("x", 1200)
        iq.decision(1200)  # y and z expire; at 1400 all three are pruned
        iq.decision(1400)
    assert port.counters() == ref.counters()
    assert port.counters()["pruned_heartbeats"] == 3


def test_lighthouse_cli_serves_a_domain_tier() -> None:
    # the fleet-tree flags: a tier-1 aggregator for one domain, reporting
    # to a root lighthouse, as the JAX package's CLI does
    import json
    import subprocess
    import sys
    import urllib.request

    root = control.Lighthouse(min_replicas=1)
    proc = subprocess.Popen(
        [sys.executable, "-m", "torchft_tpu_torch.lighthouse_cli",
         "--min_replicas", "1", "--bind", "127.0.0.1:0", "--hostname",
         "127.0.0.1", "--domain", "rack7", "--upstream", root.address(),
         "--upstream_report_interval_ms", "50", "--prune_after_ms", "60000",
         "--no-cache-quorum"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        line = proc.stdout.readline()
        assert "lighthouse serving at" in line, line
        addr = line.strip().rsplit(" ", 1)[-1]
        assert "tier-1 aggregator for domain 'rack7'" in proc.stdout.readline()
        with urllib.request.urlopen(addr + "/status.json", timeout=5) as r:
            ctl = json.load(r)["control"]
        assert ctl["tier"] == 1 and ctl["domain"] == "rack7"
        deadline = time.monotonic() + 10.0
        while True:
            with urllib.request.urlopen(root.address() + "/status.json",
                                        timeout=5) as r:
                domains = json.load(r).get("domains") or {}
            if "rack7" in domains or time.monotonic() > deadline:
                break
            time.sleep(0.05)
        assert domains["rack7"]["tier"] == 1
        assert domains["rack7"]["address"] == addr
    finally:
        proc.terminate()
        proc.wait(timeout=10)
        root.shutdown()
