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
    fs = [Future() for _ in range(200)]
    timed = [futures.future_timeout(f, 0.05 + (i % 5) * 0.01)
             for i, f in enumerate(fs)]
    for f in fs[::2]:
        f.set_result(1)
    time.sleep(0.3)
    ok = sum(1 for t in timed if t.exception() is None)
    assert ok == 100
