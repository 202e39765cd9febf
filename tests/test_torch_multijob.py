"""The port's multi-tenant control plane, held against the JAX package.

Twins of tests/test_multijob.py over the port's Managers and bindings, on
one native lighthouse: a kill inside job A heals while job B's shard
counters stay flat and B steps at 0 control RPCs (also with one of the two
jobs run by the JAX package's Manager); a higher-priority arrival over
``fleet_capacity`` evicts one group of the over-budget job in the quorum
answer, never by a timeout (with the low-priority job run by either
package); clients that name no job land in the "default" job. Besides: the
lighthouse client's request bodies byte-equal to the JAX package's for the
same calls, the event registry, a mixed cohort of both packages in one
non-default job (the same store keys, an allreduce and a bitwise heal),
and the two-job drill at "tiny", whose jobs run the same seeds and data, so
job A (with an observer) and job B (without) must agree bit for bit until
A's kill: an observer counted as a participant would change A's average.
The victim job's shrink (3 -> 2 sharded optimizer ranks) moves exactly
its lower bound through the redistribution planner.
"""

import json
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

import torchft_tpu.control as jax_control
import torchft_tpu.manager as jax_manager
import torchft_tpu.utils.events as jax_events
import torchft_tpu_torch.comm.store as store_mod
import torchft_tpu_torch.control as control
import torchft_tpu_torch.manager as manager_mod
from torchft_tpu_torch.checkpointing import CheckpointServer
from torchft_tpu_torch.comm.store import StoreClient, StoreServer
from torchft_tpu_torch.control import Lighthouse, LighthouseClient
from torchft_tpu_torch.examples.train_ddp import _wait_lighthouse
from torchft_tpu_torch.utils.events import EVENT_KINDS

_MANAGERS = {"torch": manager_mod.Manager, "jax": jax_manager.Manager}


def _status(lighthouse):
    with urllib.request.urlopen(lighthouse.address() + "/status.json",
                                timeout=10) as r:
        return json.load(r)


def _telemetry(store, key, what):
    url = StoreClient(store.addr, connect_timeout=5.0).get(key).decode()
    with urllib.request.urlopen(url + "/telemetry/" + what, timeout=10) as r:
        return json.load(r)


def _make_manager(pkg, store, lighthouse, replica_id, job_id, **kwargs):
    defaults = dict(
        min_replica_size=1, rank=0, world_size=1, store_addr=store.addr,
        lighthouse_addr=lighthouse.address(), replica_id=replica_id,
        job_id=job_id, timeout=20.0, quorum_timeout=20.0,
        connect_timeout=20.0, heartbeat_interval=0.05,
        use_async_quorum=False,
    )
    defaults.update(kwargs)
    return _MANAGERS[pkg](**defaults)


def _step(manager):
    manager.start_quorum(allow_heal=False)
    manager.allreduce_arrays([np.ones(8, np.float32)]).future().result(
        timeout=20)
    return manager.should_commit()


def _shutdown(managers, stores, lighthouse):
    for m in managers:
        try:
            m.shutdown(wait=False)
        except Exception:  # noqa: BLE001
            pass
    for s in stores:
        s.shutdown()
    lighthouse.shutdown()


# ------------------------------------------------------------ kill isolation


@pytest.mark.parametrize("pkg_a, pkg_b", [("torch", "torch"),
                                          ("jax", "torch"),
                                          ("torch", "jax")])
def test_kill_in_job_a_leaves_job_b_untouched(monkeypatch, pkg_a,
                                              pkg_b) -> None:
    """Job A loses a group mid-run and heals through the lease break and
    the full quorum while job B's membership epoch, recompute count and
    lease breaks stay at the pre-kill baseline and every B step in the
    window makes 0 control RPCs, whichever package runs either job."""
    monkeypatch.setenv("TORCHFT_TPU_FASTPATH", "1")
    lh = Lighthouse(min_replicas=1, join_timeout_ms=100, quorum_tick_ms=10,
                    heartbeat_timeout_ms=1200, lease_ms=2000)
    stores = [StoreServer() for _ in range(3)]
    managers = []
    try:
        b = _make_manager(pkg_b, stores[0], lh, "mj_b_", "b")
        managers.append(b)
        assert _step(b)
        a0, a1 = (_make_manager(pkg_a, stores[1 + i], lh, f"mj_a{i}_", "a",
                                timeout=5.0, quorum_timeout=5.0,
                                connect_timeout=5.0)
                  for i in range(2))
        managers.extend([a0, a1])
        with ThreadPoolExecutor(max_workers=2) as pool:
            deadline = time.monotonic() + 30.0
            while time.monotonic() < deadline:
                if all(pool.map(_step, [a0, a1])):
                    break
            else:
                pytest.fail("job a never converged to a joint quorum")
        time.sleep(0.3)  # the install's recompute lands on the next tick
        base = _status(lh)["jobs"]
        assert set(base) >= {"a", "b"}

        def _a0_breaks():
            return sum(1 for e in a0.events.since(0)[0]
                       if e["kind"] == "lease_break")

        breaks_before_kill = _a0_breaks()
        a1.shutdown(wait=False)  # stops heartbeating, never deregisters
        b_rpcs = []
        a_commits_after_break = 0
        deadline = time.monotonic() + 60.0
        while time.monotonic() < deadline and a_commits_after_break < 2:
            committed = _step(a0)
            if committed and _a0_breaks() > breaks_before_kill:
                a_commits_after_break += 1
            if not committed:
                time.sleep(0.3)  # let the dead peer age out
            assert _step(b)
            b_rpcs.append(b._control_rpcs)
        assert _a0_breaks() > breaks_before_kill
        assert a_commits_after_break >= 2
        assert sum(b_rpcs) == 0, b_rpcs

        after = _status(lh)["jobs"]
        for key in ("membership_epoch", "quorum_compute_count",
                    "lease_breaks"):
            assert after["b"][key] == base["b"][key], key
        assert after["a"]["membership_epoch"] > base["a"]["membership_epoch"]
        assert after["a"]["healthy"] == 1
        status = _status(lh)
        for key in ("quorum_rpcs", "lease_breaks", "preemptions",
                    "rate_limit_drops"):
            assert status["control"][key] == sum(
                j[key] for j in status["jobs"].values()), key
        tel = _telemetry(stores[0], "job:b/checkpoint_addr_0", "metrics")
        assert tel["job_id"] == "b"
        assert tel["evicted"] is False
        assert tel["control_rpcs_per_step"] == 0
    finally:
        _shutdown(managers, stores, lh)


# --------------------------------------------------------------- preemption


@pytest.mark.parametrize("pkg_lo", ["torch", "jax"])
def test_priority_preemption_is_prescriptive(pkg_lo) -> None:
    """Three low-priority groups (budget 2) fill ``fleet_capacity``; a
    port group of a high-priority job joins and exactly one low group is
    evicted through the quorum answer: ``is_evicted()``, a
    ``job_preempted`` event with its job, the status counters, and an
    immediate answer to its next ask."""
    lh = Lighthouse(min_replicas=1, join_timeout_ms=100, quorum_tick_ms=10,
                    heartbeat_timeout_ms=30000, fleet_capacity=3)
    stores = [StoreServer() for _ in range(4)]
    managers = []
    try:
        client = LighthouseClient(lh.address())
        client.register_job("lo", priority=0, group_budget=2)
        client.register_job("hi", priority=10)
        lo = [_make_manager(pkg_lo, stores[i], lh, f"mj_lo{i}_", "lo")
              for i in range(3)]
        managers.extend(lo)
        with ThreadPoolExecutor(max_workers=3) as pool:
            assert all(pool.map(_step, lo))
        hi = _make_manager("torch", stores[3], lh, "mj_hi_", "hi")
        managers.append(hi)
        assert _step(hi)  # the claimant's quorum carries the preemption
        time.sleep(0.5)

        def _drive(mgr):
            mgr.start_quorum(allow_heal=False)
            if mgr.is_evicted():
                return "evicted"
            mgr.allreduce_arrays([np.ones(8, np.float32)]).future().result(
                timeout=20)
            return mgr.should_commit()

        with ThreadPoolExecutor(max_workers=3) as pool:
            outcomes = list(pool.map(_drive, lo))
        assert outcomes.count("evicted") == 1, outcomes
        assert outcomes.count(True) == 2, outcomes
        victim = lo[outcomes.index("evicted")]
        victim_store = stores[outcomes.index("evicted")]
        assert victim.is_evicted() and victim.job_id() == "lo"
        assert victim.num_participants() == 0
        assert not victim.should_commit()  # the latch vetoes the step

        status = _status(lh)
        jobs = status["jobs"]
        assert jobs["lo"]["preemptions"] == 1
        assert jobs["hi"]["preemptions"] == 0
        assert jobs["lo"]["evicted"] == [victim._replica_id]
        assert victim._replica_id == max(m._replica_id for m in lo)
        assert jobs["hi"]["healthy"] == 1
        assert status["control"]["preemptions"] == 1
        assert status["control"]["fleet_capacity"] == 3

        tel = _telemetry(victim_store, "job:lo/checkpoint_addr_0", "events")
        preempted = [e for e in tel["events"] if e["kind"] == "job_preempted"]
        assert len(preempted) == 1 and preempted[0]["job_id"] == "lo"
        metrics = _telemetry(victim_store, "job:lo/checkpoint_addr_0",
                             "metrics")
        assert metrics["evicted"] is True and metrics["job_id"] == "lo"

        t0 = time.perf_counter()
        resp = client.quorum(
            {"replica_id": victim._replica_id,
             "address": "http://localhost:1", "store_address": "localhost:1",
             "step": 1, "world_size": 1},
            timeout=30.0, job_id="lo")
        assert resp.get("evicted") is True, resp
        assert time.perf_counter() - t0 < 5.0
    finally:
        _shutdown(managers, stores, lh)


def test_victim_shrink_moves_exactly_the_lower_bound() -> None:
    """The evicted group's state leaves the job through the redistribution
    planner: a live 3 -> 2 shrink of the sharded optimizer ships
    ``redist_moved_bytes == redist_lower_bound_bytes`` on every surviving
    rank (and a non-zero total: real state moved), and each survivor's
    last ``redist_plan`` event agrees with its gauges."""
    import copy

    import torch

    from torchft_tpu_torch.comm.transport import TcpCommContext
    from torchft_tpu_torch.comm.wire_stub import run_stub_ranks
    from torchft_tpu_torch.optim import ShardedOptimizerWrapper, adam

    store = StoreServer()
    rng = np.random.default_rng(1909)
    params0 = [rng.standard_normal(64 + 8 * i).astype(np.float32)
               for i in range(4)]

    def _run(prefix, world, carried=None):
        def _fn(mgr, rank):
            params = [torch.nn.Parameter(torch.from_numpy(p.copy()))
                      for p in params0]
            opt = ShardedOptimizerWrapper(mgr, adam(1e-2), params,
                                          sharded=True)
            if carried is not None and carried[rank] is not None:
                opt.state = copy.deepcopy(carried[rank])
            mgr.start_quorum()
            for p in params:
                p.grad = p.detach() * 0.1
            assert opt.step(), "shrink step discarded"
            plans = [e for e in mgr.events.since(0)[0]
                     if e["kind"] == "redist_plan"]
            return opt.state, mgr.metrics.snapshot(), plans

        return run_stub_ranks(store.addr, prefix, world, _fn,
                              lambda: TcpCommContext(timeout=15.0),
                              timeout=90)

    try:
        w3 = _run("mj_shrink_w3", 3)
        shrunk = _run("mj_shrink_w2", 2, carried=[w3[0][0], w3[1][0]])
        total_moved = 0.0
        for rank, (_, snap, plans) in enumerate(shrunk):
            moved = snap.get("redist_moved_bytes")
            lower = snap.get("redist_lower_bound_bytes")
            assert moved is not None and lower is not None, rank
            assert float(moved) == float(lower), (
                f"rank {rank}: the victim shrink over-shipped ({moved} vs "
                f"lower bound {lower})")
            assert plans, f"rank {rank}: no redist_plan event"
            assert plans[-1]["moved_bytes"] == int(moved)
            assert plans[-1]["lower_bound_bytes"] == int(lower)
            total_moved += float(moved)
        assert total_moved > 0, "the 3 -> 2 shrink moved zero bytes"
    finally:
        store.shutdown()


def test_job_preempted_fields_and_registry_match_the_reference() -> None:
    # the port's registry is a subset of the JAX package's, in its order,
    # and the eviction event carries the same fields
    assert "job_preempted" in EVENT_KINDS
    assert [k for k in jax_events.EVENT_KINDS if k in EVENT_KINDS] == list(
        EVENT_KINDS)
    from torchft_tpu_torch.utils.events import EventRecorder

    port = EventRecorder(capacity=8, enabled=True, replica_id="r", rank=0)
    ref = jax_events.EventRecorder(capacity=8, enabled=True, replica_id="r",
                                   rank=0)
    for rec in (port, ref):
        rec.emit("job_preempted", step=3, epoch=7, job_id="lo")
    got, want = port.since(0)[0][0], ref.since(0)[0][0]
    assert set(got) == set(want)
    assert {k: got[k] for k in ("kind", "step", "epoch", "job_id")} == {
        k: want[k] for k in ("kind", "step", "epoch", "job_id")}


# ------------------------------------------------------------ legacy clients


def _legacy_member(i, step=0):
    return {"replica_id": f"legacy_{i:02d}",
            "address": f"http://localhost:{2000 + i}",
            "store_address": f"localhost:{3000 + i}",
            "step": step, "world_size": 1}


def test_legacy_clients_land_in_default_job() -> None:
    """Clients that name no job form their quorum in the "default" job,
    get the single-job answer shape, and the root of /status.json mirrors
    the default job; their heartbeats and epoch watches hit it too, and
    the JAX package's client reads the same answers."""
    lh = Lighthouse(min_replicas=2, join_timeout_ms=200, quorum_tick_ms=10,
                    heartbeat_timeout_ms=30000)
    try:
        addr = lh.address()
        want = {"legacy_00", "legacy_01"}
        responses = [None, None]

        def _q_until(i):
            client = LighthouseClient(addr)
            deadline = time.monotonic() + 30.0
            while time.monotonic() < deadline:
                resp = client.quorum(_legacy_member(i), timeout=2.0)
                got = {p["replica_id"] for p in
                       resp.get("quorum", {}).get("participants", [])}
                if want <= got:
                    responses[i] = resp
                    return
            raise AssertionError(f"legacy member {i} never saw full quorum")

        threads = [threading.Thread(target=_q_until, args=(i,))
                   for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60.0)
            assert not t.is_alive()
        for resp in responses:
            assert resp is not None
            assert set(resp) == {"quorum", "membership_epoch", "lease_ms"}

        status = _status(lh)
        assert set(status["jobs"]) == {"default"}
        dj = status["jobs"]["default"]
        assert status["quorum"]["quorum_id"] == dj["quorum_id"]
        assert sorted(p["replica_id"] for p in
                      status["quorum"]["participants"]) == sorted(
            dj["quorum_replica_ids"])
        assert status["control"]["quorum_rpcs"] == dj["quorum_rpcs"]
        assert status["control"]["membership_epoch"] == dj[
            "membership_epoch"]

        client = LighthouseClient(addr)
        client.heartbeat("legacy_hb")
        status = _status(lh)
        assert "legacy_hb" in status["heartbeats"]
        assert status["jobs"]["default"]["heartbeat_rpcs"] >= 1

        epoch = status["jobs"]["default"]["membership_epoch"]
        t0 = time.monotonic()
        new_epoch, changed = client.epoch_watch("legacy_00", epoch,
                                                timeout=0.3)
        assert not changed and new_epoch == epoch
        assert time.monotonic() - t0 >= 0.1
        # the JAX package's client parks on the same epoch and renews
        assert jax_control.LighthouseClient(addr).epoch_watch(
            "legacy_00", epoch, timeout=0.3) == (epoch, False)
        waker = threading.Timer(0.2, LighthouseClient(addr).heartbeat,
                                ("legacy_stranger",))
        waker.start()
        try:
            new_epoch, changed = client.epoch_watch("legacy_00", epoch,
                                                    timeout=10.0)
        finally:
            waker.join()
        assert changed and new_epoch > epoch
    finally:
        lh.shutdown()


# ----------------------------------------------------- byte-equal requests


class _Recorder:
    """The native library with the request bodies of the lighthouse
    client's and servers' calls recorded on their way through."""

    _BODY_ARG = {"ft_lighthouse_client_heartbeat2": 1,
                 "ft_lighthouse_client_quorum2": 1,
                 "ft_lighthouse_client_heartbeat": 1,
                 "ft_lighthouse_client_quorum": 1,
                 "ft_lighthouse_client_post": 2,
                 "ft_lighthouse_new": 7,
                 "ft_manager_new": 10}

    def __init__(self, lib) -> None:
        self._lib = lib
        self.calls = []

    def __getattr__(self, name):
        fn = getattr(self._lib, name)
        if name not in self._BODY_ARG:
            return fn

        def _call(*args):
            extra = (args[1],) if name == "ft_lighthouse_client_post" else ()
            self.calls.append((name, *extra, args[self._BODY_ARG[name]]))
            return fn(*args)

        return _call


def _drive_client(pkg_control, addr):
    # every quorum asks for the same member, so each forms at once (the
    # last quorum's members all asking again)
    client = pkg_control.LighthouseClient(addr)
    member = _legacy_member(7)
    answers = [
        client.quorum(member, timeout=10.0),
        client.quorum(member, timeout=10.0, job_id="j"),
        client.quorum(member, timeout=10.0, extra={"priority": 3}),
        client.quorum(member, timeout=10.0, job_id="k",
                      extra={"priority": 1, "group_budget": 2}),
        pkg_control.lighthouse_quorum(addr, member, timeout=10.0),
        client.register_job("j", priority=2, group_budget=1, rpc_budget=50),
        client.register_job("k"),
        client.post("/torchft.LighthouseService/RegisterJob",
                    {"job_id": "m", "priority": 4}),
        client.epoch_watch("r1", 10**6, timeout=1.0, job_id="j"),
        client.epoch_watch("r1", 10**6, timeout=1.0),
    ]
    client.heartbeat("r1")
    client.heartbeat(["r1", "r2"])
    client.heartbeat("r1", job_id="j")
    client.heartbeat(["r1", "r2"], job_id="j")
    pkg_control.lighthouse_heartbeat(addr, "r3")
    return answers


def _shape(x):
    if isinstance(x, dict):
        return {k: _shape(v) for k, v in x.items()
                if k not in ("created_ms", "quorum_id", "membership_epoch")}
    if isinstance(x, (list, tuple)):
        return [_shape(v) for v in x]
    return type(x).__name__


def test_request_bodies_byte_equal_to_the_reference(monkeypatch) -> None:
    """The same calls through both packages' clients and servers put the
    same bytes on the wire: heartbeats (one id, a batch, in a job),
    quorums (plain, in a job, with admission fields), RegisterJob, raw
    posts, epoch watches, the one-shot RPCs, and the servers' ``extra``
    JSON (``fleet_capacity``, ``job_id``); the answers have one shape."""
    recs = {}
    for name, mod in (("torch", control), ("jax", jax_control)):
        rec = _Recorder(mod.get_lib())
        monkeypatch.setattr(mod, "get_lib", lambda rec=rec: rec)
        recs[name] = rec
    answers = {}
    for name, mod in (("torch", control), ("jax", jax_control)):
        lh = mod.Lighthouse(min_replicas=1, join_timeout_ms=50,
                            quorum_tick_ms=10, lease_ms=500,
                            fleet_capacity=7, prune_after_ms=60000)
        try:
            server = mod.ManagerServer("ms_0", lh.address(),
                                       hostname="127.0.0.1",
                                       store_addr="127.0.0.1:1",
                                       exit_on_kill=False, job_id="srv")
            server.shutdown()
            answers[name] = _drive_client(mod, lh.address())
        finally:
            lh.shutdown()
    assert recs["torch"].calls == recs["jax"].calls
    assert len(recs["torch"].calls) == 17
    assert _shape(answers["torch"]) == _shape(answers["jax"])
    assert answers["torch"][5] == {"job_id": "j", "priority": 2,
                                   "group_budget": 1, "rpc_budget": 50}


# ------------------------------------------------------------- mixed cohort


class _KeyLog:
    """Every key each package's store clients set."""

    def __init__(self) -> None:
        self.keys = {}
        self.lock = threading.Lock()

    def wrap(self, pkg, cls):
        orig = cls.set
        log = self

        def _set(client, key, value):
            with log.lock:
                log.keys.setdefault(pkg, set()).add(key)
            return orig(client, key, value)

        return _set


@pytest.mark.parametrize("transport", ["torch", "jax"])
def test_mixed_cohort_in_one_job_same_keys_and_bitwise_heal(
        monkeypatch, transport) -> None:
    """A JAX-package Manager and a port Manager in job "mix" on one
    lighthouse: every group-store key each writes is the same string, they
    allreduce together over both packages' TCP wires, and the one behind
    heals from the other bitwise. Both heal over one package's checkpoint
    transport (``transport``): a heal without a template rebuilds the
    donor's tree structure, which does not cross packages (only the
    template heal does, tests/test_torch_heal_plane.py)."""
    import torchft_tpu.checkpointing as jax_ckpt
    import torchft_tpu.comm.store as jax_store

    log = _KeyLog()
    for pkg, mod in (("torch", store_mod), ("jax", jax_store)):
        monkeypatch.setattr(mod.StoreClient, "set",
                            log.wrap(pkg, mod.StoreClient))
    server_cls = (CheckpointServer if transport == "torch"
                  else jax_ckpt.CheckpointServer)
    lh = Lighthouse(min_replicas=1, join_timeout_ms=5000, quorum_tick_ms=10,
                    heartbeat_timeout_ms=5000)
    stores = [StoreServer(), StoreServer()]
    rng = np.random.default_rng(1010)
    init = rng.standard_normal(64).astype(np.float32)
    states = [{"w": init.copy()}, {"w": rng.standard_normal(64)
                                   .astype(np.float32)}]
    managers = []

    def make(i, pkg):
        def load(sd):
            states[i]["w"] = np.array(sd["w"], np.float32)

        managers.append(_make_manager(
            pkg, stores[i], lh, f"mix{i}_", "mix", use_async_quorum=True,
            timeout=10.0, quorum_timeout=10.0, connect_timeout=10.0,
            checkpoint_transport=server_cls(timeout=10.0),
            state_dict=lambda: {"w": states[i]["w"]}, load_state_dict=load))

    try:
        make(0, "jax")
        sums = [None, None]

        def joint(i):
            m = managers[i]
            # group 0 steps once alone first: group 1 is behind and heals
            m.start_quorum()
            out = m.allreduce_arrays([np.full(4, i + 1.0, np.float32)])
            got = out.future().result(timeout=20)[0].copy()
            ok = m.should_commit()
            return got, ok, m.did_heal(), m.num_participants()

        assert joint(0)[1]  # step 1 alone
        make(1, "torch")
        with ThreadPoolExecutor(max_workers=2) as pool:
            # the newcomer asks first: a quorum of the last one's members
            # alone would form at once without it
            late = pool.submit(joint, 1)
            _wait_lighthouse(lh.address(), "participants", 1, 20.0,
                             threading.Event(), job="mix")
            res = [joint(0), late.result(timeout=30)]
        for i, (got, ok, healed, parts) in enumerate(res):
            assert ok and parts == 1  # the healer contributes zeros
            sums[i] = got
        assert res[1][2] and not res[0][2]
        assert np.array_equal(states[1]["w"], init)  # bitwise heal
        assert np.array_equal(sums[0], sums[1])
        assert np.array_equal(sums[0], np.full(4, 1.0, np.float32))
        with ThreadPoolExecutor(max_workers=2) as pool:
            res = list(pool.map(joint, range(2)))
        assert all(ok and parts == 2 for _, ok, _, parts in res)
        assert np.array_equal(res[0][0], np.full(4, 1.5, np.float32))
        assert np.array_equal(res[0][0], res[1][0])
        assert [m.current_step() for m in managers] == [3, 3]
    finally:
        _shutdown(managers, stores, lh)
    # the group-store keys, byte for byte; the wire's rendezvous keys sit
    # under the quorum's torchft/{quorum_id}/{fingerprint}/ prefix
    group = {pkg: sorted(k for k in keys if not k.startswith("torchft/"))
             for pkg, keys in log.keys.items()}
    assert group["torch"] == group["jax"] == [
        "job:mix/checkpoint_addr_0", "job:mix/manager_addr",
        "job:mix/replica_id"]


# ------------------------------------------------------------- the drill


def test_multijob_drill_at_tiny(monkeypatch) -> None:
    """run_multijob_drill at "tiny" on the CPU: its own checks (bitwise
    heal, participants, the observer, B's flat counters and 0 RPCs, the
    prescriptive eviction), and the cross-job numbers: A (with its
    observer) and B run the same seeds and data, so their parameters agree
    bit for bit at every step up to the kill."""
    from torchft_tpu_torch.examples.train_ddp import run_multijob_drill
    from torchft_tpu_torch.models import CONFIGS

    monkeypatch.setenv("TORCHFT_TPU_FASTPATH", "1")
    result = run_multijob_drill(CONFIGS["tiny"], device="cpu", batch_size=2,
                                timeout=30.0)
    assert result["cross_job_equal"] == [1, 2, 3]
    assert result["eviction"]["seconds"] < 5.0
    assert result["probe_passes"] == 7
    runs = result["runs"]
    assert runs["b1"][0].evicted_at == 7
    assert sorted(runs["b0"][0].participants) == list(range(1, 10))
    assert runs["a_obs"][0].passes == 0
    # a0 commits step 4 alone on a solo wire: one fused step
    assert runs["a0"][0].fused_steps == 1
    assert result["passes"] == sum(r.passes for n in runs if n != "hi0"
                                   for r in runs[n])
