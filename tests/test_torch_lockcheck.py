"""The port's runtime lock-order detector (torchft_tpu_torch.analysis.
lockcheck), twin of tests/test_lockcheck.py.

The seeded violation is the classic inverted pair: site A taken before
B on one path, B before A on another. The detector must flag it even
though the two paths never actually deadlocked — acquisition-ORDER
cycles are latent deadlocks, and catching them without the lucky
interleaving is the whole point. The clean-path tests pin the
non-goals: reentrant RLocks, same-site sibling instances, and
Condition integration must NOT report; and a real two-rank transport
allreduce under full instrumentation must come back cycle-free.
"""

import threading

import numpy as np
import pytest

from torchft_tpu_torch.analysis import lockcheck

pytestmark = pytest.mark.analysis


@pytest.fixture(autouse=True)
def _fresh_graph():
    lockcheck.reset()
    yield
    lockcheck.uninstall()
    lockcheck.reset()


def test_inverted_pair_raises():
    a = lockcheck.Lock("site-A")
    b = lockcheck.Lock("site-B")
    with a:
        with b:
            pass
    b.acquire()
    with pytest.raises(lockcheck.LockOrderError) as ei:
        a.acquire()
    # no leak: the failed acquire released its inner lock before
    # raising, so only b is held here — and a is free for others
    assert not a.locked()
    b.release()
    assert "site-A" in str(ei.value) and "site-B" in str(ei.value)
    cycles = lockcheck.cycles()
    assert len(cycles) == 1
    assert cycles[0]["new_edge"] == "site-B -> site-A"


def test_transitive_cycle_detected():
    a, b, c = (lockcheck.Lock(s) for s in ("t-A", "t-B", "t-C"))
    with a:
        with b:
            pass
    with b:
        with c:
            pass
    c.acquire()
    with pytest.raises(lockcheck.LockOrderError):
        a.acquire()  # C -> A closes A -> B -> C
    assert not a.locked()  # released before the raise
    c.release()


def test_record_only_mode(monkeypatch):
    monkeypatch.setenv(lockcheck.ENV_RAISE, "0")
    a = lockcheck.Lock("r-A")
    b = lockcheck.Lock("r-B")
    with a:
        with b:
            pass
    with b:
        with a:
            pass
    assert len(lockcheck.cycles()) == 1
    rep = lockcheck.report()
    assert "r-A -> r-B" in rep["edges"]
    assert "r-B -> r-A" in rep["edges"]


def test_one_acquisition_records_every_closed_cycle(monkeypatch):
    # acquiring C while holding [A, B] can close TWO distinct cycles;
    # both must land in cycles() (the freshly-inserted edges would
    # otherwise suppress re-detection forever)
    monkeypatch.setenv(lockcheck.ENV_RAISE, "0")
    a, b, c = (lockcheck.Lock(s) for s in ("m-A", "m-B", "m-C"))
    with c:
        with a:
            pass
    with c:
        with b:
            pass
    with a:
        with b:
            with c:
                pass
    closed = sorted(x["new_edge"] for x in lockcheck.cycles())
    assert closed == ["m-A -> m-C", "m-B -> m-C"], closed


def test_consistent_order_is_clean():
    a = lockcheck.Lock("c-A")
    b = lockcheck.Lock("c-B")
    for _ in range(3):
        with a:
            with b:
                pass
    assert lockcheck.cycles() == []


def test_reentrant_rlock_and_same_site_instances_clean():
    r = lockcheck.RLock("re-A")
    with r:
        with r:  # reentrancy is not an ordering edge
            pass
    # two instances born at one site (per-object locks of one class):
    # nested acquisition cannot be ordered and must not self-cycle
    def make():
        return lockcheck.Lock("shared-site")
    l1, l2 = make(), make()
    l1.site = l2.site = "shared-site"
    with l1:
        with l2:
            pass
    with l2:
        with l1:
            pass
    assert lockcheck.cycles() == []


def test_cross_thread_release_leaves_no_phantom_edges():
    # threading.Lock may legally be released by another thread (handoff
    # idioms); the holder's thread-local stack must not keep a phantom
    # entry that manufactures bogus edges afterwards
    handoff = lockcheck.Lock("x-handoff")
    other = lockcheck.Lock("x-other")
    handoff.acquire()
    t = threading.Thread(target=handoff.release)
    t.start()
    t.join(5)
    assert not handoff.locked()
    with other:  # must NOT record "x-handoff -> x-other"
        pass
    rep = lockcheck.report()
    assert "x-handoff -> x-other" not in rep["edges"], rep["edges"]
    assert lockcheck.cycles() == []


def test_nested_rlock_release_keeps_ownership_edges():
    # an inner reentrant release must not un-own the outer level: the
    # edge A -> B while still holding A has to be recorded
    a = lockcheck.RLock("nest-A")
    b = lockcheck.Lock("nest-B")
    with a:
        with a:
            pass
        with b:
            pass
    rep = lockcheck.report()
    assert "nest-A -> nest-B" in rep["edges"], rep["edges"]
    assert lockcheck.cycles() == []


def test_condition_over_plain_lock():
    # Condition(Lock()) is legal; the cv must route through the
    # instrumented _release_save/_acquire_restore (record-only on
    # re-acquire) instead of raw acquire()
    cond = threading.Condition(lockcheck.Lock("cv-plain"))
    got = []

    def waiter():
        with cond:
            while not got:
                if not cond.wait(timeout=5.0):
                    break
            got.append("woke")

    t = threading.Thread(target=waiter)
    t.start()
    with cond:
        got.append("go")
        cond.notify_all()
    t.join(timeout=10.0)
    assert not t.is_alive()
    assert "woke" in got
    assert lockcheck.cycles() == []


def test_condition_integration():
    cond = threading.Condition(lockcheck.RLock("cv-lock"))
    hits = []

    def waiter():
        with cond:
            while not hits:
                if not cond.wait(timeout=5.0):
                    break
            hits.append("woke")

    t = threading.Thread(target=waiter)
    t.start()
    with cond:
        hits.append("go")
        cond.notify_all()
    t.join(timeout=10.0)
    assert not t.is_alive()
    assert "woke" in hits
    assert lockcheck.cycles() == []


def test_install_patches_threading_and_condition_default():
    lockcheck.install()
    try:
        lk = threading.Lock()
        rk = threading.RLock()
        assert isinstance(lk, lockcheck.Lock)
        assert isinstance(rk, lockcheck.RLock)
        # Condition() with no lock must pick up the patched RLock
        cond = threading.Condition()
        assert isinstance(cond._lock, lockcheck.RLock)
        with cond:
            cond.notify_all()
    finally:
        lockcheck.uninstall()
    assert not isinstance(threading.Lock(), lockcheck.Lock)


def test_real_transport_allreduce_clean_under_lockcheck():
    """A real two-rank socket allreduce with every
    transport/store/futures lock instrumented: the repo's actual lane
    threads + store server + futures chaining must produce an
    acquisition graph with no cycles (and the reduce must still be
    correct — instrumentation cannot perturb values)."""
    lockcheck.install()
    try:
        from torchft_tpu_torch.comm import StoreServer, TcpCommContext
        from torchft_tpu_torch.comm.wire_stub import run_stub_ranks

        store = StoreServer()
        try:
            def fn(mgr, rank):
                arr = np.full(257, float(rank + 1), np.float32)
                return mgr.allreduce_arrays([arr]).future().result()[0]

            out = run_stub_ranks(
                store.addr, "lockcheck", 2, fn,
                lambda: TcpCommContext(timeout=15.0), timeout=60.0,
            )
        finally:
            store.shutdown()
    finally:
        lockcheck.uninstall()
    # manager semantics: SUM scaled by 1/num_participants -> (1+2)/2
    np.testing.assert_allclose(out[0], np.full(257, 1.5, np.float32))
    np.testing.assert_allclose(out[0], out[1])
    rep = lockcheck.report()
    assert rep["cycles"] == [], rep["cycles"]
    # sanity: the instrumentation actually saw the transport's locks
    assert rep["edges"], "no lock-order edges recorded — install failed?"


def test_package_root_installs_under_the_env_var():
    # TORCHFT_TPU_LOCKCHECK=1 before the import: the root installs the
    # detector before its own imports create their locks, and still imports
    # no torch
    import subprocess
    import sys

    code = ("import sys, threading, torchft_tpu_torch\n"
            "from torchft_tpu_torch.analysis import lockcheck\n"
            "print(lockcheck.installed(), "
            "isinstance(threading.Lock(), lockcheck.Lock), "
            "'torch' in sys.modules)")
    env = dict(__import__("os").environ, TORCHFT_TPU_LOCKCHECK="1")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, env=env)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.split() == ["True", "True", "False"], r.stdout
