"""The port's future helpers and fragment grid against the JAX package's.

Twins of the FutureGroup cases of tests/test_ddp_pipeline.py and the
future_wait cases of tests/test_futures.py (seal, outstanding, exception
propagation after every member settles, timeout), ``future_all``'s
contract, and ``comm.wire.split_weighted`` equal to the reference's grid
for random leaf sizes and part counts.
"""

import threading
import time
from concurrent.futures import Future

import numpy as np
import pytest

from torchft_tpu import futures as jax_futures
from torchft_tpu.comm.wire import split_weighted as jax_split_weighted
from torchft_tpu_torch.comm.wire import split_weighted
from torchft_tpu_torch.futures import (
    FutureGroup,
    completed_future,
    failed_future,
    future_all,
    future_timeout,
    future_wait,
)


def _pending():
    f = Future()
    f.set_running_or_notify_cancel()
    return f


def test_future_group_resolves_after_all_members() -> None:
    group = FutureGroup()
    members = [_pending() for _ in range(3)]
    for m in members:
        group.add(m)
    assert group.outstanding == 3
    out = group.seal(lambda: "done")
    members[2].set_result(None)  # out of order
    members[0].set_result(None)
    assert not out.done() and group.outstanding == 1
    members[1].set_result(None)
    assert out.result(timeout=5) == "done"
    assert group.outstanding == 0


def test_future_group_empty_seal_resolves_immediately() -> None:
    assert FutureGroup().seal(lambda: 42).result(timeout=1) == 42


def test_future_group_member_error_fails_after_all_settle() -> None:
    group = FutureGroup()
    a, b = _pending(), _pending()
    group.add(a)
    group.add(b)
    out = group.seal(lambda: "never")
    a.set_exception(ValueError("boom"))
    # the group stays open until every member settled (quiescence)
    assert not out.done()
    b.set_result(None)
    with pytest.raises(ValueError, match="boom"):
        out.result(timeout=5)


def test_future_group_seal_fn_error_and_double_seal() -> None:
    group = FutureGroup()
    out = group.seal(lambda: 1 / 0)
    with pytest.raises(ZeroDivisionError):
        out.result(timeout=1)
    with pytest.raises(RuntimeError, match="sealed twice"):
        group.seal(lambda: None)


def test_future_group_add_after_seal_rejected() -> None:
    group = FutureGroup()
    group.seal(lambda: None)
    with pytest.raises(RuntimeError, match="after seal"):
        group.add(_pending())


def test_future_group_accepts_completed_members() -> None:
    group = FutureGroup()
    group.add(completed_future(1))
    group.add(failed_future(KeyError("k")))
    with pytest.raises(KeyError):
        group.seal(lambda: "ok").result(timeout=1)
    ok = FutureGroup()
    ok.add(completed_future(1))
    assert ok.seal(lambda: "ok").result(timeout=1) == "ok"


def test_future_group_matches_reference_under_threads() -> None:
    # the same members completed from many threads in a random order give
    # both packages' groups the same outcome
    rng = np.random.default_rng(0)
    for trial in range(8):
        n = int(rng.integers(1, 12))
        fail = int(rng.integers(-1, n))
        outcomes = []
        for group in (FutureGroup(), jax_futures.FutureGroup()):
            members = [_pending() for _ in range(n)]
            for m in members:
                group.add(m)
            out = group.seal(lambda: "sealed")
            threads = []
            for i in rng.permutation(n):
                m = members[i]
                done = ((lambda m=m: m.set_exception(RuntimeError("x")))
                        if i == fail else (lambda m=m: m.set_result(i)))
                threads.append(threading.Thread(target=done))
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=5)
            exc = out.exception(timeout=5)
            outcomes.append("error" if exc is not None else out.result())
        assert outcomes[0] == outcomes[1], trial


def test_future_all_waits_for_every_member() -> None:
    assert future_all([]).result(timeout=1) == []
    a, b = _pending(), _pending()
    out = future_all([a, b])
    b.set_exception(RuntimeError("late"))
    assert not out.done()
    a.set_result(3)
    got = out.result(timeout=1)
    assert got == [a, b] and got[0].result() == 3
    assert isinstance(got[1].exception(), RuntimeError)


def test_future_wait() -> None:
    fut = Future()

    def _complete():
        time.sleep(0.05)
        fut.set_result("ok")

    threading.Thread(target=_complete, daemon=True).start()
    assert future_wait(fut, 2.0) == "ok"


def test_future_wait_timeout_is_builtin() -> None:
    with pytest.raises(TimeoutError, match="timed out"):
        future_wait(Future(), 0.05)
    # a future that itself failed with a TimeoutError re-raises that one
    own = failed_future(TimeoutError("its own"))
    with pytest.raises(TimeoutError, match="its own"):
        future_wait(own, 1.0)


@pytest.mark.parametrize("seed", range(6))
def test_split_weighted_equals_reference(seed) -> None:
    rng = np.random.default_rng(seed)
    for _ in range(50):
        n = int(rng.integers(1, 40))
        weights = [int(w) for w in rng.integers(0, 1 << 22, n)]
        if rng.random() < 0.2:
            weights[int(rng.integers(0, n))] = 0
        for parts in (1, 2, 3, 5, 8, 64):
            grid = split_weighted(weights, parts)
            assert grid == jax_split_weighted(weights, parts)
            assert grid[0][0] == 0 and grid[-1][1] == n
            assert len(grid) == min(parts, n)
            assert all(a < b for a, b in grid)


def test_cancelled_timeout_releases_its_callback() -> None:
    # a future resolved before its deadline cancels the timer, and the
    # cancelled entry, still in the heap until the deadline, no longer
    # holds the wrapper future or what its continuations close over (the
    # reference's asyncio handle drops its callback on cancel too)
    import gc
    import weakref

    class Payload:
        pass

    fut = Future()
    payload = Payload()
    timed = future_timeout(fut, 3600.0)
    timed.add_done_callback(lambda f, p=payload: p)
    ref = weakref.ref(payload)
    fut.set_result(1)
    assert timed.result(timeout=5) == 1
    del fut, timed, payload
    gc.collect()
    assert ref() is None
