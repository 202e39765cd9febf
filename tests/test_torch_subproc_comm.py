"""The port's subprocess-isolated comm context (twins of
tests/test_subproc_comm.py): ``SubprocessCommContext`` hosts the port's
``TcpCommContext`` in a spawn-context child. Two ranks allreduce through
their children; a reconfigure SIGKILLs the previous child (a new pid, the
old one gone, ``wire_generation`` bumped); a SIGSTOPped (wedged) child
fails its op within the context's timeout + 10 s, the ops queued behind it
at once, and the next configure replaces it; a child's death surfaces as
an error and latches; the codec and the other transport options reach
the child, the hierarchical tier too (four children over a 2x2 domain
map, bitwise both packages' host composition). Each wait carries its own
timeout. Tolerance: bitwise, except the bf16 codec's allreduce (rtol
1e-2, as the reference test).
"""

import json
import os
import signal
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from torchft_tpu_torch.comm.context import ReduceOp
from torchft_tpu_torch.comm.store import StoreServer
from torchft_tpu_torch.comm.subproc import SubprocessCommContext


@pytest.fixture()
def store():
    server = StoreServer()
    yield server
    server.shutdown()


def _gone(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return True
    return False


def test_subproc_allreduce_two_ranks(store) -> None:
    ctxs = [SubprocessCommContext(timeout=20.0) for _ in range(2)]
    try:
        with ThreadPoolExecutor(max_workers=2) as pool:
            for f in [pool.submit(ctxs[r].configure, f"{store.addr}/sp", r, 2)
                      for r in range(2)]:
                f.result(timeout=60)
        w0 = ctxs[0].allreduce([np.full(4, 1.0, np.float32)])
        w1 = ctxs[1].allreduce([np.full(4, 2.0, np.float32)])
        assert w0.future().result(timeout=20)[0].tobytes() == \
            np.full(4, 3.0, np.float32).tobytes()
        w1.future().result(timeout=20)
        # reduce_scatter by owner and allgather by rank, through the child
        works = [ctxs[r].reduce_scatter(
            [np.full(3, r + 1.0, np.float32), np.full(2, 1.0, np.float32)],
            owners=[1, 0]) for r in range(2)]
        got = [w.future().result(timeout=20) for w in works]
        assert (got[1][0] == 3.0).all() and (got[0][1] == 2.0).all()
        gathered = [ctxs[r].allgather([np.full(2, r, np.int64)])
                    for r in range(2)]
        assert [a[0].tolist() for a in gathered[0].future().result(20)] == \
            [[0, 0], [1, 1]]
        gathered[1].future().result(20)
        # the child really is a separate process
        assert ctxs[0].child_pid() not in (None, os.getpid())
        assert ctxs[0].child_pid() != ctxs[1].child_pid()
    finally:
        for c in ctxs:
            c.shutdown()


def test_subproc_reconfigure_kills_child(store) -> None:
    ctx = SubprocessCommContext(timeout=10.0)
    try:
        ctx.configure(f"{store.addr}/solo1", 0, 1)
        pid1, gen1 = ctx.child_pid(), ctx.wire_generation()
        out = ctx.allreduce([np.ones(2)]).future().result(timeout=20)
        np.testing.assert_array_equal(out[0], np.ones(2))
        ctx.configure(f"{store.addr}/solo2", 0, 1)
        assert ctx.child_pid() != pid1 and _gone(pid1)
        assert ctx.wire_generation() == gen1 + 1
        out = ctx.allreduce([np.full(2, 5.0)]).future().result(timeout=20)
        np.testing.assert_array_equal(out[0], np.full(2, 5.0))
    finally:
        ctx.shutdown()


def test_subproc_wedged_child_killed(store) -> None:
    # a wedged transport: the child is SIGSTOPped with ops queued; the
    # first fails after timeout + 10 s, the rest at once (not one timeout
    # each), and configure recovers by SIGKILLing the child: the trainer
    # process lives on
    ctx = SubprocessCommContext(timeout=1.0)
    try:
        ctx.configure(f"{store.addr}/wedge", 0, 1)
        pid = ctx.child_pid()
        os.kill(pid, signal.SIGSTOP)
        t0 = time.monotonic()
        works = [ctx.allreduce([np.ones(2)]) for _ in range(3)]
        for work in works:
            with pytest.raises((ConnectionError, TimeoutError)):
                work.future().result(timeout=30)
        assert time.monotonic() - t0 < 1.0 + 10 + 5
        assert ctx.errored() is not None
        ctx.configure(f"{store.addr}/wedge2", 0, 1)
        assert ctx.child_pid() != pid and _gone(pid)
        assert ctx.errored() is None
        out = ctx.allreduce([np.full(3, 2.0)]).future().result(timeout=20)
        np.testing.assert_array_equal(out[0], np.full(3, 2.0))
    finally:
        ctx.shutdown()


def test_subproc_child_death_surfaces_error(store) -> None:
    ctx = SubprocessCommContext(timeout=5.0)
    try:
        ctx.configure(f"{store.addr}/die", 0, 1)
        os.kill(ctx.child_pid(), signal.SIGKILL)
        time.sleep(0.3)
        with pytest.raises(ConnectionError):
            ctx.allreduce([np.ones(2)]).future().result(timeout=20)
        assert ctx.errored() is not None
        # a latched context refuses new ops until the next configure
        with pytest.raises(ConnectionError, match="previously errored"):
            ctx.allreduce([np.ones(2)]).future().result(timeout=5)
    finally:
        ctx.shutdown()


def test_subprocess_compression_plumbed(store) -> None:
    # the codec and transport options reach the child's TcpCommContext
    ctxs = [SubprocessCommContext(timeout=15.0, compression="bf16",
                                  algorithm="star", channels=2)
            for _ in range(2)]
    results = [None, None]

    def _worker(rank):
        ctxs[rank].configure(f"{store.addr}/subc", rank, 2)
        work = ctxs[rank].allreduce(
            [np.full(8, float(rank + 1) + 1e-3, np.float32)], ReduceOp.SUM)
        results[rank] = work.future().result(timeout=20)[0]

    try:
        with ThreadPoolExecutor(max_workers=2) as pool:
            for f in [pool.submit(_worker, r) for r in range(2)]:
                f.result(timeout=60)
    finally:
        for ctx in ctxs:
            ctx.shutdown()
    for out in results:
        np.testing.assert_allclose(out, np.full(8, 3.002), rtol=1e-2)
    assert results[0].tobytes() == results[1].tobytes()
    # bf16 on the wire: not the exact f32 sum
    assert results[0].tobytes() != np.full(8, 3.002, np.float32).tobytes()
    assert SubprocessCommContext.unsupported_reason("star", "bf16") is None
    assert SubprocessCommContext.unsupported_reason("nccl", "none")


def test_subprocess_context_forwards_hier(store, monkeypatch) -> None:
    # topology="hier" reaches each child's TcpCommContext, whose resolver
    # reads the domain map from the environment it inherited
    from torchft_tpu.comm.xla_backend import (
        _host_hier_allreduce as ref_hier,
    )
    from torchft_tpu_torch.comm.cuda_backend import _host_hier_allreduce

    chunk, groups = 1 << 12, ((0, 1), (2, 3))
    monkeypatch.setenv("TORCHFT_TPU_DOMAINS", json.dumps(
        {"d0": ["rank0", "rank1"], "d1": ["rank2", "rank3"]}))
    rng = np.random.default_rng(29)
    srcs = [(rng.standard_normal(1024) * (r + 1)).astype(np.float32)
            for r in range(4)]
    want = _host_hier_allreduce([[s.copy()] for s in srcs], "int8", chunk,
                                ReduceOp.SUM, groups, 4)[0]
    assert want.tobytes() == ref_hier([[s.copy()] for s in srcs], "int8",
                                      chunk, ReduceOp.SUM, groups, 4)[0] \
        .tobytes()
    ctxs = [SubprocessCommContext(timeout=30.0, algorithm="star",
                                  channels=2, compression="int8",
                                  chunk_bytes=chunk, topology="hier")
            for _ in range(4)]
    try:
        def run(rank):
            ctxs[rank].configure(f"{store.addr}/sub_hier", rank, 4)
            work = ctxs[rank].allreduce([srcs[rank].copy()])
            return work.future().result(timeout=60)[0]

        with ThreadPoolExecutor(max_workers=4) as pool:
            outs = [f.result(timeout=180)
                    for f in [pool.submit(run, r) for r in range(4)]]
        for out in outs:
            assert out.tobytes() == want.tobytes()
    finally:
        for c in ctxs:
            c.shutdown()
