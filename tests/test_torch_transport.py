"""The port's TcpCommContext against the JAX package's, rank for rank.

A mixed cohort — ranks of both packages in one allreduce — must give
results bitwise equal to an all-JAX cohort's on the same inputs: the frames
are byte-compatible and the reduction order is the same (star: the root
adds peers in rank order per chunk; ring: reduce-scatter then all-gather
per chunk). Payloads span several 1 MiB chunks, so the lane striping runs.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from torchft_tpu.comm import store as jstore
from torchft_tpu.comm.transport import TcpCommContext as JaxTcp
from torchft_tpu_torch.comm.context import (
    DummyCommContext,
    ErrorSwallowingCommContext,
    ReduceOp,
)
from torchft_tpu_torch.comm.transport import TcpCommContext


def _arrays(rank):
    rng = np.random.default_rng(100 + rank)
    return [
        rng.standard_normal(600_000).astype(np.float32),  # 2.3 MiB: 3 chunks
        rng.standard_normal((17, 33)).astype(np.float32),
        rng.standard_normal(1000),                         # float64
        rng.integers(-50, 50, 64).astype(np.int32),
        np.zeros(0, np.float32),
    ]


def _run_cohort(kinds, algorithm, op=ReduceOp.SUM):
    server = jstore.StoreServer()
    world = len(kinds)
    ctxs = [(TcpCommContext if k == "port" else JaxTcp)(
        timeout=10.0, algorithm=algorithm) for k in kinds]
    addr = f"{server.addr}/torchft/1/cohort/0"
    try:
        with ThreadPoolExecutor(max_workers=world) as pool:
            list(pool.map(lambda r: ctxs[r].configure(addr, r, world),
                          range(world)))
            works = [ctxs[r].allreduce(_arrays(r), op) for r in range(world)]
            return [w.future().result(timeout=30) for w in works]
    finally:
        for c in ctxs:
            c.shutdown()
        server.shutdown()


@pytest.mark.parametrize("kinds,algorithm", [
    (("port", "jax"), "auto"),          # star at world size 2
    (("jax", "port"), "auto"),
    (("port", "jax", "port"), "auto"),  # ring at world size 3
    (("jax", "port", "jax"), "auto"),
    (("port", "jax"), "ring"),
    (("jax", "port", "port"), "star"),
])
def test_mixed_cohort_bitwise_equals_reference(kinds, algorithm) -> None:
    mixed = _run_cohort(kinds, algorithm)
    reference = _run_cohort(("jax",) * len(kinds), algorithm)
    expected = [sum(_arrays(r)[i] for r in range(len(kinds)))
                for i in range(len(_arrays(0)))]
    for r in range(len(kinds)):
        for got, ref, want in zip(mixed[r], reference[r], expected):
            assert got.dtype == ref.dtype and got.shape == ref.shape
            assert got.tobytes() == ref.tobytes()
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        for got, first in zip(mixed[r], mixed[0]):
            assert got.tobytes() == first.tobytes()


def test_port_only_cohort_max_op() -> None:
    results = _run_cohort(("port", "port", "port"), "ring", ReduceOp.MAX)
    want = np.maximum.reduce([_arrays(r)[1] for r in range(3)])
    for r in range(3):
        assert np.array_equal(results[r][1], want)


def test_allreduce_is_in_place_on_donated_arrays() -> None:
    ctx = TcpCommContext()
    ctx.configure("unused:0", 0, 1)
    a = np.arange(10, dtype=np.float32)
    out = ctx.allreduce([a]).future().result(timeout=5)
    assert out[0] is a
    ctx.shutdown()


def test_error_latches_until_reconfigure() -> None:
    server = jstore.StoreServer()
    ctxs = [TcpCommContext(timeout=2.0), TcpCommContext(timeout=2.0)]
    addr = f"{server.addr}/torchft/1/latch/0"
    try:
        with ThreadPoolExecutor(max_workers=2) as pool:
            list(pool.map(lambda r: ctxs[r].configure(addr, r, 2), range(2)))
        ctxs[1].shutdown()  # the peer dies
        work = ctxs[0].allreduce([np.ones(100, np.float32)])
        with pytest.raises(Exception):
            work.future().result(timeout=10)
        assert ctxs[0].errored() is not None
        with pytest.raises(ConnectionError, match="previously errored"):
            ctxs[0].allreduce([np.ones(1, np.float32)]).future().result(1)
        ctxs[0].configure("unused:0", 0, 1)  # a fresh (solo) membership
        assert ctxs[0].errored() is None
        assert ctxs[0].allreduce([np.ones(1)]).future().result(5)[0][0] == 1
    finally:
        for c in ctxs:
            c.shutdown()
        server.shutdown()


def test_unconfigured_and_invalid() -> None:
    ctx = TcpCommContext()
    with pytest.raises(RuntimeError, match="not configured"):
        ctx.allreduce([np.ones(2)]).future().result(1)
    with pytest.raises(ValueError):
        TcpCommContext(algorithm="psum")
    with pytest.raises(ValueError):
        TcpCommContext(channels=0)


def test_wrappers() -> None:
    dummy = DummyCommContext()
    a = [np.ones(3)]
    assert dummy.allreduce(a).future().result()[0] is a[0]
    swallow = ErrorSwallowingCommContext(TcpCommContext())
    # the inner context is unconfigured: the error is swallowed and latched
    out = swallow.allreduce([np.ones(2)]).future().result(timeout=5)
    assert np.array_equal(out[0], np.ones(2))
    assert swallow.errored() is not None
    swallow.configure("unused:0", 0, 1)
    assert swallow.errored() is None
