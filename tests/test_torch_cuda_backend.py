"""The port's on-device gradient plane (comm/cuda_backend.py) on the CPU.

Twins of tests/test_xla_backend.py and tests/test_quantized_psum.py at world
2 and 3, with the plane's pool on ``device="cpu"`` (its kernels' plain
versions run there; tests/test_torch_cuda.py holds the kernels to them on
the card). Oracles, all bitwise unless stated:

- star and ring at every codec against the reference's host simulation
  ``_host_allreduce`` (the socket transport's math), and at codec none
  against the port's own TcpCommContext;
- the quantized psum and psum_scatter against a numpy composition of the
  reference's codecs in ``reduce_int8`` / ``reduce_astype`` order, and
  within the reference's envelope ``(world + 1) * absmax / 100`` of the
  exact sum;
- the port's DDP with error feedback over ``CudaCommContext(star, int8)``
  against the reference's DDP over its ``TcpCommContext(star, int8)``:
  averaged gradients and residuals;
- plan counters across kill -> reform, lifecycle failures, capability
  surface, counters and the Manager's selector;
- ``topology="hier"``: the star composition against both packages'
  ``_host_hier_allreduce`` and the TCP hier path (bitwise), the psum
  composition within ``3 * absmax / 100`` of the f64 sum and identical on
  every rank, divergent assignments, roles, tier counters, plan cache.
"""

from __future__ import annotations

import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from torchft_tpu.comm.transport import (
    _CODECS as REF_CODECS,
    codec_roundtrip as ref_codec_roundtrip,
)
from torchft_tpu.comm.xla_backend import _host_allreduce as ref_host_allreduce
from torchft_tpu.comm.xla_backend import (
    _host_hier_allreduce as ref_host_hier_allreduce,
)
from torchft_tpu_torch.comm.context import (
    DummyCommContext,
    ErrorSwallowingCommContext,
    ReduceOp,
)
from torchft_tpu_torch.comm.cuda_backend import (
    CudaCommContext,
    DevicePool,
    _host_hier_allreduce,
    default_device_pool,
    device_codec_roundtrip,
)
from torchft_tpu_torch.comm.store import StoreServer
from torchft_tpu_torch.comm.topology import DomainTopology
from torchft_tpu_torch.comm.transport import (
    _CODECS,
    TcpCommContext,
    codec_roundtrip,
    codec_wire_nbytes,
)
from torchft_tpu_torch.utils.metrics import Metrics

CHUNK = 1 << 12  # small grid: several chunks and per-chunk int8 scales
CODECS = ("none", "bf16", "fp16", "int8")


@pytest.fixture(scope="module")
def pool():
    # one pool for the module: plans cache across tests like one process
    # surviving many quorum epochs
    return DevicePool("cpu")


def _inputs(world: int, seed: int, floats_only: bool = False):
    rng = np.random.default_rng(seed)
    out = []
    for r in range(world):
        per = [(rng.standard_normal(5000) * (r + 1)).astype(np.float32),
               rng.standard_normal(257).astype(np.float32)]
        if not floats_only:
            per.append(rng.integers(-50, 50, 1000).astype(np.int32))
        out.append(per)
    return out


def _run_cohort(ctxs, addr, world, body, timeout=60.0):
    """Configure each rank's context and run ``body(ctx, rank)`` on a
    thread per rank (the in-process stand-in for a collective launch)."""
    results = [None] * world

    def _worker(rank):
        ctxs[rank].configure(addr, rank, world)
        results[rank] = body(ctxs[rank], rank)

    with ThreadPoolExecutor(max_workers=world) as ex:
        for f in [ex.submit(_worker, r) for r in range(world)]:
            f.result(timeout=timeout)
    return results


def _allreduce_body(inputs, op):
    def body(ctx, rank):
        w = ctx.allreduce([a.copy() for a in inputs[rank]], op)
        return [np.array(x) for x in w.future().result(timeout=30)]
    return body


def _cuda_ctxs(pool, world, algo, codec, timeout=30.0):
    return [CudaCommContext(timeout=timeout, algorithm=algo,
                            compression=codec, chunk_bytes=CHUNK,
                            device_pool=pool) for _ in range(world)]


def _cuda_results(pool, tag, world, algo, codec, inputs, op):
    ctxs = _cuda_ctxs(pool, world, algo, codec)
    try:
        return _run_cohort(ctxs, f"cuda://{tag}", world,
                           _allreduce_body(inputs, op))
    finally:
        for c in ctxs:
            c.shutdown()


def _ref_host(inputs, algo, codec, op):
    return ref_host_allreduce([[a.copy() for a in per] for per in inputs],
                              algo, codec, CHUNK, op)


def _assert_bitwise(got, want, tag):
    for r, (g_r, w_r) in enumerate(zip(got, want)):
        for i, (g, w) in enumerate(zip(g_r, w_r)):
            assert g.dtype == w.dtype and g.shape == w.shape
            assert g.tobytes() == w.tobytes(), (
                f"{tag}: rank {r} array {i}: "
                f"{int((g != w).sum())}/{g.size} elements differ")


# ------------------------------------------------------------- parity


@pytest.mark.parametrize("world", [2, 3])
@pytest.mark.parametrize("algo", ["star", "ring"])
@pytest.mark.parametrize("codec", CODECS)
def test_allreduce_bitwise_matches_host(pool, world, algo, codec) -> None:
    # SUM over f32 + int32 (the ints ride uncompressed on both planes), AVG
    # and MAX over the floats
    for op, floats_only in ((ReduceOp.SUM, False), (ReduceOp.AVG, True),
                            (ReduceOp.MAX, True)):
        inputs = _inputs(world, seed=world * 7 + 1, floats_only=floats_only)
        tag = f"par_{world}_{algo}_{codec}_{op}"
        got = _cuda_results(pool, tag, world, algo, codec, inputs, op)
        _assert_bitwise(got, _ref_host(inputs, algo, codec, op), tag)


@pytest.mark.parametrize("world", [2, 3])
@pytest.mark.parametrize("algo", ["star", "ring"])
def test_codec_none_matches_port_tcp_wire(pool, world, algo) -> None:
    inputs = _inputs(world, seed=world + 40)
    server = StoreServer()
    tcp = [TcpCommContext(timeout=30.0, algorithm=algo, channels=2,
                          chunk_bytes=CHUNK) for _ in range(world)]
    try:
        want = _run_cohort(tcp, f"{server.addr}/tcp_{world}_{algo}", world,
                           _allreduce_body(inputs, ReduceOp.SUM))
    finally:
        for c in tcp:
            c.shutdown()
        server.shutdown()
    got = _cuda_results(pool, f"tcp_{world}_{algo}", world, algo, "none",
                        inputs, ReduceOp.SUM)
    _assert_bitwise(got, want, f"tcp {world} {algo}")


def test_f64_host_fallback_and_half_dtype_parity(pool) -> None:
    # 64-bit leaves reduce on the in-group host simulation (the real codec
    # code); f16 stays on the device plane and divides like numpy's half
    world = 2
    rng = np.random.default_rng(11)
    inputs = [[(rng.standard_normal(999) * (r + 1)).astype(np.float32),
               (rng.standard_normal(333) * (r + 1)).astype(np.float64),
               rng.integers(-(2**40), 2**40, 100).astype(np.int64),
               (rng.standard_normal(700) * (r + 1)).astype(np.float16)]
              for r in range(world)]
    for algo in ("star", "ring"):
        got = _cuda_results(pool, f"f64_{algo}", world, algo, "int8",
                            inputs, ReduceOp.SUM)
        _assert_bitwise(got, _ref_host(inputs, algo, "int8", ReduceOp.SUM),
                        f"f64 {algo}")
        halves = [[per[0], per[1], per[3]] for per in inputs]
        got = _cuda_results(pool, f"half_{algo}", world, algo, "none",
                            halves, ReduceOp.AVG)
        _assert_bitwise(got, _ref_host(halves, algo, "none", ReduceOp.AVG),
                        f"half {algo}")


# ------------------------------------------------- the quantized psum


def _np_quantized_psum(xs, codec_name, op):
    """The reference's quantized psum composed from its host codecs, in
    its order: each rank's contribution decoded (``reduce_int8`` /
    ``reduce_astype`` phase 1), zero-padded to n·L, summed in rank order
    from zeros, AVG divided, each owner's shard re-encoded on the
    shard-local grid and decoded (phase 2)."""
    n, size = len(xs), xs[0].size
    L = -(-size // n)
    codec = REF_CODECS[codec_name]()
    acc = np.zeros(n * L, np.float32)
    for x in xs:
        dec = np.zeros(n * L, np.float32)
        ref_codec_roundtrip(codec, CHUNK, x, dec[:size])
        acc = acc + dec
    if op == ReduceOp.AVG:
        acc = acc / np.float32(n)
    out = np.empty_like(acc)
    for d in range(n):
        ref_codec_roundtrip(codec, CHUNK, acc[d * L:(d + 1) * L],
                            out[d * L:(d + 1) * L])
    return out[:size]


@pytest.mark.parametrize("world", [2, 3])
@pytest.mark.parametrize("codec", ["bf16", "fp16", "int8"])
def test_quantized_psum_bitwise_and_envelope(pool, world, codec) -> None:
    rng = np.random.default_rng(world * 13)
    for op in (ReduceOp.SUM, ReduceOp.AVG):
        for size in (5000, 7):
            xs = [(rng.standard_normal(size) * (r + 1)).astype(np.float32)
                  for r in range(world)]
            xs[0][size // 2] = 40.0  # an outlier sets one chunk's scale
            ctxs = _cuda_ctxs(pool, world, "psum", codec)
            try:
                got = _run_cohort(
                    ctxs, f"cuda://q_{world}_{codec}_{op}_{size}", world,
                    _allreduce_body([[x] for x in xs], op))
                want = _np_quantized_psum(xs, codec, op)
                for r in range(world):
                    assert got[r][0].tobytes() == want.tobytes(), (op, size)
                exact = np.sum(xs, axis=0, dtype=np.float64)
                if op == ReduceOp.AVG:
                    exact /= world
                absmax = max(float(np.abs(x).max()) for x in xs)
                envelope = (world + 1) * absmax / 100
                assert float(np.abs(got[0][0] - exact).max()) < envelope
                for ctx in ctxs:
                    snap = ctx.metrics.snapshot()
                    ratio = snap["comm_encoded_bytes"] / snap["comm_raw_bytes"]
                    if codec == "int8" and size == 5000:
                        assert ratio <= 0.3
                    assert snap["comm_encoded_bytes"] == \
                        ctx.wire_nbytes(xs[0])
            finally:
                for c in ctxs:
                    c.shutdown()


@pytest.mark.parametrize("codec", ["bf16", "int8"])
def test_quantized_psum_scatter_bitwise(pool, codec) -> None:
    # reduce_scatter on psum with one f32 array per rank, owned in rank
    # order: phase 1 alone, each slot on its own grid, owner-side decode
    world = 3
    rng = np.random.default_rng(5)
    sizes = (4000, 2500, 4097)
    L = max(sizes)
    inputs = [[(rng.standard_normal(s) * (r + 1)).astype(np.float32)
               for s in sizes] for r in range(world)]
    for op in (ReduceOp.SUM, ReduceOp.AVG):
        ctxs = _cuda_ctxs(pool, world, "psum", codec)

        def body(ctx, rank):
            w = ctx.reduce_scatter([a.copy() for a in inputs[rank]], op)
            return np.array(w.future().result(timeout=30)[rank])

        try:
            got = _run_cohort(ctxs, f"cuda://qs_{codec}_{op}", world, body)
        finally:
            for c in ctxs:
                c.shutdown()
        codec_ref = REF_CODECS[codec]()
        for d in range(world):
            acc = np.zeros(L, np.float32)
            for r in range(world):
                slot = np.zeros(L, np.float32)
                slot[:sizes[d]] = inputs[r][d]
                dec = np.empty_like(slot)
                ref_codec_roundtrip(codec_ref, CHUNK, slot, dec)
                acc = acc + dec
            if op == ReduceOp.AVG:
                acc = acc / np.float32(world)
            assert got[d].tobytes() == acc[:sizes[d]].tobytes(), (d, op)


def test_raw_psum_and_psum_scatter_are_numeric(pool) -> None:
    world = 3
    inputs = _inputs(world, seed=9, floats_only=True)
    got = _cuda_results(pool, "raw_psum", world, "psum", "none", inputs,
                        ReduceOp.SUM)
    for i in range(2):
        exact = np.sum([inputs[r][i] for r in range(world)], axis=0)
        for r in range(world):
            np.testing.assert_allclose(got[r][i], exact, rtol=1e-5,
                                       atol=1e-5)
    got = _cuda_results(pool, "raw_max", world, "psum", "none", inputs,
                        ReduceOp.MAX)
    assert np.array_equal(got[1][0], np.max([x[0] for x in inputs], axis=0))
    ctxs = _cuda_ctxs(pool, world, "psum", "none")

    def body(ctx, rank):
        arrays = [np.full(10 + j, float(rank + 1), np.float32)
                  for j in range(world)]
        return np.array(ctx.reduce_scatter(arrays, ReduceOp.AVG).future()
                        .result(timeout=30)[rank])

    try:
        got = _run_cohort(ctxs, "cuda://raw_scatter", world, body)
    finally:
        for c in ctxs:
            c.shutdown()
    for d in range(world):
        assert np.allclose(got[d], np.full(10 + d, 2.0, np.float32))


def test_device_codec_roundtrip_equals_host(pool) -> None:
    rng = np.random.default_rng(3)
    src = rng.standard_normal(6000).astype(np.float32)
    src[17] = 250.0
    bad = src.copy()
    bad[5] = np.inf
    for codec in CODECS:
        for x in (src, bad):
            host = np.empty_like(x)
            codec_roundtrip(_CODECS[codec](), CHUNK, x, host)
            ref = np.empty_like(x)
            ref_codec_roundtrip(REF_CODECS[codec](), CHUNK, x, ref)
            dev = device_codec_roundtrip(codec, CHUNK, x, pool)
            assert host.tobytes() == dev.tobytes() == ref.tobytes(), codec
    dev = device_codec_roundtrip("int8", CHUNK, bad, pool)
    assert np.isnan(dev[:CHUNK // 4]).all()
    assert np.isfinite(dev[CHUNK // 4:]).all()


def test_lossy_psum_refuses_max_min(pool) -> None:
    world = 2
    for op in (ReduceOp.MAX, ReduceOp.MIN):
        reason = CudaCommContext.unsupported_reason("psum", "int8", op)
        assert "only ACCUMULATES" in reason and "star/ring" in reason
    ctxs = _cuda_ctxs(pool, world, "psum", "int8")

    def body(ctx, rank):
        w = ctx.allreduce([np.ones(256, np.float32)], ReduceOp.MAX)
        with pytest.raises(ValueError, match="only ACCUMULATES"):
            w.future().result(timeout=30)
        return True

    try:
        assert all(_run_cohort(ctxs, "cuda://qmax", world, body))
    finally:
        for c in ctxs:
            c.shutdown()


def test_zero_size_and_mixed_dtype_payloads(pool) -> None:
    world = 2
    rng = np.random.default_rng(29)
    floats = [(rng.standard_normal(300) * (r + 1)).astype(np.float32)
              for r in range(world)]
    ints = [rng.integers(-50, 50, 100).astype(np.int32) for _ in range(world)]
    ctxs = _cuda_ctxs(pool, world, "psum", "int8")

    def body(ctx, rank):
        return ctx.allreduce([np.zeros(0, np.float32), floats[rank].copy(),
                              ints[rank].copy()]).future().result(timeout=30)

    try:
        got = _run_cohort(ctxs, "cuda://qzero", world, body)
    finally:
        for c in ctxs:
            c.shutdown()
    assert got[0][0].size == 0
    assert np.array_equal(got[0][2], ints[0] + ints[1])
    exact = floats[0].astype(np.float64) + floats[1]
    absmax = max(float(np.abs(a).max()) for a in floats)
    assert float(np.abs(got[0][1] - exact).max()) < 3 * absmax / 100
    assert got[0][1].tobytes() == got[1][1].tobytes()


# ------------------------------------------------- plans and lifecycle


def test_plan_counts_across_kill_and_reform() -> None:
    # first sight of a (world, codec, layout) builds one plan; a kill ->
    # shrink -> reform at seen world sizes only hits the cache
    pool = DevicePool("cpu")
    inputs3 = _inputs(3, seed=42, floats_only=True)
    inputs2 = _inputs(2, seed=43, floats_only=True)
    body3 = _allreduce_body(inputs3, ReduceOp.SUM)
    body2 = _allreduce_body(inputs2, ReduceOp.SUM)
    ctxs = _cuda_ctxs(pool, 3, "psum", "int8")
    _run_cohort(ctxs, "cuda://churn/e1", 3, body3)
    assert pool.compile_count == 1 and pool.trace_count == 1
    hits0 = pool.hit_count
    _run_cohort(ctxs, "cuda://churn/e1b", 3, body3)
    assert pool.compile_count == 1 and pool.hit_count > hits0
    ctxs[2].shutdown()  # replica 2 dies; the survivors reform at world 2
    _run_cohort(ctxs[:2], "cuda://churn/e2", 2, body2)
    assert pool.compile_count == 2 and pool.trace_count == 2
    for c in ctxs:
        c.shutdown()
    ctxs = _cuda_ctxs(pool, 3, "psum", "int8")  # it comes back: seen world
    hits1 = pool.hit_count
    _run_cohort(ctxs, "cuda://churn/e3", 3, body3)
    assert pool.compile_count == 2 and pool.hit_count > hits1
    for c in ctxs:
        c.shutdown()
    ctxs = _cuda_ctxs(pool, 3, "psum", "bf16")  # another codec: a new plan
    _run_cohort(ctxs, "cuda://churn/e4", 3, body3)
    assert pool.compile_count == 3 and pool.trace_count == 3
    for c in ctxs:
        c.shutdown()


def test_concurrent_first_sight_builds_once() -> None:
    pool = DevicePool("cpu")
    started, release = threading.Event(), threading.Event()
    builds = [0]

    def build():
        builds[0] += 1
        started.set()
        release.wait(timeout=10)
        return "plan"

    with ThreadPoolExecutor(max_workers=2) as ex:
        f1 = ex.submit(pool.plan, ("k",), build)
        started.wait(timeout=10)
        f2 = ex.submit(pool.plan, ("k",), build)
        release.set()
        assert f1.result(timeout=10) == f2.result(timeout=10) == "plan"
    assert builds[0] == 1 and pool.compile_count == 1
    assert default_device_pool("cpu") is default_device_pool("cpu")
    assert default_device_pool() is default_device_pool("cuda")


def test_cohorts_sharing_a_plan_do_not_mix() -> None:
    # cohorts of one process (one store address each) share the pool and,
    # at one layout, one plan, but each runs its ops on its own executor:
    # the plan's buffers must hold one op at a time. A lost upload shows as
    # another cohort's sum; the short switch interval widens the window.
    pool = DevicePool("cpu")
    world, n_cohorts, n_ops = 2, 4, 30
    rng = np.random.default_rng(7)
    ins = rng.standard_normal((n_cohorts, world, 3000)).astype(np.float32)

    def cohort(c):
        ctxs = _cuda_ctxs(pool, world, "star", "none")

        def body(ctx, rank):
            return [ctx.allreduce([ins[c, rank].copy()]).future()
                    .result(timeout=30)[0] for _ in range(n_ops)]

        try:
            return _run_cohort(ctxs, f"cuda://shared/{c}", world, body)
        finally:
            for x in ctxs:
                x.shutdown()

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(max_workers=n_cohorts) as ex:
            results = [f.result(timeout=120) for f in
                       [ex.submit(cohort, c) for c in range(n_cohorts)]]
    finally:
        sys.setswitchinterval(interval)
    for c, per_rank in enumerate(results):
        want = ins[c, 0] + ins[c, 1]
        for outs in per_rank:
            for got in outs:
                np.testing.assert_array_equal(got, want)   # bitwise
    assert pool.compile_count == 1


def test_dead_member_latches_and_shutdown_fails_peers_fast(pool) -> None:
    world = 2
    ctxs = _cuda_ctxs(pool, world, "star", "none", timeout=0.5)
    _run_cohort(ctxs, "cuda://dead", world, lambda ctx, rank: None)
    w = ctxs[0].allreduce([np.ones(8, np.float32)])
    with pytest.raises(ConnectionError, match="timed out waiting"):
        w.future().result(timeout=10)
    assert isinstance(ctxs[0].errored(), ConnectionError)
    with pytest.raises(ConnectionError, match="previously errored"):
        ctxs[0].allreduce([np.ones(8, np.float32)]).future().result(5)
    for c in ctxs:
        c.shutdown()
    # a member shutting down fails its peer's in-flight op at once, far
    # inside the op timeout
    ctxs = _cuda_ctxs(pool, world, "psum", "int8", timeout=60.0)
    _run_cohort(ctxs, "cuda://teardown", world, lambda ctx, rank: None)
    w = ctxs[0].allreduce([np.ones(8, np.float32)])
    t0 = time.monotonic()
    ctxs[1].shutdown()
    with pytest.raises(ConnectionError, match="torn down"):
        w.future().result(timeout=10)
    assert time.monotonic() - t0 < 5.0
    ctxs[0].shutdown()


def test_failed_rendezvous_can_be_retried(pool) -> None:
    lone = CudaCommContext(timeout=0.3, algorithm="star", device_pool=pool)
    with pytest.raises(TimeoutError, match="before timeout"):
        lone.configure("cuda://retry", 0, 2)
    ctxs = _cuda_ctxs(pool, 2, "star", "none")
    got = _run_cohort(ctxs, "cuda://retry", 2, _allreduce_body(
        [[np.full(64, r + 1, np.float32)] for r in range(2)], ReduceOp.SUM))
    assert np.array_equal(got[0][0], np.full(64, 3.0, np.float32))
    for c in ctxs:
        c.shutdown()
    # settings must match across ranks
    a = CudaCommContext(timeout=1.0, compression="int8", device_pool=pool)
    b = CudaCommContext(timeout=1.0, compression="bf16", device_pool=pool)
    errs = []

    def _join(ctx, rank):
        try:
            ctx.configure("cuda://mismatch", rank, 2)
        except Exception as e:  # noqa: BLE001 — asserted below
            errs.append(e)

    ts = [threading.Thread(target=_join, args=(c, r))
          for r, c in enumerate((a, b))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in ts)
    assert any("must match across ranks" in str(e) for e in errs), errs
    a.shutdown()
    b.shutdown()


def test_solo_identity_private_allgather_and_donation(pool) -> None:
    solo = CudaCommContext(device_pool=DevicePool("cpu"))
    solo.configure("cuda://solo/0", 0, 1)
    a = np.arange(16, dtype=np.float32)
    out = solo.allreduce([a]).future().result(timeout=5)
    assert out[0] is a and np.array_equal(a, np.arange(16, dtype=np.float32))
    assert solo._pool.compile_count == 0  # no plan for a solo wire
    solo.shutdown()
    world = 3
    ctxs = _cuda_ctxs(pool, world, "star", "none")
    donated = [np.full(32, float(r + 1), np.float32) for r in range(world)]

    def body(ctx, rank):
        mine = np.full(4, float(rank), np.float32)
        ag = ctx.allgather([mine]).future().result(timeout=15)
        bc = ctx.broadcast([mine.copy()], root=1).future().result(timeout=15)
        out = ctx.allreduce([donated[rank]]).future().result(timeout=15)
        return ag, bc, out[0] is donated[rank]

    try:
        got = _run_cohort(ctxs, "cuda://misc", world, body)
    finally:
        for c in ctxs:
            c.shutdown()
    got[0][0][0][0][:] = 777.0  # rank 0 mutates its received copy
    for rank, (ag, bc, aliased) in enumerate(got):
        assert aliased
        assert np.array_equal(bc[0], np.full(4, 1.0, np.float32))
        if rank:
            for src in range(world):
                assert np.array_equal(ag[src][0],
                                      np.full(4, float(src), np.float32))
    for d in donated:
        assert np.array_equal(d, np.full(32, 6.0, np.float32))


# ------------------------------------------------- surface and selector


def test_capability_surface_and_labels(pool) -> None:
    for codec in CODECS:
        assert CudaCommContext.supports("psum", codec)
        assert CudaCommContext.supports("psum", codec, ReduceOp.AVG)
        assert CudaCommContext.supports("star", codec, ReduceOp.MAX)
        assert CudaCommContext.supports("ring", codec, ReduceOp.MIN)
    assert CudaCommContext.supports("psum", "none", ReduceOp.MAX)
    assert "unknown algorithm" in CudaCommContext.unsupported_reason(
        "tree", "none")
    # the hierarchical tier: star/auto/psum compose it, the ring inter
    # tier is a host-plane arm
    CudaCommContext(topology="hier", device_pool=pool)
    assert CudaCommContext.supports("psum", "int8", topology="hier")
    assert "host" in CudaCommContext.unsupported_reason(
        "ring", "none", topology="hier")
    assert "unknown topology" in CudaCommContext.unsupported_reason(
        "star", "none", topology="tree")
    with pytest.raises(ValueError, match="unknown compression"):
        CudaCommContext(compression="zstd", device_pool=pool)
    # the TCP wire: no psum; every codec on both tiers
    assert not TcpCommContext.supports("psum", "none")
    assert "cuda" in TcpCommContext.unsupported_reason("psum", "none")
    for codec in CODECS:
        assert TcpCommContext.supports("star", codec)
        assert TcpCommContext.supports("ring", codec, topology="hier")
        TcpCommContext(compression=codec, topology="hier").shutdown()
    wrapped = ErrorSwallowingCommContext(
        CudaCommContext(algorithm="psum", compression="int8",
                        device_pool=pool))
    assert wrapped.supports("psum", "int8")
    assert not wrapped.supports("psum", "int8", ReduceOp.MAX)
    assert wrapped.wire_codec_name() == "int8" and wrapped.wire_is_lossy()
    assert DummyCommContext().supports("psum", "int8", ReduceOp.MAX)
    # role-aware compensability: star peers and every psum rank
    src = np.random.default_rng(1).standard_normal(6000).astype(np.float32)
    star = CudaCommContext(algorithm="star", compression="int8",
                           chunk_bytes=CHUNK, device_pool=pool)
    psum = CudaCommContext(algorithm="psum", compression="int8",
                           chunk_bytes=CHUNK, device_pool=pool)
    for rank in (0, 1):
        for ctx in (star, psum):
            ctx._rank, ctx._world_size = rank, 2
        assert star.wire_compensable() == (rank == 1)
        assert psum.wire_compensable()
        out, ref = np.empty_like(src), np.empty_like(src)
        psum.wire_roundtrip(src, out)
        codec_roundtrip(_CODECS["int8"](), CHUNK, src, ref)
        assert out.tobytes() == ref.tobytes()
    assert psum.wire_nbytes(src) == codec_wire_nbytes(_CODECS["int8"](),
                                                      CHUNK, src)
    assert psum.wire_nbytes(src) < 0.3 * src.nbytes
    metrics = Metrics()
    psum.set_metrics(metrics)
    assert metrics.snapshot()["comm_backend"] == "cuda"
    assert CudaCommContext.backend_name == "cuda"


def test_manager_selector() -> None:
    from torchft_tpu_torch.control import Lighthouse
    from torchft_tpu_torch.manager import Manager, _build_comm_context

    assert isinstance(_build_comm_context("host", None, 5.0), TcpCommContext)
    pool = DevicePool("cpu")
    cc = _build_comm_context("cuda", {"compression": "bf16",
                                      "chunk_bytes": 123,
                                      "device_pool": pool}, 5.0)
    assert isinstance(cc, CudaCommContext) and cc._timeout == 5.0
    assert cc.wire_codec_name() == "bf16" and cc._chunk_bytes == 123
    with pytest.raises(ValueError, match="unknown comm_backend"):
        _build_comm_context("nccl", None, 5.0)
    with pytest.raises(ValueError, match="backend 'host'"):
        Manager(comm=TcpCommContext(timeout=1.0), comm_backend="cuda",
                min_replica_size=1)
    with pytest.raises(ValueError, match="comm_options applies only"):
        Manager(comm=TcpCommContext(timeout=1.0),
                comm_options={"channels": 2}, min_replica_size=1)
    lh = Lighthouse(min_replicas=1, join_timeout_ms=100)
    store = StoreServer()
    try:
        m = Manager(comm_backend="cuda",
                    comm_options={"algorithm": "psum",
                                  "compression": "int8",
                                  "device_pool": pool},
                    min_replica_size=1, rank=0, world_size=1,
                    store_addr=store.addr, lighthouse_addr=lh.address(),
                    replica_id="sel_", timeout=10.0, connect_timeout=10.0)
        try:
            assert m.comm_backend() == "cuda"
            assert m.comm_supports("psum", "int8")
            assert "only ACCUMULATES" in m.comm_unsupported_reason(
                "psum", "int8", ReduceOp.MAX)
            assert m.wire_codec_name() == "int8" and m.wire_is_lossy()
            assert m.metrics.snapshot()["comm_backend"] == "cuda"
        finally:
            m.shutdown()
    finally:
        store.shutdown()
        lh.shutdown()


# ------------------------------------------------------------ DDP + EF


class _StubManager:
    """The Manager surface the port's DDP reads, over a bare context (the
    twin of the reference's WireStubManager): no quorum, AVG scaling by the
    wire world."""

    def __init__(self, ctx, world: int) -> None:
        self._ctx = ctx
        self._world = world
        self.metrics = Metrics()

    def wait_quorum(self) -> None:
        pass

    def report_error(self, e) -> None:
        raise e

    def is_solo_wire(self) -> bool:
        return self._world == 1

    def is_participating(self) -> bool:
        return True

    def wire_compensable(self) -> bool:
        return self._ctx.wire_compensable()

    def wire_generation(self) -> int:
        return self._ctx.wire_generation()

    def wire_roundtrip(self, src, out) -> None:
        self._ctx.wire_roundtrip(src, out)

    def allreduce_arrays(self, arrays, op=ReduceOp.SUM):
        from torchft_tpu_torch.comm.context import Work
        from torchft_tpu_torch.futures import future_chain

        scale = np.float32(1.0 / self._world)

        def _avg(f):
            reduced = f.result()
            for a in reduced:
                np.multiply(a, a.dtype.type(scale), out=a)
            return reduced

        work = self._ctx.allreduce(list(arrays), ReduceOp.SUM)
        return Work(future_chain(work.future(), _avg))


def test_ddp_error_feedback_matches_reference_bitwise(pool) -> None:
    # the port's DDP over CudaCommContext(star, int8) against the
    # reference's DDP over its own TcpCommContext(star, int8): 3 steps of
    # the same seeded gradients; the averages and the residuals must agree
    # bit for bit (rank 1 is the compensable star peer)
    from torchft_tpu.comm.store import StoreServer as RefStore
    from torchft_tpu.comm.transport import TcpCommContext as RefTcp
    from torchft_tpu.comm.wire_stub import WireStubManager
    from torchft_tpu.ddp import DistributedDataParallel as RefDDP
    from torchft_tpu_torch.ddp import DistributedDataParallel

    world, steps = 2, 3
    rng = np.random.default_rng(5)
    grads = [{"b": (rng.standard_normal(77) * (r + 1)).astype(np.float32),
              "w": (rng.standard_normal((64, 33)) * (r + 1))
              .astype(np.float32)} for r in range(world)]

    server = RefStore()
    ref_ctxs = [RefTcp(timeout=30.0, algorithm="star", channels=2,
                       compression="int8", chunk_bytes=CHUNK)
                for _ in range(world)]

    def ref_body(ctx, rank):
        ddp = RefDDP(WireStubManager(ctx, world), bucket_bytes=8192)
        out = []
        for _ in range(steps):
            avg = ddp.average_gradients(grads[rank])
            out.append({k: np.asarray(v).copy() for k, v in avg.items()})
        res = ddp._arenas[0].residuals
        return out, None if res is None else [
            None if r is None else r.copy() for r in res]

    try:
        want = _run_cohort(ref_ctxs, f"{server.addr}/ddp_ref", world,
                           ref_body)
    finally:
        for c in ref_ctxs:
            c.shutdown()
        server.shutdown()

    def port_body(ctx, rank):
        # the reference flattens the dict in key order: b, then w
        params = [torch.nn.Parameter(torch.zeros(g.shape))
                  for g in (grads[rank]["b"], grads[rank]["w"])]
        ddp = DistributedDataParallel(_StubManager(ctx, world),
                                      bucket_bytes=8192)
        out = []
        for _ in range(steps):
            for p, k in zip(params, ("b", "w")):
                p.grad = torch.from_numpy(grads[rank][k].copy())
            ddp.average_gradients(params)
            out.append({k: p.grad.numpy().copy()
                        for p, k in zip(params, ("b", "w"))})
        res = ddp._residuals
        return out, None if res is None else [
            None if r is None else r.copy() for r in res]

    ctxs = _cuda_ctxs(pool, world, "star", "int8")
    try:
        got = _run_cohort(ctxs, "cuda://ddp", world, port_body)
    finally:
        for c in ctxs:
            c.shutdown()
    for r in range(world):
        for t in range(steps):
            for k in ("b", "w"):
                assert got[r][0][t][k].tobytes() == \
                    want[r][0][t][k].tobytes(), (r, t, k)
    # the star root's contribution is raw: no arena on either side
    assert got[0][1] is None and want[0][1] is None
    assert len(got[1][1]) == len(want[1][1]) == 2
    for g, w in zip(got[1][1], want[1][1]):
        assert g.tobytes() == w.tobytes()
    assert np.abs(got[1][1][1]).max() > 0  # the peer banked real error


# ------------------------------------------------- the hierarchical tier
# CudaCommContext(topology="hier") on DevicePool("cpu"): the star
# composition bitwise with the port's and the reference's
# _host_hier_allreduce and with the TCP hier path; the psum composition
# within 3 * absmax / 100 of the f64 sum and identical on every rank;
# divergent assignments fail fast; the error-feedback roles; the plan cache
# across a kill and re-form; the tier counters.

MAP_2X2 = {"d0": ["rank0", "rank1"], "d1": ["rank2", "rank3"]}
MAP_UNEVEN = {"d0": ["rank0", "rank2"], "d1": ["rank1"], "d2": ["rank3"]}
HIER_LAYOUTS = {"2x2": (MAP_2X2, ((0, 1), (2, 3))),
                "uneven": (MAP_UNEVEN, ((0, 2), (1,), (3,)))}


def _hier_inputs(seed, size=5000):
    rng = np.random.default_rng(seed)
    return [[(rng.standard_normal(size) * (r + 1)).astype(np.float32),
             rng.standard_normal(300).astype(np.float32),
             rng.standard_normal(64),                        # f64: host
             rng.integers(-50, 50, 100).astype(np.int32)]
            for r in range(4)]


def _hier_cuda(pool, tag, codec, inputs, op, algorithm="star",
               smap=MAP_2X2, timeout=30.0):
    resolver = DomainTopology(static_map=smap)
    ctxs = [CudaCommContext(timeout=timeout, algorithm=algorithm,
                            compression=codec, chunk_bytes=CHUNK,
                            device_pool=pool, topology="hier",
                            domain_resolver=resolver) for _ in range(4)]

    def body(ctx, rank):
        w = ctx.allreduce([a.copy() for a in inputs[rank]], op)
        return ([np.array(x) for x in w.future().result(timeout=30)],
                ctx.metrics.snapshot(), ctx.wire_compensable())

    try:
        return _run_cohort(ctxs, f"cuda://{tag}", 4, body)
    finally:
        for c in ctxs:
            c.shutdown()


@pytest.mark.parametrize("layout", sorted(HIER_LAYOUTS))
@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("op", [ReduceOp.SUM, ReduceOp.AVG, ReduceOp.MAX])
def test_hier_star_bitwise_with_host_composition(pool, layout, codec,
                                                 op) -> None:
    smap, groups = HIER_LAYOUTS[layout]
    inputs = _hier_inputs(31)
    if op == ReduceOp.AVG:
        inputs = [per[:3] for per in inputs]  # AVG takes floats only
    got = _hier_cuda(pool, f"hs_{layout}_{codec}_{op}", codec, inputs, op,
                     smap=smap)
    want = _host_hier_allreduce([[a.copy() for a in per] for per in inputs],
                                codec, CHUNK, op, groups, 4)
    ref = ref_host_hier_allreduce(
        [[a.copy() for a in per] for per in inputs], codec, CHUNK, op,
        groups, 4)
    for w, r in zip(want, ref):
        assert w.tobytes() == r.tobytes()
    for outs, _, _ in got:
        for o, w in zip(outs, want):
            assert o.dtype == w.dtype and o.tobytes() == w.tobytes()


def test_hier_star_bitwise_with_tcp_hier_path(pool) -> None:
    inputs = _hier_inputs(33)
    store = StoreServer()
    resolver = DomainTopology(static_map=MAP_2X2)
    tcp = [TcpCommContext(timeout=30.0, algorithm="star", channels=2,
                          compression="int8", chunk_bytes=CHUNK,
                          topology="hier", domain_resolver=resolver)
           for _ in range(4)]
    try:
        over_tcp = _run_cohort(tcp, f"{store.addr}/hier_tcp", 4,
                               _allreduce_body(inputs, ReduceOp.SUM))
    finally:
        for c in tcp:
            c.shutdown()
        store.shutdown()
    got = _hier_cuda(pool, "hs_tcp", "int8", inputs, ReduceOp.SUM)
    for (outs, _, _), want in zip(got, over_tcp):
        for o, w in zip(outs, want):
            assert o.tobytes() == w.tobytes()


@pytest.mark.parametrize("codec", ["none", "bf16", "int8"])
def test_hier_psum_numeric_and_cross_rank_identical(pool, codec) -> None:
    inputs = [[per[0]] for per in _hier_inputs(35)]
    exact = np.sum([per[0] for per in inputs], axis=0, dtype=np.float64)
    absmax = float(max(np.abs(per[0]).max() for per in inputs))
    got = _hier_cuda(pool, f"hp_{codec}", codec, inputs, ReduceOp.SUM,
                     algorithm="psum")
    assert len({outs[0].tobytes() for outs, _, _ in got}) == 1
    err = float(np.abs(got[0][0][0].astype(np.float64) - exact).max())
    # one quantization per domain sum: the reference test's envelope
    assert err <= 3 * absmax / 100.0
    if codec == "none":
        assert err <= 1e-4 * absmax
    # AVG divides in the same pass; extrema stay exact
    avg = _hier_cuda(pool, f"hpa_{codec}", codec, inputs, ReduceOp.AVG,
                     algorithm="psum")
    assert len({outs[0].tobytes() for outs, _, _ in avg}) == 1
    assert float(np.abs(avg[0][0][0] - exact / 4).max()) <= \
        3 * absmax / 400.0
    if codec == "none":
        mx = _hier_cuda(pool, "hpm", codec, inputs, ReduceOp.MAX,
                        algorithm="psum")
        want = np.max([per[0] for per in inputs], axis=0)
        assert mx[0][0][0].tobytes() == want.tobytes()


def test_hier_counters_and_roles(pool) -> None:
    inputs = [[per[0]] for per in _hier_inputs(37)]
    raw = float(inputs[0][0].nbytes)
    enc = float(codec_wire_nbytes(_CODECS["int8"](), CHUNK, inputs[0][0]))
    star = _hier_cuda(pool, "hc_star", "int8", inputs, ReduceOp.SUM)
    psum = _hier_cuda(pool, "hc_psum", "int8", inputs, ReduceOp.SUM,
                      algorithm="psum")
    # star fan-in: the d1 egress is compensable, the d0 egress is the root
    assert [c for _, _, c in star] == [False, False, True, False]
    assert [c for _, _, c in psum] == [True, False, True, False]
    for rank, (_, snap, _) in enumerate(star):
        assert snap["comm_intra_bytes"] == raw
        assert snap["comm_inter_bytes"] == (enc if rank in (0, 2) else 0.0)
        assert snap["comm_hops"] == 4.0
    uneven = _hier_cuda(pool, "hc_uneven", "int8", inputs, ReduceOp.SUM,
                        smap=MAP_UNEVEN)
    for rank, (_, snap, _) in enumerate(uneven):
        single = rank in (1, 3)
        assert snap["comm_intra_bytes"] == (0.0 if single else raw)
        assert snap["comm_hops"] == (2.0 if single else 4.0)
        assert snap["comm_inter_bytes"] == (enc if rank != 2 else 0.0)


def test_hier_divergent_assignments_fail_fast(pool) -> None:
    ctxs = [CudaCommContext(
        timeout=5.0, algorithm="star", chunk_bytes=CHUNK, device_pool=pool,
        topology="hier", domain_resolver=DomainTopology(
            static_map=MAP_2X2 if r == 0
            else {"dX": [f"rank{i}" for i in range(4)]}))
        for r in range(4)]

    def body(ctx, rank):
        w = ctx.allreduce([np.ones(16, np.float32)])
        with pytest.raises(ConnectionError, match="divergent"):
            w.future().result(timeout=20)
        return ctx.errored() is not None

    try:
        assert all(_run_cohort(ctxs, "cuda://hier_div", 4, body))
    finally:
        for c in ctxs:
            c.shutdown()


def test_hier_plan_cache_pins_across_kill_reform() -> None:
    own = DevicePool("cpu")
    inputs = [[per[0][:512]] for per in _hier_inputs(39)]
    _hier_cuda(own, "pin_a", "int8", inputs, ReduceOp.SUM)
    assert own.compile_count == 1
    hits = own.hit_count
    _hier_cuda(own, "pin_b", "int8", inputs, ReduceOp.SUM)  # re-form
    assert own.compile_count == 1 and own.hit_count > hits
    # the kill: three ranks re-form over a new domain structure ...
    resolver = DomainTopology(static_map=MAP_2X2)
    ctxs = [CudaCommContext(timeout=30.0, algorithm="star",
                            compression="int8", chunk_bytes=CHUNK,
                            device_pool=own, topology="hier",
                            domain_resolver=resolver) for _ in range(3)]
    for c in ctxs:
        c.set_wire_members(["rank0", "rank1", "rank3"])
    try:
        outs = _run_cohort(ctxs, "cuda://pin_c", 3,
                           _allreduce_body(inputs[:2] + inputs[3:],
                                           ReduceOp.SUM))
    finally:
        for c in ctxs:
            c.shutdown()
    assert own.compile_count == 2
    want = _host_hier_allreduce([inputs[0], inputs[1], inputs[3]], "int8",
                                CHUNK, ReduceOp.SUM, ((0, 1), (2,)), 3)
    assert outs[0][0].tobytes() == want[0].tobytes()
    # ... and the restart returns to a membership seen before: a hit
    _hier_cuda(own, "pin_d", "int8", inputs, ReduceOp.SUM)
    assert own.compile_count == 2


def test_hier_per_op_override_and_flat_default(pool) -> None:
    inputs = [[per[0]] for per in _hier_inputs(41)]
    resolver = DomainTopology(static_map=MAP_2X2)
    ctxs = [CudaCommContext(timeout=30.0, algorithm="star",
                            chunk_bytes=CHUNK, device_pool=pool,
                            domain_resolver=resolver) for _ in range(4)]

    def body(ctx, rank):
        hier = inputs[rank][0].copy()
        ctx.allreduce([hier], topology="hier").future().result(timeout=30)
        flat = inputs[rank][0].copy()
        ctx.allreduce([flat]).future().result(timeout=30)
        return hier.tobytes(), flat.tobytes(), ctx.wire_compensable()

    try:
        outs = _run_cohort(ctxs, "cuda://hier_override", 4, body)
    finally:
        for c in ctxs:
            c.shutdown()
    want = _host_hier_allreduce(inputs, "none", CHUNK, ReduceOp.SUM,
                                ((0, 1), (2, 3)), 4)[0]
    flat = _host_hier_allreduce(inputs, "none", CHUNK, ReduceOp.SUM,
                                ((0, 1, 2, 3),), 4)[0]
    for hier_b, flat_b, comp in outs:
        assert hier_b == want.tobytes()
        # the flat default at world 4 is the ring
        assert np.allclose(np.frombuffer(flat_b, np.float32), flat,
                           rtol=1e-5, atol=1e-5)
        assert not comp
    lossy = CudaCommContext(algorithm="star", compression="int8",
                            device_pool=pool)
    w = lossy.allreduce([np.ones(8, np.float32)], topology="hier")
    with pytest.raises(ValueError, match="error-feedback"):
        w.future().result(timeout=5)
