"""The port's TcpCommContext against the JAX package's, rank for rank.

A mixed cohort — ranks of both packages in one op — must give results
bitwise equal to an all-JAX cohort's on the same inputs: the frames are
byte-compatible and the reduction order is the same (star: the root adds
peers in rank order per chunk; ring: reduce-scatter then all-gather per
chunk). Payloads span several chunks, so the lane striping runs. Covered:
every codec (none, bf16, fp16, int8) on star and ring for SUM, AVG, MAX
and MIN, reduce_scatter with owners, allgather and broadcast; the array
frames and codec bytes against the reference's; striping invisibility and
the error-feedback roles (twins of test_transport_framing.py and
test_transport_striping.py); and the hierarchical tier: mixed cohorts on
even, uneven and singleton domains bitwise against the reference's and
against both packages' ``_host_hier_allreduce``, the tier counters, the
published assignment, the per-op override, an egress death, the int8
error-feedback descent over the hier wire, the host wire's capability
table, its constructor's refusals and the wrappers that forward the
topology (twins of test_hier_topology.py). Every comparison is bitwise unless a test states its bound.
"""

import socket
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor

import numpy as np
import pytest
import torch

from torchft_tpu.comm import store as jstore
from torchft_tpu.comm import transport as ref_transport
from torchft_tpu.comm.topology import DomainTopology as RefTopology
from torchft_tpu.comm.transport import TcpCommContext as JaxTcp
from torchft_tpu.comm.xla_backend import (
    _host_hier_allreduce as ref_host_hier_allreduce,
)
from torchft_tpu_torch.comm import transport as port_transport
from torchft_tpu_torch.comm.context import (
    DummyCommContext,
    ErrorSwallowingCommContext,
    ReduceOp,
    Work,
)
from torchft_tpu_torch.comm.cuda_backend import _host_hier_allreduce
from torchft_tpu_torch.comm.topology import DomainTopology
from torchft_tpu_torch.comm.transport import TcpCommContext
from torchft_tpu_torch.comm.wire import iov_join
from torchft_tpu_torch.ddp import DistributedDataParallel
from torchft_tpu_torch.futures import future_chain
from torchft_tpu_torch.utils.events import EventRecorder
from torchft_tpu_torch.utils.metrics import Metrics


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


# ---------------------------------------------------------------------------
# The flat wire whole: every codec, both wires, every reduce op and all four
# opcodes, in mixed cohorts held bitwise against all-JAX cohorts.

CODECS = ("none", "bf16", "fp16", "int8")
OPS = (ReduceOp.SUM, ReduceOp.AVG, ReduceOp.MAX, ReduceOp.MIN)
CHUNK = 1 << 12


def _payload(rank, op=ReduceOp.SUM):
    """Several grid chunks, a 2-D array, f64, ints (not under AVG, whose
    in-place integer divide raises on both packages) and an empty view."""
    rng = np.random.default_rng(500 + rank)
    arrays = [
        (rng.standard_normal(3000) * (rank + 1)).astype(np.float32),
        rng.standard_normal((9, 13)).astype(np.float32),
        rng.standard_normal(700),
        np.zeros(0, np.float32),
    ]
    if op != ReduceOp.AVG:
        arrays.append(rng.integers(-50, 50, 40).astype(np.int32))
    return arrays


def _cohort(kinds, body, store_addr, tag, **ctx_kw):
    """Run ``body(ctx, rank)`` on a cohort of port/JAX TcpCommContexts."""
    world = len(kinds)
    ctxs = [(TcpCommContext if k == "port" else JaxTcp)(timeout=20.0,
                                                         **ctx_kw)
            for k in kinds]
    addr = f"{store_addr}/torchft/{tag}/0"
    try:
        with ThreadPoolExecutor(max_workers=world) as pool:
            list(pool.map(lambda r: ctxs[r].configure(addr, r, world),
                          range(world)))
            futs = [pool.submit(body, ctxs[r], r) for r in range(world)]
            return [f.result(timeout=60) for f in futs]
    finally:
        for c in ctxs:
            c.shutdown()


@pytest.fixture(scope="module")
def jserver():
    server = jstore.StoreServer()
    yield server
    server.shutdown()


def _bits(arrays):
    return [(a.dtype.str, a.shape, a.tobytes()) for a in arrays]


MIXED3 = ("port", "jax", "port")


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("algorithm", ["star", "ring"])
@pytest.mark.parametrize("codec", CODECS)
def test_mixed_cohort_allreduce_every_codec(jserver, codec, algorithm,
                                            op) -> None:
    def body(ctx, rank):
        return _bits(ctx.allreduce(_payload(rank, op), op).future()
                     .result(timeout=30))

    kw = dict(algorithm=algorithm, compression=codec, chunk_bytes=CHUNK,
              channels=2)
    tag = f"ar_{codec}_{algorithm}_{op}"
    mixed = _cohort(MIXED3, body, jserver.addr, tag + "_m", **kw)
    ref = _cohort(("jax",) * 3, body, jserver.addr, tag + "_r", **kw)
    assert mixed == ref
    assert all(m == mixed[0] for m in mixed)  # every rank decodes the same


@pytest.mark.parametrize("algorithm", ["star", "ring"])
@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("op", [ReduceOp.SUM, ReduceOp.AVG])
def test_mixed_cohort_reduce_scatter(jserver, codec, algorithm, op) -> None:
    owners = [0, 2, 1, 0, 1][:len(_payload(0, op))]

    def body(ctx, rank):
        out = ctx.reduce_scatter(_payload(rank, op), op,
                                 owners=owners).future().result(timeout=30)
        return _bits([a for a, o in zip(out, owners) if o == rank])

    def allreduce(ctx, rank):
        out = ctx.allreduce(_payload(rank, op), op).future().result(30)
        return _bits([a for a, o in zip(out, owners) if o == rank])

    kw = dict(algorithm=algorithm, compression=codec, chunk_bytes=CHUNK,
              channels=3)
    tag = f"rs_{codec}_{algorithm}_{op}"
    mixed = _cohort(MIXED3, body, jserver.addr, tag + "_m", **kw)
    ref = _cohort(("jax",) * 3, body, jserver.addr, tag + "_r", **kw)
    assert mixed == ref
    # owned arrays are what an allreduce over the same grid gives there
    assert mixed == _cohort(MIXED3, allreduce, jserver.addr, tag + "_a", **kw)


def _state(rank):
    rng = np.random.default_rng(900 + rank)
    return [rng.standard_normal((rank + 1, 3)).astype(np.float32),
            np.arange(rank + 2, dtype=np.int64),
            np.full((1, 1), float(rank)),
            np.zeros((0, 4), np.float16)]


@pytest.mark.parametrize("algorithm", ["star", "ring"])
@pytest.mark.parametrize("codec", CODECS)
def test_mixed_cohort_allgather_and_broadcast(jserver, codec,
                                              algorithm) -> None:
    # state collectives: self-describing array frames, never compressed
    def body(ctx, rank):
        gathered = ctx.allgather(_state(rank)).future().result(timeout=30)
        bcast = ctx.broadcast(_state(rank), root=1).future().result(30)
        return [_bits(g) for g in gathered], _bits(bcast)

    kw = dict(algorithm=algorithm, compression=codec, channels=2)
    tag = f"ag_{codec}_{algorithm}"
    mixed = _cohort(MIXED3, body, jserver.addr, tag + "_m", **kw)
    ref = _cohort(("jax",) * 3, body, jserver.addr, tag + "_r", **kw)
    assert mixed == ref
    for gathered, bcast in mixed:
        assert gathered == [_bits(_state(r)) for r in range(3)]
        assert bcast == _bits(_state(1))


def test_zero_dim_state_arrives_one_dim_as_in_reference(jserver) -> None:
    # both packages frame np.ascontiguousarray(a), which is 1-D for a 0-d
    # array: a peer's 0-d contribution arrives with shape (1,)
    def body(ctx, rank):
        gathered = ctx.allgather([np.float32(rank).reshape(())]).future()
        return [g[0].shape for g in gathered.result(timeout=30)]

    for kinds in (("port", "jax"), ("jax", "jax")):
        shapes = _cohort(kinds, body, jserver.addr, f"zd_{kinds[0]}",
                         algorithm="star")
        assert shapes == [[(), (1,)], [(1,), (1,)]]


def test_solo_and_empty_collectives() -> None:
    ctx = TcpCommContext()
    ctx.configure("unused:0", 0, 1)
    try:
        a = [np.ones(3, np.float32)]
        assert ctx.allgather(a).future().result(5) == [a]
        assert ctx.broadcast(a).future().result(5)[0] is a[0]
        assert ctx.reduce_scatter(a).future().result(5)[0] is a[0]
        assert ctx.take_commit_vote() is True  # the solo op's own vote
    finally:
        ctx.shutdown()


def test_reduce_scatter_of_an_empty_payload(jserver) -> None:
    # the JAX package's star peer fails here (its per-lane owner list is
    # None for an all-empty grid: ROADMAP queue 3, R5); the port sends the
    # header and the vote byte alone
    def body(ctx, rank):
        out = ctx.reduce_scatter([np.zeros(0, np.float32)], owners=[1])
        return out.future().result(timeout=10)[0].shape, \
            ctx.take_commit_vote()

    for algorithm in ("star", "ring"):
        got = _cohort(("port", "port", "port"), body, jserver.addr,
                      f"rs_empty_{algorithm}", algorithm=algorithm)
        assert got == [((0,), True)] * 3


def test_reduce_scatter_owner_validation(jserver) -> None:
    def body(ctx, rank):
        w = ctx.reduce_scatter([np.ones(4, np.float32)], owners=[5])
        with pytest.raises(ValueError, match="owners"):
            w.future().result(timeout=10)
        return True

    assert all(_cohort(("port", "port"), body, jserver.addr, "rs_bad"))


# ------------------------------------------------- framing and striping


def _frame_arrays():
    import ml_dtypes

    rng = np.random.default_rng(3)
    return [
        rng.standard_normal((3, 4)).astype(np.float32),
        np.arange(7, dtype=np.int64),
        np.float32(2.5).reshape(()),
        np.zeros((0, 5), dtype=np.float64),
        rng.standard_normal(9).astype(np.dtype(ml_dtypes.bfloat16)),
        np.frombuffer(b"\x01\x02\x03", dtype=np.uint8),  # read-only
    ]


def test_array_frame_bytes_match_reference() -> None:
    arrays = _frame_arrays()
    frame = iov_join(port_transport._array_frame_iovecs(arrays))
    assert frame == ref_transport._pack_arrays(arrays)
    assert iov_join(port_transport._array_frame_iovecs([])) == \
        ref_transport._pack_arrays([])
    got = port_transport._unpack_arrays(frame)
    for g, a in zip(got, arrays):
        a = np.ascontiguousarray(a)  # what is framed: 0-d travels as (1,)
        assert g.dtype == a.dtype and g.shape == a.shape
        assert g.tobytes() == a.tobytes()
    with pytest.raises(ConnectionError, match="truncated"):
        port_transport._unpack_arrays(frame[:-1])


def test_array_frame_socket_roundtrip() -> None:
    arrays = _frame_arrays()
    s_tx, s_rx = socket.socketpair()
    try:
        sender = threading.Thread(target=port_transport._send_arrays,
                                  args=(s_tx, arrays))
        sender.start()
        got = port_transport._recv_arrays(s_rx)
        sender.join(timeout=10)
    finally:
        s_tx.close()
        s_rx.close()
    assert _bits(got) == _bits([np.ascontiguousarray(a) for a in arrays])


@pytest.mark.parametrize("codec", CODECS)
def test_codec_bytes_match_reference(codec) -> None:
    rng = np.random.default_rng(11)
    views = [rng.standard_normal(37).astype(np.float32),
             rng.standard_normal(5),
             np.arange(6, dtype=np.int32),
             np.array([np.inf, 1.0, -2.0], np.float32)]
    port = port_transport.make_wire_codec(codec)
    ref = ref_transport.make_wire_codec(codec)
    data = iov_join(port.encode_iovecs(views))
    assert data == ref.encode_views(views)
    assert len(data) == sum(port.wire_nbytes(v) for v in views)
    outs = [np.empty_like(v) for v in views]
    want = [np.empty_like(v) for v in views]
    port.decode_into(data, outs, lambda v, inc: np.copyto(v, inc))
    ref.decode_into(data, want, lambda v, inc: np.copyto(v, inc))
    assert _bits(outs) == _bits(want)


def test_chunk_grid_owned_matches_reference() -> None:
    flats = [np.zeros(n, np.float32) for n in (0, 1, 1024, 1025, 3000)]
    owners = [0, 1, 2, 0, 1]
    for cb in (0, 64, 4096):
        got, got_o = port_transport._chunk_grid_owned(flats, owners, cb)
        want, want_o = ref_transport._chunk_grid_owned(flats, owners, cb)
        assert [c.size for c in got] == [c.size for c in want]
        assert got_o == want_o


@pytest.mark.parametrize("codec", CODECS)
def test_striping_is_bitwise_invisible(jserver, codec) -> None:
    def body(ctx, rank):
        return _bits(ctx.allreduce(_payload(rank)).future().result(30))

    runs = [
        _cohort(("port", "port"), body, jserver.addr, f"st_{codec}_{i}",
                algorithm="star", compression=codec, chunk_bytes=CHUNK,
                channels=channels, stripe=stripe)
        for i, (channels, stripe) in enumerate(((4, True), (1, True),
                                                (4, False)))
    ]
    assert runs[0] == runs[1] == runs[2]


def test_star_is_sequential_rank_order_accumulation(jserver) -> None:
    def body(ctx, rank):
        return ctx.allreduce([_payload(rank)[0]]).future().result(30)[0]

    outs = _cohort(("port", "jax", "port", "port"), body, jserver.addr,
                   "seq", algorithm="star", chunk_bytes=CHUNK)
    want = _payload(0)[0].copy()
    for r in range(1, 4):
        want = want + _payload(r)[0]
    for o in outs:
        assert o.tobytes() == want.tobytes()


@pytest.mark.parametrize("codec", ["bf16", "fp16", "int8"])
def test_wire_roundtrip_roles(jserver, codec) -> None:
    # the image error feedback is computed against: a star peer's is the
    # codec's, the star root's and every ring rank's the identity
    src = np.random.default_rng(13).standard_normal(5000).astype(np.float32)
    want = np.empty_like(src)
    port_transport.codec_roundtrip(port_transport.make_wire_codec(codec),
                                   CHUNK, src, want)
    ref_want = np.empty_like(src)
    ref_transport.codec_roundtrip(ref_transport.make_wire_codec(codec),
                                  CHUNK, src, ref_want)
    assert want.tobytes() == ref_want.tobytes()

    def body(ctx, rank):
        out = np.empty_like(src)
        ctx.wire_roundtrip(src, out)
        return ctx.wire_compensable(), out.tobytes()

    for algorithm in ("star", "ring"):
        got = _cohort(("port",) * 3, body, jserver.addr,
                      f"rt_{codec}_{algorithm}", algorithm=algorithm,
                      compression=codec, chunk_bytes=CHUNK)
        for rank, (comp, out) in enumerate(got):
            peer = algorithm == "star" and rank > 0
            assert comp == peer
            assert out == (want.tobytes() if peer else src.tobytes())


# --------------------------------------------------- the hierarchical tier

MAP_2X2 = {"d0": ["rank0", "rank1"], "d1": ["rank2", "rank3"]}
MAP_UNEVEN = {"d0": ["rank0", "rank2"], "d1": ["rank1"], "d2": ["rank3"]}
MAP_SINGLE = {f"d{r}": [f"rank{r}"] for r in range(4)}
GROUPS = {
    "2x2": (MAP_2X2, ((0, 1), (2, 3))),
    "uneven": (MAP_UNEVEN, ((0, 2), (1,), (3,))),
    "singletons": (MAP_SINGLE, ((0,), (1,), (2,), (3,))),
}


def _hier_cohort(kinds, smap, body, store_addr, tag, timeout=20.0, **kw):
    """A cohort of hier-default contexts of both packages, each with its
    own package's resolver over the same map."""
    world = len(kinds)
    ctxs = []
    for k in kinds:
        if k == "port":
            ctxs.append(TcpCommContext(
                timeout=timeout, channels=2, chunk_bytes=CHUNK,
                topology="hier", domain_resolver=DomainTopology(
                    static_map=smap), **kw))
        else:
            ctxs.append(JaxTcp(
                timeout=timeout, channels=2, chunk_bytes=CHUNK,
                topology="hier", domain_resolver=RefTopology(
                    static_map=smap), **kw))
    addr = f"{store_addr}/torchft/{tag}/0"
    try:
        with ThreadPoolExecutor(max_workers=world) as pool:
            def run(rank):
                ctxs[rank].configure(addr, rank, world)
                return body(ctxs[rank], rank)

            futs = [pool.submit(run, r) for r in range(world)]
            return [f.result(timeout=90) for f in futs]
    finally:
        for c in ctxs:
            c.shutdown()


def _hier_srcs(seed, size=6000):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(size) * (r + 1)).astype(np.float32)
            for r in range(4)]


@pytest.mark.parametrize("layout", sorted(GROUPS))
@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("algorithm,op", [
    ("star", ReduceOp.SUM), ("star", ReduceOp.AVG), ("ring", ReduceOp.SUM),
    ("auto", ReduceOp.MAX),
])
def test_hier_mixed_cohort_bitwise(jserver, layout, codec, algorithm,
                                   op) -> None:
    smap, groups = GROUPS[layout]
    srcs = _hier_srcs(hash((layout, codec)) % 1000)

    def body(ctx, rank):
        d = srcs[rank].copy()
        ctx.allreduce([d], op).future().result(timeout=60)
        return d.tobytes()

    tag = f"h_{layout}_{codec}_{algorithm}_{op}"
    kinds = ("port", "jax", "jax", "port")
    mixed = _hier_cohort(kinds, smap, body, jserver.addr, tag + "_m",
                         algorithm=algorithm, compression=codec)
    ref = _hier_cohort(("jax",) * 4, smap, body, jserver.addr, tag + "_r",
                       algorithm=algorithm, compression=codec)
    assert mixed == ref
    assert all(m == mixed[0] for m in mixed)
    if algorithm != "ring":  # the star fan-in is the reference composition
        want = _host_hier_allreduce([[s.copy()] for s in srcs], codec,
                                    CHUNK, op, groups, 4)[0]
        ref_want = ref_host_hier_allreduce([[s.copy()] for s in srcs],
                                           codec, CHUNK, op, groups, 4)[0]
        assert want.tobytes() == ref_want.tobytes() == mixed[0]


def test_hier_counters_egress_only_and_hops(jserver) -> None:
    srcs = _hier_srcs(7)

    def body(ctx, rank):
        d = srcs[rank].copy()
        ctx.allreduce([d]).future().result(timeout=60)
        return ctx.metrics.snapshot(), ctx.take_commit_vote()

    for layout, (smap, groups) in GROUPS.items():
        snaps = _hier_cohort(("port",) * 4, smap, body, jserver.addr,
                             f"ctr_{layout}", algorithm="star",
                             compression="int8")
        raw = float(srcs[0].nbytes)
        enc = float(port_transport.codec_wire_nbytes(
            port_transport.make_wire_codec("int8"), CHUNK, srcs[0]))
        egress = {g[0] for g in groups}
        for rank, (snap, vote) in enumerate(snaps):
            many = any(rank in g and len(g) > 1 for g in groups)
            assert snap["comm_intra_bytes"] == (raw if many else 0.0)
            assert snap["comm_inter_bytes"] == (
                enc if rank in egress else 0.0)
            assert 0 < enc <= 0.3 * raw
            # reduce-to-egress + broadcast (2, in a domain of several) +
            # the star inter tier (2): f(domains), not f(world)
            assert snap["comm_hops"] == 2.0 * many + 2.0
            assert vote is None  # a hier op rides child contexts
    # the ring inter tier: 2(d-1) hops, raw partial sums counted too
    snaps = _hier_cohort(("port",) * 4, MAP_SINGLE, body, jserver.addr,
                         "ctr_ring", algorithm="ring", compression="int8")
    for snap, _ in snaps:
        assert snap["comm_hops"] == 6.0
        assert snap["comm_inter_bytes"] == (raw + enc) * 3 / 4


def test_hier_roles_and_exchange_events(jserver) -> None:
    recs = [EventRecorder(replica_id=f"r{i}", rank=0) for i in range(4)]

    def body(ctx, rank):
        ctx.set_events(recs[rank])
        return ctx.wire_compensable()

    # events are emitted at configure: install the recorders first
    world = 4
    ctxs = [TcpCommContext(timeout=20.0, algorithm="star", channels=2,
                           compression="int8", chunk_bytes=CHUNK,
                           topology="hier",
                           domain_resolver=DomainTopology(static_map=MAP_2X2))
            for _ in range(world)]
    for c, rec in zip(ctxs, recs):
        c.set_events(rec)
    addr = f"{jserver.addr}/torchft/roles/0"
    try:
        with ThreadPoolExecutor(max_workers=world) as pool:
            list(pool.map(lambda r: ctxs[r].configure(addr, r, world),
                          range(world)))
        # the d1 egress encodes into the fan-in; the d0 egress is the root
        assert [c.wire_compensable() for c in ctxs] == [False, False,
                                                        True, False]
        src = np.linspace(-1, 1, 5000, dtype=np.float32)
        out = np.empty_like(src)
        ctxs[1].wire_roundtrip(src, out)
        assert out.tobytes() == src.tobytes()  # non-egress: identity
        ctxs[2].wire_roundtrip(src, out)
        want = np.empty_like(src)
        port_transport.codec_roundtrip(
            port_transport.make_wire_codec("int8"), CHUNK, src, want)
        assert out.tobytes() == want.tobytes()
    finally:
        for c in ctxs:
            c.shutdown()
    for rank, rec in enumerate(recs):
        evs = [e for e in rec.dump()["events"] if e["kind"] == "hier_exchange"]
        assert len(evs) == 1
        assert evs[0]["domains"] == 2 and evs[0]["egress"] == [0, 2]
        assert evs[0]["is_egress"] == (rank in (0, 2))


def test_hier_per_op_override(jserver) -> None:
    srcs = _hier_srcs(9)

    def body(ctx, rank):
        flat = srcs[rank].copy()
        ctx.allreduce([flat], topology="flat").future().result(timeout=60)
        hier = srcs[rank].copy()
        ctx.allreduce([hier]).future().result(timeout=60)
        return flat.tobytes(), hier.tobytes()

    outs = _hier_cohort(("port", "jax", "port", "jax"), MAP_2X2, body,
                        jserver.addr, "override", algorithm="star")
    flat_ref = srcs[0].copy()
    for s in srcs[1:]:
        flat_ref = flat_ref + s
    hier_ref = _host_hier_allreduce([[s.copy()] for s in srcs], "none",
                                    CHUNK, ReduceOp.SUM, ((0, 1), (2, 3)),
                                    4)[0]
    for flat, hier in outs:
        assert flat == flat_ref.tobytes()
        assert hier == hier_ref.tobytes()

    # a lossy codec refuses an override that would desync error feedback
    def lossy(ctx, rank):
        w = ctx.allreduce([np.ones(8, np.float32)], topology="flat")
        with pytest.raises(ValueError, match="error-feedback"):
            w.future().result(timeout=10)
        return True

    assert all(_hier_cohort(("port",) * 4, MAP_2X2, lossy, jserver.addr,
                            "override_lossy", algorithm="star",
                            compression="int8"))

    # a flat context has no hier tier to ride
    def flat_only(ctx, rank):
        w = ctx.allreduce([np.ones(8, np.float32)], topology="hier")
        with pytest.raises(RuntimeError, match="topology='hier'"):
            w.future().result(timeout=10)
        w = ctx.allreduce([np.ones(8, np.float32)], topology="mesh")
        with pytest.raises(ValueError, match="unknown topology"):
            w.future().result(timeout=10)
        return True

    assert all(_cohort(("port", "port"), flat_only, jserver.addr,
                       "flat_no_hier", algorithm="star"))


def test_hier_egress_death_latches_peers(jserver) -> None:
    srcs = _hier_srcs(11)
    ctxs = [TcpCommContext(timeout=3.0, algorithm="star", channels=2,
                           chunk_bytes=CHUNK, topology="hier",
                           domain_resolver=DomainTopology(static_map=MAP_2X2))
            for _ in range(4)]
    results = [None] * 4
    configured = threading.Barrier(4)

    def worker(rank):
        ctxs[rank].configure(f"{jserver.addr}/torchft/death/0", rank, 4)
        configured.wait(timeout=30)
        if rank == 2:
            return  # the egress of d1 never submits, then dies
        try:
            ctxs[rank].allreduce([srcs[rank].copy()]).future().result(40)
            results[rank] = "ok"
        except Exception:  # noqa: BLE001
            results[rank] = "failed"

    threads = [threading.Thread(target=worker, args=(r,)) for r in range(4)]
    try:
        for t in threads:
            t.start()
        time.sleep(1.0)
        ctxs[2].shutdown()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        # d1's other member and d0's egress (waiting on the fan-in) fail
        # and latch instead of hanging
        assert results[3] == "failed" and results[0] == "failed"
        assert ctxs[3].errored() is not None
        assert ctxs[0].errored() is not None
    finally:
        for c in ctxs:
            c.shutdown()


def test_hier_publishes_rank0_assignment(jserver) -> None:
    # only wire rank 0 needs a resolver: the others adopt its hier_map
    srcs = _hier_srcs(13)
    ctxs = [TcpCommContext(timeout=20.0, algorithm="star", channels=2,
                           chunk_bytes=CHUNK, topology="hier",
                           domain_resolver=DomainTopology(
                               static_map=MAP_2X2 if r == 0 else {}))
            for r in range(4)]
    for c in ctxs:
        c.set_wire_members([f"rank{r}" for r in range(4)])

    def run(rank):
        ctxs[rank].configure(f"{jserver.addr}/torchft/publish/0", rank, 4)
        d = srcs[rank].copy()
        ctxs[rank].allreduce([d]).future().result(timeout=60)
        return d.tobytes(), ctxs[rank].metrics.snapshot()["comm_inter_bytes"]

    try:
        with ThreadPoolExecutor(max_workers=4) as pool:
            outs = list(pool.map(run, range(4)))
    finally:
        for c in ctxs:
            c.shutdown()
    want = _host_hier_allreduce([[s.copy()] for s in srcs], "none", CHUNK,
                                ReduceOp.SUM, ((0, 1), (2, 3)), 4)[0]
    assert [o for o, _ in outs] == [want.tobytes()] * 4
    assert [b > 0 for _, b in outs] == [True, False, True, False]


# ----------------------------------------------- error feedback over hier


class _DdpStub:
    """Manager facade over a raw port context for the port's DDP: no-op
    quorum, SUM then 1/world scaling in f32 (the Manager's), the wire_*
    introspection passed through."""

    def __init__(self, ctx, world):
        self._ctx = ctx
        self._world = world
        self.metrics = Metrics()

    def wait_quorum(self):
        pass

    def is_solo_wire(self):
        return self._world == 1

    def is_participating(self):
        return True

    def report_error(self, e):
        raise e

    def wire_compensable(self):
        return self._ctx.wire_compensable()

    def wire_generation(self):
        return self._ctx.wire_generation()

    def wire_roundtrip(self, src, out):
        self._ctx.wire_roundtrip(src, out)

    def allreduce_arrays(self, arrays, op=ReduceOp.SUM, topology=None):
        work = self._ctx.allreduce(list(arrays), ReduceOp.SUM,
                                   topology=topology)
        scale = np.float32(1.0 / self._world)

        def _avg(f: Future):
            reduced = f.result()
            for a in reduced:
                np.multiply(a, a.dtype.type(scale), out=a)
            return reduced

        return Work(future_chain(work.future(), _avg))


def _descend_hier(store_addr, tag, codec, error_feedback, targets, smap,
                  steps=200, tail=40):
    """GD on f(x) = mean_r 0.5 ||x - t_r||^2 through the port's DDP over
    the hier wire (inter tier int8 or raw); rank 0's Polyak tail average."""
    world = len(targets)

    def body(ctx, rank):
        ddp = DistributedDataParallel(_DdpStub(ctx, world),
                                      error_feedback=error_feedback,
                                      topology="hier")
        x = torch.nn.Parameter(torch.zeros(targets[rank].shape))
        t = torch.from_numpy(targets[rank])
        acc = np.zeros(x.shape, np.float64)
        for i in range(steps):
            x.grad = (x.detach() - t).clone()
            ddp.average_gradients([x])
            with torch.no_grad():
                x -= 0.2 * x.grad
            if i >= steps - tail:
                acc += x.detach().numpy()
        return (acc / tail).astype(np.float32)

    ctxs = [TcpCommContext(timeout=30.0, algorithm="star", channels=2,
                           compression=codec, chunk_bytes=64,
                           topology="hier",
                           domain_resolver=DomainTopology(static_map=smap))
            for _ in range(world)]
    try:
        with ThreadPoolExecutor(max_workers=world) as pool:
            list(pool.map(lambda r: ctxs[r].configure(
                f"{store_addr}/torchft/{tag}/0", r, world), range(world)))
            return [f.result(timeout=300) for f in
                    [pool.submit(body, ctxs[r], r) for r in range(world)]][0]
    finally:
        for c in ctxs:
            c.shutdown()


def test_int8_ef_converges_over_hier_wire_where_raw_parks(jserver) -> None:
    """Four one-group domains (the egress residual is exact): int8 with
    error feedback over the hier inter tier tracks fp32 (to 1e-3 of the
    optimum's scale), raw int8 parks at a bias fixed point at least 10x
    further off, the reference test's bounds."""
    rng = np.random.default_rng(23)
    targets = []
    for _ in range(4):
        t = rng.standard_normal(48).astype(np.float32)
        t[:4] *= 100.0
        targets.append(t)
    optimum = np.mean(targets, axis=0).astype(np.float32)
    scale = float(np.abs(optimum).max())
    x_fp32 = _descend_hier(jserver.addr, "hef_fp32", "none", "auto",
                           targets, MAP_SINGLE)
    x_raw = _descend_hier(jserver.addr, "hef_raw", "int8", False, targets,
                          MAP_SINGLE)
    x_ef = _descend_hier(jserver.addr, "hef_on", "int8", "auto", targets,
                         MAP_SINGLE)
    err_fp32 = float(np.max(np.abs(x_fp32 - optimum)))
    err_raw = float(np.max(np.abs(x_raw - optimum)))
    err_ef = float(np.max(np.abs(x_ef - optimum)))
    assert err_fp32 < 1e-4
    assert float(np.max(np.abs(x_ef - x_fp32))) < 1e-3 * scale, err_ef
    assert err_raw > 10 * err_ef, (err_raw, err_ef)


# ------------------------------------- the hier capability surface, as the JAX


def test_host_rules() -> None:
    # the host wire's capability table, reason for reason the reference's
    # (its on-device plane named "cuda" where the reference names "xla")
    for algorithm in ("star", "ring", "auto", "psum", "tree"):
        for codec in ("none", "bf16", "int8"):
            for topology in ("flat", "hier", "mesh"):
                want = ref_transport.host_unsupported_reason(
                    algorithm, codec, topology=topology)
                got = port_transport.host_unsupported_reason(
                    algorithm, codec, topology=topology)
                assert got == (None if want is None else
                               want.replace("xla", "cuda")), (
                    algorithm, codec, topology)
    assert port_transport.host_unsupported_reason(
        "star", "int8", topology="hier") is None
    assert "cuda" in port_transport.host_unsupported_reason(
        "psum", "none", topology="hier")
    assert "hier" in port_transport.host_unsupported_reason(
        "star", "none", topology="mesh")


def test_ctor_refusals_are_prescriptive() -> None:
    for cls in (TcpCommContext, JaxTcp):
        with pytest.raises(ValueError, match="psum"):
            cls(algorithm="psum", topology="hier")
        with pytest.raises(ValueError, match="unknown topology"):
            cls(topology="tree")


def test_wrappers_forward_topology() -> None:
    # the error-swallowing wrapper and the wire stub answer for the
    # context they wrap, topology included; an identity context takes all
    from torchft_tpu.comm.context import ErrorSwallowingCommContext as JSwallow
    from torchft_tpu.comm.wire_stub import WireStubManager as JStub
    from torchft_tpu_torch.comm.wire_stub import WireStubManager

    got = {}
    for pkg, tcp, swallow, stub in (
            ("port", TcpCommContext, ErrorSwallowingCommContext,
             WireStubManager),
            ("jax", JaxTcp, JSwallow, JStub)):
        inner = tcp(timeout=5.0, algorithm="star")
        try:
            wrapped, wire = swallow(inner), stub(inner, 1)
            got[pkg] = (
                wrapped.supports("star", "int8", topology="hier"),
                wrapped.supports("psum", "none", topology="hier"),
                wire.comm_supports("ring", "bf16", topology="hier"),
                wire.comm_unsupported_reason("star", "none",
                                             topology="weird") is not None)
        finally:
            inner.shutdown()
    assert got["port"] == got["jax"] == (True, False, True, True)
    assert DummyCommContext().supports("star", "int8", topology="hier")
