"""``DevicePool(devices=...)``, the twin of the reference's
``MeshManager(devices=)``, on the CPU.

The same seeded numpy inputs go through every arm of the pool:

- ``one``: ``DevicePool("cpu", positions=n)``, today's virtual mesh;
- ``list``: ``DevicePool(devices=["cpu"] * n)``, the same pool spelled as a
  device list;
- ``cards``: ``DevicePool(devices=["cpu:0", ..., "cpu:n-1"])``: distinct
  device indices lay out as distinct cards, so the plane takes its
  cross-card path (one buffer a card, copies between them) on the host;
- ``cycled``: ``cpu:0, cpu:1, cpu:0, ...``: rows that share a card share a
  buffer.

Checked, bitwise unless stated: ``mesh_for`` puts every position where the
reference's ``MeshManager(jax.devices()[:8]).mesh_for`` puts its device,
and raises past the list; the arms agree with each other for star, ring,
psum and the quantized psum at codecs none, bf16 and int8 under SUM and
AVG, for ``reduce_scatter`` and for the hier tier; star and ring agree with
the reference's ``TcpCommContext`` (its host codec over sockets), the
quantized psum and its scatter with a numpy composition of the reference's
codecs, the raw psum within 1e-5 of numpy's sum, and the hier star with the
reference's ``_host_hier_allreduce``. ``dryrun_multichip(4,
devices=["cpu"])`` gives ``dryrun_multichip(4, device="cpu")``'s figures.
A pool that names a card the process cannot see raises. No caller needs a
pool over one card any more (``DevicePool.device()`` is gone):
``FusedStepEngine`` takes a pool over several devices (its bitwise oracles
over cards are in tests/test_torch_fused_step.py) and refuses one whose
positions mix device kinds. (R1 keeps the XLA plane from being an
oracle.)
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from torchft_tpu.comm.transport import _CODECS as REF_CODECS
from torchft_tpu.comm.transport import codec_roundtrip as ref_codec_roundtrip
from torchft_tpu.comm.xla_backend import (
    _host_hier_allreduce as ref_host_hier_allreduce,
)
from torchft_tpu_torch.comm.context import ReduceOp
from torchft_tpu_torch.comm.cuda_backend import CudaCommContext, DevicePool
from torchft_tpu_torch.comm.topology import DomainTopology

CHUNK = 1 << 12  # several chunks and per-chunk int8 scales
CODECS = ("none", "bf16", "int8")
OPS = (ReduceOp.SUM, ReduceOp.AVG)


def _pools(n: int):
    return {"one": DevicePool("cpu", positions=n),
            "list": DevicePool(devices=["cpu"] * n),
            "cards": DevicePool(devices=[f"cpu:{i}" for i in range(n)]),
            "cycled": DevicePool(devices=[f"cpu:{i % 2}" for i in range(n)])}


def _inputs(world: int, seed: int, sizes=(5000, 257)):
    rng = np.random.default_rng(seed)
    out = []
    for r in range(world):
        per = [(rng.standard_normal(s) * (r + 1)).astype(np.float32)
               for s in sizes]
        per[0][len(per[0]) // 3] = 40.0 * (r + 1)  # one chunk's scale
        out.append(per)
    return out


def _run_cohort(ctxs, addr, world, body, timeout=60.0):
    """Configure each rank's context and run ``body(ctx, rank)`` on a
    thread per rank (the in-process stand-in for a collective launch)."""
    results = [None] * world

    def worker(rank):
        ctxs[rank].configure(addr, rank, world)
        results[rank] = body(ctxs[rank], rank)

    with ThreadPoolExecutor(max_workers=world) as ex:
        for f in [ex.submit(worker, r) for r in range(world)]:
            f.result(timeout=timeout)
    return results


def _cohort(pool, tag, world, body, **ctx_kw):
    ctxs = [CudaCommContext(timeout=30.0, chunk_bytes=CHUNK,
                            device_pool=pool, **ctx_kw)
            for _ in range(world)]
    try:
        return _run_cohort(ctxs, f"cuda://pool/{tag}", world, body)
    finally:
        for c in ctxs:
            c.shutdown()


def _allreduce(inputs, op):
    def body(ctx, rank):
        w = ctx.allreduce([a.copy() for a in inputs[rank]], op)
        return [np.array(x) for x in w.future().result(timeout=30)]
    return body


def _every_arm(world, tag, body, **ctx_kw):
    """Each arm's per-rank results, all held bitwise to the ``one`` arm's;
    returns those."""
    got = {arm: _cohort(pool, f"{tag}/{arm}", world, body, **ctx_kw)
           for arm, pool in _pools(world).items()}
    want = got["one"]
    for arm, results in got.items():
        for r, (g_r, w_r) in enumerate(zip(results, want)):
            for i, (g, w) in enumerate(zip(g_r, w_r)):
                assert g.dtype == w.dtype and g.shape == w.shape
                assert g.tobytes() == w.tobytes(), (
                    f"{tag}: arm {arm} rank {r} array {i}: "
                    f"{int((g != w).sum())}/{g.size} elements differ")
    return want


# ------------------------------------------------------- (a) the layout


@pytest.mark.parametrize("replicas, shards", [(2, 1), (4, 1), (2, 2),
                                              (2, 4)])
def test_mesh_for_places_positions_as_the_reference(replicas,
                                                    shards) -> None:
    import jax

    from torchft_tpu.comm.xla_backend import MeshManager

    ref = MeshManager(jax.devices()[:8]).mesh_for(replicas, shards)
    want = np.vectorize(lambda d: d.id)(np.asarray(ref.devices))
    pool = DevicePool(devices=[f"cpu:{i}" for i in range(8)])
    mesh = pool.mesh_for(replicas, shards)
    assert mesh.axis_names == tuple(ref.axis_names)
    got = np.vectorize(lambda d: d.index)(mesh.devices)
    assert got.shape == want.shape and (got == want).all()
    assert pool.mesh_for(replicas, shards) is mesh  # cached per shape
    virtual = DevicePool(devices=["cpu"] * 8).mesh_for(replicas, shards)
    assert virtual.devices.shape == want.shape
    assert {str(d) for d in virtual.devices.flat} == {"cpu"}
    # rank r of the wire on position r, whichever replicas survive
    cards = pool.cards_for(replicas)
    assert [cards.card(r).index for r in range(replicas)] == \
        list(range(replicas))


def test_mesh_past_the_list_raises_as_the_reference() -> None:
    from torchft_tpu.comm.xla_backend import MeshManager

    with pytest.raises(ValueError, match="exceeds the device pool"):
        MeshManager(devices=[object(), object()]).mesh_for(3)
    pool = DevicePool(devices=["cpu:0", "cpu:1"])
    for args in ((3,), (2, 2)):
        with pytest.raises(ValueError, match="exceeds the device pool"):
            pool.mesh_for(*args)
    with pytest.raises(ValueError, match="exceeds the device pool"):
        pool.cards_for(3)
    assert DevicePool("cpu", positions=5).device_count() == \
        DevicePool(devices=["cpu"] * 5).device_count() == 5
    with pytest.raises(ValueError):
        DevicePool("cpu", devices=["cpu"])


def test_rows_that_share_a_card_share_a_buffer() -> None:
    cards = DevicePool(devices=["cpu:0", "cpu:1", "cpu:0", "cpu:1",
                                "cpu:0"]).cards_for(5)
    assert [d.index for d in cards.devices] == [0, 1]
    assert cards.ranks == [[0, 2, 4], [1, 3]]
    assert cards.slot == [0, 0, 1, 1, 2] and not cards.one
    assert DevicePool(devices=["cpu"] * 3).cards_for(3).one


# ------------------------------------------- (b) the plane on every arm


@pytest.mark.parametrize("world", [2, 3])
@pytest.mark.parametrize("algo", ["star", "ring"])
@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("op", OPS)
def test_star_and_ring_on_every_arm_equal_the_reference_tcp_wire(
        world, algo, codec, op) -> None:
    from torchft_tpu.comm.store import StoreServer as RefStore
    from torchft_tpu.comm.transport import TcpCommContext as RefTcp

    inputs = _inputs(world, seed=world * 10 + len(codec))
    tag = f"{algo}_{codec}_{op}_{world}"
    got = _every_arm(world, tag, _allreduce(inputs, op), algorithm=algo,
                     compression=codec)
    server = RefStore()
    ref = [RefTcp(timeout=30.0, algorithm=algo, channels=2,
                  compression=codec, chunk_bytes=CHUNK)
           for _ in range(world)]
    try:
        want = _run_cohort(ref, f"{server.addr}/{tag}", world,
                           _allreduce(inputs, op))
    finally:
        for c in ref:
            c.shutdown()
        server.shutdown()
    for g_r, w_r in zip(got, want):
        for g, w in zip(g_r, w_r):
            assert g.tobytes() == np.asarray(w).tobytes(), tag


def _np_quantized_psum(xs, codec_name, op):
    """The reference's quantized psum from its host codecs, in its order
    (tests/test_torch_cuda_backend.py's composition)."""
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


@pytest.mark.parametrize("world", [2, 3, 4])
@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("op", OPS)
def test_psum_on_every_arm(world, codec, op) -> None:
    # 5000 f32 splits unevenly over the owners, 7 leaves most shards short,
    # 2 leaves whole shards of padding (the cross-card path's zero-width
    # owner), and an int32 payload rides the raw sum
    sizes = (5000, 7, 2) if world > 2 else (5000, 7)
    inputs = _inputs(world, seed=world * 3 + len(codec), sizes=sizes)
    if op == ReduceOp.SUM:  # AVG takes floats only
        for r, per in enumerate(inputs):
            per.append(np.arange(300, dtype=np.int32) * (r + 1))
    got = _every_arm(world, f"psum_{codec}_{op}_{world}",
                     _allreduce(inputs, op), algorithm="psum",
                     compression=codec)
    for k in range(len(sizes)):
        xs = [per[k] for per in inputs]
        if codec == "none":
            want = np.sum(xs, axis=0)
            if op == ReduceOp.AVG:
                want = want / world
            for r in range(world):
                np.testing.assert_allclose(got[r][k], want, rtol=1e-5,
                                           atol=1e-5)
        else:
            want = _np_quantized_psum(xs, codec, op)
            for r in range(world):
                assert got[r][k].tobytes() == want.tobytes(), (k, r)
    if op == ReduceOp.SUM:
        ints = np.sum([per[-1] for per in inputs], axis=0, dtype=np.int32)
        for r in range(world):
            assert np.array_equal(got[r][-1], ints)


@pytest.mark.parametrize("world", [2, 3])
@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("op", OPS)
def test_reduce_scatter_on_every_arm(world, codec, op) -> None:
    rng = np.random.default_rng(world + 17)
    sizes = (4000, 2500, 4097)[:world]
    L = max(sizes)
    inputs = [[(rng.standard_normal(s) * (r + 1)).astype(np.float32)
               for s in sizes] for r in range(world)]

    def body(ctx, rank):
        w = ctx.reduce_scatter([a.copy() for a in inputs[rank]], op)
        return [np.array(w.future().result(timeout=30)[rank])]

    got = _every_arm(world, f"scatter_{codec}_{op}_{world}", body,
                     algorithm="psum", compression=codec)
    for d in range(world):
        if codec == "none":
            want = np.sum([inputs[r][d] for r in range(world)], axis=0)
            if op == ReduceOp.AVG:
                want = want / world
            np.testing.assert_allclose(got[d][0], want, rtol=1e-5,
                                       atol=1e-5)
            continue
        ref = REF_CODECS[codec]()
        acc = np.zeros(L, np.float32)
        for r in range(world):
            slot = np.zeros(L, np.float32)
            slot[:sizes[d]] = inputs[r][d]
            dec = np.empty_like(slot)
            ref_codec_roundtrip(ref, CHUNK, slot, dec)
            acc = acc + dec
        if op == ReduceOp.AVG:
            acc = acc / np.float32(world)
        assert got[d][0].tobytes() == acc[:sizes[d]].tobytes(), d


@pytest.mark.parametrize("world", [2, 3])
@pytest.mark.parametrize("algo", ["star", "ring"])
def test_max_and_min_on_every_arm(world, algo) -> None:
    inputs = _inputs(world, seed=world + 70)
    for op in (ReduceOp.MAX, ReduceOp.MIN):
        got = _every_arm(world, f"extrema_{algo}_{op}_{world}",
                         _allreduce(inputs, op), algorithm=algo,
                         compression="int8")
        exact = (np.max if op == ReduceOp.MAX else np.min)(
            [per[0] for per in inputs], axis=0)
        assert np.abs(got[0][0] - exact).max() <= 2 * np.abs(exact).max()


HIER_MAPS = {"2x2": ({"d0": ["rank0", "rank1"], "d1": ["rank2", "rank3"]},
                     ((0, 1), (2, 3))),
             "uneven": ({"d0": ["rank0", "rank2"], "d1": ["rank1"],
                         "d2": ["rank3"]}, ((0, 2), (1,), (3,)))}


@pytest.mark.parametrize("layout", sorted(HIER_MAPS))
@pytest.mark.parametrize("algo", ["star", "psum"])
@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("op", OPS)
def test_hier_tier_on_every_arm(layout, algo, codec, op) -> None:
    smap, groups = HIER_MAPS[layout]
    inputs = _inputs(4, seed=len(codec) + 5 * len(layout))
    got = _every_arm(4, f"hier_{layout}_{algo}_{codec}_{op}",
                     _allreduce(inputs, op), algorithm=algo,
                     compression=codec, topology="hier",
                     domain_resolver=DomainTopology(static_map=smap))
    if algo == "star":
        want = ref_host_hier_allreduce(
            [[a.copy() for a in per] for per in inputs], codec, CHUNK, op,
            groups, 4)
        for outs in got:
            for o, w in zip(outs, want):
                assert o.tobytes() == np.asarray(w).tobytes()
        return
    exact = np.sum([per[0] for per in inputs], axis=0, dtype=np.float64)
    if op == ReduceOp.AVG:
        exact /= 4
    absmax = max(float(np.abs(per[0]).max()) for per in inputs)
    for outs in got:
        assert outs[0].tobytes() == got[0][0].tobytes()
        assert float(np.abs(outs[0] - exact).max()) < 3 * absmax / 100


def test_cross_card_plans_cache_per_world_and_count_builds() -> None:
    pool = DevicePool(devices=[f"cpu:{i}" for i in range(3)])
    inputs = _inputs(3, seed=1)
    for world in (3, 2, 3):
        _cohort(pool, f"cache_{world}", world,
                _allreduce(inputs[:world], ReduceOp.SUM), algorithm="psum",
                compression="int8")
    # one plan a world size: the third op is a hit
    assert (pool.compile_count, pool.hit_count) == (2, 1)


# ------------------------------------------------ (c) the dry run's list


def test_dryrun_over_a_device_list_gives_the_virtual_mesh_figures() -> None:
    from torchft_tpu_torch.graft_entry import dryrun_multichip

    a = dryrun_multichip(4, device="cpu")
    b = dryrun_multichip(4, devices=["cpu"])
    assert a["segments"].keys() == b["segments"].keys()
    for name in a["segments"]:
        if name == "ft":  # a threaded schedule: its counts vary run to run
            assert a["segments"][name]["common_steps"] > 0
            assert b["segments"][name]["common_steps"] > 0
            continue
        assert a["segments"][name] == b["segments"][name], name
    assert a["launches"] == b["launches"]
    assert b["summary"].endswith("OK")
    with pytest.raises(ValueError):
        dryrun_multichip(4, device="cpu", devices=["cpu"])


# --------------------------------------- (d) no fall back to one device


def test_single_card_callers_refuse_a_pool_of_several_devices() -> None:
    # the single-card callers are gone: the fused engine lays a pool over
    # several devices out one position a card (no fall back to the first
    # card), and only a pool whose positions mix device kinds is refused
    from torchft_tpu_torch.fused import FusedStepEngine
    from torchft_tpu_torch.optim import sgd

    assert not hasattr(DevicePool, "device")
    pool = DevicePool(devices=[f"cpu:{i}" for i in range(4)])
    eng = FusedStepEngine(pool, 2, 2, np.linspace(-1, 1, 8, dtype=np.float32),
                          2, lambda p, row: (p * row.sum()).square().sum(),
                          sgd(0.1))
    assert len(eng._state.p) == len(pool.cards()) == 4
    eng.step_fused(np.ones((4, 2), np.float32))
    eng.verify_replicas()
    mixed = DevicePool(devices=["cpu", "meta"])
    assert [str(d) for d in mixed.cards()] == ["cpu", "meta"]
    with pytest.raises(ValueError, match="cpu, meta"):
        FusedStepEngine(mixed, 1, 2, np.zeros(8, np.float32), 2,
                        lambda p, row: (p * p).sum(), sgd(0.1))


def test_a_card_the_process_cannot_see_raises() -> None:
    pool = DevicePool(devices=["cpu", f"cuda:{torch.cuda.device_count()}"])
    # no card: resolve_device refuses CUDA; on a machine with cards the
    # index past the visible ones does
    with pytest.raises((RuntimeError, ValueError)):
        pool.devices()
    with pytest.raises((RuntimeError, ValueError)):
        pool.mesh_for(2)
