"""The port's redistribution engine against the JAX package's.

Twins of tests/test_redistribute.py (its XLA-plane arm cannot run here,
R1, and the two DiLoCo ``sharded_outer`` tests wait for that port): the
spec algebra, transfer plans, lower bounds and the 2-D sub-units, each
held EQUAL to the reference's on the same inputs; the plan cache under
world-size oscillation; multi-holder striping; whole-or-raise failover;
the cohort exchange over the port's loopback TCP wire with
``redist_moved_bytes == redist_lower_bound_bytes``, against the
allgather A/B arm; a dead donor and a protocol error mid-exchange; and
``fetch_opt_shard`` on the planner. Tolerance: none, every comparison is
exact or bitwise.
"""

import copy
import io
import urllib.error

import numpy as np
import pytest
import torch

from tests.test_torch_sharded_update import (
    _KEYS,
    _TX,
    _helper,
    run_wrapper,
)
from torchft_tpu_torch.comm.redistribute import (
    RedistPlanner,
    RedistTransferError,
    ShardSpec,
    TransferPlan,
    exchange,
    execute_fetches,
)
from torchft_tpu_torch.comm.store import StoreServer
from torchft_tpu_torch.comm.transport import TcpCommContext
from torchft_tpu_torch.comm.wire_stub import WireStubManager, run_stub_ranks
from torchft_tpu_torch.ddp import shard_ranges
from torchft_tpu_torch.optim import _state_tensors
from torchft_tpu_torch.utils.metrics import Metrics


@pytest.fixture()
def store():
    server = StoreServer()
    yield server
    server.shutdown()


def _ref():
    import torchft_tpu.comm.redistribute as ref

    return ref


def _same_plan(port_plan, ref_plan) -> None:
    """Two plans equal field by field (the reference's on the same
    inputs)."""
    for name in ("unit_bytes", "fetches", "unsourced", "senders",
                 "moved_bytes", "lower_bound_bytes"):
        assert getattr(port_plan, name) == getattr(ref_plan, name), name


# ------------------------------------------------------------ spec algebra


def test_spec_constructors_agree() -> None:
    ref = _ref()
    by_ranges = ShardSpec.from_ranges([(0, 2), (2, 5)], 5)
    by_dict = ShardSpec(5, {0: [0, 1], 1: [2, 3, 4]})
    assert by_ranges == by_dict and hash(by_ranges) == hash(by_dict)
    owner = ShardSpec.from_owner_map(6, 3, lambda u: u % 3)
    assert owner.units_of(1) == (1, 4) and owner.holders_of(5) == (2,)
    dup = ShardSpec(3, {0: [1], 1: [1], 2: []})
    assert dup.holders() == (0, 1) and dup.holders_of(1) == (0, 1)
    with pytest.raises(ValueError, match="outside the grid"):
        ShardSpec(2, {0: [2]})
    # keys and fingerprints equal the reference's
    for spec, twin in (
            (by_ranges, ref.ShardSpec.from_ranges([(0, 2), (2, 5)], 5)),
            (owner, ref.ShardSpec.from_owner_map(6, 3, lambda u: u % 3)),
            (dup, ref.ShardSpec(3, {0: [1], 1: [1], 2: []}))):
        assert spec.key() == twin.key()
        assert spec.fingerprint() == twin.fingerprint()


def test_plan_minimal_no_overship_no_fanout() -> None:
    src = ShardSpec(6, {0: [0, 1, 2], 1: [3, 4]})  # unit 5: dead owner
    dst = ShardSpec.from_ranges([(0, 2), (2, 4), (4, 6)], 6)
    unit_bytes = [10, 20, 30, 40, 50, 60]
    plan = TransferPlan(src, dst, unit_bytes)
    assert plan.receiver_fetches(0) == ()
    assert {u for u, _ in plan.receiver_fetches(1)} == {2}
    assert {u for u, _ in plan.receiver_fetches(2)} == {4}
    assert plan.receiver_unsourced(2) == (5,)
    assert plan.moved_bytes == {1: 30, 2: 50} == plan.lower_bound_bytes
    assert plan.total_moved_bytes() == 80
    assert plan.senders == (0, 1)
    assert plan.serve_units(0) == (2,) and plan.serve_units(1) == (4,)
    ref = _ref()
    _same_plan(plan, ref.TransferPlan(
        ref.ShardSpec(6, {0: [0, 1, 2], 1: [3, 4]}),
        ref.ShardSpec.from_ranges([(0, 2), (2, 4), (4, 6)], 6), unit_bytes))


def test_spec_2d_sub_units() -> None:
    spec = ShardSpec.from_ranges_2d([(0, 2), (2, 3)], 2, 3)
    assert spec.n_units == 6
    assert spec.units_of(0) == (0, 1, 2, 3) and spec.units_of(1) == (4, 5)
    assert ShardSpec.from_ranges_2d([(0, 2), (2, 3)], 1, 3) == \
        ShardSpec.from_ranges([(0, 2), (2, 3)], 3)
    assert spec == ShardSpec(6, {0: [0, 1, 2, 3], 1: [4, 5]})
    assert spec.key() == _ref().ShardSpec.from_ranges_2d(
        [(0, 2), (2, 3)], 2, 3).key()


@pytest.mark.parametrize("model_shards", [1, 2, 3])
def test_plan_2d_shrink_moved_equals_lower_bound(model_shards) -> None:
    # a w3 -> w2 shrink priced per sub-unit: moved == lower bound, the
    # dead owner's sub-units unsourced; equal to the reference's plan
    from torchft_tpu.ddp import shard_ranges as ref_ranges

    ref = _ref()
    sizes = [8 + i for i in range(6)]
    dtypes = [np.dtype(np.float32)] * 6
    m = model_shards
    assert shard_ranges(sizes, dtypes, 3) == ref_ranges(sizes, dtypes, 3)
    spec3 = ShardSpec.from_ranges_2d(shard_ranges(sizes, dtypes, 3), m, 6)
    spec2 = ShardSpec.from_ranges_2d(shard_ranges(sizes, dtypes, 2), m, 6)
    src = ShardSpec(6 * m, {0: spec3.units_of(1), 1: spec3.units_of(2)})
    unit_bytes = []
    for n in sizes:
        part = (n // m) * 4
        unit_bytes += [part] * (m - 1) + [n * 4 - part * (m - 1)]
    plan = TransferPlan(src, spec2, unit_bytes)
    assert plan.lower_bound_bytes == plan.moved_bytes
    for rank in (0, 1):
        needed = set(spec2.units_of(rank)) - set(src.units_of(rank))
        sourced = {u for u in needed if src.holders_of(u)}
        assert {u for u, _ in plan.receiver_fetches(rank)} == sourced
        assert set(plan.receiver_unsourced(rank)) == needed - sourced
    assert any(plan.receiver_fetches(r) for r in (0, 1))
    assert any(plan.receiver_unsourced(r) for r in (0, 1))
    r3 = ref.ShardSpec.from_ranges_2d(ref_ranges(sizes, dtypes, 3), m, 6)
    r2 = ref.ShardSpec.from_ranges_2d(ref_ranges(sizes, dtypes, 2), m, 6)
    _same_plan(plan, ref.TransferPlan(
        ref.ShardSpec(6 * m, {0: r3.units_of(1), 1: r3.units_of(2)}), r2,
        unit_bytes))


def test_split_join_leaf_payload_roundtrip() -> None:
    # a lossless inverse pair, scalars and odd lengths included, equal to
    # the reference's split on the same arrays
    from torchft_tpu.checkpointing import split_leaf_payload as ref_split
    from torchft_tpu_torch.checkpointing import (
        join_leaf_payload,
        split_leaf_payload,
    )

    rng = np.random.default_rng(3)
    arrays = [np.asarray(np.int32(7)),
              rng.standard_normal(13).astype(np.float32),
              rng.standard_normal((3, 5)).astype(np.float32)]
    for m in (1, 2, 3, 4):
        pieces = split_leaf_payload(arrays, m)
        want = ref_split(arrays, m)
        assert len(pieces) == len(want) == m
        for mine, theirs in zip(pieces, want):
            assert [a.tobytes() for a in mine] == \
                [a.tobytes() for a in theirs]
        back = join_leaf_payload(pieces, [a.shape for a in arrays])
        for orig, rt in zip(arrays, back):
            assert orig.dtype == rt.dtype
            np.testing.assert_array_equal(orig, rt)
    # tensors split as their bytes
    t = split_leaf_payload([torch.arange(6, dtype=torch.float32)], 2)
    assert [p.tolist() for p in t[0] + t[1]] == [[0, 1, 2], [3, 4, 5]]
    bad = split_leaf_payload(arrays, 2)
    bad[1][1] = bad[1][1][:-1]
    with pytest.raises(ValueError, match="template"):
        join_leaf_payload(bad, [a.shape for a in arrays])


def test_format_slice_spec_matches_the_reference() -> None:
    from torchft_tpu.checkpointing import format_slice_spec as ref_format
    from torchft_tpu_torch.checkpointing import format_slice_spec

    for slices in ([slice(0, 4), slice(None), slice(2, 8)],
                   [slice(None, 3)], [slice(5, None), slice(0, 0)]):
        assert format_slice_spec(slices) == ref_format(slices)
    with pytest.raises(ValueError, match="strided"):
        format_slice_spec([slice(0, 4, 2)])


def test_plan_cache_oscillation_exactly_two_builds() -> None:
    sizes = [64, 33, 47, 12, 90]
    dtypes = [np.dtype(np.float32)] * 5
    w2 = ShardSpec.from_ranges(shard_ranges(sizes, dtypes, 2), 5)
    w3 = ShardSpec.from_ranges(shard_ranges(sizes, dtypes, 3), 5)
    unit_bytes = [s * 4 for s in sizes]
    p = RedistPlanner()
    metrics = Metrics()
    plans = [p.plan(src, dst, unit_bytes, metrics=metrics)
             for src, dst in [(w2, w3), (w3, w2), (w2, w3), (w3, w2)]]
    assert p.builds == 2 and p.hits == 2
    assert plans[2] is plans[0] and plans[3] is plans[1]
    snap = metrics.snapshot()
    assert snap["redist_plan_builds"] == 2 == snap["redist_plan_cache_hits"]


def test_multi_holder_striping_round_robin() -> None:
    src = ShardSpec(4, {0: [0, 1, 2, 3], 1: [0, 1, 2, 3]})
    dst = ShardSpec(4, {2: [0, 1, 2, 3]})
    plan = TransferPlan(src, dst, [8, 8, 8, 8])
    primaries = [holders[0] for _, holders in plan.receiver_fetches(2)]
    assert primaries.count(0) == primaries.count(1) == 2
    for _, holders in plan.receiver_fetches(2):
        assert sorted(holders) == [0, 1]


def test_execute_fetches_failover_whole_or_raises() -> None:
    src = ShardSpec(3, {0: [0, 1, 2], 1: [0, 1]})
    dst = ShardSpec(3, {2: [0, 1, 2]})
    plan = TransferPlan(src, dst, [4, 4, 4])
    calls = []

    def _fetch(holder, unit):
        calls.append((holder, unit))
        if holder == 0:
            raise ConnectionError("holder 0 died")
        return [np.full(1, unit, np.float32)]

    with pytest.raises(RedistTransferError, match="unit 2"):
        execute_fetches(plan, 2, _fetch, parallel=1)
    assert (1, 0) in calls and (1, 1) in calls


def test_execute_fetches_failover_succeeds_when_covered() -> None:
    plan = TransferPlan(ShardSpec(2, {0: [0, 1], 1: [0, 1]}),
                        ShardSpec(2, {2: [0, 1]}), [4, 4])

    def _fetch(holder, unit):
        if holder == 0:
            raise ConnectionError("holder 0 died")
        return [np.full(2, unit + 1, np.float32)]

    got, nbytes = execute_fetches(plan, 2, _fetch, parallel=2)
    assert sorted(got) == [0, 1] and nbytes == 16
    for u in (0, 1):
        assert got[u][0].tolist() == [u + 1.0, u + 1.0]


def test_execute_fetches_all_holders_dead_raises() -> None:
    plan = TransferPlan(ShardSpec(2, {0: [0, 1], 1: [0, 1]}),
                        ShardSpec(2, {2: [0, 1]}), [4, 4])

    def _fetch(holder, unit):
        raise ConnectionError(f"holder {holder} died")

    with pytest.raises(RedistTransferError, match="died mid-plan"):
        execute_fetches(plan, 2, _fetch, parallel=2)


# --------------------------------------------- cohort exchange (loopback)


def test_exchange_grow_counters_pin_moved_equals_lower(store) -> None:
    # w2 -> w3 over the planned exchange: moved == lower bound on every
    # rank, a redist_plan event each; bitwise with the allgather arm,
    # whose received bytes exceed the bound
    w2 = run_wrapper(store, 2, "g_w2", _TX["adam"], steps=2)
    carried = [w2[0][1], w2[1][1], None]
    planned = run_wrapper(store, 3, "g_w3p", _TX["adam"], steps=1,
                          carried=[copy.deepcopy(c) for c in carried])
    legacy = run_wrapper(store, 3, "g_w3l", _TX["adam"], steps=1,
                         carried=[copy.deepcopy(c) for c in carried],
                         redistribute="allgather")
    total = 0
    for rank in range(3):
        snap = planned[rank][2].metrics.snapshot()
        moved, lower = snap["redist_moved_bytes"], \
            snap["redist_lower_bound_bytes"]
        assert moved == lower
        total += moved
        plans = [e for e in planned[rank][2].events.since(0)[0]
                 if e["kind"] == "redist_plan"]
        assert plans and plans[0]["moved_bytes"] == int(moved)
        assert plans[0]["source"] == "reshard"
    assert total > 0
    excess = False
    for rank in range(3):
        snap = legacy[rank][2].metrics.snapshot()
        assert snap["redist_moved_bytes"] >= snap["redist_lower_bound_bytes"]
        excess |= snap["redist_moved_bytes"] > snap[
            "redist_lower_bound_bytes"]
    assert excess
    for rank in range(3):
        for k in _KEYS:
            assert planned[rank][0][k].tobytes() == \
                legacy[rank][0][k].tobytes()


@pytest.mark.parametrize("codec", ["none", "int8"])
def test_exchange_grow_bitwise_across_codecs(store, codec) -> None:
    # the exchange moves raw state bytes whatever the gradient codec
    w2 = run_wrapper(store, 2, f"cx_{codec}_w2", _TX["sgd"], steps=2,
                     codec=codec)
    carried = [w2[0][1], w2[1][1], None]
    planned = run_wrapper(store, 3, f"cx_{codec}_w3p", _TX["sgd"], steps=1,
                          codec=codec,
                          carried=[copy.deepcopy(c) for c in carried])
    legacy = run_wrapper(store, 3, f"cx_{codec}_w3l", _TX["sgd"], steps=1,
                         codec=codec, redistribute="allgather",
                         carried=[copy.deepcopy(c) for c in carried])
    for rank in range(3):
        for k in _KEYS:
            assert planned[rank][0][k].tobytes() == \
                legacy[rank][0][k].tobytes(), (codec, rank, k)


def test_exchange_grow_stateless_transform_no_livelock(store) -> None:
    # plain sgd: each leaf's state flattens to no array; the grow resolves
    # those units locally, at zero bytes, and nothing latches
    w2 = run_wrapper(store, 2, "sl_w2", _TX["plain_sgd"], steps=2)
    grown = run_wrapper(store, 3, "sl_w3", _TX["plain_sgd"], steps=1,
                        carried=[w2[0][1], w2[1][1], None])
    for params, state, mgr, opt in grown:
        assert mgr.errored() is None and state.held()
        snap = mgr.metrics.snapshot()
        assert snap["redist_moved_bytes"] == \
            snap["redist_lower_bound_bytes"] == 0.0
    for rank in (1, 2):
        for k in _KEYS:
            assert grown[rank][0][k].tobytes() == grown[0][0][k].tobytes()


def test_exchange_second_identical_transition_is_cache_hit(store) -> None:
    w2 = run_wrapper(store, 2, "c_w2", _TX["adam"], steps=2)
    carried = [w2[0][1], w2[1][1], None]
    planners = [RedistPlanner() for _ in range(3)]
    run_wrapper(store, 3, "c_w3a", _TX["adam"], steps=1, planners=planners,
                carried=[copy.deepcopy(c) for c in carried])
    assert all(p.builds == 1 for p in planners)
    run_wrapper(store, 3, "c_w3b", _TX["adam"], steps=1, planners=planners,
                carried=[copy.deepcopy(c) for c in carried])
    for p in planners:
        assert p.builds == 1 and p.hits >= 1


def test_exchange_dead_donor_mid_plan_never_partial_adopts(store) -> None:
    # a donor gone between publishing its address and serving fails the
    # receivers' plans whole (None, latched) while the collectives stay
    # matched
    from torchft_tpu_torch import checkpointing as ckpt

    real_serve = ckpt.serve_redist_payload

    def _dying_serve(units, timeout=60.0):
        addr, close = real_serve(units, timeout)
        close()
        return addr, (lambda: None)

    dst = ShardSpec(6, {0: [0, 1], 1: [2, 3], 2: [4, 5]})
    holdings = {0: {u: [np.full(3, 10 + u, np.float32)] for u in (0, 1, 2)},
                1: {u: [np.full(3, 10 + u, np.float32)] for u in (3, 4, 5)},
                2: {}}

    def _fn(mgr, rank):
        return ckpt.redistribute_exchange(mgr, rank, 3, dst, holdings[rank],
                                          RedistPlanner(), timeout=5.0), mgr

    try:
        ckpt.serve_redist_payload = _dying_serve
        res = run_stub_ranks(store.addr, "dd_x", 3, _fn,
                             lambda: TcpCommContext(timeout=15.0,
                                                    algorithm="star",
                                                    chunk_bytes=256))
    finally:
        ckpt.serve_redist_payload = real_serve
    r0, mgr0 = res[0]
    assert r0 is not None and r0.fetched == {} and r0.moved_bytes == 0
    assert mgr0.errored() is None
    for rank in (1, 2):
        result, mgr = res[rank]
        assert result is None and mgr.errored() is not None


def test_exchange_protocol_error_escalates_after_ack(store) -> None:
    # an HTTP protocol error (the holder answered wrongly) raises out of
    # the exchange after the ack barrier, never a silent retry
    dst = ShardSpec(2, {0: [0], 1: [1]})
    holdings = {0: {0: [np.ones(3, np.float32)], 1: [np.ones(3, np.float32)]},
                1: {}}

    class _SkewFetcher:
        def fetch(self, addr, unit):
            raise urllib.error.HTTPError(addr, 404, "not found", {},
                                         io.BytesIO(b""))

        def close(self):
            pass

    def _fn(mgr, rank):
        try:
            exchange(mgr, rank, 2, dst, holdings[rank], RedistPlanner(),
                     serve_fn=lambda units: ("http://127.0.0.1:9",
                                             lambda: None),
                     fetch_factory=_SkewFetcher)
            return "ok"
        except urllib.error.HTTPError:
            return "raised"

    res = run_stub_ranks(store.addr, "pe_x", 2, _fn,
                         lambda: TcpCommContext(timeout=15.0,
                                                algorithm="star",
                                                chunk_bytes=256))
    assert res == ["ok", "raised"]


def test_exchange_serves_device_tensors_lazily(store) -> None:
    # holdings may be tensors: their bytes stage when a receiver fetches
    dst = ShardSpec(2, {0: [0], 1: [1]})
    holdings = {0: {0: [torch.ones(3)], 1: [torch.arange(4.0),
                                            torch.tensor(2, dtype=torch.int32)]},
                1: {}}

    def _fn(mgr, rank):
        from torchft_tpu_torch.checkpointing import redistribute_exchange

        return redistribute_exchange(mgr, rank, 2, dst, holdings[rank],
                                     RedistPlanner(), timeout=10.0)

    res = run_stub_ranks(store.addr, "tens_x", 2, _fn,
                         lambda: TcpCommContext(timeout=15.0,
                                                algorithm="star"))
    got = res[1].fetched[1]
    assert got[0].tolist() == [0.0, 1.0, 2.0, 3.0]
    assert got[1].dtype == np.int32 and int(got[1]) == 2
    assert res[1].moved_bytes == res[1].lower_bound_bytes == 20


# ------------------------------------------------ fetch_opt_shard on plan


def test_fetch_opt_shard_stripes_and_counters(store) -> None:
    # duplicate donor coverage stripes the leaf fetches; moved == lower
    # bound; a second identical heal is a plan cache hit
    from torchft_tpu_torch.checkpointing import (
        CheckpointServer,
        fetch_opt_shard,
    )

    full = run_wrapper(store, 2, "fo_w2", _TX["adam"], sharded=False,
                       steps=2)
    helper = _helper()
    state = full[0][1]
    servers = []
    for _ in range(2):
        srv = CheckpointServer(timeout=10.0)
        srv.send_checkpoint([], 3, {"user": {"opt": helper.opt_state_dict(
            state)}, "torchft": {"step": 3}}, 10.0)
        servers.append(srv)
    donors = [s.metadata() for s in servers]
    try:
        needed = list(range(len(state.leaf_states)))
        metrics = Metrics()
        planner = RedistPlanner()
        events = WireStubManager(None, 1).events
        got = fetch_opt_shard(donors, 3, needed,
                              state_slots=helper.state_slots, timeout=10.0,
                              metrics=metrics, planner=planner,
                              events=events)
        assert sorted(got) == needed
        for i in needed:
            want = _state_tensors(state.leaf_states[i])
            for a, b in zip(got[i], want):
                assert a.tobytes() == b.numpy().tobytes()
        snap = metrics.snapshot()
        assert snap["redist_moved_bytes"] == \
            snap["redist_lower_bound_bytes"] > 0
        assert snap["heal_opt_bytes"] == snap["redist_moved_bytes"]
        assert planner.builds == 1
        plan = [e for e in events.since(0)[0] if e["kind"] == "redist_plan"]
        assert plan and plan[0]["source"] == "opt_shard_heal"
        fetch_opt_shard(donors, 3, needed, state_slots=helper.state_slots,
                        timeout=10.0, metrics=metrics, planner=planner)
        assert planner.builds == 1 and planner.hits == 1
    finally:
        for s in servers:
            s.shutdown(wait=False)


def test_heal_fetches_deferred_slots_through_fetch_opt_shard(store) -> None:
    # a CheckpointServer with defer_paths heals the slots it matches
    # through fetch_opt_shard (a redist_plan event at the lower bound) and
    # the rest through the chunked stream: the state comes back whole
    from torchft_tpu_torch.checkpointing import CheckpointServer
    from torchft_tpu_torch.examples.train_ddp import OPT_SLOTS_PATH_RE

    sh = run_wrapper(store, 2, "defer_w2", _TX["adam"], steps=1)
    helper = _helper()
    sd = {"user": {"params": {k: torch.from_numpy(v)
                              for k, v in sh[0][0].items()},
                   "opt": helper.opt_state_dict(sh[0][1])},
          "torchft": {"step": 1}}
    donor = CheckpointServer(timeout=10.0)
    healer = CheckpointServer(timeout=10.0, defer_paths=OPT_SLOTS_PATH_RE)
    healer.set_events(WireStubManager(None, 1).events)
    try:
        donor.send_checkpoint([], 1, sd, 10.0)
        got = healer.recv_checkpoint(0, donor.metadata(), 1, 10.0)
        for k, v in sh[0][0].items():
            assert got["user"]["params"][k].numpy().tobytes() == v.tobytes()
        for i, slots in enumerate(got["user"]["opt"]["slots"]):
            want = sd["user"]["opt"]["slots"][i]
            for a, b in zip(slots, want):
                b = b.numpy() if isinstance(b, torch.Tensor) else b
                assert np.asarray(a).tobytes() == b.tobytes()
        plans = [e for e in healer._events.since(0)[0]
                 if e["kind"] == "redist_plan"]
        assert plans and plans[0]["moved_bytes"] == \
            plans[0]["lower_bound_bytes"] > 0
        state = helper.load_opt_state_dict(got["user"]["opt"])
        assert state.held() == sh[0][1].held()
    finally:
        donor.shutdown()
        healer.shutdown()
