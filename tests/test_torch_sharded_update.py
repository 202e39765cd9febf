"""The port's sharded weight update against the JAX package's.

Twins of tests/test_sharded_update.py over the port's TCP wire (its XLA
arms cannot run here, R1; DiLoCo's ``sharded_outer`` twins live in
test_torch_local_sgd.py), driven through ``comm.wire_stub``:
the transport's reduce_scatter bitwise equal to its allreduce on owned
arrays, ``shard_ranges`` equal to the reference's, the shard grid's
rebuild event, ``ShardedOptimizerWrapper`` bitwise equal to its replicated
arm (``sharded=False``) at every codec, world and topology, the state
bytes divided by the world, reshards on a grow and a shrink, a healer's
multi-donor ``fetch_opt_shard`` (from port donors and from a JAX-package
donor, which proves the manifest path format), leaves matched across the
packages' manifests by path (their indices differ), and ``opt_state_dict``
round trips.

Tolerances: bitwise everywhere, except the port's per-leaf ``adamw``/
``adam``/``sgd`` against optax on the same numpy inputs (the updates at
rtol 1e-6, atol 1e-10, the parameters at rtol 1e-6, atol 1e-7: the same
f32 operations in the same order, but torch and XLA may contract
differently) and the wrapper's trajectory against the reference wrapper's
(rtol 1e-5, atol 1e-6, three steps). adamw is held at the example's
decay and at a large one, and the checks are shown to reject adam in its
place and decay applied before the Adam scaling.
"""

from concurrent.futures import Future, ThreadPoolExecutor

import numpy as np
import pytest
import torch

from torchft_tpu_torch.comm.context import (
    CommContext,
    DummyCommContext,
    ErrorSwallowingCommContext,
    ManagedCommContext,
    ReduceOp,
)
from torchft_tpu_torch.comm.store import StoreServer
from torchft_tpu_torch.comm.transport import TcpCommContext
from torchft_tpu_torch.comm.wire_stub import WireStubManager, run_stub_ranks
from torchft_tpu_torch.ddp import ShardedGradReducer, shard_ranges
from torchft_tpu_torch.optim import (
    ShardedOptimizerWrapper,
    ShardedOptState,
    _state_tensors,
    adam,
    adamw,
    sgd,
)

TIMEOUT = 30.0


@pytest.fixture()
def store():
    server = StoreServer()
    yield server
    server.shutdown()


def _run_world(store, world, prefix, fn, **ctx_kw):
    ctxs = [TcpCommContext(timeout=15.0, **ctx_kw) for _ in range(world)]
    results = [None] * world

    def _worker(rank):
        ctxs[rank].configure(f"{store.addr}/{prefix}", rank, world)
        results[rank] = fn(ctxs[rank], rank)

    with ThreadPoolExecutor(max_workers=world) as pool:
        for f in [pool.submit(_worker, r) for r in range(world)]:
            f.result(timeout=60)
    for ctx in ctxs:
        ctx.shutdown()
    return results


def _payloads(world, seed=5):
    rng = np.random.default_rng(seed)
    base = [rng.standard_normal(131).astype(np.float32)
            for _ in range(world)]
    return [[(a * (r + 2)).astype(np.float32) for a in base]
            for r in range(world)]


# ------------------------------------------------ transport reduce_scatter


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("algorithm", ["star", "ring"])
@pytest.mark.parametrize("codec", ["none", "bf16", "int8"])
def test_reduce_scatter_bitwise_vs_allreduce(store, world, algorithm,
                                             codec) -> None:
    # owned arrays after reduce_scatter == the allreduce there; 256-byte
    # chunks do not divide the 131-element arrays
    payloads = _payloads(world)
    owners = list(range(world))
    kw = dict(algorithm=algorithm, compression=codec, chunk_bytes=256,
              channels=2)

    def _ar(ctx, rank):
        return [a.copy() for a in ctx.allreduce(
            [a.copy() for a in payloads[rank]]).future().result(TIMEOUT)]

    def _rs(ctx, rank):
        out = ctx.reduce_scatter([a.copy() for a in payloads[rank]],
                                 owners=owners).future().result(TIMEOUT)
        return out[rank].copy()

    ref = _run_world(store, world, f"ar_{world}_{algorithm}_{codec}",
                     _ar, **kw)
    got = _run_world(store, world, f"rs_{world}_{algorithm}_{codec}",
                     _rs, **kw)
    for r in range(world):
        assert got[r].tobytes() == ref[0][r].tobytes(), (algorithm, codec)


def test_reduce_scatter_multi_array_owners_and_avg(store) -> None:
    rng = np.random.default_rng(11)
    arrays = [rng.standard_normal(40).astype(np.float32) for _ in range(4)]
    owners = [0, 1, 0, 1]

    def _rs(ctx, rank):
        out = ctx.reduce_scatter([a * (rank + 1) for a in arrays],
                                 op=ReduceOp.AVG,
                                 owners=owners).future().result(TIMEOUT)
        return [out[i].copy() for i, o in enumerate(owners) if o == rank]

    got = _run_world(store, 2, "rs_multi", _rs, algorithm="star",
                     chunk_bytes=64)
    for rank in range(2):
        expect = [(arrays[i] * 1 + arrays[i] * 2) / 2.0
                  for i, o in enumerate(owners) if o == rank]
        for g, e in zip(got[rank], expect):
            np.testing.assert_array_equal(g, e)


def test_reduce_scatter_owner_validation(store) -> None:
    def _bad(ctx, rank):
        work = ctx.reduce_scatter([np.ones(4, np.float32)], owners=[7])
        with pytest.raises(ValueError, match="owners"):
            work.future().result(TIMEOUT)
        return True

    assert all(_run_world(store, 2, "rs_bad", _bad))


def test_reduce_scatter_solo_identity(store) -> None:
    ctx = TcpCommContext(timeout=5.0)
    ctx.configure(f"{store.addr}/solo_rs", 0, 1)
    try:
        out = ctx.reduce_scatter([np.arange(5, dtype=np.float32)]) \
            .future().result(5)
        np.testing.assert_array_equal(out[0], np.arange(5, dtype=np.float32))
    finally:
        ctx.shutdown()


# ------------------------------------------------------------- shard grid


def test_shard_ranges_deterministic_and_balanced() -> None:
    from torchft_tpu.ddp import shard_ranges as ref_ranges

    sizes = [100, 3, 50, 200, 7, 90]
    dtypes = [np.dtype(np.float32)] * 6
    r4 = shard_ranges(sizes, dtypes, 4)
    assert r4 == shard_ranges(sizes, dtypes, 4)
    assert r4[0][0] == 0 and r4[-1][1] == 6
    for (_, b), (c, _) in zip(r4, r4[1:]):
        assert b == c
    assert len(shard_ranges(sizes, dtypes, 9)) == 6
    # equal to the reference's on the same inputs, torch dtypes included
    rng = np.random.default_rng(0)
    for world in (1, 2, 3, 4, 7):
        sizes = rng.integers(1, 500, 17).tolist()
        np_dt = [np.dtype(d) for d in rng.choice(["float32", "float64",
                                                  "float16"], 17)]
        torch_dt = [getattr(torch, d.name) for d in np_dt]
        assert shard_ranges(sizes, torch_dt, world) == \
            ref_ranges(sizes, np_dt, world) == \
            shard_ranges(sizes, np_dt, world)


def test_shard_grid_rebuild_event(store) -> None:
    # a new wire world builds the plan once and emits shard_grid_rebuild
    ctx = TcpCommContext(timeout=5.0)
    ctx.configure(f"{store.addr}/grid_ev", 0, 1)
    mgr = WireStubManager(ctx, 1)
    red = ShardedGradReducer(mgr)
    grads = [torch.ones(4, 4), torch.ones(3)]
    red.reduce(grads, sharded=True)
    red.reduce(grads, sharded=True)  # cached: no second event
    rebuilds = [e for e in mgr.events.since(0)[0]
                if e["kind"] == "shard_grid_rebuild"]
    assert len(rebuilds) == 1 and rebuilds[0]["new_world"] == 1
    with pytest.raises(ValueError, match="frozen"):
        red.reduce([torch.ones(5)], sharded=True)
    ctx.shutdown()


def test_managed_comm_context_allgather_lifted() -> None:
    from torchft_tpu_torch.comm.context import CompletedWork

    class _Mgr:
        def comm_backend(self):
            return "none"

        def allgather_arrays(self, arrays):
            return CompletedWork([list(arrays)])

        def num_participants(self):
            return 1

        def participating_rank(self):
            return 0

    out = ManagedCommContext(_Mgr()).allgather(
        [np.ones(2, np.float32)]).future().result()
    assert len(out) == 1 and len(out[0]) == 1


def test_dummy_and_swallowing_reduce_scatter() -> None:
    d = DummyCommContext()
    out = d.reduce_scatter([np.ones(3, np.float32)]).future().result()
    np.testing.assert_array_equal(out[0], np.ones(3, np.float32))
    sw = ErrorSwallowingCommContext(DummyCommContext())
    out = sw.reduce_scatter([np.ones(3, np.float32)]).future().result()
    np.testing.assert_array_equal(out[0], np.ones(3, np.float32))

    class _Legacy(CommContext):
        def configure(self, *a):
            pass

        def allreduce(self, arrays, op=ReduceOp.SUM, topology=None):
            raise NotImplementedError

    with pytest.raises(NotImplementedError, match="reduce_scatter"):
        _Legacy().reduce_scatter([np.ones(1, np.float32)])


# ----------------------------------------- the per-leaf update vs optax


# The example's adamw (lr 3e-4, decay 1e-4) moves a parameter by only
# 3e-8 |p| a step through its decay, below any parameter tolerance, so the
# updates themselves are compared, where decay is 1e-4 of the update, and
# a large decay (lr 1e-2, decay 0.1) puts it far above the tolerance.
_ADAMW_CASES = {"example": (3e-4, 1e-4), "large_decay": (1e-2, 0.1)}
_UPDATE_RTOL, _UPDATE_ATOL = 1e-6, 1e-10


def _optax_case(name):
    import optax

    if name.startswith("adamw_"):
        lr, wd = _ADAMW_CASES[name[len("adamw_"):]]
        return (adamw(lr, weight_decay=wd),
                optax.adamw(lr, weight_decay=wd))
    return {
        "adam": (adam(1e-2), optax.adam(1e-2)),
        "sgd_momentum": (sgd(0.1, momentum=0.9),
                         optax.sgd(0.1, momentum=0.9)),
        "sgd": (sgd(0.1), optax.sgd(0.1)),
    }[name]


def _hold_against_optax(port, ref, steps=5) -> None:
    # the updates at rtol 1e-6/atol 1e-10 and the parameters at
    # rtol 1e-6/atol 1e-7, every step, from the same numpy inputs
    import jax.numpy as jnp
    import optax

    rng = np.random.default_rng(3)
    p0 = rng.standard_normal((7, 5)).astype(np.float32)
    p_t, p_j = torch.from_numpy(p0.copy()), jnp.asarray(p0)
    s_t, s_j = port.init([p_t]), ref.init(p_j)
    for step in range(steps):
        g = rng.standard_normal((7, 5)).astype(np.float32)
        u_t, s_t = port.update([torch.from_numpy(g)], s_t, [p_t])
        u_j, s_j = ref.update(jnp.asarray(g), s_j, p_j)
        np.testing.assert_allclose(u_t[0].numpy(), np.asarray(u_j),
                                   rtol=_UPDATE_RTOL, atol=_UPDATE_ATOL,
                                   err_msg=f"update, step {step}")
        p_t = (p_t + u_t[0]).to(p_t.dtype)
        p_j = optax.apply_updates(p_j, u_j)
        np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j),
                                   rtol=1e-6, atol=1e-7,
                                   err_msg=f"params, step {step}")


@pytest.mark.parametrize("name", ["adamw_example", "adamw_large_decay",
                                  "adam", "sgd_momentum", "sgd"])
def test_per_leaf_update_matches_optax(name) -> None:
    # the port's functional transformation against optax's on the same
    # numpy inputs, five steps, state included
    _hold_against_optax(*_optax_case(name))


class _DecayBeforeScaling:
    """Decay folded into the gradient ahead of Adam's scaling (coupled L2,
    as ``torch.optim.Adam(weight_decay=)``): the order adamw must not use."""

    def __init__(self, lr, wd):
        self.inner, self.wd = adam(lr), wd

    def init(self, leaves):
        return self.inner.init(leaves)

    def update(self, grads, state, params):
        return self.inner.update(
            [g + self.wd * p for g, p in zip(grads, params)], state, params)


@pytest.mark.parametrize("case", sorted(_ADAMW_CASES))
@pytest.mark.parametrize("mutant", ["adam_for_adamw", "decay_before_scaling"])
def test_per_leaf_adamw_check_sees_the_decay(case, mutant) -> None:
    # the comparison above rejects adam in adamw's place and decay applied
    # before the Adam scaling, at the example's decay and at a large one
    import optax

    lr, wd = _ADAMW_CASES[case]
    wrong = (adam(lr) if mutant == "adam_for_adamw"
             else _DecayBeforeScaling(lr, wd))
    with pytest.raises(AssertionError, match="update, step 0"):
        _hold_against_optax(wrong, optax.adamw(lr, weight_decay=wd))


# ------------------------------------------------ the sharded wrapper


_KEYS = ("a", "b", "c")  # the reference flattens its dict in this order


def _make_params(seed=7):
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((13, 5)).astype(np.float32),
            "b": rng.standard_normal(31).astype(np.float32),
            "c": rng.standard_normal((3, 3)).astype(np.float32)}


def _grad_seq(params_np, world, steps, seed=13):
    return [[{k: (v * (0.1 * (s + 1)) * (r + 1)).astype(np.float32)
              for k, v in params_np.items()} for r in range(world)]
            for s in range(steps)]


_TX = {"sgd": lambda: sgd(0.1, momentum=0.9), "adam": lambda: adam(1e-2),
       "adamw": lambda: adamw(3e-4, weight_decay=1e-4),
       "plain_sgd": lambda: sgd(0.1)}


def _params(params_np):
    return [torch.nn.Parameter(torch.from_numpy(params_np[k].copy()))
            for k in _KEYS]


def run_wrapper(store, world, prefix, tx_fn, sharded=True, steps=3,
                codec="none", algorithm="star", params0=None, carried=None,
                redistribute="plan", planners=None, grad_seed=13):
    """Each rank's (params, state, stub, wrapper) after ``steps`` steps of
    the sharded wrapper; rank r resumes from ``carried[r]`` (None: fresh)."""
    params0 = _make_params() if params0 is None else params0
    gseq = _grad_seq(params0, world, steps, seed=grad_seed)

    def _fn(mgr, rank):
        params = _params(params0)
        opt = ShardedOptimizerWrapper(
            mgr, tx_fn(), params, sharded=sharded,
            redistribute=redistribute,
            planner=None if planners is None else planners[rank])
        if carried is not None and carried[rank] is not None:
            opt.state = carried[rank]
        for s in range(steps):
            mgr.start_quorum()
            for p, k in zip(params, _KEYS):
                p.grad = torch.from_numpy(gseq[s][rank][k].copy())
            assert opt.step()
        return ({k: p.detach().numpy().copy()
                 for k, p in zip(_KEYS, params)}, opt.state, mgr, opt)

    return run_stub_ranks(
        store.addr, prefix, world, _fn,
        lambda: TcpCommContext(timeout=15.0, algorithm=algorithm,
                               compression=codec, chunk_bytes=256,
                               channels=2))


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("algorithm", ["star", "ring"])
@pytest.mark.parametrize("codec", ["none", "bf16", "int8"])
@pytest.mark.parametrize("optname", ["sgd", "adam"])
def test_sharded_update_bitwise_oracle_host(store, world, algorithm, codec,
                                            optname) -> None:
    # allgather(sharded 1/N update) == the replicated arm bit for bit
    sh = run_wrapper(store, world, f"o_sh_{world}_{algorithm}_{codec}_"
                     f"{optname}", _TX[optname], True, codec=codec,
                     algorithm=algorithm)
    rp = run_wrapper(store, world, f"o_rp_{world}_{algorithm}_{codec}_"
                     f"{optname}", _TX[optname], False, codec=codec,
                     algorithm=algorithm)
    for r in range(world):
        for k in _KEYS:
            assert sh[r][0][k].tobytes() == rp[0][0][k].tobytes(), (r, k)
            assert sh[r][0][k].tobytes() == sh[0][0][k].tobytes()


@pytest.mark.parametrize("case", sorted(_ADAMW_CASES))
def test_sharded_update_matches_the_reference_wrapper(store, case) -> None:
    # the port's sharded wrapper against the JAX package's over its own
    # wire, the same inputs, optax.adamw: within rtol 1e-5 after 3 steps.
    # At the example's decay the decay term (3e-8 |p| a step) lies below
    # that tolerance, so the large decay (1e-3 |p| a step) is where the
    # wrapper's decay is checked, and there adam in its place fails.
    import jax.numpy as jnp
    import optax

    from torchft_tpu.comm import StoreServer as JaxStore
    from torchft_tpu.comm import TcpCommContext as JaxTcp
    from torchft_tpu.comm.wire_stub import run_stub_ranks as jax_ranks
    from torchft_tpu.optim import ShardedOptimizerWrapper as JaxWrapper

    lr, wd = _ADAMW_CASES[case]
    params0 = _make_params()
    gseq = _grad_seq(params0, 2, 3)

    def _ref(mgr, rank):
        opt = JaxWrapper(mgr, optax.adamw(lr, weight_decay=wd))
        params = {k: jnp.asarray(v) for k, v in params0.items()}
        state = opt.init(params)
        for s in range(3):
            mgr.start_quorum()
            params, state, ok = opt.step(params, state, gseq[s][rank])
            assert ok
        return {k: np.asarray(v) for k, v in params.items()}

    server = JaxStore()
    try:
        ref = jax_ranks(server.addr, f"ref_adamw_{case}", 2, _ref,
                        lambda: JaxTcp(timeout=15.0, algorithm="star",
                                       chunk_bytes=256))
    finally:
        server.shutdown()

    def _hold(got):
        for r in range(2):
            for k in _KEYS:
                np.testing.assert_allclose(got[r][0][k], ref[r][k],
                                           rtol=1e-5, atol=1e-6)

    _hold(run_wrapper(store, 2, f"port_adamw_{case}",
                      lambda: adamw(lr, weight_decay=wd), True))
    if case == "large_decay":
        with pytest.raises(AssertionError):
            _hold(run_wrapper(store, 2, "port_adam_for_adamw",
                              lambda: adam(lr), True))


def test_sharded_state_bytes_divide_by_world(store) -> None:
    # opt_state_bytes and opt_update_elems at world 4 are ~1/4 of the
    # replicated arm's, and the shards cover the state exactly
    world = 4
    rng = np.random.default_rng(21)
    params0 = {k: rng.standard_normal(24 + i).astype(np.float32)
               for i, k in enumerate(_KEYS)}
    many = {f"w{i:02d}": rng.standard_normal(24 + i).astype(np.float32)
            for i in range(16)}

    def run(sharded, prefix):
        keys = sorted(many)

        def _fn(mgr, rank):
            params = [torch.nn.Parameter(torch.from_numpy(many[k].copy()))
                      for k in keys]
            opt = ShardedOptimizerWrapper(mgr, adam(1e-2), params,
                                          sharded=sharded)
            for _ in range(2):
                mgr.start_quorum()
                for p in params:
                    p.grad = p.detach() * 0.1
                assert opt.step()
            return mgr.metrics.snapshot()

        return run_stub_ranks(store.addr, prefix, world, _fn,
                              lambda: TcpCommContext(timeout=15.0,
                                                     algorithm="star"))

    del params0
    sh, rp = run(True, "bytes_sh"), run(False, "bytes_rp")
    full_bytes, full_elems = rp[0]["opt_state_bytes"], \
        rp[0]["opt_update_elems"]
    assert full_bytes > 0 and full_elems > 0
    for snap in sh:
        assert snap["opt_state_bytes"] <= full_bytes / world * 1.5
        assert snap["opt_update_elems"] <= full_elems / world * 1.5
    assert sum(s["opt_state_bytes"] for s in sh) == pytest.approx(full_bytes)


# ------------------------------------------------------- reshard exchange


def _continue_replicated(store, prefix, params_np, state, world, steps=1):
    """The replicated arm continued from a carried state: the oracle."""
    import copy

    def _fn(mgr, rank):
        params = _params(params_np)
        opt = ShardedOptimizerWrapper(mgr, adam(1e-2), params,
                                      sharded=False)
        opt.state = copy.deepcopy(state)
        gseq = _grad_seq(params_np, world, steps, seed=29)
        for s in range(steps):
            mgr.start_quorum()
            for p, k in zip(params, _KEYS):
                p.grad = torch.from_numpy(gseq[s][rank][k].copy())
            assert opt.step()
        return ({k: p.detach().numpy().copy()
                 for k, p in zip(_KEYS, params)}, opt.state)

    return run_stub_ranks(store.addr, prefix, world, _fn,
                          lambda: TcpCommContext(timeout=15.0,
                                                 algorithm="star",
                                                 chunk_bytes=256))[0]


def _continue_sharded(store, prefix, params_by_rank, states, world,
                      steps=1):
    import copy

    def _fn(mgr, rank):
        params = _params(params_by_rank[rank % len(params_by_rank)])
        opt = ShardedOptimizerWrapper(mgr, adam(1e-2), params, sharded=True)
        if rank < len(states) and states[rank] is not None:
            opt.state = copy.deepcopy(states[rank])
        gseq = _grad_seq(params_by_rank[0], world, steps, seed=29)
        for s in range(steps):
            mgr.start_quorum()
            for p, k in zip(params, _KEYS):
                p.grad = torch.from_numpy(gseq[s][rank][k].copy())
            opt.step()
        return ({k: p.detach().numpy().copy()
                 for k, p in zip(_KEYS, params)}, opt.state, mgr)

    return run_stub_ranks(store.addr, prefix, world, _fn,
                          lambda: TcpCommContext(timeout=15.0,
                                                 algorithm="star",
                                                 chunk_bytes=256))


def _state_bytes_equal(a, b) -> bool:
    ta = [t for k in ("count", "mu", "nu") for t in
          ([a[k]] if k == "count" else a[k])]
    tb = [t for k in ("count", "mu", "nu") for t in
          ([b[k]] if k == "count" else b[k])]
    return all(x.numpy().tobytes() == y.numpy().tobytes()
               for x, y in zip(ta, tb))


def test_reshard_grow_w2_to_w3_bitwise(store) -> None:
    # w2 -> w3: the survivors' states cover every leaf, so each rank's new
    # shard equals the replicated arm's states bitwise, the joiner's too
    sh2 = run_wrapper(store, 2, "grow_sh2", _TX["adam"], True)
    rp2 = run_wrapper(store, 2, "grow_rp2", _TX["adam"], False)
    res = _continue_sharded(store, "grow_w3",
                            [sh2[0][0], sh2[1][0], sh2[0][0]],
                            [sh2[0][1], sh2[1][1], None], 3)
    rp3 = _continue_replicated(store, "grow_rp3", rp2[0][0], rp2[0][1], 3)
    for r in range(3):
        params, state, mgr = res[r]
        for k in _KEYS:
            assert params[k].tobytes() == rp3[0][k].tobytes(), (r, k)
        for i in state.held():
            assert _state_bytes_equal(state.leaf_states[i],
                                      rp3[1].leaf_states[i])
        resh = [e for e in mgr.events.since(0)[0] if e["kind"] == "reshard"]
        assert resh and resh[0]["new_world"] == 3
        assert resh[0]["reinit_leaves"] == 0


def test_reshard_shrink_w3_to_w2_reinit_accounted(store) -> None:
    # rank 2 died with its shard: the survivors rebuild what they can and
    # reinitialize exactly its leaves, visibly, and keep committing
    sh3 = run_wrapper(store, 3, "shrink_sh3", _TX["adam"], True)
    lost = set(sh3[2][1].held())
    assert lost
    res = _continue_sharded(store, "shrink_w2", [sh3[0][0], sh3[1][0]],
                            [sh3[0][1], sh3[1][1]], 2)
    reinit = 0
    for params, state, mgr in res:
        resh = [e for e in mgr.events.since(0)[0] if e["kind"] == "reshard"]
        assert resh and resh[0]["new_world"] == 2
        reinit += resh[0]["reinit_leaves"]
        assert state.held()
    assert reinit == len(lost)
    for k in _KEYS:
        assert res[0][0][k].tobytes() == res[1][0][k].tobytes()


# ------------------------------------ shard-spec-aware heal (multi-donor)


def _shard_of(full_state, ranges, rank, n_leaves):
    lo, hi = ranges[rank]
    return ShardedOptState(
        n_leaves, world_size=len(ranges), rank=rank, ranges=ranges,
        leaf_states=[full_state.leaf_states[i] if lo <= i < hi else None
                     for i in range(n_leaves)], wire_gen=None)


def _helper():
    return ShardedOptimizerWrapper(WireStubManager(DummyCommContext(), 1),
                                   adam(1e-2), _params(_make_params()))


def test_reshard_on_heal_multi_donor_intersection(store) -> None:
    # a healer joining a w2 cohort rebuilds its shard from three w3
    # donors' checkpoints, bitwise, and fails over a dead donor to a
    # fourth holding a w2 shard
    from torchft_tpu_torch.checkpointing import (
        CheckpointServer,
        fetch_opt_shard,
    )

    sh3 = run_wrapper(store, 3, "heal_sh3", _TX["adam"], True)
    rp = run_wrapper(store, 3, "heal_rp3", _TX["adam"], False)
    helper = _helper()
    servers = []
    for r in range(3):
        srv = CheckpointServer(timeout=10.0)
        srv.send_checkpoint([], 7, {
            "user": {"opt": helper.opt_state_dict(sh3[r][1])},
            "torchft": {"step": 7}}, 10.0)
        servers.append(srv)
    donors = [s.metadata() for s in servers]
    try:
        k = helper.state_slots
        n_leaves = len(sh3[0][1].leaf_states)
        w2 = shard_ranges([65, 31, 9], [np.dtype(np.float32)] * 3, 2)
        needed = list(range(*w2[1]))
        got = fetch_opt_shard(donors, 7, needed, state_slots=k, timeout=10.0)
        assert sorted(got) == needed
        for i in needed:
            want = _state_tensors(rp[0][1].leaf_states[i])
            for a, b in zip(got[i], want):
                assert a.tobytes() == b.numpy().tobytes()
        owner3 = next(r for r, (a, b) in enumerate(sh3[0][1].ranges)
                      if a <= needed[0] < b)
        extra = CheckpointServer(timeout=10.0)
        extra.send_checkpoint([], 7, {
            "user": {"opt": helper.opt_state_dict(
                _shard_of(rp[0][1], w2, 1, n_leaves))},
            "torchft": {"step": 7}}, 10.0)
        servers.append(extra)
        servers[owner3].shutdown(wait=False)
        got2 = fetch_opt_shard(donors + [extra.metadata()], 7, needed,
                               state_slots=k, timeout=5.0)
        for i in needed:
            want = _state_tensors(rp[0][1].leaf_states[i])
            for a, b in zip(got2[i], want):
                assert a.tobytes() == b.numpy().tobytes()
    finally:
        for s in servers:
            s.shutdown(wait=False)


def test_port_healer_fetches_from_a_reference_donor(store) -> None:
    # the manifest path format across packages: the JAX package's donor
    # serves its sharded wrapper's checkpoint (its manifest pickles a jax
    # tree structure and sorts dict keys), and the port's fetch_opt_shard
    # finds every slot by path and fetches the shard bitwise
    import jax
    import jax.numpy as jnp
    import optax

    from torchft_tpu.checkpointing import CheckpointServer as JaxServer
    from torchft_tpu.comm import StoreServer as JaxStore
    from torchft_tpu.comm import TcpCommContext as JaxTcp
    from torchft_tpu.comm.wire_stub import run_stub_ranks as jax_ranks
    from torchft_tpu.optim import ShardedOptimizerWrapper as JaxWrapper
    from torchft_tpu_torch.checkpointing import fetch_manifest, \
        fetch_opt_shard

    params0 = _make_params()
    gseq = _grad_seq(params0, 2, 2)

    def _ref(mgr, rank):
        opt = JaxWrapper(mgr, optax.adam(1e-2))
        params = {k: jnp.asarray(v) for k, v in params0.items()}
        state = opt.init(params)
        for s in range(2):
            mgr.start_quorum()
            params, state, _ = opt.step(params, state, gseq[s][rank])
        return opt, state

    server = JaxStore()
    try:
        ref = jax_ranks(server.addr, "ref_donors", 2, _ref,
                        lambda: JaxTcp(timeout=15.0, algorithm="star"))
    finally:
        server.shutdown()
    donors = []
    try:
        for opt, state in ref:
            srv = JaxServer(timeout=10.0)
            # keys the reference sorts: "opt" before "params"
            srv.allow_checkpoint(4, {
                "user": {"params": {k: np.asarray(v)
                                    for k, v in params0.items()},
                         "opt": opt.opt_state_dict(state)},
                "torchft": {"step": 4}})
            donors.append(srv)
        addrs = [s.metadata() for s in donors]
        manifest = fetch_manifest(addrs[0], 4)
        paths = [e["path"] for e in manifest["leaves"]]
        assert paths[0].startswith("['torchft']") or \
            paths[0].startswith("['user']['opt']")
        assert "['user']['opt']['slots'][0][1]" in paths
        got = fetch_opt_shard(addrs, 4, [0, 1, 2], state_slots=3,
                              timeout=10.0)
        for i in range(3):
            holder = next(s for _, s in ref if s.leaf_states[i] is not None)
            want = jax.tree_util.tree_leaves(holder.leaf_states[i])
            for a, b in zip(got[i], want):
                assert a.tobytes() == np.asarray(b).tobytes()
        # the port wrapper adopts the fetched slots as its state
        helper = _helper()
        state = helper._unflatten_state(got[0], 0)
        assert int(state["count"]) == 2
    finally:
        for s in donors:
            s.shutdown(wait=False)


def test_opt_state_dict_roundtrip_and_heal_bytes() -> None:
    # the state dict carries only the held shard, in a fixed structure;
    # a load restores it bitwise and gauges heal_opt_bytes
    mgr = WireStubManager(DummyCommContext(), 1)
    params = _params(_make_params())
    opt = ShardedOptimizerWrapper(mgr, adam(1e-2), params, sharded=True)
    mgr.start_quorum()
    for p in params:
        p.grad = p.detach() * 0.1
    assert opt.step()
    sd = opt.opt_state_dict()
    assert len(sd["slots"]) == len(opt.state.leaf_states)
    before = opt.state
    restored = opt.load_opt_state_dict(sd)
    assert restored.held() == before.held() and opt.state is restored
    for i in before.held():
        assert _state_bytes_equal(restored.leaf_states[i],
                                  before.leaf_states[i])
    assert mgr.metrics.snapshot()["heal_opt_bytes"] > 0


def test_sharded_wrapper_discards_and_validates() -> None:
    # a latched error discards the step and leaves parameters and state
    # alone; redistribute is validated
    mgr = WireStubManager(DummyCommContext(), 1)
    params = _params(_make_params())
    opt = ShardedOptimizerWrapper(mgr, adam(1e-2), params)
    mgr.start_quorum()
    before = [p.detach().clone() for p in params]
    for p in params:
        p.grad = torch.ones_like(p)
    mgr.report_error(RuntimeError("discard"))
    assert not opt.step()
    assert all(torch.equal(a, b) for a, b in zip(before, params))
    assert opt.state.held() == []
    with pytest.raises(ValueError, match="redistribute"):
        ShardedOptimizerWrapper(mgr, adam(1e-2), params,
                                redistribute="broadcast")
    # a future of gradients is resolved first
    mgr.start_quorum()
    fut: Future = Future()
    fut.set_result([torch.ones_like(p) for p in params])
    assert opt.step(fut)
    assert not torch.equal(before[0], params[0].detach())


def test_manifest_paths_match_across_packages_not_indices() -> None:
    # the same state served by each package: the manifests list the same
    # leaves under the same key-string paths, of the same kinds and in the
    # same order (both flatten with jax.tree_util's rules: dict keys
    # sorted), and a leaf fetched by path is the same bytes from either
    # donor
    from torchft_tpu.checkpointing import CheckpointServer as JaxServer
    from torchft_tpu_torch.checkpointing import (
        CheckpointServer,
        fetch_leaf,
        fetch_manifest,
    )

    rng = np.random.default_rng(1)
    arrays = {k: rng.standard_normal(5 + i).astype(np.float32)
              for i, k in enumerate(("zeta", "alpha", "mid"))}
    state = {"user": {"train": {"opt": {"slots": [[arrays["zeta"]],
                                                  [arrays["alpha"]]]},
                                "params": {"zeta": arrays["zeta"],
                                           "alpha": arrays["alpha"],
                                           "mid": arrays["mid"]}}},
             "torchft": {"step": 3}}
    port, ref = CheckpointServer(timeout=10.0), JaxServer(timeout=10.0)
    try:
        port.send_checkpoint([], 3, state, 10.0)
        ref.allow_checkpoint(3, state)
        mp = fetch_manifest(port.metadata(), 3)["leaves"]
        mr = fetch_manifest(ref.metadata(), 3)["leaves"]
        port_paths = [e["path"] for e in mp]
        ref_paths = [e["path"] for e in mr]
        assert port_paths == ref_paths
        assert [e["kind"] for e in mp] == [e["kind"] for e in mr]
        assert "['user']['train']['params']['zeta']" in port_paths
        assert [e["pieces"] for e in mp if e["kind"] == "ndarray"] == \
            [e["pieces"] for e in mr if e["kind"] == "ndarray"]
        for path in (e["path"] for e in mp if e["kind"] == "ndarray"):
            a = fetch_leaf(port.metadata(), 3, port_paths.index(path))
            b = fetch_leaf(ref.metadata(), 3, ref_paths.index(path))
            assert np.asarray(a).tobytes() == np.asarray(b).tobytes(), path
    finally:
        port.shutdown()
        ref.shutdown(wait=False)


# ------------------------------------------- bfloat16 through the reducer


def _bf16_grads(world, seed=17):
    """Per rank a gradient list as the JAX package takes it (ml_dtypes'
    bfloat16 arrays, one float32 leaf between them, so the buckets group
    by dtype) and as the port takes it (torch tensors of the same bits)."""
    import ml_dtypes

    rng = np.random.default_rng(seed)
    shapes = [(33, 7), (129,), (5, 4, 3), (64,), (2, 300)]
    ref = []
    for rank in range(world):
        leaves = [(rng.standard_normal(s) * (rank + 1)).astype(
            ml_dtypes.bfloat16) for s in shapes]
        leaves[3] = leaves[3].astype(np.float32)
        ref.append(leaves)
    port = [[torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
             if a.dtype.name == "bfloat16" else torch.from_numpy(a.copy())
             for a in leaves] for leaves in ref]
    return ref, port


def _reference_reducer_pkg():
    from types import SimpleNamespace

    from torchft_tpu.comm.store import StoreServer as RefStore
    from torchft_tpu.comm.transport import TcpCommContext as RefTcp
    from torchft_tpu.control import Lighthouse as RefLighthouse
    from torchft_tpu.ddp import ShardedGradReducer as RefReducer
    from torchft_tpu.manager import Manager as RefManager

    return SimpleNamespace(Lighthouse=RefLighthouse, StoreServer=RefStore,
                           TcpCommContext=RefTcp, Manager=RefManager,
                           ShardedGradReducer=RefReducer)


@pytest.mark.parametrize("world", [1, 2, 3])
@pytest.mark.parametrize("sharded", [True, False])
def test_bf16_gradients_reduce_bitwise_as_the_reference(world,
                                                        sharded) -> None:
    # F22's rest: the port's ShardedGradReducer stages and returns
    # bfloat16 gradients (ml_dtypes' bfloat16 host arrays, as the
    # reference's), each wire rank's leaves bitwise the reference
    # reducer's on the same values under real Managers (the AVG scaling
    # included); the sharded arm's owned leaves are the replicated arm's
    import importlib.util
    import os

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    ref_grads, port_grads = _bf16_grads(world)
    port = smoke.reduce_sharded(port_grads, sharded, timeout=20.0)
    ref = smoke.reduce_sharded(ref_grads, sharded,
                               pkg=_reference_reducer_pkg(), timeout=20.0)
    n = len(ref_grads[0])
    for rank in range(world):
        assert sorted(port[rank]) == sorted(ref[rank])
        for i, a in port[rank].items():
            assert a.dtype == ref[rank][i].dtype, (i, a.dtype)
            assert smoke.same_bits(a, ref[rank][i]), (rank, i)
    if sharded:
        assert sorted(i for p in port for i in p) == list(range(n))
        full = smoke.reduce_sharded(port_grads, False, timeout=20.0)
        for rank, owned in enumerate(port):
            for i, a in owned.items():
                assert smoke.same_bits(a, full[rank][i])
    else:
        assert all(sorted(p) == list(range(n)) for p in port)
    assert {a.dtype.name for p in port for a in p.values()} == \
        {"bfloat16", "float32"}


def test_sharded_wrapper_steps_bf16_params(store) -> None:
    # F26: ShardedOptimizerWrapper steps bfloat16 parameters: the reduced
    # bf16 leaves reach the update and the allgather through the host
    # views, the sharded arm is the replicated arm bit for bit, and both
    # hold against the reference wrapper on the same bf16 values within
    # one bf16 ulp (torch rounds lr * g to bf16 before the subtraction,
    # XLA may fuse the two)
    import jax.numpy as jnp
    import ml_dtypes
    import optax

    from torchft_tpu.comm import StoreServer as JaxStore
    from torchft_tpu.comm import TcpCommContext as JaxTcp
    from torchft_tpu.comm.wire_stub import run_stub_ranks as jax_ranks
    from torchft_tpu.optim import ShardedOptimizerWrapper as JaxWrapper

    bf16 = ml_dtypes.bfloat16
    params0 = {k: v.astype(bf16) for k, v in _make_params().items()}
    gseq = [[{k: v.astype(bf16) for k, v in g.items()} for g in step]
            for step in _grad_seq(_make_params(), 2, 2)]

    def tensor(a):
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)

    def _port(sharded):
        def _fn(mgr, rank):
            params = [torch.nn.Parameter(tensor(params0[k])) for k in _KEYS]
            opt = ShardedOptimizerWrapper(mgr, sgd(0.1), params,
                                          sharded=sharded)
            for s in range(2):
                mgr.start_quorum()
                for p, k in zip(params, _KEYS):
                    p.grad = tensor(gseq[s][rank][k])
                assert opt.step()
            assert all(p.dtype == torch.bfloat16 for p in params)
            return {k: p.detach().view(torch.int16).numpy().view(bf16).copy()
                    for k, p in zip(_KEYS, params)}

        return run_stub_ranks(store.addr, f"bf16_wrap_{sharded}", 2, _fn,
                              lambda: TcpCommContext(timeout=15.0,
                                                     chunk_bytes=256))

    def _ref(mgr, rank):
        opt = JaxWrapper(mgr, optax.sgd(0.1))
        params = {k: jnp.asarray(v) for k, v in params0.items()}
        state = opt.init(params)
        for s in range(2):
            mgr.start_quorum()
            params, state, ok = opt.step(params, state, gseq[s][rank])
            assert ok
        return {k: np.asarray(v) for k, v in params.items()}

    server = JaxStore()
    try:
        ref = jax_ranks(server.addr, "bf16_wrap_ref", 2, _ref,
                        lambda: JaxTcp(timeout=15.0, chunk_bytes=256))
    finally:
        server.shutdown()
    sh, rp = _port(True), _port(False)
    for r in range(2):
        for k in _KEYS:
            assert sh[r][k].tobytes() == rp[r][k].tobytes() == \
                sh[0][k].tobytes(), (r, k)
            assert ref[r][k].dtype == bf16
            np.testing.assert_allclose(sh[r][k].astype(np.float32),
                                       ref[r][k].astype(np.float32),
                                       rtol=2.0 ** -8, atol=0)
