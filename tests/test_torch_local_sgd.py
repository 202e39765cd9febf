"""The port's LocalSGD/DiLoCo streaming fragment scheduler against the JAX
package's (twins of tests/test_localsgd_streaming.py).

Cross-package: the same seeded inputs go through the JAX package's
``LocalSGD`` over its ``TcpCommContext`` and the port's over
``CudaCommContext`` on the CPU, at codecs none/bf16/int8 on star (world 2)
and ring (world 3): committed parameters and error-feedback residuals must
be bitwise equal. DiLoCo's averaged pseudogradients are bitwise equal to
the reference's; its outer-updated parameters and outer states lie within
``OUTER_TOL`` of optax's. Within the port, streaming and blocking rounds
are bitwise equal at every codec, a mid-round abort rolls every fragment
back bitwise, and a heal at the fence re-reads ``params_fn``.

``sharded_outer=True`` (twins of test_sharded_update.py's and
test_redistribute.py's DiLoCo tests): bitwise the replicated arm at world 3
over codecs none/int8, 1 and 3 fragments and both schedules, each rank
holding exactly the fragments ``f % world == rank``; LocalSGD's sharded arm
bitwise the reference's; DiLoCo's within ``OUTER_TOL`` of the reference's,
its state_dict's leaves in the reference's order; a grow fetches an
arriving fragment's momentum from its live holder (moved == lower bound >
0, bitwise a carried copy), a shrink reinitializes only an uncovered
fragment, and an aborted sharded round leaves parameters and owned outer
states bitwise as they were. Every stub is ``comm.wire_stub``'s.
"""

import copy
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torchft_tpu.comm import StoreServer as JaxStoreServer
from torchft_tpu.comm import TcpCommContext as JaxTcp
from torchft_tpu.comm.topology import DomainTopology as JaxTopology
from torchft_tpu.comm.wire import split_weighted as jax_split_weighted
from torchft_tpu.comm.wire_stub import WireStubManager as JaxWireStub
from torchft_tpu.local_sgd import DiLoCo as JaxDiLoCo
from torchft_tpu.local_sgd import LocalSGD as JaxLocalSGD
from torchft_tpu.local_sgd import fragment_boundaries as jax_boundaries
from torchft_tpu_torch import optim as outer
from torchft_tpu_torch.comm.context import (
    CompletedWork,
    DummyCommContext,
    ReduceOp,
    Work,
)
from torchft_tpu_torch.comm.cuda_backend import CudaCommContext, DevicePool
from torchft_tpu_torch.comm.store import StoreServer
from torchft_tpu_torch.comm.topology import DomainTopology
from torchft_tpu_torch.comm.transport import TcpCommContext
from torchft_tpu_torch.comm.wire import split_weighted
from torchft_tpu_torch.comm.wire_stub import WireStubManager, run_stub_ranks
from torchft_tpu_torch.examples.train_diloco import _tree_equal
from torchft_tpu_torch.futures import future_chain
from torchft_tpu_torch.local_sgd import (
    DiLoCo,
    LocalSGD,
    _outer_executor,
    fragment_boundaries,
    from_jax_state,
)

# DiLoCo's outer step against optax's (the same order of operations; the
# compilers may contract a multiply-add differently)
OUTER_TOL = dict(rtol=1e-6, atol=1e-7)

_KEYS = ("a", "b", "c", "d", "e")  # jax.tree_util's (sorted) leaf order


def _params0_np():
    """Uneven leaf sizes, so the byte-balanced grid splits mid-tree."""
    rng = np.random.default_rng(7)
    return {
        "a": rng.standard_normal(96).astype(np.float32),
        "b": rng.standard_normal((8, 8)).astype(np.float32),
        "c": rng.standard_normal(160).astype(np.float32),
        "d": rng.standard_normal(32).astype(np.float32),
        "e": rng.standard_normal(48).astype(np.float32),
    }


def _port_params(tree=None):
    tree = _params0_np() if tree is None else tree
    return [torch.from_numpy(np.array(tree[k])) for k in _KEYS]


def _jax_params(tree=None):
    tree = _params0_np() if tree is None else tree
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _increments(rank, steps):
    """Per-(rank, step) inner updates, drawn once so every arm of both
    packages replays the same inner trajectory."""
    rng = np.random.default_rng(1000 + rank)
    base = _params0_np()
    return [{k: (rng.standard_normal(v.shape) * 0.1).astype(np.float32)
             for k, v in base.items()} for _ in range(steps)]


def _snap_port(params):
    return {k: p.numpy().copy() for k, p in zip(_KEYS, params)}


def _snap_jax(params):
    return {k: np.asarray(params[k]).copy() for k in _KEYS}


class _PortWireStub(WireStubManager):
    """The port's ``WireStubManager`` keeping a copy of every averaged
    array (``reduced``)."""

    def __init__(self, ctx, world):
        super().__init__(ctx, world)
        self.reduced = []

    def allreduce_arrays(self, arrays, op=ReduceOp.SUM, topology=None):
        work = super().allreduce_arrays(arrays, op, topology)
        return Work(future_chain(
            work.future(),
            lambda f: [self.reduced.append(a.copy()) or a
                       for a in f.result()]))


class _RecordingJaxStub(JaxWireStub):
    def __init__(self, ctx, world):
        super().__init__(ctx, world)
        self.reduced = []

    def allreduce_arrays(self, arrays, op=ReduceOp.SUM, topology=None):
        work = super().allreduce_arrays(arrays, op, topology)
        return Work(future_chain(
            work.future(),
            lambda f: [self.reduced.append(a.copy()) or a
                       for a in f.result()]))


class _LocalStubManager(WireStubManager):
    """The shared stub over an identity wire (``DummyCommContext``, world
    1) with the reference test's hooks: a failed op latches and its future
    resolves to its inputs, as the Manager's does (``fail_at_op``), and
    the next fence reports a heal (``heal_next_fence``)."""

    def __init__(self, fail_at_op=None):
        super().__init__(DummyCommContext(), 1)
        self._ops = 0
        self.fail_at_op = fail_at_op
        self.heal_next_fence = False
        self._did_heal = False

    def start_quorum(self, **kw):
        super().start_quorum(**kw)
        self._did_heal = False

    def quorum_fence(self):
        if self.heal_next_fence:
            self._did_heal = True
            self.heal_next_fence = False

    def did_heal(self):
        return self._did_heal

    def allreduce_arrays(self, arrays, op=ReduceOp.SUM, topology=None):
        self._ops += 1
        if self._error is not None:
            return CompletedWork([np.asarray(a) for a in arrays])
        if self.fail_at_op is not None and self._ops == self.fail_at_op:
            self.report_error(RuntimeError("injected outer-sync fault"))
            return CompletedWork([np.asarray(a) for a in arrays])
        return CompletedWork([np.array(a, copy=True) for a in arrays])


# ------------------------------------------------------------- the arms


def _port_arm(prefix, algorithm, world, codec, fragments, streaming,
              rounds=2, sync_every=4, outer_tx=None, sharded_outer=False):
    """``rounds`` rounds over the port's on-device plane on the CPU; per
    rank: the committed parameters of each round, the final EF residuals,
    the stub (its averaged arrays) and the wrapper."""
    pool = DevicePool("cpu")
    ctxs = [CudaCommContext(timeout=15.0, algorithm=algorithm,
                            compression=codec, chunk_bytes=256,
                            device_pool=pool) for _ in range(world)]
    outs = [None] * world
    steps = rounds * sync_every

    def worker(rank):
        ctxs[rank].configure(f"localsgd://{prefix}", rank, world)
        manager = _PortWireStub(ctxs[rank], world)
        if outer_tx is not None:
            wrapper = DiLoCo(manager, outer_tx(), sync_every=sync_every,
                             num_fragments=fragments, streaming=streaming,
                             sharded_outer=sharded_outer)
        else:
            wrapper = LocalSGD(manager, sync_every=sync_every,
                               num_fragments=fragments, streaming=streaming,
                               sharded_outer=sharded_outer)
        params = _port_params()
        wrapper.register(params)
        incs = _increments(rank, steps)
        per_round = []
        for t in range(steps):
            for k, p in zip(_KEYS, params):
                p.add_(torch.from_numpy(incs[t][k]))
            wrapper.step()
            if wrapper.local_step == 0:
                per_round.append(_snap_port(params))
        residuals = (None if wrapper._ef_residuals is None
                     else [r.copy() for r in wrapper._ef_residuals])
        outs[rank] = (per_round, residuals, manager, wrapper)

    try:
        with ThreadPoolExecutor(max_workers=world) as ex:
            for f in [ex.submit(worker, r) for r in range(world)]:
                f.result(timeout=120)
    finally:
        for c in ctxs:
            c.shutdown()
    return outs


def _jax_arm(store, prefix, algorithm, world, codec, fragments, streaming,
             rounds=2, sync_every=4, outer_tx=None, sharded_outer=False):
    """The same rounds through the JAX package over its TcpCommContext."""
    ctxs = [JaxTcp(timeout=15.0, algorithm=algorithm, channels=2,
                   compression=codec, chunk_bytes=256) for _ in range(world)]
    outs = [None] * world
    steps = rounds * sync_every

    def worker(rank):
        ctxs[rank].configure(f"{store.addr}/{prefix}", rank, world)
        manager = _RecordingJaxStub(ctxs[rank], world)
        if outer_tx is not None:
            wrapper = JaxDiLoCo(manager, outer_tx(), sync_every=sync_every,
                                num_fragments=fragments, streaming=streaming,
                                sharded_outer=sharded_outer)
        else:
            wrapper = JaxLocalSGD(manager, sync_every=sync_every,
                                  num_fragments=fragments,
                                  streaming=streaming,
                                  sharded_outer=sharded_outer)
        params = wrapper.register(_jax_params())
        incs = _increments(rank, steps)
        per_round = []
        for t in range(steps):
            params = {k: params[k] + incs[t][k] for k in params}
            params = wrapper.step(params)
            if wrapper.local_step == 0:
                per_round.append(_snap_jax(params))
        residuals = (None if wrapper._ef_residuals is None
                     else [r.copy() for r in wrapper._ef_residuals])
        outs[rank] = (per_round, residuals, manager, wrapper)

    try:
        with ThreadPoolExecutor(max_workers=world) as ex:
            for f in [ex.submit(worker, r) for r in range(world)]:
                f.result(timeout=120)
    finally:
        for c in ctxs:
            c.shutdown()
    return outs


@pytest.fixture()
def jax_store():
    server = JaxStoreServer()
    yield server
    server.shutdown()


def _assert_rounds_equal(got, want, what):
    assert len(got) == len(want), what
    for t, (g, w) in enumerate(zip(got, want)):
        for k in w:
            assert g[k].tobytes() == w[k].tobytes(), (
                f"{what}: round {t}, leaf {k!r}")


# --------------------------------------------- cross-package, bitwise


@pytest.mark.parametrize("algorithm,world", [("star", 2), ("ring", 3)])
@pytest.mark.parametrize("codec", ["none", "bf16", "int8"])
def test_localsgd_bitwise_equals_reference(jax_store, algorithm, world,
                                           codec) -> None:
    # EF "auto" engages exactly where the reference's does (star peers
    # under a lossy codec): the residual arenas must match bit for bit too
    for fragments in (1, 2, 4):
        tag = f"{algorithm}_{codec}_f{fragments}"
        port = _port_arm(tag, algorithm, world, codec, fragments, True)
        ref = _jax_arm(jax_store, f"x_{tag}", algorithm, world, codec,
                       fragments, True)
        for rank in range(world):
            _assert_rounds_equal(port[rank][0], ref[rank][0],
                                 f"{tag} rank {rank}")
            got_res, want_res = port[rank][1], ref[rank][1]
            assert (got_res is None) == (want_res is None), (tag, rank)
            if want_res is not None:
                for g, w in zip(got_res, want_res):
                    assert g.tobytes() == w.tobytes(), (tag, rank)
            if codec != "none" and algorithm == "star" and rank > 0:
                assert got_res is not None and any(
                    np.any(r != 0) for r in got_res), (tag, rank)


@pytest.mark.parametrize("algorithm,world", [("star", 2), ("ring", 3)])
@pytest.mark.parametrize("codec", ["none", "bf16", "int8"])
def test_streaming_bitwise_identical_to_blocking(algorithm, world,
                                                 codec) -> None:
    # streaming is a scheduling change only: same grid, snapshot points,
    # codec and EF math; the residuals evolve across rounds in both arms
    def outer_tx():
        return outer.sgd(0.7, momentum=0.9, nesterov=True)

    for fragments in (1, 2, 4):
        tag = f"{algorithm}_{codec}_f{fragments}"
        streamed = _port_arm(f"st_{tag}", algorithm, world, codec,
                             fragments, True, outer_tx=outer_tx)
        blocking = _port_arm(f"bl_{tag}", algorithm, world, codec,
                             fragments, False, outer_tx=outer_tx)
        for rank in range(world):
            assert len(streamed[rank][0]) == 2
            _assert_rounds_equal(streamed[rank][0], blocking[rank][0],
                                 f"{tag}: streaming vs blocking, rank {rank}")
        for rank in range(1, world):  # every rank commits the same state
            _assert_rounds_equal(streamed[rank][0], streamed[0][0],
                                 f"{tag}: rank {rank} vs rank 0")


def test_streaming_localsgd_bitwise_and_ef_disabled() -> None:
    # the weight-averaging arm, int8 on star (EF on the peer, raw root),
    # and error_feedback=False on the blocking path
    for fragments in (2, 4):
        streamed = _port_arm(f"ls_st_{fragments}", "star", 2, "int8",
                             fragments, True)
        blocking = _port_arm(f"ls_bl_{fragments}", "star", 2, "int8",
                             fragments, False)
        for rank in range(2):
            _assert_rounds_equal(streamed[rank][0], blocking[rank][0],
                                 f"f{fragments} rank {rank}")
    off = _port_arm("ls_off", "star", 2, "int8", 2, True)
    assert off[1][1] is not None  # the peer kept residuals...
    manager = _LocalStubManager()
    wrapper = LocalSGD(manager, sync_every=2, num_fragments=2,
                       error_feedback=False)
    params = _port_params()
    wrapper.register(params)
    for _ in range(2):
        wrapper.step()
    assert wrapper._ef_residuals is None  # ...and the disabled arm none


@pytest.mark.parametrize("name", ["sgd", "nesterov", "adam"])
def test_diloco_matches_reference_outer_step(jax_store, name) -> None:
    txs = {
        "sgd": (lambda: outer.sgd(1.0), lambda: optax.sgd(1.0)),
        "nesterov": (lambda: outer.sgd(0.7, momentum=0.9, nesterov=True),
                     lambda: optax.sgd(0.7, momentum=0.9, nesterov=True)),
        "adam": (lambda: outer.adam(1e-2), lambda: optax.adam(1e-2)),
    }
    port_tx, jax_tx = txs[name]
    port = _port_arm(f"dl_{name}", "star", 2, "none", 2, True,
                     rounds=3, outer_tx=port_tx)
    ref = _jax_arm(jax_store, f"dlx_{name}", "star", 2, "none", 2, True,
                   rounds=3, outer_tx=jax_tx)
    for rank in range(2):
        got_avg, want_avg = port[rank][2].reduced, ref[rank][2].reduced
        assert len(got_avg) == len(want_avg) == 6  # 2 fragments x 3 rounds
        # round 1 starts from the same backup: its averaged
        # pseudogradients are bitwise; at lr 1 without state, every round's
        checked = want_avg if name == "sgd" else want_avg[:2]
        for g, w in zip(got_avg, checked):
            assert g.tobytes() == w.tobytes(), (name, rank)
        for g, w in zip(got_avg[2:], want_avg[2:]):
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)
        for t, (g, w) in enumerate(zip(port[rank][0], ref[rank][0])):
            for k in _KEYS:
                np.testing.assert_allclose(g[k], w[k], **OUTER_TOL,
                                           err_msg=f"{name} round {t} {k}")
        got_states = port[rank][3].outer_state
        want_states = [outer.from_optax_state(s) for s in
                       jax.device_get(ref[rank][3].outer_state)]
        assert len(got_states) == len(want_states) == 2
        for g, w in zip(got_states, want_states):
            assert sorted(g) == sorted(w)
            for key in w:
                if key == "count":
                    assert int(g[key]) == int(w[key]) == 3
                    continue
                for a, b in zip(g[key], w[key]):
                    np.testing.assert_allclose(a.numpy(), b.numpy(),
                                               **OUTER_TOL)


def test_diloco_resumes_from_reference_state() -> None:
    # one mid-run state, carried across: a JAX-package DiLoCo commits a
    # round (outer momentum non-zero), its state_dict starts a port DiLoCo,
    # and both run the next round from it
    incs = _increments(0, 8)
    jax_wrapper = JaxDiLoCo(_JaxLocalStub(), optax.sgd(0.7, momentum=0.9,
                                                       nesterov=True),
                            sync_every=4, num_fragments=2)
    params = jax_wrapper.register(_jax_params())
    for t in range(4):
        params = {k: params[k] + incs[t][k] for k in params}
        params = jax_wrapper.step(params)
    assert jax_wrapper.local_step == 0
    state = from_jax_state(jax.device_get(jax_wrapper.state_dict()))
    mid = _snap_jax(params)
    port_params = _port_params(mid)
    wrapper = DiLoCo(_LocalStubManager(),
                     outer.sgd(0.7, momentum=0.9, nesterov=True),
                     sync_every=4, num_fragments=2)
    wrapper.register(port_params)
    wrapper.load_state_dict(state)
    assert wrapper.local_step == 0
    for p, b in zip(port_params, wrapper._backup):
        assert p.numpy().tobytes() == b.numpy().tobytes()
    for t in range(4, 8):
        params = {k: params[k] + incs[t][k] for k in params}
        params = jax_wrapper.step(params)
        for k, p in zip(_KEYS, port_params):
            p.add_(torch.from_numpy(incs[t][k]))
        wrapper.step()
    assert wrapper.local_step == jax_wrapper.local_step == 0
    want = _snap_jax(params)
    for k, p in zip(_KEYS, port_params):
        np.testing.assert_allclose(p.numpy(), want[k], **OUTER_TOL)


class _JaxLocalStub:
    """The reference test's transport-less stub (identity averaging)."""

    def __init__(self):
        from torchft_tpu.utils.metrics import Metrics as JaxMetrics

        self.metrics = JaxMetrics()
        self._use_async_quorum = True

    def start_quorum(self, **kw):
        pass

    def quorum_fence(self):
        pass

    def did_heal(self):
        return False

    def errored(self):
        return None

    def report_error(self, e):
        raise AssertionError(e)

    def should_commit(self):
        return True

    def is_participating(self):
        return True

    def wire_compensable(self):
        return False

    def wire_generation(self):
        return 0

    def wire_nbytes(self, a):
        return int(np.asarray(a).nbytes)

    def allreduce_arrays(self, arrays, op=ReduceOp.SUM):
        from torchft_tpu.comm.context import CompletedWork as JaxCompleted

        return JaxCompleted([np.array(a, copy=True) for a in arrays])


# ------------------------------------------------------- fragment grid


def test_fragment_partition_deterministic_balanced() -> None:
    sizes = [96 * 4, 64 * 4, 160 * 4, 32 * 4, 48 * 4]
    grid = split_weighted(sizes, 3)
    assert grid[0][0] == 0 and grid[-1][1] == len(sizes)
    for (a, b), (c, d) in zip(grid, grid[1:]):
        assert b == c and b > a and d > c
    assert grid == split_weighted(sizes, 3)
    weights = [sum(sizes[a:b]) for a, b in grid]
    assert max(weights) - min(weights) <= max(sizes)
    assert split_weighted([8, 8], 5) == [(0, 1), (1, 2)]
    assert split_weighted([8], 1) == [(0, 1)]
    # the reference's grid, exactly, and the wrapper's on the same leaves
    assert grid == jax_split_weighted(sizes, 3)
    for f in (1, 2, 3, 4, 5, 7):
        wrapper = LocalSGD(_LocalStubManager(), sync_every=8,
                           num_fragments=min(f, 8))
        wrapper.register(_port_params())
        ref = JaxLocalSGD(_LocalStubManager(), sync_every=8,
                          num_fragments=min(f, 8))
        ref.register(_jax_params())
        assert wrapper._fragments == ref._fragments
        assert wrapper._boundaries == ref._boundaries


def test_fragment_boundaries_schedule() -> None:
    assert fragment_boundaries(8, 4) == [2, 4, 6, 8]
    assert fragment_boundaries(8, 1) == [8]
    assert fragment_boundaries(4, 4) == [1, 2, 3, 4]
    assert fragment_boundaries(5, 2) == [2, 5]
    for e in range(1, 12):
        for f in range(1, e + 1):
            bs = fragment_boundaries(e, f)
            assert bs == jax_boundaries(e, f)
            assert bs[-1] == e and all(b2 > b1 for b1, b2 in zip(bs, bs[1:]))


# -------------------------------------------------- abort / heal paths


def test_midround_abort_rolls_back_every_fragment() -> None:
    # fragment 0 lands, fragment 1's op latches: the WHOLE round rolls
    # back bitwise, landed fragment included, into the same tensors; the
    # next round commits
    manager = _LocalStubManager(fail_at_op=2)
    diloco = DiLoCo(manager, outer.sgd(1.0), sync_every=4, num_fragments=4)
    params = _port_params()
    ptrs = [p.data_ptr() for p in params]
    diloco.register(params)
    ref = _snap_port(params)
    for _ in range(4):
        for p in params:
            p.add_(1.0)
        diloco.step()
    assert diloco.local_step == 0
    assert [p.data_ptr() for p in params] == ptrs
    for k, p in zip(_KEYS, params):
        assert p.numpy().tobytes() == ref[k].tobytes(), k
    # fragment f ships at inner step f+1, when the loop has added f+1
    manager.fail_at_op = None
    for _ in range(4):
        for p in params:
            p.add_(1.0)
        diloco.step()
    for f, (start, stop) in enumerate(diloco._fragments):
        for i in range(start, stop):
            np.testing.assert_allclose(params[i].numpy(),
                                       ref[_KEYS[i]] + (f + 1.0), rtol=1e-6,
                                       err_msg=f"fragment {f} leaf {i}")


def test_rollback_then_the_next_step_trains_the_restored_values() -> None:
    # the inner step (a CUDA graph on the card) holds the parameter and
    # AdamW tensors: an aborted round writes the backup INTO them, so the
    # next step trains the restored values, as a fresh model loaded with
    # them does
    from torchft_tpu_torch.models import CONFIGS, GPT, make_train_step

    cfg = CONFIGS["tiny"]
    model = GPT(cfg, device="cpu", seed=0)
    opt = torch.optim.AdamW(model.parameters(), lr=1e-2)
    step = make_train_step(model, opt)
    rng = np.random.default_rng(3)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 16)))
    targets = torch.roll(tokens, -1, dims=1)
    manager = _LocalStubManager(fail_at_op=1)
    wrapper = LocalSGD(manager, sync_every=2, num_fragments=1)
    wrapper.register(model)
    synced = [p.detach().clone() for p in model.parameters()]
    step(tokens, targets)  # AdamW's lazy state is born here
    wrapper.step()
    key = step._state_key()
    step(tokens, targets)
    wrapper.step()  # the round ends and aborts
    assert wrapper.local_step == 0
    assert step._state_key() == key  # same storages: no re-capture
    for p, s in zip(model.parameters(), synced):
        assert torch.equal(p, s)
    twin = GPT(cfg, device="cpu", seed=1)
    twin.load_state_dict(model.state_dict())
    twin_opt = torch.optim.AdamW(twin.parameters(), lr=1e-2)
    # a deep copy: a plain load shares the state tensors
    twin_opt.load_state_dict(copy.deepcopy(opt.state_dict()))
    make_train_step(twin, twin_opt)(tokens, targets)
    step(tokens, targets)
    for a, b in zip(model.parameters(), twin.parameters()):
        assert torch.equal(a, b)


def test_heal_at_fence_rereads_params_fn() -> None:
    # a heal applied at the fence: the round snapshots the params_fn
    # re-read, and without a donor backup the healed state becomes the
    # new sync point
    healed = [torch.full_like(p, 5.0) for p in _port_params()]
    holder = {"params": _port_params()}
    manager = _LocalStubManager()
    wrapper = LocalSGD(manager, sync_every=2, num_fragments=2,
                       params_fn=lambda: holder["params"])
    wrapper.register(holder["params"])
    manager.heal_next_fence = True
    holder["params"] = healed
    for _ in range(2):  # no inner movement: isolates the re-read
        wrapper.step()
    for p in healed:
        np.testing.assert_allclose(p.numpy(), 5.0, rtol=1e-6)
    wrapper.restore()
    for p, b in zip(healed, wrapper._backup):
        np.testing.assert_allclose(b.numpy(), 5.0, rtol=1e-6)


def test_heal_keeps_donor_backup_as_sync_point() -> None:
    # the donor's backup came through load_state_dict: the fence keeps IT;
    # outer lr 0.5 commits the midpoint of backup (2) and params (6)
    base = _port_params()
    holder = {"params": base}
    manager = _LocalStubManager()
    wrapper = DiLoCo(manager, outer.sgd(0.5), sync_every=2, num_fragments=2,
                     params_fn=lambda: holder["params"])
    wrapper.register(base)
    wrapper.load_state_dict({
        "backup": [torch.full_like(p, 2.0) for p in base],
        "local_step": 0, "outer_state": wrapper.outer_state,
    })
    manager.heal_next_fence = True
    healed = [torch.full_like(p, 6.0) for p in base]
    holder["params"] = healed
    for _ in range(2):
        wrapper.step()
    for p in healed:  # pseudograd 2 - 6 = -4; 2 + 0.5 * 4 = 4
        np.testing.assert_allclose(p.numpy(), 4.0, rtol=1e-6)


# ------------------------------------------------------ metric surface


def test_outer_metric_surface() -> None:
    manager = _LocalStubManager()
    wrapper = DiLoCo(manager, outer.sgd(0.7), sync_every=2, num_fragments=2)
    params = _port_params()
    wrapper.register(params)
    for _ in range(2):
        for p in params:
            p.add_(1.0)
        wrapper.step()
    snap = manager.metrics.snapshot()
    for stage in ("outer_d2h", "outer_wire", "outer_land"):
        assert f"{stage}_avg_ms" in snap, (stage, sorted(snap))
        assert np.isfinite(snap[f"{stage}_avg_ms"])
    for gauge in ("outer_wire_ms", "outer_wire_exposed_ms", "outer_overlap",
                  "outer_wire_bytes", "outer_inflight_at_drain"):
        assert gauge in snap, (gauge, sorted(snap))
        assert np.isfinite(snap[gauge]) and snap[gauge] >= 0.0
    assert 0.0 <= snap["outer_overlap"] <= 1.0
    total = sum(v.size for v in _params0_np().values())
    assert snap["outer_wire_bytes"] == 4 * total


def test_outer_ef_timer_under_a_lossy_wire() -> None:
    port = _port_arm("ef_timer", "star", 2, "int8", 2, True, rounds=1)
    snap = port[1][2].metrics.snapshot()  # the peer compensates
    assert snap["outer_ef_p50_ms"] >= 0.0
    assert "outer_ef_p50_ms" not in port[0][2].metrics.snapshot()


def test_streaming_overlaps_wire_behind_inner_steps() -> None:
    # a delayed wire: fragment 0 (shipped at step 1 of 2) resolves while
    # the inner loop still steps, so the exposed time is below the summed
    # wire time and the overlap gauge reads > 0
    delay = 0.15

    class _DelayedStub(_LocalStubManager):
        def allreduce_arrays(self, arrays, op=ReduceOp.SUM):
            self._ops += 1
            fut = Future()
            fut.set_running_or_notify_cancel()
            arrs = [np.array(a, copy=True) for a in arrays]

            def _complete():
                time.sleep(delay)
                fut.set_result(arrs)

            threading.Thread(target=_complete, daemon=True).start()
            return Work(fut)

    manager = _DelayedStub()
    wrapper = LocalSGD(manager, sync_every=2, num_fragments=2)
    params = _port_params()
    wrapper.register(params)
    for t in range(2):
        for p in params:
            p.add_(1.0)
        wrapper.step()
        if t == 0:
            time.sleep(delay * 1.5)  # inner compute hiding fragment 0
    snap = manager.metrics.snapshot()
    assert snap["outer_overlap"] > 0.25, snap
    assert snap["outer_wire_exposed_ms"] < snap["outer_wire_ms"], snap


def test_sync_quorum_heal_does_not_rewind_round() -> None:
    # a use_async_quorum=False manager heals INSIDE start_quorum, before
    # the round object exists: the donor's mid-round local_step must not
    # be adopted, or this round's fragments never ship
    refs = {}

    class _SyncQuorumStub(_LocalStubManager):
        def __init__(self):
            super().__init__()
            self._use_async_quorum = False
            self.heal_in_start_quorum = False

        def start_quorum(self, **kw):
            super().start_quorum(**kw)
            if self.heal_in_start_quorum:
                self.heal_in_start_quorum = False
                refs["wrapper"].load_state_dict(
                    {"backup": refs["donor_backup"], "local_step": 1})
                self._did_heal = True

    base = _port_params()
    holder = {"params": base}
    manager = _SyncQuorumStub()
    wrapper = LocalSGD(manager, sync_every=4, num_fragments=1,
                       params_fn=lambda: holder["params"])
    refs["wrapper"] = wrapper
    refs["donor_backup"] = [torch.full_like(p, 2.0) for p in base]
    wrapper.register(base)
    for _ in range(3):
        wrapper.step()
    manager.heal_in_start_quorum = True
    healed = [torch.full_like(p, 3.0) for p in base]
    holder["params"] = healed
    wrapper.step()  # the round-start step (boundary 4)
    assert wrapper.local_step == 0, (
        "heal rewound the fragment schedule; the round never closed")
    for p in healed:
        np.testing.assert_allclose(p.numpy(), 3.0, rtol=1e-6)


def test_sync_without_register() -> None:
    # sync(params) on a wrapper that never saw register() bootstraps the
    # layout and DiLoCo's outer state
    wrapper = DiLoCo(_LocalStubManager(), outer.sgd(1.0), sync_every=4,
                     num_fragments=2)
    params = _port_params()
    before = _snap_port(params)
    wrapper.sync(params)
    assert wrapper.local_step == 0
    for k, p in zip(_KEYS, params):  # zero pseudogradient
        np.testing.assert_allclose(p.numpy(), before[k], rtol=1e-6)
    with pytest.raises(RuntimeError, match="register"):
        LocalSGD(_LocalStubManager(), sync_every=2).step()


def test_load_state_dict_leaf_count_mismatch_raises() -> None:
    wrapper = LocalSGD(_LocalStubManager(), sync_every=2, num_fragments=2)
    wrapper.register(_port_params())
    with pytest.raises(ValueError, match="leaves"):
        wrapper.load_state_dict(
            {"backup": [np.zeros(96, np.float32)], "local_step": 0})


# ------------------------------------------- the hierarchical outer sync

HIER_MAP = {"d0": ["rank0", "rank1"], "d1": ["rank2", "rank3"]}


def _hier_arm(kind, store, prefix, codec, outer_tx=None, rounds=2,
              sync_every=4, fragments=2):
    """Four ranks in two domains, the wrapper's fragments over
    ``topology="hier"``: ``kind`` "port" (the port's wrapper over its
    TcpCommContext), "cuda" (over its CudaCommContext on the CPU) or "jax"
    (the JAX package's wrapper over its own). Per rank: the committed
    parameters of each round, the EF residuals and the stub."""
    world = 4
    if kind == "jax":
        resolver = JaxTopology(static_map=HIER_MAP)
        ctxs = [JaxTcp(timeout=15.0, algorithm="star", channels=2,
                       compression=codec, chunk_bytes=256, topology="hier",
                       domain_resolver=resolver) for _ in range(world)]
    elif kind == "port":
        resolver = DomainTopology(static_map=HIER_MAP)
        ctxs = [TcpCommContext(timeout=15.0, algorithm="star", channels=2,
                               compression=codec, chunk_bytes=256,
                               topology="hier", domain_resolver=resolver)
                for _ in range(world)]
    else:
        resolver = DomainTopology(static_map=HIER_MAP)
        pool = DevicePool("cpu")
        ctxs = [CudaCommContext(timeout=15.0, algorithm="star",
                                compression=codec, chunk_bytes=256,
                                device_pool=pool, topology="hier",
                                domain_resolver=resolver)
                for _ in range(world)]
    addr = (f"{store.addr}/{prefix}" if kind != "cuda"
            else f"localsgd://{prefix}")
    outs = [None] * world
    steps = rounds * sync_every

    def worker(rank):
        ctxs[rank].configure(addr, rank, world)
        incs = _increments(rank, steps)
        per_round = []
        if kind == "jax":
            manager = _RecordingJaxStub(ctxs[rank], world)
            cls = (JaxLocalSGD if outer_tx is None
                   else lambda m, **kw: JaxDiLoCo(m, outer_tx[1](), **kw))
            wrapper = cls(manager, sync_every=sync_every,
                          num_fragments=fragments, topology="hier")
            params = wrapper.register(_jax_params())
            for t in range(steps):
                params = {k: params[k] + incs[t][k] for k in params}
                params = wrapper.step(params)
                if wrapper.local_step == 0:
                    per_round.append(_snap_jax(params))
        else:
            manager = _PortWireStub(ctxs[rank], world)
            cls = (LocalSGD if outer_tx is None
                   else lambda m, **kw: DiLoCo(m, outer_tx[0](), **kw))
            wrapper = cls(manager, sync_every=sync_every,
                          num_fragments=fragments, topology="hier")
            params = _port_params()
            wrapper.register(params)
            for t in range(steps):
                for k, p in zip(_KEYS, params):
                    p.add_(torch.from_numpy(incs[t][k]))
                wrapper.step()
                if wrapper.local_step == 0:
                    per_round.append(_snap_port(params))
        residuals = (None if wrapper._ef_residuals is None
                     else [r.copy() for r in wrapper._ef_residuals])
        outs[rank] = (per_round, residuals, manager)

    try:
        with ThreadPoolExecutor(max_workers=world) as ex:
            for f in [ex.submit(worker, r) for r in range(world)]:
                f.result(timeout=120)
    finally:
        for c in ctxs:
            c.shutdown()
    return outs


@pytest.mark.parametrize("codec", ["none", "bf16", "int8"])
def test_localsgd_hier_bitwise_equals_reference(jax_store, codec) -> None:
    # EF "auto" engages on the compensable egress alone (rank 2: the d1
    # egress encodes into the inter fan-in), in both packages
    ref = _hier_arm("jax", jax_store, f"hx_{codec}", codec)
    for kind in ("port", "cuda"):
        got = _hier_arm(kind, jax_store, f"h{kind}_{codec}", codec)
        for rank in range(4):
            _assert_rounds_equal(got[rank][0], ref[rank][0],
                                 f"{kind} {codec} rank {rank}")
            g_res, w_res = got[rank][1], ref[rank][1]
            assert (g_res is None) == (w_res is None), (kind, rank)
            if w_res is not None:
                for g, w in zip(g_res, w_res):
                    assert g.tobytes() == w.tobytes(), (kind, rank)
            if codec != "none":
                # only the compensable egress keeps a residual that moved
                moved = g_res is not None and any(np.any(r != 0)
                                                  for r in g_res)
                assert moved == (rank == 2), (kind, codec, rank)
    for rank in range(1, 4):  # every rank commits the same state
        _assert_rounds_equal(ref[rank][0], ref[0][0], f"rank {rank}")


@pytest.mark.parametrize("codec", ["none", "bf16", "int8"])
def test_diloco_hier_matches_reference(jax_store, codec) -> None:
    # outer sgd(1.0) has no state: every round's averaged pseudogradients
    # are bitwise; the outer step itself is held to OUTER_TOL, as above
    tx = (lambda: outer.sgd(1.0), lambda: optax.sgd(1.0))
    got = _hier_arm("port", jax_store, f"dh_{codec}", codec, outer_tx=tx)
    ref = _hier_arm("jax", jax_store, f"dhx_{codec}", codec, outer_tx=tx)
    for rank in range(4):
        g_avg, w_avg = got[rank][2].reduced, ref[rank][2].reduced
        assert len(g_avg) == len(w_avg) == 4  # 2 fragments x 2 rounds
        for g, w in zip(g_avg, w_avg):
            assert g.tobytes() == w.tobytes(), (codec, rank)
        for t, (g, w) in enumerate(zip(got[rank][0], ref[rank][0])):
            for k in _KEYS:
                np.testing.assert_allclose(g[k], w[k], **OUTER_TOL,
                                           err_msg=f"round {t} {k}")


def test_outer_pools_are_split() -> None:
    assert _outer_executor("ef") is not _outer_executor("land")
    assert _outer_executor("land") is _outer_executor("land")


def test_num_fragments_validation() -> None:
    with pytest.raises(ValueError, match="num_fragments must be >= 1"):
        LocalSGD(_LocalStubManager(), sync_every=4, num_fragments=0)
    with pytest.raises(ValueError, match="must be >= num_fragments"):
        LocalSGD(_LocalStubManager(), sync_every=3, num_fragments=4)
    with pytest.raises(ValueError, match="error_feedback"):
        LocalSGD(_LocalStubManager(), sync_every=3, error_feedback="yes")


# --------------------------------------------- the sharded outer update


@pytest.fixture()
def port_store():
    server = StoreServer()
    yield server
    server.shutdown()


def _tcp(codec="none"):
    return lambda: TcpCommContext(timeout=15.0, algorithm="star",
                                  compression=codec, chunk_bytes=256,
                                  channels=2)


def _diloco_ranks(store, prefix, world, sharded=True, codec="none",
                  fragments=3, streaming=True, rounds=2, sync_every=4,
                  carried=None, stub=None):
    """A DiLoCo (outer ``sgd(0.5, momentum=0.9)``) per rank over the port's
    TCP wire behind ``comm.wire_stub``; per rank: the committed parameters
    of each round (or the rolled-back ones of an aborted round), the
    wrapper and the stub. ``carried[rank]`` replaces a rank's outer states
    after register; ``stub(ctx, world)`` builds a rank's manager."""
    def fn(mgr, rank):
        if stub is not None:
            mgr = stub(mgr._ctx, world)
        params = _port_params()
        dl = DiLoCo(mgr, outer.sgd(0.5, momentum=0.9), sync_every=sync_every,
                    num_fragments=fragments, streaming=streaming,
                    sharded_outer=sharded)
        dl.register(params)
        if carried is not None and carried[rank] is not None:
            dl.load_outer_state(copy.deepcopy(carried[rank]))
        incs = _increments(rank, rounds * sync_every)
        per_round = []
        for t in range(rounds * sync_every):
            for k, p in zip(_KEYS, params):
                p.add_(torch.from_numpy(incs[t][k]))
            dl.step()
            if dl.local_step == 0:
                per_round.append(_snap_port(params))
        return per_round, dl, mgr

    return run_stub_ranks(store.addr, prefix, world, fn, _tcp(codec),
                          timeout=120)


def _held(wrapper):
    return [f for f, s in enumerate(wrapper.outer_state) if s is not None]


def _reshards(mgr):
    return [e for e in mgr.events.since(0)[0] if e["kind"] == "reshard"]


@pytest.mark.parametrize("codec", ["none", "int8"])
@pytest.mark.parametrize("num_fragments", [1, 3])
@pytest.mark.parametrize("streaming", [True, False])
def test_diloco_sharded_outer_bitwise(port_store, codec, num_fragments,
                                      streaming) -> None:
    # fragments as the shard unit: bitwise the replicated arm's commits at
    # world 3, both schedules, both codecs (EF on the star peers at int8);
    # each rank holds exactly the fragments f % world == rank
    tag = f"{codec}_{num_fragments}_{streaming}"
    sh = _diloco_ranks(port_store, f"sh_{tag}", 3, True, codec,
                       num_fragments, streaming)
    rp = _diloco_ranks(port_store, f"rp_{tag}", 3, False, codec,
                       num_fragments, streaming)
    for rank in range(3):
        assert len(sh[rank][0]) == 2
        _assert_rounds_equal(sh[rank][0], rp[0][0],
                             f"{tag}: sharded rank {rank} vs replicated")
        assert sh[rank][1].num_fragments == num_fragments
        assert _held(sh[rank][1]) == [f for f in range(num_fragments)
                                      if f % 3 == rank], (tag, rank)
        assert len(_held(rp[rank][1])) == num_fragments  # replicated: all
        for e in _reshards(sh[rank][2]):
            assert e["source"] == "outer_sync"
            assert e["wire_bytes"] == e["lower_bound_bytes"] == 0
            assert e["reinit_fragments"] == 0


@pytest.mark.parametrize("codec", ["none", "int8"])
def test_localsgd_sharded_outer_bitwise_equals_reference(jax_store,
                                                         codec) -> None:
    # LocalSGD's weight average sharded by fragment: the owner's average
    # rides the commit allgather, bitwise the reference's sharded arm (star
    # w3: EF on the peers at int8, the same residuals) and the replicated
    port = _port_arm(f"lsh_{codec}", "star", 3, codec, 3, True,
                     sharded_outer=True)
    ref = _jax_arm(jax_store, f"x_lsh_{codec}", "star", 3, codec, 3, True,
                   sharded_outer=True)
    flat = _port_arm(f"lrp_{codec}", "star", 3, codec, 3, True)
    for rank in range(3):
        _assert_rounds_equal(port[rank][0], ref[rank][0], f"{codec} {rank}")
        _assert_rounds_equal(port[rank][0], flat[rank][0], f"{codec} {rank}")
        got_res, want_res = port[rank][1], ref[rank][1]
        assert (got_res is None) == (want_res is None), (codec, rank)
        for g, w in zip(got_res or (), want_res or ()):
            assert g.tobytes() == w.tobytes(), (codec, rank)


def test_diloco_sharded_outer_matches_reference(jax_store) -> None:
    # against the reference's sharded DiLoCo on the same inputs: the same
    # owner map (each rank the same fragments), the committed parameters
    # and the held momentum within OUTER_TOL, and the state_dict's leaves
    # (the heal manifest's) in the reference's order: None is no leaf
    from torchft_tpu_torch.utils.serialization import tree_flatten_with_path

    port = _port_arm("dsh", "star", 3, "none", 3, True,
                     outer_tx=lambda: outer.sgd(0.5, momentum=0.9),
                     sharded_outer=True)
    ref = _jax_arm(jax_store, "x_dsh", "star", 3, "none", 3, True,
                   outer_tx=lambda: optax.sgd(0.5, momentum=0.9),
                   sharded_outer=True)
    for rank in range(3):
        pw, rw = port[rank][3], ref[rank][3]
        for t, (g, w) in enumerate(zip(port[rank][0], ref[rank][0])):
            for k in _KEYS:
                np.testing.assert_allclose(g[k], w[k], **OUTER_TOL,
                                           err_msg=f"rank {rank} round {t}")
        assert _held(pw) == [f for f, s in enumerate(rw.outer_state)
                             if s is not None] == [rank]
        want = outer.from_optax_state(
            jax.device_get(rw.outer_state[rank]))
        for a, b in zip(pw.outer_state[rank]["trace"], want["trace"]):
            np.testing.assert_allclose(a.numpy(), b.numpy(), **OUTER_TOL)
        got_leaves = [v for _, v in tree_flatten_with_path(
            pw.state_dict())[0]]
        want_leaves = jax.tree_util.tree_leaves(
            jax.device_get(rw.state_dict()))
        assert len(got_leaves) == len(want_leaves)
        for g, w in zip(got_leaves, want_leaves):
            if isinstance(g, torch.Tensor):
                w = np.asarray(w)
                assert tuple(g.shape) == w.shape and str(g.dtype) == \
                    f"torch.{w.dtype}"
                np.testing.assert_allclose(g.numpy(), w, **OUTER_TOL)
            else:
                assert g == w


def _tiny_params(seed=9):
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((13, 5)).astype(np.float32),
            "b": rng.standard_normal(31).astype(np.float32),
            "c": rng.standard_normal((3, 3)).astype(np.float32)}


def _run_diloco(store, prefix, world, carried=None, rounds=1, sync_every=4,
                fragments=3):
    """Twin of the reference test's ``_run_diloco``
    (tests/test_redistribute.py): per rank the final parameters, the outer
    states and the stub."""
    params0 = _tiny_params()

    def fn(mgr, rank):
        dl = DiLoCo(mgr, outer.sgd(0.5, momentum=0.9), sync_every=sync_every,
                    num_fragments=fragments, streaming=True,
                    sharded_outer=True)
        params = [torch.from_numpy(params0[k].copy()) for k in "abc"]
        dl.register(params)
        if carried is not None and carried[rank] is not None:
            dl.load_outer_state(copy.deepcopy(carried[rank]))
        for step in range(1, rounds * sync_every + 1):
            for p in params:
                p.sub_(0.01 * (rank + 1) * step)
            dl.step()
        return ({k: p.numpy().copy() for k, p in zip("abc", params)},
                dl.outer_state, mgr)

    return run_stub_ranks(store.addr, prefix, world, fn, _tcp(), timeout=120)


def test_diloco_sharded_outer_heal_exchanges_not_reinits(port_store) -> None:
    # a healer whose donor does not cover its new fragment FETCHES that
    # fragment's outer state from the live holder (reinit 0, moved == lower
    # bound > 0), and the adopted momentum is bitwise what a healer that
    # carried the holder's states holds
    w2 = _run_diloco(port_store, "dh_w2", 2)
    # w2's owner map f % 2: rank 0 holds {f0, f2}, rank 1 {f1}. Grow to 3:
    # the joiner (rank 2) healed from rank 1, so it carries {f1} but owns
    # f2, which only rank 0 holds: a real fetch
    fetched = _run_diloco(port_store, "dh_w3f", 3,
                          carried=[w2[0][1], w2[1][1], w2[1][1]])
    resh = _reshards(fetched[2][2])
    assert resh and resh[0]["source"] == "outer_sync"
    assert resh[0]["adopted_fragments"] == 1
    assert resh[0]["reinit_fragments"] == 0
    assert resh[0]["wire_bytes"] == resh[0]["lower_bound_bytes"] > 0
    plans = [e for e in fetched[2][2].events.since(0)[0]
             if e["kind"] == "redist_plan"]
    assert plans and plans[0]["source"] == "outer_sync"
    snap = fetched[2][2].metrics.snapshot()
    assert snap["redist_moved_bytes"] == snap["redist_lower_bound_bytes"] > 0
    carried = _run_diloco(port_store, "dh_w3c", 3,
                          carried=[w2[0][1], w2[1][1], w2[0][1]])
    for k in "abc":
        assert fetched[2][0][k].tobytes() == carried[2][0][k].tobytes()
    for a, b in zip(fetched[2][1][2]["trace"], carried[2][1][2]["trace"]):
        assert a.numpy().tobytes() == b.numpy().tobytes()
    assert [f for f, s in enumerate(fetched[2][1]) if s is not None] == [2]


def test_diloco_shrink_reinit_only_when_uncovered(port_store) -> None:
    # w3 -> w2 with the departed rank's fragment state gone with it: the
    # arriving fragment reinitializes (counted, never silent); covered
    # fragments keep their state
    w3 = _run_diloco(port_store, "ds_w3", 3)
    res = _run_diloco(port_store, "ds_w2", 2, carried=[w3[0][1], w3[1][1]])
    resh = _reshards(res[0][2])
    assert resh and resh[0]["reinit_fragments"] == 1
    assert resh[0]["adopted_fragments"] == 0
    resh1 = _reshards(res[1][2])
    assert resh1 and resh1[0]["reinit_fragments"] == 0


def test_localsgd_sharded_outer_native_dtypes(port_store) -> None:
    # the commit allgather carries each owned fragment in its leaves' own
    # dtypes: a bfloat16 leaf (numpy has none: it rides as its bits) and an
    # int32 leaf (rounded, not truncated) land bitwise as the replicated
    # arm's copy_ writes them, at world 2 with a fragment per leaf
    rng = np.random.default_rng(11)
    base = [rng.standard_normal((13, 5)).astype(np.float32),
            rng.standard_normal(31).astype(np.float32),
            rng.integers(-50, 50, (3, 3)).astype(np.int32)]

    def arm(prefix, sharded):
        def fn(mgr, rank):
            params = [torch.from_numpy(base[0].copy()),
                      torch.from_numpy(base[1].copy()).to(torch.bfloat16),
                      torch.from_numpy(base[2].copy())]
            ls = LocalSGD(mgr, sync_every=3, num_fragments=3,
                          sharded_outer=sharded)
            ls.register(params)
            for step in range(1, 7):
                params[0].add_(0.01 * (rank + 1) * step)
                params[1].add_(0.01 * (rank + 1) * step)
                params[2].add_(rank + step)
                ls.step()
            return [p.view(torch.int16) if p.dtype == torch.bfloat16
                    else p for p in params], ls

        return run_stub_ranks(port_store.addr, prefix, 2, fn, _tcp(),
                              timeout=120)

    sh, rp = arm("nd_sh", True), arm("nd_rp", False)
    assert sh[0][1].num_fragments == 3
    for rank in range(2):
        for got, want in zip(sh[rank][0], rp[0][0]):
            assert got.dtype == want.dtype
            assert torch.equal(got, want), rank


class _FaultOnEveryRank(WireStubManager):
    """A wire failure every rank sees: the ``fail_at``-th reduce_scatter
    latches after its collective ran."""

    fail_at = 5

    def __init__(self, ctx, world):
        super().__init__(ctx, world)
        self.scatters = 0

    def reduce_scatter_arrays(self, arrays, op=ReduceOp.SUM, owners=None):
        self.scatters += 1
        work = super().reduce_scatter_arrays(arrays, op, owners)
        if self.scatters != self.fail_at:
            return work

        def _fail(f):
            self.report_error(RuntimeError("injected wire fault"))
            return f.result()

        return Work(future_chain(work.future(), _fail))


def test_sharded_round_abort_restores_params_and_owned_states(
        port_store) -> None:
    # round 2's second fragment op fails on every rank after the wire ran:
    # the round rolls back bitwise (parameters at the backup, each owned
    # outer state as round 1 committed it: nothing adopted), and round 3
    # commits equal on every rank
    def fn(mgr, rank):
        mgr = _FaultOnEveryRank(mgr._ctx, 3)
        params = _port_params()
        dl = DiLoCo(mgr, outer.sgd(0.5, momentum=0.9), sync_every=4,
                    num_fragments=3, sharded_outer=True)
        dl.register(params)
        incs = _increments(rank, 12)
        snaps, states = [], []
        for t in range(12):
            for k, p in zip(_KEYS, params):
                p.add_(torch.from_numpy(incs[t][k]))
            dl.step()
            if dl.local_step == 0:
                snaps.append(_snap_port(params))
                states.append(copy.deepcopy(dl.outer_state))
        return snaps, states, mgr

    res = run_stub_ranks(port_store.addr, "abort", 3, fn, _tcp(),
                         timeout=120)
    for rank, (snaps, states, mgr) in enumerate(res):
        assert len(snaps) == 3
        _assert_rounds_equal([snaps[1]], [snaps[0]], f"rank {rank} abort")
        assert [f for f, s in enumerate(states[1]) if s is not None] == [rank]
        assert _tree_equal(states[1], states[0]), rank
        assert not _tree_equal(states[2], states[1]), rank
        _assert_rounds_equal(snaps, res[0][0], f"rank {rank} vs rank 0")
        aborts = [e for e in mgr.events.since(0)[0]
                  if e["kind"] == "round_abort"]
        assert len(aborts) == 1 and aborts[0]["wire_world"] == 3
