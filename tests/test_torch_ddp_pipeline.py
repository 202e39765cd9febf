"""The port's streamed DDP pipeline against its lock-step arm and the JAX
package's DDP.

Twins of tests/test_ddp_pipeline.py. The streamed pipeline is a change of
schedule only (same math, buffers and submission order), so its averages
and its error-feedback residuals are held BITWISE equal to the lock-step
arm's at every step of a multi-step run, at codecs none, bf16 and int8,
star and ring, over the port's TCP wire; and bitwise equal to the JAX
package's streamed DDP on the same inputs over the JAX package's wire.
Also: the arena generations (overlap, aliasing, the all-in-flight guard,
the mid-loop failure guard), PureDistributedDataParallel, and
``OptimizerWrapper.step`` taking the average's future. The FutureGroup
twins (test_future_group_*) live in tests/test_torch_futures.py.
Tolerance: none; every comparison is bitwise.
"""

import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from unittest.mock import MagicMock

import numpy as np
import pytest
import torch

from torchft_tpu_torch.comm.context import CompletedWork, ReduceOp, Work
from torchft_tpu_torch.comm.cuda_backend import CudaCommContext, DevicePool
from torchft_tpu_torch.comm.store import StoreServer
from torchft_tpu_torch.comm.transport import TcpCommContext
from torchft_tpu_torch.ddp import (
    DistributedDataParallel,
    PureDistributedDataParallel,
)
from torchft_tpu_torch.futures import completed_future, failed_future, \
    future_chain
from torchft_tpu_torch.optim import OptimizerWrapper
from torchft_tpu_torch.utils.metrics import Metrics


@pytest.fixture()
def store():
    server = StoreServer()
    yield server
    server.shutdown()


class _WireStubManager:
    """Manager facade over a raw comm context: the quorum is a no-op, the
    average divides by the wire world, wire_* passes through, and a real
    Metrics sink records the pipeline's stage timers."""

    def __init__(self, ctx, world: int) -> None:
        self._ctx = ctx
        self._world = world
        self.metrics = Metrics()

    def wait_quorum(self) -> None:
        pass

    def is_solo_wire(self) -> bool:
        return self._world == 1

    def is_participating(self) -> bool:
        return True

    def report_error(self, e) -> None:
        raise e

    def wire_compensable(self) -> bool:
        return self._ctx.wire_compensable()

    def wire_generation(self) -> int:
        return self._ctx.wire_generation()

    def wire_roundtrip(self, src, out) -> None:
        self._ctx.wire_roundtrip(src, out)

    def allreduce_arrays(self, arrays, op=ReduceOp.SUM) -> Work:
        work = self._ctx.allreduce(list(arrays), ReduceOp.SUM)
        scale = np.float32(1.0 / self._world)

        def _avg(f: Future):
            reduced = f.result()
            for a in reduced:
                if a.dtype in (np.float32, np.float64):
                    np.multiply(a, a.dtype.type(scale), out=a)
            return reduced

        return Work(future_chain(work.future(), _avg))


# the JAX package flattens a dict in sorted key order: b, i, w1, w2, w3
_KEYS = ("b", "i", "w1", "w2", "w3")


def _grad_tree(rank: int):
    """The reference's multi-dtype tree: at bucket_bytes=512 three f32
    buckets, an f64 and an int64 one."""
    rng = np.random.default_rng(100 + rank)
    return {
        "w1": rng.standard_normal(128).astype(np.float32),
        "w2": rng.standard_normal(128).astype(np.float32),
        "w3": rng.standard_normal(128).astype(np.float32),
        "b": rng.standard_normal(40).astype(np.float64),
        "i": np.arange(9, dtype=np.int64) * (rank + 1),
    }


def _residuals(arena):
    if arena.residuals is None:
        return None
    return [None if r is None else r.copy() for r in arena.residuals]


def _run_port(store, prefix, algorithm, world, codec, ef, streamed,
              steps=3):
    """Per-step averages and residuals of every rank of a port cohort."""
    ctxs = [TcpCommContext(timeout=15.0, algorithm=algorithm, channels=3,
                           compression=codec, chunk_bytes=256)
            for _ in range(world)]
    outs = [None] * world

    def _worker(rank):
        ctx = ctxs[rank]
        ctx.configure(f"{store.addr}/{prefix}", rank, world)
        ddp = DistributedDataParallel(_WireStubManager(ctx, world),
                                      bucket_bytes=512, error_feedback=ef,
                                      streamed=streamed)
        base = _grad_tree(rank)
        per_step = []
        for t in range(steps):
            grads = [torch.from_numpy((base[k] * (t + 1)).astype(
                base[k].dtype)) for k in _KEYS]
            ddp.average_gradients(grads)
            per_step.append(({k: g.numpy().copy()
                              for k, g in zip(_KEYS, grads)},
                             _residuals(ddp._arenas[0])))
        outs[rank] = per_step

    with ThreadPoolExecutor(max_workers=world) as pool:
        for f in [pool.submit(_worker, r) for r in range(world)]:
            f.result(timeout=120)
    for ctx in ctxs:
        ctx.shutdown()
    return outs


def _run_reference(prefix, algorithm, world, codec, ef, steps=3):
    """The same run through the JAX package's streamed DDP and wire."""
    from torchft_tpu.comm import StoreServer as JaxStore
    from torchft_tpu.comm import TcpCommContext as JaxTcp
    from torchft_tpu.comm.wire_stub import WireStubManager
    from torchft_tpu.ddp import DistributedDataParallel as JaxDDP

    server = JaxStore()
    ctxs = [JaxTcp(timeout=15.0, algorithm=algorithm, channels=3,
                   compression=codec, chunk_bytes=256) for _ in range(world)]
    outs = [None] * world

    def _worker(rank):
        ctx = ctxs[rank]
        ctx.configure(f"{server.addr}/{prefix}", rank, world)
        ddp = JaxDDP(WireStubManager(ctx, world), bucket_bytes=512,
                     error_feedback=ef)
        base = _grad_tree(rank)
        per_step = []
        for t in range(steps):
            avg = ddp.average_gradients(
                {k: (v * (t + 1)).astype(v.dtype) for k, v in base.items()})
            per_step.append(({k: np.asarray(avg[k]).copy() for k in _KEYS},
                             _residuals(ddp._arenas[0])))
        outs[rank] = per_step

    try:
        with ThreadPoolExecutor(max_workers=world) as pool:
            for f in [pool.submit(_worker, r) for r in range(world)]:
                f.result(timeout=120)
    finally:
        for ctx in ctxs:
            ctx.shutdown()
        server.shutdown()
    return outs


def _assert_same(got, want, what):
    """Averages and residuals bitwise. The JAX package (x64 off) lands its
    f64 and int64 leaves as f32 and int32, so those compare after the same
    cast; its residuals stay at the bucket's dtype."""
    for rank, (g_steps, w_steps) in enumerate(zip(got, want)):
        for t, ((g_avg, g_res), (w_avg, w_res)) in enumerate(
                zip(g_steps, w_steps)):
            for k in _KEYS:
                mine = g_avg[k].astype(w_avg[k].dtype)
                assert mine.tobytes() == w_avg[k].tobytes(), (
                    f"{what}: rank {rank} step {t} leaf {k}")
            assert (g_res is None) == (w_res is None), (what, rank, t)
            for a, b in zip(g_res or (), w_res or ()):
                assert (a is None) == (b is None)
                if a is not None:
                    assert a.tobytes() == b.tobytes(), (
                        f"{what}: residual, rank {rank} step {t}")


@pytest.mark.parametrize("algorithm,world", [("star", 2), ("ring", 3)])
@pytest.mark.parametrize("codec", ["none", "bf16", "int8"])
def test_streamed_bitwise_identical_to_lockstep(store, algorithm, world,
                                                codec) -> None:
    # EF "auto" engages where it should (star peers under a lossy codec),
    # so the identity holds with the residuals evolving across steps
    streamed = _run_port(store, f"sp_{algorithm}_{codec}", algorithm, world,
                         codec, "auto", streamed=True)
    lockstep = _run_port(store, f"ls_{algorithm}_{codec}", algorithm, world,
                         codec, "auto", streamed=False)
    _assert_same(streamed, lockstep, f"{algorithm}/{codec} streamed")
    reference = _run_reference(f"ref_{algorithm}_{codec}", algorithm, world,
                               codec, "auto")
    _assert_same(streamed, reference, f"{algorithm}/{codec} vs reference")
    if algorithm == "star" and codec != "none":
        # the star peer compensates: its residuals exist and moved
        assert streamed[1][-1][1] is not None
    for rank in range(1, world):
        for t in range(len(streamed[0])):
            for k in _KEYS:
                assert streamed[rank][t][0][k].tobytes() \
                    == streamed[0][t][0][k].tobytes()


def test_streamed_identical_to_lockstep_ef_disabled(store) -> None:
    # error_feedback=False (raw quantization) is its own path on both arms
    streamed = _run_port(store, "sp_rawq", "star", 2, "int8", False,
                         streamed=True)
    lockstep = _run_port(store, "ls_rawq", "star", 2, "int8", False,
                         streamed=False)
    _assert_same(streamed, lockstep, "int8 without EF")
    assert streamed[1][-1][1] is None


def test_streamed_identical_to_lockstep_on_the_cuda_plane() -> None:
    # the device plane's quantized psum (run on the CPU here): every rank
    # compensates, and the streamed arm still equals the lock-step arm
    pool = DevicePool("cpu")

    def run(streamed, key):
        ctxs = [CudaCommContext(timeout=15.0, algorithm="psum",
                                compression="int8", chunk_bytes=256,
                                device_pool=pool) for _ in range(2)]
        outs = [None, None]

        def _worker(rank):
            ctxs[rank].configure(key, rank, 2)
            ddp = DistributedDataParallel(_WireStubManager(ctxs[rank], 2),
                                          bucket_bytes=512, streamed=streamed)
            base = _grad_tree(rank)
            per_step = []
            for t in range(3):
                grads = [torch.from_numpy((base[k] * (t + 1)).astype(
                    base[k].dtype)) for k in _KEYS]
                ddp.average_gradients(grads)
                per_step.append(({k: g.numpy().copy()
                                  for k, g in zip(_KEYS, grads)},
                                 _residuals(ddp._arenas[0])))
            outs[rank] = per_step

        with ThreadPoolExecutor(max_workers=2) as ex:
            for f in [ex.submit(_worker, r) for r in range(2)]:
                f.result(timeout=60)
        for c in ctxs:
            c.shutdown()
        return outs

    streamed = run(True, "cuda://ddp_streamed")
    lockstep = run(False, "cuda://ddp_lockstep")
    _assert_same(streamed, lockstep, "cuda psum int8")
    assert all(r is not None for r in streamed[0][-1][1][:3])


def test_pipeline_stage_timers_and_op_wire_metric(store) -> None:
    # per-bucket stage timers land in the manager's sink (d2h/ef/wire/h2d
    # and the two per-step ones), and the transport observes comm_op_wire
    world = 2
    ctxs = [TcpCommContext(timeout=15.0, algorithm="star", channels=3,
                           compression="int8", chunk_bytes=256)
            for _ in range(world)]
    snaps = [None] * world
    ctx_snaps = [None] * world

    def _worker(rank):
        ctx = ctxs[rank]
        ctx.configure(f"{store.addr}/stage_timers", rank, world)
        stub = _WireStubManager(ctx, world)
        ddp = DistributedDataParallel(stub, bucket_bytes=512)
        base = _grad_tree(rank)
        for _ in range(2):
            ddp.average_gradients([torch.from_numpy(base[k].copy())
                                   for k in _KEYS])
        snaps[rank] = stub.metrics.snapshot()
        ctx_snaps[rank] = ctx.metrics.snapshot()

    with ThreadPoolExecutor(max_workers=world) as pool:
        for f in [pool.submit(_worker, r) for r in range(world)]:
            f.result(timeout=60)
    for ctx in ctxs:
        ctx.shutdown()
    snap = snaps[1]  # a star peer: compensable, the ef stage ran
    for stage in ("ddp_d2h", "ddp_ef", "ddp_wire", "ddp_h2d",
                  "ddp_wire_total", "ddp_wire_exposed"):
        assert f"{stage}_avg_ms" in snap, (stage, sorted(snap))
        assert np.isfinite(snap[f"{stage}_avg_ms"])
    assert "ddp_ef_avg_ms" not in snaps[0]  # the root never encodes
    assert "comm_op_wire_avg_ms" in ctx_snaps[0]


# ---------------------------------------------------- arena generations


def _mock_manager():
    m = MagicMock()
    m.is_solo_wire.return_value = False
    m.is_participating.return_value = True
    m.wire_compensable.return_value = False
    m.errored.return_value = None
    m.events = None
    return m


def _donated_delayed_allreduce(delay):
    """Work resolving to the DONATED arrays after ``delay``, the
    transport's contract, so arena aliasing surfaces as wrong values."""

    def _ar(arrays, **kw):
        fut: Future = Future()
        fut.set_running_or_notify_cancel()
        arrs = list(arrays)

        def _complete():
            time.sleep(delay)
            fut.set_result(arrs)

        threading.Thread(target=_complete, daemon=True).start()
        return Work(fut)

    return _ar


def test_arena_generations_allow_overlapping_averages() -> None:
    # two arenas: a second average over another gradient set packs while
    # the first is on the wire; each lands its own values
    manager = _mock_manager()
    manager.allreduce_arrays.side_effect = _donated_delayed_allreduce(0.25)
    ddp = DistributedDataParallel(manager, bucket_bytes=64,
                                  staging_arenas=2)
    grads_a = [torch.arange(32, dtype=torch.float32)]
    grads_b = [torch.arange(32, dtype=torch.float32) * 100.0]
    fut_a = ddp.average_gradients_async(grads_a)
    fut_b = ddp.average_gradients_async(grads_b)  # must not raise
    out_a = fut_a.result(timeout=10)
    out_b = fut_b.result(timeout=10)
    assert out_a[0] is grads_a[0] and out_b[0] is grads_b[0]
    np.testing.assert_array_equal(out_a[0].numpy(),
                                  np.arange(32, dtype=np.float32))
    np.testing.assert_array_equal(out_b[0].numpy(),
                                  np.arange(32, dtype=np.float32) * 100.0)


def test_arena_results_survive_next_pack() -> None:
    # a resolved average's gradients do not alias the staging arena: the
    # next call's pack into the same generation leaves them alone
    manager = _mock_manager()
    manager.allreduce_arrays.side_effect = _donated_delayed_allreduce(0.05)
    ddp = DistributedDataParallel(manager, bucket_bytes=64,
                                  staging_arenas=1)
    out_a = ddp.average_gradients([torch.full((32,), 7.0)])
    snapshot = out_a[0].clone()
    ddp.average_gradients([torch.full((32,), -3.0)])
    assert torch.equal(out_a[0], snapshot)


def test_all_arenas_in_flight_is_a_hard_error() -> None:
    manager = _mock_manager()
    manager.allreduce_arrays.side_effect = _donated_delayed_allreduce(0.4)
    ddp = DistributedDataParallel(manager, bucket_bytes=64,
                                  staging_arenas=2)
    futs = [ddp.average_gradients_async([torch.ones(32)]) for _ in range(2)]
    with pytest.raises(RuntimeError, match="in flight"):
        ddp.average_gradients_async([torch.ones(32)])
    for f in futs:
        f.result(timeout=10)
    # once the averages resolved, acquisition works again
    ddp.average_gradients_async([torch.ones(32)]).result(timeout=10)


def test_single_arena_restores_one_outstanding_guard() -> None:
    manager = _mock_manager()
    manager.allreduce_arrays.side_effect = _donated_delayed_allreduce(0.3)
    ddp = DistributedDataParallel(manager, bucket_bytes=64,
                                  staging_arenas=1)
    fut = ddp.average_gradients_async([torch.ones(16)])
    with pytest.raises(RuntimeError, match="in flight"):
        ddp.average_gradients_async([torch.ones(16)])
    fut.result(timeout=10)


@pytest.mark.parametrize("streamed", [True, False])
def test_midloop_failure_keeps_arena_guard(streamed) -> None:
    # a submit failure after bucket 0 is on the wire must not leave the
    # arena looking free; the guard holds until bucket 0 settles
    manager = _mock_manager()
    delayed = _donated_delayed_allreduce(0.3)
    calls = []

    def _flaky(arrays, **kw):
        calls.append(None)
        if len(calls) == 2:
            raise RuntimeError("submit blew up")
        return delayed(arrays, **kw)

    manager.allreduce_arrays.side_effect = _flaky
    ddp = DistributedDataParallel(manager, bucket_bytes=64,
                                  staging_arenas=1, streamed=streamed)
    # the second bucket (f64) fails to submit
    grads = [torch.ones(32), torch.ones(8, dtype=torch.float64)]
    with pytest.raises(RuntimeError, match="submit blew up"):
        ddp.average_gradients_async(grads)
    with pytest.raises(RuntimeError, match="in flight"):
        ddp.average_gradients_async(grads)
    time.sleep(0.5)  # bucket 0 settles, the guard resolves
    manager.allreduce_arrays.side_effect = delayed
    out = ddp.average_gradients_async(grads).result(timeout=10)
    np.testing.assert_array_equal(out[0].numpy(), np.ones(32, np.float32))


def test_staging_arenas_validation() -> None:
    with pytest.raises(ValueError, match="staging_arenas"):
        DistributedDataParallel(_mock_manager(), staging_arenas=0)
    ddp = DistributedDataParallel(_mock_manager())
    assert ddp._streamed and len(ddp._arenas) == 2  # the defaults


def test_staging_is_reused_and_residuals_reset_on_reconfigure() -> None:
    # a sequential caller reuses arena 0's staging; a new wire generation
    # zeroes the residuals
    manager = _mock_manager()
    manager.wire_compensable.return_value = True
    manager.wire_generation.return_value = 1
    manager.wire_roundtrip.side_effect = lambda src, out: np.copyto(
        out, src.astype(np.float16).astype(src.dtype))
    manager.allreduce_arrays.side_effect = lambda arrays, **kw: \
        CompletedWork(list(arrays))
    ddp = DistributedDataParallel(manager, bucket_bytes=64)
    ddp.average_gradients([torch.full((8,), 1.0001)])
    staging = ddp._arenas[0].staging[0]
    assert ddp._residuals[0].any()
    ddp.average_gradients([torch.full((8,), 1.0001)])
    assert ddp._arenas[0].staging[0] is staging
    assert ddp._arenas[1].staging is None
    manager.wire_generation.return_value = 2
    manager.wire_roundtrip.side_effect = lambda src, out: np.copyto(out, src)
    ddp.average_gradients([torch.full((8,), 1.0001)])
    assert ddp._ef_generation == 2 and not ddp._residuals[0].any()


# ------------------------------------------------------ Pure DDP parity


def test_pure_ddp_latches_quorum_failure() -> None:
    manager = _mock_manager()
    manager.wait_quorum.side_effect = TimeoutError("quorum timed out")
    grads = [torch.ones(4)]
    out = PureDistributedDataParallel(manager).average_gradients(grads)
    manager.report_error.assert_called_once()
    assert isinstance(manager.report_error.call_args[0][0], TimeoutError)
    assert out[0] is grads[0] and torch.equal(out[0], torch.ones(4))
    manager.allreduce_arrays.assert_not_called()


def test_pure_ddp_solo_wire_fast_path() -> None:
    manager = _mock_manager()
    manager.is_solo_wire.return_value = True
    grads = [torch.full((4,), 3.0)]
    out = PureDistributedDataParallel(manager).average_gradients(grads)
    assert out[0] is grads[0]
    manager.allreduce_arrays.assert_not_called()
    manager.wait_quorum.assert_called_once()


def test_pure_ddp_still_averages_with_peers() -> None:
    manager = _mock_manager()
    manager.allreduce_arrays.side_effect = lambda arrays, **kw: (
        CompletedWork([np.array(a, copy=True) * 0.5 for a in arrays]))
    w = torch.nn.Parameter(torch.zeros(2))
    b = torch.nn.Parameter(torch.zeros(1))
    w.grad, b.grad = torch.full((2,), 3.0), torch.ones(1)
    PureDistributedDataParallel(manager).average_gradients([w, b])
    np.testing.assert_allclose(w.grad.numpy(), np.full(2, 1.5))
    np.testing.assert_allclose(b.grad.numpy(), np.full(1, 0.5))
    assert manager.allreduce_arrays.call_count == 2  # one per leaf
    manager.wait_quorum.assert_called_once()


# ---------------------------------------- the optimizer takes the future


def _commit_manager(local: bool = True):
    manager = MagicMock()
    manager.did_heal.return_value = False
    manager.current_step.return_value = 0

    def _commit_async(**kw):
        fut = completed_future(local)
        fut.local_should_commit = local
        return fut

    manager.should_commit_async.side_effect = _commit_async
    return manager


def test_optimizer_step_accepts_grads_future() -> None:
    # a loop hands the UNRESOLVED average future straight to step()
    manager = _mock_manager()
    manager.allreduce_arrays.side_effect = _donated_delayed_allreduce(0.1)
    w = torch.nn.Parameter(torch.ones(3))
    w.grad = torch.full((3,), 2.0)
    ddp = DistributedDataParallel(manager, bucket_bytes=64)
    opt = OptimizerWrapper(_commit_manager(), torch.optim.SGD([w], lr=0.1))
    fut = ddp.average_gradients_async([w])
    assert opt.step(fut)
    np.testing.assert_allclose(w.detach().numpy(), np.full(3, 0.8),
                               rtol=1e-6)
    # and as the keyword, beside the loss
    w.grad = torch.full((3,), 2.0)
    assert opt.step(torch.tensor(1.0), grads=ddp.average_gradients_async([w]))
    np.testing.assert_allclose(w.detach().numpy(), np.full(3, 0.6),
                               rtol=1e-6)


def test_optimizer_step_latches_a_failed_future() -> None:
    manager = _commit_manager(local=False)
    w = torch.nn.Parameter(torch.ones(3))
    w.grad = torch.ones(3)
    opt = OptimizerWrapper(manager, torch.optim.SGD([w], lr=0.1))
    assert not opt.step(failed_future(ConnectionError("wire down")))
    err = manager.report_error.call_args[0][0]
    assert isinstance(err, ConnectionError)
    assert torch.equal(w.detach(), torch.ones(3))


def test_overlapping_averages_under_thread_stress() -> None:
    # one submitter overlapping two gradient sets on two arenas, round
    # after round, with wire completions landing in random order on other
    # threads and a short switch interval: each set lands its own values,
    # and of 16 threads racing for the two arenas exactly two win
    import random
    import sys

    rnd = random.Random(0)

    def _ar(arrays, **kw):
        fut: Future = Future()
        fut.set_running_or_notify_cancel()
        arrs = list(arrays)
        delay = rnd.random() * 2e-3

        def _complete():
            time.sleep(delay)
            fut.set_result(arrs)

        threading.Thread(target=_complete, daemon=True).start()
        return Work(fut)

    manager = _mock_manager()
    manager.allreduce_arrays.side_effect = _ar
    ddp = DistributedDataParallel(manager, bucket_bytes=64,
                                  staging_arenas=2)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for i in range(100):
            sets = [[torch.full((32,), float(v)),
                     torch.full((8,), float(v), dtype=torch.float64)]
                    for v in (i, -i - 0.5)]
            futs = [ddp.average_gradients_async(g) for g in sets]
            for v, f in zip((i, -i - 0.5), futs):
                out = f.result(timeout=10)
                assert all(bool((t == v).all()) for t in out), (i, v)
        manager.allreduce_arrays.side_effect = _donated_delayed_allreduce(
            0.5)
        wins, losses = [], []
        start = threading.Barrier(16, timeout=10)

        def _race():
            start.wait()
            try:
                wins.append(ddp.average_gradients_async(
                    [torch.ones(32), torch.ones(8, dtype=torch.float64)]))
            except RuntimeError as e:
                losses.append(e)

        racers = [threading.Thread(target=_race) for _ in range(16)]
        for t in racers:
            t.start()
        for t in racers:
            t.join(timeout=30)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(interval)
    assert len(wins) == 2 and len(losses) == 14
    assert all("in flight" in str(e) for e in losses)
    for f in wins:
        f.result(timeout=10)
