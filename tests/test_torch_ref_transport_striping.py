"""The cases of tests/test_transport_striping.py over the port: the chunk
grid, striping's bitwise invisibility for every codec, both topologies and
both chunk sizes, in-place reduction, the stripe knob, pipelined ops and
the wire round trip's roles, under the reference's names and assertions
(tests/test_torch_twin.py says how).

Its four DDP error-feedback cases hand DDP dicts of numpy arrays, which
the port's DDP (torch tensors, as its training loops give it) does not
take; in a copy with only the package renamed one of them even passed
with nothing checked, its assertions on threads whose exceptions nobody
read. They are held below under their names, on lists of tensors, over
the reference's own ``_WireStubManager`` (compiled here on the port),
each worker's exception raised.
"""

import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from tests.test_torch_twin import reference_twin

_DDP_CASES = ("test_int8_error_feedback_converges_where_raw_drifts",
              "test_error_feedback_residuals_reset_on_reconfigure",
              "test_error_feedback_survives_nonfinite_gradient",
              "test_error_feedback_auto_off_for_lossless_wire")

reference_twin(globals(), "test_transport_striping",
               drop=dict.fromkeys(_DDP_CASES, "below, on tensors"))


def _ranks(world, fn, timeout=120):
    with ThreadPoolExecutor(max_workers=world) as pool:
        return [f.result(timeout=timeout)
                for f in [pool.submit(fn, r) for r in range(world)]]


def _descend_tensors(store, prefix, codec, error_feedback, steps, targets,
                     chunk_bytes=64, tail=50):
    """The reference's ``_descend`` with the gradient a list of one
    tensor: rank 0's Polyak tail average."""
    world = len(targets)
    ctxs = [TcpCommContext(timeout=15.0, algorithm="star", channels=2,
                           compression=codec, chunk_bytes=chunk_bytes)
            for _ in range(world)]

    def _worker(rank):
        ctx = ctxs[rank]
        ctx.configure(f"{store.addr}/{prefix}", rank, world)
        ddp = DistributedDataParallel(_WireStubManager(ctx, world),
                                      error_feedback=error_feedback)
        x = np.zeros_like(targets[rank])
        acc = np.zeros(x.shape, np.float64)
        for t in range(steps):
            avg = ddp.average_gradients(
                [torch.from_numpy(x - targets[rank])])
            x = x - 0.2 * avg[0].numpy()
            if t >= steps - tail:
                acc += x
        return (acc / tail).astype(np.float32)

    try:
        return _ranks(world, _worker)[0]
    finally:
        for ctx in ctxs:
            ctx.shutdown()


def test_int8_error_feedback_converges_where_raw_drifts(store) -> None:
    rng = np.random.default_rng(17)
    targets = []
    for _ in range(2):
        t = rng.standard_normal(48).astype(np.float32)
        t[:4] *= 100.0
        targets.append(t)
    optimum = (targets[0] + targets[1]) / 2.0
    x_fp32 = _descend_tensors(store, "ef_fp32", "none", "auto", 200, targets)
    x_raw = _descend_tensors(store, "ef_raw", "int8", False, 200, targets)
    x_ef = _descend_tensors(store, "ef_on", "int8", "auto", 200, targets)
    err_fp32 = float(np.max(np.abs(x_fp32 - optimum)))
    err_raw = float(np.max(np.abs(x_raw - optimum)))
    err_ef = float(np.max(np.abs(x_ef - optimum)))
    assert err_fp32 < 1e-4
    assert err_ef < 2e-2, f"int8+EF did not converge (err={err_ef})"
    assert err_raw > 1e-1, f"raw int8 unexpectedly converged ({err_raw})"
    assert err_raw > 10 * err_ef, (err_raw, err_ef)


def test_error_feedback_residuals_reset_on_reconfigure(store) -> None:
    world = 2
    rng = np.random.default_rng(23)
    grads = [rng.standard_normal(32).astype(np.float32) * (r + 1)
             for r in range(world)]
    ctxs = [TcpCommContext(timeout=15.0, algorithm="star", channels=2,
                           compression="int8", chunk_bytes=64)
            for _ in range(world)]
    barrier = threading.Barrier(world, timeout=30)

    def _worker(rank):
        ctx = ctxs[rank]
        ddp = DistributedDataParallel(_WireStubManager(ctx, world),
                                      error_feedback="auto")
        gen = None
        for round_no in range(2):
            barrier.wait()
            ctx.configure(f"{store.addr}/efgen{round_no}", rank, world)
            barrier.wait()
            ddp.average_gradients([torch.from_numpy(grads[rank].copy())])
            if round_no == 0:
                if rank != 0:
                    # star peer: the int8 error of its compensated gradient
                    res = ddp._residuals[0]
                    assert res is not None and float(np.abs(res).max()) > 0
                    gen = ddp._ef_generation
                else:
                    # star root: never encoded, so no arena at all
                    assert ddp._residuals is None
                barrier.wait()
            elif rank != 0:
                assert ddp._ef_generation == ctx.wire_generation()
                assert ddp._ef_generation != gen
        return True

    try:
        assert _ranks(world, _worker, timeout=60) == [True, True]
    finally:
        for ctx in ctxs:
            ctx.shutdown()


def test_error_feedback_survives_nonfinite_gradient(store) -> None:
    world = 2
    targets = [np.full(32, 1.0 + r, np.float32) for r in range(world)]
    ctxs = [TcpCommContext(timeout=15.0, algorithm="star", channels=2,
                           compression="int8", chunk_bytes=64)
            for _ in range(world)]

    def _worker(rank):
        ctx = ctxs[rank]
        ctx.configure(f"{store.addr}/efnan", rank, world)
        ddp = DistributedDataParallel(_WireStubManager(ctx, world),
                                      error_feedback="auto")
        x = np.zeros_like(targets[rank])
        for t in range(12):
            grad = x - targets[rank]
            if t == 3 and rank == 1:
                grad[0] = np.inf  # a transient spike on the peer
            avg = ddp.average_gradients([torch.from_numpy(grad)])
            if t != 3:  # the poisoned step's average is NaN by design
                x = x - 0.2 * avg[0].numpy()
            if ddp._residuals is not None and t >= 3:
                assert np.all(np.isfinite(ddp._residuals[0])), (rank, t)
        return x

    try:
        finals = _ranks(world, _worker, timeout=60)
    finally:
        for ctx in ctxs:
            ctx.shutdown()
    for x in finals:
        assert np.all(np.isfinite(x))
        assert abs(float(x[1]) - 1.5) < 0.2


def test_error_feedback_auto_off_for_lossless_wire(store) -> None:
    world = 2
    grads = [np.full(16, float(r + 1), np.float32) for r in range(world)]
    ctxs = [TcpCommContext(timeout=15.0, algorithm="star", channels=2)
            for _ in range(world)]

    def _worker(rank):
        ctx = ctxs[rank]
        ctx.configure(f"{store.addr}/efoff", rank, world)
        ddp = DistributedDataParallel(_WireStubManager(ctx, world),
                                      error_feedback="auto")
        out = ddp.average_gradients([torch.from_numpy(grads[rank].copy())])
        assert ddp._residuals is None
        return out[0].numpy()

    try:
        outs = _ranks(world, _worker, timeout=30)
    finally:
        for ctx in ctxs:
            ctx.shutdown()
    for out in outs:
        np.testing.assert_allclose(out, np.full(16, 1.5, np.float32))
