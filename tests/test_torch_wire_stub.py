"""The port's ``comm.wire_stub`` against the JAX package's.

``WireStubManager`` carries every public name of the reference's stub (the
surface the outer-sync and sharded-update wrappers probe by name), AVG
divides float payloads by the wire world and leaves integers summed, a
reduce_scatter scales only the owned arrays, and ``should_commit`` is the
error-latch vote: a reported error aborts until the next ``start_quorum``.
``run_stub_ranks`` aggregates a rank's failure into one error. Tolerance:
bitwise (a float32 sum of two ranks times 0.5 is exact here).
"""

import numpy as np
import pytest

from torchft_tpu.comm.wire_stub import WireStubManager as JaxWireStub
from torchft_tpu_torch.comm.context import DummyCommContext
from torchft_tpu_torch.comm.store import StoreServer
from torchft_tpu_torch.comm.transport import TcpCommContext
from torchft_tpu_torch.comm.wire_stub import WireStubManager, run_stub_ranks
from torchft_tpu_torch.utils.events import EventRecorder
from torchft_tpu_torch.utils.metrics import Metrics


@pytest.fixture()
def store():
    server = StoreServer()
    yield server
    server.shutdown()


def _public(cls):
    return {n for n in dir(cls) if not n.startswith("_")}


def test_surface_matches_the_reference() -> None:
    assert _public(JaxWireStub) <= _public(WireStubManager)
    for name in ("wire_compensable", "quorum_fence", "wire_nbytes",
                 "reduce_scatter_arrays", "allgather_arrays",
                 "wire_generation", "transport_world_size",
                 "transport_rank"):
        assert callable(getattr(WireStubManager, name)), name
    mgr = WireStubManager(DummyCommContext(), 1)
    assert isinstance(mgr.events, EventRecorder)
    assert isinstance(mgr.metrics, Metrics)
    assert mgr.metrics.snapshot()["comm_backend"] == "none"


def test_avg_scales_floats_and_the_latch_votes(store) -> None:
    rng = np.random.default_rng(3)
    base = rng.standard_normal(37).astype(np.float32)

    def fn(mgr, rank):
        x = (base * (rank + 1)).astype(np.float32)
        n = np.full(5, rank + 1, np.int32)
        avg, ints = mgr.allreduce_arrays([x.copy(), n.copy()]).future(
        ).result(20)
        owned = mgr.reduce_scatter_arrays(
            [x.copy(), x.copy()], owners=[0, 1]).future().result(20)
        gathered = mgr.allgather_arrays([n]).future().result(20)
        votes = [mgr.should_commit()]
        mgr.report_error(RuntimeError("a fragment op failed"))
        mgr.report_error(RuntimeError("a second error keeps the first"))
        votes += [mgr.should_commit(), str(mgr.errored())]
        mgr.start_quorum()
        votes.append(mgr.should_commit())
        return avg, ints, owned, gathered, votes, mgr.transport_rank()

    res = run_stub_ranks(store.addr, "stub", 2, fn,
                         lambda: TcpCommContext(timeout=15.0), timeout=60)
    want = ((base * 1 + base * 2) * np.float32(0.5)).astype(np.float32)
    for rank, (avg, ints, owned, gathered, votes, trank) in enumerate(res):
        assert trank == rank
        assert avg.tobytes() == want.tobytes()
        assert ints.dtype == np.int32 and (ints == 3).all()  # summed, raw
        assert owned[rank].tobytes() == want.tobytes()  # owned: scaled
        assert [g[0].tolist() for g in gathered] == [[1] * 5, [2] * 5]
        assert votes == [True, False, "a fragment op failed", True]


def test_run_stub_ranks_aggregates_a_rank_failure(store) -> None:
    def fn(mgr, rank):
        if rank == 1:
            raise ValueError("rank one broke")
        return rank

    with pytest.raises(RuntimeError, match="rank 1: ValueError"):
        run_stub_ranks(store.addr, "fail", 2, fn,
                       lambda: DummyCommContext(), timeout=30)
