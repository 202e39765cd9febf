"""The port's Manager, DDP and OptimizerWrapper semantics.

Twins of the manager cases of tests/test_manager.py over real servers:
allreduce scaling by participants, the error latch and its commit veto,
the solo-wire identity, the required quorum floor, DDP's frozen bucket
plan, ``reduce_scatter_arrays``/``allgather_arrays`` across two groups,
and the ``topology`` keyword forwarded (only when set) through the
Manager, its wrappers and DDP.
"""

import threading

import numpy as np
import pytest
import torch

from torchft_tpu_torch.comm.context import DummyCommContext, ReduceOp
from torchft_tpu_torch.comm.store import StoreServer
from torchft_tpu_torch.comm.transport import TcpCommContext
from torchft_tpu_torch.control import Lighthouse
from torchft_tpu_torch.ddp import DistributedDataParallel, _BucketPlan
from torchft_tpu_torch.examples.train_ddp import _wait_lighthouse
from torchft_tpu_torch.manager import Manager
from torchft_tpu_torch.optim import OptimizerWrapper


def _manager(lh, store, comm=None, name="rep", **kw):
    return Manager(comm=comm or TcpCommContext(timeout=10.0),
                   min_replica_size=kw.pop("min_replica_size", 1), rank=0,
                   world_size=1, store_addr=store.addr,
                   lighthouse_addr=lh.address(), replica_id=f"{name}_",
                   timeout=10.0, quorum_timeout=10.0, connect_timeout=10.0,
                   heartbeat_interval=0.05, **kw)


@pytest.fixture()
def infra():
    lh = Lighthouse(min_replicas=1, join_timeout_ms=100)
    stores = [StoreServer(), StoreServer()]
    yield lh, stores
    for s in stores:
        s.shutdown()
    lh.shutdown()


def test_min_replica_size_is_required(infra) -> None:
    lh, stores = infra
    with pytest.raises(TypeError, match="min_replica_size"):
        Manager(comm=DummyCommContext(), rank=0, world_size=1,
                store_addr=stores[0].addr, lighthouse_addr=lh.address())


def test_solo_step_commits_and_latch_vetoes(infra) -> None:
    lh, stores = infra
    m = _manager(lh, stores[0])
    try:
        m.start_quorum()
        out = m.allreduce_arrays([np.full(4, 3.0, np.float32)])
        assert np.array_equal(out.future().result(timeout=10)[0],
                              np.full(4, 3.0, np.float32))
        assert m.is_solo_wire()
        assert m.should_commit()
        assert m.current_step() == 1 and m.num_participants() == 1
        m.start_quorum()
        m.report_error(RuntimeError("injected"))
        # errored: allreduce is an identity, the commit is vetoed
        a = np.ones(2, np.float32)
        assert m.allreduce_arrays([a]).future().result()[0] is a
        assert not m.should_commit()
        assert m.current_step() == 1
        m.start_quorum()  # a new quorum clears the latch
        assert m.errored() is None
        assert m.should_commit()
        assert m.state_dict() == {"step": 2, "batches_committed": 2}
    finally:
        m.shutdown(wait=False)


def test_two_groups_average_over_participants(infra) -> None:
    lh, stores = infra
    results = [None, None]

    def group(i):
        # step 0 heals every group from one donor (the init sync), so
        # both carry state dict functions
        m = _manager(lh, stores[i], name=f"g{i}",
                     state_dict=lambda: {"w": np.zeros(3, np.float32)},
                     load_state_dict=lambda sd: None)
        try:
            # both heartbeating before either asks for a quorum, so neither
            # forms one alone
            _wait_lighthouse(lh.address(), "healthy", 2, 20.0,
                             threading.Event())
            for _ in range(3):  # the first step is the step-0 init heal
                m.start_quorum()
                a = np.full(8, float(i + 1), np.float32)
                avg = m.allreduce_arrays([a], op=ReduceOp.AVG)
                got = avg.future().result(timeout=20)[0]
                if m.should_commit():
                    results[i] = (got.copy(), m.num_participants())
        finally:
            m.shutdown(wait=False)

    threads = [threading.Thread(target=group, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    for got, parts in results:
        assert parts == 2
        assert np.array_equal(got, np.full(8, 1.5, np.float32))


def test_transport_rank_is_the_wire_rank(infra) -> None:
    # after wait_quorum, transport_rank() is the comm context's configured
    # rank; on a solo wire it is 0 (reference manager.py:1677-1682)
    lh, stores = infra
    seen = {}

    def group(i):
        m = _manager(lh, stores[i], name=f"tr{i}",
                     state_dict=lambda: {"w": np.zeros(3, np.float32)},
                     load_state_dict=lambda sd: None)
        try:
            _wait_lighthouse(lh.address(), "healthy", 2, 20.0,
                             threading.Event())
            m.start_quorum()
            m.wait_quorum()
            seen[i] = (m.transport_rank(), m._comm.rank(),
                       m.transport_world_size())
            m.allreduce_arrays([np.ones(4, np.float32)]).future().result(
                timeout=20)
            m.should_commit()
        finally:
            m.shutdown(wait=False)

    threads = [threading.Thread(target=group, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert sorted(r for r, _, _ in seen.values()) == [0, 1]
    assert all(r == ctx for r, ctx, _ in seen.values())
    assert all(w == 2 for _, _, w in seen.values())

    alone = Lighthouse(min_replicas=1, join_timeout_ms=100)
    solo = _manager(alone, stores[0], name="tr_solo")
    try:
        solo.start_quorum()
        solo.wait_quorum()
        assert solo.is_solo_wire()
        assert solo.transport_rank() == 0
    finally:
        solo.shutdown(wait=False)
        alone.shutdown()


def test_avg_rejects_integer_arrays(infra) -> None:
    lh, stores = infra
    m = _manager(lh, stores[0])
    try:
        with pytest.raises(ValueError, match="floating"):
            m.allreduce_arrays([np.ones(2, np.int32)], op=ReduceOp.AVG)
    finally:
        m.shutdown(wait=False)


def test_optimizer_wrapper_gates_step(infra) -> None:
    lh, stores = infra
    m = _manager(lh, stores[0])
    model = torch.nn.Linear(3, 2)
    opt = OptimizerWrapper(m, torch.optim.SGD(model.parameters(), lr=0.1))
    ddp = DistributedDataParallel(m)
    try:
        before = [p.detach().clone() for p in model.parameters()]
        opt.begin_step()
        model(torch.ones(4, 3)).sum().backward()
        ddp.average_gradients(model)  # solo wire: identity
        m.report_error(RuntimeError("discard this step"))
        assert not opt.step()
        assert all(torch.equal(a, b)
                   for a, b in zip(before, model.parameters()))
        opt.begin_step()
        assert all(float(p.grad.abs().sum()) == 0
                   for p in model.parameters())
        model(torch.ones(4, 3)).sum().backward()
        ddp.average_gradients(model)
        assert opt.step()
        assert not all(torch.equal(a, b)
                       for a, b in zip(before, model.parameters()))
    finally:
        m.shutdown(wait=False)


def test_bucket_plan_is_frozen_and_dtype_grouped() -> None:
    params = [torch.zeros(10), torch.zeros(3, dtype=torch.float64),
              torch.zeros(20), torch.zeros(5)]
    plan = _BucketPlan(params, bucket_bytes=100)
    # f32 buckets of <= 100 bytes in parameter order, then the f64 one
    assert plan.buckets == [[0], [2, 3], [1]]
    assert list(plan.slices(1)) == [(2, 0, 20), (3, 20, 5)]
    staging = plan.alloc_staging(pin=False)
    assert [s.numel() for s in staging] == [10, 25, 3]

    class _Solo:
        metrics = None

        def wait_quorum(self):
            pass

        def is_solo_wire(self):
            return False

    ddp = DistributedDataParallel(_Solo())
    ddp._get_plan(params)
    with pytest.raises(ValueError, match="frozen"):
        ddp._get_plan([torch.zeros(11)])


class _RecordingComm(DummyCommContext):
    """An identity context that records the keywords each collective got."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def allreduce(self, arrays, op=ReduceOp.SUM, **kw):
        self.calls.append(("allreduce", op, kw))
        return super().allreduce(arrays, op)

    def reduce_scatter(self, arrays, op=ReduceOp.SUM, owners=None):
        self.calls.append(("reduce_scatter", op, {"owners": owners}))
        return super().reduce_scatter(arrays, op, owners)


def test_topology_is_forwarded_only_when_set(infra) -> None:
    from torchft_tpu_torch.comm.context import (
        ErrorSwallowingCommContext,
        ManagedCommContext,
    )

    lh, stores = infra
    comm = _RecordingComm()
    m = _manager(lh, stores[0], comm=comm)
    try:
        m.start_quorum()
        a = np.ones(4, np.float32)
        m.allreduce_arrays([a]).future().result(timeout=10)
        m.allreduce_arrays([a], topology="hier").future().result(timeout=10)
        ManagedCommContext(m).allreduce([a], topology="flat").wait(10)
        ErrorSwallowingCommContext(comm).allreduce([a], topology="hier")
        out = m.reduce_scatter_arrays([a, a.copy()], op=ReduceOp.AVG)
        assert len(out.future().result(timeout=10)) == 2
        gathered = m.allgather_arrays([a]).future().result(timeout=10)
        assert len(gathered) == 1 and gathered[0][0] is not None
        # the DDP buckets carry it too
        p = torch.nn.Parameter(torch.ones(3))
        p.grad = torch.ones(3)
        DistributedDataParallel(m, topology="hier").average_gradients([p])
        assert m.should_commit()
    finally:
        m.shutdown(wait=False)
    kws = [kw for name, _, kw in comm.calls if name == "allreduce"]
    assert kws == [{}, {"topology": "hier"}, {"topology": "flat"},
                   {"topology": "hier"}]
    assert comm.calls[-1] == ("reduce_scatter", ReduceOp.SUM,
                              {"owners": [0, 0]})
    with pytest.raises(ValueError, match="error_feedback"):
        DistributedDataParallel(m, error_feedback="yes")


def test_reduce_scatter_and_allgather_across_groups(infra) -> None:
    from torchft_tpu_torch.comm.topology import DomainTopology

    lh, stores = infra
    results = {}

    def group(i):
        # a hier-default context: the Manager hands it the wire cohort and a
        # resolver on its lighthouse, whose flat /status.json maps every
        # group to the one "default" domain (the intra tier alone)
        comm = TcpCommContext(timeout=10.0, algorithm="star",
                              topology="hier")
        m = _manager(lh, stores[i], comm=comm, name=f"rs{i}",
                     state_dict=lambda: {"w": np.zeros(3, np.float32)},
                     load_state_dict=lambda sd: None)
        try:
            assert isinstance(comm._domain_resolver, DomainTopology)
            _wait_lighthouse(lh.address(), "healthy", 2, 20.0,
                             threading.Event())
            for _ in range(3):  # the first step is the step-0 init heal
                m.start_quorum()
                r = m.transport_rank()
                own = [np.full(6, float(i + 1), np.float32),
                       np.full(5, 10.0 * (i + 1), np.float32)]
                rs = m.reduce_scatter_arrays(own, op=ReduceOp.AVG)
                rs = [x.copy() for x in rs.future().result(timeout=20)]
                ag = m.allgather_arrays([np.full(2, float(i), np.float32)])
                ag = ag.future().result(timeout=20)
                ar = m.allreduce_arrays([np.full(4, float(i + 1),
                                                 np.float32)])
                ar = ar.future().result(timeout=20)[0].copy()
                flat = m.allreduce_arrays([np.full(4, float(i + 1),
                                                   np.float32)],
                                          topology="flat")
                flat = flat.future().result(timeout=20)[0].copy()
                if m.should_commit():
                    results[i] = (r, rs, [g[0].copy() for g in ag], ar,
                                  flat, m.metrics.snapshot(),
                                  list(comm._wire_members))
        finally:
            m.shutdown(wait=False)

    threads = [threading.Thread(target=group, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=90)
        assert not t.is_alive()
    assert len(results) == 2
    by_rank = {v[0]: (g, v) for g, v in results.items()}
    for r, (g, (_, rs, ag, ar, flat, snap, members)) in by_rank.items():
        # array r is owned by rank r: its average lands there
        want = np.full(6, 1.5, np.float32) if r == 0 \
            else np.full(5, 15.0, np.float32)
        assert np.array_equal(rs[r], want)
        assert [float(x[0]) for x in ag] == [float(by_rank[k][0])
                                             for k in (0, 1)]
        assert np.array_equal(ar, np.full(4, 1.5, np.float32))
        assert np.array_equal(flat, ar)
        assert len(members) == 2 and all("rs" in x for x in members)
        assert snap["comm_intra_bytes"] > 0
        assert snap["comm_inter_bytes"] == 0.0  # one domain
