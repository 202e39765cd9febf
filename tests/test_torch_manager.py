"""The port's Manager, DDP and OptimizerWrapper semantics.

Twins of the manager cases of tests/test_manager.py over real servers:
allreduce scaling by participants, the error latch and its commit veto,
the solo-wire identity, the required quorum floor, DDP's frozen bucket
plan, ``reduce_scatter_arrays``/``allgather_arrays`` across two groups,
and the ``topology`` keyword forwarded (only when set) through the
Manager, its wrappers and DDP.

Then every case of tests/test_manager.py over its mocked control plane,
run on both packages' Managers with the same fabricated quorum answers:
each asserts the reference case's expectations on both and that the two
agree (the configure calls, participation, step, commits, the latched
error's type, the values returned, a healed state bitwise). An answer
without data-plane membership configures the full-membership wire
(``.../all/...``) and, in sync mode, counts every replica as
participating, as the reference reads it.
"""

import threading
from concurrent.futures import Future

import numpy as np
import pytest
import torch

from torchft_tpu_torch.comm.context import DummyCommContext, ReduceOp
from torchft_tpu_torch.comm.store import StoreClient, StoreServer
from torchft_tpu_torch.comm.transport import TcpCommContext
from torchft_tpu_torch.control import Lighthouse
from torchft_tpu_torch.ddp import DistributedDataParallel, _BucketPlan
from torchft_tpu_torch.examples.train_ddp import _wait_lighthouse
from torchft_tpu_torch.manager import Manager
from torchft_tpu_torch.optim import OptimizerWrapper
from torchft_tpu_torch.utils.serialization import (
    from_host,
    to_numpy,
    tree_flatten_with_path,
)


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


# --- observers, jobs, stages and the mesh label, against the JAX package ----
# Both packages' Managers over a mocked control plane (the reference's
# test_manager.py harness): the same fabricated quorum answers must drive
# the same wire configuration, participation and heal decisions.


def _mocked_manager(pkg, store, state=None, **kwargs):
    from unittest.mock import MagicMock, patch

    import torchft_tpu.comm.context as jctx
    import torchft_tpu.manager as jmanager
    import torchft_tpu_torch.comm.context as pctx
    import torchft_tpu_torch.manager as pmanager

    mod, ctx = (pmanager, pctx) if pkg == "torch" else (jmanager, jctx)

    class FakeComm(ctx.CommContext):
        """Identity-sum wire recording its configure calls and the ops it
        reduced; ``fail_next`` fails the next allreduce with that
        exception, ``hang_next`` leaves it never completing."""

        def __init__(self) -> None:
            super().__init__()
            self.configure_calls = []
            self.ops = []
            self.fail_next = None
            self.hang_next = False

        def configure(self, store_addr, rank, world_size):
            self.configure_calls.append((store_addr, rank, world_size))
            self._rank, self._world_size = rank, world_size

        def allreduce(self, arrays, op=ReduceOp.SUM, topology=None):
            self.ops.append(op)
            if self.fail_next is not None:
                exc, self.fail_next = self.fail_next, None
                return ctx.FailedWork(exc)
            if self.hang_next:
                self.hang_next = False
                return ctx.Work(Future())
            return ctx.CompletedWork([np.array(a, copy=True)
                                      for a in arrays])

        def allgather(self, arrays):
            return ctx.CompletedWork([list(arrays)])

        def broadcast(self, arrays, root=0):
            return ctx.CompletedWork(list(arrays))

    state = {"w": np.zeros(2)} if state is None else state

    def load_state_dict(sd):
        state.clear()
        state.update(sd)

    defaults = dict(min_replica_size=2, use_async_quorum=True, rank=0,
                    world_size=1, store_addr=store.addr,
                    lighthouse_addr="http://mock-lighthouse:1", timeout=5.0,
                    quorum_timeout=5.0, connect_timeout=5.0)
    defaults.update(kwargs)
    comm = FakeComm()
    with patch.object(mod, "ManagerServer") as server, \
            patch.object(mod, "ManagerClient") as client_cls:
        server.return_value.address.return_value = "http://mock:1"
        client = MagicMock()
        client_cls.return_value = client
        manager = mod.Manager(comm=comm, load_state_dict=load_state_dict,
                              state_dict=lambda: dict(state), **defaults)
    return manager, client, comm, server


def _quorum(pkg, **kw):
    import torchft_tpu.control as jctrl
    import torchft_tpu_torch.control as pctrl

    d = dict(quorum_id=1, replica_rank=0, replica_world_size=2,
             recover_src_manager_address="", recover_src_rank=None,
             recover_dst_ranks=[], store_address="store", max_step=0,
             max_rank=0, max_world_size=2, max_replica_ids=[],
             transport_rank=None, transport_world_size=0,
             transport_replica_ids=[], heal=False)
    d.update(kw)
    return (pctrl if pkg == "torch" else jctrl).QuorumResult(**d)


@pytest.fixture()
def mstore():
    server = StoreServer()
    yield server
    server.shutdown()


def _both(mstore, states=None, **kwargs):
    """Each package's mocked Manager on the same arguments. ``states``: a
    dict that receives each package's user state, the dict its
    ``load_state_dict`` loads a heal into."""
    out = {}
    for pkg in ("torch", "jax"):
        state = {"w": np.zeros(2)}
        if states is not None:
            states[pkg] = state
        out[pkg] = _mocked_manager(pkg, mstore, state=state, **kwargs)
    return out


def test_transport_scoped_to_data_plane_members(mstore) -> None:
    # the wire spans the data-plane members: an observer in the quorum
    # widens nothing, and a change of the wire's members reconfigures
    # under the same quorum id
    seen = {}
    for pkg, (m, client, comm, _) in _both(mstore).items():
        try:
            client.quorum.return_value = _quorum(
                pkg, replica_world_size=3, max_step=5, max_world_size=2,
                transport_rank=0, transport_world_size=2,
                transport_replica_ids=["a", "b"])
            m.start_quorum()
            m.wait_quorum()
            m.start_quorum()
            m.wait_quorum()
            assert len(comm.configure_calls) == 1
            assert m.num_participants() == 2
            client.quorum.return_value = _quorum(
                pkg, replica_world_size=3, max_step=5, max_world_size=3,
                transport_rank=0, transport_world_size=3,
                transport_replica_ids=["a", "b", "c"])
            m.start_quorum()
            m.wait_quorum()
            seen[pkg] = list(comm.configure_calls)
        finally:
            m.shutdown(wait=False)
    assert seen["torch"] == seen["jax"]
    (p1, r1, w1), (p2, r2, w2) = seen["torch"]
    assert (r1, w1, r2, w2) == (0, 2, 0, 3)
    assert "/observer/" not in p1 and p1 != p2


def test_observer_gets_solo_transport_and_never_participates(mstore) -> None:
    # an observer in the max-step cohort is still off the wire: a private
    # one-member transport, never participating, contributing zeros
    seen = {}
    for pkg, (m, client, comm, _) in _both(mstore, data_plane=False).items():
        try:
            client.quorum.return_value = _quorum(
                pkg, replica_rank=2, replica_world_size=3, max_step=0,
                max_rank=2, max_world_size=3, transport_rank=None,
                transport_world_size=2, transport_replica_ids=["a", "b"])
            m.start_quorum(allow_heal=False)
            m.wait_quorum()
            assert not m.is_participating() and not m.is_solo_wire()
            assert m.transport_world_size() == 1
            fut = m.allreduce_arrays([np.full(2, 5.0, np.float32)]).future()
            assert np.array_equal(fut.result(timeout=5)[0], np.zeros(2))
            seen[pkg] = (comm.configure_calls,
                         client.quorum.call_args.kwargs["data_plane"])
            rid = m.replica_id() if pkg == "torch" else m._replica_id
            assert comm.configure_calls[0][0].endswith(f"/observer/{rid}/0")
        finally:
            m.shutdown(wait=False)
    (calls_t, dp_t), (calls_j, dp_j) = seen["torch"], seen["jax"]
    assert dp_t is dp_j is False
    assert [(r, w) for _, r, w in calls_t] == [(r, w) for _, r, w in calls_j]
    assert calls_t[0][0].rsplit("/", 3)[0] == calls_j[0][0].rsplit("/", 3)[0]


def test_observer_start_quorum_forces_allow_heal_false(mstore) -> None:
    # a confused control plane assigns an observer a heal: nothing is
    # fetched and the sync-participation branch is skipped
    seen = {}
    for pkg, (m, client, comm, _) in _both(mstore, data_plane=False).items():
        try:
            client.quorum.return_value = _quorum(
                pkg, replica_rank=1, replica_world_size=2, max_step=7,
                max_rank=None, max_world_size=1, recover_src_rank=0,
                recover_src_manager_address="http://donor:1", heal=True,
                transport_rank=None, transport_world_size=1,
                transport_replica_ids=["a"])
            m.start_quorum(allow_heal=True)
            m.wait_quorum()
            assert m._healing is False and m._pending_state_dict is None
            assert not m.is_participating()
            assert m.num_participants() == 1
            seen[pkg] = (m.num_participants(), m.current_step(),
                         [(r, w) for _, r, w in comm.configure_calls])
        finally:
            m.shutdown(wait=False)
    assert seen["torch"] == seen["jax"]


def test_sync_participation_counts_the_wire_not_the_quorum(mstore) -> None:
    # use_async_quorum=False: every wire member participates, and an
    # off-wire observer must not inflate the count (1/3 instead of 1/2
    # would under-scale every average)
    got = {}
    for pkg, (m, client, comm, _) in _both(
            mstore, use_async_quorum=False).items():
        try:
            client.quorum.return_value = _quorum(
                pkg, replica_world_size=3, max_world_size=2,
                transport_rank=1, transport_world_size=2,
                transport_replica_ids=["a", "b"])
            m.start_quorum()
            out = m.allreduce_arrays([np.full(4, 6.0, np.float32)])
            got[pkg] = (m.num_participants(), m.participating_rank(),
                        out.future().result(timeout=5)[0].tolist())
        finally:
            m.shutdown(wait=False)
    assert got["torch"] == got["jax"] == (2, 1, [3.0] * 4)


def test_eviction_latches_and_clears_participation(mstore) -> None:
    # an evicted answer: no commit, no participants, is_evicted() for
    # good, a job_preempted event and the telemetry fields
    import torchft_tpu.control as jctrl
    import torchft_tpu_torch.control as pctrl

    seen = {}
    for pkg, (m, client, comm, _) in _both(mstore, job_id="lo").items():
        ctrl = pctrl if pkg == "torch" else jctrl
        try:
            client.quorum.return_value = _quorum(pkg)
            m.start_quorum()
            m.wait_quorum()
            client.should_commit.return_value = True
            assert m.should_commit() and not m.is_evicted()
            client.quorum.return_value = ctrl.QuorumResult.from_json(
                '{"evicted": true, "job_id": "lo", "membership_epoch": 9, '
                '"lease_ms": 0}')
            m.start_quorum()
            m.wait_quorum()
            assert m.is_evicted() and m.errored() is not None
            assert m.num_participants() == 0 and not m.is_participating()
            assert not m.should_commit_async().local_should_commit
            info = m._telemetry_info()
            assert info["evicted"] is True and info["job_id"] == "lo"
            ev = [e for e in m.events.since(0)[0]
                  if e["kind"] == "job_preempted"]
            seen[pkg] = [(e["step"], e["epoch"], e["job_id"]) for e in ev]
        finally:
            m.shutdown(wait=False)
    assert seen["torch"] == seen["jax"] == [(1, 9, "lo")]


def test_job_prefixes_every_group_store_key() -> None:
    # "default" keeps the unprefixed keys; any other job prefixes them all
    for job, prefix in (("default", ""), ("train-7", "job:train-7/")):
        for pkg in ("torch", "jax"):
            own = StoreServer()
            m, client, comm, server = _mocked_manager(pkg, own, job_id=job)
            try:
                assert m.job_id() == job
                assert server.call_args.kwargs["job_id"] == job
                c = StoreClient(own.addr)
                assert c.get(f"{prefix}manager_addr") == b"http://mock:1"
                assert c.get(f"{prefix}replica_id").decode() == (
                    m.replica_id() if pkg == "torch" else m._replica_id)
                assert c.get(f"{prefix}checkpoint_addr_0")
                assert m._telemetry_info()["job_id"] == job
            finally:
                m.shutdown(wait=False)
                own.shutdown()


def test_bind_stage_and_mesh_shape_match_the_reference(mstore) -> None:
    got = {}
    for pkg, (m, client, comm, _) in _both(mstore, model_shards=4).items():
        try:
            assert (m.stage_index(), m.stage_count()) == (0, 1)
            assert m.metrics.labels()["mesh_shape"] == "1x4"
            with pytest.raises(ValueError, match="outside"):
                m.bind_stage(3, 3)
            with pytest.raises(ValueError, match="outside"):
                m.bind_stage(-1, 2)
            m.bind_stage(1, 3)
            snap = m.metrics.snapshot()
            info = m._telemetry_info()
            # a wire of 3, then a shrink to 2: the label follows the wire
            shapes = []
            for world in (3, 2):
                client.quorum.return_value = _quorum(
                    pkg, quorum_id=world, replica_world_size=world,
                    max_world_size=world, transport_rank=0,
                    transport_world_size=world,
                    transport_replica_ids=list("abc"[:world]))
                m.start_quorum()
                m.wait_quorum()
                shapes.append(m.metrics.labels()["mesh_shape"])
            got[pkg] = (m.stage_index(), m.stage_count(),
                        snap["pipe_stage_index"], snap["pipe_stage_count"],
                        info["stage_index"], info["stage_count"], shapes,
                        m.model_shards)
        finally:
            m.shutdown(wait=False)
    assert got["torch"] == got["jax"] == (1, 3, 1.0, 3.0, 1, 3,
                                          ["3x4", "2x4"], 4)


def test_all_observer_quorum_stays_coherent(mstore) -> None:
    # every member an observer: the kernel puts them all on the wire (its
    # fallback), so the observer configures the cohort's wire, yet never
    # participates, heals or donates
    seen = {}
    for pkg, (m, client, comm, _) in _both(mstore, data_plane=False).items():
        try:
            client.quorum.return_value = _quorum(
                pkg, replica_world_size=2, max_step=3, max_world_size=2,
                recover_dst_ranks=[1], transport_rank=0,
                transport_world_size=2, transport_replica_ids=["a", "b"])
            m.start_quorum(allow_heal=True)
            m.wait_quorum()
            assert not m.is_participating() and not m._healing
            assert m.transport_world_size() == 2
            seen[pkg] = comm.configure_calls
        finally:
            m.shutdown(wait=False)
    assert seen["torch"] == seen["jax"]
    prefix, rank, world = seen["torch"][0]
    assert (rank, world) == (0, 2) and "/observer/" not in prefix


# --- the event stream, against the JAX package --------------------------------
# A sequence of quorum answers (each a list of wire members, "evict" for an
# eviction) drives both Managers; each non-evicted quorum is followed by a
# commit. The projected recordings must be equal: the Manager's member_dead
# names every wire member of the last quorum that is gone from this one, in
# sorted order, before quorum_complete.

_EVENT_FIELDS = ("kind", "step", "epoch", "member", "wire_world",
                 "replica_world", "participants", "heal")


@pytest.mark.parametrize("kwargs,answers,dead", [
    ({}, [list("abc"), list("ac")], [(2, "b")]),
    ({}, [list("dbac"), list("ac")], [(2, "b"), (2, "d")]),
    ({}, [list("ac"), list("abc"), list("ab")], [(3, "c")]),
    ({}, [list("abc"), list("ac"), list("a"), list("ab")],
     [(2, "b"), (3, "c")]),
    ({"data_plane": False}, [list("ab"), list("a")], [(2, "b")]),
    ({"job_id": "lo"}, [list("abc"), "evict", list("a")],
     [(3, "b"), (3, "c")]),
], ids=["one_leaves", "two_leave_sorted", "one_joins", "leave_leave_join",
        "observer", "eviction"])
def test_event_stream_matches_the_reference(mstore, kwargs, answers,
                                            dead) -> None:
    import torchft_tpu.control as jctrl
    import torchft_tpu_torch.control as pctrl

    seen = {}
    for pkg, (m, client, comm, _) in _both(mstore, **kwargs).items():
        ctrl = pctrl if pkg == "torch" else jctrl
        observer = kwargs.get("data_plane") is False
        client.should_commit.return_value = True
        try:
            for qid, wire in enumerate(answers, start=1):
                if wire == "evict":
                    client.quorum.return_value = ctrl.QuorumResult.from_json(
                        '{"evicted": true, "job_id": "lo", '
                        '"membership_epoch": 9, "lease_ms": 0}')
                else:
                    client.quorum.return_value = _quorum(
                        pkg, quorum_id=qid, replica_world_size=len(wire) + 1,
                        max_step=m.current_step(), max_world_size=len(wire),
                        transport_rank=None if observer else 0,
                        transport_world_size=len(wire),
                        transport_replica_ids=wire)
                m.start_quorum(allow_heal=not observer)
                m.wait_quorum()
                if wire != "evict":
                    assert m.should_commit()
            seen[pkg] = [tuple(e.get(f) for f in _EVENT_FIELDS)
                         for e in m.events.since(0)[0]]
        finally:
            m.shutdown(wait=False)
    assert seen["torch"] == seen["jax"]
    got = [(e[2], e[3]) for e in seen["torch"] if e[0] == "member_dead"]
    assert got == dead
    # each death comes just before its quorum's quorum_complete
    kinds = [e[0] for e in seen["torch"]]
    for i, kind in enumerate(kinds):
        if kind == "member_dead":
            assert kinds[i + 1] in ("member_dead", "quorum_complete")


# --- tests/test_manager.py whole, against the JAX package ---------------------
# Each case runs the reference case's steps on both packages' Managers over
# the same fabricated answers, asserts the reference's own expectations on
# each, and that the two agree: the configure calls, participation, step,
# commits, the latched error's type, the values returned, and a healed
# state bitwise.


def _observed(m, comm) -> dict:
    """What the two packages' Managers must agree on after a case."""
    err = m.errored()
    return {"configure": list(comm.configure_calls),
            "participating": m.is_participating(),
            "participants": m.num_participants(),
            "step": m.current_step(),
            "committed": m.batches_committed(),
            "errored": None if err is None else type(err).__name__,
            "ops": list(comm.ops)}


def _agree(seen: dict) -> dict:
    """Assert both packages saw the same, and return it."""
    assert seen["torch"] == seen["jax"], seen
    return seen["torch"]


def _donor(pkg, step: int, w: np.ndarray, committed: int):
    """A donor's checkpoint server of ``pkg``, staged at ``step``."""
    import torchft_tpu.checkpointing as jck
    import torchft_tpu_torch.checkpointing as pck

    server = (pck if pkg == "torch" else jck).CheckpointServer(timeout=5.0)
    server.allow_checkpoint(step, {
        "user": {"w": w},
        "torchft": {"step": step, "batches_committed": committed}})
    return server


def _healing_from(pkg, donor):
    """Patch ``pkg``'s manager module so a heal's ``ManagerClient`` names
    ``donor`` as the checkpoint's address."""
    from unittest.mock import patch

    import torchft_tpu.manager as jmanager
    import torchft_tpu_torch.manager as pmanager

    patcher = patch.object(pmanager if pkg == "torch" else jmanager,
                           "ManagerClient")
    cls = patcher.start()
    cls.return_value.checkpoint_metadata.return_value = donor.address()
    return patcher


def _heal_answer(pkg, max_step: int, quorum_id: int = 3):
    # replica 1 of 2 is behind: it heals from rank 0 and is not in the
    # max-step cohort; the answer carries no data-plane membership
    return _quorum(pkg, quorum_id=quorum_id, replica_rank=1,
                   replica_world_size=2, recover_src_rank=0,
                   recover_src_manager_address="http://donor:1",
                   max_step=max_step, max_rank=None, max_world_size=1,
                   heal=True)


def _bits(a) -> tuple:
    a = np.asarray(a)
    return a.dtype.str, a.shape, a.tobytes()


def test_happy_path_step_commit(mstore) -> None:
    # an answer without data-plane membership (the reference's "old
    # control plane") configures the full-membership wire and counts
    # every replica as participating
    seen = {}
    for pkg, (m, client, comm, _) in _both(mstore).items():
        try:
            client.quorum.return_value = _quorum(pkg)
            client.should_commit.return_value = True
            assert m.current_step() == 0
            m.start_quorum()
            fut = m.allreduce_arrays([np.full(3, 4.0, np.float32)]).future()
            out = fut.result(timeout=5)[0]
            np.testing.assert_allclose(out, np.full(3, 2.0))
            assert m.should_commit()
            seen[pkg] = (_observed(m, comm), _bits(out))
        finally:
            m.shutdown(wait=False)
    got, _ = _agree(seen)
    assert got["step"] == 1 and got["committed"] == 2
    assert got["configure"] == [("store/torchft/1/all/0", 0, 2)]
    assert got["participating"] and got["participants"] == 2


def test_quorum_id_change_reconfigures(mstore) -> None:
    seen = {}
    for pkg, (m, client, comm, _) in _both(mstore).items():
        try:
            client.should_commit.return_value = True
            counts = []
            for qid in (1, 1, 2):
                client.quorum.return_value = _quorum(pkg, quorum_id=qid)
                m.start_quorum()
                m.wait_quorum()
                counts.append(len(comm.configure_calls))
            seen[pkg] = (counts, _observed(m, comm))
        finally:
            m.shutdown(wait=False)
    counts, got = _agree(seen)
    assert counts == [1, 1, 2]
    assert [c[0] for c in got["configure"]] == ["store/torchft/1/all/0",
                                                "store/torchft/2/all/0"]


@pytest.mark.parametrize("op", [ReduceOp.SUM, ReduceOp.AVG], ids=[
    "async_heal_not_participating_zero_grads",
    "healing_replica_avg_matches_sum_scaling"])
def test_healing_replica_contributes_zeros(mstore, op) -> None:
    # a healing replica is not participating and contributes zeros, AVG
    # reduces as SUM scaled by the participants (1 here), and its vote is
    # still True: the donor's state applies in should_commit (async mode)
    # and the step goes on from the donor's
    seen, states = {}, {}
    for pkg, (m, client, comm, _) in _both(mstore, states=states).items():
        donor = _donor(pkg, 20, np.full(2, 7.0), 40)
        patcher = _healing_from(pkg, donor)
        try:
            client.quorum.return_value = _heal_answer(pkg, 20)
            client.should_commit.return_value = True
            m.start_quorum()
            fut = m.allreduce_arrays([np.full(2, 9.0, np.float32)],
                                     op=op).future()
            out = fut.result(timeout=5)[0]
            np.testing.assert_allclose(out, np.zeros(2))
            assert not m.is_participating() and m.num_participants() == 1
            assert m.should_commit()
            np.testing.assert_allclose(states[pkg]["w"], np.full(2, 7.0))
            seen[pkg] = (_observed(m, comm), _bits(out),
                         _bits(states[pkg]["w"]))
        finally:
            patcher.stop()
            donor.shutdown()
            m.shutdown(wait=False)
    got, _, _ = _agree(seen)
    assert got["step"] == 21 and got["ops"] == [ReduceOp.SUM]


def test_sync_quorum_heals_eagerly(mstore) -> None:
    # sync mode heals inside start_quorum; an answer without data-plane
    # membership makes participation the replica rank and world, so the
    # healer participates, and a heal-step AVG divides by 2
    seen, states = {}, {}
    for pkg, (m, client, comm, _) in _both(
            mstore, states=states, use_async_quorum=False).items():
        donor = _donor(pkg, 5, np.full(2, 3.0), 10)
        patcher = _healing_from(pkg, donor)
        try:
            client.quorum.return_value = _heal_answer(pkg, 5, quorum_id=1)
            client.should_commit.return_value = True
            m.start_quorum()
            np.testing.assert_allclose(states[pkg]["w"], np.full(2, 3.0))
            assert m.is_participating() and m.num_participants() == 2
            assert m.current_step() == 5
            out = m.allreduce_arrays([np.full(2, 9.0, np.float32)],
                                     op=ReduceOp.AVG).future()
            out = out.result(timeout=5)[0]
            seen[pkg] = (_observed(m, comm), _bits(out),
                         _bits(states[pkg]["w"]))
        finally:
            patcher.stop()
            donor.shutdown()
            m.shutdown(wait=False)
    got, out, _ = _agree(seen)
    assert np.frombuffer(out[2], np.float32).tolist() == [4.5, 4.5]
    assert got["configure"] == [("store/torchft/1/all/0", 1, 2)]


@pytest.mark.parametrize("op,want", [(ReduceOp.AVG, 2.0),
                                     (ReduceOp.MAX, 4.0)], ids=[
    "avg_scales_by_participants_not_transport_world", "max_not_scaled"])
def test_allreduce_scaling_by_op(mstore, op, want) -> None:
    # AVG through the Manager reduces as SUM and scales by the
    # participants; MAX reaches the wire as MAX and is not scaled
    seen = {}
    for pkg, (m, client, comm, _) in _both(mstore).items():
        try:
            client.quorum.return_value = _quorum(pkg)
            client.should_commit.return_value = True
            m.start_quorum()
            out = m.allreduce_arrays([np.full(3, 4.0, np.float32)],
                                     op=op).future().result(timeout=5)[0]
            np.testing.assert_allclose(out, np.full(3, want))
            seen[pkg] = (_observed(m, comm), _bits(out))
        finally:
            m.shutdown(wait=False)
    got, _ = _agree(seen)
    assert got["ops"] == [ReduceOp.SUM if op == ReduceOp.AVG else op]


@pytest.mark.parametrize("fault", ["fail", "hang"], ids=[
    "allreduce_error_latches_and_skips", "wrap_future_timeout_latches"])
def test_allreduce_failure_latches(mstore, fault) -> None:
    # a failed or hung op completes with its input and latches (a hang
    # through wrap_future's timeout); later ops this step return their
    # input, the local vote is False, the step does not move, and the next
    # quorum clears the latch
    seen = {}
    for pkg, (m, client, comm, _) in _both(mstore, timeout=0.5).items():
        try:
            client.quorum.return_value = _quorum(pkg)
            client.should_commit.return_value = False
            m.start_quorum()
            if fault == "fail":
                comm.fail_next = RuntimeError("injected comm failure")
            else:
                comm.hang_next = True
            out = m.allreduce_arrays([np.full(2, 6.0, np.float32)])
            out = out.future().result(timeout=10)[0]
            np.testing.assert_allclose(out, np.full(2, 6.0))
            latched = _observed(m, comm)
            again = m.allreduce_arrays([np.ones(2)]).future().result(5)[0]
            np.testing.assert_allclose(again, np.ones(2))
            assert m.should_commit() is False
            assert client.should_commit.call_args.args[2] is False
            assert m.current_step() == 0
            client.quorum.return_value = _quorum(pkg, quorum_id=2)
            m.start_quorum()
            m.wait_quorum()
            assert m.errored() is None
            seen[pkg] = (latched, _observed(m, comm), _bits(out))
        finally:
            m.shutdown(wait=False)
    latched, _, _ = _agree(seen)
    assert latched["errored"] == ("RuntimeError" if fault == "fail"
                                  else "TimeoutError")
    assert latched["ops"] == [ReduceOp.SUM]


def test_spares_mode_clamps_participation(mstore) -> None:
    # FIXED_WITH_SPARES: the world clamps to min_replica_size and a rank
    # beyond it is parked
    import torchft_tpu.manager as jmanager
    import torchft_tpu_torch.manager as pmanager

    seen = {}
    for pkg in ("torch", "jax"):
        mode = (pmanager if pkg == "torch" else jmanager).WorldSizeMode
        m, client, comm, _ = _mocked_manager(
            pkg, mstore, world_size_mode=mode.FIXED_WITH_SPARES,
            min_replica_size=2)
        try:
            got = []
            for qid, rank in ((1, 2), (2, 1)):
                client.quorum.return_value = _quorum(
                    pkg, quorum_id=qid, replica_rank=rank,
                    replica_world_size=3, max_rank=rank, max_world_size=3)
                m.start_quorum()
                m.wait_quorum()
                got.append(_observed(m, comm))
            seen[pkg] = got
        finally:
            m.shutdown(wait=False)
    parked, active = _agree(seen)
    assert (parked["participants"], parked["participating"]) == (2, False)
    assert (active["participants"], active["participating"]) == (2, True)


def test_allow_heal_false_uses_full_quorum(mstore) -> None:
    # allow_heal=False: no checkpoint traffic even when the answer says
    # heal, and participation comes from the max-step cohort
    seen = {}
    for pkg, (m, client, comm, _) in _both(mstore).items():
        try:
            client.quorum.return_value = _quorum(
                pkg, replica_rank=1, replica_world_size=2,
                recover_src_rank=0, max_step=3, max_rank=None,
                max_world_size=1, heal=True)
            m.start_quorum(allow_heal=False)
            m.wait_quorum()
            assert not m._healing
            seen[pkg] = _observed(m, comm)
        finally:
            m.shutdown(wait=False)
    got = _agree(seen)
    assert got["participants"] == 1 and not got["participating"]


def test_min_replicas_vote_false(mstore) -> None:
    # fewer participants than min_replica_size: the local vote is False
    seen = {}
    for pkg, (m, client, comm, _) in _both(mstore,
                                           min_replica_size=2).items():
        try:
            client.quorum.return_value = _quorum(
                pkg, replica_world_size=1, max_world_size=1, max_rank=0)
            client.should_commit.return_value = False
            m.start_quorum()
            m.wait_quorum()
            assert m.should_commit() is False
            seen[pkg] = (client.should_commit.call_args.args[2],
                         _observed(m, comm))
        finally:
            m.shutdown(wait=False)
    vote, got = _agree(seen)
    assert vote is False and got["step"] == 0


def test_donor_serves_recovering_peers(mstore) -> None:
    # recover_dst_ranks in the answer: the donor stages its checkpoint at
    # the max step, read here through each package's own fetch path (the
    # manifest and the state a healer receives)
    import torchft_tpu.checkpointing as jck
    import torchft_tpu_torch.checkpointing as pck

    seen = {}
    for pkg, (m, client, comm, _) in _both(mstore).items():
        ck = pck if pkg == "torch" else jck
        healer = ck.CheckpointServer(timeout=5.0)
        try:
            client.quorum.return_value = _quorum(pkg, max_step=7,
                                                 recover_dst_ranks=[1])
            m.start_quorum()
            m.wait_quorum()
            metadata = m._checkpoint_transport.metadata()
            manifest = ck.fetch_manifest(metadata, 7, timeout=5.0)
            assert manifest["step"] == 7
            got = healer.recv_checkpoint(src_rank=0, metadata=metadata,
                                         step=7, timeout=5.0)
            assert got["torchft"]["step"] == 0
            assert "w" in got["user"]
            seen[pkg] = (got["torchft"], _bits(got["user"]["w"]),
                         len(manifest["leaves"]))
        finally:
            healer.shutdown()
            m.shutdown(wait=False)
    _agree(seen)


def test_state_dict_roundtrip(mstore) -> None:
    seen = {}
    for pkg, (m, client, comm, _) in _both(mstore).items():
        m2, *_ = _mocked_manager(pkg, mstore)
        try:
            client.quorum.return_value = _quorum(pkg)
            client.should_commit.return_value = True
            m.start_quorum()
            assert m.should_commit()
            sd = m.state_dict()
            m2.load_state_dict(sd)
            seen[pkg] = (sd, m2.current_step(), m2.batches_committed())
        finally:
            m.shutdown(wait=False)
            m2.shutdown(wait=False)
    assert _agree(seen) == ({"step": 1, "batches_committed": 2}, 1, 2)


@pytest.mark.parametrize("kwargs,key,want", [
    ({"timeout": 12.5}, "timeout", 12.5),
    ({"shrink_only": True}, "shrink_only", True),
], ids=["quorum_timeout_plumbing", "shrink_only_plumbed_to_quorum"])
def test_start_quorum_arguments_reach_the_rpc(mstore, kwargs, key,
                                              want) -> None:
    seen = {}
    for pkg, (m, client, comm, _) in _both(mstore).items():
        try:
            client.quorum.return_value = _quorum(pkg)
            m.start_quorum(**kwargs)
            m.wait_quorum()
            seen[pkg] = client.quorum.call_args.kwargs[key]
        finally:
            m.shutdown(wait=False)
    assert _agree(seen) == want


def test_metrics_populated(mstore) -> None:
    names = ("quorum_avg_ms", "allreduce_avg_ms", "commit_barrier_avg_ms")
    seen = {}
    for pkg, (m, client, comm, _) in _both(mstore).items():
        try:
            client.quorum.return_value = _quorum(pkg)
            client.should_commit.return_value = True
            m.start_quorum()
            m.allreduce_arrays([np.ones(2, np.float32)]).future().result(5)
            m.should_commit()
            snap = m.metrics.snapshot()
            seen[pkg] = (snap["steps_committed"],
                         [n for n in names if n in snap])
        finally:
            m.shutdown(wait=False)
    assert _agree(seen) == (1, list(names))


@pytest.mark.parametrize("op", [ReduceOp.SUM, ReduceOp.AVG])
def test_bfloat16_arrays_scale_as_floats(mstore, op) -> None:
    # an ml_dtypes bfloat16 array (what a bf16 bucket is on the host wire)
    # is a float to the Manager: AVG takes it and both ops scale it by the
    # participants, though numpy does not class it under np.floating
    import ml_dtypes

    seen = {}
    for pkg, (m, client, comm, _) in _both(mstore).items():
        try:
            client.quorum.return_value = _quorum(pkg)
            m.start_quorum()
            a = np.full(3, 4.0, ml_dtypes.bfloat16)
            out = m.allreduce_arrays([a], op=op).future().result(5)[0]
            seen[pkg] = (out.dtype.name, out.astype(np.float32).tolist())
        finally:
            m.shutdown(wait=False)
    assert _agree(seen) == ("bfloat16", [2.0, 2.0, 2.0])


def test_integer_avg_raises(mstore) -> None:
    for pkg, (m, client, comm, _) in _both(mstore).items():
        try:
            client.quorum.return_value = _quorum(pkg)
            m.start_quorum()
            with pytest.raises(ValueError, match="AVG requires floating"):
                m.allreduce_arrays([np.array([4, 4], np.int64)],
                                   op=ReduceOp.AVG)
            assert comm.ops == []
        finally:
            m.shutdown(wait=False)


class _FanoutTransport:
    """A checkpoint transport recording the peers each donor event set."""

    def __init__(self) -> None:
        self.peer_calls = []
        self.sends = 0

    def metadata(self):
        return "fake://ckpt"

    def set_peers(self, peers):
        self.peer_calls.append(list(peers))

    def send_checkpoint(self, dst_ranks, step, state_dict, timeout):
        self.sends += 1

    def recv_checkpoint(self, src_rank, metadata, step, timeout):
        raise AssertionError("a donor never receives")

    def disallow_checkpoint(self):
        pass

    def shutdown(self, wait=True):
        pass


def test_ckpt_peers_rediscovered_each_donor_event(mstore) -> None:
    # a peer that restarts advertises a new checkpoint address: the donor
    # reads the peers' addresses again at every donor event
    seen = {}
    for pkg in ("torch", "jax"):
        transport = _FanoutTransport()
        m, client, comm, _ = _mocked_manager(
            pkg, mstore, world_size=2, checkpoint_transport=transport)
        try:
            for qid, addr in ((1, "peer:1111"), (2, "peer:2222")):
                StoreClient(mstore.addr).set("checkpoint_addr_1", addr)
                client.quorum.return_value = _quorum(
                    pkg, quorum_id=qid, max_step=2 + qid, max_world_size=1,
                    recover_dst_ranks=[1])
                m.start_quorum()
                m.wait_quorum()
            seen[pkg] = (transport.peer_calls, transport.sends)
        finally:
            m.shutdown(wait=False)
    assert _agree(seen) == ([["peer:1111"], ["peer:2222"]], 2)


def test_should_commit_async_overlaps_rpc(mstore) -> None:
    # the barrier RPC rides the executor while the caller is free; the
    # counters move only with the decision
    seen = {}
    for pkg, (m, client, comm, _) in _both(mstore).items():
        gate, entered = threading.Event(), threading.Event()

        def slow_commit(rank, step, should_commit, timeout=None):
            entered.set()
            assert gate.wait(5)
            return True

        try:
            client.quorum.return_value = _quorum(pkg)
            client.should_commit.side_effect = slow_commit
            m.start_quorum()
            m.wait_quorum()
            fut = m.should_commit_async()
            assert fut.local_should_commit is True
            assert entered.wait(5)
            assert not fut.done() and m.current_step() == 0
            gate.set()
            assert fut.result(timeout=5) is True
            seen[pkg] = _observed(m, comm)
        finally:
            gate.set()
            m.shutdown(wait=False)
    got = _agree(seen)
    assert (got["step"], got["committed"]) == (1, 2)


def test_should_commit_async_false_local_vote_after_error(mstore) -> None:
    # a latched error shows on the returned future before the decision
    seen = {}
    for pkg, (m, client, comm, _) in _both(mstore).items():
        try:
            client.quorum.return_value = _quorum(pkg)
            client.should_commit.return_value = False
            m.start_quorum()
            m.wait_quorum()
            m.report_error(RuntimeError("transport died"))
            fut = m.should_commit_async()
            seen[pkg] = (fut.local_should_commit, fut.result(timeout=5),
                         _observed(m, comm))
        finally:
            m.shutdown(wait=False)
    local, decision, got = _agree(seen)
    assert local is False and decision is False and got["step"] == 0


def test_should_commit_async_applies_heal_in_prologue(mstore) -> None:
    # the pending heal applies in the prologue, before the future returns,
    # so an overlapping caller updates the healed state
    seen, states = {}, {}
    for pkg, (m, client, comm, _) in _both(mstore, states=states).items():
        donor = _donor(pkg, 20, np.full(2, 7.0), 40)
        patcher = _healing_from(pkg, donor)
        try:
            client.quorum.return_value = _heal_answer(pkg, 20)
            client.should_commit.return_value = True
            m.start_quorum()
            m.wait_quorum()
        finally:
            patcher.stop()
            donor.shutdown()
        try:
            fut = m.should_commit_async()
            assert m.did_heal()
            np.testing.assert_allclose(states[pkg]["w"], np.full(2, 7.0))
            assert fut.result(timeout=5) is True
            seen[pkg] = (_observed(m, comm), _bits(states[pkg]["w"]))
        finally:
            m.shutdown(wait=False)
    got, _ = _agree(seen)
    assert got["step"] == 21


# ---------------------------------------- allreduce_pytree (F28): a tree


def _pytree(pkg: str, rank: int, ints: bool):
    """One rank's gradient tree, the same values in either package: the
    port's leaves tensors (f32, bf16, int32, a 0-d, one numpy leaf kept
    numpy), the reference's numpy (bf16 as ml_dtypes'), nested dicts and a
    list whose keys are not in sorted order."""
    import ml_dtypes

    rng = np.random.default_rng(40 + rank)
    leaves = {"w": rng.standard_normal((3, 4)).astype(np.float32),
              "bf": rng.standard_normal(5).astype(ml_dtypes.bfloat16),
              "s": np.asarray(rng.standard_normal(), np.float32),
              "a": rng.standard_normal(2).astype(np.float32),
              "n": rng.standard_normal(6).astype(np.float32),
              "i": np.arange(4, dtype=np.int32) * (rank + 3)}
    if pkg == "torch":
        leaves.update({k: from_host(v.copy()) for k, v in leaves.items()
                       if k != "n"})
    tree = {"w": leaves["w"],
            "nested": {"z": [leaves["bf"], leaves["s"]], "a": leaves["a"]},
            "n": leaves["n"]}
    if ints:
        tree["i"] = leaves["i"]
    return tree


def _leaf_bits(tree) -> list:
    """(path, kind, dtype, shape, bytes) of every leaf in jax's order."""
    out = []
    for path, x in tree_flatten_with_path(tree)[0]:
        kind = "tensor" if isinstance(x, torch.Tensor) else type(x).__name__
        a = to_numpy(x) if isinstance(x, torch.Tensor) else np.asarray(x)
        out.append((path, kind, a.dtype.name, a.shape, a.tobytes()))
    return out


@pytest.mark.parametrize("op", [ReduceOp.SUM, ReduceOp.AVG])
def test_allreduce_pytree_mixed_cohort_is_the_reference(op) -> None:
    # a port Manager and a reference Manager in one quorum over TCP: each
    # reduces its tree through allreduce_pytree; the port's result is the
    # reference's bitwise, leaf by leaf, in the same structure, its tensor
    # leaves back as tensors of their dtypes, its inputs untouched
    from torchft_tpu.comm.transport import TcpCommContext as JaxTcp
    from torchft_tpu.manager import Manager as JaxManager

    lighthouse = Lighthouse(min_replicas=2, join_timeout_ms=10000)
    stores = [StoreServer(), StoreServer()]
    kinds = ("torch", "jax")
    managers = [None, None]
    out, inputs = {}, {}
    barrier = threading.Barrier(2, timeout=60.0)

    def _replica(idx: int) -> None:
        kind = kinds[idx]
        cls, comm = ((Manager, TcpCommContext(timeout=20.0)) if kind ==
                     "torch" else (JaxManager, JaxTcp(timeout=20.0)))
        mgr = cls(comm=comm, min_replica_size=2, rank=0, world_size=1,
                  store_addr=stores[idx].addr,
                  lighthouse_addr=lighthouse.address(),
                  replica_id=f"pytree_{kind}_", timeout=20.0,
                  quorum_timeout=20.0, connect_timeout=20.0,
                  heartbeat_interval=0.05, use_async_quorum=False)
        managers[idx] = mgr
        barrier.wait()
        mgr.start_quorum(allow_heal=False)
        tree = _pytree(kind, idx, ints=op == ReduceOp.SUM)
        inputs[kind] = (tree, _leaf_bits(tree))
        out[kind] = mgr.allreduce_pytree(tree, op=op).result(timeout=30)
        assert mgr.num_participants() == 2
        assert mgr.should_commit()

    threads = [threading.Thread(target=_replica, args=(i,)) for i in range(2)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120.0)
            assert not t.is_alive()
    finally:
        for mgr in managers:
            if mgr is not None:
                mgr.shutdown(wait=False)
        for s in stores:
            s.shutdown()
        lighthouse.shutdown()
    assert set(out) == set(kinds), "a replica raised"
    port, ref = _leaf_bits(out["torch"]), _leaf_bits(out["jax"])
    # the same leaves under the same paths, in the same dict key order
    assert list(out["torch"]) == list(out["jax"]) == sorted(out["jax"])
    assert [p[0] for p in port] == [r[0] for r in ref]
    for p, r in zip(port, ref):
        assert p[2:] == r[2:], p[0]  # dtype, shape, bits
        assert p[1] == ("ndarray" if p[0] == "['n']" else "tensor"), p
    # the reduction did reduce: rank 0's own values are not the result
    tree, before = inputs["torch"]
    assert port[0][4] != before[0][4]
    # the port's input tensors were not written (its numpy leaf is
    # donated, as the reference's), and no result tensor is an input
    after = _leaf_bits(tree)
    assert [b for b in after if b[1] == "tensor"] == \
        [b for b in before if b[1] == "tensor"]
    src = dict(tree_flatten_with_path(tree)[0])
    for path, x in tree_flatten_with_path(out["torch"])[0]:
        if isinstance(x, torch.Tensor):
            assert x.dtype == src[path].dtype and x.device == src[path].device
            assert x.data_ptr() != src[path].data_ptr()


def test_allreduce_pytree_healing_member_contributes_zeros(mstore) -> None:
    # a healing replica's tree reduces as zeros in both packages, its
    # inputs untouched, and the step commits with the donor's state
    seen, states = {}, {}
    for pkg, (m, client, comm, _) in _both(mstore, states=states).items():
        donor = _donor(pkg, 20, np.full(2, 7.0), 40)
        patcher = _healing_from(pkg, donor)
        try:
            client.quorum.return_value = _heal_answer(pkg, 20)
            client.should_commit.return_value = True
            m.start_quorum()
            tree = _pytree(pkg, 0, ints=True)
            before = _leaf_bits(tree)
            got = m.allreduce_pytree(tree).result(timeout=5)
            assert not m.is_participating()
            for leaf in tree_flatten_with_path(got)[0]:
                a = leaf[1]
                a = to_numpy(a) if isinstance(a, torch.Tensor) else a
                assert not np.asarray(a, np.float64).any(), leaf[0]
            assert [b for b in _leaf_bits(tree) if b[1] == "tensor"] == \
                [b for b in before if b[1] == "tensor"]
            assert m.should_commit()
            seen[pkg] = (_observed(m, comm),
                         [b[2:] for b in _leaf_bits(got)])
        finally:
            patcher.stop()
            donor.shutdown()
            m.shutdown(wait=False)
    got, _ = _agree(seen)
    assert got["step"] == 21 and got["ops"] == [ReduceOp.SUM]


def test_allreduce_pytree_latched_error_resolves_to_the_input(mstore) -> None:
    # a failed op latches: the tree resolves to its input's values (the
    # port's tensor leaves as new tensors of their dtypes), the step does
    # not commit, and both packages agree leaf by leaf
    seen = {}
    for pkg, (m, client, comm, _) in _both(mstore).items():
        try:
            client.quorum.return_value = _quorum(pkg)
            client.should_commit.return_value = False
            m.start_quorum()
            comm.fail_next = RuntimeError("injected comm failure")
            tree = _pytree(pkg, 1, ints=True)
            before = _leaf_bits(tree)
            got = m.allreduce_pytree(tree).result(timeout=10)
            assert [b[2:] for b in _leaf_bits(got)] == \
                [b[2:] for b in before]
            assert m.should_commit() is False
            seen[pkg] = (_observed(m, comm),
                         [b[2:] for b in _leaf_bits(got)])
        finally:
            m.shutdown(wait=False)
    got, _ = _agree(seen)
    assert got["errored"] == "RuntimeError" and got["step"] == 0
