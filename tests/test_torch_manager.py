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
from torchft_tpu_torch.comm.store import StoreClient, StoreServer
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


# --- observers, jobs, stages and the mesh label, against the JAX package ----
# Both packages' Managers over a mocked control plane (the reference's
# test_manager.py harness): the same fabricated quorum answers must drive
# the same wire configuration, participation and heal decisions.


def _mocked_manager(pkg, store, **kwargs):
    from unittest.mock import MagicMock, patch

    import torchft_tpu.comm.context as jctx
    import torchft_tpu.manager as jmanager
    import torchft_tpu_torch.comm.context as pctx
    import torchft_tpu_torch.manager as pmanager

    mod, ctx = (pmanager, pctx) if pkg == "torch" else (jmanager, jctx)

    class FakeComm(ctx.CommContext):
        """Identity-sum wire recording its configure calls."""

        def __init__(self) -> None:
            super().__init__()
            self.configure_calls = []

        def configure(self, store_addr, rank, world_size):
            self.configure_calls.append((store_addr, rank, world_size))
            self._rank, self._world_size = rank, world_size

        def allreduce(self, arrays, op=ReduceOp.SUM, topology=None):
            return ctx.CompletedWork([np.array(a, copy=True)
                                      for a in arrays])

        def allgather(self, arrays):
            return ctx.CompletedWork([list(arrays)])

        def broadcast(self, arrays, root=0):
            return ctx.CompletedWork(list(arrays))

    state = {"w": np.zeros(2)}
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
        manager = mod.Manager(comm=comm, load_state_dict=state.update,
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


def _both(mstore, **kwargs):
    return {pkg: _mocked_manager(pkg, mstore, **kwargs)
            for pkg in ("torch", "jax")}


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
        finally:
            m.shutdown(wait=False)


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
