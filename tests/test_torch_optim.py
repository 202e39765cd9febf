"""The port's OptimizerWrapper and fused train step against the JAX package's.

Twins of the OptimizerWrapper tests of tests/test_train_integration.py:
commit and abort, the phase timers, the fused step's commit and rollover,
a heal making the fused step re-read the state, the classic -> fused
transition draining the fence, the fused trajectory equal to the classic
one (bitwise here: on the CPU both paths run the same eager arithmetic),
fence-stride batching of the loss readback, and the fused -> classic
transition shrinking the fence. The two classic arms, as the reference's
seven ``donate_update`` tests: the default overlapped arm enqueues the
update while the barrier is in flight (behind a backup), skips it on a
False local vote, waits out and restores an update the group discards or
whose barrier raises; the decided arm (``donate_update=True``) runs
nothing on a discard; the arms are bitwise equal over 3 AdamW steps
(stronger than the reference's rtol 1e-6: both update in place with the
same arithmetic). Beyond the reference: every non-commit leaves each
parameter and state tensor bitwise at its old address, a heal from the
prologue survives a discard, a decision already final takes no backup,
and both arms track the reference's wrapper at both ``donate_update``
values. A stand-in manager decides the commits, as the reference's tests
use a mock; it can hold a decision open until the wrapper asks for it.

Against the reference itself: the commit arithmetic of both wrappers, and
the port's fused step (``models.make_train_step``) from the JAX package's
parameters (``from_jax_params``) against the reference's jitted
``make_train_step``: the first three losses within 1e-5 (f32 "tiny",
summation order only, the GPT twin's tolerance), and after those steps
every parameter within 1e-4 absolute (AdamW's first updates are ~lr x sign,
so a one-ulp difference in a gradient near zero can flip one element's
step: the bound is a small fraction of lr = 3e-4).
"""

import dataclasses
from concurrent.futures import Future

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torchft_tpu_torch.models import CONFIGS, GPT, from_jax_params
from torchft_tpu_torch.models import make_train_step
from torchft_tpu_torch.optim import (OptimizerWrapper, init_adam_state,
                                     load_optimizer_state_dict)


class HeldFuture(Future):
    """A commit decision held open until its result is asked for: the
    barrier RPC still in flight when the wrapper dispatches the update."""

    def __init__(self, resolve):
        super().__init__()
        self._resolve = resolve

    def result(self, timeout=None):
        if not self.done():
            self._resolve(self)
        return super().result(timeout)


class FakeManager:
    """Just enough Manager for the wrapper: decisions set by the test.
    ``commit``: the global decision (True, False, or an exception the
    barrier raises); ``local``: the local vote (``bool(commit)`` unless
    set); ``held``: decisions held open until the wrapper resolves them
    (else final when the prologue returns, as on an epoch-lease step);
    ``prologue``: called in the prologue (a heal loading state)."""

    def __init__(self, commit=True, solo=True, healed=False, held=False,
                 local=None, prologue=None):
        self.commit = commit
        self.solo = solo
        self.healed = healed
        self.held = held
        self.local = local
        self.prologue = prologue
        self.step = 0
        self.errors = []
        self.quorum_error = None
        self.events = []

    def start_quorum(self, **kw):
        pass

    def wait_quorum(self):
        if self.quorum_error is not None:
            raise self.quorum_error

    def report_error(self, e):
        self.errors.append(e)

    def is_solo_wire(self):
        return self.solo and not self.errors

    def did_heal(self):
        return self.healed

    def current_step(self):
        return self.step

    def should_commit(self):
        return self.should_commit_async().result()

    def finish_staging(self):
        self.events.append("staged")

    def should_commit_async(self):
        if self.prologue is not None:
            self.prologue()
        commit = self.commit

        def resolve(fut):
            self.events.append("decision")
            if isinstance(commit, BaseException):
                fut.set_exception(commit)
            else:
                if commit:
                    self.step += 1
                fut.set_result(bool(commit))

        fut = HeldFuture(resolve)
        if not self.held:
            resolve(fut)
        fut.local_should_commit = (bool(commit) if self.local is None
                                   else self.local)
        return fut


def _sgd_param():
    w = torch.nn.Parameter(torch.ones(3))
    return w, torch.optim.SGD([w], lr=0.1)


def _set_grad(w, value):
    w.grad = torch.full_like(w, value)


def test_optimizer_wrapper_commit_applies_update() -> None:
    import optax

    from torchft_tpu.optim import OptimizerWrapper as JaxWrapper

    w, sgd = _sgd_param()
    opt = OptimizerWrapper(FakeManager(), sgd)
    opt.begin_step()
    _set_grad(w, 2.0)
    assert opt.step()
    # the reference wrapper's update of the same parameter and gradient
    jopt = JaxWrapper(FakeManager(), optax.sgd(0.1))
    params = {"w": jnp.ones(3)}
    new, _, committed = jopt.step(params, jopt.init(params),
                                  {"w": jnp.full(3, 2.0)})
    assert committed
    np.testing.assert_array_equal(w.detach().numpy(), np.asarray(new["w"]))
    np.testing.assert_allclose(w.detach().numpy(), np.full(3, 0.8), rtol=1e-6)


def test_optimizer_wrapper_abort_skips_update() -> None:
    w, sgd = _sgd_param()
    opt = OptimizerWrapper(FakeManager(commit=False), sgd)
    _set_grad(w, 2.0)
    assert not opt.step()
    np.testing.assert_array_equal(w.detach().numpy(), np.ones(3))


def test_classic_barrier_failure_drains_the_fence_and_raises() -> None:
    w, sgd = _sgd_param()
    manager = FakeManager()
    opt = OptimizerWrapper(manager, sgd, fence_depth=2)
    _set_grad(w, 1.0)
    assert opt.step(torch.tensor(1.5))
    assert len(opt._in_flight) == 1
    manager.commit = TimeoutError("barrier RPC timed out")
    with pytest.raises(TimeoutError):
        opt.step(torch.tensor(2.5))
    assert opt._in_flight == []
    assert opt.take_losses() == {1: 1.5}
    np.testing.assert_allclose(w.detach().numpy(), np.full(3, 0.9),
                               rtol=1e-6)


def test_classic_step_populates_phase_timers() -> None:
    w, sgd = _sgd_param()
    opt = OptimizerWrapper(FakeManager(), sgd)
    _set_grad(w, 2.0)
    opt.step()
    snap = opt.metrics.snapshot()
    for phase in ("prologue", "dispatch", "barrier", "fence"):
        assert f"{phase}_avg_ms" in snap, (phase, sorted(snap))
    assert opt.classic_steps == 1 and opt.fused_steps == 0


def test_can_fuse_latches_a_quorum_error() -> None:
    w, sgd = _sgd_param()
    manager = FakeManager()
    opt = OptimizerWrapper(manager, sgd)
    assert opt.can_fuse()
    manager.quorum_error = RuntimeError("quorum timed out")
    assert not opt.can_fuse()
    assert manager.errors == [manager.quorum_error]
    manager.quorum_error, manager.errors = None, []
    manager.solo = False  # a peer on the wire
    assert not opt.can_fuse()


def test_fused_step_commit_and_rollover() -> None:
    w, sgd = _sgd_param()
    manager = FakeManager()
    opt = OptimizerWrapper(manager, sgd)
    calls = []

    def fused(x):
        calls.append(x)
        _set_grad(w, 2.0)
        loss = w.detach().sum().clone()
        sgd.step()
        return loss

    assert opt.can_fuse()
    loss, ok = opt.fused_step(fused, 7)
    assert ok and calls == [7] and float(loss) == 3.0
    np.testing.assert_allclose(w.detach().numpy(), np.full(3, 0.8), rtol=1e-6)
    assert opt.fused_steps == 1
    # a discarded step runs nothing
    manager.commit = False
    loss, ok = opt.fused_step(fused, 8)
    assert not ok and loss is None and calls == [7]
    np.testing.assert_allclose(w.detach().numpy(), np.full(3, 0.8), rtol=1e-6)
    assert opt.take_losses() == {1: 3.0}


def test_fused_step_heal_rereads_state() -> None:
    # a heal lands in the barrier: the fused function re-reads the state
    # (sync_state) before it runs
    w, sgd = _sgd_param()
    opt = OptimizerWrapper(FakeManager(healed=True), sgd)
    order = []

    class Step:
        def sync_state(self):
            order.append("sync")

        def __call__(self):
            order.append("run")
            return torch.tensor(0.0)

    opt.fused_step(Step())
    assert order == ["sync", "run"]
    # no heal: no re-read
    order.clear()
    opt2 = OptimizerWrapper(FakeManager(healed=False), sgd)
    opt2.fused_step(Step())
    assert order == ["run"]


def test_fused_step_drains_classic_fence_first() -> None:
    w, sgd = _sgd_param()
    opt = OptimizerWrapper(FakeManager(), sgd, fence_depth=2)
    _set_grad(w, 2.0)
    assert opt.step(torch.tensor(4.0))
    assert [e[0] for e in opt._in_flight] == ["block"]

    def fused():
        assert not any(e[0] == "block" for e in opt._in_flight)
        return torch.tensor(1.0)

    _, ok = opt.fused_step(fused)
    assert ok
    assert [e[0] for e in opt._in_flight] == ["readback"]
    assert "transition_drain_avg_ms" in opt.metrics.snapshot()
    assert opt.take_losses() == {1: 4.0}


def test_fused_fence_stride_batches_readbacks() -> None:
    w, sgd = _sgd_param()
    manager = FakeManager()
    opt = OptimizerWrapper(manager, sgd, fence_depth=1, fence_stride=4)
    lengths, batches = [], []
    for i in range(12):
        _, ok = opt.fused_step(lambda i=i: torch.tensor(float(i)))
        assert ok
        lengths.append(len(opt._in_flight))
        got = opt.take_losses()
        if got:
            batches.append(sorted(got))
    assert max(lengths) <= 1 + 4
    assert min(lengths[4:]) >= 1
    # each readback brings fence_stride losses at once, keyed by step
    assert batches == [[1, 2, 3, 4], [5, 6, 7, 8]]
    manager.commit = False
    _, ok = opt.fused_step(lambda: torch.tensor(99.0))
    assert not ok and opt._in_flight == []
    assert sorted(opt.take_losses()) == [9, 10, 11, 12]


def test_fused_to_classic_transition_shrinks_fence() -> None:
    w, sgd = _sgd_param()
    opt = OptimizerWrapper(FakeManager(), sgd, fence_depth=1, fence_stride=8)
    for i in range(8):
        opt.fused_step(lambda i=i: torch.tensor(float(i)))
    assert len(opt._in_flight) == 8
    _set_grad(w, 2.0)
    assert opt.step(torch.tensor(-1.0))
    assert len(opt._in_flight) == opt._fence_depth == 1
    assert [e[0] for e in opt._in_flight] == ["block"]
    assert opt.drain() == {**{i + 1: float(i) for i in range(8)}, 9: -1.0}


# ------------------------------------- the overlapped and the decided arm


def _adamw_params(seed=0, shapes=((4, 3), (5,), ())):
    rng = np.random.default_rng(seed)
    params = [torch.nn.Parameter(torch.tensor(
        rng.standard_normal(s).astype(np.float32))) for s in shapes]
    optimizer = torch.optim.AdamW(params, lr=1e-2, weight_decay=1e-2)
    init_adam_state(optimizer)
    return params, optimizer


def _set_grads(params, rng):
    for p in params:
        p.grad = torch.tensor(rng.standard_normal(tuple(p.shape))
                              .astype(np.float32))


def _tensors(params, optimizer):
    """Every parameter and state tensor, in order."""
    out = [p.detach() for p in params]
    for p in params:
        out += [v for _, v in sorted(optimizer.state[p].items())]
    return out


def _snapshot(params, optimizer):
    return [(t.clone(), t.data_ptr()) for t in _tensors(params, optimizer)]


def _assert_unchanged(params, optimizer, snap):
    now = _tensors(params, optimizer)
    assert len(now) == len(snap)
    for t, (before, ptr) in zip(now, snap):
        assert torch.equal(t, before)
        assert t.data_ptr() == ptr


def _spy(monkeypatch, opt, name):
    calls = []
    real = getattr(opt, name)

    def spy(*a):
        calls.append(a)
        return real(*a)

    monkeypatch.setattr(opt, name, spy)
    return calls


def test_classic_step_overlaps_barrier_with_dispatch(monkeypatch) -> None:
    # the default arm: the update is enqueued WHILE the barrier RPC is in
    # flight, so a slow barrier costs max(rpc, update), not their sum
    import threading
    import time

    w, sgd = _sgd_param()
    manager = FakeManager()
    rpc_s = 0.15

    def _commit_async():
        fut = Future()
        fut.local_should_commit = True

        def _resolve():
            time.sleep(rpc_s)  # a slow two-phase-commit round trip
            manager.events.append("decision")
            fut.set_result(True)

        threading.Thread(target=_resolve, daemon=True).start()
        return fut

    manager.should_commit_async = _commit_async
    opt = OptimizerWrapper(manager, sgd)
    real_step = sgd.step

    def traced_step(*a, **kw):
        manager.events.append("dispatch")
        return real_step(*a, **kw)

    monkeypatch.setattr(sgd, "step", traced_step)
    _set_grad(w, 2.0)
    t0 = time.perf_counter()
    assert opt.step()
    elapsed = time.perf_counter() - t0
    # the served state staged first, then the dispatch strictly before the
    # decision resolved: genuine overlap
    assert manager.events == ["staged", "dispatch", "decision"]
    assert elapsed < rpc_s * 2, f"step took {elapsed:.3f}s"
    np.testing.assert_allclose(w.detach().numpy(), np.full(3, 0.8), rtol=1e-6)
    assert "dispatch_avg_ms" in opt.classic_metrics.snapshot()


def test_classic_step_skips_dispatch_on_false_local_vote(monkeypatch) -> None:
    # a False local vote makes the global AND False: no backup, no update
    params, adamw = _adamw_params()
    _set_grads(params, np.random.default_rng(1))
    manager = FakeManager(commit=False, held=True)
    opt = OptimizerWrapper(manager, adamw)
    backups = _spy(monkeypatch, opt, "_backup")
    steps = _spy(monkeypatch, adamw, "step")
    snap = _snapshot(params, adamw)
    assert not opt.step()
    assert not backups and not steps, "update dispatched on a False vote"
    assert manager.events == ["decision"]
    _assert_unchanged(params, adamw, snap)


def test_donated_step_matches_overlapped_step(monkeypatch) -> None:
    # the two arms over 3 committed AdamW steps on the same seeded values:
    # bitwise equal parameters and state (the reference holds its two
    # programs within rtol 1e-6; here both arms run the same in-place
    # update, so nothing may differ), the overlapped arm taking a backup
    # at every step
    results = []
    for donate in (False, True):
        params, adamw = _adamw_params()
        opt = OptimizerWrapper(FakeManager(held=True), adamw,
                               donate_update=donate)
        backups = _spy(monkeypatch, opt, "_backup")
        rng = np.random.default_rng(2)
        for _ in range(3):
            _set_grads(params, rng)
            assert opt.step()
        assert len(backups) == (0 if donate else 3)
        results.append(_tensors(params, adamw))
    for a, b in zip(*results):
        assert torch.equal(a, b)
    # the first parameter's state, sorted: exp_avg, exp_avg_sq, step
    assert int(results[0][len(params) + 2]) == 3


def test_donated_step_noncommit_dispatches_nothing(monkeypatch) -> None:
    # decide-then-apply: a discarded step runs no update and touches no
    # tensor; the gradients stay as they were
    params, adamw = _adamw_params()
    _set_grads(params, np.random.default_rng(1))
    grads = [p.grad.clone() for p in params]
    opt = OptimizerWrapper(FakeManager(commit=False, local=True, held=True),
                           adamw, donate_update=True)
    steps = _spy(monkeypatch, adamw, "step")
    backups = _spy(monkeypatch, opt, "_backup")
    snap = _snapshot(params, adamw)
    assert not opt.step()
    assert not steps and not backups
    _assert_unchanged(params, adamw, snap)
    assert all(torch.equal(p.grad, g) for p, g in zip(params, grads))


def test_donated_step_fence_survives_next_donation() -> None:
    # two commits on the decided arm leave the fence holding the first's
    # entry while the second updates the same tensors in place; a
    # non-commit then drains both, and the values are the two updates'
    w = torch.nn.Parameter(torch.ones(16))
    sgd = torch.optim.SGD([w], lr=0.1)
    manager = FakeManager()
    opt = OptimizerWrapper(manager, sgd, fence_depth=2, donate_update=True)
    for loss in (1.0, 2.0):
        w.grad = torch.full((16,), 0.5)
        assert opt.step(torch.tensor(loss))
    assert [e[0] for e in opt._in_flight] == ["block", "block"]
    manager.commit = False
    w.grad = torch.full((16,), 0.5)
    assert not opt.step(torch.tensor(3.0))
    assert opt._in_flight == []
    assert opt.take_losses() == {1: 1.0, 2: 2.0}
    np.testing.assert_allclose(w.detach().numpy(), np.full(16, 0.9),
                               rtol=1e-6)


def test_overlapped_discard_awaits_dispatched_program(monkeypatch) -> None:
    # a dispatched update the group does not adopt (local vote True, global
    # decision False) is restored and waited out: a peer voting False for
    # M steps leaves no update queued
    params, adamw = _adamw_params()
    opt = OptimizerWrapper(FakeManager(commit=False, local=True, held=True),
                           adamw)
    waited = []
    real_wait = opt._wait_batch
    monkeypatch.setattr(opt, "_wait_batch", lambda entries: (
        waited.extend(entries), real_wait(entries)))
    rng = np.random.default_rng(3)
    snap = _snapshot(params, adamw)
    for _ in range(3):
        _set_grads(params, rng)
        assert not opt.step()
    # every discarded step waited on exactly its own update
    assert [e[0] for e in waited] == ["block"] * 3
    _assert_unchanged(params, adamw, snap)


def test_overlapped_step_awaits_dispatch_when_barrier_raises(
        monkeypatch) -> None:
    # a barrier that fails after the dispatch (a wedged manager, a timeout)
    # restores the backup and waits the update out before re-raising
    params, adamw = _adamw_params()
    _set_grads(params, np.random.default_rng(4))
    manager = FakeManager(commit=TimeoutError("barrier timed out"),
                          held=True)
    opt = OptimizerWrapper(manager, adamw)
    waited = []
    real_wait = opt._wait_batch
    monkeypatch.setattr(opt, "_wait_batch", lambda entries: (
        waited.extend(entries), real_wait(entries)))
    snap = _snapshot(params, adamw)
    with pytest.raises(TimeoutError):
        opt.step()
    assert [e[0] for e in waited] == ["block"], waited
    _assert_unchanged(params, adamw, snap)


@pytest.mark.parametrize("case", ["discard", "local_false", "raises"])
def test_overlapped_noncommit_leaves_state_bitwise_in_place(case) -> None:
    # after a committed step (so the moments are non-zero and the step
    # count moved), each way a step fails to commit leaves every parameter
    # and state tensor bitwise what it was, at its old address
    params, adamw = _adamw_params()
    manager = FakeManager(held=True)
    opt = OptimizerWrapper(manager, adamw)
    rng = np.random.default_rng(5)
    _set_grads(params, rng)
    assert opt.step()
    manager.commit, manager.local = {
        "discard": (False, True), "local_false": (False, False),
        "raises": (ConnectionError("barrier lost"), True)}[case]
    _set_grads(params, rng)
    snap = _snapshot(params, adamw)
    if case == "raises":
        with pytest.raises(ConnectionError):
            opt.step()
    else:
        assert not opt.step()
    _assert_unchanged(params, adamw, snap)
    # and the next committed step is the one a clean history gives
    manager.commit, manager.local = True, None
    assert opt.step()
    ref_params, ref_adamw = _adamw_params()
    rng = np.random.default_rng(5)
    for _ in range(2):
        _set_grads(ref_params, rng)
        ref_adamw.step()
    for a, b in zip(_tensors(params, adamw), _tensors(ref_params, ref_adamw)):
        assert torch.equal(a, b)


def test_overlapped_discard_keeps_a_heal_from_the_prologue() -> None:
    # a heal loads the donor's state in the prologue; the backup is taken
    # after it, so a discarded step restores the healed state, not the
    # pre-heal one
    donor, donor_opt = _adamw_params(seed=7)
    rng = np.random.default_rng(6)
    for _ in range(2):
        _set_grads(donor, rng)
        donor_opt.step()
    params, adamw = _adamw_params()

    def heal():
        with torch.no_grad():
            for p, d in zip(params, donor):
                p.copy_(d)
        load_optimizer_state_dict(adamw, donor_opt.state_dict())

    manager = FakeManager(commit=False, local=True, held=True, healed=True,
                          prologue=heal)
    opt = OptimizerWrapper(manager, adamw)
    ptrs = [t.data_ptr() for t in _tensors(params, adamw)]
    _set_grads(params, rng)
    assert not opt.step()
    for a, b in zip(_tensors(params, adamw), _tensors(donor, donor_opt)):
        assert torch.equal(a, b)
    assert [t.data_ptr() for t in _tensors(params, adamw)] == ptrs


def test_overlapped_step_takes_no_backup_once_the_decision_is_final(
        monkeypatch) -> None:
    # a decision already final when the prologue returns (an epoch-lease
    # step) runs decide-then-apply: no backup; a decision still in flight
    # takes one. Both land on the same values
    results = []
    for held in (True, False):
        params, adamw = _adamw_params()
        manager = FakeManager(held=held)
        opt = OptimizerWrapper(manager, adamw)
        backups = _spy(monkeypatch, opt, "_backup")
        _set_grads(params, np.random.default_rng(8))
        assert opt.step()
        assert len(backups) == (1 if held else 0)
        assert manager.events == (["staged", "decision"] if held
                                  else ["decision"])
        results.append(_tensors(params, adamw))
    for a, b in zip(*results):
        assert torch.equal(a, b)


class _FailingAdamW(torch.optim.AdamW):
    """AdamW whose next step, once ``fail`` is set, updates its first
    parameter group and then raises ``fail``: an allocation failure part
    way through the update."""

    fail = None

    def step(self, closure=None):
        if self.fail is None:
            return super().step(closure)
        exc, self.fail = self.fail, None
        groups = self.param_groups
        self.param_groups = groups[:1]
        try:
            super().step(closure)
        finally:
            self.param_groups = groups
        raise exc


def _failing_adamw(seed=0):
    params, _ = _adamw_params(seed)
    adamw = _FailingAdamW([{"params": params[:1]}, {"params": params[1:]}],
                          lr=1e-2, weight_decay=1e-2)
    init_adam_state(adamw)
    return params, adamw


def _raise_once(real, exc):
    """``real``, except that its first call raises ``exc``."""
    armed = [exc]

    def call(*a, **k):
        if armed:
            raise armed.pop()
        return real(*a, **k)

    return call


@pytest.mark.parametrize("where", ["update", "backup", "staging",
                                   "update_and_barrier"])
def test_overlapped_raise_rolls_back_and_reads_the_decision(where) -> None:
    # anything that raises between the prologue and the decision on the
    # overlapped arm (the served state's staging, the backup, an update
    # that wrote part of the state) leaves every parameter and state
    # tensor bitwise what it was at its old address, reads the decision,
    # drains the fence and re-raises the original exception, with a
    # failing barrier chained to it; the next step commits as a wrapper
    # that never raised does
    params, adamw = _failing_adamw()
    manager = FakeManager(held=True)
    opt = OptimizerWrapper(manager, adamw)
    rng = np.random.default_rng(10)
    _set_grads(params, rng)
    assert opt.step() and opt._in_flight
    _set_grads(params, rng)
    snap = _snapshot(params, adamw)
    fault = MemoryError("allocation failed part way through the update")
    if where == "backup":
        opt._backup = _raise_once(opt._backup, fault)
    elif where == "staging":
        manager.finish_staging = _raise_once(manager.finish_staging, fault)
    else:
        adamw.fail = fault
    if where == "update_and_barrier":
        manager.commit = ConnectionError("barrier lost")
    manager.events.clear()
    with pytest.raises(MemoryError) as raised:
        opt.step()
    assert raised.value is fault
    if where == "update_and_barrier":
        assert isinstance(raised.value.__context__, ConnectionError)
    assert "decision" in manager.events
    assert not opt._in_flight
    _assert_unchanged(params, adamw, snap)
    manager.commit = True
    assert opt.step()
    ref_params, ref_adamw = _failing_adamw()
    rng = np.random.default_rng(10)
    for _ in range(2):
        _set_grads(ref_params, rng)
        ref_adamw.step()
    for a, b in zip(_tensors(params, adamw), _tensors(ref_params, ref_adamw)):
        assert torch.equal(a, b)


def test_update_window_wraps_each_arm_update() -> None:
    # the window opens after the prologue and closes after the update
    # (overlapped: after the decision and the drop or the restore)
    from contextlib import contextmanager

    for donate, held in ((False, True), (True, True), (False, False)):
        w, sgd = _sgd_param()
        manager = FakeManager(held=held)
        order = []

        @contextmanager
        def window():
            order.append("open")
            yield
            order.append("close")

        manager.prologue = lambda: order.append("prologue")
        real_step = sgd.step
        sgd.step = lambda *a, **k: (order.append("update"),
                                    real_step(*a, **k))[1]
        opt = OptimizerWrapper(manager, sgd, donate_update=donate,
                               update_window=window)
        _set_grad(w, 2.0)
        assert opt.step()
        assert order == ["prologue", "open", "update", "close"], (donate,
                                                                  held)


@pytest.mark.parametrize("donate", [False, True])
def test_both_arms_track_the_reference_wrapper(donate) -> None:
    # the port's two arms and the reference's OptimizerWrapper at the same
    # donate_update, from the same "tiny" parameters (from_jax_params) and
    # the same seeded gradients, 3 committed AdamW steps: every parameter
    # within this file's 1e-4 absolute (torch's AdamW and optax's adamw
    # round in another order), and the port's arms bitwise each other
    import optax

    from torchft_tpu.models import transformer as jtf
    from torchft_tpu.optim import OptimizerWrapper as JaxWrapper

    jcfg = dataclasses.replace(jtf.CONFIGS["tiny"], dtype=jnp.float32)
    params = jax.device_get(jtf.init_params(jcfg, jax.random.key(0)))
    rng = np.random.default_rng(9)
    grads = [jax.tree_util.tree_map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32), params)
        for _ in range(3)]
    jopt = JaxWrapper(FakeManager(held=True), optax.adamw(3e-4),
                      donate_update=donate)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = jopt.init(jparams)
    for g in grads:
        jparams, jstate, ok = jopt.step(
            jparams, jstate, jax.tree_util.tree_map(jnp.asarray, g))
        assert ok
    want = from_jax_params(jax.device_get(jparams))
    cfg = dataclasses.replace(CONFIGS["tiny"], dtype=torch.float32)
    arms = []
    for port_donate in (False, True):
        model = GPT(cfg, device="cpu")
        model.load_state_dict(from_jax_params(params))
        adamw = torch.optim.AdamW(model.parameters(), lr=3e-4,
                                  weight_decay=1e-4)
        init_adam_state(adamw)
        opt = OptimizerWrapper(FakeManager(held=True), adamw,
                               donate_update=port_donate)
        named = dict(model.named_parameters())
        for g in grads:
            for name, value in from_jax_params(g).items():
                named[name].grad = value.clone()
            assert opt.step()
        for name, p in named.items():
            np.testing.assert_allclose(p.detach().numpy(),
                                       want[name].numpy(), rtol=0,
                                       atol=1e-4, err_msg=name)
        arms.append([p.detach().clone() for p in model.parameters()])
    assert all(torch.equal(a, b) for a, b in zip(*arms))


# ---------------------------------------------------- the fused train step


def _gpt(seed=0, cfg=None):
    cfg = cfg or CONFIGS["tiny"]
    torch.manual_seed(seed)
    model = GPT(cfg, device="cpu", seed=seed)
    optimizer = torch.optim.AdamW(model.parameters(), lr=3e-4,
                                  weight_decay=1e-4)
    return model, optimizer


def _batches(cfg, n, batch=2, seed=5):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                              (batch, cfg.max_seq_len)))
        yield tokens, torch.roll(tokens, -1, dims=1)


def test_fused_trajectory_matches_classic() -> None:
    # over 5 committed steps the fused path lands bitwise where forward /
    # backward -> (identity average) -> gated update lands
    cfg = CONFIGS["tiny"]
    mc, oc = _gpt()
    opt_c = OptimizerWrapper(FakeManager(solo=False), oc)
    for tokens, targets in _batches(cfg, 5):
        opt_c.begin_step()
        loss = mc.loss(tokens, targets)
        loss.backward()
        assert opt_c.step(loss.detach())
    mf, of = _gpt()
    opt_f = OptimizerWrapper(FakeManager(), of)
    step = make_train_step(mf, of)
    for tokens, targets in _batches(cfg, 5):
        opt_f.begin_step()
        assert opt_f.can_fuse()
        _, ok = opt_f.fused_step(step, tokens, targets)
        assert ok
    for (name, a), b in zip(mc.named_parameters(), mf.parameters()):
        assert torch.equal(a, b), name
    assert opt_c.drain() == opt_f.drain()
    for p in mc.parameters():
        for k, v in oc.state[p].items():
            assert torch.equal(v, of.state[dict(zip(
                mc.parameters(), mf.parameters()))[p]][k]), k


def test_load_optimizer_state_dict_in_place() -> None:
    cfg = CONFIGS["tiny"]
    donor, donor_opt = _gpt(seed=1)
    step = make_train_step(donor, donor_opt)
    for tokens, targets in _batches(cfg, 2):
        step(tokens, targets)
    healer, healer_opt = _gpt(seed=2)
    # no state yet: a plain load builds the tensors
    load_optimizer_state_dict(healer_opt, donor_opt.state_dict())
    tensors = [v for p in healer.parameters()
               for v in healer_opt.state[p].values()]
    for tokens, targets in _batches(cfg, 1, seed=9):
        step(tokens, targets)
    # state present: the load copies into the same tensors
    load_optimizer_state_dict(healer_opt, donor_opt.state_dict())
    after = [v for p in healer.parameters()
             for v in healer_opt.state[p].values()]
    assert all(a is b for a, b in zip(tensors, after))
    for pd, ph in zip(donor.parameters(), healer.parameters()):
        for k in donor_opt.state[pd]:
            assert torch.equal(donor_opt.state[pd][k], healer_opt.state[ph][k])
    # other hyperparameters: a plain load
    sd = donor_opt.state_dict()
    sd["param_groups"][0]["lr"] = 1e-3
    load_optimizer_state_dict(healer_opt, sd)
    assert healer_opt.param_groups[0]["lr"] == 1e-3


def test_fused_step_from_jax_params_matches_reference_train_step() -> None:
    import optax

    from torchft_tpu.models import transformer as jtf

    jcfg = jtf.CONFIGS["tiny"]
    cfg = dataclasses.replace(CONFIGS["tiny"], dtype=torch.float32)
    jcfg = dataclasses.replace(jcfg, dtype=jnp.float32)
    params = jax.device_get(jtf.init_params(jcfg, jax.random.key(0)))
    tx = optax.adamw(3e-4)
    jstep = jtf.make_train_step(jcfg, tx, donate=False)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = tx.init(jparams)

    model = GPT(cfg, device="cpu")
    model.load_state_dict(from_jax_params(params))
    optimizer = torch.optim.AdamW(model.parameters(), lr=3e-4,
                                  weight_decay=1e-4)
    opt = OptimizerWrapper(FakeManager(), optimizer)
    step = make_train_step(model, optimizer)
    losses = []
    for tokens, targets in _batches(cfg, 3):
        jparams, jstate, jloss = jstep(
            jparams, jstate, jnp.asarray(tokens.numpy(), jnp.int32),
            jnp.asarray(targets.numpy(), jnp.int32))
        loss, ok = opt.fused_step(step, tokens, targets)
        assert ok
        losses.append((float(loss), float(jloss)))
    for got, want in losses:
        assert abs(got - want) <= 1e-5, losses
    got_params = from_jax_params(jax.device_get(jparams))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(),
                                   got_params[name].numpy(), rtol=0,
                                   atol=1e-4, err_msg=name)


def test_train_step_on_the_cpu_counts_no_capture() -> None:
    model, optimizer = _gpt()
    step = make_train_step(model, optimizer)
    for tokens, targets in _batches(CONFIGS["tiny"], 2):
        loss = step(tokens, targets)
        assert loss.dim() == 0 and torch.isfinite(loss)
    assert step.captures == 0 and step.warmup_passes == 0
    step.sync_state()  # nothing captured: a no-op


@pytest.mark.parametrize("name", ["adamw", "adam"])
def test_transformation_optimizer_tracks_optax(name) -> None:
    # TransformationOptimizer steps in place by the port's optax-order
    # transformation: five steps on seeded parameters and gradients against
    # optax itself, within the outer optimizer's tolerance (rtol 1e-6,
    # atol 1e-7; bitwise in practice)
    import optax

    from torchft_tpu_torch import optim

    make = {"adamw": (lambda: optim.adamw(3e-4), lambda: optax.adamw(3e-4)),
            "adam": (lambda: optim.adam(1e-2), lambda: optax.adam(1e-2))}
    port_tx, ref_tx = make[name]
    rng = np.random.default_rng(3)
    shapes = [(4, 3), (5,), ()]
    init = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    params = [torch.nn.Parameter(torch.tensor(a)) for a in init]
    opt = optim.TransformationOptimizer(params, port_tx())
    ref = [jnp.asarray(a) for a in init]
    tx = ref_tx()
    state = tx.init(ref)
    for _ in range(5):
        grads = [rng.standard_normal(s).astype(np.float32) for s in shapes]
        for p, g in zip(params, grads):
            p.grad = torch.tensor(g)
        opt.step()
        updates, state = tx.update([jnp.asarray(g) for g in grads], state,
                                   ref)
        ref = optax.apply_updates(ref, updates)
    for p, r in zip(params, ref):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(r),
                                   rtol=1e-6, atol=1e-7)


def test_transformation_optimizer_state_is_a_template_loaded_in_place():
    # the state exists before the first step (optax's init), so its
    # state_dict lists every leaf a donor serves, and a load lands in place
    from torchft_tpu_torch import optim

    params = [torch.nn.Parameter(torch.ones(3)) for _ in range(2)]
    opt = optim.TransformationOptimizer(params, optim.adamw(3e-4))
    sd = opt.state_dict()
    assert sorted(sd["state"][0]) == ["count", "mu", "nu"]
    assert sd["state"][1]["count"].dtype == torch.int32
    donor = optim.TransformationOptimizer(
        [torch.nn.Parameter(torch.ones(3)) for _ in range(2)],
        optim.adamw(3e-4))
    for p in donor.param_groups[0]["params"]:
        p.grad = torch.full((3,), 0.5)
    donor.step()
    before = [v.data_ptr() for s in opt.state.values() for v in s.values()]
    load_optimizer_state_dict(opt, donor.state_dict())
    after = [v.data_ptr() for s in opt.state.values() for v in s.values()]
    assert before == after
    assert all(int(s["count"]) == 1 for s in opt.state.values())
    assert torch.equal(opt.state[params[0]]["mu"],
                       donor.state[donor.param_groups[0]["params"][0]]["mu"])
    with pytest.raises(ValueError, match="closure"):
        opt.step(lambda: 0.0)
    with pytest.raises(ValueError, match="adam or adamw"):
        optim.TransformationOptimizer(params, optim.sgd(0.1, momentum=0.9))


@pytest.mark.parametrize("name", ["adamw", "adam", "adamw_decay"])
def test_transformation_optimizer_steps_in_place_as_the_transformation(
        name) -> None:
    # the in-place step against OuterTransformation.update then
    # apply_updates on the same seeded values: bitwise, and the parameters
    # and moments keep their storage across steps
    from torchft_tpu_torch import optim

    make = {"adamw": lambda: optim.adamw(3e-4),
            "adam": lambda: optim.adam(1e-2),
            "adamw_decay": lambda: optim.adamw(1e-2, weight_decay=0.1)}[name]
    rng = np.random.default_rng(5)
    shapes = [(6, 5), (7,), ()]
    init = [torch.tensor(rng.standard_normal(s).astype(np.float32))
            for s in shapes]
    params = [torch.nn.Parameter(a.clone()) for a in init]
    opt = optim.TransformationOptimizer(params, make())
    storage = [t.data_ptr() for t in params] + [
        v.data_ptr() for p in params for v in opt.state[p].values()]
    tx = make()
    ref, state = list(init), tx.init(init)
    for _ in range(4):
        grads = [torch.tensor(rng.standard_normal(s).astype(np.float32))
                 for s in shapes]
        for p, g in zip(params, grads):
            p.grad = g
        opt.step()
        updates, state = tx.update(grads, state, ref)
        ref = optim.apply_updates(ref, updates)
    for p, r in zip(params, ref):
        assert torch.equal(p.detach(), r)
    for key in ("mu", "nu"):
        for p, r in zip(params, state[key]):
            assert torch.equal(opt.state[p][key], r)
    assert all(int(opt.state[p]["count"]) == int(state["count"]) == 4
               for p in params)
    assert storage == [t.data_ptr() for t in params] + [
        v.data_ptr() for p in params for v in opt.state[p].values()]
