"""The port's OptimizerWrapper and fused train step against the JAX package's.

Twins of the OptimizerWrapper tests of tests/test_train_integration.py:
commit and abort, the phase timers, the fused step's commit and rollover,
a heal making the fused step re-read the state, the classic -> fused
transition draining the fence, the fused trajectory equal to the classic
one (bitwise here: on the CPU both paths run the same eager arithmetic),
fence-stride batching of the loss readback, and the fused -> classic
transition shrinking the fence. A stand-in manager decides the commits,
as the reference's tests use a mock.

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
from torchft_tpu_torch.optim import OptimizerWrapper, load_optimizer_state_dict


class FakeManager:
    """Just enough Manager for the wrapper: decisions set by the test."""

    def __init__(self, commit=True, solo=True, healed=False):
        self.commit = commit
        self.solo = solo
        self.healed = healed
        self.step = 0
        self.errors = []
        self.quorum_error = None

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

    def should_commit_async(self):
        fut = Future()
        if isinstance(self.commit, BaseException):
            fut.set_exception(self.commit)
        else:
            if self.commit:
                self.step += 1
            fut.set_result(bool(self.commit))
        fut.local_should_commit = bool(self.commit)
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
