"""End-to-end fault tolerance of the port at "tiny" on the CPU.

Real native lighthouse and manager servers, real TCP gradient wire, real
HTTP heal plane, replica groups in threads. The twin of
``test_ddp_recovery_replica_killed_and_heals`` (tests/test_integration.py)
runs the port's training loop (``examples/train_ddp.py``): a group fails,
restarts from a poisoned init, heals from its peer and must then be
bitwise equal to its donor at every step both commit. The cross-package
check starts the port and the JAX package's classic (non-fused) path from
the same parameters and data, one replica group each, and compares the
losses of 5 committed steps. The drill runs once more over the on-device
int8 plane. ``run_resume_drill`` runs the durable half at "tiny": a fused
solo phase, a heal, steady steps on the epoch lease, checkpoints, a kill of
both groups and a resume, with the checks ``chip_smoke.py``'s
``train_durable`` makes (on the card it also counts the flash launches).
"""

import dataclasses
import math
import os
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torchft_tpu_torch.control import Lighthouse
from torchft_tpu_torch.examples.train_ddp import (
    run_kill_and_heal,
    run_resume_drill,
    train_group,
)
from torchft_tpu_torch.models import CONFIGS, from_jax_params

STEPS = 5
# |port loss - JAX loss| per committed step. f32: summation order only; the
# bf16 default rounds at other places in the two frameworks and AdamW's
# first steps (update ~ lr * sign) carry the difference forward.
LOSS_TOL = {"f32": 1e-5, "bf16": 5e-3}


def test_ddp_recovery_replica_killed_and_heals() -> None:
    result = run_kill_and_heal(CONFIGS["tiny"], kill_step=2, steps_after=2,
                               device="cpu", batch_size=2, timeout=20.0)
    runs = result["runs"]
    # the fixed schedule: steps 1-2 together, 3 by group 0 alone, the heal
    # commit 4 (whose gradient is group 0's alone: the healing group's came
    # from its poisoned state), then 5-6 together; 6 + 2 + 3
    # forward/backward passes
    assert result["heal_step"] == 4
    assert result["checked_steps"] == [4, 5, 6]
    assert sorted(runs[0].losses) == [1, 2, 3, 4, 5, 6]
    assert sorted(runs[1].losses) == [4, 5, 6]
    assert runs[0].participants == {1: 2, 2: 2, 3: 1, 4: 1, 5: 2, 6: 2}
    assert runs[1].participants == {4: 1, 5: 2, 6: 2}
    assert result["passes"] == 11
    for run in runs.values():
        assert all(math.isfinite(v) for v in run.losses.values())


def test_recovery_over_the_int8_device_plane() -> None:
    # the same drill with the gradient wire swapped for the on-device plane
    # (comm/cuda_backend.py, here on the CPU) running the quantized psum
    # with error feedback: the heal must still be bitwise, because every
    # rank decodes the same reduced bytes
    from torchft_tpu_torch.comm.cuda_backend import default_device_pool

    pool = default_device_pool("cpu")
    plans = pool.compile_count
    result = run_kill_and_heal(
        CONFIGS["tiny"], kill_step=2, steps_after=2, device="cpu",
        batch_size=2, timeout=20.0, comm_backend="cuda",
        comm_options={"algorithm": "psum", "compression": "int8"})
    runs = result["runs"]
    assert result["heal_step"] == 4 and result["checked_steps"] == [4, 5, 6]
    assert runs[0].participants == {1: 2, 2: 2, 3: 1, 4: 1, 5: 2, 6: 2}
    # a peer on the wire in k + 1 + a = 5 steps, group 0's solo step aside
    assert runs[0].wire_steps == 5 and runs[1].wire_steps == 3
    assert runs[0].metrics["comm_backend"] == "cuda"
    assert runs[0].metrics["comm_encoded_bytes"] \
        <= 0.3 * runs[0].metrics["comm_raw_bytes"]
    # one plan (world 2, the frozen bucket layout) however often the
    # membership changed
    assert pool.compile_count - plans <= 1
    for run in runs.values():
        assert all(math.isfinite(v) for v in run.losses.values())


def _jax_classic_losses(jcfg, params_np, steps):
    import optax

    from torchft_tpu.comm.store import StoreServer
    from torchft_tpu.comm.transport import TcpCommContext
    from torchft_tpu.data import DistributedSampler
    from torchft_tpu.ddp import DistributedDataParallel
    from torchft_tpu.manager import Manager
    from torchft_tpu.models import make_grad_step
    from torchft_tpu.optim import OptimizerWrapper

    lh = Lighthouse(min_replicas=1, join_timeout_ms=100)
    store = StoreServer()
    tx = optax.adamw(3e-4)
    state = {"params": jax.tree_util.tree_map(jnp.asarray, params_np)}
    state["opt"] = tx.init(state["params"])
    dataset = np.random.default_rng(0).integers(
        0, jcfg.vocab_size, (4096, jcfg.max_seq_len))
    sampler = DistributedSampler(len(dataset), replica_group=0,
                                 num_replica_groups=1, shuffle=True, seed=1)
    manager = Manager(
        comm=TcpCommContext(timeout=20.0),
        load_state_dict=lambda sd: state.update(sd),
        state_dict=lambda: dict(state),
        min_replica_size=1, rank=0, world_size=1, store_addr=store.addr,
        lighthouse_addr=lh.address(), replica_id="jax_classic_",
        timeout=20.0, quorum_timeout=20.0, connect_timeout=20.0,
    )
    ddp = DistributedDataParallel(manager)
    opt = OptimizerWrapper(manager, tx,
                           state_fn=lambda: (state["params"], state["opt"]))
    grad_step = make_grad_step(jcfg)
    losses = {}
    it = iter(sampler)
    try:
        while manager.current_step() < steps:
            idx = [next(it) for _ in range(8)]
            tokens = jnp.asarray(dataset[idx], dtype=jnp.int32)
            targets = jnp.roll(tokens, -1, axis=1)
            opt.begin_step()
            loss, grads = grad_step(state["params"], tokens, targets)
            avg = ddp.average_gradients(grads)
            params, opt_state, committed = opt.step(
                state["params"], state["opt"], avg)
            if committed:
                state["params"], state["opt"] = params, opt_state
                losses[manager.current_step()] = float(loss)
    finally:
        manager.shutdown()
        store.shutdown()
        lh.shutdown()
    return losses


@pytest.mark.parametrize("dtype_case", ["f32", "bf16"])
def test_single_group_loss_tracks_jax_classic_path(dtype_case, monkeypatch):
    # the JAX package's epoch-lease fast path off: its classic full-quorum
    # path is the one the port mirrors
    monkeypatch.setenv("TORCHFT_TPU_FASTPATH", "0")
    from torchft_tpu.models import transformer as jtf

    tdt, jdt = ((torch.float32, jnp.float32) if dtype_case == "f32"
                else (torch.bfloat16, jnp.bfloat16))
    jcfg = dataclasses.replace(jtf.CONFIGS["tiny"], dtype=jdt)
    cfg = dataclasses.replace(CONFIGS["tiny"], dtype=tdt)
    params = jax.device_get(jtf.init_params(jcfg, jax.random.key(0)))
    jax_losses = _jax_classic_losses(jcfg, params, STEPS)

    lh = Lighthouse(min_replicas=1, join_timeout_ms=100)
    try:
        run = train_group(cfg, replica_group=0, num_groups=1,
                          total_steps=STEPS, lighthouse_addr=lh.address(),
                          device="cpu", init_state=from_jax_params(params),
                          timeout=20.0)
    finally:
        lh.shutdown()
    assert sorted(run.losses) == sorted(jax_losses) == list(range(1, 6))
    for step, loss in run.losses.items():
        assert abs(loss - jax_losses[step]) <= LOSS_TOL[dtype_case], (
            step, loss, jax_losses[step])


def test_resume_drill_at_tiny(tmp_path, monkeypatch) -> None:
    monkeypatch.setenv("TORCHFT_TPU_FASTPATH", "1")
    cfg = CONFIGS["tiny"]
    assert cfg.n_layers == 2
    result = run_resume_drill(cfg, device="cpu", batch_size=2, timeout=30.0,
                              ckpt_dir=str(tmp_path))
    runs = result["runs"]
    first0, first1 = runs[0][0], runs[1][0]
    # the schedule: 3 fused solo steps, the heal commit 4, joint 5-7, the
    # kill, the resume from step 6, then 7-8 again
    assert first0.fused_steps == 3 and first1.fused_steps == 0
    assert first1.healed_at == [4]
    assert result["heal_step"] == 4 and result["resume_step"] == 6
    assert result["checked_steps"] == [[4, 5, 6, 7], [7, 8]]
    # steps 6 and 7 ride the lease in both groups (the heal quorum grants
    # no lease; the next full quorum does), 8 after the resume
    for g in (0, 1):
        assert [s for s, n in runs[g][0].control_rpcs.items() if n == 0] \
            == [6, 7]
        assert [s for s, n in runs[g][1].control_rpcs.items() if n == 0] \
            == [8]
        assert runs[g][1].resumed_step == 6
        assert runs[g][1].resume_mismatches == []
        assert runs[g][1].resume_seconds > 0
    assert result["telemetry"]["lease_live"] is True
    assert result["telemetry"]["control_rpcs_per_step"] == 0
    # the resumed step 7 repeats the first life's step 7 bit for bit
    assert result["replay_equal"] is True
    # every group wrote every second step, keep=2 on disk
    assert [c["path"].rsplit(".", 1)[1] for c in first0.checkpoints] == [
        "2", "4", "6"]
    assert sorted(os.listdir(tmp_path / "group0")) == ["ckpt.6", "ckpt.8"]
    # passes: 7 + 4 before the kill, 2 + 2 after (no capture on the CPU)
    assert result["passes"] == 15
    for g in (0, 1):
        for run in runs[g]:
            assert all(math.isfinite(v) for v in run.losses.values())
    assert sorted(first0.losses) == list(range(1, 8))
    assert sorted(runs[0][1].losses) == [7, 8]


# --- observers in a live quorum (twins of test_integration.py's) -----------

_TARGET = np.full((2, 3), 10.0, dtype=np.float32)


def _observer_manager(pkg, lighthouse, store, name, **kw):
    import torchft_tpu.comm.transport as jtransport
    import torchft_tpu.manager as jmanager

    from torchft_tpu_torch.comm.transport import TcpCommContext
    from torchft_tpu_torch.manager import Manager

    mgr_cls, comm = ((Manager, TcpCommContext(timeout=5.0)) if pkg == "torch"
                     else (jmanager.Manager,
                           jtransport.TcpCommContext(timeout=5.0)))
    kw.setdefault("min_replica_size", 1)
    return mgr_cls(comm=comm, timeout=5.0,
                   quorum_timeout=5.0, connect_timeout=5.0, rank=0,
                   world_size=1, store_addr=store.addr,
                   lighthouse_addr=lighthouse.address(),
                   replica_id=f"{name}_", heartbeat_interval=0.05, **kw)


class _Trainer:
    """A replica group descending w -= 0.5 * avg(w - target): one step's
    implied contribution ratio (w_a - w_b) / (0.5 (w_a - target)) is the
    share of participants that contributed, 1.0 or 0.5 (a healer gives
    zeros) in a cohort of two; 2/3 or 1/3 if an observer were counted."""

    def __init__(self, lighthouse, name, **kw) -> None:
        from torchft_tpu_torch.comm.store import StoreServer

        self.store = StoreServer()
        self.state = {"w": np.zeros((2, 3), np.float32)}
        self.history = {}
        self.parts = set()
        self.healed = False
        self.manager = _observer_manager(
            "torch", lighthouse, self.store, name,
            load_state_dict=self._load, state_dict=lambda: dict(self.state),
            **kw)

    def _load(self, sd) -> None:
        self.state["w"] = np.array(sd["w"], np.float32)

    def step(self) -> bool:
        from torchft_tpu_torch.comm.context import ReduceOp

        m = self.manager
        m.start_quorum()
        avg = m.allreduce_arrays([self.state["w"] - _TARGET],
                                 op=ReduceOp.AVG).future().result(timeout=20)
        if not m.should_commit():
            return False
        self.healed |= m.did_heal()
        self.parts.add(m.num_participants())
        self.state["w"] = self.state["w"] - np.float32(0.5) * avg[0]
        self.history[m.current_step()] = self.state["w"].copy()
        return True

    def close(self) -> None:
        self.manager.shutdown(wait=False)
        self.store.shutdown()


def _ratios(trainer):
    steps = sorted(trainer.history)
    out = []
    for a, b in zip(steps, steps[1:]):
        if b == a + 1:
            w_a, w_b = trainer.history[a], trainer.history[b]
            out.append(float(np.mean((w_a - w_b) / (0.5 * (w_a - _TARGET)))))
    return out


def _observe(pkg, lighthouse, stop, view):
    from torchft_tpu_torch.comm.store import StoreServer

    store = StoreServer()
    m = _observer_manager(pkg, lighthouse, store, "observer_0",
                          data_plane=False, load_state_dict=lambda sd: None,
                          state_dict=lambda: {})
    try:
        while not stop.is_set():
            try:
                m.start_quorum(allow_heal=False)
                m.wait_quorum()
            except (TimeoutError, RuntimeError):
                continue
            view["world_max"] = max(view["world_max"],
                                    m.replica_world_size())
            view["participated"] |= m.is_participating()
            view["wire_max"] = max(view["wire_max"],
                                   m.transport_world_size())
            view["steps"] = m.current_step()
            time.sleep(0.02)
    finally:
        m.shutdown(wait=False)
        store.shutdown()


@pytest.mark.parametrize("observer_pkg", ["torch", "jax"])
def test_observer_replica_is_invisible_to_training(observer_pkg) -> None:
    """Two port trainers and an observer (of either package) in one
    quorum: every update is a two-participant scale, the observer sees
    the full three-member quorum from a wire of its own and never
    participates or advances."""
    import threading
    from concurrent.futures import ThreadPoolExecutor

    lh = Lighthouse(min_replicas=1, join_timeout_ms=200,
                    heartbeat_timeout_ms=1000)
    stop = threading.Event()
    view = {"world_max": 0, "participated": False, "wire_max": 0,
            "steps": 0}
    obs = threading.Thread(target=_observe,
                           args=(observer_pkg, lh, stop, view), daemon=True)
    trainers = [_Trainer(lh, f"obstrain_{i}") for i in range(2)]
    try:
        obs.start()

        def run(t):
            while len(t.history) < 6:
                t.step()

        with ThreadPoolExecutor(max_workers=2) as pool:
            list(pool.map(run, trainers, timeout=120))
    finally:
        stop.set()
        obs.join(timeout=10)
        for t in trainers:
            t.close()
        lh.shutdown()
    for step in set(trainers[0].history) & set(trainers[1].history):
        assert np.array_equal(trainers[0].history[step],
                              trainers[1].history[step])
    ratios = [r for t in trainers for r in _ratios(t)]
    assert len(ratios) >= 4
    assert all(min(abs(r - 1.0), abs(r - 0.5)) < 1e-4 for r in ratios), ratios
    assert all(t.parts <= {1, 2} for t in trainers)
    assert view["world_max"] == 3, view
    assert not view["participated"] and view["wire_max"] == 1
    assert view["steps"] == 0


def test_observer_heal_and_spares_together() -> None:
    """Three trainers under FIXED_WITH_SPARES(min 2) and a JAX-package
    observer: a participant is killed, restarts and heals; at every step
    the participant count is clamped to 2, every update is a
    two-participant scale and the observer never participates."""
    import threading

    from torchft_tpu_torch.manager import WorldSizeMode

    lh = Lighthouse(min_replicas=2, join_timeout_ms=200,
                    heartbeat_timeout_ms=1000)
    stop = threading.Event()
    view = {"world_max": 0, "participated": False, "wire_max": 0,
            "steps": 0}
    obs = threading.Thread(target=_observe, args=("jax", lh, stop, view),
                           daemon=True)
    spares = dict(min_replica_size=2,
                  world_size_mode=WorldSizeMode.FIXED_WITH_SPARES)
    trainers = [_Trainer(lh, f"spare_{i}", **spares) for i in range(3)]
    rejoined = []
    errors = []

    def run(i):
        # trainer 0 is killed after its third step and restarts; the
        # others step on until the restarted one has committed 3 steps
        try:
            t = trainers[i]
            while not stop.is_set():
                if i == 0 and len(t.history) == 3:
                    t.close()
                    t = _Trainer(lh, "spare_0_again", **spares)
                    rejoined.append(t)
                    while len(t.history) < 3 and not stop.is_set():
                        t.step()
                    return
                if i and rejoined and len(rejoined[0].history) >= 3:
                    return
                t.step()
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append(e)
            stop.set()

    threads = [threading.Thread(target=run, args=(i,)) for i in range(3)]
    try:
        obs.start()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
    finally:
        stop.set()
        obs.join(timeout=10)
        for t in trainers[1:] + rejoined:
            t.close()
        lh.shutdown()
    if errors:
        raise errors[0]
    everyone = trainers + rejoined
    assert rejoined and rejoined[0].healed
    assert all(t.parts <= {1, 2} and t.parts for t in everyone)
    ratios = [r for t in everyone for r in _ratios(t)]
    assert len(ratios) >= 6
    assert all(min(abs(r - 1.0), abs(r - 0.5)) < 1e-4 for r in ratios), ratios
    assert not view["participated"] and view["world_max"] >= 3
