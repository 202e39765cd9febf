"""Process-level kill and heal with the port: each replica group a real OS
process, SIGKILLed mid-step and relaunched.

Twin of ``tests/test_integration_proc.py``. The thread drills model a death
as a clean shutdown inside one process; here a whole process dies, its
manager server, store, checkpoint server and transport sockets together,
mid-collective, with no cleanup.

- ``test_process_replica_sigkill_relaunch_heal``: the reference test's
  phases and oracle on the port's Manager, ``StoreServer`` and
  ``TcpCommContext``, with the reference's numpy toy worker (W -> target)
  written against the port.
- ``test_mixed_cohort_port_relaunch_heals_from_the_reference``: the
  reference's own worker (``test_integration_proc._proc_replica_main``,
  spawned unchanged) survives; the port's worker is killed, relaunched from
  the poison value and heals from the reference's live checkpoint through
  its template (a heal without one cannot cross packages: F7 in ROADMAP).
- ``test_run_process_drill_at_tiny``: the example's process drill
  (``examples.train_ddp.run_process_drill``), the GPT at "tiny" on the
  CPU, whose 125m run is chip_smoke.py's ``train_proc``.

The workers never touch a JAX backend: the reference's is numpy only, and
the port's imports no JAX at all.
"""

import logging
import multiprocessing as mp
import queue as queue_mod
import time

import numpy as np

from torchft_tpu_torch.control import Lighthouse
from torchft_tpu_torch.models import CONFIGS

logger = logging.getLogger(__name__)

_TARGET = 10.0
_LR = 0.5


def _port_replica_main(replica_id, incarnation, lighthouse_addr, stop_evt,
                       q, template=False) -> None:
    """The reference's toy worker on the port: its own store, manager (with
    the native manager server and a checkpoint server) and TCP transport.
    ``template``: heal through ``CheckpointServer(template_fn=...)``, the
    path that crosses packages."""
    import faulthandler
    import signal

    from torchft_tpu_torch.checkpointing import CheckpointServer
    from torchft_tpu_torch.comm.store import StoreServer
    from torchft_tpu_torch.comm.transport import TcpCommContext
    from torchft_tpu_torch.manager import Manager

    faulthandler.register(signal.SIGUSR1, all_threads=True)
    target = np.full((2, 3), _TARGET, dtype=np.float32)
    # a relaunch starts from a poison value: only a real heal can make its
    # trajectory match
    w0 = 99.0 if incarnation > 0 else 0.0
    state = {"w": np.full((2, 3), w0, dtype=np.float32)}

    def load_state_dict(sd):
        state["w"] = np.array(sd["w"], dtype=np.float32)

    transport = None
    if template:
        transport = CheckpointServer(timeout=5.0, template_fn=lambda: {
            "user": {"w": state["w"]},
            "torchft": {"step": 0, "batches_committed": 0}})
    store = StoreServer()
    manager = Manager(
        comm=TcpCommContext(timeout=5.0),
        load_state_dict=load_state_dict,
        state_dict=lambda: {"w": state["w"]},
        checkpoint_transport=transport,
        min_replica_size=1,
        use_async_quorum=True,
        timeout=8.0,
        quorum_timeout=8.0,
        connect_timeout=8.0,
        rank=0,
        world_size=1,
        store_addr=store.addr,
        lighthouse_addr=lighthouse_addr,
        replica_id=f"proc_{replica_id}_i{incarnation}_",
        heartbeat_interval=0.05,
    )
    q.put(("started", replica_id, incarnation, manager.current_step()))
    try:
        while not stop_evt.is_set():
            try:
                manager.start_quorum()
                grad = state["w"] - target
                fut = manager.allreduce_arrays([grad]).future()
                avg = fut.result(timeout=20)[0]
                committed = manager.should_commit()
            except Exception as e:  # noqa: BLE001 — a peer died mid-RPC;
                # retry as a real trainer does
                logger.info("replica %s step retry: %s", replica_id, e)
                time.sleep(0.05)
                continue
            if committed:
                state["w"] = state["w"] - _LR * avg
                q.put(("commit", replica_id, incarnation,
                       manager.current_step(), state["w"].tolist()))
                # the toy step is all RPC: throttle a solo survivor, as
                # the reference does
                time.sleep(0.005)
            else:
                time.sleep(0.01)
    finally:
        manager.shutdown(wait=False)
        store.shutdown()


def _port_template_main(replica_id, incarnation, lighthouse_addr, stop_evt,
                        q) -> None:
    _port_replica_main(replica_id, incarnation, lighthouse_addr, stop_evt, q,
                       template=True)


def _sigkill_relaunch_heal(workers, survivor_first: bool = False) -> None:
    """The reference test's phases and oracle: ``workers[rid]`` is replica
    ``rid``'s process target. Replica 0 is SIGKILLed once both trained
    together, replica 1 must keep committing, replica 0 relaunches and
    must rejoin; every step several lives committed holds the same
    weights (rtol 1e-6), at least 3 such steps and one after the heal, and
    the relaunch never replays a step. ``survivor_first``: replica 0
    starts once replica 1 has committed, so that replica 1 never heals."""
    ctx = mp.get_context("spawn")
    lighthouse = Lighthouse(min_replicas=1, join_timeout_ms=300,
                            heartbeat_timeout_ms=1000)
    stop = ctx.Event()
    # one queue per replica life: a SIGKILL during a put leaves a shared
    # queue's lock held by a dead process
    queues, procs, history = {}, {}, {}

    def launch(rid: int, incarnation: int) -> None:
        q = ctx.Queue()
        queues[(rid, incarnation)] = q
        p = ctx.Process(target=workers[rid],
                        args=(rid, incarnation, lighthouse.address(), stop,
                              q), daemon=True)
        p.start()
        procs[rid] = p

    def record(msg) -> None:
        if msg[0] == "commit":
            _, rid, inc, step, w = msg
            history.setdefault((rid, inc), {})[step] = np.array(
                w, dtype=np.float32)

    def max_step(rid, inc=None):
        return max((s for (r, i), h in history.items()
                    if r == rid and (inc is None or i == inc) for s in h),
                   default=0)

    def drain_once() -> bool:
        got = False
        for q in queues.values():
            try:
                while True:
                    record(q.get_nowait())
                    got = True
            except (queue_mod.Empty, OSError, EOFError):
                pass
        return got

    def drain_until(cond, timeout):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if cond():
                return True
            if not drain_once():
                time.sleep(0.05)
        return cond()

    def overlap(a, b):
        return set(history.get(a, {})) & set(history.get(b, {}))

    try:
        launch(1, 0)
        if survivor_first:
            assert drain_until(lambda: max_step(1, 0) >= 1, 90), \
                "replica 1 never committed alone"
        launch(0, 0)
        assert drain_until(lambda: len(overlap((0, 0), (1, 0))) >= 3, 90), \
            f"bring-up failed: {sorted(history)}"
        procs[0].kill()
        procs[0].join(timeout=10)
        assert procs[0].exitcode == -9
        kill_step = max_step(0, 0)
        assert drain_until(lambda: max_step(1, 0) >= kill_step + 3, 60), (
            f"survivor stalled after peer SIGKILL at step {kill_step}: "
            f"reached {max_step(1, 0)}")
        launch(0, 1)
        assert drain_until(lambda: len(overlap((0, 1), (1, 0))) >= 3, 120), (
            f"heal/rejoin failed: r0i1={sorted(history.get((0, 1), {}))} "
            f"r1 max={max_step(1, 0)}")
    finally:
        stop.set()
        for p in procs.values():
            p.join(timeout=15)
            if p.is_alive():
                p.kill()
                p.join(timeout=5)
        lighthouse.shutdown()
        drain_once()

    inc1_steps = sorted(history[(0, 1)])
    assert inc1_steps, "relaunched replica never committed"
    assert min(inc1_steps) > kill_step, (
        f"relaunched replica replayed old steps: {inc1_steps[:5]}")
    by_step = {}
    for key, h in history.items():
        for step, w in h.items():
            by_step.setdefault(step, []).append((key, w))
    overlapping = 0
    for step, entries in sorted(by_step.items()):
        if len(entries) > 1:
            overlapping += 1
            base_key, base = entries[0]
            for key, w in entries[1:]:
                np.testing.assert_allclose(
                    w, base, rtol=1e-6,
                    err_msg=f"divergence at step {step}: {key} vs {base_key}")
    assert overlapping >= 3, f"too few overlapping steps: {overlapping}"
    assert [s for s, entries in by_step.items()
            if len(entries) > 1 and s >= min(inc1_steps)], \
        "no overlapping steps after the heal"


def test_process_replica_sigkill_relaunch_heal() -> None:
    _sigkill_relaunch_heal({0: _port_replica_main, 1: _port_replica_main})


def test_mixed_cohort_port_relaunch_heals_from_the_reference() -> None:
    from test_integration_proc import _proc_replica_main

    # the reference's worker heals without a template: it starts first and
    # never heals, and the port's heals from it at its start and relaunch
    _sigkill_relaunch_heal({0: _port_template_main, 1: _proc_replica_main},
                           survivor_first=True)


def test_run_process_drill_at_tiny() -> None:
    from torchft_tpu_torch.examples.train_ddp import (
        PROC_AFTER,
        PROC_KILL,
        PROC_SOLO,
        run_process_drill,
    )

    result = run_process_drill(CONFIGS["tiny"], device="cpu", batch_size=2,
                               timeout=30.0, log=lambda m: None)
    # run_process_drill raises on a digest that differs, a relaunch that
    # does not heal, a two-participant commit in the dead window, a
    # non-finite loss or a launch count off its passes
    heal = PROC_KILL + PROC_SOLO + 1
    total = heal + PROC_AFTER
    assert result["heal_step"] == heal and result["total"] == total
    assert result["overlap"] == (list(range(1, PROC_KILL + 1))
                                 + list(range(heal, total + 1)))
    commits = result["commits"]
    assert sorted(commits[(0, 0)]) == list(range(1, PROC_KILL + 1))
    assert sorted(commits[(1, 0)]) == list(range(1, total + 1))
    assert sorted(commits[(0, 1)]) == list(range(heal, total + 1))
    assert [commits[(1, 0)][s]["participants"]
            for s in range(PROC_KILL + 1, heal)] == [1] * PROC_SOLO
    # the relaunch heals the survivor's state over HTTP, its bytes counted
    timeline = result["timeline"]
    assert timeline["heal"]["heal_wire_bytes"] > 0
    assert 0 < timeline["reap_s"] < timeline["first_joint_commit_s"]
    assert all(0 < t < timeline["first_joint_commit_s"]
               for t in timeline["solo_commit_s"])
    # no flash kernel on the CPU
    assert all(set(c.values()) <= {0} for c in result["launches"].values())
    assert result["memory"] == {}
