"""The port's flight recorder end to end: the whole kill -> heal lifecycle
rebuilt from the ``/telemetry/events`` endpoints alone.

The twin of tests/test_telemetry_integration.py. Two port replica groups
run over the native lighthouse with the TCP gradient wire and the HTTP heal
plane; replica 0 is killed at step 2 and restarts. The assertions read only
each manager's telemetry endpoints, found the way scripts/fleet_top.py finds
them (the group store's ``checkpoint_addr_{rank}`` key), and rebuild, in
order:

    quorum epoch N (both on the wire) -> member_dead -> quorum epoch > N
    -> heal_start/heal_done on the rejoiner -> step_commit resumes

The order is set by the schedule, not by sleeps: both groups start their
first quorum together, and the restarted group waits until the survivor has
committed a step over a quorum it requested after the kill without the dead
group on its wire. So the survivor's member_dead always comes before the
rejoin, and the checks allow extra events but never missing ones.
"""

import json
import logging
import threading
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

import numpy as np
import pytest

from torchft_tpu_torch.comm.store import StoreClient, StoreServer
from torchft_tpu_torch.comm.transport import TcpCommContext
from torchft_tpu_torch.control import Lighthouse
from torchft_tpu_torch.manager import Manager
from torchft_tpu_torch.utils.events import (
    to_chrome_trace,
    validate_chrome_trace,
)

logger = logging.getLogger(__name__)

TOTAL_STEPS = 8
KILL_STEP = 2
# every wait of the schedule is bounded: a fault fails the test, never
# hangs it
GATE_TIMEOUT = 60.0


class InjectedFailure(Exception):
    pass


def _fetch(url: str, timeout: float = 10.0) -> dict:
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return json.load(resp)


class _Harness:
    def __init__(self, num_replicas: int, total_steps: int) -> None:
        self.num_replicas = num_replicas
        self.total_steps = total_steps
        self.stop = threading.Event()
        self.started = threading.Barrier(num_replicas)
        # set by the victim as it dies; set by the survivor once it has
        # committed over a post-kill quorum whose wire is itself alone
        self.killed = threading.Event()
        self.survivor_solo = threading.Event()
        self.progress: Dict[int, int] = {}
        self._lock = threading.Lock()

    def report(self, replica_id: int, step: int) -> None:
        with self._lock:
            self.progress[replica_id] = max(
                self.progress.get(replica_id, 0), step)
            if len(self.progress) == self.num_replicas and all(
                    s >= self.total_steps for s in self.progress.values()):
                self.stop.set()


class _Replica:
    """One replica group; restarts after the injected kill. Each life's
    telemetry (events and metrics) is captured over HTTP in the finally
    block, before the manager goes down with the life."""

    def __init__(self, replica_id: int, lighthouse_addr: str,
                 harness: _Harness,
                 fail_at_step: Optional[int] = None) -> None:
        self.replica_id = replica_id
        self.lighthouse_addr = lighthouse_addr
        self.harness = harness
        self.fail_at_step = fail_at_step
        self.failures = 0
        self.gate_timed_out = False
        # one entry per life: {"events": ..., "metrics": ...}
        self.telemetry: List[dict] = []

    def run(self) -> None:
        while not self.harness.stop.is_set():
            try:
                self._main()
                return
            except InjectedFailure:
                logger.warning("replica %s restarting after injected kill",
                               self.replica_id)
                if not self.harness.survivor_solo.wait(GATE_TIMEOUT):
                    self.gate_timed_out = True
                    return

    def _main(self) -> None:
        store = StoreServer()
        state = {"w": np.zeros((2, 3), dtype=np.float32)}

        def load_state_dict(sd):
            state["w"] = np.array(sd["w"], dtype=np.float32)

        manager = Manager(
            comm=TcpCommContext(timeout=5.0),
            load_state_dict=load_state_dict,
            state_dict=lambda: {"w": state["w"]},
            min_replica_size=1,
            use_async_quorum=True,
            timeout=5.0, quorum_timeout=5.0, connect_timeout=5.0,
            rank=0, world_size=1,
            store_addr=store.addr,
            lighthouse_addr=self.lighthouse_addr,
            replica_id=f"telemetry_rep_{self.replica_id}_",
            heartbeat_interval=0.05,
        )
        # endpoint discovery as fleet_top does it: the group store names
        # each rank's checkpoint and telemetry server
        telemetry_url = (StoreClient(store.addr, connect_timeout=5.0)
                         .get("checkpoint_addr_0").decode())
        first_life = self.failures == 0
        try:
            if first_life:
                self.harness.started.wait(GATE_TIMEOUT)
            while not self.harness.stop.is_set():
                if (self.fail_at_step is not None and self.failures == 0
                        and manager.current_step() >= self.fail_at_step):
                    self.failures += 1
                    self.harness.killed.set()
                    raise InjectedFailure(
                        f"injected kill of replica {self.replica_id}")
                after_kill = self.harness.killed.is_set()
                try:
                    manager.start_quorum()
                except (TimeoutError, RuntimeError) as e:
                    logger.info("quorum retry: %s", e)
                    continue
                grad = state["w"] - 10.0
                fut = manager.allreduce_arrays([grad]).future()
                avg_grad = fut.result(timeout=20)[0]
                if manager.should_commit():
                    state["w"] = state["w"] - 0.5 * avg_grad
                    self.harness.report(self.replica_id,
                                        manager.current_step())
                    if (self.fail_at_step is None and after_kill
                            and manager.transport_world_size() == 1):
                        self.harness.survivor_solo.set()
        finally:
            # capture this life's flight recording over HTTP while its
            # server is up: the endpoints are the assertions' only source
            try:
                events = _fetch(telemetry_url + "/telemetry/events?since=0")
                metrics = _fetch(telemetry_url + "/telemetry/metrics")
                # the cursor contract on a live manager
                tail = _fetch(telemetry_url
                              + f"/telemetry/events?since={events['next']}")
                assert tail["events"] == [], "cursor returned stale events"
                self.telemetry.append({"events": events, "metrics": metrics})
            except Exception as e:  # noqa: BLE001 — a capture failure
                # must fail the test, not hang it
                self.telemetry.append({"capture_error": repr(e)})
            manager.shutdown(wait=False)
            store.shutdown()


def _events_of(dump: dict) -> List[dict]:
    assert "capture_error" not in dump, dump
    return sorted(dump["events"]["events"], key=lambda e: e["seq"])


def test_kill_heal_lifecycle_reconstructed_from_endpoints() -> None:
    lighthouse = Lighthouse(min_replicas=1, join_timeout_ms=200,
                            heartbeat_timeout_ms=1000)
    harness = _Harness(num_replicas=2, total_steps=TOTAL_STEPS)
    replicas = [
        _Replica(0, lighthouse.address(), harness, fail_at_step=KILL_STEP),
        _Replica(1, lighthouse.address(), harness),
    ]
    try:
        with ThreadPoolExecutor(max_workers=2) as pool:
            futs = [pool.submit(r.run) for r in replicas]
            try:
                for f in futs:
                    f.result(timeout=120.0)
            finally:
                # a failed or stuck group must not leave the other looping
                # while the pool waits for it
                harness.stop.set()
    finally:
        lighthouse.shutdown()

    assert not replicas[0].gate_timed_out, \
        "the survivor never committed alone after the kill"
    assert replicas[0].failures == 1
    # survivor: one life; killed replica: two
    assert len(replicas[1].telemetry) == 1
    assert len(replicas[0].telemetry) == 2

    surv = _events_of(replicas[1].telemetry[0])
    dead_id = replicas[0].telemetry[0]["events"].get("replica_id", "")
    assert dead_id.startswith("telemetry_rep_0_")

    # --- the survivor: epoch N with both on the wire, then member_dead for
    # the killed replica, then a later epoch ----------------------------------
    two_wire = [e for e in surv
                if e["kind"] == "quorum_complete" and e["wire_world"] == 2]
    assert two_wire, "survivor never saw a 2-member wire"
    md = [e for e in surv if e["kind"] == "member_dead"]
    assert md, "no member_dead event on the survivor"
    death = md[0]
    assert death["member"] == dead_id
    epoch_n = [e for e in two_wire if e["seq"] < death["seq"]]
    assert epoch_n, "member_dead not preceded by a 2-member quorum"
    assert death["epoch"] > epoch_n[-1]["epoch"]
    shrunk = [e for e in surv
              if e["kind"] == "quorum_complete" and e["seq"] > death["seq"]]
    assert shrunk and shrunk[0]["epoch"] >= death["epoch"]
    # the survivor kept committing after the death
    assert any(e["kind"] == "step_commit" and e["seq"] > death["seq"]
               for e in surv)
    # ...and saw the rejoiner back on a 2-member wire
    assert any(e["wire_world"] == 2 for e in shrunk), \
        "rejoined replica never re-entered the survivor's wire"

    # --- the rejoiner: heal_start -> heal_done -> commits resume -------------
    healer = _events_of(replicas[0].telemetry[1])
    hs = [e for e in healer if e["kind"] == "heal_start"]
    hd = [e for e in healer if e["kind"] == "heal_done"]
    assert hs and hd, "rejoiner recorded no heal lifecycle"
    assert hs[0]["seq"] < hd[0]["seq"]
    assert hs[0]["epoch"] >= death["epoch"]
    resumed = [e for e in healer
               if e["kind"] == "step_commit" and e["seq"] > hd[0]["seq"]]
    assert resumed, "no step_commit after heal_done on the rejoiner"
    # the heal fast-forwarded the rejoiner past its kill point
    assert max(e["step"] for e in resumed) > KILL_STEP
    # events carry the identity stamps a merger needs
    for e in healer:
        assert e["replica_id"].startswith("telemetry_rep_0_")
        assert e["replica_id"] != dead_id
        assert e["rank"] == 0

    # --- allreduce p50 is served and sane with the recorder on ---------------
    m = replicas[1].telemetry[0]["metrics"]["metrics"]
    assert m.get("steps_committed", 0) >= TOTAL_STEPS
    p50 = m.get("allreduce_p50_ms")
    assert p50 is not None and 0 <= p50 < 5000

    # --- the merged dumps convert to one valid Chrome trace ------------------
    dumps = [replicas[1].telemetry[0]["events"],
             replicas[0].telemetry[0]["events"],
             replicas[0].telemetry[1]["events"]]
    trace = json.loads(json.dumps(to_chrome_trace(dumps)))
    assert validate_chrome_trace(trace) == []
    names = {e["name"] for e in trace["traceEvents"]}
    assert {"quorum", "heal", "step_commit", "member_dead"} <= names
    # a track each: the restarted life keeps its replica_id prefix but gets
    # a fresh uuid suffix
    pids = {e["pid"] for e in trace["traceEvents"] if e["ph"] != "M"}
    assert len(pids) == 3


# --- the process drill's lifecycle check, on fabricated recordings ----------
# train_ddp.check_lifecycle is what run_process_drill (and chip_smoke.py's
# train_proc on the card) holds its two captured recordings to: the checks
# above. Each case drops or changes one fact of a recording that passes,
# and the check must name it.

_DEAD, _RELAUNCH = "train_ddp_0_first", "train_ddp_0_second"


def _fabricated():
    from torchft_tpu_torch.utils.events import EventRecorder

    surv = EventRecorder(replica_id="train_ddp_1_survivor", rank=0)
    for step, epoch, wire in ((0, 1, 2), (1, 1, 2), (2, 1, 2), (3, 1, 2)):
        surv.emit("quorum_start", step=step, epoch=epoch)
        surv.emit("quorum_complete", step=step, epoch=epoch,
                  wire_world=wire)
        if step < 3:
            surv.emit("step_commit", step=step, epoch=epoch)
    surv.emit("error_latched", step=3, epoch=1)
    surv.emit("step_discard", step=3, epoch=1)
    surv.emit("member_dead", step=3, epoch=2, member=_DEAD)
    for step, epoch, wire in ((3, 2, 1), (4, 2, 1), (5, 3, 2), (6, 3, 2)):
        surv.emit("quorum_complete", step=step, epoch=epoch,
                  wire_world=wire)
        surv.emit("step_commit", step=step, epoch=epoch)
    heal = EventRecorder(replica_id=_RELAUNCH, rank=0)
    heal.emit("quorum_complete", step=0, epoch=3, wire_world=2, heal=True)
    heal.emit("heal_start", step=0, epoch=3)
    heal.emit("heal_done", step=5, epoch=3)
    for step in (5, 6):
        heal.emit("step_commit", step=step, epoch=3)
    return ({"events": surv.dump(), "metrics": {"metrics": {
        "steps_committed": 7.0, "allreduce_p50_ms": 1.5}}},
            {"events": heal.dump(), "metrics": {"metrics": {}}})


def _drop(dump, kind):
    dump["events"]["events"] = [e for e in dump["events"]["events"]
                                if e["kind"] != kind]


def _set(dump, kind, **fields):
    for e in dump["events"]["events"]:
        if e["kind"] == kind:
            e.update(fields)


@pytest.mark.parametrize("life,mutate,match", [
    (0, lambda d: _drop(d, "member_dead"), "no member_dead naming"),
    (0, lambda d: _set(d, "member_dead", member="someone_else"),
     "no member_dead naming"),
    (0, lambda d: _set(d, "member_dead", epoch=1), "not above a two-wire"),
    (0, lambda d: _set(d, "quorum_complete", wire_world=1),
     "not above a two-wire"),
    (0, lambda d: d["events"].update(events=[
        e for e in d["events"]["events"]
        if not (e["kind"] == "step_commit" and e["step"] >= 3)]),
     "no commit after the death"),
    (1, lambda d: _drop(d, "heal_done"), "no heal_start before heal_done"),
    (1, lambda d: _set(d, "heal_start", epoch=1), "below the death's"),
    (1, lambda d: _set(d, "step_commit", step=1),
     "no commit beyond step 3"),
    (1, lambda d: _set(d, "step_commit", replica_id=_DEAD), "carry"),
    (0, lambda d: d["metrics"]["metrics"].update(steps_committed=6.0),
     "steps_committed"),
    (0, lambda d: d["metrics"]["metrics"].update(
        allreduce_p50_ms=float("nan")), "allreduce_p50_ms"),
    (1, lambda d: d.update(capture_error="URLError()"),
     "no flight recording"),
], ids=["no_death", "wrong_member", "death_not_later", "no_two_wire",
        "no_commit_after", "no_heal_done", "heal_before_death",
        "no_resumed_commit", "foreign_stamp", "few_commits", "nan_p50",
        "capture_error"])
def test_drill_lifecycle_check_names_what_is_missing(life, mutate,
                                                     match) -> None:
    from torchft_tpu_torch.examples.train_ddp import check_lifecycle

    kw = dict(dead_id=_DEAD, relaunch_id=_RELAUNCH, kill_step=3, total=7)
    dumps = _fabricated()
    lc = check_lifecycle(*dumps, **kw)
    assert (lc["last_two_wire_epoch"], lc["death_epoch"],
            lc["rejoin_epoch"], lc["heal_epoch"]) == (1, 2, 3, 3)
    assert lc["death_step"] == 3 and lc["first_resumed_commit"] == 5
    assert lc["trace_valid"] and lc["event_counts"]["survivor"][
        "member_dead"] == 1
    dumps = _fabricated()
    mutate(dumps[life])
    with pytest.raises(AssertionError, match=match):
        check_lifecycle(*dumps, **kw)
