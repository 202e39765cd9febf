"""The port's host spans (utils/profiling.py) against the JAX package's:
``timed_span`` and ``throughput_span`` write the Manager's ``Metrics``
under the reference's names (the byte counter cumulative, none for a
zero-byte span), and ``host_span`` names a region on a
``torch.profiler`` trace. ``StepProfiler`` and ``trace`` are twins of the
reference's tests (tests/test_profiling_prefetch.py, the context-manager
case of tests/test_telemetry.py): the env contract, a window of steps
written as a Chrome trace, an early exit that still closes it.
"""

import json
import os
import time

import pytest
import torch

from torchft_tpu.utils import profiling as jax_profiling
from torchft_tpu.utils.metrics import Metrics as JaxMetrics
from torchft_tpu_torch.utils.metrics import Metrics
from torchft_tpu_torch.utils import profiling
from torchft_tpu_torch.utils.profiling import (
    StepProfiler,
    host_span,
    throughput_span,
    timed_span,
    trace,
)


def _names(snapshot):
    return sorted(k for k in snapshot if k != "comm_backend")


def test_timed_span_writes_the_reference_names() -> None:
    port, ref = Metrics(), JaxMetrics()
    for metrics, span in ((port, timed_span), (ref, jax_profiling.timed_span)):
        with span(metrics, "outer_land", span="outer_land_frag0"):
            time.sleep(0.01)
        with span(metrics, "outer_d2h"):
            pass
    assert _names(port.snapshot()) == _names(ref.snapshot())
    assert port.snapshot()["outer_land_max_ms"] >= 10.0
    with timed_span(None, "no_sink"):  # a plain span without metrics
        pass


def test_timed_span_records_on_error() -> None:
    metrics = Metrics()
    with pytest.raises(ValueError):
        with timed_span(metrics, "outer_ef"):
            raise ValueError("inside")
    assert "outer_ef_p50_ms" in metrics.snapshot()


def test_throughput_span_counter_and_rate() -> None:
    port, ref = Metrics(), JaxMetrics()
    for metrics, span in ((port, throughput_span),
                          (ref, jax_profiling.throughput_span)):
        with span(metrics, "heal_wire", 1000):
            time.sleep(0.005)
        late = [0]
        with span(metrics, "heal_wire", late):
            late[0] = 500  # known only at the block's end
    got, want = port.snapshot(), ref.snapshot()
    assert _names(got) == _names(want)
    assert got["heal_wire_bytes"] == want["heal_wire_bytes"] == 1500
    assert got["heal_wire_bytes_per_s"] > 0


def test_throughput_span_cumulative_byte_counter() -> None:
    # the byte counter adds up over spans (the rate gauge is the last
    # span's), and a zero-byte span records its time and no byte keys
    got = []
    for metrics_cls, span in ((Metrics, throughput_span),
                              (JaxMetrics, jax_profiling.throughput_span)):
        m = metrics_cls()
        for n in (1000, 500):
            with span(m, "heal_wire", n):
                time.sleep(0.001)
        late = [0]
        with span(m, "heal_wire", late):
            late[0] = 250
        zero = metrics_cls()
        with span(zero, "x", 0):
            pass
        snap, zsnap = m.snapshot(), zero.snapshot()
        assert snap["heal_wire_bytes"] == 1750.0
        assert snap["heal_wire_bytes_per_s"] > 0
        assert snap["heal_wire_avg_ms"] > 0
        assert "x_bytes" not in zsnap and "x_avg_ms" in zsnap
        got.append((_names(snap), _names(zsnap)))
    assert got[0] == got[1]


def test_host_span_shows_on_a_profiler_trace() -> None:
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with host_span("outer_pack_frag1"):
            torch.ones(8).sum()
    assert any(e.name == "outer_pack_frag1" for e in prof.events())


# ------------------------------------------------------------ StepProfiler


def _trace_files(log_dir):
    return [os.path.join(root, f) for root, _, files in os.walk(log_dir)
            for f in files]


def test_step_profiler_disabled_is_noop(monkeypatch) -> None:
    monkeypatch.delenv("TORCHFT_TPU_PROFILE_DIR", raising=False)
    p = StepProfiler()
    assert not p.enabled
    for _ in range(10):
        p.step()
    p.close()
    assert p.profile is None


def test_step_profiler_env_contract(monkeypatch, tmp_path) -> None:
    monkeypatch.setenv("TORCHFT_TPU_PROFILE_DIR", str(tmp_path / "env"))
    monkeypatch.setenv("TORCHFT_TPU_PROFILE_START", "10")
    monkeypatch.setenv("TORCHFT_TPU_PROFILE_STEPS", "5")
    p = StepProfiler()
    assert p.enabled and (p.start, p.num_steps) == (10, 5)
    assert p.log_dir == str(tmp_path / "env")


def test_step_profiler_traces_window(tmp_path) -> None:
    log_dir = str(tmp_path / "trace")
    p = StepProfiler(log_dir=log_dir, start=2, num_steps=2)
    x = torch.ones((64, 64))
    for i in range(6):
        with host_span(f"step{i}"):
            x @ x
        p.step()
    p.close()
    found = _trace_files(log_dir)
    assert len(found) == 1, found
    with open(found[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    # the third step() opened the window and the fifth closed it: the work
    # between them (steps 3 and 4) is on the trace, the rest is not
    assert {"step3", "step4"} <= names
    assert not {"step0", "step1", "step2", "step5"} & names
    assert p.profile is not None
    assert any(e.name == "step3" for e in p.profile.events())


def test_trace_context_manager(tmp_path) -> None:
    log_dir = str(tmp_path / "blk")
    with trace(log_dir):
        torch.ones((8, 8)) @ torch.ones((8, 8))
    assert _trace_files(log_dir)


def test_step_profiler_early_loop_exit_closes_trace(tmp_path) -> None:
    log_dir = str(tmp_path / "early")
    p = StepProfiler(log_dir=log_dir, start=0, num_steps=100)
    p.step()  # opens the trace; the loop "ends" before the window does
    p.close()
    assert _trace_files(log_dir)
    with trace(str(tmp_path / "next")):  # no trace left open
        pass


def test_step_profiler_context_manager_closes_trace(monkeypatch) -> None:
    with StepProfiler(log_dir=None) as prof:  # disabled: a no-op
        assert not prof.enabled
        prof.step()
    assert prof._done

    class _FakeTrace:
        def __init__(self):
            self.started = []
            self.stopped = 0

        def start_trace(self, d):
            self.started.append(d)

        def stop_trace(self):
            self.stopped += 1
            return "profile"

    fake = _FakeTrace()
    monkeypatch.setattr(profiling, "start_trace", fake.start_trace)
    monkeypatch.setattr(profiling, "stop_trace", fake.stop_trace)
    with StepProfiler(log_dir="unused", start=0, num_steps=100) as prof:
        prof.step()  # opens the trace at step 0
        assert fake.started == ["unused"]
    # the block ended inside the window: __exit__ closed the trace
    assert fake.stopped == 1
    assert prof._done and not prof._active and prof.profile == "profile"
    prof.close()  # idempotent
    assert fake.stopped == 1


def test_one_trace_at_a_time(tmp_path) -> None:
    with trace(str(tmp_path / "a")):
        with pytest.raises(RuntimeError, match="already open"):
            profiling.start_trace(str(tmp_path / "b"))
    with pytest.raises(RuntimeError, match="no profiler trace"):
        profiling.stop_trace()
