"""The port's host spans (utils/profiling.py) against the JAX package's:
``timed_span`` and ``throughput_span`` write the Manager's ``Metrics``
under the reference's names, and ``host_span`` names a region on a
``torch.profiler`` trace.
"""

import time

import pytest
import torch

from torchft_tpu.utils import profiling as jax_profiling
from torchft_tpu.utils.metrics import Metrics as JaxMetrics
from torchft_tpu_torch.utils.metrics import Metrics
from torchft_tpu_torch.utils.profiling import (
    host_span,
    throughput_span,
    timed_span,
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


def test_host_span_shows_on_a_profiler_trace() -> None:
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with host_span("outer_pack_frag1"):
            torch.ones(8).sum()
    assert any(e.name == "outer_pack_frag1" for e in prof.events())
