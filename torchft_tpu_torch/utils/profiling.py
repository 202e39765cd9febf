"""Host spans on the profiler timeline, and in the Manager's metrics.

Twin of the span helpers of ``torchft_tpu/utils/profiling.py``:
``host_span`` names a host-side region (a fragment's pack, its landing)
with ``torch.profiler.record_function``, so a ``torch.profiler`` trace
shows it next to the device work it overlaps; outside a trace it costs a
few microseconds. ``timed_span`` also records the block's wall time into a
``Metrics`` sink, and ``throughput_span`` adds a byte counter and a rate
gauge, under the reference's names.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Optional

import torch

__all__ = ["host_span", "timed_span", "throughput_span"]


@contextmanager
def host_span(name: str):
    """Annotate the enclosed host region as ``name`` on the profiler's
    timeline."""
    with torch.profiler.record_function(name):
        yield


@contextmanager
def timed_span(metrics, name: str, span: Optional[str] = None):
    """``host_span`` (under ``span``, or ``name`` when omitted) plus
    ``metrics.observe(name, seconds)`` of the block's wall time, so the
    trace view and the metrics view of a stage stay in lockstep.
    ``metrics=None`` leaves the plain span."""
    start = time.perf_counter()
    try:
        with host_span(span or name):
            yield
    finally:
        if metrics is not None:
            metrics.observe(name, time.perf_counter() - start)


@contextmanager
def throughput_span(metrics, name: str, nbytes: "int | list"):
    """``timed_span`` plus a cumulative ``{name}_bytes`` counter and a
    last-write-wins ``{name}_bytes_per_s`` gauge. ``nbytes`` may be a
    one-element list filled in inside the block, for a byte count known
    only at its end."""
    start = time.perf_counter()
    try:
        with host_span(name):
            yield
    finally:
        elapsed = time.perf_counter() - start
        if metrics is not None:
            metrics.observe(name, elapsed)
            n = nbytes[0] if isinstance(nbytes, list) else nbytes
            if n:
                metrics.incr(f"{name}_bytes", n)
                if elapsed > 0:
                    metrics.gauge(f"{name}_bytes_per_s", n / elapsed)
