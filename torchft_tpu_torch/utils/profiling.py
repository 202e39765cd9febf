"""Profiler traces of a step window, and host spans on their timeline.

Twin of ``torchft_tpu/utils/profiling.py``, over ``torch.profiler``:

- ``StepProfiler``: trace steps [start, start + num_steps) of a loop,
  configured by env so any trainer can be profiled without code changes:
  ``TORCHFT_TPU_PROFILE_DIR=/tmp/trace TORCHFT_TPU_PROFILE_START=10
  TORCHFT_TPU_PROFILE_STEPS=5``. Without ``TORCHFT_TPU_PROFILE_DIR``,
  ``step()`` is two integer compares.
- ``trace(log_dir)``: a context manager for one block.

A trace records the host's ops and, on a machine with a card, the device's
kernels and copies (CUPTI), and is written to ``log_dir`` as a Chrome trace
(``trace_<pid>_<n>.json``, readable by Perfetto); ``stop_trace`` also
returns the ``torch.profiler.profile``, whose ``events()`` and
``key_averages()`` a caller can read. One trace at a time per process.

``host_span`` names a host-side region (a fragment's pack, its landing)
with ``torch.profiler.record_function``, so a trace shows it next to the
device work it overlaps; outside a trace it costs a few microseconds.
``timed_span`` also records the block's wall time into a ``Metrics`` sink,
and ``throughput_span`` adds a byte counter and a rate gauge, under the
reference's names.
"""

from __future__ import annotations

import itertools
import os
import threading
import time
from contextlib import contextmanager
from typing import Any, Optional

import torch

__all__ = [
    "StepProfiler", "host_span", "start_trace", "stop_trace",
    "throughput_span", "timed_span", "trace",
]

_ACTIVE: "Optional[tuple]" = None  # (profile, log_dir) of the open trace
_ACTIVE_LOCK = threading.Lock()
_SEQ = itertools.count()


def start_trace(log_dir: str) -> None:
    """Open this process's trace (host ops, and the card's kernels where
    there is one); raises RuntimeError if one is open."""
    global _ACTIVE
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with _ACTIVE_LOCK:
        if _ACTIVE is not None:
            raise RuntimeError("a profiler trace is already open")
        prof = torch.profiler.profile(activities=activities)
        prof.start()
        _ACTIVE = (prof, log_dir)


def stop_trace() -> Any:
    """Close the open trace, write it to its ``log_dir`` as a Chrome trace
    and return the ``torch.profiler.profile``."""
    global _ACTIVE
    with _ACTIVE_LOCK:
        if _ACTIVE is None:
            raise RuntimeError("no profiler trace is open")
        prof, log_dir = _ACTIVE
        _ACTIVE = None
    prof.stop()
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(
        os.path.join(log_dir, f"trace_{os.getpid()}_{next(_SEQ)}.json"))
    return prof


@contextmanager
def trace(log_dir: str):
    """Profile the enclosed block into ``log_dir``."""
    start_trace(log_dir)
    try:
        yield
    finally:
        stop_trace()


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


class StepProfiler:
    """Trace a window of training steps, configured by env or args.

    Call ``step()`` once per loop iteration. The trace starts when the step
    counter reaches ``start`` and stops after ``num_steps`` more; ``close()``
    stops a still-open trace if the loop ends early. ``profile`` is the
    closed window's ``torch.profiler.profile`` (None before).

    Also a context manager: ``with StepProfiler() as prof:`` closes the
    trace when the block exits, on success or exception."""

    def __init__(self, log_dir: Optional[str] = None,
                 start: Optional[int] = None,
                 num_steps: Optional[int] = None):
        self.log_dir = (
            log_dir
            if log_dir is not None
            else os.environ.get("TORCHFT_TPU_PROFILE_DIR")
        )
        self.start = (
            start
            if start is not None
            else int(os.environ.get("TORCHFT_TPU_PROFILE_START", "3"))
        )
        self.num_steps = (
            num_steps
            if num_steps is not None
            else int(os.environ.get("TORCHFT_TPU_PROFILE_STEPS", "5"))
        )
        self.profile = None
        self._step = 0
        self._active = False
        self._done = self.log_dir is None  # disabled: step() is a no-op

    @property
    def enabled(self) -> bool:
        return self.log_dir is not None

    def step(self) -> None:
        """Advance the step counter; open/close the trace at the window's
        edges."""
        if self._done:
            return
        if not self._active and self._step == self.start:
            start_trace(self.log_dir)
            self._active = True
        elif self._active and self._step >= self.start + self.num_steps:
            self._stop()
        self._step += 1

    def _stop(self) -> None:
        self.profile = stop_trace()
        self._active = False
        self._done = True

    def close(self) -> None:
        if self._active:
            self._stop()
        self._done = True

    def __enter__(self) -> "StepProfiler":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()

    def __del__(self):  # pragma: no cover — best-effort
        try:
            self.close()
        except Exception:
            pass
