"""Async durable checkpointing: stage on call, persist in the background.

Twin of ``torchft_tpu/checkpoint_io.py``. The live heal plane
(checkpointing.py) moves state replica to replica over HTTP; this module
writes durable snapshots to disk, which training resumes from after a
restart of every group.

``save()`` has two phases:

1. STAGE (synchronous, on the caller): a device-to-host copy of every
   tensor of the state. It cannot be deferred: the next step updates the
   parameters and optimizer state in place (and a CUDA graph replays into
   the very same memory), so the caller's tensors change right after
   ``save`` returns. The copy is the only part training waits for.
2. PERSIST (asynchronous, one worker thread): ``torch.save`` of the host
   copy to ``path + ".tmp"``, fsync, then ``os.replace`` into place, so a
   reader never sees a torn file, and old checkpoints beyond ``keep`` are
   pruned.

At most one write is in flight: ``save`` waits for the previous persist
before it stages, so a disk slower than the save cadence throttles the
saver instead of queueing host copies of the model. A background write
error latches and re-raises on the next ``save`` or ``wait``.

``DcpCheckpointer`` is the counterpart of the reference's
``OrbaxCheckpointer``: the same call shape over
``torch.distributed.checkpoint`` (one directory per step, the format
PyTorch's distributed tools read), in a single process.
"""

from __future__ import annotations

import os
import shutil
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from concurrent.futures import TimeoutError as FuturesTimeoutError
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

__all__ = [
    "AsyncCheckpointWriter",
    "DcpCheckpointer",
    "latest_checkpoint",
    "load_checkpoint",
]


def _stage_to_host(state: Any) -> Any:
    """A host snapshot of ``state`` (nested dicts, lists and tuples): every
    torch tensor copied to the CPU, every numpy array copied, every other
    value kept as is. A copy even where the tensor already lies on the
    CPU, so the caller may mutate its state right after."""
    if isinstance(state, torch.Tensor):
        return state.detach().to("cpu", copy=True)
    if isinstance(state, np.ndarray):
        return state.copy()
    if isinstance(state, dict):
        return type(state)((k, _stage_to_host(v)) for k, v in state.items())
    if isinstance(state, (list, tuple)):
        return type(state)(_stage_to_host(v) for v in state)
    return state


def load_checkpoint(path: str) -> Any:
    """Read a checkpoint written by :class:`AsyncCheckpointWriter` onto
    the CPU. A pickle over a trusted filesystem: the same trust model as
    the reference's resume and the heal plane."""
    return torch.load(path, map_location="cpu", weights_only=False)


def _step_checkpoints(base_path: str) -> List[Tuple[int, str]]:
    """(step, path) for every ``{base_path}.{int}`` on disk, ascending."""
    d, base = os.path.split(base_path)
    try:
        names = os.listdir(d or ".")
    except FileNotFoundError:
        return []
    found = []
    for name in names:
        # the whole suffix after "base." must be digits: "base.ema.50" or
        # "base.12.tmp" belong to another family and are never resumed
        # from or pruned by this writer
        suffix = name[len(base) + 1:]
        if name.startswith(base + ".") and suffix.isdigit():
            found.append((int(suffix), os.path.join(d, name)))
    return sorted(found)


def latest_checkpoint(base_path: str) -> Optional[str]:
    """Newest ``{base_path}.{step}`` file, else a bare ``base_path``
    written by an unsuffixed saver, else None."""
    steps = _step_checkpoints(base_path)
    if steps:
        return steps[-1][1]
    if os.path.exists(base_path):
        return base_path
    return None


class AsyncCheckpointWriter:
    """Serialize durable checkpoint writes onto one background thread.

    ``keep``: how many of the newest checkpoint files to retain (older
    files of this writer are deleted after each successful write); 0 keeps
    everything. ``saves`` logs each finished write: its ``path``, stage
    and persist seconds (``stage_s``, ``persist_s``) and ``bytes``."""

    def __init__(self, keep: int = 3) -> None:
        self._executor = ThreadPoolExecutor(max_workers=1,
                                            thread_name_prefix="ckpt-writer")
        self._keep = keep
        self._written: List[str] = []  # newest last
        self._seeded_bases: set = set()
        self._lock = threading.Lock()
        self._error: Optional[BaseException] = None
        self._last: Optional[Future] = None
        self.saves: List[Dict[str, Any]] = []

    def save(self, path: str, state: Any) -> Future:
        """Stage ``state`` to host now; persist it to ``path`` in the
        background. Returns the write's Future (resolves to ``path``).
        Waits for the previous write first and raises its latched error."""
        import time

        if self._last is not None and not self._last.done():
            try:
                self._last.result()
            except BaseException:  # noqa: BLE001 — raised just below
                pass
        self.raise_if_failed()
        t0 = time.perf_counter()
        host = _stage_to_host(state)
        stage_s = time.perf_counter() - t0
        fut = self._executor.submit(self._persist, path, host, stage_s)
        self._last = fut
        return fut

    def save_step(self, base_path: str, step: int, state: Any) -> Future:
        """``save`` to ``{base_path}.{step}``. Retention spans restarts: the
        first save for a base counts the files earlier incarnations left
        on disk toward ``keep``. Resume with ``latest_checkpoint``."""
        with self._lock:
            if base_path not in self._seeded_bases:
                self._seeded_bases.add(base_path)
                prior = [p for _, p in _step_checkpoints(base_path)
                         if p not in self._written]
                self._written = prior + self._written  # oldest first
        return self.save(f"{base_path}.{step}", state)

    def wait(self, timeout: Optional[float] = None) -> None:
        """Block until the newest save has persisted; re-raise (and clear)
        a latched write error."""
        if self._last is not None:
            try:
                self._last.result(timeout)
            except FuturesTimeoutError:
                raise
            except BaseException:  # noqa: BLE001 — raised just below
                pass
        self.raise_if_failed()

    def raise_if_failed(self) -> None:
        with self._lock:
            err, self._error = self._error, None
        if err is not None:
            raise RuntimeError("background checkpoint write failed") from err

    def close(self) -> None:
        """Drain pending writes and stop the worker; raises if the final
        write failed."""
        self._executor.shutdown(wait=True)
        self.raise_if_failed()

    def __enter__(self) -> "AsyncCheckpointWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _persist(self, path: str, host: Any, stage_s: float) -> str:
        import time

        try:
            t0 = time.perf_counter()
            d = os.path.dirname(path)
            if d:
                os.makedirs(d, exist_ok=True)
            tmp = path + ".tmp"
            size = self._write(tmp, host)
            self._replace(tmp, path)  # atomic: readers never see torn files
            self._prune(path)
            self.saves.append({"path": path, "stage_s": stage_s,
                               "persist_s": time.perf_counter() - t0,
                               "bytes": size})
            return path
        except BaseException as e:  # latched for the training thread
            with self._lock:
                self._error = e
            raise

    def _write(self, tmp: str, host: Any) -> int:
        with open(tmp, "wb") as f:
            torch.save(host, f)
            f.flush()
            os.fsync(f.fileno())
            return f.tell()

    def _replace(self, tmp: str, path: str) -> None:
        os.replace(tmp, path)

    def _remove(self, old: str) -> None:
        os.remove(old)

    def _prune(self, newest: str) -> None:
        with self._lock:
            if newest in self._written:
                self._written.remove(newest)  # a re-save to the same path
            self._written.append(newest)
            if self._keep <= 0:
                return
            excess = self._written[: -self._keep]
            self._written = self._written[-self._keep:]
        for old in excess:
            try:
                self._remove(old)
            except OSError:
                pass  # already gone


class _DcpWriter(AsyncCheckpointWriter):
    """The writer's stage, single in-flight persist, error latch and
    retention, over ``torch.distributed.checkpoint`` directories."""

    def _write(self, tmp: str, host: Any) -> int:
        import torch.distributed.checkpoint as dcp

        shutil.rmtree(tmp, ignore_errors=True)
        # the storage writer fsyncs every file it writes
        dcp.save(host, checkpoint_id=tmp, no_dist=True)
        return sum(os.path.getsize(os.path.join(tmp, n))
                   for n in os.listdir(tmp))

    def _replace(self, tmp: str, path: str) -> None:
        shutil.rmtree(path, ignore_errors=True)  # a re-save of a step
        os.replace(tmp, path)

    def _remove(self, old: str) -> None:
        shutil.rmtree(old)


class DcpCheckpointer:
    """Durable checkpoints in ``torch.distributed.checkpoint``'s format.

    The same role and call shape as the reference's ``OrbaxCheckpointer``:
    ``save_step`` stages on call and persists on one background thread
    (``<directory>/step_<N>``, written as ``step_<N>.tmp`` and renamed into
    place), ``keep`` newest steps retained, ``latest_step``, ``restore``,
    ``wait`` and ``close``. Runs in one process without a process group.

    ``restore(step, template)`` loads into ``template`` in place (tensors
    keep their storage and device) and returns it. Without a template it
    returns the saved structure on the CPU, where the checkpoint format
    turns integer dict keys into strings (an optimizer's ``state``): pass
    a template to restore an optimizer state dict."""

    def __init__(self, directory: str, keep: int = 3) -> None:
        self._dir = os.path.abspath(directory)
        os.makedirs(self._dir, exist_ok=True)
        self._writer = _DcpWriter(keep=keep)
        # retention spans restarts: steps already on disk count toward keep
        self._writer._written = [p for _, p in self._step_dirs()]

    def _step_dirs(self) -> List[Tuple[int, str]]:
        found = []
        for name in os.listdir(self._dir):
            suffix = name[len("step_"):]
            if name.startswith("step_") and suffix.isdigit():
                found.append((int(suffix), os.path.join(self._dir, name)))
        return sorted(found)

    def save_step(self, step: int, state: Any) -> Future:
        """Stage ``state`` to host now; persist step ``step`` in the
        background. Returns the write's Future."""
        return self._writer.save(os.path.join(self._dir, f"step_{step}"),
                                 state)

    def latest_step(self) -> Optional[int]:
        steps = self._step_dirs()
        return steps[-1][0] if steps else None

    def all_steps(self) -> List[int]:
        return [s for s, _ in self._step_dirs()]

    def restore(self, step: Optional[int] = None,
                template: Any = None) -> Any:
        """Restore ``step`` (default: the newest) into ``template``, or as
        a new CPU structure without one."""
        import torch.distributed.checkpoint as dcp

        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self._dir}")
        path = os.path.join(self._dir, f"step_{step}")
        if template is not None:
            dcp.load(template, checkpoint_id=path, no_dist=True)
            return template
        import tempfile

        from torch.distributed.checkpoint.format_utils import (
            dcp_to_torch_save,
        )
        with tempfile.TemporaryDirectory(dir=self._dir) as tmp:
            flat = os.path.join(tmp, "restore.pt")
            dcp_to_torch_save(path, flat)
            return load_checkpoint(flat)

    def wait(self) -> None:
        self._writer.wait()

    def close(self) -> None:
        self._writer.close()

    def __enter__(self) -> "DcpCheckpointer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
