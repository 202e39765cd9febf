"""Subprocess-isolated comm context (the BabyNCCL shape).

Twin of ``torchft_tpu/comm/subproc.py``. A killable child process owns the
communicator, so a wedged or crashed wire is killed and rebuilt without
taking the trainer down: a peer that half-dies can leave a socket in a
state ``close()`` does not always unstick promptly, and SIGKILL of a child
is the one abort that never blocks.

``SubprocessCommContext`` hosts the port's ``TcpCommContext`` in a
spawn-context child; ``configure`` SIGKILLs any previous child (the abort
path) and configures a fresh one. The fresh child was spawned ahead, when
the previous configure (or the constructor) ran, so a configure never
waits for a process to start and import: the peers' rendezvous, bounded
by the wire's timeout, does not see the spawn. Ops run in issue order on
the child's transport; a pump thread in the parent matches results to
futures, so the ``Work``/``Future`` API holds.

Each op's command rides an mp queue and its arrays ride a shared-memory
slab the parent owns: the pump copies the arrays in, the child reduces
them in place there (allreduce, reduce_scatter) or writes its results to a
second slab (allgather, broadcast), and the pump copies them out, one copy
each way. (The reference pickles the arrays through the queue: a round
trip of the 181 MB of a 125m DiLoCo fragment took 5.1 s that way on an
H100 machine's host, 0.11 s through the slab.) The child maps the slabs
through ``/dev/shm`` by name and never registers them, so the parent
alone creates and unlinks them (its resource tracker cleans up should it
die).

Every configure is a fresh *epoch*: a child, its queues, its slabs, a
calls queue and a pump thread that closes over that epoch's objects only,
never reading them from ``self``. A stale pump stuck on a wedged child can
only fail its own dead epoch's calls; it never takes an op submitted after
a reconfigure. Once an epoch's op failed, the calls queued behind it fail
at once: a wedged child costs one timeout, not one per queued op.

The child imports the TCP transport and numpy and creates no CUDA context
(which would cost device memory and a second context on the card): arrays
cross as host numpy, and a CUDA tensor is refused, as the host wire
refuses it. ``wire_generation`` counts configures in the parent (each
child's transport is its first incarnation), so the error-feedback
residuals and DiLoCo's sharded reshard trigger on every reconfigure, as
they do over an in-process ``TcpCommContext``.
"""

from __future__ import annotations

import mmap
import multiprocessing as mp
import os
import queue as queue_mod
import threading
import time
from concurrent.futures import Future
from datetime import timedelta
from multiprocessing import shared_memory
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from torchft_tpu_torch.comm.context import CommContext, ReduceOp, Work

__all__ = ["SubprocessCommContext"]

_CMD_CONFIGURE = "configure"
_CMD_OP = "op"
_CMD_FILL = "fill"
_IN_PLACE = ("allreduce", "reduce_scatter")
_ALIGN = 64
_SLAB_ROUND = 1 << 20

# (dtype, shape, byte offset) of each array in a slab
Layout = List[Tuple[str, Tuple[int, ...], int]]


def _layout(arrays: Sequence[np.ndarray]) -> Tuple[Layout, int]:
    out: Layout = []
    off = 0
    for a in arrays:
        if a.dtype.hasobject:
            raise TypeError("object arrays cannot cross to the comm child")
        out.append((a.dtype.str, tuple(a.shape), off))
        off += -(-a.nbytes // _ALIGN) * _ALIGN
    return out, off


def _views(buf: Any, layout: Layout) -> List[np.ndarray]:
    return [np.ndarray(shape, np.dtype(dt), buffer=buf, offset=off)
            for dt, shape, off in layout]


class _ChildSlabs:
    """The child's mappings of the parent's slabs, one per role ("in",
    "out"), by name, through ``/dev/shm`` (no resource-tracker entry)."""

    def __init__(self) -> None:
        self._maps: Dict[str, Tuple[str, mmap.mmap]] = {}

    def get(self, role: str, name: str) -> mmap.mmap:
        held = self._maps.get(role)
        if held is not None and held[0] == name:
            return held[1]
        if held is not None:
            try:
                held[1].close()
            except BufferError:  # a view still lives: the GC closes it
                pass
        fd = os.open(f"/dev/shm/{name}", os.O_RDWR)
        try:
            mm = mmap.mmap(fd, os.fstat(fd).st_size)
        finally:
            os.close(fd)
        self._maps[role] = (name, mm)
        return mm


def _child_main(tx: "mp.Queue", rx: "mp.Queue", timeout: float,
                transport_kwargs: Optional[dict] = None) -> None:
    """The child: own a TcpCommContext and run commands in order."""
    from torchft_tpu_torch.comm.transport import TcpCommContext

    ctx = TcpCommContext(timeout=timeout, **(transport_kwargs or {}))
    slabs = _ChildSlabs()
    try:
        while True:
            cmd = tx.get()
            kind = cmd[0]
            if kind == _CMD_CONFIGURE:
                _, store_addr, rank, world_size, members = cmd
                try:
                    if members is not None:
                        ctx.set_wire_members(members)
                    ctx.configure(store_addr, rank, world_size)
                    rx.put(("ok", None))
                except Exception as e:  # noqa: BLE001 — sent to the parent
                    rx.put(("error", f"{type(e).__name__}: {e}"))
            elif kind == _CMD_OP:
                try:
                    rx.put(_run_op(ctx, slabs, cmd, tx, rx))
                except Exception as e:  # noqa: BLE001 — sent to the parent
                    rx.put(("error", f"{type(e).__name__}: {e}"))
            else:
                rx.put(("error", f"unknown command {kind}"))
    finally:
        ctx.shutdown()


def _run_op(ctx: Any, slabs: _ChildSlabs, cmd: tuple, tx: "mp.Queue",
            rx: "mp.Queue") -> tuple:
    """One op on the child's transport; returns its answer. ``arg`` is the
    opcode's own extra: allreduce's topology override, reduce_scatter's
    owners, broadcast's root. In-place ops leave their results in the input
    slab; the others write theirs to the output slab, first asking the
    parent for a larger one (a ``grow`` answer, a ``fill`` command back)
    when they do not fit."""
    _, opcode, op, arg, in_name, layout, out_name, out_size = cmd
    arrays = _views(slabs.get("in", in_name), layout)
    if opcode == "allreduce":
        work = ctx.allreduce(arrays, op, topology=arg)
    elif opcode == "reduce_scatter":
        work = ctx.reduce_scatter(arrays, op, owners=arg)
    elif opcode == "allgather":
        work = ctx.allgather(arrays)
    elif opcode == "broadcast":
        work = ctx.broadcast(arrays, arg)
    else:
        raise ValueError(f"unknown op {opcode}")
    result = work.future().result()
    if opcode in _IN_PLACE:
        for v, r in zip(arrays, result):
            if r is not v:
                np.copyto(v, np.asarray(r).reshape(v.shape))
        return ("ok", None)
    nested = result if opcode == "allgather" else [result]
    flat = [np.ascontiguousarray(a) for per in nested for a in per]
    out_layout, need = _layout(flat)
    if need > out_size:
        rx.put(("grow", need))
        fill = tx.get()
        if fill[0] != _CMD_FILL:
            raise RuntimeError(f"expected a fill command, got {fill[0]!r}")
        out_name = fill[1]
    for v, a in zip(_views(slabs.get("out", out_name), out_layout), flat):
        np.copyto(v, a)
    return ("ok", (out_layout, [len(per) for per in nested]))


class _PendingCall:
    __slots__ = ("opcode", "op", "arg", "arrays", "fut")

    def __init__(self, opcode: str, op: str, arg: Any,
                 arrays: List[np.ndarray], fut: Future) -> None:
        self.opcode = opcode
        self.op = op
        self.arg = arg
        self.arrays = arrays
        self.fut = fut


def _release(slab: Optional[shared_memory.SharedMemory]) -> None:
    if slab is None:
        return
    try:
        slab.close()
    except BufferError:  # a view still lives; the mapping goes with it
        pass
    try:
        slab.unlink()
    except FileNotFoundError:
        pass


class _Epoch:
    """One child process and everything scoped to it."""

    def __init__(self, mp_ctx: Any, timeout: float,
                 transport_kwargs: Optional[dict] = None) -> None:
        self.tx = mp_ctx.Queue()
        self.rx = mp_ctx.Queue()
        self.calls: "queue_mod.Queue[Optional[_PendingCall]]" = (
            queue_mod.Queue())
        self.timeout = timeout
        self.world_size = 1  # set by configure
        self.proc = mp_ctx.Process(
            target=_child_main,
            args=(self.tx, self.rx, timeout, transport_kwargs),
            daemon=True,
            name="torchft_tpu_torch_comm_child",
        )
        self.pump: Optional[threading.Thread] = None
        # the slabs: the pump thread's alone once it runs
        self.slab_in: Optional[shared_memory.SharedMemory] = None
        self.slab_out: Optional[shared_memory.SharedMemory] = None

    def reply(self, timeout: float) -> tuple:
        """The child's next answer; a child that died while it was awaited
        raises at once (ConnectionError), one that answers nothing within
        ``timeout`` raises TimeoutError."""
        deadline = time.monotonic() + timeout
        while True:
            try:
                return self.rx.get(
                    timeout=min(0.5, max(0.0, deadline - time.monotonic())))
            except queue_mod.Empty:
                if not self.proc.is_alive():
                    raise ConnectionError(
                        f"comm child process died (exit code "
                        f"{self.proc.exitcode})") from None
                if time.monotonic() >= deadline:
                    raise TimeoutError(
                        f"comm child answered nothing within {timeout:.1f} "
                        "s") from None

    @staticmethod
    def _fit(slab: Optional[shared_memory.SharedMemory],
             need: int) -> shared_memory.SharedMemory:
        if slab is not None and slab.size >= need:
            return slab
        _release(slab)
        size = max(_SLAB_ROUND, -(-need // _SLAB_ROUND) * _SLAB_ROUND)
        return shared_memory.SharedMemory(create=True, size=size)

    def _run(self, call: _PendingCall) -> Any:
        """One call through the child: arrays into the input slab, the
        command over the queue, results out of a slab."""
        layout, need = _layout(call.arrays)
        self.slab_in = self._fit(self.slab_in, need)
        views = _views(self.slab_in.buf, layout)
        for v, a in zip(views, call.arrays):
            np.copyto(v, a)
        out_name, out_size = "", 0
        if call.opcode not in _IN_PLACE:
            # an allgather's result is about world times its input
            self.slab_out = self._fit(self.slab_out, need * self.world_size)
            out_name, out_size = self.slab_out.name, self.slab_out.size
        self.tx.put((_CMD_OP, call.opcode, call.op, call.arg,
                     self.slab_in.name, layout, out_name, out_size))
        status, payload = self.reply(self.timeout + 10)
        if status == "grow":
            self.slab_out = self._fit(self.slab_out, int(payload))
            self.tx.put((_CMD_FILL, self.slab_out.name))
            status, payload = self.reply(self.timeout + 10)
        if status != "ok":
            raise ConnectionError(payload)
        if call.opcode in _IN_PLACE:
            for v, a in zip(views, call.arrays):
                np.copyto(a, v)
            return call.arrays
        out_layout, counts = payload
        flat = [v.copy() for v in _views(self.slab_out.buf, out_layout)]
        if call.opcode == "broadcast":
            return flat
        nested, pos = [], 0
        for n in counts:
            nested.append(flat[pos:pos + n])
            pos += n
        return nested

    def start_pump(self, on_error) -> None:
        def _loop() -> None:
            failed: Optional[Exception] = None
            try:
                while True:
                    call = self.calls.get()
                    if call is None:
                        return
                    try:
                        if failed is not None:
                            raise ConnectionError(
                                f"comm child epoch already failed: {failed}")
                        if not self.proc.is_alive():
                            raise ConnectionError(
                                "comm child process is dead")
                        call.fut.set_result(self._run(call))
                    except Exception as e:  # noqa: BLE001 — fails the call
                        if failed is None:
                            failed = e
                            on_error(e)
                        try:
                            call.fut.set_exception(e)
                        except Exception:  # noqa: BLE001 — resolved already
                            pass
            finally:
                _release(self.slab_in)
                _release(self.slab_out)

        self.pump = threading.Thread(
            target=_loop, name="torchft_tpu_torch_comm_pump", daemon=True)
        self.pump.start()

    def kill(self) -> None:
        """SIGKILL the child, fail the stranded calls, then stop the pump
        and wait for it: a pump still waiting on the dead child fails its
        call within half a second, takes the sentinel and releases the
        slabs; it holds no newer epoch."""
        if self.proc.pid is not None:
            self.proc.kill()
            self.proc.join(timeout=5.0)
        while True:
            try:
                call = self.calls.get_nowait()
            except queue_mod.Empty:
                break
            if call is not None:
                call.fut.set_exception(
                    ConnectionError("comm child killed during reconfigure"))
        self.calls.put(None)  # the pump's exit sentinel
        if (self.pump is not None
                and self.pump is not threading.current_thread()):
            self.pump.join(timeout=5.0)
        for q in (self.tx, self.rx):
            q.cancel_join_thread()
            q.close()


class SubprocessCommContext(CommContext):
    """CommContext facade over a killable child process."""

    backend_name = "host"  # the child owns a TcpCommContext: the same plane

    def __init__(self, timeout: "float | timedelta" = 60.0,
                 algorithm: str = "auto", channels: int = 4,
                 compression: str = "none",
                 chunk_bytes: int = 1 << 20,
                 stripe: bool = True,
                 topology: str = "flat") -> None:
        """``algorithm``, ``channels``, ``compression``, ``chunk_bytes``,
        ``stripe`` and ``topology`` go to the child's TcpCommContext
        (transport.py has their meaning; the child resolves hier domains
        from its own ``TORCHFT_TPU_DOMAINS`` or the wire members shipped
        with each configure)."""
        super().__init__()
        if isinstance(timeout, timedelta):
            timeout = timeout.total_seconds()
        self._timeout = float(timeout)
        self._wire_members: Optional[List[str]] = None
        self._transport_kwargs = {
            "algorithm": algorithm,
            "channels": channels,
            "compression": compression,
            "chunk_bytes": chunk_bytes,
            "stripe": stripe,
            "topology": topology,
        }
        self._mp = mp.get_context("spawn")
        self._epoch: Optional[_Epoch] = None
        self._lock = threading.Lock()
        self._error: Optional[Exception] = None
        self._generation = 0
        # the next configure's child, starting in the background
        self._spare: Optional[_Epoch] = self._spawn()

    def _spawn(self) -> _Epoch:
        epoch = _Epoch(self._mp, self._timeout, self._transport_kwargs)
        epoch.proc.start()
        return epoch

    @classmethod
    def unsupported_reason(cls, algorithm: str, compression: str,
                           op: str = ReduceOp.SUM,
                           topology: str = "flat") -> Optional[str]:
        # the child owns a TcpCommContext: its capability is the host
        # plane's (one definition, transport.py)
        from torchft_tpu_torch.comm.transport import host_unsupported_reason

        return host_unsupported_reason(algorithm, compression, op, topology)

    def set_wire_members(self, members: Sequence[str]) -> None:
        """The cohort's replica ids in transport rank order, shipped to the
        child with the next configure (the hier domain resolver's input)."""
        self._wire_members = [str(m) for m in members]

    # ------------------------------------------------------------ lifecycle

    def configure(self, store_addr: str, rank: int, world_size: int) -> None:
        if self._epoch is not None:
            # SIGKILL, not a graceful close: this is the abort path of a
            # wedged transport
            self._epoch.kill()
            self._epoch = None
        with self._lock:
            self._error = None
            self._generation += 1
        self._rank = rank
        self._world_size = world_size

        epoch, self._spare = self._spare, None
        if epoch is None or not epoch.proc.is_alive():
            if epoch is not None:
                epoch.kill()
            epoch = self._spawn()
        try:
            epoch.world_size = max(1, int(world_size))
            epoch.tx.put((_CMD_CONFIGURE, store_addr, rank, world_size,
                          self._wire_members))
            try:
                status, payload = epoch.reply(self._timeout + 10)
            except (ConnectionError, TimeoutError) as e:
                status, payload = "error", str(e)
            if status != "ok":
                epoch.kill()
                raise RuntimeError(f"comm child configure failed: {payload}")
            epoch.start_pump(self._latch_error)
            self._epoch = epoch
        finally:
            self._spare = self._spawn()

    def _latch_error(self, e: Exception) -> None:
        with self._lock:
            if self._error is None:
                self._error = e

    def shutdown(self) -> None:
        for epoch in (self._epoch, self._spare):
            if epoch is not None:
                epoch.kill()
        self._epoch = self._spare = None

    def errored(self) -> Optional[Exception]:
        with self._lock:
            return self._error

    def wire_generation(self) -> int:
        """Bumped by every configure (each a new child)."""
        with self._lock:
            return self._generation

    def child_pid(self) -> Optional[int]:
        """The pid of the live epoch's child, or None before configure."""
        return self._epoch.proc.pid if self._epoch is not None else None

    # ----------------------------------------------------------- collectives

    def _submit(self, opcode: str, arrays: Sequence[Any], op: str,
                arg: Any) -> Work:
        fut: Future = Future()
        fut.set_running_or_notify_cancel()
        err = self.errored()
        if err is not None:
            fut.set_exception(
                ConnectionError(f"comm context previously errored: {err}"))
            return Work(fut)
        epoch = self._epoch
        if epoch is None or epoch.pump is None:
            fut.set_exception(RuntimeError("comm context not configured"))
            return Work(fut)
        if any(getattr(a, "is_cuda", False) for a in arrays):
            fut.set_exception(TypeError(
                "SubprocessCommContext takes host arrays: a CUDA tensor "
                "cannot cross to the comm child (stage it through host "
                "memory, as ddp.py does, or use comm_backend='cuda')"))
            return Work(fut)
        # the donation contract: in-place ops resolve to these very arrays
        arrays = [self._prepare(a) for a in arrays]
        epoch.calls.put(_PendingCall(opcode, op, arg, arrays, fut))
        return Work(fut)

    def allreduce(self, arrays: Sequence[np.ndarray], op: str = ReduceOp.SUM,
                  topology: Optional[str] = None) -> Work:
        return self._submit("allreduce", arrays, op, topology)

    def reduce_scatter(self, arrays: Sequence[np.ndarray],
                       op: str = ReduceOp.SUM,
                       owners: "Optional[Sequence[int]]" = None) -> Work:
        """The child's reduce_scatter, in place: this rank's owned entries
        reduced, the others unspecified."""
        if owners is not None:
            owners = [int(o) for o in owners]
        return self._submit("reduce_scatter", arrays, op, owners)

    def allgather(self, arrays: Sequence[np.ndarray]) -> Work:
        return self._submit("allgather", arrays, ReduceOp.SUM, None)

    def broadcast(self, arrays: Sequence[np.ndarray], root: int = 0) -> Work:
        return self._submit("broadcast", arrays, ReduceOp.SUM, root)
