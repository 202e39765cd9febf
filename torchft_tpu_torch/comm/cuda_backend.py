"""On-device gradient plane: the collectives as torch code over one stacked
device tensor, with the int8 block codec as hand-written CUDA kernels.

Twin of ``torchft_tpu/comm/xla_backend.py``. The TCP
transport (transport.py) moves gradient bytes over sockets; this plane
implements the same ``CommContext`` surface (allreduce with the donation
contract, reduce_scatter, allgather, broadcast, the ``wire_*``
introspection error feedback keys off) but reduces on the card.

One card, several replica groups
--------------------------------
Replica groups that share a process (threads, as in the kill/heal drill)
share one device. ``_DeviceGroup`` is the in-process rendezvous that stands
in for a collective launch, as the reference's ``_XlaGroup`` does: contexts
configured against the same store address join one group; each rank's
submit deposits its donated numpy arrays, and when the whole cohort has
submitted a sequence number the group's 1-thread executor uploads every
rank's arrays into ONE stacked ``(world, size)`` device tensor per array
(row r = rank r), runs the reduction on the card, copies the result back
through pinned host staging, synchronises, writes it into every rank's
donated arrays and only then resolves the futures. ``all_to_all`` becomes a
re-indexing of the stacked buffer (owner d reads columns ``[d·L, (d+1)·L)``
of every row) and ``all_gather`` a read of all rows. A rank missing from a
sequence number fails the op with ``ConnectionError`` after the timeout; a
member that reconfigures or shuts down fails its peers' in-flight ops at
once, and the Manager latches either like a dead socket. Several processes
(NCCL over ``torch.distributed``) are not ported: NCCL refuses two ranks on
one device, and the port's drill runs its groups on one card.

Algorithms
----------
``star``/``ring`` reproduce the host transport's accumulation order and
codec bits exactly, so the socket transport stays the bitwise oracle:

* ``star``: acc = v_0 + Σ_{r>0} dec(enc(v_r)) in rank order per chunk, the
  root's contribution raw, AVG divides, the result re-encoded once.
* ``ring``: per grid chunk and rank-part c (``_chunk_bounds``), partial sums
  in ring order v_c, v_{c+1} + acc, ...; the completed part encoded once
  (one int8 scale per part), AVG after the decode.

``psum`` is the native path: codec "none" is a plain ``sum`` over the
stacked rows (numeric: the order is the library's). A lossy codec runs the
QUANTIZED exchange (EQuARX): each rank's contribution is quantized on the
chunk grid (``quant_int8``), every owner dequantize-accumulates its shard
of the int8 rows in rank order (``dequant_acc_int8``), the reduced shards
are re-quantized on the shard-local grid and decoded once more, so every
rank receives identical values. bf16/fp16 downcast elementwise instead.

Floating-point rounding is the host's at every point: torch's elementwise
ops round each result, divisions go through ``div_exact`` (PyTorch's CUDA
kernel multiplies by the reciprocal of a Python scalar divisor), and the
kernels use explicit ``_rn`` intrinsics (no FMA contraction), so no twin of
the reference's ``_hardround`` is needed. ``quant_int8`` is the one
quantizer of every phase and path (the reference's ``_dev_quant_int8`` and
``_quantize_chunks``), and its scale divide is f64, as in numpy. The
phase-1 encode therefore
bit-matches the host codec, which is what makes the host
``codec_roundtrip`` the honest error-feedback image of this wire.

Plans
-----
``DevicePool`` caches one plan per ``(world, algorithm, codec, chunk grid,
op, layouts)``: the stacked device buffers, the ring's part-index tensors
and the pinned host staging. Every quorum at a seen world size and layout
reuses its plan (``hit_count``); only first sight builds one
(``compile_count``), so membership churn never grows the cache per step.

Hierarchical topology
---------------------
``topology="hier"`` reduces over the domain tree that ``comm/topology.py``
resolves (every rank resolves the cohort; divergent assignments fail the
op). ``star``/``auto`` is the deterministic composition of the TCP hier
path, bitwise with it: each domain's rows accumulate at full precision in
wire rank order, domain 0's sum stays raw and every other domain's sum is
decoded from its encoding in domain order, and the result is re-encoded
once (``_dev_enc_dec``: ``quant_int8`` and ``dequant_acc_int8`` under
int8). ``psum`` is numeric: a full-precision sum within each domain, then
``quant_int8`` of every domain sum (the egress rows) and one
``dequant_acc_int8`` across them, identical on every rank. The plan key
holds the domain groups, so a re-form at a membership seen before is a
cache hit. ``_host_hier_allreduce`` is the reference composition on the
host: the fallback for dtypes the card does not hold, and the oracle.

64-bit payloads and the dtypes torch does not add on the card (u16, u32)
reduce on a host simulation of the same topology and codec math
(``_host_allreduce``), bitwise identical by construction.

Fused step
----------
The builders of ``fused.FusedStepEngine``: a ``(replica, model)`` mesh laid
over the pool's device (``DevicePool.mesh_for``, virtual: every position a
row of a stacked tensor), the HSDP step's four stage bodies written once
(``_fused_local_fns``), and two program families cached in the pool per
``_FusedSpec.exec_key``: the whole step as one CUDA graph
(``_build_fused_step``) and each stage as its own (``_build_step_stage``).
"""

from __future__ import annotations

import contextlib
import logging
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from datetime import timedelta
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from torchft_tpu_torch.comm.context import CommContext, ReduceOp, Work
from torchft_tpu_torch.comm.topology import DomainAssignment, DomainTopology
from torchft_tpu_torch.comm.transport import (
    _CODECS,
    _REDUCE_FNS,
    _NoCodec,
    _chunk_bounds,
    _chunk_grid,
    codec_roundtrip,
    codec_wire_nbytes,
)
from torchft_tpu_torch.comm.wire import iov_join
from torchft_tpu_torch.ops.quant import (
    dequant_acc_int8,
    div_exact,
    n_chunks,
    quant_int8,
)
from torchft_tpu_torch.utils.device import resolve_device
from torchft_tpu_torch.utils.metrics import Metrics

logger = logging.getLogger(__name__)

__all__ = [
    "CudaCommContext",
    "DevicePool",
    "default_device_pool",
    "device_codec_roundtrip",
]

# Dtypes the device plane carries, by numpy dtype string. f32 is the codec
# plane; the rest pass through uncompressed (the host codecs'
# _is_compressible gate) but accumulate in the topology's exact order.
_DEVICE_DTYPES = {
    "<f4": torch.float32, "<f2": torch.float16,
    "|i1": torch.int8, "<i2": torch.int16, "<i4": torch.int32,
    "|u1": torch.uint8,
}
_WIRE_DTYPES = {"bf16": torch.bfloat16, "fp16": torch.float16}


def _dtype_key(dt: np.dtype) -> str:
    s = np.dtype(dt).str
    return np.dtype(dt).name if s.lstrip("<>|=").startswith("V") else s


def _is_device_dtype(dt: np.dtype) -> bool:
    return _dtype_key(dt) in _DEVICE_DTYPES


def _is_float(dt) -> bool:
    return np.dtype(dt).kind == "f" or "float" in np.dtype(dt).name


# the mesh axes of the fused step (the reference's _AXIS, _MODEL_AXIS)
REPLICA_AXIS = "replica"
MODEL_AXIS = "model"
# mesh positions a DevicePool lays out over its device by default
DEFAULT_POSITIONS = 64


# --------------------------------------------------------------- the pool


class DevicePool:
    """Plan cache across quorum epochs, on one device (twin of the
    reference's ``MeshManager``).

    ``executable(key, build)`` returns the cached plan or builds it once,
    even when several contexts (one per Manager in a process) race on first
    sight. ``compile_count`` counts builds, ``trace_count`` builder runs and
    ``hit_count`` cache hits, under the reference's names. The plane's
    device work runs on the pool's own CUDA stream.

    ``mesh_for(world_size, model_shards)`` lays a ``(replica, model)`` mesh
    over the pool's device: a virtual mesh, the device repeated at every
    position, as the reference's CPU tests lay theirs over forced host
    devices. ``positions`` is how many positions the pool lays out
    (``device_count()``); a mesh that needs more raises, as the
    reference's does past its device list."""

    def __init__(self, device: "Optional[str | torch.device]" = None,
                 positions: int = DEFAULT_POSITIONS,
                 axis_name: str = REPLICA_AXIS,
                 model_axis_name: str = MODEL_AXIS) -> None:
        self._device_arg = device
        self._device: Optional[torch.device] = None
        self._stream = None
        self._positions = int(positions)
        self.axis_name = axis_name
        self.model_axis_name = model_axis_name
        self._meshes: Dict[Tuple[int, int], Any] = {}
        self._plans: Dict[Tuple, Any] = {}
        self._building: Dict[Tuple, Future] = {}
        self._lock = threading.Lock()
        self.compile_count = 0
        self.trace_count = 0
        self.hit_count = 0
        # flight recorder: every plan build emits one mesh_compile event
        self.events = None

    def device(self) -> torch.device:
        """The pool's device (``cuda`` unless given), resolved on first
        use so that constructing a pool touches no device."""
        with self._lock:
            if self._device is None:
                self._device = resolve_device(self._device_arg)
            return self._device

    def device_count(self) -> int:
        """Mesh positions the pool lays out over its device."""
        return self._positions

    def mesh_for(self, world_size: int, model_shards: int = 1):
        """The ``parallel.mesh.Mesh`` of ``world_size`` replicas x
        ``model_shards`` positions over the pool's device: 1-D
        ``(replica,)`` at one model shard, else 2-D ``(replica, model)``,
        replica group r the row of positions ``r*M .. r*M + M - 1``.
        Cached per shape; raises ValueError past ``device_count()``."""
        from torchft_tpu_torch.parallel.mesh import Mesh

        m = max(1, int(model_shards))
        need = int(world_size) * m
        if need > self._positions:
            raise ValueError(
                f"mesh {world_size}x{m} needs {need} positions, which "
                f"exceeds the device pool ({self._positions}); pass a "
                "larger `positions` to DevicePool")
        dev = self.device()
        with self._lock:
            mesh = self._meshes.get((world_size, m))
            if mesh is None:
                grid = np.empty(need, dtype=object)
                grid[:] = [dev] * need
                if m == 1:
                    mesh = Mesh(grid, (self.axis_name,))
                else:
                    mesh = Mesh(grid.reshape(world_size, m),
                                (self.axis_name, self.model_axis_name))
                self._meshes[(world_size, m)] = mesh
            return mesh

    @contextlib.contextmanager
    def on_stream(self):
        """Run the enclosed device work on the pool's stream (CUDA)."""
        dev = self.device()
        if dev.type != "cuda":
            yield
            return
        with self._lock:
            if self._stream is None:
                self._stream = torch.cuda.Stream(device=dev)
            stream = self._stream
        with torch.cuda.stream(stream):
            yield

    def synchronize(self) -> None:
        if self._stream is not None:
            self._stream.synchronize()

    def _note_trace(self) -> None:
        with self._lock:
            self.trace_count += 1

    def executable(self, key: Tuple, build: Callable[[], Any]) -> Any:
        """The cached plan of ``key``; ``build()`` runs at most once per key
        for the life of the pool."""
        with self._lock:
            p = self._plans.get(key)
            if p is not None:
                self.hit_count += 1
                return p
            pending = self._building.get(key)
            owner = pending is None
            if owner:
                pending = self._building[key] = Future()
        if not owner:
            p = pending.result()  # another thread is building this key
            with self._lock:
                self.hit_count += 1
            return p
        try:
            p = build()
        except Exception as e:
            with self._lock:
                del self._building[key]
            pending.set_exception(e)
            raise
        with self._lock:
            self._plans[key] = p
            self.compile_count += 1
            compile_count = self.compile_count
            del self._building[key]
        pending.set_result(p)
        ev = self.events
        if ev:
            ev.emit("mesh_compile", key=repr(key)[:200],
                    compile_count=compile_count)
        return p


_DEFAULT_POOLS: Dict[str, DevicePool] = {}
_DEFAULT_POOL_LOCK = threading.Lock()


def default_device_pool(
        device: "Optional[str | torch.device]" = None) -> DevicePool:
    """The process-wide DevicePool of ``device`` (``cuda`` by default):
    every context of a process that reduces on that device shares its
    plans."""
    key = str(torch.device("cuda" if device is None else device))
    with _DEFAULT_POOL_LOCK:
        pool = _DEFAULT_POOLS.get(key)
        if pool is None:
            pool = _DEFAULT_POOLS[key] = DevicePool(key)
        return pool


# ------------------------------------------------------ device codec math


def _grid_step(size: int, chunk_bytes: int, itemsize: int = 4) -> int:
    """Chunk length of the device-side chunk grid over one flat view of
    ``size`` elements (the transport's ``_chunk_grid`` step rule; the whole
    view at grid 0), the int8 scale granularity. The grid has
    ``n_chunks(size, step)`` chunks, the last one short."""
    if chunk_bytes <= 0:
        return max(1, size)
    return max(1, chunk_bytes // itemsize)


def _dev_dequant_int8(q: torch.Tensor, scales: torch.Tensor,
                      step: int) -> torch.Tensor:
    """``f32(q) * scale`` per row (one source, a grid per row)."""
    rows, n = q.shape
    out = dequant_acc_int8(q.reshape(1, rows * n),
                           scales.reshape(1, -1), step, seg=max(1, n),
                           cps=scales.shape[1])
    return out.view(rows, n)


def _dev_enc_dec(codec_name: str, x: torch.Tensor, step: int
                 ) -> torch.Tensor:
    """decode(encode(x)) for rows of one payload, bit-matching the host
    codec for f32; identity for dtypes the host wire does not compress."""
    if codec_name == "none" or x.dtype != torch.float32:
        return x
    if codec_name in _WIRE_DTYPES:
        return x.to(_WIRE_DTYPES[codec_name]).to(torch.float32)
    if codec_name == "int8":
        q, s = quant_int8(x.contiguous(), step)
        return _dev_dequant_int8(q, s, step)
    raise ValueError(f"unknown codec {codec_name!r}")


def device_codec_roundtrip(codec_name: str, chunk_bytes: int,
                           src: np.ndarray,
                           pool: Optional[DevicePool] = None) -> np.ndarray:
    """decode(encode(src)) computed on the pool's device over the chunk
    grid: the device image of one wire contribution, which the tests hold
    bit for bit against the host ``codec_roundtrip`` (what the error
    feedback arena runs)."""
    pool = pool or default_device_pool()
    src = np.ascontiguousarray(src, dtype=np.float32).reshape(-1)
    step = _grid_step(src.size, chunk_bytes)
    with pool.on_stream():
        x = torch.from_numpy(src).to(pool.device())
        out = _dev_enc_dec(codec_name, x[None], step)[0].cpu().numpy()
    return out


# ------------------------------------------------------------------ plans


class _Plan:
    """One cached collective: stacked device input buffers, the reduction
    over them, and the pinned host staging its results come back through.
    ``run`` returns one host array per input buffer (rows: 1 for an
    allreduce, whose result every rank shares; world for a scatter)."""

    def __init__(self, device: torch.device,
                 shapes: Sequence[Tuple[Tuple[int, ...], torch.dtype]],
                 out_shapes: Sequence[Tuple[Tuple[int, ...], torch.dtype]],
                 reduce: Callable[[List[torch.Tensor]], List[torch.Tensor]]
                 ) -> None:
        self.inputs = [torch.zeros(s, dtype=d, device=device)
                       for s, d in shapes]
        pin = device.type == "cuda"
        self.host = [torch.empty(s, dtype=d, pin_memory=pin)
                     for s, d in out_shapes] if pin else None
        self._reduce = reduce
        self.lock = threading.Lock()

    def run(self) -> List[np.ndarray]:
        outs = self._reduce(self.inputs)
        if self.host is None:
            return [o.numpy() for o in outs]
        for h, o in zip(self.host, outs):
            h.copy_(o, non_blocking=True)
        return [h.numpy() for h in self.host]


def _comb(op: str, acc: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
    if op in (ReduceOp.SUM, ReduceOp.AVG):
        return acc + new
    if op == ReduceOp.MAX:
        return torch.maximum(acc, new)
    if op == ReduceOp.MIN:
        return torch.minimum(acc, new)
    raise ValueError(f"unsupported reduce op: {op}")


def _ring_parts(size: int, n: int, step: int
                ) -> Tuple[np.ndarray, np.ndarray, int, int]:
    """Per element of one flat view: its ring rank-part (``_chunk_bounds``
    of its grid chunk) and its slot in a ``[chunks * n, maxlen]`` zero-padded
    matrix of (chunk, part) segments, one int8 scale each."""
    j = np.arange(size, dtype=np.int64)
    ci = j // step
    o = j - ci * step
    m = np.minimum(step, size - ci * step)   # this chunk's length
    base, extra = m // n, m % n
    cut = extra * (base + 1)
    part = np.where(o < cut, o // np.maximum(base + 1, 1),
                    extra + (o - cut) // np.maximum(base, 1))
    start = part * base + np.minimum(part, extra)
    maxlen = -(-step // n)
    n_seg = n_chunks(size, step) * n
    dst = (ci * n + part) * maxlen + (o - start)
    return part, dst, n_seg, maxlen


def _build_allreduce(pool: DevicePool, n: int, algorithm: str,
                     codec_name: str, chunk_bytes: int, op: str,
                     layouts: Sequence[Tuple[int, str]]) -> _Plan:
    """The star / ring parity paths and the raw psum, one reduction per
    payload array over its ``(n, size)`` stacked buffer; the result is one
    row, the same for every rank."""
    pool._note_trace()
    dev = pool.device()
    lossy = codec_name != "none"
    fns = []
    for size, dkey in layouts:
        step = _grid_step(size, chunk_bytes, np.dtype(dkey).itemsize)
        if algorithm == "psum":
            fns.append(_raw_psum(n, op))
        elif algorithm == "star":
            fns.append(_star(n, codec_name, op, step, lossy))
        else:
            fns.append(_ring(dev, n, codec_name, op, size, step, lossy))
    shapes = [((n, s), _DEVICE_DTYPES[d]) for s, d in layouts]
    outs = [((1, s), _DEVICE_DTYPES[d]) for s, d in layouts]
    return _Plan(dev, shapes, outs,
                 lambda ins: [f(g) for f, g in zip(fns, ins)])


def _raw_psum(n: int, op: str):
    def fn(g: torch.Tensor) -> torch.Tensor:
        if op in (ReduceOp.SUM, ReduceOp.AVG):
            red = g.sum(0, dtype=g.dtype)
            if op == ReduceOp.AVG:
                red = div_exact(red, n)
        elif op == ReduceOp.MAX:
            red = g.amax(0)
        else:
            red = g.amin(0)
        return red[None]
    return fn


def _star(n: int, codec_name: str, op: str, step: int, lossy: bool):
    def fn(g: torch.Tensor) -> torch.Tensor:
        acc = g[0]
        if n > 1:
            dec = _dev_enc_dec(codec_name, g[1:], step)
            for r in range(n - 1):
                acc = _comb(op, acc, dec[r])
        if op == ReduceOp.AVG:
            acc = div_exact(acc, n)
        if lossy:
            acc = _dev_enc_dec(codec_name, acc[None], step)[0]
        return acc[None]
    return fn


def _ring(dev: torch.device, n: int, codec_name: str, op: str, size: int,
          step: int, lossy: bool):
    part, dst, n_seg, maxlen = _ring_parts(size, n, step)
    part_t = torch.from_numpy(part).to(dev)
    dst_t = torch.from_numpy(dst).to(dev)

    def fn(g: torch.Tensor) -> torch.Tensor:
        acc = torch.gather(g, 0, part_t[None])[0]
        for i in range(1, n):
            new = torch.gather(g, 0, ((part_t + i) % n)[None])[0]
            acc = _comb(op, new, acc)   # the local (newer) value on the left
        if lossy and acc.dtype == torch.float32:
            if codec_name == "int8":
                seg = torch.zeros(n_seg * maxlen, dtype=torch.float32,
                                  device=dev)
                seg[dst_t] = acc
                dec = _dev_enc_dec(codec_name, seg.view(n_seg, maxlen),
                                   maxlen)
                acc = dec.reshape(-1)[dst_t]
            else:
                acc = _dev_enc_dec(codec_name, acc[None], step)[0]
        if op == ReduceOp.AVG:
            acc = div_exact(acc, n)
        return acc[None]
    return fn


def _build_psum_scatter(pool: DevicePool, n: int, op: str,
                        sizes: Sequence[int]) -> _Plan:
    """The native reduce_scatter: input ``(n, n·L)`` (each rank's
    contribution to every owner's slot, padded to the common slot length
    L); output ``(n, L)``, row d owner d's reduced slot (numeric)."""
    pool._note_trace()
    L = max(sizes)

    def fn(ins: List[torch.Tensor]) -> List[torch.Tensor]:
        red = ins[0].view(n, n, L).sum(0)
        return [div_exact(red, n) if op == ReduceOp.AVG else red]

    return _Plan(pool.device(), [((n, n * L), torch.float32)],
                 [((n, L), torch.float32)], fn)


def _build_quantized_psum(pool: DevicePool, n: int, codec_name: str,
                          chunk_bytes: int, op: str,
                          layouts: Sequence[Tuple[int, str]]) -> _Plan:
    """The quantized allreduce (EQuARX) for each f32 payload:

    1. quantize every rank's row on the chunk grid (``quant_int8``, one
       launch for all rows; bf16/fp16 downcast elementwise);
    2. owner d dequantize-accumulates columns ``[d·L, (d+1)·L)`` of every
       row in rank order (``dequant_acc_int8``, one launch for all owners;
       the padding past ``size`` decodes to 0, as the reference's 1.0-padded
       scales make it), then AVG divides;
    3. each owner's reduced shard is re-quantized on the shard-local grid
       and decoded (one launch each), so every rank receives the same bytes.

    Non-f32 payloads ride a raw ``sum`` uncompressed, as the host codecs
    leave them. SUM/AVG only (the ctor and ``unsupported_reason`` refuse
    max/min)."""
    pool._note_trace()
    if op not in (ReduceOp.SUM, ReduceOp.AVG):
        raise ValueError(
            f"quantized psum only accumulates (sum/avg); got op={op!r}"
        )
    div = n if op == ReduceOp.AVG else 0
    fns = []
    for size, dkey in layouts:
        if size == 0:
            fns.append(lambda g: g[:1])
        elif dkey != "<f4":
            fns.append(_raw_psum(n, op))
        elif codec_name == "int8":
            fns.append(_qpsum_int8(n, size, chunk_bytes, div))
        else:
            fns.append(_qpsum_astype(n, size, _WIRE_DTYPES[codec_name], div))
    shapes = [((n, s), _DEVICE_DTYPES[d]) for s, d in layouts]
    outs = [((1, s), _DEVICE_DTYPES[d]) for s, d in layouts]
    return _Plan(pool.device(), shapes, outs,
                 lambda ins: [f(g) for f, g in zip(fns, ins)])


def _qpsum_int8(n: int, size: int, chunk_bytes: int, div: int):
    L = -(-size // n)
    step1 = _grid_step(size, chunk_bytes)
    step2 = _grid_step(L, chunk_bytes)
    c2 = n_chunks(L, step2)

    def fn(g: torch.Tensor) -> torch.Tensor:
        q = torch.empty((n, n * L), dtype=torch.int8, device=g.device)
        s = torch.empty((n, n_chunks(size, step1)), dtype=torch.float32,
                        device=g.device)
        quant_int8(g, step1, out=(q[:, :size], s))
        acc = dequant_acc_int8(q, s, step1, valid=size, divisor=div)
        q2, s2 = quant_int8(acc.view(n, L), step2)
        out = dequant_acc_int8(q2.view(1, n * L), s2.view(1, n * c2), step2,
                               valid=size, seg=L, cps=c2)
        return out[:size][None]
    return fn


def _qpsum_astype(n: int, size: int, wd: torch.dtype, div: int):
    L = -(-size // n)

    def fn(g: torch.Tensor) -> torch.Tensor:
        et = torch.zeros((n, n * L), dtype=wd, device=g.device)
        et[:, :size] = g.to(wd)
        acc = torch.zeros(n * L, dtype=torch.float32, device=g.device)
        for r in range(n):
            acc = acc + et[r].float()
        if div:
            acc = div_exact(acc, div)
        return acc.to(wd).float()[:size][None]
    return fn


def _build_quantized_psum_scatter(pool: DevicePool, n: int,
                                  codec_name: str, chunk_bytes: int, op: str,
                                  sizes: Sequence[int]) -> _Plan:
    """The quantized reduce_scatter: phase 1 of the quantized psum alone.
    Every rank's contribution to every owner is quantized on that slot's
    grid (one launch), each owner dequantize-accumulates its slot in rank
    order (one launch). Input and output as :func:`_build_psum_scatter`."""
    pool._note_trace()
    L = max(sizes)
    step = _grid_step(L, chunk_bytes)
    c = n_chunks(L, step)
    div = n if op == ReduceOp.AVG else 0

    def fn(ins: List[torch.Tensor]) -> List[torch.Tensor]:
        x = ins[0].view(n * n, L)   # row r·n + d: rank r's slot for owner d
        if codec_name == "int8":
            q, s = quant_int8(x, step)
            acc = dequant_acc_int8(q.view(n, n * L), s.view(n, n * c), step,
                                   seg=L, cps=c, divisor=div)
            return [acc.view(n, L)]
        et = x.view(n, n, L).to(_WIRE_DTYPES[codec_name])
        acc = torch.zeros((n, L), dtype=torch.float32, device=x.device)
        for r in range(n):
            acc = acc + et[r].float()
        return [div_exact(acc, div) if div else acc]

    return _Plan(pool.device(), [((n, n * L), torch.float32)],
                 [((n, L), torch.float32)], fn)


def _build_hier(pool: DevicePool, n: int, codec_name: str,
                chunk_bytes: int, op: str,
                layouts: Sequence[Tuple[int, str]],
                groups: Sequence[Sequence[int]]) -> _Plan:
    """The deterministic hierarchical allreduce (module docstring), per
    payload array over its ``(n, size)`` stacked buffer, bitwise with the
    TCP hier path: reduce-within in wire rank order, the star fan-in of the
    encoded domain sums in domain order, the root's re-encode, then AVG."""
    pool._note_trace()
    lossy = codec_name != "none"

    def build_one(size: int, dkey: str):
        step = _grid_step(size, chunk_bytes, np.dtype(dkey).itemsize)

        def fn(g: torch.Tensor) -> torch.Tensor:
            dsums = []
            for ranks in groups:
                acc = g[ranks[0]]
                for r in ranks[1:]:
                    acc = _comb(op, acc, g[r])
                dsums.append(acc)
            acc = dsums[0]
            if len(dsums) > 1:
                dec = _dev_enc_dec(codec_name, torch.stack(dsums[1:]), step)
                for d in range(len(dsums) - 1):
                    acc = _comb(op, acc, dec[d])
                if lossy:
                    acc = _dev_enc_dec(codec_name, acc[None], step)[0]
            if op == ReduceOp.AVG:
                acc = div_exact(acc, n)
            return acc[None]
        return fn

    fns = [build_one(size, dkey) if size else (lambda g: g[:1])
           for size, dkey in layouts]
    shapes = [((n, s), _DEVICE_DTYPES[d]) for s, d in layouts]
    outs = [((1, s), _DEVICE_DTYPES[d]) for s, d in layouts]
    return _Plan(pool.device(), shapes, outs,
                 lambda ins: [f(g) for f, g in zip(fns, ins)])


def _build_hier_psum(pool: DevicePool, n: int, codec_name: str,
                     chunk_bytes: int, op: str,
                     layouts: Sequence[Tuple[int, str]],
                     groups: Sequence[Sequence[int]]) -> _Plan:
    """The native hierarchical allreduce (numeric): a full-precision sum
    within each domain, then the domain sums (one per egress row) encoded
    once and accumulated across domains in domain order. int8 is one
    ``quant_int8`` of the egress rows and one ``dequant_acc_int8`` across
    them (AVG divides in the same launch); bf16/fp16 downcast. Extrema
    are idempotent across tiers (a plain max/min); non-f32 payloads and a
    single domain accumulate flat. Every rank receives the one result."""
    pool._note_trace()
    div = n if op == ReduceOp.AVG else 0
    index = [torch.tensor(list(r), dtype=torch.long, device=pool.device())
             for r in groups]

    def build_one(size: int, dkey: str):
        if op in (ReduceOp.MAX, ReduceOp.MIN) or dkey != "<f4" \
                or len(groups) == 1:
            return _raw_psum(n, op)
        step = _grid_step(size, chunk_bytes)

        def fn(g: torch.Tensor) -> torch.Tensor:
            dsums = torch.stack([g.index_select(0, i).sum(0) for i in index])
            if codec_name == "int8":
                q, s = quant_int8(dsums, step)
                return dequant_acc_int8(q, s, step, divisor=div)[None]
            if codec_name != "none":
                dsums = dsums.to(_WIRE_DTYPES[codec_name]).float()
            acc = dsums[0]
            for d in range(1, len(groups)):
                acc = acc + dsums[d]
            return (div_exact(acc, div) if div else acc)[None]
        return fn

    fns = [build_one(size, dkey) if size else (lambda g: g[:1])
           for size, dkey in layouts]
    shapes = [((n, s), _DEVICE_DTYPES[d]) for s, d in layouts]
    outs = [((1, s), _DEVICE_DTYPES[d]) for s, d in layouts]
    return _Plan(pool.device(), shapes, outs,
                 lambda ins: [f(g) for f, g in zip(fns, ins)])


# ------------------------------------------------------- the fused HSDP step
# Twin of the reference's fused-step builders. A replica group is a row of
# ``model_shards`` positions of a (replica, model) mesh laid over the pool's
# device (``DevicePool.mesh_for``); every position is a row of a stacked
# ``(D, ...)`` tensor, ``D = replicas * model_shards``, position ``d = r * M +
# m``. Params are model-sharded and replica-replicated; the optimizer state is
# sharded over both axes: position (r, m) owns the sub-shard
# ``shard_m[r*q_len : (r+1)*q_len]``. The four stage bodies are written once
# (``_fused_local_fns``) and shared by the fused program (one CUDA graph of
# all four) and the staged programs (one graph each, with host round trips
# between them in fused.py), so both arms run the same kernels in the same
# order; no twin of ``_hardround`` is needed (module docstring). Programs are
# cached in the DevicePool per (mesh shape, codec, chunk grid, layouts, fn
# identity): churn at a seen shape is a cache hit.

_STAGES = ("grad", "exchange", "update", "gather")
# the port's one block quantizer (the reference pins its "xla"/"pallas" pick)
_QUANT_IMPL = "quant_int8"


class _FusedSpec:
    """Static description of one fused-step program family: everything the
    builders need, and everything the cache key must pin. ``q_len`` is the
    per-position owned sub-shard, ``p_len = replicas * q_len`` the
    per-model-shard param slice, ``s_len = model_shards * p_len`` the padded
    flat param vector. ``sub_update(g, p_sub, leaves) -> (new_sub,
    new_leaves)`` is one position's optimizer step over its owned
    sub-shard and its state leaves (fused.py builds it from ``tx``); the
    leaves' shapes and dtypes stand for the reference's optax treedef."""

    __slots__ = (
        "replicas", "model_shards", "param_size", "batch_size",
        "codec_name", "chunk_bytes", "quant_impl", "error_feedback",
        "loss_fn", "sub_update", "opt_leaf_shapes",
        "opt_leaf_dtypes", "fn_key", "q_len", "p_len", "s_len",
    )

    def __init__(self, replicas: int, model_shards: int, param_size: int,
                 batch_size: int, codec_name: str, chunk_bytes: int,
                 quant_impl: str, error_feedback: bool, loss_fn, sub_update,
                 opt_leaf_shapes, opt_leaf_dtypes,
                 fn_key: str) -> None:
        self.replicas = int(replicas)
        self.model_shards = max(1, int(model_shards))
        self.param_size = int(param_size)
        self.batch_size = int(batch_size)
        self.codec_name = codec_name
        self.chunk_bytes = int(chunk_bytes)
        self.quant_impl = quant_impl
        self.error_feedback = bool(error_feedback)
        self.loss_fn = loss_fn
        self.sub_update = sub_update
        self.opt_leaf_shapes = tuple(tuple(s) for s in opt_leaf_shapes)
        self.opt_leaf_dtypes = tuple(opt_leaf_dtypes)
        self.fn_key = fn_key
        self.q_len = max(
            1, -(-self.param_size // (self.replicas * self.model_shards))
        )
        self.p_len = self.replicas * self.q_len
        self.s_len = self.model_shards * self.p_len

    @property
    def positions(self) -> int:
        return self.replicas * self.model_shards

    def exec_key(self, kind: str) -> Tuple:
        """DevicePool cache key of one program of the family (``kind``:
        "fused" or a stage name): the reference's fields."""
        return (
            "fused_step", kind, self.replicas, self.model_shards,
            self.codec_name, self.chunk_bytes, self.quant_impl,
            self.error_feedback, self.param_size, self.batch_size,
            self.opt_leaf_shapes,
            tuple(str(d) for d in self.opt_leaf_dtypes), self.fn_key,
        )


def _fused_local_fns(spec: _FusedSpec):
    """The four stage bodies over stacked tensors, defined once and shared
    by the fused and staged builders. Each is pure (returns new tensors):

    ``grad(p, b) -> (gm, loss)``: per position the params allgather over
    the model axis (the row's shards side by side, a view), autograd of
    ``loss_fn`` on its microbatch, the reduce-scatter back onto the model
    axis (summed in model order); ``loss`` the sum over positions divided
    by R*M, one per position.

    ``exchange(gm, e) -> (h, e')``: the cross-replica reduce-scatter of the
    model-sharded gradient under the codec, divided by R*M. ``none`` sums in
    rank order; ``bf16``/``fp16`` cast every slot and accumulate in f32 from
    0 in rank order; ``int8`` quantizes every destination slot on the chunk
    grid (``quant_int8``, one launch for all D*R slots), adds the error
    feedback residual first when it is on, and decodes-accumulates in rank
    order (``dequant_acc_int8``, one launch for all positions, the output
    in (m, r) order: the flat averaged gradient); the residual is ``gq -
    own wire image`` (one more ``dequant_acc_int8``).

    ``update(h, p, *opt) -> (new_sub, *new_opt)``: per position its owned
    sub-shard through ``spec.sub_update``.

    ``gather(new_sub) -> new_p``: the allgather over the replica axis of
    the raw values, a broadcast view shaped ``(R, M, R, q_len)``."""
    R, M = spec.replicas, spec.model_shards
    D = R * M
    q_len, p_len, s_len = spec.q_len, spec.p_len, spec.s_len
    codec = spec.codec_name
    denom = R * M
    ef = spec.error_feedback
    step = _grid_step(q_len, spec.chunk_bytes)
    cpr = n_chunks(q_len, step)

    def local_grad(p, b):
        gm = torch.empty((D, p_len), dtype=torch.float32, device=p.device)
        losses = []
        for r in range(R):
            full = p[r * M:(r + 1) * M].reshape(s_len)
            rowg = gm[r * M:(r + 1) * M]
            for m in range(M):
                x = full.detach().requires_grad_(True)
                with torch.enable_grad():
                    w = x if spec.param_size == s_len \
                        else x[:spec.param_size]
                    loss = spec.loss_fn(w, b[r * M + m])
                    (g,) = torch.autograd.grad(loss, x)
                if m == 0:
                    rowg.copy_(g.view(M, p_len))
                else:
                    rowg.add_(g.view(M, p_len))
                losses.append(loss.detach().float().reshape(()))
        total = losses[0]
        for x in losses[1:]:
            total = total + x
        return gm, div_exact(total, denom).reshape(1).expand(D).contiguous()

    def by_position(mr):
        # (M, R, q_len) in (m, r) order -> (D, q_len), d = r * M + m
        return mr.transpose(0, 1).reshape(D, q_len)

    def local_exchange(gm, e):
        gv = gm.view(R, M, R, q_len)  # [source r', m, destination r]
        if codec == "none":
            acc = gv[0]
            for r in range(1, R):
                acc = acc + gv[r]
            return by_position(div_exact(acc, denom)), e
        if codec in _WIRE_DTYPES:
            wd = _WIRE_DTYPES[codec]
            acc = torch.zeros((M, R, q_len), dtype=torch.float32,
                              device=gm.device)
            for r in range(R):
                acc = acc + gv[r].to(wd).to(torch.float32)
            return by_position(div_exact(acc, denom)), e
        gq = gm + e if ef else gm
        q, s = quant_int8(gq.view(D * R, q_len), step)
        acc = dequant_acc_int8(q.view(R, M * R * q_len),
                               s.view(R, M * R * cpr), step, seg=q_len,
                               cps=cpr, divisor=denom)
        h = by_position(acc.view(M, R, q_len))
        if ef:
            e = gq - _dev_dequant_int8(q, s, step).view(D, p_len)
        return h, e

    def local_update(h, p, *opt):
        pv = p.view(R, M, R, q_len)
        subs, new = [], [[] for _ in opt]
        for d in range(D):
            r, m = divmod(d, M)
            p_sub = pv[r, m, r]
            new_sub, leaves = spec.sub_update(h[d], p_sub,
                                              [leaf[d] for leaf in opt])
            subs.append(new_sub)
            for acc, leaf in zip(new, leaves):
                acc.append(leaf)
        return (torch.stack(subs),) + tuple(torch.stack(x) for x in new)

    def local_gather(new_sub):
        return new_sub.view(R, M, q_len).permute(1, 0, 2)[None].expand(
            R, M, R, q_len)

    return local_grad, local_exchange, local_update, local_gather


class _StepProgram:
    """One program of a fused-step family. ``pure(*args)`` is its body
    (new tensors out); ``write(args, outs)`` writes the state outputs into
    their input tensors in place and returns the rest. ``run(*args)`` does
    both eagerly (the CPU path); ``capture(args, mempool, side)`` records
    both as one CUDA graph over the static tensors ``args``."""

    def __init__(self, pure: Callable, write: Callable) -> None:
        self.pure = pure
        self.write = write

    def run(self, *args):
        return self.write(args, self.pure(*args))

    def capture(self, args: Sequence[torch.Tensor], mempool,
                side: "torch.cuda.Stream") -> "_StepGraph":
        """Warm up once (the pure body alone: autograd's and cuBLAS's lazy
        state come into being on the capture stream ``side``, outside the
        capture; its launches count as launches), then capture on
        ``side``, tallying the kernel wrappers' calls
        (``recording_launches``). One side stream serves all of an
        owner's captures, so the warm-ups' cached memory is reused."""
        from torchft_tpu_torch.ops import flash, quant

        cur = torch.cuda.current_stream(args[0].device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            self.pure(*args)
        side.wait_stream(cur)
        graph = torch.cuda.CUDAGraph()
        tally: Dict[str, int] = {}
        with flash.recording_launches(tally, side), \
                quant.recording_launches(tally, side):
            with torch.cuda.graph(graph, pool=mempool, stream=side,
                                  capture_error_mode="thread_local"):
                outs = self.run(*args)
        cur.wait_stream(side)
        return _StepGraph(graph, outs, tally)


class _StepGraph:
    """A captured program: ``replay()`` runs it on the current stream, adds
    its capture's tally to the kernel wrappers' launch counts, and returns
    its static outputs (valid until the next replay of a graph sharing its
    memory pool)."""

    def __init__(self, graph, outs: Tuple, tally: Dict[str, int]) -> None:
        self.graph = graph
        self.outs = outs
        self.tally = tally

    def replay(self) -> Tuple:
        from torchft_tpu_torch.ops import flash, quant

        self.graph.replay()
        flash.add_launches(self.tally)
        quant.add_launches(self.tally)
        return self.outs


def _write_state(dst: torch.Tensor, src: torch.Tensor) -> None:
    if src is not dst:
        dst.copy_(src)


def _build_fused_step(pool: DevicePool, spec: _FusedSpec) -> _StepProgram:
    """The whole step as one program: ``run(p, b, e, *opt) -> (loss,)``,
    with ``p``, ``e`` and the optimizer leaves updated in place (the
    reference's ``fn(z, p, b, e, *opt) -> (new_p, loss, new_e, *new_opt)``
    with the outputs replacing the inputs). On the card it is captured as
    ONE CUDA graph: no host round trip between the stages."""
    grad, exchange, update, gather = _fused_local_fns(spec)
    pool._note_trace()

    def pure(p, b, e, *opt):
        gm, loss = grad(p, b)
        h, new_e = exchange(gm, e)
        del gm  # its memory serves the update
        new_sub, *new_opt = update(h, p, *opt)
        return (gather(new_sub), loss, new_e, *new_opt)

    def write(args, outs):
        p, _, e, *opt = args
        new_p, loss, new_e, *new_opt = outs
        p.view(new_p.shape).copy_(new_p)
        _write_state(e, new_e)
        for dst, src in zip(opt, new_opt):
            dst.copy_(src)
        return (loss,)

    return _StepProgram(pure, write)


def _build_step_stage(pool: DevicePool, spec: _FusedSpec,
                      stage: str) -> _StepProgram:
    """One stage of the staged arm, the same body the fused program
    composes, as a program of its own (a CUDA graph of its own on the card)
    whose inputs and outputs cross the host between replays:

    ``grad``     ``run(p, b) -> (gm, loss)``
    ``exchange`` ``run(gm, e) -> (h,)``, ``e`` updated in place
    ``update``   ``run(h, p, *opt) -> (new_sub,)``, ``opt`` in place
    ``gather``   ``run(new_sub, p) -> ()``, ``p`` written in place"""
    if stage not in _STAGES:
        raise ValueError(f"unknown step stage {stage!r}")
    grad, exchange, update, gather = _fused_local_fns(spec)
    pool._note_trace()
    if stage == "grad":
        return _StepProgram(grad, lambda args, outs: outs)
    if stage == "exchange":
        def write_exchange(args, outs):
            _write_state(args[1], outs[1])
            return outs[:1]

        return _StepProgram(exchange, write_exchange)
    if stage == "update":
        def write_update(args, outs):
            for dst, src in zip(args[2:], outs[1:]):
                dst.copy_(src)
            return outs[:1]

        return _StepProgram(update, write_update)

    def write_gather(args, outs):
        args[1].view(outs[0].shape).copy_(outs[0])
        return ()

    return _StepProgram(lambda new_sub, p: (gather(new_sub),), write_gather)


# ------------------------------------------------------ host-side fallback


def _host_allreduce(contribs: List[List[np.ndarray]], algorithm: str,
                    codec_name: str, chunk_bytes: int,
                    op: str) -> List[List[np.ndarray]]:
    """In-group host simulation of the transport's star/ring math for
    payload dtypes the device plane does not hold (64-bit, u16, u32): the
    real codec code over the real chunk grid, so bitwise identical to the
    socket transport by construction. ``psum`` maps onto the ring
    simulation. Returns per-rank results."""
    n = len(contribs)
    codec = _CODECS[codec_name]()
    reduce_fn = _REDUCE_FNS.get(ReduceOp.SUM if op == ReduceOp.AVG else op)
    if reduce_fn is None:
        raise ValueError(f"unsupported reduce op: {op}")
    lossy = type(codec) is not _NoCodec
    copy = lambda v, inc: np.copyto(v, inc)  # noqa: E731

    if algorithm == "star":
        acc = [a.copy() for a in contribs[0]]
        acc_chunks = _chunk_grid([a.reshape(-1) for a in acc], chunk_bytes)
        peer_chunks = [
            _chunk_grid([a.reshape(-1) for a in contribs[r]], chunk_bytes)
            for r in range(1, n)
        ]
        for ci, ch in enumerate(acc_chunks):
            for pi in range(n - 1):
                enc = codec.encode_iovecs([peer_chunks[pi][ci]])
                codec.decode_into(iov_join(enc), [ch], reduce_fn)
            if op == ReduceOp.AVG:
                np.divide(ch, n, out=ch)
            if lossy:
                enc = codec.encode_iovecs([ch])
                codec.decode_into(iov_join(enc), [ch], copy)
        return [acc for _ in range(n)]

    # ring: every rank's reduce-scatter, then the encode-once all-gather
    ranks = [[a.copy() for a in contribs[r]] for r in range(n)]
    flats = [
        _chunk_grid([a.reshape(-1) for a in ranks[r]], chunk_bytes)
        for r in range(n)
    ]

    def views(r: int, c: int) -> List[np.ndarray]:
        out = []
        for f in flats[r]:
            s, e = _chunk_bounds(f.size, n, c)
            out.append(f[s:e])
        return out

    for step in range(n - 1):
        sent = {
            r: [v.copy() for v in views(r, (r - step) % n)] for r in range(n)
        }
        for r in range(n):
            for v, inc in zip(views(r, (r - step - 1) % n),
                              sent[(r - 1) % n]):
                reduce_fn(v, inc)
    for c in range(n):
        enc = iov_join(codec.encode_iovecs(views((c - 1) % n, c)))
        for r in range(n):
            codec.decode_into(enc, views(r, c), copy)
    if op == ReduceOp.AVG:
        for r in range(n):
            for f in flats[r]:
                np.divide(f, n, out=f)
    return ranks


def _host_hier_allreduce(contribs: List[List[np.ndarray]],
                         codec_name: str, chunk_bytes: int, op: str,
                         groups: Sequence[Sequence[int]],
                         world_size: int) -> List[np.ndarray]:
    """The hierarchical composition on the host, through the real codec
    over the real chunk grid (bitwise with the TCP hier path by
    construction): the fallback for dtypes the card does not hold, and the
    reference both planes are held to. Returns ONE result list (every rank
    decodes the same values)."""
    codec = _CODECS[codec_name]()
    reduce_fn = _REDUCE_FNS.get(ReduceOp.SUM if op == ReduceOp.AVG else op)
    if reduce_fn is None:
        raise ValueError(f"unsupported reduce op: {op}")
    lossy = type(codec) is not _NoCodec
    copy = lambda v, inc: np.copyto(v, inc)  # noqa: E731

    def grid(arrays: List[np.ndarray]) -> List[np.ndarray]:
        return _chunk_grid([a.reshape(-1) for a in arrays], chunk_bytes)

    # reduce-within: wire rank order per domain (the intra star's order)
    dsums: List[List[np.ndarray]] = []
    for ranks in groups:
        acc = [a.copy() for a in contribs[ranks[0]]]
        acc_chunks = grid(acc)
        for r in ranks[1:]:
            for ch, inc in zip(acc_chunks, grid(contribs[r])):
                reduce_fn(ch, inc)
        dsums.append(acc)
    # exchange-across: star fan-in over the domains (domain 0 raw, the
    # rest encoded once), then the root's re-encode
    total = dsums[0]
    total_chunks = grid(total)
    for dsum in dsums[1:]:
        for ch, inc in zip(total_chunks, grid(dsum)):
            codec.decode_into(iov_join(codec.encode_iovecs([inc])), [ch],
                              reduce_fn)
    if len(dsums) > 1 and lossy:
        for ch in total_chunks:
            codec.decode_into(iov_join(codec.encode_iovecs([ch])), [ch], copy)
    if op == ReduceOp.AVG:
        for a in total:
            np.divide(a, world_size, out=a)
    return total


# ---------------------------------------------------------- group rendezvous


class _Sub:
    __slots__ = ("opcode", "arrays", "op", "root", "fut", "owners",
                 "topology", "vote", "t_submit")

    def __init__(self, opcode: str, arrays: List[np.ndarray], op: str,
                 root: int, fut: Future,
                 owners: "Optional[List[int]]" = None,
                 topology: Optional[str] = None, vote: int = 0) -> None:
        self.opcode = opcode
        self.arrays = arrays
        self.op = op
        self.root = root
        self.fut = fut
        self.owners = owners  # reduce_scatter: destination rank per array
        self.topology = topology  # allreduce: the per-op override
        # this rank's commit-vote health bit (1 = unhealthy), sampled at
        # submit on the gradient ops
        self.vote = vote
        self.t_submit = time.perf_counter()


def _fail(fut: Future, exc: Exception) -> None:
    try:
        fut.set_exception(exc)
    except Exception:  # noqa: BLE001 — already resolved
        pass


class _DeviceGroup:
    """In-process rendezvous standing in for a collective launch (module
    docstring): one group per store address, executing each fully
    subscribed op on a 1-thread executor so submits stay O(enqueue)."""

    _registry: Dict[str, "_DeviceGroup"] = {}
    _registry_lock = threading.Lock()

    @classmethod
    def join(cls, key: str, rank: int, world_size: int,
             ctx: "CudaCommContext", timeout: float) -> "_DeviceGroup":
        with cls._registry_lock:
            group = cls._registry.get(key)
            if group is None:
                group = cls(key, world_size, ctx._pool)
                cls._registry[key] = group
        group._add_member(rank, world_size, ctx)
        # block until the full cohort arrives, as the socket rendezvous
        # does: a peer that died before it must fail configure
        deadline = time.time() + timeout
        try:
            with group._cond:
                while (len(group._members) < world_size
                       and not group._closed):
                    remaining = deadline - time.time()
                    if remaining <= 0:
                        raise TimeoutError(
                            f"cuda comm configure: {len(group._members)} of "
                            f"{world_size} ranks joined {key!r} before "
                            "timeout"
                        )
                    group._cond.wait(timeout=min(0.1, remaining))
                if group._closed:
                    raise ConnectionError(
                        f"cuda comm configure: group {key!r} closed during "
                        "rendezvous (a member reconfigured or shut down)"
                    )
        except Exception:
            group._abandon(rank)
            raise
        return group

    def __init__(self, key: str, world_size: int, pool: DevicePool) -> None:
        self.key = key
        self.world_size = world_size
        self.pool = pool
        self._members: Dict[int, "CudaCommContext"] = {}
        self._pending: Dict[int, Dict[int, _Sub]] = {}
        self._timers: Dict[int, threading.Timer] = {}
        self._cond = threading.Condition()
        self._closed = False
        self._executor = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix=f"torchft_cuda_{id(self)}"
        )

    def _add_member(self, rank: int, world_size: int,
                    ctx: "CudaCommContext") -> None:
        with self._cond:
            if self._closed:
                raise ConnectionError(
                    f"cuda comm configure: group {self.key!r} already closed"
                )
            if world_size != self.world_size:
                raise ValueError(
                    f"cuda comm configure: rank {rank} joined {self.key!r} "
                    f"with world_size {world_size}, group has "
                    f"{self.world_size}"
                )
            if rank in self._members:
                raise ValueError(
                    f"cuda comm configure: duplicate rank {rank} in "
                    f"{self.key!r}"
                )
            first = next(iter(self._members.values()), None)
            if first is None:
                # the first member's pool runs the group's plans
                self.pool = ctx._pool
            else:
                mine = (ctx._codec_name, ctx._chunk_bytes, ctx._algorithm,
                        ctx._topology_default)
                theirs = (first._codec_name, first._chunk_bytes,
                          first._algorithm, first._topology_default)
                if mine != theirs or ctx._pool is not self.pool:
                    raise ValueError(
                        f"cuda comm configure: rank {rank} joined "
                        f"{self.key!r} with (codec, chunk_bytes, "
                        f"algorithm, topology)={mine} but the group runs "
                        f"{theirs} (settings and device pool must match "
                        "across ranks)"
                    )
            self._members[rank] = ctx
            self._cond.notify_all()

    def _abandon(self, rank: int) -> None:
        """Failed rendezvous: deregister the waiting rank so a retried
        configure can rendezvous again; the last member to give up
        disposes the group."""
        with self._cond:
            self._members.pop(rank, None)
            dispose = not self._members and not self._closed
            if dispose:
                # closed BEFORE leaving the registry: a racing joiner that
                # fetched this group must fail fast, not wait on a zombie
                self._close_locked(ConnectionError(
                    f"cuda comm group {self.key!r} disposed after a failed "
                    "rendezvous"
                ))
            self._cond.notify_all()
        if dispose:
            self._unregister()

    def leave(self, ctx: "CudaCommContext") -> None:
        """A member reconfiguring or shutting down closes the whole group,
        as closing sockets does: the peers' in-flight and later ops on the
        stale round fail at once."""
        with self._cond:
            if ctx not in self._members.values():
                return
            self._close_locked(ConnectionError(
                f"cuda comm group {self.key!r} torn down (member "
                "reconfigured or shut down)"
            ))
        self._unregister()

    def _unregister(self) -> None:
        with self._registry_lock:
            if self._registry.get(self.key) is self:
                del self._registry[self.key]
        self._executor.shutdown(wait=False)

    def _close_locked(self, exc: Exception) -> None:
        if self._closed:
            return
        self._closed = True
        for timer in self._timers.values():
            timer.cancel()
        self._timers.clear()
        pend, self._pending = self._pending, {}
        for subs in pend.values():
            for sub in subs.values():
                _fail(sub.fut, exc)
        self._cond.notify_all()

    def _latch_all(self, exc: Exception) -> None:
        for ctx in list(self._members.values()):
            ctx._latch_group_error(self, exc)

    # ------------------------------------------------------------- submit

    def submit(self, rank: int, seq: int, sub: _Sub,
               timeout: float) -> None:
        run_now = None
        with self._cond:
            if self._closed:
                _fail(sub.fut, ConnectionError(
                    f"cuda comm group {self.key!r} is closed"))
                return
            subs = self._pending.setdefault(seq, {})
            subs[rank] = sub
            if len(subs) == self.world_size:
                del self._pending[seq]
                timer = self._timers.pop(seq, None)
                if timer is not None:
                    timer.cancel()
                run_now = subs
            elif seq not in self._timers:
                # the first arrival arms the straggler deadline: a peer
                # that died mid-step fails the survivors' op
                timer = threading.Timer(timeout, self._expire, args=(seq,))
                timer.daemon = True
                self._timers[seq] = timer
                timer.start()
        if run_now is not None:
            # enqueue only: each rank submits in program order, so the
            # 1-thread executor keeps the group's op sequence
            try:
                self._executor.submit(self._execute_safe, seq, run_now)
            except RuntimeError as e:
                # a member tore the group down between the unlock and the
                # enqueue: this seq already left _pending, fail it here
                exc = ConnectionError(
                    f"cuda comm group {self.key!r} closed while dispatching "
                    f"seq={seq}: {e}"
                )
                for s in run_now.values():
                    _fail(s.fut, exc)
                self._latch_all(exc)

    def _expire(self, seq: int) -> None:
        with self._cond:
            subs = self._pending.pop(seq, None)
            self._timers.pop(seq, None)
        if not subs:
            return
        missing = sorted(set(range(self.world_size)) - set(subs))
        exc = ConnectionError(
            f"cuda comm op seq={seq} timed out waiting for ranks {missing} "
            f"in group {self.key!r}"
        )
        for sub in subs.values():
            _fail(sub.fut, exc)
        self._latch_all(exc)

    # ------------------------------------------------------------ execute

    def _execute_safe(self, seq: int, subs: Dict[int, _Sub]) -> None:
        try:
            self._execute(seq, subs)
        except Exception as e:  # noqa: BLE001 — fail the op, latch all
            logger.warning("cuda comm op failed (group %s seq %d): %s",
                           self.key, seq, e)
            for sub in subs.values():
                _fail(sub.fut, e)
            self._latch_all(e)

    def _execute(self, seq: int, subs: Dict[int, _Sub]) -> None:
        n = self.world_size
        ordered = [subs[r] for r in range(n)]
        first = ordered[0]
        sig = [
            (sub.opcode, sub.op, sub.root, sub.topology,
             tuple(sub.owners or ()),
             [(a.shape, _dtype_key(a.dtype)) for a in sub.arrays])
            for sub in ordered
        ]
        if first.opcode in ("broadcast", "allgather"):
            # layouts may differ per rank: broadcast discards non-root
            # contributions, allgather self-describes each rank's arrays
            sig = [s[:4] for s in sig]
        if any(s != sig[0] for s in sig):
            raise ConnectionError(
                f"cuda comm collective mismatch at seq={seq}: ranks "
                "submitted divergent ops/layouts/owners"
            )
        # per-rank spans land in each member's own sink, gradient ops only
        sinks = [self._members[r].metrics for r in range(n)]
        t_exec = time.perf_counter()
        if first.opcode in ("allreduce", "reduce_scatter"):
            for sub, m in zip(ordered, sinks):
                m.observe("comm_submit_wire", t_exec - sub.t_submit)
            self._execute_allreduce(ordered)
            # the commit vote: the rendezvous gathered every rank's health
            # bit with the op, so the aggregate is their OR, recorded on
            # every member (the reference's fold). A failed or expired op
            # records nothing: the vote is absent and the barrier runs
            agg = 0
            for sub in ordered:
                agg |= sub.vote & 1
            for r in range(n):
                self._members[r]._record_vote(agg)
            # spans before the futures resolve: a caller reading the
            # metrics right after .result() sees them
            t_done = time.perf_counter()
            for sub, m in zip(ordered, sinks):
                m.observe("comm_wire_reduce", t_done - t_exec)
                m.observe("comm_op_wire", t_done - sub.t_submit)
            for sub in ordered:
                sub.fut.set_result(sub.arrays)
        elif first.opcode == "broadcast":
            src = ordered[first.root].arrays
            for sub in ordered:
                sub.fut.set_result([np.array(a, copy=True) for a in src])
        else:  # allgather: fresh buffers per receiving rank
            for sub in ordered:
                sub.fut.set_result([
                    [np.array(a, copy=True) for a in src.arrays]
                    for src in ordered
                ])

    def _execute_allreduce(self, ordered: List[_Sub]) -> None:
        n = self.world_size
        op = ordered[0].op
        ctx0 = self._members[0]
        algorithm = ctx0._resolved_algorithm(n)
        codec_name = ctx0._codec_name
        chunk_bytes = ctx0._chunk_bytes
        arrays0 = ordered[0].arrays
        # allreduce only: reduce_scatter stays on the flat tier, as on the
        # TCP wire
        topo = ("flat" if ordered[0].opcode != "allreduce"
                else ordered[0].topology or ctx0._topology_default)
        # op-dependent capability (the ctor vetted the static combo); hier
        # checks the constructor's algorithm ("auto" composes as star)
        reason = CudaCommContext.unsupported_reason(
            ctx0._algorithm if topo == "hier" else algorithm, codec_name,
            op, topo)
        if reason is not None:
            raise ValueError(reason)
        if op == ReduceOp.AVG and not all(_is_float(a.dtype)
                                          for a in arrays0):
            raise TypeError(
                "ReduceOp.AVG requires float arrays (matching the host "
                "transport, whose in-place integer divide raises)"
            )
        if topo == "hier":
            self._execute_hier(ordered, op)
            return
        # one direction, one rank's encoded contribution (wire_nbytes), in
        # every member's sink: a compression ratio is a counter division
        raw_b = float(sum(a.nbytes for a in arrays0))
        enc_b = float(sum(ctx0.wire_nbytes(a) for a in arrays0))
        for r in range(n):
            m = self._members[r].metrics
            m.incr("comm_raw_bytes", raw_b)
            m.incr("comm_encoded_bytes", enc_b)
        owners = (ordered[0].owners
                  if ordered[0].opcode == "reduce_scatter" else None)
        if owners is not None:
            if len(owners) != len(arrays0) or any(
                    not 0 <= o < n for o in owners):
                raise ValueError(
                    f"reduce_scatter owners {owners} must name a rank in "
                    f"[0, {n}) per array ({len(arrays0)} submitted)"
                )
            if (algorithm == "psum"
                    and op in (ReduceOp.SUM, ReduceOp.AVG)
                    and list(owners) == list(range(n))
                    and all(_dtype_key(a.dtype) == "<f4" for a in arrays0)):
                self._execute_psum_scatter(ordered, op)
                return

        dev_idx = [j for j, a in enumerate(arrays0)
                   if _is_device_dtype(a.dtype)]
        host_idx = [j for j in range(len(arrays0)) if j not in dev_idx]
        host_results = None
        if host_idx:
            host_results = _host_allreduce(
                [[sub.arrays[j] for j in host_idx] for sub in ordered],
                algorithm, codec_name, chunk_bytes, op,
            )
        if dev_idx:
            layouts = tuple(
                (int(arrays0[j].size), _dtype_key(arrays0[j].dtype))
                for j in dev_idx
            )
            pool = self.pool
            if algorithm == "psum" and codec_name != "none":
                key = (n, "psum_q", codec_name, chunk_bytes, op, layouts)
                build = lambda: _build_quantized_psum(  # noqa: E731
                    pool, n, codec_name, chunk_bytes, op, layouts)
            else:
                key = (n, algorithm, codec_name, chunk_bytes, op, layouts)
                build = lambda: _build_allreduce(  # noqa: E731
                    pool, n, algorithm, codec_name, chunk_bytes, op, layouts)
            n_chunks_op = float(sum(
                n_chunks(arrays0[j].size,
                         _grid_step(arrays0[j].size, chunk_bytes,
                                    arrays0[j].itemsize))
                for j in dev_idx
            ))
            for r in range(n):
                self._members[r].metrics.incr("comm_chunks", n_chunks_op)

            def deliver(outs: List[np.ndarray]) -> None:
                for r, sub in enumerate(ordered):
                    for k, j in enumerate(dev_idx):
                        if owners is None or owners[j] == r:
                            np.copyto(sub.arrays[j].reshape(-1), outs[k][0])

            self._run(key, build, [[sub.arrays[j] for sub in ordered]
                                   for j in dev_idx], deliver)
        for r, sub in enumerate(ordered):
            for k, j in enumerate(host_idx):
                if owners is None or owners[j] == r:
                    np.copyto(sub.arrays[j], host_results[r][k])

    def _execute_hier(self, ordered: List[_Sub], op: str) -> None:
        """The hierarchical allreduce (module docstring) as one cached plan
        per (world, composition, codec, grid, op, layouts, domain groups).
        The tier counters follow the TCP hier path's convention: one
        direction, each rank's contribution; raw bytes within a domain of
        several, encoded bytes across domains on egress ranks only."""
        n = self.world_size
        ctx0 = self._members[0]
        codec_name = ctx0._codec_name
        chunk_bytes = ctx0._chunk_bytes
        arrays0 = ordered[0].arrays
        assigns = [self._members[r]._resolve_assignment() for r in range(n)]
        fps = {a.fingerprint for a in assigns}
        if len(fps) != 1:
            raise ConnectionError(
                "hier allreduce with divergent domain assignments across "
                f"ranks: {sorted(fps)}; resolver maps must match across "
                "the cohort"
            )
        a0 = assigns[0]
        if a0.world_size() != n:
            raise ConnectionError(
                f"domain assignment spans {a0.world_size()} ranks but the "
                f"wire has {n}"
            )
        groups = a0.groups
        raw_b = float(sum(a.nbytes for a in arrays0))
        enc_b = float(sum(ctx0.wire_nbytes(a) for a in arrays0))
        for r in range(n):
            m = self._members[r].metrics
            many = len(a0.group_of(r)) > 1
            across = a0.n_domains > 1
            m.incr("comm_raw_bytes", raw_b)
            m.incr("comm_encoded_bytes", enc_b)
            m.incr("comm_intra_bytes", raw_b if many else 0.0)
            m.incr("comm_inter_bytes",
                   enc_b if across and a0.is_egress(r) else 0.0)
            # reduce-to-egress and broadcast-within, the star fan-in
            m.incr("comm_hops", float(2 * many + 2 * across))

        dev_idx = [j for j, a in enumerate(arrays0)
                   if _is_device_dtype(a.dtype)]
        host_idx = [j for j in range(len(arrays0)) if j not in dev_idx]
        if host_idx:
            host_result = _host_hier_allreduce(
                [[sub.arrays[j] for j in host_idx] for sub in ordered],
                codec_name, chunk_bytes, op, groups, n,
            )
            for sub in ordered:
                for k, j in enumerate(host_idx):
                    np.copyto(sub.arrays[j], host_result[k])
        if not dev_idx:
            return
        layouts = tuple((int(arrays0[j].size), _dtype_key(arrays0[j].dtype))
                        for j in dev_idx)
        pool = self.pool
        if ctx0._resolved_hier_algorithm() == "psum":
            key = (n, "hier_psum", codec_name, chunk_bytes, op, layouts,
                   groups)
            build = lambda: _build_hier_psum(  # noqa: E731
                pool, n, codec_name, chunk_bytes, op, layouts, groups)
        else:
            key = (n, "hier", codec_name, chunk_bytes, op, layouts, groups)
            build = lambda: _build_hier(  # noqa: E731
                pool, n, codec_name, chunk_bytes, op, layouts, groups)
        n_chunks_op = float(sum(
            n_chunks(arrays0[j].size, _grid_step(
                arrays0[j].size, chunk_bytes, arrays0[j].itemsize))
            for j in dev_idx))
        for r in range(n):
            self._members[r].metrics.incr("comm_chunks", n_chunks_op)

        def deliver(outs: List[np.ndarray]) -> None:
            for sub in ordered:
                for k, j in enumerate(dev_idx):
                    np.copyto(sub.arrays[j].reshape(-1), outs[k][0])

        self._run(key, build, [[sub.arrays[j] for sub in ordered]
                               for j in dev_idx], deliver)

    def _run(self, key: Tuple, build: Callable[[], _Plan],
             rows: List[List[np.ndarray]],
             deliver: Callable[[List[np.ndarray]], None]) -> None:
        """The plan of ``key`` (built on the pool's stream at first sight):
        upload row r of input buffer k from ``rows[k][r]``, reduce on the
        card, download, wait for the stream, and ``deliver`` the host
        results into the ranks' donated arrays (the donation contract;
        _execute resolves the futures after this). The plan's lock spans
        all of it: groups that share a pool run on executors of their own,
        and a plan's buffers hold one op at a time."""
        pool = self.pool
        with pool.on_stream():
            plan = pool.executable(key, build)
        with plan.lock:
            with pool.on_stream():
                for buf, arrays in zip(plan.inputs, rows):
                    for r, a in enumerate(arrays):
                        src = torch.from_numpy(np.ascontiguousarray(a)
                                               .reshape(-1))
                        buf[r, :src.numel()].copy_(src, non_blocking=True)
                outs = plan.run()
            pool.synchronize()
            deliver(outs)

    def _execute_psum_scatter(self, ordered: List[_Sub], op: str) -> None:
        """The native reduce_scatter (owners == range(n), f32, SUM/AVG):
        arrays padded to one slot length L and stacked ``(n, n·L)``; owner
        r's reduced slot lands in rank r's array r. A lossy codec takes the
        quantized variant."""
        n = self.world_size
        ctx0 = self._members[0]
        codec_name = ctx0._codec_name
        chunk_bytes = ctx0._chunk_bytes
        sizes = tuple(int(a.size) for a in ordered[0].arrays)
        L = max(sizes) if sizes else 0
        if L == 0:
            return
        pool = self.pool
        if codec_name != "none":
            key = (n, "psum_scatter_q", codec_name, chunk_bytes, op, sizes)
            build = lambda: _build_quantized_psum_scatter(  # noqa: E731
                pool, n, codec_name, chunk_bytes, op, sizes)
        else:
            key = (n, "psum_scatter", op, sizes)
            build = lambda: _build_psum_scatter(  # noqa: E731
                pool, n, op, sizes)
        stacked = np.zeros((n, n * L), np.float32)
        for r, sub in enumerate(ordered):
            for j, a in enumerate(sub.arrays):
                stacked[r, j * L: j * L + sizes[j]] = (
                    np.ascontiguousarray(a).reshape(-1))

        def deliver(outs: List[np.ndarray]) -> None:
            for r, sub in enumerate(ordered):
                np.copyto(sub.arrays[r].reshape(-1), outs[0][r, :sizes[r]])

        self._run(key, build, [list(stacked)], deliver)


# --------------------------------------------------------------- the context


class CudaCommContext(CommContext):
    """Reconfigurable on-device collective context (module docstring).

    ``algorithm``: "star"/"ring" reproduce the socket transport's
    accumulation order and codec bits exactly ("auto" picks ring at world
    size >= 3); "psum" is the native path, a plain sum at codec "none" and
    the quantized exchange under a lossy codec (sum/avg only).
    ``compression`` / ``chunk_bytes``: the reference's codecs and chunk
    grid (the int8 scale granularity). ``device_pool``: the plan cache and
    device, process-wide on ``cuda`` by default; pass
    ``DevicePool("cpu")`` to run the plane on the CPU. ``topology``: the
    default path of ``allreduce``, "flat" or "hier" (module docstring);
    ``domain_resolver``: the :class:`DomainTopology` every rank resolves
    its cohort with (default: the ``TORCHFT_TPU_DOMAINS`` map).
    ``model_shards``: the model-axis extent of each replica group on the
    fused-step plane (fused.py); the wire collectives stay 1-D, so it is
    introspection (``mesh_shape()``) and plumbing for the fused builders,
    never a change to the exchange sequence."""

    backend_name = "cuda"

    def __init__(self, timeout: "float | timedelta" = 60.0,
                 algorithm: str = "auto",
                 compression: str = "none",
                 chunk_bytes: int = 1 << 20,
                 device_pool: Optional[DevicePool] = None,
                 topology: str = "flat",
                 domain_resolver: Optional[DomainTopology] = None,
                 model_shards: int = 1) -> None:
        super().__init__()
        if isinstance(timeout, timedelta):
            timeout = timeout.total_seconds()
        reason = self.unsupported_reason(algorithm, compression,
                                         topology=topology)
        if reason is not None:
            raise ValueError(reason)
        if chunk_bytes < 0:
            raise ValueError("chunk_bytes must be >= 0")
        self._timeout = float(timeout)
        self._algorithm = algorithm
        self._codec_name = compression
        self._codec = _CODECS[compression]()
        self._chunk_bytes = int(chunk_bytes)
        self._pool = device_pool or default_device_pool()
        self._topology_default = topology
        self._domain_resolver = domain_resolver
        self._model_shards = max(1, int(model_shards))
        self._wire_members: "Optional[List[str]]" = None
        self._configured_members: "Optional[List[str]]" = None
        self._hier_assignment: Optional[DomainAssignment] = None
        self._group: Optional[_DeviceGroup] = None
        self._seq = 0
        self._generation = 0
        self._error: Optional[Exception] = None
        self._lock = threading.Lock()
        self.metrics = Metrics()
        self.metrics.label("comm_backend", self.backend_name)
        self._events = None
        # data-plane commit votes: the aggregate health bits that rode this
        # context's gradient ops since the last take_commit_vote
        self._vote_health = None
        self._vote_lock = threading.Lock()
        self._vote_ops = 0
        self._vote_unhealthy = False

    @classmethod
    def unsupported_reason(cls, algorithm: str, compression: str,
                           op: str = ReduceOp.SUM,
                           topology: str = "flat") -> Optional[str]:
        """The cuda-plane capability rule: every codec on star/ring (the
        bitwise parity paths) for every reduce op; ``psum`` carries every
        codec too, but a lossy one only accumulates (per-chunk scales
        cannot ride max/min). ``topology="hier"`` composes the domain tree
        as the star fan-in or the native psum; its multi-hop ring inter
        tier is a host-plane arm."""
        if algorithm not in ("auto", "star", "ring", "psum"):
            return f"unknown algorithm {algorithm!r}"
        if compression not in _CODECS:
            return (f"unknown compression {compression!r}; have "
                    f"{sorted(_CODECS)}")
        if topology not in ("flat", "hier"):
            return (
                f"unknown topology {topology!r}; have 'flat' (one tier "
                "spanning the wire) and 'hier' (domain tree: reduce-within "
                "-> compress -> exchange-across -> broadcast-within)"
            )
        if topology == "hier" and algorithm == "ring":
            return (
                "topology='hier' with algorithm='ring' is the multi-hop "
                "cross-domain rotation, a host-plane arm (comm_backend="
                "'host'); the cuda hier path composes star fan-in or the "
                "native psum: use algorithm='star'/'auto'/'psum' here, or "
                "the host backend for the ring inter tier"
            )
        if (algorithm == "psum" and compression != "none"
                and op not in (ReduceOp.SUM, ReduceOp.AVG)):
            return (
                f"algorithm='psum' with compression={compression!r} runs "
                "the quantized exchange, which only ACCUMULATES (sum/avg) — "
                f"block scales cannot ride op={op!r}. Use "
                "compression='none' for max/min on the psum path, or the "
                "star/ring parity paths (their codecs handle every op)"
            )
        return None

    def set_metrics(self, metrics: Metrics) -> None:
        """Share the Manager's sink: per-op spans land under the host
        transport's names, told apart by the ``comm_backend`` label."""
        self.metrics = metrics
        metrics.label("comm_backend", self.backend_name)

    def set_events(self, events) -> None:
        """Share a flight recorder: ``mesh_reconfigure`` at every
        configure, ``error_latched`` on each latch edge, ``mesh_compile``
        (from the pool) at each plan build."""
        self._events = events
        self._pool.events = events

    def set_wire_members(self, members: "Sequence[str]") -> None:
        """Replica ids of the upcoming cohort in transport rank order (the
        Manager calls this before each ``configure``); ``rank{r}`` names
        without it."""
        self._wire_members = [str(m) for m in members]

    def set_domain_resolver(self, resolver: DomainTopology) -> None:
        """Install a resolver unless one was given to the constructor."""
        if self._domain_resolver is None:
            self._domain_resolver = resolver

    def _resolve_assignment(self) -> DomainAssignment:
        """This configure's domain assignment, resolved once: at configure
        for a hier-default context, at its first hier op otherwise."""
        if self._hier_assignment is not None:
            return self._hier_assignment
        members = self._configured_members
        if members is None:
            raise RuntimeError(
                "hier allreduce before configure: the cohort is unknown")
        if self._domain_resolver is None:
            self._domain_resolver = DomainTopology()
        self._hier_assignment = self._domain_resolver.assign(members)
        return self._hier_assignment

    def _resolved_algorithm(self, world_size: int) -> str:
        if self._algorithm == "auto":
            return "ring" if world_size >= 3 else "star"
        return self._algorithm

    def _resolved_hier_algorithm(self) -> str:
        """The hier composition: "psum" stays native, anything else
        (including "auto" at any world size) is the star fan-in."""
        return "psum" if self._algorithm == "psum" else "star"

    # ------------------------------------------------------------ lifecycle

    def configure(self, store_addr: str, rank: int, world_size: int) -> None:
        self.shutdown()
        with self._lock:
            self._generation += 1
            self._rank = rank
            self._world_size = world_size
            self._error = None
            self._seq = 0
            generation = self._generation
        with self._vote_lock:  # votes of the old membership prove nothing
            self._vote_ops = 0
            self._vote_unhealthy = False
        ev = self._events
        if world_size == 1:
            if ev:
                ev.emit("mesh_reconfigure", world_size=1,
                        generation=generation, solo=True)
            return  # solo: every op is an identity, no group needed
        # pin the cohort for domain resolution: eagerly for a hier default
        # (a live resolver pays its walk at the quorum boundary)
        members = self._wire_members
        self._configured_members = (
            members if members is not None and len(members) == world_size
            else [f"rank{r}" for r in range(world_size)])
        self._hier_assignment = None
        assignment = (self._resolve_assignment()
                      if self._topology_default == "hier" else None)
        # the store address is the cohort's rendezvous namespace: every
        # member of a transport cohort passes the same one
        group = _DeviceGroup.join(store_addr, rank, world_size, self,
                                  self._timeout)
        with self._lock:
            self._group = group
        if ev:
            ev.emit("mesh_reconfigure", world_size=world_size,
                    generation=generation,
                    algorithm=self._resolved_algorithm(world_size))
            if assignment is not None:
                ev.emit("hier_exchange", world=world_size,
                        domains=assignment.n_domains,
                        egress=list(assignment.egress),
                        domain=assignment.domains[rank],
                        is_egress=assignment.is_egress(rank),
                        fingerprint=assignment.fingerprint)

    def shutdown(self) -> None:
        with self._lock:
            group, self._group = self._group, None
        if group is not None:
            group.leave(self)

    def errored(self) -> Optional[Exception]:
        with self._lock:
            return self._error

    def _latch_group_error(self, group: _DeviceGroup, e: Exception) -> None:
        """Latch only while this context still belongs to ``group``: a
        stale group's timer or executor firing after a reconfigure must
        not poison the new quorum epoch's first op."""
        with self._lock:
            first = self._group is group and self._error is None
            if first:
                self._error = e
        ev = self._events
        if first and ev:
            ev.emit("error_latched", source="cuda", error=repr(e)[:200])

    # ------------------------------------------- data-plane commit votes
    # The TCP wire's surface and window semantics: a voted op proves every
    # cohort member reached the step's collective and reported healthy. On
    # this plane the evidence is the group rendezvous (_DeviceGroup._execute).

    def set_vote_health(self, fn) -> None:
        """Install the local health provider (``fn() -> bool``, True =
        healthy) sampled when each gradient op is submitted."""
        self._vote_health = fn

    def _vote_health_bit(self) -> int:
        """This rank's vote bit: 1 = unhealthy. A latched error always
        votes unhealthy; so does a provider that raises."""
        if self.errored() is not None:
            return 1
        fn = self._vote_health
        if fn is None:
            return 0
        try:
            return 0 if fn() else 1
        except Exception:  # noqa: BLE001 — a broken provider is unhealthy
            return 1

    def _record_vote(self, bit: int) -> None:
        with self._vote_lock:
            self._vote_ops += 1
            if bit & 1:
                self._vote_unhealthy = True

    def take_commit_vote(self) -> "Optional[bool]":
        """Aggregate of the votes recorded since the last call: True (at
        least one voted op, every member healthy on each), False (any
        dissent), None (no voted op completed: the caller runs the full
        commit barrier)."""
        with self._vote_lock:
            ops, bad = self._vote_ops, self._vote_unhealthy
            self._vote_ops = 0
            self._vote_unhealthy = False
        if ops == 0:
            return None
        return not bad

    # ------------------------------------------------- wire introspection

    def wire_codec_name(self) -> str:
        return self._codec_name

    def wire_is_lossy(self) -> bool:
        return self._codec_name != "none"

    def wire_generation(self) -> int:
        with self._lock:
            return self._generation

    def wire_compensable(self) -> bool:
        """Role-aware like the host transport: a star PEER's contribution
        crosses the wire through the lossy codec (the root's stays raw;
        ring partial sums ride uncompressed), and on the quantized ``psum``
        path EVERY rank's contribution is phase-1 encoded. Hier: only an
        egress rank's domain sum is encoded, every egress on the psum
        composition and all but domain 0's on the star fan-in."""
        with self._lock:
            world, rank = self._world_size, self._rank
        if self._codec_name == "none" or world <= 1:
            return False
        if self._topology_default == "hier":
            a = self._hier_assignment
            if a is None or a.n_domains <= 1 or not a.is_egress(rank):
                return False
            return (self._resolved_hier_algorithm() == "psum"
                    or a.domain_index(rank) != 0)
        algo = self._resolved_algorithm(world)
        return (algo == "star" and rank != 0) or algo == "psum"

    def wire_roundtrip(self, src: np.ndarray, out: np.ndarray) -> None:
        """The host codec IS the device codec bit for bit, so the error
        feedback arena's roundtrip runs the numpy codec: no device work on
        the EF path."""
        if src.shape != out.shape or src.dtype != out.dtype:
            raise ValueError("wire_roundtrip: src/out layout mismatch")
        if not self.wire_compensable():
            np.copyto(out, src)
            return
        codec_roundtrip(self._codec, self._chunk_bytes, src, out)

    def wire_nbytes(self, a: np.ndarray) -> int:
        return codec_wire_nbytes(self._codec, self._chunk_bytes, a)

    def mesh_shape(self) -> Tuple[int, int]:
        """(replicas, model_shards): the wire world times the declared
        model-axis extent."""
        return (self.size(), self._model_shards)

    # ----------------------------------------------------------- collectives

    def _submit(self, opcode: str, arrays: Sequence[np.ndarray], op: str,
                root: int,
                owners: "Optional[Sequence[int]]" = None,
                topology: Optional[str] = None) -> Work:
        fut: Future = Future()
        fut.set_running_or_notify_cancel()
        err = self.errored()
        if err is not None:
            fut.set_exception(
                ConnectionError(f"comm context previously errored: {err}"))
            return Work(fut)
        prepared = [self._prepare(a) for a in arrays]
        with self._lock:
            world = self._world_size
            group = self._group
            if world > 1 and group is None:
                fut.set_exception(RuntimeError("comm context not configured"))
                return Work(fut)
            self._seq += 1
            seq = self._seq
        grad_op = opcode in ("allreduce", "reduce_scatter")
        if world == 1:
            if grad_op:
                # solo: the op's vote is this rank's own health, as on the
                # TCP wire's solo path
                self._record_vote(self._vote_health_bit())
            fut.set_result([prepared] if opcode == "allgather" else prepared)
            return Work(fut)
        if opcode == "reduce_scatter" and owners is None:
            owners = [i % world for i in range(len(prepared))]
        group.submit(
            self._rank, seq,
            _Sub(opcode, prepared, op, root, fut,
                 owners=None if owners is None else [int(o) for o in owners],
                 topology=topology,
                 vote=self._vote_health_bit() if grad_op else 0),
            self._timeout,
        )
        return Work(fut)

    def allreduce(self, arrays: Sequence[np.ndarray],
                  op: str = ReduceOp.SUM,
                  topology: Optional[str] = None) -> Work:
        """``topology`` overrides the default path for this op; under a
        lossy codec it may not differ from the default (the error-feedback
        roles follow the default), as on the TCP wire."""
        if (topology is not None and topology != self._topology_default
                and self._codec_name != "none"):
            fut: Future = Future()
            fut.set_running_or_notify_cancel()
            fut.set_exception(ValueError(
                f"per-op topology={topology!r} differs from this context's "
                f"default {self._topology_default!r} under the lossy "
                f"{self._codec_name!r} codec: construct a context with "
                f"topology={topology!r} for this arm, or use "
                "compression='none' for a per-op A/B (the error-feedback "
                "roles follow the default topology)"
            ))
            return Work(fut)
        return self._submit("allreduce", arrays, op, 0, topology=topology)

    def reduce_scatter(self, arrays: Sequence[np.ndarray],
                       op: str = ReduceOp.SUM,
                       owners: "Optional[Sequence[int]]" = None) -> Work:
        """Reduce across ranks, delivering each array's result only to its
        owner (``owners[i]``, default ``i % world_size``); the other arrays
        are unspecified (donation contract). Parity algorithms reuse the
        allreduce plan; ``psum`` with one f32 array per rank, owned in rank
        order, takes the native scatter."""
        return self._submit("reduce_scatter", arrays, op, 0, owners=owners)

    def allgather(self, arrays: Sequence[np.ndarray]) -> Work:
        """Future resolves to a list of per-rank lists of arrays, fresh
        buffers for every receiving rank."""
        return self._submit("allgather", arrays, ReduceOp.SUM, 0)

    def broadcast(self, arrays: Sequence[np.ndarray], root: int = 0) -> Work:
        """Future resolves to copies of root's arrays on every rank."""
        return self._submit("broadcast", arrays, ReduceOp.SUM, root)
