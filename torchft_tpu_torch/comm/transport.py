"""TCP transport for cross-replica collectives.

Twin of ``torchft_tpu/comm/transport.py``, with byte-compatible frames, so
a rank of either package can join one cohort:

    configure(store_addr, rank, world_size):
        endpoints rendezvous through the store; "star" (rank 0 reduces and
        fans out) or "ring" (reduce-scatter + all-gather); "auto" picks
        ring at world size >= 3.

Opcodes: allreduce (1), allgather (2), broadcast (3) and
reduce_scatter (4), each frame as the reference frames it.

Collectives run on ``channels`` lanes, each with its own sockets and
worker thread. An allreduce or reduce_scatter payload is cut into a
deterministic chunk grid (contiguous <= ``chunk_bytes`` slices of each
flat view, in view order) and chunk c runs on lane ``(base + c) %
channels``, where ``base`` is the op's round-robin index: the same grid
and the same chunk -> lane map on every rank, so each lane's frame stream
stays ordered and a large bucket rides every lane at once. The star root
drains peers in rank order per chunk and the ring treats each chunk as an
independent payload, so the result is bitwise independent of striping.
allgather and broadcast carry self-describing array frames on the op's
round-robin lane, never compressed.

Codecs (``compression``): "none", "bf16", "fp16" or "int8" (one absmax
scale per grid chunk) on the gradient opcodes. The star root decodes each
peer's encoded chunk into its raw accumulator and fans the result out
encoded once, re-decoding its own bytes, so every rank holds identical
values; ring reduce-scatter hops carry raw partial sums and the
all-gather carries each part encoded once by its owner.

``topology="hier"`` builds the domain tier on top of the flat lanes
(``comm/topology.py`` names each replica's domain): reduce to the domain's
egress at full precision over a private intra star, exchange the domain
sums across domains through the egress ranks with the codec, broadcast
within the domain. Only egress ranks move encoded bytes across domains.

Zero copy: sends are ``sendmsg`` iovecs over the arrays themselves,
receives land in per-lane buffer pools via ``recv_into``, and payloads are
reduced straight into the caller's (donated) arrays. Reconfigure/shutdown
closes the sockets, which fails in-flight ops with ConnectionError; the
first error latches until the next ``configure``.

Each gradient frame carries the reference's one-byte health vote (0 =
healthy, 1 = this rank has latched an error or its Manager reports an
error), byte for byte. Every flat op records the aggregate vote it carried;
``take_commit_vote`` hands the window's verdict to the Manager's fast
path, which commits a leased step on it without the barrier RPC. A hier
op rides child contexts and records no vote (the barrier runs).
"""

from __future__ import annotations

import concurrent.futures
import logging
import queue
import select
import socket
import struct
import threading
import time
from concurrent.futures import Future
from datetime import timedelta
from typing import Dict, List, Optional, Sequence

import numpy as np

from torchft_tpu_torch.comm.context import CommContext, ReduceOp, Work
from torchft_tpu_torch.comm.store import create_store_client
from torchft_tpu_torch.comm.topology import DomainAssignment, DomainTopology
from torchft_tpu_torch.comm.wire import (
    IOV_MAX,
    as_bytes_view,
    iov_join,
    iov_nbytes,
    recv_exact,
    recv_into_exact,
    sendmsg_all,
)
from torchft_tpu_torch.utils.metrics import Metrics
from torchft_tpu_torch.utils.net import advertised_host

logger = logging.getLogger(__name__)

__all__ = [
    "TcpCommContext",
    "codec_decode_frame",
    "codec_encode_frame",
    "codec_roundtrip",
    "codec_wire_nbytes",
    "host_unsupported_reason",
    "make_wire_codec",
]

# the reference's opcodes, byte for byte
_OP_ALLREDUCE = 1
_OP_ALLGATHER = 2
_OP_BROADCAST = 3
_OP_REDUCE_SCATTER = 4

# opcodes on the chunk-striped gradient path (votes, codecs, comm_* timers)
_GRAD_OPCODES = (_OP_ALLREDUCE, _OP_REDUCE_SCATTER)

_REDUCE_FNS = {
    ReduceOp.SUM: lambda a, b: np.add(a, b, out=a),
    ReduceOp.MAX: lambda a, b: np.maximum(a, b, out=a),
    ReduceOp.MIN: lambda a, b: np.minimum(a, b, out=a),
}


def _duplex_exchange(tx_sock: socket.socket, tx_bufs: Sequence,
                     rx_sock: socket.socket, rx_targets,
                     timeout: float) -> None:
    """Stream ``tx_bufs`` (an iovec list) to ``tx_sock`` while filling the
    memoryviews yielded by the ``rx_targets`` generator from ``rx_sock``,
    interleaved via select on one thread: receives always drain, so the
    peer's sends always progress and neither side can deadlock on full
    socket buffers. ``rx_targets`` may size each next buffer lazily (parse a
    header first); the two sockets may be one (star peer)."""
    mvs = [mv for mv in (as_bytes_view(b) for b in tx_bufs) if len(mv)]
    rx_mv: Optional[memoryview] = None
    rx_off = 0

    def _advance_rx() -> None:
        nonlocal rx_mv, rx_off
        rx_off = 0
        rx_mv = next(rx_targets, None)
        while rx_mv is not None and len(rx_mv) == 0:
            rx_mv = next(rx_targets, None)

    _advance_rx()
    if not mvs and rx_mv is None:
        return
    # Idle deadline, extended on every byte of progress: a slow link that
    # keeps moving data must not fail a large exchange.
    deadline = time.perf_counter() + timeout
    socks = {tx_sock, rx_sock}
    for s in socks:
        s.setblocking(False)
    try:
        # Interleave only while there is still something to send; then
        # finish with plain blocking receives (fewer wakeups).
        while mvs:
            now = time.perf_counter()
            if now > deadline:
                raise TimeoutError("duplex exchange stalled")
            rlist = [rx_sock] if rx_mv is not None else []
            r, w, _ = select.select(
                rlist, [tx_sock], [], min(1.0, deadline - now)
            )
            if w:
                while mvs:
                    try:
                        sent = tx_sock.sendmsg(mvs[:IOV_MAX])
                    except (BlockingIOError, InterruptedError):
                        break
                    if sent == 0:
                        raise ConnectionError(
                            "comm transport connection closed"
                        )
                    deadline = time.perf_counter() + timeout
                    while sent and mvs:
                        if sent >= len(mvs[0]):
                            sent -= len(mvs[0])
                            mvs.pop(0)
                        else:
                            mvs[0] = mvs[0][sent:]
                            sent = 0
            if r:
                while rx_mv is not None:
                    try:
                        n = rx_sock.recv_into(
                            rx_mv[rx_off:],
                            min(len(rx_mv) - rx_off, 1 << 20),
                        )
                    except (BlockingIOError, InterruptedError):
                        break
                    if n == 0:
                        raise ConnectionError(
                            "comm transport connection closed"
                        )
                    deadline = time.perf_counter() + timeout
                    rx_off += n
                    if rx_off == len(rx_mv):
                        _advance_rx()
        rx_sock.settimeout(timeout)
        while rx_mv is not None:
            recv_into_exact(rx_sock, rx_mv[rx_off:])
            _advance_rx()
    finally:
        for s in socks:
            s.settimeout(timeout)


class _RecvBufs:
    """Per-lane receive buffers, step-persistent and sized to the largest
    frame seen. Payloads rotate across two slots so the ring can forward
    the previous frame while the next one streams in; a returned view is
    valid until two more payload receives."""

    def __init__(self) -> None:
        self._hdr = bytearray(4096)
        self._slots = [bytearray(), bytearray()]
        self._i = 0

    def header_slot(self, n: int) -> memoryview:
        if n > len(self._hdr):
            raise ConnectionError(
                f"oversized frame metadata ({n} bytes) — corrupt or "
                "desynced stream"
            )
        return memoryview(self._hdr)[:n]

    def recv_header(self, sock: socket.socket, n: int) -> memoryview:
        mv = self.header_slot(n)
        recv_into_exact(sock, mv)
        return mv

    def payload_slot(self, n: int) -> memoryview:
        self._i ^= 1
        if len(self._slots[self._i]) < n:
            self._slots[self._i] = bytearray(n)
        return memoryview(self._slots[self._i])[:n]

    def recv_payload(self, sock: socket.socket, n: int) -> memoryview:
        if n == 0:
            return memoryview(b"")
        mv = self.payload_slot(n)
        recv_into_exact(sock, mv)
        return mv


def _dtype_tag(d: np.dtype) -> bytes:
    """Wire tag of a dtype in an array frame: its ``str``, or the
    registered name for extension dtypes that stringify to a void type
    (ml_dtypes' bfloat16)."""
    if d.str.lstrip("<>|=").startswith("V"):
        return d.name.encode()
    return d.str.encode()


def _dtype_from_tag(tag: str) -> np.dtype:
    try:
        d = np.dtype(tag)
        if not d.str.lstrip("<>|=").startswith("V"):
            return d
    except TypeError:
        pass
    try:
        import ml_dtypes
    except ImportError:
        raise ConnectionError(
            f"array frame carries dtype {tag!r}, which needs the "
            "ml_dtypes package to decode"
        ) from None
    return np.dtype(getattr(ml_dtypes, tag))


def _array_frame_iovecs(arrays: Sequence[np.ndarray]) -> List:
    """The reference's self-describing array frame as an iovec list:
    [count u32], then per array [tag len u16][tag][ndim u8][shape
    i64 x ndim][nbytes u64][body]; metadata in small buffers, bodies as
    the arrays themselves."""
    iov: List = []
    meta = bytearray(struct.pack("<I", len(arrays)))
    for a in arrays:
        a = np.ascontiguousarray(a)
        dt = _dtype_tag(a.dtype)
        meta += struct.pack("<H", len(dt))
        meta += dt
        meta += struct.pack("<B", a.ndim)
        if a.ndim:
            meta += struct.pack(f"<{a.ndim}q", *a.shape)
        meta += struct.pack("<Q", a.nbytes)
        iov.append(bytes(meta))
        meta = bytearray()
        iov.append(a)
    if meta:
        iov.append(bytes(meta))
    return iov


def _send_arrays(sock: socket.socket, arrays: Sequence[np.ndarray]) -> None:
    sendmsg_all(sock, _array_frame_iovecs(arrays))


def _unpack_arrays(data) -> List[np.ndarray]:
    """Decode an array frame from any buffer; the arrays own their
    memory."""
    data = memoryview(data)
    offset = 0

    def take(n: int) -> memoryview:
        nonlocal offset
        out = data[offset: offset + n]
        if len(out) != n:
            raise ConnectionError("truncated array frame")
        offset += n
        return out

    (count,) = struct.unpack("<I", take(4))
    out: List[np.ndarray] = []
    for _ in range(count):
        (dlen,) = struct.unpack("<H", take(2))
        dtype = _dtype_from_tag(bytes(take(dlen)).decode())
        (ndim,) = struct.unpack("<B", take(1))
        shape = struct.unpack(f"<{ndim}q", take(8 * ndim)) if ndim else ()
        (nbytes,) = struct.unpack("<Q", take(8))
        out.append(
            np.frombuffer(take(nbytes), dtype=dtype).reshape(shape).copy()
        )
    return out


def _recv_arrays(sock: socket.socket,
                 bufs: "Optional[_RecvBufs]" = None) -> List[np.ndarray]:
    """Streaming reader of an array frame: each body lands in the lane's
    pooled buffer and is copied once into an owned array."""
    bufs = bufs if bufs is not None else _RecvBufs()
    (n,) = struct.unpack("<I", bufs.recv_header(sock, 4))
    out: List[np.ndarray] = []
    for _ in range(n):
        (dlen,) = struct.unpack("<H", bufs.recv_header(sock, 2))
        dtype = _dtype_from_tag(bytes(bufs.recv_header(sock, dlen)).decode())
        (ndim,) = struct.unpack("<B", bufs.recv_header(sock, 1))
        shape = (struct.unpack(f"<{ndim}q", bufs.recv_header(sock, 8 * ndim))
                 if ndim else ())
        (nbytes,) = struct.unpack("<Q", bufs.recv_header(sock, 8))
        body = bufs.recv_payload(sock, nbytes)
        out.append(np.frombuffer(body, dtype=dtype).reshape(shape).copy())
    return out


def _decode_into(data, views: Sequence[np.ndarray], combine) -> None:
    """Combine the raw wire bytes of ``views`` (back to back) into them."""
    offset = 0
    for v in views:
        nb = v.nbytes
        combine(v, np.frombuffer(data[offset: offset + nb], dtype=v.dtype))
        offset += nb


def _copy(v: np.ndarray, incoming: np.ndarray) -> None:
    np.copyto(v, incoming)


def _chunk_grid(flats: Sequence[np.ndarray],
                chunk_bytes: int) -> List[np.ndarray]:
    """Deterministic chunk grid over the op's flat views: each view split,
    in view order, into contiguous slices of at most ``chunk_bytes`` (at
    least one element); empty views contribute nothing. Built from shapes
    and dtypes only, so every rank computes the identical grid."""
    return _chunk_grid_owned(flats, None, chunk_bytes)[0]


def _chunk_grid_owned(
    flats: Sequence[np.ndarray], owners: "Optional[Sequence[int]]",
    chunk_bytes: int,
) -> "tuple[List[np.ndarray], Optional[List[int]]]":
    """:func:`_chunk_grid` plus a parallel per-chunk owner list: the chunk
    views of ``flats[i]`` inherit ``owners[i]`` (the reduce_scatter
    destination); ``owners=None`` returns ``(chunks, None)``. One step rule
    for both opcodes, so a reduce_scatter computes the allreduce's grid and
    int8 scales."""
    chunks: List[np.ndarray] = []
    chunk_owners: "Optional[List[int]]" = None if owners is None else []
    for vi, f in enumerate(flats):
        if f.size == 0:
            continue
        if chunk_bytes <= 0:
            view_chunks = [f]
        else:
            step = max(1, chunk_bytes // f.dtype.itemsize)
            view_chunks = [f[s: s + step] for s in range(0, f.size, step)]
        chunks.extend(view_chunks)
        if chunk_owners is not None:
            chunk_owners.extend([int(owners[vi])] * len(view_chunks))
    return chunks, chunk_owners


def _chunk_bounds(total: int, n: int, c: int) -> "tuple[int, int]":
    """Element bounds of rank-part ``c`` when ``total`` is split into n
    near-equal parts, the first ``total % n`` one element longer (the
    ring's reduce-scatter split)."""
    base, extra = divmod(total, n)
    start = c * base + min(c, extra)
    return start, start + base + (1 if c < extra else 0)


# --------------------------------------------------------------- compression
# Wire codecs for the gradient opcodes, twins of the reference's: bf16/fp16
# downcast, int8 with one absmax scale per chunk of the grid. Plain numpy
# (bf16 through torch, which numpy lacks). The star fan-out and the ring
# all-gather forward the same encoded bytes to every rank, so all ranks
# decode identical values. They are also the host image of the wire and
# the bitwise oracle of the on-device plane (comm/cuda_backend.py).


def _is_compressible(a: np.ndarray) -> bool:
    return a.dtype in (np.float32, np.float64)


class _NoCodec:
    name = "none"

    # flat-view interface: encode_iovecs for the send side, decode_into for
    # the in-place receive side, wire_nbytes for size validation
    def wire_nbytes(self, v: np.ndarray) -> int:
        return v.nbytes

    def encode_iovecs(self, views: Sequence[np.ndarray]) -> List:
        """Encoded payload as an iovec list; the identity codec returns the
        views themselves (zero copy)."""
        return list(views)

    def decode_into(self, data: bytes, views: Sequence[np.ndarray],
                    combine) -> None:
        _decode_into(data, views, combine)


# torch is imported by the bf16 codec alone, so a process that runs this
# wire without it (comm/subproc.py's child) starts in well under a second


def _to_bf16_bits(v: np.ndarray) -> np.ndarray:
    import torch

    return (torch.from_numpy(np.ascontiguousarray(v)).to(torch.bfloat16)
            .view(torch.int16).numpy())


def _from_bf16_bits(bits: np.ndarray, dtype: np.dtype) -> np.ndarray:
    import torch

    t = torch.from_numpy(np.array(bits, dtype=np.int16)).view(torch.bfloat16)
    return t.to(torch.float64 if dtype == np.float64
                else torch.float32).numpy()


class _AstypeCodec(_NoCodec):
    """Lossy float downcast on the wire (bf16 / fp16, round to nearest
    even); non-float arrays pass through untouched."""

    def __init__(self, name: str) -> None:
        self.name = name
        self._wd = np.dtype(np.int16 if name == "bf16" else np.float16)

    def _encode(self, v: np.ndarray) -> np.ndarray:
        return _to_bf16_bits(v) if self.name == "bf16" \
            else v.astype(np.float16)

    def _decode(self, wire: np.ndarray, dtype: np.dtype) -> np.ndarray:
        return _from_bf16_bits(wire, dtype) if self.name == "bf16" \
            else wire.astype(dtype)

    def wire_nbytes(self, v: np.ndarray) -> int:
        if _is_compressible(v):
            return v.size * self._wd.itemsize
        return v.nbytes

    def encode_iovecs(self, views):
        return [self._encode(v) if _is_compressible(v) else v for v in views]

    def decode_into(self, data, views, combine):
        offset = 0
        for v in views:
            if _is_compressible(v):
                nb = v.size * self._wd.itemsize
                incoming = self._decode(
                    np.frombuffer(data[offset: offset + nb], dtype=self._wd),
                    v.dtype)
            else:
                nb = v.nbytes
                incoming = np.frombuffer(data[offset: offset + nb],
                                         dtype=v.dtype)
            combine(v, incoming)
            offset += nb


class _Int8Codec(_NoCodec):
    """Per-chunk absmax int8 quantization: wire = [scale f32][int8
    payload]. Max abs error per element is scale/2 = absmax/254."""

    name = "int8"

    @staticmethod
    def _quantize(a: np.ndarray) -> "tuple[np.float32, np.ndarray]":
        absmax = float(np.max(np.abs(a))) if a.size else 0.0
        if not np.isfinite(absmax):
            # a NaN scale poisons the chunk (its decode is NaN everywhere)
            # instead of clipping Inf/NaN into plausible values
            return np.float32("nan"), np.zeros(a.shape, np.int8)
        scale = np.float32(absmax / 127.0 if absmax > 0 else 1.0)
        q = np.clip(np.rint(a / scale), -127, 127).astype(np.int8)
        return scale, q

    def wire_nbytes(self, v: np.ndarray) -> int:
        if _is_compressible(v):
            return 4 + v.size
        return v.nbytes

    def encode_iovecs(self, views):
        parts: List = []
        for v in views:
            if _is_compressible(v):
                scale, q = self._quantize(v)
                parts.append(np.float32(scale).tobytes())
                parts.append(q)
            else:
                parts.append(v)
        return parts

    def decode_into(self, data, views, combine):
        offset = 0
        for v in views:
            if _is_compressible(v):
                scale = np.frombuffer(data[offset: offset + 4],
                                      dtype=np.float32)[0]
                q = np.frombuffer(data[offset + 4: offset + 4 + v.size],
                                  dtype=np.int8)
                incoming = q.astype(v.dtype) * v.dtype.type(scale)
                offset += 4 + v.size
            else:
                incoming = np.frombuffer(data[offset: offset + v.nbytes],
                                         dtype=v.dtype)
                offset += v.nbytes
            combine(v, incoming)


_CODECS = {
    "none": _NoCodec,
    "bf16": lambda: _AstypeCodec("bf16"),
    "fp16": lambda: _AstypeCodec("fp16"),
    "int8": _Int8Codec,
}

# the identity codec of every ring reduce-scatter phase
_NO_CODEC = _NoCodec()


def make_wire_codec(name: str):
    """A standalone wire codec by name ("none" / "bf16" / "fp16" /
    "int8"). Codecs are stateless."""
    try:
        return _CODECS[name]()
    except KeyError:
        raise ValueError(
            f"unknown wire codec {name!r}; have {sorted(_CODECS)}"
        ) from None


def codec_roundtrip(codec, chunk_bytes: int, src: np.ndarray,
                    out: np.ndarray) -> None:
    """Write decode(encode(src)) into ``out``, chunked exactly as one
    allreduce contribution over the grid: the wire's local image, which
    error feedback computes its residual against."""
    src_chunks = _chunk_grid([src.reshape(-1)], chunk_bytes)
    out_chunks = _chunk_grid([out.reshape(-1)], chunk_bytes)
    for ch_s, ch_o in zip(src_chunks, out_chunks):
        codec.decode_into(iov_join(codec.encode_iovecs([ch_s])), [ch_o],
                          _copy)


def codec_encode_frame(codec, flat: np.ndarray) -> bytes:
    """Encode one whole flat array as a single wire-frame payload: the
    point-to-point frame surface (the pipeline plane's activation and
    gradient hops), where a tensor travels un-chunked, one frame, one
    codec image. The allreduce planes keep their chunk-grid encoding
    (:func:`codec_roundtrip`); the two must not be mixed, because the int8
    codec's per-chunk scale makes the images differ."""
    return iov_join(codec.encode_iovecs([np.ascontiguousarray(flat)]))


def codec_decode_frame(codec, data: bytes, out: np.ndarray) -> None:
    """Decode one :func:`codec_encode_frame` payload into ``out`` in place
    (plain copy combine). Callers that need the wire's local image for
    error feedback decode their own encoded bytes through this, so
    residuals stay bit-identical on both ends of the hop."""
    codec.decode_into(data, [out], _copy)


def codec_wire_nbytes(codec, chunk_bytes: int, a: np.ndarray) -> int:
    """Encoded size of ``a`` as one allreduce contribution: the codec's
    per-chunk wire size summed over the grid (int8 carries a scale per
    chunk). Size arithmetic only."""
    a = np.asarray(a)
    return sum(codec.wire_nbytes(ch)
               for ch in _chunk_grid([a.reshape(-1)], chunk_bytes))


def host_unsupported_reason(algorithm: str, compression: str,
                            op: str = ReduceOp.SUM,
                            topology: str = "flat") -> "Optional[str]":
    """The reference's host-plane capability rule: every codec on
    star/ring/auto for every reduce op, on the flat tier and on the
    hierarchical one (``topology="hier"``: the intra tier is always a
    full-precision star, ``algorithm`` picks the cross-domain wire);
    ``psum`` is the on-device path and does not exist on sockets."""
    if algorithm == "psum":
        return (
            "algorithm='psum' is the on-device hardware-native path "
            "(comm_backend='cuda', comm/cuda_backend.py); the host socket "
            "transport has no psum — use algorithm='star'/'ring'/'auto' "
            "here, or select the cuda backend"
        )
    if algorithm not in ("auto", "star", "ring"):
        return f"unknown algorithm {algorithm!r}"
    if compression not in _CODECS:
        return (
            f"unknown compression {compression!r}; have {sorted(_CODECS)}"
        )
    if topology not in ("flat", "hier"):
        return (
            f"unknown topology {topology!r}; have 'flat' (one tier "
            "spanning the wire) and 'hier' (domain tree: reduce-within "
            "-> compress -> exchange-across -> broadcast-within)"
        )
    return None


class _OpState:
    """Completion state shared by one striped op's per-lane sub-ops: the
    last lane to finish resolves the caller's future with the donated
    arrays (reduced in place across all lanes' disjoint chunks) and
    observes the op's submit-to-completion time as ``comm_op_wire``."""

    __slots__ = ("arrays", "fut", "_remaining", "_lock", "metrics",
                 "t_submit")

    def __init__(self, arrays: List[np.ndarray], fut: Future,
                 n_subops: int, metrics: "Optional[Metrics]" = None) -> None:
        self.arrays = arrays
        self.fut = fut
        self._remaining = n_subops
        self._lock = threading.Lock()
        self.metrics = metrics
        self.t_submit = time.perf_counter()

    def subop_done(self) -> bool:
        with self._lock:
            self._remaining -= 1
            done = self._remaining == 0
        if done and self.metrics is not None:
            self.metrics.observe("comm_op_wire",
                                 time.perf_counter() - self.t_submit)
        return done


class _PendingOp:
    __slots__ = ("opcode", "arrays", "op", "root", "fut", "chunks", "state",
                 "owners", "t_submit")

    def __init__(self, opcode: int, arrays: List[np.ndarray], op: str,
                 root: int, fut: Future,
                 chunks: "Optional[List[np.ndarray]]" = None,
                 state: "Optional[_OpState]" = None,
                 owners: "Optional[List[int]]" = None) -> None:
        self.opcode = opcode
        self.arrays = arrays
        self.op = op
        self.root = root
        self.fut = fut
        self.chunks = chunks  # this lane's chunk views (gradient opcodes)
        self.state = state    # shared across the op's sub-ops
        self.owners = owners  # reduce_scatter: destination rank per chunk
        self.t_submit = time.perf_counter()


def _reduce_fn(op: str):
    fn = _REDUCE_FNS.get(ReduceOp.SUM if op == ReduceOp.AVG else op)
    if fn is None:
        raise ValueError(f"unsupported reduce op: {op}")
    return fn


class _Lane:
    """One connection set + worker thread. Every lane sees the same
    deterministic subsequence of ops on every rank."""

    # ring frame header: opcode, seq, step, payload bytes, vote
    _RING_HDR = struct.Struct("<BQHQB")

    def __init__(self, ctx: "TcpCommContext", lane_id: int) -> None:
        self._ctx = ctx
        self._lane_id = lane_id
        self._queue: "queue.Queue[Optional[_PendingOp]]" = queue.Queue()
        self._thread: Optional[threading.Thread] = None
        self._seq = 0
        self._bufs = _RecvBufs()
        self._peer_socks: Dict[int, socket.socket] = {}   # star: root only
        self._root_sock: Optional[socket.socket] = None   # star: non-root
        self._next_sock: Optional[socket.socket] = None   # ring
        self._prev_sock: Optional[socket.socket] = None   # ring

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._run_loop,
            name=f"torchft_tpu_torch_comm_l{self._lane_id}",
            daemon=True,
        )
        self._thread.start()

    def close_sockets(self) -> None:
        socks = list(self._peer_socks.values()) + [
            self._next_sock, self._prev_sock, self._root_sock,
        ]
        for s in socks:
            if s is not None:
                try:
                    s.close()
                except OSError:
                    pass
        self._peer_socks = {}
        self._next_sock = self._prev_sock = self._root_sock = None

    def _run_loop(self) -> None:
        metrics = self._ctx.metrics
        while True:
            pending = self._queue.get()
            if pending is None:
                return
            t_deq = time.perf_counter()
            try:
                result = self._execute(pending)
                if pending.opcode in _GRAD_OPCODES:
                    metrics.observe("comm_submit_wire",
                                    t_deq - pending.t_submit)
                    metrics.observe("comm_wire_reduce",
                                    time.perf_counter() - t_deq)
                state = pending.state
                if state is None:
                    pending.fut.set_result(result)
                elif state.subop_done():
                    try:
                        state.fut.set_result(state.arrays)
                    except Exception:
                        pass  # a sibling lane already failed the op
            except Exception as e:  # noqa: BLE001 — latch every transport error
                self._ctx._latch_error(e)
                logger.warning(
                    "comm op failed (rank %d world %d lane %d): %r",
                    self._ctx._rank, self._ctx._world_size, self._lane_id, e,
                )
                try:
                    pending.fut.set_exception(e)
                except Exception:
                    pass

    def _execute(self, p: _PendingOp):
        self._seq += 1
        ctx = self._ctx
        if ctx._world_size == 1:
            if p.opcode in _GRAD_OPCODES:
                # solo wire: the op's vote is this rank's own health, the
                # degenerate (but present) evidence the fast path consumes
                ctx._record_vote(ctx._vote_health_bit())
            return [p.arrays] if p.opcode == _OP_ALLGATHER else p.arrays
        if p.opcode in _GRAD_OPCODES:
            if ctx._use_ring:
                self._ring_allreduce(p)
            elif ctx._rank == 0:
                self._star_root(p)
            else:
                self._star_peer(p)
            return p.arrays
        if ctx._use_ring:
            return self._execute_ring(p)
        if ctx._rank == 0:
            return self._execute_root(p)
        return self._execute_peer(p)

    def _check_header(self, peer_rank: int, sock: socket.socket,
                      opcode: int) -> int:
        """Validate one peer -> root header [opcode u8][seq u64][vote u8]
        and return the vote bit (always 0 off the gradient opcodes)."""
        r_op, r_seq, r_vote = struct.unpack(
            "<BQB", self._bufs.recv_header(sock, 10)
        )
        if r_op != opcode or r_seq != self._seq:
            raise ConnectionError(
                f"collective mismatch from rank {peer_rank}: got "
                f"op={r_op} seq={r_seq}, expected op={opcode} "
                f"seq={self._seq}"
            )
        return r_vote & 1

    # ------------------------------------------------------------- star
    # Gradient opcodes. peer -> root: [opcode u8][seq u64][vote u8], then
    # per chunk [nbytes u64] + the codec's encoding of the chunk. root ->
    # peer: per chunk [nbytes u64] + the encoded result, then one
    # aggregate vote byte. Peers are drained in rank order per chunk, so
    # the float result is the sequential r = 1..n-1 reduction whatever the
    # grid or striping. reduce_scatter shares the upload and the reduce;
    # the root sends each completed chunk to its owner alone.

    def _star_root(self, p: _PendingOp) -> None:
        ctx = self._ctx
        codec = ctx._codec
        reduce_fn = _reduce_fn(p.op)
        peers = sorted(self._peer_socks.items())
        peer_socks = dict(peers)
        vote = ctx._vote_health_bit()
        for peer_rank, sock in peers:
            vote |= self._check_header(peer_rank, sock, p.opcode)
        lossy = type(codec) is not _NoCodec
        owners = p.owners if p.opcode == _OP_REDUCE_SCATTER else None
        for c, ch in enumerate(p.chunks):
            expected = codec.wire_nbytes(ch)
            for peer_rank, sock in peers:
                (nbytes,) = struct.unpack("<Q", self._bufs.recv_header(sock, 8))
                if nbytes != expected:
                    raise ConnectionError(
                        f"allreduce chunk size mismatch from rank "
                        f"{peer_rank}: {nbytes} != {expected} (divergent "
                        "shapes or chunk_bytes?)"
                    )
                codec.decode_into(self._bufs.recv_payload(sock, nbytes),
                                  [ch], reduce_fn)
            if p.op == ReduceOp.AVG:
                np.divide(ch, ctx._world_size, out=ch)
            enc = codec.encode_iovecs([ch])
            if owners is None:
                frame = [struct.pack("<Q", iov_nbytes(enc)), *enc]
                for _, sock in peers:
                    sendmsg_all(sock, frame)
            elif owners[c] != 0:
                sendmsg_all(peer_socks[owners[c]],
                            [struct.pack("<Q", iov_nbytes(enc)), *enc])
                continue
            if lossy:
                # the root keeps what its peers decode
                codec.decode_into(iov_join(enc), [ch], _copy)
        for _, sock in peers:
            sendmsg_all(sock, [struct.pack("<B", vote)])
        ctx._record_vote(vote)

    def _star_peer(self, p: _PendingOp) -> None:
        ctx = self._ctx
        codec = ctx._codec
        sock = self._root_sock
        assert sock is not None
        if p.opcode == _OP_REDUCE_SCATTER:
            rx_chunks = [ch for ch, o in zip(p.chunks, p.owners)
                         if o == ctx._rank]
        else:
            rx_chunks = p.chunks
        tx: List = [struct.pack("<BQB", p.opcode, self._seq,
                                ctx._vote_health_bit())]
        for ch in p.chunks:
            enc = codec.encode_iovecs([ch])
            tx.append(struct.pack("<Q", iov_nbytes(enc)))
            tx.extend(enc)

        def _rx_targets():
            for ch in rx_chunks:
                expected = codec.wire_nbytes(ch)
                len_mv = self._bufs.header_slot(8)
                yield len_mv
                (nbytes,) = struct.unpack("<Q", len_mv)
                if nbytes != expected:
                    raise ConnectionError(
                        f"allreduce reply chunk size mismatch: {nbytes} "
                        f"!= {expected} (divergent shapes or chunk_bytes?)"
                    )
                payload = self._bufs.payload_slot(nbytes)
                yield payload
                codec.decode_into(payload, [ch], _copy)
            vote_mv = self._bufs.header_slot(1)  # the root's aggregate vote
            yield vote_mv
            ctx._record_vote(vote_mv[0])

        _duplex_exchange(sock, tx, sock, _rx_targets(), ctx._timeout)

    # allgather / broadcast, star: peer -> root [opcode][seq][0] + an array
    # frame (empty for a non-root broadcast contribution); root -> peer one
    # array frame (allgather: [world, n_0, arrays_0..., n_1, ...] flat).

    def _execute_root(self, p: _PendingOp):
        world = self._ctx._world_size
        peers = sorted(self._peer_socks.items())
        contributions: Dict[int, List[np.ndarray]] = {0: p.arrays}
        for peer_rank, sock in peers:
            self._check_header(peer_rank, sock, p.opcode)
            contributions[peer_rank] = _recv_arrays(sock, self._bufs)
        if p.opcode == _OP_ALLGATHER:
            gathered = [contributions[r] for r in range(world)]
            flat: List[np.ndarray] = [np.asarray(world, dtype=np.int64)]
            for per_rank in gathered:
                flat.append(np.asarray(len(per_rank), dtype=np.int64))
                flat.extend(per_rank)
            for _, sock in peers:
                _send_arrays(sock, flat)
            return gathered
        if p.opcode == _OP_BROADCAST:
            src = contributions[p.root]
            for _, sock in peers:
                _send_arrays(sock, src)
            return [a.copy() for a in src]
        raise ValueError(f"unknown opcode {p.opcode}")

    def _execute_peer(self, p: _PendingOp):
        sock = self._root_sock
        assert sock is not None
        body = ([] if p.opcode == _OP_BROADCAST and self._ctx._rank != p.root
                else p.arrays)
        sendmsg_all(sock, [struct.pack("<BQB", p.opcode, self._seq, 0),
                           *_array_frame_iovecs(body)])
        result = _recv_arrays(sock, self._bufs)
        if p.opcode != _OP_ALLGATHER:
            return result
        idx, world = 1, int(result[0])
        gathered: List[List[np.ndarray]] = []
        for _ in range(world):
            n = int(result[idx])
            gathered.append(result[idx + 1: idx + 1 + n])
            idx += 1 + n
        return gathered

    # ------------------------------------------------------------- ring

    def _ring_sendrecv(self, opcode: int, step: int, bufs: Sequence,
                       nbytes: int, vote: int = 0
                       ) -> "tuple[memoryview, int]":
        """Full-duplex hop: push to next while pulling from prev. Every
        frame carries [opcode][seq][step][nbytes][vote] and is validated, so
        a desynced collective fails fast instead of reducing misaligned
        bytes. The received payload stays valid through one more hop."""
        hdr = self._RING_HDR
        header = hdr.pack(opcode, self._seq, step, nbytes, vote)
        out: List[memoryview] = []
        rvotes: List[int] = []

        def _rx_targets():
            hdr_mv = self._bufs.header_slot(hdr.size)
            yield hdr_mv
            r_op, r_seq, r_step, r_len, r_vote = hdr.unpack(hdr_mv)
            if (r_op, r_seq, r_step) != (opcode, self._seq, step):
                raise ConnectionError(
                    f"ring collective mismatch: got op={r_op} seq={r_seq} "
                    f"step={r_step}, expected op={opcode} "
                    f"seq={self._seq} step={step}"
                )
            rvotes.append(r_vote & 1)
            if r_len == 0:
                out.append(memoryview(b""))
                return
            payload = self._bufs.payload_slot(r_len)
            out.append(payload)
            yield payload

        _duplex_exchange(self._next_sock, [header, *bufs], self._prev_sock,
                         _rx_targets(), self._ctx._timeout)
        return out[0], rvotes[0]

    def _execute_ring(self, p: _PendingOp):
        n, r = self._ctx._world_size, self._ctx._rank
        hdr = self._RING_HDR
        if p.opcode == _OP_BROADCAST:
            # the whole frame travels around the ring from the root
            if r == p.root:
                iov = _array_frame_iovecs(p.arrays)
                sendmsg_all(self._next_sock, [
                    hdr.pack(_OP_BROADCAST, self._seq, 0, iov_nbytes(iov), 0),
                    *iov,
                ])
                return [np.array(a, copy=True) for a in p.arrays]
            r_op, r_seq, _, r_len, _ = hdr.unpack(
                self._bufs.recv_header(self._prev_sock, hdr.size)
            )
            if (r_op, r_seq) != (_OP_BROADCAST, self._seq):
                raise ConnectionError(
                    f"ring broadcast mismatch: got op={r_op} seq={r_seq}, "
                    f"expected op={_OP_BROADCAST} seq={self._seq}"
                )
            payload = self._bufs.recv_payload(self._prev_sock, r_len)
            if (r + 1) % n != p.root:
                sendmsg_all(self._next_sock, [
                    hdr.pack(_OP_BROADCAST, self._seq, 0, r_len, 0), payload,
                ])
            return _unpack_arrays(payload)
        if p.opcode == _OP_ALLGATHER:
            # rotate the contributions n-1 times, slotted by source rank
            gathered: List[Optional[List[np.ndarray]]] = [None] * n
            gathered[r] = [np.array(a, copy=True) for a in p.arrays]
            carry: List = _array_frame_iovecs(gathered[r])
            carry_len = iov_nbytes(carry)
            for step in range(n - 1):
                data, _ = self._ring_sendrecv(_OP_ALLGATHER, step, carry,
                                              carry_len)
                gathered[(r - step - 1) % n] = _unpack_arrays(data)
                carry, carry_len = [data], len(data)
            return gathered
        raise ValueError(f"unknown opcode {p.opcode}")

    @staticmethod
    def _part_views(flats: Sequence[np.ndarray], n: int,
                    c: int) -> List[np.ndarray]:
        """Rank-part ``c`` of every chunk: ``size`` split into n near-equal
        parts, the first ``size % n`` one element longer."""
        views = []
        for f in flats:
            start, end = _chunk_bounds(f.size, n, c)
            views.append(f[start: end])
        return views

    @staticmethod
    def _expect_len(codec, views: Sequence[np.ndarray]) -> int:
        return sum(codec.wire_nbytes(v) for v in views)

    @staticmethod
    def _decode_filtered(codec, data, views: List[np.ndarray],
                         owned: "Optional[List[bool]]", combine) -> None:
        """Decode ``data`` into the ``views`` whose ``owned`` flag is set
        (all of them when ``owned`` is None); byte offsets advance over
        the others."""
        if owned is None:
            codec.decode_into(data, views, combine)
            return
        data = memoryview(data)
        offset = 0
        for v, own in zip(views, owned):
            nb = codec.wire_nbytes(v)
            if own:
                codec.decode_into(data[offset: offset + nb], [v], combine)
            offset += nb

    def _ring_allreduce(self, p: _PendingOp) -> None:
        """Reduce-scatter (n-1 hops of raw partial sums) then all-gather
        (n-1 hops, each completed part encoded once by its owner and
        forwarded verbatim): rank r ends the first phase owning part
        (r + 1) % n of every chunk. reduce_scatter rides the same frames
        and decodes only the chunks this rank owns."""
        ctx = self._ctx
        n, r = ctx._world_size, ctx._rank
        codec = ctx._codec
        reduce_fn = _reduce_fn(p.op)
        flats = p.chunks
        owned: "Optional[List[bool]]" = None
        if p.opcode == _OP_REDUCE_SCATTER:
            owned = [o == r for o in p.owners]
        vote = ctx._vote_health_bit()
        for step in range(n - 1):
            send_views = self._part_views(flats, n, (r - step) % n)
            recv_views = self._part_views(flats, n, (r - step - 1) % n)
            data, rvote = self._ring_sendrecv(
                p.opcode, step, send_views, iov_nbytes(send_views), vote
            )
            vote |= rvote
            if len(data) != iov_nbytes(recv_views):
                raise ConnectionError(
                    "ring allreduce chunk size mismatch (divergent shapes?)"
                )
            _NO_CODEC.decode_into(data, recv_views, reduce_fn)
        own_views = self._part_views(flats, n, (r + 1) % n)
        if type(codec) is _NoCodec:
            carry: List = list(own_views)
        else:
            own_bytes = iov_join(codec.encode_iovecs(own_views))
            self._decode_filtered(codec, own_bytes, own_views, owned, _copy)
            carry = [own_bytes]
        carry_len = self._expect_len(codec, own_views)
        for step in range(n - 1):
            recv_views = self._part_views(flats, n, (r - step) % n)
            data, rvote = self._ring_sendrecv(p.opcode, n - 1 + step, carry,
                                              carry_len, vote)
            vote |= rvote
            if len(data) != self._expect_len(codec, recv_views):
                raise ConnectionError(
                    "ring allreduce chunk size mismatch (divergent shapes?)"
                )
            self._decode_filtered(codec, data, recv_views, owned, _copy)
            carry, carry_len = [data], len(data)
        ctx._record_vote(vote)
        if p.op == ReduceOp.AVG:
            for i, f in enumerate(flats):
                if owned is None or owned[i]:
                    np.divide(f, n, out=f)


# ------------------------------------------------------ hierarchical tier
# Reduce within a domain at full precision over a private intra star,
# exchange across domains through one elected egress rank per domain with
# the configured codec (the expensive bytes, encoded once), broadcast the
# result within each domain. Composed from child TcpCommContexts, so every
# wire property (framing, chunk grid, codec bits, latching) is the flat
# tier's own.


class _HierState:
    """One configure epoch's domain tier: the resolved assignment, the
    intra child (absent for a one-member domain), the inter child (egress
    ranks only), and a 1-thread executor that runs each op's composition
    in submission order."""

    __slots__ = ("assignment", "intra", "inter", "exec", "rank", "group",
                 "n_domains", "inter_hops")

    def __init__(self, assignment: DomainAssignment, rank: int) -> None:
        self.assignment = assignment
        self.rank = rank
        self.group = assignment.group_of(rank)
        self.n_domains = assignment.n_domains
        self.intra: "Optional[TcpCommContext]" = None
        self.inter: "Optional[TcpCommContext]" = None
        self.inter_hops = 0
        self.exec = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="torchft_tpu_torch_hier"
        )

    def shutdown(self) -> None:
        self.exec.shutdown(wait=False)
        for ctx in (self.intra, self.inter):
            if ctx is not None:
                ctx.shutdown()

    def hops(self) -> int:
        """Sequential exchange rounds on this rank's path for one op:
        reduce-to-egress and broadcast-within (2, in a domain of several)
        plus the inter tier (2 for the star fan-in, 2(d-1) for the ring);
        a function of the domain structure, never of the world size."""
        hops = 2 if len(self.group) > 1 else 0
        if self.n_domains > 1:
            hops += self.inter_hops
        return hops


class TcpCommContext(CommContext):
    """Reconfigurable collective context over TCP (star or ring, flat or
    hierarchical)."""

    backend_name = "host"

    def __init__(self, timeout: "float | timedelta" = 60.0,
                 algorithm: str = "auto", channels: int = 4,
                 compression: str = "none", chunk_bytes: int = 1 << 20,
                 stripe: bool = True, topology: str = "flat",
                 domain_resolver: Optional[DomainTopology] = None) -> None:
        """``algorithm``: "star", "ring" or "auto" (ring at world size >= 3;
        on the hier inter tier "auto" is star). ``channels``: socket lanes;
        ops are assigned round-robin and, with ``stripe``, one op's chunks
        spread over every lane. ``compression``: the gradient opcodes'
        codec ("none", "bf16", "fp16", "int8"). ``chunk_bytes``: the chunk
        grid, also the int8 scale granularity (0 keeps each array whole).
        ``topology``: the default data path of ``allreduce``, "flat" or
        "hier" (configure then also builds the domain tier; a per-op
        ``topology=`` overrides at codec "none"). ``domain_resolver``: the
        :class:`DomainTopology` that maps replica ids to domains; only
        wire rank 0 consults it (default: the ``TORCHFT_TPU_DOMAINS`` map).
        All but ``domain_resolver`` must match across ranks, and across
        packages in a mixed cohort."""
        super().__init__()
        if isinstance(timeout, timedelta):
            timeout = timeout.total_seconds()
        reason = self.unsupported_reason(algorithm, compression,
                                         topology=topology)
        if reason is not None:
            raise ValueError(reason)
        if channels < 1:
            raise ValueError("channels must be >= 1")
        if chunk_bytes < 0:
            raise ValueError("chunk_bytes must be >= 0")
        self._algorithm = algorithm
        self._codec = _CODECS[compression]()
        self._compression = compression
        self._channels = int(channels)
        self._chunk_bytes = int(chunk_bytes)
        self._stripe = bool(stripe)
        self._topology_default = topology
        self._domain_resolver = domain_resolver
        self._wire_members: "Optional[List[str]]" = None
        self._hier: Optional[_HierState] = None
        self._use_ring = False
        self._timeout = float(timeout)
        self._generation = 0
        self._lock = threading.Lock()
        self._lanes: List[_Lane] = []
        self._rr = 0
        self._listener: Optional[socket.socket] = None
        self._error: Optional[Exception] = None
        # data-plane commit votes: the aggregate health bytes that rode
        # this context's collectives since the last take_commit_vote
        self._vote_health = None
        self._vote_lock = threading.Lock()
        self._vote_ops = 0
        self._vote_unhealthy = False
        self.metrics = Metrics()
        self.metrics.label("comm_backend", self.backend_name)
        self._events = None

    @classmethod
    def unsupported_reason(cls, algorithm: str, compression: str,
                           op: str = ReduceOp.SUM,
                           topology: str = "flat") -> Optional[str]:
        return host_unsupported_reason(algorithm, compression, op, topology)

    def set_wire_members(self, members: "Sequence[str]") -> None:
        """Replica ids of the upcoming cohort in transport rank order (the
        Manager calls this before each ``configure``): what the domain
        resolver maps to tiers. Without it a hier configure names the
        ranks ``rank{r}``."""
        self._wire_members = [str(m) for m in members]

    def set_domain_resolver(self, resolver: DomainTopology) -> None:
        """Install a resolver unless one was given to the constructor (the
        explicit one wins)."""
        if self._domain_resolver is None:
            self._domain_resolver = resolver

    def set_metrics(self, metrics: Metrics) -> None:
        """Record lane phase timings into ``metrics`` (the Manager's)."""
        self.metrics = metrics
        metrics.label("comm_backend", self.backend_name)

    def set_events(self, events) -> None:
        """Share a flight recorder: ``error_latched`` on each latch edge,
        ``hier_exchange`` at each hier configure."""
        self._events = events

    # ------------------------------------------------------------ lifecycle

    def configure(self, store_addr: str, rank: int, world_size: int) -> None:
        self.shutdown()
        with self._lock:
            self._generation += 1
            self._rank = rank
            self._world_size = world_size
            self._error = None
            self._rr = 0
        with self._vote_lock:  # votes of the old membership prove nothing
            self._vote_ops = 0
            self._vote_unhealthy = False
        n_lanes = 1 if world_size == 1 else self._channels
        lanes = [_Lane(self, i) for i in range(n_lanes)]
        store = None
        if world_size > 1:
            store = create_store_client(store_addr, timeout=self._timeout)
            self._use_ring = self._algorithm == "ring" or (
                self._algorithm == "auto" and world_size >= 3
            )
            if self._use_ring:
                self._configure_ring(store, rank, world_size, lanes)
            else:
                self._configure_star(store, rank, world_size, lanes)
        for lane in lanes:
            lane.start()
        with self._lock:
            self._lanes = lanes
        if store is not None and self._topology_default == "hier":
            try:
                self._configure_hier(store_addr, rank, world_size, store)
            except Exception:
                self.shutdown()  # a half-built tier must not leak sockets
                raise

    def _listen(self, backlog: int) -> socket.socket:
        listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        listener.bind(("0.0.0.0", 0))
        listener.listen(backlog)
        listener.settimeout(self._timeout)
        self._listener = listener
        return listener

    def _dial(self, addr: str, rank: int, lane_id: int) -> socket.socket:
        host, port_s = addr.rsplit(":", 1)
        sock = socket.create_connection((host, int(port_s)),
                                        timeout=self._timeout)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        sock.settimeout(self._timeout)
        sock.sendall(struct.pack("<II", rank, lane_id))
        return sock

    def _accept(self, listener: socket.socket) -> "tuple":
        conn, _ = listener.accept()
        conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        conn.settimeout(self._timeout)
        peer_rank, lane_id = struct.unpack("<II", recv_exact(conn, 8))
        return conn, peer_rank, lane_id

    def _abort_configure(self, lanes: List[_Lane]) -> None:
        for lane in lanes:
            lane.close_sockets()
        if self._listener is not None:
            self._listener.close()
            self._listener = None

    def _configure_star(self, store, rank: int, world_size: int,
                        lanes: List[_Lane]) -> None:
        """Rank 0 listens; every peer dials one connection per lane, tagged
        [rank u32][lane u32]."""
        n_lanes = len(lanes)
        if rank == 0:
            listener = self._listen(world_size * n_lanes)
            store.set("comm_addr",
                      f"{advertised_host()}:{listener.getsockname()[1]}")
            expected = (world_size - 1) * n_lanes
            accepted = 0
            try:
                while accepted < expected:
                    conn, peer_rank, lane_id = self._accept(listener)
                    if lane_id >= n_lanes:
                        conn.close()
                        raise ConnectionError(
                            f"peer {peer_rank} sent lane {lane_id}, have "
                            f"{n_lanes} lanes (channels mismatch across ranks?)"
                        )
                    lane_socks = lanes[lane_id]._peer_socks
                    if peer_rank in lane_socks:
                        # redial inside the configure window: newest wins
                        lane_socks[peer_rank].close()
                    else:
                        accepted += 1
                    lane_socks[peer_rank] = conn
            except (OSError, ConnectionError) as e:
                self._abort_configure(lanes)
                raise TimeoutError(
                    f"comm configure: rank 0 failed waiting for {expected} "
                    f"lane connections ({accepted} joined): {e}"
                ) from e
        else:
            addr = store.wait("comm_addr", timeout=self._timeout).decode()
            try:
                for lane in lanes:
                    lane._root_sock = self._dial(addr, rank, lane._lane_id)
            except OSError as e:
                self._abort_configure(lanes)
                raise TimeoutError(
                    f"comm configure: rank {rank} could not reach root: {e}"
                ) from e

    def _configure_ring(self, store, rank: int, world_size: int,
                        lanes: List[_Lane]) -> None:
        """Every rank listens; rank r dials (r+1) % n once per lane and
        accepts one connection per lane from (r-1) % n."""
        n_lanes = len(lanes)
        listener = self._listen(2 * n_lanes)
        store.set(f"ring_addr_{rank}",
                  f"{advertised_host()}:{listener.getsockname()[1]}")
        next_rank = (rank + 1) % world_size
        expected_prev = (rank - 1) % world_size
        addr = store.wait(f"ring_addr_{next_rank}",
                          timeout=self._timeout).decode()
        try:
            for lane in lanes:
                lane._next_sock = self._dial(addr, rank, lane._lane_id)
            accepted = 0
            while accepted < n_lanes:
                conn, prev_rank, lane_id = self._accept(listener)
                if prev_rank != expected_prev:
                    conn.close()
                    raise ConnectionError(
                        f"ring configure: rank {rank} accepted rank "
                        f"{prev_rank}, expected {expected_prev} (stale round?)"
                    )
                if lane_id >= n_lanes or lanes[lane_id]._prev_sock is not None:
                    conn.close()
                    raise ConnectionError(
                        f"ring configure: bad/duplicate lane {lane_id} "
                        "(channels mismatch across ranks?)"
                    )
                lanes[lane_id]._prev_sock = conn
                accepted += 1
        except (OSError, ConnectionError) as e:
            self._abort_configure(lanes)
            if isinstance(e, ConnectionError):
                raise
            raise TimeoutError(
                f"ring configure: rank {rank} could not link the ring: {e}"
            ) from e

    def _configure_hier(self, store_addr: str, rank: int, world_size: int,
                        store) -> None:
        """Build the domain tier on top of the flat lanes. Wire rank 0
        resolves the cohort and publishes the assignment as ``hier_map`` on
        the store; the other ranks adopt the published copy, so a live map
        refresh mid-quorum cannot split the cohort. Then the intra child
        (this domain; intra rank 0 is the egress) and, on egress ranks,
        the inter child (one rank per domain, in sorted-name order)."""
        members = self._wire_members
        if members is None or len(members) != world_size:
            members = [f"rank{r}" for r in range(world_size)]
        if rank == 0:
            if self._domain_resolver is None:
                self._domain_resolver = DomainTopology()
            assignment = self._domain_resolver.assign(members)
            store.set("hier_map", assignment.to_json())
        else:
            assignment = DomainAssignment.from_json(
                store.wait("hier_map", timeout=self._timeout))
        h = _HierState(assignment, rank)
        d_idx = assignment.domain_index(rank)
        try:
            if len(h.group) > 1:
                # reduce-within and broadcast-within: a full-precision star
                # whose root is the egress
                h.intra = TcpCommContext(
                    timeout=self._timeout, algorithm="star",
                    channels=self._channels, compression="none",
                    chunk_bytes=self._chunk_bytes, stripe=self._stripe,
                )
                h.intra.configure(f"{store_addr}/hier_intra_{d_idx}",
                                  h.group.index(rank), len(h.group))
            if h.n_domains > 1:
                inter_algo = "star" if self._algorithm == "auto" \
                    else self._algorithm
                h.inter_hops = (2 * (h.n_domains - 1)
                                if inter_algo == "ring" else 2)
                if assignment.is_egress(rank):
                    h.inter = TcpCommContext(
                        timeout=self._timeout, algorithm=inter_algo,
                        channels=self._channels,
                        compression=self._compression,
                        chunk_bytes=self._chunk_bytes, stripe=self._stripe,
                    )
                    h.inter.configure(f"{store_addr}/hier_inter", d_idx,
                                      h.n_domains)
        except Exception:
            h.shutdown()
            raise
        with self._lock:
            self._hier = h
        ev = self._events
        if ev:
            ev.emit("hier_exchange", world=world_size,
                    domains=h.n_domains, egress=list(assignment.egress),
                    domain=assignment.domains[rank],
                    is_egress=assignment.is_egress(rank),
                    fingerprint=assignment.fingerprint)

    def shutdown(self) -> None:
        with self._lock:
            lanes, self._lanes = self._lanes, []
            hier, self._hier = self._hier, None
            for lane in lanes:
                lane._queue.put(None)  # no op can be enqueued after it
        if hier is not None:
            hier.shutdown()
        for lane in lanes:
            lane.close_sockets()
        if self._listener is not None:
            try:
                self._listener.close()
            except OSError:
                pass
            self._listener = None
        for lane in lanes:
            if lane._thread is not None:
                lane._thread.join(timeout=5.0)
                lane._thread = None

    def errored(self) -> Optional[Exception]:
        with self._lock:
            return self._error

    def _latch_error(self, e: Exception) -> None:
        with self._lock:
            first = self._error is None
            if first:
                self._error = e
        ev = self._events
        if first and ev:
            ev.emit("error_latched", source="host", error=repr(e)[:200])

    # ------------------------------------------- data-plane commit votes

    def set_vote_health(self, fn) -> None:
        """Install the local health provider (``fn() -> bool``, True =
        healthy) sampled when each op ships its vote byte. The Manager
        wires its error latch here; without one a rank votes healthy
        unless this context has latched an error."""
        self._vote_health = fn

    def _vote_health_bit(self) -> int:
        """This rank's vote byte: 1 = unhealthy. A latched transport
        error always votes unhealthy; so does a provider that raises."""
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
        least one voted op, every participant healthy on each), False (any
        dissent), None (no voted op completed, as on the hier tier: the
        caller must run the full commit barrier)."""
        with self._vote_lock:
            ops, bad = self._vote_ops, self._vote_unhealthy
            self._vote_ops = 0
            self._vote_unhealthy = False
        if ops == 0:
            return None
        return not bad

    # ------------------------------------------------- wire introspection

    def wire_codec_name(self) -> str:
        return self._codec.name

    def wire_is_lossy(self) -> bool:
        return type(self._codec) is not _NoCodec

    def wire_generation(self) -> int:
        """Bumped by every configure: error-feedback residuals reset on
        it."""
        with self._lock:
            return self._generation

    def wire_compensable(self) -> bool:
        """True when THIS rank's contribution crosses the wire through the
        lossy codec. Flat: star peers only (the root's contribution is the
        raw accumulator, ring hops carry raw partial sums). Hier: an
        egress rank whose inter-tier role is compensable (every egress but
        the inter star's root). Valid after configure."""
        with self._lock:
            h = self._hier
            flat = (type(self._codec) is not _NoCodec
                    and self._world_size > 1 and not self._use_ring
                    and self._rank != 0)
        if self._topology_default == "hier":
            return (type(self._codec) is not _NoCodec and h is not None
                    and h.inter is not None and h.inter.wire_compensable())
        return flat

    def wire_roundtrip(self, src: np.ndarray, out: np.ndarray) -> None:
        """The wire's image of this rank's contribution, what an error
        feedback residual is computed against: decode(encode(src)) per
        grid chunk where :meth:`wire_compensable`, else the identity."""
        if src.shape != out.shape or src.dtype != out.dtype:
            raise ValueError("wire_roundtrip: src/out layout mismatch")
        if not self.wire_compensable():
            np.copyto(out, src)
            return
        codec_roundtrip(self._codec, self._chunk_bytes, src, out)

    def wire_nbytes(self, a: np.ndarray) -> int:
        return codec_wire_nbytes(self._codec, self._chunk_bytes, a)

    # ----------------------------------------------------------- collectives

    @staticmethod
    def _failed(exc: Exception) -> Work:
        fut: Future = Future()
        fut.set_running_or_notify_cancel()
        fut.set_exception(exc)
        return Work(fut)

    def _submit(self, opcode: int, arrays: Sequence[np.ndarray], op: str,
                root: int,
                owners: "Optional[Sequence[int]]" = None) -> Work:
        err = self.errored()
        if err is not None:
            return self._failed(
                ConnectionError(f"comm context previously errored: {err}"))
        fut: Future = Future()
        fut.set_running_or_notify_cancel()
        prepared = [self._prepare(a) for a in arrays]
        # Paired with shutdown(): either we enqueue before the sentinel or
        # we see no lanes and fail fast.
        with self._lock:
            if not self._lanes:
                fut.set_exception(RuntimeError("comm context not configured"))
                return Work(fut)
            n_lanes = len(self._lanes)
            base = self._rr % n_lanes
            self._rr += 1
            if opcode not in _GRAD_OPCODES or self._world_size == 1:
                self._lanes[base]._queue.put(
                    _PendingOp(opcode, prepared, op, root, fut))
                return Work(fut)
            if opcode == _OP_REDUCE_SCATTER:
                if owners is None:
                    owners = [i % self._world_size
                              for i in range(len(prepared))]
                owners = [int(o) for o in owners]
                if len(owners) != len(prepared) or any(
                        not 0 <= o < self._world_size for o in owners):
                    fut.set_exception(ValueError(
                        f"reduce_scatter owners {owners} must name a rank "
                        f"in [0, {self._world_size}) per array "
                        f"({len(prepared)} arrays submitted)"
                    ))
                    return Work(fut)
            else:
                owners = None
            chunks, chunk_owners = _chunk_grid_owned(
                [a.reshape(-1) for a in prepared], owners, self._chunk_bytes)
            per_lane: Dict[int, List[np.ndarray]] = {}
            per_lane_owner: Dict[int, List[int]] = {}
            for c, ch in enumerate(chunks):
                lane_id = (base + c) % n_lanes if self._stripe else base
                per_lane.setdefault(lane_id, []).append(ch)
                if chunk_owners is not None:
                    per_lane_owner.setdefault(lane_id, []).append(
                        chunk_owners[c])
            if not per_lane:  # all views empty: nothing to reduce
                per_lane = {base: []}
                per_lane_owner = {base: []} if owners is not None else {}
            state = _OpState(prepared, fut, len(per_lane), self.metrics)
            # one direction, this rank's contribution: a compression ratio
            # is a counter division
            self.metrics.incr("comm_chunks", float(len(chunks)))
            self.metrics.incr("comm_raw_bytes",
                              float(sum(ch.nbytes for ch in chunks)))
            self.metrics.incr("comm_encoded_bytes", float(sum(
                self._codec.wire_nbytes(ch) for ch in chunks)))
            for lane_id in sorted(per_lane):
                self._lanes[lane_id]._queue.put(_PendingOp(
                    opcode, prepared, op, root, fut,
                    chunks=per_lane[lane_id], state=state,
                    owners=per_lane_owner.get(lane_id),
                ))
        return Work(fut)

    def _submit_hier(self, arrays: Sequence[np.ndarray], op: str) -> Work:
        err = self.errored()
        if err is not None:
            return self._failed(
                ConnectionError(f"comm context previously errored: {err}"))
        prepared = [self._prepare(a) for a in arrays]
        with self._lock:
            h = self._hier
            world = self._world_size
            configured = bool(self._lanes)
        if not configured:
            return self._failed(RuntimeError("comm context not configured"))
        fut: Future = Future()
        fut.set_running_or_notify_cancel()
        if world == 1:
            fut.set_result(prepared)  # solo wire: identity, as the flat path
        elif h is None:
            fut.set_exception(RuntimeError(
                "topology='hier' requires a context configured with the "
                "hierarchical tier: construct TcpCommContext("
                "topology='hier') (and configure it) or use "
                "topology='flat' for this op"
            ))
        else:
            h.exec.submit(self._run_hier, h, prepared, op, fut)
        return Work(fut)

    def _run_hier(self, h: _HierState, arrays: List[np.ndarray], op: str,
                  fut: Future) -> None:
        """One op's composition on the hier executor: reduce to the egress
        (the intra reduce_scatter with every array owned by intra rank 0),
        exchange across domains (egress only, the codec encoding each
        domain sum once), broadcast within the domain (raw), then the AVG
        divide. A failed phase latches like a dead socket: an egress dying
        mid-op fails its domain's broadcast by timeout, and the next
        quorum elects the lowest surviving rank."""
        t0 = time.perf_counter()
        phase_timeout = self._timeout + 15.0
        try:
            tier_op = ReduceOp.SUM if op == ReduceOp.AVG else op
            m = len(h.group)
            if m > 1:
                h.intra.reduce_scatter(
                    arrays, tier_op, owners=[0] * len(arrays)
                ).future().result(timeout=phase_timeout)
            if h.n_domains > 1 and h.inter is not None:
                h.inter.allreduce(arrays, tier_op).future().result(
                    timeout=phase_timeout)
            if m > 1:
                res = h.intra.broadcast(arrays, root=0).future().result(
                    timeout=phase_timeout)
                for a, r in zip(arrays, res):
                    np.copyto(a, r)
            if op == ReduceOp.AVG:
                for a in arrays:
                    np.divide(a, self._world_size, out=a)
            # one direction, this rank's contribution: intra = the raw
            # domain hop, inter = the encoded cross-domain hop (egress only)
            raw_b = float(sum(a.nbytes for a in arrays))
            inter_b = 0.0
            if h.inter is not None and h.n_domains > 1:
                enc_b = float(sum(self.wire_nbytes(a) for a in arrays))
                if h.inter._use_ring:
                    # ring: raw partial sums, then the encoded all-gather
                    d = h.n_domains
                    inter_b = (raw_b + enc_b) * (d - 1) / d
                else:
                    inter_b = enc_b
            self.metrics.incr("comm_intra_bytes", raw_b if m > 1 else 0.0)
            self.metrics.incr("comm_inter_bytes", inter_b)
            self.metrics.incr("comm_hops", float(h.hops()))
            self.metrics.observe("comm_op_wire", time.perf_counter() - t0)
            fut.set_result(arrays)
        except Exception as e:  # noqa: BLE001 — latch every tier error
            self._latch_error(e)
            logger.warning(
                "hier comm op failed (rank %d world %d domain %s): %r",
                self._rank, self._world_size,
                h.assignment.domains[h.rank], e,
            )
            try:
                fut.set_exception(e)
            except Exception:
                pass

    def allreduce(self, arrays: Sequence[np.ndarray], op: str = ReduceOp.SUM,
                  topology: Optional[str] = None) -> Work:
        """Reduce across ranks in place (the donation contract).
        ``topology`` overrides the context's default path for this op;
        under a lossy codec it may not differ from the default, because
        the error-feedback roles (:meth:`wire_compensable`) follow the
        default."""
        topo = topology if topology is not None else self._topology_default
        if topo != self._topology_default and self.wire_is_lossy():
            return self._failed(ValueError(
                f"per-op topology={topo!r} differs from this context's "
                f"default {self._topology_default!r} under the lossy "
                f"{self._codec.name!r} codec: the error-feedback roles "
                "(wire_compensable) follow the default topology, so the "
                "override would desynchronize EF from the actual wire. "
                f"Construct a context with topology={topo!r} for this arm, "
                "or use compression='none' for a per-op A/B"
            ))
        if topo == "hier":
            return self._submit_hier(arrays, op)
        if topo != "flat":
            return self._failed(ValueError(
                host_unsupported_reason(self._algorithm, self._codec.name,
                                        op, topo)
                or f"unknown topology {topo!r}"))
        return self._submit(_OP_ALLREDUCE, arrays, op, 0)

    def reduce_scatter(self, arrays: Sequence[np.ndarray],
                       op: str = ReduceOp.SUM,
                       owners: "Optional[Sequence[int]]" = None) -> Work:
        """Reduce across ranks, delivering each array's result only to its
        owner (``owners[i]``, default ``i % world_size``): bitwise what an
        allreduce over the same grid gives there. The other arrays'
        contents are unspecified (donation contract). Every rank submits
        identical layouts and owners."""
        return self._submit(_OP_REDUCE_SCATTER, arrays, op, 0, owners=owners)

    def allgather(self, arrays: Sequence[np.ndarray]) -> Work:
        """Future resolves to a list of per-rank lists of arrays."""
        return self._submit(_OP_ALLGATHER, arrays, ReduceOp.SUM, 0)

    def broadcast(self, arrays: Sequence[np.ndarray], root: int = 0) -> Work:
        """Future resolves to root's arrays on every rank."""
        return self._submit(_OP_BROADCAST, arrays, ReduceOp.SUM, root)
