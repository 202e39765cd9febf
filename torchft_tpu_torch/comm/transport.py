"""TCP transport for cross-replica gradient allreduce.

Twin of ``torchft_tpu/comm/transport.py`` in its default configuration, with
byte-compatible frames, so a rank of either package can join one cohort:

    configure(store_addr, rank, world_size):
        endpoints rendezvous through the store; "star" (rank 0 reduces and
        fans out) or "ring" (reduce-scatter + all-gather); "auto" picks
        ring at world size >= 3.

Collectives run on ``channels`` lanes, each with its own sockets and
worker thread. An allreduce payload is cut into a deterministic chunk grid
(contiguous <= ``chunk_bytes`` slices of each flat view, in view order) and
chunk c runs on lane ``(base + c) % channels``, where ``base`` is the op's
round-robin index: the same grid and the same chunk -> lane map on every
rank, so each lane's frame stream stays ordered and a large bucket rides
every lane at once. The star root drains peers in rank order per chunk and
the ring treats each chunk as an independent payload, so the result is
bitwise independent of striping.

Zero copy: sends are ``sendmsg`` iovecs over the arrays themselves,
receives land in per-lane buffer pools via ``recv_into``, and payloads are
reduced straight into the caller's (donated) arrays. Reconfigure/shutdown
closes the sockets, which fails in-flight ops with ConnectionError; the
first error latches until the next ``configure``.

The wire carries raw values (``compression="none"``). Each gradient frame
carries the reference's one-byte health vote (0 = healthy, 1 = this rank
has latched an error or its Manager reports an error), byte for byte. Every
op records the aggregate vote it carried; ``take_commit_vote`` hands the
window's verdict to the Manager's fast path, which commits a leased step on
it without the barrier RPC.
"""

from __future__ import annotations

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
import torch

from torchft_tpu_torch.comm.context import CommContext, ReduceOp, Work
from torchft_tpu_torch.comm.store import create_store_client
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
    "codec_roundtrip",
    "codec_wire_nbytes",
    "host_unsupported_reason",
    "make_wire_codec",
]

_OP_ALLREDUCE = 1  # the reference's opcode for allreduce frames

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
    chunks: List[np.ndarray] = []
    for f in flats:
        if f.size == 0:
            continue
        if chunk_bytes <= 0:
            chunks.append(f)
            continue
        step = max(1, chunk_bytes // f.dtype.itemsize)
        chunks.extend(f[s: s + step] for s in range(0, f.size, step))
    return chunks


def _chunk_bounds(total: int, n: int, c: int) -> "tuple[int, int]":
    """Element bounds of rank-part ``c`` when ``total`` is split into n
    near-equal parts, the first ``total % n`` one element longer (the
    ring's reduce-scatter split)."""
    base, extra = divmod(total, n)
    start = c * base + min(c, extra)
    return start, start + base + (1 if c < extra else 0)


# --------------------------------------------------------------- compression
# Wire codecs for allreduce payloads (gradients), twins of the reference's:
# bf16/fp16 downcast, int8 with one absmax scale per chunk of the grid.
# Plain numpy (bf16 through torch, which numpy lacks). They are the host
# image of the wire and the bitwise oracle of the on-device plane
# (comm/cuda_backend.py); this module's TcpCommContext still carries raw
# values only.


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


def _to_bf16_bits(v: np.ndarray) -> np.ndarray:
    return (torch.from_numpy(np.ascontiguousarray(v)).to(torch.bfloat16)
            .view(torch.int16).numpy())


def _from_bf16_bits(bits: np.ndarray, dtype: np.dtype) -> np.ndarray:
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
    star/ring/auto for every reduce op; ``psum`` is the on-device path and
    does not exist on sockets."""
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
    arrays (reduced in place across all lanes' disjoint chunks)."""

    __slots__ = ("arrays", "fut", "_remaining", "_lock")

    def __init__(self, arrays: List[np.ndarray], fut: Future,
                 n_subops: int) -> None:
        self.arrays = arrays
        self.fut = fut
        self._remaining = n_subops
        self._lock = threading.Lock()

    def subop_done(self) -> bool:
        with self._lock:
            self._remaining -= 1
            return self._remaining == 0


class _PendingOp:
    __slots__ = ("op", "chunks", "state", "t_submit")

    def __init__(self, op: str, chunks: List[np.ndarray],
                 state: _OpState) -> None:
        self.op = op
        self.chunks = chunks  # this lane's chunk views
        self.state = state
        self.t_submit = time.perf_counter()


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
                self._execute(pending)
                metrics.observe("comm_submit_wire", t_deq - pending.t_submit)
                metrics.observe("comm_wire_reduce",
                                time.perf_counter() - t_deq)
                state = pending.state
                if state.subop_done():
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
                    pending.state.fut.set_exception(e)
                except Exception:
                    pass

    def _execute(self, p: _PendingOp) -> None:
        self._seq += 1
        if self._ctx._world_size == 1:
            # solo wire: the op's vote is this rank's own health, the
            # degenerate (but present) evidence the fast path consumes
            self._ctx._record_vote(self._ctx._vote_health_bit())
            return
        if self._ctx._use_ring:
            self._ring_allreduce(p)
        elif self._ctx._rank == 0:
            self._star_root(p)
        else:
            self._star_peer(p)

    # ------------------------------------------------------------- star
    # peer -> root: [opcode u8][seq u64][vote u8], then per chunk
    # [nbytes u64] + the chunk's raw bytes. root -> peer: per chunk
    # [nbytes u64] + the reduced bytes, then one aggregate vote byte.
    # Peers are drained in rank order per chunk, so the float result is the
    # sequential r = 1..n-1 reduction whatever the grid or striping.

    def _star_root(self, p: _PendingOp) -> None:
        reduce_fn = _REDUCE_FNS.get(
            ReduceOp.SUM if p.op == ReduceOp.AVG else p.op
        )
        if reduce_fn is None:
            raise ValueError(f"unsupported reduce op: {p.op}")
        world = self._ctx._world_size
        peers = sorted(self._peer_socks.items())
        vote = self._ctx._vote_health_bit()
        for peer_rank, sock in peers:
            r_op, r_seq, r_vote = struct.unpack(
                "<BQB", self._bufs.recv_header(sock, 10)
            )
            if r_op != _OP_ALLREDUCE or r_seq != self._seq:
                raise ConnectionError(
                    f"collective mismatch from rank {peer_rank}: got "
                    f"op={r_op} seq={r_seq}, expected op={_OP_ALLREDUCE} "
                    f"seq={self._seq}"
                )
            vote |= r_vote & 1
        for ch in p.chunks:
            for peer_rank, sock in peers:
                (nbytes,) = struct.unpack("<Q", self._bufs.recv_header(sock, 8))
                if nbytes != ch.nbytes:
                    raise ConnectionError(
                        f"allreduce chunk size mismatch from rank "
                        f"{peer_rank}: {nbytes} != {ch.nbytes} (divergent "
                        "shapes or chunk_bytes?)"
                    )
                _decode_into(self._bufs.recv_payload(sock, nbytes), [ch],
                             reduce_fn)
            if p.op == ReduceOp.AVG:
                np.divide(ch, world, out=ch)
            frame = [struct.pack("<Q", ch.nbytes), ch]
            for _, sock in peers:
                sendmsg_all(sock, frame)
        for _, sock in peers:
            sendmsg_all(sock, [struct.pack("<B", vote)])
        self._ctx._record_vote(vote)

    def _star_peer(self, p: _PendingOp) -> None:
        sock = self._root_sock
        assert sock is not None
        tx: List = [struct.pack("<BQB", _OP_ALLREDUCE, self._seq,
                                self._ctx._vote_health_bit())]
        for ch in p.chunks:
            tx.append(struct.pack("<Q", ch.nbytes))
            tx.append(ch)

        def _rx_targets():
            for ch in p.chunks:
                len_mv = self._bufs.header_slot(8)
                yield len_mv
                (nbytes,) = struct.unpack("<Q", len_mv)
                if nbytes != ch.nbytes:
                    raise ConnectionError(
                        f"allreduce reply chunk size mismatch: {nbytes} "
                        f"!= {ch.nbytes} (divergent shapes or chunk_bytes?)"
                    )
                payload = self._bufs.payload_slot(nbytes)
                yield payload
                _decode_into(payload, [ch], _copy)
            vote_mv = self._bufs.header_slot(1)  # the root's aggregate vote
            yield vote_mv
            self._ctx._record_vote(vote_mv[0])

        _duplex_exchange(sock, tx, sock, _rx_targets(), self._ctx._timeout)

    # ------------------------------------------------------------- ring

    def _ring_sendrecv(self, step: int, bufs: Sequence, nbytes: int,
                       vote: int) -> "tuple[memoryview, int]":
        """Full-duplex hop: push to next while pulling from prev. Every
        frame carries [opcode][seq][step][nbytes][vote] and is validated, so
        a desynced collective fails fast instead of reducing misaligned
        bytes. The received payload stays valid through one more hop."""
        hdr = self._RING_HDR
        header = hdr.pack(_OP_ALLREDUCE, self._seq, step, nbytes, vote)
        out: List[memoryview] = []
        rvotes: List[int] = []

        def _rx_targets():
            hdr_mv = self._bufs.header_slot(hdr.size)
            yield hdr_mv
            r_op, r_seq, r_step, r_len, r_vote = hdr.unpack(hdr_mv)
            if (r_op, r_seq, r_step) != (_OP_ALLREDUCE, self._seq, step):
                raise ConnectionError(
                    f"ring collective mismatch: got op={r_op} seq={r_seq} "
                    f"step={r_step}, expected op={_OP_ALLREDUCE} "
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

    def _ring_allreduce(self, p: _PendingOp) -> None:
        """Reduce-scatter (n-1 hops of partial sums) then all-gather (n-1
        hops forwarding completed parts verbatim): rank r ends the first
        phase owning part (r + 1) % n of every chunk."""
        n, r = self._ctx._world_size, self._ctx._rank
        reduce_fn = _REDUCE_FNS.get(
            ReduceOp.SUM if p.op == ReduceOp.AVG else p.op
        )
        if reduce_fn is None:
            raise ValueError(f"unsupported reduce op: {p.op}")
        flats = p.chunks
        vote = self._ctx._vote_health_bit()
        for step in range(n - 1):
            send_views = self._part_views(flats, n, (r - step) % n)
            recv_views = self._part_views(flats, n, (r - step - 1) % n)
            data, rvote = self._ring_sendrecv(
                step, send_views, iov_nbytes(send_views), vote
            )
            vote |= rvote
            if len(data) != iov_nbytes(recv_views):
                raise ConnectionError(
                    "ring allreduce chunk size mismatch (divergent shapes?)"
                )
            _decode_into(data, recv_views, reduce_fn)
        own_views = self._part_views(flats, n, (r + 1) % n)
        carry: List = list(own_views)
        carry_len = iov_nbytes(own_views)
        for step in range(n - 1):
            recv_views = self._part_views(flats, n, (r - step) % n)
            data, rvote = self._ring_sendrecv(n - 1 + step, carry, carry_len,
                                              vote)
            vote |= rvote
            if len(data) != iov_nbytes(recv_views):
                raise ConnectionError(
                    "ring allreduce chunk size mismatch (divergent shapes?)"
                )
            _decode_into(data, recv_views, _copy)
            carry, carry_len = [data], len(data)
        self._ctx._record_vote(vote)
        if p.op == ReduceOp.AVG:
            for f in flats:
                np.divide(f, n, out=f)


class TcpCommContext(CommContext):
    """Reconfigurable allreduce context over TCP (star or ring)."""

    backend_name = "host"

    def __init__(self, timeout: "float | timedelta" = 60.0,
                 algorithm: str = "auto", channels: int = 4,
                 chunk_bytes: int = 1 << 20, stripe: bool = True,
                 compression: str = "none") -> None:
        """``algorithm``: "star", "ring" or "auto" (ring at world size >= 3).
        ``channels``: socket lanes; ops are assigned round-robin and, with
        ``stripe``, one op's chunks spread over every lane. ``chunk_bytes``:
        the chunk grid (0 keeps each array whole). All four must match
        across ranks, and across packages in a mixed cohort.
        ``compression``: "none" only (see :meth:`unsupported_reason`)."""
        super().__init__()
        if isinstance(timeout, timedelta):
            timeout = timeout.total_seconds()
        reason = self.unsupported_reason(algorithm, compression)
        if reason is not None:
            raise ValueError(reason)
        if channels < 1:
            raise ValueError("channels must be >= 1")
        if chunk_bytes < 0:
            raise ValueError("chunk_bytes must be >= 0")
        self._algorithm = algorithm
        self._channels = int(channels)
        self._chunk_bytes = int(chunk_bytes)
        self._stripe = bool(stripe)
        self._use_ring = False
        self._timeout = float(timeout)
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

    @classmethod
    def unsupported_reason(cls, algorithm: str, compression: str,
                           op: str = ReduceOp.SUM,
                           topology: str = "flat") -> Optional[str]:
        """The reference's host-plane rule (:func:`host_unsupported_reason`)
        narrowed to what this wire carries: raw values on the flat tier."""
        reason = host_unsupported_reason(algorithm, compression, op, topology)
        if reason is not None:
            return reason
        if compression != "none":
            return (
                f"compression={compression!r}: this TCP wire carries raw "
                "values (codecs on its frames are ROADMAP queue 1 item 2); "
                "use comm_backend='cuda', whose on-device plane runs every "
                "codec"
            )
        if topology != "flat":
            return (
                "topology='hier' is not ported (ROADMAP queue 1 item 2); "
                "this wire is one flat tier"
            )
        return None

    def set_metrics(self, metrics: Metrics) -> None:
        """Record lane phase timings into ``metrics`` (the Manager's)."""
        self.metrics = metrics
        metrics.label("comm_backend", self.backend_name)

    # ------------------------------------------------------------ lifecycle

    def configure(self, store_addr: str, rank: int, world_size: int) -> None:
        self.shutdown()
        with self._lock:
            self._rank = rank
            self._world_size = world_size
            self._error = None
            self._rr = 0
        with self._vote_lock:  # votes of the old membership prove nothing
            self._vote_ops = 0
            self._vote_unhealthy = False
        n_lanes = 1 if world_size == 1 else self._channels
        lanes = [_Lane(self, i) for i in range(n_lanes)]
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

    def shutdown(self) -> None:
        with self._lock:
            lanes, self._lanes = self._lanes, []
            for lane in lanes:
                lane._queue.put(None)  # no op can be enqueued after it
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
            if self._error is None:
                self._error = e

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
        dissent), None (no voted op completed: the caller must run the
        full commit barrier)."""
        with self._vote_lock:
            ops, bad = self._vote_ops, self._vote_unhealthy
            self._vote_ops = 0
            self._vote_unhealthy = False
        if ops == 0:
            return None
        return not bad

    # ----------------------------------------------------------- collectives

    def allreduce(
        self, arrays: Sequence[np.ndarray], op: str = ReduceOp.SUM
    ) -> Work:
        fut: Future = Future()
        fut.set_running_or_notify_cancel()
        err = self.errored()
        if err is not None:
            fut.set_exception(
                ConnectionError(f"comm context previously errored: {err}")
            )
            return Work(fut)
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
            chunks = _chunk_grid([a.reshape(-1) for a in prepared],
                                 self._chunk_bytes)
            per_lane: Dict[int, List[np.ndarray]] = {}
            for c, ch in enumerate(chunks):
                lane_id = (base + c) % n_lanes if self._stripe else base
                per_lane.setdefault(lane_id, []).append(ch)
            if not per_lane:  # all views empty: nothing to reduce
                per_lane = {base: []}
            state = _OpState(prepared, fut, len(per_lane))
            self.metrics.incr("comm_chunks", float(len(chunks)))
            self.metrics.incr("comm_raw_bytes",
                              float(sum(ch.nbytes for ch in chunks)))
            for lane_id in sorted(per_lane):
                self._lanes[lane_id]._queue.put(
                    _PendingOp(op, per_lane[lane_id], state)
                )
        return Work(fut)
