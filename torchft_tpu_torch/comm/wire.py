"""Shared byte-plane helpers for both data planes.

The gradient transport (comm/transport.py) and the heal plane
(checkpointing.py) move the same thing — large contiguous tensor bytes —
over sockets: uint8 reinterpret views, scatter-gather ``sendmsg`` with
sendall semantics, and ``recv_into`` loops that land bytes straight into
their final buffers. Twin of ``torchft_tpu/comm/wire.py``; numpy and the
standard library only.
"""

from __future__ import annotations

import socket
from typing import List, Sequence, Tuple

import numpy as np

__all__ = [
    "IOV_MAX",
    "HAS_SENDMSG",
    "as_bytes_view",
    "iov_join",
    "iov_nbytes",
    "sendmsg_all",
    "recv_into_exact",
    "recv_exact",
    "readinto_exact",
    "split_stripes",
    "split_weighted",
]

# Linux UIO_MAXIOV is 1024; stay under it per sendmsg call.
IOV_MAX = 512
HAS_SENDMSG = hasattr(socket.socket, "sendmsg")


def as_bytes_view(b) -> memoryview:
    """Byte-typed memoryview of any buffer without copying (ndarrays go
    through a uint8 reinterpret)."""
    if isinstance(b, np.ndarray):
        a = np.ascontiguousarray(b)
        return memoryview(a.reshape(-1).view(np.uint8))
    return memoryview(b).cast("B")


def iov_nbytes(bufs: Sequence) -> int:
    return sum(
        b.nbytes if isinstance(b, np.ndarray) else len(b) for b in bufs
    )


def iov_join(bufs: Sequence) -> bytes:
    """Materialize an iovec list (a lossy codec's self-decode)."""
    return b"".join(bytes(as_bytes_view(b)) for b in bufs)


def sendmsg_all(sock: socket.socket, bufs: Sequence) -> None:
    """sendall semantics over an iovec list: every buffer hits the wire,
    in order, with no concatenation into an intermediate payload."""
    mvs = [mv for mv in (as_bytes_view(b) for b in bufs) if len(mv)]
    if not HAS_SENDMSG:  # pragma: no cover — non-Linux fallback
        sock.sendall(b"".join(mvs))
        return
    while mvs:
        sent = sock.sendmsg(mvs[:IOV_MAX])
        if sent == 0:
            raise ConnectionError("comm transport connection closed")
        while sent and mvs:
            if sent >= len(mvs[0]):
                sent -= len(mvs[0])
                mvs.pop(0)
            else:
                mvs[0] = mvs[0][sent:]
                sent = 0


def recv_into_exact(sock: socket.socket, mv: memoryview) -> None:
    got, n = 0, len(mv)
    while got < n:
        r = sock.recv_into(mv[got:], min(n - got, 1 << 20))
        if r == 0:
            raise ConnectionError("comm transport connection closed")
        got += r


def recv_exact(sock: socket.socket, n: int) -> bytearray:
    """One-shot exact receive into a fresh right-sized buffer (rendezvous
    handshakes); hot paths use pooled buffers instead."""
    buf = bytearray(n)
    if n:
        recv_into_exact(sock, memoryview(buf))
    return buf


def readinto_exact(fp, mv: memoryview, what: str = "body") -> None:
    """Fill ``mv`` exactly from a file-like object exposing ``readinto``
    (an HTTP response body). Raises a prescriptive ``ConnectionError`` on
    a short body instead of letting a downstream reshape crash."""
    got, n = 0, len(mv)
    while got < n:
        r = fp.readinto(mv[got:])
        if not r:
            raise ConnectionError(
                f"{what} truncated at {got}/{n} bytes — the sender died "
                "mid-stream or advertised a wrong length; refetch from a "
                "live peer"
            )
        got += r


def split_stripes(n: int, stripe_count: int) -> "List[Tuple[int, int]]":
    """Deterministic 1-D stripe grid over ``n`` rows: ``stripe_count``
    contiguous (start, stop) ranges, balanced to within one row, empty
    ranges dropped. The heal plane stripes a large region over donors and
    connections on it; every healer computes the same grid from shapes
    alone."""
    stripe_count = max(1, min(stripe_count, n))
    return [
        (n * k // stripe_count, n * (k + 1) // stripe_count)
        for k in range(stripe_count)
        if n * (k + 1) // stripe_count > n * k // stripe_count
    ]


def split_weighted(
    weights: "Sequence[int]", part_count: int
) -> "List[Tuple[int, int]]":
    """Deterministic weighted partition: contiguous (start, stop) ranges
    over ``len(weights)`` items, balanced by cumulative weight. Every range
    is non-empty (``part_count`` is clamped to the item count), and the
    grid is a pure function of the weights, so all ranks compute the
    identical partition from shapes alone. The outer-sync fragment
    scheduler (local_sgd.py) byte-balances parameter leaves with it."""
    n = len(weights)
    part_count = max(1, min(part_count, n))
    total = sum(int(w) for w in weights)
    out: "List[Tuple[int, int]]" = []
    start = 0
    acc = 0
    for i in range(n):
        acc += int(weights[i])
        closed = len(out)
        parts_left = part_count - closed
        items_left = n - (i + 1)
        if parts_left == 1:
            continue  # the final range swallows the tail
        # close once this range reaches its even share of the total
        # weight, or when the remaining items are only just enough to give
        # every remaining range one item
        if (acc * part_count >= total * (closed + 1)
                or items_left == parts_left - 1):
            out.append((start, i + 1))
            start = i + 1
    out.append((start, n))
    return out
