"""Live checkpoint transport for healing replicas.

Twin of the streaming heal plane of ``torchft_tpu/checkpointing.py``, over
torch state dicts. An up-to-date replica serves its in-memory state over
HTTP; a healing replica fetches it at the step boundary. Serving is gated:
the Manager's ``send_checkpoint`` stages the state for one step and opens
the gate; ``disallow_checkpoint`` (after the commit barrier, before the
optimizer may touch the state again) closes it.

- Donor: ``send_checkpoint`` flattens the state with ``jax.tree_util``'s
  rules (``utils.serialization``) and builds the manifest from metadata
  only, then opens the gate at once. A background stager copies the tensor
  leaves to host in order, and an HTTP request that needs leaf *i* now
  stages it inline (``futures.StealableTask``). ``disallow_checkpoint``
  finishes any residual staging before it returns, so the training step
  can never mutate a tensor a pending stage still reads.
- Manifest (pickled, builtins only): ``{step, leaves, treedef, peers}``.
  Each entry carries the JAX package's ``path`` and ``kind``; a tensor
  entry (``"ndarray"``) its ``dtype`` by numpy's name, ``shape``,
  ``nbytes``, ``pieces`` (the global bounds this host holds, one piece for
  a whole tensor, its distinct shard bounds for a ``ShardedTensor``) and
  ``tensor`` (a torch tensor, not a numpy array); an
  object entry (a non-tensor leaf: the step counters, an optimizer's
  hyperparameters) its ``value``. ``peers`` are the other ranks' servers
  of the replica group (``set_peers``), for a healer to fan out to.
- Wire: ``GET /checkpoint/{step}/manifest``,
  ``GET /checkpoint/{step}/rawleaves/{lo}-{hi}`` (the tensor leaves' raw
  bytes back to back) and ``GET /checkpoint/{step}/leaf/{i}`` (one leaf,
  or with ``?slice=0:4,:`` one region of it, with dtype and shape
  headers; an object leaf as a pickle). ``?crc=1`` adds a 4-byte
  little-endian CRC32C after each tensor body; ``&wire=bf16`` downcasts
  float32/float64 bodies to bfloat16 on the wire, the gradient codec's
  astype round trip, for a healer that opted in (``heal_wire_dtype``).
  Tensor bytes never go through pickle and leave as views of the staged
  copy; the donor counts them in ``heal_served_bytes``.
- Telemetry: ``GET /telemetry/metrics`` (the Manager's metrics snapshot)
  and ``GET /telemetry/events?since=<seq>`` (the flight recorder's tail),
  each framed by the Manager's identity probe (``set_telemetry``) in the
  reference's payload shape, so ``scripts/fleet_top.py`` reads a replica of
  either package. Telemetry is not gated on the checkpoint gate.
- Sharded leaves: a ``parallel.sharding.ShardedTensor`` is staged shard by
  shard (each distinct region's piece copied to host on its own, the twin
  of the reference's ``_ShardedLeaf``, so the staged copy never forms the
  whole leaf on the card). A request for exactly one piece's bounds is
  served from that piece, a region spanning pieces is assembled on the
  host, and a whole fetch (``/leaf/{i}`` without a slice, ``rawleaves``)
  assembles the leaf.
- Healer, chunked (the default without a template): ``_recv_chunked``
  splits the tensor leaves into byte-balanced ranges over ``num_chunks``
  keep-alive connections and ``readinto``s each leaf straight into a
  preallocated CPU tensor, verifying its CRC32C frame, then rebuilds the
  donor's structure. Leaves whose manifest path matches the server's
  ``defer_paths`` (the sharded optimizer's slots) come through
  :func:`fetch_opt_shard` instead, still inside the heal.
- Healer with a template (``CheckpointServer(template_fn=...)``):
  :func:`recv_checkpoint_sharded` matches the template's leaves to the
  donor's by path, routes each region over the donor's and its peers'
  piece maps, stripes large regions over every covering host and several
  connections, fails over when a donor dies mid-stream, and uploads each
  leaf to the template's device as soon as its last region lands. A
  template leaf that is a ``ShardedTensor`` fetches only the bounds of its
  pieces and lands each in its piece on that piece's device: the healed
  leaf has the healer's own sharding. Donors
  of either package serve it, and a JAX-package healer heals from a donor
  of this one.

Heals are bitwise unless a healer asks for the bf16 wire. Trust model: the
manifest is a pickle, so the heal plane must only span mutually trusted
trainer hosts.

Redistribution transport: :func:`serve_redist_payload` and
:class:`RedistFetcher` are the ``serve_fn``/``fetch_factory`` hooks of
``comm.redistribute.exchange`` over this plane; :func:`redistribute_exchange`
binds them, and :func:`fetch_opt_shard` plans a sharded optimizer state's
fetch from donor manifests.
"""

from __future__ import annotations

import http.client
import io
import json
import logging
import os
import pickle
import re
import socket
import struct
import threading
import time
import urllib.error
from abc import ABC, abstractmethod
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass
from datetime import timedelta
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Generic, List, Optional, Sequence, Tuple, TypeVar

import numpy as np
import torch

from torchft_tpu_torch.comm.redistribute import (
    RedistPlanner,
    ShardSpec,
    execute_fetches,
)
from torchft_tpu_torch.comm.wire import readinto_exact, split_stripes
from torchft_tpu_torch.control._native import get_lib
from torchft_tpu_torch.futures import FutureGroup, StealableTask, future_chain
from torchft_tpu_torch.parallel.sharding import ShardedTensor
from torchft_tpu_torch.utils.crc32c import crc32c
from torchft_tpu_torch.utils.net import advertised_host
from torchft_tpu_torch.utils.serialization import (
    dtype_from_str,
    dtype_str,
    is_tensor_leaf,
    to_host,
    tree_flatten_with_path,
    tree_unflatten,
)
from torchft_tpu_torch.utils.profiling import throughput_span, timed_span

logger = logging.getLogger(__name__)

T = TypeVar("T")

__all__ = [
    "ChecksumError",
    "CheckpointServer",
    "CheckpointTransport",
    "RedistFetcher",
    "fetch_leaf",
    "fetch_manifest",
    "fetch_opt_shard",
    "format_slice_spec",
    "join_leaf_payload",
    "recv_checkpoint_sharded",
    "redistribute_exchange",
    "serve_copy_stats",
    "serve_redist_payload",
    "split_leaf_payload",
    "wire_crc_stats",
]

# Chunk size for streaming a staged leaf into the socket: few syscalls, and
# a dying healer is detected within a chunk.
_SEND_CHUNK = 1 << 20

# CRC32C integrity frames on the raw tensor wire, on by default;
# TORCHFT_TPU_WIRE_CRC=0 turns them off (both packages read the same name).
_WIRE_CRC = os.environ.get("TORCHFT_TPU_WIRE_CRC", "1") != "0"

# The opt-in lossy heal wire (``&wire=bf16``) and the leaf dtypes it
# downcasts, the ones the gradient codecs compress.
_WIRE_DTYPES = {"bf16": torch.bfloat16}
_WIRE_COMPRESSIBLE = ("float32", "float64")

# Test seam: maps an outgoing chunk of a tensor body to what hits the
# socket, applied after the frame's CRC32C accumulated the true bytes
# (corruption in flight, which by definition happens past the donor).
_WIRE_FAULT_HOOK = None


class ChecksumError(ConnectionError):
    """A tensor body failed its CRC32C wire frame: the payload was corrupted
    in flight. A ConnectionError, so callers treat it as "this copy is bad,
    refetch"."""


# Process-wide test counters, the reference's: the receiver's CRC frames
# checked and rejected, and the donor's tensor bodies served as views of
# the staged copy against the copies a body needed (a region that is not
# contiguous). Plain increments under the GIL, no lock: they sit on the
# heal plane's per-frame and per-region paths and only tests read them.
_crc_stats = {"frames_checked": 0, "checksum_errors": 0}
_copy_stats = {"zero_copy_serves": 0, "full_array_copies": 0}


def _snapshot(stats: Dict[str, int], reset: bool) -> Dict[str, int]:
    out = dict(stats)
    if reset:
        stats.update(dict.fromkeys(stats, 0))
    return out


def wire_crc_stats(reset: bool = False) -> Dict[str, int]:
    """Snapshot (optionally reset) the receiver-side CRC frame counters."""
    return _snapshot(_crc_stats, reset)


def serve_copy_stats(reset: bool = False) -> Dict[str, int]:
    """Snapshot (optionally reset) the donor serve-path copy counters."""
    return _snapshot(_copy_stats, reset)


def _count_crc(ok: bool) -> None:
    _crc_stats["frames_checked"] += 1
    if not ok:
        _crc_stats["checksum_errors"] += 1


def _count_serve(copies: int) -> None:
    if copies == 0:
        _copy_stats["zero_copy_serves"] += 1
    else:
        _copy_stats["full_array_copies"] += copies


# ------------------------------------------------------------ bytes and bounds


def _byte_view(x: Any) -> np.ndarray:
    """The bytes of a C-contiguous CPU tensor or array as a flat uint8
    array, without a copy."""
    if isinstance(x, torch.Tensor):
        return x.reshape(-1).view(torch.uint8).numpy()
    return x.reshape(-1).view(np.uint8)


def _contiguous(x: Any) -> bool:
    if isinstance(x, torch.Tensor):
        return x.is_contiguous()
    return bool(x.flags.c_contiguous)


def _wire_encode(region: Any, wire: "Optional[torch.dtype]"
                 ) -> "Tuple[np.ndarray, Optional[str]]":
    """One region's wire bytes: ``(uint8 view, wire dtype name or None)``.
    The default is a view of the staged bytes (a copy only for a region that
    is not contiguous); the opt-in downcast allocates."""
    if wire is not None and dtype_str(region.dtype) in _WIRE_COMPRESSIBLE:
        t = region if isinstance(region, torch.Tensor) \
            else torch.from_numpy(np.ascontiguousarray(region))
        return _byte_view(t.to(wire).contiguous()), dtype_str(wire)
    _count_serve(0 if _contiguous(region) else 1)
    if isinstance(region, torch.Tensor):
        return _byte_view(region.contiguous()), None
    return _byte_view(np.ascontiguousarray(region)), None


def _entry_wire_nbytes(entry: dict, wire: "Optional[torch.dtype]") -> int:
    """Wire bytes of one tensor entry, from metadata only, so both sides
    size a raw multi-leaf stream before any staging."""
    if wire is not None and entry["dtype"] in _WIRE_COMPRESSIBLE:
        return int(np.prod(entry["shape"], dtype=np.int64)) * wire.itemsize
    return int(entry["nbytes"])


def _full(shape) -> "Tuple[Tuple[int, int], ...]":
    return tuple((0, int(d)) for d in shape)


def _normalize_index(index, shape) -> "Tuple[Tuple[int, int], ...]":
    """A region's slices as hashable (start, stop) pairs with concrete
    bounds for every dimension."""
    out = []
    for s, dim in zip(index, shape):
        start = 0 if s.start is None else int(s.start)
        stop = int(dim) if s.stop is None else int(s.stop)
        out.append((start, stop))
    return tuple(out)


def _bounds_to_slices(bounds) -> "Tuple[slice, ...]":
    return tuple(slice(a, b) for a, b in bounds)


def _intersect(a, b):
    """Intersection of two bounds tuples, or None if empty."""
    out = tuple(
        (max(a1, a2), min(b1, b2)) for (a1, b1), (a2, b2) in zip(a, b)
    )
    if any(lo >= hi for lo, hi in out):
        return None
    return out


def _covers_exactly(bounds, covers) -> bool:
    """True iff the union of ``covers`` contains every point of ``bounds``:
    coordinate-compress each dimension, then require every elementary cell
    to lie inside some cover (exact for overlapping pieces too)."""
    import itertools

    cuts = []
    for d, (lo, hi) in enumerate(bounds):
        pts = {lo, hi}
        for c in covers:
            a, b = c[d]
            pts.add(min(max(a, lo), hi))
            pts.add(min(max(b, lo), hi))
        cuts.append(sorted(pts))
    cells_per_dim = [list(zip(c[:-1], c[1:])) for c in cuts]
    for cell in itertools.product(*cells_per_dim):
        if not any(
            all(ca <= c_lo and c_hi <= cb
                for (c_lo, c_hi), (ca, cb) in zip(cell, cov))
            for cov in covers
        ):
            return False
    return True


def _route_region(bounds, piece_maps):
    """Plan the fetches of one needed region over donor hosts.
    ``piece_maps``: ``{host: [piece bounds, ...]}`` for this leaf. Returns
    ``[(host, fetch_bounds), ...]`` whose union covers ``bounds``: one entry
    when one host holds the whole region, per-piece intersections otherwise
    (none fetched twice). Raises ValueError if the hosts cannot cover it."""
    for host, pieces in piece_maps.items():
        for p in pieces:
            if _intersect(bounds, p) == bounds:
                return [(host, bounds)]
    plan = []
    seen = set()
    for host, pieces in piece_maps.items():
        for p in pieces:
            inter = _intersect(bounds, p)
            if inter is None or inter in seen:
                continue
            seen.add(inter)
            if plan and _covers_exactly(inter, [b for _, b in plan]):
                continue  # another host already supplies every byte of it
            plan.append((host, inter))
    if not _covers_exactly(bounds, [b for _, b in plan]):
        raise ValueError(
            f"region {bounds} not covered by any donor host "
            f"(hosts: {list(piece_maps)}) — resharded beyond the donor "
            "group's union of shards"
        )
    return plan


def _covering_hosts(bounds, piece_maps, dead=()) -> List[str]:
    """Hosts whose pieces fully contain ``bounds`` (stripe and retry
    candidates), dead hosts excluded."""
    return [
        host for host, pieces in piece_maps.items()
        if host not in dead
        and any(_intersect(bounds, p) == bounds for p in pieces)
    ]


def _stripe_region(bounds, nbytes: int, stripe_bytes: int,
                   parallel: int) -> "Optional[List[tuple]]":
    """Deterministic stripe grid of one region: contiguous dim-0 bands of
    about ``stripe_bytes`` each (each lands in a contiguous slab of the
    region's buffer), at most ``parallel`` of them. None when the region is
    too small or has fewer than two rows. The grid is checked to cover the
    region exactly."""
    if stripe_bytes <= 0 or nbytes < 2 * stripe_bytes:
        return None
    rows = bounds[0][1] - bounds[0][0]
    if rows < 2:
        return None
    want = min(max(2, nbytes // stripe_bytes), max(2, parallel), rows)
    base = bounds[0][0]
    stripes = [((base + a, base + b),) + tuple(bounds[1:])
               for a, b in split_stripes(rows, want)]
    if not _covers_exactly(bounds, stripes):  # pragma: no cover — by
        # construction; guards a refactor of the grid
        raise ValueError(f"stripe grid does not exactly cover {bounds}")
    return stripes


def _parse_slice_spec(spec: str, shape: tuple) -> "Tuple[slice, ...]":
    """Parse ``"0:4,:,2:8"`` into one slice per dimension ('' = full)."""
    parts = spec.split(",")
    if len(parts) != len(shape):
        raise ValueError(
            f"slice spec has {len(parts)} dims, array has {len(shape)}")
    out = []
    for p, dim in zip(parts, shape):
        p = p.strip()
        if p in ("", ":"):
            out.append(slice(None))
            continue
        start_s, _, stop_s = p.partition(":")
        start = int(start_s) if start_s else 0
        stop = int(stop_s) if stop_s else dim
        if not 0 <= start <= stop <= dim:
            raise ValueError(f"slice {p} out of bounds for dim {dim}")
        out.append(slice(start, stop))
    return tuple(out)


def format_slice_spec(slices: Sequence[slice]) -> str:
    """A leaf shard's slice spec, ``"0:4,:,2:8"`` (one contiguous
    ``start:stop`` per dimension, empty for a full one), the JAX package's
    URL form of a shard."""
    for sl in slices:
        if sl.step not in (None, 1):
            raise ValueError(
                f"strided slices are not supported by the checkpoint "
                f"plane (got step={sl.step}); shard specs must be "
                "contiguous start:stop ranges"
            )
    return ",".join(
        f"{'' if sl.start in (None, 0) else sl.start}:"
        f"{'' if sl.stop is None else sl.stop}"
        for sl in slices
    )


# ------------------------------------------------------- bounded worker pools
# Process-wide, two workers each: the donor's staging (device to host) and
# the healer's uploads (host to device), so many servers in one process
# cannot pile up threads and an upload never queues behind a stage.

_POOL_LOCK = threading.Lock()
_POOLS: Dict[str, ThreadPoolExecutor] = {}


def _heal_executor(kind: str) -> ThreadPoolExecutor:
    with _POOL_LOCK:
        ex = _POOLS.get(kind)
        if ex is None:
            ex = ThreadPoolExecutor(
                max_workers=2,
                thread_name_prefix=f"torchft_tpu_torch_heal_{kind}")
            _POOLS[kind] = ex
        return ex


# ------------------------------------------------------------------- staging


class _HostShards:
    """Host copy of one ``ShardedTensor``, held shard-wise: a contiguous
    CPU tensor per distinct region kept, keyed by its global bounds (the
    twin of the reference's ``_ShardedLeaf``)."""

    def __init__(self, leaf: ShardedTensor, keep) -> None:
        self.shape = leaf.shape
        self.dtype = leaf.dtype
        self.pieces: Dict[tuple, torch.Tensor] = {}
        for piece, b in zip(leaf.pieces, leaf.bounds):
            if b in keep and b not in self.pieces:
                self.pieces[b] = to_host(piece)

    def read(self, bounds) -> torch.Tensor:
        """The region ``bounds``: a piece itself when it is one, else
        assembled on the host from the pieces it overlaps; raises
        ValueError when they do not cover it."""
        hit = self.pieces.get(bounds)
        if hit is not None:
            return hit
        out = torch.empty(tuple(b - a for a, b in bounds), dtype=self.dtype)
        covers = []
        for pb, arr in self.pieces.items():
            inter = _intersect(pb, bounds)
            if inter is None:
                continue
            src = tuple(slice(a - pa, b - pa)
                        for (a, b), (pa, _) in zip(inter, pb))
            dst = tuple(slice(a - ra, b - ra)
                        for (a, b), (ra, _) in zip(inter, bounds))
            out[dst] = arr[src]
            covers.append(inter)
        if not _covers_exactly(bounds, covers):
            raise ValueError(f"region {bounds} is not covered by this "
                             "host's pieces")
        return out


@dataclass(frozen=True)
class _Staged:
    """One staged checkpoint: per-leaf tasks resolving to the staged host
    object (a contiguous CPU tensor, a numpy array or the object leaf), and
    the metadata-only manifest."""

    step: int
    slots: List[StealableTask]
    entries: List[dict]
    manifest_bytes: bytes

    def leaf(self, i: int, timeout: "Optional[float]" = None) -> Any:
        """Host copy of leaf ``i``, staged inline if the background stager
        has not reached it yet."""
        return self.slots[i].result(timeout)

    def finish_staging(self, timeout: "Optional[float]" = None) -> None:
        for slot in self.slots:
            try:
                slot.result(timeout)
            except Exception as e:  # noqa: BLE001 — the healer gets a 503
                logger.warning("checkpoint leaf staging failed: %s", e)


def _build_staged(step: int, state: Any, peers: Sequence[str] = (),
                  shard_filter: "Optional[Any]" = None,
                  metrics: "Optional[Any]" = None,
                  owned: bool = False) -> _Staged:
    """Stage ``state`` for serving; the manifest comes from metadata only.
    Tensors are copied to host lazily (the gate keeps the trainer off them
    until staging finished), a ``ShardedTensor`` piece by piece; numpy
    arrays, mutable host state, are snapshot now. ``shard_filter(path,
    bounds) -> bool`` drops pieces at staging time (the single-process
    stand-in for a host that holds part of a leaf). ``owned``: the caller
    hands over numpy leaves that nothing mutates again, served as they
    are, with no snapshot copy."""
    flat, spec = tree_flatten_with_path(state)
    entries: List[dict] = []
    slots: List[StealableTask] = []
    for path, leaf in flat:
        if not is_tensor_leaf(leaf):
            entries.append({"path": path, "kind": "object", "value": leaf})
            slots.append(StealableTask(lambda o=leaf: o))
            continue
        shape = tuple(int(d) for d in leaf.shape)
        if isinstance(leaf, ShardedTensor):
            pieces = sorted(set(leaf.bounds))
        else:
            pieces = [_full(shape)]
        if shard_filter is not None:
            pieces = [b for b in pieces if shard_filter(path, b)]
        if isinstance(leaf, ShardedTensor):
            entries.append({
                "path": path, "kind": "ndarray",
                "dtype": dtype_str(leaf.dtype), "shape": shape,
                "nbytes": leaf.nbytes, "pieces": pieces, "tensor": True,
            })

            def _stage_shards(x=leaf, keep=frozenset(pieces)):
                with timed_span(metrics, "heal_stage"):
                    return _HostShards(x, keep)

            slots.append(StealableTask(_stage_shards))
            continue
        tensor = isinstance(leaf, torch.Tensor)
        entries.append({
            "path": path,
            "kind": "ndarray",
            "dtype": dtype_str(leaf.dtype),
            "shape": shape,
            "nbytes": int(leaf.numel() * leaf.element_size()) if tensor
            else int(leaf.nbytes),
            "pieces": pieces,
            "tensor": tensor,
        })
        if tensor:
            def _stage(t=leaf):
                with timed_span(metrics, "heal_stage"):
                    return to_host(t)

            slots.append(StealableTask(_stage))
        else:
            with timed_span(metrics, "heal_stage"):
                snap = np.ascontiguousarray(leaf) if owned \
                    else np.array(leaf, copy=True)
            slots.append(StealableTask(lambda s=snap: s))
    manifest = {"step": step, "leaves": entries, "treedef": spec,
                "peers": list(peers)}
    return _Staged(step=step, slots=slots, entries=entries,
                   manifest_bytes=pickle.dumps(manifest, protocol=5))


class CheckpointTransport(ABC, Generic[T]):
    """Pluggable transport moving live checkpoints donor -> healer."""

    @abstractmethod
    def metadata(self) -> str:
        """Advertised via the manager's CheckpointMetadata RPC."""

    @abstractmethod
    def send_checkpoint(self, dst_ranks: List[int], step: int, state_dict: T,
                        timeout: "float | timedelta") -> None:
        """Stage ``state_dict`` for the recovering ranks at ``step``."""

    def disallow_checkpoint(self) -> None:  # noqa: B027 — optional hook
        """Close the serving gate (training may mutate state again)."""

    def finish_staging(self) -> None:  # noqa: B027 — optional hook
        """Return once the staged state no longer reads the live tensors
        (training may mutate them while the gate stays open)."""

    @abstractmethod
    def recv_checkpoint(self, src_rank: int, metadata: str, step: int,
                        timeout: "float | timedelta") -> T:
        """Fetch the checkpoint staged by the donor for ``step``."""

    def shutdown(self, wait: bool = True) -> None:  # noqa: B027
        """Tear down any serving resources."""


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server_version = "torchft_tpu_torch_ckpt"
    # headers and body leave in separate writes: without TCP_NODELAY each
    # small response waits out the client's delayed ACK
    disable_nagle_algorithm = True

    def log_message(self, format: str, *args) -> None:  # noqa: A002
        logger.debug("checkpoint http: " + format, *args)

    def _await_staged(self, step: int) -> "Optional[_Staged]":
        """Block until the donor staged a checkpoint: a healer's fetch can
        land before the donor's send_checkpoint (both act on the same
        quorum answer), so the gate waits instead of failing."""
        server: "CheckpointServer" = self.server.ckpt_server  # type: ignore[attr-defined]
        with server._cond:
            opened = server._cond.wait_for(
                lambda: not server._disallowed, timeout=server._timeout
            )
            if not opened:
                self.send_error(
                    503, f"timed out waiting for checkpoint gate for step {step}"
                )
                return None
            staged = server._staged
            if staged is None or staged.step != step:
                have = None if staged is None else staged.step
                self.send_error(
                    400,
                    f"checkpoint for step {step} not available (staged={have})",
                )
                return None
            return staged

    def _write_body(self, view: np.ndarray, crc: bool) -> None:
        mv = memoryview(view)
        c = 0
        for off in range(0, len(mv), _SEND_CHUNK):
            chunk = mv[off: off + _SEND_CHUNK]
            if crc:
                c = crc32c(chunk, c)
            if _WIRE_FAULT_HOOK is not None:
                chunk = _WIRE_FAULT_HOOK(chunk)
            self.wfile.write(chunk)
        if crc:
            self.wfile.write(struct.pack("<I", c))
        metrics = self.server.ckpt_server._metrics  # type: ignore[attr-defined]
        if metrics is not None:
            metrics.incr("heal_served_bytes", float(len(mv)))

    def _send_json(self, obj: dict) -> None:
        body = json.dumps(obj).encode()
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _do_telemetry(self, parts, url) -> None:
        """GET /telemetry/metrics and GET /telemetry/events?since=<seq>,
        framed with the Manager's identity probe (replica_id, rank, step,
        quorum epoch, lease state). A probe that raises still answers,
        with ``telemetry_info_error`` in the frame."""
        from urllib.parse import parse_qs

        server: "CheckpointServer" = self.server.ckpt_server  # type: ignore[attr-defined]
        base: dict = {}
        info_fn = server._telemetry_info
        if callable(info_fn):
            try:
                base = dict(info_fn())
            except Exception as e:  # noqa: BLE001 — framing only
                base = {"telemetry_info_error": repr(e)[:200]}
        if len(parts) == 2 and parts[1] == "metrics":
            metrics = server._metrics
            base["t_wall"] = time.time()
            base["metrics"] = metrics.snapshot() if metrics is not None else {}
            self._send_json(base)
            return
        if len(parts) == 2 and parts[1] == "events":
            q = parse_qs(url.query)
            try:
                since = int(q.get("since", ["0"])[0])
            except ValueError:
                self.send_error(400, "bad since cursor (want an integer)")
                return
            events = server._events
            if events is not None:
                evs, nxt, dropped = events.since(since)
                base.setdefault("replica_id", events.replica_id)
                base.setdefault("rank", events.rank)
                base.update(events=evs, next=nxt, dropped=dropped,
                            enabled=events.enabled)
            else:
                base.update(events=[], next=0, dropped=0, enabled=False)
            base["t_wall"] = time.time()
            self._send_json(base)
            return
        self.send_error(
            404,
            "unknown telemetry path (have /telemetry/metrics and "
            "/telemetry/events?since=<seq>)",
        )

    def _send_leaf(self, staged: _Staged, idx: int, spec: "Optional[str]",
                   wire: "Optional[torch.dtype]", crc: bool) -> bool:
        """GET /checkpoint/{step}/leaf/{idx}: staged (and sliced) before
        any header goes out, so a failure there is still an error status.
        Returns whether the body started streaming."""
        server: "CheckpointServer" = self.server.ckpt_server  # type: ignore[attr-defined]
        obj = staged.leaf(idx, server._timeout)  # stages it now if needed
        entry = staged.entries[idx]
        if entry["kind"] == "object":
            body = pickle.dumps(obj, protocol=5)
            self.send_response(200)
            self.send_header("X-Kind", "object")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            return False
        shape = tuple(entry["shape"])
        slices = _parse_slice_spec(spec, shape) if spec is not None else None
        bounds = _normalize_index(slices, shape) if slices else _full(shape)
        if not _covers_exactly(bounds, [tuple(tuple(b) for b in p)
                                        for p in entry["pieces"]]):
            self.send_error(400, f"region {bounds} of leaf {idx} is not "
                                 "held by this host")
            return False
        if isinstance(obj, _HostShards):
            region = obj.read(bounds)
        else:
            region = obj[slices] if slices else obj
        view, wired = _wire_encode(region, wire)
        self.send_response(200)
        self.send_header("X-Kind", "ndarray")
        self.send_header("X-Dtype", entry["dtype"])
        if wired is not None:
            self.send_header("X-Wire-Dtype", wired)
        if entry.get("tensor"):
            self.send_header("X-Tensor", "1")
        self.send_header("X-Shape",
                         ",".join(str(b - a) for a, b in bounds))
        self.send_header("Content-Length",
                         str(view.nbytes + (4 if crc else 0)))
        self.end_headers()
        self._write_body(view, crc)
        return True

    def _send_rawleaves(self, staged: _Staged, lo: int, hi: int,
                        wire: "Optional[torch.dtype]", crc: bool) -> bool:
        """GET /checkpoint/{step}/rawleaves/{lo}-{hi}: the tensor leaves'
        bytes back to back. The Content-Length comes from metadata, so the
        headers go out at once and each leaf stages just in time while
        earlier ones are on the wire; a staging failure mid-stream shows as
        a short body, which the healer's bounded read rejects."""
        server: "CheckpointServer" = self.server.ckpt_server  # type: ignore[attr-defined]
        if not 0 <= lo < hi <= len(staged.slots):
            self.send_error(404, f"bad leaf range {lo}-{hi}")
            return False
        sizes = []
        for entry in staged.entries[lo:hi]:
            if entry["kind"] != "ndarray" or not _covers_exactly(
                    _full(entry["shape"]),
                    [tuple(tuple(b) for b in p) for p in entry["pieces"]]):
                self.send_error(400, f"leaf range {lo}-{hi} holds a leaf "
                                     "that is not a whole tensor on this "
                                     "host: fetch it through /leaf/{i}")
                return False
            sizes.append(_entry_wire_nbytes(entry, wire))
        clen = sum(sizes) + (4 * (hi - lo) if crc else 0)
        self.send_response(200)
        self.send_header("X-Kind", "rawleaves")
        self.send_header("X-Count", str(hi - lo))
        self.send_header("Content-Length", str(clen))
        self.end_headers()
        for i in range(lo, hi):
            leaf = staged.leaf(i, server._timeout)
            if isinstance(leaf, _HostShards):
                leaf = leaf.read(_full(leaf.shape))
            view, _ = _wire_encode(leaf, wire)
            self._write_body(view, crc)
        return True

    def do_GET(self) -> None:  # noqa: N802
        from urllib.parse import parse_qs, urlparse

        url = urlparse(self.path)
        parts = [p for p in url.path.split("/") if p]
        if parts and parts[0] == "telemetry":
            try:
                self._do_telemetry(parts, url)
            except (BrokenPipeError, ConnectionResetError):
                logger.debug("telemetry poller disconnected")
            return
        if len(parts) < 3 or parts[0] != "checkpoint":
            self.send_error(404, "unknown path")
            return
        try:
            step = int(parts[1])
        except ValueError:
            self.send_error(400, "bad step")
            return
        q = parse_qs(url.query)
        crc = q.get("crc", ["0"])[0] == "1"
        wire_name = q.get("wire", [None])[0]
        if wire_name is not None and wire_name not in _WIRE_DTYPES:
            self.send_error(400, f"unknown wire dtype {wire_name!r} "
                                 f"(supported: {sorted(_WIRE_DTYPES)})")
            return
        wire = _WIRE_DTYPES[wire_name] if wire_name is not None else None
        staged = self._await_staged(step)
        if staged is None:
            return
        streaming = False
        try:
            if parts[2] == "manifest" and len(parts) == 3:
                body = staged.manifest_bytes
                self.send_response(200)
                self.send_header("Content-Type", "application/octet-stream")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                return
            if parts[2] == "rawleaves" and len(parts) == 4:
                lo_s, _, hi_s = parts[3].partition("-")
                streaming = self._send_rawleaves(staged, int(lo_s),
                                                 int(hi_s), wire, crc)
                return
            if parts[2] == "leaf" and len(parts) == 4:
                idx = int(parts[3])
                if not 0 <= idx < len(staged.slots):
                    self.send_error(404, f"no leaf {idx}")
                    return
                streaming = self._send_leaf(staged, idx,
                                            q.get("slice", [None])[0],
                                            wire, crc)
                return
            self.send_error(404, "unknown path")
        except (ValueError, IndexError) as e:
            if not streaming:
                self.send_error(400, str(e))
        except (BrokenPipeError, ConnectionResetError):
            logger.warning("checkpoint receiver disconnected mid-stream")
        except Exception as e:  # noqa: BLE001 — a failed lazy stage
            logger.exception("checkpoint serve failed: %s", e)
            if streaming:
                # never write an error into the advertised byte stream:
                # cut the connection so the healer sees a short body
                self.close_connection = True
                try:
                    self.connection.close()
                except OSError:
                    pass
            else:
                try:
                    self.send_error(503, str(e)[:300])
                except (OSError, ValueError):
                    pass


class _ThreadingServer(ThreadingHTTPServer):
    """The listening socket's backlog is set when the server binds, so it
    is a class attribute: at the default 5, the connections of several
    healers or adopters at once (4 members x 4 fetchers) overflow it and
    each dropped SYN costs a 1 s retransmit."""

    daemon_threads = True
    request_queue_size = 1024


class CheckpointServer(CheckpointTransport[T]):
    """Daemon-thread HTTP server streaming the staged state dict."""

    def __init__(self, timeout: "float | timedelta" = 60.0,
                 num_chunks: int = 2,
                 defer_paths: Optional[str] = None,
                 template_fn: "Optional[Any]" = None,
                 heal_wire_dtype: Optional[str] = None,
                 stripe_bytes: int = 4 << 20) -> None:
        """``num_chunks``: keep-alive connections a healer fetches over
        (at least 2 on the template path). ``defer_paths``: a regular
        expression over manifest paths whose groups are (leaf, slot); a
        chunked heal through this server fetches the non-empty entries it
        matches with :func:`fetch_opt_shard` (the sharded optimizer's
        slots) instead of the chunked stream.

        ``template_fn``: a zero-argument callable returning the healer's
        current state (the structure the donor serves, as
        ``{"user": ..., "torchft": ...}``); when set, a heal takes
        :func:`recv_checkpoint_sharded` and its result has the template's
        structure, devices and dtypes. ``heal_wire_dtype``: ``"bf16"`` to
        fetch float leaves downcast on the wire (lossy, opt-in; None keeps
        heals bitwise). ``stripe_bytes``: regions at least twice this
        large stripe over donors and connections (<= 0: never)."""
        if isinstance(timeout, timedelta):
            timeout = timeout.total_seconds()
        if num_chunks < 1:
            raise ValueError("num_chunks must be >= 1")
        if heal_wire_dtype is not None and heal_wire_dtype not in _WIRE_DTYPES:
            raise ValueError(
                f"heal_wire_dtype={heal_wire_dtype!r} unsupported "
                f"(choose from {sorted(_WIRE_DTYPES)} or None)")
        # the wire's CRC32C lives in the native library: load it (building
        # it on the first use in a checkout, ~10 s) here, before any
        # request handler and its caller's timeout need it
        get_lib()
        self._timeout = float(timeout)
        self._num_chunks = int(num_chunks)
        self._defer_paths = defer_paths
        self._template_fn = template_fn
        self._heal_wire_dtype = heal_wire_dtype
        self._stripe_bytes = int(stripe_bytes)
        self._metrics = None
        self._events = None
        self._telemetry_info = None
        self._cond = threading.Condition()
        self._disallowed = True
        self._staged: Optional[_Staged] = None
        self._peers: List[str] = []
        self._shard_filter = None  # test seam: a host holding part of a leaf
        self._server = _ThreadingServer(("0.0.0.0", 0), _Handler)
        self._server.ckpt_server = self  # type: ignore[attr-defined]
        self._thread = threading.Thread(
            target=self._server.serve_forever,
            name="torchft_tpu_torch_ckpt_server", daemon=True,
        )
        self._thread.start()
        self._addr = f"http://{advertised_host()}:{self._server.server_address[1]}"

    def metadata(self) -> str:
        return self._addr

    def set_metrics(self, metrics) -> None:
        """Share the Manager's Metrics sink (heal spans and gauges; served
        by GET /telemetry/metrics)."""
        self._metrics = metrics

    def set_events(self, events) -> None:
        """Share the Manager's flight recorder, served read-only by GET
        /telemetry/events."""
        self._events = events

    def set_telemetry(self, info_fn) -> None:
        """Register a zero-argument callable returning the identity and
        state dict that frames every /telemetry response
        (``Manager._telemetry_info``)."""
        self._telemetry_info = info_fn

    def set_peers(self, peers: List[str]) -> None:
        """The other ranks' checkpoint servers of this replica group,
        advertised in every manifest staged from now on, so a healer can
        fetch a region from every host that holds it."""
        self._peers = [p for p in peers if p != self._addr]

    def send_checkpoint(self, dst_ranks: List[int], step: int, state_dict: T,
                        timeout: "float | timedelta",
                        owned: bool = False) -> None:
        """Stage ``state_dict`` at ``step`` and open the gate. ``owned``:
        its numpy leaves are host copies the caller hands over and never
        mutates, served without a snapshot copy (a deploy publication)."""
        del dst_ranks  # HTTP serves whoever fetches
        staged = _build_staged(step, state_dict, peers=self._peers,
                               shard_filter=self._shard_filter,
                               metrics=self._metrics, owned=owned)
        with self._cond:
            self._staged = staged
            self._disallowed = False
            self._cond.notify_all()

        def _drain(slots=staged.slots):
            for slot in slots:
                slot.run()

        _heal_executor("stage").submit(_drain)

    def finish_staging(self) -> None:
        with self._cond:
            staged = self._staged
        if staged is not None:
            staged.finish_staging(self._timeout)

    def disallow_checkpoint(self) -> None:
        with self._cond:
            staged = self._staged
            if self._disallowed:
                return
            self._disallowed = True
            self._staged = None
        if staged is not None:
            staged.finish_staging(self._timeout)

    def recv_checkpoint(self, src_rank: int, metadata: str, step: int,
                        timeout: "float | timedelta") -> T:
        del src_rank
        if isinstance(timeout, timedelta):
            timeout = timeout.total_seconds()
        t0 = time.perf_counter()
        if self._template_fn is not None:
            out = recv_checkpoint_sharded(
                metadata, step, self._template_fn(), float(timeout),
                parallel=max(2, self._num_chunks), metrics=self._metrics,
                wire_dtype=self._heal_wire_dtype,
                stripe_bytes=self._stripe_bytes)
        else:
            out = _recv_chunked(metadata, step, self._num_chunks,
                                float(timeout), metrics=self._metrics,
                                defer_paths=self._defer_paths,
                                events=self._events,
                                wire_dtype=self._heal_wire_dtype)
        if self._metrics is not None:
            self._metrics.gauge(
                "heal_wall_ms", (time.perf_counter() - t0) * 1000.0
            )
        return out

    def shutdown(self, wait: bool = True) -> None:
        self._server.shutdown()
        self._server.server_close()
        if wait:
            self._thread.join(timeout=5.0)

    # -- test conveniences, the reference's (pre-seeding a donor) ----------

    def allow_checkpoint(self, step: int, state_dict: T) -> None:
        self.send_checkpoint([], step, state_dict, self._timeout)

    def address(self) -> str:
        return self._addr


# ---------------------------------------------------------------- client side


class _DonorConn:
    """Keep-alive HTTP client to one donor. A stale keep-alive socket is
    retried once on a fresh connection; real donor death surfaces as the
    second failure."""

    def __init__(self, metadata: str, timeout: float) -> None:
        from urllib.parse import urlparse

        u = urlparse(metadata)
        if u.hostname is None:
            raise ValueError(f"bad donor address {metadata!r}")
        self._host, self._port = u.hostname, u.port or 80
        self._timeout = timeout
        self._conn: "Optional[http.client.HTTPConnection]" = None

    def close(self) -> None:
        if self._conn is not None:
            try:
                self._conn.close()
            except OSError:
                pass
            self._conn = None

    def get(self, path: str) -> http.client.HTTPResponse:
        """GET returning the live response (the caller must consume exactly
        the advertised body to reuse the connection). Non-200 raises
        urllib.error.HTTPError."""
        for attempt in (0, 1):
            if self._conn is None:
                self._conn = http.client.HTTPConnection(
                    self._host, self._port, timeout=self._timeout
                )
            try:
                self._conn.request("GET", path)
                resp = self._conn.getresponse()
                break
            except (http.client.HTTPException, OSError):
                self.close()
                if attempt:
                    raise
        if resp.status != 200:
            body = resp.read()
            self.close()
            raise urllib.error.HTTPError(
                f"http://{self._host}:{self._port}{path}", resp.status,
                body.decode(errors="replace")[:500], resp.headers,
                io.BytesIO(body),
            )
        return resp


class _ConnPool:
    """Keep-alive donor connections shared across fetch workers, keyed by
    host: acquire per request, release only after the body was consumed
    exactly (a connection with stale bytes is closed, never released),
    ``close_all`` when the fetch ends."""

    def __init__(self, timeout: float) -> None:
        self._timeout = timeout
        self._lock = threading.Lock()
        self._idle: Dict[str, List[_DonorConn]] = {}
        self._all: List[_DonorConn] = []

    def acquire(self, host: str) -> _DonorConn:
        with self._lock:
            idle = self._idle.setdefault(host, [])
            if idle:
                return idle.pop()
        c = _DonorConn(host, self._timeout)
        with self._lock:
            self._all.append(c)
        return c

    def release(self, host: str, conn: _DonorConn) -> None:
        with self._lock:
            self._idle.setdefault(host, []).append(conn)

    def close_all(self) -> None:
        with self._lock:
            for c in self._all:
                c.close()


class _StubbedClass:
    """Stands in for a class a manifest names from a package this one does
    not import (the JAX package's tree structure): accepts any pickled
    construction and state, and is never used."""

    def __init__(self, *args, **kwargs) -> None:
        pass

    def __setstate__(self, state) -> None:
        pass

    def __call__(self, *args, **kwargs) -> "_StubbedClass":
        return _StubbedClass()


class _ManifestUnpickler(pickle.Unpickler):
    """Reads either package's manifest: the JAX package pickles a jax tree
    structure beside its entries, whose classes are stubbed rather than
    imported (the port never imports jax; its routing reads the entries'
    paths)."""

    def find_class(self, module: str, name: str):
        if module.split(".")[0] in ("jax", "jaxlib", "torchft_tpu"):
            return _StubbedClass
        return super().find_class(module, name)


def fetch_manifest(metadata: str, step: int, timeout: float = 60.0,
                   conn: "Optional[_DonorConn]" = None) -> dict:
    """The donor's manifest: ``{step, leaves: [{path, kind, ...}],
    treedef, peers}``. ``conn`` rides an existing keep-alive
    connection."""
    own = conn is None
    conn = conn or _DonorConn(metadata, timeout)
    try:
        resp = conn.get(f"/checkpoint/{step}/manifest")
        clen = int(resp.headers["Content-Length"])
        body = resp.read(clen)
        if len(body) != clen:
            raise ConnectionError(f"manifest truncated at {len(body)}/{clen}")
        return _ManifestUnpickler(io.BytesIO(body)).load()
    finally:
        if own:
            conn.close()


def _empty(shape, dtype, pin: bool = False) -> Any:
    """A CPU destination of ``dtype`` (a torch dtype makes a tensor, pinned
    when ``pin``; a numpy dtype an array)."""
    if isinstance(dtype, torch.dtype):
        return torch.empty(shape, dtype=dtype, pin_memory=pin)
    return np.empty(shape, dtype)


def _read_wire(resp, dtype, shape, wire_name: "Optional[str]", what: str,
               out: Any = None, check_crc: bool = False) -> Any:
    """Land one tensor body from ``resp`` in ``out`` (or a fresh CPU tensor
    or array of ``dtype``), through a wire-dtype temporary and an upcast
    under the lossy encoding (``wire_name``). The CRC32C trailer is checked
    against the wire bytes before they are trusted: corrupt bytes never
    reach a caller's buffer."""
    if wire_name is None:
        dest = out if out is not None else _empty(shape, dtype)
        wire_buf = dest
    else:
        dest = None
        wire_buf = torch.empty(shape, dtype=dtype_from_str(wire_name,
                                                           tensor=True))
    view = _byte_view(wire_buf)
    readinto_exact(resp, memoryview(view), what=what)
    if check_crc:
        trailer = bytearray(4)
        readinto_exact(resp, memoryview(trailer), what=f"{what} crc frame")
        want = struct.unpack("<I", trailer)[0]
        got = crc32c(memoryview(view))
        _count_crc(got == want)
        if got != want:
            raise ChecksumError(
                f"{what}: CRC32C mismatch (wire frame {want:#010x}, computed "
                f"{got:#010x}) — payload corrupted in flight; refetch"
            )
    if dest is not None:
        return dest
    up = wire_buf.to(dtype_from_str(dtype_str(dtype), tensor=True))
    if out is None:
        return up if isinstance(dtype, torch.dtype) else up.numpy()
    if isinstance(out, torch.Tensor):
        out.copy_(up)
    else:
        out[...] = up.numpy()
    return out


def _read_leaf(resp, entry: dict, what: str, check_crc: bool,
               wire: "Optional[torch.dtype]" = None) -> Any:
    """Land one manifest entry's body from ``resp`` into a fresh CPU tensor
    (a torch leaf) or array."""
    dtype = dtype_from_str(entry["dtype"], tensor=bool(entry.get("tensor")))
    wired = wire is not None \
        and entry["dtype"] in _WIRE_COMPRESSIBLE
    return _read_wire(resp, dtype, tuple(entry["shape"]),
                      dtype_str(wire) if wired else None, what,
                      check_crc=check_crc)


def _leaf_path(step: int, index: int, slices: "Optional[Sequence[slice]]",
               wire_dtype: "Optional[str]", crc: bool) -> str:
    path = f"/checkpoint/{step}/leaf/{index}"
    params = []
    if slices is not None:
        params.append("slice=" + format_slice_spec(slices))
    if wire_dtype is not None:
        params.append(f"wire={wire_dtype}")
    if crc:
        params.append("crc=1")
    return path + ("?" + "&".join(params) if params else "")


def fetch_leaf(metadata: str, step: int, index: int,
               slices: "Optional[Sequence[slice]]" = None,
               timeout: float = 60.0, out: Any = None,
               wire_dtype: "Optional[str]" = None,
               conn: "Optional[_DonorConn]" = None,
               crc: "Optional[bool]" = None) -> Any:
    """Fetch one leaf by index, or with ``slices`` one region of it, sliced
    by the donor. Reads are bounded by the advertised Content-Length, which
    must agree with the dtype and shape headers. ``out``: a preallocated
    C-contiguous CPU tensor or array of the leaf's (region's) dtype and
    shape, read into with no intermediate bytes, and returned.
    ``wire_dtype``: ``"bf16"`` asks for the lossy wire; the result is
    upcast to the leaf's dtype. ``conn`` rides an existing keep-alive
    connection; the caller owns it. ``crc``: ask for and verify the CRC32C
    frame (default: ``TORCHFT_TPU_WIRE_CRC``). A tensor leaf of a donor of
    this package comes back as a torch tensor, any leaf numpy lacks a dtype
    for too; other tensor leaves as numpy arrays, object leaves as they
    were."""
    crc = _WIRE_CRC if crc is None else crc
    own = conn is None
    conn = conn or _DonorConn(metadata, timeout)
    try:
        resp = conn.get(_leaf_path(step, index, slices, wire_dtype, crc))
        clen_hdr = resp.headers.get("Content-Length")
        if clen_hdr is None:
            raise ConnectionError(f"donor sent no Content-Length for leaf "
                                  f"{index} — refusing an unbounded read")
        clen = int(clen_hdr)
        if resp.headers.get("X-Kind", "ndarray") == "object":
            body = resp.read(clen)
            if len(body) != clen:
                raise ConnectionError(
                    f"object leaf {index} body truncated at {len(body)}/"
                    f"{clen} bytes — donor died mid-stream; refetch")
            return pickle.loads(body)
        dtype = dtype_from_str(resp.headers["X-Dtype"],
                               tensor=resp.headers.get("X-Tensor") == "1")
        shape = tuple(int(d) for d in resp.headers["X-Shape"].split(",") if d)
        wire_hdr = resp.headers.get("X-Wire-Dtype")
        item = (dtype_from_str(wire_hdr, tensor=True) if wire_hdr
                else dtype).itemsize
        expect = int(np.prod(shape, dtype=np.int64)) * item + (4 if crc else 0)
        if clen != expect:
            raise ConnectionError(
                f"leaf {index}: advertised Content-Length {clen} != {expect} "
                f"implied by dtype={wire_hdr or dtype_str(dtype)} "
                f"shape={shape} — donor/healer version skew or corrupt "
                "stream; refusing to decode")
        if out is not None:
            if (tuple(out.shape) != shape
                    or dtype_str(out.dtype) != dtype_str(dtype)):
                raise ValueError(
                    f"out buffer {dtype_str(out.dtype)}{tuple(out.shape)} "
                    f"does not match leaf {dtype_str(dtype)}{shape}")
            if not _contiguous(out):
                raise ValueError(
                    "out buffer must be C-contiguous for recv-into")
        return _read_wire(resp, dtype, shape, wire_hdr, f"leaf {index} body",
                          out=out, check_crc=crc)
    finally:
        if own:
            conn.close()


def _byte_ranges(entries: List[dict], parts: int) -> List[Tuple[int, int]]:
    """Contiguous leaf ranges balanced by bytes, at most ``parts``."""
    budget = sum(e["nbytes"] for e in entries) / float(max(1, parts))
    ranges: List[Tuple[int, int]] = []
    start, acc = 0, 0
    for i, e in enumerate(entries):
        acc += e["nbytes"]
        if acc >= budget and len(ranges) < parts - 1 and i + 1 < len(entries):
            ranges.append((start, i + 1))
            start, acc = i + 1, 0
    if start < len(entries):
        ranges.append((start, len(entries)))
    return ranges


def _recv_chunked(metadata: str, step: int, num_chunks: int, timeout: float,
                  metrics: "Optional[Any]" = None,
                  defer_paths: Optional[str] = None,
                  events: "Optional[Any]" = None,
                  wire_dtype: "Optional[str]" = None) -> Any:
    """Fetch every tensor leaf over ``num_chunks`` keep-alive connections
    (one rawleaves range each) and rebuild the state with the donor's
    structure; object leaves come with the manifest. The non-empty tensor
    leaves whose paths match ``defer_paths`` (groups: leaf, slot) come
    through :func:`fetch_opt_shard` instead."""
    t0 = time.perf_counter()
    manifest = fetch_manifest(metadata, step, timeout)
    entries = manifest["leaves"]
    outs: List[Any] = [e.get("value") for e in entries]
    use_crc = _WIRE_CRC
    wire = _WIRE_DTYPES[wire_dtype] if wire_dtype is not None else None
    query = "&".join((["crc=1"] if use_crc else [])
                     + ([f"wire={wire_dtype}"] if wire is not None else []))
    pat = re.compile(defer_paths) if defer_paths is not None else None
    fetch: List[int] = []
    deferred: Dict[int, Tuple[int, int]] = {}  # entry -> (leaf, slot)
    state_slots = 0
    for i, e in enumerate(entries):
        if e["kind"] != "ndarray":
            continue
        m = pat.match(e["path"]) if pat is not None else None
        if m is not None:
            state_slots = max(state_slots, int(m.group(2)) + 1)
        if m is not None and e["nbytes"] > 0:
            deferred[i] = (int(m.group(1)), int(m.group(2)))
        else:
            fetch.append(i)

    def _fetch_range(r: Tuple[int, int]) -> int:
        lo, hi = r
        conn = _DonorConn(metadata, timeout)
        nb = [0]
        try:
            with throughput_span(metrics, "heal_wire", nb):
                resp = conn.get(f"/checkpoint/{step}/rawleaves/{lo}-{hi}"
                                + (f"?{query}" if query else ""))
                clen = int(resp.headers["Content-Length"])
                want = sum(_entry_wire_nbytes(e, wire)
                           for e in entries[lo:hi])
                want += 4 * (hi - lo) if use_crc else 0
                if clen != want:
                    raise ConnectionError(
                        f"rawleaves {lo}-{hi}: Content-Length {clen} != "
                        f"{want} implied by the manifest — donor/healer "
                        "version skew")
                for i in range(lo, hi):
                    outs[i] = _read_leaf(resp, entries[i],
                                         f"leaf {i} body", use_crc, wire)
                nb[0] = clen
            return clen
        finally:
            conn.close()

    # contiguous runs of the leaves to fetch, each split by bytes
    ranges: List[Tuple[int, int]] = []
    run_start = None
    for j, i in enumerate(fetch):
        if run_start is None:
            run_start = i
        if j + 1 == len(fetch) or fetch[j + 1] != i + 1:
            ranges += [(run_start + lo, run_start + hi) for lo, hi in
                       _byte_ranges(entries[run_start: i + 1], num_chunks)]
            run_start = None
    logger.info("fetching checkpoint step %d: %d leaves over %d ranges",
                step, len(entries), len(ranges))
    total = 0
    if ranges:
        with ThreadPoolExecutor(
                max_workers=min(len(ranges), num_chunks)) as pool:
            for nbytes in pool.map(_fetch_range, ranges):
                total += nbytes
    if deferred:
        got = fetch_opt_shard(
            [metadata], step, sorted({leaf for leaf, _ in deferred.values()}),
            state_slots, slots_path_re=defer_paths, timeout=timeout,
            events=events)
        for i, (leaf, slot) in deferred.items():
            outs[i] = got[leaf][slot]
            total += int(outs[i].nbytes)
    if metrics is not None:
        wall = time.perf_counter() - t0
        if total and wall > 0:
            metrics.gauge("heal_bytes_per_s", total / wall)
    return tree_unflatten(manifest["treedef"], outs)


# --------------------------------------------------- the template (sharded) heal


def _to_device(buf: torch.Tensor, device: torch.device,
               streams: Dict[Any, Any], lock: threading.Lock
               ) -> torch.Tensor:
    """Upload a host region to ``device`` on the heal's side stream: the
    result is allocated on the calling thread's current stream, the copy
    is non-blocking from pinned memory, and this returns once it landed,
    so the result is ready for any stream and the host buffer is free."""
    with lock:
        stream = streams.get(device)
        if stream is None:
            stream = streams[device] = torch.cuda.Stream(device)
    out = torch.empty(buf.shape, dtype=buf.dtype, device=device)
    stream.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(stream):
        out.copy_(buf, non_blocking=True)
        done = torch.cuda.Event()
        done.record(stream)
    done.synchronize()
    return out


def _assign(buf: Any, dst: "Tuple[slice, ...]", arr: Any) -> None:
    """``buf[dst] = arr`` across torch and numpy."""
    if isinstance(buf, torch.Tensor):
        buf[dst] = arr if isinstance(arr, torch.Tensor) \
            else torch.from_numpy(np.ascontiguousarray(arr))
    else:
        buf[dst] = arr.numpy() if isinstance(arr, torch.Tensor) else arr


def recv_checkpoint_sharded(
    metadata: str,
    step: int,
    template: Any,
    timeout: float = 60.0,
    parallel: int = 4,
    metrics: "Optional[Any]" = None,
    wire_dtype: "Optional[str]" = None,
    stripe_bytes: int = 4 << 20,
) -> Any:
    """Heal into the structure of ``template``: the healer's current state,
    whose tensor leaves (torch tensors on any device, or numpy arrays) give
    each healed leaf its shape, dtype and device. Leaves are matched to the
    donor's manifest by path, so a donor of either package serves it (the
    JAX package orders dict keys its own way); the structure comes from the
    template, never from the donor.

    A template leaf that is a ``parallel.sharding.ShardedTensor`` fetches
    only the distinct bounds of its pieces (each once, however many
    devices hold it) and comes back as a ``ShardedTensor`` of the
    template's sharding, each region landed in its piece on that piece's
    device.

    Streaming pipeline: each tensor leaf's region lands by ``readinto`` in
    a preallocated host buffer (pinned when the template leaf is on the
    card); a region spread over hosts is fetched piece by piece from the
    hosts that hold it; a region of at least ``2 * stripe_bytes`` stripes
    over every host that holds all of it (the manifest's ``peers`` are
    pulled for that) and ``parallel`` keep-alive connections. The moment a
    leaf's last region lands, a bounded worker uploads it to the template's
    device (``non_blocking`` on a side stream) while later leaves keep
    streaming. Object leaves are fetched whole.

    Peer manifests are pulled lazily (when a region needs them or a donor
    died), in parallel, under one lock. A donor that dies mid-stream, or
    whose payload fails its CRC32C frame (``heal_checksum_errors``), is
    marked dead and the same bounds are refetched from each surviving host
    that covers them; the heal completes whole or raises, and nothing
    partial is returned. ``timeout`` bounds each wait (socket operations,
    an upload), not the heal. ``metrics`` gets the ``heal_wire`` and
    ``heal_h2d`` spans and the ``heal_bytes_per_s`` gauge, in wire bytes;
    ``heal_wall_ms`` is the caller's (``CheckpointServer.recv_checkpoint``).
    """
    t0 = time.perf_counter()
    manifest = fetch_manifest(metadata, step, timeout=timeout)
    entries = manifest["leaves"]
    t_flat, t_spec = tree_flatten_with_path(template)
    if len(t_flat) != len(entries):
        raise ValueError(
            f"template has {len(t_flat)} leaves, donor checkpoint has "
            f"{len(entries)} — model structure mismatch")
    index_of: Dict[str, Dict[str, int]] = {
        metadata: {e["path"]: i for i, e in enumerate(entries)}}
    for path, _ in t_flat:
        if path not in index_of[metadata]:
            raise ValueError(f"leaf path mismatch: template leaf {path!r} is "
                             "not in the donor's checkpoint")
    wire = _WIRE_DTYPES[wire_dtype] if wire_dtype is not None else None

    # per-host manifests, extended with the peers' only when needed
    manifests = {metadata: manifest}
    peers_lock = threading.Lock()  # guards manifests, index_of, peers_left
    peers_left = [p for p in manifest.get("peers", []) if p != metadata]

    def _piece_maps(path: str, shape) -> Dict[str, list]:
        with peers_lock:
            items = [(h, m["leaves"][index_of[h][path]])
                     for h, m in manifests.items() if path in index_of[h]]
        return {h: [tuple(tuple(b) for b in p)
                    for p in e.get("pieces", [_full(shape)])]
                for h, e in items if e["kind"] == "ndarray"}

    def _pull_peer_manifests() -> None:
        # once, in parallel; the lock is held through the pull, so a second
        # caller never sees the peers claimed while their manifests are
        # still missing
        with peers_lock:
            if not peers_left:
                return

            def _pull(peer):
                try:
                    return peer, fetch_manifest(peer, step, timeout=timeout)
                except Exception as e:  # noqa: BLE001 — a dead peer only
                    # narrows coverage; routing raises if it falls short
                    logger.warning("peer manifest fetch failed %s: %s",
                                   peer, e)
                    return peer, None

            with ThreadPoolExecutor(
                    max_workers=max(1, min(len(peers_left), parallel))) as ex:
                for peer, m in ex.map(_pull, list(peers_left)):
                    if m is not None:
                        manifests[peer] = m
                        index_of[peer] = {e["path"]: i for i, e
                                          in enumerate(m["leaves"])}
            peers_left.clear()

    def _plan_region(path, shape, bounds):
        try:
            return _route_region(bounds, _piece_maps(path, shape))
        except ValueError:
            _pull_peer_manifests()
            return _route_region(bounds, _piece_maps(path, shape))

    dead_hosts: set = set()
    dead_lock = threading.Lock()
    total_bytes = [0]
    bytes_lock = threading.Lock()
    conn_pool = _ConnPool(timeout)
    net_errors = (urllib.error.URLError, http.client.HTTPException,
                  ConnectionError, socket.timeout, TimeoutError, OSError)

    def _fetch_once(host, path, bounds, out):
        nb = [0]
        with throughput_span(metrics, "heal_wire", nb):
            with peers_lock:
                idx = index_of[host][path]
            conn = conn_pool.acquire(host)
            try:
                got = fetch_leaf(
                    host, step, idx,
                    slices=_bounds_to_slices(bounds) if bounds is not None
                    else None,
                    timeout=timeout, out=out, wire_dtype=wire_dtype,
                    conn=conn)
            except BaseException:
                conn.close()  # possibly mid-body: not reusable
                raise
            conn_pool.release(host, conn)
            if is_tensor_leaf(got):
                # wire bytes: under the lossy wire the socket moved the
                # downcast payload
                item = got.dtype.itemsize
                if wire is not None and dtype_str(got.dtype) \
                        in _WIRE_COMPRESSIBLE:
                    item = wire.itemsize
                nb[0] = int(np.prod(got.shape, dtype=np.int64)) * item
                with bytes_lock:
                    total_bytes[0] += nb[0]
        return got

    def _alive(hosts):
        with dead_lock:
            return [h for h in hosts if h not in dead_hosts]

    def _fetch_job(host, path, bounds, out, alternates):
        """One fetch with failover: on a network error (or a corrupt
        payload) the host is marked dead and the same bounds are refetched
        from each surviving host that covers them."""
        try:
            return _fetch_once(host, path, bounds, out)
        except urllib.error.HTTPError:
            raise  # the donor answered: a protocol error, not a death
        except net_errors as first:
            if isinstance(first, ChecksumError) and metrics is not None:
                metrics.incr("heal_checksum_errors")
            with dead_lock:
                dead_hosts.add(host)
            try:
                _pull_peer_manifests()  # a death is when peers matter
            except Exception:  # noqa: BLE001 — alternates only narrow
                pass
            for alt in _alive(alternates()):
                logger.warning("donor %s died mid-stream; refetching %s %s "
                               "from %s", host, path, bounds, alt)
                try:
                    return _fetch_once(alt, path, bounds, out)
                except net_errors as again:
                    if isinstance(again, ChecksumError) \
                            and metrics is not None:
                        metrics.incr("heal_checksum_errors")
                    with dead_lock:
                        dead_hosts.add(alt)
            raise ConnectionError(
                f"leaf {path} bounds {bounds}: donor {host} died and no "
                "surviving peer covers the region") from first

    # plan every leaf first (its regions routed to hosts), then stream
    plans = []  # (path, entry, template leaf, routed regions or None)
    for path, tleaf in t_flat:
        entry = entries[index_of[metadata][path]]
        if not is_tensor_leaf(tleaf):
            plans.append((path, entry, tleaf, None))
            continue
        if entry["kind"] != "ndarray":
            raise ValueError(f"kind mismatch at {path}: template holds a "
                             f"tensor, the donor a {entry['kind']}")
        shape = tuple(int(d) for d in entry["shape"])
        if tuple(tleaf.shape) != shape:
            raise ValueError(f"shape mismatch at {path}: template "
                             f"{tuple(tleaf.shape)} vs donor {shape}")
        if dtype_str(tleaf.dtype) != entry["dtype"]:
            raise ValueError(f"dtype mismatch at {path}: template "
                             f"{dtype_str(tleaf.dtype)} vs donor "
                             f"{entry['dtype']}")
        # a sharded template fetches the bounds of its pieces alone
        regions = dict.fromkeys(tleaf.bounds) \
            if isinstance(tleaf, ShardedTensor) else {_full(shape): None}
        plans.append((path, entry, tleaf,
                      {b: _plan_region(path, shape, b) for b in regions}))

    h2d_ex = _heal_executor("h2d")
    streams: Dict[Any, Any] = {}
    streams_lock = threading.Lock()
    fetch_pool = ThreadPoolExecutor(max_workers=max(1, parallel),
                                    thread_name_prefix="torchft_tpu_torch_heal_fetch")
    results: List[Future] = []
    try:
        for path, entry, tleaf, routed in plans:
            if routed is None and "value" in entry:
                # an object leaf a donor of this package carries in its
                # manifest: no request
                done: Future = Future()
                done.set_result(entry["value"])
                results.append(done)
                continue
            if routed is None:
                # an object leaf, fetched whole from any live host
                def _oalts(path=path):
                    with peers_lock:
                        hosts = [h for h in manifests if path in index_of[h]]
                    return [h for h in hosts if h != metadata]

                results.append(fetch_pool.submit(
                    _fetch_job, metadata, path, None, None, _oalts))
                continue
            shape = tuple(int(d) for d in entry["shape"])
            if isinstance(tleaf, ShardedTensor):
                on_card = any(d.type == "cuda" for d in tleaf.devices)
            else:
                on_card = isinstance(tleaf, torch.Tensor) and tleaf.is_cuda
            dtype = tleaf.dtype
            group = FutureGroup()
            region_bufs = {}
            for bounds, sub in routed.items():
                buf = _empty(tuple(b - a for a, b in bounds), dtype,
                             pin=on_card)
                region_bufs[bounds] = buf
                nbytes = int(np.prod(buf.shape, dtype=np.int64)) \
                    * dtype.itemsize

                def _alts(b=bounds, path=path, shape=shape):
                    return _covering_hosts(b, _piece_maps(path, shape))

                if len(sub) == 1 and sub[0][1] == bounds:
                    stripes = _stripe_region(bounds, nbytes, stripe_bytes,
                                             parallel)
                    if stripes is None:
                        group.add(fetch_pool.submit(
                            _fetch_job, sub[0][0], path, bounds, buf, _alts))
                        continue
                    # stripe s goes to covering host s % n: every host that
                    # holds the region shares it (the peers are pulled for
                    # that), and each host gets several connections
                    _pull_peer_manifests()
                    hosts = _alive(_covering_hosts(
                        bounds, _piece_maps(path, shape))) or [sub[0][0]]
                    base0 = bounds[0][0]
                    for s_idx, sb in enumerate(stripes):
                        dst = buf[sb[0][0] - base0: sb[0][1] - base0]

                        def _salts(sb=sb, path=path, shape=shape):
                            return _covering_hosts(sb,
                                                   _piece_maps(path, shape))

                        group.add(fetch_pool.submit(
                            _fetch_job, hosts[s_idx % len(hosts)], path, sb,
                            dst, _salts))
                    continue
                # the region spans hosts: each piece lands in a fresh
                # buffer (a piece may not be contiguous in the region's)
                for host, piece_b in sub:
                    dst = tuple(slice(a - ra, b - ra)
                                for (a, b), (ra, _) in zip(piece_b, bounds))

                    def _piece(host=host, piece_b=piece_b, dst=dst, buf=buf,
                               path=path, shape=shape):
                        arr = _fetch_job(
                            host, path, piece_b, None,
                            lambda: _covering_hosts(
                                piece_b, _piece_maps(path, shape)))
                        _assign(buf, dst, arr)

                    group.add(fetch_pool.submit(_piece))

            def _assemble(tleaf=tleaf, region_bufs=region_bufs,
                          on_card=on_card):
                if isinstance(tleaf, ShardedTensor):
                    # each region lands in every piece that holds it, on
                    # that piece's device
                    with timed_span(metrics, "heal_h2d"):
                        return tleaf.like([
                            _to_device(region_bufs[b], d, streams,
                                       streams_lock)
                            if d.type == "cuda" else region_bufs[b]
                            for b, d in zip(tleaf.bounds, tleaf.devices)])
                (buf,) = region_bufs.values()
                if not on_card:
                    return buf
                with timed_span(metrics, "heal_h2d"):
                    return _to_device(buf, tleaf.device, streams,
                                      streams_lock)

            # the upload overlaps the receives still in flight: it rides
            # the bounded worker the moment this leaf's last region lands
            sealed = group.seal(lambda: None)
            results.append(future_chain(
                sealed, lambda f, a=_assemble: (f.result(),
                                                h2d_ex.submit(a))[1]))
        leaves = []
        for (path, entry, tleaf, routed), fut in zip(plans, results):
            # the fetches are bounded by per-socket idle deadlines and a
            # finite retry set; the upload keeps ``timeout``
            got = fut.result()
            leaves.append(got if routed is None else got.result(timeout))
    finally:
        fetch_pool.shutdown(wait=True, cancel_futures=True)
        conn_pool.close_all()
    if metrics is not None:
        wall = time.perf_counter() - t0
        if total_bytes[0] and wall > 0:
            metrics.gauge("heal_bytes_per_s", total_bytes[0] / wall)
    return tree_unflatten(t_spec, leaves)


def _host_array(x: Any) -> np.ndarray:
    """A fetched leaf as a numpy array (a CPU tensor of a numpy dtype, or
    an array)."""
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


# ------------------------------------------------- redistribution transport
# The byte-movement hooks of comm/redistribute.py over this plane: a holder
# publishes through an ephemeral CheckpointServer (lazy staging, so an
# unfetched unit costs no bytes) and a receiver pulls through keep-alive
# connections. Exchanges happen at membership changes only.

_REDIST_STEP = 0
_REDIST_PATH_RE = r".*\['units'\]\['(\d+)'\]\[(\d+)\]$"

# the heal path's plan cache: donor spec pairs repeat across heals
_OPT_SHARD_PLANNER = RedistPlanner()


def _pool_fetch_leaves(pool: _ConnPool, host: str, step: int,
                       indices: Sequence[int], timeout: float,
                       what: str = "unit") -> List[np.ndarray]:
    """Fetch the manifest leaves ``indices`` of ``host`` in order over one
    pooled connection, released only after every body was consumed (closed
    on an error). ``urllib.error.HTTPError`` passes through (the holder
    answered: a protocol error); everything transport-shaped becomes a
    ``ConnectionError``, the death the redistribution failover keys on."""
    try:
        conn = pool.acquire(host)
        try:
            arrays = [_host_array(fetch_leaf(host, step, int(mi),
                                             timeout=timeout, conn=conn))
                      for mi in indices]
        except BaseException:
            conn.close()  # possibly mid-body: not reusable
            raise
        pool.release(host, conn)
        return arrays
    except urllib.error.HTTPError:
        raise
    except (http.client.HTTPException, TimeoutError) as e:
        raise ConnectionError(f"holder {host} died fetching {what}: {e}") \
            from e


def fetch_opt_shard(
    donors: Sequence[str],
    step: int,
    needed: Sequence[int],
    state_slots: int,
    slots_path_re: str = r".*\['slots'\]\[(\d+)\]\[(\d+)\]$",
    timeout: float = 60.0,
    parallel: int = 4,
    metrics: Optional[Any] = None,
    planner: Optional[RedistPlanner] = None,
    events: Optional[Any] = None,
) -> Dict[int, List[np.ndarray]]:
    """Fetch the per-leaf optimizer states ``needed`` from donors' staged
    checkpoints, planned by the redistribution engine: the donor manifests
    are the source shard spec, ``needed`` the destination, and each leaf
    is fetched exactly once, striped across the donors that hold it, with
    dead-donor failover (whole or raise).

    A donor's checkpoint holds its own shard of
    ``ShardedOptimizerWrapper.opt_state_dict``: leaf ``i`` is held when all
    ``state_slots`` of its entries (paths matching ``slots_path_re``,
    groups (leaf, slot)) have ``nbytes > 0``. Donors of either package
    serve the same paths. Gauges ``heal_opt_bytes`` and counts
    ``redist_moved_bytes``/``redist_lower_bound_bytes``. Returns
    ``{leaf: [slot arrays]}`` for every index in ``needed``."""
    needed = sorted(set(int(i) for i in needed))
    if not needed:
        return {}
    pat = re.compile(slots_path_re)
    coverage: Dict[str, Dict[int, Dict[int, int]]] = {}
    leaf_bytes: Dict[int, int] = {}
    for donor in donors:
        try:
            manifest = fetch_manifest(donor, step, timeout=timeout)
        except Exception as e:  # noqa: BLE001 — a dead donor narrows
            logger.warning("opt-shard manifest fetch failed %s: %s",
                           donor, e)
            continue
        slots: Dict[int, Dict[int, int]] = {}
        sizes: Dict[int, int] = {}
        for mi, entry in enumerate(manifest["leaves"]):
            m = pat.match(entry.get("path", ""))
            if m is None or entry.get("kind") != "ndarray":
                continue
            if int(entry.get("nbytes", 0)) <= 0:
                continue
            leaf, slot = int(m.group(1)), int(m.group(2))
            slots.setdefault(leaf, {})[slot] = mi
            sizes[leaf] = sizes.get(leaf, 0) + int(entry["nbytes"])
        coverage[donor] = {leaf: by_slot for leaf, by_slot in slots.items()
                           if len(by_slot) == state_slots}
        for leaf in coverage[donor]:
            leaf_bytes[leaf] = max(leaf_bytes.get(leaf, 0), sizes[leaf])

    # holders are donor positions; the healer is one receiver past them
    n_units = max([*needed, *(l for c in coverage.values() for l in c)]) + 1
    src = ShardSpec(n_units, {di: list(coverage[d])
                              for di, d in enumerate(donors)
                              if coverage.get(d)})
    receiver = len(donors)
    dst = ShardSpec(n_units, {receiver: needed})
    unit_bytes = [leaf_bytes.get(u, 0) for u in range(n_units)]
    planner = planner if planner is not None else _OPT_SHARD_PLANNER
    hits0 = planner.hits
    plan = planner.plan(src, dst, unit_bytes, metrics=metrics)
    missing = list(plan.receiver_unsourced(receiver))
    if missing:
        raise ConnectionError(
            f"no donor covers optimizer-state leaves {missing[:8]}"
            f"{'...' if len(missing) > 8 else ''} at step {step}: the "
            "donors' shard specs do not union to the needed shard"
        )
    conn_pool = _ConnPool(timeout)

    def _fetch_unit(holder: int, leaf: int) -> List[np.ndarray]:
        donor = donors[holder]
        by_slot = coverage[donor][leaf]
        nb = [0]
        with throughput_span(metrics, "heal_wire", nb):
            arrays = _pool_fetch_leaves(
                conn_pool, donor, step,
                [by_slot[slot] for slot in range(state_slots)], timeout,
                what=f"opt-shard leaf {leaf}")
            nb[0] = sum(int(a.nbytes) for a in arrays)
        return arrays

    try:
        out, total_bytes = execute_fetches(plan, receiver, _fetch_unit,
                                           parallel=parallel)
    finally:
        conn_pool.close_all()
    lower = plan.lower_bound_bytes.get(receiver, 0)
    if metrics is not None:
        metrics.gauge("heal_opt_bytes", float(total_bytes))
        metrics.incr("heal_opt_bytes_total", float(total_bytes))
        metrics.incr("redist_moved_bytes", float(total_bytes))
        metrics.incr("redist_lower_bound_bytes", float(lower))
    if events:
        events.emit(
            "redist_plan", source="opt_shard_heal",
            src_spec=src.fingerprint(), dst_spec=dst.fingerprint(),
            n_units=n_units, cache_hit=planner.hits > hits0,
            fetches=len(plan.receiver_fetches(receiver)), unsourced=0,
            moved_bytes=int(total_bytes), lower_bound_bytes=int(lower),
        )
    return out


def serve_redist_payload(units: Dict[int, Sequence[Any]],
                         timeout: float = 60.0,
                         step: int = _REDIST_STEP) -> Tuple[str, Any]:
    """Publish a holder's redistribution payload: an ephemeral checkpoint
    server staging ``{"units": {str(u): [arrays...]}}`` at ``step``.
    Tensors may live on the device: each stages when a receiver fetches
    it. Returns ``(address, close)``. The ``serve_fn`` hook of
    ``comm.redistribute.exchange``."""
    srv: CheckpointServer = CheckpointServer(timeout=timeout)
    tree = {"units": {str(int(u)): list(arrays)
                      for u, arrays in units.items()}}
    srv.send_checkpoint([], int(step), tree, timeout)

    def _close() -> None:
        try:
            srv.disallow_checkpoint()
        finally:
            srv.shutdown(wait=False)

    return srv.metadata(), _close


class RedistFetcher:
    """Pull side of the redistribution plane: a per-address manifest cache
    and a keep-alive connection pool. ``fetch(address, unit)`` returns the
    unit's arrays in slot order; a dead holder surfaces as
    ``ConnectionError``/``OSError`` for the engine's failover. The
    ``fetch_factory`` hook of ``comm.redistribute.exchange``."""

    def __init__(self, timeout: float = 60.0,
                 step: int = _REDIST_STEP) -> None:
        self._timeout = float(timeout)
        self._step = int(step)
        self._pool = _ConnPool(self._timeout)
        self._pat = re.compile(_REDIST_PATH_RE)
        self._slots: Dict[str, Dict[int, List[int]]] = {}
        self._lock = threading.Lock()

    def _unit_slots(self, addr: str) -> Dict[int, List[int]]:
        with self._lock:
            cached = self._slots.get(addr)
        if cached is not None:
            return cached
        manifest = fetch_manifest(addr, self._step, timeout=self._timeout)
        by_unit: Dict[int, Dict[int, int]] = {}
        for mi, entry in enumerate(manifest["leaves"]):
            m = self._pat.match(entry.get("path", ""))
            if m is None or entry.get("kind") != "ndarray":
                continue
            by_unit.setdefault(int(m.group(1)), {})[int(m.group(2))] = mi
        slots = {u: [by_slot[k] for k in sorted(by_slot)]
                 for u, by_slot in by_unit.items()}
        with self._lock:
            self._slots[addr] = slots
        return slots

    def fetch(self, addr: str, unit: int) -> List[np.ndarray]:
        try:
            slots = self._unit_slots(addr)
        except urllib.error.HTTPError:
            raise  # a protocol error, not a death
        except (http.client.HTTPException, TimeoutError) as e:
            raise ConnectionError(
                f"redist holder {addr} died serving its manifest: {e}"
            ) from e
        if int(unit) not in slots:
            raise ConnectionError(
                f"holder {addr} advertises no unit {unit}: its published "
                "spec and the plan diverged"
            )
        return _pool_fetch_leaves(self._pool, addr, self._step,
                                  slots[int(unit)], self._timeout,
                                  what=f"unit {unit}")

    def close(self) -> None:
        self._pool.close_all()


def redistribute_exchange(mgr: Any, my_rank: int, world: int,
                          dst_spec: ShardSpec,
                          holdings: Dict[int, Sequence[Any]],
                          planner: RedistPlanner, timeout: float = 60.0,
                          parallel: int = 4, source: str = "reshard"):
    """``comm.redistribute.exchange`` bound to this raw-bytes plane: the
    cohort redistribution call of the sharded optimizer. Returns the
    engine's ``ExchangeResult``, or None (wire latched or a transfer
    failed whole: the caller keeps its grid, the next quorum retries)."""
    from torchft_tpu_torch.comm.redistribute import exchange

    return exchange(
        mgr, my_rank, world, dst_spec, holdings, planner,
        serve_fn=lambda units: serve_redist_payload(units, timeout),
        fetch_factory=lambda: RedistFetcher(timeout),
        parallel=parallel, source=source,
    )


def split_leaf_payload(arrays: Sequence[Any],
                       model_shards: int) -> List[List[np.ndarray]]:
    """Split one unit's slot arrays into ``model_shards`` sub-unit payloads
    (the 2-D mesh's holdings): each slot array is raveled and cut into
    contiguous pieces, piece ``m`` of every slot going to sub-unit ``m``;
    a remainder goes to the last shard."""
    m = max(1, int(model_shards))
    out: List[List[np.ndarray]] = [[] for _ in range(m)]
    for a in arrays:
        flat = np.ascontiguousarray(_host_array(a)).ravel()
        per = len(flat) // m
        for k in range(m):
            lo = k * per
            hi = (k + 1) * per if k < m - 1 else len(flat)
            out[k].append(flat[lo:hi])
    return out


def join_leaf_payload(pieces_by_shard: Sequence[Sequence[Any]],
                      template_shapes: Sequence[Tuple[int, ...]]
                      ) -> List[np.ndarray]:
    """Inverse of :func:`split_leaf_payload`: each slot reassembled from
    its sub-unit pieces into the shape of ``template_shapes``. Raises
    ValueError when the bytes cannot fill a template (the caller then
    reinitializes that unit)."""
    n_slots = len(template_shapes)
    for shard in pieces_by_shard:
        if len(shard) != n_slots:
            raise ValueError(
                f"sub-unit carries {len(shard)} slots, expected {n_slots}")
    out: List[np.ndarray] = []
    for i, shape in enumerate(template_shapes):
        flat = np.concatenate([
            np.ascontiguousarray(shard[i]).ravel()
            for shard in pieces_by_shard
        ]) if pieces_by_shard else np.empty((0,))
        want = int(np.prod(shape)) if shape else 1
        if flat.size != want:
            raise ValueError(
                f"slot {i}: reassembled {flat.size} elements, template "
                f"shape {tuple(shape)} needs {want}")
        out.append(flat.reshape(shape))
    return out
