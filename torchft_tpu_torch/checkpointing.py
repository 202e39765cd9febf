"""Live checkpoint transport for healing replicas.

Twin of the default heal plane of ``torchft_tpu/checkpointing.py`` (the
raw-leaves chunked transfer the Manager uses, ``num_chunks=2``), over torch
state dicts. An up-to-date replica serves its in-memory state over HTTP; a
healing replica fetches it at the step boundary. Serving is gated: the
Manager's ``send_checkpoint`` stages the state for one step and opens the
gate; ``disallow_checkpoint`` (at the commit barrier, before the optimizer
may touch the state again) closes it.

- Donor: ``send_checkpoint`` flattens the state dict into tensor leaves
  plus a structure spec (every non-tensor value stays in the spec), builds
  the manifest from metadata only and opens the gate at once. A background
  stager copies the leaves to host in order, and an HTTP request that needs
  leaf *i* now stages it inline (``futures.StealableTask``).
  ``disallow_checkpoint`` finishes any residual staging before it returns,
  so the training step can never mutate a tensor a pending stage still
  reads.
- Wire: ``GET /checkpoint/{step}/manifest`` (pickled: entries + spec),
  ``GET /checkpoint/{step}/rawleaves/{lo}-{hi}`` (the leaves' raw bytes back
  to back, each followed by a 4-byte little-endian CRC32C with ``?crc=1``),
  and ``GET /checkpoint/{step}/leaf/{i}`` (one leaf with dtype/shape
  headers). Tensor bytes never go through pickle.
- Telemetry: ``GET /telemetry/metrics`` (the Manager's metrics snapshot)
  and ``GET /telemetry/events?since=<seq>`` (the flight recorder's tail),
  each framed by the Manager's identity probe (``set_telemetry``) in the
  reference's payload shape, so ``scripts/fleet_top.py`` reads a replica of
  either package. Telemetry is not gated on the checkpoint gate.
- Healer: ``_recv_chunked`` splits the tensor leaves into byte-balanced
  ranges over ``num_chunks`` keep-alive connections and ``readinto``s each
  leaf straight into a preallocated CPU tensor, verifying its CRC32C frame.
  Leaves whose manifest path matches the server's ``defer_paths`` (the
  sharded optimizer's slots) leave the chunked fetch and come through
  :func:`fetch_opt_shard` instead, still inside the heal: the donor closes
  its gate at its commit barrier, which does not wait for the healer.

Manifest entries carry the JAX package's ``path`` (its key-string format,
``['train']['opt']['slots'][3][0]``) and ``kind`` beside dtype, shape and
nbytes, so a healer of either package can route leaves by path. The JAX
package sorts dict keys where this one keeps insertion order, so leaf
indices differ between the packages' manifests; paths do not. A port
healer reads a JAX donor's manifest (its pickled tree structure is stubbed
out, never imported).

Redistribution transport: :func:`serve_redist_payload` and
:class:`RedistFetcher` are the ``serve_fn``/``fetch_factory`` hooks of
``comm.redistribute.exchange`` over this plane; :func:`redistribute_exchange`
binds them, and :func:`fetch_opt_shard` plans a sharded optimizer state's
fetch from donor manifests.

Heals are bitwise. Trust model: the manifest is a pickle, so the heal plane
must only span mutually trusted trainer hosts.
"""

from __future__ import annotations

import http.client
import io
import json
import logging
import os
import pickle
import struct
import threading
import time
import urllib.error
from abc import ABC, abstractmethod
from concurrent.futures import ThreadPoolExecutor
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
from torchft_tpu_torch.comm.wire import as_bytes_view, readinto_exact
from torchft_tpu_torch.control._native import get_lib
from torchft_tpu_torch.futures import StealableTask
from torchft_tpu_torch.utils.crc32c import crc32c
from torchft_tpu_torch.utils.net import advertised_host
from torchft_tpu_torch.utils.serialization import (
    dtype_from_str,
    dtype_str,
    flatten_state,
    leaf_paths,
    to_host,
    unflatten_state,
)
from torchft_tpu_torch.utils.profiling import throughput_span

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
    "redistribute_exchange",
    "serve_redist_payload",
    "split_leaf_payload",
]

# Chunk size for streaming a staged leaf into the socket: few syscalls, and
# a dying healer is detected within a chunk.
_SEND_CHUNK = 1 << 20

# CRC32C integrity frames on the raw tensor wire, on by default;
# TORCHFT_TPU_WIRE_CRC=0 turns them off (both packages read the same name).
_WIRE_CRC = os.environ.get("TORCHFT_TPU_WIRE_CRC", "1") != "0"


class ChecksumError(ConnectionError):
    """A tensor body failed its CRC32C wire frame: the payload was corrupted
    in flight. A ConnectionError, so callers treat it as "this copy is bad,
    refetch"."""


@dataclass(frozen=True)
class _Staged:
    """One staged checkpoint: per-leaf tasks resolving to host arrays, and
    the metadata-only manifest."""

    step: int
    slots: List[StealableTask]
    entries: List[dict]
    manifest_bytes: bytes

    def leaf(self, i: int, timeout: "Optional[float]" = None) -> np.ndarray:
        """Host copy of leaf ``i``, staged inline if the background stager
        has not reached it yet."""
        return self.slots[i].result(timeout)

    def finish_staging(self, timeout: "Optional[float]" = None) -> None:
        for slot in self.slots:
            try:
                slot.result(timeout)
            except Exception as e:  # noqa: BLE001 — the healer gets a 503
                logger.warning("checkpoint leaf staging failed: %s", e)


def _build_staged(step: int, state: Any) -> _Staged:
    leaves, spec = flatten_state(state)
    entries = []
    slots = []
    for leaf, path in zip(leaves, leaf_paths(state)):
        entries.append({
            "path": path,
            "kind": "ndarray",
            "dtype": dtype_str(leaf.dtype),
            "shape": tuple(leaf.shape),
            "nbytes": int(leaf.numel() * leaf.element_size())
            if isinstance(leaf, torch.Tensor) else int(leaf.nbytes),
        })
        if isinstance(leaf, np.ndarray):
            # host arrays are mutable: snapshot now
            snap = np.array(leaf, copy=True)
            slots.append(StealableTask(lambda s=snap: s))
        else:
            slots.append(StealableTask(lambda t=leaf: to_host(t)))
    manifest = {"step": step, "leaves": entries, "treedef": spec}
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

    @abstractmethod
    def recv_checkpoint(self, src_rank: int, metadata: str, step: int,
                        timeout: "float | timedelta") -> T:
        """Fetch the checkpoint staged by the donor for ``step``."""

    def shutdown(self, wait: bool = True) -> None:  # noqa: B027
        """Tear down any serving resources."""


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server_version = "torchft_tpu_torch_ckpt"

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

    def _write_leaf(self, arr: np.ndarray, crc: bool) -> None:
        view = as_bytes_view(arr)
        c = 0
        for off in range(0, view.nbytes, _SEND_CHUNK):
            chunk = view[off: off + _SEND_CHUNK]
            if crc:
                c = crc32c(chunk, c)
            self.wfile.write(chunk)
        if crc:
            self.wfile.write(struct.pack("<I", c))

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
        staged = self._await_staged(step)
        if staged is None:
            return
        server: "CheckpointServer" = self.server.ckpt_server  # type: ignore[attr-defined]
        crc = parse_qs(url.query).get("crc", ["0"])[0] == "1"
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
                # Content-Length comes from METADATA, so headers go out at
                # once and each leaf stages just in time while earlier ones
                # are on the wire; a staging failure mid-stream surfaces as
                # a short body, which the healer's bounded read rejects.
                lo_s, _, hi_s = parts[3].partition("-")
                lo, hi = int(lo_s), int(hi_s)
                if not 0 <= lo < hi <= len(staged.slots):
                    self.send_error(404, f"bad leaf range {lo}-{hi}")
                    return
                clen = sum(e["nbytes"] for e in staged.entries[lo:hi])
                clen += 4 * (hi - lo) if crc else 0
                self.send_response(200)
                self.send_header("X-Kind", "rawleaves")
                self.send_header("X-Count", str(hi - lo))
                self.send_header("Content-Length", str(clen))
                self.end_headers()
                streaming = True
                for i in range(lo, hi):
                    self._write_leaf(staged.leaf(i, server._timeout), crc)
                return
            if parts[2] == "leaf" and len(parts) == 4:
                idx = int(parts[3])
                if not 0 <= idx < len(staged.slots):
                    self.send_error(404, f"no leaf {idx}")
                    return
                arr = staged.leaf(idx, server._timeout)  # before headers
                entry = staged.entries[idx]
                self.send_response(200)
                self.send_header("X-Kind", "ndarray")
                self.send_header("X-Dtype", entry["dtype"])
                self.send_header(
                    "X-Shape", ",".join(str(d) for d in entry["shape"])
                )
                self.send_header(
                    "Content-Length", str(entry["nbytes"] + (4 if crc else 0))
                )
                self.end_headers()
                streaming = True
                self._write_leaf(arr, crc)
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


_STAGE_POOL = ThreadPoolExecutor(
    max_workers=2, thread_name_prefix="torchft_tpu_torch_heal_stage"
)


class CheckpointServer(CheckpointTransport[T]):
    """Daemon-thread HTTP server streaming the staged state dict."""

    def __init__(self, timeout: "float | timedelta" = 60.0,
                 num_chunks: int = 2,
                 defer_paths: Optional[str] = None) -> None:
        """``num_chunks``: keep-alive connections a healer fetches over.
        ``defer_paths``: a regular expression over manifest paths whose
        groups are (leaf, slot); a heal through this server fetches the
        non-empty entries it matches with :func:`fetch_opt_shard` (the
        sharded optimizer's slots, planned by the redistribution engine)
        instead of the chunked stream."""
        if isinstance(timeout, timedelta):
            timeout = timeout.total_seconds()
        if num_chunks < 1:
            raise ValueError("num_chunks must be >= 1")
        # the wire's CRC32C lives in the native library: load it (building
        # it on the first use in a checkout, ~10 s) here, before any
        # request handler and its caller's timeout need it
        get_lib()
        self._timeout = float(timeout)
        self._num_chunks = int(num_chunks)
        self._defer_paths = defer_paths
        self._metrics = None
        self._events = None
        self._telemetry_info = None
        self._cond = threading.Condition()
        self._disallowed = True
        self._staged: Optional[_Staged] = None
        self._server = ThreadingHTTPServer(("0.0.0.0", 0), _Handler)
        self._server.daemon_threads = True
        self._server.request_queue_size = 1024
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
        """Share the Manager's Metrics sink (heal gauges; served by GET
        /telemetry/metrics)."""
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

    def send_checkpoint(self, dst_ranks: List[int], step: int, state_dict: T,
                        timeout: "float | timedelta") -> None:
        del dst_ranks  # HTTP serves whoever fetches
        staged = _build_staged(step, state_dict)
        with self._cond:
            self._staged = staged
            self._disallowed = False
            self._cond.notify_all()

        def _drain(slots=staged.slots):
            for slot in slots:
                slot.run()

        _STAGE_POOL.submit(_drain)

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
        out = _recv_chunked(metadata, step, self._num_chunks, float(timeout),
                            metrics=self._metrics,
                            defer_paths=self._defer_paths,
                            events=self._events)
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
    """The donor's manifest: {step, leaves: [{path, kind, dtype, shape,
    nbytes}], treedef (the structure spec)}. ``conn`` rides an existing
    keep-alive connection."""
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


def _empty_leaf(entry: dict) -> "Tuple[Any, np.ndarray]":
    """A CPU destination for one manifest entry and its byte view."""
    dtype = dtype_from_str(entry["dtype"])
    shape = tuple(entry["shape"])
    if isinstance(dtype, torch.dtype):
        t = torch.empty(shape, dtype=dtype)
        return t, t.reshape(-1).view(torch.uint8).numpy()
    a = np.empty(shape, dtype)
    return a, a.reshape(-1).view(np.uint8)


def _read_leaf(resp, entry: dict, what: str, check_crc: bool) -> Any:
    """Land one leaf body from ``resp`` into a fresh CPU tensor/array,
    verifying the CRC32C trailer before the bytes are trusted."""
    out, view = _empty_leaf(entry)
    readinto_exact(resp, memoryview(view), what=what)
    if check_crc:
        trailer = bytearray(4)
        readinto_exact(resp, memoryview(trailer), what=f"{what} crc frame")
        want = struct.unpack("<I", trailer)[0]
        got = crc32c(memoryview(view))
        if got != want:
            raise ChecksumError(
                f"{what}: CRC32C mismatch (wire frame {want:#010x}, computed "
                f"{got:#010x}) — payload corrupted in flight; refetch"
            )
    return out


def fetch_leaf(metadata: str, step: int, index: int, timeout: float = 60.0,
               crc: "Optional[bool]" = None,
               conn: "Optional[_DonorConn]" = None) -> Any:
    """Fetch one leaf by index (bounded by its advertised length). ``conn``
    rides an existing keep-alive connection; the caller owns it."""
    crc = _WIRE_CRC if crc is None else crc
    own = conn is None
    conn = conn or _DonorConn(metadata, timeout)
    try:
        resp = conn.get(f"/checkpoint/{step}/leaf/{index}"
                        + ("?crc=1" if crc else ""))
        entry = {
            "dtype": resp.headers["X-Dtype"],
            "shape": tuple(
                int(d) for d in resp.headers["X-Shape"].split(",") if d
            ),
        }
        out, view = _empty_leaf(entry)
        clen = int(resp.headers["Content-Length"])
        if clen != view.nbytes + (4 if crc else 0):
            raise ConnectionError(
                f"leaf {index}: Content-Length {clen} disagrees with "
                f"dtype={entry['dtype']} shape={entry['shape']}"
            )
        return _read_leaf(resp, entry, f"leaf {index} body", crc)
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
                  events: "Optional[Any]" = None) -> Any:
    """Fetch every leaf over ``num_chunks`` keep-alive connections (one
    rawleaves range each) and rebuild the state with the donor's spec. The
    non-empty leaves whose paths match ``defer_paths`` (groups: leaf, slot)
    come through :func:`fetch_opt_shard` instead."""
    import re

    t0 = time.perf_counter()
    manifest = fetch_manifest(metadata, step, timeout)
    entries = manifest["leaves"]
    outs: List[Any] = [None] * len(entries)
    use_crc = _WIRE_CRC
    fetch = list(range(len(entries)))
    deferred: Dict[int, Tuple[int, int]] = {}  # entry -> (leaf, slot)
    state_slots = 0
    if defer_paths is not None:
        pat = re.compile(defer_paths)
        fetch = []
        for i, e in enumerate(entries):
            m = pat.match(e.get("path", ""))
            if m is not None:
                state_slots = max(state_slots, int(m.group(2)) + 1)
            if m is not None and e.get("nbytes", 0) > 0:
                deferred[i] = (int(m.group(1)), int(m.group(2)))
            else:
                fetch.append(i)

    def _fetch_range(r: Tuple[int, int]) -> int:
        lo, hi = r
        conn = _DonorConn(metadata, timeout)
        try:
            resp = conn.get(f"/checkpoint/{step}/rawleaves/{lo}-{hi}"
                            + ("?crc=1" if use_crc else ""))
            clen = int(resp.headers["Content-Length"])
            want = sum(e["nbytes"] for e in entries[lo:hi])
            want += 4 * (hi - lo) if use_crc else 0
            if clen != want:
                raise ConnectionError(
                    f"rawleaves {lo}-{hi}: Content-Length {clen} != {want} "
                    "implied by the manifest — donor/healer version skew"
                )
            for i in range(lo, hi):
                outs[i] = _read_leaf(resp, entries[i], f"leaf {i} body",
                                     use_crc)
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
    return unflatten_state(manifest["treedef"], outs)


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
    import re

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
        import re

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
