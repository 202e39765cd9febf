"""MPMD pipeline parallelism: a streaming 1F1B microbatch plane.

Twin of ``torchft_tpu/pipeline.py``. The model is split into layer ranges
("stages"), each stage is a replica group with its own manager surface,
and microbatches stream stage to stage as length-prefixed ``TFPP``
activation / gradient frames, byte for byte the reference's (the same
header, kinds and codec ids; the payloads through
``comm.transport.codec_{encode,decode}_frame`` over the port's host
codecs), optionally over the bf16/fp16/int8 wire codecs with error
feedback on the gradient hop (the residuals stay host numpy, as the
reference's do).

The stage compute is the reference's deterministic f32 MLP (layer ``L-1``
linear, the rest relu) as torch ops on the plane's device
(``PipelineConfig(device=...)``, CUDA unless asked): activations and
gradients are copied to the host once a frame, into the frame's bytes,
and land on the device once a frame on the other side. The step's inputs
are the reference's numpy draws, and ``param_hash`` hashes the same f32
C-order bytes in the same order.

Execution is schedule-driven, not timing-driven: each stage replica
follows its stage's projection of ``parallel.schedule``'s
``one_f_one_b_schedule`` (or ``gpipe_schedule`` when ``streaming=False``,
the fill/drain A/B lever), blocking on exactly the frame the schedule
dictates next. Per-microbatch gradients land in store-once slots summed
in fixed microbatch order at step end, so the pipelined arm is
sha256-for-sha256 identical to the stage-serial arm per optimizer step.

Fault tolerance: a stage-replica kill heals without draining the
pipeline. Routing is lane-based (lane r of every boundary targets replica
r of the next stage; a dead replica's lanes collapse onto its stage
peer), every replica keeps a per-step cache of the encoded frames it
already sent, and a topology-generation bump makes every live replica
resend its cached frames once against the re-resolved routes: a replay
wave that re-covers exactly the state the dead replica held, while every
surviving stage keeps streaming (``pipe_drained_steps`` stays 0;
``pipe_replay_microbatches`` counts the wave). The healed replica then
pulls its stage's layer units from its stage peer through the planner
(``comm/redistribute``) over FETCH/PARAM frames, moved bytes pinned at
the set-theoretic lower bound. The ``on_kill="drain"`` arm is the A/B
baseline: the step aborts everywhere (``step_discard`` +
``pipe_drained_steps``), the healer refetches the FULL tree, and the step
reruns.

Elastic stage re-balancing (moving layer ranges between stages) is a
``ShardSpec`` transition the same planner compiles minimally; because the
backward pass is the exact chain rule regardless of which stage hosts a
layer, a rebalance preserves the bitwise training trajectory.

Telemetry: counters/gauges (``pipe_inflight``, ``pipe_bubble_steps``,
``pipe_sched_ticks``, ``pipe_stage_bytes``, ``pipe_drained_steps``,
``pipe_replay_microbatches``, ``microbatch_send/recv``,
``pipe_stage_index``, ``pipe_stage_count``) and events
(``microbatch_send``, ``microbatch_recv``, ``stage_rebalance`` plus the
lifecycle kinds) land in the standard Metrics/EventRecorder sinks, so
the telemetry endpoints reconstruct the full bubble schedule from
``/telemetry/events`` alone: :func:`reconstruct_pipe_schedule` is that
reconstruction.
"""

from __future__ import annotations

import hashlib
import logging
import socket
import struct
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from torchft_tpu_torch.comm.redistribute import (
    RedistPlanner,
    ShardSpec,
    execute_fetches,
)
from torchft_tpu_torch.comm.transport import (
    codec_decode_frame,
    codec_encode_frame,
    make_wire_codec,
)
from torchft_tpu_torch.comm.wire import recv_exact, sendmsg_all
from torchft_tpu_torch.parallel.schedule import (
    gpipe_schedule,
    one_f_one_b_schedule,
)
from torchft_tpu_torch.utils.device import resolve_device
from torchft_tpu_torch.utils.events import EventRecorder
from torchft_tpu_torch.utils.metrics import Metrics

__all__ = [
    "PipelineConfig",
    "Pipeline",
    "expected_stage_sequence",
    "stage_bubble_slots",
    "reconstruct_pipe_schedule",
]

logger = logging.getLogger(__name__)

# ----------------------------------------------------------------- frames

_MAGIC = b"TFPP"
_VERSION = 1
# magic, version, kind, codec_id, pad, step, mb/unit, lane, from_stage,
# rows, cols, payload nbytes
_HDR = struct.Struct("!4sBBBxIIIIIIQ")

_KIND_ACT = 1
_KIND_GRAD = 2
_KIND_FETCH = 3
_KIND_PARAM = 4

_CODEC_IDS = {"none": 0, "bf16": 1, "fp16": 2, "int8": 3}


def _pack_frame(kind: int, codec_id: int, step: int, mb: int, lane: int,
                stage: int, rows: int, cols: int, payload: bytes) -> bytes:
    return _HDR.pack(_MAGIC, _VERSION, kind, codec_id, step, mb, lane,
                     stage, rows, cols, len(payload)) + payload


def _device_layers(layers: "Dict[int, Dict[str, Any]]",
                   device: torch.device) -> "Dict[int, Dict[str, Any]]":
    """Layer params (numpy arrays or tensors) as f32 tensors of their own
    on ``device``."""
    return {int(li): {k: torch.as_tensor(v).to(device, torch.float32,
                                               copy=True)
                      for k, v in p.items()}
            for li, p in layers.items()}


def _f32_bytes(t: torch.Tensor) -> bytes:
    """A tensor's f32 C-order bytes, as the reference hashes and ships
    its numpy arrays."""
    return t.detach().to("cpu", torch.float32).contiguous().numpy().tobytes()


# ----------------------------------------------------------- schedule math

def _schedule_for(num_stages: int, num_microbatches: int,
                  streaming: bool) -> List[List[Any]]:
    builder = one_f_one_b_schedule if streaming else gpipe_schedule
    return builder(num_stages, num_microbatches)


def expected_stage_sequence(num_stages: int, num_microbatches: int,
                            stage: int, streaming: bool = True,
                            ) -> "List[Tuple[str, int]]":
    """Ground truth: stage ``stage``'s (phase, microbatch) action order —
    the per-stage projection of the schedule table with idle ticks
    dropped. The runtime executes exactly this sequence per lane, and
    :func:`reconstruct_pipe_schedule` must recover it from events."""
    sched = _schedule_for(num_stages, num_microbatches, streaming)
    return [
        (a[0], a[1]) for row in sched for a in [row[stage]] if a is not None
    ]


def stage_bubble_slots(num_stages: int, num_microbatches: int,
                       streaming: bool = True) -> "Tuple[int, int]":
    """(idle slots per stage, makespan ticks) of one optimizer step —
    identical for every stage row of GPipe / non-interleaved 1F1B:
    2(S-1) idle slots over a 2(S-1)+2M makespan. Feeds the
    ``pipe_bubble_steps`` / ``pipe_sched_ticks`` counters so the bubble
    fraction is a pure counter ratio."""
    sched = _schedule_for(num_stages, num_microbatches, streaming)
    ticks = len(sched)
    return ticks - 2 * num_microbatches, ticks


def reconstruct_pipe_schedule(dumps: "Sequence[Dict[str, Any]]",
                              ) -> "Dict[int, Dict[int, List[Tuple[str, int]]]]":
    """Rebuild the executed pipeline schedule from event dumps ALONE.

    ``dumps``: any mix of ``EventRecorder.dump()`` payloads and
    ``/telemetry/events`` response bodies (one per stage replica).
    Returns ``{step: {stage: [(phase, microbatch), ...]}}`` — each
    stage's executed action order, recovered from its seq-ordered
    ``microbatch_recv`` events. For a fault-free single-lane run this
    must equal :func:`expected_stage_sequence` per stage (the flight
    recorder's contract at pipeline granularity)."""
    out: "Dict[int, Dict[int, List[Tuple[str, int]]]]" = {}
    for d in dumps:
        events = sorted(
            (e for e in d.get("events", ())
             if e and e.get("kind") == "microbatch_recv"),
            key=lambda e: e.get("seq", 0),
        )
        for e in events:
            step = int(e.get("step", 0) or 0)
            stage = int(e.get("stage", 0))
            out.setdefault(step, {}).setdefault(stage, []).append(
                (str(e.get("phase", "?")), int(e.get("mb", -1)))
            )
    return out


# ------------------------------------------------------------- primitives


class _StepAborted(Exception):
    """Raised inside a replica loop when the drain-mode baseline tears
    the current step down (the A/B counterpoint to the replay wave)."""


class _Topology:
    """Live-ness + lane routing for the S×R replica grid.

    ``generation`` bumps on every death/revival; replica loops watch it
    to re-resolve routes, adopt orphaned lanes, and fire the replay
    wave. ``route(stage, lane)`` maps a lane onto the lane-aligned
    replica when it lives, else onto the lowest live replica of the
    stage (the collapse that keeps surviving stages streaming).
    ``endpoint`` names a replica's current incarnation: a revived replica
    is a new endpoint even if its server got the dead one's port back, so
    no sender reuses a connection the dead replica's readers still
    drain."""

    def __init__(self, num_stages: int, replicas: int) -> None:
        self.num_stages = int(num_stages)
        self.replicas = int(replicas)
        self._lock = threading.Lock()
        self._live = {
            (s, r): True
            for s in range(self.num_stages) for r in range(self.replicas)
        }
        self._addrs: "Dict[Tuple[int, int], Tuple[str, int]]" = {}
        self._incarnations: "Dict[Tuple[int, int], int]" = {}
        self.generation = 0
        self._watchers: "List[Callable[[], None]]" = []

    def add_watcher(self, poke: "Callable[[], None]") -> None:
        with self._lock:
            self._watchers.append(poke)

    def _poke_all(self) -> None:
        for poke in list(self._watchers):
            try:
                poke()
            except Exception:  # pragma: no cover — waking is best-effort
                pass

    def set_addr(self, stage: int, replica: int,
                 addr: "Tuple[str, int]") -> None:
        with self._lock:
            self._addrs[(stage, replica)] = addr

    def addr(self, stage: int, replica: int) -> "Tuple[str, int]":
        with self._lock:
            return self._addrs[(stage, replica)]

    def endpoint(self, stage: int, replica: int,
                 ) -> "Tuple[Tuple[str, int], int]":
        """(address, incarnation) of the replica's current server."""
        with self._lock:
            return (self._addrs[(stage, replica)],
                    self._incarnations.get((stage, replica), 0))

    def is_live(self, stage: int, replica: int) -> bool:
        with self._lock:
            return self._live.get((stage, replica), False)

    def live_replicas(self, stage: int) -> "List[int]":
        with self._lock:
            return [
                r for r in range(self.replicas) if self._live[(stage, r)]
            ]

    def route(self, stage: int, lane: int) -> int:
        with self._lock:
            if self._live[(stage, lane % self.replicas)]:
                return lane % self.replicas
            for r in range(self.replicas):
                if self._live[(stage, r)]:
                    return r
        raise ConnectionError(
            f"pipeline stage {stage} has no live replica — the stage's "
            "whole replica group died; heal one replica before resuming"
        )

    def lanes_for(self, stage: int, replica: int) -> "List[int]":
        return [
            lane for lane in range(self.replicas)
            if self.route(stage, lane) == replica
        ]

    def mark_dead(self, stage: int, replica: int) -> None:
        with self._lock:
            self._live[(stage, replica)] = False
            self.generation += 1
        self._poke_all()

    def revive(self, stage: int, replica: int,
               addr: "Tuple[str, int]") -> None:
        with self._lock:
            self._live[(stage, replica)] = True
            self._addrs[(stage, replica)] = addr
            self._incarnations[(stage, replica)] = \
                self._incarnations.get((stage, replica), 0) + 1
            self.generation += 1
        self._poke_all()


class _Mailbox:
    """Keyed frame store with a condition: readers block for the exact
    frame the schedule needs next; topology pokes wake every waiter so
    route adoption and drain aborts preempt a blocked wait."""

    def __init__(self) -> None:
        self._cond = threading.Condition()
        self._frames: "Dict[tuple, np.ndarray]" = {}

    def put(self, key: tuple, value: np.ndarray) -> None:
        with self._cond:
            self._frames[key] = value
            self._cond.notify_all()

    def poke(self) -> None:
        with self._cond:
            self._cond.notify_all()

    def has(self, key: tuple) -> bool:
        with self._cond:
            return key in self._frames

    def pop(self, key: tuple) -> np.ndarray:
        with self._cond:
            return self._frames.pop(key)

    def wait_any(self, timeout: float) -> None:
        with self._cond:
            self._cond.wait(timeout)

    def clear_before(self, step: int) -> None:
        """Drop frames of earlier steps only: a fast upstream stage may
        legally deliver step-k frames before this replica's step-k loop
        starts, so a blanket clear would eat them."""
        with self._cond:
            for key in [k for k in self._frames if k[0] < step]:
                del self._frames[key]


class _ConnCache:
    """One persistent outbound socket per destination endpoint (address,
    incarnation: ``_Topology.endpoint``), with a per-connection send lock
    (frames from one sender stay ordered — the FIFO the replay-wave
    argument relies on). ``timeout`` bounds a connect and each send."""

    def __init__(self, timeout: float) -> None:
        self._timeout = float(timeout)
        self._lock = threading.Lock()
        self._conns: "Dict[tuple, Tuple[socket.socket, threading.Lock]]" = {}

    def send(self, endpoint: tuple, frame: bytes) -> None:
        with self._lock:
            entry = self._conns.get(endpoint)
            if entry is None:
                sock = socket.create_connection(endpoint[0],
                                                timeout=self._timeout)
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                entry = (sock, threading.Lock())
                self._conns[endpoint] = entry
        sock, lock = entry
        try:
            with lock:
                sendmsg_all(sock, [frame])
        except OSError:
            self.drop(endpoint)
            raise

    def drop(self, endpoint: tuple) -> None:
        with self._lock:
            entry = self._conns.pop(endpoint, None)
        if entry is not None:
            try:
                entry[0].close()
            except OSError:  # pragma: no cover — best-effort close
                pass

    def close(self) -> None:
        with self._lock:
            conns, self._conns = self._conns, {}
        for sock, _ in conns.values():
            try:
                sock.close()
            except OSError:  # pragma: no cover
                pass


class PipelineConfig:
    """Static shape of one pipeline run (all fields deterministic).

    ``layer_dims``: MLP widths, ``len(layer_dims) - 1`` layers; layer
    ``L-1`` is linear, the rest relu. ``stage_layers``: global layer
    indices per stage (contiguous ranges; this is the ShardSpec unit
    grid the heal/rebalance planner prices). ``replicas``: replica
    group size per stage (lanes). ``microbatches`` must divide evenly
    across lanes. ``codec``: stage-boundary wire codec ("none" / "bf16"
    / "fp16" / "int8"); ``error_feedback`` arms the EF residuals
    on the gradient hop. ``streaming``: 1F1B when True, GPipe
    fill/drain (the stage-serial A/B arm) when False. ``on_kill``:
    "heal" = replay wave, no drain; "drain" = abort + full-tree refetch
    + rerun (the baseline). ``step_timeout`` bounds every blocking wait
    of a step. ``device``: where the stage compute runs (CUDA unless
    asked, ``utils.device.resolve_device``)."""

    def __init__(self, layer_dims: "Sequence[int]" = (8, 8, 8, 8, 8),
                 stage_layers: "Optional[Sequence[Sequence[int]]]" = None,
                 num_stages: int = 2, replicas: int = 1,
                 microbatches: int = 4, batch: int = 4, lr: float = 0.05,
                 seed: int = 0, codec: str = "none",
                 error_feedback: bool = False, streaming: bool = True,
                 on_kill: str = "heal", step_timeout: float = 60.0,
                 device: "Optional[str | torch.device]" = None) -> None:
        self.layer_dims = tuple(int(d) for d in layer_dims)
        n_layers = len(self.layer_dims) - 1
        if stage_layers is None:
            S = int(num_stages)
            bounds = [n_layers * s // S for s in range(S + 1)]
            stage_layers = [
                list(range(bounds[s], bounds[s + 1])) for s in range(S)
            ]
        self.stage_layers = [
            [int(i) for i in layers] for layers in stage_layers
        ]
        self.num_stages = len(self.stage_layers)
        self.num_layers = n_layers
        self.replicas = int(replicas)
        self.microbatches = int(microbatches)
        if self.microbatches % self.replicas:
            raise ValueError(
                f"microbatches ({self.microbatches}) must divide evenly "
                f"across {self.replicas} lanes"
            )
        self.batch = int(batch)
        self.lr = np.float32(lr)
        self.seed = int(seed)
        if codec not in _CODEC_IDS:
            raise ValueError(
                f"unknown pipeline codec {codec!r}; have {sorted(_CODEC_IDS)}"
            )
        self.codec = codec
        self.error_feedback = bool(error_feedback)
        self.streaming = bool(streaming)
        if on_kill not in ("heal", "drain"):
            raise ValueError("on_kill must be 'heal' or 'drain'")
        self.on_kill = on_kill
        self.step_timeout = float(step_timeout)
        self.device = resolve_device(device)

class _StageReplica:
    """One stage replica: layer params, a frame server, and the
    schedule-driven step loop. Threads: one accept loop plus one reader
    per inbound connection; the step itself runs on a per-step worker
    thread owned by the Pipeline."""

    def __init__(self, pipeline: "Pipeline", stage: int, replica: int,
                 layers: "Dict[int, Dict[str, Any]]",
                 manager: "Optional[Any]" = None) -> None:
        self.pipeline = pipeline
        self.cfg = pipeline.cfg
        self.device = self.cfg.device
        self.stage = int(stage)
        self.replica = int(replica)
        self._param_lock = threading.Lock()
        self.layers = _device_layers(layers, self.device)
        self.manager = manager
        if manager is not None:
            self.metrics = manager.metrics
            self.events = manager.events
            bind = getattr(manager, "bind_stage", None)
            if callable(bind):
                bind(self.stage, self.cfg.num_stages)
            else:  # a manager surface without bind_stage
                self.metrics.gauge("pipe_stage_index", self.stage)
                self.metrics.gauge("pipe_stage_count", self.cfg.num_stages)
        else:
            self.metrics = Metrics()
            self.events = EventRecorder(
                replica_id=f"pipe-s{stage}r{replica}", rank=replica
            )
            self.metrics.gauge("pipe_stage_index", self.stage)
            self.metrics.gauge("pipe_stage_count", self.cfg.num_stages)
        self.codec = make_wire_codec(self.cfg.codec)
        self._codec_id = _CODEC_IDS[self.cfg.codec]
        self._lossy = self.cfg.codec != "none"
        self._residuals: "Dict[tuple, np.ndarray]" = {}
        self.mailbox = _Mailbox()
        self._conns = _ConnCache(self.cfg.step_timeout)
        self.kill_after: "Optional[int]" = None
        self.dead = False
        self._closed = False
        # per-step state (reset in run_step)
        self._act_cache: "Dict[Tuple[int, int], bytes]" = {}
        self._grad_cache: "Dict[Tuple[int, int], bytes]" = {}
        self._server = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._server.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._server.bind(("127.0.0.1", 0))
        self._server.listen(16)
        self.addr = self._server.getsockname()
        threading.Thread(
            target=self._accept_loop, daemon=True,
            name=f"pipe-accept-s{stage}r{replica}",
        ).start()

    # ------------------------------------------------------- frame server

    def _accept_loop(self) -> None:
        while not self._closed:
            try:
                conn, _ = self._server.accept()
            except OSError:
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            threading.Thread(
                target=self._reader_loop, args=(conn,), daemon=True,
                name=f"pipe-read-s{self.stage}r{self.replica}",
            ).start()

    def _reader_loop(self, conn: socket.socket) -> None:
        try:
            while True:
                hdr = recv_exact(conn, _HDR.size)
                (magic, ver, kind, _codec, step, mb, lane, from_stage,
                 rows, cols, nbytes) = _HDR.unpack(bytes(hdr))
                if magic != _MAGIC or ver != _VERSION:
                    raise ConnectionError(
                        f"bad pipeline frame magic/version from stage "
                        f"{from_stage}: speak protocol v{_VERSION}"
                    )
                payload = bytes(recv_exact(conn, nbytes)) if nbytes else b""
                if kind == _KIND_FETCH:
                    self._serve_fetch(conn, mb)
                    continue
                out = np.empty(rows * cols, np.float32)
                codec_decode_frame(self.codec, payload, out)
                key = (step, kind, lane, mb)
                self.mailbox.put(key, out.reshape(rows, cols))
        except (ConnectionError, OSError):
            pass  # peer closed / died; routing + replay own recovery
        finally:
            try:
                conn.close()
            except OSError:  # pragma: no cover
                pass

    def _serve_fetch(self, conn: socket.socket, unit: int) -> None:
        """Answer a heal/rebalance FETCH inline: one PARAM frame with the
        layer's full-precision f32 bytes (the heal plane never rides the
        lossy stage codec)."""
        with self._param_lock:
            layer = self.layers.get(int(unit))
            if layer is None:
                raise ConnectionError(
                    f"stage {self.stage} replica {self.replica} asked for "
                    f"layer {unit} it does not hold"
                )
            rows, cols = layer["W"].shape
            payload = _f32_bytes(layer["W"]) + _f32_bytes(layer["b"])
        frame = _pack_frame(_KIND_PARAM, 0, 0, int(unit), 0, self.stage,
                            rows, cols, payload)
        sendmsg_all(conn, [frame])

    # ---------------------------------------------------------- send side

    def _encode_payload(self, arr: np.ndarray, kind: int,
                        lane: int, mb: int) -> bytes:
        flat = np.ascontiguousarray(arr, np.float32).reshape(-1)
        if (kind == _KIND_GRAD and self._lossy
                and self.cfg.error_feedback):
            key = (lane, mb)
            res = self._residuals.get(key)
            if res is None:
                res = np.zeros_like(flat)
            comp = flat + res
            data = codec_encode_frame(self.codec, comp)
            decoded = np.empty_like(comp)
            codec_decode_frame(self.codec, data, decoded)
            self._residuals[key] = comp - decoded
            return data
        return codec_encode_frame(self.codec, flat)

    def _send_routed(self, kind: int, to_stage: int, step: int, lane: int,
                     mb: int, frame: bytes, frame_name: str,
                     replay: bool = False) -> None:
        """Send one cached frame along the lane's CURRENT route, retrying
        once across a route change. A frame that still cannot land is
        dropped — the topology-generation replay wave re-covers it."""
        topo = self.pipeline.topo
        for _attempt in range(2):
            try:
                tgt = topo.route(to_stage, lane)
                self._conns.send(topo.endpoint(to_stage, tgt), frame)
                break
            except (ConnectionError, OSError):
                continue
        else:
            logger.warning(
                "pipeline frame %s step %d mb %d lane %d to stage %d "
                "dropped; the replay wave will re-cover it",
                frame_name, step, mb, lane, to_stage,
            )
            return
        self.metrics.incr("microbatch_send")
        self.metrics.incr("pipe_stage_bytes", len(frame))
        ev = self.events
        if ev:
            ev.emit("microbatch_send", step=step, mb=mb, lane=lane,
                    frame=frame_name, from_stage=self.stage,
                    to_stage=to_stage, nbytes=len(frame), replay=replay)

    def _send_tensor(self, kind: int, to_stage: int, step: int, lane: int,
                     mb: int, t: torch.Tensor, frame_name: str) -> None:
        # the one device-to-host copy of this frame
        arr = t.detach().to("cpu", torch.float32).numpy()
        payload = self._encode_payload(arr, kind, lane, mb)
        frame = _pack_frame(kind, self._codec_id, step, mb, lane,
                            self.stage, arr.shape[0], arr.shape[1], payload)
        cache = self._act_cache if kind == _KIND_ACT else self._grad_cache
        cache[(lane, mb)] = frame
        self._send_routed(kind, to_stage, step, lane, mb, frame, frame_name)

    def _replay_cached(self, step: int) -> None:
        """The replay wave: resend every frame this replica already sent
        this step, against re-resolved routes. Store-once grad slots and
        keyed mailboxes make duplicates idempotent; the union of every
        live replica's wave reconstructs exactly the state the dead
        replica held."""
        n = 0
        for (lane, mb), frame in sorted(self._act_cache.items()):
            self._send_routed(_KIND_ACT, self.stage + 1, step, lane, mb,
                              frame, "act", replay=True)
            n += 1
        for (lane, mb), frame in sorted(self._grad_cache.items()):
            self._send_routed(_KIND_GRAD, self.stage - 1, step, lane, mb,
                              frame, "grad", replay=True)
            n += 1
        if n:
            self.metrics.incr("pipe_replay_microbatches", n)

    # ------------------------------------------------------- stage compute

    def _land(self, value: "np.ndarray | torch.Tensor") -> torch.Tensor:
        """A mailbox value (a decoded frame, or the last stage's own loss
        gradient) on this replica's device: the frame's one host-to-device
        copy."""
        if isinstance(value, torch.Tensor):
            return value
        return torch.from_numpy(value).to(self.device)

    def _forward(self, x: torch.Tensor) -> "Tuple[torch.Tensor, list]":
        """The stage's layers on ``x``: the output and, per layer, its
        (index, input, pre-activation) for the backward."""
        h = x
        saved: "List[Tuple[int, torch.Tensor, torch.Tensor]]" = []
        with self._param_lock:
            order = sorted(self.layers)
            params = {i: (self.layers[i]["W"], self.layers[i]["b"])
                      for i in order}
        last = self.cfg.num_layers - 1
        for li in order:
            w, b = params[li]
            z = h @ w + b
            saved.append((li, h, z))
            h = z if li == last else torch.relu(z)
        return h, saved

    def _backward(self, saved, gy: torch.Tensor,
                  slots: "Dict[int, Dict[int, List[torch.Tensor]]]",
                  mb: int) -> torch.Tensor:
        g = gy
        last = self.cfg.num_layers - 1
        with self._param_lock:
            weights = {li: self.layers[li]["W"] for li, _, _ in saved}
        for li, h_in, z in reversed(saved):
            dz = g if li == last else g * (z > 0)
            slots.setdefault(mb, {})[li] = [h_in.T @ dz, dz.sum(0)]
            g = dz @ weights[li].T
        return g

    # ----------------------------------------------------------- step loop

    def _lane_mbs(self, lane: int) -> "List[int]":
        return list(range(lane, self.cfg.microbatches, self.cfg.replicas))

    def _die(self, step: int) -> None:
        ev = self.events
        if ev:
            ev.emit("member_dead", step=step, stage=self.stage,
                    replica=self.replica)
        self.dead = True
        self.pipeline.topo.mark_dead(self.stage, self.replica)
        self.close()

    def run_step(self, step: int, data: "Dict[str, List[np.ndarray]]",
                 reduce_group: "_StageReduce", gen0: int
                 ) -> "Dict[str, Any]":
        """One step of this replica's lanes. ``gen0``: the topology
        generation when the step began, read once for every replica, so a
        thread that starts after a peer already died still sees the death
        as this step's (drain: abort; heal: adopt and replay)."""
        cfg = self.cfg
        topo = self.pipeline.topo
        S = cfg.num_stages
        self._act_cache.clear()
        self._grad_cache.clear()
        self.mailbox.clear_before(step)
        seen_gen = gen0
        lanes: "Dict[int, Dict[str, Any]]" = {}

        def _adopt_lanes() -> None:
            for lane in topo.lanes_for(self.stage, self.replica):
                if lane not in lanes:
                    mbs = self._lane_mbs(lane)
                    lanes[lane] = {
                        "mbs": mbs,
                        "actions": expected_stage_sequence(
                            S, len(mbs), self.stage, cfg.streaming),
                        "ptr": 0,
                    }

        _adopt_lanes()
        slots: "Dict[int, Dict[int, List[torch.Tensor]]]" = {}
        acts: "Dict[int, Any]" = {}
        losses: "Dict[int, float]" = {}
        inflight_peak = 0
        executed = 0
        t_end = time.monotonic() + cfg.step_timeout

        def _ready(lane: int, st: "Dict[str, Any]") -> bool:
            phase, k = st["actions"][st["ptr"]]
            mb = st["mbs"][k]
            if phase == "F":
                return (self.stage == 0
                        or self.mailbox.has((step, _KIND_ACT, lane, mb)))
            return self.mailbox.has((step, _KIND_GRAD, lane, mb))

        def _execute(lane: int, st: "Dict[str, Any]") -> None:
            nonlocal inflight_peak, executed
            phase, k = st["actions"][st["ptr"]]
            mb = st["mbs"][k]
            ev = self.events
            if phase == "F":
                if self.stage == 0:
                    x = self._land(data["x"][mb])
                    frame_name = "data"
                else:
                    x = self._land(self.mailbox.pop((step, _KIND_ACT, lane,
                                                     mb)))
                    frame_name = "act"
                self.metrics.incr("microbatch_recv")
                if ev:
                    ev.emit("microbatch_recv", step=step, mb=mb, lane=lane,
                            frame=frame_name, stage=self.stage,
                            replica=self.replica, phase="F")
                h, saved = self._forward(x)
                acts[mb] = saved
                inflight_peak = max(inflight_peak, len(acts))
                if self.stage < S - 1:
                    self._send_tensor(_KIND_ACT, self.stage + 1, step,
                                      lane, mb, h, "act")
                else:
                    diff = h - self._land(data["y"][mb])
                    losses[mb] = float(torch.mean(diff * diff))
                    gy = diff * (2.0 / diff.numel())
                    self.mailbox.put((step, _KIND_GRAD, lane, mb), gy)
            else:
                gy = self._land(self.mailbox.pop((step, _KIND_GRAD, lane,
                                                  mb)))
                frame_name = "loss" if self.stage == S - 1 else "grad"
                self.metrics.incr("microbatch_recv")
                if ev:
                    ev.emit("microbatch_recv", step=step, mb=mb, lane=lane,
                            frame=frame_name, stage=self.stage,
                            replica=self.replica, phase="B")
                saved = acts.pop(mb)
                gx = self._backward(saved, gy, slots, mb)
                if self.stage > 0:
                    self._send_tensor(_KIND_GRAD, self.stage - 1, step,
                                      lane, mb, gx, "grad")
            st["ptr"] += 1
            executed += 1
            if (self.kill_after is not None
                    and executed >= self.kill_after):
                self.kill_after = None
                self._die(step)
                raise _StepAborted("killed")

        def _check_generation() -> None:
            nonlocal seen_gen
            gen = topo.generation
            if gen != seen_gen:
                seen_gen = gen
                if cfg.on_kill == "drain":
                    raise _StepAborted("drain")
                _adopt_lanes()
                self._replay_cached(step)

        try:
            while True:
                # action phase: run every routed lane's projected
                # schedule to completion
                while any(st["ptr"] < len(st["actions"])
                          for st in lanes.values()):
                    _check_generation()
                    progress = False
                    for lane in sorted(lanes):
                        st = lanes[lane]
                        while (st["ptr"] < len(st["actions"])
                               and _ready(lane, st)):
                            _execute(lane, st)
                            progress = True
                    if not progress:
                        if time.monotonic() > t_end:
                            raise RuntimeError(
                                f"pipeline stage {self.stage} replica "
                                f"{self.replica} stalled at step {step}: "
                                + ", ".join(
                                    f"lane {ln} at {st['ptr']}/"
                                    f"{len(st['actions'])}"
                                    for ln, st in sorted(lanes.items()))
                            )
                        self.mailbox.wait_any(0.2)
                # rendezvous phase: combine lane-partial grads across
                # the stage. None = lane coverage went incomplete (our
                # peer died mid-rendezvous) — loop back, adopt its
                # lanes, replay, re-contribute.
                _check_generation()
                if any(st["ptr"] < len(st["actions"])
                       for st in lanes.values()):
                    # the generation check just adopted an orphaned lane
                    # whose schedule has not run yet; contributing now
                    # would claim coverage for microbatches whose grads
                    # are not in the slots.
                    continue
                combined = reduce_group.combine(
                    self.replica, self._flat_grads(slots),
                    set(lanes), range(cfg.replicas), seen_gen)
                if combined is not None:
                    break
        except _StepAborted as abort:
            if str(abort) == "killed":
                return {"status": "killed"}
            self.metrics.incr("pipe_drained_steps")
            ev = self.events
            if ev:
                ev.emit("step_discard", step=step, stage=self.stage,
                        replica=self.replica, reason="pipeline drain")
            return {"status": "aborted"}

        return self._finalize(step, combined, losses, inflight_peak,
                              lanes)

    def _flat_grads(self, slots) -> "List[torch.Tensor]":
        """Store-once slots summed in fixed global-microbatch order: the
        bitwise anchor that makes pipelined ≡ stage-serial exact."""
        with self._param_lock:
            order = sorted(self.layers)
        flats: "List[torch.Tensor]" = []
        for li in order:
            acc_w = acc_b = None
            for mb in sorted(slots):
                gw, gb = slots[mb][li]
                if acc_w is None:
                    acc_w, acc_b = gw.clone(), gb.clone()
                else:
                    acc_w += gw
                    acc_b += gb
            flats.extend([acc_w, acc_b])
        return flats

    def _finalize(self, step, combined, losses, inflight_peak,
                  lanes) -> "Dict[str, Any]":
        cfg = self.cfg
        with self._param_lock:
            order = sorted(self.layers)
        # f32 scalars, as the reference's np.float32 ones
        scale, lr = float(np.float32(1.0 / cfg.microbatches)), float(cfg.lr)
        with self._param_lock:
            for i, li in enumerate(order):
                gw = combined[2 * i] * scale
                gb = combined[2 * i + 1] * scale
                self.layers[li]["W"] -= lr * gw
                self.layers[li]["b"] -= lr * gb
        idle, ticks = stage_bubble_slots(
            cfg.num_stages, cfg.microbatches // cfg.replicas, cfg.streaming)
        self.metrics.incr("pipe_bubble_steps", idle * len(lanes))
        self.metrics.incr("pipe_sched_ticks", ticks * len(lanes))
        self.metrics.gauge("pipe_inflight", inflight_peak)
        ev = self.events
        if ev:
            ev.emit("step_commit", step=step, stage=self.stage,
                    replica=self.replica, inflight_peak=inflight_peak)
        return {"status": "ok", "hash": self.param_hash(),
                "losses": dict(losses), "inflight_peak": inflight_peak}

    # ----------------------------------------------------------- utilities

    def param_hash(self) -> str:
        h = hashlib.sha256()
        with self._param_lock:
            for li in sorted(self.layers):
                h.update(_f32_bytes(self.layers[li]["W"]))
                h.update(_f32_bytes(self.layers[li]["b"]))
        return h.hexdigest()

    def held_units(self) -> "List[int]":
        with self._param_lock:
            return sorted(self.layers)

    def set_layers(self, layers: "Dict[int, Dict[str, Any]]") -> None:
        layers = _device_layers(layers, self.device)
        with self._param_lock:
            self.layers = layers

    def close(self) -> None:
        self._closed = True
        try:
            self._server.close()
        except OSError:  # pragma: no cover
            pass
        self._conns.close()
        self.mailbox.poke()


class _StageReduce:
    """Per-step intra-stage gradient rendezvous: every live replica of a
    stage contributes its lane-partial flat grads; the sum runs in
    replica-index order, so it is deterministic and — when a stage also
    carries a Manager wire — bitwise identical to the star allreduce's
    rank-order reduction (tests pin that parity). Membership is
    re-evaluated on every topology poke, so a replica that died mid-step
    is excluded instead of hanging the barrier (its lanes were already
    re-covered by the replay wave)."""

    def __init__(self, topo: _Topology, stage: int, timeout: float) -> None:
        self._topo = topo
        self._stage = stage
        self._timeout = timeout
        self._cond = threading.Condition()
        self._round = 0
        self._contrib: "Dict[int, Tuple[List[torch.Tensor], set]]" = {}

    def poke(self) -> None:
        with self._cond:
            self._cond.notify_all()

    def combine(self, replica: int, flats: "List[torch.Tensor]",
                lanes_covered: set,
                all_lanes, gen0: int) -> "Optional[List[torch.Tensor]]":
        """Contribute and wait. Returns the deterministic replica-order
        sum once every live replica has contributed AND the live
        contributions jointly cover every lane — or ``None`` when the
        round is voided (a death left a lane uncovered, or the topology
        generation moved past ``gen0``, the caller's last-observed
        value): the caller must re-observe the generation — abort
        (drain) or adopt the orphaned lanes, replay — and re-contribute."""
        t_end = time.monotonic() + self._timeout
        with self._cond:
            round0 = self._round
            self._contrib[replica] = (flats, set(lanes_covered))
            self._cond.notify_all()
            while True:
                if self._round != round0:
                    return None
                if self._topo.generation != gen0:
                    # a death ANYWHERE in the pipeline (not just this
                    # stage) voids the round: peers in other stages may
                    # have aborted (drain) or gone off to replay (heal)
                    # and will never arrive, so waiting here deadlocks
                    self._round += 1
                    self._contrib.clear()
                    self._cond.notify_all()
                    return None
                live = self._topo.live_replicas(self._stage)
                if all(r in self._contrib for r in live):
                    union = set()
                    for r in live:
                        union |= self._contrib[r][1]
                    if union >= set(all_lanes):
                        members = sorted(r for r in self._contrib
                                         if r in live)
                        out = [a.clone()
                               for a in self._contrib[members[0]][0]]
                        for r in members[1:]:
                            for acc, part in zip(
                                    out, self._contrib[r][0]):
                                acc += part
                        return out
                    # a lane died with its replica mid-rendezvous: void
                    # the round so the survivor re-runs with adopted
                    # lanes instead of committing a partial sum
                    self._round += 1
                    self._contrib.clear()
                    self._cond.notify_all()
                    return None
                if time.monotonic() > t_end:
                    raise RuntimeError(
                        f"stage {self._stage} gradient rendezvous timed "
                        f"out: have {sorted(self._contrib)}, need {live}"
                    )
                self._cond.wait(0.2)


class Pipeline:
    """The MPMD pipeline plane: S stages × R replicas of deterministic
    f32 MLP stage compute, streaming microbatch frames between stages.

    ``manager_factory(stage, replica)`` (optional) supplies a Manager
    surface per replica (a real ``Manager`` or ``WireStubManager``);
    its metrics/events sinks are adopted and ``bind_stage`` is called,
    so the stage topology rides the standard telemetry plane. Without
    a factory each replica carries its own ``Metrics``/``EventRecorder``
    (replica_id ``pipe-s{stage}r{replica}``)."""

    def __init__(self, cfg: PipelineConfig,
                 manager_factory: "Optional[Callable[[int, int], Any]]" = None,
                 ) -> None:
        self.cfg = cfg
        self.topo = _Topology(cfg.num_stages, cfg.replicas)
        self.planner = RedistPlanner()
        self._step = 0
        self._kill_plan: "Optional[Dict[str, int]]" = None
        self._groups: "Dict[int, _StageReduce]" = {}
        rng = np.random.default_rng(cfg.seed)
        self._init_layers = {}
        for li in range(cfg.num_layers):
            d_in, d_out = cfg.layer_dims[li], cfg.layer_dims[li + 1]
            self._init_layers[li] = {
                "W": (rng.standard_normal((d_in, d_out))
                      * (1.0 / np.sqrt(d_in))).astype(np.float32),
                "b": np.zeros(d_out, np.float32),
            }
        self.stage_layers = [list(ls) for ls in cfg.stage_layers]
        self.replicas: "Dict[Tuple[int, int], _StageReplica]" = {}
        for s in range(cfg.num_stages):
            for r in range(cfg.replicas):
                mgr = (manager_factory(s, r)
                       if manager_factory is not None else None)
                rep = _StageReplica(self, s, r, {
                    li: {"W": self._init_layers[li]["W"].copy(),
                         "b": self._init_layers[li]["b"].copy()}
                    for li in self.stage_layers[s]
                }, manager=mgr)
                self.replicas[(s, r)] = rep
                self.topo.set_addr(s, r, rep.addr)
                self.topo.add_watcher(rep.mailbox.poke)
        self.topo.add_watcher(self._poke_groups)
        self._unit_bytes = [
            self._init_layers[li]["W"].nbytes
            + self._init_layers[li]["b"].nbytes
            for li in range(cfg.num_layers)
        ]
        self._manager_factory = manager_factory

    # --------------------------------------------------------- accounting

    def _poke_groups(self) -> None:
        for g in list(self._groups.values()):
            g.poke()

    def _holder_id(self, stage: int, replica: int) -> int:
        return stage * self.cfg.replicas + replica

    def stage_param_bytes(self, stage: int) -> int:
        """Bytes of one replica's layer params at ``stage`` — the
        set-theoretic lower bound a minimal heal of that stage moves."""
        return sum(self._unit_bytes[li] for li in self.stage_layers[stage])

    def total_param_bytes(self) -> int:
        return sum(self._unit_bytes)

    def global_param_hash(self) -> str:
        """sha256 over the whole model in global layer order, read from
        the lowest live replica of each owning stage — THE cross-arm
        step oracle."""
        h = hashlib.sha256()
        for li in range(self.cfg.num_layers):
            stage = next(
                s for s, ls in enumerate(self.stage_layers) if li in ls
            )
            rep = self.replicas[(stage, self.topo.live_replicas(stage)[0])]
            with rep._param_lock:
                h.update(_f32_bytes(rep.layers[li]["W"]))
                h.update(_f32_bytes(rep.layers[li]["b"]))
        return h.hexdigest()

    def metrics_snapshots(self) -> "Dict[str, Dict[str, Any]]":
        return {
            f"s{s}r{r}": rep.metrics.snapshot()
            for (s, r), rep in sorted(self.replicas.items())
        }

    def event_dumps(self) -> "List[Dict[str, Any]]":
        return [rep.events.dump()
                for _, rep in sorted(self.replicas.items())]

    # ------------------------------------------------------------ stepping

    def _step_data(self, step: int) -> "Dict[str, List[np.ndarray]]":
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed + 1) * 1_000_003 + step)
        xs = [rng.standard_normal(
            (cfg.batch, cfg.layer_dims[0])).astype(np.float32)
            for _ in range(cfg.microbatches)]
        ys = [rng.standard_normal(
            (cfg.batch, cfg.layer_dims[-1])).astype(np.float32)
            for _ in range(cfg.microbatches)]
        return {"x": xs, "y": ys}

    def schedule_kill(self, stage: int, replica: int,
                      after_actions: int) -> None:
        """Arm a deterministic mid-step kill: the target replica dies
        after executing ``after_actions`` schedule actions of the next
        step — between frames, the cooperative fail-stop model every
        chaos arm in this repo uses."""
        self._kill_plan = {"stage": int(stage), "replica": int(replica),
                           "after": int(after_actions)}

    def run_step(self) -> "Dict[str, Any]":
        step = self._step
        killed: "List[Tuple[int, int]]" = []
        for _attempt in range(3):
            result = self._run_step_once(step)
            killed.extend(result["killed"])
            if not result["aborted"]:
                break
            # drain-and-restart baseline: heal the dead replica from the
            # FULL tree (checkpoint-restore semantics), then rerun.
            for (s, r) in result["killed"]:
                self.heal(s, r, full_tree=True)
        self._step += 1
        result["step"] = step
        result["killed"] = killed
        return result

    def _run_step_once(self, step: int) -> "Dict[str, Any]":
        cfg = self.cfg
        data = self._step_data(step)
        self._groups = {
            s: _StageReduce(self.topo, s, cfg.step_timeout)
            for s in range(cfg.num_stages)
        }
        live = [
            (s, r) for (s, r), rep in sorted(self.replicas.items())
            if not rep.dead
        ]
        plan = self._kill_plan
        if plan is not None:
            self._kill_plan = None
            target = self.replicas.get((plan["stage"], plan["replica"]))
            if target is not None and not target.dead:
                target.kill_after = plan["after"]
        results: "Dict[Tuple[int, int], Dict[str, Any]]" = {}
        errors: "List[str]" = []
        gen0 = self.topo.generation

        def _worker(key: "Tuple[int, int]") -> None:
            rep = self.replicas[key]
            try:
                results[key] = rep.run_step(
                    step, data, self._groups[key[0]], gen0)
            except Exception as e:  # noqa: BLE001 — aggregated below
                errors.append(f"stage {key[0]} replica {key[1]}: {e!r}")

        threads = [
            threading.Thread(target=_worker, args=(key,),
                             name=f"pipe-step-s{key[0]}r{key[1]}")
            for key in live
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=cfg.step_timeout + 30.0)
        if errors or any(t.is_alive() for t in threads):
            raise RuntimeError(
                "pipeline step failed: " + ("; ".join(errors) or
                                            "a replica thread hung")
            )
        killed = [k for k, v in results.items()
                  if v.get("status") == "killed"]
        aborted = any(v.get("status") == "aborted" for v in results.values())
        losses: "Dict[int, float]" = {}
        inflight = 0
        for v in results.values():
            losses.update(v.get("losses", {}))
            inflight = max(inflight, v.get("inflight_peak", 0))
        return {
            "aborted": aborted,
            "killed": killed,
            "hashes": {k: v.get("hash") for k, v in results.items()
                       if v.get("status") == "ok"},
            "loss": (sum(losses[m] for m in sorted(losses)) / len(losses)
                     if losses else None),
            "inflight_peak": inflight,
        }

    def run(self, steps: int) -> "List[Dict[str, Any]]":
        return [self.run_step() for _ in range(steps)]

    # ------------------------------------------------------ heal/rebalance

    def _live_src_spec(self) -> ShardSpec:
        assignment = {
            self._holder_id(s, r): self.replicas[(s, r)].held_units()
            for s in range(self.cfg.num_stages)
            for r in self.topo.live_replicas(s)
        }
        return ShardSpec(self.cfg.num_layers, assignment)

    def _fetch_unit(self, holder: int, unit: int) -> "List[np.ndarray]":
        """The heal-plane fetch: one FETCH frame to the holder's frame
        server, one PARAM frame back — full-precision layer bytes over
        the same wire.py primitives the data plane uses."""
        stage, replica = divmod(holder, self.cfg.replicas)
        addr = self.topo.addr(stage, replica)
        with socket.create_connection(
                addr, timeout=self.cfg.step_timeout) as sock:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            sendmsg_all(sock, [_pack_frame(
                _KIND_FETCH, 0, 0, int(unit), 0, 0, 0, 0, b"")])
            hdr = recv_exact(sock, _HDR.size)
            (magic, _ver, kind, _codec, _step, got_unit, _lane, _stage,
             rows, cols, nbytes) = _HDR.unpack(bytes(hdr))
            if magic != _MAGIC or kind != _KIND_PARAM or got_unit != unit:
                raise ConnectionError(
                    f"bad PARAM reply for unit {unit} from holder {holder}"
                )
            payload = recv_exact(sock, nbytes)
        w = np.frombuffer(bytes(payload[:rows * cols * 4]),
                          np.float32).reshape(rows, cols).copy()
        b = np.frombuffer(bytes(payload[rows * cols * 4:]),
                          np.float32).copy()
        return [w, b]

    def heal(self, stage: int, replica: int,
             full_tree: bool = False) -> "Dict[str, Any]":
        """Revive a dead stage replica from its live peers via the
        planner. ``full_tree=False`` (the heal arm) fetches exactly the
        stage's layer units — moved bytes == the set-theoretic lower
        bound; ``full_tree=True`` (the drain-and-restart baseline)
        refetches EVERY layer, checkpoint-restore style, and the delta
        between the two is the A/B's byte story."""
        cfg = self.cfg
        healer_id = self._holder_id(stage, replica)
        src = self._live_src_spec()
        need = (list(range(cfg.num_layers)) if full_tree
                else list(self.stage_layers[stage]))
        dst_assignment = {
            h: list(src.units_of(h)) for h in src.holders()
        }
        dst_assignment[healer_id] = need
        dst = ShardSpec(cfg.num_layers, dst_assignment)
        old = self.replicas[(stage, replica)]
        mgr = (self._manager_factory(stage, replica)
               if self._manager_factory is not None else None)
        rep = _StageReplica(self, stage, replica, {}, manager=mgr)
        plan = self.planner.plan(src, dst, self._unit_bytes,
                                 metrics=rep.metrics)
        lower = self.stage_param_bytes(stage)
        ev = rep.events
        if ev:
            ev.emit("heal_start", step=self._step, stage=stage,
                    replica=replica, full_tree=full_tree,
                    src_fp=src.fingerprint(), dst_fp=dst.fingerprint())
        fetched, moved = execute_fetches(
            plan, healer_id, self._fetch_unit, parallel=2)
        layers = {
            unit: {"W": arrays[0], "b": arrays[1]}
            for unit, arrays in fetched.items()
            if unit in self.stage_layers[stage]
        }
        rep.set_layers(layers)
        rep.metrics.incr("redist_moved_bytes", moved)
        rep.metrics.incr("redist_lower_bound_bytes", lower)
        if ev:
            ev.emit("heal_done", step=self._step, stage=stage,
                    replica=replica, full_tree=full_tree,
                    moved_bytes=moved, lower_bound_bytes=lower,
                    units=len(fetched))
        old.close()
        self.replicas[(stage, replica)] = rep
        self.topo.add_watcher(rep.mailbox.poke)
        self.topo.revive(stage, replica, rep.addr)
        return {"moved_bytes": moved, "lower_bound_bytes": lower,
                "units": len(fetched)}

    def rebalance(self, new_stage_layers: "Sequence[Sequence[int]]",
                  ) -> "Dict[str, Any]":
        """Move layer ranges between stages as ONE ShardSpec transition:
        every live replica of stage s becomes a holder of the new
        assignment's layers, the planner compiles the minimal transfer,
        and each receiver pulls only the units it lacks (fetch-all
        before apply-any, so every source still holds its old units
        while the transfer runs). Because backward is the exact chain
        rule regardless of stage hosting, the training trajectory stays
        bitwise identical across the move."""
        cfg = self.cfg
        new_stage_layers = [
            [int(i) for i in ls] for ls in new_stage_layers
        ]
        if len(new_stage_layers) != cfg.num_stages:
            raise ValueError(
                f"rebalance needs {cfg.num_stages} stage ranges, got "
                f"{len(new_stage_layers)}"
            )
        covered = sorted(i for ls in new_stage_layers for i in ls)
        if covered != list(range(cfg.num_layers)):
            raise ValueError(
                "rebalance assignment must cover every layer exactly once"
            )
        src = self._live_src_spec()
        dst = ShardSpec(cfg.num_layers, {
            self._holder_id(s, r): new_stage_layers[s]
            for s in range(cfg.num_stages)
            for r in self.topo.live_replicas(s)
        })
        builds_before = self.planner.builds
        plan = self.planner.plan(
            src, dst, self._unit_bytes,
            metrics=self.replicas[(0, self.topo.live_replicas(0)[0])].metrics,
        )
        cache_hit = self.planner.builds == builds_before
        staged: "Dict[Tuple[int, int], Dict[int, Dict[str, Any]]]" = {}
        total_moved = 0
        for s in range(cfg.num_stages):
            for r in self.topo.live_replicas(s):
                rid = self._holder_id(s, r)
                fetched, moved = execute_fetches(
                    plan, rid, self._fetch_unit, parallel=2)
                rep = self.replicas[(s, r)]
                keep = {
                    li: rep.layers[li]
                    for li in rep.held_units()
                    if li in new_stage_layers[s]
                }
                keep.update({
                    unit: {"W": arrays[0], "b": arrays[1]}
                    for unit, arrays in fetched.items()
                })
                staged[(s, r)] = keep
                lower = plan.moved_bytes.get(rid, 0)
                rep.metrics.incr("redist_moved_bytes", moved)
                rep.metrics.incr("redist_lower_bound_bytes", lower)
                total_moved += moved
                ev = rep.events
                if ev:
                    ev.emit("stage_rebalance", step=self._step, stage=s,
                            replica=r, moved_bytes=moved,
                            lower_bound_bytes=lower,
                            src_fp=src.fingerprint(),
                            dst_fp=dst.fingerprint(),
                            cache_hit=cache_hit,
                            layers=len(new_stage_layers[s]))
        for key, layers in staged.items():
            self.replicas[key].set_layers(layers)
        self.stage_layers = new_stage_layers
        return {
            "moved_bytes": total_moved,
            "lower_bound_bytes": plan.total_moved_bytes(),
            "cache_hit": cache_hit,
        }

    def close(self) -> None:
        for rep in self.replicas.values():
            rep.close()
