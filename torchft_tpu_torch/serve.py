"""Train-to-serve plane: zero-redundancy live weight deployment into a
serving cohort whose members hold their shards on the card.

Twin of ``torchft_tpu/serve.py``, with the same public names, counters,
events and wire. Every leg rides a subsystem the port already has:

- **Registration / membership**: serving replicas are their own job on the
  multi-tenant lighthouse: they quorum once, then park epoch watches on the
  job's ``membership_epoch``, so a serving-replica kill is a quorum
  transition the router re-routes on.
- **Deploy hot path**: each adoption is a ``ShardSpec`` transition compiled
  by the redistribution planner over a combined holder space (train donors
  first, serve members after them), so a member's moved bytes equal the
  set-theoretic lower bound: it fetches exactly its serve shard, striped
  across the train donors, over the raw-leaves plane with CRC32C frames.
- **Wire**: a publication stages ``{"units": {str(u): [leaf]}}`` at
  ``step == version``, so every fetch is version-gated (a wrong version
  answers 400, never stale bytes). The payload is the reference's, byte
  for byte: a reference publisher feeds a port cohort and back.
- **Version gate (whole-or-latch) on the card**: a fetched shard is
  uploaded whole on a side stream, and the upload has finished before the
  one reference swap, so an answer racing the flip reads V or V+1 whole.
  A failed fetch or upload leaves V live. ``serve_stale_reads`` counts
  answers whose live buffer, read back from the device, fails its
  flip-time digest; it must read 0 across any kill and concurrent deploy.
- **Peer heal**: a rejoining serving replica heals its shard from serve
  peers (each re-stages the host bytes it uploaded), never from the
  training job: ``deploy_train_bytes`` does not move on a rejoin.

Live training: hang ``DeployPublisher.publish`` off the trainer's commit.
``Manager.set_commit_hook`` fires inside ``should_commit``, before the
optimizer applies the step, so a trainer records the committed step in the
hook and publishes the parameters after its update.

Layering: an orchestration module (``checkpointing``, ``comm``,
``control``, ``utils``); nothing imports it back. ``ServingReplica`` and
``ServeCohort`` take ``device=None``, the card; ``device="cpu"`` is for
the tests. They do not take the reference's ``wire_dtype``, which nothing
there reads: the wire carries the published dtype.
"""

from __future__ import annotations

import contextlib
import hashlib
import logging
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from torchft_tpu_torch.checkpointing import CheckpointServer, RedistFetcher
from torchft_tpu_torch.comm.redistribute import (
    RedistPlanner,
    ShardSpec,
    execute_fetches,
)
from torchft_tpu_torch.comm.wire import split_weighted
from torchft_tpu_torch.utils.device import resolve_device
from torchft_tpu_torch.utils.events import EventRecorder
from torchft_tpu_torch.utils.metrics import Metrics
from torchft_tpu_torch.utils.profiling import throughput_span, timed_span

logger = logging.getLogger(__name__)

__all__ = [
    "DeployPublisher",
    "ServeCohort",
    "ServingReplica",
    "serve_layout",
    "unit_digest",
]

SERVE_JOB_ID = "serve"


def _byte_view(a: Any) -> np.ndarray:
    """The raw bytes of an array or a tensor (on any device: a tensor off
    the CPU is read back) as a flat uint8 array."""
    if isinstance(a, torch.Tensor):
        t = a.detach().contiguous().reshape(-1).view(torch.uint8)
        return t.cpu().numpy()
    return np.ascontiguousarray(a).reshape(-1).view(np.uint8)


def unit_digest(arrays: "Sequence[Any]") -> str:
    """Digest of one unit's arrays (sha256 over raw bytes): recorded when a
    version flips live, re-derived on every answer, compared by the oracles
    with the publisher's digest of the same unit. Arrays and tensors (on
    any device) of the same bytes give the same digest."""
    h = hashlib.sha256()
    for a in arrays:
        h.update(_byte_view(a).data)
    return h.hexdigest()


def serve_layout(
    unit_bytes: "Sequence[int]",
    n_members: int,
    replication: int = 2,
) -> ShardSpec:
    """The serving cohort's shard layout over ``len(unit_bytes)`` units: a
    byte-balanced contiguous partition into ``n_members`` groups
    (``split_weighted``), each group also held by the next ``replication -
    1`` members, so a single kill leaves every unit answerable and healable
    from a serve peer. ``replication`` is clamped to the member count."""
    n_units = len(unit_bytes)
    n_members = max(1, int(n_members))
    repl = max(1, min(int(replication), n_members))
    ranges = split_weighted([int(b) for b in unit_bytes], n_members)
    by_holder: "Dict[int, List[int]]" = {m: [] for m in range(n_members)}
    for g, (lo, hi) in enumerate(ranges):
        units = list(range(lo, hi))
        for r in range(repl):
            by_holder[(g + r) % n_members].extend(units)
    return ShardSpec(
        n_units, {m: sorted(u) for m, u in by_holder.items() if u}
    )


def _host_leaf(a: Any) -> np.ndarray:
    """One host copy of a leaf the caller may mutate afterwards, as a numpy
    array (the reference's manifest entry; the redistribution engine moves
    numpy arrays, so a unit's dtype must be one numpy has)."""
    if isinstance(a, torch.Tensor):
        return a.detach().to("cpu", copy=True).contiguous().numpy()
    return np.array(a, copy=True, order="C")


# ------------------------------------------------------------- train side


class DeployPublisher:
    """Train-side publication point for committed weights: a rotating pair
    of checkpoint servers, so version V stays fetchable while V+1 stages
    on the other, and publishing never touches the training job's own heal
    gate. ``publish`` stages the weights in the redistribution payload
    shape at ``step == version``, which version-gates every adoption
    fetch."""

    def __init__(self, timeout: float = 30.0,
                 metrics: "Optional[Metrics]" = None,
                 events: "Optional[EventRecorder]" = None) -> None:
        self._timeout = float(timeout)
        self._servers = [
            CheckpointServer(timeout=self._timeout),
            CheckpointServer(timeout=self._timeout),
        ]
        self._active = -1
        self._version: "Optional[int]" = None
        self._digests: "Dict[int, Dict[int, str]]" = {}
        self._unit_bytes: "List[int]" = []
        self._lock = threading.Lock()
        self._metrics = metrics
        self._events = events

    @property
    def version(self) -> "Optional[int]":
        return self._version

    @property
    def unit_bytes(self) -> "List[int]":
        return list(self._unit_bytes)

    def publish(self, version: int, leaves: "Sequence[Any]") -> str:
        """Stage ``leaves`` (one model unit per leaf: tensors on any device,
        or arrays) as ``version`` on the idle server of the pair and make
        it the fetchable one; returns its address. One host copy of each
        leaf is taken now (a D2H for a tensor on the card) and served as
        it is. The previous version stays fetchable on the other server
        until the next publish evicts it."""
        version = int(version)
        with timed_span(self._metrics, "deploy_publish_d2h"):
            arrays = [_host_leaf(a) for a in leaves]
        with timed_span(self._metrics, "deploy_publish_digest"):
            digests = {i: unit_digest([a]) for i, a in enumerate(arrays)}
        with self._lock:
            nxt = (self._active + 1) % 2
            srv = self._servers[nxt]
            # evict the version staged two publishes ago (V-1 keeps
            # serving on the other server)
            srv.disallow_checkpoint()
            tree = {
                "units": {str(i): [a] for i, a in enumerate(arrays)}
            }
            srv.send_checkpoint([], version, tree, self._timeout, owned=True)
            self._active = nxt
            self._version = version
            self._unit_bytes = [int(a.nbytes) for a in arrays]
            self._digests[version] = digests
            self._digests = {
                v: d for v, d in self._digests.items()
                if v in (version, version - 1)
            }
            addr = srv.metadata()
        if self._metrics is not None:
            self._metrics.gauge("deploy_published_version", version)
        if self._events:
            self._events.emit(
                "deploy_publish", step=version,
                units=len(arrays),
                nbytes=int(sum(self._unit_bytes)),
            )
        return addr

    def address(self) -> str:
        """Address currently staging :attr:`version`."""
        with self._lock:
            if self._active < 0:
                raise RuntimeError("nothing published yet")
            return self._servers[self._active].metadata()

    def digests(self, version: int) -> "Dict[int, str]":
        """Per-unit digests of ``version`` (bench/test oracle)."""
        return dict(self._digests.get(int(version), {}))

    def close(self) -> None:
        for s in self._servers:
            try:
                s.disallow_checkpoint()
            finally:
                s.shutdown(wait=False)


# ------------------------------------------------------------- serve side


class _LiveModel:
    """One fully resident model version: the immutable object one
    reference flip publishes to the answer path. ``buffers`` live on the
    replica's device; ``digests`` are of the host bytes they were uploaded
    from."""

    __slots__ = ("version", "buffers", "digests")

    def __init__(self, version: int,
                 buffers: "Dict[int, List[torch.Tensor]]",
                 digests: "Dict[int, str]") -> None:
        self.version = int(version)
        self.buffers = buffers
        self.digests = digests


def _unit_sum(t: torch.Tensor) -> float:
    """The sum of one live buffer on its device, accumulated in the
    buffer's own float type (at least f32), as numpy sums an f32 array."""
    if t.is_floating_point():
        acc = torch.float64 if t.dtype == torch.float64 else torch.float32
        return float(t.sum(dtype=acc))
    return float(t.sum())


class ServingReplica:
    """One inference replica: answers unit queries from an atomically
    flipped model version held on ``device`` while adoptions stream in the
    background, and takes part in the serve job's lighthouse quorum.

    The replica's own checkpoint server stages the current live shard at
    ``step == version`` (the payload a rejoining serve peer heals from)
    and is the ``/telemetry`` endpoint the fleet poller and the oracles
    read."""

    def __init__(
        self,
        member_index: int,
        replica_id: "Optional[str]" = None,
        lighthouse_addr: "Optional[str]" = None,
        job_id: str = SERVE_JOB_ID,
        timeout: float = 20.0,
        heartbeat_interval: float = 0.25,
        parallel: int = 4,
        device: "Optional[str | torch.device]" = None,
    ) -> None:
        self.member_index = int(member_index)
        self.replica_id = replica_id or f"serve_{member_index}"
        self.job_id = job_id
        self.device = resolve_device(device)
        self._timeout = float(timeout)
        self._parallel = int(parallel)
        self.metrics = Metrics()
        self.events = EventRecorder(
            replica_id=self.replica_id, rank=self.member_index
        )
        self._planner = RedistPlanner()
        self._live: "Optional[_LiveModel]" = None
        self._adopt_lock = threading.Lock()  # one adoption at a time
        self._upload_stream: "Optional[torch.cuda.Stream]" = None
        self._dead = False
        self._server: "Optional[CheckpointServer]" = None
        self._hb_stop = threading.Event()
        self._hb_thread: "Optional[threading.Thread]" = None
        self._epoch = 0
        self._lh = None
        if lighthouse_addr is not None:
            from torchft_tpu_torch.control import LighthouseClient

            self._lh = LighthouseClient(lighthouse_addr)
            self._lh.register_job(job_id)
        self._hb_interval = float(heartbeat_interval)
        self._start_serving()

    # -- lifecycle ----------------------------------------------------------

    def _start_serving(self) -> None:
        self._server = CheckpointServer(timeout=self._timeout)
        self._server.set_metrics(self.metrics)
        self._server.set_events(self.events)
        self._server.set_telemetry(self._telemetry_info)
        self._dead = False
        if self._lh is not None:
            self._hb_stop.clear()
            self._hb_thread = threading.Thread(
                target=self._membership_loop,
                name=f"torchft_tpu_torch_serve_hb_{self.replica_id}",
                daemon=True,
            )
            self._hb_thread.start()

    def _telemetry_info(self) -> dict:
        live = self._live
        return {
            "replica_id": self.replica_id,
            "rank": self.member_index,
            "step": -1 if live is None else live.version,
            "epoch": self._epoch,
            "job_id": self.job_id,
            "serve": True,
        }

    def _requester(self) -> dict:
        live = self._live
        return {
            "replica_id": self.replica_id,
            "address": self.address,
            "store_address": self.address,
            "step": 0 if live is None else live.version,
            "world_size": 1,
        }

    def _membership_loop(self) -> None:
        """Join the serve job's quorum once, take its ``membership_epoch``,
        then park an epoch watch on it (a parked watch is the replica's
        heartbeat); run the quorum path again only when the watch reports
        a change, or after a lighthouse blip."""
        lh = self._lh
        need_quorum = True
        watch_s = max(0.25, min(2.0, self._hb_interval * 4.0))
        while not self._hb_stop.is_set():
            try:
                if need_quorum:
                    resp = lh.quorum(
                        self._requester(), timeout=self._timeout,
                        job_id=self.job_id,
                    )
                    self._epoch = int(
                        resp.get("membership_epoch", self._epoch)
                    )
                    need_quorum = False
                    continue
                epoch, changed = lh.epoch_watch(
                    self.replica_id, self._epoch,
                    timeout=watch_s, job_id=self.job_id,
                )
                self._epoch = int(epoch)
                need_quorum = bool(changed)
            except Exception as e:  # noqa: BLE001 — a lighthouse blip
                # must not kill serving; back off one window and rejoin
                # through the full quorum path
                logger.debug("serve membership tick failed: %s", e)
                need_quorum = True
                self._hb_stop.wait(self._hb_interval)

    @property
    def alive(self) -> bool:
        return not self._dead

    @property
    def address(self) -> str:
        if self._server is None:
            raise ConnectionError(f"{self.replica_id} is down")
        return self._server.metadata()

    @property
    def version(self) -> int:
        live = self._live
        return -1 if live is None else live.version

    def live_digests(self) -> "Dict[int, str]":
        """Per-unit digests of the live buffers, read back from the device
        now (the oracle's view; empty before the first adoption)."""
        live = self._live
        if live is None:
            return {}
        return {u: unit_digest(arrs) for u, arrs in live.buffers.items()}

    def kill(self) -> None:
        """Fail-stop this replica: heartbeats cease (the lighthouse expires
        the lease and the job's epoch moves), the shard/telemetry server
        dies, and every in-process answer raises like a closed socket."""
        self._dead = True
        self._hb_stop.set()
        srv, self._server = self._server, None
        if srv is not None:
            srv.shutdown(wait=False)
        if self._hb_thread is not None:
            self._hb_thread.join(timeout=2.0)
            self._hb_thread = None

    def shutdown(self) -> None:
        self.kill()

    # -- adoption (the deploy hot path) -------------------------------------

    def adopt(
        self,
        version: int,
        layout: ShardSpec,
        unit_bytes: "Sequence[int]",
        donor_addrs: "Sequence[str]" = (),
        peer_addrs: "Optional[Dict[int, str]]" = None,
        units: "Optional[Sequence[int]]" = None,
    ) -> int:
        """Adopt ``version``: fetch exactly this member's serve shard
        (``layout.units_of(member_index)``, or ``units``: a layout-changing
        deploy passes the old and new shards' union) through a
        planner-compiled transition over the combined holder space (train
        donors ``0..T-1``, serve member ``m`` at ``T + m``), upload it
        whole to the device, then flip it live. Returns moved bytes.

        ``donor_addrs``: publisher addresses, each staging every unit of
        ``version``. ``peer_addrs``: ``{member_index: address}`` of serve
        peers already at ``version`` (a rejoin passes only these).

        Whole-or-latch: the fetch completes whole or raises, and the
        upload finishes before the swap; on any failure the replica keeps
        answering from its current version."""
        version = int(version)
        n_train = len(donor_addrs)
        peer_addrs = dict(peer_addrs or {})
        my_units = (
            sorted(int(u) for u in units) if units is not None
            else list(layout.units_of(self.member_index))
        )
        with self._adopt_lock:
            if self._dead:
                raise ConnectionError(f"{self.replica_id} is down")
            t0 = time.perf_counter()
            live = self._live
            self.metrics.gauge(
                "serve_version_lag",
                version - (live.version if live else -1),
            )
            self.events.emit(
                "deploy_start", step=version,
                units=len(my_units),
                n_donors=n_train, n_peers=len(peer_addrs),
            )
            by_holder: "Dict[int, Sequence[int]]" = {
                d: range(layout.n_units) for d in range(n_train)
            }
            for m in peer_addrs:
                if m == self.member_index:
                    continue
                by_holder[n_train + m] = layout.units_of(m)
            src = ShardSpec(layout.n_units, by_holder)
            receiver = n_train + self.member_index
            dst = ShardSpec(layout.n_units, {receiver: my_units})
            plan = self._planner.plan(
                src, dst, [int(b) for b in unit_bytes],
                metrics=self.metrics,
            )
            missing = plan.receiver_unsourced(receiver)
            if missing:
                raise ConnectionError(
                    f"deploy v{version}: no holder covers units "
                    f"{list(missing)[:8]} — donors/peers insufficient"
                )

            fetcher = RedistFetcher(self._timeout, step=version)

            def _addr_of(holder: int) -> str:
                if holder < n_train:
                    return donor_addrs[holder]
                return peer_addrs[holder - n_train]

            def _fetch_unit(holder: int, unit: int):
                nb = [0]
                with throughput_span(self.metrics, "deploy_fetch", nb):
                    arrays = fetcher.fetch(_addr_of(holder), unit)
                    nb[0] = sum(int(a.nbytes) for a in arrays)
                return arrays

            def _attribute(unit: int, holder: int, nb: int) -> None:
                if holder < n_train:
                    self.metrics.incr("deploy_train_bytes", nb)
                else:
                    self.metrics.incr("deploy_peer_bytes", nb)

            try:
                host, moved = execute_fetches(
                    plan, receiver, _fetch_unit,
                    parallel=self._parallel, on_fetch=_attribute,
                )
            finally:
                fetcher.close()
            buffers = self._upload(host)
            lower = int(plan.lower_bound_bytes.get(receiver, 0))
            self.metrics.incr("deploy_bytes_moved", float(moved))
            self.metrics.incr("deploy_lower_bound_bytes", float(lower))
            self.metrics.incr("deploy_adoptions")
            self._flip(version, host, buffers)
            wall_ms = (time.perf_counter() - t0) * 1000.0
            self.metrics.gauge("deploy_wall_ms", wall_ms)
            self.metrics.gauge("serve_version_lag", 0.0)
            self.events.emit(
                "deploy_done", step=version,
                moved_bytes=int(moved), lower_bound_bytes=lower,
                src_spec=src.fingerprint(), dst_spec=dst.fingerprint(),
            )
            return int(moved)

    def _upload(self, host: "Dict[int, List[Any]]"
                ) -> "Dict[int, List[torch.Tensor]]":
        """The fetched shard on the device, whole: every copy is issued on
        the replica's upload stream and has finished when this returns."""
        dev = self.device
        if dev.type == "cuda" and self._upload_stream is None:
            self._upload_stream = torch.cuda.Stream(dev)
        stream = self._upload_stream
        with timed_span(self.metrics, "deploy_upload"), (
                torch.cuda.stream(stream) if stream is not None
                else contextlib.nullcontext()):
            out = {
                u: [torch.as_tensor(a).to(dev, copy=True) for a in arrs]
                for u, arrs in host.items()
            }
            if stream is not None:
                stream.synchronize()
        return out

    def _flip(self, version: int, host: "Dict[int, List[Any]]",
              buffers: "Dict[int, List[torch.Tensor]]") -> None:
        """The version gate: build the immutable live bundle from the
        resident buffers, swap ONE reference, then re-stage the shard's
        host bytes on this replica's own server (the peer-heal source).
        Answers racing the flip read V or V+1 whole: the bundle is complete
        before the swap and old readers keep their snapshot reference."""
        live = _LiveModel(version, buffers, {
            u: unit_digest(arrs) for u, arrs in host.items()
        })
        self._live = live
        self.metrics.gauge("serve_version", float(version))
        srv = self._server
        if srv is not None:
            srv.disallow_checkpoint()
            tree = {
                "units": {str(u): list(arrs) for u, arrs in host.items()}
            }
            srv.send_checkpoint([], version, tree, self._timeout, owned=True)
        self.events.emit(
            "serve_flip", step=version, units=len(buffers),
        )

    def rejoin(
        self,
        version: int,
        layout: ShardSpec,
        unit_bytes: "Sequence[int]",
        peer_addrs: "Dict[int, str]",
    ) -> int:
        """Come back from a kill: restart serving and membership, then heal
        this member's serve shard from serve peers at the cohort's current
        version (``adopt`` with no train donors, so ``deploy_train_bytes``
        cannot move). Returns moved bytes."""
        if not self._dead:
            raise RuntimeError(f"{self.replica_id} is not down")
        self._live = None  # the old shard's version is gone stale
        self._start_serving()
        moved = self.adopt(
            version, layout, unit_bytes,
            donor_addrs=(), peer_addrs=peer_addrs,
        )
        self.events.emit(
            "serve_join", step=int(version), moved_bytes=int(moved),
            healed_from=sorted(
                m for m in peer_addrs if m != self.member_index
            ),
        )
        return moved

    # -- the answer path ----------------------------------------------------

    def answer(self, unit: int, x: float) -> "Tuple[int, float]":
        """Answer one toy inference request against the live version:
        ``sum(leaf) * x`` over the unit's buffers, summed on the device.
        Raises ``ConnectionError`` when the replica is down (the router's
        re-route trigger). Every answer re-derives the unit's digest from
        the buffers read back from the device and compares it with the
        flip-time record: ``serve_stale_reads`` counts mismatches."""
        if self._dead:
            raise ConnectionError(f"{self.replica_id} is down")
        live = self._live
        if live is None or int(unit) not in live.buffers:
            raise ConnectionError(
                f"{self.replica_id} does not hold unit {unit} "
                f"(version {-1 if live is None else live.version})"
            )
        self.metrics.incr("serve_requests")
        with timed_span(self.metrics, "serve_answer"):
            arrs = live.buffers[int(unit)]
            if unit_digest(arrs) != live.digests[int(unit)]:
                self.metrics.incr("serve_stale_reads")
            value = float(sum(_unit_sum(t) for t in arrs)) * float(x)
        return live.version, value


# ---------------------------------------------------------------- the router


class ServeCohort:
    """The serving cohort: owns the members, the request router and the
    deploy fan-out. The router sends each unit query to a live holder,
    re-routing on member death (``serve_reroutes``) and counting a drop
    only when every holder is gone (``serve_dropped``). An answer-path
    failure marks the member suspect at once; the quorum view the members
    maintain confirms or clears it.

    The cohort's own telemetry endpoint (a checkpoint server serving
    ``/telemetry`` only) carries the router's counters and events."""

    def __init__(
        self,
        n_members: int,
        lighthouse_addr: "Optional[str]" = None,
        job_id: str = SERVE_JOB_ID,
        replication: int = 2,
        timeout: float = 20.0,
        heartbeat_interval: float = 0.25,
        device: "Optional[str | torch.device]" = None,
    ) -> None:
        self.job_id = job_id
        self.replication = int(replication)
        self.device = resolve_device(device)
        self.metrics = Metrics()
        self.events = EventRecorder(replica_id=f"{job_id}_router")
        self._timeout = float(timeout)
        self._lighthouse_addr = lighthouse_addr
        self._hb_interval = float(heartbeat_interval)
        self.members = [self._member(m) for m in range(int(n_members))]
        self._suspect: "set" = set()
        self._rr = 0
        self._lock = threading.Lock()
        self._layout: "Optional[ShardSpec]" = None
        self._unit_bytes: "List[int]" = []
        self._router_server = CheckpointServer(timeout=self._timeout)
        self._router_server.set_metrics(self.metrics)
        self._router_server.set_events(self.events)
        self._router_server.set_telemetry(lambda: {
            "replica_id": f"{self.job_id}_router",
            "rank": -1,
            "step": self.min_version(),
            "job_id": self.job_id,
            "serve": True,
        })

    def _member(self, index: int) -> ServingReplica:
        return ServingReplica(
            index,
            lighthouse_addr=self._lighthouse_addr,
            job_id=self.job_id,
            timeout=self._timeout,
            heartbeat_interval=self._hb_interval,
            device=self.device,
        )

    # -- membership ---------------------------------------------------------

    @property
    def layout(self) -> "Optional[ShardSpec]":
        return self._layout

    @property
    def unit_bytes(self) -> "List[int]":
        return list(self._unit_bytes)

    def router_address(self) -> str:
        return self._router_server.metadata()

    def min_version(self) -> int:
        vs = [m.version for m in self.members if m.alive]
        return min(vs) if vs else -1

    def live_members(self) -> "List[ServingReplica]":
        with self._lock:
            suspect = set(self._suspect)
        return [
            m for m in self.members
            if m.alive and m.member_index not in suspect
        ]

    def _mark_suspect(self, member_index: int) -> None:
        with self._lock:
            self._suspect.add(member_index)

    def reconcile(self) -> None:
        """Clear suspects that liveness vouches for again (after a rejoin
        heal)."""
        with self._lock:
            self._suspect = {
                i for i in self._suspect
                if not self.members[i].alive
            }

    # -- deploys ------------------------------------------------------------

    def deploy(
        self,
        version: int,
        donor_addrs: "Sequence[str]",
        unit_bytes: "Sequence[int]",
        members: "Optional[Sequence[ServingReplica]]" = None,
        parallel: bool = True,
    ) -> int:
        """Fan one version out to every live member (each adopts only its
        shard; the cohort's moved bytes equal ``replication x`` the model,
        against ``n_members x`` for a full fetch each). Serving continues
        throughout. Returns total moved bytes.

        A deploy after :meth:`grow` is also the layout transition: each
        member adopts the union of its old and new shards, and the router
        keeps routing by the old layout until every flip landed, then
        swaps, so growth drops nothing."""
        version = int(version)
        self._unit_bytes = [int(b) for b in unit_bytes]
        old_layout = self._layout
        new_layout = serve_layout(
            self._unit_bytes, len(self.members), self.replication
        )
        transition = (
            old_layout is not None and old_layout != new_layout
            and old_layout.n_units == new_layout.n_units
        )
        targets = [
            m for m in (members if members is not None
                        else self.live_members())
            if m.alive
        ]
        self.events.emit(
            "deploy_start", step=version,
            n_members=len(targets), n_donors=len(donor_addrs),
        )
        t0 = time.perf_counter()
        lag = version - self.min_version()
        self.metrics.gauge("serve_version_lag", float(lag))

        def _one(m: "ServingReplica") -> int:
            units = None
            if transition:
                units = sorted(
                    set(new_layout.units_of(m.member_index))
                    | set(old_layout.units_of(m.member_index))
                )
            return m.adopt(
                version, new_layout, self._unit_bytes,
                donor_addrs=donor_addrs, units=units,
            )

        if parallel and len(targets) > 1:
            with ThreadPoolExecutor(
                max_workers=len(targets),
                thread_name_prefix="torchft_tpu_torch_deploy",
            ) as pool:
                moved = sum(pool.map(_one, targets))
        else:
            moved = sum(_one(m) for m in targets)
        self._layout = new_layout
        self.metrics.incr("deploy_bytes_moved", float(moved))
        self.metrics.gauge(
            "deploy_wall_ms", (time.perf_counter() - t0) * 1000.0
        )
        self.metrics.gauge("serve_version_lag", 0.0)
        self.events.emit(
            "deploy_done", step=version, moved_bytes=int(moved),
            n_members=len(targets),
        )
        return moved

    def rejoin_member(self, member_index: int) -> int:
        """Heal a killed member back in from its serve peers at the
        cohort's current version, then clear its suspect mark."""
        if self._layout is None:
            raise RuntimeError("nothing deployed yet")
        version = max(m.version for m in self.members if m.alive)
        peers = {
            m.member_index: m.address
            for m in self.live_members()
            if m.member_index != member_index
        }
        moved = self.members[member_index].rejoin(
            version, self._layout, self._unit_bytes, peers
        )
        self.reconcile()
        return moved

    def grow(self) -> "ServingReplica":
        """Add one serving member mid-run. It registers with the lighthouse
        at once and starts holding and answering at the next
        :meth:`deploy`, which recomputes the layout over the larger cohort
        (the union transition); until then the router never routes to
        it."""
        m = self._member(len(self.members))
        self.members.append(m)
        self.events.emit(
            "serve_join", step=self.min_version(),
            member=m.member_index, grown=True,
        )
        return m

    # -- the request path ---------------------------------------------------

    def answer(self, unit: int, x: float) -> "Tuple[int, float]":
        """Route one request to a live holder of ``unit``; on a dead member
        re-route to the next holder (``serve_reroutes``); count a drop only
        when no live holder remains (``serve_dropped``), raising
        ConnectionError so callers see the failure they are counting."""
        if self._layout is None:
            raise ConnectionError("nothing deployed yet")
        self.metrics.incr("serve_requests")
        holders = list(self._layout.holders_of(int(unit)))
        if not holders:
            self.metrics.incr("serve_dropped")
            raise ConnectionError(f"no holder for unit {unit}")
        with self._lock:
            start = self._rr
            self._rr += 1
            suspect = set(self._suspect)
        order = sorted(
            holders,
            key=lambda h: (
                h in suspect,  # suspected dead last
                (h - start) % len(self.members),
            ),
        )
        last: "Optional[Exception]" = None
        rerouted = False
        for h in order:
            m = self.members[h]
            try:
                got = m.answer(unit, x)
                if rerouted:
                    self.metrics.incr("serve_reroutes")
                    self.events.emit(
                        "serve_reroute", step=got[0],
                        unit=int(unit), to_member=h,
                    )
                return got
            except ConnectionError as e:
                self._mark_suspect(h)
                rerouted = True
                last = e
        self.metrics.incr("serve_dropped")
        raise ConnectionError(
            f"unit {unit}: every holder is down"
        ) from last

    def shutdown(self) -> None:
        for m in self.members:
            try:
                m.shutdown()
            except Exception:  # noqa: BLE001 — teardown best-effort
                pass
        self._router_server.shutdown(wait=False)
