"""Shard-spec-to-shard-spec redistribution: the transfer-plan compiler,
its executor and the cohort exchange.

Twin of ``torchft_tpu/comm/redistribute.py``; the port keeps its own copy,
numpy and stdlib only. A (source shard spec -> destination shard spec) pair
compiles into a :class:`TransferPlan` over whole units (leaves or
fragments, the ``split_weighted``/``ddp.shard_ranges`` grid):

- Minimality. A plan ships one copy of unit ``u`` to receiver ``r`` exactly
  when ``r`` must hold ``u`` under the destination spec, does not hold it
  under the source spec, and some holder has it. ``moved_bytes`` therefore
  equals the set-theoretic lower bound by construction; units nobody holds
  are ``unsourced`` (the call site reinitializes them, visibly).
- Caching. :class:`RedistPlanner` caches plans per (source spec,
  destination spec, unit byte layout) and counts ``redist_plan_builds`` /
  ``redist_plan_cache_hits``, so a world size oscillating w3 -> w2 -> w3
  plans twice, ever.
- Execution. :func:`execute_fetches` runs one receiver's slice of a plan,
  striped across holders, with dead-holder failover: whole or raise.
  :func:`exchange` is the cohort protocol, three matched allgathers over
  ``manager.allgather_arrays`` (holdings metadata, serving addresses, an
  ack), with the payload bytes moving point to point through two injected
  hooks, ``serve_fn`` and ``fetch_factory``; ``checkpointing.py`` binds
  them to the raw-bytes heal plane (``redistribute_exchange``).

Holdings may carry torch tensors: only their ``nbytes`` is read until a
unit is served.
"""

from __future__ import annotations

import hashlib
import logging
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import (
    Any,
    Callable,
    Dict,
    List,
    Optional,
    Sequence,
    Tuple,
)

import numpy as np

logger = logging.getLogger(__name__)

__all__ = [
    "ShardSpec",
    "TransferPlan",
    "RedistPlanner",
    "RedistTransferError",
    "ExchangeResult",
    "execute_fetches",
    "exchange",
]


class RedistTransferError(ConnectionError):
    """A planned transfer could not complete WHOLE: some unit's every
    covering holder died mid-plan. The executor never partial-adopts —
    callers either retry at the next quorum (the reshard path latches
    and keeps the old grid) or surface the failure (the heal path
    raises)."""


class ShardSpec:
    """Who holds which units: an immutable holder → unit-set assignment.

    ``units`` are leaf/fragment indices in ``range(n_units)`` — the
    leaf-granular grid ``split_weighted``/``ddp.shard_ranges`` produce.
    Contiguous per-rank ranges (the sharded optimizer grid) and
    arbitrary assignments (DiLoCo's ``f % world`` owner map, donor
    manifests) are both just assignments here. A unit may have several
    holders (a healer that adopted a donor's shard while the donor
    lives) — that is the multi-holder striping/failover case.
    """

    __slots__ = ("n_units", "_by_holder", "_holders_of", "_key")

    def __init__(self, n_units: int,
                 assignment: "Dict[int, Sequence[int]]") -> None:
        self.n_units = int(n_units)
        by_holder: "Dict[int, Tuple[int, ...]]" = {}
        holders_of: "Dict[int, List[int]]" = {}
        for holder in sorted(assignment):
            units = tuple(sorted(set(int(u) for u in assignment[holder])))
            for u in units:
                if not 0 <= u < self.n_units:
                    raise ValueError(
                        f"unit {u} outside the grid [0, {self.n_units})"
                    )
            if units:
                by_holder[int(holder)] = units
                for u in units:
                    holders_of.setdefault(u, []).append(int(holder))
        self._by_holder = by_holder
        self._holders_of = {
            u: tuple(h) for u, h in holders_of.items()
        }
        self._key = (self.n_units, tuple(
            (h, units) for h, units in sorted(by_holder.items())
        ))

    # -- constructors --------------------------------------------------------

    @classmethod
    def from_ranges(cls, ranges: "Sequence[Tuple[int, int]]",
                    n_units: "Optional[int]" = None) -> "ShardSpec":
        """Contiguous (start, stop) unit ranges, one per rank — the
        ``shard_ranges`` grid. ``n_units`` defaults to the grid's
        extent."""
        ranges = [(int(a), int(b)) for a, b in ranges]
        if n_units is None:
            n_units = max((b for _, b in ranges), default=0)
        return cls(n_units, {
            r: range(a, b) for r, (a, b) in enumerate(ranges)
        })

    @classmethod
    def from_ranges_2d(cls, ranges: "Sequence[Tuple[int, int]]",
                       model_shards: int,
                       n_units: "Optional[int]" = None) -> "ShardSpec":
        """A (replica-shard × model-shard) grid: each base unit ``u`` of
        a 1-D contiguous grid splits into ``model_shards`` sub-units
        ``u * model_shards + m``, all held by the replica rank that
        holds ``u``. This is how the 2-D mesh's optimizer state prices
        through the planner with ZERO engine changes — sub-units are
        just more (opaque) units, so a heal/reshard at a changed world
        size or mesh shape compiles to the same provably-minimal
        transfer plan as the 1-D case. ``n_units`` is the BASE grid
        extent (defaults to the ranges' extent); the returned spec has
        ``n_units * model_shards`` units."""
        m = max(1, int(model_shards))
        ranges = [(int(a), int(b)) for a, b in ranges]
        if n_units is None:
            n_units = max((b for _, b in ranges), default=0)
        return cls(int(n_units) * m, {
            r: [u * m + s for u in range(a, b) for s in range(m)]
            for r, (a, b) in enumerate(ranges)
        })

    @classmethod
    def from_owner_map(cls, n_units: int, world: int,
                       owner_fn: "Callable[[int], int]") -> "ShardSpec":
        """An owner function over the unit grid (DiLoCo's
        ``f % world``)."""
        assignment: "Dict[int, List[int]]" = {r: [] for r in range(world)}
        for u in range(int(n_units)):
            assignment[int(owner_fn(u)) % world].append(u)
        return cls(n_units, assignment)

    # -- queries -------------------------------------------------------------

    def key(self) -> tuple:
        """Canonical hashable form — the plan-cache key component."""
        return self._key

    def fingerprint(self) -> str:
        """Short stable digest for events/logs (not the cache key)."""
        return hashlib.sha256(repr(self._key).encode()).hexdigest()[:12]

    def holders(self) -> "Tuple[int, ...]":
        return tuple(self._by_holder)

    def units_of(self, holder: int) -> "Tuple[int, ...]":
        return self._by_holder.get(int(holder), ())

    def holders_of(self, unit: int) -> "Tuple[int, ...]":
        return self._holders_of.get(int(unit), ())

    def __eq__(self, other: Any) -> bool:
        return isinstance(other, ShardSpec) and self._key == other._key

    def __hash__(self) -> int:
        return hash(self._key)

    def __repr__(self) -> str:  # pragma: no cover — debugging aid
        return f"ShardSpec(n_units={self.n_units}, {dict(self._by_holder)})"


class TransferPlan:
    """One compiled (src spec → dst spec) transfer: exactly which units
    each receiver pulls, from which candidate holders.

    ``fetches[r]`` is a tuple of ``(unit, holders)`` pairs — ``holders``
    ordered with the STRIPE-ASSIGNED primary first (needed units
    round-robined across their covering holders, so a multi-holder
    range stripes its pulls instead of convoying on one donor) and the
    remaining covering holders after it as the failover order.
    ``unsourced[r]`` are units receiver ``r`` needs that NO holder has
    (the call site reinitializes those). ``senders`` is every holder
    that may be asked for at least one byte (primary or failover) — the
    set that must publish a payload.
    """

    __slots__ = ("src", "dst", "unit_bytes", "fetches", "unsourced",
                 "senders", "moved_bytes", "lower_bound_bytes")

    def __init__(self, src: ShardSpec, dst: ShardSpec,
                 unit_bytes: "Sequence[int]") -> None:
        if src.n_units != dst.n_units:
            raise ValueError(
                f"spec grids disagree: src has {src.n_units} units, "
                f"dst {dst.n_units}"
            )
        self.src = src
        self.dst = dst
        self.unit_bytes = tuple(int(b) for b in unit_bytes)
        if len(self.unit_bytes) != src.n_units:
            raise ValueError(
                f"unit_bytes has {len(self.unit_bytes)} entries for "
                f"{src.n_units} units"
            )
        fetches: "Dict[int, List[Tuple[int, Tuple[int, ...]]]]" = {}
        unsourced: "Dict[int, Tuple[int, ...]]" = {}
        senders: "set" = set()
        moved: "Dict[int, int]" = {}
        for r in dst.holders():
            have = set(src.units_of(r))
            need = [u for u in dst.units_of(r) if u not in have]
            entries: "List[Tuple[int, Tuple[int, ...]]]" = []
            missing: "List[int]" = []
            k = 0
            for u in need:
                holders = src.holders_of(u)
                if not holders:
                    missing.append(u)
                    continue
                # Round-robin the needed range across its covering
                # holders (multi-donor striping); the rest of the
                # holder tuple is the failover order.
                primary = holders[k % len(holders)]
                rest = tuple(h for h in holders if h != primary)
                entries.append((u, (primary,) + rest))
                senders.update(holders)
                moved[r] = moved.get(r, 0) + self.unit_bytes[u]
                k += 1
            if entries:
                fetches[r] = tuple(entries)
            if missing:
                unsourced[r] = tuple(missing)
        self.fetches = fetches
        self.unsourced = unsourced
        self.senders = tuple(sorted(senders))
        # Provably minimal: each (receiver, unit) need with a live
        # source costs exactly one copy of the unit — the set-theoretic
        # lower bound of any correct transfer. moved == lower_bound by
        # construction; the counters re-derive moved from actual
        # fetched bytes so the executor cannot silently over-ship.
        self.moved_bytes = dict(moved)
        self.lower_bound_bytes = dict(moved)

    def total_fetches(self) -> int:
        return sum(len(v) for v in self.fetches.values())

    def total_moved_bytes(self) -> int:
        return sum(self.moved_bytes.values())

    def receiver_fetches(
        self, receiver: int
    ) -> "Tuple[Tuple[int, Tuple[int, ...]], ...]":
        return self.fetches.get(int(receiver), ())

    def receiver_unsourced(self, receiver: int) -> "Tuple[int, ...]":
        return self.unsourced.get(int(receiver), ())

    def serve_units(self, holder: int) -> "Tuple[int, ...]":
        """Units holder ``h`` may be asked for (primary OR failover) —
        what it must publish. Lazy staging makes over-publication free:
        only fetched units cost bytes."""
        holder = int(holder)
        out = set()
        for entries in self.fetches.values():
            for u, holders in entries:
                if holder in holders:
                    out.add(u)
        return tuple(sorted(out))


class RedistPlanner:
    """Spec-pair-cached plan compiler (the device plan cache's discipline).

    ``plan()`` returns the cached :class:`TransferPlan` for a seen
    (src, dst, unit-byte-layout) triple — a dict lookup, zero
    recompilation — and counts ``redist_plan_builds`` /
    ``redist_plan_cache_hits`` into the supplied metrics sink (plus
    instance attributes for sink-less callers). Repeated world-size
    oscillation (w3→w2→w3→…) therefore replans exactly twice, ever.
    Thread-safe; one planner per wrapper instance is the intended
    shape (specs from different wrappers rarely collide, and the key
    includes the byte layout so collisions are correct anyway)."""

    def __init__(self) -> None:
        self._cache: "Dict[tuple, TransferPlan]" = {}
        self._lock = threading.Lock()
        self.builds = 0
        self.hits = 0

    def plan(self, src: ShardSpec, dst: ShardSpec,
             unit_bytes: "Sequence[int]",
             metrics: "Optional[Any]" = None) -> TransferPlan:
        key = (src.key(), dst.key(),
               tuple(int(b) for b in unit_bytes))
        with self._lock:
            plan = self._cache.get(key)
            if plan is not None:
                self.hits += 1
                if metrics is not None:
                    metrics.incr("redist_plan_cache_hits")
                return plan
        built = TransferPlan(src, dst, unit_bytes)
        with self._lock:
            # A racing thread may have built it first; keep ONE object
            # so identity-based cache assertions hold.
            plan = self._cache.setdefault(key, built)
            if plan is built:
                self.builds += 1
                if metrics is not None:
                    metrics.incr("redist_plan_builds")
            else:
                self.hits += 1
                if metrics is not None:
                    metrics.incr("redist_plan_cache_hits")
        return plan


def execute_fetches(
    plan: TransferPlan,
    receiver: int,
    fetch_unit: "Callable[[int, int], List[np.ndarray]]",
    parallel: int = 4,
    on_fetch: "Optional[Callable[[int, int, int], None]]" = None,
) -> "Tuple[Dict[int, List[np.ndarray]], int]":
    """Run receiver ``r``'s slice of the plan: every assigned fetch,
    striped across primaries, with dead-donor failover.

    ``fetch_unit(holder, unit)`` returns the unit's arrays or raises
    ``ConnectionError``/``OSError``-family on holder death (an HTTP
    protocol error — the holder answered wrongly — should raise
    ``urllib.error.HTTPError`` and escalates immediately: that is
    version skew, not a death). A holder that dies is excluded from
    every later attempt; each of its assigned units is refetched from
    the surviving covering holders. If ANY unit exhausts its holders
    the whole call raises :class:`RedistTransferError` — the plan
    completes whole or raises, never partial-adopts (the caller must
    discard the returned dict on exception; none escapes).

    ``on_fetch(unit, holder, nbytes)``: per-unit attribution callback
    fired after each SUCCESSFUL fetch with the holder that actually
    served it (failovers included) — the serve plane splits its
    deploy-bytes counters by source class (train donor vs serve peer)
    with this.

    Returns ``({unit: arrays}, fetched_bytes)``."""
    import urllib.error

    entries = plan.receiver_fetches(receiver)
    if not entries:
        return {}, 0
    dead: "set" = set()
    dead_lock = threading.Lock()
    out: "Dict[int, List[np.ndarray]]" = {}
    out_lock = threading.Lock()
    total = [0]

    def _one(unit: int, holders: "Tuple[int, ...]") -> None:
        last: "Optional[Exception]" = None
        for h in holders:
            with dead_lock:
                if h in dead:
                    continue
            try:
                arrays = [np.asarray(a) for a in fetch_unit(h, unit)]
            except urllib.error.HTTPError:
                raise  # the holder answered: protocol error, not death
            except (ConnectionError, OSError, EOFError, TimeoutError) as e:
                logger.warning(
                    "redist holder %s died fetching unit %d: %s",
                    h, unit, e,
                )
                with dead_lock:
                    dead.add(h)
                last = e
                continue
            nb = sum(int(a.nbytes) for a in arrays)
            with out_lock:
                out[unit] = arrays
                total[0] += nb
            if on_fetch is not None:
                on_fetch(unit, h, nb)
            return
        raise RedistTransferError(
            f"redistribution unit {unit}: every covering holder "
            f"({list(holders)}) died mid-plan — the transfer cannot "
            "complete whole; retry at the next quorum or heal from a "
            "checkpoint"
        ) from last

    if len(entries) == 1 or parallel <= 1:
        for u, holders in entries:
            _one(u, holders)
    else:
        with ThreadPoolExecutor(
            max_workers=max(1, min(int(parallel), len(entries))),
            thread_name_prefix="torchft_tpu_torch_redist",
        ) as pool:
            futs = [pool.submit(_one, u, h) for u, h in entries]
            exc: "Optional[BaseException]" = None
            for f in futs:
                try:
                    f.result()
                except BaseException as e:  # noqa: BLE001 — drain all,
                    if exc is None:        # surface the first
                        exc = e
            if exc is not None:
                raise exc
    return out, total[0]


class ExchangeResult:
    """What one cohort exchange produced for THIS rank."""

    __slots__ = ("plan", "fetched", "moved_bytes", "lower_bound_bytes",
                 "cache_hit")

    def __init__(self, plan: TransferPlan,
                 fetched: "Dict[int, List[np.ndarray]]",
                 moved_bytes: int, lower_bound_bytes: int,
                 cache_hit: bool) -> None:
        self.plan = plan
        self.fetched = fetched
        self.moved_bytes = int(moved_bytes)
        self.lower_bound_bytes = int(lower_bound_bytes)
        self.cache_hit = bool(cache_hit)

    def unsourced(self, receiver: int) -> "Tuple[int, ...]":
        return self.plan.receiver_unsourced(receiver)


def _unit_nbytes(a: Any) -> int:
    """Byte size without materializing: numpy arrays and torch tensors
    both expose ``nbytes`` as metadata (no device-to-host copy — the
    holdings may carry device tensors until a unit is actually served)."""
    nb = getattr(a, "nbytes", None)
    return int(nb) if nb is not None else int(np.asarray(a).nbytes)


def _encode_meta(holdings: "Dict[int, Sequence[Any]]"
                 ) -> "List[np.ndarray]":
    units = sorted(holdings)
    idx = np.asarray(units, dtype=np.int64)
    nbytes = np.asarray(
        [sum(_unit_nbytes(a) for a in holdings[u]) for u in units],
        dtype=np.int64,
    )
    # Array count per unit: a unit whose state flattens to ZERO arrays
    # (stateless optax transforms — EmptyState) carries no bytes AND no
    # manifest entries; receivers must rebuild it locally instead of
    # scheduling an unservable fetch.
    counts = np.asarray(
        [len(holdings[u]) for u in units], dtype=np.int64
    )
    return [idx, nbytes, counts]


def _decode_meta(
    gathered: "Sequence[Sequence[np.ndarray]]", n_units: int,
) -> "Tuple[Dict[int, List[int]], List[int], List[int]]":
    """(holder → units, per-unit byte sizes, per-unit array counts)
    from the metadata allgather. Sizes/counts must agree across holders
    (bitwise-identical states); the max is taken defensively so a
    skewed advertisement surfaces as a moved/lower-bound mismatch
    instead of hiding."""
    assignment: "Dict[int, List[int]]" = {}
    unit_bytes = [0] * int(n_units)
    unit_counts = [0] * int(n_units)
    for r, arrays in enumerate(gathered):
        if not arrays:
            continue
        idx = np.asarray(arrays[0]).astype(np.int64).reshape(-1)
        nb = (
            np.asarray(arrays[1]).astype(np.int64).reshape(-1)
            if len(arrays) > 1 else np.zeros_like(idx)
        )
        cnt = (
            np.asarray(arrays[2]).astype(np.int64).reshape(-1)
            if len(arrays) > 2 else np.ones_like(idx)
        )
        units: "List[int]" = []
        for u, b, c in zip(idx.tolist(), nb.tolist(), cnt.tolist()):
            if 0 <= u < n_units:
                units.append(int(u))
                unit_bytes[int(u)] = max(unit_bytes[int(u)], int(b))
                unit_counts[int(u)] = max(unit_counts[int(u)], int(c))
        if units:
            assignment[r] = units
    return assignment, unit_bytes, unit_counts


def exchange(
    mgr: Any,
    my_rank: int,
    world: int,
    dst_spec: ShardSpec,
    holdings: "Dict[int, Sequence[Any]]",
    planner: RedistPlanner,
    serve_fn: "Callable[[Dict[int, Sequence[Any]]], Tuple[str, Callable[[], None]]]",
    fetch_factory: "Callable[[], Any]",
    parallel: int = 4,
    source: str = "reshard",
) -> "Optional[ExchangeResult]":
    """The cohort-synchronized redistribution exchange.

    Every wire member calls this at the same quorum boundary (the
    ``wire_generation`` bump is cohort-synchronized, which is what
    keeps the embedded collectives matched):

    1. **Holdings allgather** (tiny): each rank ships its held unit
       indices + per-unit byte sizes. Every rank now derives the SAME
       source spec, compiles the SAME plan (cached per spec pair), and
       knows deterministically whether any byte moves at all.
    2. **Address allgather** (only when the plan moves bytes): ranks
       the plan may ask for bytes publish their payload via
       ``serve_fn`` (lazy staging — unfetched units cost no bytes) and
       ship the serving address.
    3. **Point-to-point fetches** per the plan (striped, failover via
       :func:`execute_fetches`), then an **ack allgather** so no donor
       tears down while a receiver still streams.

    Returns an :class:`ExchangeResult`, or ``None`` when the wire
    latched mid-exchange or a transfer could not complete whole — the
    caller keeps its old grid, the step discards, and the next healthy
    quorum's generation bump retries (never a partial adopt). Counters
    ``redist_moved_bytes``/``redist_lower_bound_bytes`` and one
    ``redist_plan`` event land on success."""
    metrics = getattr(mgr, "metrics", None)
    events = getattr(mgr, "events", None)

    def _latched() -> bool:
        errored = getattr(mgr, "errored", None)
        return callable(errored) and errored() is not None

    def _allgather(arrays: "List[np.ndarray]"):
        try:
            gathered = mgr.allgather_arrays(arrays).future().result()
        except Exception as e:  # noqa: BLE001 — stub contexts may raise
            mgr.report_error(e)
            return None
        if _latched() or len(gathered) != world:
            # latched fallback is a solo view — the exchange cannot
            # proceed on it
            return None
        return gathered

    # -- 1. holdings metadata -------------------------------------------------
    gathered = _allgather(_encode_meta(holdings))
    if gathered is None:
        return None
    assignment, unit_bytes, unit_counts = _decode_meta(
        gathered, dst_spec.n_units
    )
    src_spec = ShardSpec(dst_spec.n_units, assignment)
    hits0 = planner.hits
    plan = planner.plan(src_spec, dst_spec, unit_bytes, metrics=metrics)
    cache_hit = planner.hits > hits0

    fetched: "Dict[int, List[np.ndarray]]" = {}
    moved = 0
    failure: "Optional[Exception]" = None
    protocol_failure: "Optional[Exception]" = None
    if plan.total_fetches():
        import urllib.error

        # -- 2. addresses (senders publish; everyone participates).
        # Zero-array units (stateless transforms) never hit the wire —
        # they are resolved locally below — so only units with actual
        # manifest entries are staged/served.
        close: "Optional[Callable[[], None]]" = None
        addr = ""
        serve = [
            u for u in plan.serve_units(my_rank) if unit_counts[u] > 0
        ]
        if serve:
            addr, close = serve_fn({u: holdings[u] for u in serve})
        try:
            got = _allgather([
                np.frombuffer(addr.encode(), dtype=np.uint8).copy()
            ])
            if got is None:
                return None
            addrs = {
                r: bytes(np.asarray(a[0]).astype(np.uint8)).decode()
                for r, a in enumerate(got) if a and np.asarray(a[0]).size
            }
            # -- 3. fetch per plan, then ack so donors can tear down -------
            fetcher = fetch_factory()
            try:
                def _fetch_unit(holder: int, unit: int):
                    if unit_counts[unit] == 0:
                        # The unit's state flattens to zero arrays
                        # (EmptyState-style): nothing to move — adopt an
                        # empty slot list, zero wire bytes (consistent
                        # with the 0-byte lower bound).
                        return []
                    a = addrs.get(holder)
                    if not a:
                        raise ConnectionError(
                            f"holder rank {holder} published no "
                            "redistribution address"
                        )
                    return fetcher.fetch(a, unit)

                try:
                    fetched, moved = execute_fetches(
                        plan, my_rank, _fetch_unit, parallel=parallel
                    )
                except urllib.error.HTTPError as e:
                    # A holder ANSWERED wrongly (path/version skew) —
                    # not a death: held until after the ack barrier
                    # (collectives stay matched), then re-raised so the
                    # skew surfaces loudly instead of retrying forever.
                    protocol_failure = e
                    fetched = {}
                    moved = 0
                except (RedistTransferError, ConnectionError, OSError,
                        EOFError, TimeoutError) as e:
                    # Hold the failure until AFTER the ack barrier: the
                    # cohort's collectives must stay matched even when
                    # this rank's fetches failed.
                    failure = e
                    fetched = {}
                    moved = 0
            finally:
                fetcher.close()
            if _allgather([np.ones(1, dtype=np.uint8)]) is None:
                return None
        finally:
            if close is not None:
                close()
    if protocol_failure is not None:
        raise protocol_failure
    if failure is not None:
        logger.warning("redistribution exchange failed whole: %s", failure)
        mgr.report_error(failure)
        return None
    lower = plan.lower_bound_bytes.get(int(my_rank), 0)
    if metrics is not None:
        metrics.incr("redist_moved_bytes", float(moved))
        metrics.incr("redist_lower_bound_bytes", float(lower))
    if events:
        events.emit(
            "redist_plan", source=source,
            src_spec=src_spec.fingerprint(),
            dst_spec=dst_spec.fingerprint(),
            n_units=dst_spec.n_units,
            cache_hit=cache_hit,
            fetches=len(plan.receiver_fetches(my_rank)),
            unsourced=len(plan.receiver_unsourced(my_rank)),
            moved_bytes=int(moved),
            lower_bound_bytes=int(lower),
        )
    return ExchangeResult(plan, fetched, moved, lower, cache_hit)
