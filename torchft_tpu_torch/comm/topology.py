"""Domain topology resolver for the hierarchical data plane
(reduce-within -> compress -> exchange-across -> broadcast-within).

Twin of ``torchft_tpu/comm/topology.py``, kept as the port's own copy. A
two-level lighthouse tree lists every domain aggregator in the root's
``/status.json``, and each aggregator's own ``/status.json`` lists the
replica groups homed to it (rack locality). This module turns that
membership into the data plane's tier structure: given a wire cohort
(replica ids in transport rank order), a :class:`DomainAssignment` says
which ranks share a domain (full-precision reduction over cheap links),
which single rank per domain is the elected **egress** (the only rank
whose bytes cross the slow tier, encoded), and in which order domains sit
on the cross-domain tier.

Sources, in precedence order:

* an explicit ``static_map`` ``{domain: [replica_id, ...]}``;
* a live lighthouse ``status_url``: the root's ``/status.json`` domains
  table is walked as ``scripts/fleet_top.py`` walks it, and each
  aggregator's participants pin ``replica -> domain`` at FIRST SIGHT (a
  replica's home aggregator does not move mid-job, so ranks that refresh
  at different times converge on one map);
* the ``TORCHFT_TPU_DOMAINS`` env var (the same JSON object as
  ``static_map``).

Replicas no source claims fall into one shared ``"default"`` domain, so an
unmapped fleet degrades to a single-domain hierarchy instead of erroring.
Assignments are cached per ``(cohort, map generation)`` with
``hit_count``/``miss_count``: a re-form at a membership seen before is a
dict lookup. Election is deterministic (egress = lowest wire rank of the
domain; domain order = sorted names), and ``to_json`` is byte-identical to
the JAX package's, because wire rank 0 publishes it on the rendezvous
store for a cohort that may mix both packages.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

__all__ = [
    "DomainAssignment",
    "DomainTopology",
    "DEFAULT_DOMAIN",
    "DOMAINS_ENV",
]

DOMAINS_ENV = "TORCHFT_TPU_DOMAINS"
# Where replicas no source claims land: one shared domain, so "no map at
# all" degrades to a single-domain hierarchy instead of an error.
DEFAULT_DOMAIN = "default"


def _fingerprint(items: "Sequence[Tuple[str, str]]") -> str:
    import hashlib

    blob = "\x00".join(f"{k}\x01{v}" for k, v in items)
    return hashlib.sha1(blob.encode()).hexdigest()[:12]


class DomainAssignment:
    """One cohort's resolved tier structure (immutable).

    ``members`` are replica ids in transport rank order (``members[r]``
    is wire rank ``r``); ``domains[r]`` is rank r's domain name. Domain
    ORDER — hence each domain's rank on the cross-domain tier — is
    sorted-name order; the **egress** of a domain is its lowest wire
    rank (re-elected from scratch on every membership change: an egress
    death simply stops being the minimum at the next quorum)."""

    __slots__ = ("members", "domains", "names", "groups", "egress",
                 "fingerprint")

    def __init__(self, members: Sequence[str],
                 domains: Sequence[str]) -> None:
        if len(members) != len(domains):
            raise ValueError(
                f"members/domains length mismatch: {len(members)} != "
                f"{len(domains)}"
            )
        self.members: Tuple[str, ...] = tuple(str(m) for m in members)
        self.domains: Tuple[str, ...] = tuple(str(d) for d in domains)
        self.names: Tuple[str, ...] = tuple(sorted(set(self.domains)))
        self.groups: Tuple[Tuple[int, ...], ...] = tuple(
            tuple(r for r, d in enumerate(self.domains) if d == name)
            for name in self.names
        )
        self.egress: Tuple[int, ...] = tuple(g[0] for g in self.groups)
        self.fingerprint = _fingerprint(
            list(zip(self.members, self.domains))
        )

    @property
    def n_domains(self) -> int:
        return len(self.names)

    def world_size(self) -> int:
        return len(self.members)

    def domain_index(self, rank: int) -> int:
        """The rank's domain's position on the cross-domain tier (its
        inter-tier rank)."""
        return self.names.index(self.domains[rank])

    def group_of(self, rank: int) -> Tuple[int, ...]:
        return self.groups[self.domain_index(rank)]

    def local_index(self, rank: int) -> int:
        """Rank's position within its domain group (its intra-tier
        rank; 0 is the egress)."""
        return self.group_of(rank).index(rank)

    def is_egress(self, rank: int) -> bool:
        return self.egress[self.domain_index(rank)] == rank

    # ------------------------------------------------- wire publication
    # The host transport cohort-synchronizes by shipping wire rank 0's
    # assignment over the rendezvous store — one canonical serialization.

    def to_json(self) -> str:
        return json.dumps(
            {"members": list(self.members), "domains": list(self.domains)}
        )

    @classmethod
    def from_json(cls, blob: "str | bytes") -> "DomainAssignment":
        d = json.loads(blob)
        return cls(d["members"], d["domains"])

    def __repr__(self) -> str:  # pragma: no cover — debugging aid
        return (
            f"DomainAssignment(world={len(self.members)}, "
            f"domains={self.names}, egress={self.egress}, "
            f"fp={self.fingerprint})"
        )


def _parse_static_map(obj: Any) -> Dict[str, str]:
    """``{domain: [replica_id, ...]}`` → ``{replica_id: domain}``,
    rejecting a replica claimed by two domains (a silent first-wins
    would make the tier structure depend on dict order)."""
    if not isinstance(obj, dict):
        raise ValueError(
            "domain map must be a JSON object {domain: [replica_id, ...]}"
        )
    out: Dict[str, str] = {}
    for domain, members in obj.items():
        if isinstance(members, str):
            members = [members]
        for m in members:
            m = str(m)
            if m in out and out[m] != str(domain):
                raise ValueError(
                    f"replica {m!r} is claimed by domains {out[m]!r} and "
                    f"{domain!r} — a replica is homed to exactly one "
                    "domain"
                )
            out[m] = str(domain)
    return out


def _default_fetch(url: str, timeout: float) -> Dict[str, Any]:
    import urllib.request

    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return json.load(resp)


class DomainTopology:
    """Resolver from replica-id cohorts to :class:`DomainAssignment`.

    ``static_map``: ``{domain: [replica_id, ...]}`` (tests/benches).
    ``status_url``: a lighthouse root; its ``/status.json`` domains
    table is walked (aggregator participants → replica→domain), entries
    pinned at first sight. ``fetch(url, timeout)`` is injectable for
    tests. With neither, the ``TORCHFT_TPU_DOMAINS`` env var (same JSON
    object as ``static_map``) is the fallback; an empty map sends every
    replica to the shared ``"default"`` domain.

    Thread-safe. ``assign`` caches per (cohort, map-generation) —
    ``hit_count``/``miss_count`` expose the mesh-cache discipline."""

    def __init__(self, static_map: "Optional[Dict[str, Any]]" = None,
                 status_url: Optional[str] = None,
                 fetch: "Optional[Callable[[str, float], Any]]" = None,
                 timeout: float = 5.0) -> None:
        self._lock = threading.Lock()
        self._status_url = status_url
        self._fetch = fetch or _default_fetch
        self._timeout = float(timeout)
        if static_map is not None:
            member_domain = _parse_static_map(static_map)
        else:
            env = os.environ.get(DOMAINS_ENV, "")
            member_domain = (
                _parse_static_map(json.loads(env)) if env.strip() else {}
            )
        self._member_domain: Dict[str, str] = member_domain
        # bumped whenever the member→domain map gains entries (a live
        # refresh) — part of the assignment cache key, so a map change
        # invalidates exactly the assignments it could alter
        self._map_generation = 0
        self._cache: Dict[Tuple, DomainAssignment] = {}
        self.hit_count = 0
        self.miss_count = 0

    # ------------------------------------------------------ live status

    def refresh(self) -> int:
        """Walk ``status_url`` (root ``/status.json`` → per-aggregator
        participants) and pin any replica→domain entries not yet known
        (first sight wins — a replica's home aggregator does not move
        mid-job, and pinning keeps concurrent refreshers convergent).
        Returns the number of NEW entries pinned. No-op without a
        ``status_url``."""
        if not self._status_url:
            return 0
        root = self._fetch(
            self._status_url.rstrip("/") + "/status.json", self._timeout
        )
        learned: List[Tuple[str, str]] = []
        domains = root.get("domains") or {}
        for name in sorted(domains):
            addr = (domains[name] or {}).get("address")
            if not addr:
                continue
            try:
                dstatus = self._fetch(
                    str(addr).rstrip("/") + "/status.json", self._timeout
                )
            except Exception:  # noqa: BLE001 — a partitioned aggregator
                continue  # is fleet weather; its replicas stay unmapped
            for p in dstatus.get("quorum", {}).get("participants", []):
                rid = p.get("replica_id")
                if rid:
                    learned.append((str(rid), str(name)))
        # A single-level lighthouse (no domains table) may still label
        # itself with a domain: its own participants are homed there.
        own = (root.get("control") or {}).get("domain")
        if own:
            for p in root.get("quorum", {}).get("participants", []):
                rid = p.get("replica_id")
                if rid:
                    learned.append((str(rid), str(own)))
        added = 0
        with self._lock:
            for rid, name in learned:
                if rid not in self._member_domain:
                    self._member_domain[rid] = name
                    added += 1
            if added:
                self._map_generation += 1
        return added

    # ------------------------------------------------------- resolution

    def domain_of(self, replica_id: str) -> str:
        with self._lock:
            return self._member_domain.get(str(replica_id), DEFAULT_DOMAIN)

    def map_fingerprint(self) -> str:
        with self._lock:
            return _fingerprint(sorted(self._member_domain.items()))

    def assign(self, members: Sequence[str]) -> DomainAssignment:
        """Resolve a cohort (replica ids in transport rank order) to its
        tier structure. Cached per (cohort, map generation): a
        kill→reform at a seen (world, domain-map) key is a dict lookup."""
        members = tuple(str(m) for m in members)
        with self._lock:
            key = (members, self._map_generation)
            hit = self._cache.get(key)
            if hit is not None:
                self.hit_count += 1
                return hit
            unmapped = [m for m in members if m not in self._member_domain]
        if unmapped and self._status_url:
            try:
                self.refresh()
            except Exception:  # noqa: BLE001 — resolution must not take
                pass  # the data plane down; unmapped members degrade to
                # the shared default domain below
        with self._lock:
            key = (members, self._map_generation)
            hit = self._cache.get(key)
            if hit is not None:
                self.hit_count += 1
                return hit
            assignment = DomainAssignment(
                members,
                [
                    self._member_domain.get(m, DEFAULT_DOMAIN)
                    for m in members
                ],
            )
            self._cache[key] = assignment
            self.miss_count += 1
            return assignment
