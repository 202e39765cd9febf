"""The port's domain resolver (``comm/topology.py``) against the JAX
package's: the same cohorts and maps resolve to the same assignments, and
``to_json`` is byte-equal, because wire rank 0 of a mixed cohort publishes
it on the rendezvous store for both packages to adopt. Twins of the
resolver cases of ``tests/test_hier_topology.py``: static map, the env
fallback, the shared default domain, duplicate claims, the assignment
cache across a kill and re-form, election determinism, and the live
``/status.json`` tree of a root lighthouse and two domain aggregators built
with the port's ``Lighthouse(domain=, upstream_addr=)``. Every comparison
is exact."""

from __future__ import annotations

import json
import time
import urllib.request

import pytest

from torchft_tpu.comm import topology as ref_topology
from torchft_tpu_torch.comm.topology import (
    DEFAULT_DOMAIN,
    DOMAINS_ENV,
    DomainAssignment,
    DomainTopology,
)
from torchft_tpu_torch.control import Lighthouse

MAP_2X2 = {"d0": ["rank0", "rank1"], "d1": ["rank2", "rank3"]}
MAP_UNEVEN = {"d0": ["rank0", "rank2"], "d1": ["rank1"], "d2": ["rank3"]}
GROUPS_UNEVEN = ((0, 2), (1,), (3,))
MEMBERS4 = [f"rank{r}" for r in range(4)]


def _quorum(addr: str, requester: dict, timeout: float = 10.0) -> dict:
    """One lighthouse quorum RPC over HTTP: a replica joins its domain."""
    req = urllib.request.Request(
        addr + "/torchft.LighthouseService/Quorum",
        data=json.dumps({"requester": requester}).encode(),
        headers={"Content-Type": "application/json",
                 "x-timeout-ms": str(int(timeout * 1000))})
    with urllib.request.urlopen(req, timeout=timeout + 5) as r:
        return json.load(r)


def _same(port: DomainAssignment, ref) -> None:
    assert port.to_json() == ref.to_json()  # the published bytes
    assert port.fingerprint == ref.fingerprint
    for attr in ("members", "domains", "names", "groups", "egress"):
        assert getattr(port, attr) == getattr(ref, attr)
    assert port.n_domains == ref.n_domains


def test_constants_match_reference() -> None:
    assert DOMAINS_ENV == ref_topology.DOMAINS_ENV == "TORCHFT_TPU_DOMAINS"
    assert DEFAULT_DOMAIN == ref_topology.DEFAULT_DOMAIN


@pytest.mark.parametrize("smap,members", [
    (MAP_2X2, MEMBERS4),
    (MAP_UNEVEN, MEMBERS4),
    ({"d0": ["rank0"]}, MEMBERS4),                # unmapped -> default
    ({}, MEMBERS4),                               # one shared domain
    ({"z": "rank3", "a": ["rank1", "rank0"]}, ["rank3", "rank0", "rank1"]),
])
def test_static_map_matches_reference(smap, members) -> None:
    _same(DomainTopology(static_map=smap).assign(members),
          ref_topology.DomainTopology(static_map=smap).assign(members))


def test_static_map_assignment() -> None:
    a = DomainTopology(static_map=MAP_UNEVEN).assign(MEMBERS4)
    assert a.names == ("d0", "d1", "d2")  # sorted-name tier order
    assert a.groups == GROUPS_UNEVEN
    assert a.egress == (0, 1, 3)  # lowest wire rank per domain
    assert a.domains == ("d0", "d1", "d0", "d2")
    assert a.is_egress(0) and not a.is_egress(2)
    assert a.local_index(2) == 1 and a.local_index(0) == 0
    assert a.domain_index(3) == 2
    assert a.world_size() == 4


def test_env_fallback(monkeypatch) -> None:
    monkeypatch.setenv(DOMAINS_ENV, json.dumps(MAP_2X2))
    a = DomainTopology().assign(MEMBERS4)
    assert a.groups == ((0, 1), (2, 3)) and a.egress == (0, 2)
    _same(a, ref_topology.DomainTopology().assign(MEMBERS4))
    # an explicit map wins over the env
    b = DomainTopology(static_map=MAP_UNEVEN).assign(MEMBERS4)
    assert b.groups == GROUPS_UNEVEN


def test_unmapped_members_share_default_domain() -> None:
    a = DomainTopology(static_map={"d0": ["rank0"]}).assign(MEMBERS4)
    assert a.domains == ("d0",) + (DEFAULT_DOMAIN,) * 3
    b = DomainTopology(static_map={}).assign(MEMBERS4)
    assert b.n_domains == 1 and b.egress == (0,)


def test_duplicate_domain_claim_raises() -> None:
    with pytest.raises(ValueError, match="exactly one domain"):
        DomainTopology(static_map={"a": ["r0"], "b": ["r0"]})
    with pytest.raises(ValueError, match="JSON object"):
        DomainTopology(static_map=["r0"])


def test_assignment_cache_pins_across_kill_reform() -> None:
    topo = DomainTopology(static_map=MAP_2X2)
    a1 = topo.assign(MEMBERS4)
    assert (topo.hit_count, topo.miss_count) == (0, 1)
    assert topo.assign(MEMBERS4) is a1
    assert (topo.hit_count, topo.miss_count) == (1, 1)
    shrunk = ["rank0", "rank1", "rank3"]  # rank2, an egress, died
    a2 = topo.assign(shrunk)
    assert topo.miss_count == 2
    assert a2.egress == (0, 2)  # re-elected: wire rank 2 is now rank3
    assert a2.domains[2] == "d1"
    assert topo.assign(MEMBERS4) is a1  # re-form at a seen membership
    assert topo.hit_count == 2
    _same(a2, ref_topology.DomainTopology(static_map=MAP_2X2).assign(shrunk))


def test_cross_rank_election_determinism() -> None:
    seen = set()
    for _ in range(4):
        a = DomainTopology(static_map=MAP_UNEVEN).assign(MEMBERS4)
        seen.add((a.fingerprint, a.egress, a.groups, a.to_json()))
    assert len(seen) == 1


def test_assignment_json_roundtrip_across_packages() -> None:
    a = DomainTopology(static_map=MAP_UNEVEN).assign(MEMBERS4)
    b = DomainAssignment.from_json(a.to_json())
    assert b.fingerprint == a.fingerprint and b.groups == a.groups
    # what a reference rank 0 publishes, a port rank adopts, and back
    ref = ref_topology.DomainTopology(static_map=MAP_UNEVEN).assign(MEMBERS4)
    _same(DomainAssignment.from_json(ref.to_json().encode()), ref)
    _same(a, ref_topology.DomainAssignment.from_json(a.to_json()))
    with pytest.raises(ValueError, match="length mismatch"):
        DomainAssignment(["a", "b"], ["d0"])


def test_injected_fetch_walks_the_domains_table() -> None:
    pages = {
        "http://tree-root/status.json": {"domains": {
            "rack1": {"address": "http://agg1"},
            "rack0": {"address": "http://agg0"},
            "gone": {"address": "http://down"},
        }},
        "http://agg0/status.json": {"quorum": {"participants": [
            {"replica_id": "a"}, {"replica_id": "b"}]}},
        "http://agg1/status.json": {"quorum": {"participants": [
            {"replica_id": "c"}, {"replica_id": "a"}]}},  # a: first sight
    }

    def fetch(url, timeout):
        if url not in pages:
            raise OSError("partitioned")
        return pages[url]

    topo = DomainTopology(status_url="http://tree-root", fetch=fetch)
    ref = ref_topology.DomainTopology(status_url="http://tree-root", fetch=fetch)
    members = ["c", "a", "b", "z"]
    a = topo.assign(members)
    assert a.domains == ("rack1", "rack0", "rack0", DEFAULT_DOMAIN)
    _same(a, ref.assign(members))
    assert topo.refresh() == 0  # everything known is pinned


def test_live_status_json_membership() -> None:
    """A real root lighthouse and two domain aggregators (the port's
    ``Lighthouse(domain=, upstream_addr=)``), replicas joining through real
    quorum RPCs, and both packages' resolvers walking the tree."""
    root = Lighthouse(min_replicas=1)
    aggs = {
        name: Lighthouse(min_replicas=1, join_timeout_ms=100, domain=name,
                         upstream_addr=root.address(),
                         upstream_report_interval_ms=50)
        for name in ("rack0", "rack1")
    }
    try:
        for name, rid in (("rack0", "grp_a"), ("rack1", "grp_b")):
            _quorum(aggs[name].address(), {
                "replica_id": rid, "address": f"http://{rid}:1",
                "store_address": f"{rid}:1", "step": 0, "world_size": 1,
                "shrink_only": False,
            }, 10.0)

        def domains_reported() -> bool:
            with urllib.request.urlopen(root.address() + "/status.json",
                                        timeout=5) as r:
                return len(json.load(r).get("domains") or {}) == 2

        deadline = time.monotonic() + 10
        while not domains_reported():
            assert time.monotonic() < deadline, "tree never formed"
            time.sleep(0.05)
        members = ["grp_a", "grp_b", "grp_c"]
        topo = DomainTopology(status_url=root.address())
        a = topo.assign(members)
        assert a.domains == ("rack0", "rack1", DEFAULT_DOMAIN)
        assert topo.domain_of("grp_a") == "rack0"
        _same(a, ref_topology.DomainTopology(
            status_url=root.address()).assign(members))
    finally:
        for agg in aggs.values():
            agg.shutdown()
        root.shutdown()
