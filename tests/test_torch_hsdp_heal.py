"""Sharded leaves on both sides of the port's heal plane.

Twins of ``tests/test_integration_hsdp.py``'s heal-plane tests that
``tests/test_torch_heal_plane.py`` has none of, with the port's
``ShardedTensor`` where the reference has a ``NamedSharding`` ed
``jax.Array``: the sharded template heal round trip, the structure and
dtype checks, two donor hosts each holding half of the pieces (the
``_shard_filter`` seam), a region no host holds, the overlap that must not
mask a gap, and the donor staging shard by shard. Then the two mixed
cohorts, each bitwise: a port healer with a sharded template heals from a
JAX-package donor holding sharded arrays, and a JAX-package healer with a
sharded template heals from a port donor holding ``ShardedTensor`` s; in
both the healer fetches every byte of its distinct regions once and
nothing else (a region the donor holds in several pieces comes piece by
piece).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding as JNamedSharding
from jax.sharding import PartitionSpec as JP

import torchft_tpu.checkpointing as jax_ckpt
import torchft_tpu_torch.checkpointing as cp
from torchft_tpu.parallel import ft_mesh as jft_mesh
from torchft_tpu.parallel import shard_pytree as jshard_pytree
from torchft_tpu_torch.parallel import (
    NamedSharding,
    PartitionSpec as P,
    ShardedTensor,
    ft_mesh,
    shard_pytree,
)
from torchft_tpu_torch.utils.metrics import Metrics

D_IN, D_HID = 8, 16  # divisible by fsdp=4


def make_params(seed: float):
    return {
        "layer1": {"w": np.full((D_IN, D_HID), seed, np.float32)},
        "layer2": {"w": np.full((D_HID, D_IN), seed / 2, np.float32)},
    }


def group_mesh(n: int = 4):
    """A virtual fsdp mesh of ``n`` CPU positions (the reference carves 4
    of its 8 CPU devices)."""
    return ft_mesh({"fsdp": n}, devices=["cpu"] * n)


def shard_group_params(params, mesh):
    return shard_pytree(params, mesh, tp_rules=None, fsdp_axis="fsdp")


def _zeros(shape, sharding, dtype=torch.float32) -> ShardedTensor:
    return ShardedTensor.from_full(torch.zeros(shape, dtype=dtype), sharding)


def _bytes(x) -> bytes:
    if isinstance(x, ShardedTensor):
        x = x.full()
    if isinstance(x, torch.Tensor):
        return x.detach().contiguous().reshape(-1).view(
            torch.uint8).numpy().tobytes()
    return np.asarray(x).tobytes()


def test_sharded_recv_roundtrip() -> None:
    # the donor serves its whole host state; the healer assembles it into
    # its OWN sharded layout, fetching only its pieces' bounds
    donor_state = {
        "user": {k: {"w": torch.from_numpy(v["w"])}
                 for k, v in make_params(3.0).items()},
        "torchft": {"step": 5, "batches_committed": 10},
    }
    donor = cp.CheckpointServer(timeout=5.0)
    try:
        donor.send_checkpoint([1], step=5, state_dict=donor_state,
                              timeout=5.0)
        template = {
            "user": shard_group_params(make_params(0.0), group_mesh()),
            "torchft": {"step": 0, "batches_committed": 0},
        }
        got = cp.recv_checkpoint_sharded(donor.metadata(), 5, template,
                                         timeout=5.0)
        assert got["torchft"] == {"step": 5, "batches_committed": 10}
        for name in ("layer1", "layer2"):
            healed = got["user"][name]["w"]
            tmpl = template["user"][name]["w"]
            # the healed leaf arrives with the healer's sharding, its
            # pieces on the template's devices
            assert isinstance(healed, ShardedTensor)
            assert healed.sharding == tmpl.sharding
            assert healed.bounds == tmpl.bounds
            assert [p.device for p in healed.pieces] == tmpl.devices
            assert _bytes(healed) == _bytes(donor_state["user"][name]["w"])
    finally:
        donor.shutdown()


def test_sharded_recv_rejects_structure_mismatch() -> None:
    donor = cp.CheckpointServer(timeout=5.0)
    try:
        donor.send_checkpoint(
            [1], step=1, state_dict={"a": np.zeros(4, np.float32)},
            timeout=5.0)
        template = {"b": shard_group_params(
            {"w": np.zeros(4, np.float32)}, group_mesh())["w"]}
        with pytest.raises(ValueError, match="mismatch"):
            cp.recv_checkpoint_sharded(donor.metadata(), 1, template,
                                       timeout=5.0)
    finally:
        donor.shutdown()


def test_multihost_donor_fanout() -> None:
    # two checkpoint servers stand for the two hosts of one donor group:
    # each stages half the fsdp pieces (_shard_filter) and names the other
    # as a peer. A healer sharded row-wise needs rows from both hosts for
    # every region: the fan-out assembly
    w = np.arange(D_IN * D_HID, dtype=np.float32).reshape(D_IN, D_HID)
    state = {"user": shard_group_params({"layer1": {"w": w}}, group_mesh()),
             "torchft": {"step": 7, "batches_committed": 14}}
    assert state["user"]["layer1"]["w"].sharding.spec == P(None, "fsdp")
    host_a = cp.CheckpointServer(timeout=5.0)
    host_b = cp.CheckpointServer(timeout=5.0)
    try:
        host_a._shard_filter = lambda path, b: b[1][0] < D_HID // 2
        host_b._shard_filter = lambda path, b: b[1][0] >= D_HID // 2
        host_a.set_peers([host_b.metadata()])
        host_b.set_peers([host_a.metadata()])
        for h in (host_a, host_b):
            h.send_checkpoint([1], step=7, state_dict=state, timeout=5.0)
        man = cp.fetch_manifest(host_a.metadata(), 7)
        entry = next(e for e in man["leaves"] if "layer1" in e["path"])
        assert len(entry["pieces"]) == 2  # A holds 2 of the 4 shards
        assert man["peers"] == [host_b.metadata()]

        mesh2 = group_mesh()
        tmpl_w = _zeros((D_IN, D_HID), NamedSharding(mesh2, P("fsdp", None)))
        template = {"user": {"layer1": {"w": tmpl_w}},
                    "torchft": {"step": 0, "batches_committed": 0}}
        got = cp.recv_checkpoint_sharded(host_a.metadata(), 7, template,
                                         timeout=5.0)
        healed = got["user"]["layer1"]["w"]
        assert healed.sharding == tmpl_w.sharding
        assert _bytes(healed) == w.tobytes()
        assert got["torchft"]["step"] == 7

        # the matching column layout: the regions B holds go to B whole
        tmpl_col = shard_group_params(
            {"layer1": {"w": np.zeros((D_IN, D_HID), np.float32)}}, mesh2)
        got2 = cp.recv_checkpoint_sharded(
            host_a.metadata(), 7,
            {"user": tmpl_col,
             "torchft": {"step": 0, "batches_committed": 0}}, timeout=5.0)
        assert _bytes(got2["user"]["layer1"]["w"]) == w.tobytes()
    finally:
        host_a.shutdown()
        host_b.shutdown()


def test_multihost_donor_gap_is_loud() -> None:
    # a region no donor host holds fails with the resharding error, never
    # a torn heal
    state = {"w": shard_group_params(
        {"w": np.zeros((D_IN, D_HID), np.float32)}, group_mesh())["w"]}
    host_a = cp.CheckpointServer(timeout=5.0)
    host_b = cp.CheckpointServer(timeout=5.0)
    try:
        # columns [4, 8) are held by nobody
        host_a._shard_filter = lambda path, b: b[1][0] < 4
        host_b._shard_filter = lambda path, b: b[1][0] >= 8
        host_a.set_peers([host_b.metadata()])
        for h in (host_a, host_b):
            h.send_checkpoint([1], step=1, state_dict=state, timeout=5.0)
        template = {"w": _zeros((D_IN, D_HID), NamedSharding(
            group_mesh(), P("fsdp", None)))}
        with pytest.raises(ValueError, match="not covered"):
            cp.recv_checkpoint_sharded(host_a.metadata(), 1, template,
                                       timeout=5.0)
    finally:
        host_a.shutdown()
        host_b.shutdown()


def test_route_region_overlap_cannot_mask_gap() -> None:
    # overlapping pieces whose total volume matches the request must
    # still fail while part of the region is uncovered
    bounds = ((0, 8),)
    piece_maps = {"http://a": [((0, 4),)], "http://b": [((2, 6),)]}
    with pytest.raises(ValueError, match="not covered"):
        cp._route_region(bounds, piece_maps)
    piece_maps["http://b"].append(((6, 8),))
    plan = cp._route_region(bounds, piece_maps)
    assert set(b for _, b in plan) == {((0, 4),), ((2, 6),), ((6, 8),)}


def test_sharded_recv_rejects_dtype_mismatch() -> None:
    donor = cp.CheckpointServer(timeout=5.0)
    try:
        donor.send_checkpoint(
            [1], step=1, state_dict=shard_group_params(
                {"w": np.zeros((D_IN, D_HID), np.float32)}, group_mesh()),
            timeout=5.0)
        template = {"w": _zeros((D_IN, D_HID), NamedSharding(
            group_mesh(), P(None, "fsdp")), torch.bfloat16)}
        with pytest.raises(ValueError, match="dtype mismatch"):
            cp.recv_checkpoint_sharded(donor.metadata(), 1, template,
                                       timeout=5.0)
    finally:
        donor.shutdown()


def test_donor_stages_shard_wise() -> None:
    # the donor holds pieces, not the assembled leaf: an exact piece
    # request is served from that piece, a region spanning pieces is
    # assembled on the host, and a whole fetch assembles the leaf
    w = np.arange(D_IN * D_HID, dtype=np.float32).reshape(D_IN, D_HID)
    params = shard_group_params({"layer1": {"w": w}}, group_mesh())
    donor = cp.CheckpointServer(timeout=5.0)
    try:
        donor.send_checkpoint([1], step=3, state_dict=params, timeout=5.0)
        staged = donor._staged.leaf(0)
        assert isinstance(staged, cp._HostShards)
        assert len(staged.pieces) == 4  # one piece per fsdp shard
        (bounds, piece), *_ = sorted(staged.pieces.items())
        assert staged.read(bounds) is piece
        slices = tuple(slice(a, b) for a, b in bounds)
        got = cp.fetch_leaf(donor.metadata(), 3, 0, slices=slices)
        np.testing.assert_array_equal(np.asarray(got), w[slices])
        span = cp.fetch_leaf(donor.metadata(), 3, 0,
                             slices=(slice(0, D_IN), slice(2, 10)))
        np.testing.assert_array_equal(np.asarray(span), w[:, 2:10])
        # the chunked (template-free) heal reads the assembled leaf, and
        # so does the legacy full stream (the reference's last assertion)
        for n in (2, 0):
            full = cp.CheckpointServer(timeout=5.0, num_chunks=n)
            try:
                got = full.recv_checkpoint(0, donor.metadata(), 3, 5.0)
            finally:
                full.shutdown()
            assert _bytes(got["layer1"]["w"]) == w.tobytes()
    finally:
        donor.shutdown()


def test_full_stream_refuses_a_leaf_this_host_does_not_cover() -> None:
    # a donor holding half of a sharded leaf cannot materialize it: the
    # full stream answers 503 before any byte of the body
    import urllib.error
    import urllib.request

    w = np.arange(D_IN * D_HID, dtype=np.float32).reshape(D_IN, D_HID)
    params = shard_group_params({"layer1": {"w": w}}, group_mesh())
    donor = cp.CheckpointServer(timeout=5.0)
    donor._shard_filter = lambda path, bounds: bounds[1][0] < D_HID // 2
    try:
        donor.send_checkpoint([1], step=3, state_dict=params, timeout=5.0)
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(f"{donor.metadata()}/checkpoint/3",
                                   timeout=10)
        assert err.value.code == 503
        assert "not covered" in err.value.read().decode()
    finally:
        donor.shutdown()


# ----------------------------------------------------------- mixed cohorts


def _mixed_params():
    rng = np.random.default_rng(11)
    return {"b": rng.standard_normal(16).astype(np.float32),
            "w": rng.standard_normal((16, 32)).astype(np.float32)}


def _recording(monkeypatch, module):
    """Record every region ``module.fetch_leaf`` requests."""
    seen = []
    real = module.fetch_leaf

    def spy(metadata, step, index, slices=None, **kw):
        seen.append((index, None if slices is None else tuple(
            (s.start or 0, s.stop) for s in slices)))
        return real(metadata, step, index, slices=slices, **kw)

    monkeypatch.setattr(module, "fetch_leaf", spy)
    return seen


def test_port_healer_with_a_sharded_template_heals_from_a_jax_donor(
        monkeypatch) -> None:
    params = _mixed_params()
    # the donor: fsdp 4 over the JAX package's CPU devices (columns of w)
    jmesh = jft_mesh({"fsdp": 4}, devices=jax.devices()[:4])
    jstate = {"user": jshard_pytree(params, jmesh, fsdp_axis="fsdp"),
              "torchft": {"step": 4, "batches_committed": 8}}
    # the healer: another layout, fsdp x tensor over 4 virtual positions
    mesh = ft_mesh({"fsdp": 2, "tensor": 2}, devices=["cpu"] * 4)
    tmpl = {"b": _zeros((16,), NamedSharding(mesh, P("fsdp"))),
            "w": _zeros((16, 32), NamedSharding(mesh, P("tensor", "fsdp")))}
    template = {"user": tmpl, "torchft": {"step": 0, "batches_committed": 0}}
    donor = jax_ckpt.CheckpointServer(timeout=10.0)
    healer = cp.CheckpointServer(timeout=10.0, template_fn=lambda: template)
    metrics = Metrics()
    healer.set_metrics(metrics)
    seen = _recording(monkeypatch, cp)
    try:
        donor.send_checkpoint([], 4, jstate, 10.0)
        names = {i: e["path"].split("'")[-2] for i, e in enumerate(
            cp.fetch_manifest(donor.metadata(), 4)["leaves"])
            if e["kind"] == "ndarray"}
        got = healer.recv_checkpoint(0, donor.metadata(), 4, 10.0)
    finally:
        donor.shutdown()
        healer.shutdown()
    for name, want in params.items():
        healed = got["user"][name]
        assert isinstance(healed, ShardedTensor)
        assert healed.sharding == tmpl[name].sharding
        assert _bytes(healed) == want.tobytes()
    assert got["torchft"] == {"step": 4, "batches_committed": 8}
    # each of the healer's distinct regions once, and nothing else: a
    # region the donor holds in several pieces is fetched piece by piece,
    # each request inside one of the healer's regions, none twice; "b" is
    # replicated over tensor, and its halves are fetched once each
    by_leaf = {}
    for index, region in seen:
        if index in names:  # the object leaves come whole
            assert region is not None
            by_leaf.setdefault(index, []).append(region)
    assert sorted(names.values()) == ["b", "w"] and set(by_leaf) == set(names)
    for index, regions in by_leaf.items():
        assert len(regions) == len(set(regions))
        leaf = tmpl[names[index]]
        for r in regions:
            assert sum(cp._intersect(r, b) == r
                       for b in set(leaf.bounds)) == 1, (r, leaf.bounds)
        assert sum(int(np.prod([b - a for a, b in r])) for r in regions) \
            == int(np.prod(leaf.shape))
    assert metrics.snapshot()["heal_wire_bytes"] == sum(
        v.nbytes for v in params.values())


def test_jax_healer_with_a_sharded_template_heals_from_a_port_donor(
        monkeypatch) -> None:
    params = _mixed_params()
    mesh = ft_mesh({"fsdp": 2, "tensor": 2}, devices=["cpu"] * 4)
    port_state = {
        "user": {"b": ShardedTensor.from_full(params["b"],
                                              NamedSharding(mesh, P("fsdp"))),
                 "w": ShardedTensor.from_full(
                     params["w"], NamedSharding(mesh, P("fsdp", "tensor")))},
        "torchft": {"step": 6, "batches_committed": 12}}
    jmesh = jft_mesh({"fsdp": 4}, devices=jax.devices()[4:8])
    jtmpl = {"b": jax.device_put(jnp.zeros(16), JNamedSharding(jmesh,
                                                               JP("fsdp"))),
             "w": jax.device_put(jnp.zeros((16, 32)),
                                 JNamedSharding(jmesh, JP("fsdp", None)))}
    template = {"user": jtmpl, "torchft": {"step": 0, "batches_committed": 0}}
    donor = cp.CheckpointServer(timeout=10.0)
    served = Metrics()
    donor.set_metrics(served)
    healer = jax_ckpt.CheckpointServer(timeout=10.0,
                                       template_fn=lambda: template)
    seen = _recording(monkeypatch, jax_ckpt)
    try:
        donor.send_checkpoint([], 6, port_state, 10.0)
        man = cp.fetch_manifest(donor.metadata(), 6)
        w_entry = next(e for e in man["leaves"] if e["path"].endswith(
            "['w']"))
        assert [tuple(p) for p in w_entry["pieces"]] == sorted(
            port_state["user"]["w"].bounds)
        got = healer.recv_checkpoint(0, donor.metadata(), 6, 10.0)
    finally:
        donor.shutdown()
        healer.shutdown()
    for name, want in params.items():
        healed = got["user"][name]
        assert isinstance(healed, jax.Array)
        assert healed.sharding == jtmpl[name].sharding
        assert np.asarray(healed).tobytes() == want.tobytes()
    assert got["torchft"] == {"step": 6, "batches_committed": 12}
    # every request inside one of the healer's row bands, none twice, the
    # bands tiled exactly (a band the donor holds in two pieces comes in two)
    for name, leaf in jtmpl.items():
        bands = {jax_ckpt._normalize_index(ix, leaf.shape) for ix in
                 leaf.sharding.addressable_devices_indices_map(
                     leaf.shape).values()}
        regions = [r for _, r in seen
                   if r is not None and len(r) == leaf.ndim]
        assert len(regions) == len(set(regions))
        for r in regions:
            assert sum(cp._intersect(r, b) == r for b in bands) == 1
        assert sum(int(np.prod([b - a for a, b in r])) for r in regions) \
            == leaf.size
    # the port donor served exactly the healer's regions' bytes
    assert served.snapshot()["heal_served_bytes"] == sum(
        v.nbytes for v in params.values())
