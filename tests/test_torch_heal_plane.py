"""The port's streaming heal plane against the JAX package's.

Twins of tests/test_heal_plane.py: every heal mode bitwise (fp32 and
bf16), multi-donor routing, donor death with and without a survivor, the
bf16 wire, an unknown wire dtype, a lying Content-Length, the metrics
surface and ``out=``; the stripe grid bitwise against the reference's; and
the mixed-package heals (F7): a port healer from reference donors that
each hold half of a sharded leaf, and a reference healer from a port donor.
Inputs come from numpy seeds; each case runs through both packages.
"""

import threading
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch

import torchft_tpu.checkpointing as jax_ckpt
import torchft_tpu_torch.checkpointing as cp
from tests.test_heal_plane import _DieAfterManifestProxy, _LyingHandler
from torchft_tpu.comm.wire import split_stripes as jax_split_stripes
from torchft_tpu_torch.comm.wire import split_stripes
from torchft_tpu_torch.utils.metrics import Metrics


def _arrays():
    """The reference test's leaves, from the same seeds: w [8192] and b
    [33, 17], f32 (the states round them to bf16 for "bf16")."""
    w = np.random.default_rng(7).standard_normal(8192).astype(np.float32)
    b = np.random.default_rng(8).standard_normal((33, 17)).astype(np.float32)
    return w, b


def _port_state(dtype_name: str):
    dt = torch.float32 if dtype_name == "fp32" else torch.bfloat16
    w, b = _arrays()
    return {"params": {"w": torch.from_numpy(w).to(dt),
                       "b": torch.from_numpy(b).to(dt)},
            "torchft": {"step": 3, "batches_committed": 9}}


def _jax_state(dtype_name: str):
    import jax.numpy as jnp

    dt = jnp.float32 if dtype_name == "fp32" else jnp.bfloat16
    w, b = _arrays()
    return {"params": {"w": jnp.asarray(w, dt), "b": jnp.asarray(b, dt)},
            "torchft": {"step": 3, "batches_committed": 9}}


def _bytes(x) -> bytes:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().contiguous().reshape(-1).view(
            torch.uint8).numpy().tobytes()
    return np.asarray(x).tobytes()


def _assert_port_bitwise(got, src) -> None:
    assert set(got) == set(src)
    for k, v in src.items():
        if isinstance(v, dict):
            _assert_port_bitwise(got[k], v)
        elif isinstance(v, torch.Tensor):
            assert isinstance(got[k], torch.Tensor)
            assert got[k].dtype == v.dtype and got[k].shape == v.shape
            assert _bytes(got[k]) == _bytes(v)
        else:
            assert got[k] == v


def _port_healer(mode: str, state, **kw):
    if mode == "full_stream":  # the whole state over one connection
        return cp.CheckpointServer(timeout=10.0, num_chunks=1, **kw)
    if mode == "chunked":
        return cp.CheckpointServer(timeout=10.0, num_chunks=3, **kw)
    if mode == "sharded":
        return cp.CheckpointServer(timeout=10.0, template_fn=lambda: state,
                                   **kw)
    return cp.CheckpointServer(timeout=10.0, template_fn=lambda: state,
                               stripe_bytes=2048, **kw)


def _jax_healer(mode: str, state):
    if mode == "full_stream":
        return jax_ckpt.CheckpointServer(timeout=10.0)
    if mode == "chunked":
        return jax_ckpt.CheckpointServer(timeout=10.0, num_chunks=3)
    if mode == "sharded":
        return jax_ckpt.CheckpointServer(timeout=10.0,
                                         template_fn=lambda: state)
    return jax_ckpt.CheckpointServer(timeout=10.0, template_fn=lambda: state,
                                     stripe_bytes=2048)


@pytest.mark.parametrize("dtype_name", ["fp32", "bf16"])
@pytest.mark.parametrize("mode",
                         ["full_stream", "chunked", "sharded", "striped"])
def test_bitwise_heal_identity(mode: str, dtype_name: str) -> None:
    # every heal mode of both packages is bitwise the donor's state, and
    # the two packages heal the same bytes ("full_stream" is one rawleaves
    # stream in the port: it has no pickle stream)
    pstate, jstate = _port_state(dtype_name), _jax_state(dtype_name)
    pd, jd = cp.CheckpointServer(timeout=10.0), \
        jax_ckpt.CheckpointServer(timeout=10.0)
    ph, jh = _port_healer(mode, pstate), _jax_healer(mode, jstate)
    try:
        pd.send_checkpoint([1], step=3, state_dict=pstate, timeout=10.0)
        jd.send_checkpoint([1], step=3, state_dict=jstate, timeout=10.0)
        pgot = ph.recv_checkpoint(0, pd.metadata(), 3, 10.0)
        jgot = jh.recv_checkpoint(0, jd.metadata(), 3, 10.0)
        _assert_port_bitwise(pgot, pstate)
        for k in ("w", "b"):
            assert _bytes(pgot["params"][k]) == _bytes(jgot["params"][k])
        assert pgot["torchft"] == jgot["torchft"] == pstate["torchft"]
    finally:
        for s in (pd, jd, ph, jh):
            s.shutdown()


@pytest.mark.parametrize("n", [1, 2, 3, 7, 16, 1000, 1023, 4097])
def test_split_stripes_is_the_reference_grid(n: int) -> None:
    for count in (0, 1, 2, 3, 4, 5, 8, 17, n - 1, n, n + 1, 2 * n):
        got = split_stripes(n, count)
        assert got == jax_split_stripes(n, count), (n, count)
        assert got[0][0] == 0 and got[-1][1] == n
        assert all(a[1] == b[0] for a, b in zip(got, got[1:]))


def _half_sharded_reference_donors(step: int):
    """Two JAX-package donors, each holding half of the pieces of ``w``
    sharded over the 8 CPU devices (fsdp cuts its 32 columns into bands
    of 4; host A holds columns 0-16, host B 16-32), host A advertising
    host B as its peer (the reference's multi-host seam)."""
    import jax
    import jax.numpy as jnp

    from torchft_tpu.parallel import ft_mesh, shard_pytree

    w = np.random.default_rng(3).standard_normal((16, 32)).astype(np.float32)
    mesh = ft_mesh({"fsdp": 8}, devices=jax.devices()[:8])
    params = shard_pytree({"w": jnp.asarray(w)}, mesh, tp_rules=None,
                          fsdp_axis="fsdp")
    state = {"user": params, "torchft": {"step": step,
                                         "batches_committed": 2 * step}}
    host_a = jax_ckpt.CheckpointServer(timeout=10.0)
    host_b = jax_ckpt.CheckpointServer(timeout=10.0)
    host_a._shard_filter = lambda path, b: b[1][0] < 16
    host_b._shard_filter = lambda path, b: b[1][0] >= 16
    host_a.set_peers([host_b.metadata()])
    host_a.send_checkpoint([], step, state, 10.0)
    host_b.send_checkpoint([], step, state, 10.0)
    return w, host_a, host_b


def test_sharded_multi_donor_bitwise() -> None:
    # F7: a port healer with a template heals whole and bitwise from two
    # reference donors that each hold half of a leaf's pieces: the region
    # is split per piece and each piece fetched from the host that owns it
    # (the peer's manifest is pulled when the primary cannot cover it)
    w, host_a, host_b = _half_sharded_reference_donors(7)
    try:
        for host, cols in ((host_a, range(0, 16, 4)),
                           (host_b, range(16, 32, 4))):
            manifest = cp.fetch_manifest(host.metadata(), 7)
            (entry,) = [e for e in manifest["leaves"]
                        if e["kind"] == "ndarray"]
            assert [tuple(p) for p in entry["pieces"]] == \
                [((0, 16), (c, c + 4)) for c in cols]
        template = {"user": {"w": torch.empty(16, 32)},
                    "torchft": {"step": 0, "batches_committed": 0}}
        metrics = Metrics()
        got = cp.recv_checkpoint_sharded(host_a.metadata(), 7, template,
                                         timeout=10.0, metrics=metrics)
        assert _bytes(got["user"]["w"]) == w.tobytes()
        assert got["torchft"] == {"step": 7, "batches_committed": 14}
        assert metrics.snapshot()["heal_wire_bytes"] == w.nbytes
    finally:
        host_a.shutdown()
        host_b.shutdown()


def test_port_donors_route_each_leaf_to_its_holder() -> None:
    # two port donors, each holding one of the two leaves (the port's
    # _shard_filter seam): the healer fetches each from the host holding it
    state = _port_state("fp32")
    host_a, host_b = cp.CheckpointServer(timeout=10.0), \
        cp.CheckpointServer(timeout=10.0)
    metrics_a, metrics_b = Metrics(), Metrics()
    try:
        host_a.set_metrics(metrics_a)
        host_b.set_metrics(metrics_b)
        host_a._shard_filter = lambda path, b: path.endswith("['w']")
        host_b._shard_filter = lambda path, b: path.endswith("['b']")
        host_a.set_peers([host_a.metadata(), host_b.metadata()])
        assert host_a._peers == [host_b.metadata()]  # never itself
        host_a.send_checkpoint([], 4, state, 10.0)
        host_b.send_checkpoint([], 4, state, 10.0)
        got = cp.recv_checkpoint_sharded(host_a.metadata(), 4, state,
                                         timeout=10.0)
        _assert_port_bitwise(got, state)
        assert metrics_a.snapshot()["heal_served_bytes"] == 8192 * 4
        assert metrics_b.snapshot()["heal_served_bytes"] == 33 * 17 * 4
    finally:
        host_a.shutdown()
        host_b.shutdown()


def test_striped_heal_spreads_over_every_covering_host() -> None:
    # both donors hold the whole state: a striped region goes to both (the
    # peers are pulled to stripe), and the heal is bitwise
    state = _port_state("fp32")
    donors = [cp.CheckpointServer(timeout=10.0) for _ in range(2)]
    metrics = [Metrics(), Metrics()]
    try:
        for d, m in zip(donors, metrics):
            d.set_metrics(m)
        donors[0].set_peers([donors[1].metadata()])
        for d in donors:
            d.send_checkpoint([], 5, state, 10.0)
        got = cp.recv_checkpoint_sharded(donors[0].metadata(), 5, state,
                                         timeout=10.0, parallel=4,
                                         stripe_bytes=2048)
        _assert_port_bitwise(got, state)
        served = [m.snapshot().get("heal_served_bytes", 0) for m in metrics]
        assert all(s > 0 for s in served), served
        assert sum(served) == (8192 + 33 * 17) * 4
    finally:
        for d in donors:
            d.shutdown()


@pytest.mark.parametrize("sharded_template", [False, True])
def test_reference_healer_heals_from_a_port_donor(sharded_template) -> None:
    # F7, the reverse direction: the reference's recv_checkpoint_sharded
    # reads the port's manifest with plain pickle, zips its template with
    # the entries (same leaves, kinds and order) and fetches each region
    # (server-side slices when its template is sharded) from a port donor
    import jax
    import jax.numpy as jnp

    from tests.test_integration_hsdp import group_mesh, shard_group_params

    w = np.random.default_rng(5).standard_normal((16, 32)).astype(np.float32)
    b = np.random.default_rng(6).standard_normal(24).astype(np.float32)
    port_state = {"user": {"b": torch.from_numpy(b).to(torch.bfloat16),
                           "w": torch.from_numpy(w)},
                  "torchft": {"step": 6, "batches_committed": 12}}
    params = {"b": jnp.zeros(24, jnp.bfloat16), "w": jnp.zeros((16, 32))}
    if sharded_template:
        params = shard_group_params(params, group_mesh(1))
    template = {"user": params,
                "torchft": {"step": 0, "batches_committed": 0}}
    donor = cp.CheckpointServer(timeout=10.0)
    healer = jax_ckpt.CheckpointServer(timeout=10.0,
                                       template_fn=lambda: template)
    try:
        donor.send_checkpoint([], 6, port_state, 10.0)
        got = healer.recv_checkpoint(0, donor.metadata(), 6, 10.0)
        assert isinstance(got["user"]["w"], jax.Array)
        assert np.asarray(got["user"]["w"]).tobytes() == w.tobytes()
        assert np.asarray(got["user"]["b"]).tobytes() == \
            _bytes(port_state["user"]["b"])
        assert got["torchft"] == {"step": 6, "batches_committed": 12}
        if sharded_template:
            assert got["user"]["w"].sharding == params["w"].sharding
    finally:
        donor.shutdown()
        healer.shutdown()


def test_donor_death_mid_stream_retries_surviving_peer() -> None:
    # the primary serves its manifest, then dies; its manifest names a
    # survivor holding everything: the healer fails over and heals
    # bitwise. With no survivor the heal raises and returns nothing.
    state = {"w": torch.arange(2048, dtype=torch.float32),
             "b": torch.ones(7, 5)}
    survivor = cp.CheckpointServer(timeout=10.0)
    primary = cp.CheckpointServer(timeout=10.0)
    proxy = _DieAfterManifestProxy(primary.metadata())
    try:
        primary.set_peers([survivor.metadata()])
        primary.send_checkpoint([], 9, state, 10.0)
        survivor.send_checkpoint([], 9, state, 10.0)
        got = cp.recv_checkpoint_sharded(proxy.addr, 9, state, timeout=10.0,
                                         parallel=2)
        _assert_port_bitwise(got, state)
    finally:
        proxy.close()

    lonely = cp.CheckpointServer(timeout=10.0)
    proxy2 = _DieAfterManifestProxy(lonely.metadata())
    try:
        lonely.send_checkpoint([], 9, state, 10.0)
        with pytest.raises(ConnectionError, match="no surviving peer"):
            cp.recv_checkpoint_sharded(proxy2.addr, 9, state, timeout=5.0,
                                       parallel=2)
    finally:
        proxy2.close()
        for s in (lonely, primary, survivor):
            s.shutdown()


def test_corrupt_stripe_fails_over_and_counts(monkeypatch) -> None:
    # a payload that fails its CRC32C frame is a bad copy: the same bounds
    # come from the peer, and heal_checksum_errors counts it
    state = {"w": torch.arange(8192, dtype=torch.float32),
             "b": torch.ones(9, 5)}
    primary, survivor = cp.CheckpointServer(timeout=10.0), \
        cp.CheckpointServer(timeout=10.0)
    flips = [0]

    def _flip_once(chunk):
        if flips[0]:
            return chunk
        flips[0] = 1
        b = bytearray(chunk)
        b[len(b) // 2] ^= 0x01
        return bytes(b)

    metrics = Metrics()
    try:
        primary.set_peers([survivor.metadata()])
        primary.send_checkpoint([], 6, state, 10.0)
        survivor.send_checkpoint([], 6, state, 10.0)
        monkeypatch.setattr(cp, "_WIRE_FAULT_HOOK", _flip_once)
        got = cp.recv_checkpoint_sharded(primary.metadata(), 6, state,
                                         timeout=10.0, metrics=metrics)
        _assert_port_bitwise(got, state)
        assert flips[0] == 1
        assert metrics.snapshot().get("heal_checksum_errors") == 1.0
    finally:
        primary.shutdown()
        survivor.shutdown()


@pytest.mark.parametrize("path", ["chunked", "template"])
def test_wire_bf16_opt_in_roundtrip(path: str) -> None:
    # the opt-in lossy wire: bf16-exact values round trip exactly, the
    # healed dtype stays the leaf's (f32), the wire moves half the bytes,
    # and the bytes match the reference's bf16 wire from either donor
    w = np.arange(256, dtype=np.float32)  # exact in bf16
    state = {"w": torch.from_numpy(w.copy())}
    donor = cp.CheckpointServer(timeout=10.0)
    kw = {"template_fn": lambda: state} if path == "template" else {}
    healer = cp.CheckpointServer(timeout=10.0, num_chunks=2,
                                 heal_wire_dtype="bf16", **kw)
    metrics = Metrics()
    healer.set_metrics(metrics)
    jdonor = jax_ckpt.CheckpointServer(timeout=10.0)
    try:
        donor.send_checkpoint([], 5, state, 10.0)
        got = healer.recv_checkpoint(0, donor.metadata(), 5, 10.0)
        assert got["w"].dtype == torch.float32
        assert _bytes(got["w"]) == w.tobytes()
        assert metrics.snapshot()["heal_wire_bytes"] == \
            w.size * 2 + (4 if cp._WIRE_CRC else 0) * (path == "chunked")
        leaf = cp.fetch_leaf(donor.metadata(), 5, 0, wire_dtype="bf16")
        assert leaf.dtype == torch.float32 and _bytes(leaf) == w.tobytes()
        # across packages: the reference healer reads the port's bf16
        # wire, the port healer the reference's
        jax_leaf = jax_ckpt.fetch_leaf(donor.metadata(), 5, 0,
                                       wire_dtype="bf16")
        assert jax_leaf.dtype == np.float32 and jax_leaf.tobytes() == \
            w.tobytes()
        import jax.numpy as jnp

        jdonor.send_checkpoint([], 5, {"w": jnp.asarray(w)}, 10.0)
        port_leaf = cp.fetch_leaf(jdonor.metadata(), 5, 0, wire_dtype="bf16")
        assert port_leaf.tobytes() == w.tobytes()
    finally:
        for s in (donor, healer, jdonor):
            s.shutdown()


def test_unknown_wire_dtype_rejected() -> None:
    with pytest.raises(ValueError, match="heal_wire_dtype"):
        cp.CheckpointServer(timeout=1.0, heal_wire_dtype="fp4")
    with pytest.raises(ValueError, match="heal_wire_dtype"):
        jax_ckpt.CheckpointServer(timeout=1.0, heal_wire_dtype="fp4")
    donor = cp.CheckpointServer(timeout=5.0)
    try:
        donor.send_checkpoint([], 1, {"w": torch.ones(4)}, 5.0)
        for what in ("leaf/0", "rawleaves/0-1"):
            with pytest.raises(urllib.error.HTTPError) as exc:
                urllib.request.urlopen(
                    f"{donor.metadata()}/checkpoint/1/{what}?wire=fp4",
                    timeout=5)
            assert exc.value.code == 400
            assert "unknown wire dtype" in exc.value.read().decode()
    finally:
        donor.shutdown()


@pytest.mark.parametrize("mode", ["mismatch", "short"])
def test_fetch_leaf_bounded_and_prescriptive(mode: str) -> None:
    # a donor advertising a Content-Length its dtype and shape contradict,
    # or cutting the body short: both packages refuse with a prescriptive
    # ConnectionError, never a shape crash downstream
    srv = ThreadingHTTPServer(("127.0.0.1", 0), _LyingHandler)
    _LyingHandler.mode = mode
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    addr = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        for fetch in (cp.fetch_leaf, jax_ckpt.fetch_leaf):
            with pytest.raises(ConnectionError) as exc_info:
                fetch(addr, 1, 0, timeout=5.0, crc=False)
            msg = str(exc_info.value)
            if mode == "mismatch":
                assert "Content-Length" in msg and "version skew" in msg
            else:
                assert "truncated" in msg
    finally:
        srv.shutdown()
        srv.server_close()


@pytest.mark.parametrize("path", ["chunked", "template"])
def test_heal_metrics_surface(path: str) -> None:
    # a heal lands the donor's heal_stage span and served bytes, and the
    # healer's heal_wire span, heal_wall_ms and heal_bytes_per_s
    state = {"w": torch.arange(4096, dtype=torch.float32)}
    donor = cp.CheckpointServer(timeout=10.0)
    kw = {"template_fn": lambda: state} if path == "template" else {}
    healer = cp.CheckpointServer(timeout=10.0, num_chunks=2, **kw)
    donor_metrics, healer_metrics = Metrics(), Metrics()
    donor.set_metrics(donor_metrics)
    healer.set_metrics(healer_metrics)
    try:
        donor.send_checkpoint([], 6, state, 10.0)
        got = healer.recv_checkpoint(0, donor.metadata(), 6, 10.0)
        assert torch.equal(got["w"], state["w"])
        donor.disallow_checkpoint()  # finishes the staging
        d, h = donor_metrics.snapshot(), healer_metrics.snapshot()
        assert d.get("heal_stage_avg_ms", -1) >= 0.0, sorted(d)
        assert d["heal_served_bytes"] == 4096 * 4
        assert h.get("heal_wire_avg_ms", -1) >= 0.0, sorted(h)
        assert h.get("heal_wall_ms", -1) > 0.0, sorted(h)
        assert h.get("heal_bytes_per_s", -1) > 0.0, sorted(h)
        for v in (h["heal_wall_ms"], h["heal_bytes_per_s"]):
            assert np.isfinite(v)
    finally:
        donor.shutdown()
        healer.shutdown()


@pytest.mark.parametrize("kind", ["tensor", "ndarray"])
def test_striped_fetch_into_out_buffer(kind: str) -> None:
    # readinto: a fetch lands in the caller's buffer (a tensor or an
    # array, a region of it too); a buffer of another shape or dtype, or
    # one that is not contiguous, fails loudly
    w = np.arange(1024, dtype=np.float32)
    donor = cp.CheckpointServer(timeout=10.0)

    def make(shape, dtype=np.float32):
        a = np.empty(shape, dtype)
        return torch.from_numpy(a) if kind == "tensor" else a

    try:
        donor.send_checkpoint([], 8, {"w": torch.from_numpy(w.copy())}, 10.0)
        out = make(1024)
        got = cp.fetch_leaf(donor.metadata(), 8, 0, out=out)
        assert got is out and _bytes(out) == w.tobytes()
        region = make(100)
        cp.fetch_leaf(donor.metadata(), 8, 0, slices=(slice(200, 300),),
                      out=region)
        assert _bytes(region) == w[200:300].tobytes()
        with pytest.raises(ValueError, match="does not match"):
            cp.fetch_leaf(donor.metadata(), 8, 0, out=make(7))
        with pytest.raises(ValueError, match="does not match"):
            cp.fetch_leaf(donor.metadata(), 8, 0, out=make(1024, np.int32))
        with pytest.raises(ValueError, match="contiguous"):
            cp.fetch_leaf(donor.metadata(), 8, 0, out=make((1024, 2))[:, 0])
    finally:
        donor.shutdown()


@pytest.mark.parametrize("path", ["chunked", "template"])
def test_empty_leaves_heal(path: str) -> None:
    # a leaf with no elements (an empty optimizer slot) is held by every
    # host and heals as an empty tensor on either path
    state = {"e": torch.empty(0), "w": torch.ones(3, 2),
             "z": torch.zeros(0, 4, dtype=torch.bfloat16)}
    donor = cp.CheckpointServer(timeout=10.0)
    kw = {"template_fn": lambda: state} if path == "template" else {}
    healer = cp.CheckpointServer(timeout=10.0, **kw)
    try:
        donor.send_checkpoint([], 1, state, 10.0)
        _assert_port_bitwise(healer.recv_checkpoint(0, donor.metadata(), 1,
                                                    10.0), state)
        assert cp.fetch_leaf(donor.metadata(), 1, 0).shape == (0,)
    finally:
        donor.shutdown()
        healer.shutdown()


def test_template_must_match_the_donor() -> None:
    # structure, shape and dtype skew fail loudly before any tensor moves
    state = _port_state("fp32")
    donor = cp.CheckpointServer(timeout=10.0)
    try:
        donor.send_checkpoint([], 2, state, 10.0)
        cases = [
            ({"params": {"w": torch.empty(8192)},
              "torchft": state["torchft"]}, "structure"),
            ({**state, "params": {**state["params"],
                                  "v": state["params"]["w"]}}, "structure"),
            ({**state, "params": {"w": torch.empty(8191),
                                  "b": state["params"]["b"]}}, "shape"),
            ({**state, "params": {"w": torch.empty(8192, dtype=torch.float16),
                                  "b": state["params"]["b"]}}, "dtype"),
            ({**state, "params": {"w": torch.empty(8192),
                                  "x": state["params"]["b"]}}, "path"),
        ]
        for template, what in cases:
            with pytest.raises(ValueError, match=what):
                cp.recv_checkpoint_sharded(donor.metadata(), 2, template,
                                           timeout=5.0)
    finally:
        donor.shutdown()


class _PeerRecorder:
    """A checkpoint transport recording the donor events a Manager hands
    it: the peers it was given and the steps it staged."""

    def __init__(self) -> None:
        self.peers, self.sent = [], []

    def metadata(self) -> str:
        return "http://self:1"

    def set_peers(self, peers) -> None:
        self.peers.append(list(peers))

    def send_checkpoint(self, dst_ranks, step, state_dict, timeout) -> None:
        self.sent.append(step)

    def disallow_checkpoint(self) -> None:
        pass

    def recv_checkpoint(self, src_rank, metadata, step, timeout):
        raise AssertionError("a donor never receives")

    def shutdown(self, wait: bool = True) -> None:
        pass


@pytest.mark.parametrize("pkg", ["torch", "jax"])
def test_donor_reads_its_peers_at_every_donor_event(pkg: str) -> None:
    # both packages' Managers, rank 0 of a group of 2: every donor event
    # reads the other ranks' checkpoint addresses from the group store and
    # hands them to set_peers; a missing address only logs (the checkpoint
    # is still staged), and a restarted peer's new address is read at the
    # next event
    from tests.test_torch_manager import _mocked_manager, _quorum
    from torchft_tpu_torch.comm.store import StoreClient, StoreServer

    store, transport = StoreServer(), _PeerRecorder()
    m = None
    try:
        m, client, _, _ = _mocked_manager(pkg, store, world_size=2,
                                          checkpoint_transport=transport,
                                          connect_timeout=0.3)
        client.quorum.return_value = _quorum(
            pkg, max_step=5, recover_dst_ranks=[1], transport_rank=0,
            transport_world_size=2, transport_replica_ids=["a", "b"])
        m.start_quorum()
        m.wait_quorum()
        assert transport.peers == [] and transport.sent == [5]
        writer = StoreClient(store.addr)
        for addr in ("http://peer:1", "http://peer:2"):
            writer.set("checkpoint_addr_1", addr)
            m.start_quorum()
            m.wait_quorum()
            assert transport.peers[-1] == [addr]
        assert transport.sent == [5, 5, 5]
    finally:
        if m is not None:
            m.shutdown(wait=False)
        store.shutdown()
