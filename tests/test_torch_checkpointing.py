"""The port's heal plane: torch state dicts over the raw-leaves wire.

Twin of the default-plane cases of tests/test_checkpointing.py and
tests/test_crc32c.py: round trip (bitwise, dtypes and structure kept),
wrong step -> 400, the gate blocks until staged, CRC32C frames catch a
flipped bit, and a healed optimizer steps bitwise like its donor. On host
(numpy) state, each case on a server of each package, which must deliver
the same: a large state, a chunked heal of numpy scalars and a 0-d array,
a leaf sliced by the donor (and a slice outside it refused), writable
healed leaves, and an ml_dtypes bfloat16 leaf.
"""

import io
import struct
import threading
import time
import urllib.error

import numpy as np
import pytest
import torch

from torchft_tpu.utils.crc32c import crc32c as jax_crc32c
from torchft_tpu_torch import checkpointing as cp
from torchft_tpu_torch.utils.crc32c import crc32c
from torchft_tpu_torch.utils.serialization import (
    is_tensor_leaf,
    pytree_from_bytes,
    pytree_from_stream,
    pytree_to_bytes,
    pytree_to_stream,
    tree_flatten_with_path,
    tree_unflatten,
)


def _state():
    gen = torch.Generator().manual_seed(0)
    return {
        "model": {"w": torch.randn(64, 33, generator=gen),
                  "b": torch.randn(7, generator=gen).to(torch.bfloat16)},
        "optim": {"state": {0: {"step": torch.tensor(3.0),
                                "exp_avg": torch.randn(5, generator=gen)}},
                  "param_groups": [{"lr": 3e-4, "params": [0],
                                    "betas": (0.9, 0.999)}]},
        "sampler": {"epoch": 1, "pos": 17},
        "ids": torch.arange(10),
        "host": np.linspace(0, 1, 9, dtype=np.float32),
        "misc": [None, "label", (1, 2)],
    }


def _assert_same(a, b) -> None:
    if isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and b.device.type == "cpu"
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    elif isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _assert_same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    else:
        assert a == b


def test_flatten_roundtrip() -> None:
    state = _state()
    flat, spec = tree_flatten_with_path(state)
    leaves = [leaf for _, leaf in flat]
    assert sum(is_tensor_leaf(leaf) for leaf in leaves) == 6
    _assert_same(state, tree_unflatten(spec, leaves))


@pytest.mark.parametrize("num_chunks", [0, 1, 2, 3])
def test_checkpoint_roundtrip_bitwise(num_chunks) -> None:
    server = cp.CheckpointServer(timeout=5.0, num_chunks=num_chunks)
    try:
        state = {"user": _state(), "torchft": {"step": 3,
                                               "batches_committed": 6}}
        server.send_checkpoint([1], step=3, state_dict=state, timeout=5.0)
        got = server.recv_checkpoint(0, server.metadata(), 3, 5.0)
        _assert_same(state, got)
        server.disallow_checkpoint()
    finally:
        server.shutdown()


def test_wrong_step_is_400() -> None:
    server = cp.CheckpointServer(timeout=5.0)
    try:
        server.send_checkpoint([1], 3, {"x": torch.ones(2)}, 5.0)
        with pytest.raises(urllib.error.HTTPError) as exc:
            server.recv_checkpoint(0, server.metadata(), 99, 5.0)
        assert exc.value.code == 400
    finally:
        server.shutdown()


def test_gate_blocks_until_staged_then_closes() -> None:
    server = cp.CheckpointServer(timeout=3.0)
    results = {}

    def _fetch():
        results["state"] = server.recv_checkpoint(0, server.metadata(), 5,
                                                  10.0)

    try:
        t = threading.Thread(target=_fetch)
        t.start()
        time.sleep(0.2)
        assert "state" not in results  # waiting on the gate
        server.send_checkpoint([1], 5, {"w": torch.full((3,), 2.0)}, 5.0)
        t.join(timeout=10)
        assert torch.equal(results["state"]["w"], torch.full((3,), 2.0))
        server.disallow_checkpoint()
        with pytest.raises(urllib.error.HTTPError) as exc:
            server.recv_checkpoint(0, server.metadata(), 5, 5.0)
        assert exc.value.code == 503  # gate closed: times out
    finally:
        server.shutdown()


def test_fetch_leaf_and_manifest() -> None:
    server = cp.CheckpointServer(timeout=5.0)
    try:
        state = _state()
        server.send_checkpoint([1], 2, state, 5.0)
        manifest = cp.fetch_manifest(server.metadata(), 2)
        # the JAX package's flattening order: dict keys sorted, None no
        # leaf; dtypes by numpy's names, torch leaves marked as tensors
        tensors = [(e["path"], e["dtype"], e["tensor"])
                   for e in manifest["leaves"] if e["kind"] == "ndarray"]
        assert tensors == [
            ("['host']", "float32", False), ("['ids']", "int64", True),
            ("['model']['b']", "bfloat16", True),
            ("['model']['w']", "float32", True),
            ("['optim']['state'][0]['exp_avg']", "float32", True),
            ("['optim']['state'][0]['step']", "float32", True)]
        index = {e["path"]: i for i, e in enumerate(manifest["leaves"])}
        leaf = cp.fetch_leaf(server.metadata(), 2, index["['model']['b']"])
        assert torch.equal(leaf, state["model"]["b"])
        host = cp.fetch_leaf(server.metadata(), 2, index["['host']"])
        assert np.array_equal(host, state["host"])
        lr = cp.fetch_leaf(server.metadata(), 2,
                           index["['optim']['param_groups'][0]['lr']"])
        assert lr == 3e-4
    finally:
        server.shutdown()


def test_crc_frame_catches_flipped_bit() -> None:
    data = np.arange(16, dtype=np.float32)
    entry = {"dtype": "float32", "shape": (16,)}
    body = data.tobytes()
    frame = body + struct.pack("<I", crc32c(body))
    got = cp._read_leaf(io.BytesIO(frame), entry, "leaf", True)
    assert np.array_equal(got, data)
    bad = bytearray(frame)
    bad[5] ^= 0x10
    with pytest.raises(cp.ChecksumError):
        cp._read_leaf(io.BytesIO(bytes(bad)), entry, "leaf", True)
    with pytest.raises(ConnectionError, match="truncated"):
        cp._read_leaf(io.BytesIO(frame[:-9]), entry, "leaf", True)


def test_crc32c_matches_reference() -> None:
    assert crc32c(b"123456789") == 0xE3069283
    blob = np.random.default_rng(0).integers(0, 256, 100_003,
                                             dtype=np.uint8).tobytes()
    assert crc32c(blob) == jax_crc32c(blob)
    assert crc32c(blob[50:], crc32c(blob[:50])) == jax_crc32c(blob)


def test_byte_ranges_cover_every_leaf() -> None:
    entries = [{"nbytes": n} for n in (10, 500, 3, 3, 400, 90, 1)]
    for parts in (1, 2, 3, 10):
        ranges = cp._byte_ranges(entries, parts)
        assert ranges[0][0] == 0 and ranges[-1][1] == len(entries)
        assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
        assert len(ranges) <= parts


def test_healed_optimizer_steps_bitwise_like_donor() -> None:
    torch.manual_seed(0)
    donor = torch.nn.Linear(8, 4)
    opt = torch.optim.AdamW(donor.parameters(), lr=3e-4, weight_decay=1e-4)
    for _ in range(3):
        opt.zero_grad()
        donor(torch.randn(5, 8)).square().sum().backward()
        opt.step()
    server = cp.CheckpointServer(timeout=5.0)
    try:
        server.send_checkpoint([1], 3, {"model": donor.state_dict(),
                                        "optim": opt.state_dict()}, 5.0)
        got = server.recv_checkpoint(0, server.metadata(), 3, 5.0)
    finally:
        server.shutdown()
    healed = torch.nn.Linear(8, 4)
    healed_opt = torch.optim.AdamW(healed.parameters(), lr=1.0)
    healed.load_state_dict(got["model"])
    healed_opt.load_state_dict(got["optim"])
    grads = [torch.randn_like(p) for p in donor.parameters()]
    for model, o in ((donor, opt), (healed, healed_opt)):
        for p, g in zip(model.parameters(), grads):
            p.grad = g.clone()
        o.step()
    for a, b in zip(donor.parameters(), healed.parameters()):
        assert torch.equal(a, b)


def test_server_listens_with_the_full_backlog(monkeypatch) -> None:
    # the backlog is set at bind: a value assigned to the server after it
    # bound never reached listen(), and 16 concurrent fetches (4 adopters x
    # 4 connections) overflowed the default 5, each dropped SYN a 1 s
    # retransmit
    import socket

    seen = []
    real = socket.socket.listen

    def listen(self, *args):
        seen.extend(args)
        return real(self, *args)

    monkeypatch.setattr(socket.socket, "listen", listen)
    server = cp.CheckpointServer(timeout=5.0)
    server.shutdown()
    assert seen == [1024]


# --- numpy state over both packages' servers ----------------------------------
# Twins of tests/test_checkpointing.py's cases on host (numpy) state: each
# runs on a server of each package and the two must deliver the same.


def _jax_cp():
    import torchft_tpu.checkpointing as jcp

    return jcp


def _by_key(tree):
    """``tree`` with every dict's keys sorted. The port rebuilds a dict in
    the donor's key order (a torch state_dict's order is its module's);
    the JAX package sorts them, as jax's pytrees do."""
    if isinstance(tree, dict):
        return {k: _by_key(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_by_key(x) for x in tree)
    return tree


def _each_package(run):
    """``run(checkpointing_module)`` for the port and the JAX package;
    assert both returned the same, dicts compared by key, and return the
    port's."""
    got = [run(cp), run(_jax_cp())]
    _assert_same(_by_key(got[0]), _by_key(got[1]))
    return got[0]


def test_large_state_roundtrip() -> None:
    big = {"params": [np.random.default_rng(0).random(1 << 20)
                      for _ in range(4)]}

    def run(ck):
        server = ck.CheckpointServer(timeout=30.0, num_chunks=2)
        try:
            server.send_checkpoint([1], step=1, state_dict=big, timeout=30.0)
            return server.recv_checkpoint(0, server.metadata(), 1, 30.0)
        finally:
            server.shutdown()

    _assert_same(big, _each_package(run))


def test_chunked_recv_matches_full() -> None:
    # four connections reassemble the tree: numpy scalars, a 0-d array,
    # a half-precision leaf and plain ints, each as it was
    state = {
        "params": {"w": np.arange(24, dtype=np.float32).reshape(4, 6),
                   "b": np.ones((6,), dtype=np.float16)},
        "scalars": {"count": np.float64(7.0), "step_arr": np.array(3)},
        "torchft": {"step": 3, "batches_committed": 6},
    }

    def run(ck):
        donor = ck.CheckpointServer(timeout=5.0)
        healer = ck.CheckpointServer(timeout=5.0, num_chunks=4)
        try:
            donor.send_checkpoint([1], step=3, state_dict=state, timeout=5.0)
            got = healer.recv_checkpoint(0, donor.metadata(), 3, 5.0)
            return {"params": got["params"], "torchft": got["torchft"],
                    "scalars": {k: (type(v).__name__, np.asarray(v).dtype.str,
                                    np.asarray(v).shape, float(v))
                                for k, v in got["scalars"].items()}}
        finally:
            donor.shutdown()
            healer.shutdown()

    got = _each_package(run)
    for k, v in state["params"].items():
        _assert_same(v, got["params"][k])
    assert got["torchft"] == {"step": 3, "batches_committed": 6}
    assert got["scalars"]["count"][3] == 7.0
    assert got["scalars"]["step_arr"][2:] == ((), 3.0)


def test_leaf_fetch_with_slice() -> None:
    # a healer pulls one region of a leaf, sliced by the donor; a slice
    # outside the leaf is a 400 (test_leaf_fetch_bad_slice_is_400), and
    # the leaves a chunked heal and a leaf fetch return are writable
    # (test_chunked_leaves_writable_and_int_avg_rejected)
    w = np.arange(64, dtype=np.float32).reshape(8, 8)

    def run(ck):
        donor = ck.CheckpointServer(timeout=5.0)
        healer = ck.CheckpointServer(timeout=5.0, num_chunks=2)
        try:
            donor.send_checkpoint([1], step=5, state_dict={"w": w},
                                  timeout=5.0)
            manifest = ck.fetch_manifest(donor.metadata(), 5)
            shard = ck.fetch_leaf(donor.metadata(), 5, 0,
                                  slices=(slice(2, 6), slice(None)))
            full = ck.fetch_leaf(donor.metadata(), 5, 0)
            with pytest.raises(urllib.error.HTTPError) as exc:
                ck.fetch_leaf(donor.metadata(), 5, 0, slices=(slice(0, 99),))
            assert exc.value.code == 400
            healed = healer.recv_checkpoint(0, donor.metadata(), 5, 5.0)
            healed["w"] += 1.0
            full += 1.0
            return ([(e["path"], tuple(e["shape"]))
                     for e in manifest["leaves"]], shard, full, healed["w"])
        finally:
            donor.shutdown()
            healer.shutdown()

    paths, shard, full, healed = _each_package(run)
    assert paths == [("['w']", (8, 8))]
    assert np.array_equal(shard, w[2:6, :])
    assert np.array_equal(full, w + 1.0) and np.array_equal(healed, w + 1.0)


def test_leaf_fetch_bfloat16() -> None:
    # an ml_dtypes bfloat16 array (no buffer protocol) is served as its
    # raw bytes
    import ml_dtypes

    w = np.arange(16, dtype=np.float32).astype(ml_dtypes.bfloat16)

    def run(ck):
        donor = ck.CheckpointServer(timeout=5.0)
        try:
            donor.send_checkpoint([1], step=1, state_dict={"w": w},
                                  timeout=5.0)
            got = ck.fetch_leaf(donor.metadata(), 1, 0)
            shard = ck.fetch_leaf(donor.metadata(), 1, 0,
                                  slices=(slice(4, 8),))
            return got.dtype.name, got.view(np.uint16), shard.view(np.uint16)
        finally:
            donor.shutdown()

    dtype, got, shard = _each_package(run)
    assert dtype == "bfloat16"
    assert np.array_equal(got, w.view(np.uint16))
    assert np.array_equal(shard, w[4:8].view(np.uint16))


# ------------------------------------------- the full stream (F29, was L1)


def test_serialization_roundtrip() -> None:
    # the reference's case on tensors: the stream carries the host tree
    # (a tensor arrives as a numpy array), builtins as they were
    tree = {
        "params": {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3)},
        "step": 7,
        "nested": [np.ones(2), "label", None],
    }
    out = pytree_from_bytes(pytree_to_bytes(tree))
    np.testing.assert_allclose(out["params"]["w"], np.arange(6).reshape(2, 3))
    assert isinstance(out["params"]["w"], np.ndarray)  # tensor -> host
    assert out["step"] == 7
    assert out["nested"][1] == "label" and out["nested"][2] is None
    buf = io.BytesIO()
    pytree_to_stream(tree, buf)
    buf.seek(0)
    again = pytree_from_stream(buf)
    assert again["params"]["w"].tobytes() == out["params"]["w"].tobytes()


def _plain_tree(kind: str):
    """One tree of plain containers in either form: tensors ("torch") or
    the same values as numpy ("numpy", bf16 as ml_dtypes'), with a 0-d
    leaf, ints, strings, None, a tuple, an OrderedDict and dict keys out
    of sorted order."""
    from collections import OrderedDict

    import ml_dtypes

    rng = np.random.default_rng(3)
    w = rng.standard_normal((4, 5)).astype(np.float32)
    b = rng.standard_normal(7).astype(ml_dtypes.bfloat16)
    ids = np.arange(6, dtype=np.int64)
    s = np.asarray(1.25, np.float32)
    if kind == "torch":
        w, ids, s = torch.from_numpy(w), torch.from_numpy(ids), \
            torch.from_numpy(s)
        b = torch.from_numpy(b.view(np.int16)).view(torch.bfloat16)
    return {"z": {"w": w, "b": b}, "a": [ids, s, None, "label", 3, 2.5],
            "t": (1, (s, "x")),
            "od": OrderedDict([("y", w), ("x", 4)]),
            "step": 9}


def test_pytree_bytes_equal_the_reference() -> None:
    from torchft_tpu.utils.serialization import (
        pytree_to_bytes as jax_pytree_to_bytes)

    got = pytree_to_bytes(_plain_tree("torch"))
    assert got == jax_pytree_to_bytes(_plain_tree("numpy"))
    # and the reference reads it as its own
    back = pytree_from_bytes(got)
    assert list(back) == ["a", "od", "step", "t", "z"]
    assert list(back["od"]) == ["y", "x"]
    assert back["z"]["b"].dtype.name == "bfloat16"
    assert back["a"][1].shape == () and back["a"][2] is None


def _leaves_bits(tree) -> list:
    out = []
    for path, x in tree_flatten_with_path(tree)[0]:
        if isinstance(x, torch.Tensor):
            from torchft_tpu_torch.utils.serialization import to_numpy
            x = to_numpy(x)
        if isinstance(x, np.ndarray):
            out.append((path, x.dtype.name, x.shape, x.tobytes()))
        else:
            out.append((path, x))
    return out


def test_full_stream_heals_across_packages() -> None:
    # a reference healer on its default full stream heals from a port
    # donor, and a port healer with num_chunks=0 from a reference donor
    # (plain containers and arrays), both bitwise
    jcp = _jax_cp()
    pstate, jstate = _plain_tree("torch"), _plain_tree("numpy")
    pd, jd = cp.CheckpointServer(timeout=5.0), jcp.CheckpointServer(
        timeout=5.0)
    jh = jcp.CheckpointServer(timeout=5.0)  # num_chunks=0, its default
    ph = cp.CheckpointServer(timeout=5.0, num_chunks=0)
    try:
        pd.send_checkpoint([1], step=4, state_dict=pstate, timeout=5.0)
        jd.send_checkpoint([1], step=4, state_dict=jstate, timeout=5.0)
        from_port = jh.recv_checkpoint(0, pd.metadata(), 4, 5.0)
        from_jax = ph.recv_checkpoint(0, jd.metadata(), 4, 5.0)
    finally:
        for s in (pd, jd, jh, ph):
            s.shutdown()
    want = _leaves_bits(jstate)
    assert _leaves_bits(from_port) == want
    assert _leaves_bits(from_jax) == want
    # a JAX donor's state comes as it was pickled: numpy leaves, dicts
    # sorted as jax rebuilds them
    assert list(from_jax) == sorted(from_jax)
    assert isinstance(from_jax["z"]["w"], np.ndarray)


def test_full_stream_equals_the_chunked_heal() -> None:
    # from a port donor the full stream returns exactly what the chunked
    # heal returns: tensors on the CPU, numpy leaves, the donor's key order
    state = {"user": _state(), "torchft": {"step": 3,
                                           "batches_committed": 6}}
    donor = cp.CheckpointServer(timeout=5.0)
    healers = [cp.CheckpointServer(timeout=5.0, num_chunks=n)
               for n in (0, 2)]
    try:
        donor.send_checkpoint([1], step=3, state_dict=state, timeout=5.0)
        stream, chunked = (h.recv_checkpoint(0, donor.metadata(), 3, 5.0)
                           for h in healers)
        _assert_same(chunked, stream)
        _assert_same(state, stream)
        with pytest.raises(ValueError, match="num_chunks"):
            cp.CheckpointServer(num_chunks=-1)
        with pytest.raises(ValueError, match="defer_paths"):
            cp.CheckpointServer(num_chunks=0, defer_paths=r"(\d+)/(\d+)")
    finally:
        for s in [donor] + healers:
            s.shutdown()
