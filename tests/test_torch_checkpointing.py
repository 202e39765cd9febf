"""The port's heal plane: torch state dicts over the raw-leaves wire.

Twin of the default-plane cases of tests/test_checkpointing.py and
tests/test_crc32c.py: round trip (bitwise, dtypes and structure kept),
wrong step -> 400, the gate blocks until staged, CRC32C frames catch a
flipped bit, and a healed optimizer steps bitwise like its donor.
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


@pytest.mark.parametrize("num_chunks", [1, 2, 3])
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
