"""The port's last public names of the heal wire, each against the reference.

Twins of tests/test_crc32c.py's ``test_combine`` and of its two wire-frame
tests' counters (``wire_crc_stats``), and of tests/test_heal_plane.py's
``test_donor_zero_copy_serve`` (``serve_copy_stats``): the same scenario
runs through both packages and the counters must be equal. Plus
``crc32c_combine`` bitwise against ``crc32c(a + b)``, and the reference's
test conveniences ``CheckpointServer.allow_checkpoint``/``address``.
"""

import numpy as np
import pytest
import torch

from torchft_tpu import checkpointing as JCP
from torchft_tpu.utils import crc32c as JC
from torchft_tpu_torch import checkpointing as CP
from torchft_tpu_torch.utils import crc32c as C
from torchft_tpu_torch.utils.metrics import Metrics


def _flip(chunk):
    b = bytearray(chunk)
    b[len(b) // 2] ^= 0x01
    return bytes(b)


def test_combine() -> None:
    rng = np.random.default_rng(1)
    a = rng.integers(0, 256, 3000, dtype=np.uint8).tobytes()
    b = rng.integers(0, 256, 5000, dtype=np.uint8).tobytes()
    got = C.crc32c_combine(C.crc32c(a), C.crc32c(b), len(b))
    assert got == C.crc32c(a + b)
    assert got == JC.crc32c_combine(JC.crc32c(a), JC.crc32c(b), len(b))
    assert C.crc32c_combine(C.crc32c(a), 0, 0) == C.crc32c(a)


@pytest.mark.parametrize("len2", [1, 2, 3, 7, 8, 9, 255, 4096, 65537])
def test_combine_bitwise_at_every_length(len2: int) -> None:
    rng = np.random.default_rng(len2)
    a = rng.integers(0, 256, 777, dtype=np.uint8).tobytes()
    b = rng.integers(0, 256, len2, dtype=np.uint8).tobytes()
    crc_a = C.crc32c(a)
    assert C.crc32c_combine(crc_a, C.crc32c(b), len2) == C.crc32c(a + b)
    assert C.crc32c_combine(crc_a, C.crc32c(b), len2) == \
        JC.crc32c_combine(crc_a, JC.crc32c(b), len2)


def _flip_fetch(pkg, monkeypatch, state, leaf: int):
    """tests/test_crc32c.py's flip scenario through ``pkg``: a clean fetch,
    then one through a flipping wire; the counters after each."""
    donor = pkg.CheckpointServer(timeout=10.0)
    try:
        donor.send_checkpoint([], 4, state, 10.0)
        pkg.wire_crc_stats(reset=True)
        pkg.fetch_leaf(donor.metadata(), 4, leaf, timeout=10.0)
        clean = pkg.wire_crc_stats()
        monkeypatch.setattr(pkg, "_WIRE_FAULT_HOOK", _flip)
        with pytest.raises(pkg.ChecksumError):
            pkg.fetch_leaf(donor.metadata(), 4, leaf, timeout=10.0)
        monkeypatch.setattr(pkg, "_WIRE_FAULT_HOOK", None)
        return clean, pkg.wire_crc_stats()
    finally:
        donor.shutdown()


def test_fetch_leaf_crc_flip_is_counted_as_in_reference(monkeypatch) -> None:
    import jax.numpy as jnp

    port = _flip_fetch(CP, monkeypatch,
                       {"w": torch.arange(4096, dtype=torch.float32)}, 0)
    ref = _flip_fetch(JCP, monkeypatch,
                      {"w": jnp.arange(4096, dtype=jnp.float32)}, 0)
    assert port == ref
    clean, flipped = port
    assert clean == {"frames_checked": 1, "checksum_errors": 0}
    assert flipped == {"frames_checked": 2, "checksum_errors": 1}


def _failover(pkg, monkeypatch, state, template):
    primary = pkg.CheckpointServer(timeout=10.0)
    survivor = pkg.CheckpointServer(timeout=10.0)
    flips = [0]

    def _flip_once(chunk):
        if flips[0]:
            return chunk
        flips[0] = 1
        return _flip(chunk)

    metrics = Metrics()
    try:
        primary._peers = [survivor.metadata()]
        primary.send_checkpoint([], 6, state, 10.0)
        survivor.send_checkpoint([], 6, state, 10.0)
        pkg.wire_crc_stats(reset=True)
        monkeypatch.setattr(pkg, "_WIRE_FAULT_HOOK", _flip_once)
        got = pkg.recv_checkpoint_sharded(primary.metadata(), 6, template,
                                          timeout=10.0, metrics=metrics)
        monkeypatch.setattr(pkg, "_WIRE_FAULT_HOOK", None)
        assert flips[0] == 1
        assert metrics.snapshot().get("heal_checksum_errors") == 1.0
        return got, pkg.wire_crc_stats()
    finally:
        primary.shutdown()
        survivor.shutdown()


def test_crc_flip_failover_counters_match_reference(monkeypatch) -> None:
    import jax.numpy as jnp

    port_state = {"w": torch.arange(8192, dtype=torch.float32),
                  "b": torch.ones(9, 5)}
    ref_state = {"w": jnp.arange(8192, dtype=jnp.float32),
                 "b": jnp.ones((9, 5), jnp.float32)}
    got, port = _failover(CP, monkeypatch, port_state, port_state)
    assert all(torch.equal(got[k], port_state[k]) for k in port_state)
    _, ref = _failover(JCP, monkeypatch, ref_state, ref_state)
    assert port["checksum_errors"] == ref["checksum_errors"] == 1
    assert port["frames_checked"] > port["checksum_errors"]
    assert ref["frames_checked"] > ref["checksum_errors"]


def _zero_copy(pkg, state):
    donor = pkg.CheckpointServer(timeout=10.0)
    try:
        donor.send_checkpoint([], 1, state, 10.0)
        donor._staged.finish_staging(10.0)
        pkg.serve_copy_stats(reset=True)
        got_h = pkg.fetch_leaf(donor.metadata(), 1, 0)
        got_w = pkg.fetch_leaf(donor.metadata(), 1, 1)
        np.testing.assert_array_equal(np.asarray(got_h), state["host"])
        return np.asarray(got_w), pkg.serve_copy_stats()
    finally:
        donor.shutdown()


def test_donor_zero_copy_serve_as_in_reference() -> None:
    import jax.numpy as jnp

    host = np.arange(512, dtype=np.float64)
    w_port, port = _zero_copy(
        CP, {"w": torch.arange(4096, dtype=torch.float32), "host": host})
    w_ref, ref = _zero_copy(
        JCP, {"w": jnp.arange(4096, dtype=jnp.float32), "host": host})
    assert w_port.tobytes() == w_ref.tobytes()
    assert port == ref == {"zero_copy_serves": 2, "full_array_copies": 0}


def test_a_region_that_is_not_contiguous_counts_one_copy() -> None:
    state = {"w": torch.arange(64, dtype=torch.float32).reshape(8, 8)}
    donor = CP.CheckpointServer(timeout=10.0)
    try:
        donor.send_checkpoint([], 1, state, 10.0)
        donor._staged.finish_staging(10.0)
        CP.serve_copy_stats(reset=True)
        got = CP.fetch_leaf(donor.metadata(), 1, 0,
                            slices=(slice(0, 8), slice(2, 5)))
        assert torch.equal(torch.as_tensor(got), state["w"][:, 2:5])
        assert CP.serve_copy_stats() == {"zero_copy_serves": 0,
                                         "full_array_copies": 1}
    finally:
        donor.shutdown()


def test_allow_checkpoint_and_address_pre_seed_a_donor() -> None:
    state = {"w": torch.linspace(-1, 1, 33)}
    donor = CP.CheckpointServer(timeout=10.0)
    try:
        assert donor.address() == donor.metadata()
        donor.allow_checkpoint(3, state)
        got = CP.fetch_leaf(donor.address(), 3, 0, timeout=10.0)
        assert torch.equal(torch.as_tensor(got), state["w"])
        # a reference healer reads the pre-seeded port donor
        ref = JCP.fetch_leaf(donor.address(), 3, 0, timeout=10.0)
        assert ref.tobytes() == state["w"].numpy().tobytes()
    finally:
        donor.shutdown()
