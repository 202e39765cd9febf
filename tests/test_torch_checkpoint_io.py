"""The port's durable checkpoints against the JAX package's.

Twins of every test in tests/test_checkpoint_io.py. Each scenario runs
through both packages' ``AsyncCheckpointWriter`` (torch tensors into the
port's, JAX arrays into the reference's) and the two must agree: the same
files on disk, the same retention across restarts, the same resume choice,
the same values read back. ``DcpCheckpointer`` (over
``torch.distributed.checkpoint``) takes the place of ``OrbaxCheckpointer``.
The resume contract also runs the same steps under a reference Manager and
a port Manager: their ``state_dict()`` fields, the ``"manager"`` half of
every checkpoint, are equal.
"""

import os
import pickle

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torchft_tpu import checkpoint_io as jax_io
from torchft_tpu_torch import checkpoint_io as port_io
from torchft_tpu_torch.checkpoint_io import (
    AsyncCheckpointWriter,
    DcpCheckpointer,
    latest_checkpoint,
    load_checkpoint,
)

IO = {"port": port_io, "jax": jax_io}
BOTH = pytest.mark.parametrize("pkg", sorted(IO))


def _tree(pkg: str, step: int):
    if pkg == "jax":
        return {"params": {"w": jnp.full((4, 4), float(step)),
                           "b": jnp.ones((4,))}, "step": step}
    return {"params": {"w": torch.full((4, 4), float(step)),
                       "b": torch.ones((4,))}, "step": step}


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@BOTH
def test_save_roundtrip(tmp_path, pkg) -> None:
    path = str(tmp_path / "ckpt_1.pkl")
    with IO[pkg].AsyncCheckpointWriter() as w:
        assert w.save(path, _tree(pkg, 7)).result(30) == path
    got = IO[pkg].load_checkpoint(path)
    np.testing.assert_array_equal(_np(got["params"]["w"]),
                                  np.full((4, 4), 7.0))
    assert got["step"] == 7
    # staged to the host: numpy in the reference, CPU tensors in the port
    if pkg == "port":
        assert got["params"]["w"].device.type == "cpu"
    else:
        assert isinstance(got["params"]["w"], np.ndarray)


@BOTH
def test_staging_is_immediate_snapshot(tmp_path, pkg) -> None:
    # the device-to-host copy happens on the call: what the caller does to
    # its state afterwards never reaches the disk
    path = str(tmp_path / "snap.pkl")
    with IO[pkg].AsyncCheckpointWriter() as w:
        if pkg == "port":
            state = {"w": torch.zeros(8)}
            w.save(path, state)
            state["w"].add_(100.0)  # in place, as the train step updates
        else:
            state = {"w": jnp.zeros((8,))}
            w.save(path, state)
            state["w"] = state["w"] + 100.0
        w.wait(30)
    np.testing.assert_array_equal(_np(IO[pkg].load_checkpoint(path)["w"]),
                                  np.zeros(8))


@BOTH
def test_retention_keeps_last_k(tmp_path, pkg) -> None:
    with IO[pkg].AsyncCheckpointWriter(keep=2) as w:
        for i in range(5):
            w.save(str(tmp_path / f"ckpt_{i}.pkl"), _tree(pkg, i))
        w.wait(30)
    assert sorted(os.listdir(tmp_path)) == ["ckpt_3.pkl", "ckpt_4.pkl"]


@BOTH
def test_atomic_no_torn_files(tmp_path, pkg) -> None:
    path = str(tmp_path / "atomic.pkl")
    with IO[pkg].AsyncCheckpointWriter() as w:
        for i in range(10):
            w.save(path, _tree(pkg, i))
            if os.path.exists(path):
                assert IO[pkg].load_checkpoint(path)["step"] in range(10)
        w.wait(30)
    assert IO[pkg].load_checkpoint(path)["step"] == 9
    assert not os.path.exists(path + ".tmp")


@BOTH
def test_write_error_latches_and_raises(tmp_path, pkg) -> None:
    w = IO[pkg].AsyncCheckpointWriter()
    blocker = tmp_path / "blocker"
    blocker.write_bytes(b"")  # a regular file as the parent directory
    fut = w.save(str(blocker / "x.pkl"), _tree(pkg, 0))
    with pytest.raises(Exception):
        fut.result(30)
    with pytest.raises(RuntimeError, match="background checkpoint"):
        w.save(str(tmp_path / "ok.pkl"), _tree(pkg, 1))
    # the raise clears the latch; later saves work
    assert w.save(str(tmp_path / "ok2.pkl"), _tree(pkg, 2)).result(30)
    w.close()


def test_wait_raises_a_latched_write_error(tmp_path) -> None:
    w = AsyncCheckpointWriter()
    blocker = tmp_path / "blocker"
    blocker.write_bytes(b"")
    w.save(str(blocker / "x.pkl"), _tree("port", 0))
    with pytest.raises(RuntimeError, match="background checkpoint"):
        w.wait(30)
    w.wait(30)  # cleared
    w.close()


@BOTH
def test_backpressure_one_write_in_flight(tmp_path, pkg) -> None:
    w = IO[pkg].AsyncCheckpointWriter()
    f1 = w.save(str(tmp_path / "a.pkl"), _tree(pkg, 1))
    w.save(str(tmp_path / "b.pkl"), _tree(pkg, 2))
    assert f1.done()  # the previous write finished before the next stage
    w.close()


@BOTH
def test_save_step_retention_spans_restarts(tmp_path, pkg) -> None:
    base = str(tmp_path / "run.ckpt")
    with IO[pkg].AsyncCheckpointWriter(keep=2) as w1:
        for s in (10, 20):
            w1.save_step(base, s, _tree(pkg, s))
    with IO[pkg].AsyncCheckpointWriter(keep=2) as w2:  # a new incarnation
        w2.save_step(base, 30, _tree(pkg, 30))
    assert sorted(os.listdir(tmp_path)) == ["run.ckpt.20", "run.ckpt.30"]
    assert IO[pkg].latest_checkpoint(base).endswith(".30")


@BOTH
def test_latest_checkpoint_legacy_bare_path(tmp_path, pkg) -> None:
    base = str(tmp_path / "old.ckpt")
    with open(base, "wb") as f:
        pickle.dump({"step": 5}, f)
    assert IO[pkg].latest_checkpoint(base) == base
    assert IO[pkg].latest_checkpoint(str(tmp_path / "missing")) is None
    assert IO[pkg].latest_checkpoint(str(tmp_path / "nodir" / "x")) is None


def test_latest_checkpoint_agrees_with_the_reference(tmp_path) -> None:
    base = str(tmp_path / "run.ckpt")
    for name in ("run.ckpt", "run.ckpt.3", "run.ckpt.12", "run.ckpt.12.tmp",
                 "run.ckpt.ema.50", "run.ckpt.9"):
        (tmp_path / name).write_bytes(b"x")
    assert latest_checkpoint(base) == jax_io.latest_checkpoint(base)
    assert latest_checkpoint(base).endswith("run.ckpt.12")


@BOTH
def test_persist_creates_parent_dirs(tmp_path, pkg) -> None:
    path = str(tmp_path / "deep" / "nested" / "c.pkl")
    with IO[pkg].AsyncCheckpointWriter() as w:
        assert w.save(path, _tree(pkg, 1)).result(30) == path
    assert IO[pkg].load_checkpoint(path)["step"] == 1


@BOTH
def test_step_checkpoints_ignore_foreign_families(tmp_path, pkg) -> None:
    base = str(tmp_path / "run.ckpt")
    for name in ("run.ckpt.ema.50", "run.ckpt.backup.2", "run.ckpt.tmp"):
        (tmp_path / name).write_bytes(b"x")
    with IO[pkg].AsyncCheckpointWriter(keep=1) as w:
        w.save_step(base, 10, _tree(pkg, 10))
    assert IO[pkg].latest_checkpoint(base).endswith("run.ckpt.10")
    names = sorted(os.listdir(tmp_path))
    assert "run.ckpt.ema.50" in names and "run.ckpt.backup.2" in names


def test_kill_mid_write_resumes_from_the_previous_checkpoint(tmp_path) -> None:
    # a crash during a persist leaves only ``{path}.tmp``, torn: resume
    # never picks it, and the next incarnation's retention cleans nothing
    # of the older, complete file
    base = str(tmp_path / "run.ckpt")
    with AsyncCheckpointWriter(keep=2) as w:
        w.save_step(base, 4, _tree("port", 4))
    with open(base + ".6.tmp", "wb") as f:
        f.write(b"torn")
    newest = latest_checkpoint(base)
    assert newest.endswith("run.ckpt.4")
    assert load_checkpoint(newest)["step"] == 4
    with AsyncCheckpointWriter(keep=2) as w:
        w.save_step(base, 6, _tree("port", 6))  # the retried write
    assert load_checkpoint(latest_checkpoint(base))["step"] == 6
    assert not os.path.exists(base + ".6.tmp")


def test_stage_and_persist_are_logged(tmp_path) -> None:
    with AsyncCheckpointWriter() as w:
        w.save(str(tmp_path / "a.pkl"), _tree("port", 1))
        w.wait(30)
    (entry,) = w.saves
    assert entry["path"].endswith("a.pkl")
    assert entry["stage_s"] >= 0 and entry["persist_s"] > 0
    assert entry["bytes"] == os.path.getsize(entry["path"])


# ------------------------------------------------------------ resume contract


def _manager_steps(pkg: str, steps: int, tmp_path):
    """``steps`` committed solo steps of a Manager of ``pkg``; its
    state_dict() after them."""
    if pkg == "jax":
        from torchft_tpu.comm.store import StoreServer
        from torchft_tpu.control import Lighthouse
        from torchft_tpu.manager import Manager
    else:
        from torchft_tpu_torch.comm.store import StoreServer
        from torchft_tpu_torch.control import Lighthouse
        from torchft_tpu_torch.manager import Manager
    lh = Lighthouse(min_replicas=1, join_timeout_ms=100)
    store = StoreServer()
    m = Manager(min_replica_size=1, rank=0, world_size=1,
                store_addr=store.addr, lighthouse_addr=lh.address(),
                replica_id=f"resume_{pkg}_", timeout=20.0,
                quorum_timeout=20.0, connect_timeout=20.0,
                use_async_quorum=False)
    try:
        for _ in range(steps):
            m.start_quorum(allow_heal=False)
            m.allreduce_arrays([np.ones(4, np.float32)]).future().result(20)
            assert m.should_commit()
        return m.state_dict()
    finally:
        m.shutdown(wait=False)
        store.shutdown()
        lh.shutdown()


def test_resume_contract_with_manager_state(tmp_path, monkeypatch) -> None:
    # the example's durable format: {"user": ..., "manager": ...}, the
    # manager half written by either package's Manager identically
    monkeypatch.setenv("TORCHFT_TPU_FASTPATH", "0")
    port_state = _manager_steps("port", 3, tmp_path)
    jax_state = _manager_steps("jax", 3, tmp_path)
    assert port_state == jax_state == {"step": 3, "batches_committed": 3}
    path = str(tmp_path / "resume.pkl")
    with AsyncCheckpointWriter() as w:
        w.save(path, {"user": {"model": {"w": torch.arange(4.0)},
                               "sampler": {"epoch": 0, "pos": 24}},
                      "manager": port_state})
    got = load_checkpoint(path)
    assert got["manager"] == jax_state
    np.testing.assert_array_equal(got["user"]["model"]["w"].numpy(),
                                  np.arange(4.0))
    assert got["user"]["sampler"] == {"epoch": 0, "pos": 24}


# -------------------------------------------------------------- DCP format


def _dcp_state(step: int):
    return {"user": {"params": {"w": torch.arange(6, dtype=torch.float32)},
                     "optim": {"state": {0: {"step": torch.tensor(float(step)),
                                             "exp_avg": torch.ones(6) * step}},
                               "param_groups": [{"lr": 0.1, "params": [0]}]}},
            "manager": {"step": step, "batches_committed": 7}}


def test_dcp_checkpointer_roundtrip_and_keep(tmp_path) -> None:
    directory = str(tmp_path / "ckpt")
    with DcpCheckpointer(directory, keep=2) as ck:
        for s in (1, 2, 3):
            ck.save_step(s, _dcp_state(s))
        ck.wait()
        assert ck.latest_step() == 3
        restored = ck.restore()
        np.testing.assert_array_equal(
            restored["user"]["params"]["w"].numpy(), np.arange(6.0))
        assert int(restored["manager"]["step"]) == 3
        # into a template: in place, integer keys kept
        template = _dcp_state(0)
        w = template["user"]["params"]["w"]
        out = ck.restore(2, template=template)
        assert out is template and template["user"]["params"]["w"] is w
        assert float(template["user"]["optim"]["state"][0]["step"]) == 2.0
        assert template["manager"]["step"] == 2
    # keep=2 across a restart: step 1 pruned, the newest found again
    with DcpCheckpointer(directory, keep=2) as ck2:
        assert ck2.latest_step() == 3
        assert ck2.all_steps() == [2, 3]
        ck2.save_step(4, _dcp_state(4))
        ck2.wait()
        assert ck2.all_steps() == [3, 4]
    assert not any(n.endswith(".tmp") for n in os.listdir(directory))


def test_dcp_checkpointer_restore_without_a_checkpoint_raises(tmp_path):
    with DcpCheckpointer(str(tmp_path / "empty")) as ck:
        assert ck.latest_step() is None
        with pytest.raises(FileNotFoundError):
            ck.restore()
