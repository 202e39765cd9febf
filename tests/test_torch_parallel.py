"""The port's mesh and ring attention against the JAX package's.

Twins of ``tests/test_parallel.py``'s ``ft_mesh`` tests and ring tests,
with the same tolerances (f32: 2e-5 on outputs, 5e-5 on gradients): the
port's ring runs its shards in lock-step over a virtual mesh of CPU
devices (``ft_mesh({"seq": n}, devices=["cpu"] * n)``), where the flash
block path reaches the flash kernels' plain versions. The cross-package
tests feed the same seeded numpy q, k, v and dO to the JAX package's ring
(4 of conftest's 8 CPU devices; the flash blocks in Pallas interpret mode,
as its own tests run them) and to the port's, outputs and gradients held
within the same tolerances.
"""

from unittest.mock import MagicMock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from torchft_tpu.parallel import ft_mesh as jft_mesh
from torchft_tpu.parallel import make_ring_attention as jmake_ring
from torchft_tpu_torch.comm.context import ManagedCommContext
from torchft_tpu_torch.ops.attention import reference_attention
from torchft_tpu_torch.parallel import (
    FTMesh,
    ft_mesh,
    make_ring_attention,
    ring,
    ring_attention,
    ring_launches,
    ring_schedule,
)

OUT_TOL = 2e-5
GRAD_TOL = 5e-5


def _cpu_mesh(n, name="seq"):
    return ft_mesh({name: n}, devices=["cpu"] * n)


def _qkv(seed, shape, extra=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for _ in range(3 + extra)]


def _t(*arrays, grad=False):
    return [torch.tensor(a, requires_grad=grad) for a in arrays]


# ------------------------------------------------------------------- mesh


def test_ft_mesh_axes_and_infer() -> None:
    mesh = ft_mesh({"data": 2, "fsdp": -1}, devices=["cpu"] * 8)
    assert mesh.shape == {"data": 2, "fsdp": 4}
    assert mesh.devices.shape == (2, 4)
    assert all(d == torch.device("cpu") for d in mesh.devices.flat)
    with pytest.raises(ValueError, match="need"):
        ft_mesh({"data": 3, "fsdp": 4}, devices=["cpu"] * 8)
    with pytest.raises(ValueError, match="at most one"):
        ft_mesh({"data": -1, "fsdp": -1}, devices=["cpu"] * 8)
    with pytest.raises(ValueError, match="divisible"):
        ft_mesh({"data": 3, "fsdp": -1}, devices=["cpu"] * 8)


def test_ft_mesh_defaults_to_the_cards() -> None:
    if torch.cuda.is_available():
        mesh = ft_mesh({"seq": -1})
        assert mesh.size == torch.cuda.device_count()
        return
    with pytest.raises(RuntimeError, match="devices="):
        ft_mesh({"seq": -1})


def test_ft_mesh_replica_axis_is_virtual() -> None:
    mesh = ft_mesh({"data": 8}, devices=["cpu"] * 8)
    manager = MagicMock()
    manager.num_participants.return_value = 3
    ftm = FTMesh(manager, mesh)
    assert ftm.num_replicas() == 3
    # the managed view includes the virtual axis; the in-group mesh never
    assert ftm.axis_names == ("replica", "data")
    assert "replica" not in ftm.mesh.axis_names
    with pytest.raises(ValueError, match="virtual replica"):
        FTMesh(manager, ft_mesh({"replica": 8}, devices=["cpu"] * 8))
    manager.num_participants.return_value = 0
    assert ftm.num_replicas() == 1  # reported >= 1


def test_ft_mesh_composition_surface() -> None:
    # distinct devices (indices of one kind), so coordinate() can find one
    devices = [torch.device("cpu", i) for i in range(8)]
    mesh = ft_mesh({"data": 2, "fsdp": 4}, devices=devices)
    manager = MagicMock()
    manager.num_participants.return_value = 3
    manager.participating_rank.return_value = 2
    ftm = FTMesh(manager, mesh)

    assert ftm.shape == {"replica": 3, "data": 2, "fsdp": 4}
    assert ftm.size() == 24
    assert ftm.size("replica") == 3 and ftm.size("fsdp") == 4
    assert ftm.ndim == 3
    assert ftm.global_batch_ratio() == 3.0

    sub = ftm[("replica", "fsdp")]
    assert isinstance(sub, FTMesh)
    assert sub.shape == {"replica": 3, "fsdp": 4}
    assert sub.size() == 12  # not 24: "data" is outside the view
    with pytest.raises(KeyError):
        sub.axis_size("data")
    rep_only = ftm["replica"]
    assert rep_only.axis_names == ("replica",)
    assert rep_only.size() == 3
    assert ftm["fsdp"] == "fsdp"
    assert ftm[("data", "fsdp")] == ("data", "fsdp")
    with pytest.raises(KeyError):
        ftm["bogus"]

    assert isinstance(ftm.get_comm("replica"), ManagedCommContext)
    assert isinstance(ftm.get_comm(), ManagedCommContext)
    assert ftm.get_comm("data") == "data"

    assert ftm.flattened_spec("data", "fsdp") == ("data", "fsdp")
    with pytest.raises(ValueError, match="virtual"):
        ftm.flattened_spec("replica")

    dev = mesh.devices[1][2]
    assert ftm.coordinate(dev) == {"replica": 2, "data": 1, "fsdp": 2}
    assert ftm.coordinate(index=6) == {"replica": 2, "data": 1, "fsdp": 2}
    assert ftm.coordinate() == {"replica": 2, "data": 0, "fsdp": 0}
    assert sub.coordinate(index=6) == {"replica": 2, "fsdp": 2}
    assert rep_only.coordinate() == {"replica": 2}
    with pytest.raises(ValueError, match="not part"):
        ftm.coordinate(torch.device("cpu", 9))


def test_coordinate_on_a_virtual_mesh_takes_an_index() -> None:
    # one device at four positions: asking by device is ambiguous, never
    # the first match
    mesh = _cpu_mesh(4)
    manager = MagicMock()
    manager.participating_rank.return_value = None
    ftm = FTMesh(manager, mesh)
    with pytest.raises(ValueError, match="4 positions"):
        ftm.coordinate("cpu")
    assert [ftm.coordinate(index=i)["seq"] for i in range(4)] == [0, 1, 2, 3]
    assert ftm.coordinate(index=3)["replica"] == 0
    with pytest.raises(ValueError, match="outside"):
        ftm.coordinate(index=4)


def test_axis_devices_are_the_axis_shards() -> None:
    devices = [torch.device("cpu", i) for i in range(8)]
    mesh = ft_mesh({"data": 2, "seq": 4}, devices=devices)
    assert mesh.axis_devices("seq") == devices[:4]
    assert mesh.axis_devices("data") == [devices[0], devices[4]]


# ------------------------------------------------------- ring (port only)


@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_matches_reference(causal) -> None:
    q, k, v = _t(*_qkv(0, (2, 64, 4, 16)))
    ring_fn = make_ring_attention(_cpu_mesh(8), "seq", causal=causal)
    out = ring_fn(q, k, v)
    expected = reference_attention(q, k, v, causal=causal)
    np.testing.assert_allclose(out.numpy(), expected.numpy(),
                               atol=OUT_TOL, rtol=OUT_TOL)
    assert out.shape == q.shape and out.is_contiguous()


@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_flash_blocks_matches_reference(causal) -> None:
    q, k, v = _t(*_qkv(7, (2, 64, 2, 16)))
    ring_fn = make_ring_attention(_cpu_mesh(4), "seq", causal=causal,
                                  block_impl="flash", block_q=8, block_k=8)
    out = ring_fn(q, k, v)
    expected = reference_attention(q, k, v, causal=causal)
    np.testing.assert_allclose(out.numpy(), expected.numpy(),
                               atol=OUT_TOL, rtol=OUT_TOL)


def test_ring_attention_flash_blocks_match_einsum_blocks() -> None:
    q, k, v = _t(*_qkv(8, (1, 64, 2, 8)))
    mesh = _cpu_mesh(8)
    out_e = make_ring_attention(mesh, "seq", causal=True)(q, k, v)
    out_f = make_ring_attention(mesh, "seq", causal=True, block_impl="flash",
                                block_q=8, block_k=8)(q, k, v)
    np.testing.assert_allclose(out_e.numpy(), out_f.numpy(),
                               atol=OUT_TOL, rtol=OUT_TOL)


def _grads(fn, q, k, v):
    qs, ks, vs = (x.detach().clone().requires_grad_(True) for x in (q, k, v))
    (fn(qs, ks, vs) ** 2).sum().backward()
    return qs.grad, ks.grad, vs.grad


def test_ring_attention_long_context_grad() -> None:
    q, k, v = _t(*_qkv(1, (1, 32, 2, 8)))
    ring_fn = make_ring_attention(_cpu_mesh(8), "seq", causal=True)
    g_ring = _grads(ring_fn, q, k, v)
    g_ref = _grads(lambda *a: reference_attention(*a, causal=True), q, k, v)
    for a, b in zip(g_ring, g_ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(),
                                   atol=GRAD_TOL, rtol=GRAD_TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_flash_blocks_grad(causal) -> None:
    q, k, v = _t(*_qkv(11, (2, 64, 2, 16)))
    ring_fn = make_ring_attention(_cpu_mesh(4), "seq", causal=causal,
                                  block_impl="flash", block_q=8, block_k=8)
    g_ring = _grads(ring_fn, q, k, v)
    g_ref = _grads(lambda *a: reference_attention(*a, causal=causal),
                   q, k, v)
    for a, b in zip(g_ring, g_ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(),
                                   atol=GRAD_TOL, rtol=GRAD_TOL)


def test_ring_attention_flash_grad_matches_einsum_grad() -> None:
    q, k, v = _t(*_qkv(12, (1, 64, 2, 8)))
    mesh = _cpu_mesh(8)
    ge = _grads(make_ring_attention(mesh, "seq", causal=True), q, k, v)
    gf = _grads(make_ring_attention(mesh, "seq", causal=True,
                                    block_impl="flash", block_q=8,
                                    block_k=8), q, k, v)
    for a, b in zip(ge, gf):
        np.testing.assert_allclose(a.numpy(), b.numpy(),
                                   atol=GRAD_TOL, rtol=GRAD_TOL)


def test_ring_schedule_skips_the_future() -> None:
    sched = ring_schedule(4, causal=True)
    assert len(sched) == 16
    kinds = [kind for *_, kind in sched]
    assert kinds.count("skip") == 6
    assert kinds.count("causal") == 4 and kinds.count("full") == 6
    # step 0 is the diagonal; shard idx holds block (idx - t) % n
    assert [(i, s, kind) for t, i, s, kind in sched if t == 0] == \
        [(i, i, "causal") for i in range(4)]
    assert all(kind == "skip" for _, i, s, kind in sched if s > i)
    assert all(kind == "full" for *_, kind in ring_schedule(3, False))
    assert ring_launches(4) == {"flash_fwd": 10, "flash_bwd_dq": 10,
                                "flash_bwd_dkv": 10}
    # activation checkpointing runs the forward again in the backward
    assert ring_launches(4, remat=True)["flash_fwd"] == 20
    assert ring_launches(4, causal=False) == dict.fromkeys(
        ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"), 16)
    assert ring_launches(1) == dict.fromkeys(
        ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"), 1)


@pytest.mark.parametrize("causal", [True, False])
def test_future_pairs_make_no_block_call(causal, monkeypatch) -> None:
    # a spy on the block functions the flash ring calls: the launch
    # counters count CUDA launches only
    calls = {"fwd": [], "bwd": []}
    fwd, bwd = ring.flash_attention_with_lse, ring.flash_block_attention_bwd

    def spy_fwd(q, k, v, causal, **kw):
        calls["fwd"].append(causal)
        return fwd(q, k, v, causal=causal, **kw)

    def spy_bwd(q, k, v, do, lse, delta, causal, **kw):
        calls["bwd"].append(causal)
        return bwd(q, k, v, do, lse, delta, causal=causal, **kw)

    monkeypatch.setattr(ring, "flash_attention_with_lse", spy_fwd)
    monkeypatch.setattr(ring, "flash_block_attention_bwd", spy_bwd)
    q, k, v = _t(*_qkv(3, (1, 64, 2, 8)), grad=True)
    out = ring_attention(q, k, v, _cpu_mesh(4), causal=causal,
                         block_impl="flash", block_q=8, block_k=8)
    out.sum().backward()
    want = ring_launches(4, causal=causal)["flash_fwd"]
    for name in ("fwd", "bwd"):
        assert len(calls[name]) == want
        assert calls[name].count(True) == (4 if causal else 0)
    # the forward made exactly the schedule's calls, in its order
    assert calls["fwd"] == [kind == "causal" for *_, kind in
                            ring_schedule(4, causal) if kind != "skip"]


def test_ring_refuses_a_sequence_that_does_not_split() -> None:
    q, k, v = _t(*_qkv(0, (1, 30, 2, 8)))
    with pytest.raises(ValueError, match="does not split"):
        make_ring_attention(_cpu_mesh(4), "seq")(q, k, v)
    with pytest.raises(ValueError, match="block_impl"):
        make_ring_attention(_cpu_mesh(4), "seq", block_impl="pallas")


def test_ring_of_one_shard_is_local_attention() -> None:
    q, k, v = _t(*_qkv(4, (2, 32, 2, 8)))
    for impl in ("einsum", "flash"):
        out = ring_attention(q, k, v, _cpu_mesh(1), block_impl=impl)
        np.testing.assert_allclose(
            out.numpy(), reference_attention(q, k, v).numpy(),
            atol=OUT_TOL, rtol=OUT_TOL)


def test_ring_takes_an_ftmesh_and_a_bf16_cotangent() -> None:
    # bf16 in, bf16 out, the cotangent in the output's dtype: the flash
    # ring's gradients stay within bf16 rounding of the einsum ring's
    q, k, v = (x.to(torch.bfloat16) for x in _t(*_qkv(5, (1, 64, 2, 8))))
    ftm = FTMesh(MagicMock(), _cpu_mesh(4))
    got = _grads(make_ring_attention(ftm, block_impl="flash", block_q=8,
                                     block_k=8), q, k, v)
    want = _grads(make_ring_attention(ftm), q, k, v)
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16
        rel = float((a.float() - b.float()).norm() / b.float().norm())
        assert rel < 2e-2


# ------------------------------------------------------ port against JAX


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("impl", ["einsum", "flash"])
def test_ring_matches_the_jax_ring(impl, causal, monkeypatch) -> None:
    monkeypatch.setenv("TORCHFT_TPU_PALLAS_INTERPRET", "1")
    shape = (2, 64, 2, 16)
    q, k, v, do = _qkv(21, shape, extra=1)
    kw = dict(causal=causal, block_impl=impl, block_q=8, block_k=8)

    jmesh = jft_mesh({"seq": 4}, devices=jax.devices()[:4])
    spec = NamedSharding(jmesh, P(None, "seq", None, None))
    jring = jmake_ring(jmesh, "seq", **kw)
    jq, jk, jv = (jax.device_put(jnp.asarray(x), spec) for x in (q, k, v))
    jout, vjp = jax.vjp(jring, jq, jk, jv)
    jgrads = vjp(jnp.asarray(do))

    tq, tk, tv = _t(q, k, v, grad=True)
    out = make_ring_attention(_cpu_mesh(4), "seq", **kw)(tq, tk, tv)
    out.backward(torch.tensor(do))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               atol=OUT_TOL, rtol=OUT_TOL)
    for got, want in zip((tq.grad, tk.grad, tv.grad), jgrads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=GRAD_TOL, rtol=GRAD_TOL)
