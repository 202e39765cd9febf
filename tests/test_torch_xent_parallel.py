"""The port's vocab-parallel cross entropy against the JAX package's.

Twins of ``tests/test_xent.py``'s vocab-parallel tests: the JAX function
runs under ``shard_map`` on a ``{"tensor": 4}`` mesh of conftest's CPU
devices, the port's over a virtual ``["cpu"] * 4`` mesh, on the same numpy
inputs. Tolerances as the reference's (1e-6 absolute and relative on the
loss, 1e-6 absolute and 1e-5 relative on the gradients). Then the mask
the port's ``chunked_lse_and_target`` took from the reference: masked rows
report a target logit of 0 and get no one-hot gradient, against the JAX
function, and an all-True mask is bitwise no mask.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding as JNamedSharding
from jax.sharding import PartitionSpec as JP

from torchft_tpu.ops import xent as jxent
from torchft_tpu.parallel import ft_mesh as jft_mesh
from torchft_tpu_torch.ops import xent
from torchft_tpu_torch.parallel import (
    NamedSharding,
    PartitionSpec as P,
    ShardedTensor,
    ft_mesh,
)


def _dense_ce(x, w, targets):
    logits = x.astype(jnp.float32) @ w.astype(jnp.float32)
    logp = jax.nn.log_softmax(logits, axis=-1)
    return -jnp.mean(
        jnp.take_along_axis(logp, targets[:, None], axis=-1)[:, 0])


def _meshes():
    return (jft_mesh({"tensor": 4}, devices=jax.devices()[:4]),
            ft_mesh({"tensor": 4}, devices=["cpu"] * 4))


def _head(mesh, w):
    leaf = ShardedTensor.from_full(w, NamedSharding(mesh, P(None, "tensor")))
    for p in leaf.pieces:
        p.requires_grad_(True)
    return leaf


@pytest.mark.parametrize("chunks", [1, 2])
def test_vocab_parallel_ce_value_and_grads(chunks) -> None:
    jmesh, mesh = _meshes()
    n, d, v = 32, 16, 64
    rng = np.random.default_rng(5)
    h = rng.standard_normal((n, d)).astype(np.float32)
    w = (rng.standard_normal((d, v)) * 0.5).astype(np.float32)
    t = rng.integers(0, v, (n,)).astype(np.int32)
    jloss = jxent.make_vocab_parallel_cross_entropy(jmesh, "tensor",
                                                    num_chunks=chunks)
    ws = jax.device_put(jnp.asarray(w), JNamedSharding(jmesh,
                                                       JP(None, "tensor")))
    want = float(jax.jit(jloss)(jnp.asarray(h), ws, jnp.asarray(t)))
    dense = float(_dense_ce(jnp.asarray(h), jnp.asarray(w), jnp.asarray(t)))
    gh, gw = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jnp.asarray(h), ws,
                                                      jnp.asarray(t))

    loss = xent.make_vocab_parallel_cross_entropy(mesh, "tensor",
                                                  num_chunks=chunks)
    th = torch.tensor(h, requires_grad=True)
    head = _head(mesh, w)
    got = loss(th, head, torch.tensor(t, dtype=torch.int64))
    got.backward()
    np.testing.assert_allclose(got.item(), want, atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(got.item(), dense, atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(gh), atol=1e-6,
                               rtol=1e-5)
    got_w = head.like([p.grad for p in head.pieces]).full().numpy()
    np.testing.assert_allclose(got_w, np.asarray(gw), atol=1e-6, rtol=1e-5)


def test_vocab_parallel_ce_gradient_sharding_preserved() -> None:
    # dw comes back vocab-sharded: each shard's gradient on its piece, in
    # its piece's shape (no gather of the head), as the reference's spec
    jmesh, mesh = _meshes()
    n, d, v = 16, 8, 32
    rng = np.random.default_rng(6)
    h = rng.standard_normal((n, d)).astype(np.float32)
    w = (rng.standard_normal((d, v)) * 0.5).astype(np.float32)
    t = rng.integers(0, v, (n,)).astype(np.int32)
    jloss = jxent.make_vocab_parallel_cross_entropy(jmesh, "tensor")
    ws = jax.device_put(jnp.asarray(w), JNamedSharding(jmesh,
                                                       JP(None, "tensor")))
    gw = jax.jit(jax.grad(jloss, argnums=1))(jnp.asarray(h), ws,
                                             jnp.asarray(t))
    assert gw.sharding.spec == JP(None, "tensor")
    head = _head(mesh, w)
    loss = xent.make_vocab_parallel_cross_entropy(mesh, "tensor")
    loss(torch.tensor(h), head, torch.tensor(t, dtype=torch.int64)).backward()
    for piece, b, shard in zip(head.pieces, head.bounds,
                               gw.addressable_shards):
        assert piece.grad.shape == piece.shape == (d, v // 4)
        assert piece.grad.device == piece.device
        np.testing.assert_allclose(piece.grad.numpy(),
                                   np.asarray(shard.data), atol=1e-6,
                                   rtol=1e-5)


def test_vocab_parallel_ce_clips_targets_and_refuses_other_layouts() -> None:
    jmesh, mesh = _meshes()
    n, d, v = 6, 8, 32
    rng = np.random.default_rng(7)
    h = rng.standard_normal((n, d)).astype(np.float32)
    w = (rng.standard_normal((d, v)) * 0.5).astype(np.float32)
    t = np.array([-3, 0, 5, 31, 32, 100], np.int32)
    jloss = jxent.make_vocab_parallel_cross_entropy(jmesh, "tensor")
    ws = jax.device_put(jnp.asarray(w), JNamedSharding(jmesh,
                                                       JP(None, "tensor")))
    want = float(jax.jit(jloss)(jnp.asarray(h), ws, jnp.asarray(t)))
    loss = xent.make_vocab_parallel_cross_entropy(mesh, "tensor")
    got = loss(torch.tensor(h), _head(mesh, w),
               torch.tensor(t, dtype=torch.int64))
    np.testing.assert_allclose(got.item(), want, atol=1e-6, rtol=1e-6)
    rows = ShardedTensor.from_full(w, NamedSharding(mesh, P("tensor", None)))
    with pytest.raises(ValueError, match="vocab dimension"):
        loss(torch.tensor(h), rows, torch.tensor(t, dtype=torch.int64))


def test_masked_lse_and_target_matches_the_reference() -> None:
    n, d, v = 10, 8, 32
    rng = np.random.default_rng(8)
    h = rng.standard_normal((n, d)).astype(np.float32)
    w = (rng.standard_normal((d, v)) * 0.3).astype(np.float32)
    t = rng.integers(0, v, (n,))
    mask = rng.random(n) < 0.5
    g1 = rng.standard_normal(n).astype(np.float32)
    g2 = rng.standard_normal(n).astype(np.float32)

    def jf(a, b):
        lse, tl = jxent.chunked_lse_and_target(a, b, jnp.asarray(t),
                                               jnp.asarray(mask), 4)
        return jnp.sum(lse * g1 + tl * g2), (lse, tl)

    (_, (jlse, jtl)), (jdh, jdw) = jax.value_and_grad(
        jf, argnums=(0, 1), has_aux=True)(jnp.asarray(h), jnp.asarray(w))
    th = torch.tensor(h, requires_grad=True)
    tw = torch.tensor(w, requires_grad=True)
    lse, tl = xent.chunked_lse_and_target(th, tw, torch.tensor(t), 4,
                                          mask=torch.tensor(mask))
    assert not tl[~torch.tensor(mask)].any()
    (lse * torch.tensor(g1) + tl * torch.tensor(g2)).sum().backward()
    for got, want in ((lse, jlse), (tl, jtl), (th.grad, jdh),
                      (tw.grad, jdw)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   atol=1e-5, rtol=1e-5)
    # an all-True mask is bitwise no mask, value and gradient
    outs = []
    for m in (None, torch.ones(n, dtype=torch.bool)):
        a = torch.tensor(h, requires_grad=True)
        lse, tl = xent.chunked_lse_and_target(a, torch.tensor(w),
                                              torch.tensor(t), 4, mask=m)
        (lse * torch.tensor(g1) + tl * torch.tensor(g2)).sum().backward()
        outs.append((lse, tl, a.grad))
    for x, y in zip(*outs):
        assert torch.equal(x, y)
