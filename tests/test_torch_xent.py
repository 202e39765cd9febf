"""The port's chunked cross entropy against the JAX package's.

The same numpy inputs go through ``torchft_tpu.ops.xent`` and
``torchft_tpu_torch.ops.xent`` in f32. Tolerances: 1e-5 on the loss and
1e-5 relative to the largest gradient entry (summation order only).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torchft_tpu.ops import xent as jxent
from torchft_tpu_torch.ops import xent

TOL = 1e-5


def _inputs(n, d, v, seed=0, shape=None):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((n, d) if shape is None else shape + (d,))
    w = rng.standard_normal((d, v)) * 0.1
    t = rng.integers(0, v, (n,) if shape is None else shape)
    return h.astype(np.float32), w.astype(np.float32), t.astype(np.int64)


def _rel(a, b):
    b = np.asarray(b)
    return float(np.abs(np.asarray(a) - b).max() / max(1e-12, np.abs(b).max()))


@pytest.mark.parametrize("n,d,v,chunks", [
    (16, 8, 64, 1), (33, 16, 128, 4), (64, 32, 512, 8),
])
def test_chunked_ce_value_and_grads(n, d, v, chunks) -> None:
    h, w, t = _inputs(n, d, v)
    jl, (jdh, jdw) = jax.value_and_grad(
        lambda a, b: jxent.chunked_cross_entropy(a, b, jnp.asarray(t),
                                                 chunks),
        argnums=(0, 1),
    )(jnp.asarray(h), jnp.asarray(w))
    th = torch.tensor(h, requires_grad=True)
    tw = torch.tensor(w, requires_grad=True)
    tl = xent.chunked_cross_entropy(th, tw, torch.tensor(t), chunks)
    tl.backward()
    assert abs(tl.item() - float(jl)) <= TOL
    assert _rel(th.grad.numpy(), jdh) <= TOL
    assert _rel(tw.grad.numpy(), jdw) <= TOL


def test_hidden_cross_entropy_matches() -> None:
    h, w, t = _inputs(0, 16, 256, seed=1, shape=(2, 12))
    jl, (jdh, jdw) = jax.value_and_grad(
        lambda a, b: jxent.hidden_cross_entropy(a, b, jnp.asarray(t), 8),
        argnums=(0, 1),
    )(jnp.asarray(h), jnp.asarray(w))
    th = torch.tensor(h, requires_grad=True)
    tw = torch.tensor(w, requires_grad=True)
    tl = xent.hidden_cross_entropy(th, tw, torch.tensor(t), 8)
    tl.backward()
    assert abs(tl.item() - float(jl)) <= TOL
    assert _rel(th.grad.numpy(), jdh) <= TOL
    assert _rel(tw.grad.numpy(), jdw) <= TOL


def test_chunked_matches_dense_log_softmax() -> None:
    h, w, t = _inputs(40, 16, 96, seed=2)
    th, tw, tt = torch.tensor(h), torch.tensor(w), torch.tensor(t)
    dense = -torch.log_softmax(th @ tw, -1).gather(1, tt[:, None]).mean()
    assert abs(float(xent.chunked_cross_entropy(th, tw, tt, 3)) -
               float(dense)) <= TOL


def test_lse_and_target_generic_cotangents() -> None:
    # the backward takes any (g_lse, g_tl), as the reference's custom VJP
    h, w, t = _inputs(10, 8, 32, seed=3)
    rng = np.random.default_rng(4)
    g1 = rng.standard_normal(10).astype(np.float32)
    g2 = rng.standard_normal(10).astype(np.float32)
    mask = jnp.ones((10,), dtype=bool)
    jdh = jax.grad(lambda a: jnp.sum(
        jnp.stack(jxent.chunked_lse_and_target(
            a, jnp.asarray(w), jnp.asarray(t), mask, 4))
        * jnp.stack([jnp.asarray(g1), jnp.asarray(g2)])))(jnp.asarray(h))
    th = torch.tensor(h, requires_grad=True)
    lse, tl = xent.chunked_lse_and_target(th, torch.tensor(w),
                                          torch.tensor(t), 4)
    (lse * torch.tensor(g1) + tl * torch.tensor(g2)).sum().backward()
    assert _rel(th.grad.numpy(), jdh) <= TOL


def test_out_of_range_targets_clamp_like_reference() -> None:
    h, w, _ = _inputs(6, 8, 32, seed=5)
    t = np.array([-3, 0, 5, 31, 32, 100])
    jl = jxent.chunked_cross_entropy(jnp.asarray(h), jnp.asarray(w),
                                     jnp.asarray(t), 4)
    tl = xent.chunked_cross_entropy(torch.tensor(h), torch.tensor(w),
                                    torch.tensor(t), 4)
    assert abs(tl.item() - float(jl)) <= TOL


def test_rejects_indivisible_vocab() -> None:
    h, w, t = _inputs(4, 8, 30)
    with pytest.raises(ValueError, match="not divisible"):
        xent.chunked_cross_entropy(torch.tensor(h), torch.tensor(w),
                                   torch.tensor(t), 4)


# --- the rest of tests/test_xent.py, under the reference's names ----------


def test_chunked_ce_jit_and_extreme_logits() -> None:
    # logits of order 1e4: the online logsumexp stays finite where a naive
    # exp overflows, and matches the reference's chunked loss and a dense
    # one (there jitted; torch runs it eagerly)
    rng = np.random.default_rng(2)
    h = (rng.standard_normal((8, 4)) * 100.0).astype(np.float32)
    w = (rng.standard_normal((4, 32)) * 100.0).astype(np.float32)
    t = rng.integers(0, 32, (8,))
    got = float(xent.chunked_cross_entropy(torch.tensor(h), torch.tensor(w),
                                           torch.tensor(t), 4))
    ref = float(jax.jit(lambda a, b, c: jxent.chunked_cross_entropy(
        a, b, c, 4))(jnp.asarray(h), jnp.asarray(w), jnp.asarray(t)))
    logits = torch.tensor(h) @ torch.tensor(w)
    dense = float(-torch.log_softmax(logits, -1).gather(
        1, torch.tensor(t)[:, None]).mean())
    assert np.isfinite(got)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(got, dense, atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("compute", ["bf16", "f32"])
def test_model_loss_chunked_matches_dense(compute) -> None:
    # the model's switch: "tiny" with and without xent_chunks, the same
    # weights, gives the same loss (the reference's bound) and, in f32
    # compute, the same gradients (the reference's bounds). In bf16
    # compute the two paths' f32 gradients of the hidden state differ by
    # reassociation (~5e-7 relative), which rounds to bf16 one ulp apart
    # in places and moves each parameter's gradient by up to 1.5 bf16
    # ulps of its largest entry, so they are held there at two (ROADMAP
    # L3; XLA's two paths agree to 4e-9 on this input)
    import dataclasses

    from torchft_tpu_torch.models import CONFIGS, GPT

    cfg = CONFIGS["tiny"]
    assert cfg.xent_chunks == 0 and cfg.dtype == torch.bfloat16
    if compute == "f32":
        cfg = dataclasses.replace(cfg, dtype=torch.float32)
    rng = np.random.default_rng(3)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 64)))
    targets = torch.roll(tokens, -1, dims=1)
    out = []
    for c in (cfg, dataclasses.replace(cfg, xent_chunks=4)):
        model = GPT(c, device="cpu", seed=0)
        loss = model.loss(tokens, targets)
        loss.backward()
        out.append((float(loss), [p.grad.numpy() for p in model.parameters()]))
    np.testing.assert_allclose(out[0][0], out[1][0], atol=1e-5, rtol=1e-5)
    assert len(out[0][1]) == len(out[1][1])
    for a, b in zip(out[0][1], out[1][1]):
        if compute == "f32":
            np.testing.assert_allclose(a, b, atol=2e-4, rtol=2e-3)
        else:
            assert np.abs(a - b).max() <= 2.0 ** -7 * np.abs(b).max()


def test_llama_loss_chunked_matches_dense() -> None:
    import dataclasses

    from torchft_tpu_torch.models.llama import Llama, LlamaConfig

    cfg = LlamaConfig(vocab_size=128, d_model=32, n_layers=2, n_heads=4,
                      n_kv_heads=2, d_ff=64, max_seq_len=64, remat=False)
    rng = np.random.default_rng(4)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 32)))
    targets = torch.roll(tokens, -1, dims=1)
    losses = [float(Llama(c, device="cpu", seed=0).loss(tokens, targets))
              for c in (cfg, dataclasses.replace(cfg, xent_chunks=4))]
    np.testing.assert_allclose(losses[0], losses[1], atol=1e-5, rtol=1e-5)
