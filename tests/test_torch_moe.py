"""The port's MoE block and MoE transformer against the JAX package's.

Twins of the single-device tests of tests/test_moe.py and
tests/test_moe_model.py. The JAX parameters (from ``init_moe_params`` /
``moe_init_params``) are carried over to the port (``from_jax_params``)
and the same numpy inputs go through both, in f32 activations
(``dataclasses.replace(cfg, dtype=float32)``) so bf16 rounding cannot flip
a routing decision. The routing's dispatch masks are compared first,
exactly; then, within stated tolerances (summation order only): the MoE
block's output 1e-5 absolute + 1e-4 relative and its aux loss 1e-6
relative; the model's loss 1e-5 and each gradient within 1e-4 of that
parameter's largest gradient entry. The expert-sharded and TP+EP twins
are in tests/test_torch_moe_sharded.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from torchft_tpu.models import moe_transformer as jmt
from torchft_tpu.parallel import moe as jmoe
from torchft_tpu_torch.models import (
    MOE_CONFIGS,
    MoETransformer,
    count_params,
    from_jax_params,
)
from torchft_tpu_torch.parallel import moe
from torchft_tpu_torch.parallel.moe import MoEConfig

CFG = MoEConfig(d_model=16, d_ff=32, num_experts=4, capacity_factor=2.0)
OUT_ATOL, OUT_RTOL, AUX_RTOL = 1e-5, 1e-4, 1e-6
LOSS_TOL, GRAD_TOL = 1e-5, 1e-4


def _jcfg(cfg: MoEConfig):
    return jmoe.MoEConfig(d_model=cfg.d_model, d_ff=cfg.d_ff,
                          num_experts=cfg.num_experts,
                          capacity_factor=cfg.capacity_factor)


def _x(shape=(2, 8, 16), seed=0) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _params(cfg: MoEConfig, seed: int):
    """The reference's parameters, as numpy and as port tensors."""
    jp = jax.device_get(jmoe.init_moe_params(jax.random.key(seed),
                                             _jcfg(cfg)))
    tp = {"gate": {"kernel": torch.from_numpy(np.array(jp["gate"]["kernel"]))},
          "experts": {k: torch.from_numpy(np.array(v))
                      for k, v in jp["experts"].items()}}
    return jp, tp


def _both(cfg: MoEConfig, seed: int, x: np.ndarray):
    jp, tp = _params(cfg, seed)
    jy, jaux = jmoe.moe_forward(_jcfg(cfg), jp, jnp.asarray(x))
    ty, taux = moe.moe_forward(cfg, tp, torch.from_numpy(x))
    return (np.asarray(jy), float(jaux)), (ty.numpy(), float(taux)), jp, tp


@pytest.mark.parametrize("capacity", [1, 3, 16])
def test_routing_masks_equal_the_reference(capacity: int) -> None:
    # dispatch, combine and the top-1 mask from the same gates, ties
    # included (a repeated row and equal gates take the first expert)
    rng = np.random.default_rng(capacity)
    logits = rng.standard_normal((24, 4)).astype(np.float32)
    logits[5] = logits[4]
    logits[7] = 0.0  # a four-way tie
    gates = np.array(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    jd, jc, jm = (np.asarray(a) for a in
                  jmoe._top2_routing(jnp.asarray(gates), capacity))
    td, tc, tm = (a.numpy() for a in
                  moe._top2_routing(torch.from_numpy(gates), capacity))
    np.testing.assert_array_equal(td, jd)
    np.testing.assert_array_equal(tm, jm)
    np.testing.assert_allclose(tc, jc, rtol=1e-6, atol=0)
    assert td.sum() == jd.sum() > 0


def test_moe_forward_shapes_and_aux() -> None:
    x = _x()
    (jy, jaux), (ty, taux), _, _ = _both(CFG, 0, x)
    assert ty.shape == x.shape
    np.testing.assert_allclose(ty, jy, atol=OUT_ATOL, rtol=OUT_RTOL)
    np.testing.assert_allclose(taux, jaux, rtol=AUX_RTOL)
    assert 0.9 < taux < CFG.num_experts + 0.1


def test_moe_matches_dense_reference() -> None:
    # with capacity to spare nothing drops: each token's output is the
    # renormalized top-2 mix of its experts, computed one by one
    cfg = MoEConfig(d_model=8, d_ff=16, num_experts=4, capacity_factor=8.0)
    x = _x((1, 6, 8), seed=3)
    (jy, _), (ty, _), jp, _ = _both(cfg, 1, x)
    tokens = x.reshape(-1, 8)
    gates = np.asarray(jax.nn.softmax(tokens @ jp["gate"]["kernel"],
                                      axis=-1))
    up, down = jp["experts"]["up"], jp["experts"]["down"]
    expected = np.zeros_like(tokens)
    for i, tok in enumerate(tokens):
        order = np.argsort(gates[i])[::-1][:2]
        w = gates[i][order] / gates[i][order].sum()
        for e, weight in zip(order, w):
            h = np.asarray(jax.nn.gelu(tok @ up[e]))
            expected[i] += weight * (h @ down[e])
    np.testing.assert_allclose(ty.reshape(-1, 8), expected, atol=1e-5,
                               rtol=1e-4)
    np.testing.assert_allclose(ty, jy, atol=OUT_ATOL, rtol=OUT_RTOL)


def test_moe_capacity_drops_tokens() -> None:
    # capacity 1 per expert: the same tokens drop in both (their rows 0)
    cfg = MoEConfig(d_model=8, d_ff=16, num_experts=2, capacity_factor=0.05)
    x = _x((1, 32, 8), seed=4)
    (jy, _), (ty, _), _, _ = _both(cfg, 2, x)
    dropped = np.all(np.abs(ty.reshape(-1, 8)) < 1e-9, axis=-1)
    assert dropped.sum() > 0
    np.testing.assert_array_equal(
        dropped, np.all(np.abs(jy.reshape(-1, 8)) < 1e-9, axis=-1))


def test_moe_differentiable() -> None:
    x = _x()
    jp, tp = _params(CFG, 0)

    def jloss(p):
        y, aux = jmoe.moe_forward(_jcfg(CFG), p, jnp.asarray(x))
        return jnp.sum(y ** 2) + 0.01 * aux

    jg = jax.device_get(jax.grad(jloss)(jp))
    leaves = [tp["gate"]["kernel"], tp["experts"]["up"],
              tp["experts"]["down"]]
    for t in leaves:
        t.requires_grad_(True)
    y, aux = moe.moe_forward(CFG, tp, torch.from_numpy(x))
    (torch.sum(y ** 2) + 0.01 * aux).backward()
    for t, g in zip(leaves, (jg["gate"]["kernel"], jg["experts"]["up"],
                             jg["experts"]["down"])):
        got = t.grad.numpy()
        assert np.all(np.isfinite(got))
        assert np.abs(got - g).max() <= GRAD_TOL * np.abs(g).max()
    assert float(np.abs(leaves[1].grad.numpy()).max()) > 0


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}.{k}" if prefix else k
        out.update(_flat(v, key) if isinstance(v, dict) else {key: v})
    return out


def _model_pair(seed: int):
    jcfg = dataclasses.replace(jmt.MOE_CONFIGS["moe-tiny"], dtype=jnp.float32)
    cfg = dataclasses.replace(MOE_CONFIGS["moe-tiny"], dtype=torch.float32)
    params = jax.device_get(jmt.moe_init_params(jcfg, jax.random.key(seed)))
    model = MoETransformer(cfg, device="cpu")
    model.load_state_dict(from_jax_params(params))
    return jcfg, cfg, params, model


def _batch(cfg, b=2, s=16, seed=0):
    tok = np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s))
    return tok, np.roll(tok, -1, axis=1)


def test_moe_model_param_layout() -> None:
    # layer 0 dense, layer 1 MoE; the port's state-dict keys are the
    # reference's parameter paths, each of the same shape
    _, cfg, params, model = _model_pair(0)
    flat = {k: np.shape(v) for k, v in _flat(params).items()}
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == flat
    assert "layers_0.mlp.up_proj.kernel" in flat
    assert "layers_1.moe.experts.up" in flat
    assert flat["layers_1.moe.experts.up"] == (cfg.num_experts, cfg.d_model,
                                               cfg.d_ff)
    assert count_params(model) == sum(int(np.prod(s)) for s in flat.values())
    assert count_params(MoETransformer(MOE_CONFIGS["moe-8x125m"],
                                       device="meta")) == 334_308_864


@pytest.mark.parametrize("seed", [1, 2])
def test_moe_model_loss_and_grads_match(seed: int) -> None:
    jcfg, cfg, params, model = _model_pair(seed)
    tok, tgt = _batch(cfg, seed=seed)
    jl, jg = jax.value_and_grad(
        lambda p: jmt.moe_transformer_loss_fn(
            jcfg, p, jnp.asarray(tok, jnp.int32), jnp.asarray(tgt, jnp.int32))
    )(params)
    loss = model.loss(torch.tensor(tok), torch.tensor(tgt))
    loss.backward()
    assert abs(loss.item() - float(jl)) <= LOSS_TOL
    grads = dict(model.named_parameters())
    for key, g in _flat(jax.device_get(jg)).items():
        got, g = grads[key].grad.numpy(), np.asarray(g)
        assert np.abs(got - g).max() <= GRAD_TOL * np.abs(g).max(), key
    # expert weights and the router receive gradient
    assert grads["layers_1.moe.experts.up"].grad.abs().max().item() > 0
    assert grads["layers_1.moe.gate.kernel"].grad.abs().max().item() > 0


def test_moe_model_trains() -> None:
    # five Adam steps on one batch, both packages: the losses fall and
    # follow the reference's
    jcfg, cfg, params, model = _model_pair(0)
    tok, tgt = _batch(cfg)
    tx = optax.adam(1e-2)
    step = jmt.make_moe_train_step(jcfg, tx, donate=False)
    jparams, opt_state, jlosses = params, tx.init(params), []
    for _ in range(5):
        jparams, opt_state, loss = step(jparams, opt_state,
                                        jnp.asarray(tok, jnp.int32),
                                        jnp.asarray(tgt, jnp.int32))
        jlosses.append(float(loss))
    opt = torch.optim.Adam(model.parameters(), lr=1e-2)
    losses = []
    for _ in range(5):
        opt.zero_grad()
        loss = model.loss(torch.tensor(tok), torch.tensor(tgt))
        loss.backward()
        opt.step()
        losses.append(loss.item())
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)


def test_remat_recomputes_each_block() -> None:
    # remat on: the same loss and gradients, each block's forward run again
    # in the backward (the reference's jax.checkpoint)
    _, cfg, params, model = _model_pair(0)
    remat = MoETransformer(dataclasses.replace(cfg, remat=True), device="cpu")
    remat.load_state_dict(model.state_dict())
    tok, tgt = (torch.tensor(a) for a in _batch(cfg))
    calls = []
    for m in (model, remat):
        m.layers_1.moe.register_forward_pre_hook(lambda *a: calls.append(1))
    model.loss(tok, tgt).backward()
    n_plain = len(calls)
    remat.loss(tok, tgt).backward()
    assert (n_plain, len(calls) - n_plain) == (1, 2)
    for (k, a), b in zip(model.named_parameters(), remat.parameters()):
        assert torch.equal(a.grad, b.grad), k


@pytest.mark.parametrize("remat", [False, True])
def test_moe_model_takes_the_attention_hook(remat: bool) -> None:
    # the GPT's attn_fn reaches the MoE family through the shared attention
    # sublayer (with and without the recompute): a spy that defers to the
    # plain path gives the same loss and gradients, called once per block
    # per forward
    from torchft_tpu_torch.ops.attention import causal_attention

    jcfg, cfg, params, model = _model_pair(0)
    model = MoETransformer(dataclasses.replace(cfg, remat=remat),
                           device="cpu")
    model.load_state_dict(from_jax_params(params))
    tok, tgt = (torch.tensor(a) for a in _batch(cfg))
    calls = []

    def spy(q, k, v):
        calls.append(q.shape)
        return causal_attention(q, k, v)

    loss = model.loss(tok, tgt, attn_fn=spy)
    loss.backward()
    grads = [p.grad.clone() for p in model.parameters()]
    model.zero_grad()
    want = model.loss(tok, tgt)
    want.backward()
    assert torch.equal(loss, want)
    assert all(torch.equal(a, p.grad)
               for a, p in zip(grads, model.parameters()))
    assert len(calls) == cfg.n_layers * (2 if remat else 1)
