"""The port's expert axis against the JAX package on the CPU.

Twins of tests/test_moe.py's ``test_moe_sharded_expert_mesh_matches`` and
tests/test_moe_model.py's ``test_moe_model_ep_sharded_matches_unsharded``
and ``test_moe_tp_ep_single_pass_rules``, on the reference tests' meshes
(``{"expert": 4, "data": 2}`` and ``{"tensor": 2, "expert": 4}``): the
port's positions run in lock-step on a virtual mesh of the CPU, the JAX
package's on 8 of conftest's CPU devices (or unsharded, where the
reference test compares against the unsharded function).

- ``moe_rules()`` is the reference's, and gives the reference's spec for
  every leaf of "moe-tiny" on both meshes;
- the MoE block, expert-sharded (``moe_forward_sharded``), against the
  reference's unsharded ``moe_forward``: ``y`` within 1e-5 absolute +
  1e-4 relative, ``aux`` 1e-5 relative (the reference test's); with a
  capacity that drops tokens, the same tokens dropped (the routing is
  global: each shard's queue positions start after the earlier shards'),
  where per-shard routing would drop others;
- ``ShardedMoETransformer`` on the reference's weights: the loss within
  the reference test's rtol 1e-3 / atol 3e-3 in the configs' bf16, and in
  f32 activations within 2e-5 relative, every gradient within 5e-5
  (relative norm) of ``jax.grad`` of the reference's unsharded loss;
  two passes bitwise; the state tree round trip in place; an fsdp axis
  and experts that do not split refused;
- expert-sharded leaves on the heal plane across packages, both ways,
  bitwise: a port healer whose template is the sharded model's state tree
  heals from a JAX donor holding ``shard_pytree(..., moe_rules(),
  fsdp_axis=None)`` arrays, and a JAX healer with such a template heals
  from a port donor; each distinct region fetched once.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torchft_tpu.checkpointing as jax_ckpt
import torchft_tpu_torch.checkpointing as cp
from torchft_tpu.models import moe_transformer as jmt
from torchft_tpu.parallel import ft_mesh as jft_mesh
from torchft_tpu.parallel import moe as jmoe
from torchft_tpu.parallel import shard_pytree as jshard_pytree
from torchft_tpu.parallel.sharding import tp_rules_gpt as jtp_rules_gpt
from torchft_tpu_torch.models import MOE_CONFIGS, ShardedMoETransformer
from torchft_tpu_torch.models.transformer import _tree_get
from torchft_tpu_torch.optim import TransformationOptimizer, adamw
from torchft_tpu_torch.parallel import (
    MoEConfig,
    ShardedTensor,
    ft_mesh,
    moe_forward_sharded,
    moe_rules,
    shard_pytree,
    tp_rules_gpt,
)
from torchft_tpu_torch.utils.metrics import Metrics

Y_ATOL, Y_RTOL, AUX_RTOL = 1e-5, 1e-4, 1e-5
MODEL_RTOL, MODEL_ATOL = 1e-3, 3e-3
F32_LOSS, F32_GRAD = 2e-5, 5e-5
EXPERT_MESH = {"expert": 4, "data": 2}
TP_EP_MESH = {"tensor": 2, "expert": 4}
CFG = MoEConfig(d_model=16, d_ff=32, num_experts=4, capacity_factor=2.0)


def _mesh(axes):
    return ft_mesh(axes, devices=["cpu"] * int(np.prod(list(axes.values()))))


def _jmesh(axes):
    n = int(np.prod(list(axes.values())))
    return jft_mesh(axes, devices=jax.devices()[:n])


def _jcfg(cfg: MoEConfig):
    return jmoe.MoEConfig(d_model=cfg.d_model, d_ff=cfg.d_ff,
                          num_experts=cfg.num_experts,
                          capacity_factor=cfg.capacity_factor)


def _block_params(seed=0):
    jp = jax.device_get(jmoe.init_moe_params(jax.random.key(seed),
                                             _jcfg(CFG)))
    tp = jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), jp)
    return jp, tp


def _x(shape=(4, 8, 16), seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, key) if isinstance(v, dict) else {key: v})
    return out


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(1e-30,
                                                  np.linalg.norm(want)))


def _model_params(seed: int, dtype=jnp.float32):
    jcfg = dataclasses.replace(jmt.MOE_CONFIGS["moe-tiny"], dtype=dtype)
    return jcfg, jax.device_get(jmt.moe_init_params(jcfg,
                                                    jax.random.key(seed)))


def _batch(cfg, b=8, s=16, seed=0):
    tok = np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s))
    return tok, np.roll(tok, -1, axis=1)


def _jloss(jcfg, params, tok, tgt):
    return jmt.moe_transformer_loss_fn(jcfg, params,
                                       jnp.asarray(tok, jnp.int32),
                                       jnp.asarray(tgt, jnp.int32))


# ------------------------------------------------------------- the rules


def test_moe_rules_are_the_references() -> None:
    assert moe_rules() == jmoe.moe_rules()


@pytest.mark.parametrize("axes,tp", [(EXPERT_MESH, False),
                                     (TP_EP_MESH, True)],
                         ids=["expert4xdata2", "tensor2xexpert4"])
def test_specs_match_the_reference_for_every_leaf(axes, tp) -> None:
    _, params = _model_params(0)
    rules = (tp_rules_gpt() if tp else []) + moe_rules()
    jrules = (jtp_rules_gpt() if tp else []) + jmoe.moe_rules()
    jsharded = jshard_pytree(params, _jmesh(axes), tp_rules=jrules,
                             fsdp_axis=None, tensor_axis="expert")
    sharded = shard_pytree(params, _mesh(axes), tp_rules=rules,
                           fsdp_axis=None, tensor_axis="expert")
    want = {k: tuple(v.sharding.spec) for k, v in _flat(jsharded).items()}
    got = {k: tuple(v.sharding.spec) for k, v in _flat(sharded).items()}
    assert got == want
    assert got["layers_1/moe/experts/up"][:1] == ("expert",)
    assert got["layers_1/moe/experts/down"][:1] == ("expert",)
    assert all(e is None for e in got["layers_1/moe/gate/kernel"])
    # the pieces hold what the reference's shards hold
    for k, leaf in _flat(sharded).items():
        for shard in _flat(jsharded)[k].addressable_shards:
            pos = list(_jmesh(axes).devices.flat).index(shard.device)
            np.testing.assert_array_equal(leaf.piece_at(pos).numpy(),
                                          np.asarray(shard.data))


# ------------------------------------------------------------ the block


def test_moe_sharded_expert_mesh_matches() -> None:
    jp, tp = _block_params(0)
    x = _x()
    y_ref, aux_ref = jmoe.moe_forward(_jcfg(CFG), jp, jnp.asarray(x))
    sharded = shard_pytree(tp, _mesh(EXPERT_MESH), tp_rules=moe_rules(),
                           fsdp_axis=None, tensor_axis="expert")
    assert sharded["experts"]["up"].sharding.spec[0] == "expert"
    y, aux = moe_forward_sharded(CFG, sharded, torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), atol=Y_ATOL,
                               rtol=Y_RTOL)
    np.testing.assert_allclose(float(aux), float(aux_ref), rtol=AUX_RTOL)


@pytest.mark.parametrize("cf", [0.2, 0.3])
def test_sharded_block_drops_the_references_tokens(cf) -> None:
    cfg = dataclasses.replace(CFG, capacity_factor=cf)
    jp, tp = _block_params(1)
    x = _x((8, 8, 16), seed=5)
    y_ref, aux_ref = jmoe.moe_forward(_jcfg(cfg), jp, jnp.asarray(x))
    sharded = shard_pytree(tp, _mesh(EXPERT_MESH), tp_rules=moe_rules(),
                           fsdp_axis=None)
    y, aux = moe_forward_sharded(cfg, sharded, torch.from_numpy(x))
    dropped_ref = np.all(np.asarray(y_ref).reshape(-1, 16) == 0, axis=-1)
    dropped = np.all(y.numpy().reshape(-1, 16) == 0, axis=-1)
    assert dropped_ref.sum() > 0
    np.testing.assert_array_equal(dropped, dropped_ref)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), atol=Y_ATOL,
                               rtol=Y_RTOL)
    np.testing.assert_allclose(float(aux), float(aux_ref), rtol=AUX_RTOL)
    # routing each shard on its own (a capacity and queue per shard) would
    # keep other tokens: the check above can see the difference
    local = np.concatenate([np.asarray(jmoe.moe_forward(
        _jcfg(cfg), jp, jnp.asarray(shard))[0]).reshape(-1, 16)
        for shard in np.split(x.reshape(1, -1, 16), 8, axis=1)])
    assert not np.array_equal(np.all(local == 0, axis=-1), dropped_ref)


# ------------------------------------------------------------ the model


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_model_ep_sharded_matches_unsharded(dtype) -> None:
    jcfg, params = _model_params(2, getattr(jnp, dtype))
    cfg = dataclasses.replace(MOE_CONFIGS["moe-tiny"],
                              dtype=getattr(torch, dtype))
    tok, tgt = _batch(cfg, seed=2)
    loss_ref = float(_jloss(jcfg, params, tok, tgt))
    model = ShardedMoETransformer(cfg, _mesh(EXPERT_MESH), params=params)
    loss = model.loss(torch.tensor(tok), torch.tensor(tgt)).item()
    if dtype == "float32":
        assert abs(loss - loss_ref) <= F32_LOSS * abs(loss_ref)
    else:
        np.testing.assert_allclose(loss, loss_ref, rtol=MODEL_RTOL,
                                   atol=MODEL_ATOL)


def test_moe_tp_ep_single_pass_rules() -> None:
    jcfg, params = _model_params(3, jnp.bfloat16)
    cfg = MOE_CONFIGS["moe-tiny"]
    tok, tgt = _batch(cfg, seed=3)
    loss_ref = float(_jloss(jcfg, params, tok, tgt))
    model = ShardedMoETransformer(cfg, _mesh(TP_EP_MESH), params=params)
    spec = {p: tuple(model.layouts[p].sharding.spec) for p in model.paths}
    assert spec["layers_0/attn/q_proj/kernel"] == (None, "tensor")
    assert spec["layers_1/moe/experts/up"][:1] == ("expert",)
    assert all(s is None for s in spec["layers_1/moe/gate/kernel"])
    loss = model.loss(torch.tensor(tok), torch.tensor(tgt)).item()
    np.testing.assert_allclose(loss, loss_ref, rtol=MODEL_RTOL,
                               atol=MODEL_ATOL)


@pytest.mark.parametrize("axes", [EXPERT_MESH, TP_EP_MESH],
                         ids=["expert4xdata2", "tensor2xexpert4"])
@pytest.mark.parametrize("remat", [False, True])
def test_gradients_match_jax_grad(axes, remat) -> None:
    jcfg, params = _model_params(4)
    cfg = dataclasses.replace(MOE_CONFIGS["moe-tiny"], dtype=torch.float32,
                              remat=remat)
    tok, tgt = _batch(cfg, seed=4)
    jl, jg = jax.value_and_grad(lambda p: _jloss(jcfg, p, tok, tgt))(params)
    model = ShardedMoETransformer(cfg, _mesh(axes), params=params)
    loss = model.loss(torch.tensor(tok), torch.tensor(tgt))
    loss.backward()
    assert abs(loss.item() - float(jl)) <= F32_LOSS * abs(float(jl))
    grads = model.grad_tree()
    jflat = _flat(jax.device_get(jg))
    assert set(jflat) == set(model.paths)
    for path, g in jflat.items():
        got = _tree_get(grads, path)
        assert got.sharding == model.layouts[path].sharding
        assert _rel(got.full().numpy(), g) <= F32_GRAD, path
    assert np.abs(jflat["layers_1/moe/experts/up"]).max() > 0


def test_two_passes_are_bitwise() -> None:
    cfg = dataclasses.replace(MOE_CONFIGS["moe-tiny"], remat=True)
    model = ShardedMoETransformer(cfg, _mesh(EXPERT_MESH), seed=6)
    tok, tgt = (torch.tensor(a) for a in _batch(cfg, seed=6))
    runs = []
    for _ in range(2):
        model.zero_grad(set_to_none=True)
        loss = model.loss(tok, tgt)
        loss.backward()
        runs.append((loss.detach(), [p.grad.clone()
                                     for p in model.parameters()]))
    assert torch.equal(runs[0][0], runs[1][0])
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))


def test_state_tree_round_trip() -> None:
    cfg = MOE_CONFIGS["moe-tiny"]
    mesh = _mesh(EXPERT_MESH)
    a = ShardedMoETransformer(cfg, mesh, seed=4)
    b = ShardedMoETransformer(cfg, mesh, seed=5)
    opt_a = TransformationOptimizer(a.parameters(), adamw(3e-4))
    opt_b = TransformationOptimizer(b.parameters(), adamw(3e-4))
    tok, tgt = (torch.tensor(x) for x in _batch(cfg, seed=7))
    a.loss(tok, tgt).backward()
    opt_a.step()
    state = a.state_tree(opt_a)
    up = _tree_get(state["params"], "layers_1/moe/experts/up")
    assert isinstance(up, ShardedTensor) and up.sharding.spec[0] == "expert"
    assert len(up.pieces) == 4  # one per expert position, held once
    ptrs = [p.data_ptr() for p in b.parameters()]
    b.load_state_tree(state, opt_b)
    assert [p.data_ptr() for p in b.parameters()] == ptrs  # in place
    for p, q in zip(a.parameters(), b.parameters()):
        assert torch.equal(p, q)
        for k in ("mu", "nu", "count"):
            assert torch.equal(opt_a.state[p][k], opt_b.state[q][k])


def test_refuses_fsdp_and_experts_that_do_not_split() -> None:
    cfg = MOE_CONFIGS["moe-tiny"]
    with pytest.raises(ValueError, match="fsdp"):
        ShardedMoETransformer(cfg, _mesh({"fsdp": 2, "expert": 2}))
    with pytest.raises(ValueError, match="do not split"):
        ShardedMoETransformer(cfg, _mesh({"expert": 8}))


# --------------------------------------------------- heal plane, mixed


def _zeros_like(params):
    return jax.tree_util.tree_map(np.zeros_like, params)


def test_port_healer_heals_expert_leaves_from_a_jax_donor() -> None:
    _, params = _model_params(8)
    jstate = {"user": {"params": jshard_pytree(
        params, _jmesh(EXPERT_MESH), tp_rules=jmoe.moe_rules(),
        fsdp_axis=None)}, "torchft": {"step": 4, "batches_committed": 8}}
    model = ShardedMoETransformer(MOE_CONFIGS["moe-tiny"],
                                  _mesh(EXPERT_MESH), seed=99)
    template = {"user": model.state_tree(),
                "torchft": {"step": 0, "batches_committed": 0}}
    donor = jax_ckpt.CheckpointServer(timeout=10.0)
    healer = cp.CheckpointServer(timeout=10.0, template_fn=lambda: template)
    metrics = Metrics()
    healer.set_metrics(metrics)
    try:
        donor.send_checkpoint([], 4, jstate, 10.0)
        got = healer.recv_checkpoint(0, donor.metadata(), 4, 10.0)
    finally:
        donor.shutdown()
        healer.shutdown()
    assert got["torchft"] == {"step": 4, "batches_committed": 8}
    for path in model.paths:
        healed = _tree_get(got["user"]["params"], path)
        assert isinstance(healed, ShardedTensor)
        assert healed.sharding == model.layouts[path].sharding
        assert healed.full().numpy().tobytes() == \
            np.asarray(_tree_get(params, path)).tobytes()
    model.load_state_tree(got["user"])
    up = model.pieces("layers_1/moe/experts/up")
    assert torch.equal(up[3], torch.from_numpy(
        np.array(params["layers_1"]["moe"]["experts"]["up"][3:4])))
    # each distinct region once: the donor's copies over data move no byte
    assert metrics.snapshot()["heal_wire_bytes"] == sum(
        np.asarray(v).nbytes for v in _flat(params).values())


def test_jax_healer_heals_expert_leaves_from_a_port_donor() -> None:
    _, params = _model_params(9)
    model = ShardedMoETransformer(MOE_CONFIGS["moe-tiny"],
                                  _mesh(EXPERT_MESH), params=params)
    port_state = {"user": model.state_tree(),
                  "torchft": {"step": 6, "batches_committed": 12}}
    jtmpl = {"params": jshard_pytree(_zeros_like(params), _jmesh(EXPERT_MESH),
                                     tp_rules=jmoe.moe_rules(),
                                     fsdp_axis=None)}
    template = {"user": jtmpl, "torchft": {"step": 0, "batches_committed": 0}}
    donor = cp.CheckpointServer(timeout=10.0)
    served = Metrics()
    donor.set_metrics(served)
    healer = jax_ckpt.CheckpointServer(timeout=10.0,
                                       template_fn=lambda: template)
    try:
        donor.send_checkpoint([], 6, port_state, 10.0)
        got = healer.recv_checkpoint(0, donor.metadata(), 6, 10.0)
    finally:
        donor.shutdown()
        healer.shutdown()
    assert got["torchft"] == {"step": 6, "batches_committed": 12}
    flat_t, flat_g = _flat(jtmpl["params"]), _flat(got["user"]["params"])
    for path, want in _flat(params).items():
        healed = flat_g[path]
        assert isinstance(healed, jax.Array)
        assert healed.sharding == flat_t[path].sharding
        assert np.asarray(healed).tobytes() == np.asarray(want).tobytes()
    assert served.snapshot()["heal_served_bytes"] == sum(
        np.asarray(v).nbytes for v in _flat(params).values())
