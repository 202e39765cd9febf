"""The port's sharded GPT against the JAX package's GPT on sharded params.

One step of "tiny" on a ``{"fsdp": 2, "tensor": 2}`` mesh: the JAX
package's ``make_grad_step`` on ``shard_pytree`` d parameters (4 of
conftest's CPU devices, XLA partitioning it) against the port's
``ShardedGPT`` on a virtual ``["cpu"] * 4`` mesh (its positions in
lock-step), the same weights carried across (``params=`` takes the JAX
tree) and the same numpy tokens. The loss and every gradient, assembled
from its pieces, are compared.

Tolerances: in f32 activations, PR 14's ring tolerances, 2e-5 on the loss
and 5e-5 on each gradient, relative (the norm of the difference over the
norm of the reference): both sides compute the same f32 arithmetic, the
sharded products and the vocab-parallel loss's combination in another
order. In bf16 activations (the configs' default) against the port's
unsharded GPT: 2e-3 on the loss and 2e-2 on the gradients, because the
row-parallel projections round each tensor shard's partial product to
bf16 before the partials are added, where the unsharded product rounds
once.

Then AdamW stepped on pieces is bitwise AdamW stepped on whole leaves,
the state trees round-trip in place, two passes are bitwise equal, and
the model refuses a layout other than the one it computes.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torchft_tpu.models import transformer as jtf
from torchft_tpu.parallel import ft_mesh as jft_mesh
from torchft_tpu.parallel import shard_pytree as jshard_pytree
from torchft_tpu.parallel.sharding import tp_rules_gpt as jtp_rules_gpt
from torchft_tpu_torch.models import (
    CONFIGS,
    GPT,
    ShardedGPT,
    gpt_param_tree,
)
from torchft_tpu_torch.models.transformer import _tree_get
from torchft_tpu_torch.optim import TransformationOptimizer, adamw
from torchft_tpu_torch.parallel import ShardedTensor, ft_mesh

F32_LOSS, F32_GRAD = 2e-5, 5e-5
BF16_LOSS, BF16_GRAD = 2e-3, 2e-2

MESHES = [{"fsdp": 2, "tensor": 2}, {"tensor": 4}, {"fsdp": 4},
          {"data": 2, "fsdp": 2}, {"data": 2, "fsdp": 2, "tensor": 2}]


def _mesh(axes):
    n = int(np.prod(list(axes.values())))
    return ft_mesh(axes, devices=["cpu"] * n)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(1e-30,
                                                   np.linalg.norm(want)))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flat(v, key))
        else:
            out[key] = v
    return out


def _batch(cfg, seed=0, b=4, s=None):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab_size, (b, s or cfg.max_seq_len))
    return tok, np.roll(tok, -1, axis=1)


@pytest.mark.parametrize("xent_chunks", [0, 4])
def test_sharded_step_matches_the_reference_on_sharded_params(
        xent_chunks) -> None:
    jcfg = dataclasses.replace(jtf.CONFIGS["tiny"], dtype=jnp.float32,
                               xent_chunks=xent_chunks)
    cfg = dataclasses.replace(CONFIGS["tiny"], dtype=torch.float32,
                              xent_chunks=xent_chunks)
    params = jax.device_get(jtf.init_params(jcfg, jax.random.key(0)))
    axes = {"fsdp": 2, "tensor": 2}
    jmesh = jft_mesh(axes, devices=jax.devices()[:4])
    jparams = jshard_pytree(params, jmesh, tp_rules=jtp_rules_gpt())
    tok, tgt = _batch(cfg)
    with jmesh:
        jl, jg = jtf.make_grad_step(jcfg)(
            jparams, jnp.asarray(tok, jnp.int32), jnp.asarray(tgt, jnp.int32))
    model = ShardedGPT(cfg, _mesh(axes), params=params)
    loss = model.loss(torch.tensor(tok), torch.tensor(tgt))
    loss.backward()
    assert abs(loss.item() - float(jl)) <= F32_LOSS * abs(float(jl))
    grads = model.grad_tree()
    jflat = _flat(jax.device_get(jg))
    assert set(jflat) == set(model.paths)
    for path, g in jflat.items():
        got = _tree_get(grads, path)
        assert isinstance(got, ShardedTensor)
        assert got.sharding == model.layouts[path].sharding
        assert _rel(got.full().numpy(), g) <= F32_GRAD, path


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("axes", MESHES, ids=lambda a: "x".join(
    f"{k}{v}" for k, v in a.items()))
def test_sharded_step_matches_the_unsharded_port_f32(axes, remat) -> None:
    cfg = dataclasses.replace(CONFIGS["tiny"], dtype=torch.float32,
                              remat=remat, xent_chunks=2)
    dense = GPT(cfg, device="cpu", seed=1)
    model = ShardedGPT(cfg, _mesh(axes), params=gpt_param_tree(dense))
    tok, tgt = (torch.tensor(x) for x in _batch(cfg, 1, s=64))
    want = dense.loss(tok, tgt)
    want.backward()
    got = model.loss(tok, tgt)
    got.backward()
    assert abs(got.item() - want.item()) <= F32_LOSS * abs(want.item())
    grads = model.grad_tree()
    for name, p in dense.named_parameters():
        leaf = _tree_get(grads, name.replace(".", "/"))
        assert _rel(leaf.full().numpy(), p.grad.numpy()) <= F32_GRAD, name


def test_sharded_step_matches_the_unsharded_port_bf16() -> None:
    cfg = dataclasses.replace(CONFIGS["tiny"], remat=True, xent_chunks=2)
    dense = GPT(cfg, device="cpu", seed=2)
    model = ShardedGPT(cfg, _mesh({"fsdp": 2, "tensor": 2}),
                       params=gpt_param_tree(dense))
    tok, tgt = (torch.tensor(x) for x in _batch(cfg, 2))
    want = dense.loss(tok, tgt)
    want.backward()
    got = model.loss(tok, tgt)
    got.backward()
    assert abs(got.item() - want.item()) <= BF16_LOSS
    grads = model.grad_tree()
    for name, p in dense.named_parameters():
        leaf = _tree_get(grads, name.replace(".", "/"))
        assert _rel(leaf.full().numpy(), p.grad.numpy()) <= BF16_GRAD, name


def test_adamw_on_pieces_is_bitwise_adamw_on_whole_leaves() -> None:
    cfg = dataclasses.replace(CONFIGS["tiny"], xent_chunks=2)
    dense = GPT(cfg, device="cpu", seed=3)
    model = ShardedGPT(cfg, _mesh({"fsdp": 2, "tensor": 2}),
                       params=gpt_param_tree(dense))
    opt = TransformationOptimizer(model.parameters(), adamw(3e-4))
    whole = TransformationOptimizer(dense.parameters(), adamw(3e-4))
    named = dict(dense.named_parameters())
    for step in range(3):
        tok, tgt = (torch.tensor(x) for x in _batch(cfg, 10 + step))
        opt.zero_grad(set_to_none=True)
        model.loss(tok, tgt).backward()
        opt.step()
        # the whole leaves get the same gradients, assembled
        grads = model.grad_tree()
        for name, p in named.items():
            p.grad = _tree_get(grads, name.replace(".", "/")).full()
        whole.step()
        state = model.state_tree(opt)
        for name, p in named.items():
            path = name.replace(".", "/")
            got = _tree_get(state["params"], path).full()
            assert torch.equal(got, p.detach()), (step, name)
            for k in ("mu", "nu"):
                assert torch.equal(_tree_get(state["opt"][k], path).full(),
                                   whole.state[p][k]), (step, name, k)
        assert int(state["opt"]["count"]) == step + 1


def test_state_tree_round_trip() -> None:
    cfg = CONFIGS["tiny"]
    mesh = _mesh({"fsdp": 2, "tensor": 2})
    a = ShardedGPT(cfg, mesh, seed=4)
    b = ShardedGPT(cfg, mesh, seed=5)
    opt_a = TransformationOptimizer(a.parameters(), adamw(3e-4))
    opt_b = TransformationOptimizer(b.parameters(), adamw(3e-4))
    tok, tgt = (torch.tensor(x) for x in _batch(cfg, 4))
    a.loss(tok, tgt).backward()
    opt_a.step()
    ptrs = [p.data_ptr() for p in b.parameters()]
    b.load_state_tree(a.state_tree(opt_a), opt_b)
    assert [p.data_ptr() for p in b.parameters()] == ptrs  # in place
    for p, q in zip(a.parameters(), b.parameters()):
        assert torch.equal(p, q)
        for k in ("mu", "nu", "count"):
            assert torch.equal(opt_a.state[p][k], opt_b.state[q][k])


def test_two_passes_are_bitwise_and_the_layout_is_megatron() -> None:
    cfg = dataclasses.replace(CONFIGS["tiny"], remat=True, xent_chunks=2)
    model = ShardedGPT(cfg, _mesh({"fsdp": 2, "tensor": 2}), seed=7)
    tok, tgt = (torch.tensor(x) for x in _batch(cfg, 7))
    runs = []
    for _ in range(2):
        model.zero_grad(set_to_none=True)
        loss = model.loss(tok, tgt)
        loss.backward()
        runs.append([loss.detach()] + [p.grad.clone()
                                       for p in model.parameters()])
    assert all(torch.equal(x, y) for x, y in zip(*runs))
    specs = {p: model.layouts[p].sharding.spec for p in model.paths}
    assert specs["layers_0/attn/q_proj/kernel"] == ("fsdp", "tensor")
    assert specs["layers_0/attn/o_proj/kernel"] == ("tensor", "fsdp")
    assert specs["wte/embedding"] == ("tensor", "fsdp")
    assert specs["lm_head/kernel"] == ("fsdp", "tensor")
    assert specs["ln_f/scale"] == ("fsdp",)
    # the heads, d_ff and vocab must split over tensor
    with pytest.raises(ValueError, match="must split"):
        ShardedGPT(dataclasses.replace(cfg, n_heads=2),
                   _mesh({"tensor": 4}))
    with pytest.raises(ValueError, match="does not split"):
        model.loss(tok[:3], tgt[:3])
