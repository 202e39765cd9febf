"""The small-model zoo and the microbatched gradient step against the JAX
package's.

Twins of tests/test_models.py's ``test_linear_toy``,
``test_resnet18_forward_and_step``, ``test_llama_tp_sharding_rules_apply``
and ``test_grad_accumulation_*``, with the same weights carried across:

- the MLP toys (``models/mlp.py``): the reference's functions on the
  port's weights, f32, within 1e-6 (one matmul, one order);
- ResNet-18 (``models/resnet.py``): flax's variables mapped onto the
  module (``resnet_from_jax``), the same NHWC images (NCHW for the port):
  logits in train and eval mode within 1e-4 of the largest logit (17
  layers of f32 convolutions summed in another order), the updated
  running statistics within 1e-5 relative, the parameter count
  11,173,962; one SGD-momentum step (``torch.optim.SGD(0.05,
  momentum=0.9)``) against ``optax.sgd(0.05, momentum=0.9)`` on the same
  loss, two steps (the second reads the momentum), each parameter's update
  within 5e-3 relative norm (the gradients through BatchNorm at batch 4
  carry the convolutions' f32 order differences);
  ``resnet_state_tree`` round-trips bitwise;
- ``make_grad_step(model, microbatches=4)`` against the reference's on the
  same weights in f32 activations (loss 2e-5, each gradient 5e-5,
  relative norms), against the port's own ``microbatches=1`` in the
  configs' bf16 at the reference test's tolerances (loss 1e-3 absolute /
  1e-4 relative, gradients 5e-4 / 0.05), and a ragged batch refused;
- ``tp_rules_gpt`` over the Llama tree: the port's specs equal the JAX
  package's for every leaf.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from torchft_tpu.models import mlp as jmlp
from torchft_tpu.models import transformer as jtf
from torchft_tpu.models.llama import LLAMA_CONFIGS as JLLAMA
from torchft_tpu.models.llama import llama_init_params
from torchft_tpu.parallel import ft_mesh as jft_mesh
from torchft_tpu.parallel import shard_pytree as jshard_pytree
from torchft_tpu.parallel.sharding import tp_rules_gpt as jtp_rules_gpt
from torchft_tpu_torch.models import (
    CONFIGS,
    GPT,
    LLAMA_CONFIGS,
    Llama,
    ResNet18,
    count_params,
    create_resnet18,
    from_jax_params,
    init_linear,
    init_mlp,
    linear_forward,
    llama_param_tree,
    make_grad_step,
    mlp_forward,
    resnet_from_jax,
    resnet_state_tree,
)
from torchft_tpu_torch.models.resnet import load_resnet_state_tree
from torchft_tpu_torch.optim import init_sgd_state
from torchft_tpu_torch.parallel import ft_mesh, shard_pytree, tp_rules_gpt

F32_LOSS, F32_GRAD = 2e-5, 5e-5
SGD_UPDATE_TOL = 5e-3


def _np(tree):
    return jax.tree_util.tree_map(lambda t: t.detach().numpy(), tree)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(1e-30,
                                                  np.linalg.norm(want)))


# ------------------------------------------------------------------- MLP


def test_linear_toy() -> None:
    gen = torch.Generator().manual_seed(0)
    params = init_linear(gen, 2, 3, device="cpu")
    assert params["kernel"].shape == (2, 3) and params["bias"].shape == (3,)
    assert not params["bias"].any()
    x = np.ones((4, 2), np.float32)
    out = linear_forward(params, torch.from_numpy(x))
    assert out.shape == (4, 3)
    want = jmlp.linear_forward(_np(params), jnp.asarray(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=1e-6)
    # the reference's scale: N(0, 0.1^2) kernels
    big = init_linear(torch.Generator().manual_seed(1), 256, 256, "cpu")
    assert abs(float(big["kernel"].std()) - 0.1) < 0.005


def test_mlp_matches_the_reference_on_the_same_weights() -> None:
    gen = torch.Generator().manual_seed(3)
    params = init_mlp(gen, [8, 16, 16, 4], device="cpu")
    assert list(params) == ["dense_0", "dense_1", "dense_2"]
    assert [tuple(p["kernel"].shape) for p in params.values()] == [
        (8, 16), (16, 16), (16, 4)]
    # the reference's tree structure, leaf for leaf
    jparams = jmlp.init_mlp(jax.random.key(0), [8, 16, 16, 4])
    assert jax.tree_util.tree_structure(_np(params)) == \
        jax.tree_util.tree_structure(jparams)
    x = np.random.default_rng(0).standard_normal((5, 8)).astype(np.float32)
    got = mlp_forward(params, torch.from_numpy(x)).numpy()
    want = np.asarray(jmlp.mlp_forward(_np(params), jnp.asarray(x)))
    np.testing.assert_allclose(got, want, atol=1e-6)
    # the same generator state draws the same weights
    again = init_mlp(torch.Generator().manual_seed(3), [8, 16, 16, 4], "cpu")
    assert all(torch.equal(a, b) for a, b in zip(
        jax.tree_util.tree_leaves(params), jax.tree_util.tree_leaves(again)))


# --------------------------------------------------------------- ResNet-18


@pytest.fixture(scope="module")
def flax_resnet():
    pytest.importorskip("flax")
    from torchft_tpu.models.resnet import create_resnet18 as jcreate

    model, variables = jcreate(jax.random.key(0))
    return model, jax.device_get(variables)


def _images(b=4, hw=8, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (b, hw, hw, 3)).astype(np.float32)


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()


def test_resnet18_forward_and_step(flax_resnet) -> None:
    jmodel, variables = flax_resnet
    n = sum(int(np.prod(leaf.shape))
            for leaf in jax.tree_util.tree_leaves(variables["params"]))
    model = ResNet18()
    assert count_params(model) == n == 11_173_962
    model.load_state_dict(resnet_from_jax(variables))
    x = _images()
    jl, new = jmodel.apply(variables, jnp.asarray(x), train=True,
                           mutable=["batch_stats"])
    logits = model(_nchw(x), train=True)
    assert logits.shape == (4, 10) and logits.dtype == torch.float32
    jl = np.asarray(jl)
    assert np.abs(logits.detach().numpy() - jl).max() \
        <= 1e-4 * np.abs(jl).max()
    # the running statistics moved as flax's batch_stats did
    got = resnet_state_tree(model)["batch_stats"]
    for (path, want), (_, have) in zip(
            jax.tree_util.tree_flatten_with_path(
                jax.device_get(new["batch_stats"]))[0],
            jax.tree_util.tree_flatten_with_path(_np(got))[0]):
        np.testing.assert_allclose(have, want, rtol=1e-5, atol=1e-6,
                                   err_msg=jax.tree_util.keystr(path))
    # eval mode on the updated statistics, in both
    updated = dict(variables, batch_stats=jax.device_get(
        new["batch_stats"]))
    je = np.asarray(jmodel.apply(updated, jnp.asarray(x), train=False))
    model.eval()
    te = model(_nchw(x)).detach().numpy()
    assert np.abs(te - je).max() <= 1e-4 * np.abs(je).max()


def test_resnet_state_tree_round_trips_and_keeps_layouts(flax_resnet) -> None:
    _, variables = flax_resnet
    model = create_resnet18(5, device="cpu")
    optimizer = torch.optim.SGD(model.parameters(), lr=0.05, momentum=0.9)
    init_sgd_state(optimizer)
    for p in model.parameters():
        optimizer.state[p]["momentum_buffer"].normal_()
    tree = resnet_state_tree(model, optimizer)
    # the reference's structure and layouts
    want = jax.tree_util.tree_map(np.shape, variables)
    assert jax.tree_util.tree_map(lambda t: tuple(t.shape), {
        k: tree[k] for k in ("params", "batch_stats")}) == want
    assert jax.tree_util.tree_map(lambda t: tuple(t.shape),
                                  tree["opt"]["trace"]) == want["params"]
    other = create_resnet18(6, device="cpu")
    opt2 = torch.optim.SGD(other.parameters(), lr=0.05, momentum=0.9)
    init_sgd_state(opt2)
    load_resnet_state_tree(other, tree, opt2)
    for a, b in zip(model.state_dict().values(), other.state_dict().values()):
        assert torch.equal(a, b)
    for p, q in zip(model.parameters(), other.parameters()):
        assert torch.equal(optimizer.state[p]["momentum_buffer"],
                           opt2.state[q]["momentum_buffer"])
    # copies, not views of the live tensors
    tree["params"]["Dense_0"]["bias"] += 1
    assert not torch.equal(tree["params"]["Dense_0"]["bias"],
                           model.Dense_0.bias)


def test_one_sgd_momentum_step_matches_optax(flax_resnet) -> None:
    jmodel, variables = flax_resnet
    x = _images(seed=1)
    labels = np.random.default_rng(1).integers(0, 10, (4,))
    tx = optax.sgd(0.05, momentum=0.9)

    def jloss(p):
        logits, _ = jmodel.apply({"params": p,
                                  "batch_stats": variables["batch_stats"]},
                                 jnp.asarray(x), train=True,
                                 mutable=["batch_stats"])
        return optax.softmax_cross_entropy(
            logits, jax.nn.one_hot(labels, 10)).mean()

    params = variables["params"]
    opt_state = tx.init(params)
    for _ in range(2):  # the second step reads the momentum
        grads = jax.grad(jloss)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)

    model = ResNet18()
    model.load_state_dict(resnet_from_jax(variables))
    optimizer = torch.optim.SGD(model.parameters(), lr=0.05, momentum=0.9)
    init_sgd_state(optimizer)  # zero buffers: the lazy first step's result
    for _ in range(2):
        model.load_state_dict({k: v for k, v in resnet_from_jax(
            variables).items() if "running" in k}, strict=False)
        optimizer.zero_grad()
        torch.nn.functional.cross_entropy(
            model(_nchw(x), train=True), torch.as_tensor(labels)).backward()
        optimizer.step()
    got = resnet_state_tree(model)["params"]
    worst = 0.0
    for (path, want), (_, have), (_, init) in zip(
            jax.tree_util.tree_flatten_with_path(jax.device_get(params))[0],
            jax.tree_util.tree_flatten_with_path(_np(got))[0],
            jax.tree_util.tree_flatten_with_path(variables["params"])[0]):
        # the two steps' update of each parameter (momentum included)
        rel = _rel(have - init, want - init)
        worst = max(worst, rel)
        assert rel <= SGD_UPDATE_TOL, (jax.tree_util.keystr(path), rel)
    print(f"worst relative norm of an update's difference {worst:.2e}")


# ------------------------------------------------------ sharding rules


def test_llama_tp_sharding_rules_apply() -> None:
    jcfg = JLLAMA["llama_tiny"]
    params = llama_init_params(jcfg, jax.random.key(0))
    jmesh = jft_mesh({"fsdp": 2, "tensor": 2}, devices=jax.devices()[:4])
    jsharded = jshard_pytree(params, jmesh, tp_rules=jtp_rules_gpt())
    model = Llama(LLAMA_CONFIGS["llama_tiny"], device="cpu")
    model.load_state_dict(from_jax_params(jax.device_get(params)))
    mesh = ft_mesh({"fsdp": 2, "tensor": 2}, devices=["cpu"] * 4)
    sharded = shard_pytree(llama_param_tree(model), mesh,
                           tp_rules=tp_rules_gpt())
    l0 = sharded["layers"][0]
    assert l0["attn"]["q_proj"]["kernel"].sharding.spec[1] == "tensor"
    assert l0["attn"]["o_proj"]["kernel"].sharding.spec[0] == "tensor"
    assert l0["mlp"]["gate_proj"]["kernel"].sharding.spec[1] == "tensor"
    assert l0["mlp"]["down_proj"]["kernel"].sharding.spec[0] == "tensor"
    jflat = jax.tree_util.tree_flatten_with_path(jsharded)[0]
    flat = jax.tree_util.tree_flatten_with_path(
        sharded, is_leaf=lambda x: hasattr(x, "sharding"))[0]
    assert [jax.tree_util.keystr(p) for p, _ in jflat] == \
        [jax.tree_util.keystr(p) for p, _ in flat]
    for (path, a), (_, b) in zip(jflat, flat):
        assert tuple(b.sharding.spec) == tuple(a.sharding.spec), \
            jax.tree_util.keystr(path)


# ------------------------------------------------ microbatched grad step


def _batch(cfg, b=4, seed=9):
    tok = np.random.default_rng(seed).integers(0, cfg.vocab_size,
                                               (b, cfg.max_seq_len))
    return tok, np.roll(tok, -1, axis=1)


def test_grad_accumulation_matches_the_reference() -> None:
    jcfg = dataclasses.replace(jtf.CONFIGS["tiny"], dtype=jnp.float32)
    cfg = dataclasses.replace(CONFIGS["tiny"], dtype=torch.float32)
    params = jax.device_get(jtf.init_params(jcfg, jax.random.key(0)))
    model = GPT(cfg, device="cpu")
    model.load_state_dict(from_jax_params(params))
    tok, tgt = _batch(cfg)
    jl, jg = jtf.make_grad_step(jcfg, microbatches=4)(
        params, jnp.asarray(tok, jnp.int32), jnp.asarray(tgt, jnp.int32))
    loss = make_grad_step(model, microbatches=4)(torch.tensor(tok),
                                                 torch.tensor(tgt))
    assert abs(loss.item() - float(jl)) <= F32_LOSS * abs(float(jl))
    flat = dict(jax.tree_util.tree_flatten_with_path(jax.device_get(jg))[0])
    named = dict(model.named_parameters())
    for path, g in flat.items():
        key = ".".join(str(getattr(k, "key", k)) for k in path)
        assert named[key].grad.dtype == torch.float32
        assert _rel(named[key].grad.numpy(), g) <= F32_GRAD, key


def test_grad_accumulation_matches_full_batch() -> None:
    model = GPT(CONFIGS["tiny"], device="cpu", seed=0)
    tok, tgt = (torch.tensor(a) for a in _batch(CONFIGS["tiny"]))
    l1 = make_grad_step(model)(tok, tgt)
    g1 = [p.grad.clone() for p in model.parameters()]
    l4 = make_grad_step(model, microbatches=4)(tok, tgt)
    # bf16 activations: slicing the batch changes matmul tiling, so
    # agreement is at bf16 reassociation level (the reference's tolerances)
    np.testing.assert_allclose(l1.item(), l4.item(), atol=1e-3, rtol=1e-4)
    for a, p in zip(g1, model.parameters()):
        assert p.grad.dtype == p.dtype
        np.testing.assert_allclose(p.grad.numpy(), a.numpy(), atol=5e-4,
                                   rtol=0.05)
    # the step replaces the gradients rather than adding to them
    make_grad_step(model)(tok, tgt)
    assert all(torch.equal(a, p.grad) for a, p in zip(g1, model.parameters()))


def test_grad_accumulation_rejects_ragged_batch() -> None:
    model = GPT(CONFIGS["tiny"], device="cpu")
    tokens = torch.zeros((3, CONFIGS["tiny"].max_seq_len), dtype=torch.long)
    with pytest.raises(ValueError, match="microbatches"):
        make_grad_step(model, microbatches=2)(tokens, tokens)
