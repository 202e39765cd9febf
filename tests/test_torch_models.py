"""The port's GPT against the JAX package's transformer.

The JAX parameters of the "tiny" config (from ``init_params``) are mapped
onto the port's module with ``from_jax_params``; the same numpy tokens go
through both. Tolerances: in f32 activations, 1e-5 on the loss and 1e-4
relative to each parameter's largest gradient entry (summation order
only); in bf16 activations (the configs' default), 2e-3 on the loss and
5e-2 relative on the gradients (bf16 rounds at other places in the two
frameworks).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torchft_tpu.models import transformer as jtf
from torchft_tpu_torch.models import (
    CONFIGS,
    GPT,
    count_params,
    from_jax_params,
    loss_fn,
)

CASES = {
    "f32": (torch.float32, jnp.float32, 1e-5, 1e-4),
    "bf16": (torch.bfloat16, jnp.bfloat16, 2e-3, 5e-2),
}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flat(v, key))
        else:
            out[key] = v
    return out


def _pair(dtype_case, xent_chunks, seed=0):
    tdt, jdt, _, _ = CASES[dtype_case]
    jcfg = dataclasses.replace(jtf.CONFIGS["tiny"], dtype=jdt,
                               xent_chunks=xent_chunks)
    cfg = dataclasses.replace(CONFIGS["tiny"], dtype=tdt,
                              xent_chunks=xent_chunks)
    params = jax.device_get(jtf.init_params(jcfg, jax.random.key(seed)))
    model = GPT(cfg, device="cpu")
    model.load_state_dict(from_jax_params(params))
    return jcfg, cfg, params, model


@pytest.mark.parametrize("xent_chunks", [0, 4])
@pytest.mark.parametrize("dtype_case", ["f32", "bf16"])
def test_loss_and_grads_match_jax(dtype_case, xent_chunks) -> None:
    _, _, loss_tol, grad_tol = CASES[dtype_case]
    jcfg, cfg, params, model = _pair(dtype_case, xent_chunks)
    rng = np.random.default_rng(0)
    tok = rng.integers(0, cfg.vocab_size, (2, cfg.max_seq_len))
    tgt = np.roll(tok, -1, axis=1)
    jl, jg = jtf.make_grad_step(jcfg)(
        params, jnp.asarray(tok, jnp.int32), jnp.asarray(tgt, jnp.int32)
    )
    loss = loss_fn(cfg, model, torch.tensor(tok), torch.tensor(tgt))
    loss.backward()
    assert abs(loss.item() - float(jl)) <= loss_tol
    grads = dict(model.named_parameters())
    for key, g in _flat(jax.device_get(jg)).items():
        got = grads[key].grad.numpy()
        g = np.asarray(g)
        assert np.abs(got - g).max() <= grad_tol * np.abs(g).max(), key


def test_forward_logits_match_jax() -> None:
    jcfg, cfg, params, model = _pair("f32", 0)
    tok = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 32))
    jlogits = jtf.forward(jcfg, params, jnp.asarray(tok, jnp.int32))
    with torch.no_grad():
        logits = model(torch.tensor(tok))
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=1e-4, rtol=1e-4)


def test_parameter_names_and_layouts_mirror_jax() -> None:
    for name in ("tiny", "125m"):
        jcfg = jtf.CONFIGS[name]
        shapes = jax.eval_shape(lambda k: jtf.init_params(jcfg, k),
                                jax.random.key(0))
        jshapes = {k: tuple(v.shape)
                   for k, v in _flat(shapes, "").items()}
        tshapes = _meta_shapes(CONFIGS[name])
        assert tshapes == jshapes
        assert sum(int(np.prod(s)) for s in tshapes.values()) == \
            jtf.count_params(shapes)


def _meta_shapes(cfg):
    """Parameter shapes of GPT(cfg) without allocating them."""
    from torchft_tpu_torch.models import transformer as ttf

    d = cfg.d_model
    out = {"wte.embedding": (cfg.vocab_size, d),
           "wpe.embedding": (cfg.max_seq_len, d),
           "ln_f.scale": (d,), "ln_f.bias": (d,),
           "lm_head.kernel": (d, cfg.vocab_size)}
    with torch.device("meta"):
        block = ttf.Block(cfg)
    for i in range(cfg.n_layers):
        for k, p in block.named_parameters():
            out[f"layers_{i}.{k}"] = tuple(p.shape)
    assert set(out) == {k for k, _ in GPT(
        dataclasses.replace(CONFIGS["tiny"], n_layers=cfg.n_layers),
        device="cpu").named_parameters()}
    return out


def test_count_params_tiny() -> None:
    cfg = CONFIGS["tiny"]
    model = GPT(cfg, device="cpu")
    jparams = jtf.init_params(jtf.CONFIGS["tiny"], jax.random.key(0))
    assert count_params(model) == jtf.count_params(jparams)


def test_default_device_is_cuda_and_never_falls_back() -> None:
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU; the default device works")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GPT(CONFIGS["tiny"])


def test_init_scheme_and_seed() -> None:
    a = GPT(CONFIGS["tiny"], device="cpu", seed=3)
    b = GPT(CONFIGS["tiny"], device="cpu", seed=3)
    c = GPT(CONFIGS["tiny"], device="cpu", seed=4)
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["lm_head.kernel"], sc["lm_head.kernel"])
    assert torch.equal(sa["ln_f.scale"], torch.ones(64))
    assert torch.equal(sa["layers_0.ln_1.bias"], torch.zeros(64))
    std = float(sa["wte.embedding"].std())
    assert 0.015 < std < 0.025


def test_train_step_reduces_loss() -> None:
    cfg = CONFIGS["tiny"]
    model = GPT(cfg, device="cpu")
    opt = torch.optim.AdamW(model.parameters(), lr=3e-3, weight_decay=1e-4)
    tok = torch.tensor(np.random.default_rng(0).integers(0, 512, (4, 128)))
    tgt = torch.roll(tok, -1, dims=1)
    first = None
    for _ in range(5):
        opt.zero_grad()
        loss = model.loss(tok, tgt)
        loss.backward()
        opt.step()
        first = loss.item() if first is None else first
    assert model.loss(tok, tgt).item() < first


def test_ring_attention_not_ported() -> None:
    cfg = dataclasses.replace(CONFIGS["tiny"], attention="ring")
    with pytest.raises(ValueError, match="not ported"):
        GPT(cfg, device="cpu")
