"""The port's Llama family against the JAX package's ``models/llama.py``.

Twins of ``tests/test_models.py``'s llama tests, then the cross-package
checks: the JAX package's ``llama_init_params`` weights are carried onto
the port's module with ``from_jax_params`` and the same numpy tokens go
through both ``llama_loss_fn`` s: dense, chunked (``xent_chunks``) and with
``attn_fn`` a ring over 4 sequence shards (the JAX ring on 4 of conftest's
CPU devices, the port's over a virtual mesh of 4 CPU shards). Tolerances:
in f32 activations 1e-5 on the loss and 1e-4 relative to each parameter's
largest gradient entry (summation order only); in bf16 activations (the
configs' default) 2e-3 and 5e-2 (bf16 rounds at other places in the two
frameworks), as the GPT's twins.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torchft_tpu import checkpointing as jckpt
from torchft_tpu.models import llama as jl
from torchft_tpu.parallel import ft_mesh as jft_mesh
from torchft_tpu.parallel import make_ring_attention as jmake_ring
from torchft_tpu_torch import checkpointing
from torchft_tpu_torch.models import (
    LLAMA_CONFIGS,
    Llama,
    LlamaConfig,
    from_jax_params,
    llama_forward,
    llama_init_params,
    llama_loss_fn,
    llama_param_tree,
)
from torchft_tpu_torch.models.llama import repeat_kv
from torchft_tpu_torch.ops.attention import reference_attention
from torchft_tpu_torch.ops.flash import flash_attention
from torchft_tpu_torch.parallel import ft_mesh, make_ring_attention

CASES = {
    "f32": (torch.float32, jnp.float32, 1e-5, 1e-4),
    "bf16": (torch.bfloat16, jnp.bfloat16, 2e-3, 5e-2),
}


def _flat(tree, prefix=""):
    """Dotted state-dict keys of a nested dict/list pytree."""
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        key = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, (dict, list)):
            out.update(_flat(v, key))
        else:
            out[key] = v
    return out


def _data(cfg, batch=2, seed=0):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab_size, (batch, cfg.max_seq_len))
    return tok, np.roll(tok, -1, axis=1)


def _pair(dtype_case, xent_chunks=0, seed=0, **kw):
    tdt, jdt, _, _ = CASES[dtype_case]
    jcfg = dataclasses.replace(jl.LLAMA_CONFIGS["llama_tiny"], dtype=jdt,
                               xent_chunks=xent_chunks, **kw)
    cfg = dataclasses.replace(LLAMA_CONFIGS["llama_tiny"], dtype=tdt,
                              xent_chunks=xent_chunks, **kw)
    params = jax.device_get(jl.llama_init_params(jcfg, jax.random.key(seed)))
    model = Llama(cfg, device="cpu")
    model.load_state_dict(from_jax_params(params))
    return jcfg, cfg, params, model


# ------------------------------------------------------- twins (port only)


def test_llama_forward_and_grads() -> None:
    cfg = LLAMA_CONFIGS["llama_tiny"]
    model = llama_init_params(cfg, device="cpu", seed=0)
    tok, tgt = (torch.tensor(a) for a in _data(cfg))
    loss = llama_loss_fn(cfg, model, tok, tgt)
    loss.backward()
    assert np.isfinite(loss.item())
    gnorm = sum(float((p.grad.float() ** 2).sum())
                for p in model.parameters())
    assert np.isfinite(gnorm) and gnorm > 0
    # GQA present: kv projection narrower than q projection
    attn = model.layers[0].attn
    assert attn.k_proj.kernel.shape[1] < attn.q_proj.kernel.shape[1]


def test_llama_gqa_shapes() -> None:
    cfg = LLAMA_CONFIGS["llama_120m"]
    model = Llama(cfg, device="meta")
    attn = model.layers[0].attn
    assert tuple(attn.q_proj.kernel.shape) == (768, 768)
    assert tuple(attn.k_proj.kernel.shape) == (768, 4 * 64)
    assert tuple(attn.v_proj.kernel.shape) == (768, 4 * 64)
    assert tuple(model.layers[0].mlp.gate_proj.kernel.shape) == (768, 2048)
    assert sum(p.numel() for p in model.parameters()) == 125848320
    tiny = LLAMA_CONFIGS["llama_tiny"]
    logits = llama_forward(tiny, Llama(tiny, device="cpu"),
                           torch.zeros((2, 16), dtype=torch.long))
    assert logits.shape == (2, 16, tiny.vocab_size)
    assert logits.dtype == torch.float32
    with pytest.raises(ValueError, match="GQA"):
        LlamaConfig(n_heads=8, n_kv_heads=3)
    with pytest.raises(ValueError, match="even"):
        LlamaConfig(d_model=24, n_heads=8, n_kv_heads=4)
    with pytest.raises(ValueError, match="n_heads"):
        LlamaConfig(d_model=100, n_heads=8)


def test_llama_trains_and_flash_matches() -> None:
    cfg = LLAMA_CONFIGS["llama_tiny"]
    model = Llama(cfg, device="cpu", seed=1)
    tok, tgt = (torch.tensor(a) for a in _data(cfg, batch=4, seed=1))

    # the flash path (its plain version on the CPU) plugs into the GQA
    # path through the head repeat
    def flash_fn(q, k, v):
        return flash_attention(q, k, v, causal=True, block_q=64, block_k=64)

    def ref_fn(q, k, v):
        return reference_attention(q, k, v, causal=True)

    with torch.no_grad():
        l_ref = llama_loss_fn(cfg, model, tok, tgt, attn_fn=ref_fn)
        l_fl = llama_loss_fn(cfg, model, tok, tgt, attn_fn=flash_fn)
    # bf16 activations: kernel-formulation noise only
    assert abs(l_ref.item() - l_fl.item()) < 2e-2

    opt = torch.optim.Adam(model.parameters(), lr=3e-3)
    losses = []
    for _ in range(8):
        opt.zero_grad()
        loss = model.loss(tok, tgt)
        loss.backward()
        opt.step()
        losses.append(loss.item())
    assert losses[-1] < losses[0] - 0.1, losses


def test_llama_init_scheme_and_seed() -> None:
    cfg = LLAMA_CONFIGS["llama_tiny"]
    a, b, c = (Llama(cfg, device="cpu", seed=s).state_dict()
               for s in (3, 3, 4))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["lm_head.kernel"], c["lm_head.kernel"])
    assert torch.equal(a["final_norm.scale"], torch.ones(64))
    assert 0.015 < float(a["tok_embed.embedding"].std()) < 0.025
    # kernels N(0, 2 / (fan_in + fan_out)), the reference's dense()
    std = float(a["layers.0.mlp.gate_proj.kernel"].std())
    assert abs(std - np.sqrt(2 / (64 + 176))) < 0.01


def test_llama_default_device_is_cuda() -> None:
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU; the default device works")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Llama(LLAMA_CONFIGS["llama_tiny"])


def test_remat_on_equals_remat_off() -> None:
    cfg = LLAMA_CONFIGS["llama_tiny"]
    tok, tgt = (torch.tensor(a) for a in _data(cfg))
    out = []
    for remat in (False, True):
        model = Llama(dataclasses.replace(cfg, remat=remat), device="cpu")
        loss = model.loss(tok, tgt)
        loss.backward()
        out.append((loss.detach(), [p.grad for p in model.parameters()]))
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))


def test_gqa_repeat_equals_jnp_repeat_bitwise() -> None:
    x = np.random.default_rng(5).standard_normal((2, 8, 3, 4)).astype(
        np.float32)
    want = np.asarray(jnp.repeat(jnp.asarray(x), 4, axis=2))
    got = repeat_kv(torch.tensor(x), 4).numpy()
    assert got.shape == (2, 8, 12, 4)
    assert got.tobytes() == want.tobytes()
    # a tiled repeat gives other heads: the model would train and be wrong
    tiled = torch.tensor(x).repeat(1, 1, 4, 1).numpy()
    assert tiled.tobytes() != want.tobytes()
    assert repeat_kv(torch.tensor(x), 1).numpy().tobytes() == x.tobytes()


# --------------------------------------------------- port against the JAX


def _jax_loss_and_grads(jcfg, params, tok, tgt, attn_fn=None):
    return jax.value_and_grad(
        lambda p: jl.llama_loss_fn(jcfg, p, jnp.asarray(tok, jnp.int32),
                                   jnp.asarray(tgt, jnp.int32),
                                   attn_fn=attn_fn))(params)


def _check_against_jax(model, cfg, jl_loss, jgrads, tok, tgt, tols,
                       attn_fn=None) -> None:
    _, _, loss_tol, grad_tol = tols
    loss = llama_loss_fn(cfg, model, torch.tensor(tok), torch.tensor(tgt),
                         attn_fn=attn_fn)
    loss.backward()
    assert abs(loss.item() - float(jl_loss)) <= loss_tol, (
        loss.item(), float(jl_loss))
    grads = dict(model.named_parameters())
    flat = _flat(jax.device_get(jgrads))
    assert set(flat) == set(grads)
    for key, g in flat.items():
        got = grads[key].grad.numpy()
        g = np.asarray(g, dtype=np.float32)
        assert np.abs(got - g).max() <= grad_tol * np.abs(g).max(), key


@pytest.mark.parametrize("xent_chunks", [0, 4])
@pytest.mark.parametrize("dtype_case", ["f32", "bf16"])
def test_loss_and_grads_match_jax(dtype_case, xent_chunks) -> None:
    jcfg, cfg, params, model = _pair(dtype_case, xent_chunks)
    tok, tgt = _data(cfg)
    jloss, jgrads = _jax_loss_and_grads(jcfg, params, tok, tgt)
    _check_against_jax(model, cfg, jloss, jgrads, tok, tgt,
                       CASES[dtype_case])


@pytest.mark.parametrize("impl", ["einsum", "flash"])
def test_ring_loss_and_grads_match_jax(impl, monkeypatch) -> None:
    # the port's ring over 4 CPU shards against the JAX package's over 4
    # CPU devices, both exact: f32 activations, f32 tolerances
    monkeypatch.setenv("TORCHFT_TPU_PALLAS_INTERPRET", "1")
    jcfg, cfg, params, model = _pair("f32", 4)
    tok, tgt = _data(cfg)
    jmesh = jft_mesh({"seq": 4}, devices=jax.devices()[:4])
    jring = jmake_ring(jmesh, "seq", causal=True, block_impl=impl,
                       block_q=32, block_k=32)
    with jmesh:
        jloss, jgrads = jax.jit(lambda p: _jax_loss_and_grads(
            jcfg, p, tok, tgt, attn_fn=jring))(params)
    ring = make_ring_attention(ft_mesh({"seq": 4}, devices=["cpu"] * 4),
                               "seq", causal=True, block_impl=impl,
                               block_q=32, block_k=32)
    _check_against_jax(model, cfg, jloss, jgrads, tok, tgt, CASES["f32"],
                       attn_fn=ring)


def test_forward_logits_match_jax() -> None:
    jcfg, cfg, params, model = _pair("f32")
    tok = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 32))
    want = jl.llama_forward(jcfg, params, jnp.asarray(tok, jnp.int32))
    with torch.no_grad():
        got = model(torch.tensor(tok))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


def test_parameter_names_and_layouts_mirror_jax() -> None:
    for name in ("llama_tiny", "llama_120m"):
        jcfg = jl.LLAMA_CONFIGS[name]
        shapes = jax.eval_shape(lambda k: jl.llama_init_params(jcfg, k),
                                jax.random.key(0))
        jshapes = {k: tuple(v.shape) for k, v in _flat(shapes).items()}
        model = Llama(LLAMA_CONFIGS[name], device="meta")
        assert {k: tuple(p.shape) for k, p in model.named_parameters()} \
            == jshapes


def test_heal_manifest_lists_the_reference_leaves() -> None:
    # a heal manifest over {"params": llama_param_tree(model)} lists the
    # reference's leaves: the same paths in the same order, shapes, dtypes
    jcfg, cfg, params, model = _pair("f32")
    tree = llama_param_tree(model)
    want = jckpt._build_staged(0, {"params": params}, lazy=True).entries
    got = checkpointing._build_staged(0, {"params": tree}).entries
    assert [e["path"] for e in got] == [e["path"] for e in want]
    assert [(e["shape"], e["dtype"]) for e in got] == \
        [(tuple(e["shape"]), e["dtype"]) for e in want]
    assert got[0]["path"] == "['params']['final_norm']['scale']"
    # the tree holds the live parameters and maps back onto the model
    sd = from_jax_params(tree)
    assert all(sd[k].data_ptr() == p.data_ptr()
               for k, p in model.named_parameters())
