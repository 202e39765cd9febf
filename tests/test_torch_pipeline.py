"""The port's in-group pipeline (``parallel/{schedule,pipeline}.py``)
against the JAX package's.

Twins of ``tests/test_pipeline.py``: the same numpy inputs go through the
JAX function on a ``{"stage": S}`` mesh of conftest's CPU devices and
through the port's on a virtual ``{"stage": S}`` mesh of the CPU (the
positions in lock-step in one process). Tolerances, in f32: the GPipe
forward within 1e-5 (atol and rtol) of the reference and of the
sequential stages, its gradients within 1e-4; the 1F1B and interleaved
runners within the reference's own (rtol 1e-5 on the loss, rtol 1e-4 /
atol 1e-6 on the gradients). The schedule tables must equal the
reference's entry by entry.

Then a pipelined GPT: "tiny" widths at depth 4 over ``{"stage": 4}``, one
layer a stage, M = 4, the embedding before the pipeline and ``ln_f``,
the head and the loss after it. Against the JAX package's
``make_pipeline`` over its ``_block`` (the embedding fed in as the
pipeline's input, ``jax.grad`` of the loss): in f32 activations the loss
within 1e-5 and every stage gradient within 1e-4 of its largest entry; in
bf16 (the config's) 2e-3 and 5e-2, as ``tests/test_torch_models.py``
holds the unpipelined GPT. And against the port's own unpipelined
``GPT`` on the same weights: the loss and every gradient, the embedding's
included, within the f32 tolerances (the same products in another
grouping of the batch).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding as JNamedSharding
from jax.sharding import PartitionSpec as JP

import torchft_tpu.parallel as jpar
from torchft_tpu.models import transformer as jtf
from torchft_tpu.parallel import pipeline as jpipe
from torchft_tpu_torch.models import CONFIGS, GPT, from_jax_params
from torchft_tpu_torch.models.transformer import _block, _layer_norm
from torchft_tpu_torch.parallel import (
    NamedSharding,
    PartitionSpec as P,
    ShardedTensor,
    bubble_fraction,
    ft_mesh,
    gpipe_schedule,
    interleaved_1f1b_schedule,
    interleaved_tables,
    make_pipeline,
    make_pipeline_1f1b,
    make_pipeline_interleaved_1f1b,
    merge_microbatches,
    one_f_one_b_schedule,
    peak_inflight_activations,
    split_microbatches,
    stack_interleaved_params,
    stack_stage_params,
    validate_schedule,
)
from torchft_tpu_torch.parallel import pipeline as pipe


def _jmesh(n: int):
    return jpar.ft_mesh({"stage": n}, devices=jax.devices()[:n])


def _mesh(n: int):
    return ft_mesh({"stage": n}, devices=["cpu"] * n)


def _stages(num_stages, d, seed):
    rng = np.random.default_rng(seed)
    return [{"w": (rng.standard_normal((d, d)) * 0.5).astype(np.float32),
             "b": (rng.standard_normal(d) * 0.1).astype(np.float32)}
            for _ in range(num_stages)]


def _jax_stage(params, h):
    return jax.nn.relu(h @ params["w"] + params["b"])


def _stage(params, h):
    return torch.relu(h @ params["w"] + params["b"])


def _t(tree):
    return jax.tree_util.tree_map(torch.from_numpy, tree)


def _stage_split(tree, mesh):
    """Stacked leaves as ShardedTensors split on dim 0 over "stage", each
    piece a leaf that autograd reaches."""
    def cut(leaf):
        spec = P("stage", *([None] * (leaf.ndim - 1)))
        st = ShardedTensor.from_full(leaf, NamedSharding(mesh, spec))
        for p in st.pieces:
            p.requires_grad_(True)
        return st
    return jax.tree_util.tree_map(cut, tree)


@pytest.mark.parametrize("num_stages,d,batch,m,seeds", [
    (4, 8, 16, 8, (0, 1)),   # test_pipeline_matches_sequential
    (8, 4, 8, 4, (2, 3)),    # test_pipeline_eight_stages
])
def test_pipeline_matches_sequential(num_stages, d, batch, m, seeds) -> None:
    stages = _stages(num_stages, d, seeds[0])
    x = np.random.default_rng(seeds[1]).standard_normal(
        (batch, d)).astype(np.float32)
    ref = np.asarray(merge_microbatches(jax.jit(jpipe.make_pipeline(
        _jmesh(num_stages), _jax_stage))(
            jpipe.stack_stage_params([jax.tree_util.tree_map(jnp.asarray, p)
                                      for p in stages]),
            jpipe.split_microbatches(jnp.asarray(x), m))))
    mesh = _mesh(num_stages)
    stacked = stack_stage_params([_t(p) for p in stages])
    out = merge_microbatches(make_pipeline(mesh, _stage)(
        stacked, split_microbatches(torch.from_numpy(x), m)))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=1e-5)
    h = torch.from_numpy(x)
    for p in stages:
        h = _stage(_t(p), h)
    np.testing.assert_allclose(out.numpy(), h.numpy(), atol=1e-5, rtol=1e-5)
    # the same with the stacked leaves split over the stage axis
    sharded = make_pipeline(mesh, _stage)(
        _stage_split(stacked, mesh), split_microbatches(torch.from_numpy(x),
                                                        m))
    assert torch.equal(merge_microbatches(sharded), out)


@pytest.mark.parametrize("layout", ["stacked", "stage_split"])
def test_pipeline_gradients_match_sequential(layout) -> None:
    num_stages, d, batch, m = 4, 6, 8, 4
    stages = _stages(num_stages, d, 4)
    x = np.random.default_rng(5).standard_normal((batch, d)).astype(
        np.float32)
    jstacked = jpipe.stack_stage_params(
        [jax.tree_util.tree_map(jnp.asarray, p) for p in stages])
    jpp = jpipe.make_pipeline(_jmesh(num_stages), _jax_stage)
    jmb = jpipe.split_microbatches(jnp.asarray(x), m)
    ref = jax.jit(jax.grad(lambda s: jnp.sum(jpp(s, jmb) ** 2)))(jstacked)

    mesh = _mesh(num_stages)
    stacked = stack_stage_params([_t(p) for p in stages])
    if layout == "stacked":
        stacked = jax.tree_util.tree_map(
            lambda l: l.requires_grad_(True), stacked)
    else:
        stacked = _stage_split(stacked, mesh)
    out = make_pipeline(mesh, _stage)(
        stacked, split_microbatches(torch.from_numpy(x), m))
    (out ** 2).sum().backward()
    for name in ("w", "b"):
        leaf = stacked[name]
        got = (torch.cat([p.grad for p in leaf.pieces])
               if isinstance(leaf, ShardedTensor) else leaf.grad)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref[name]),
                                   atol=1e-4, rtol=1e-4)


def test_microbatch_helpers() -> None:
    x = torch.arange(24).reshape(12, 2)
    mb = split_microbatches(x, 3)
    assert tuple(mb.shape) == (3, 4, 2)
    assert torch.equal(merge_microbatches(mb), x)
    with pytest.raises(ValueError):
        split_microbatches(x, 5)


def _tables_equal(a, b) -> None:
    assert set(a) == set(b)
    for key in a:
        assert a[key] == b[key], key


@pytest.mark.parametrize("S,M,V", [(4, 16, 2), (2, 3, 2), (4, 8, 2),
                                   (2, 4, 3), (4, 8, 1), (3, 5, 2),
                                   (4, 4, 3)])
def test_schedule_properties(S, M, V) -> None:
    # every table equals the reference's, entry by entry
    assert gpipe_schedule(S, M) == jpar.gpipe_schedule(S, M)
    assert one_f_one_b_schedule(S, M) == jpar.one_f_one_b_schedule(S, M)
    iv = interleaved_1f1b_schedule(S, M, interleave=V)
    assert iv == jpar.interleaved_1f1b_schedule(S, M, interleave=V)
    _tables_equal(interleaved_tables(S, M, V),
                  jpar.interleaved_tables(S, M, V))
    for sched in (gpipe_schedule(S, M), one_f_one_b_schedule(S, M), iv):
        assert bubble_fraction(sched) == jpar.bubble_fraction(sched)
        assert peak_inflight_activations(sched) == \
            jpar.peak_inflight_activations(sched)
    # the reference test's facts, at its S = 4, M = 16
    if (S, M, V) != (4, 16, 2):
        return
    g, o = gpipe_schedule(S, M), one_f_one_b_schedule(S, M)
    validate_schedule(g, S, M)
    validate_schedule(o, S, M)
    assert len(g) == len(o)
    assert abs(bubble_fraction(g) - bubble_fraction(o)) < 1e-9
    assert peak_inflight_activations(g) == M
    assert peak_inflight_activations(o) == S
    validate_schedule(iv, S, M, interleave=2)
    assert bubble_fraction(iv) < bubble_fraction(g) - 0.02


def test_pipeline_embed_readout_heterogeneous_shapes() -> None:
    S, vocab, d = 4, 11, 8
    rng = np.random.default_rng(0)
    emb = (rng.standard_normal((vocab, d)) * 0.3).astype(np.float32)
    head = (rng.standard_normal((d, vocab)) * 0.3).astype(np.float32)
    stage_params = [{"w": (rng.standard_normal((d, d)) * 0.3).astype(
        np.float32)} for _ in range(S)]
    tokens = rng.integers(0, vocab, (8,)).astype(np.int32)

    jpp = jpipe.make_pipeline(
        _jmesh(S), lambda p, h: jnp.tanh(h @ p["w"]),
        embed_fn=lambda tok: jnp.asarray(emb)[tok],
        readout_fn=lambda h: h @ jnp.asarray(head))
    ref = np.asarray(jax.jit(jpp)(
        jpipe.stack_stage_params([jax.tree_util.tree_map(jnp.asarray, p)
                                  for p in stage_params]),
        jpipe.split_microbatches(jnp.asarray(tokens), 4)))

    t_emb, t_head = torch.from_numpy(emb), torch.from_numpy(head)
    pp = make_pipeline(_mesh(S), lambda p, h: torch.tanh(h @ p["w"]),
                       embed_fn=lambda tok: t_emb[tok],
                       readout_fn=lambda h: h @ t_head)
    out = pp(stack_stage_params([_t(p) for p in stage_params]),
             split_microbatches(torch.from_numpy(tokens).long(), 4))
    assert tuple(out.shape) == (4, 2, vocab)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-6)
    h = t_emb[torch.from_numpy(tokens).long()]
    for p in stage_params:
        h = torch.tanh(h @ torch.from_numpy(p["w"]))
    np.testing.assert_allclose(out.numpy().reshape(8, vocab),
                               (h @ t_head).numpy(), rtol=1e-5, atol=1e-6)


def _tanh_stage(p, h):
    return torch.tanh(h @ p["w"])


def _mse(h, y):
    return torch.mean((h - y) ** 2)


@pytest.mark.parametrize("V,seed,scale", [
    (None, 1, 0.4),   # test_pipeline_1f1b_matches_sequential_grads
    (2, 5, 0.35),     # test_pipeline_interleaved_1f1b_matches_...
    (3, 7, 0.35),     # one layer a virtual stage, as the card's drill
])
def test_pipeline_1f1b_matches_sequential_grads(V, seed, scale) -> None:
    S, M, mb_size, d = 4, 8, 2, 6
    n = S * (V or 1)
    rng = np.random.default_rng(seed)
    virtual = [{"w": (rng.standard_normal((d, d)) * scale).astype(
        np.float32)} for _ in range(n)]
    x = rng.standard_normal((M * mb_size, d)).astype(np.float32)
    y = rng.standard_normal((M * mb_size, d)).astype(np.float32)
    jx, jy = (jpipe.split_microbatches(jnp.asarray(a), M) for a in (x, y))
    jvirtual = [jax.tree_util.tree_map(jnp.asarray, p) for p in virtual]

    def jloss(h, y_mb):
        return jnp.mean((h - y_mb) ** 2)

    def jstage(p, h):
        return jnp.tanh(h @ p["w"])

    if V is None:
        jstacked = jpipe.stack_stage_params(jvirtual)
        jrun = jpipe.make_pipeline_1f1b(_jmesh(S), jstage, jloss, M)
    else:
        jstacked = jpipe.stack_interleaved_params(jvirtual, S, V)
        jrun = jpipe.make_pipeline_interleaved_1f1b(_jmesh(S), jstage, jloss,
                                                    M, V)
    ref_l, ref_g = jax.jit(jrun)(jstacked, jx, jy)

    def seq_loss(stacked_p):
        # sequential over the virtual stages (rows are device-major)
        total = 0.0
        for k in range(M):
            h = jx[k]
            for v in range(n):
                s, c = v % S, v // S
                h = jstage(jax.tree_util.tree_map(
                    lambda l: l[s * (V or 1) + c], stacked_p), h)
            total = total + jloss(h, jy[k])
        return total / M

    seq_l, seq_g = jax.value_and_grad(seq_loss)(jstacked)

    mesh = _mesh(S)
    tvirtual = [_t(p) for p in virtual]
    if V is None:
        stacked = stack_stage_params(tvirtual)
        run = make_pipeline_1f1b(mesh, _tanh_stage, _mse, M)
    else:
        stacked = stack_interleaved_params(tvirtual, S, V)
        run = make_pipeline_interleaved_1f1b(mesh, _tanh_stage, _mse, M, V)
    xm, ym = (split_microbatches(torch.from_numpy(a), M) for a in (x, y))
    loss, grads = run(stacked, xm, ym)
    for want_l, want_g in ((ref_l, ref_g), (seq_l, seq_g)):
        np.testing.assert_allclose(float(loss), float(want_l), rtol=1e-5)
        np.testing.assert_allclose(grads["w"].numpy(),
                                   np.asarray(want_g["w"]),
                                   rtol=1e-4, atol=1e-6)
    if V is None:
        assert run.stats["peak_inflight"] == peak_inflight_activations(
            one_f_one_b_schedule(S, M)) == S
    # the same run over stage-split leaves returns stage-split gradients
    split = _stage_split(stacked, mesh)
    loss2, grads2 = run(split, xm, ym)
    assert float(loss2) == float(loss)
    assert isinstance(grads2["w"], ShardedTensor)
    assert grads2["w"].sharding == split["w"].sharding
    assert torch.equal(grads2["w"].full(), grads["w"])
    assert all(p.grad is None for p in split["w"].pieces)


@pytest.mark.parametrize("S,M,V", [(2, 3, 2), (4, 8, 2), (2, 4, 3),
                                   (4, 8, 1), (3, 5, 2)])
def test_interleaved_tables_dataflow_sound(S, M, V) -> None:
    # Symbolically execute the static tables: every forward must read the
    # value its upstream virtual stage produced, every backward the right
    # activation and cotangent, and nothing is overwritten while live.
    tbl = interleaved_tables(S, M, V)
    _tables_equal(tbl, jpar.interleaved_tables(S, M, V))
    _dataflow_sound(tbl, S, M, V)
    if V == 1:
        # the 1F1B runner's own tables (slot mb % S) are sound too
        _dataflow_sound(pipe._one_f_one_b_tables(S, M), S, M, 1)


def _dataflow_sound(tbl, S, M, V) -> None:
    T = tbl["ticks"]
    total_v = V * S
    fwd_buf = [dict() for _ in range(S)]   # slot -> value id (v, mb)
    bwd_buf = [dict() for _ in range(S)]
    act_buf = [dict() for _ in range(S)]
    h_chan = [None] * S  # value arriving at device s this tick
    g_chan = [None] * S
    f_done = set()
    b_done = set()
    for t in range(T):
        for s in range(S):
            fs = tbl["f_stash"][t][s]
            if fs >= 0:
                assert h_chan[s] is not None, (t, s)
                fwd_buf[s][fs] = h_chan[s]
            bs = tbl["b_stash"][t][s]
            if bs >= 0:
                assert g_chan[s] is not None, (t, s)
                bwd_buf[s][bs] = g_chan[s]
        h_next = [None] * S
        g_next = [None] * S
        for s in range(S):
            f_mb = tbl["f_mb"][t][s]
            if f_mb >= 0:
                c = tbl["f_chunk"][t][s]
                v = c * S + s
                src = tbl["f_src"][t][s]
                if v == 0:
                    assert src == -1
                else:
                    assert fwd_buf[s].get(src) == (v - 1, f_mb), (t, s, v)
                slot = tbl["f_act"][t][s]
                assert slot not in act_buf[s], (t, s, slot)
                act_buf[s][slot] = (v, f_mb)
                f_done.add((v, f_mb))
                if v + 1 < total_v:
                    h_next[(s + 1) % S] = (v, f_mb)
            b_mb = tbl["b_mb"][t][s]
            if b_mb >= 0:
                c = tbl["b_chunk"][t][s]
                v = c * S + s
                assert (v, b_mb) in f_done
                assert act_buf[s].pop(tbl["b_act"][t][s]) == (v, b_mb)
                gsrc = tbl["b_gsrc"][t][s]
                if v == total_v - 1:
                    assert gsrc == -1
                else:
                    assert bwd_buf[s].get(gsrc) == (v + 1, b_mb), (t, s, v)
                b_done.add((v, b_mb))
                if v - 1 >= 0:
                    g_next[(s - 1) % S] = (v, b_mb)
        h_chan, g_chan = h_next, g_next
    assert len(f_done) == total_v * M
    assert len(b_done) == total_v * M


# ------------------------------------------------------- pipelined GPT

DTYPES = {"f32": (torch.float32, jnp.float32, 1e-5, 1e-4),
          "bf16": (torch.bfloat16, jnp.bfloat16, 2e-3, 5e-2)}


def _gpt_pair(dtype_case):
    tdt, jdt, _, _ = DTYPES[dtype_case]
    jcfg = dataclasses.replace(jtf.CONFIGS["tiny"], n_layers=4, dtype=jdt)
    cfg = dataclasses.replace(CONFIGS["tiny"], n_layers=4, dtype=tdt)
    params = jax.device_get(jtf.init_params(jcfg, jax.random.key(3)))
    return jcfg, cfg, params


def _pipelined_loss(cfg, tree, tok, tgt, S=4, M=4):
    """The port's pipelined GPT: embed, the blocks over the stage axis (one
    layer a stage), ln_f, the head and the loss. ``tree``: the whole
    model's leaves (torch tensors) in the reference's structure."""
    dt = cfg.dtype
    layers = [tree[f"layers_{i}"] for i in range(cfg.n_layers)]
    stacked = stack_stage_params(layers)
    x = tree["wte"]["embedding"].to(dt)[tok]
    x = x + tree["wpe"]["embedding"].to(dt)[:tok.shape[1]][None]
    pp = make_pipeline(_mesh(S), lambda p, h: _block(cfg, p, h))
    h = merge_microbatches(pp(stacked, split_microbatches(x, M)))
    h = _layer_norm(h, tree["ln_f"]["scale"], tree["ln_f"]["bias"])
    logp = torch.log_softmax(h.float() @ tree["lm_head"]["kernel"], -1)
    return -logp.gather(-1, tgt[..., None])[..., 0].mean(), stacked


@pytest.mark.parametrize("dtype_case", ["f32", "bf16"])
def test_pipelined_gpt_matches_jax_pipeline(dtype_case) -> None:
    _, _, loss_tol, grad_tol = DTYPES[dtype_case]
    jcfg, cfg, params = _gpt_pair(dtype_case)
    S, M = 4, 4
    rng = np.random.default_rng(1)
    tok = rng.integers(0, cfg.vocab_size, (8, cfg.max_seq_len))
    tgt = np.roll(tok, -1, axis=1)

    # the reference: make_pipeline over its _block, the embedding fed in
    jmesh = _jmesh(S)
    jpp = jpipe.make_pipeline(jmesh, lambda p, h: jtf._block(
        jcfg, p, h, attn_fn=jtf._local_causal_attention))

    def jloss(stacked, rest):
        x = jtf._embed(jcfg, rest, jnp.asarray(tok, jnp.int32))
        h = jpipe.merge_microbatches(jpp(stacked,
                                         jpipe.split_microbatches(x, M)))
        h = jtf._layer_norm(h, rest["ln_f"]["scale"], rest["ln_f"]["bias"])
        return jtf.ce_from_hidden(h, rest["lm_head"]["kernel"],
                                  jnp.asarray(tgt, jnp.int32))

    jstacked = jpipe.stack_stage_params(
        [params[f"layers_{i}"] for i in range(S)])
    jstacked = jax.tree_util.tree_map(
        lambda l: jax.device_put(l, JNamedSharding(
            jmesh, JP("stage", *([None] * (l.ndim - 1))))), jstacked)
    rest = {k: v for k, v in params.items() if not k.startswith("layers_")}
    jl, jg = jax.jit(jax.value_and_grad(jloss))(jstacked, rest)

    tree = jax.tree_util.tree_map(
        lambda a: torch.from_numpy(np.array(a)).requires_grad_(True), params)
    loss, _ = _pipelined_loss(cfg, tree, torch.from_numpy(tok),
                              torch.from_numpy(tgt), S, M)
    loss.backward()
    assert abs(loss.item() - float(jl)) <= loss_tol
    # every stage gradient, stacked as the reference's
    want = jax.tree_util.tree_leaves_with_path(jax.device_get(jg))
    for i, (path, g) in enumerate(want):
        got = torch.stack([
            jax.tree_util.tree_leaves(tree[f"layers_{s}"])[i].grad
            for s in range(S)]).numpy()
        g = np.asarray(g)
        assert np.abs(got - g).max() <= grad_tol * np.abs(g).max(), path


def test_pipelined_gpt_matches_the_unpipelined_gpt() -> None:
    _, cfg, params = _gpt_pair("f32")
    rng = np.random.default_rng(2)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                        (8, cfg.max_seq_len)))
    tgt = torch.roll(tok, -1, dims=1)
    model = GPT(cfg, device="cpu")
    model.load_state_dict(from_jax_params(params))
    ref = model.loss(tok, tgt)
    ref.backward()
    tree = {}
    for name, p in model.named_parameters():
        node = tree
        *keys, leaf = name.split(".")
        for k in keys:
            node = node.setdefault(k, {})
        node[leaf] = p.detach().clone().requires_grad_(True)
    loss, _ = _pipelined_loss(cfg, tree, tok, tgt)
    loss.backward()
    assert abs(loss.item() - ref.item()) <= 1e-5
    for name, p in model.named_parameters():
        node = tree
        for k in name.split("."):
            node = node[k]
        g, want = node.grad.numpy(), p.grad.numpy()
        assert np.abs(g - want).max() <= 1e-4 * np.abs(want).max(), name
