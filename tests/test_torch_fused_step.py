"""The port's fused HSDP step (``torchft_tpu_torch/fused.py``) on the CPU.

Two suites:

* Twins of the JAX package's tests/test_fused_step.py at its sizes (13
  params, batch 4, a 32-byte chunk grid, ``sgd(0.05, momentum=0.9)``):
  fused and staged arms bitwise equal (sha256 of params, residual and
  optimizer leaves) after every step for codecs none, bf16 and int8 at 2x2
  and 4x1; 1 dispatch and 0 host hops a fused step, 4 and 6 a staged one;
  one program per first sight of a (mesh shape, codec), none for a shape
  seen before.

* Against the JAX package's own ``FusedStepEngine``. Its device plane
  cannot trace here (R1: ``_x64_trace`` imports ``jax.experimental.
  enable_x64``, which this jax lacks), so a fixture of this file sets
  ``torchft_tpu.comm.xla_backend._x64_trace`` to ``jax.enable_x64(True)``
  for the test's span; no file of the JAX package changes. The same inputs
  go through the reference's stage executables and the port's stages, for
  each codec, shape and optimizer. Measured on this CPU: grad bitwise
  (the toy loss); gather bitwise; exchange bitwise at none and bf16. Two
  places differ by rounding, and there the test holds the port bitwise to
  a host composition and the reference within a bound:

  - update: XLA's CPU backend contracts ``a * b + c`` inside the optax
    update into one FMA (the reference fences only its stage boundaries
    with ``_hardround``); the port rounds every op, as numpy does and as
    PyTorch's CUDA kernels do. ``test_reference_update_contracts_fma``
    shows it: the reference's momentum trace equals ``g + decay * t``
    with a single rounding, bit for bit.
  - int8: the reference's exchange differs from the host codec (the TCP
    wire's numpy codec) by up to two ulps of a position's largest value in
    a few elements, at both shapes (at 13 params, one chunk a slot, its 4x1
    exchange happens to agree); the port's equals the host codec bit for
    bit, its residual equals the reference's.

  Whole 3-step runs: parameters within 1e-6 of the reference's and losses
  within 1e-6; the digests differ once the update's FMA roundings enter.
  A tiny GPT (2 layers, width 64) as a flat-loss engine at 2x2 matches the
  unsharded GPT's gradient of the same sequences.

Every engine twin runs over three layouts of the pool (``LAYOUTS``):
"virtual" (``DevicePool("cpu")``, every position a row of one stacked
tensor), "cards" (``cpu:0 .. cpu:3``, distinct device indices lay out as
distinct cards, so the stages take their cross-card path on the host: one
buffer a card, copies between them) and "cycled" (``cpu:0, cpu:1, cpu:0,
cpu:1``: two positions a card). Over cards and cycled the digest is the
virtual mesh's after every step, in both arms, for every codec and shape;
each position's rows lie on its own card's buffer.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import optax
import pytest
import torch

import torchft_tpu.comm.xla_backend as ref_xla
from torchft_tpu.fused import FusedStepEngine as RefEngine
from torchft_tpu_torch import optim
from torchft_tpu_torch.comm.cuda_backend import DevicePool
from torchft_tpu_torch.fused import (
    FusedStepEngine,
    module_loss_fn,
    module_params,
)
from torchft_tpu_torch.models import CONFIGS, GPT
from torchft_tpu_torch.utils.events import EventRecorder
from torchft_tpu_torch.utils.metrics import Metrics

PARAMS = 13   # deliberately indivisible: exercises padding
BATCH = 4
CHUNK = 32    # several int8 chunks per q_len at the larger sizes
SHAPES = [(2, 2), (4, 1)]
SHAPE_IDS = ["2x2", "4x1"]
CODECS = ["none", "bf16", "int8"]
# the reference's update against the port's, at unit-scale inputs: FMA
# roundings apart (a few ulps of the update's terms)
UPDATE_RTOL, UPDATE_ATOL = 2.0 ** -20, 1e-7
# whole runs against the reference
RUN_ATOL = 1e-6
# the tiny GPT's gradient through the engine against the unsharded GPT's
# (bf16 products over batches of 2 and of 8 sequences; measured 2.0e-3)
GPT_GRAD_REL_NORM = 1e-2

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(_ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# where the mesh's positions lie (module docstring)
LAYOUTS = {
    "virtual": lambda: DevicePool("cpu"),
    "cards": lambda: DevicePool(devices=[f"cpu:{i}" for i in range(4)]),
    "cycled": lambda: DevicePool(devices=["cpu:0", "cpu:1"] * 2),
}
LAYOUT_IDS = list(LAYOUTS)


@pytest.fixture(scope="module")
def pools():
    # one pool a layout for the module: programs cache across tests, like
    # one training process surviving many quorum epochs
    return {name: make() for name, make in LAYOUTS.items()}


def _loss_fn():
    def loss_fn(w, b):
        return 0.5 * torch.sum((w - torch.mean(b)) ** 2)

    return loss_fn


def _tx():
    return optim.sgd(0.05, momentum=0.9)


def _engine(pool, replicas, model_shards, codec, params=PARAMS, **kw):
    rng = np.random.default_rng(7)
    params = rng.standard_normal(params).astype(np.float32)
    return FusedStepEngine(pool, replicas, model_shards, params, BATCH,
                           _loss_fn(), _tx(), codec=codec, chunk_bytes=CHUNK,
                           **kw)


def _batch(devices: int, step: int) -> np.ndarray:
    rng = np.random.default_rng(100 + step)
    return rng.standard_normal((devices, BATCH)).astype(np.float32)


# ------------------------------------------------ bitwise identity


@pytest.mark.parametrize("layout", LAYOUT_IDS)
@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
@pytest.mark.parametrize("codec", CODECS)
def test_staged_fused_bitwise_identity(pools, shape, codec, layout) -> None:
    pool = pools[layout]
    R, M = shape
    a = _engine(pool, R, M, codec)
    b = _engine(pool, R, M, codec)
    assert a.digest() == b.digest()  # identical initial state
    for step in range(3):
        batch = _batch(R * M, step)
        la = a.step_fused(batch)
        lb = b.step_staged(batch)
        assert np.isfinite(la)
        assert np.float32(la) == np.float32(lb)
        assert a.digest() == b.digest(), (
            f"state diverged at step {step} ({codec} {R}x{M})")
    a.verify_replicas()
    b.verify_replicas()
    assert a.spec.error_feedback == (codec == "int8")
    if codec == "int8":
        assert any(bool((t != 0).any()) for t in a._state.e)


def test_padding_roundtrip(pools) -> None:
    eng = _engine(pools["virtual"], 2, 2, "none")
    assert eng.params().shape == (PARAMS,)
    assert eng.spec.q_len * 4 >= PARAMS


# ------------------------------------------------- counter oracle


@pytest.mark.parametrize("layout", LAYOUT_IDS)
def test_fused_counter_oracle(layout) -> None:
    pool = LAYOUTS[layout]()
    eng = _engine(pool, 2, 2, "int8", metrics=Metrics())
    eng.step_fused(_batch(4, 0))
    c = eng.counters()
    assert c["step_dispatch_count"] == 1
    assert c["step_host_hops"] == 0
    assert c["step_executable_count"] == 1
    assert c["mesh_shape"] == "2x2"
    # one program on first sight of (mesh shape, codec)
    assert pool.compile_count == 1
    assert pool.trace_count == 1
    eng.step_fused(_batch(4, 1))
    assert eng.counters()["step_dispatch_count"] == 2
    assert pool.compile_count == 1  # seen shape: a lookup
    assert pool.hit_count >= 1
    assert c["captures"] == 0  # the CPU runs the programs eagerly


@pytest.mark.parametrize("layout", LAYOUT_IDS)
def test_staged_counter_oracle(layout) -> None:
    pool = LAYOUTS[layout]()
    eng = _engine(pool, 2, 2, "none", metrics=Metrics())
    eng.step_staged(_batch(4, 0))
    c = eng.counters()
    assert c["step_dispatch_count"] == 4
    assert c["step_host_hops"] == 6  # gm, h, new_sub x (d2h + h2d)
    assert c["step_executable_count"] == 4
    assert pool.compile_count == 4


def test_fused_step_event_emitted() -> None:
    pool = DevicePool("cpu")
    ev = EventRecorder(replica_id="t", rank=0)
    eng = _engine(pool, 2, 2, "bf16", events=ev)
    eng.step_fused(_batch(4, 0))
    eng.step_staged(_batch(4, 1))  # staged steps do not emit
    events = ev.dump()["events"]
    assert [e["kind"] for e in events].count("fused_step") == 1
    rec = [e for e in events if e["kind"] == "fused_step"][0]
    assert rec["mesh_shape"] == "2x2"
    assert rec["codec"] == "bf16"
    assert rec["dispatches"] == 1
    assert rec["executables"] == 1
    assert rec["compile_count"] == 1  # only the fused program existed


@pytest.mark.parametrize("layout", LAYOUT_IDS)
def test_no_retrace_across_kill_shrink_rejoin(layout) -> None:
    pool = LAYOUTS[layout]()
    eng = _engine(pool, 4, 1, "int8")
    eng.step_fused(_batch(4, 0))
    compiles_4x1 = pool.compile_count
    eng.reshape_mesh(2)          # two replicas died: shrink
    eng.step_fused(_batch(2, 1))
    compiles_both = pool.compile_count
    assert compiles_both > compiles_4x1  # first sight of 2x1
    traces_both = pool.trace_count
    eng.reshape_mesh(4)          # they healed: rejoin at a seen shape
    eng.step_fused(_batch(4, 2))
    eng.reshape_mesh(2)          # and churn again
    eng.step_fused(_batch(2, 3))
    assert pool.compile_count == compiles_both
    assert pool.trace_count == traces_both
    assert eng.counters()["mesh_shape"] == "2x1"


def test_mesh_shape_label_follows_reshape() -> None:
    eng = _engine(DevicePool("cpu"), 2, 2, "none")
    assert eng.metrics.snapshot()["mesh_shape"] == "2x2"
    eng.reshape_mesh(2, 1)
    assert eng.metrics.snapshot()["mesh_shape"] == "2x1"


@pytest.mark.parametrize("layout", LAYOUT_IDS)
def test_reshape_preserves_params(layout) -> None:
    eng = _engine(LAYOUTS[layout](), 2, 2, "none")
    eng.step_fused(_batch(4, 0))
    before = eng.params().copy()
    eng.reshape_mesh(4, 1)
    np.testing.assert_array_equal(before, eng.params())
    eng.verify_replicas()


def test_unknown_codec_and_oversized_mesh_raise() -> None:
    with pytest.raises(ValueError, match="unknown step codec"):
        _engine(DevicePool("cpu"), 2, 2, "lz4")
    with pytest.raises(ValueError, match="exceeds the device pool"):
        _engine(DevicePool("cpu", positions=2), 2, 2, "none")


# ------------------------------------------- against the JAX package


@pytest.fixture
def x64(monkeypatch):
    """The reference's device plane traces with x64 enabled through
    ``jax.enable_x64`` for this test's span (module docstring)."""
    monkeypatch.setattr(ref_xla, "_x64_trace",
                        lambda: jax.enable_x64(True))


@pytest.fixture(scope="module")
def mesh_mgr():
    return ref_xla.MeshManager()


def _ref_loss(w, b):
    return 0.5 * jnp.sum((w - jnp.mean(b)) ** 2)


def _txs(name: str):
    if name == "sgd":
        return optax.sgd(0.05, momentum=0.9), optim.sgd(0.05, momentum=0.9)
    return (optax.adamw(3e-4, weight_decay=1e-4),
            optim.adamw(3e-4, weight_decay=1e-4))


def _pair(mesh_mgr, replicas, model_shards, codec, txname, params=PARAMS,
          layout="virtual"):
    rng = np.random.default_rng(7)
    p = rng.standard_normal(params).astype(np.float32)
    jtx, ttx = _txs(txname)
    ref = RefEngine(mesh_mgr, replicas, model_shards, p, BATCH, _ref_loss,
                    jtx, codec=codec, chunk_bytes=CHUNK, fn_key=txname)
    port = FusedStepEngine(LAYOUTS[layout](), replicas, model_shards, p,
                           BATCH, _loss_fn(), ttx, codec=codec,
                           chunk_bytes=CHUNK)
    return ref, port


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _bitwise(got, want) -> bool:
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = want.numpy() if isinstance(want, torch.Tensor) \
        else np.asarray(want)
    return got.shape == want.shape and got.tobytes() == want.tobytes()


def _host_exchange(codec, gm, e, replicas, model_shards, ef):
    """The exchange composed on the host: the slots of every position in
    rank order, summed from the first (none) or from 0 after the wire
    dtype's rounding (bf16), divided by R*M; int8 through the TCP wire's
    numpy codec (chip_smoke.host_int8_exchange)."""
    if codec == "int8":
        return _smoke().host_int8_exchange(gm, e, replicas, model_shards,
                                           CHUNK, ef)
    R, M = replicas, model_shards
    q = gm.shape[1] // R
    h = np.empty((R * M, q), np.float32)
    for d in range(R * M):
        r, m = divmod(d, M)
        rows = [gm[src * M + m, r * q:(r + 1) * q] for src in range(R)]
        if codec == "bf16":
            acc = np.zeros(q, np.float32)
            for x in rows:
                acc = acc + x.astype(ml_dtypes.bfloat16).astype(np.float32)
        else:
            acc = rows[0]
            for x in rows[1:]:
                acc = acc + x
        h[d] = acc / np.float32(R * M)
    return h, e


def _host_update(txname, h, p, opt, replicas, model_shards):
    """The sharded update composed in numpy, optax's formulas with every
    op rounded to f32: (new sub-shards, new optimizer leaves)."""
    R, M = replicas, model_shards
    q = h.shape[1]
    pv = p.reshape(R, M, R, q)
    subs, leaves = [], [[] for _ in opt]
    for d in range(R * M):
        r, m = divmod(d, M)
        g, ps = h[d], pv[r, m, r]
        if txname == "sgd":
            (t,) = (x[d] for x in opt)
            t = g + t * np.float32(0.9)
            u = t * np.float32(-0.05)
            new = [t]
        else:
            count, mu, nu = (x[d] for x in opt)
            mu = g * np.float32(1 - 0.9) + mu * np.float32(0.9)
            nu = (g * g) * np.float32(1 - 0.999) + nu * np.float32(0.999)
            count = np.int32(count + 1)
            c = np.float32(count)
            bc1 = np.float32(1) - np.float32(0.9) ** c
            bc2 = np.float32(1) - np.float32(0.999) ** c
            u = (mu / bc1) / (np.sqrt(nu / bc2) + np.float32(1e-8))
            u = u + np.float32(1e-4) * ps
            u = u * np.float32(-3e-4)
            new = [count, mu, nu]
        subs.append(ps + u)
        for acc, x in zip(leaves, new):
            acc.append(x)
    return np.stack(subs), [np.stack(x) for x in leaves]


@pytest.mark.parametrize("txname", ["sgd", "adamw"])
@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
@pytest.mark.parametrize("codec", CODECS)
def test_stages_against_the_reference(x64, mesh_mgr, codec, shape,
                                      txname) -> None:
    R, M = shape
    D = R * M
    ref, port = _pair(mesh_mgr, R, M, codec, txname, params=257)
    spec = ref.spec
    assert (port.spec.q_len, port.spec.p_len) == (spec.q_len, spec.p_len)
    rng = np.random.default_rng(11)
    row = ref._row
    for step in range(2):
        # grad: the same params and batch
        p = np.asarray(ref._p)
        b = rng.standard_normal((D, BATCH)).astype(np.float32)
        rg, rl = ref._exe("grad")(ref._z, ref._p, jax.device_put(b, row))
        (pg,), pl = port._exe("grad").run([_t(p)], [_t(b)])
        np.testing.assert_allclose(pg.numpy(), np.asarray(rg), rtol=1e-6,
                                   atol=1e-7)
        np.testing.assert_allclose(pl.numpy(), np.asarray(rl), rtol=1e-6)
        # exchange: gradients over six decades, a residual
        gm = (rng.standard_normal((D, spec.p_len))
              * 10.0 ** rng.integers(-3, 3, size=(D, 1))).astype(np.float32)
        e = (rng.standard_normal((D, spec.p_len)) * 1e-2).astype(np.float32)
        rh, re = ref._exe("exchange")(ref._z, jax.device_put(gm, row),
                                      jax.device_put(e, row))
        te = _t(e)
        ((ph,),) = port._exe("exchange").run([_t(gm)], [te])
        hh, he = _host_exchange(codec, gm, e, R, M,
                                port.spec.error_feedback)
        assert _bitwise(ph, hh) and _bitwise(te, he)
        assert _bitwise(te, re)
        if codec == "int8":
            # within two ulps of each position's largest value
            rh = np.asarray(rh)
            bound = 2.0 ** -22 * np.abs(rh).max(axis=1, keepdims=True)
            assert (np.abs(ph.numpy() - rh) <= bound).all()
        else:
            assert _bitwise(ph, rh)
        # update: a unit-scale h, the reference's params and optimizer state
        h = rng.standard_normal((D, spec.q_len)).astype(np.float32)
        opt = [np.array(x) for x in ref._opt]
        ru = ref._exe("update")(ref._z, jax.device_put(h, row), ref._p,
                                *ref._opt)
        topt = [_t(x) for x in opt]
        ((pn,),) = port._exe("update").run([_t(h)], [_t(p)],
                                           *[[t] for t in topt])
        hs, hl = _host_update(txname, h, p, opt, R, M)
        assert _bitwise(pn, hs)
        assert all(_bitwise(t, x) for t, x in zip(topt, hl))
        np.testing.assert_allclose(pn.numpy(), np.asarray(ru[0]),
                                   rtol=UPDATE_RTOL, atol=UPDATE_ATOL)
        for t, x in zip(topt, ru[1:]):
            np.testing.assert_allclose(t.numpy(), np.asarray(x),
                                       rtol=UPDATE_RTOL, atol=UPDATE_ATOL)
        # gather: raw values
        (rp,) = ref._exe("gather")(ru[0])
        tp = torch.zeros((D, spec.p_len))
        port._exe("gather").run([_t(ru[0])], [tp])
        assert _bitwise(tp, rp)
        ref._p, ref._opt = rp, list(ru[1:])


def test_reference_update_contracts_fma(x64, mesh_mgr) -> None:
    # the cause of the update's rounding gap: the reference's momentum
    # trace is g + decay * t rounded once (an FMA), not twice
    ref, port = _pair(mesh_mgr, 2, 2, "none", "sgd", params=257)
    rng = np.random.default_rng(3)
    D, q = 4, ref.spec.q_len
    h = rng.standard_normal((D, q)).astype(np.float32)
    t = rng.standard_normal((D, q)).astype(np.float32)
    ru = ref._exe("update")(ref._z, jax.device_put(h, ref._row), ref._p,
                            jax.device_put(t, ref._row))
    once = (h.astype(np.float64)
            + np.float64(np.float32(0.9)) * t.astype(np.float64)
            ).astype(np.float32)
    twice = h + t * np.float32(0.9)
    assert _bitwise(ru[1], once)
    assert not _bitwise(ru[1], twice)
    topt = [_t(t)]
    port._exe("update").run([_t(h)], [_t(np.asarray(ref._p))], topt)
    assert _bitwise(topt[0], twice)


@pytest.mark.parametrize("layout", LAYOUT_IDS)
@pytest.mark.parametrize("txname", ["sgd", "adamw"])
@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
@pytest.mark.parametrize("codec", CODECS)
def test_whole_steps_against_the_reference(x64, mesh_mgr, codec, shape,
                                           txname, layout) -> None:
    R, M = shape
    ref, port = _pair(mesh_mgr, R, M, codec, txname, layout=layout)
    # the reference's positions are distinct host devices
    assert len(set(ref._row.mesh.devices.flat)) == R * M
    assert ref.digest() == port.digest()  # the same bytes, leaf order
    for step in range(3):
        batch = _batch(R * M, step)
        lr = ref.step_fused(batch)
        lp = port.step_fused(batch)
        assert abs(lr - lp) <= RUN_ATOL
        np.testing.assert_allclose(port.params(), ref.params(), rtol=0,
                                   atol=RUN_ATOL)
        np.testing.assert_allclose(port._host_rows(port._state.e),
                                   np.asarray(ref._e),
                                   rtol=0, atol=RUN_ATOL)
    port.verify_replicas()


@pytest.mark.parametrize("layout", ["virtual", "cards"])
def test_tiny_gpt_engine_matches_the_unsharded_gradient(layout) -> None:
    cfg = dataclasses.replace(CONFIGS["tiny"], max_seq_len=64)
    assert (cfg.n_layers, cfg.d_model) == (2, 64)
    model = GPT(cfg, device="cpu", seed=0)
    smoke = _smoke()
    loss_fn = module_loss_fn(model, smoke.gpt_row_loss(cfg.max_seq_len))
    R, M = 2, 2
    eng = FusedStepEngine(LAYOUTS[layout](), R, M, module_params(model),
                          2 * cfg.max_seq_len, loss_fn,
                          optim.adamw(3e-4, weight_decay=1e-4), fn_key="gpt")
    batch = smoke.fused_batch(0, 0, cfg, R * M)
    loss = eng.step_staged(batch)
    h = eng._host_rows(eng._staged_buffers()["h"][1])
    got = smoke.assemble_grad(h, R, M)[:eng.spec.param_size]
    dense_loss, want = smoke.dense_gradient(model, batch, cfg.max_seq_len)
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel <= GPT_GRAD_REL_NORM, rel
    assert abs(loss - dense_loss) <= 1e-5
    # the loss_fn reads the params it is given, not the module's
    before = module_params(model)
    eng.step_fused(batch)
    np.testing.assert_array_equal(module_params(model), before)
    assert not np.array_equal(eng.params(), before)


# ------------------------------------------- over cards, against virtual


@pytest.mark.parametrize("layout", ["cards", "cycled"])
@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
@pytest.mark.parametrize("codec", CODECS)
def test_cards_digest_equals_the_virtual_mesh(codec, shape, layout) -> None:
    # several int8 chunks a slot (257 params), both arms, 3 steps, a churn
    # to the other shape and back: the digest over the cards is the
    # virtual mesh's after every step
    R, M = shape
    arms = ("fused", "staged")
    virtual = {a: _engine(LAYOUTS["virtual"](), R, M, codec, params=257)
               for a in arms}
    cards = {a: _engine(LAYOUTS[layout](), R, M, codec, params=257)
             for a in arms}
    assert cards["fused"].digest() == virtual["fused"].digest()
    other = SHAPES[1 - SHAPES.index(shape)]
    for step, mesh in enumerate([shape] * 3 + [other, shape]):
        for a in arms:
            for eng in (virtual[a], cards[a]):
                if (eng.replicas, eng.model_shards) != mesh:
                    eng.reshape_mesh(*mesh)
            batch = _batch(mesh[0] * mesh[1], step)
            lv = virtual[a].step(batch, fused=a == "fused")
            lc = cards[a].step(batch, fused=a == "fused")
            assert np.float32(lv) == np.float32(lc), (a, step)
            assert cards[a].digest() == virtual[a].digest(), (a, step, mesh)
        assert cards["fused"].digest() == cards["staged"].digest()
    for a in arms:
        cards[a].verify_replicas()
        assert cards[a].counters()["step_dispatch_count"] == \
            virtual[a].counters()["step_dispatch_count"]


@pytest.mark.parametrize("layout", LAYOUT_IDS)
def test_rows_lie_on_their_cards(layout) -> None:
    # one buffer a card of the pool's positions, position d's rows of p,
    # e and every optimizer leaf on pool.devices()[d]'s buffer, in
    # position order; p's row d is model shard d % M of the padded params
    from torchft_tpu_torch.comm.cuda_backend import _card_key

    pool = LAYOUTS[layout]()
    R, M = 2, 2
    eng = FusedStepEngine(pool, R, M, np.arange(13, dtype=np.float32),
                          BATCH, _loss_fn(), optim.adamw(3e-4),
                          codec="int8", chunk_bytes=CHUNK)
    cards = eng._cards
    want = {"virtual": 1, "cards": 4, "cycled": 2}[layout]
    assert len(cards.devices) == want
    st = eng._state
    padded = np.zeros(eng.spec.s_len, np.float32)
    padded[:13] = np.arange(13)
    shards = padded.reshape(M, eng.spec.p_len)
    for bufs in (st.p, st.e, *st.opt, st.b):
        assert len(bufs) == want
        for c, buf in enumerate(bufs):
            assert buf.shape[0] == len(cards.ranks[c])
            assert buf.device.type == cards.devices[c].type
    for d in range(R * M):
        assert _card_key(cards.devices[cards.of[d]]) == \
            _card_key(pool.devices()[d])
        np.testing.assert_array_equal(cards.row(st.p, d).numpy(),
                                      shards[d % M])
    for name, (dev_bufs, hosts) in eng._staged_buffers().items():
        assert [t.shape[0] for t in dev_bufs] == \
            [t.shape[0] for t in hosts] == [len(r) for r in cards.ranks]


def test_engine_refuses_a_pool_of_mixed_device_kinds() -> None:
    with pytest.raises(ValueError, match="devices of one kind"):
        _engine(DevicePool(devices=["cpu", "meta"]), 1, 2, "none")
