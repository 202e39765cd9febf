"""The port's driver entry (``torchft_tpu_torch/graft_entry.py``) against
the repo root's ``__graft_entry__.py``.

- ``entry()``: its tokens are the reference's, bitwise (the same
  ``default_rng(0)`` draw at "125m", int32); with ``CONFIGS["125m"]`` cut to
  "tiny" in f32 in both packages (here only, through ``monkeypatch``), its
  ``fn`` on the reference's parameters carried over with
  ``from_jax_params`` equals the reference's ``fn`` within 1e-4 (atol and
  rtol, tests/test_torch_models.py's ``test_forward_logits_match_jax``).
- ``_dryrun_ft_loop(8)`` alone: two trainer groups of 2 ranks of 2 virtual
  positions, a spare, an observer, a kill and every rank's sharded heal
  (the healed leaf on its fsdp sharding); and ``dryrun_multichip(4)``
  whole: every segment within ``DRYRUN_TOL`` of its counterpart and the
  summary line the reference's test reads. ``dryrun_multichip(8)`` is
  ``slow``, as the reference's is (tests/test_graft_entry.py).
- Each segment's check fails a wrong result: a ring that drops a shard's
  keys, a 1F1B runner whose gradients are off by a little.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torchft_tpu.models import transformer as jtf
from torchft_tpu_torch import graft_entry
from torchft_tpu_torch.models import CONFIGS, from_jax_params
from torchft_tpu_torch.models import transformer as tf


def test_entry_tokens_are_the_references() -> None:
    import __graft_entry__ as ref

    _, (_, jtok) = ref.entry()
    _, (params, tok) = graft_entry.entry(device="cpu")
    assert tok.dtype == torch.int32 and jtok.dtype == jnp.int32
    assert tok.shape == (4, CONFIGS["125m"].max_seq_len)
    assert np.array_equal(tok.numpy(), np.asarray(jtok))
    assert sum(p.numel() for p in params.values()) == 136091136


def test_entry_fn_matches_the_references_at_tiny(monkeypatch) -> None:
    import __graft_entry__ as ref

    monkeypatch.setitem(jtf.CONFIGS, "125m", dataclasses.replace(
        jtf.CONFIGS["tiny"], dtype=jnp.float32))
    monkeypatch.setitem(tf.CONFIGS, "125m", dataclasses.replace(
        CONFIGS["tiny"], dtype=torch.float32))
    jfn, (jparams, jtok) = ref.entry()
    fn, (params, tok) = graft_entry.entry(device="cpu")
    assert np.array_equal(tok.numpy(), np.asarray(jtok))
    carried = from_jax_params(jax.device_get(jparams))
    assert set(carried) == set(params)
    with torch.no_grad():
        logits = fn(carried, tok)
    assert logits.shape == (4, 128, 512) and logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), np.asarray(jfn(jparams, jtok)),
                               atol=1e-4, rtol=1e-4)


def _assert_ft(ft, ranks: int, per_rank: int) -> None:
    assert ft["trace"].startswith(f"groups=3x{ranks}rx{per_rank}dev")
    assert ft["heals"] >= ranks and ft["parked"] >= 1 and ft["promoted"] >= 1
    assert ft["obs_world"] >= 4 and not ft["observer_participated"]
    assert all(c >= 5 for c in ft["commits"].values())


def test_dryrun_ft_loop_8_heals_every_rank_on_its_sharding() -> None:
    # at 8 positions each rank holds an fsdp sub-mesh of 2: the heal must
    # land its leaf as a ShardedTensor on that sharding (checked inside)
    _assert_ft(graft_entry._dryrun_ft_loop(8, "cpu"), 2, 2)


def _check_summary(tail: str, ranks: int, per_rank: int) -> None:
    assert tail.endswith("OK")
    assert f"ft[groups=3x{ranks}rx{per_rank}dev" in tail
    assert "observer=1" in tail
    assert "heals=" in tail and "heals=0" not in tail \
        and "heals=1 " not in tail
    assert "parked=0" not in tail and "promoted=0" not in tail


def test_dryrun_multichip_4(capsys) -> None:
    result = graft_entry.dryrun_multichip(4, device="cpu")
    tail = capsys.readouterr().out.strip().splitlines()[-1]
    assert tail == result["summary"]
    assert tail.startswith("dryrun_multichip(4): dp=2 fsdp=1 tp=2 ")
    _check_summary(tail, 2, 1)
    seg = result["segments"]
    assert seg["vocab"]["world"] == 4 and seg["ring"]["seq"] == 256
    assert seg["moe"]["moe_axes"] == (1, 4)
    # no flash kernel off the card
    assert all(set(c.values()) == {0} for c in result["launches"].values())


@pytest.mark.slow  # as the reference's tests/test_graft_entry.py
def test_dryrun_multichip_8(capsys) -> None:
    graft_entry.dryrun_multichip(8, device="cpu")
    tail = capsys.readouterr().out.strip().splitlines()[-1]
    assert tail.startswith("dryrun_multichip(8): dp=2 fsdp=2 tp=2 ")
    _check_summary(tail, 2, 2)


def test_ring_segment_fails_a_ring_that_drops_keys(monkeypatch) -> None:
    import torchft_tpu_torch.parallel as parallel

    make = parallel.make_ring_attention

    def broken(mesh, axis, causal=True, **kw):
        ring = make(mesh, axis, causal=causal, **kw)

        def fn(q, k, v):  # the first shard's keys never reach the ring
            s = q.shape[1] // 4
            k, v = k.clone(), v.clone()
            k[:, :s] = 0
            v[:, :s] = 0
            return ring(q, k, v)

        return fn

    graft_entry._ring_segment(4, torch.device("cpu"),
                              np.random.default_rng(0))
    monkeypatch.setattr(parallel, "make_ring_attention", broken)
    with pytest.raises(AssertionError, match="ring"):
        graft_entry._ring_segment(4, torch.device("cpu"),
                                  np.random.default_rng(0))


def test_pipeline_segment_fails_a_wrong_1f1b(monkeypatch) -> None:
    import torchft_tpu_torch.parallel as parallel

    make = parallel.make_pipeline_1f1b

    def broken(*a, **kw):
        run = make(*a, **kw)

        def wrong(stacked, x, y):
            loss, grads = run(stacked, x, y)
            return loss, {k: g * 1.001 for k, g in grads.items()}

        return wrong

    monkeypatch.setattr(parallel, "make_pipeline_1f1b", broken)
    with pytest.raises(AssertionError, match="1F1B gradients"):
        graft_entry._pipeline_segments(4, torch.device("cpu"),
                                       np.random.default_rng(0))
