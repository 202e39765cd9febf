"""The slice end to end on the CPU: ``examples/train_moe.py``'s twin.

Two replica groups of two ranks each train "moe-tiny" (in f32
activations, so the two frameworks' losses agree to summation order); the
second group joins behind and heals, is killed whole, restarts from a
poisoned init and heals again through ``recv_checkpoint_sharded``, its
stripes spread over the donor group's ranks. ``run_moe_drill`` raises
unless every live rank holds the same parameters and AdamW state, bitwise,
at every committed step. The weights come from the JAX package's
``moe_init_params`` (``from_jax_params``), so each group's first loss is
the reference's ``moe_transformer_loss_fn`` on the same weights and batch,
within 1e-5.
"""

import dataclasses

import numpy as np
import torch

import jax
import jax.numpy as jnp

from torchft_tpu.models import moe_transformer as jmt
from torchft_tpu_torch.examples.train_moe import run_moe_drill
from torchft_tpu_torch.models import MOE_CONFIGS, from_jax_params

LOSS_TOL = 1e-5


def test_moe_drill_heals_bitwise_and_tracks_the_reference() -> None:
    cfg = dataclasses.replace(MOE_CONFIGS["moe-tiny"], dtype=torch.float32)
    jcfg = dataclasses.replace(jmt.MOE_CONFIGS["moe-tiny"], dtype=jnp.float32)
    params = jax.device_get(jmt.moe_init_params(jcfg, jax.random.key(0)))
    batch, k = 2, 3
    result = run_moe_drill(cfg, kill_step=k, device="cpu", batch_size=batch,
                           init_state=from_jax_params(params), timeout=30.0)
    heal = result["heal_step"]
    assert heal == k + 2
    # every rank compared at every step: group 0 alone at 1 and k + 1
    assert result["compared"] == {1: 2, 2: 4, 3: 4, 4: 2, 5: 4, 6: 4, 7: 4}
    # both of group 0's ranks served the second heal's stripes
    assert len(result["served"]) == 2
    wire = [h["heal_wire_bytes"] for h in result["heals"].values()]
    assert sum(result["served"].values()) >= sum(wire) > 0
    for h in result["heals"].values():
        assert h["heal_wall_ms"] > 0 and h["heal_bytes_per_s"] > 0
    # each group's first step ran on the initial weights: the reference's
    # loss on the same weights and the group's first batch
    lives = result["lives"]
    for group, step in ((0, 1), (1, 2)):
        rng = np.random.default_rng(group)
        tok = rng.integers(0, cfg.vocab_size, (batch, cfg.max_seq_len))
        want = float(jmt.moe_transformer_loss_fn(
            jcfg, params, jnp.asarray(tok, jnp.int32),
            jnp.asarray(np.roll(tok, -1, axis=1), jnp.int32)))
        for rank in (0, 1):
            got = lives[(group, rank)][0].losses[step]
            assert abs(got - want) <= LOSS_TOL, (group, rank, got, want)
    # one pass a committed step, per rank: group 0 at 1..7, group 1's first
    # life at 2..k (it fails before its next pass), its second at heal..7
    assert result["passes"] == 2 * (7 + (k - 1) + (7 - heal + 1))
