"""The slice end to end on the CPU: ``examples/train_llama_ring.py``'s twin.

Two replica groups train "llama_tiny" (with the example's fused loss over
4 vocab chunks, in f32 activations so the two frameworks agree to
summation order) with the flash-block ring over 4 virtual CPU shards;
group 1 is killed after step 3, restarts from a poisoned init and heals
from group 0 at step 5. ``run_llama_ring_drill`` raises unless both groups
hold the same parameters and AdamW state, bitwise, at every step both
commit. The weights come from the JAX package's ``llama_init_params``
(``from_jax_params``), so each group's first loss is the reference's
``llama_loss_fn`` (dense attention) on the same weights and batch, within
1e-5.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torchft_tpu.models import llama as jl
from torchft_tpu_torch.examples.train_llama_ring import (
    example_config,
    run_llama_ring_drill,
)
from torchft_tpu_torch.models import LLAMA_CONFIGS, from_jax_params

LOSS_TOL = 1e-5
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_llama_ring_drill_heals_bitwise_and_tracks_the_reference() -> None:
    cfg = dataclasses.replace(LLAMA_CONFIGS["llama_tiny"],
                              dtype=torch.float32, xent_chunks=4)
    jcfg = dataclasses.replace(jl.LLAMA_CONFIGS["llama_tiny"],
                               dtype=jnp.float32, xent_chunks=4)
    params = jax.device_get(jl.llama_init_params(jcfg, jax.random.key(0)))
    batch = 2
    result = run_llama_ring_drill(
        cfg, ring_impl="flash", seq_shards=4, device="cpu", batch_size=batch,
        init_state=from_jax_params(params), timeout=30.0)
    assert result["heal_step"] == 5
    # both groups at every step but group 0's solo step 4
    assert result["compared"] == {1: 2, 2: 2, 3: 2, 4: 1, 5: 2, 6: 2, 7: 2}
    assert result["checked_steps"] == [1, 2, 3, 5, 6, 7]
    heal = result["heal"]
    assert heal["heal_wall_ms"] > 0 and heal["heal_bytes_per_s"] > 0
    # 2 (k + s + 1 + a) - s forward/backward passes
    assert result["passes"] == 13
    lives = result["lives"]
    assert [len(lives[0]), len(lives[1])] == [1, 2]
    assert sorted(lives[1][0].losses) == [1, 2, 3]
    # each group's first step ran on the initial weights and its first batch
    for group in (0, 1):
        rng = np.random.default_rng(group)
        tok = rng.integers(0, cfg.vocab_size, (batch, cfg.max_seq_len))
        want = float(jl.llama_loss_fn(
            jcfg, params, jnp.asarray(tok, jnp.int32),
            jnp.asarray(np.roll(tok, -1, axis=1), jnp.int32)))
        got = lives[group][0].losses[1]
        assert abs(got - want) <= LOSS_TOL, (group, got, want)


def test_example_config_is_the_reference_example() -> None:
    cfg = example_config(256)
    want = dataclasses.replace(LLAMA_CONFIGS["llama_tiny"], max_seq_len=256,
                               xent_chunks=4)
    assert cfg == want


@pytest.mark.slow  # as the reference's twin (tests/test_apps.py)
def test_train_llama_ring_example_runs() -> None:
    # the example end to end as a real subprocess against a fresh
    # lighthouse: 4 virtual CPU shards where the reference sets
    # --xla_force_host_platform_device_count=4
    from torchft_tpu_torch.control import Lighthouse

    lh = Lighthouse(min_replicas=1, join_timeout_ms=200)
    env = dict(os.environ, TORCHFT_TPU_LIGHTHOUSE=lh.address(),
               REPLICA_GROUP_ID="0", LOGLEVEL="ERROR", DEVICE="cpu",
               TOTAL_STEPS="3", SEQ_LEN="128", SEQ_SHARDS="4")
    try:
        proc = subprocess.run(
            [sys.executable, "-m", "torchft_tpu_torch.examples."
             "train_llama_ring"], env=env, capture_output=True, text=True,
            timeout=180, cwd=_ROOT)
    finally:
        lh.shutdown()
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "step 3" in proc.stdout, proc.stdout


@pytest.mark.parametrize("device, shards, cards, want", [
    ("cuda:0", 4, 4, ["cuda:0", "cuda:1", "cuda:2", "cuda:3"]),
    ("cuda:0", 2, 4, ["cuda:0", "cuda:1"]),
    ("cuda:0", 4, 1, ["cuda:0"] * 4),
    ("cpu", 4, 0, ["cpu"] * 4),
])
def test_seq_ring_takes_a_card_a_shard_while_there_are_cards(
        monkeypatch, device, shards, cards, want) -> None:
    # one card a shard where the host has cards enough, else a virtual
    # mesh on the model's device (as the reference's forced host devices)
    import torchft_tpu_torch.examples.train_llama_ring as example
    from torchft_tpu_torch.parallel import ft_mesh

    meshes = []

    def spy(axes, devices=None):
        meshes.append([str(d) for d in devices])
        return ft_mesh(axes, devices=devices)

    monkeypatch.setattr(example, "ft_mesh", spy)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    example.make_seq_ring(example_config(256), torch.device(device), shards)
    assert meshes == [want]
