"""Stage-split leaves on the heal plane, across packages.

The PP drill's layout (``tests/test_integration_pp.py``): stage-stacked
leaves split on dim 0 over a ``"stage"`` axis of 4 positions. Following
``tests/test_torch_hsdp_heal.py``: a port healer whose template is split
over ``"stage"`` on a virtual mesh heals from a JAX-package donor holding
``P("stage", ...)`` arrays over 4 CPU devices, and a JAX-package healer
with such a template heals from a port donor holding stage-split
``ShardedTensor`` s. Both bitwise; in both the healer fetches each stage's
rows once (its wire bytes are the state's).
"""

import numpy as np
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding as JNamedSharding
from jax.sharding import PartitionSpec as JP

import torchft_tpu.checkpointing as jax_ckpt
import torchft_tpu_torch.checkpointing as cp
from torchft_tpu.parallel import ft_mesh as jft_mesh
from torchft_tpu_torch.parallel import (
    NamedSharding,
    PartitionSpec as P,
    ShardedTensor,
    ft_mesh,
    stack_stage_params,
)
from torchft_tpu_torch.utils.metrics import Metrics

S, D = 4, 6


def _stacked() -> dict:
    """The reference test's stage-stacked params, drawn from a seed."""
    rng = np.random.default_rng(17)
    return {k: v.numpy() for k, v in stack_stage_params([
        {"w": rng.standard_normal((D, D)).astype(np.float32),
         "b": rng.standard_normal(D).astype(np.float32)}
        for _ in range(S)]).items()}


def _jspec(a) -> JP:
    return JP("stage", *([None] * (a.ndim - 1)))


def _spec(a) -> P:
    return P("stage", *([None] * (a.ndim - 1)))


def test_port_healer_with_a_stage_template_heals_from_a_jax_donor() -> None:
    params = _stacked()
    jmesh = jft_mesh({"stage": S}, devices=jax.devices()[:S])
    jstate = {"user": {k: jax.device_put(v, JNamedSharding(jmesh, _jspec(v)))
                       for k, v in params.items()},
              "torchft": {"step": 3, "batches_committed": 6}}
    mesh = ft_mesh({"stage": S}, devices=["cpu"] * S)
    tmpl = {k: ShardedTensor.from_full(torch.zeros(v.shape),
                                       NamedSharding(mesh, _spec(v)))
            for k, v in params.items()}
    template = {"user": tmpl, "torchft": {"step": 0, "batches_committed": 0}}
    donor = jax_ckpt.CheckpointServer(timeout=10.0)
    healer = cp.CheckpointServer(timeout=10.0, template_fn=lambda: template)
    metrics = Metrics()
    healer.set_metrics(metrics)
    try:
        donor.send_checkpoint([], 3, jstate, 10.0)
        got = healer.recv_checkpoint(0, donor.metadata(), 3, 10.0)
    finally:
        donor.shutdown()
        healer.shutdown()
    for name, want in params.items():
        healed = got["user"][name]
        assert isinstance(healed, ShardedTensor)
        assert healed.sharding == tmpl[name].sharding
        # each position's piece is its own stage's row, bitwise
        assert [b[0] for b in healed.bounds] == [(s, s + 1)
                                                 for s in range(S)]
        for s in range(S):
            assert healed.piece_at(s).numpy().tobytes() == \
                want[s:s + 1].tobytes()
    assert got["torchft"] == {"step": 3, "batches_committed": 6}
    assert metrics.snapshot()["heal_wire_bytes"] == sum(
        v.nbytes for v in params.values())


def test_jax_healer_with_a_stage_template_heals_from_a_port_donor() -> None:
    params = _stacked()
    mesh = ft_mesh({"stage": S}, devices=["cpu"] * S)
    port_state = {
        "user": {k: ShardedTensor.from_full(v, NamedSharding(mesh, _spec(v)))
                 for k, v in params.items()},
        "torchft": {"step": 5, "batches_committed": 10}}
    jmesh = jft_mesh({"stage": S}, devices=jax.devices()[4:8])
    jtmpl = {k: jax.device_put(jnp.zeros(v.shape),
                               JNamedSharding(jmesh, _jspec(v)))
             for k, v in params.items()}
    template = {"user": jtmpl, "torchft": {"step": 0, "batches_committed": 0}}
    donor = cp.CheckpointServer(timeout=10.0)
    served = Metrics()
    donor.set_metrics(served)
    healer = jax_ckpt.CheckpointServer(timeout=10.0,
                                       template_fn=lambda: template)
    try:
        donor.send_checkpoint([], 5, port_state, 10.0)
        got = healer.recv_checkpoint(0, donor.metadata(), 5, 10.0)
    finally:
        donor.shutdown()
        healer.shutdown()
    for name, want in params.items():
        healed = got["user"][name]
        assert isinstance(healed, jax.Array)
        assert healed.sharding == jtmpl[name].sharding
        assert np.asarray(healed).tobytes() == want.tobytes()
        for shard in healed.addressable_shards:
            s = shard.index[0].start
            assert np.asarray(shard.data).tobytes() == \
                want[s:s + 1].tobytes()
    assert got["torchft"] == {"step": 5, "batches_committed": 10}
    assert served.snapshot()["heal_served_bytes"] == sum(
        v.nbytes for v in params.values())
