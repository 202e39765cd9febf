"""The mesh and sharding-rule cases of tests/test_parallel.py over the
port's ``parallel`` package, under the reference's names and assertions
(tests/test_torch_twin.py says how). Each ``ft_mesh`` here lays its axes
over CPU positions of distinct indices (``cpu:0`` ... ``cpu:7``), the
stand-in for conftest's eight CPU devices, so a position is found by its
device as the reference finds it.

Not run here: the ring-attention cases and ``shard_pytree``'s, whose
inputs are jax arrays placed with ``jax.device_put`` and run under
``jax.jit``/``jax.grad``; tests/test_torch_parallel.py (the ring, against
the JAX package's ring on conftest's devices) and
tests/test_torch_sharding.py (``shard_pytree``) hold them under their
names.
"""

from tests.test_torch_twin import reference_twin

_RING = "tests/test_torch_parallel.py of its name (a jax.jit ring here)"

reference_twin(
    globals(), "test_parallel",
    renames={"ft_mesh(": "_cpu_mesh(",
             "    tp_rules_gpt,\n)": "    tp_rules_gpt,\n)\n\n\n"
             "def _cpu_mesh(axes, devices=None):\n"
             "    n = 8 if devices is None else len(devices)\n"
             "    return ft_mesh(axes, devices=[f\"cpu:{i}\" "
             "for i in range(n)])\n"},
    drop={"test_shard_pytree_places_arrays":
          "tests/test_torch_sharding.py of its name (jax arrays here)",
          "test_ring_attention_matches_reference": _RING,
          "test_ring_attention_flash_blocks_matches_reference": _RING,
          "test_ring_attention_flash_blocks_match_einsum_blocks": _RING,
          "test_ring_attention_long_context_grad": _RING,
          "test_ring_attention_flash_blocks_grad": _RING,
          "test_ring_attention_flash_grad_matches_einsum_grad": _RING})
