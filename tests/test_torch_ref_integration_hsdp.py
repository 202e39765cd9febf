"""The cases of tests/test_integration_hsdp.py that run over the port as
written (a template's structure refused, the region router's coverage),
under the reference's names and assertions (tests/test_torch_twin.py says
how).

Not run here: the cases that build meshes of jax devices and shard jax
arrays over them; tests/test_torch_hsdp_heal.py holds the heal cases and
tests/test_torch_train_hsdp.py the two training drills (over
``Manager.allreduce_pytree``, as the reference's), each under its name.
"""

from tests.test_torch_twin import reference_twin

_HEAL = "tests/test_torch_hsdp_heal.py of its name (jax devices here)"
_DRILL = "tests/test_torch_train_hsdp.py of its name (jax devices here)"

reference_twin(
    globals(), "test_integration_hsdp",
    drop={"test_sharded_recv_roundtrip": _HEAL,
          "test_multihost_donor_fanout": _HEAL,
          "test_multihost_donor_gap_is_loud": _HEAL,
          "test_sharded_recv_rejects_dtype_mismatch": _HEAL,
          "test_donor_stages_shard_wise": _HEAL,
          "test_hsdp_ft_kill_and_sharded_heal": _DRILL,
          "test_hsdp_multirank_kill_and_per_rank_sharded_heal": _DRILL})
