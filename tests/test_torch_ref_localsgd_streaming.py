"""The cases of tests/test_localsgd_streaming.py that run over the port as
written (the fragment grid, its boundaries, the outer pools and the
fragment count's validation), under the reference's names and assertions
(tests/test_torch_twin.py says how).

Not run here: the cases that register a dict of arrays (the reference's
jax pytrees) with LocalSGD/DiLoCo; the port's wrappers take a module or a
list of tensors and update them in place. tests/test_torch_local_sgd.py
holds each under its name with the reference's assertions, the streaming
arms also bitwise against the reference's wrapper.
"""

from tests.test_torch_twin import reference_twin

_HELD = "tests/test_torch_local_sgd.py of its name (dict pytrees here)"

reference_twin(
    globals(), "test_localsgd_streaming",
    drop={name: _HELD for name in (
        "test_streaming_bitwise_identical_to_blocking",
        "test_streaming_localsgd_bitwise_and_ef_disabled",
        "test_midround_abort_rolls_back_every_fragment",
        "test_heal_at_fence_rereads_params_fn",
        "test_heal_keeps_donor_backup_as_sync_point",
        "test_outer_metric_surface",
        "test_streaming_overlaps_wire_behind_inner_steps",
        "test_sync_quorum_heal_does_not_rewind_round",
        "test_sync_without_register",
        "test_load_state_dict_leaf_count_mismatch_raises")})
