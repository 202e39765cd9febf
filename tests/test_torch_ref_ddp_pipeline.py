"""The cases of tests/test_ddp_pipeline.py that run over the port as
written (``FutureGroup`` and DDP's arena validation), under the
reference's names and assertions (tests/test_torch_twin.py says how).

Not run here: the cases that hand DDP a dict of arrays (the reference's
jax pytrees) or an optax transformation; the port's DDP takes a module,
its parameters or a list of tensors and its wrapper a torch optimizer.
tests/test_torch_ddp_pipeline.py holds each under its name with the
reference's assertions, the streamed arms also bitwise against the
reference's own DDP.
"""

from tests.test_torch_twin import reference_twin

_HELD = "tests/test_torch_ddp_pipeline.py of its name (dict pytrees here)"

reference_twin(
    globals(), "test_ddp_pipeline",
    drop={name: _HELD for name in (
        "test_streamed_bitwise_identical_to_lockstep",
        "test_streamed_identical_to_lockstep_ef_disabled",
        "test_pipeline_stage_timers_and_op_wire_metric",
        "test_arena_generations_allow_overlapping_averages",
        "test_arena_results_survive_next_pack",
        "test_all_arenas_in_flight_is_a_hard_error",
        "test_single_arena_restores_one_outstanding_guard",
        "test_midloop_failure_keeps_arena_guard",
        "test_pure_ddp_latches_quorum_failure",
        "test_pure_ddp_solo_wire_fast_path",
        "test_pure_ddp_still_averages_with_peers",
        "test_optimizer_step_accepts_grads_future")})
