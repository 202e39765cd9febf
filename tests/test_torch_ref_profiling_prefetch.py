"""The prefetch cases of tests/test_profiling_prefetch.py over the port's
``PrefetchIterator`` on the CPU (the port's iterator moves batches to the
card unless asked: here ``device="cpu"``, and a placed batch is a
``torch.Tensor`` where the reference's is a ``jax.Array``), under the
reference's names and assertions (tests/test_torch_twin.py says how).
"""

from tests.test_torch_twin import reference_twin

_PROFILING = "tests/test_torch_profiling.py of that name (torch compute)"

reference_twin(
    globals(), "test_profiling_prefetch",
    prelude="import functools\n\nimport torch\n",
    renames={"PrefetchIterator(": "_CpuPrefetch(",
             "jax.Array": "torch.Tensor",
             "from torchft_tpu_torch.data import PrefetchIterator":
                 "from torchft_tpu_torch.data import PrefetchIterator\n"
                 "_CpuPrefetch = functools.partial(PrefetchIterator, "
                 "device=\"cpu\")"},
    drop={"test_step_profiler_disabled_is_noop": _PROFILING,
          "test_step_profiler_traces_window": _PROFILING,
          "test_trace_context_manager": _PROFILING,
          "test_step_profiler_early_loop_exit_closes_trace": _PROFILING,
          # a wall-clock bound (R7's kind under load)
          "test_prefetch_overlaps_source_latency":
              "tests/test_torch_data.py of that name"})
