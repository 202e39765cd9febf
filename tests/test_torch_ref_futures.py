"""The cases of tests/test_futures.py over the port's futures, under the
reference's names and assertions (tests/test_torch_twin.py says how).
"""

from tests.test_torch_twin import reference_twin

reference_twin(globals(), "test_futures", drop={
    # a fixed 0.2 s deadline the host may overrun under load (R7); the
    # port holds the same 200 timers with a check that follows each
    # future's own schedule
    "test_many_timers_stress": "tests/test_torch_control.py "
                               "test_timer_stress",
})
