"""The case of tests/test_graft_entry.py over the port's entry point
(``graft_entry.dryrun_multichip``), under the reference's name and
assertions (tests/test_torch_twin.py says how). The suite is marked slow,
and so is its twin."""

from tests.test_torch_twin import reference_twin

reference_twin(globals(), "test_graft_entry")
