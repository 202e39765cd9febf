"""The cases of tests/test_lockcheck.py over the port's lock-order
detector (``analysis.lockcheck``), whole, under the reference's names and
assertions (tests/test_torch_twin.py says how)."""

from tests.test_torch_twin import reference_twin

reference_twin(globals(), "test_lockcheck")
