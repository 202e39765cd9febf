"""The case of tests/test_integration_proc.py over the port: replica
groups as OS processes, a SIGKILL, a relaunch and its heal, under the
reference's name and assertions (tests/test_torch_twin.py says how)."""

from tests.test_torch_twin import reference_twin

reference_twin(globals(), "test_integration_proc")
