"""The cases of tests/test_subproc_comm.py over the port's subprocess wire
(``comm.subproc.SubprocessCommContext``), whole, under the reference's
names and assertions (tests/test_torch_twin.py says how)."""

from tests.test_torch_twin import reference_twin

reference_twin(globals(), "test_subproc_comm")
