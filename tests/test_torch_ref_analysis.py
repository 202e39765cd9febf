"""The cases of tests/test_analysis.py over the port's lints
(``torchft_tpu_torch.analysis``), whole, under the reference's names and
assertions (tests/test_torch_twin.py says how); its real-tree case lints
the port's own tree."""

from tests.test_torch_twin import reference_twin

reference_twin(globals(), "test_analysis")
