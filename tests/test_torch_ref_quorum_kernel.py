"""Every case of tests/test_quorum_kernel.py over the port's binding of
the native quorum kernel (``ft_json_roundtrip``, ``ft_quorum_compute``,
the incremental quorum), under the reference's names and assertions
(tests/test_torch_twin.py says how).
"""

from tests.test_torch_twin import reference_twin

reference_twin(globals(), "test_quorum_kernel")
