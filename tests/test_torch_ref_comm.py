"""Every case of tests/test_comm.py over the port's TCP wire: the
collective sweep, reconfigure, the error latch, the ring against the
star, the per-op wire latency hook (``TcpCommContext._op_delay``: four
lanes overlap it, one lane serializes it), the codecs' numerics, wire
sizes and ``encode_views``, under the reference's names and assertions
(tests/test_torch_twin.py says how).
"""

from tests.test_torch_twin import reference_twin

reference_twin(globals(), "test_comm")
