"""Every case of tests/test_control_plane.py over the port: its
lighthouse and manager servers, the HTTP clients, the quorum and
should_commit voting, checkpoint metadata, kill and the dashboard, under
the reference's names and assertions (tests/test_torch_twin.py says how).
"""

from tests.test_torch_twin import reference_twin

reference_twin(globals(), "test_control_plane")
