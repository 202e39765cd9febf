"""Every case of tests/test_store.py over the port's rendezvous store,
under the reference's names and assertions (tests/test_torch_twin.py says
how). Its clients against the reference's server and back are
tests/test_torch_control.py ``test_store_interop``.
"""

from tests.test_torch_twin import reference_twin

reference_twin(globals(), "test_store")
