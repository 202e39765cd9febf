"""The cases of tests/test_fleet.py over the port's control plane: the
two-level lighthouse tree (a domain aggregator reporting its summary to
the root, the root flagging a stale aggregator), scripts/fleet_top.py
walking the port's tree, and batched heartbeats, under the reference's
names and assertions (tests/test_torch_twin.py says how).

``TestBenchFleet`` drives scripts/bench_fleet.py, which imports the JAX
package's control plane and measures it (a benchmark of the reference,
as ``bench.py`` is): its oracle, the incremental quorum against the
native kernel, is held on the port by tests/test_torch_ref_quorum_kernel.py
and tests/test_torch_control.py
``test_incremental_quorum_counters_match_the_reference``.
"""

from tests.test_torch_twin import reference_twin

reference_twin(globals(), "test_fleet",
               drop={"TestBenchFleet": "drives the JAX package's bench"})
