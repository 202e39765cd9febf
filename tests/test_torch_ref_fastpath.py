"""The cases of tests/test_fastpath.py that tests/test_torch_fastpath.py
has no twin of, over the port: the fast path's counters served on the
Manager's ``/telemetry/metrics`` (under the reference's name and
assertions, tests/test_torch_twin.py says how), and fleet_top's lease
columns, held below on the port's live payload where the reference feeds
scripts/fleet_top.py a made-up one.
"""

import json
import os
import sys
import urllib.request

from tests.test_torch_twin import reference_twin

_HELD = "tests/test_torch_fastpath.py of that name"

reference_twin(globals(), "test_fastpath", drop={
    **dict.fromkeys((
        "test_steady_state_steps_are_zero_rpc",
        "test_fastpath_disabled_by_env",
        "test_epoch_bump_mid_vote_falls_back",
        "test_latch_edge_during_local_start_quorum",
        "test_injected_error_mid_lease_never_fast_commits",
        "test_lease_expiry_racing_should_commit",
        "test_kill_mid_lease_before_vote_lands",
        "test_epoch_watch_renews_and_reports_change",
        "test_take_commit_vote_semantics",
        "test_vote_window_resets_on_configure"), _HELD),
    "test_fleet_top_build_row_lease_columns": "below, on a live payload",
})


def _fleet_top():
    scripts = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "scripts")
    if scripts not in sys.path:
        sys.path.insert(0, scripts)
    import fleet_top

    return fleet_top


def test_fleet_top_build_row_lease_columns(store, lease_lighthouse) -> None:
    # the lease columns from a leased port Manager's own /telemetry
    # payload: a live lease shows its epoch and zero control RPCs a step,
    # a broken one "-" and the RPCs it pays; the payload without the
    # lease fields leaves both columns empty
    fleet_top = _fleet_top()
    manager = _make_solo(store, lease_lighthouse, replica_id="fp_row_")
    try:
        for _ in range(3):
            assert _step(manager)
        url = (StoreClient(store.addr, connect_timeout=5.0)
               .get("checkpoint_addr_0").decode())
        with urllib.request.urlopen(url + "/telemetry/metrics",
                                    timeout=10) as resp:
            tel = json.load(resp)
        ep = {"replica_id": "fp_row", "rank": 0, "step": tel["step"]}
        polled = {"metrics": tel, "events": {"events": []}}
        row = fleet_top.build_row(ep, polled)
        assert tel["lease_live"] is True
        assert row["lease"] == f"e{tel['lease_epoch']}"
        assert row["rpc_step"] == 0
        tel["lease_live"], tel["control_rpcs_per_step"] = False, 2
        row = fleet_top.build_row(ep, polled)
        assert row["lease"] == "-" and row["rpc_step"] == 2
        del tel["lease_live"], tel["control_rpcs_per_step"]
        row = fleet_top.build_row(ep, polled)
        assert row["lease"] is None and row["rpc_step"] is None
    finally:
        manager.shutdown(wait=False)
