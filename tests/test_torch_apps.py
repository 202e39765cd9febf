"""The port's parameter server and launcher against the JAX package's.

Twins of tests/test_apps.py's parameter-server session round trip and
``hsdp_spec`` environment test, and mixed sessions: a server of one
package with a client of the other (the store and the TCP wire's frames
are byte-compatible, so a session spans both).
"""

import subprocess
import sys

import numpy as np
import pytest

from torchft_tpu import parameter_server as ref_ps
from torchft_tpu.launcher import hsdp_spec as ref_hsdp_spec
from torchft_tpu_torch.launcher import (
    LIGHTHOUSE_ENV,
    ReplicaGroupSpec,
    hsdp_spec,
    launch_local,
)
from torchft_tpu_torch.parameter_server import (
    ParameterServer,
    ParameterServerClient,
)


def _echo_session(comm, sessions, session_id):
    """Server side: receive the client's broadcast, send it back doubled."""
    sessions.append(session_id)
    received = comm.broadcast([np.zeros(4, np.float32)],
                              root=1).future().result(timeout=10)
    doubled = [a * 2 for a in received]
    comm.broadcast(doubled, root=0).future().result(timeout=10)


class EchoPS(ParameterServer):
    """Server doubles whatever the client broadcasts to it."""

    def __init__(self):
        super().__init__(timeout=10.0)
        self.sessions = []

    def handle_session(self, session_id, comm):
        _echo_session(comm, self.sessions, session_id)


class RefEchoPS(ref_ps.ParameterServer):
    def __init__(self):
        super().__init__(timeout=10.0)
        self.sessions = []

    def handle_session(self, session_id, comm):
        _echo_session(comm, self.sessions, session_id)


def _client_round(comm) -> np.ndarray:
    payload = np.full(4, 21.0, dtype=np.float32)
    comm.broadcast([payload], root=1).future().result(timeout=10)
    out = comm.broadcast([np.zeros(4, np.float32)],
                         root=0).future().result(timeout=10)
    comm.shutdown()
    return out[0]


def test_parameter_server_session_roundtrip() -> None:
    ps = EchoPS()
    try:
        client = ParameterServerClient(ps.address(), timeout=10.0)
        np.testing.assert_allclose(_client_round(client.new_session()),
                                   np.full(4, 42.0))
        assert len(ps.sessions) == 1
        # a second session gets a fresh context
        np.testing.assert_allclose(_client_round(client.new_session()),
                                   np.full(4, 42.0))
        assert len(ps.sessions) == 2
        assert ps.sessions[0] != ps.sessions[1]
    finally:
        ps.shutdown()


@pytest.mark.parametrize("server", ["reference", "port"])
def test_mixed_session(server) -> None:
    # a reference server with a port client, and the other way round
    if server == "reference":
        ps, client_cls = RefEchoPS(), ParameterServerClient
    else:
        ps, client_cls = EchoPS(), ref_ps.ParameterServerClient
    try:
        comm = client_cls(ps.address(), timeout=10.0).new_session()
        np.testing.assert_allclose(_client_round(comm), np.full(4, 42.0))
        assert len(ps.sessions) == 1
    finally:
        ps.shutdown()


def test_unknown_path_is_404() -> None:
    import urllib.error
    import urllib.request

    ps = EchoPS()
    try:
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(ps.address() + "/nope", timeout=10)
        assert err.value.code == 404
        assert ps.sessions == []
    finally:
        ps.shutdown()


def test_hsdp_spec_env_plumbing() -> None:
    kw = dict(script="torchft_tpu_torch/examples/train_ddp.py",
              num_replica_groups=3, lighthouse_addr="http://lh:29510",
              workers_per_group=4, extra_env={"MODEL": "tiny"},
              script_args=["--flag"])
    specs = hsdp_spec(**kw)
    assert len(specs) == 12  # groups x workers
    for spec in specs:
        i, r = spec.replica_group_id, spec.rank
        assert spec.env[LIGHTHOUSE_ENV] == "http://lh:29510"
        assert spec.env["REPLICA_GROUP_ID"] == str(i)
        assert spec.env["NUM_REPLICA_GROUPS"] == "3"
        assert spec.env["RANK"] == str(r)
        assert spec.env["WORLD_SIZE"] == "4"
        assert spec.env["MASTER_PORT"] == str(29700 + i)
        assert spec.env["TORCHFT_TPU_MANAGER_PORT"] == str(29600 + i)
        assert spec.env["MODEL"] == "tiny"
        assert spec.cmd[-1] == "--flag"
    assert {(s.replica_group_id, s.rank) for s in specs} == {
        (i, r) for i in range(3) for r in range(4)}
    # the reference's specs, field for field
    ref = ref_hsdp_spec(**kw)
    assert [(s.replica_group_id, s.rank, s.cmd, s.env) for s in specs] \
        == [(s.replica_group_id, s.rank, s.cmd, s.env) for s in ref]


def test_launch_local_overlays_the_spec_env() -> None:
    spec = ReplicaGroupSpec(
        replica_group_id=0, rank=0,
        cmd=[sys.executable, "-c",
             "import os; print(os.environ['REPLICA_GROUP_ID'], "
             "os.environ['TORCHFT_TPU_LIGHTHOUSE'])"],
        env={"REPLICA_GROUP_ID": "5",
             "TORCHFT_TPU_LIGHTHOUSE": "http://lh:1"})
    (proc,) = launch_local([spec], stdout=subprocess.PIPE, text=True)
    out, _ = proc.communicate(timeout=60)
    assert proc.returncode == 0
    assert out.split() == ["5", "http://lh:1"]
