"""Job launcher for multi-replica-group training.

Twin of ``torchft_tpu/launcher.py``: one plain subprocess spec per worker
of every replica group, with the lighthouse and per-group environment
plumbing (no torchrun needed):

    specs = hsdp_spec(num_replica_groups=2,
                      script="torchft_tpu_torch/examples/train_ddp.py",
                      lighthouse_addr="http://lh:29510")
    procs = launch_local(specs)          # for local/CI runs
    # or feed `specs` to a scheduler of choice

Environment per worker (read by ``torchft_tpu_torch.Manager``):
    TORCHFT_TPU_LIGHTHOUSE  global lighthouse address
    REPLICA_GROUP_ID / NUM_REPLICA_GROUPS   data sharding
    RANK / WORLD_SIZE       local rank within the replica group
    MASTER_ADDR / MASTER_PORT   the group's rendezvous store (rank 0 binds
                                it; other ranks connect)
    TORCHFT_TPU_MANAGER_PORT    the group's manager server port (29600 + i)
"""

from __future__ import annotations

import os
import subprocess
import sys
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from torchft_tpu_torch.manager import LIGHTHOUSE_ENV, MANAGER_PORT_ENV

__all__ = ["ReplicaGroupSpec", "hsdp_spec", "launch_local", "LIGHTHOUSE_ENV"]


@dataclass
class ReplicaGroupSpec:
    """Launch spec of one worker process of a replica group."""

    replica_group_id: int
    rank: int
    cmd: List[str]
    env: Dict[str, str] = field(default_factory=dict)


def hsdp_spec(
    script: str,
    num_replica_groups: int,
    lighthouse_addr: str,
    workers_per_group: int = 1,
    base_manager_port: int = 29600,
    base_store_port: int = 29700,
    master_addr: str = "127.0.0.1",
    extra_env: Optional[Dict[str, str]] = None,
    script_args: Optional[List[str]] = None,
) -> List[ReplicaGroupSpec]:
    """One spec per worker (num_replica_groups x workers_per_group), with
    the rank and store plumbing: rank 0 of each group binds the group store
    at MASTER_ADDR:MASTER_PORT, the other ranks connect to it."""
    specs = []
    for i in range(num_replica_groups):
        for rank in range(workers_per_group):
            env = {
                LIGHTHOUSE_ENV: lighthouse_addr,
                "REPLICA_GROUP_ID": str(i),
                "NUM_REPLICA_GROUPS": str(num_replica_groups),
                "RANK": str(rank),
                "WORLD_SIZE": str(workers_per_group),
                "MASTER_ADDR": master_addr,
                "MASTER_PORT": str(base_store_port + i),
                MANAGER_PORT_ENV: str(base_manager_port + i),
            }
            if extra_env:
                env.update(extra_env)
            specs.append(ReplicaGroupSpec(
                replica_group_id=i, rank=rank,
                cmd=[sys.executable, script, *(script_args or [])],
                env=env,
            ))
    return specs


def launch_local(specs: List[ReplicaGroupSpec],
                 **popen_kwargs) -> List[subprocess.Popen]:
    """Spawn every worker as a local subprocess: the current environment
    overlaid with the spec's. Callers own wait/kill (a kill and relaunch is
    a replica failure and rejoin)."""
    procs = []
    for spec in specs:
        env = dict(os.environ)
        env.update(spec.env)
        procs.append(subprocess.Popen(spec.cmd, env=env, **popen_kwargs))
    return procs
