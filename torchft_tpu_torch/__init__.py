"""torchft_tpu_torch — the PyTorch/CUDA port of torchft_tpu.

Per-step fault tolerance for replicated training on NVIDIA GPUs: a quorum
of healthy replica groups every step (the native lighthouse and manager
servers in native/), cross-group gradient averaging over a reconfigurable
TCP transport, an optimizer gated on a two-phase commit, and live heals of
restarted groups from a peer, and a serving cohort that adopts committed
weights while it answers (``serve.py``). The model's attention runs
hand-written CUDA kernels for Hopper (``ops/flash.py``, ``csrc/``). Entry
points run on CUDA unless asked for the CPU (``device="cpu"``).
"""

import importlib
from typing import Any

# Lock-order detector opt-in (TORCHFT_TPU_LOCKCHECK=1): installs before the
# imports below create their module-level locks. Unset, a no-op; the lint
# suite's checkers stay unimported (stdlib only, and no torch).
from torchft_tpu_torch.analysis.lockcheck import (
    maybe_install as _lockcheck_install,
)

_lockcheck_install()
del _lockcheck_install

from torchft_tpu_torch.comm import (  # noqa: E402,F401
    CommContext,
    DummyCommContext,
    ErrorSwallowingCommContext,
    ManagedCommContext,
    ReduceOp,
    SubprocessCommContext,
    TcpCommContext,
)
from torchft_tpu_torch.futures import (  # noqa: E402,F401
    future_chain,
    future_timeout,
    future_wait,
)

# The names that need torch load on first use (PEP 562), so a process that
# imports only the wire (comm/subproc.py's child) never imports torch.
_LAZY = {
    "AsyncCheckpointWriter": "torchft_tpu_torch.checkpoint_io",
    "DcpCheckpointer": "torchft_tpu_torch.checkpoint_io",
    "load_checkpoint": "torchft_tpu_torch.checkpoint_io",
    "CheckpointServer": "torchft_tpu_torch.checkpointing",
    "CheckpointTransport": "torchft_tpu_torch.checkpointing",
    "CudaCommContext": "torchft_tpu_torch.comm.cuda_backend",
    "DevicePool": "torchft_tpu_torch.comm.cuda_backend",
    "DistributedSampler": "torchft_tpu_torch.data",
    "DistributedDataParallel": "torchft_tpu_torch.ddp",
    "PureDistributedDataParallel": "torchft_tpu_torch.ddp",
    "ShardedGradReducer": "torchft_tpu_torch.ddp",
    "DiLoCo": "torchft_tpu_torch.local_sgd",
    "LocalSGD": "torchft_tpu_torch.local_sgd",
    "Manager": "torchft_tpu_torch.manager",
    "WorldSizeMode": "torchft_tpu_torch.manager",
    "OptimizerWrapper": "torchft_tpu_torch.optim",
    "ShardedOptimizerWrapper": "torchft_tpu_torch.optim",
    "ShardedOptState": "torchft_tpu_torch.optim",
    "Pipeline": "torchft_tpu_torch.pipeline",
    "PipelineConfig": "torchft_tpu_torch.pipeline",
    "DeployPublisher": "torchft_tpu_torch.serve",
    "ServeCohort": "torchft_tpu_torch.serve",
    "ServingReplica": "torchft_tpu_torch.serve",
    "serve_layout": "torchft_tpu_torch.serve",
}
# the reference's alias (torchft_tpu.Optimizer is its OptimizerWrapper)
_ALIASES = {"Optimizer": "OptimizerWrapper"}

# The reference's public names this package binds, under the same names;
# its XlaCommContext, MeshManager and OrbaxCheckpointer have their twins here
# as CudaCommContext, DevicePool and DcpCheckpointer.
__all__ = [
    "AsyncCheckpointWriter",
    "CheckpointServer",
    "CheckpointTransport",
    "CommContext",
    "CudaCommContext",
    "DcpCheckpointer",
    "DeployPublisher",
    "DevicePool",
    "DiLoCo",
    "DistributedDataParallel",
    "DistributedSampler",
    "DummyCommContext",
    "ErrorSwallowingCommContext",
    "LocalSGD",
    "ManagedCommContext",
    "Manager",
    "Optimizer",
    "OptimizerWrapper",
    "Pipeline",
    "PipelineConfig",
    "PureDistributedDataParallel",
    "ReduceOp",
    "ServeCohort",
    "ServingReplica",
    "ShardedGradReducer",
    "ShardedOptimizerWrapper",
    "ShardedOptState",
    "SubprocessCommContext",
    "TcpCommContext",
    "WorldSizeMode",
    "future_chain",
    "future_timeout",
    "future_wait",
    "load_checkpoint",
    "serve_layout",
]


def __getattr__(name: str) -> Any:
    module = _LAZY.get(name)
    if name in _ALIASES:
        value = __getattr__(_ALIASES[name])
    elif module is not None:
        value = getattr(importlib.import_module(module), name)
    else:
        try:  # a submodule, as an eager package would have bound it
            value = importlib.import_module(f"{__name__}.{name}")
        except ModuleNotFoundError as e:
            if e.name != f"{__name__}.{name}":
                raise
            raise AttributeError(
                f"module {__name__!r} has no attribute {name!r}") from None
    globals()[name] = value
    return value
