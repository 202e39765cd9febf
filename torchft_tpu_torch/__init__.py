"""torchft_tpu_torch — the PyTorch/CUDA port of torchft_tpu.

Per-step fault tolerance for replicated training on NVIDIA GPUs: a quorum
of healthy replica groups every step (the native lighthouse and manager
servers in native/), cross-group gradient averaging over a reconfigurable
TCP transport, an optimizer gated on a two-phase commit, and live heals of
restarted groups from a peer. The model's attention runs hand-written CUDA
kernels for Hopper (``ops/flash.py``, ``csrc/``). Entry points run on CUDA
unless asked for the CPU (``device="cpu"``).
"""

import importlib
from typing import Any

from torchft_tpu_torch.comm import (  # noqa: F401
    DummyCommContext,
    ErrorSwallowingCommContext,
    ManagedCommContext,
    ReduceOp,
    TcpCommContext,
)

# The names that need torch load on first use (PEP 562), so a process that
# imports only the wire (comm/subproc.py's child) never imports torch.
_LAZY = {
    "DistributedSampler": "torchft_tpu_torch.data",
    "DistributedDataParallel": "torchft_tpu_torch.ddp",
    "PureDistributedDataParallel": "torchft_tpu_torch.ddp",
    "DiLoCo": "torchft_tpu_torch.local_sgd",
    "LocalSGD": "torchft_tpu_torch.local_sgd",
    "Manager": "torchft_tpu_torch.manager",
    "WorldSizeMode": "torchft_tpu_torch.manager",
    "OptimizerWrapper": "torchft_tpu_torch.optim",
    "ShardedOptimizerWrapper": "torchft_tpu_torch.optim",
}


def __getattr__(name: str) -> Any:
    module = _LAZY.get(name)
    if module is not None:
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
