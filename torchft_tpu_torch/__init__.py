"""torchft_tpu_torch — the PyTorch/CUDA port of torchft_tpu.

Per-step fault tolerance for replicated training on NVIDIA GPUs: a quorum
of healthy replica groups every step (the native lighthouse and manager
servers in native/), cross-group gradient averaging over a reconfigurable
TCP transport, an optimizer gated on a two-phase commit, and live heals of
restarted groups from a peer. The model's attention runs hand-written CUDA
kernels for Hopper (``ops/flash.py``, ``csrc/``). Entry points run on CUDA
unless asked for the CPU (``device="cpu"``).
"""

from torchft_tpu_torch.comm import (  # noqa: F401
    DummyCommContext,
    ErrorSwallowingCommContext,
    ManagedCommContext,
    ReduceOp,
    TcpCommContext,
)
from torchft_tpu_torch.data import DistributedSampler  # noqa: F401
from torchft_tpu_torch.ddp import (  # noqa: F401
    DistributedDataParallel,
    PureDistributedDataParallel,
)
from torchft_tpu_torch.local_sgd import DiLoCo, LocalSGD  # noqa: F401
from torchft_tpu_torch.manager import Manager, WorldSizeMode  # noqa: F401
from torchft_tpu_torch.optim import (  # noqa: F401
    OptimizerWrapper,
    ShardedOptimizerWrapper,
)
