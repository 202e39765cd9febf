from torchft_tpu_torch.comm.context import (  # noqa: F401
    CommContext,
    DummyCommContext,
    ErrorSwallowingCommContext,
    ManagedCommContext,
    ReduceOp,
    Work,
)
from torchft_tpu_torch.comm.store import StoreClient, StoreServer  # noqa: F401
from torchft_tpu_torch.comm.topology import (  # noqa: F401
    DomainAssignment,
    DomainTopology,
)
from torchft_tpu_torch.comm.transport import TcpCommContext  # noqa: F401
from torchft_tpu_torch.comm.subproc import SubprocessCommContext  # noqa: F401
