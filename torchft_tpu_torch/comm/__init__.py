from torchft_tpu_torch.comm.context import (  # noqa: F401
    CommContext,
    CompletedWork,
    DummyCommContext,
    ErrorSwallowingCommContext,
    FailedWork,
    ManagedCommContext,
    ReduceOp,
    Work,
)
from torchft_tpu_torch.comm.store import (  # noqa: F401
    PrefixStore,
    StoreClient,
    StoreServer,
    create_store_client,
)
from torchft_tpu_torch.comm.topology import (  # noqa: F401
    DomainAssignment,
    DomainTopology,
)
from torchft_tpu_torch.comm.transport import TcpCommContext  # noqa: F401
from torchft_tpu_torch.comm.subproc import SubprocessCommContext  # noqa: F401
