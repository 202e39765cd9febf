"""In-group parallelism: the device mesh and its replica axis
(``mesh.py``), ring attention over a sequence axis (``ring.py``) and the
expert-parallel MoE block (``moe.py``)."""

from torchft_tpu_torch.parallel.mesh import (  # noqa: F401
    AXIS_DATA,
    AXIS_EXPERT,
    AXIS_FSDP,
    AXIS_SEQ,
    AXIS_TENSOR,
    REPLICA_AXIS,
    FTMesh,
    Mesh,
    ft_mesh,
)
from torchft_tpu_torch.parallel.moe import (  # noqa: F401
    MoEConfig,
    init_moe_params,
    moe_forward,
)
from torchft_tpu_torch.parallel.ring import (  # noqa: F401
    make_ring_attention,
    ring_attention,
    ring_launches,
    ring_schedule,
)
