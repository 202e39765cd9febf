"""In-group parallelism: the device mesh and its replica axis
(``mesh.py``), the fsdp and tensor layouts of parameters and the sharded
leaf that holds them (``sharding.py``), ring attention over a sequence
axis (``ring.py``), the expert-parallel MoE block (``moe.py``), and the
pipeline stages over a ``stage`` axis (``pipeline.py``) with their
schedules as data (``schedule.py``)."""

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
    ExpertPlan,
    MoEConfig,
    init_moe_params,
    moe_forward,
    moe_forward_sharded,
    moe_rules,
    sharded_moe_forward,
)
from torchft_tpu_torch.parallel.sharding import (  # noqa: F401
    NamedSharding,
    PartitionSpec,
    ShardedTensor,
    fsdp_sharding,
    make_sharding_fn,
    replicated,
    shard_pytree,
    tp_rules_gpt,
)
from torchft_tpu_torch.parallel.ring import (  # noqa: F401
    make_ring_attention,
    ring_attention,
    ring_launches,
    ring_schedule,
)
from torchft_tpu_torch.parallel.pipeline import (  # noqa: F401
    make_pipeline,
    make_pipeline_1f1b,
    make_pipeline_interleaved_1f1b,
    merge_microbatches,
    split_microbatches,
    stack_interleaved_params,
    stack_stage_params,
)
from torchft_tpu_torch.parallel.schedule import (  # noqa: F401
    bubble_fraction,
    gpipe_schedule,
    interleaved_1f1b_schedule,
    interleaved_tables,
    one_f_one_b_schedule,
    peak_inflight_activations,
    validate_schedule,
)
