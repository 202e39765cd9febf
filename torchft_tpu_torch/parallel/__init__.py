"""In-group parallelism: the expert-parallel MoE block (``moe.py``)."""

from torchft_tpu_torch.parallel.moe import (  # noqa: F401
    MoEConfig,
    init_moe_params,
    moe_forward,
)
