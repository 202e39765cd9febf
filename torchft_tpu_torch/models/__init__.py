from torchft_tpu_torch.models.transformer import (  # noqa: F401
    CONFIGS,
    GPT,
    TrainStep,
    TransformerConfig,
    count_params,
    from_jax_params,
    loss_fn,
    make_train_step,
)
from torchft_tpu_torch.models.moe_transformer import (  # noqa: F401
    MOE_CONFIGS,
    MoETransformer,
    MoETransformerConfig,
)
