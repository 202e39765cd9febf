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
from torchft_tpu_torch.models.llama import (  # noqa: F401
    LLAMA_CONFIGS,
    Llama,
    LlamaConfig,
    llama_forward,
    llama_forward_hidden,
    llama_init_params,
    llama_loss_fn,
    llama_param_tree,
)
