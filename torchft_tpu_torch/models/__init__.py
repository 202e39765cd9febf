from torchft_tpu_torch.models.transformer import (  # noqa: F401
    CONFIGS,
    GPT,
    ShardedGPT,
    TrainStep,
    TransformerConfig,
    count_params,
    from_jax_params,
    gpt_param_shapes,
    gpt_param_tree,
    loss_fn,
    make_grad_step,
    make_train_step,
)
from torchft_tpu_torch.models.moe_transformer import (  # noqa: F401
    MOE_CONFIGS,
    MoETransformer,
    MoETransformerConfig,
    ShardedMoETransformer,
    moe_param_shapes,
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
from torchft_tpu_torch.models.mlp import (  # noqa: F401
    init_linear,
    init_mlp,
    linear_forward,
    mlp_forward,
)
from torchft_tpu_torch.models.resnet import (  # noqa: F401
    ResNet18,
    create_resnet18,
    resnet_from_jax,
    resnet_state_tree,
)
