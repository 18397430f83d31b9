from repro_torch.configs.base import (  # noqa: F401
    LayerKind,
    LK,
    ModelConfig,
    SparseAttnConfig,
    SSMConfig,
    Stage,
    get_config,
    list_configs,
    register,
)
