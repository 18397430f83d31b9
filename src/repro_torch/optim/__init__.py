from repro_torch.optim.optimizers import (  # noqa: F401
    Optimizer, adamw, clip_by_global_norm, global_norm, sgd, value_and_grad,
)
from repro_torch.optim.schedules import (  # noqa: F401
    constant, cosine_decay, linear_warmup_cosine,
)
