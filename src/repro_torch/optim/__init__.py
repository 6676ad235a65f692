from repro_torch.optim.optimizers import (  # noqa: F401
    Optimizer,
    adamw,
    apply_updates,
    cosine_schedule,
    linear_warmup,
    make_optimizer,
    sgd,
)
