"""Optimizers (the port of ``repro/optim``): AdamW and Adafactor, schedules,
global-norm clip, updating parameters and state in place leaf by leaf."""
from repro_torch.optim.optimizers import (  # noqa: F401
    Optimizer,
    adafactor,
    adamw,
    clip_by_global_norm,
    global_norm,
    make_optimizer,
    scan_of,
    tree_leaves,
    tree_unflatten,
)
from repro_torch.optim.schedules import cosine_schedule, linear_warmup  # noqa: F401
