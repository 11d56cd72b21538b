"""Optimizers: AdamW with global-norm clipping and its LR schedule (the
reference's ``repro.optim`` without ``compression``, which serves
data-parallel training)."""
from repro_torch.optim.adamw import (  # noqa: F401
    AdamWConfig,
    OptState,
    global_norm,
    init,
    update,
    warmup_cosine,
)
