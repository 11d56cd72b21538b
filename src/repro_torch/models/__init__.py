"""Attention-only decoder models (the slice of the JAX model zoo ported so
far)."""
from repro_torch.models.model import (  # noqa: F401
    decode_step,
    forward,
    init_paged_cache,
    init_params,
    prefill,
    resolve_device,
)
