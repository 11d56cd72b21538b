"""The JAX model zoo's decoders: global and sliding-window attention, the
Mamba-2 SSD and RG-LRU recurrent blocks, dense and mixture-of-experts MLPs,
and VLM prefix embeddings."""
from repro_torch.models.model import (  # noqa: F401
    decode_step,
    forward,
    init_paged_cache,
    init_params,
    loss_fn,
    param_bytes,
    prefill,
    resolve_device,
)
