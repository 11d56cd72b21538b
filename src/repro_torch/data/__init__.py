"""Deterministic data pipeline (the reference's ``repro.data``)."""
from repro_torch.data.pipeline import (  # noqa: F401
    DataConfig,
    MemmapCorpus,
    Prefetcher,
    SyntheticLM,
    host_slice,
    make_source,
)
