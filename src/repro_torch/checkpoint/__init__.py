"""Atomic, manifest-verified, async checkpointing (the reference's
``repro.checkpoint``)."""
from repro_torch.checkpoint.manager import (  # noqa: F401
    AsyncSaver,
    cleanup,
    latest_step,
    restore,
    save,
)
