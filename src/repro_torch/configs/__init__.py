"""Architecture config registry: ``get(name)`` / ``get_smoke(name)`` /
``ARCH_NAMES``, the reference's ten architectures."""
from repro_torch.configs import (
    dbrx_132b,
    deepseek_coder_33b,
    gemma2_9b,
    granite_20b,
    granite_moe_1b,
    internvl2_2b,
    mamba2_2p7b,
    musicgen_medium,
    phi3_mini,
    recurrentgemma_2b,
)
from repro_torch.configs.base import ArchConfig  # noqa: F401

# in the reference registry's order
_MODULES = {
    "internvl2-2b": internvl2_2b,
    "recurrentgemma-2b": recurrentgemma_2b,
    "granite-moe-1b-a400m": granite_moe_1b,
    "dbrx-132b": dbrx_132b,
    "deepseek-coder-33b": deepseek_coder_33b,
    "granite-20b": granite_20b,
    "phi3-mini-3.8b": phi3_mini,
    "gemma2-9b": gemma2_9b,
    "musicgen-medium": musicgen_medium,
    "mamba2-2.7b": mamba2_2p7b,
}

ARCH_NAMES = tuple(_MODULES.keys())


def _module(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown architecture {name!r}")
    return _MODULES[name]


def get(name: str) -> ArchConfig:
    return _module(name).CONFIG


def get_smoke(name: str) -> ArchConfig:
    return _module(name).SMOKE
