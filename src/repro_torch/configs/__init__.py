"""Architecture config registry: ``get(name)`` / ``get_smoke(name)`` /
``ARCH_NAMES``.  Only the architectures ported so far are known; the others
raise with a pointer to the port's ROADMAP."""
from repro_torch.configs import musicgen_medium
from repro_torch.configs.base import ArchConfig  # noqa: F401

_MODULES = {
    "musicgen-medium": musicgen_medium,
}

# the reference's other architectures, not ported yet
_WAITING = (
    "internvl2-2b", "recurrentgemma-2b", "granite-moe-1b-a400m", "dbrx-132b",
    "deepseek-coder-33b", "granite-20b", "phi3-mini-3.8b", "gemma2-9b",
    "mamba2-2.7b",
)

ARCH_NAMES = tuple(_MODULES.keys())


def _module(name: str):
    if name in _MODULES:
        return _MODULES[name]
    if name in _WAITING:
        raise NotImplementedError(
            f"architecture {name!r} is not ported to PyTorch yet "
            "(ROADMAP: other archs wait for later slices)")
    raise KeyError(f"unknown architecture {name!r}")


def get(name: str) -> ArchConfig:
    return _module(name).CONFIG


def get_smoke(name: str) -> ArchConfig:
    return _module(name).SMOKE
