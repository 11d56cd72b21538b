"""Serving runtime of the port: seeded SLO workloads on a virtual clock.

Drift monitoring, fault retry and the prefix cache are not ported yet.
"""
from repro_torch.runtime.workload import (  # noqa: F401
    DEFAULT_CLASSES,
    RequestClass,
    VirtualClock,
    WorkloadConfig,
    generate,
    make_overload_config,
)
