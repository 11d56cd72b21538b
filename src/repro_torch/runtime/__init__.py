"""Serving runtime of the port: seeded SLO workloads on a virtual clock, the
prefix-sharing radix index, online calibration-drift monitoring for frozen
substrates, and the fault runtime (what counts as a transient device error,
the retry idiom, and the fault-tolerant training loop).
"""
from repro_torch.runtime.drift import (  # noqa: F401
    DriftConfig,
    DriftMonitor,
    DriftReport,
    DriftThresholds,
    detect_drift,
    effective_snr_t_db,
    refreshed_calibration,
    site_snr_table,
)
from repro_torch.runtime.fault import (  # noqa: F401
    TRANSIENT_ERROR_TYPES,
    FaultConfig,
    StepTimeout,
    TrainLoopRunner,
    TransientDeviceError,
    call_with_retries,
    elastic_remesh,
    is_transient_device_error,
)
from repro_torch.runtime.prefix_cache import PrefixCache  # noqa: F401
from repro_torch.runtime.workload import (  # noqa: F401
    DEFAULT_CLASSES,
    RequestClass,
    VirtualClock,
    WorkloadConfig,
    generate,
    make_overload_config,
)
