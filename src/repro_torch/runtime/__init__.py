"""Serving runtime of the port: seeded SLO workloads on a virtual clock, the
prefix-sharing radix index, online calibration-drift monitoring for frozen
substrates, and the serving half of the fault runtime (what counts as a
transient device error, and the retry idiom).  The training half of
``runtime.fault`` (``TrainLoopRunner``, ``elastic_remesh``) waits for the
port of training.
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
    TransientDeviceError,
    call_with_retries,
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
