"""The serving half of the fault runtime: which device errors a retry is
worth, and the one retry idiom the serve engine uses.

A transient error is one a re-run of the same call may not meet again: the
card ran out of memory for a moment (``torch.cuda.OutOfMemoryError``), or a
failure injector simulated a device fault (:class:`TransientDeviceError`).
Everything else propagates at once, in particular:

  - a kernel the card refused to launch (``kernels.build.KernelLaunchError``,
    raised by every kernel wrapper on a nonzero launch status);
  - a kernel source ``nvcc`` refused (a ``RuntimeError`` from
    ``kernels.build``);
  - a device-side assert, which leaves the CUDA context unusable
    (``torch.AcceleratorError`` or a ``RuntimeError``).

A retry or a retirement there would hide a broken kernel.  A retry re-runs
the same CUDA call on the same device: nothing falls back to a plain version
or to the CPU.  The training half (``TrainLoopRunner``, ``elastic_remesh``)
comes with the port of training.
"""
from __future__ import annotations

import logging
from typing import Any, Callable, Optional

import torch

log = logging.getLogger("repro_torch.fault")


class TransientDeviceError(RuntimeError):
    """A device fault worth one retry; what failure injectors and tests
    raise (the counterpart of the reference's ``XlaRuntimeError``)."""


#: exception types a retry is worth attempting for
TRANSIENT_ERROR_TYPES = (TransientDeviceError, torch.cuda.OutOfMemoryError)


def is_transient_device_error(e: BaseException) -> bool:
    """True for device errors worth a retry (:data:`TRANSIENT_ERROR_TYPES`).
    Kernel launch and build failures, device-side asserts and Python-level
    bugs are not transient: retrying them only hides the fault."""
    return isinstance(e, TRANSIENT_ERROR_TYPES)


def call_with_retries(fn: Callable[[], Any], max_retries: int, *,
                      retryable: Optional[Callable[[BaseException],
                                                    bool]] = None,
                      describe: str = "step",
                      logger: Optional[logging.Logger] = None):
    """Run ``fn()``, re-running it up to ``max_retries`` times when it raises
    an exception ``retryable`` accepts (default: any ``Exception``); the
    final failure propagates to the caller."""
    lg = logger or log
    for attempt in range(max_retries + 1):
        try:
            return fn()
        except Exception as e:  # noqa: BLE001 - device errors are dynamic
            if (retryable is not None and not retryable(e)) \
                    or attempt >= max_retries:
                raise
            lg.warning("%s attempt %d failed: %r; retrying", describe,
                       attempt, e)
    raise AssertionError("unreachable")
