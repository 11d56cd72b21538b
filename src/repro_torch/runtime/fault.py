"""The fault runtime: which device errors a retry is worth, the one retry
idiom the serve engine and the training loop share, and the fault-tolerant
training loop (the port of the reference's ``repro/runtime/fault.py``).

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
or to the CPU.

The training loop (:class:`TrainLoopRunner`) handles a failed step (retry,
then restart from the newest checkpoint), a straggler (a step past its
deadline raises :class:`StepTimeout`, which escalates to a restart), a step
torn while it changed the state in place (:class:`TornState`: a restart), and
preemption (SIGTERM: a synchronous final save).  :func:`elastic_remesh`
rebuilds a mesh from the ranks that are alive; checkpoints restore onto any
device and the data pipeline is counter-based, so training resumes where it
stopped.
"""
from __future__ import annotations

import dataclasses
import logging
import signal
import time
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch import tree as tree_lib
from repro_torch.checkpoint import manager as ckpt

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


@dataclasses.dataclass
class FaultConfig:
    ckpt_dir: str  # no default: two runs must not share one by accident
    save_every: int = 50
    keep: int = 3
    max_step_retries: int = 2
    step_deadline_s: Optional[float] = None  # straggler mitigation
    max_restarts: int = 3
    async_save: bool = True


class StepTimeout(RuntimeError):
    pass


class TornState(RuntimeError):
    """A step failed after it began changing the state in place (the
    optimizer update): a retry would run on half-updated tensors, so the
    loop restarts from the newest checkpoint instead."""


def _synchronize(metrics, state):
    """Wait for the step's work on the device of its first metric (or,
    without metrics, of the state's first leaf)."""
    first = tree_lib.leaves(metrics) or tree_lib.leaves(state)
    t = first[0] if first else None
    if isinstance(t, torch.Tensor) and t.is_cuda:
        torch.cuda.synchronize(t.device)


class TrainLoopRunner:
    """Runs ``step_fn(state, batch) -> (state, metrics)`` fault-tolerantly.

    ``step_fn`` may change ``state``'s tensors in place (the port's train
    step does, after its forward and backward pass).  A failed step is
    retried on the same state; one that raises :class:`TornState` (it
    failed while changing the state) or :class:`StepTimeout` escalates to a
    restart from the newest checkpoint."""

    def __init__(
        self,
        step_fn: Callable,
        init_state_fn: Callable[[], Any],
        batch_fn: Callable[[int], Dict],
        cfg: FaultConfig,
        failure_injector: Optional[Callable[[int], None]] = None,
    ):
        self.step_fn = step_fn
        self.init_state_fn = init_state_fn
        self.batch_fn = batch_fn
        self.cfg = cfg
        self.failure_injector = failure_injector
        self.saver = ckpt.AsyncSaver()
        self._preempted = False

    # -- preemption handling -------------------------------------------------
    def install_preemption_handler(self):
        def _handler(signum, frame):
            log.warning("preemption signal received; will save and exit")
            self._preempted = True

        signal.signal(signal.SIGTERM, _handler)

    # -- state restore --------------------------------------------------------
    def _restore_or_init(self) -> Tuple[Any, int]:
        state = self.init_state_fn()
        last = ckpt.latest_step(self.cfg.ckpt_dir)
        if last is None:
            return state, 0
        restored, extra = ckpt.restore(self.cfg.ckpt_dir, last, state)
        log.info("restored checkpoint at step %d", last)
        return restored, int(extra.get("next_step", last))

    # -- one guarded step ------------------------------------------------------
    def _guarded_step(self, state, batch, step: int):
        deadline = self.cfg.step_deadline_s

        def attempt():
            t0 = time.monotonic()
            if self.failure_injector is not None:
                self.failure_injector(step)
            new_state, metrics = self.step_fn(state, batch)
            # wait for the device so stragglers/timeouts are observable
            _synchronize(metrics, new_state)
            dt = time.monotonic() - t0
            if deadline is not None and dt > deadline:
                raise StepTimeout(
                    f"step {step} took {dt:.1f}s > deadline {deadline}s"
                )
            return new_state, metrics

        # stragglers (StepTimeout) and torn states escalate to a restart,
        # anything else is retried in place - the shared serve/train idiom
        return call_with_retries(
            attempt, self.cfg.max_step_retries,
            retryable=lambda e: not isinstance(e, (StepTimeout, TornState)),
            describe=f"step {step}",
        )

    # -- the loop ---------------------------------------------------------------
    def run(self, total_steps: int) -> Tuple[Any, Dict]:
        restarts = 0
        history: Dict[str, Any] = {"loss": [], "restarts": 0, "retried": 0}
        while True:
            try:
                state, step = self._restore_or_init()
                while step < total_steps and not self._preempted:
                    batch = self.batch_fn(step)
                    state, metrics = self._guarded_step(state, batch, step)
                    if "loss" in metrics:
                        history["loss"].append(float(metrics["loss"]))
                    step += 1
                    if step % self.cfg.save_every == 0 or step == total_steps:
                        extra = {"next_step": step}
                        # serialize wait -> cleanup -> save: cleanup removes
                        # stray .tmp dirs and must never run while an async
                        # save is mid-write (it would delete the in-flight
                        # .tmp and lose the checkpoint)
                        self.saver.wait()
                        ckpt.cleanup(self.cfg.ckpt_dir, self.cfg.keep)
                        if self.cfg.async_save:
                            self.saver.save(self.cfg.ckpt_dir, step, state,
                                            extra)
                        else:
                            ckpt.save(self.cfg.ckpt_dir, step, state, extra)
                if self._preempted:
                    self.saver.wait()
                    ckpt.save(self.cfg.ckpt_dir, step, state,
                              {"next_step": step})
                self.saver.wait()
                history["restarts"] = restarts
                return state, history
            except Exception as e:  # noqa: BLE001
                restarts += 1
                log.warning("run failed (%r); restart %d", e, restarts)
                self.saver.wait()
                if restarts > self.cfg.max_restarts:
                    raise


def elastic_remesh(model_axis: Optional[int] = None):
    """Rebuild a mesh from the ranks that are currently alive
    (``launch.mesh.make_host_mesh``).

    After losing ranks, callers rebuild the step functions against this
    mesh; checkpoint restore is device-agnostic (``repro_torch.checkpoint``)
    and the data pipeline is counter-based (``repro_torch.data``), so
    training resumes where it stopped, modulo batch layout."""
    from repro_torch.launch.mesh import make_host_mesh

    return make_host_mesh(model_axis)
