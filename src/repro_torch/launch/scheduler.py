"""Scheduler policies and load-adaptive frontier degradation for the paged
serve engine.

The admission order, the load-shedding decision and the overload response are
POLICY, not engine mechanics - this module makes each a first-class object so
``launch.serve.serve_slo`` can run the same engine under FIFO,
shortest-prompt-first or SLO-deadline scheduling and the bench can compare
them on identical seeded traffic.

Shedding reuses the engine's graceful per-request failure contract: a shed
request retires through ``Engine.fail_request`` with a typed
``error_kind="shed"`` status - never an engine death.

:class:`PressureController` is the overload response the paper uniquely
enables: under pressure (queue depth / pool occupancy) it steps the engine
DOWN the committed EDAP frontier (lower B_ADC: less energy and delay per DP,
lower SNR_T - ``core.design.frontier_ladder``), and back up when pressure
clears.  The swap (``Engine.swap_substrate``) is a host-side attribute
update between decode chunks.
"""
from __future__ import annotations

import logging
from typing import Dict, List, Sequence, Type

log = logging.getLogger("repro_torch.scheduler")

_FAR_FUTURE = float("inf")


def _ttft_deadline_abs(req) -> float:
    """Absolute virtual-time TTFT deadline (inf if the request has none)."""
    if req.arrive_at is None or req.ttft_deadline is None:
        return _FAR_FUTURE
    return req.arrive_at + req.ttft_deadline


class SchedulerPolicy:
    """Admission-order + shedding policy over the pending queue.

    ``order`` permutes the queue in place (the engine still admits the FIFO
    prefix of whatever order the policy chose); ``shed`` removes and returns
    the requests to retire with a typed shed status BEFORE admission, so a
    hopeless request never consumes prefill compute.  Stateless by default;
    instances may carry counters."""

    name = "fifo"

    def order(self, queue: List, now: float) -> None:
        return None

    def shed(self, queue: List, now: float) -> List:
        return []


class FIFOPolicy(SchedulerPolicy):
    """Strict arrival order, never sheds - the baseline every other policy
    is measured against."""

    name = "fifo"


class ShortestPromptFirst(SchedulerPolicy):
    """Admit cheap prefills first (classic SJF on the known cost component).
    Stable sort: equal lengths keep arrival order.  Resumed (preempted)
    requests sort by their full effective prompt - they are mid-flight and
    cheap to finish, so they naturally stay near the front."""

    name = "sjf"

    def order(self, queue: List, now: float) -> None:
        queue.sort(key=lambda r: len(r.prompt) + len(r.out))


class DeadlineSLOPolicy(SchedulerPolicy):
    """Earliest-TTFT-deadline-first admission with load shedding.

    Ordering: resumed requests (generation already started - their TTFT is
    already decided) go first to finish and free blocks; fresh requests run
    earliest-deadline-first.  Shedding: a fresh request whose TTFT deadline
    has already passed can no longer meet its SLO no matter what - serving
    it would only steal capacity from requests that still can, so it is
    shed (typed ``error_kind="shed"``, counted, never an engine death)."""

    name = "deadline"

    def __init__(self, slack: float = 0.0):
        # shed only once the deadline is `slack` past due: slack > 0 trades
        # a little wasted work for serving near-miss requests anyway
        self.slack = slack
        self.shed_count = 0

    def order(self, queue: List, now: float) -> None:
        queue.sort(key=lambda r: (-_FAR_FUTURE if r.out
                                  else _ttft_deadline_abs(r)))

    def shed(self, queue: List, now: float) -> List:
        doomed = [r for r in queue
                  if not r.out and now > _ttft_deadline_abs(r) + self.slack]
        for r in doomed:
            queue.remove(r)
        self.shed_count += len(doomed)
        return doomed


POLICIES: Dict[str, Type[SchedulerPolicy]] = {
    FIFOPolicy.name: FIFOPolicy,
    ShortestPromptFirst.name: ShortestPromptFirst,
    DeadlineSLOPolicy.name: DeadlineSLOPolicy,
}


def make_policy(name: str) -> SchedulerPolicy:
    try:
        return POLICIES[name]()
    except KeyError:
        raise ValueError(
            f"unknown scheduler policy {name!r}; have {sorted(POLICIES)}")


class PressureController:
    """Load-adaptive frontier degradation with hysteresis.

    Watches the engine's queue depth and KV pool occupancy each serve-loop
    tick; after ``hold`` consecutive high-pressure ticks it steps one level
    DOWN the substrate ladder (``core.substrate.substrate_ladder`` - lower
    B_ADC, lower energy/delay per DP, lower SNR_T), after ``hold``
    consecutive low-pressure ticks it steps back up.  The engine re-freezes
    each ladder substrate with its own live calibration, so site names are
    preserved and every move is a host-side attribute update.

    Virtual time: each level's decode step costs its frontier delay ratio
    (``design.delay_per_dp / base.delay_per_dp`` < 1 when degraded), which is
    exactly how stepping down the frontier buys goodput under overload.
    """

    def __init__(self, engine, ladder: Sequence, high: float = 1.0,
                 low: float = 0.25, hold: int = 2):
        if not ladder:
            raise ValueError("need a non-empty substrate ladder")
        if high <= low:
            raise ValueError(f"need high > low (got {high} <= {low})")
        self.engine = engine
        self.ladder = list(ladder)
        base = self.ladder[0].design
        self.time_scales = [
            (s.design.delay_per_dp / base.delay_per_dp
             if (base is not None and s.design is not None) else 1.0)
            for s in self.ladder
        ]
        self.high = high
        self.low = low
        self.hold = hold
        self.level = 0
        self.degrade_steps = 0
        self.upgrade_steps = 0
        self._hot = 0
        self._cool = 0

    def pressure(self) -> float:
        """max(queue depth per slot, KV pool occupancy): either resource
        saturating is pressure."""
        qp = self.engine.queue_depth / max(self.engine.batch_slots, 1)
        cap = self.engine.alloc.num_blocks - 1
        pp = self.engine.alloc.used_count / cap if cap > 0 else 0.0
        return max(qp, pp)

    def update(self) -> int:
        """One serve-loop tick; returns the (possibly new) ladder level."""
        p = self.pressure()
        if p >= self.high:
            self._hot += 1
            self._cool = 0
        elif p <= self.low:
            self._cool += 1
            self._hot = 0
        else:
            self._hot = self._cool = 0
        if self._hot >= self.hold and self.level < len(self.ladder) - 1:
            self.level += 1
            self.degrade_steps += 1
            self._hot = 0
            self._apply("degrade", p)
        elif self._cool >= self.hold and self.level > 0:
            self.level -= 1
            self.upgrade_steps += 1
            self._cool = 0
            self._apply("upgrade", p)
        return self.level

    def _apply(self, direction: str, p: float):
        sub = self.ladder[self.level]
        self.engine.swap_substrate(sub, time_scale=self.time_scales[self.level])
        log.info("pressure %.2f: %s to frontier level %d (b_adc=%s, "
                 "time_scale=%.3f)", p, direction, self.level,
                 getattr(sub.design, "b_adc", None),
                 self.time_scales[self.level])

    def counters(self) -> Dict[str, float]:
        return {
            "level": self.level,
            "degrade_steps": self.degrade_steps,
            "upgrade_steps": self.upgrade_steps,
        }
