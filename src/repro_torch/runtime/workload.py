"""Seeded SLO-aware workload generation for the serve engine.

The ROADMAP's production scenarios need traffic that looks like traffic:
requests ARRIVE over time (Poisson or bursty), prompt and output lengths are
heavy-tailed (lognormal, clipped), and requests belong to multi-tenant
classes with per-class TTFT / inter-token deadlines.  This module generates
such workloads **deterministically from a seed** - every draw comes from one
`numpy.random.default_rng(seed)` stream, so a `serve_slo` bench record is
reproducible draw-for-draw with no wall clock anywhere.

Time is VIRTUAL, measured in decode-step units (:class:`VirtualClock`): one
decode step at the baseline substrate costs 1.0, a prefill token costs
``prefill_token_cost`` (prefill rows run batched, so a bucket costs
``bucket * prefill_token_cost`` regardless of R), and a degraded substrate
scales the decode step by its frontier delay ratio (``clock.time_scale``).
Arrival times and deadlines live on the same axis, which makes TTFT,
inter-token latency and goodput pure functions of the seed.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Tuple

import numpy as np


class VirtualClock:
    """Deterministic serve-loop time in decode-step units.

    The engine advances it: ``n_steps * time_scale`` per decode chunk
    and ``bucket * prefill_token_cost`` per batched prefill group.  The
    ``PressureController`` writes ``time_scale`` when it moves the engine
    along the EDAP frontier (a degraded design point has a smaller
    delay-per-DP, so its steps cost less virtual time).
    """

    def __init__(self, prefill_token_cost: float = 0.125,
                 time_scale: float = 1.0):
        self.now = 0.0
        self.prefill_token_cost = prefill_token_cost
        self.time_scale = time_scale

    def advance(self, dt: float):
        if dt < 0:
            raise ValueError(f"time cannot run backwards (dt={dt})")
        self.now += dt


@dataclasses.dataclass(frozen=True)
class RequestClass:
    """A tenant class: how much of the traffic it is and what it expects.

    Deadlines are in virtual steps: ``ttft_deadline`` bounds arrival ->
    first token, ``itl_deadline`` bounds the gap between consecutive
    generated tokens (both checked post-hoc by ``metering.slo_summary``;
    the deadline scheduler additionally sheds requests that can no longer
    meet their TTFT deadline)."""

    name: str
    weight: float
    ttft_deadline: float
    itl_deadline: float


DEFAULT_CLASSES: Tuple[RequestClass, ...] = (
    RequestClass("interactive", weight=0.7, ttft_deadline=48.0,
                 itl_deadline=6.0),
    RequestClass("batch", weight=0.3, ttft_deadline=192.0,
                 itl_deadline=24.0),
)


@dataclasses.dataclass(frozen=True)
class WorkloadConfig:
    """Everything a workload draw depends on (hash it, commit it, replay it).

    ``arrival`` is "poisson" (exponential inter-arrival gaps with mean
    ``mean_interarrival``) or "bursty" (groups of ``burst_size`` arrivals
    separated by ``burst_size * mean_interarrival`` quiet gaps - same mean
    rate, much worse peaks).  Prompt lengths and true generation lengths
    (``stop_at`` - the EOS the engine cannot know at admission) are
    lognormal, clipped to the given bounds; ``max_new`` is the per-request
    generation CAP, so ``stop_at < max_new`` requests are the early-stopping
    mix that worst-case block reservation over-provisions for."""

    n_requests: int = 32
    seed: int = 0
    arrival: str = "poisson"  # "poisson" | "bursty"
    mean_interarrival: float = 4.0  # virtual steps between arrivals
    burst_size: int = 4
    prompt_median: float = 8.0
    prompt_sigma: float = 0.6
    prompt_min: int = 1
    prompt_max: int = 32
    max_new: int = 8
    gen_median: float = 6.0
    gen_sigma: float = 0.5
    classes: Tuple[RequestClass, ...] = DEFAULT_CLASSES
    # shared-system-prompt traffic: every request's prompt starts with a
    # ``prefix_len``-token prefix drawn from its CLASS's pool of distinct
    # prefixes (pool size ~ class share of n_requests / prefix_dup, so
    # ``prefix_dup`` requests share each system prompt on average - the
    # high-duplication regime prefix-sharing KV caches exist for).  0
    # disables (every prompt fully unique, the legacy draw, stream-identical
    # to pre-prefix workloads).
    prefix_len: int = 0
    prefix_dup: int = 4

    def __post_init__(self):
        if self.arrival not in ("poisson", "bursty"):
            raise ValueError(f"unknown arrival process {self.arrival!r}")
        if not self.classes:
            raise ValueError("need at least one request class")
        if self.prefix_len < 0 or self.prefix_dup < 1:
            raise ValueError("prefix_len must be >= 0 and prefix_dup >= 1")


def make_overload_config(n_requests: int = 32, seed: int = 0,
                         overload: float = 2.0, slots: int = 4,
                         max_new: int = 8, arrival: str = "bursty",
                         prefill_token_cost: float = 0.125,
                         **kw) -> WorkloadConfig:
    """A workload offered at ``overload`` times the engine's service rate.

    Capacity model (virtual steps): ``slots`` streams each deliver one token
    per step, so a request costing roughly ``prompt * prefill_token_cost +
    E[stop_at]`` steps of single-stream work is served at rate
    ``slots / cost``.  Setting the mean inter-arrival to ``cost / (slots *
    overload)`` offers ``overload``x that - at 2x, half the offered SLO-load
    is physically unservable and the scheduler has to choose."""
    probe = WorkloadConfig(n_requests=1, seed=0, max_new=max_new, **kw)
    mean_prompt = probe.prompt_median * math.exp(probe.prompt_sigma ** 2 / 2)
    mean_gen = min(probe.gen_median * math.exp(probe.gen_sigma ** 2 / 2),
                   float(max_new))
    # shared prefixes are costed COLD here: the capacity model prices what a
    # cache-less engine must serve, so a prefix cache shows up as headroom
    cost = (mean_prompt + probe.prefix_len) * prefill_token_cost + mean_gen
    return WorkloadConfig(
        n_requests=n_requests, seed=seed, arrival=arrival, max_new=max_new,
        mean_interarrival=cost / (max(slots, 1) * overload), **kw)


def _lognormal_int(rng: np.random.Generator, median: float, sigma: float,
                   lo: int, hi: int) -> int:
    draw = rng.lognormal(mean=math.log(median), sigma=sigma)
    return int(np.clip(round(draw), lo, hi))


def _arrival_times(rng: np.random.Generator, wcfg: WorkloadConfig) -> List[float]:
    times: List[float] = []
    t = 0.0
    if wcfg.arrival == "poisson":
        for _ in range(wcfg.n_requests):
            t += rng.exponential(wcfg.mean_interarrival)
            times.append(t)
        return times
    # bursty: burst_size near-simultaneous arrivals, then a quiet gap that
    # restores the overall mean rate (peak rate ~ burst_size x the mean)
    intra = wcfg.mean_interarrival / max(wcfg.burst_size, 1)
    quiet = wcfg.mean_interarrival * wcfg.burst_size
    i = 0
    while i < wcfg.n_requests:
        t += rng.exponential(quiet)
        for _ in range(min(wcfg.burst_size, wcfg.n_requests - i)):
            t += rng.exponential(intra)
            times.append(t)
            i += 1
    return times


def generate(wcfg: WorkloadConfig, vocab_size: int) -> List["Request"]:
    """Draw the workload: a list of ``launch.serve.Request`` (sorted by
    ``arrive_at``, rid = arrival order) with prompts, generation caps, true
    stop lengths, class tags and per-class deadlines all seeded."""
    # lazy import: runtime must stay importable without the launch layer
    from repro_torch.launch.serve import Request

    rng = np.random.default_rng(wcfg.seed)
    times = _arrival_times(rng, wcfg)
    weights = np.array([c.weight for c in wcfg.classes], float)
    weights = weights / weights.sum()
    # per-class shared-system-prompt pools: each class holds roughly
    # (its share of n_requests) / prefix_dup distinct prefixes, all drawn
    # from the SAME seeded stream (prefix_len == 0 adds no draws, so legacy
    # workloads replay identically).  Pool draws happen up front, in class
    # order, so the stream layout is independent of per-request choices.
    pools: dict = {}
    if wcfg.prefix_len > 0:
        for c, w in zip(wcfg.classes, weights):
            n_pool = max(1, round(w * wcfg.n_requests / wcfg.prefix_dup))
            pools[c.name] = [rng.integers(0, vocab_size, wcfg.prefix_len)
                             for _ in range(n_pool)]
    reqs: List[Request] = []
    for rid, t in enumerate(times):
        cls = wcfg.classes[int(rng.choice(len(wcfg.classes), p=weights))]
        plen = _lognormal_int(rng, wcfg.prompt_median, wcfg.prompt_sigma,
                              wcfg.prompt_min, wcfg.prompt_max)
        stop = _lognormal_int(rng, wcfg.gen_median, wcfg.gen_sigma,
                              1, wcfg.max_new)
        prompt = rng.integers(0, vocab_size, plen)
        if wcfg.prefix_len > 0:
            pool = pools[cls.name]
            prefix = pool[int(rng.integers(0, len(pool)))]
            prompt = np.concatenate([prefix, prompt])
        reqs.append(Request(
            rid=rid,
            prompt=prompt,
            max_new=wcfg.max_new,
            stop_at=stop,
            arrive_at=float(t),
            rclass=cls.name,
            ttft_deadline=cls.ttft_deadline,
            itl_deadline=cls.itl_deadline,
        ))
    return reqs
