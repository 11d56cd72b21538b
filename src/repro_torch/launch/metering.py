"""Serve-path energy-delay metering: roll real serving traffic up to the
paper's energy-delay-accuracy metrics.

The serve engine (``launch.serve.Engine``) reports tok/s and KV bytes; the
paper's headline result is an energy-delay frontier over QS/QR/CM design
points.  This module is the missing link: a :class:`DPMeter` counts the
dot-product work the engine admits - per phase (prefill vs decode) and per
matmul site - and :func:`serve_energy_report` multiplies those counts by a
``core.design`` design point's ``energy_per_dp`` / ``delay_per_dp`` to report
J/token, J/request, EDP/token and compute-model tok/s.

Metering costs nothing on device: every count is a pure function of the
host-side call arguments the engine already computes (the admitted
``(R, bucket)`` of each batched prefill and the ``(active, T)`` of each
decode chunk), so the one-``(slots, T)``-block transfer per chunk is
untouched.

Billing policy (the reference's, pinned by the tests against it):

  * prefill bucket padding IS billed: an admitted row executes the full
    ``(bucket,)``-token matmul sequence regardless of its true length - pad
    positions occupy real bank conversions;
  * dummy pow2-R pad rows are NOT billed: they exist only to keep the
    prefill shapes to powers of two and their outputs are dropped before any
    bank would be scheduled for them;
  * decode bills ACTIVE slots only: inactive rows in the decode chunk are a
    batching artifact (their writes go to the garbage block), not work a
    deployed accelerator must schedule.

The per-site shapes walk is shared with ``benchmarks/model_energy`` and
``launch.breakdown`` (``core.mapping.per_token_matmul_shapes``), and the
per-token energy/delay math is shared with ``core.design.workload_metrics``
- one code path, so serve-side and training-side accounting cannot silently
double-count a site.

Billing is substrate-first: the engine records the
``core.substrate.Substrate`` it executes on the meter, and
:func:`serve_energy_report` accepts a substrate whose (possibly per-site)
design points price each matmul site - the design point billed is the one
the substrate object actually carries, not a parallel flag.  The legacy
``design=`` argument remains as the uniform-design special case.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence

from repro_torch.core import design as design_lib
from repro_torch.core.design import DesignPoint
from repro_torch.core.mapping import MatmulShape, per_token_matmul_shapes
from repro_torch.core.substrate import Substrate


class DPMeter:
    """Counts billed token-forwards (and thus dot-product evaluations) per
    phase and per matmul site for a served workload.

    The engine calls :meth:`note_prefill` once per batched ``(R, bucket)``
    prefill group and :meth:`note_decode` once per decode chunk; both
    are O(1) host-side integer updates.
    """

    def __init__(self, cfg=None, sites: Optional[Sequence[MatmulShape]] = None,
                 substrate: Optional[Substrate] = None):
        if sites is None:
            if cfg is None:
                raise ValueError("need a model config or an explicit site list")
            sites = per_token_matmul_shapes(cfg)
        self.sites: List[MatmulShape] = list(sites)
        # the substrate whose matmuls this meter counted: the serve engine
        # stamps its own substrate here at construction, so the rollup knows
        # what actually ran without any parallel flag plumbing
        self.substrate: Optional[Substrate] = substrate
        # prefill: billed = admitted rows x bucket (pad rows excluded)
        self.prefill_billed_tokens = 0
        self.prefill_true_tokens = 0
        self.prefill_groups = 0
        self.prefill_rows = 0
        # decode: billed = active rows x scan length
        self.decode_billed_tokens = 0
        self.decode_chunks = 0
        # robustness / online-calibration counters (engine hook points; all
        # O(1) host-side, same contract as the prefill/decode notes)
        self.shadow_samples = 0
        self.drift_checks = 0
        self.drift_events = 0
        self.calibration_swaps = 0
        self.failed_requests = 0
        self.drift_reports: List[dict] = []
        # overload-resilience counters (same O(1) host-side contract)
        self.shed_requests = 0
        self.preemptions = 0
        self.substrate_swaps = 0
        # prefix-sharing counters: a hit admission bills only its uncached
        # suffix; ``prefix_saved_billed_tokens`` is the billed prefill work a
        # cold admission of the same request WOULD have executed minus what
        # the warm one did - the tokens whose dot-product energy the cache
        # avoided outright (priced by serve_energy_report)
        self.prefix_lookups = 0
        self.prefix_hits = 0
        self.prefix_hit_tokens = 0
        self.prefix_saved_billed_tokens = 0
        self.cow_copies = 0
        # tensor-parallel provenance: the sharded engine stamps its mesh and
        # per-device KV pool capacity so energy/bench rollups can report the
        # per-device footprint next to the billed work
        self.mesh_shape: Optional[str] = None
        self.mesh_devices = 1
        self.kv_pool_bytes_per_device = 0

    # -- engine hook points ---------------------------------------------------
    def note_mesh(self, mesh_shape: Optional[str], devices: int,
                  kv_pool_bytes_per_device: int = 0):
        """The engine serves over a device mesh: record its ``RxC`` shape,
        device count, and structural per-device KV pool capacity (head-sharded
        pools carry 1/model_axis of the bytes on each device)."""
        self.mesh_shape = mesh_shape
        self.mesh_devices = devices
        self.kv_pool_bytes_per_device = kv_pool_bytes_per_device

    def note_shadow_sample(self):
        """One chunk / prefill group ran with shadow calibration recording."""
        self.shadow_samples += 1

    def note_drift_report(self, report: dict):
        """One drift-detector check ran; ``report`` is the structured
        ``runtime.drift.DriftReport.to_dict()`` payload."""
        self.drift_checks += 1
        if report.get("drifted"):
            self.drift_events += 1
        self.drift_reports.append(report)

    def note_swap(self):
        """The engine hot-swapped a refreshed calibration."""
        self.calibration_swaps += 1

    def note_request_failure(self):
        """One request retired with a per-request error status."""
        self.failed_requests += 1

    def note_shed(self):
        """The scheduler shed one request (typed per-request status)."""
        self.shed_requests += 1

    def note_preemption(self):
        """One mid-generation recompute-preemption (blocks freed, request
        re-queued with its generated tokens)."""
        self.preemptions += 1

    def note_substrate_swap(self, substrate: Optional[Substrate] = None):
        """The engine hot-swapped its execution substrate (frontier
        degradation step).  Energy rollups keep billing the substrate stamped
        on the meter - a mixed-level workload is billed at whichever level
        the report reads, which the serve_slo record states explicitly."""
        self.substrate_swaps += 1

    def drift_summary(self) -> Optional[dict]:
        """Structured rollup of the online-calibration activity this meter
        observed (None if the workload ran without a drift monitor)."""
        if not (self.shadow_samples or self.drift_checks
                or self.calibration_swaps):
            return None
        return {
            "shadow_samples": self.shadow_samples,
            "drift_checks": self.drift_checks,
            "drift_events": self.drift_events,
            "calibration_swaps": self.calibration_swaps,
            "failed_requests": self.failed_requests,
            "last_report": self.drift_reports[-1] if self.drift_reports
            else None,
        }
    def note_prefix_admission(self, suffix_billed: int, cold_bucket: int,
                              hit_tokens: int):
        """One prefix-HIT admission: ``suffix_billed`` token-forwards of
        suffix prefill actually ran (teacher-forced decode steps - no bucket
        padding, one row), against the ``cold_bucket`` a cold admission
        would have billed; ``hit_tokens`` prompt positions were served from
        cached blocks without any dot-product work."""
        self.prefill_billed_tokens += suffix_billed
        self.prefill_true_tokens += suffix_billed
        self.prefill_groups += 1
        self.prefill_rows += 1
        self.prefix_lookups += 1
        self.prefix_hits += 1
        self.prefix_hit_tokens += hit_tokens
        self.prefix_saved_billed_tokens += max(0, cold_bucket - suffix_billed)

    def note_prefix_miss(self):
        """One cold admission under an enabled prefix cache (its blocks are
        now indexed for future sharers)."""
        self.prefix_lookups += 1

    def note_cow_copy(self):
        """One copy-on-write block copy (a write landed in a shared block)."""
        self.cow_copies += 1

    def note_prefill(self, r_real: int, bucket: int,
                     true_lens: Optional[Sequence[int]] = None):
        """One admitted prefill group: ``r_real`` real rows (pow2 pad rows
        excluded), each billed for the full ``bucket`` positions."""
        self.prefill_billed_tokens += r_real * bucket
        if true_lens is not None:
            self.prefill_true_tokens += int(sum(true_lens))
        self.prefill_groups += 1
        self.prefill_rows += r_real

    def note_decode(self, n_active: int, n_steps: int):
        """One decode chunk: ``n_active`` live slots each execute
        ``n_steps`` token-forwards."""
        self.decode_billed_tokens += n_active * n_steps
        self.decode_chunks += 1

    # -- derived counts -------------------------------------------------------
    @property
    def billed_tokens(self) -> int:
        return self.prefill_billed_tokens + self.decode_billed_tokens

    @property
    def prefill_pad_tokens(self) -> int:
        """Billed-but-useless bucket-padding positions."""
        return self.prefill_billed_tokens - self.prefill_true_tokens

    def site_triples(self):
        """``(k, m, calls)`` triples (the ``core.design.workload_metrics``
        workload format)."""
        return [(s.k, s.m, s.calls) for s in self.sites]

    def dp_counts(self, phase: str = "total", rows: int = 512) -> Dict[str, float]:
        """Dot-product evaluations per matmul site for ``phase`` ("prefill" |
        "decode" | "total"), with DP dimensions tiled onto ``rows``-row banks
        (``ceil(k / rows)`` bank DPs per output column)."""
        tokens = {
            "prefill": self.prefill_billed_tokens,
            "decode": self.decode_billed_tokens,
            "total": self.billed_tokens,
        }[phase]
        return {
            s.name: tokens * s.calls * s.m * math.ceil(s.k / rows)
            for s in self.sites
        }


# ---------------------------------------------------------------------------
# rollup: meter counts x design point -> the paper's serving metrics
# ---------------------------------------------------------------------------


def energy_for_tokens(sites, design: DesignPoint, tokens: float) -> dict:
    """Energy/delay of ``tokens`` token-forwards over ``sites`` at ``design``.

    THE shared rollup helper: ``launch.breakdown`` (training/profiling side)
    and :func:`serve_energy_report` (serve side) both call it, so one full
    forward is costed identically no matter which path bills it.  ``sites``
    may be :class:`MatmulShape` objects or ``(k, m, calls)`` triples.
    """
    triples = [
        (s.k, s.m, s.calls) if isinstance(s, MatmulShape) else tuple(s)
        for s in sites
    ]
    per_tok = design_lib.workload_metrics(design, triples)
    return {
        "energy_j": tokens * per_tok["energy_per_token_j"],
        "energy_per_token_j": per_tok["energy_per_token_j"],
        "delay_per_token_s": per_tok["delay_per_token_s"],
        "edp_per_token": per_tok["edp_per_token"],
    }


def substrate_energy_for_tokens(sites: Sequence[MatmulShape],
                                substrate: Substrate, tokens: float) -> dict:
    """Like :func:`energy_for_tokens`, but each site is billed at the design
    point the SUBSTRATE assigns to it (``Substrate.design_for_site``), so
    MPC-style per-site overrides - e.g. the output head at a higher B_ADC -
    price exactly the hardware they describe.  With no per-site overrides
    this reduces to ``energy_for_tokens(sites, substrate.design, tokens)``
    exactly (same additions in the same site order)."""
    energy = 0.0
    delay = 0.0
    for s in sites:
        pt = substrate.design_for_site(s.name)
        if pt is None:
            raise ValueError(
                f"substrate {substrate.name!r} carries no design point for "
                f"site {s.name!r}; attach one with with_design()/overrides")
        per_tok = design_lib.workload_metrics(pt, [(s.k, s.m, s.calls)])
        energy += per_tok["energy_per_token_j"]
        delay += per_tok["delay_per_token_s"]
    return {
        "energy_j": tokens * energy,
        "energy_per_token_j": energy,
        "delay_per_token_s": delay,
        "edp_per_token": energy * delay,
    }


@dataclasses.dataclass(frozen=True)
class EnergyReport:
    """A served workload rolled up at one design point.

    ``j_per_token`` divides TOTAL billed energy (prefill + decode) by the
    tokens actually delivered to requests; ``edp_per_token`` multiplies it by
    the compute-model decode latency of one token-forward;
    ``tok_s_compute`` is the per-stream decode rate the compute model alone
    would allow (1 / delay_per_token - the serving analogue of the paper's
    delay axis, independent of the host wall clock).
    """

    design: DesignPoint
    prefill_tokens: int  # billed token-forwards (bucket padding included)
    decode_tokens: int  # billed token-forwards (active slots only)
    generated_tokens: int  # tokens delivered to requests
    requests: int
    prefill_j: float
    decode_j: float
    delay_per_token_s: float
    # the substrate whose (per-site) design points priced this workload;
    # None for legacy uniform-design rollups
    substrate: Optional[Substrate] = None
    # structured online-calibration rollup (DPMeter.drift_summary()); None
    # when the workload ran without a drift monitor
    drift: Optional[dict] = None
    # billed prefill energy the prefix cache avoided (the cold-admission
    # dot-products that never ran), priced through the same rollup as the
    # billed work; 0.0 for prefix-free workloads
    saved_prefill_j: float = 0.0

    @property
    def total_j(self) -> float:
        return self.prefill_j + self.decode_j

    @property
    def j_per_token_saved(self) -> float:
        """Avoided prefill energy per delivered token: the prefix cache's
        J/token discount (what j_per_token WOULD grow by without sharing)."""
        return self.saved_prefill_j / max(self.generated_tokens, 1)

    @property
    def j_per_token(self) -> float:
        return self.total_j / max(self.generated_tokens, 1)

    @property
    def j_per_request(self) -> float:
        return self.total_j / max(self.requests, 1)

    @property
    def edp_per_token(self) -> float:
        return self.j_per_token * self.delay_per_token_s

    @property
    def tok_s_compute(self) -> float:
        return 1.0 / self.delay_per_token_s if self.delay_per_token_s > 0 else float("inf")

    def summary(self) -> Dict[str, float]:
        out = {
            "substrate": (self.substrate.name if self.substrate is not None
                          else None),
            "arch_kind": self.design.arch_kind,
            "n": self.design.n,
            "n_banks": self.design.n_banks,
            "b_adc": self.design.b_adc,
            "knob": self.design.knob,
            "snr_t_db": round(self.design.snr_t_db, 2),
            "prefill_tokens": self.prefill_tokens,
            "decode_tokens": self.decode_tokens,
            "generated_tokens": self.generated_tokens,
            "requests": self.requests,
            "prefill_j": self.prefill_j,
            "decode_j": self.decode_j,
            "j_per_token": self.j_per_token,
            "j_per_request": self.j_per_request,
            "edp_per_token": self.edp_per_token,
            "delay_per_token_s": self.delay_per_token_s,
            "tok_s_compute": self.tok_s_compute,
        }
        # drift activity / prefix savings ride along only when they
        # happened: the legacy record shape is unchanged otherwise
        if self.drift is not None:
            out["drift"] = self.drift
        if self.saved_prefill_j:
            out["saved_prefill_j"] = self.saved_prefill_j
            out["j_per_token_saved"] = self.j_per_token_saved
        return out


def serve_energy_report(
    meter: DPMeter,
    design: Optional[DesignPoint] = None,
    generated_tokens: Optional[int] = None,
    requests: Optional[int] = None,
    substrate: Optional[Substrate] = None,
) -> EnergyReport:
    """Roll a metered serve workload up to J/token, J/request, EDP/token and
    compute-model tok/s (prefill/decode split preserved).

    Pass a ``substrate`` to bill the design points the substrate object
    carries - its base ``design`` plus any per-site overrides (the
    first-class path: no flag plumbing between the engine and the bill).
    Passing a bare ``design`` is the legacy uniform-design rollup.
    """
    sites = meter.sites
    if substrate is not None:
        if design is not None:
            raise ValueError("pass either design= or substrate=, not both")
        design = substrate.design
        if design is None:
            raise ValueError(
                f"substrate {substrate.name!r} carries no design point to "
                "bill; attach one with with_design()")
        pre = substrate_energy_for_tokens(sites, substrate,
                                          meter.prefill_billed_tokens)
        dec = substrate_energy_for_tokens(sites, substrate,
                                          meter.decode_billed_tokens)
        sav = substrate_energy_for_tokens(sites, substrate,
                                          meter.prefix_saved_billed_tokens)
    elif design is None:
        raise ValueError("need a design point or a substrate to bill")
    else:
        pre = energy_for_tokens(sites, design, meter.prefill_billed_tokens)
        dec = energy_for_tokens(sites, design, meter.decode_billed_tokens)
        sav = energy_for_tokens(sites, design,
                                meter.prefix_saved_billed_tokens)
    if generated_tokens is None:
        # best available proxy: every billed decode token is delivered, plus
        # one first token per prefill row
        generated_tokens = meter.decode_billed_tokens + meter.prefill_rows
    if requests is None:
        requests = meter.prefill_rows
    return EnergyReport(
        design=design,
        prefill_tokens=meter.prefill_billed_tokens,
        decode_tokens=meter.decode_billed_tokens,
        generated_tokens=generated_tokens,
        requests=requests,
        prefill_j=pre["energy_j"],
        decode_j=dec["energy_j"],
        delay_per_token_s=dec["delay_per_token_s"],
        substrate=substrate,
        drift=meter.drift_summary(),
        saved_prefill_j=sav["energy_j"],
    )


# ---------------------------------------------------------------------------
# SLO rollup: per-request timing -> p50/p99 TTFT & inter-token latency,
# deadline misses and goodput (virtual-clock serve loops; deterministic)
# ---------------------------------------------------------------------------


def percentile(values: Sequence[float], p: float) -> float:
    """Nearest-rank percentile (deterministic, no interpolation): the
    smallest element >= p percent of the sample.  NaN on empty input."""
    if not values:
        return float("nan")
    xs = sorted(values)
    rank = max(1, math.ceil(p / 100.0 * len(xs)))
    return float(xs[rank - 1])


def request_ttft(req) -> Optional[float]:
    """Arrival -> first token (falls back to submit time when the request
    carries no arrival timestamp)."""
    if req.t_first is None:
        return None
    start = req.arrive_at if req.arrive_at is not None else req.t_submit
    if start is None:
        return None
    return req.t_first - start


def request_itl_gaps(req) -> List[float]:
    """Gaps between consecutive generated tokens (virtual-clock runs only).
    Spans preemptions: a re-queued request's wait shows up as a large gap,
    which is exactly what its consumer would experience."""
    ts = req.token_times
    return [ts[i + 1] - ts[i] for i in range(len(ts) - 1)]


def slo_summary(requests, elapsed: float, policy: str = "",
                prefix_hits: int = 0, cow_copies: int = 0) -> dict:
    """Roll a finished SLO workload up to the scheduling scoreboard.

    A request MEETS its SLO iff it completed without error, its TTFT is
    within ``ttft_deadline`` and no inter-token gap exceeds
    ``itl_deadline`` (absent deadlines always pass).  ``goodput`` is
    SLO-met requests per virtual step and ``goodput_tokens`` their tokens
    per virtual step - the overload currency: shedding a hopeless request
    costs completed-count but buys goodput."""
    ttfts: List[float] = []
    gaps: List[float] = []
    completed = shed = errored = ttft_miss = itl_miss = slo_met = 0
    slo_tokens = 0
    preemptions = 0
    for r in requests:
        preemptions += r.preemptions
        if getattr(r, "shed", False):
            shed += 1
            continue
        if r.error is not None:
            errored += 1
            continue
        completed += 1
        ttft = request_ttft(r)
        if ttft is not None:
            ttfts.append(ttft)
        r_gaps = request_itl_gaps(r)
        gaps.extend(r_gaps)
        miss = False
        if r.ttft_deadline is not None and (ttft is None
                                            or ttft > r.ttft_deadline):
            ttft_miss += 1
            miss = True
        if r.itl_deadline is not None and any(g > r.itl_deadline
                                              for g in r_gaps):
            itl_miss += 1
            miss = True
        if not miss:
            slo_met += 1
            slo_tokens += len(r.out)
    if elapsed > 0:
        goodput = slo_met / elapsed
        goodput_tokens = slo_tokens / elapsed
    else:
        # empty / instantly-drained workload: a rate over zero elapsed time
        # is undefined - report 0.0 when nothing met its SLO and NaN when
        # something did (matching percentile() on empty input), instead of
        # the absurd ~1e9x inflation a clamped divisor produces
        goodput = 0.0 if slo_met == 0 else float("nan")
        goodput_tokens = 0.0 if slo_tokens == 0 else float("nan")
    return {
        "policy": policy,
        "requests": len(requests),
        "completed": completed,
        "shed": shed,
        "errored": errored,
        "ttft_miss": ttft_miss,
        "itl_miss": itl_miss,
        "slo_met": slo_met,
        "preemptions": preemptions,
        "elapsed_steps": round(elapsed, 3),
        "goodput": goodput,
        "goodput_tokens": goodput_tokens,
        "ttft_p50": percentile(ttfts, 50),
        "ttft_p99": percentile(ttfts, 99),
        "itl_p50": percentile(gaps, 50),
        "itl_p99": percentile(gaps, 99),
        # prefix-sharing under churn: hits that survived preemption pressure
        # and the CoW copies taken to keep shared blocks immutable
        "prefix_hits": prefix_hits,
        "cow_copies": cow_copies,
    }


def format_slo_summary(summary: dict) -> str:
    keys = ["requests", "completed", "shed", "errored", "ttft_miss",
            "itl_miss", "slo_met", "preemptions", "elapsed_steps",
            "goodput", "goodput_tokens", "ttft_p50", "ttft_p99", "itl_p50",
            "itl_p99", "prefix_hits", "cow_copies"]
    lines = []
    for k in keys:
        v = summary.get(k)
        lines.append(f"  {k:>16s} = "
                     + (f"{v:.4f}" if isinstance(v, float) else str(v)))
    for k, v in summary.items():
        if k in keys or k == "policy":
            continue
        lines.append(f"  {k:>16s} = "
                     + (f"{v:.4f}" if isinstance(v, float) else str(v)))
    return "\n".join(lines)


def format_report(reports: Sequence[EnergyReport]) -> str:
    """Human-readable table of one workload rolled up at several design
    points (one row per substrate/design point)."""
    hdr = (f"{'kind':>4s} {'N':>5s} {'banks':>5s} {'B_ADC':>5s} "
           f"{'SNR_T dB':>8s} {'J/token':>10s} {'J/request':>10s} "
           f"{'EDP/token':>10s} {'tok/s (compute)':>15s}")
    lines = [hdr]
    for r in reports:
        lines.append(
            f"{r.design.arch_kind:>4s} {r.design.n:>5d} "
            f"{r.design.n_banks:>5d} {r.design.b_adc:>5d} "
            f"{r.design.snr_t_db:>8.1f} {r.j_per_token:>10.3e} "
            f"{r.j_per_request:>10.3e} {r.edp_per_token:>10.3e} "
            f"{r.tok_s_compute:>15.3e}"
        )
    return "\n".join(lines)
