"""Online calibration: drift detection and recalibration for frozen
substrates (the port of ``repro.runtime.drift``, plain host Python).

A ``frozen`` substrate (``core.substrate``) makes IMC serving
batch-composition-invariant by fixing quantizer ranges captured once from a
reference batch.  Under live traffic the activation statistics drift: when
``|x|`` grows past the frozen ``x_max`` the activation quantizer clips, and
per-site SNR_T silently degrades.  This module closes the loop:

  shadow observation   the serve engine runs ``CalibrationRecorder``'s
                       running-maxima capture on a sampled fraction of live
                       chunks (``core.substrate.shadow_recording``: passive,
                       outputs untouched; the maxima stay on the device until
                       a check reads them);
  drift detection      :func:`detect_drift` is a ONE-SIDED test per site:
                       stats are running maxima, so ``observed <= frozen``
                       never flags; an excess is scored by relative range
                       excess and by a clip-rate proxy (Gaussian tail mass
                       past the frozen range at the site's assumed PAR);
  refresh              :func:`refreshed_calibration` max-merges the frozen
                       and observed stats, PRESERVING the frozen site-name
                       set, so ``Engine.swap_calibration`` accepts it;
  recovery accounting  :func:`effective_snr_t_db` is the analytic SNR_T proxy
                       of a B_x-bit quantizer whose full-scale range mismatches
                       the live traffic (quantization noise + clip noise from
                       ``core.precision.gaussian_clip_stats``).

:class:`DriftMonitor` packages the recorder, cadence and thresholds for the
engine: sample every Nth chunk, check every Nth sample, auto-swap on a
drifted report.  Detection latency is therefore bounded by
``sample_every * check_every`` chunks of the drift onset.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

from repro_torch.core.precision import gaussian_clip_stats
from repro_torch.core.substrate import (
    DEFAULT_SITE,
    _STAT_FIELDS,
    Calibration,
    CalibrationRecorder,
    SiteStats,
)

# ---------------------------------------------------------------------------
# detection
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DriftThresholds:
    """Per-site drift thresholds (both tests strictly greater-than: a site
    sitting exactly at a threshold has not drifted).

    ``rel_excess``: observed/frozen - 1 past which a stat field counts as
    drifted (5% default - comfortably above shadow-sampling jitter).
    ``clip_rate``: estimated probability mass the frozen activation range
    clips off the observed traffic, past which ``x_max`` drift is flagged
    even under ``rel_excess`` (a heavy-tailed shift can hurt SNR_T before
    the 5% range excess trips).
    """

    rel_excess: float = 0.05
    clip_rate: float = 1e-3


@dataclasses.dataclass(frozen=True)
class SiteDrift:
    """One (site, stat-field) comparison of observed traffic vs the frozen
    range.  ``rel_excess`` is one-sided (clamped at 0: frozen ranges are
    running maxima, so an observation below the range carries no evidence)."""

    site: str
    field: str
    frozen: float
    observed: float
    rel_excess: float
    clip_rate: float  # estimated clip probability (x_max entries; else 0)
    drifted: bool

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class DriftReport:
    """Structured result of one drift check (surfaced through
    ``launch.metering``)."""

    entries: Tuple[SiteDrift, ...]
    checked_sites: int

    @property
    def drifted(self) -> bool:
        return any(e.drifted for e in self.entries)

    @property
    def drifted_sites(self) -> Tuple[str, ...]:
        return tuple(sorted({e.site for e in self.entries if e.drifted}))

    def worst(self) -> Optional[SiteDrift]:
        """The entry with the largest relative excess (None if no entries)."""
        if not self.entries:
            return None
        return max(self.entries, key=lambda e: e.rel_excess)

    def to_dict(self) -> dict:
        worst = self.worst()
        return {
            "drifted": self.drifted,
            "checked_sites": self.checked_sites,
            "drifted_sites": list(self.drifted_sites),
            "max_rel_excess": worst.rel_excess if worst else 0.0,
            "max_clip_rate": max((e.clip_rate for e in self.entries),
                                 default=0.0),
            "entries": [e.to_dict() for e in self.entries if e.drifted],
        }

    def summary_line(self) -> str:
        if not self.drifted:
            return (f"no drift across {self.checked_sites} sites "
                    f"(max rel excess "
                    f"{self.worst().rel_excess if self.entries else 0.0:.3f})")
        w = self.worst()
        return (f"DRIFT at {len(self.drifted_sites)}/{self.checked_sites} "
                f"sites {list(self.drifted_sites)}: worst {w.site}.{w.field} "
                f"observed {w.observed:.4g} vs frozen {w.frozen:.4g} "
                f"(+{100 * w.rel_excess:.1f}%, clip~{w.clip_rate:.2e})")


def estimated_clip_rate(frozen_max: float, observed_max: float,
                        par: float = 4.0) -> float:
    """Probability mass a quantizer clipping at ``frozen_max`` cuts off the
    observed traffic, modelling the operand as Gaussian with
    ``sigma = observed_max / par`` (the substrate's PAR assumption).  The
    effective clip factor is ``zeta = par * frozen_max / observed_max``; the
    tail mass is ``p_c = 2 Q(zeta)`` (``core.precision.gaussian_clip_stats``).
    Monotone one-sided: observed <= frozen gives zeta >= par ~ 4 and a
    negligible rate."""
    if observed_max <= 0.0 or frozen_max <= 0.0:
        return 0.0
    zeta = par * frozen_max / observed_max
    p_c, _ = gaussian_clip_stats(zeta)
    return float(p_c)


def detect_drift(frozen: Calibration, observed: Calibration,
                 thresholds: DriftThresholds = DriftThresholds(),
                 par_x: float = 4.0) -> DriftReport:
    """One-sided per-site drift test of ``observed`` shadow stats against the
    ``frozen`` calibration.

    Superset monotonicity makes this sound: frozen stats are running maxima,
    so any genuine distribution shift that matters to the quantizers shows up
    as ``observed > frozen`` on some field; ``observed <= frozen`` is always
    consistent with the calibrated distribution and never flags.  Each
    observed site is compared against the stats the frozen engine actually
    uses for it (exact entry or the ``"*"`` fallback).  The aggregate
    ``"*"`` entry itself is skipped: it merges every site and would only
    duplicate the per-site verdicts.
    """
    entries: List[SiteDrift] = []
    checked = 0
    for name, obs in observed.sites:
        if name == DEFAULT_SITE:
            continue
        frz = frozen.get(name)
        if frz is None:
            continue
        checked += 1
        for field in _STAT_FIELDS:
            f_val = float(getattr(frz, field))
            o_val = float(getattr(obs, field))
            rel = max(0.0, o_val / f_val - 1.0) if f_val > 0 else (
                float("inf") if o_val > 0 else 0.0)
            clip = (estimated_clip_rate(f_val, o_val, par_x)
                    if field == "x_max" else 0.0)
            drifted = (rel > thresholds.rel_excess
                       or clip > thresholds.clip_rate)
            entries.append(SiteDrift(site=name, field=field, frozen=f_val,
                                     observed=o_val, rel_excess=rel,
                                     clip_rate=clip, drifted=drifted))
    return DriftReport(entries=tuple(entries), checked_sites=checked)


# ---------------------------------------------------------------------------
# refresh: the hot-swappable calibration
# ---------------------------------------------------------------------------


def refreshed_calibration(frozen: Calibration,
                          observed: Calibration) -> Calibration:
    """Max-merge ``observed`` shadow stats into ``frozen``, PRESERVING the
    frozen site-name set (the engine's hot-swap refuses any other).
    Observed sites the frozen calibration does not name are folded into its
    ``"*"`` fallback entry (the entry the frozen engine serves them from).
    Monotone: no refreshed range is ever below its frozen value.
    """
    names = set(frozen.site_names())
    merged: Dict[str, SiteStats] = dict(frozen.sites)
    extra: Optional[SiteStats] = None
    for name, st in observed.sites:
        if name in names:
            merged[name] = merged[name].merge(st)
        elif name != DEFAULT_SITE:
            extra = st if extra is None else extra.merge(st)
    if extra is not None and DEFAULT_SITE in merged:
        merged[DEFAULT_SITE] = merged[DEFAULT_SITE].merge(extra)
    return Calibration(tuple(merged.items()))


# ---------------------------------------------------------------------------
# analytic per-site SNR_T proxy (degradation / recovery accounting)
# ---------------------------------------------------------------------------


def effective_snr_t_db(range_max: float, observed_max: float, bx: int,
                       par: float = 4.0) -> float:
    """SNR_T of a signed ``bx``-bit quantizer with full-scale ``range_max``
    against traffic whose observed max-|x| is ``observed_max`` (Gaussian at
    the PAR assumption, ``sigma = observed_max / par``).

    Two regimes, both priced (paper eq. 8 + the MPC clip analysis):
    quantization noise ``Delta^2/12`` with ``Delta = range_max * 2^(1-bx)``
    grows when the range over-provisions (range >> traffic), and clip noise
    ``p_c * sigma_cc^2`` (``gaussian_clip_stats``) takes over when the range
    under-provisions (drifted traffic) - so a drifted site's SNR_T drops and
    a freshly-matched range (``range_max == observed_max``) is the
    reference the hot-swap recovery is measured against.
    """
    if observed_max <= 0.0 or range_max <= 0.0:
        return float("-inf")
    sigma = observed_max / par
    zeta = range_max / sigma
    delta = range_max * 2.0 ** (1 - bx)
    q_noise = delta * delta / 12.0
    p_c, scc = gaussian_clip_stats(zeta)
    clip_noise = float(p_c) * float(scc) * sigma * sigma
    return 10.0 * math.log10(sigma * sigma / (q_noise + clip_noise))


def site_snr_table(frozen: Calibration, refreshed: Calibration,
                   observed: Calibration, bx: int,
                   par_x: float = 4.0) -> List[dict]:
    """Per-site SNR_T accounting rows: the stale frozen range vs the
    refreshed (post-swap) range vs a fresh-frozen reference whose range
    exactly matches the observed traffic."""
    rows = []
    for name, obs in observed.sites:
        if name == DEFAULT_SITE:
            continue
        frz = frozen.get(name)
        if frz is None:
            continue
        ref = refreshed.get(name)
        fresh = effective_snr_t_db(obs.x_max, obs.x_max, bx, par_x)
        stale = effective_snr_t_db(frz.x_max, obs.x_max, bx, par_x)
        after = effective_snr_t_db(ref.x_max, obs.x_max, bx, par_x)
        rows.append({
            "site": name,
            "x_max_frozen": float(frz.x_max),
            "x_max_observed": float(obs.x_max),
            "snr_t_stale_db": stale,
            "snr_t_refreshed_db": after,
            "snr_t_fresh_db": fresh,
            "recovery_gap_db": fresh - after,
            "degradation_db": fresh - stale,
        })
    return rows


def format_snr_table(rows: List[dict]) -> str:
    hdr = (f"{'site':>10s} {'x_max frz':>10s} {'x_max obs':>10s} "
           f"{'SNR_T stale':>11s} {'SNR_T swap':>11s} {'SNR_T fresh':>11s} "
           f"{'gap dB':>7s}")
    lines = [hdr]
    for r in rows:
        lines.append(
            f"{r['site']:>10s} {r['x_max_frozen']:>10.4g} "
            f"{r['x_max_observed']:>10.4g} {r['snr_t_stale_db']:>11.2f} "
            f"{r['snr_t_refreshed_db']:>11.2f} {r['snr_t_fresh_db']:>11.2f} "
            f"{r['recovery_gap_db']:>7.3f}")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# the monitor the serve engine drives
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DriftConfig:
    """Cadence + policy of online drift monitoring.

    ``sample_every``: shadow-record every Nth decode chunk / prefill group
    (1 = every chunk).  ``check_every``: run the detector every Nth shadow
    sample.  Detection latency of a drift onset is therefore bounded by
    ``sample_every * check_every`` chunks.  ``auto_swap``: hot-swap the
    refreshed calibration at the next chunk boundary when a check drifts.
    """

    sample_every: int = 4
    check_every: int = 2
    thresholds: DriftThresholds = DriftThresholds()
    auto_swap: bool = True
    par_x: float = 4.0

    def __post_init__(self):
        if self.sample_every < 1 or self.check_every < 1:
            raise ValueError("sample_every and check_every must be >= 1")


class DriftMonitor:
    """Shadow recorder + drift bookkeeping for one serve engine.

    The engine asks :meth:`take_sample` before each decode chunk (and prefill
    group) and runs the sampled call under
    ``core.substrate.shadow_recording(monitor.recorder)``; after a sampled
    chunk it calls :meth:`check`.  The recorder lives as long as the monitor
    and accumulates every sampled observation.
    """

    def __init__(self, cfg: DriftConfig = DriftConfig()):
        self.cfg = cfg
        self.recorder = CalibrationRecorder()
        self.chunks_seen = 0
        self.prefills_seen = 0
        self.samples = 0
        self.checks = 0
        self.drift_events = 0
        self.swaps = 0
        self.last_report: Optional[DriftReport] = None
        self.last_observed: Optional[Calibration] = None
        self.first_drift_chunk: Optional[int] = None

    # -- cadence --------------------------------------------------------------
    def take_sample(self) -> bool:
        """True if the upcoming decode chunk should be shadow-recorded."""
        take = self.chunks_seen % self.cfg.sample_every == 0
        self.chunks_seen += 1
        return take

    def take_prefill_sample(self) -> bool:
        """True if the upcoming prefill group should be shadow-recorded."""
        take = self.prefills_seen % self.cfg.sample_every == 0
        self.prefills_seen += 1
        return take

    # -- detection ------------------------------------------------------------
    def check(self, frozen: Calibration) -> Optional[DriftReport]:
        """Account one shadow sample; every ``check_every`` samples read the
        recorder's device maxima (the only host syncs of shadow recording)
        and run the detector.  Returns the report when a check ran, else
        None."""
        self.samples += 1
        if self.samples % self.cfg.check_every != 0:
            return None
        observed = self.recorder.finalize()
        if not observed.sites:
            return None
        self.checks += 1
        report = detect_drift(frozen, observed, self.cfg.thresholds,
                              par_x=self.cfg.par_x)
        self.last_report = report
        self.last_observed = observed
        if report.drifted:
            self.drift_events += 1
            if self.first_drift_chunk is None:
                self.first_drift_chunk = self.chunks_seen
        return report

    def refreshed(self, frozen: Calibration) -> Calibration:
        """The hot-swappable calibration: frozen max-merged with everything
        observed so far (site names preserved).  After a swap the observed
        stats are by construction <= the new frozen stats, so stale
        accumulator state cannot re-flag the same drift."""
        return refreshed_calibration(frozen, self.recorder.finalize())

    def note_swap(self):
        self.swaps += 1

    def counters(self) -> dict:
        return {
            "chunks_seen": self.chunks_seen,
            "shadow_samples": self.samples,
            "drift_checks": self.checks,
            "drift_events": self.drift_events,
            "calibration_swaps": self.swaps,
            "first_drift_chunk": self.first_drift_chunk,
        }
