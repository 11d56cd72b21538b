"""Design-space exploration: turn the paper's SSVI design guidelines into a solver.

Given a DP dimension N, a target SNR_T, a technology node, and signal statistics,
find the minimum-energy IMC design point:

  * compute model / architecture: QS-Arch (knob: V_WL), QR-Arch (knob: C_o),
    CM (knobs: V_WL, B_w),
  * banking: if no feasible single-bank point exists at N (SNR_a caps out -
    paper SSVI bullet 4: "multi-bank IMCs will be required for high-dimensional
    DPs"), split the DP across n_banks banks of N/n_banks rows each and reduce
    digitally; the analog SNR improves (smaller N per bank) at digital cost.
  * B_ADC: assigned by MPC (eq. 15) - never BGC.

The solver reproduces the paper's qualitative guideline "QS-based architectures
are preferred at low compute SNR, QR-based at high compute SNR" (tests assert it).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Iterable, List, Optional

import numpy as np

from repro_torch.core import precision as prec
from repro_torch.core.archs import (
    CMArch,
    IMCArch,
    QRArch,
    QSArch,
    binomial_clip_second_moment,
    sigma_qiy_sq,
)
from repro_torch.core.compute_models import TECH_65NM, TechParams
from repro_torch.core.quant import QuantSpec, SignalStats, UNIFORM_STATS

# digital reduction-tree latency per level (banked composition and
# cross-tile workload rollups share it: one calibration site)
T_REDUCE_LEVEL = 1e-10  # s

V_WL_GRID = tuple(np.round(np.arange(0.50, 0.86, 0.025), 3))
C_O_GRID = tuple(float(c) * 1e-15 for c in (0.5, 1, 1.5, 2, 3, 4.5, 6, 9, 12, 16))
BANK_SPLITS = (1, 2, 4, 8, 16, 32)


@dataclasses.dataclass(frozen=True)
class DesignPoint:
    """A fully-specified IMC design for one dot-product shape."""

    arch_kind: str  # "qs" | "qr" | "cm"
    n: int  # total DP dimension
    n_bank: int  # rows per bank
    n_banks: int  # digital reduction fan-in
    bx: int
    bw: int
    b_adc: int
    knob: float  # V_WL (qs/cm) or C_o (qr)
    tech: str
    # predicted metrics
    snr_a_db: float
    snr_A_db: float
    snr_t_db: float
    energy_per_dp: float  # J (analog + ADC + digital reduction)
    delay_per_dp: float  # s
    edp: float

    def arch(self, stats: SignalStats = UNIFORM_STATS) -> IMCArch:
        from repro_torch.core import scaling

        tech = scaling.node(self.tech)
        if self.arch_kind == "qs":
            return QSArch(n=self.n_bank, bx=self.bx, bw=self.bw, stats=stats,
                          tech=tech, v_wl=self.knob)
        if self.arch_kind == "qr":
            return QRArch(n=self.n_bank, bx=self.bx, bw=self.bw, stats=stats,
                          tech=tech, c_o=self.knob)
        return CMArch(n=self.n_bank, bx=self.bx, bw=self.bw, stats=stats,
                      tech=tech, v_wl=self.knob)


def _mk_arch(kind: str, n_bank: int, bx: int, bw: int, stats, tech, knob) -> IMCArch:
    if kind == "qs":
        return QSArch(n=n_bank, bx=bx, bw=bw, stats=stats, tech=tech, v_wl=knob)
    if kind == "qr":
        return QRArch(n=n_bank, bx=bx, bw=bw, stats=stats, tech=tech, c_o=knob)
    if kind == "cm":
        return CMArch(n=n_bank, bx=bx, bw=bw, stats=stats, tech=tech, v_wl=knob)
    raise ValueError(kind)


def _bank_reduction_energy(n_banks: int, width_bits: int, tech: TechParams) -> float:
    """Digital adder-tree energy for combining n_banks partial DPs."""
    return max(n_banks - 1, 0) * width_bits * tech.e_add_per_bit


def evaluate_point(
    kind: str,
    n: int,
    n_banks: int,
    bx: int,
    bw: int,
    stats: SignalStats,
    tech: TechParams,
    knob: float,
    snr_t_target_db: float,
    gamma_db: float = 0.5,
    max_rows: int = 512,
) -> Optional[DesignPoint]:
    """Returns a DesignPoint if the configuration meets the SNR target, else None."""
    n_bank = int(math.ceil(n / n_banks))
    if n_bank > max_rows or n_bank < 2:
        return None
    arch = _mk_arch(kind, n_bank, bx, bw, stats, tech, knob)

    # banked composition: per-bank DP variance is sigma_yo^2/n_banks-ish; bank
    # noises are independent => bank SNRs compose as the same SNR (both signal
    # and noise scale with n_bank). SNR_a(total) = SNR_a(bank).
    snr_a_db = arch.snr_a_db()
    snr_A_db = arch.snr_A_db()
    b_adc = arch.b_adc_min(gamma_db)
    snr_t_db = arch.snr_T_db(b_adc)
    if not math.isfinite(snr_t_db) or snr_t_db < snr_t_target_db:
        return None

    e_bank = arch.energy_per_dp(b_adc)
    width = b_adc + int(math.ceil(math.log2(max(n_banks, 2))))
    energy = n_banks * e_bank + _bank_reduction_energy(n_banks, width, tech)
    # banks operate in parallel; reduction adds one tree of log2(n_banks) adds
    delay = arch.delay_per_dp(b_adc) \
        + math.ceil(math.log2(max(n_banks, 1)) or 0) * T_REDUCE_LEVEL
    return DesignPoint(
        arch_kind=kind,
        n=n,
        n_bank=n_bank,
        n_banks=n_banks,
        bx=bx,
        bw=bw,
        b_adc=b_adc,
        knob=knob,
        tech=tech.name,
        snr_a_db=snr_a_db,
        snr_A_db=snr_A_db,
        snr_t_db=snr_t_db,
        energy_per_dp=energy,
        delay_per_dp=delay,
        edp=energy * delay,
    )


def with_b_adc(pt: DesignPoint, b_adc: int,
               stats: SignalStats = UNIFORM_STATS) -> DesignPoint:
    """The same analog design point re-assigned a different output-ADC
    precision (MPC-style per-site assignment, paper eq. 15): SNR_T, ADC
    energy and conversion delay move; the analog core (kind, knob, banking)
    stays.  Uses the same Table III closed forms as :func:`evaluate_point`,
    so ``with_b_adc(pt, pt.b_adc) == pt`` for any solver-produced point."""
    from repro_torch.core import scaling

    tech = scaling.node(pt.tech)
    arch = pt.arch(stats)
    e_bank = arch.energy_per_dp(b_adc)
    width = b_adc + int(math.ceil(math.log2(max(pt.n_banks, 2))))
    energy = pt.n_banks * e_bank \
        + _bank_reduction_energy(pt.n_banks, width, tech)
    delay = arch.delay_per_dp(b_adc) \
        + math.ceil(math.log2(max(pt.n_banks, 1)) or 0) * T_REDUCE_LEVEL
    return dataclasses.replace(
        pt,
        b_adc=b_adc,
        snr_t_db=arch.snr_T_db(b_adc),
        energy_per_dp=energy,
        delay_per_dp=delay,
        edp=energy * delay,
    )


def frontier_ladder(pt: DesignPoint, steps: int = 2, min_b_adc: int = 2,
                    stats: SignalStats = UNIFORM_STATS) -> List[DesignPoint]:
    """Design points stepping DOWN the EDAP frontier from ``pt`` by lowering
    the output-ADC precision one bit at a time (:func:`with_b_adc`): each
    step trades SNR_T for lower energy AND delay per DP while the analog
    core (kind, knob, banking) stays put.  Index 0 is ``pt`` itself; the
    list is the load-shedding-by-accuracy axis the serve engine's
    ``PressureController`` walks under overload (the workload-matched ADC
    precision argument of arxiv 2507.09776 / 2408.06390)."""
    if steps < 0:
        raise ValueError("steps must be >= 0")
    ladder = [pt]
    b = pt.b_adc
    for _ in range(steps):
        b -= 1
        if b < min_b_adc:
            break
        ladder.append(with_b_adc(pt, b, stats))
    return ladder


# ---------------------------------------------------------------------------
# vectorized grid evaluation: all (knob, n_banks) points per kind in one
# numpy batch (same Table III math as evaluate_point; verified by tests)
# ---------------------------------------------------------------------------

_v_clip_stats = np.vectorize(prec.gaussian_clip_stats, otypes=[float, float])
_v_binom2 = np.vectorize(
    lambda nn, kk: binomial_clip_second_moment(int(nn), float(kk)),
    otypes=[float],
)


def _db_arr(x):
    return 10.0 * np.log10(np.maximum(x, 1e-300))


@functools.lru_cache(maxsize=256)
def _grid_metrics(kind: str, n: int, bx: int, bw: int, stats: SignalStats,
                  tech: TechParams, max_rows: int, gamma_db: float):
    """Table III metrics over the full (knob x n_banks) grid, as numpy arrays
    of shape (len(knobs), len(BANK_SPLITS)).  Row-major flat order matches the
    legacy scalar loop (knob outer, banking inner), so argmin tie-breaking is
    unchanged.  Cached: pareto_sweep re-uses the batch across SNR targets."""
    knobs = np.asarray(C_O_GRID if kind == "qr" else V_WL_GRID)[:, None]
    banks = np.asarray(BANK_SPLITS)[None, :]
    n_bank = np.ceil(n / banks).astype(int)
    valid = (n_bank <= max_rows) & (n_bank >= 2)
    n_bank = np.maximum(n_bank, 2)  # placeholder rows stay masked via `valid`

    dx = QuantSpec(bx, signed=False, max_val=stats.x_max).delta
    dw = QuantSpec(bw, signed=True, max_val=stats.w_max).delta
    sigma_yo_sq = n_bank * stats.var_w * stats.e_x2
    sigma_qiy = n_bank * sigma_qiy_sq(1, bx, bw, stats)  # linear in N

    if kind == "qs" or kind == "cm":
        t_pulse = tech.t0 if kind == "cm" else tech.t_pulse
        ov = np.maximum(knobs - tech.v_t, 1e-9)
        cell_i = tech.w_over_l * tech.k_prime * ov**tech.alpha
        sigma_d = tech.alpha * tech.sigma_vt / ov
        t_rf = tech.t_rise - ((knobs - tech.v_t) / knobs) * (
            (tech.t_rise + tech.t_fall) / (tech.alpha + 1.0)
        )
        t_eff = np.maximum(t_pulse - t_rf, 1e-12)
        dv_unit = cell_i * t_eff / tech.c_bl
        k_h = tech.dv_bl_max / dv_unit

    if kind == "qs":
        pws = (4.0 / 9.0) * (1 - 4.0**-bw) * (1 - 4.0**-bx)
        eta_h = pws * _v_binom2(n_bank + 0 * k_h, k_h + 0.0 * n_bank)
        eta_e = pws * n_bank * sigma_d**2 / 4.0
        v_c_counts = np.minimum(
            np.minimum(n_bank / 4.0 + np.sqrt(3.0 * n_bank), k_h), n_bank
        )
        v_c_norm = v_c_counts * dx * dw * (2.0**bx - 1) * (2.0**bw - 1) / 4.0
        adc_ratio = tech.v_dd / np.maximum(v_c_counts * dv_unit, 1e-6)
        conversions = bx * bw
        analog = bx * bw * (
            np.minimum(n_bank / 4.0, k_h) * dv_unit * tech.v_dd * tech.c_bl
            + n_bank * tech.e_switch
        )
    elif kind == "qr":
        c_o = knobs
        sigma_c_rel = tech.pelgrom_kappa / np.sqrt(c_o)
        sigma_th = np.sqrt(1.380649e-23 * tech.temp / c_o)
        sigma_inj_sq = (tech.inj_p * tech.wl_cox / c_o) ** 2
        per_cell = (
            stats.e_x2 * sigma_c_rel**2
            + 2.0 * (sigma_th / tech.v_dd) ** 2
            + sigma_inj_sq * stats.var_x
        )
        eta_h = np.zeros_like(per_cell + 0.0 * n_bank)
        eta_e = (2.0 / 3.0) * (1 - 4.0**-bw) * n_bank * per_cell
        v_c_volts = (
            2.0 * tech.v_dd
            * np.sqrt((stats.e_x2 + stats.var_x) / (stats.x_max**2 * n_bank))
        ) + 0.0 * c_o
        v_c_norm = 4.0 * np.sqrt(sigma_yo_sq) + 0.0 * c_o
        adc_ratio = tech.v_dd / np.maximum(v_c_volts, 1e-6)
        conversions = bw
        e_qr = n_bank * ((1.0 - stats.mu_x) * tech.v_dd) * tech.v_dd * c_o \
            + n_bank * tech.e_switch
        e_mult = stats.mu_x * 0.5 * c_o * tech.v_dd**2
        analog = bw * (e_qr + n_bank * e_mult)
    elif kind == "cm":
        t = np.maximum(1.0 - 2.0 * k_h * 2.0**-bw, 0.0)
        eta_h = (
            (1.0 / 12.0) * n_bank * stats.e_x2 * stats.var_w
            * k_h**-2 * 2.0 ** (2 * bw) * t * t
        )
        eta_e = (
            (2.0 / 3.0) * n_bank * stats.e_x2
            * (0.25 - 4.0**-bw) * sigma_d**2
        )
        sigma_y = np.sqrt(n_bank * stats.var_w * stats.e_x2)
        v_c_volts = 4.0 * 2.0 ** (bw - 1) * dv_unit * sigma_y / n_bank
        v_c_norm = 4.0 * np.sqrt(sigma_yo_sq) + 0.0 * k_h
        adc_ratio = tech.v_dd / np.maximum(v_c_volts, 1e-6)
        conversions = 1
        mean_counts = np.minimum(0.5 * (2.0**bw - 1), k_h * 2)
        mean_v = np.minimum(mean_counts * dv_unit, tech.dv_bl_max)
        e_qs_col = mean_v * tech.v_dd * tech.c_bl / n_bank + tech.e_switch
        qr_co = 3e-15
        e_qr = n_bank * ((1.0 - stats.mu_x) * tech.v_dd) * tech.v_dd * qr_co \
            + n_bank * tech.e_switch
        e_mult = stats.mu_x * 0.5 * qr_co * tech.v_dd**2
        analog = 2 * n_bank * e_qs_col + e_qr + n_bank * e_mult
    else:
        raise ValueError(kind)

    # -- SNR composition (eqs. 10, 11, 14, 15) --
    snr_a = sigma_yo_sq / np.maximum(eta_h + eta_e, 1e-300)
    snr_a_db = _db_arr(snr_a)
    snr_A = 1.0 / (1.0 / snr_a + sigma_qiy / sigma_yo_sq)
    snr_A_db = _db_arr(snr_A)
    mpc = np.ceil(
        (snr_A_db + 7.2 - gamma_db
         - 10.0 * math.log10(1.0 - 10.0 ** (-gamma_db / 10.0))) / 6.0
    )
    if kind == "qs":
        b_adc = np.ceil(np.minimum(
            np.minimum(mpc, np.log2(np.maximum(k_h, 2.0)) + 0.0 * n_bank),
            np.log2(n_bank),
        )).astype(int)
    elif kind == "qr":
        b_adc = np.ceil(np.minimum(mpc, bx + np.log2(n_bank))).astype(int)
    else:
        b_adc = mpc.astype(int)

    zeta = v_c_norm / np.maximum(np.sqrt(sigma_yo_sq), 1e-300)
    q_var = (2.0 * v_c_norm * 2.0**-b_adc.astype(float)) ** 2 / 12.0
    p_c, scc = _v_clip_stats(zeta)
    sigma_qy = q_var + p_c * scc * sigma_yo_sq
    snr_t = 1.0 / (1.0 / snr_A + sigma_qy / sigma_yo_sq)
    snr_t_db = _db_arr(snr_t)

    # -- energy & delay (eqs. 21, 25, 26 + banked composition) --
    r = np.maximum(adc_ratio, 1.0)
    e_adc = 100e-15 * (b_adc + np.log2(r)) + 1e-18 * r * r * 4.0**b_adc
    e_bank = analog + conversions * e_adc \
        + conversions * b_adc * tech.e_add_per_bit
    width = b_adc + np.ceil(np.log2(np.maximum(banks, 2))).astype(int)
    energy = banks * e_bank \
        + np.maximum(banks - 1, 0) * width * tech.e_add_per_bit
    if kind == "qs":
        delay_bank = bx * (tech.t_pulse + tech.t_setup
                           + b_adc * tech.t_adc_per_bit)
    elif kind == "qr":
        delay_bank = 2 * tech.t0 + tech.t_setup + b_adc * tech.t_adc_per_bit
    else:
        delay_bank = (2.0 ** (bw - 1) * tech.t0 + tech.t_setup
                      + 2 * tech.t0 + tech.t_setup
                      + b_adc * tech.t_adc_per_bit)
    delay = delay_bank + np.ceil(np.log2(np.maximum(banks, 1))) * T_REDUCE_LEVEL
    energy = np.broadcast_to(energy + 0.0 * snr_t_db, snr_t_db.shape)
    delay = np.broadcast_to(delay + 0.0 * snr_t_db, snr_t_db.shape)
    return {
        "knobs": np.asarray(C_O_GRID if kind == "qr" else V_WL_GRID),
        "banks": np.asarray(BANK_SPLITS),
        "valid": np.broadcast_to(valid, snr_t_db.shape),
        "snr_t_db": snr_t_db,
        "energy": energy,
        "delay": delay,
        "edp": energy * delay,
    }


def optimize(
    n: int,
    snr_t_target_db: float,
    stats: SignalStats = UNIFORM_STATS,
    tech: TechParams = TECH_65NM,
    kinds: Iterable[str] = ("qs", "qr", "cm"),
    bx: Optional[int] = None,
    bw: Optional[int] = None,
    objective: str = "energy",  # "energy" | "edp" | "delay"
    max_rows: int = 512,
) -> Optional[DesignPoint]:
    """Grid search over (kind x knob x banking), min-objective subject to
    SNR_T >= target.  B_x/B_w default to the SSIII-B assignment for the target.

    The whole (knob, n_banks) grid per kind is evaluated as one vectorized
    numpy batch (:func:`_grid_metrics`); only the winning cell goes through
    the scalar :func:`evaluate_point` to build the exact DesignPoint."""
    if bx is None or bw is None:
        pa = prec.assign_precisions(snr_t_target_db + 3.0, n, stats)
        bx = bx or pa.bx
        bw = bw or pa.bw

    obj_key = {"energy": "energy", "edp": "edp", "delay": "delay"}[objective]
    best: Optional[DesignPoint] = None
    for kind in kinds:
        g = _grid_metrics(kind, n, bx, bw, stats, tech, max_rows, 0.5)
        feasible = (
            g["valid"]
            & np.isfinite(g["snr_t_db"])
            & (g["snr_t_db"] >= snr_t_target_db)
        )
        if not feasible.any():
            continue
        obj = np.where(feasible, g[obj_key], np.inf)
        # ascending objective; stable sort keeps the legacy scalar-loop
        # tie-break (knob outer, banking inner, first strict improvement)
        for flat in np.argsort(obj, axis=None, kind="stable"):
            if not feasible.flat[flat]:
                break
            ki, bi = np.unravel_index(flat, obj.shape)
            pt = evaluate_point(
                kind, n, int(g["banks"][bi]), bx, bw, stats, tech,
                float(g["knobs"][ki]), snr_t_target_db, max_rows=max_rows,
            )
            if pt is not None:
                key = {"energy": pt.energy_per_dp, "edp": pt.edp,
                       "delay": pt.delay_per_dp}[objective]
                best_key = None if best is None else {
                    "energy": best.energy_per_dp, "edp": best.edp,
                    "delay": best.delay_per_dp}[objective]
                if best is None or key < best_key:
                    best = pt
                break
    return best


# ---------------------------------------------------------------------------
# workload-level rollup: one token-forward of a model costed at a design point
# ---------------------------------------------------------------------------


def workload_metrics(pt: DesignPoint, sites) -> dict:
    """Energy/delay of ONE token-forward over ``sites`` at design point ``pt``.

    ``sites`` is an iterable of ``(k, m, calls)`` matmul-site triples (see
    :func:`repro_torch.core.mapping.per_token_matmul_shapes`): each call evaluates
    ``m`` output dot products of dimension ``k``.  A site whose DP dimension
    exceeds the design point's ``pt.n`` is tiled onto ``ceil(k / pt.n)``
    bank-row groups (the ``core.mapping`` bank tiling) whose partials reduce
    digitally, exactly like the in-design banking of ``evaluate_point``.
    Banks are column- and tile-parallel, so per-call delay is one DP
    conversion; sites within a token-forward are sequential (layer order).
    """
    from repro_torch.core import scaling

    tech = scaling.node(pt.tech)
    energy = 0.0
    delay = 0.0
    for k, m, calls in sites:
        tiles = int(math.ceil(k / pt.n))
        width = pt.b_adc + int(math.ceil(math.log2(max(tiles * pt.n_banks, 2))))
        e_dp = tiles * pt.energy_per_dp + _bank_reduction_energy(tiles, width, tech)
        energy += calls * m * e_dp
        delay += calls * (pt.delay_per_dp
                          + math.ceil(math.log2(max(tiles, 1))) * T_REDUCE_LEVEL)
    return {
        "energy_per_token_j": energy,
        "delay_per_token_s": delay,
        "edp_per_token": energy * delay,
    }


def pareto_sweep(
    n: int,
    stats: SignalStats = UNIFORM_STATS,
    tech: TechParams = TECH_65NM,
    kinds: Iterable[str] = ("qs", "qr", "cm"),
    targets_db: Iterable[float] = tuple(range(8, 44, 2)),
    workload=None,
):
    """Energy-vs-SNR_T pareto frontier (the Fig. 13-style trade-off curve).

    With ``workload=`` (an iterable of ``(k, m, calls)`` matmul-site triples,
    e.g. from a :class:`repro_torch.launch.metering.DPMeter`), each SNR target
    re-ranks the per-kind optima by SERVE-WORKLOAD EDP per token-forward
    (:func:`workload_metrics`) instead of per-DP energy - the rollup the
    paper's "QS at low / QR at high compute SNR" guideline is stated over.
    """
    out = []
    for t in targets_db:
        if workload is None:
            pt = optimize(n, t, stats=stats, tech=tech, kinds=kinds)
            if pt is not None:
                out.append((t, pt))
            continue
        best = None
        best_edp = math.inf
        for kind in kinds:
            pt = optimize(n, t, stats=stats, tech=tech, kinds=(kind,))
            if pt is None:
                continue
            edp = workload_metrics(pt, workload)["edp_per_token"]
            if edp < best_edp:
                best, best_edp = pt, edp
        if best is not None:
            out.append((t, best))
    return out
