"""One benchmark per paper table/figure.

Each ``fig*`` function regenerates the quantitative content of the paper's
figure from the port (closed-form curves + Monte Carlo overlays) and returns
rows of (name, value, derived) that ``run.py`` prints as CSV, under the
reference's row names, with the paper's anchors inline.  The MC overlays take
a ``torch.Generator`` (``gen``; by default ``mc.generator(0)``, on the card):
their values are draws of the port's stream, not of JAX's.
"""
from __future__ import annotations

import time
from typing import List, Tuple

import numpy as np

from repro_torch.core import mc, precision as prec, scaling
from repro_torch.core.archs import CMArch, QRArch, QSArch
from repro_torch.core.design import pareto_sweep
from repro_torch.core.quant import UNIFORM_STATS, sqnr_qiy_db_approx

Row = Tuple[str, float, str]


def _gen(gen):
    return mc.generator(0) if gen is None else gen


# ---------------------------------------------------------------------------
# Fig. 4: MPC vs BGC vs tBGC
# ---------------------------------------------------------------------------


def fig4_mpc_vs_bgc() -> List[Row]:
    rows: List[Row] = []
    stats = UNIFORM_STATS
    rows.append(("fig4/sqnr_qiy_7b_dB", float(sqnr_qiy_db_approx(7, 7, stats)),
                 "paper: 41 dB"))
    for n in (16, 64, 256, 1024):
        rows.append((f"fig4a/bgc_by_N{n}", prec.by_bgc(7, 7, n),
                     "B_y under BGC (16-20 over sweep)"))
        rows.append((
            f"fig4a/tbgc8_sqnr_N{n}",
            round(float(prec.sqnr_qy_fullrange_db_approx(8, n, stats)), 2),
            "tBGC B_y=8 fails 40 dB at large N",
        ))
    rows.append(("fig4a/mpc8_sqnr_dB", round(float(prec.sqnr_qy_mpc_db(8)), 2),
                 "MPC B_y=8, N-independent (>=40)"))
    # Fig 4(b): SQNR vs clip ratio, maximum at zeta ~ 4
    for z in (2.0, 3.0, 4.0, 5.0, 6.0):
        rows.append((f"fig4b/mpc8_zeta{z:.0f}",
                     round(float(prec.sqnr_qy_mpc_db(8, z)), 2), ""))
    rows.append(("fig4b/optimal_zeta", prec.optimal_zeta(8), "paper: 4"))
    return rows


# ---------------------------------------------------------------------------
# Fig. 9: QS-Arch SNR trade-offs (+ MC overlay)
# ---------------------------------------------------------------------------


def fig9_qs_arch(mc_ens: int = 400, gen=None) -> List[Row]:
    rows: List[Row] = []
    for v_wl in (0.6, 0.7, 0.8):
        for n in (32, 64, 125, 256, 512):
            a = QSArch(n=n, bx=6, bw=6, v_wl=v_wl)
            rows.append((f"fig9a/E_snrA_V{v_wl}_N{n}",
                         round(a.snr_A_db(), 2), f"k_h={a.k_h:.0f}"))
    # MC overlay at the paper's anchor point
    a = QSArch(n=125, bx=6, bw=6, v_wl=0.8)
    r = mc.empirical_snrs(_gen(gen), a, mc.mc_qs_arch, ens=mc_ens)
    rows.append(("fig9a/S_snrA_V0.8_N125", round(r["snr_A_db"], 2),
                 f"E={a.snr_A_db():.2f} (paper ~19.6)"))
    # Fig 9(b): SNR_T vs B_ADC - minimum B_ADC prediction
    for b_adc in (3, 4, 5, 6, 8):
        rows.append((f"fig9b/snrT_V0.7_N128_B{b_adc}",
                     round(QSArch(n=128, bx=6, bw=6, v_wl=0.7).snr_T_db(b_adc), 2),
                     ""))
    rows.append(("fig9b/b_adc_min_V0.7_N128",
                 QSArch(n=128, bx=6, bw=6, v_wl=0.7).b_adc_min(), "circled pt"))
    return rows


# ---------------------------------------------------------------------------
# Fig. 10: QR-Arch
# ---------------------------------------------------------------------------


def fig10_qr_arch(mc_ens: int = 400, gen=None) -> List[Row]:
    rows: List[Row] = []
    base = QRArch(n=128, bx=6, bw=7, c_o=1e-15).snr_a_db()
    for co in (1e-15, 3e-15, 9e-15):
        a = QRArch(n=128, bx=6, bw=7, c_o=co)
        rows.append((f"fig10a/E_snrA_Co{co*1e15:.0f}fF",
                     round(a.snr_A_db(), 2),
                     f"delta={a.snr_a_db()-base:+.1f} (paper +8/+12)"))
        rows.append((f"fig10b/b_adc_Co{co*1e15:.0f}fF", a.b_adc_min(),
                     "6-8 per paper; BGC=12"))
    a = QRArch(n=128, bx=6, bw=7, c_o=3e-15)
    r = mc.empirical_snrs(_gen(gen), a, mc.mc_qr_arch, ens=mc_ens)
    rows.append(("fig10a/S_snrA_Co3fF", round(r["snr_A_db"], 2),
                 f"E={a.snr_A_db():.2f}"))
    rows.append(("fig10/bgc_by", a.b_adc_bgc(), "vs MPC above"))
    return rows


# ---------------------------------------------------------------------------
# Fig. 11: CM
# ---------------------------------------------------------------------------


def fig11_cm(mc_ens: int = 400, gen=None) -> List[Row]:
    rows: List[Row] = []
    for v_wl in (0.7, 0.8):
        vals = {bw: CMArch(n=64, bx=6, bw=bw, v_wl=v_wl).snr_A_db()
                for bw in range(3, 10)}
        best = max(vals, key=vals.get)
        for bw, v in vals.items():
            rows.append((f"fig11a/E_snrA_V{v_wl}_Bw{bw}", round(v, 2), ""))
        rows.append((f"fig11a/opt_bw_V{v_wl}", best,
                     "paper: 6 @0.8V, 7 @0.7V"))
    a = CMArch(n=64, bx=6, bw=6, v_wl=0.8)
    r = mc.empirical_snrs(_gen(gen), a, mc.mc_cm, ens=mc_ens)
    rows.append(("fig11a/S_snrA_V0.8_Bw6", round(r["snr_A_db"], 2),
                 f"E={a.snr_A_db():.2f}"))
    rows.append(("fig11b/b_adc_mpc", a.b_adc_min(), "paper: <=8 (BGC 19)"))
    rows.append(("fig11b/b_adc_bgc", a.b_adc_bgc(), ""))
    return rows


# ---------------------------------------------------------------------------
# Fig. 12: ADC energy vs N under BGC vs MPC
# ---------------------------------------------------------------------------


def fig12_adc_energy() -> List[Row]:
    rows: List[Row] = []
    for n in (32, 64, 128, 256, 512):
        qs = QSArch(n=n, bx=6, bw=6, v_wl=0.7)
        qr = QRArch(n=n, bx=6, bw=6, c_o=3e-15)
        cm = CMArch(n=n, bx=6, bw=6, v_wl=0.8)
        rows.append((f"fig12a/qs_mpc_fJ_N{n}",
                     round(qs.adc_energy_per_conversion(qs.b_adc_min()) * 1e15, 2),
                     "decreases with N"))
        rows.append((f"fig12b/qr_mpc_fJ_N{n}",
                     round(qr.adc_energy_per_conversion(qr.b_adc_min()) * 1e15, 2),
                     "~N under MPC"))
        rows.append((f"fig12b/qr_bgc_fJ_N{n}",
                     round(qr.adc_energy_per_conversion(qr.b_adc_bgc()) * 1e15, 2),
                     "~N^2 under BGC"))
        rows.append((f"fig12c/cm_mpc_fJ_N{n}",
                     round(cm.adc_energy_per_conversion(cm.b_adc_min()) * 1e15, 2),
                     ""))
    return rows


# ---------------------------------------------------------------------------
# Fig. 13: technology scaling
# ---------------------------------------------------------------------------


def fig13_scaling() -> List[Row]:
    rows: List[Row] = []
    for name in scaling.PAPER_SEQUENCE:
        tech = scaling.node(name)
        best_qs = max(
            QSArch(n=100, bx=3, bw=4, tech=tech, v_wl=float(v)).snr_A_db()
            for v in np.arange(0.5, tech.v_dd - 0.05, 0.025)
        )
        rows.append((f"fig13a/qs_max_snrA_{name}", round(best_qs, 2),
                     "declines with scaling"))
        qr = QRArch(n=100, bx=3, bw=4, tech=tech, c_o=3e-15)
        rows.append((f"fig13b/qr_snrA_{name}", round(qr.snr_A_db(), 2),
                     "QR keeps its SNR"))
        rows.append((f"fig13b/qr_energy_fJ_{name}",
                     round((qr.analog_energy_per_dp()
                            + qr.adc_energy_per_conversion(6)) * 1e15, 2),
                     "drops with scaling"))
    return rows


# ---------------------------------------------------------------------------
# SSVI guidelines as data: energy-vs-SNR pareto (design solver)
# ---------------------------------------------------------------------------


def table_design_pareto() -> List[Row]:
    rows: List[Row] = []
    for target, pt in pareto_sweep(n=256, targets_db=range(10, 34, 4)):
        rows.append((
            f"pareto/target{target}dB",
            round(pt.energy_per_dp * 1e12, 4),
            f"pJ/DP via {pt.arch_kind} knob={pt.knob:.3g} "
            f"banks={pt.n_banks} B_ADC={pt.b_adc}",
        ))
    return rows


# ---------------------------------------------------------------------------
# Fig. 8 methodology at scale: E against S as the ensemble grows
# ---------------------------------------------------------------------------

# the 512-row points the reference pins, and the QR and CM points whose
# gaps its tests call finite-ensemble bias (tests/test_mc_validation.py; also
# the fig10 and fig11 overlays)
MC_POINTS = {
    "QS-512": (QSArch(n=512, bx=6, bw=6, v_wl=0.6), mc.mc_qs_arch),
    "QR-512": (QRArch(n=512, bx=6, bw=7, c_o=3e-15), mc.mc_qr_arch),
    "CM-512": (CMArch(n=512, bx=6, bw=6, v_wl=0.8), mc.mc_cm),
    "QR-128": (QRArch(n=128, bx=6, bw=7, c_o=3e-15), mc.mc_qr_arch),
    "CM-64": (CMArch(n=64, bx=6, bw=6, v_wl=0.8), mc.mc_cm),
}
MC_ENS = (600, 2400, 10**4, 10**5, 10**6)


def mc_convergence(device="cuda", ens_values=MC_ENS, seeds=range(8)
                   ) -> List[dict]:
    """For each point of ``MC_POINTS`` and ensemble size, ``empirical_snrs`` under
    each generator seed: the mean and sample std over seeds of S_A - E_A
    (MC against the Table III closed form) and of S_T - S_A (what the ADC
    costs), and the host milliseconds per ensemble (each call ends in a
    read of its sums, so the device's work is inside)."""
    seeds = list(seeds)
    records = []
    for kind, (arch, sim) in MC_POINTS.items():
        e_a = arch.snr_A_db()
        # warm-up: the first call on a device pays its set-up
        mc.empirical_snrs(mc.generator(0, device), arch, sim,
                          ens=min(ens_values))
        for ens in ens_values:
            gaps, adc = [], []
            t0 = time.perf_counter()
            for seed in seeds:
                r = mc.empirical_snrs(mc.generator(seed, device), arch, sim,
                                      ens=ens)
                gaps.append(r["snr_A_db"] - e_a)
                adc.append(r["snr_T_db"] - r["snr_A_db"])
            ms = (time.perf_counter() - t0) / len(seeds) * 1e3
            records.append({
                "point": kind, "n": arch.n, "ens": ens, "seeds": len(seeds),
                "e_a_db": e_a,
                "gap_mean_db": float(np.mean(gaps)),
                "gap_std_db": float(np.std(gaps, ddof=1)),
                "adc_mean_db": float(np.mean(adc)),
                "adc_std_db": float(np.std(adc, ddof=1)),
                "ms_per_ensemble": ms})
    return records


ALL = {
    "fig4": fig4_mpc_vs_bgc,
    "fig9": fig9_qs_arch,
    "fig10": fig10_qr_arch,
    "fig11": fig11_cm,
    "fig12": fig12_adc_energy,
    "fig13": fig13_scaling,
    "pareto": table_design_pareto,
}
# the figures with Monte Carlo overlays: they take ``gen=``
MC_FIGS = ("fig9", "fig10", "fig11")
