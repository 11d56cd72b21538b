"""In-memory compute models: charge summing (QS), current summing (IS), charge
redistribution (QR) - paper SSIV, Fig. 5, Table II.

Each model maps algorithmic variables of the DP  y_o = sum_j w_j x_j  to physical
quantities:

  QS: (y_o -> V_o,  w_j -> I_j,  x_j -> T_j):  V_o = (1/C) sum_j I_j T_j   (eq. 16)
  QR: (w_j x_j -> V_j):  V_o = sum_j C_j V_j / sum_j C_j                   (eq. 22)
  IS: (w_j -> I_j, x_j -> switch): output current summed over a fixed window
      (the paper defers IS details; we model it as QS with a fixed pulse - the
      same mismatch/thermal machinery applies, no pulse-width noise).

Noise parameter expressions implemented here: eqs. (18)-(20) for QS, eq. (24)
for QR.  Energy: eqs. (21), (25).  Delay: T_QS = T_max + T_su, T_QR = T_share + T_su.

All voltages in volts, capacitances in farads, currents in amperes, times in
seconds, energies in joules.  "Normalized" noise values are referred to the
algorithmic DP with x_m = w_m = 1.
"""
from __future__ import annotations

import dataclasses
import math

K_BOLTZMANN = 1.380649e-23  # J/K


# ---------------------------------------------------------------------------
# Technology parameters (Table II; 65 nm CMOS representative process)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TechParams:
    """Process + circuit parameters (Table II plus calibration constants).

    Calibration constants not printed in the paper (w_over_l, t_pulse,
    c_sw, E_su per-cell, ADC timing) are chosen to reproduce the paper's
    quantitative anchors (sigma_I/I in 8-25% over V_WL = 0.55-0.8 V;
    QS-Arch N_max ~ 125 at V_WL = 0.8 V with SNR_A ~ 19.6 dB; see DESIGN.md SS7).
    """

    name: str = "65nm"
    # --- QS / transistor ---
    k_prime: float = 220e-6  # A/V^2 (alpha-law prefactor k')
    alpha: float = 1.8  # alpha-law exponent
    v_t: float = 0.40  # V, threshold voltage
    sigma_vt: float = 23.8e-3  # V, threshold-voltage mismatch std
    v_dd: float = 1.0  # V
    sigma_t0: float = 2.3e-12  # s, unit WL-driver delay std
    t0: float = 100e-12  # s, unit WL-driver delay
    dv_bl_max: float = 0.85  # V, max BL discharge (0.8-0.9 V in Table II)
    c_bl: float = 270e-15  # F, bit-line capacitance (512-row array, SSV)
    g_m: float = 66e-6  # A/V, access transistor transconductance
    temp: float = 300.0  # K
    # calibration (see docstring)
    w_over_l: float = 1.0  # access transistor W/L
    t_pulse: float = 130e-12  # s, LSB word-line pulse width
    t_rise: float = 30e-12  # s, WL pulse rise time
    t_fall: float = 30e-12  # s, WL pulse fall time
    t_setup: float = 200e-12  # s, precharge/setup time T_su
    e_switch: float = 0.1e-15  # J, per-cell switch-toggle energy (E_su component)
    # --- QR ---
    wl_cox: float = 0.31e-15  # F, W*L*C_ox of the QR switch (Table II)
    pelgrom_kappa: float = 0.08 * math.sqrt(1e-15)  # F^0.5 (kappa = 0.08 fF^0.5)
    inj_p: float = 0.5  # charge-injection layout constant p
    # --- misc/digital ---
    e_add_per_bit: float = 1.0e-15  # J, digital add energy per bit (reduction tree)
    t_adc_per_bit: float = 250e-12  # s, SAR ADC time per bit


TECH_65NM = TechParams()


# ---------------------------------------------------------------------------
# QS model (paper SSIV-B)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class QSModel:
    """Charge-summing compute model at an operating point.

    The operating point is (V_WL, pulse width T, capacitor C).  The binary cell
    discharges the BL cap by dv_unit = I T / C per active (x=1, w=1) cell.
    """

    tech: TechParams = TECH_65NM
    v_wl: float = 0.8

    # --- device quantities -------------------------------------------------
    @property
    def cell_current(self) -> float:
        """alpha-law cell current, eq. (31): I = (W/L) k' (V_WL - V_t)^alpha."""
        ov = max(self.v_wl - self.tech.v_t, 1e-9)
        return self.tech.w_over_l * self.tech.k_prime * ov**self.tech.alpha

    @property
    def sigma_d(self) -> float:
        """Normalized current mismatch sigma_I/I, eq. (18):
        sigma_D = alpha sigma_Vt / (V_WL - V_t)."""
        ov = max(self.v_wl - self.tech.v_t, 1e-9)
        return self.tech.alpha * self.tech.sigma_vt / ov

    @property
    def t_rf(self) -> float:
        """Effective pulse-width loss from finite rise/fall times, eq. (19)."""
        t = self.tech
        return t.t_rise - ((self.v_wl - t.v_t) / self.v_wl) * (
            (t.t_rise + t.t_fall) / (t.alpha + 1.0)
        )

    def sigma_t(self, h_stages: float = 1.0) -> float:
        """Pulse-width mismatch std, eq. (20): sigma_Tj = sqrt(h_j) sigma_T0."""
        return math.sqrt(h_stages) * self.tech.sigma_t0

    def sigma_theta_volts(self, n: int, t_max: float | None = None) -> float:
        """Integrated BL thermal noise voltage std, eq. (20):
        sigma_theta = (1/C) sqrt(N T_max g_m k T / 3)."""
        t = self.tech
        t_max = self.t_pulse_max if t_max is None else t_max
        return (1.0 / t.c_bl) * math.sqrt(n * t_max * t.g_m * K_BOLTZMANN * t.temp / 3.0)

    # --- derived array quantities ------------------------------------------
    @property
    def t_pulse_max(self) -> float:
        return self.tech.t_pulse

    @property
    def t_eff(self) -> float:
        """Effective integration window: nominal pulse minus the deterministic
        rise/fall-time loss t_rf (eq. 19/36)."""
        return max(self.tech.t_pulse - self.t_rf, 1e-12)

    @property
    def dv_unit(self) -> float:
        """Actual BL discharge per active cell: Delta V_BL,unit = I T_eff / C
        (the deterministic rise/fall loss is part of the unit discharge; it is
        known and compensated digitally at reconstruction)."""
        return self.cell_current * self.t_eff / self.tech.c_bl

    @property
    def k_h(self) -> float:
        """Headroom in unit discharges: k_h = Delta V_BL,max / Delta V_BL,unit
        (Table III footnote) - the number of simultaneously-active cells the BL
        can absorb before clipping."""
        return self.tech.dv_bl_max / self.dv_unit

    # --- energy & delay (eq. 21) --------------------------------------------
    def energy(self, mean_v_a: float, n: int) -> float:
        """E_QS = E[V_a] V_dd C + E_su (eq. 21). mean_v_a in volts."""
        t = self.tech
        return mean_v_a * t.v_dd * t.c_bl + n * t.e_switch

    @property
    def delay(self) -> float:
        """T_QS = T_max + T_su."""
        return self.tech.t_pulse + self.tech.t_setup


# ---------------------------------------------------------------------------
# IS model (current summing; modeled as fixed-window QS - see module docstring)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ISModel:
    tech: TechParams = TECH_65NM
    v_wl: float = 0.8

    @property
    def _qs(self) -> QSModel:
        return QSModel(tech=self.tech, v_wl=self.v_wl)

    @property
    def sigma_d(self) -> float:
        return self._qs.sigma_d

    def sigma_theta_volts(self, n: int) -> float:
        return self._qs.sigma_theta_volts(n)

    @property
    def dv_unit(self) -> float:
        return self._qs.dv_unit

    @property
    def k_h(self) -> float:
        return self._qs.k_h

    def energy(self, mean_v_a: float, n: int) -> float:
        return self._qs.energy(mean_v_a, n)

    @property
    def delay(self) -> float:
        # no per-row pulse modulation: single fixed integration window
        return self.tech.t_pulse + self.tech.t_setup


# ---------------------------------------------------------------------------
# QR model (paper SSIV-C)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class QRModel:
    """Charge-redistribution compute model with unit capacitors C_o."""

    tech: TechParams = TECH_65NM
    c_o: float = 3e-15  # F (1-10 fF MOM caps)

    @property
    def sigma_c(self) -> float:
        """Capacitor mismatch std, eq. (24): sigma_C = kappa sqrt(C)."""
        return self.tech.pelgrom_kappa * math.sqrt(self.c_o)

    @property
    def sigma_c_rel(self) -> float:
        """sigma_C / C = kappa / sqrt(C)."""
        return self.sigma_c / self.c_o

    @property
    def sigma_theta_volts(self) -> float:
        """Per-capacitor kT/C thermal noise voltage std, eq. (24)."""
        return math.sqrt(K_BOLTZMANN * self.tech.temp / self.c_o)

    def charge_injection_volts(self, v_j: float) -> float:
        """Deterministic-per-voltage charge injection, eq. (24):
        v_inj = p W L C_ox (V_dd - V_t - V_j) / C_j."""
        t = self.tech
        return t.inj_p * t.wl_cox * (t.v_dd - t.v_t - v_j) / self.c_o

    @property
    def sigma_inj_norm_sq(self) -> float:
        """Normalized (V/V_dd) charge-injection *noise* variance.

        v_inj depends linearly on the signal voltage V_j = x V_dd; the
        signal-dependent part acts as noise (the constant part is an offset,
        calibrated out).  Var(v_inj/V_dd) = (p WLCox / C_o)^2 Var(x).
        See DESIGN.md SS7 deviation (2) - the paper's footnote is dimensionally
        loose; the Monte Carlo uses eq. (24) directly and validates this.
        """
        t = self.tech
        g = t.inj_p * t.wl_cox / self.c_o
        return g * g  # multiply by Var(x) at the architecture level

    # --- energy & delay (eq. 25) --------------------------------------------
    def energy(self, mean_one_minus_v_norm: float, n: int) -> float:
        """E_QR = sum_j E[(V_dd - V_j)] V_dd C_j + E_su (eq. 25).

        ``mean_one_minus_v_norm`` = E[1 - V_j/V_dd] = E[1 - x] for V_j = x V_dd.
        """
        t = self.tech
        return n * (mean_one_minus_v_norm * t.v_dd) * t.v_dd * self.c_o + n * t.e_switch

    @property
    def delay(self) -> float:
        """T_QR = T_share + T_su; charge sharing settles in a few RC constants -
        we use a fixed 2 T_0 for T_share (sub-ns for fF caps)."""
        return 2 * self.tech.t0 + self.tech.t_setup
