"""IMC architecture-level analytical models: QS-Arch, QR-Arch, CM (paper Table III,
SSIV-B2/C2/D, Appendix B).

All noise variances are in *normalized algorithmic units* (x_m = w_m = 1), i.e.
directly comparable with sigma_yo^2 = N sigma_w^2 E[x^2].  Voltage-domain
quantities (V_c, Delta-V_BL) convert through dv_unit (QS/CM) or V_dd (QR).

Each architecture exposes:
  sigma_qiy_sq / sigma_eta_h_sq / sigma_eta_e_sq / sigma_eta_a_sq
  snr_a / snr_A / snr_T(b_adc)              (linear; *_db helpers)
  b_adc_min(gamma)                          (Table III row "B_ADC")
  v_c_*                                     (ADC input clip level / range)
  energy_per_dp(b_adc) / delay_per_dp       (Table III row "Energy cost per DP")
"""
from __future__ import annotations

import dataclasses
import math
from functools import lru_cache

import numpy as np

from repro_torch.core import precision as prec
from repro_torch.core.adc import adc_energy
from repro_torch.core.compute_models import QRModel, QSModel, TECH_65NM, TechParams
from repro_torch.core.quant import QuantSpec, SignalStats, UNIFORM_STATS


def _db(x):
    return 10.0 * math.log10(max(float(x), 1e-300))


# ---------------------------------------------------------------------------
# Binomial clipping moment (QS-Arch Appendix B)
# ---------------------------------------------------------------------------


@lru_cache(maxsize=4096)
def binomial_clip_second_moment(n: int, k_h: float, p: float = 0.25) -> float:
    """E[(K - k_h)^2 ; K > k_h] for K ~ Binomial(n, p).

    Exact iterative pmf for n <= 20000; Gaussian tail approximation beyond.
    """
    if k_h >= n:
        return 0.0
    if n <= 20000:
        pmf = (1.0 - p) ** n
        total = 0.0
        k0 = int(math.floor(k_h)) + 1
        for k in range(0, n + 1):
            if k >= k0:
                total += (k - k_h) ** 2 * pmf
            pmf *= (n - k) / (k + 1.0) * (p / (1.0 - p))
        return total
    # Gaussian approximation: K ~ N(np, np(1-p))
    mu = n * p
    sig = math.sqrt(n * p * (1 - p))
    z = (k_h - mu) / sig
    pc, scc = prec.gaussian_clip_stats(abs(z)) if z > 0 else (1.0, 1.0 + z * z)
    return 0.5 * pc * scc * sig * sig if z > 0 else sig * sig


# ---------------------------------------------------------------------------
# Shared input-quantization noise (identical for all three architectures)
# ---------------------------------------------------------------------------


def sigma_qiy_sq(n: int, bx: int, bw: int, stats: SignalStats):
    dx = QuantSpec(bx, signed=False, max_val=stats.x_max).delta
    dw = QuantSpec(bw, signed=True, max_val=stats.w_max).delta
    return (n / 12.0) * (dx**2 * stats.var_w + dw**2 * stats.e_x2)


# ---------------------------------------------------------------------------
# Base class
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class IMCArch:
    """Common analytic scaffolding; subclasses fill in the Table III rows."""

    n: int = 512  # DP dimension (rows used per bank)
    bx: int = 6
    bw: int = 6
    stats: SignalStats = UNIFORM_STATS
    tech: TechParams = TECH_65NM

    # ---- Table III rows (subclass responsibility) ----
    def sigma_eta_h_sq(self) -> float:
        raise NotImplementedError

    def sigma_eta_e_sq(self) -> float:
        raise NotImplementedError

    def v_c_norm(self) -> float:
        """ADC clip level in normalized output units (used by MPC math)."""
        raise NotImplementedError

    def analog_energy_per_dp(self) -> float:
        raise NotImplementedError

    def adc_conversions_per_dp(self) -> int:
        raise NotImplementedError

    def adc_range_ratio(self) -> float:
        """V_DD / V_c for the ADC energy model (eq. 26)."""
        raise NotImplementedError

    def delay_per_dp(self, b_adc: int) -> float:
        raise NotImplementedError

    # ---- derived SNRs ----
    def sigma_yo_sq(self) -> float:
        return self.stats.dp_var(self.n)

    def sigma_qiy_sq(self) -> float:
        return sigma_qiy_sq(self.n, self.bx, self.bw, self.stats)

    def sigma_eta_a_sq(self) -> float:
        return self.sigma_eta_h_sq() + self.sigma_eta_e_sq()

    def snr_a(self) -> float:
        return self.sigma_yo_sq() / max(self.sigma_eta_a_sq(), 1e-300)

    def snr_a_db(self) -> float:
        return _db(self.snr_a())

    def sqnr_qiy(self) -> float:
        return self.sigma_yo_sq() / self.sigma_qiy_sq()

    def snr_A(self) -> float:
        """Eq. (10)."""
        return 1.0 / (1.0 / self.snr_a() + 1.0 / self.sqnr_qiy())

    def snr_A_db(self) -> float:
        return _db(self.snr_A())

    def sigma_qy_sq(self, b_adc: int) -> float:
        """Output (ADC) quantization + clip noise at the final DP output, for an
        MPC-clipped ADC with range +-v_c_norm: variance of quantization over the
        clipped range plus conditional clipping noise of the DP output."""
        y_c = self.v_c_norm()
        sigma_yo = math.sqrt(self.sigma_yo_sq())
        zeta = y_c / max(sigma_yo, 1e-300)
        delta = y_c * 2.0 ** (1 - b_adc) / 2.0  # step/2... step = 2 y_c / 2^B
        q_var = (2.0 * y_c * 2.0**-b_adc) ** 2 / 12.0
        p_c, scc = prec.gaussian_clip_stats(zeta)
        return q_var + p_c * scc * sigma_yo**2

    def sqnr_qy(self, b_adc: int) -> float:
        return self.sigma_yo_sq() / self.sigma_qy_sq(b_adc)

    def snr_T(self, b_adc: int) -> float:
        """Eq. (11)."""
        return 1.0 / (1.0 / self.snr_A() + 1.0 / self.sqnr_qy(b_adc))

    def snr_T_db(self, b_adc: int) -> float:
        return _db(self.snr_T(b_adc))

    # ---- precision assignment ----
    def b_adc_mpc(self, gamma_db: float = 0.5) -> int:
        """The MPC term of the Table III B_ADC bound (eq. 15)."""
        return prec.by_mpc_lower_bound(self.snr_A_db(), gamma_db)

    def b_adc_min(self, gamma_db: float = 0.5) -> int:
        raise NotImplementedError

    def b_adc_bgc(self) -> int:
        return prec.by_bgc(self.bx, self.bw, self.n)

    # ---- energy ----
    def adc_energy_per_conversion(self, b_adc: int) -> float:
        return adc_energy(b_adc, self.adc_range_ratio(), self.tech)

    def energy_per_dp(self, b_adc: int | None = None) -> float:
        if b_adc is None:
            b_adc = self.b_adc_min()
        return (
            self.analog_energy_per_dp()
            + self.adc_conversions_per_dp() * self.adc_energy_per_conversion(b_adc)
            + self.misc_energy_per_dp(b_adc)
        )

    def misc_energy_per_dp(self, b_adc: int) -> float:
        """Digital recombination / reduction energy (E_misc)."""
        return self.adc_conversions_per_dp() * b_adc * self.tech.e_add_per_bit

    def edp_per_dp(self, b_adc: int | None = None) -> float:
        if b_adc is None:
            b_adc = self.b_adc_min()
        return self.energy_per_dp(b_adc) * self.delay_per_dp(b_adc)


# ---------------------------------------------------------------------------
# QS-Arch: fully binarized bit-serial DPs (paper SSIV-B2)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class QSArch(IMCArch):
    v_wl: float = 0.8

    @property
    def qs(self) -> QSModel:
        return QSModel(tech=self.tech, v_wl=self.v_wl)

    @property
    def k_h(self) -> float:
        return self.qs.k_h

    # -- Table III noise rows --
    def _plane_weight_sum(self) -> float:
        """sum_{i,j} 4^(1-i-j) = (4/9)(1-4^-Bw)(1-4^-Bx)."""
        return (4.0 / 9.0) * (1 - 4.0**-self.bw) * (1 - 4.0**-self.bx)

    def sigma_eta_h_sq(self) -> float:
        lam2 = binomial_clip_second_moment(self.n, self.k_h)
        return self._plane_weight_sum() * lam2

    def sigma_eta_e_sq(self, include_secondary: bool = False) -> float:
        """Table III: N sigma_D^2 (1-4^-Bw)(1-4^-Bx) / 9 (current mismatch).

        ``include_secondary`` adds pulse-width + thermal terms (the paper's MC
        includes them; Table III neglects them as sub-dominant).
        """
        qs = self.qs
        var_delta = qs.sigma_d**2 / 4.0
        if include_secondary:
            # pulse-width: relative (sigma_T/T)^2 per active cell
            var_delta += (qs.sigma_t() / qs.t_pulse_max) ** 2 / 4.0
            # thermal: in counts^2 per plane, spread over N cells
            v_th_counts = qs.sigma_theta_volts(self.n) / qs.dv_unit
            var_delta += v_th_counts**2 / self.n
        return self._plane_weight_sum() * self.n * var_delta

    # -- ADC --
    def v_c_counts(self) -> float:
        """Per-plane ADC clip level in unit-discharge counts: cover the binomial
        plane-DP up to mean + 4 sigma, bounded by headroom k_h and by N.
        (Table III convention note: DESIGN.md SS7.)"""
        mu = self.n / 4.0
        sig = math.sqrt(3.0 * self.n) / 4.0
        return min(mu + 4.0 * sig, self.k_h, float(self.n))

    def v_c_norm(self) -> float:
        """Clip level referred to the *final* DP output (normalized units):
        plane clip c_plane recombines like the planes themselves."""
        dx = QuantSpec(self.bx, signed=False, max_val=self.stats.x_max).delta
        dw = QuantSpec(self.bw, signed=True, max_val=self.stats.w_max).delta
        # sum of plane weights: (2^Bx - 1)(2^Bw - 1) ~ full-scale recombination
        return self.v_c_counts() * dx * dw * (2.0**self.bx - 1) * (2.0**self.bw - 1) / 4.0

    def adc_range_ratio(self) -> float:
        v_c_volts = self.v_c_counts() * self.qs.dv_unit
        return self.tech.v_dd / max(v_c_volts, 1e-6)

    def b_adc_min(self, gamma_db: float = 0.5) -> int:
        """Table III: >= min((SNR_A + 16.2)/6, log2 k_h, log2 N)."""
        return int(
            math.ceil(
                min(
                    self.b_adc_mpc(gamma_db),
                    math.log2(max(self.k_h, 2.0)),
                    math.log2(self.n),
                )
            )
        )

    # -- energy & delay: E = Bw Bx (E_QS + E_ADC) + E_misc --
    def analog_energy_per_dp(self) -> float:
        mean_counts = min(self.n / 4.0, self.k_h)
        mean_v_a = mean_counts * self.qs.dv_unit
        return self.bx * self.bw * self.qs.energy(mean_v_a, self.n)

    def adc_conversions_per_dp(self) -> int:
        return self.bx * self.bw

    def delay_per_dp(self, b_adc: int) -> float:
        # Bx serial input cycles; Bw columns converted in parallel per cycle.
        t_adc = b_adc * self.tech.t_adc_per_bit
        return self.bx * (self.qs.delay + t_adc)


# ---------------------------------------------------------------------------
# QR-Arch: binary-weighted DPs via charge redistribution (paper SSIV-C2)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class QRArch(IMCArch):
    c_o: float = 3e-15

    @property
    def qr(self) -> QRModel:
        return QRModel(tech=self.tech, c_o=self.c_o)

    def _w_plane_weight_sum(self) -> float:
        """sum_i 4^(1-i), i = 1..Bw -> (4/3)(1 - 4^-Bw); the x input is analog
        (multi-bit DAC) so only weight planes recombine."""
        return (4.0 / 3.0) * (1 - 4.0**-self.bw)

    def sigma_eta_h_sq(self) -> float:
        return 0.0  # QR does not clip (charge conservation; paper SSIV-C)

    def sigma_eta_e_sq(self) -> float:
        """Table III: (2/3)(1-4^-Bw) N (E[x^2] sigma_Co^2/C_o^2 + 2 sigma_th^2/V_dd^2
        + sigma_inj^2)."""
        qr = self.qr
        per_cell = (
            self.stats.e_x2 * qr.sigma_c_rel**2
            + 2.0 * (qr.sigma_theta_volts / self.tech.v_dd) ** 2
            + qr.sigma_inj_norm_sq * self.stats.var_x
        )
        return (2.0 / 3.0) * (1 - 4.0**-self.bw) * self.n * per_cell

    def v_c_volts(self) -> float:
        """Clip level (4 sigma) of the charge-shared plane output
        V = (V_dd/N) sum x^_j w^_ij: sigma_V = (V_dd/2) sqrt((E[x^2]+Var x)/N)
        (paper App. B; Table III's '8 V_dd sqrt(.)' is the full 8-sigma span -
        we standardize on the 4-sigma clip level, DESIGN.md SS7)."""
        s = self.stats
        return (
            2.0
            * self.tech.v_dd
            * math.sqrt((s.e_x2 + s.var_x) / (s.x_max**2 * self.n))
        )

    def v_c_norm(self) -> float:
        """Final-output clip level: planes are not clipped, the ADC clip is MPC
        at 4 sigma of the recombined output."""
        return 4.0 * math.sqrt(self.sigma_yo_sq())

    def adc_range_ratio(self) -> float:
        return self.tech.v_dd / max(self.v_c_volts(), 1e-6)

    def b_adc_min(self, gamma_db: float = 0.5) -> int:
        """Table III: >= min((SNR_A+16.2)/6, Bx + log2 N)."""
        return int(
            math.ceil(min(self.b_adc_mpc(gamma_db), self.bx + math.log2(self.n)))
        )

    # -- energy & delay: E = Bw (E_QR + N E_mult + E_ADC) + E_misc --
    def analog_energy_per_dp(self) -> float:
        qr = self.qr
        e_qr = qr.energy(1.0 - self.stats.mu_x, self.n)
        e_mult = self.stats.mu_x * 0.5 * self.c_o * self.tech.v_dd**2
        return self.bw * (e_qr + self.n * e_mult)

    def adc_conversions_per_dp(self) -> int:
        return self.bw

    def delay_per_dp(self, b_adc: int) -> float:
        t_adc = b_adc * self.tech.t_adc_per_bit
        return self.qr.delay + t_adc  # Bw rows in parallel


# ---------------------------------------------------------------------------
# CM: multi-bit analog DP (QS + QR composed; paper SSIV-D)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CMArch(IMCArch):
    v_wl: float = 0.8

    @property
    def qs(self) -> QSModel:
        # CM uses the smallest pulse T0 as the LSB pulse
        return QSModel(
            tech=dataclasses.replace(self.tech, t_pulse=self.tech.t0),
            v_wl=self.v_wl,
        )

    @property
    def k_h(self) -> float:
        return self.qs.k_h

    def sigma_eta_h_sq(self) -> float:
        """Table III: (1/12) N E[x^2] sigma_w^2 k_h^-2 2^(2Bw) (1 - 2 k_h 2^-Bw)_+^2."""
        s = self.stats
        t = 1.0 - 2.0 * self.k_h * 2.0**-self.bw
        t = max(t, 0.0)
        return (
            (1.0 / 12.0)
            * self.n
            * s.e_x2
            * s.var_w
            * self.k_h**-2
            * 2.0 ** (2 * self.bw)
            * t * t
        )

    def sigma_eta_e_sq(self) -> float:
        """Table III: (2/3) N E[x^2] (1/4 - 4^-Bw) sigma_D^2."""
        return (
            (2.0 / 3.0)
            * self.n
            * self.stats.e_x2
            * (0.25 - 4.0**-self.bw)
            * self.qs.sigma_d**2
        )

    def v_c_volts(self) -> float:
        """Table III (App. B): 4 sigma of Delta-V_o = 2^(Bw-1) dV_unit/N sum w_i x_i."""
        s = self.stats
        sigma_y = math.sqrt(self.n * s.var_w * s.e_x2)
        return 4.0 * 2.0 ** (self.bw - 1) * self.qs.dv_unit * sigma_y / self.n

    def v_c_norm(self) -> float:
        return 4.0 * math.sqrt(self.sigma_yo_sq())

    def adc_range_ratio(self) -> float:
        return self.tech.v_dd / max(self.v_c_volts(), 1e-6)

    def b_adc_min(self, gamma_db: float = 0.5) -> int:
        """Table III: >= (SNR_A + 16.2)/6 (MPC only)."""
        return int(math.ceil(self.b_adc_mpc(gamma_db)))

    # -- energy & delay: E = 2N E_QS + E_QR + E_mult + E_ADC + E_misc --
    def analog_energy_per_dp(self) -> float:
        s = self.stats
        # per-column BL discharge ~ E[|w|] of full scale; E[|w|] for U[-1,1] = 1/2
        mean_counts = min(0.5 * (2.0**self.bw - 1), self.k_h * 2)
        mean_v = min(mean_counts * self.qs.dv_unit, self.tech.dv_bl_max)
        e_qs_col = mean_v * self.tech.v_dd * self.tech.c_bl / self.n + self.tech.e_switch
        qr = QRModel(tech=self.tech, c_o=3e-15)
        e_qr = qr.energy(1.0 - s.mu_x, self.n)
        e_mult = s.mu_x * 0.5 * qr.c_o * self.tech.v_dd**2
        return 2 * self.n * e_qs_col + e_qr + self.n * e_mult

    def adc_conversions_per_dp(self) -> int:
        return 1

    def delay_per_dp(self, b_adc: int) -> float:
        t_max = 2.0 ** (self.bw - 1) * self.tech.t0
        qr = QRModel(tech=self.tech, c_o=3e-15)
        return t_max + self.tech.t_setup + qr.delay + b_adc * self.tech.t_adc_per_bit
