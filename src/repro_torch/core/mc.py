"""Sample-accurate Monte Carlo simulation of the IMC architectures (paper SSV-A,
Fig. 8): the 'S' curves that validate the Table III 'E' expressions.

Each simulator is split in two:

  draw_qs / draw_qr / draw_cm   take an explicit ``torch.Generator`` and return
      the ensemble's standard-normal draws (spatial mismatch fixed per
      instance, temporal noise per evaluation), in the shapes the JAX
      reference draws them;
  qs_chain / qr_chain / cm_chain   push operand vectors and those draws through
      the *physical* signal chain of eqs. (17) / (23), nonlinear clipping and
      ADC included.  They are deterministic, so a test can replay the
      reference's ``jax.random`` draws through them.

``mc_qs_arch`` / ``mc_qr_arch`` / ``mc_cm`` compose the two with the
reference's signatures, a generator in the key's place.  Each returns the
post-ADC and the pre-ADC reconstructed DP outputs from the SAME analog pass
(same noise draws) and the ideal DP: one simulation yields the full-chain
SNR_T and the chain-without-ADC SNR_A.

Everything is float32, as the reference runs it (JAX with x64 off); every
division by a constant goes through a 0-dim tensor (``true_div``), so the card
divides as the CPU does.  ``empirical_snrs`` runs the ensemble in chunks of at
most ``CHUNK`` instances on the generator's device and accumulates float64
running sums; its result is a function of the generator's seed, ``ens`` and
``CHUNK``.  ``generator`` makes one on the card unless asked for the CPU.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.archs import CMArch, QRArch, QSArch
from repro_torch.core.compute_models import K_BOLTZMANN
from repro_torch.core.quant import QuantSpec, bit_planes
from repro_torch.kernels.ref import true_div

# instances per chunk of empirical_snrs: at N = 512 the largest chunk tensors
# (QS's pulse-width draws and bit planes, (Bx, CHUNK, N) float32) are 1.6 GB
CHUNK = 2**17


def generator(seed: int, device="cuda") -> torch.Generator:
    """A ``torch.Generator`` on ``device`` (the card by default) seeded with
    ``seed``: the draws of every function here come from it, on its device."""
    return torch.Generator(device=device).manual_seed(seed)


def _normal(gen, shape):
    return torch.randn(shape, generator=gen, device=gen.device,
                       dtype=torch.float32)


def _uniform(gen, shape, lo: float, hi: float):
    """U[lo, hi) as ``jax.random.uniform(minval=lo, maxval=hi)`` forms it."""
    u = torch.rand(shape, generator=gen, device=gen.device,
                   dtype=torch.float32)
    return torch.clamp(u * (hi - lo) + lo, min=lo)


def _codes(v, spec: QuantSpec):
    """clip(round(v / Delta), code_min, code_max), half to even."""
    return torch.clamp(torch.round(true_div(v, spec.delta)), spec.code_min,
                       spec.code_max)


def _specs(arch):
    return (QuantSpec(arch.bx, signed=False, max_val=arch.stats.x_max),
            QuantSpec(arch.bw, signed=True, max_val=arch.stats.w_max))


def _f32(a, device):
    return torch.as_tensor(np.asarray(a), dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# ADC helper: clipped uniform quantizer in physical units
# ---------------------------------------------------------------------------


def adc_quantize(v, b_adc: int, v_lo: float, v_hi: float):
    """B_ADC-bit uniform ADC over [v_lo, v_hi] (values beyond the range clip)."""
    span = v_hi - v_lo
    delta = span / (2.0**b_adc)
    code = torch.clamp(torch.round(true_div(v - v_lo, delta)), 0,
                       2.0**b_adc - 1)
    return v_lo + code * delta


# ---------------------------------------------------------------------------
# QS-Arch sample-accurate simulator (eq. 17 per bit plane)
# ---------------------------------------------------------------------------


class QSDraws(NamedTuple):
    cur: torch.Tensor  # (ens, N) spatial current mismatch, per cell
    pw: torch.Tensor  # (Bx, ens, N) temporal pulse-width mismatch, per plane
    th: torch.Tensor  # (Bw, Bx, ens) integrated thermal noise, per plane pair


def draw_qs(gen, ens: int, n: int, arch: QSArch) -> QSDraws:
    return QSDraws(_normal(gen, (ens, n)), _normal(gen, (arch.bx, ens, n)),
                   _normal(gen, (arch.bw, arch.bx, ens)))


def qs_chain(x, w, arch: QSArch, draws: QSDraws, b_adc: Optional[int] = None):
    """QS-Arch on ``x`` (ens, N) unsigned in [0, x_max] and ``w`` (ens, N)
    signed in [-w_max, w_max]; returns (y_post, y_pre, y_ideal) per instance.

    Physical chain per (weight-bit i, input-bit j) plane: per-cell discharge
    dv_unit * (1 + i_k/I) * (1 + t_k/T) for active cells + thermal noise,
    clipped at dv_bl_max, ADC-quantized, then power-of-two recombined and
    rescaled to algorithmic units.  The deterministic rise/fall-time loss
    (eq. 19) is folded into dv_unit = I*T_eff/C (known, compensated
    digitally)."""
    n = x.shape[1]
    qs, tech = arch.qs, arch.tech
    if b_adc is None:
        b_adc = arch.b_adc_min()
    xspec, wspec = _specs(arch)
    xb, xw_weights = bit_planes(_codes(x, xspec), arch.bx, signed=False)
    wb, ww_weights = bit_planes(_codes(w, wspec), arch.bw, signed=True)
    cur_mis = 1.0 + qs.sigma_d * draws.cur
    pw_mis = 1.0 + (qs.sigma_t() / qs.t_eff) * draws.pw
    dv_unit = qs.dv_unit

    # active-cell discharge per plane pair: sum_k wb_i xb_j cur_k pw_jk, one
    # weight plane at a time ((Bx, ens, N) products; each product is cur*pw
    # or 0, as the reference forms it)
    xpw = xb * pw_mis
    v_planes = torch.stack([dv_unit * ((wbi * cur_mis) * xpw).sum(-1)
                            for wbi in wb])  # (Bw, Bx, ens)
    v_planes = v_planes + qs.sigma_theta_volts(n) * draws.th
    # headroom clipping (eq. 17): v_a = min(V_o, V_o,max)
    v_planes = torch.clamp(v_planes, max=tech.dv_bl_max)
    v_adc = adc_quantize(v_planes, b_adc, 0.0, arch.v_c_counts() * dv_unit)

    coef = _f32(np.outer(ww_weights, xw_weights), x.device)[:, :, None]

    def recombine(v):
        counts = true_div(v, dv_unit)  # back to unit-discharge counts
        y_code = (coef * counts).sum((0, 1))
        return y_code * xspec.delta * wspec.delta

    y_ideal = (w * x).sum(-1)
    return recombine(v_adc), recombine(v_planes), y_ideal


def mc_qs_arch(gen, x, w, arch: QSArch, b_adc: Optional[int] = None):
    """Draw an ensemble from ``gen`` and run :func:`qs_chain` on it."""
    ens, n = x.shape
    return qs_chain(x, w, arch, draw_qs(gen, ens, n, arch), b_adc)


# ---------------------------------------------------------------------------
# QR-Arch sample-accurate simulator (eq. 23 per weight-bit plane)
# ---------------------------------------------------------------------------


class QRDraws(NamedTuple):
    caps: torch.Tensor  # (ens, N) spatial capacitor mismatch
    th: torch.Tensor  # (Bw, ens, N) kT/C noise, per weight plane


def draw_qr(gen, ens: int, n: int, arch: QRArch) -> QRDraws:
    return QRDraws(_normal(gen, (ens, n)), _normal(gen, (arch.bw, ens, n)))


def qr_chain(x, w, arch: QRArch, draws: QRDraws, b_adc: Optional[int] = None):
    """Charge redistribution across N caps per weight-bit plane:
    V = sum_j (C + c_j)(V_j + v_th,j + v_inj,j) / sum_j (C + c_j),
    V_j = x_j w^_i V_dd.  Returns (y_post, y_pre, y_ideal); post- and pre-ADC
    share one analog pass."""
    n = x.shape[1]
    qr, tech = arch.qr, arch.tech
    if b_adc is None:
        b_adc = arch.b_adc_min()
    xspec, wspec = _specs(arch)
    xq = _codes(x, xspec) * xspec.delta
    wb, ww_weights = bit_planes(_codes(w, wspec), arch.bw, signed=True)
    caps = qr.c_o + qr.sigma_c * draws.caps
    caps = torch.clamp(caps, min=0.1 * qr.c_o)
    den = caps.sum(-1)
    v_dd = tech.v_dd
    x_rel = true_div(xq, arch.stats.x_max)

    def plane_voltage(wbi, z_th):
        v_j = x_rel * wbi * v_dd  # (ens, N) in volts
        v_th = qr.sigma_theta_volts * z_th
        v_inj = tech.inj_p * tech.wl_cox * (tech.v_dd - tech.v_t - v_j) / caps
        v_inj = v_inj * wbi  # switch only toggles for active cells
        return (caps * (v_j + v_th + v_inj)).sum(-1) / den  # (ens,)

    v_planes = torch.stack([plane_voltage(wb[i], draws.th[i])
                            for i in range(arch.bw)])  # (Bw, ens)
    v_c = arch.v_c_volts()
    mu = float(arch.stats.mu_x) * v_dd / 2.0  # plane mean (w-bit ~ Bern(1/2))
    v_adc = adc_quantize(v_planes, b_adc, mu - v_c, mu + v_c)
    ww = _f32(ww_weights, x.device)[:, None]

    def recombine(v):
        # normalize: plane DP estimate = V * N / V_dd (x-normalized counts)
        plane_dp = true_div(v * n, v_dd) * arch.stats.x_max
        return (ww * plane_dp).sum(0) * wspec.delta

    y_ideal = (w * x).sum(-1)
    return recombine(v_adc), recombine(v_planes), y_ideal


def mc_qr_arch(gen, x, w, arch: QRArch, b_adc: Optional[int] = None):
    """Draw an ensemble from ``gen`` and run :func:`qr_chain` on it."""
    ens, n = x.shape
    return qr_chain(x, w, arch, draw_qr(gen, ens, n, arch), b_adc)


# ---------------------------------------------------------------------------
# CM sample-accurate simulator (QS multi-bit column + QR aggregation)
# ---------------------------------------------------------------------------

CM_QR_C = 3e-15  # F, the unit cap of CM's charge-domain aggregation


class CMDraws(NamedTuple):
    cur: torch.Tensor  # (ens, Bw, N) spatial current mismatch, per bit cell
    caps: torch.Tensor  # (ens, N) spatial capacitor mismatch
    th: torch.Tensor  # (ens, N) kT/C noise


def draw_cm(gen, ens: int, n: int, arch: CMArch) -> CMDraws:
    return CMDraws(_normal(gen, (ens, arch.bw, n)), _normal(gen, (ens, n)),
                   _normal(gen, (ens, n)))


def cm_chain(x, w, arch: CMArch, draws: CMDraws, b_adc: Optional[int] = None):
    """CM: per-column POT-weighted QS discharge encodes |w_j| on BL / BLB
    (sign via differential), clipped at dv_bl_max; per-column mixed-signal
    multiply by x_j; QR aggregation across N columns; single ADC conversion.
    Returns (y_post, y_pre, y_ideal); post- and pre-ADC share one analog
    pass."""
    n = x.shape[1]
    qs, tech = arch.qs, arch.tech
    if b_adc is None:
        b_adc = arch.b_adc_min()
    xspec, wspec = _specs(arch)
    xq = _codes(x, xspec) * xspec.delta
    wc = _codes(w, wspec)

    # weight magnitude bit planes (sign handled differentially: noise identical)
    wmag = wc.abs()
    wsign = torch.sign(wc) + (wc == 0)
    wb, wmag_weights = bit_planes(wmag, arch.bw, signed=False)  # (Bw, ens, N)
    cur_mis = 1.0 + qs.sigma_d * draws.cur

    dv_unit = qs.dv_unit
    # POT pulse widths: bit i uses 2^i T0 => discharge 2^i dv_unit per active bit
    pot = _f32(wmag_weights, x.device).reshape(1, arch.bw, 1)
    dv_col = dv_unit * (wb.transpose(0, 1) * pot * cur_mis).sum(1)
    # (ens, N) column discharges encoding |w| in dv_unit counts
    dv_col = torch.clamp(dv_col, max=tech.dv_bl_max)  # headroom clip (eq. 17)

    # mixed-signal multiply by x (charge-domain scaling) + QR aggregation
    sig_c = tech.pelgrom_kappa * math.sqrt(CM_QR_C)
    caps = CM_QR_C + sig_c * draws.caps
    caps = torch.clamp(caps, min=0.1 * CM_QR_C)
    v_mult = dv_col * true_div(xq, arch.stats.x_max) * wsign
    v_th = math.sqrt(K_BOLTZMANN * tech.temp / CM_QR_C) * draws.th
    v_o = (caps * (v_mult + v_th)).sum(-1) / caps.sum(-1)

    v_c = arch.v_c_volts()
    v_adc = adc_quantize(v_o, b_adc, -v_c, v_c)

    def rescale(v):
        # V_o = dv_unit/(N x_max) sum_k wc_k x_k  =>  y = Delta_w sum wc x
        return true_div(v * n * arch.stats.x_max, dv_unit) * wspec.delta

    y_ideal = (w * x).sum(-1)
    return rescale(v_adc), rescale(v_o), y_ideal


def mc_cm(gen, x, w, arch: CMArch, b_adc: Optional[int] = None):
    """Draw an ensemble from ``gen`` and run :func:`cm_chain` on it."""
    ens, n = x.shape
    return cm_chain(x, w, arch, draw_cm(gen, ens, n, arch), b_adc)


# ---------------------------------------------------------------------------
# Ensemble runs
# ---------------------------------------------------------------------------


def sample_operands(gen, ens: int, n: int, stats, dist: str = "uniform"):
    """Draw operand ensembles (ens, N) matching a SignalStats description, on
    the generator's device."""
    if dist == "uniform":
        x = _uniform(gen, (ens, n), 0.0, stats.x_max)
        w = _uniform(gen, (ens, n), -stats.w_max, stats.w_max)
    elif dist == "gaussian":
        sig_w = float(np.sqrt(stats.var_w))
        x = torch.clamp(_normal(gen, (ens, n)).abs() * stats.x_max / 4.0,
                        0.0, stats.x_max)
        w = torch.clamp(_normal(gen, (ens, n)) * sig_w, -stats.w_max,
                        stats.w_max)
    else:
        raise ValueError(dist)
    return x, w


def snr_sums(y_post, y_pre, y_ideal) -> torch.Tensor:
    """float64 running sums of one chunk: sum and sum of squares of the
    signal (y_ideal) and of the post- and pre-ADC errors (formed in
    float32, as the reference forms them)."""
    sig = y_ideal.double()
    e_post = (y_post - y_ideal).double()
    e_pre = (y_pre - y_ideal).double()
    return torch.stack([sig.sum(), (sig * sig).sum(), e_post.sum(),
                        (e_post * e_post).sum(), e_pre.sum(),
                        (e_pre * e_pre).sum()])


def snrs_from_sums(sums, count: int) -> dict:
    """snr_T_db (full chain) and snr_A_db (chain without ADC): the ratio of
    the signal's variance to the mean-removed error's, in dB."""
    s = [float(v) for v in sums.tolist()]

    def var(total, total_sq):
        return total_sq / count - (total / count) ** 2

    sig = var(s[0], s[1])
    return {"snr_T_db": 10.0 * math.log10(sig / var(s[2], s[3])),
            "snr_A_db": 10.0 * math.log10(sig / var(s[4], s[5]))}


def empirical_snrs(gen, arch, simulate, ens: int = 1000, b_adc=None,
                   dist="uniform"):
    """Run a simulator ONCE per instance and report empirical pre/post-ADC
    SNRs in dB, as ``{"snr_T_db", "snr_A_db"}``; both come from the same
    simulator pass (identical noise draws).  Each chunk of at most ``CHUNK``
    instances draws its operands, then its circuit noise, from ``gen``; the
    statistics are float64 running sums on ``gen``'s device, read once at
    the end."""
    sums = torch.zeros(6, dtype=torch.float64, device=gen.device)
    for start in range(0, ens, CHUNK):
        size = min(CHUNK, ens - start)
        x, w = sample_operands(gen, size, arch.n, arch.stats, dist)
        sums += snr_sums(*simulate(gen, x, w, arch, b_adc=b_adc))
    return snrs_from_sums(sums, ens)
