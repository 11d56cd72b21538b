"""Output-precision assignment criteria: BGC, tBGC, and the paper's MPC
(paper SSIII-C/D, eqs. 12-15).

BGC (bit growth criterion):      B_y = B_x + B_w + log2(N)         (eq. 12)
tBGC:                            B_y set below BGC, LSBs truncated (eq. 9 applies)
MPC (minimum precision criterion): clip the output at y_c = zeta * sigma_yo
  (zeta = 4 maximizes SQNR for Gaussian outputs) and quantize the reduced range
  with B_y bits, trading quantization noise against a controlled clipping noise
  (eq. 14).  Lower bound on B_y: eq. (15).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np

from repro_torch.core import snr as snr_lib
from repro_torch.core.quant import QuantSpec, SignalStats, db


# ---------------------------------------------------------------------------
# Gaussian clipping statistics (used by MPC; paper SSIII-D)
# ---------------------------------------------------------------------------


def _phi(z):
    """Standard normal pdf."""
    return np.exp(-0.5 * z * z) / math.sqrt(2.0 * math.pi)


def _q(z):
    """Standard normal tail probability Q(z) = P(Z > z)."""
    return 0.5 * math.erfc(z / math.sqrt(2.0))


def gaussian_clip_stats(zeta: float) -> Tuple[float, float]:
    """For y ~ N(0, sigma^2) clipped at y_c = zeta*sigma, returns
    (p_c, sigma_cc^2 / sigma^2):

      p_c       = Pr{|y| > y_c} = 2 Q(zeta)
      sigma_cc^2 = E[(|y| - y_c)^2 | |y| > y_c]
                 = sigma^2 (1 + zeta^2 - zeta phi(zeta)/Q(zeta))
    """
    qz = _q(zeta)
    p_c = 2.0 * qz
    if qz <= 0.0:
        return 0.0, 0.0
    scc = 1.0 + zeta**2 - zeta * _phi(zeta) / qz
    return p_c, max(scc, 0.0)


# ---------------------------------------------------------------------------
# BGC / tBGC (eqs. 12, 9, 13)
# ---------------------------------------------------------------------------


def by_bgc(bx: int, bw: int, n: int) -> int:
    """Eq. (12): full bit growth (lossless integer accumulation width)."""
    return bx + bw + int(math.ceil(math.log2(n)))


def sqnr_qy_fullrange(by: int, n: int, stats: SignalStats):
    """Exact SQNR_qy when the full range [-y_m, y_m], y_m = N x_m w_m, is
    quantized with B_y bits (this is eq. (9); BGC/tBGC both use it)."""
    y_m = stats.dp_max(n)
    spec = QuantSpec(by, signed=True, max_val=y_m)
    return stats.dp_var(n) / spec.noise_var


def sqnr_qy_fullrange_db_approx(by: int, n: int, stats: SignalStats):
    """Paper eq. (9): 6 B_y + 4.8 - [zeta_x + zeta_w](dB) - 10log10(N)."""
    return (
        6.0206 * by
        + 4.7712
        - db(stats.zeta_x_sq)
        - db(stats.zeta_w_sq)
        - 10.0 * np.log10(n)
    )


def sqnr_qy_bgc_db(bx: int, bw: int, n: int, stats: SignalStats):
    """Paper eq. (13) (closed form with B_y = B_y^BGC)."""
    return (
        6.0206 * (bx + bw)
        + 4.7712
        - db(stats.zeta_x_sq)
        - db(stats.zeta_w_sq)
        + 10.0 * np.log10(n)
    )


# ---------------------------------------------------------------------------
# MPC (eqs. 14, 15)
# ---------------------------------------------------------------------------


def sqnr_qy_mpc(by: int, zeta: float = 4.0):
    """Paper eq. (14)/(30) for a Gaussian DP output, in linear units:

        SQNR = 3 * 2^(2 B_y) / (zeta^2 (1 + p_c sigma_cc^2/sigma_qy^2))

    with sigma_qy^2 = y_c^2 2^(-2 B_y) / 3 and y_c = zeta sigma_yo.
    Independent of N and of the signal scale (everything normalizes to sigma_yo).
    """
    p_c, scc_norm = gaussian_clip_stats(zeta)
    sigma_qy_norm = zeta**2 * 2.0 ** (-2 * by) / 3.0  # / sigma_yo^2
    return (3.0 * 2.0 ** (2 * by) / zeta**2) / (1.0 + p_c * scc_norm / sigma_qy_norm)


def sqnr_qy_mpc_db(by: int, zeta: float = 4.0):
    return db(sqnr_qy_mpc(by, zeta))


def optimal_zeta(by: int, grid=None) -> float:
    """Numerically maximize eq. (14) over the clip ratio zeta.

    The paper's MPC rule: the optimum is ~4 for Gaussian outputs (Fig. 4(b)).
    """
    if grid is None:
        grid = np.linspace(1.0, 8.0, 1401)
    vals = [float(sqnr_qy_mpc_db(by, z)) for z in grid]
    return float(grid[int(np.argmax(vals))])


def by_mpc_lower_bound(snr_a_db: float, gamma_db: float = 0.5) -> int:
    """Paper eq. (15): minimum B_y so that SNR_A - SNR_T <= gamma, assuming
    Gaussian outputs clipped at 4 sigma with p_c = 0.001:

        B_y >= 1/6 [ SNR_A(dB) + 7.2 - gamma - 10 log10(1 - 10^(-gamma/10)) ]

    For gamma = 0.5 dB this is B_y >= (SNR_A(dB) + 16.3)/6.
    """
    val = (
        snr_a_db
        + 7.2
        - gamma_db
        - 10.0 * math.log10(1.0 - 10.0 ** (-gamma_db / 10.0))
    ) / 6.0
    return int(math.ceil(val))


def clip_level_mpc(sigma_yo, zeta: float = 4.0):
    """The MPC-based SQNR maximizing rule: y_c = 4 sigma_yo for Gaussian DPs."""
    return zeta * sigma_yo


# ---------------------------------------------------------------------------
# Empirical MPC for arbitrary output distributions (beyond-paper utility)
# ---------------------------------------------------------------------------


def sqnr_qy_mpc_empirical(y_samples, by: int, zeta: float = 4.0):
    """Monte-Carlo SQNR_qy of a zeta*sigma-clipped B_y-bit quantizer applied to
    actual DP output samples (no Gaussian assumption). Used to validate eq. (14)
    and to extend MPC to non-Gaussian layer output distributions."""
    y = np.asarray(y_samples)
    sigma = np.std(y)
    c = zeta * sigma
    spec = QuantSpec(by, signed=True, max_val=c)
    yq = np.clip(np.round(y / spec.delta), spec.code_min, spec.code_max) * spec.delta
    err = yq - y
    return float(np.var(y) / np.mean((err - np.mean(err)) ** 2))


# ---------------------------------------------------------------------------
# Full precision assignment (paper SSIII-B procedure)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PrecisionAssignment:
    bx: int
    bw: int
    by: int
    criterion: str
    # predicted SNRs (dB)
    sqnr_qiy_db: float
    sqnr_qy_db: float
    snr_a_db: float
    snr_A_db: float
    snr_t_db: float


def assign_precisions(
    snr_a_db: float,
    n: int,
    stats: SignalStats,
    gamma_db: float = 0.5,
    criterion: str = "mpc",
    max_bits: int = 16,
) -> PrecisionAssignment:
    """The paper's SSIII-B recipe, automated:

      1. smallest B_x = B_w such that SQNR_qiy >= SNR_a + margin(gamma/2)
         (so SNR_A -> SNR_a within gamma/2),
      2. B_y via MPC eq. (15) (or BGC eq. (12)) so SNR_T -> SNR_A within gamma/2.
    """
    from repro_torch.core.quant import sqnr_qiy  # local import to avoid cycle

    margin = float(snr_lib.margin_for_degradation(gamma_db / 2.0))
    bx = bw = None
    for b in range(2, max_bits + 1):
        if float(db(sqnr_qiy(n, b, b, stats))) >= snr_a_db + margin:
            bx = bw = b
            break
    if bx is None:
        bx = bw = max_bits

    snr_A_db = float(
        snr_lib.compose_snr_db(snr_a_db, db(sqnr_qiy(n, bx, bw, stats)))
    )

    if criterion == "bgc":
        by = by_bgc(bx, bw, n)
        qy_db = float(sqnr_qy_bgc_db(bx, bw, n, stats))
    else:
        by = by_mpc_lower_bound(snr_A_db, gamma_db / 2.0)
        qy_db = float(sqnr_qy_mpc_db(by))

    snr_t_db = float(snr_lib.compose_snr_db(snr_A_db, qy_db))
    return PrecisionAssignment(
        bx=bx,
        bw=bw,
        by=by,
        criterion=criterion,
        sqnr_qiy_db=float(db(sqnr_qiy(n, bx, bw, stats))),
        sqnr_qy_db=qy_db,
        snr_a_db=snr_a_db,
        snr_A_db=snr_A_db,
        snr_t_db=snr_t_db,
    )
