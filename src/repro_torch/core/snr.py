"""Compute SNR metrics for IMCs and their composition rules (paper SSIII, eqs. 6-11).

The IMC noise model is

    y = y_o + q_iy + eta_a + q_y,      eta_a = eta_e + eta_h        (eq. 6)

with the fundamental metrics

    SQNR_qiy = sigma_yo^2 / sigma_qiy^2        (input quantization)
    SNR_a    = sigma_yo^2 / sigma_eta_a^2      (analog core)
    SQNR_qy  = sigma_yo^2 / sigma_qy^2         (ADC / output quantization)

and the harmonic composition rules

    SNR_A = (1/SNR_a + 1/SQNR_qiy)^-1          (eq. 10, pre-ADC SNR)
    SNR_T = (1/SNR_A + 1/SQNR_qy)^-1           (eq. 11, total SNR)

so SNR_T <= SNR_a always: the analog core is the fundamental limit.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.quant import db, undb


# ---------------------------------------------------------------------------
# Composition
# ---------------------------------------------------------------------------


def compose_snr(*snrs):
    """Harmonic composition of independent noise sources sharing one signal:
    SNR_tot = (sum_i 1/SNR_i)^-1.  (Generalizes eqs. (10)-(11).)"""
    inv = sum(1.0 / np.asarray(s) for s in snrs)
    return 1.0 / inv


def compose_snr_db(*snr_dbs):
    return db(compose_snr(*[undb(s) for s in snr_dbs]))


def snr_a_required_for_target(snr_t_target_db: float, margin_db: float = 1.0):
    """Minimum SNR_a(dB) such that SNR_T(dB) >= target is attainable with
    appropriately assigned precisions (SNR_T -> SNR_a; paper SSIII-B)."""
    return snr_t_target_db + margin_db


def degradation_db(snr_limit_db, sqnr_extra_db):
    """By how much an extra noise source with SQNR ``sqnr_extra`` degrades an
    existing SNR ``snr_limit``: returns SNR_limit(dB) - SNR_combined(dB).

    Paper SSIII-B anchor: if SQNR_extra = SNR + 9 dB, degradation <= 0.5 dB.
    """
    combined = compose_snr_db(snr_limit_db, sqnr_extra_db)
    return np.asarray(snr_limit_db) - combined


def margin_for_degradation(gamma_db):
    """Inverse of :func:`degradation_db`: required (SQNR_extra - SNR)(dB) so that
    the degradation is exactly ``gamma_db``.

    1/SNR_c = 1/SNR + 1/SQNR ; SNR/SNR_c = 1 + SNR/SQNR = 10^(gamma/10)
    => SQNR/SNR = 1/(10^(gamma/10) - 1).
    """
    g = undb(gamma_db)
    return db(1.0 / (g - 1.0))


# ---------------------------------------------------------------------------
# Empirical estimators (ensemble / Monte Carlo; paper SSV-A)
# ---------------------------------------------------------------------------


def empirical_snr(y_ideal, y_noisy, axis=None):
    """SNR estimate var(y_o) / var(y_noisy - y_o) over an ensemble.

    The error is mean-removed per the paper's convention (fixed offsets are
    calibrated out in real IMCs).
    """
    err = y_noisy - y_ideal
    err = err - np.mean(err, axis=axis, keepdims=axis is not None)
    sig = y_ideal - np.mean(y_ideal, axis=axis, keepdims=axis is not None)
    return np.mean(sig**2, axis=axis) / np.mean(err**2, axis=axis)


def empirical_snr_db(y_ideal, y_noisy, axis=None):
    return db(empirical_snr(y_ideal, y_noisy, axis=axis))
