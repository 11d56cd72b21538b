"""Uniform quantizers and the additive quantization noise model (paper SSII-B, II-C).

Conventions (kept consistent across analytics, Monte Carlo, the IMC layer and the
Pallas kernel):

* Unsigned signal ``x in [0, x_max]`` quantized to ``B`` bits:
  step ``Delta_x = x_max * 2**-B`` (paper's convention), integer codes
  ``k = clip(round(x / Delta), 0, 2**B - 1)``, dequant ``x_hat = k * Delta``.
  Quantization error ~ U[-Delta/2, Delta/2] (unbiased), variance Delta^2/12.
  Codes are exactly representable as ``B`` bit planes: ``k = sum_j 2**j b_j``.

* Signed signal ``w in [-w_max, w_max]`` quantized to ``B`` bits (two's complement):
  step ``Delta_w = w_max * 2**(1-B)``, codes ``k in [-2**(B-1), 2**(B-1)-1]``,
  dequant ``w_hat = k * Delta``. Bit planes: ``k = -2**(B-1) b_{B-1} + sum 2**j b_j``.

* Clipped (MPC) signed quantizer: range ``[-c, c]``, step ``Delta = c * 2**(1-B)``;
  values beyond +-c clip. This is the ADC model under the minimum precision
  criterion (paper SSIII-D).

The analytics take numpy arrays or floats; ``quantize`` / ``fakequant`` also
accept torch tensors, and ``fakequant_ste`` is the torch autograd form.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

# ---------------------------------------------------------------------------
# dB helpers
# ---------------------------------------------------------------------------


def db(x):
    """10*log10(x) (power ratio -> dB)."""
    return 10.0 * np.log10(x)


def undb(x_db):
    """dB -> linear power ratio."""
    return 10.0 ** (np.asarray(x_db) / 10.0)


# ---------------------------------------------------------------------------
# Quantizer specs
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class QuantSpec:
    """A uniform quantizer description.

    Attributes:
      bits:   number of bits ``B``.
      signed: two's-complement signed (True) or unsigned (False).
      max_val: full-scale value (``x_max`` / ``w_max`` / clip level ``c``).
    """

    bits: int
    signed: bool
    max_val: float = 1.0

    @property
    def delta(self) -> float:
        """Quantization step size (paper: Delta_x = x_m 2^-Bx, Delta_w = w_m 2^(1-Bw))."""
        if self.signed:
            return self.max_val * 2.0 ** (1 - self.bits)
        return self.max_val * 2.0 ** (-self.bits)

    @property
    def code_min(self) -> int:
        return -(2 ** (self.bits - 1)) if self.signed else 0

    @property
    def code_max(self) -> int:
        return (2 ** (self.bits - 1)) - 1 if self.signed else (2**self.bits) - 1

    @property
    def noise_var(self) -> float:
        """Additive-model quantization noise variance Delta^2 / 12."""
        return self.delta**2 / 12.0


# ---------------------------------------------------------------------------
# Core quantize / dequantize
# ---------------------------------------------------------------------------


def quantize(x, spec: QuantSpec):
    """Quantize to integer codes (rounded, clipped). Returns float-typed codes.

    Float codes keep everything differentiable-friendly (with STE below) and are
    exact integers in value, so bit-plane extraction is exact.
    """
    if isinstance(x, torch.Tensor):
        return torch.clamp(torch.round(x / spec.delta), spec.code_min,
                           spec.code_max)
    k = np.round(x / spec.delta)
    return np.clip(k, spec.code_min, spec.code_max)


def dequantize(codes, spec: QuantSpec):
    return codes * spec.delta


def fakequant(x, spec: QuantSpec):
    """quantize -> dequantize (the FX signal x_q = x + q_x of the additive model)."""
    return dequantize(quantize(x, spec), spec)


def fakequant_ste(x, spec: QuantSpec):
    """Fake-quant with a straight-through estimator gradient (for QAT / noise-aware
    training, paper SSIII-B references in-training quantization [32][33])."""
    y = fakequant(x, spec)
    zero = x - x.detach()
    return zero + y.detach()


# ---------------------------------------------------------------------------
# Bit planes (for the bit-serial QS-Arch path; paper SSIV-B2)
# ---------------------------------------------------------------------------


def bit_planes(codes, bits: int, signed: bool):
    """Decompose integer-valued (float dtype) codes into bit planes.

    Returns:
      planes: float array, shape ``(bits,) + codes.shape`` with entries in {0, 1}.
              planes[j] is the 2^j plane; for signed, planes[bits-1] is the sign
              plane.
      weights: float array (bits,) such that ``codes == sum_j weights[j]*planes[j]``.
               Unsigned: ``weights[j] = 2^j``. Signed: MSB weight ``-2^(bits-1)``.
    """
    codes = np.asarray(codes)
    if signed:
        # offset-binary representative: u = k + 2^(B-1) in [0, 2^B - 1]
        u = codes + 2.0 ** (bits - 1)
    else:
        u = codes
    planes = []
    for j in range(bits):
        b = np.mod(np.floor(u / (2.0**j)), 2.0)
        planes.append(b)
    if signed:
        # two's complement sign bit a_{B-1} = 1 - (offset-binary MSB), so that
        # k = -2^(B-1) a_{B-1} + sum_{j<B-1} 2^j a_j  holds exactly.
        planes[bits - 1] = 1.0 - planes[bits - 1]
    planes = np.stack(planes, axis=0)
    weights = np.array([2.0**j for j in range(bits)])
    if signed:
        weights = weights.copy()
        weights[bits - 1] = -(2.0 ** (bits - 1))
    return planes, np.asarray(weights)


def combine_bit_planes(planes, weights):
    """Inverse of :func:`bit_planes` (digital power-of-two recombination)."""
    w = np.asarray(weights).reshape((-1,) + (1,) * (planes.ndim - 1))
    return np.sum(planes * w, axis=0)


# ---------------------------------------------------------------------------
# Peak-to-average ratios (paper's zeta definitions)
# ---------------------------------------------------------------------------


def par_signed(w_max, var_w):
    """PAR of a signed signal: zeta_w^2 = w_max^2 / sigma_w^2  (paper SSII-B)."""
    return w_max**2 / var_w


def par_unsigned(x_max, e_x2):
    """PAR of an unsigned signal per the paper's convention:
    zeta_x^2 = x_max^2 / (4 E[x^2])   (paper eq. (8) footnote)."""
    return x_max**2 / (4.0 * e_x2)


def par_signed_db(w_max, var_w):
    return db(par_signed(w_max, var_w))


def par_unsigned_db(x_max, e_x2):
    return db(par_unsigned(x_max, e_x2))


# ---------------------------------------------------------------------------
# SQNR: exact (linear domain) and the paper's dB approximation (eq. 1)
# ---------------------------------------------------------------------------


def sqnr_exact(signal_var, spec: QuantSpec):
    """SQNR = sigma_x^2 / (Delta^2/12)."""
    return signal_var / spec.noise_var


def sqnr_db_rule_of_thumb(bits, par_db_val):
    """Paper eq. (1): SQNR(dB) = 6.02 B + 4.77 - zeta(dB).

    (The paper rounds to 6 B + 4.78; we keep the exact constants
    20log10(2) = 6.0206, 10log10(3) = 4.7712.)
    """
    return 6.0206 * bits + 4.7712 - par_db_val


# ---------------------------------------------------------------------------
# Signal statistics container used throughout the analytics
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SignalStats:
    """Moments of the DP operands (paper SSII-C):

      activations x: unsigned, in [0, x_max], second moment e_x2 = E[x^2],
                     mean mu_x, variance var_x.
      weights w:     signed, zero-mean in [-w_max, w_max], variance var_w.
    """

    x_max: float = 1.0
    w_max: float = 1.0
    e_x2: float = 1.0 / 3.0  # uniform[0,1]
    mu_x: float = 0.5
    var_w: float = 1.0 / 3.0  # uniform[-1,1]

    @property
    def var_x(self) -> float:
        return self.e_x2 - self.mu_x**2

    @property
    def zeta_x_sq(self) -> float:
        return par_unsigned(self.x_max, self.e_x2)

    @property
    def zeta_w_sq(self) -> float:
        return par_signed(self.w_max, self.var_w)

    def dp_var(self, n: int) -> float:
        """sigma_yo^2 = N sigma_w^2 E[x^2]  (paper eq. (5))."""
        return n * self.var_w * self.e_x2

    def dp_max(self, n: int) -> float:
        """y_m = N x_max w_max (no clipping; paper App. A)."""
        return n * self.x_max * self.w_max


UNIFORM_STATS = SignalStats()
"""x ~ U[0,1], w ~ U[-1,1]: the paper's SSV default (zeta_x = -1.3 dB unsigned-PAR
... actually for U[0,1]: x_m^2/(4 E[x^2]) = 1/(4/3) = 0.75 -> -1.25 dB, the paper's
-1.3 dB; zeta_w: 1/(1/3) = 3 -> 4.77 dB, the paper's 4.8 dB)."""


def gaussian_relu_stats(sigma: float = 1.0, x_clip_sigmas: float = 4.0) -> SignalStats:
    """Stats for ReLU(Gaussian) activations and Gaussian weights clipped at 4 sigma,
    a DNN-realistic alternative used in benchmarks.

    For x = max(g, 0), g ~ N(0, sigma^2): E[x^2] = sigma^2/2, E[x] = sigma/sqrt(2 pi).
    """
    e_x2 = sigma**2 / 2.0
    mu_x = sigma / np.sqrt(2.0 * np.pi)
    return SignalStats(
        x_max=x_clip_sigmas * sigma,
        w_max=x_clip_sigmas * sigma,
        e_x2=e_x2,
        mu_x=mu_x,
        var_w=sigma**2,
    )


# ---------------------------------------------------------------------------
# DP input-referred quantization noise (paper eq. (5) / (27))
# ---------------------------------------------------------------------------


def sigma_qiy_sq(n: int, bx: int, bw: int, stats: SignalStats):
    """sigma_qiy^2 = N/12 (Delta_w^2 E[x^2] + Delta_x^2 sigma_w^2)."""
    dx = QuantSpec(bx, signed=False, max_val=stats.x_max).delta
    dw = QuantSpec(bw, signed=True, max_val=stats.w_max).delta
    return (n / 12.0) * (dw**2 * stats.e_x2 + dx**2 * stats.var_w)


def sqnr_qiy(n: int, bx: int, bw: int, stats: SignalStats):
    """Exact linear-domain SQNR_qiy (paper eq. (7)/(28))."""
    return stats.dp_var(n) / sigma_qiy_sq(n, bx, bw, stats)


def sqnr_qiy_db_approx(bx: int, bw: int, stats: SignalStats):
    """Paper eq. (8) closed form (independent of N)."""
    zx2 = stats.zeta_x_sq
    zw2 = stats.zeta_w_sq
    val = 3.0 * 2.0 ** (2 * (bx + bw)) / (
        zx2 * zw2 * (2.0 ** (2 * bx) / zx2 + 2.0 ** (2 * bw) / zw2)
    )
    return db(val)
