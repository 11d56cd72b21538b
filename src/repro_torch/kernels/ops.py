"""IMC-simulated matmuls on real-valued operands.

``imc_matmul`` quantizes activations and weights (paper SSII), derives the
noise constants from the core analytics, and runs the integer-code matmul:
the bit-serial kernel (``imc_bitserial``), the analytic folded-noise kernel
(``imc_analytic``: the int8 code product for codes of at most 8 bits, the
split-TF32 float kernel for wider ones) or a plain code product
(``fakequant``).  On the card the two IMC modes always launch their CUDA
kernels; on the CPU their plain versions run.  (The JAX serve path reaches
the plain oracles only because interpret-mode Pallas is slow off the TPU;
the math is the same.)

Noise is driven by an explicit integer ``seed``: the JAX reference derives
its kernel seed from a PRNG key (``_seed_from_key``), which PyTorch cannot
replay, so callers hand seeds down directly.  ``core.imc_linear.linear``
runs the analytic substrate as plain tensor code, as the reference does; only
this module's ``imc_analytic`` mode reaches the analytic kernel.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.kernels import imc_mvm, prng
from repro_torch.kernels.ref import (
    AnalyticSpec,
    BitSerialSpec,
    quantize_codes,
    true_div,
)


@dataclasses.dataclass(frozen=True)
class IMCMatmulConfig:
    """Runtime configuration of an IMC-simulated matmul."""

    mode: str = "imc_bitserial"  # imc_bitserial | imc_analytic | fakequant
    bx: int = 6
    bw: int = 6
    b_adc: int = 8
    rows: int = 512
    x_signed: bool = True  # LM activations are signed; paper mode uses False
    sigma_d: float = 0.0  # per-cell relative current mismatch (eq. 18)
    sigma_thermal_counts: float = 0.0  # per-plane thermal noise std (eq. 20)
    k_h_counts: float = 1e9  # headroom clip in counts (bitserial)
    v_c_counts: float = 1e9  # per-plane ADC range in counts (bitserial)
    snr_a_db: Optional[float] = None  # analytic mode: folded analog SNR
    y_clip_sigmas: float = 4.0  # MPC clip ratio (analytic mode)


def derive_config_from_arch(arch, x_signed: bool = True) -> IMCMatmulConfig:
    """An :class:`IMCMatmulConfig` from a core ``QSArch`` analytic design
    point: its bank, bit widths, minimum ADC precision, noise constants in
    counts and its analog SNR (for the analytic mode)."""
    qs = arch.qs
    return IMCMatmulConfig(
        mode="imc_bitserial",
        bx=arch.bx,
        bw=arch.bw,
        b_adc=arch.b_adc_min(),
        rows=arch.n,
        x_signed=x_signed,
        sigma_d=float(qs.sigma_d),
        sigma_thermal_counts=float(qs.sigma_theta_volts(arch.n) / qs.dv_unit),
        k_h_counts=float(arch.k_h),
        v_c_counts=float(arch.v_c_counts()),
        snr_a_db=float(arch.snr_a_db()),
    )


def matmul_config_from_imc(cfg, n: int) -> IMCMatmulConfig:
    """Resolve a layer-level ``core.imc_linear.IMCConfig`` into the kernel
    knobs for a DP dimension ``n``: auto-banked rows, per-plane ADC precision
    and the QS-Arch noise constants in counts."""
    arch = cfg.qs_arch(n)
    return IMCMatmulConfig(
        mode="imc_bitserial",
        bx=cfg.bx,
        bw=cfg.bw,
        b_adc=cfg.resolved_b_adc_bitserial(n),
        rows=cfg.bank_rows(n),
        x_signed=cfg.x_signed,
        sigma_d=float(arch.qs.sigma_d),
        sigma_thermal_counts=float(
            arch.qs.sigma_theta_volts(arch.n) / arch.qs.dv_unit),
        k_h_counts=float(arch.k_h),
        v_c_counts=float(arch.v_c_counts()),
    )


def _dynamic_max(v):
    return v.detach().abs().max() + 1e-9


def imc_matmul(x, w, cfg: IMCMatmulConfig, seed: Optional[int] = None,
               x_max=None, w_max=None, sigma_yo=None, cols=None):
    """IMC-simulated ``y = x @ w`` in real units, for ``x`` (B, K) and ``w``
    (K, M).

    ``x_max`` / ``w_max`` freeze the quantizer ranges (the ``frozen``
    calibration policy) and default to the dynamic ``max|.|`` of the operand;
    ``seed=None`` disables analog noise (quantization, clipping and the ADC
    still apply).  In the bit-serial mode ``seed`` derives two child seeds:
    one draws the (K, M) per-cell mismatch gain, the other keys the kernel's
    per-plane thermal noise.  In the analytic mode ``seed`` itself keys the
    kernel's folded output noise (the reference derives it from a key).

    ``sigma_yo`` (analytic mode) is the output std in CODE units that scales
    the folded noise and the MPC clip; it defaults to the std of the first
    <= 8 rows' ideal code product, a per-batch statistic.

    ``cols = (start, total)`` (bit-serial mode) says that ``w`` holds the
    columns ``[start, start + M)`` of a ``(K, total)`` weight split by
    columns over a tensor-parallel group: the mismatch gain is that slice
    of the whole weight's draw and the kernel's noise sites are the whole
    weight's columns, so the shards together equal the whole call.
    """
    if x_max is None:
        x_max = _dynamic_max(x)
    if w_max is None:
        w_max = _dynamic_max(w)
    xc, dx = quantize_codes(x, cfg.bx, cfg.x_signed, x_max)
    wc, dw = quantize_codes(w, cfg.bw, True, w_max)

    if cfg.mode == "fakequant":
        return (xc.to(torch.float32) @ wc.to(torch.float32)) * (dx * dw)

    if cfg.mode == "imc_analytic":
        xc, wc = xc.to(torch.float32), wc.to(torch.float32)
        if sigma_yo is None:
            # a per-batch statistic: the std of the first <= 8 rows' ideal
            # code product
            sigma_yo = (xc[: min(xc.shape[0], 8)] @ wc).detach().std(
                unbiased=False) + 1e-9
        # folded analog noise: SNR_a = sigma_yo^2 / sigma_a^2
        sigma_out = (10.0 ** (-cfg.snr_a_db / 20.0)
                     if cfg.snr_a_db is not None else 0.0)
        # sigma_out and y_clip are in sigma_yo units: the operands are
        # scaled by 1/sigma_yo so the constants apply exactly
        spec = AnalyticSpec(b_adc=cfg.b_adc, sigma_out=sigma_out,
                            y_clip=cfg.y_clip_sigmas, apply_adc=True)
        noise_seed = seed if sigma_out > 0.0 else None
        # codes of at most 8 bits take the exact int8 code product; wider
        # ones (assign_precisions allows 16 bits) the split-TF32 float kernel
        if imc_mvm.int8_route_fits(cfg.bx, cfg.bw, cfg.x_signed,
                                   wc.shape[0]):
            y = imc_mvm.imc_analytic_codes_matmul(
                xc, wc, sigma_yo, spec, bx=cfg.bx, bw=cfg.bw,
                x_signed=cfg.x_signed, seed=noise_seed)
        else:
            y = imc_mvm.imc_analytic_matmul(true_div(xc, sigma_yo), wc, spec,
                                            seed=noise_seed)
        return y * sigma_yo * (dx * dw)

    if cfg.mode == "imc_bitserial":
        spec = BitSerialSpec(
            bx=cfg.bx, bw=cfg.bw, b_adc=cfg.b_adc, rows=cfg.rows,
            k_h=cfg.k_h_counts, v_c=cfg.v_c_counts, x_signed=cfg.x_signed,
            apply_adc=True, sigma_noise=cfg.sigma_thermal_counts)
        k, m = w.shape
        col0, m_total = (0, m) if cols is None else cols
        w_gain = None
        noise_seed = None
        if seed is not None:
            if cfg.sigma_d > 0.0:
                # spatial per-cell current mismatch (fixed per die: pass the
                # same seed for the same chip instance)
                gen = torch.Generator(device=x.device)
                gen.manual_seed(prng.derive_seed(seed, 0))
                w_gain = 1.0 + cfg.sigma_d * torch.randn(
                    (k, m_total), generator=gen, device=x.device,
                    dtype=torch.float32)
                if m_total != m:
                    w_gain = w_gain[:, col0:col0 + m]
            if cfg.sigma_thermal_counts > 0.0:
                noise_seed = prng.derive_seed(seed, 1)
        y = imc_mvm.imc_bitserial_matmul(xc, wc, w_gain, spec,
                                         seed=noise_seed, col0=col0)
        return y * (dx * dw)

    raise ValueError(f"unknown mode {cfg.mode!r}")
