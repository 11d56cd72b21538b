"""IMC-simulated matmuls on real-valued operands.

``imc_matmul`` quantizes activations and weights (paper SSII), derives the
per-plane noise constants from the core analytics, and runs the integer-code
matmul.  Noise is driven by an explicit integer ``seed``: the JAX reference
derives its kernel seed from a PRNG key (``_seed_from_key``), which PyTorch
cannot replay, so callers hand seeds down directly.

On the card the bit-serial mode always launches the CUDA kernel.  The JAX
serve path reaches the plain oracle instead only because interpret-mode
Pallas is slow off the TPU (its ``IMCConfig.use_kernel`` defaults to False);
the math is the same.  On the CPU the plain version
runs.  The analytic mode's kernel is not ported yet (ROADMAP queue 2), so
``imc_matmul(mode="imc_analytic")`` raises; ``core.imc_linear.linear`` runs
the analytic substrate as plain tensor code, as the reference does.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.kernels import imc_mvm, prng
from repro_torch.kernels.ref import BitSerialSpec, quantize_codes


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
               x_max=None, w_max=None, sigma_yo=None):
    """IMC-simulated ``y = x @ w`` in real units, for ``x`` (B, K) and ``w``
    (K, M).

    ``x_max`` / ``w_max`` freeze the quantizer ranges (the ``frozen``
    calibration policy) and default to the dynamic ``max|.|`` of the operand;
    ``seed=None`` disables analog noise (quantization, clipping and the ADC
    still apply).  In the bit-serial mode ``seed`` derives two child seeds:
    one draws the (K, M) per-cell mismatch gain, the other keys the kernel's
    per-plane thermal noise.
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
        raise NotImplementedError(
            "imc_matmul(mode='imc_analytic') needs the analytic-mode kernel, "
            "which is not ported yet (ROADMAP queue 2); "
            "core.imc_linear.linear runs the analytic substrate as plain "
            "tensor code")

    if cfg.mode == "imc_bitserial":
        spec = BitSerialSpec(
            bx=cfg.bx, bw=cfg.bw, b_adc=cfg.b_adc, rows=cfg.rows,
            k_h=cfg.k_h_counts, v_c=cfg.v_c_counts, x_signed=cfg.x_signed,
            apply_adc=True, sigma_noise=cfg.sigma_thermal_counts)
        k, m = w.shape
        w_gain = None
        noise_seed = None
        if seed is not None:
            if cfg.sigma_d > 0.0:
                # spatial per-cell current mismatch (fixed per die: pass the
                # same seed for the same chip instance)
                gen = torch.Generator(device=x.device)
                gen.manual_seed(prng.derive_seed(seed, 0))
                w_gain = 1.0 + cfg.sigma_d * torch.randn(
                    (k, m), generator=gen, device=x.device,
                    dtype=torch.float32)
            if cfg.sigma_thermal_counts > 0.0:
                noise_seed = prng.derive_seed(seed, 1)
        y = imc_mvm.imc_bitserial_matmul(xc, wc, w_gain, spec,
                                         seed=noise_seed)
        return y * (dx * dw)

    raise ValueError(f"unknown mode {cfg.mode!r}")
