"""Plain PyTorch versions of the kernels: the bit-serial and analytic IMC
matmuls and the paged-attention decode.

These are the functions the CUDA kernels are held against, on the card and
(through the JAX reference ``repro.kernels.ref``) on the CPU.  They run on
whatever device their inputs live on.

Bit-serial semantics (QS-Arch, paper SSIV-B2):

  y[b, m] = sum_banks  sum_{i<Bw, j<Bx}  s_i s_j 2^(i+j) *
          ADC( min( xplane_j[b, :] . wplane_i[:, m], k_h ) + noise )

with two's-complement bit planes (s = -1 for sign planes), per-plane headroom
clipping at k_h counts, additive per-plane analog noise drawn from the counter
hash in :mod:`repro_torch.kernels.prng` at global ``(bank, plane, b, m)``
sites, and a B_adc-bit ADC over [0, v_c] counts.  Rounding is half to even
(``torch.round``), as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import prng

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class BitSerialSpec:
    """Static configuration of the bit-serial IMC matmul."""

    bx: int = 6
    bw: int = 6
    b_adc: int = 8
    rows: int = 512  # bank height (DP dimension per bank)
    k_h: float = 1e9  # headroom clip in unit-discharge counts (inf = no clip)
    v_c: float = 1e9  # ADC full-scale in counts (>= k_h typically)
    x_signed: bool = False  # unsigned (ReLU) vs signed activations
    apply_adc: bool = True
    sigma_noise: float = 0.0  # per-plane temporal noise std in counts (eq. 20)

    def plane_weights(self):
        """(w_weights[Bw], x_weights[Bx]) signed power-of-two recombination."""
        ww = np.array([2.0**i for i in range(self.bw)])
        ww[self.bw - 1] = -(2.0 ** (self.bw - 1))  # w always signed
        xw = np.array([2.0**j for j in range(self.bx)])
        if self.x_signed:
            xw[self.bx - 1] = -(2.0 ** (self.bx - 1))
        return ww, xw


# ---------------------------------------------------------------------------
# quantization helpers (codes in float, exact small ints)
# ---------------------------------------------------------------------------


def true_div(v, d):
    """``v / d`` rounded as an IEEE division on every device.  PyTorch's CUDA
    backend turns division by a Python number into multiplication by its
    reciprocal, which rounds differently at quantizer knife edges; a 0-dim
    tensor divisor keeps the true division, so CPU and card agree."""
    if not isinstance(d, torch.Tensor):
        d = torch.tensor(d, dtype=v.dtype, device=v.device)
    return v / d


def quantize_codes(v, bits: int, signed: bool, max_val):
    """Uniform quantization to integer codes (float dtype of ``v``)."""
    if signed:
        delta = max_val * 2.0 ** (1 - bits)
        lo, hi = -(2.0 ** (bits - 1)), 2.0 ** (bits - 1) - 1
    else:
        delta = max_val * 2.0 ** (-bits)
        lo, hi = 0.0, 2.0**bits - 1
    return torch.clamp(torch.round(true_div(v, delta)), lo, hi), delta


def unpack_plane(codes, j: int, bits: int, signed: bool):
    """Bit plane j of integer codes; two's complement sign plane for
    j == bits-1 when signed."""
    u = codes + 2.0 ** (bits - 1) if signed else codes
    b = torch.remainder(torch.floor(u * (2.0**-j)), 2.0)
    if signed and j == bits - 1:
        b = 1.0 - b
    return b


def adc_transfer(v, b_adc: int, v_c: float):
    """B_adc-bit ADC over [0, v_c] counts."""
    delta = v_c / (2.0**b_adc)
    code = torch.clamp(torch.round(true_div(v, delta) - 0.5), 0.0,
                       2.0**b_adc - 1)
    return (code + 0.5) * delta


def mpc_adc(v, b_adc: int, y_clip):
    """Signed B_adc-bit MPC output ADC over [-y_clip, y_clip]."""
    delta = 2.0 * y_clip / (2.0**b_adc)
    code = torch.clamp(torch.round(true_div(v, delta)), -(2.0 ** (b_adc - 1)),
                       2.0 ** (b_adc - 1) - 1)
    return code * delta


def bitserial_bank_noise(seed, bank: int, n_planes: int, b_sz: int, m: int,
                         device=None):
    """The (n_planes, B, M) standard-normal draws of ``bank``, at the same
    counter sites as the kernel (plane index p = i*Bx + j)."""
    p_idx = torch.arange(n_planes, device=device)[:, None, None]
    b_idx = torch.arange(b_sz, device=device)[None, :, None]
    m_idx = torch.arange(m, device=device)[None, None, :]
    return prng.counter_normal(seed, prng.TAG_BITSERIAL, bank, p_idx, b_idx,
                               m_idx)


# ---------------------------------------------------------------------------
# bit-serial plain version
# ---------------------------------------------------------------------------


def imc_bitserial_ref(x_codes, w_codes, w_gain, spec: BitSerialSpec,
                      seed: Optional[int] = None):
    """Recombined integer-code DP (B, M) in code units.

    ``w_gain`` (K, M) is the spatial per-cell current gain (paper eq. 18),
    shared by every bit plane of a cell; ``seed`` enables per-plane temporal
    noise of std ``spec.sigma_noise`` counts from the counter hash.  With a
    gain the plane sums are taken in float64 and rounded once to float32.
    """
    b_sz, k = x_codes.shape
    k2, m = w_codes.shape
    if k != k2:
        raise ValueError(f"inner dimensions differ: {k} vs {k2}")
    x_codes = x_codes.to(torch.float32)
    w_codes = w_codes.to(torch.float32)
    n_banks = (k + spec.rows - 1) // spec.rows
    pad = n_banks * spec.rows - k
    if pad:
        x_codes = torch.nn.functional.pad(x_codes, (0, pad))
        w_codes = torch.nn.functional.pad(w_codes, (0, 0, 0, pad))
        if w_gain is not None:
            w_gain = torch.nn.functional.pad(w_gain.to(torch.float32),
                                             (0, 0, 0, pad), value=1.0)
    ww, xw = spec.plane_weights()
    has_noise = seed is not None and spec.sigma_noise > 0.0

    acc = torch.zeros((b_sz, m), dtype=torch.float32, device=x_codes.device)
    for bank in range(n_banks):
        sl = slice(bank * spec.rows, (bank + 1) * spec.rows)
        xb, wb = x_codes[:, sl], w_codes[sl, :]
        gb = None if w_gain is None else w_gain[sl, :].to(torch.float32)
        z_bank = None
        if has_noise:
            z_bank = bitserial_bank_noise(seed, bank, spec.bw * spec.bx,
                                          b_sz, m, device=x_codes.device)
        xplanes = [unpack_plane(xb, j, spec.bx, signed=spec.x_signed)
                   for j in range(spec.bx)]
        for i in range(spec.bw):
            wplane = unpack_plane(wb, i, spec.bw, signed=True)
            if gb is not None:
                wplane = wplane * gb
            for j in range(spec.bx):
                if gb is None:
                    dp = xplanes[j] @ wplane  # integer counts: exact
                else:
                    # gain-weighted counts: accumulate in float64 and round
                    # once, so the result does not depend on the order of
                    # the sum (the CUDA kernel adds in row order)
                    dp = (xplanes[j].double() @ wplane.double()).float()
                dp = torch.clamp(dp, max=spec.k_h)
                if has_noise:
                    z = z_bank[i * spec.bx + j]
                    dp = torch.clamp(dp + spec.sigma_noise * z, min=0.0)
                if spec.apply_adc:
                    dp = adc_transfer(dp, spec.b_adc, spec.v_c)
                acc = acc + float(ww[i] * xw[j]) * dp
    return acc


# ---------------------------------------------------------------------------
# analytic-mode plain version: fakequant matmul + folded noise + MPC ADC
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AnalyticSpec:
    """Static config of the analytic (folded-noise) IMC matmul: noise std
    and MPC clip in code units, and the output ADC precision."""

    b_adc: int = 8
    sigma_out: float = 0.0
    y_clip: float = 1e9
    apply_adc: bool = True


def analytic_output_noise(seed, b_sz: int, m: int, device=None):
    """The (B, M) standard-normal draw of the analytic epilogue."""
    b_idx = torch.arange(b_sz, device=device)[:, None]
    m_idx = torch.arange(m, device=device)[None, :]
    return prng.counter_normal(seed, prng.TAG_ANALYTIC, b_idx, m_idx)


def imc_analytic_ref(x_codes, w_codes, spec: AnalyticSpec,
                     seed: Optional[int] = None):
    """y_code = ADC_MPC( x_codes @ w_codes + sigma_out * N(seed) )."""
    y = x_codes.to(torch.float32) @ w_codes.to(torch.float32)
    if seed is not None and spec.sigma_out > 0.0:
        b_sz, m = y.shape
        y = y + spec.sigma_out * analytic_output_noise(seed, b_sz, m,
                                                       device=y.device)
    if spec.apply_adc:
        y = mpc_adc(y, spec.b_adc, spec.y_clip)
    return y


# ---------------------------------------------------------------------------
# paged-attention decode: scatter, gather pool[bt], full softmax
# ---------------------------------------------------------------------------


def paged_attention_ref(q, k_new, v_new, pk, pv, bt, pos_b, active=None, *,
                        scale: float, softcap: Optional[float] = None):
    """Gather-path version of ``paged_attention.paged_attention_decode``.

    Scatters the new token into the pools IN PLACE (garbage-block-0 routing
    from ``paged_attention.write_routing``), gathers ``pool[bt]`` and runs a
    full-row softmax.  Returns ``(ctx (B, Hkv, G, hd) f32, pk, pv)``.
    """
    from repro_torch.kernels.paged_attention import write_routing

    b, max_blocks = bt.shape
    bs, hkv, hd = pk.shape[1], pk.shape[2], pk.shape[3]
    pos_b = pos_b.to(torch.int64)
    dest, off = write_routing(bt, pos_b, bs, active)
    pk[dest, off] = k_new.to(pk.dtype)
    pv[dest, off] = v_new.to(pv.dtype)
    s_kv = max_blocks * bs
    bt_l = bt.to(torch.int64)
    k = pk[bt_l].reshape(b, s_kv, hkv, hd).to(torch.float32)
    v = pv[bt_l].reshape(b, s_kv, hkv, hd).to(torch.float32)
    s = torch.einsum("bhgd,bkhd->bhgk", q.to(torch.float32), k) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    valid = torch.arange(s_kv, device=q.device)[None, :] <= pos_b[:, None]
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    ctx = torch.einsum("bhgk,bkhd->bhgd", p, v)
    return ctx, pk, pv
