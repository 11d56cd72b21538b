"""IMCLinear: the paper's technique as an executable layer.

Every matmul of the model routes through :func:`linear`, in one of four modes:

  digital        plain matmul (the baseline).
  fakequant      B_x/B_w input quantization only (STE gradients) - isolates
                 SQNR_qiy (paper eq. 8).
  imc_analytic   folded-noise IMC model: fakequant matmul + Gaussian analog
                 noise at the analytic SNR_a + MPC-clipped B_ADC output
                 quantization (paper eqs. 10-15), as plain tensor code with
                 STE gradients.
  imc_bitserial  bit-exact QS-Arch simulation through the bit-serial matmul
                 (``kernels.ops``): the CUDA kernel on the card, its plain
                 version on the CPU.

Noise is driven by integer seeds: ``rng`` is an int (or None, which turns
analog noise off), and :func:`layer_rng` derives a per-layer seed with the
counter hash, where the JAX reference folds a layer id into a PRNG key.
``cfg`` may be an :class:`IMCConfig` or a ``core.substrate.Substrate``.

Under tensor parallelism (an active ``core.parallel`` shard group) a call
site marks its projection column- or row-parallel (``split``), and every
mode keeps the single device's semantics: quantizer ranges and the analytic
output statistics are taken over the whole tensor, analog noise is the
slice of the single device's draw, and a bit-serial bank always sees its
whole dot product.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import torch

from repro_torch.core import parallel
from repro_torch.core.archs import QSArch
from repro_torch.kernels import prng
from repro_torch.kernels.ref import true_div


@dataclasses.dataclass(frozen=True)
class IMCConfig:
    """Static IMC execution configuration (hashable)."""

    mode: str = "digital"  # digital|fakequant|imc_analytic|imc_bitserial
    bx: int = 6
    bw: int = 6
    b_adc: Optional[int] = None  # None -> MPC assignment from SNR_A
    rows: int = 512  # SRAM bank height (DP dim per bank)
    x_signed: bool = True
    # analog design point (QS-Arch knobs; used to derive SNR_a when
    # snr_a_db is None)
    v_wl: float = 0.7
    snr_a_db: Optional[float] = None
    y_clip_sigmas: float = 4.0
    # assumed operand PARs (max/sigma) for static ADC assignment on the
    # bit-serial path; 4.0 ~ Gaussian tensors clipped at 4 sigma
    par_x: float = 4.0
    par_w: float = 4.0
    adc_margin_db: float = 9.0  # SQNR_qy >= SNR_A + margin (paper SSIII-B)

    def bank_rows(self, n: Optional[int] = None) -> int:
        """Auto-banking (paper SSVI bullet 4): the largest power-of-two bank
        height within 1 dB of the peak analytic SNR_A."""
        return _bank_rows_cached(min(n or self.rows, self.rows), self.bx,
                                 self.bw, self.v_wl)

    def resolved_snr_a_db(self, n: Optional[int] = None) -> float:
        if self.snr_a_db is not None:
            return self.snr_a_db
        return float(self.qs_arch(n).snr_a_db())

    def qs_arch(self, n: Optional[int] = None) -> QSArch:
        return QSArch(n=self.bank_rows(n), bx=self.bx, bw=self.bw,
                      v_wl=self.v_wl)

    def resolved_b_adc(self, n: Optional[int] = None) -> int:
        """MPC assignment (paper eq. 15) for final-output ADCs."""
        if self.b_adc is not None:
            return self.b_adc
        from repro_torch.core.precision import by_mpc_lower_bound

        return by_mpc_lower_bound(self.resolved_snr_a_db(n))

    def resolved_b_adc_bitserial(self, n: int) -> int:
        """Per-plane ADC precision for the bit-serial QS-Arch path: the
        requirement is placed on the RECOMBINED ADC noise,

          n_banks * S_x * S_w * Delta^2/12 <= sigma_yo,code^2 * 10^-(SNR_A+m)/10

        with S_b = (4^B - 1)/3 and sigma_yo,code from the assumed PARs."""
        if self.b_adc is not None:
            return self.b_adc
        arch = self.qs_arch(n)
        nb = arch.n
        n_banks = max(1, -(-n // nb))
        sx = 2.0 ** (self.bx - 1) / self.par_x if self.x_signed else (
            2.0**self.bx * 0.5 / self.par_x)
        sw = 2.0 ** (self.bw - 1) / self.par_w
        sigma_yo_sq = n * sx**2 * sw**2
        budget = sigma_yo_sq * 10.0 ** (
            -(arch.snr_A_db() + self.adc_margin_db) / 10.0)
        s_x = (4.0**self.bx - 1) / 3.0
        s_w = (4.0**self.bw - 1) / 3.0
        delta = math.sqrt(12.0 * budget / (n_banks * s_x * s_w))
        v_c = arch.v_c_counts()
        b = int(math.ceil(math.log2(max(v_c / max(delta, 1e-6), 2.0))))
        return max(2, min(b, 14))


DIGITAL = IMCConfig(mode="digital")


@functools.lru_cache(maxsize=1024)
def _bank_rows_cached(size: int, bx: int, bw: int, v_wl: float) -> int:
    cands = []
    c = size
    while c >= 32:
        cands.append(c)
        c //= 2
    if not cands:
        return max(size, 1)
    snrs = [QSArch(n=nb, bx=bx, bw=bw, v_wl=v_wl).snr_A_db() for nb in cands]
    peak = max(snrs)
    for nb, s in zip(cands, snrs):  # cands sorted large -> small
        if s >= peak - 1.0:
            return nb
    return cands[-1]


# ---------------------------------------------------------------------------
# quantizer helpers (dynamic per-tensor scales, STE gradients)
# ---------------------------------------------------------------------------


def _fq_ste(v, bits: int, signed: bool, max_val):
    """fake-quant with a straight-through gradient."""
    if signed:
        delta = max_val * 2.0 ** (1 - bits)
        lo, hi = -(2.0 ** (bits - 1)), 2.0 ** (bits - 1) - 1
    else:
        delta = max_val * 2.0 ** (-bits)
        lo, hi = 0.0, 2.0**bits - 1
    q = torch.clamp(torch.round(true_div(v, delta)), lo, hi) * delta
    return v + (q - v).detach()


def _dynamic_max(v):
    return v.detach().abs().max() + 1e-9


def _matmul(x, w, tp=None):
    """x @ w.  With ``tp`` (a row-parallel site's shard group) each rank's
    partial sums stay in float32 through the all-reduce and are rounded to
    x's dtype once, as one device rounds its float32 accumulator once."""
    if tp is None:
        return torch.matmul(x, w)
    if x.dtype in (torch.float32, torch.float64):
        return tp.sum(torch.matmul(x, w))
    if x.is_cuda:  # the tensor cores' float32 accumulator, unrounded
        y = torch.mm(x.reshape(-1, x.shape[-1]), w, out_dtype=torch.float32)
        y = y.reshape(*x.shape[:-1], w.shape[-1])
    else:
        y = torch.matmul(x.to(torch.float32), w.to(torch.float32))
    return tp.sum(y).to(x.dtype)


# ---------------------------------------------------------------------------
# the layer
# ---------------------------------------------------------------------------


def linear(w, x, cfg=DIGITAL, rng: Optional[int] = None, bias=None,
           site: Optional[str] = None, split: Optional[str] = None):
    """y = x @ w (+ bias) on the configured execution substrate.

    ``w`` is (d_in, d_out), ``x`` (..., d_in).  ``site`` names the compute
    site (``"attn.wq"``, ``"mlp.wi"``, ``"lm_head"``, ...): it selects a
    per-site override and, under a ``frozen`` calibration, the frozen
    quantizer ranges.  ``rng`` is an integer noise seed or None.

    ``split`` marks a tensor-parallel projection; it matters only under an
    active shard group (``core.parallel.use``).  ``"col"``: ``w`` holds this
    rank's share of the output columns and ``x`` is whole; the output stays
    split by columns.  ``"row"``: ``x`` and ``w`` hold this rank's share of
    the dot-product dimension and the output is whole, summed over the
    group.  A row site in the group's ``row_columns`` (bit-serial banks)
    holds output columns instead: its input is gathered, and its output
    gathered back.
    """
    from repro_torch.core import substrate as substrate_lib

    sub = substrate_lib.as_substrate(cfg)
    cfg = sub.site_config(site)
    tp = parallel.active() if split is not None else None
    if tp is not None:
        if bias is not None:
            raise ValueError("a tensor-parallel linear takes no bias")
        if split == "row" and site in tp.row_columns:
            y = linear(w, tp.gather(x), sub, rng, site=site, split="col")
            return tp.gather(y)
    row = tp is not None and split == "row"
    tp_row = tp if row else None
    if cfg.mode == "digital":
        y = _matmul(x, w, tp_row)
        return y if bias is None else y + bias

    rec = substrate_lib.active_recorder()
    if rec is not None and tp is not None:
        raise ValueError("calibration records whole-tensor statistics: "
                         "calibrate the unsharded model")
    if rec is not None:
        # calibration pass: record this site's operand ranges, then run the
        # noiseless fakequant proxy (same ranges as the real substrate)
        xq = _fq_ste(x, cfg.bx, cfg.x_signed, _dynamic_max(x))
        wq = _fq_ste(w, cfg.bw, True, _dynamic_max(w))
        y = _matmul(xq, wq)
        rec.observe(site or substrate_lib.DEFAULT_SITE, x, w, y=y)
        return y if bias is None else y + bias

    # passive shadow observation (online drift monitoring): the real
    # substrate path below runs unchanged; the recorder is fed the closest
    # pre-ADC proxy, the fakequant product for fakequant and analytic and
    # the kernel output for bit-serial, as in the reference
    shadow = substrate_lib.active_shadow_recorder()
    if shadow is not None and tp is not None:
        raise ValueError("shadow recording is not sharded: drift monitoring "
                         "runs on one device")

    def _shadow_note(y_obs):
        if shadow is not None:
            shadow.observe(site or substrate_lib.DEFAULT_SITE, x, w, y=y_obs)

    stats = sub.site_stats(site)  # None => dynamic per-batch statistics
    if stats is None:
        x_max, w_max = _dynamic_max(x), _dynamic_max(w)
        if tp is not None:  # ranges of the whole tensors
            w_max = tp.max(w_max)
            if row:
                x_max = tp.max(x_max)
    else:
        x_max, w_max = stats.x_max, stats.w_max

    if cfg.mode == "fakequant":
        xq = _fq_ste(x, cfg.bx, cfg.x_signed, x_max)
        wq = _fq_ste(w, cfg.bw, True, w_max)
        y = _matmul(xq, wq, tp_row)
        _shadow_note(y)
        return y if bias is None else y + bias

    if cfg.mode == "imc_analytic":
        n = x.shape[-1] * (tp.size if row else 1)
        xq = _fq_ste(x, cfg.bx, cfg.x_signed, x_max)
        wq = _fq_ste(w, cfg.bw, True, w_max)
        y = _matmul(xq, wq, tp_row)  # the ADC converts the whole product
        _shadow_note(y)
        col = tp is not None and not row
        if stats is None:
            y_all = tp.gather(y.detach()) if col else y.detach()
            sigma_yo = y_all.std(unbiased=False) + 1e-9
        else:
            sigma_yo = stats.sigma_yo
        snr_a_db = cfg.resolved_snr_a_db(n)
        sigma_a = sigma_yo * 10.0 ** (-snr_a_db / 20.0)
        if rng is not None:
            gen = torch.Generator(device=y.device)
            gen.manual_seed(int(rng))
            m = y.shape[-1]
            shape = y.shape[:-1] + (m * tp.size if col else m,)
            z = torch.randn(shape, generator=gen, device=y.device,
                            dtype=y.dtype)
            if col:  # this rank's columns of the single device's draw
                z = z[..., tp.rank * m:(tp.rank + 1) * m]
            y = y + sigma_a * z
        # MPC output ADC: clip at zeta*sigma, quantize with B_ADC bits (STE)
        b_adc = cfg.resolved_b_adc(n)
        y_c = cfg.y_clip_sigmas * sigma_yo
        y = _fq_ste(torch.clamp(y, -y_c, y_c), b_adc, True, y_c)
        return y if bias is None else y + bias

    if cfg.mode == "imc_bitserial":
        from repro_torch.kernels import ops as kops

        if row:  # launch.sharding places bit-serial row sites by columns
            raise ValueError(f"bit-serial site {site!r} split by rows would "
                             "split its banks")
        n = x.shape[-1]
        mcfg = kops.matmul_config_from_imc(cfg, n)
        lead = x.shape[:-1]
        x2 = x.reshape(-1, n)
        m = w.shape[-1]
        cols = ((tp.rank * m, tp.size * m) if tp is not None
                else (0, m))
        y = kops.imc_matmul(x2, w, mcfg, seed=rng, x_max=x_max, w_max=w_max,
                            cols=cols)
        y = y.reshape(*lead, w.shape[-1]).to(x.dtype)
        _shadow_note(y)
        return y if bias is None else y + bias

    raise ValueError(f"unknown IMC mode {cfg.mode!r}")


def layer_rng(base: Optional[int], layer_id: int) -> Optional[int]:
    """Derive a per-layer noise seed (None passes through)."""
    if base is None:
        return None
    return prng.derive_seed(base, layer_id)
