#!/usr/bin/env python3
"""Quickest proof that the PyTorch + CUDA port starts on the GPU.

  python3 chip_smoke.py            # all phases, one card
  python3 chip_smoke.py --phases device,build,kernels

Phases, each reported on its own line:
  1 device   the card's name and power limit (nvidia-smi);
  2 build    the CUDA kernels, compiled from the sources in this checkout;
  3 kernels  each kernel against its plain PyTorch version on the card, at the
             main path's full-width shapes, with its time, the plain
             version's time, a library call's time where one computes the
             same function, and the least time the card could take (bound);
  4 design   the layer-scale design study, the analytic kernel's path: every
             matmul shape of musicgen-medium at 512 rows through
             ``ops.imc_matmul(mode="imc_analytic")`` at each billed QR and CM
             design point, delivered SNR_T against the design's prediction;
  5 serve    full-width musicgen-medium (48 layers, d_model 1536, bf16,
             seeded random weights) served by the engine on the digital
             substrate (metered, with the energy table), the bit-serial IMC
             substrate, and a 2x bursty overload on the analytic substrate
             with deadline scheduling, lazy KV, preemption and frontier
             degradation; counting the kernels' launches;
  6 parity   the SMOKE config in float32: the engine on the card against the
             same engine on the CPU, greedy tokens identical (for the
             overload run, identical SLO counters, and tokens identical but
             for exact ties of the analytic LM head's ADC-quantized logits).
Optional: ``--phases ...,profile``, a torch.profiler trace of one decode
chunk of each full-width substrate - device kernel time by name against the
chunk's wall time (summary printed, tables under build/chip_smoke/);
``--phases ...,tiles``, the analytic kernel's tile instantiations
(``TILE_CONFIGS``) timed against each other at every site shape.
The line before the last is a JSON object with every kernel's numbers; the
last line is ``{"ok": true, "device": {...}}``.  Any failure raises and exits
non-zero; without a CUDA device, or outside a checkout of the repository,
the script exits non-zero before printing a result.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "build" / "chip_smoke"  # logs and profiler tables (git-ignored)
PHASES = ("device", "build", "kernels", "design", "serve", "parity")
# not run by default: a profiler trace of one decode chunk per substrate
EXTRA_PHASES = ("profile", "tiles")

# NVIDIA H100 SXM published peaks (data sheet, dense), used for the bounds
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
F32_FLOPS_PER_S = 67e12

MIXED_LENS = [4, 6, 48, 5, 8, 44, 6, 7]
# slots of the full-width bit-serial serve (phase 5) and its kernel check
BITSERIAL_SLOTS = 4
# the full-width overload serve (phase 5): 8 slots whose full provisioning is
# 8 * 7 + 1 = 57 KV blocks; 20 makes lazy allocation preempt
OVERLOAD_SLOTS, OVERLOAD_REQUESTS, OVERLOAD_GEN, OVERLOAD_KV_BLOCKS = 8, 24, 16, 20
# matmul shapes of musicgen-medium (K, M): attention, MLP in, MLP out, head
SITE_SHAPES = ((1536, 1536), (1536, 6144), (6144, 1536), (1536, 2048))
# (BM, BN, BK, TM, TN) instantiations of the analytic kernel's tile template
# timed against each other by the optional tiles phase
TILE_CONFIGS = ((64, 64, 16, 4, 4), (8, 64, 32, 1, 4))


def say(phase: str, msg: str):
    print(f"[{phase}] {msg}", flush=True)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds per call on the card (CUDA events around a run)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def check_paged_attention(dev):
    """8 slots with contexts up to ~1024 in bf16 pools (musicgen-medium:
    Hkv=24, G=1, hd=64, block 8), one inactive and one overrun row."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import paged_attention as pa

    gen = torch.Generator(device=dev).manual_seed(0)
    b, hkv, g, hd, bs, max_blocks = 8, 24, 1, 64, 8, 130
    nb = b * max_blocks + 1
    bf = torch.bfloat16
    q = torch.randn((b, hkv, g, hd), generator=gen, device=dev)
    kn = torch.randn((b, hkv, hd), generator=gen, device=dev).to(bf)
    vn = torch.randn((b, hkv, hd), generator=gen, device=dev).to(bf)
    pk = torch.randn((nb, bs, hkv, hd), generator=gen, device=dev).to(bf)
    pv = torch.randn((nb, bs, hkv, hd), generator=gen, device=dev).to(bf)
    perm = torch.randperm(nb - 1, generator=gen, device=dev) + 1
    bt = perm[: b * max_blocks].reshape(b, max_blocks).to(torch.int32)
    # contexts 17 .. 1023, slot 6 inactive, slot 7 overran its capacity
    pos = torch.tensor([17, 130, 511, 640, 777, 900, 1023, max_blocks * bs],
                       dtype=torch.int32, device=dev)
    active = torch.ones(b, dtype=torch.bool, device=dev)
    active[6] = False
    scale = hd**-0.5

    pk_k, pv_k = pk.clone(), pv.clone()
    pk_p, pv_p = pk.clone(), pv.clone()
    ctx_k, _, _ = pa.paged_attention_decode(q, kn, vn, pk_k, pv_k, bt, pos,
                                            active, scale=scale)
    ctx_p, _, _ = pa.decode_plain(q, kn, vn, pk_p, pv_p, bt, pos, active,
                                  scale=scale)
    torch.cuda.synchronize()
    err = float((ctx_k - ctx_p).abs().max())
    if not torch.allclose(ctx_k, ctx_p, rtol=1e-5, atol=1e-5):
        raise AssertionError(f"paged attention ctx differs: max abs {err}")
    if not (torch.equal(pk_k[1:], pk_p[1:]) and torch.equal(pv_k[1:],
                                                            pv_p[1:])):
        raise AssertionError("paged attention pools differ outside block 0")
    # softcap and GQA variant at a smaller width
    q2 = torch.randn((b, 4, 2, hd), generator=gen, device=dev)
    pk2 = torch.randn((nb, bs, 4, hd), generator=gen, device=dev)
    pv2 = torch.randn((nb, bs, 4, hd), generator=gen, device=dev)
    kn2 = torch.randn((b, 4, hd), generator=gen, device=dev)
    vn2 = torch.randn((b, 4, hd), generator=gen, device=dev)
    c2k, a2k, b2k = pa.paged_attention_decode(
        q2, kn2, vn2, pk2.clone(), pv2.clone(), bt, pos, active, scale=scale,
        softcap=30.0)
    c2p, a2p, b2p = pa.decode_plain(q2, kn2, vn2, pk2.clone(), pv2.clone(),
                                    bt, pos, active, scale=scale, softcap=30.0)
    if not torch.allclose(c2k, c2p, rtol=1e-5, atol=1e-5) or not (
            torch.equal(a2k[1:], a2p[1:]) and torch.equal(b2k[1:], b2p[1:])):
        raise AssertionError("paged attention (GQA, softcap) differs: max "
                             f"abs {float((c2k - c2p).abs().max())}")

    # a decode step meets each layer's pools cold: rotate over 4 pool pairs
    # (4 x 102 MB) so no call finds the previous one's rows in the 50 MB L2
    pools = [(pk.clone(), pv.clone()) for _ in range(4)]
    turn = iter(range(10**9))

    def kernel_call():
        pk_r, pv_r = pools[next(turn) % len(pools)]
        pa.paged_attention_decode(q, kn, vn, pk_r, pv_r, bt, pos, active,
                                  scale=scale)

    ms = time_ms(kernel_call)
    plain_ms = time_ms(lambda: pa.decode_plain(
        q, kn, vn, pk_p, pv_p, bt, pos, active, scale=scale), iters=5)
    # yardstick only: SDPA over the gathered pool[bt] view (the port never
    # calls it); the gather itself is not timed
    s_kv = max_blocks * bs
    kg = pk[bt.long()].reshape(b, s_kv, hkv, hd).permute(0, 2, 1, 3)
    vg = pv[bt.long()].reshape(b, s_kv, hkv, hd).permute(0, 2, 1, 3)
    mask = (torch.arange(s_kv, device=dev)[None, :] <= pos[:, None].long())
    mask = mask[:, None, None, :]
    qs = q.reshape(b, hkv, 1, hd).to(bf)
    views = [(kg.clone(), vg.clone()) for _ in range(4)]  # cold, as above

    def library_call():
        kv, vv = views[next(turn) % len(views)]
        F.scaled_dot_product_attention(qs, kv, vv, attn_mask=mask,
                                       scale=scale)

    library_ms = time_ms(library_call)
    # bound: each valid K/V row (0..pos, within capacity) read once, q
    # read, the new rows and ctx written; ~4 flops per K/V element
    rows = sum(min(int(p) + 1, max_blocks * bs) for p in pos.tolist())
    nbytes = (2 * rows * hkv * hd * 2 + q.numel() * 4 + 2 * kn.numel() * 2
              + 2 * kn.numel() * 2 + ctx_k.numel() * 4)
    flops = 4 * rows * hkv * g * hd
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    say("kernels", f"paged_attention: max_abs_err={err:.3e} ms={ms:.4f} "
        f"plain_ms={plain_ms:.4f} library_ms(sdpa)={library_ms:.4f} "
        f"bound_ms={max(t_bytes, t_ops):.5f}")
    return {"name": "paged_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
            "replaces": "src/repro/kernels/paged_attention.py:159",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms}


def bitserial_bound(b, k, m, bits, gain):
    """(bound_ms, bound_by) of one bit-serial call: int8 codes (and the f32
    gain) read once, the f32 output written once; the plane products as one
    multiply-add (2 operations) per (b, k, m) and plane pair, int8 without
    gain, float32 with it (the gain-weighted sums are float32 work)."""
    nbytes = k * m + b * k + 4 * b * m + (4 * k * m if gain else 0)
    n_ops = 2 * bits * b * k * m
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / (F32_FLOPS_PER_S if gain else INT8_OPS_PER_S) * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def check_bitserial(dev):
    """Every bit-serial shape of the bit-serial serve's decode step, at its 4
    slots and knobs (7x7 bits, 256-row banks, b_adc 10): the projections
    1536->1536 (wq, wk, wv, wo), 1536->6144 and 6144->1536 (MLP) and the LM
    head 1536->2048.  Each without noise and gain (exact) and with seeded
    noise and per-cell gain (at most 0.1% of elements may differ by a code).
    The serve path runs the projections with noise and gain (the kernel's
    gain instantiation) and the LM head without (its other instantiation):
    those two are the rows of the kernels line."""
    import torch

    from repro_torch.core.imc_linear import IMCConfig
    from repro_torch.kernels import imc_mvm, ops, ref

    imc = IMCConfig(mode="imc_bitserial", bx=7, bw=7, v_wl=0.7)
    gen = torch.Generator(device=dev).manual_seed(1)
    b = BITSERIAL_SLOTS
    worst = {True: 0.0, False: 0.0}
    ms = {}
    for k, m in ((1536, 1536), (1536, 6144), (6144, 1536), (1536, 2048)):
        mc = ops.matmul_config_from_imc(imc, k)
        spec = ref.BitSerialSpec(bx=mc.bx, bw=mc.bw, b_adc=mc.b_adc,
                                 rows=mc.rows, k_h=mc.k_h_counts,
                                 v_c=mc.v_c_counts, x_signed=True,
                                 sigma_noise=mc.sigma_thermal_counts)
        x = torch.randn((b, k), generator=gen, device=dev)
        w = torch.randn((k, m), generator=gen, device=dev)
        xc, _ = ref.quantize_codes(x, 7, True, x.abs().max())
        wc, _ = ref.quantize_codes(w, 7, True, w.abs().max())
        gain = 1.0 + mc.sigma_d * torch.randn((k, m), generator=gen,
                                              device=dev)
        step = spec.v_c / 2**spec.b_adc * 2 ** (spec.bw + spec.bx)
        fracs = {}
        for g, seed in ((None, None), (gain, 4242)):
            y_k = imc_mvm.imc_bitserial_matmul(xc, wc, g, spec, seed=seed)
            y_p = ref.imc_bitserial_ref(xc, wc, g, spec, seed=seed)
            torch.cuda.synchronize()
            diff = (y_k - y_p).abs()
            frac = float((diff > 0).float().mean())
            if g is None and frac > 0:
                raise AssertionError(
                    f"bitserial ({k}x{m}) noiseless differs: max abs "
                    f"{float(diff.max())}")
            if frac > 1e-3 or float(diff.max()) > step:
                raise AssertionError(
                    f"bitserial ({k}x{m}) with noise and gain: {frac:.2e} of "
                    f"elements differ (limit 1e-3), max {float(diff.max())}")
            worst[g is not None] = max(worst[g is not None],
                                       float(diff.max()))
            fracs[g is not None] = frac
            ms[(k, m, g is not None)] = time_ms(
                lambda: imc_mvm.imc_bitserial_matmul(xc, wc, g, spec,
                                                     seed=seed))
        say("kernels", f"bitserial {b}x{k}x{m} rows={spec.rows} "
            f"b_adc={spec.b_adc}: without noise and gain exact, "
            f"ms={ms[(k, m, False)]:.4f}; with noise and gain "
            f"{fracs[True]:.2e} of elements differ, "
            f"ms={ms[(k, m, True)]:.4f}")
        if (k, m) == (1536, 6144):  # the gain row's shape (MLP wi)
            main_gain = (xc, wc, gain, spec)
        if (k, m) == (1536, 2048):  # the no-gain row's shape (LM head)
            main_lm = (xc, wc, spec)

    xc, wc, gain, spec = main_gain
    gain_plain_ms = time_ms(lambda: ref.imc_bitserial_ref(
        xc, wc, gain, spec, seed=4242), iters=3, warmup=1)
    bits = spec.bw * spec.bx
    gain_bound, gain_by = bitserial_bound(b, 1536, 6144, bits, True)
    xc, wc, spec = main_lm
    lm_plain_ms = time_ms(lambda: ref.imc_bitserial_ref(xc, wc, None, spec),
                          iters=3, warmup=1)
    lm_bound, lm_by = bitserial_bound(b, 1536, 2048, bits, False)
    # the kernel's share of one decode step: 48 layers of four 1536->1536
    # projections and the two MLP projections with gain, one LM head without
    step_ms = 48 * (4 * ms[(1536, 1536, True)] + ms[(1536, 6144, True)]
                    + ms[(6144, 1536, True)]) + ms[(1536, 2048, False)]
    say("kernels", f"bitserial with noise and gain at {b}x1536x6144: "
        f"ms={ms[(1536, 6144, True)]:.4f} plain_ms={gain_plain_ms:.4f} "
        f"bound_ms={gain_bound:.5f} ({gain_by}); without, LM head "
        f"{b}x1536x2048: ms={ms[(1536, 2048, False)]:.4f} "
        f"plain_ms={lm_plain_ms:.4f} bound_ms={lm_bound:.5f} ({lm_by}); "
        f"kernel time of one {b}-slot decode step (289 launches): "
        f"{step_ms:.2f} ms")
    common = {"route": "cuda",
              "source": "src/repro_torch/kernels/csrc/bitserial.cu",
              "replaces": "src/repro/kernels/imc_mvm.py:140",
              "library_ms": None}
    return [dict(common, name="bitserial", max_abs_err=worst[True],
                 ms=ms[(1536, 6144, True)], plain_ms=gain_plain_ms,
                 bound_ms=gain_bound, bound_by=gain_by,
                 shape=f"{b}x1536x6144, noise and gain"),
            dict(common, name="bitserial_nogain", max_abs_err=worst[False],
                 ms=ms[(1536, 2048, False)], plain_ms=lm_plain_ms,
                 bound_ms=lm_bound, bound_by=lm_by,
                 shape=f"{b}x1536x2048 (LM head), no noise or gain")]


def analytic_bound(b, k, m):
    """(bound_ms, bound_by) of one analytic call: f32 x, w and out moved once
    over the HBM rate, or the 2 B K M float32 operations of the product over
    the card's float32 peak (the noise draws are not counted)."""
    t_bytes = 4 * (b * k + k * m + b * m) / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * b * k * m / F32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def analytic_operands(gen, b, k, m, pt, dev):
    """Seeded analytic-kernel operands at design point ``pt``: activation
    codes over sigma_yo (of the first 8 rows' code product), weight codes."""
    import torch

    from repro_torch.kernels import ref

    x = torch.rand((b, k), generator=gen, device=dev)
    w = torch.rand((k, m), generator=gen, device=dev) * 2 - 1
    xc, _ = ref.quantize_codes(x, pt.bx, False, x.abs().max())
    wc, _ = ref.quantize_codes(w, pt.bw, True, w.abs().max())
    return ref.true_div(xc, (xc[:8] @ wc).std(unbiased=False) + 1e-9), wc


def check_analytic(dev):
    """The analytic kernel at every musicgen-medium site shape, at B = 8 and
    B = 512, with the QR 26 dB design point's ADC (b_adc from the design,
    sigma_out = 10^(-SNR_a/20), y_clip 4) and a seed.  With the ADC at most
    0.1% of the outputs may differ from the plain version, each by at most
    one ADC step plus 1e-6 (the K order of the sums differs); without it
    allclose(rtol 1e-5, atol 1e-5 * max|y|), and at one shape the noise alone
    (noisy - clean) equals sigma_out * z of the plain version within 3 ulp.
    The plain version on the card is float32 (TF32 off)."""
    import torch

    from repro_torch.core.design import optimize
    from repro_torch.kernels import imc_mvm, ref

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("the plain version must run in float32: "
                             "torch.backends.cuda.matmul.allow_tf32 is set")
    pt = optimize(n=512, snr_t_target_db=26.0, kinds=("qr",))
    spec = ref.AnalyticSpec(b_adc=pt.b_adc,
                            sigma_out=10.0 ** (-pt.snr_a_db / 20.0),
                            y_clip=4.0)
    raw = ref.AnalyticSpec(b_adc=spec.b_adc, sigma_out=spec.sigma_out,
                           y_clip=spec.y_clip, apply_adc=False)
    step = 2 * spec.y_clip / 2**spec.b_adc
    seed = 1234
    gen = torch.Generator(device=dev).manual_seed(2)
    worst, row = 0.0, None
    for b in (8, 512):
        for k, m in SITE_SHAPES:
            xs, wc = analytic_operands(gen, b, k, m, pt, dev)
            y_k = imc_mvm.imc_analytic_matmul(xs, wc, spec, seed=seed)
            y_p = ref.imc_analytic_ref(xs, wc, spec, seed=seed)
            r_k = imc_mvm.imc_analytic_matmul(xs, wc, raw, seed=seed)
            r_p = ref.imc_analytic_ref(xs, wc, raw, seed=seed)
            torch.cuda.synchronize()
            diff = (y_k - y_p).abs()
            frac = float((diff > 1e-6).float().mean())
            if float(diff.max()) > step + 1e-6 or frac >= 1e-3:
                raise AssertionError(
                    f"analytic {b}x{k}x{m}: {frac:.2e} of outputs differ "
                    f"(limit 1e-3), max {float(diff.max())} (limit {step})")
            atol = 1e-5 * float(r_p.abs().max())
            if not torch.allclose(r_k, r_p, rtol=1e-5, atol=atol):
                raise AssertionError(
                    f"analytic {b}x{k}x{m} without the ADC differs: max abs "
                    f"{float((r_k - r_p).abs().max())}")
            worst = max(worst, float(diff.max()))
            if (b, k, m) == (8, 1536, 1536):
                clean = imc_mvm.imc_analytic_matmul(xs, wc, raw)
                z = spec.sigma_out * ref.analytic_output_noise(seed, b, m,
                                                               device=dev)
                eps = torch.finfo(torch.float32).eps
                tol = 3 * eps * (z.abs() + r_k.abs())
                if not bool(((r_k - clean - z).abs() <= tol).all()):
                    raise AssertionError("analytic noise differs from "
                                         "sigma_out * z by more than 3 ulp")
            ms = time_ms(lambda: imc_mvm.imc_analytic_matmul(xs, wc, spec,
                                                             seed=seed))
            plain_ms = time_ms(lambda: ref.imc_analytic_ref(xs, wc, spec,
                                                            seed=seed))
            lib_ms = time_ms(lambda: torch.matmul(xs, wc))
            bound, by = analytic_bound(b, k, m)
            say("kernels", f"analytic {b}x{k}x{m} b_adc={spec.b_adc}: "
                f"{frac:.2e} of outputs differ, max_abs_err="
                f"{float(diff.max()):.3e}; ms={ms:.4f} plain_ms={plain_ms:.4f}"
                f" library_ms(torch.matmul, product only)={lib_ms:.4f} "
                f"bound_ms={bound:.5f} ({by})")
            if (b, k, m) == (512, 1536, 6144):
                row = {"name": "analytic", "route": "cuda",
                       "source": "src/repro_torch/kernels/csrc/analytic.cu",
                       "replaces": "src/repro/kernels/imc_mvm.py:284",
                       "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                       "bound_by": by, "library_ms": lib_ms,
                       "shape": f"{b}x{k}x{m}, noise and ADC"}
    row["max_abs_err"] = worst
    return row


# ---------------------------------------------------------------------------
# phase 4: the design study at layer scale, the analytic kernel's path
# ---------------------------------------------------------------------------


def phase_design(dev):
    """Each billed QR and CM design point (min-energy at SNR_T 14 and 26 dB,
    512-row banks) runs every distinct (K, M) of musicgen-medium's matmul
    sites through ``ops.imc_matmul(mode="imc_analytic")`` on the card at
    B = 512, with operands of the design's statistics (x uniform in [0, 1),
    w uniform in [-1, 1)).  Prints the delivered SNR_T beside the design's
    SNR_T and SNR_a, and asserts the paper's bound SNR_T <= SNR_a + 1.5 dB
    and that every call launched the analytic kernel once.  Then times one
    whole ``ops.imc_matmul`` call per shape at the QR 26 dB point (after the
    launches are read, so the timing's launches do not count)."""
    import math

    import torch

    from repro_torch import configs
    from repro_torch.core.design import optimize
    from repro_torch.core.mapping import per_token_matmul_shapes
    from repro_torch.kernels import ops

    shapes = sorted({(s.k, s.m) for s in per_token_matmul_shapes(
        configs.get("musicgen-medium"))})
    gen = torch.Generator(device=dev).manual_seed(3)
    calls = 0
    for target in (14.0, 26.0):
        for kind in ("qr", "cm"):
            pt = optimize(n=512, snr_t_target_db=target, kinds=(kind,))
            if pt is None:
                say("design", f"{kind} @ {target:g} dB: no feasible point")
                continue
            cfg = ops.IMCMatmulConfig(mode="imc_analytic", bx=pt.bx,
                                      bw=pt.bw, b_adc=pt.b_adc,
                                      snr_a_db=pt.snr_a_db, x_signed=False)
            if (target, kind) == (26.0, "qr"):
                timed_cfg = cfg
            got = []
            for k, m in shapes:
                x = torch.rand((512, k), generator=gen, device=dev)
                w = torch.rand((k, m), generator=gen, device=dev) * 2 - 1
                y = ops.imc_matmul(x, w, cfg, seed=calls + 1)
                calls += 1
                y0 = x.double() @ w.double()
                err = y.double() - y0
                snr = 10 * math.log10(float(y0.var(unbiased=False)) / float(
                    ((err - err.mean()) ** 2).mean()))
                if snr > pt.snr_a_db + 1.5:
                    raise AssertionError(
                        f"{kind} @ {target:g} dB, {k}x{m}: delivered SNR_T "
                        f"{snr:.2f} dB above SNR_a {pt.snr_a_db:.2f} + 1.5")
                got.append(f"{k}->{m} {snr:.2f}")
            say("design", f"{kind} @ {target:g} dB (bx={pt.bx} bw={pt.bw} "
                f"b_adc={pt.b_adc}, {pt.n_banks} bank(s)): predicted SNR_T "
                f"{pt.snr_t_db:.2f} dB, SNR_a {pt.snr_a_db:.2f} dB; "
                f"delivered at B=512: {'; '.join(got)} dB")
    launches = read_counts()["analytic"]
    if launches != calls:
        raise AssertionError(f"design: {launches} analytic launches for "
                             f"{calls} calls")
    timed = []
    for k, m in shapes:
        x = torch.rand((512, k), generator=gen, device=dev)
        w = torch.rand((k, m), generator=gen, device=dev) * 2 - 1
        ms = time_ms(lambda: ops.imc_matmul(x, w, timed_cfg, seed=1),
                     iters=10)
        timed.append(f"{k}->{m} {ms:.4f}")
    say("design", f"one ops.imc_matmul call (quantize, sigma_yo, kernel, "
        f"rescale) at B=512, qr @ 26 dB, ms: {'; '.join(timed)}")
    return launches


# ---------------------------------------------------------------------------
# phase 5: the main path at full width
# ---------------------------------------------------------------------------


def reset_counts():
    from repro_torch.kernels import imc_mvm, paged_attention

    paged_attention.paged_attention_cuda.launches = 0
    imc_mvm.bitserial_cuda.launches = 0
    imc_mvm.bitserial_cuda.gain_launches = 0
    imc_mvm.analytic_cuda.launches = 0


def read_counts():
    from repro_torch.kernels import imc_mvm, paged_attention

    bs = imc_mvm.bitserial_cuda
    return {"paged_attention": paged_attention.paged_attention_cuda.launches,
            "bitserial": bs.gain_launches,
            "bitserial_nogain": bs.launches - bs.gain_launches,
            "analytic": imc_mvm.analytic_cuda.launches}


def serve_run(label, argv, n_layers, vocab):
    """Serve through the CLI entry point and check what came out: no failed
    request, tokens in the vocabulary (every request's full ``max_new``
    unless it ran a workload with early stops), one paged-attention launch
    per layer and decode step, and - when metered - a finite J/token at
    every billed design point."""
    import math

    import torch

    from repro_torch.launch import serve
    from repro_torch.launch.metering import format_report, format_slo_summary

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    rep = serve.main(argv)
    counts = read_counts()
    eng = rep["engine"]
    fin = rep["finished"]
    bad = [r.rid for r in fin if r.error is not None and not r.shed]
    if bad:
        raise AssertionError(f"{label}: requests {bad} failed")
    for r in fin:
        want = r.max_new if r.stop_at is None else min(r.max_new, r.stop_at)
        if r.shed:
            want = len(r.out)
        if len(r.out) != want or not all(0 <= t < vocab for t in r.out):
            raise AssertionError(f"{label}: request {r.rid} produced "
                                 f"{r.out}")
    if counts["paged_attention"] != n_layers * eng.decode_steps:
        raise AssertionError(
            f"{label}: {counts['paged_attention']} paged-attention launches "
            f"for {eng.decode_steps} decode steps of {n_layers} layers")
    meter = rep["meter"]
    if meter is not None:
        if meter.billed_tokens <= 0 or not rep["energy"] or not all(
                math.isfinite(e.j_per_token) for e in rep["energy"]):
            raise AssertionError(f"{label}: energy report incomplete: "
                                 f"{[e.summary() for e in rep['energy']]}")
    say("serve", f"{label}: {len(fin)} requests, {rep['tokens']} tokens in "
        f"{rep['seconds']:.2f} s, {rep['tok_s']:.1f} tok/s, mean TTFT "
        f"{rep['ttft_ms']:.1f} ms, {eng.decode_steps} decode steps, "
        f"{eng.prefill_calls} prefills, launches {counts} "
        f"({counts['paged_attention'] / max(eng.decode_steps, 1):.0f} "
        f"paged-attention per step), peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if rep["slo"] is not None:
        say("serve", f"{label} SLO summary (virtual decode steps):\n"
            + format_slo_summary(rep["slo"]))
    if meter is not None:
        say("serve", f"{label} energy (billed prefill tokens "
            f"{meter.prefill_billed_tokens}, of which padding "
            f"{meter.prefill_pad_tokens}; decode tokens "
            f"{meter.decode_billed_tokens}):\n" + format_report(rep["energy"]))
    return counts, rep


def overload_argv(n_requests, gen, kv_blocks, slots):
    """The overload CLI: a 2x bursty workload under deadline scheduling with
    lazy KV and frontier degradation on the analytic substrate, metered."""
    return ["--arch", "musicgen-medium", "--batch", str(slots),
            "--requests", str(n_requests), "--gen", str(gen), "--chunk", "4",
            "--workload", "bursty", "--workload-seed", "0", "--overload",
            "2.0", "--slo-policy", "deadline", "--alloc", "lazy",
            "--kv-blocks", str(kv_blocks), "--degrade", "--imc-mode",
            "imc_analytic", "--imc-policy", "frozen", "--energy-report",
            "--seed", "0"]


def phase_serve():
    from repro_torch import configs

    cfg = configs.get("musicgen-medium")
    n_layers, vocab = cfg.n_layers, cfg.vocab_size
    digital, _ = serve_run(
        "digital", ["--arch", "musicgen-medium", "--batch", "8",
                    "--requests", "8", "--prompt-lens",
                    "16,512,64,300,128,33,480,256", "--gen", "32",
                    "--chunk", "8", "--energy-report", "--seed", "0"],
        n_layers, vocab)
    bitserial, _ = serve_run(
        "imc_bitserial", ["--arch", "musicgen-medium", "--batch",
                          str(BITSERIAL_SLOTS),
                          "--requests", "6", "--prompt-lens",
                          "5,9,32,4,17,6", "--gen", "8", "--chunk", "4",
                          "--imc-mode", "imc_bitserial", "--seed", "0"],
        n_layers, vocab)
    overload, rep = serve_run(
        "overload", overload_argv(OVERLOAD_REQUESTS, OVERLOAD_GEN,
                                  OVERLOAD_KV_BLOCKS, OVERLOAD_SLOTS),
        n_layers, vocab)
    rids = sorted(r.rid for r in rep["finished"])
    if rids != list(range(OVERLOAD_REQUESTS)):
        raise AssertionError(f"overload: requests did not each leave once: "
                             f"{rids}")
    if rep["engine"].substrate_swaps < 1:
        raise AssertionError("overload: the frontier was never walked "
                             "(0 substrate swaps)")
    runs = (digital, bitserial, overload)
    counts = {k: sum(c[k] for c in runs) for k in digital if k != "analytic"}
    if min(counts.values()) <= 0:
        raise AssertionError(f"a kernel of the main path never launched: "
                             f"{counts}")
    return counts


# ---------------------------------------------------------------------------
# phase 6: card against CPU on the SMOKE config
# ---------------------------------------------------------------------------


def phase_parity(dev):
    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.core.imc_linear import IMCConfig
    from repro_torch.core.substrate import calibrate_model
    from repro_torch.launch.serve import Engine, Request, serve
    from repro_torch.models import init_params
    from repro_torch.models.model import tree_map

    def tokens(cfg, params):
        rnp = np.random.default_rng(11)
        reqs = [Request(rid=i, prompt=rnp.integers(0, cfg.vocab_size, n),
                        max_new=6) for i, n in enumerate(MIXED_LENS)]
        eng = Engine(cfg, params, batch_slots=4, cache_len=48 + 6 + 8,
                     max_chunk=4, block_size=8)
        done = serve(eng, reqs)
        if any(r.error for r in done):
            raise AssertionError("parity run had failed requests")
        return {r.rid: r.out for r in done}

    for mode in ("digital", "imc_bitserial"):
        cfg = configs.get_smoke("musicgen-medium")
        params_cpu = init_params(cfg, seed=0, device="cpu")
        if mode != "digital":
            cfg = cfg.replace(imc=IMCConfig(mode=mode, bx=7, bw=7, v_wl=0.7))
            ref = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 24))
            cfg = calibrate_model(cfg, params_cpu, [ref])
        params_gpu = tree_map(lambda t: t.to(dev), params_cpu)
        reset_counts()
        out_gpu = tokens(cfg, params_gpu)
        counts = read_counts()
        out_cpu = tokens(cfg, params_cpu)
        if out_gpu != out_cpu:
            raise AssertionError(f"{mode}: card tokens {out_gpu} != CPU "
                                 f"tokens {out_cpu}")
        say("parity", f"SMOKE float32 {mode}: greedy tokens identical on "
            f"the card and the CPU ({sum(map(len, out_cpu.values()))} "
            f"tokens, card launches {counts})")

    overload_parity(dev)


class TokenProbe:
    """Records the logits behind every token an engine emits, keyed by
    (request id, token index), with the frontier level (index into
    ``ladder``) the engine was at.  With ``force`` ({key: token}), each
    forced token is made the greedy pick after its logits are recorded, so
    the engine follows a given token stream (teacher forcing through the
    engine's own prefill and decode path)."""

    def __init__(self, eng, ladder, force=None):
        self.eng, self.ladder, self.force = eng, ladder, force
        self.logits, self.level = {}, {}
        self.rows, self.step = [], 0
        # which rows hold which request, set where a prefill group or a
        # decode chunk starts: (row, request, index of the row's next token)
        run_chunk, admit_group = eng._run_chunk, eng._admit_group

        def _run_chunk(n_steps, active, key):
            self.start([(i, r) for i, r in enumerate(eng.slots)
                        if r is not None])
            return run_chunk(n_steps, active, key)

        def _admit_group(group, slot_ids, bucket):
            self.start(list(enumerate(group)))
            return admit_group(group, slot_ids, bucket)

        eng._run_chunk, eng._admit_group = _run_chunk, _admit_group

    def start(self, rows):
        self.rows = [(i, r, len(r.out)) for i, r in rows]
        self.step = 0

    def emit(self, logits):
        """Called with each (rows, 1, V) logits block the engine argmaxes."""
        designs = [sub.design for sub in self.ladder]
        level = designs.index(self.eng.substrate.design)
        bump = []
        for i, req, idx in self.rows:
            key = (req.rid, idx + self.step)
            row = logits[i, -1].float().cpu()
            self.logits[key], self.level[key] = row, level
            if self.force is not None and key in self.force:
                bump.append((i, self.force[key], float(row.max()) + 1.0))
        self.step += 1
        if bump:
            logits = logits.clone()
            for i, tok, top in bump:
                logits[i, -1, tok] = top
        return logits


def overload_parity(dev):
    """The overload path on SMOKE in float32, card against CPU: the same
    workload, scheduler, pool and frontier ladder as phase 5's overload run.

    The virtual clock makes every SLO counter a function of the seed, so
    they must match exactly.  The analytic substrate's MPC ADC makes the LM
    head's logits multiples of one code, so two tokens can tie exactly at
    the top, and the card's other summation order can break such a tie the
    other way.  So where the tokens differ, the CPU is run again, forced
    through the engine onto the card's tokens, and at every token the card's
    pick must be the CPU's greedy pick on the same history and frontier
    level, or the two picks' logits must be exactly equal on the CPU or on
    the card.  Lengths must match, and every token is compared."""
    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.core.design import optimize
    from repro_torch.core.substrate import (
        calibrate_model,
        substrate_for_design,
        substrate_ladder,
    )
    from repro_torch.launch import serve as serve_mod
    from repro_torch.launch.serve import Engine, serve_workload
    from repro_torch.models import init_params
    from repro_torch.models.model import tree_map
    from repro_torch.runtime.workload import VirtualClock, make_overload_config

    pt = optimize(n=512, snr_t_target_db=26.0, kinds=("qr",))
    ladder = substrate_ladder(pt, steps=2)
    cfg = configs.get_smoke("musicgen-medium")
    cfg = cfg.replace(imc=substrate_for_design(pt))
    params_cpu = init_params(cfg, seed=0, device="cpu")
    ref = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 32))
    cfg = calibrate_model(cfg, params_cpu, [ref])
    wcfg = make_overload_config(
        n_requests=OVERLOAD_REQUESTS, seed=0, overload=2.0,
        slots=OVERLOAD_SLOTS, max_new=OVERLOAD_GEN, arrival="bursty")
    model_prefill, model_decode = serve_mod.prefill, serve_mod.decode_step

    def overload(params, force=None):
        eng = Engine(cfg, params, OVERLOAD_SLOTS, 32 + OVERLOAD_GEN + 8,
                     max_chunk=4, kv_blocks=OVERLOAD_KV_BLOCKS,
                     alloc_policy="lazy", clock=VirtualClock())
        probe = TokenProbe(eng, ladder, force)

        def prefill(*a, **k):
            logits, cache = model_prefill(*a, **k)
            return probe.emit(logits), cache

        def decode_step(*a, **k):
            logits, cache = model_decode(*a, **k)
            return probe.emit(logits), cache

        serve_mod.prefill, serve_mod.decode_step = prefill, decode_step
        try:
            fin, summary = serve_workload(eng, wcfg, "deadline", ladder)
        finally:
            serve_mod.prefill, serve_mod.decode_step = (model_prefill,
                                                        model_decode)
        return ({r.rid: r.out for r in fin},
                json.dumps(summary, sort_keys=True), probe)

    out_gpu, slo_gpu, probe_gpu = overload(
        tree_map(lambda t: t.to(dev), params_cpu))
    out_cpu, slo_cpu, _ = overload(params_cpu)
    if slo_gpu != slo_cpu:
        raise AssertionError(f"overload: card SLO counters {slo_gpu} != "
                             f"CPU {slo_cpu}")
    lens_gpu = {rid: len(o) for rid, o in out_gpu.items()}
    lens_cpu = {rid: len(o) for rid, o in out_cpu.items()}
    if lens_gpu != lens_cpu:
        raise AssertionError(f"overload: request lengths differ, card "
                             f"{lens_gpu} CPU {lens_cpu}")
    same = sum(out_gpu[r] == out_cpu[r] for r in out_cpu)
    n_tok = sum(lens_cpu.values())
    if same == len(out_cpu):
        say("parity", f"SMOKE float32 overload: SLO counters and all "
            f"{n_tok} tokens identical on the card and the CPU ({slo_cpu})")
        return
    force = {(rid, i): t for rid, o in out_gpu.items()
             for i, t in enumerate(o)}
    out_forced, slo_forced, probe_cpu = overload(params_cpu, force)
    if out_forced != out_gpu or slo_forced != slo_gpu:
        raise AssertionError("overload: the CPU run forced onto the card's "
                             "tokens did not reproduce them or its SLO "
                             f"counters: {out_forced} {slo_forced}")
    ties = []
    for key, tok in sorted(force.items()):
        lc, lg = probe_cpu.logits[key], probe_gpu.logits[key]
        if probe_cpu.level[key] != probe_gpu.level[key]:
            raise AssertionError(f"overload: token {key} was emitted at "
                                 f"frontier level {probe_gpu.level[key]} on "
                                 f"the card, {probe_cpu.level[key]} on the "
                                 f"CPU")
        mine = int(torch.argmax(lc))  # the CPU's greedy pick
        if mine == tok:
            continue
        if lc[tok] == lc[mine]:
            where = "CPU"
        elif lg[tok] == lg[mine]:
            where = "card"
        else:
            raise AssertionError(
                f"overload: request {key[0]} token {key[1]} (frontier level "
                f"{probe_gpu.level[key]}) is {tok} on the card, where the "
                f"CPU picks {mine} on the same history; logits CPU "
                f"{float(lc[tok])!r} vs {float(lc[mine])!r}, card "
                f"{float(lg[tok])!r} vs {float(lg[mine])!r}")
        ties.append(f"request {key[0]} token {key[1]} at level "
                    f"{probe_gpu.level[key]}: card {tok}, CPU {mine}, logits "
                    f"exactly equal on the {where} ({float(lc[mine])!r})")
    say("parity", f"SMOKE float32 overload: SLO counters identical on the "
        f"card and the CPU ({slo_cpu}); tokens identical for {same} of "
        f"{len(out_cpu)} requests; forced onto the card's tokens, the CPU "
        f"picks the card's token at {n_tok - len(ties)} of {n_tok} tokens "
        f"and the rest are exact ties: {'; '.join(ties)}")


# ---------------------------------------------------------------------------
# optional: where a decode step's time goes
# ---------------------------------------------------------------------------


def profile_chunk(label, cfg, n_slots, prompt_lens, steps, rng,
                  freeze=False):
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.substrate import calibrate_model
    from repro_torch.launch.serve import Engine, Request
    from repro_torch.models import init_params

    params = init_params(cfg, seed=0, device="cuda")
    if freeze:  # the frozen calibration of the serve CLI's --imc-policy
        ref = np.random.default_rng(1).integers(0, cfg.vocab_size,
                                                (2, max(prompt_lens)))
        cfg = calibrate_model(cfg, params, [ref])
    rnp = np.random.default_rng(0)
    engine = Engine(cfg, params, n_slots, max(prompt_lens) + 4 * steps + 8,
                    rng=rng, max_chunk=steps)
    reqs = [Request(rid=i, prompt=rnp.integers(0, cfg.vocab_size, n),
                    max_new=4 * steps) for i, n in enumerate(prompt_lens)]
    engine.admit_pending(reqs)
    engine.decode_chunk(steps)  # warm: every shape of the chunk seen once
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.decode_chunk(steps)
    torch.cuda.synchronize()
    plain_wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.decode_chunk(steps)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device kernels only: operator rows repeat their kernels' time
    rows = [(e.self_device_time_total / 1e3, e.count, e.key)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows)
    (OUT / f"profile_{label}.txt").write_text(prof.key_averages().table(
        sort_by="self_device_time_total", row_limit=40))
    top = "; ".join(f"{k[:48]} {ms:.2f} ms x{n}" for ms, n, k in rows[:6])
    say("profile", f"{label}: {steps}-step chunk, {n_slots} slots: "
        f"{plain_wall_ms / steps:.2f} ms/step without the profiler; with it "
        f"wall {wall_ms:.1f} ms, device kernels {busy_ms:.1f} ms (busy "
        f"share {busy_ms / wall_ms:.3f}); top: {top}")


def phase_profile():
    from repro_torch import configs
    from repro_torch.core.design import optimize
    from repro_torch.core.imc_linear import IMCConfig
    from repro_torch.core.substrate import substrate_for_design
    from repro_torch.kernels import prng

    cfg = configs.get("musicgen-medium")
    profile_chunk("digital", cfg, 8, [16, 512, 64, 300, 128, 33, 480, 256],
                  8, None)
    cfg = cfg.replace(imc=IMCConfig(mode="imc_bitserial", bx=7, bw=7,
                                    v_wl=0.7))
    profile_chunk("imc_bitserial", cfg, 4, [5, 9, 32, 4], 4,
                  prng.derive_seed(0, 7))
    # the overload serve's substrate: ladder level 0 of --degrade, frozen
    pt = optimize(n=512, snr_t_target_db=26.0, kinds=("qr",))
    cfg = cfg.replace(imc=substrate_for_design(pt))
    profile_chunk("imc_analytic", cfg, 8, [5, 9, 32, 4, 17, 6, 12, 8], 4,
                  None, freeze=True)


def phase_tiles(dev):
    """Instantiations of the analytic kernel's tile template, ``launch<BM,
    BN, BK, TM, TN>`` of ``csrc/analytic.cu``, timed against each other at
    every site shape, B = 8 and 512, with the QR 26 dB ADC and noise.  One
    library holds them all (a source that includes analytic.cu, built with
    the kernels' flags); each one's output must equal the shipped kernel's
    bit for bit (every thread sums K in the same order whatever the tile),
    and the configurations are timed in the order A B ... B A."""
    import ctypes

    import torch

    from repro_torch.core.design import optimize
    from repro_torch.kernels import build, imc_mvm, ref

    names = [f"tile_{bm}x{bn}x{bk}_{tm}x{tn}"
             for bm, bn, bk, tm, tn in TILE_CONFIGS]
    args = ("const float* x, const float* w, float* out, int B, int K, "
            "int M, int has_noise, uint32_t seed, float sigma, int apply_adc,"
            " float adc_delta, float code_lo, float code_hi, void* stream")
    src = OUT / "analytic_tiles.cu"
    src.write_text('#include "analytic.cu"\n' + "".join(
        f'extern "C" int {n}({args}) {{\n  return launch<{bm}, {bn}, {bk}, '
        f"{tm}, {tn}>(x, w, out, B, K, M, has_noise, seed, sigma, apply_adc,"
        f" adc_delta, code_lo, code_hi, (cudaStream_t)stream);\n}}\n"
        for n, (bm, bn, bk, tm, tn) in zip(names, TILE_CONFIGS)))
    lib_path = OUT / "libanalytic_tiles.so"
    proc = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-I",
                           str(build.CSRC), "-o", str(lib_path), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}"
                           f"{proc.stderr}")
    lib = ctypes.CDLL(str(lib_path))
    fns = []
    for n in names:
        fn = getattr(lib, n)
        fn.argtypes = build._SIGNATURES["analytic"][1]
        fn.restype = ctypes.c_int
        fns.append(fn)

    pt = optimize(n=512, snr_t_target_db=26.0, kinds=("qr",))
    spec = ref.AnalyticSpec(b_adc=pt.b_adc,
                            sigma_out=10.0 ** (-pt.snr_a_db / 20.0),
                            y_clip=4.0)
    half = 2.0 ** (spec.b_adc - 1)
    seed = 1234
    gen = torch.Generator(device=dev).manual_seed(2)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for b in (8, 512):
        for k, m in SITE_SHAPES:
            xs, wc = analytic_operands(gen, b, k, m, pt, dev)
            shipped = imc_mvm.imc_analytic_matmul(xs, wc, spec, seed=seed)
            out = torch.empty_like(shipped)

            def call(fn):
                err = fn(xs.data_ptr(), wc.data_ptr(), out.data_ptr(), b, k,
                         m, 1, ctypes.c_uint32(seed), spec.sigma_out, 1,
                         2.0 * spec.y_clip / 2.0**spec.b_adc, -half, half - 1,
                         stream)
                if err != 0:
                    raise RuntimeError(f"tile launch failed: {err}")

            for n, fn in zip(names, fns):
                out.zero_()
                call(fn)
                if not torch.equal(out, shipped):
                    raise AssertionError(f"{n} at {b}x{k}x{m} differs from "
                                         f"the shipped kernel")
            order = list(range(len(fns))) + list(range(len(fns)))[::-1]
            times = {n: [] for n in names}
            for i in order:
                times[names[i]].append(time_ms(lambda: call(fns[i])))
            say("tiles", f"{b}x{k}x{m}: " + "; ".join(
                f"{n} " + " / ".join(f"{t:.4f}" for t in ts) + " ms"
                for n, ts in times.items()) + " (outputs equal the shipped "
                "kernel's bit for bit)")


# ---------------------------------------------------------------------------


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma list of {PHASES + EXTRA_PHASES}")
    args = ap.parse_args()
    phases = args.phases.split(",")
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke.py must run from a checkout of the repository "
              "(src/repro_torch not found)", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device visible to PyTorch", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    OUT.mkdir(parents=True, exist_ok=True)
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    t_all = time.perf_counter()

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    say("device", f"{smi} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | {count} device(s)")

    from repro_torch.kernels import build

    t = build.build_all()
    if build.build_log:  # empty when every library was already built
        (OUT / "kernel_build.log").write_text("\n\n".join(
            f"== {n}\n{log}" for n, log in build.build_log.items()))
    say("build", f"{len(build.SOURCES)} kernel libraries ready in {t:.1f} s "
        f"(nvcc -gencode arch=compute_90a,code=sm_90a; ptxas report in "
        f"build/chip_smoke/kernel_build.log)")
    for n, log in build.build_log.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                say("build", f"{n}: {line.strip()}")

    kernels = []
    if "kernels" in phases:
        kernels = [check_paged_attention(dev), *check_bitserial(dev),
                   check_analytic(dev)]
    counts = {}
    if "design" in phases:
        reset_counts()
        counts["analytic"] = phase_design(dev)
    if "serve" in phases:
        counts.update(phase_serve())
    for k in kernels:  # None where the phase that counts it did not run
        k["launches"] = counts.get(k["name"])
    if "parity" in phases:
        phase_parity(dev)
    if "profile" in phases:
        phase_profile()
    if "tiles" in phases:
        phase_tiles(dev)
    say("done", f"all phases passed in {time.perf_counter() - t_all:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
