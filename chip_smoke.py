#!/usr/bin/env python3
"""Quickest proof that the PyTorch + CUDA port starts on the GPU.

  python3 chip_smoke.py            # all phases, one card
  python3 chip_smoke.py --phases device,build,kernels

Phases, each reported on its own line:
  1 device   the card's name and power limit (nvidia-smi);
  2 build    the CUDA kernels, compiled from the sources in this checkout;
  3 kernels  each kernel against its plain PyTorch version on the card, at the
             main path's full-width shapes, with its device time (calls
             replayed from a CUDA graph), the plain version's time, a library
             call's time where one computes the same function (also from a
             graph), and the least time the card could take (bound);
  4 design   the layer-scale design study, the analytic kernels' path: every
             matmul shape of musicgen-medium at 512 rows through
             ``ops.imc_matmul(mode="imc_analytic")`` at each billed QR and CM
             design point (the int8 kernel), delivered SNR_T against the
             design's prediction, and one 10-bit call (the float32 kernel);
  5 serve    full-width musicgen-medium (48 layers, d_model 1536, bf16,
             seeded random weights) served by the engine on the digital
             substrate (metered, with the energy table), the bit-serial IMC
             substrate, and a 2x bursty overload on the analytic substrate
             with deadline scheduling, lazy KV, preemption and frontier
             degradation; prefix-sharing traffic (a 256-token shared prompt
             in a pool tight enough to evict, against the same run cold,
             then whole cached prompts that copy-on-write); drift injection
             on the frozen analytic substrate (shadow sampling, detection,
             hot-swap, SNR_T recovery, ms per sampled and unsampled step);
             and faults (a transient decode error retried to the same
             tokens, a refused kernel launch that escapes the engine);
             counting the kernels' launches;
  6 parity   the SMOKE config in float32: the engine on the card against the
             same engine on the CPU, greedy tokens identical (for the
             overload run, identical SLO counters); warm prefix admissions
             (copy-on-write included) against cold ones and card against CPU
             on the three substrates; CI serve smokes 3 (drift) and 5
             (prefix) card against CPU, with identical scoreboards, drift
             counters and drifted sites.  On the analytic substrate tokens
             may differ only at exact ties of the LM head's ADC-quantized
             logits.
  7 bench    the port's benchmark suite on the card
             (``repro_torch.benchmarks.run``: the paper figures with their
             Monte Carlo overlays, the pareto table, the per-site SNR map and
             the kernel bench, which runs the frozen seed bit-serial kernel
             beside the port's; phase 3 holds each kernel it times against
             its plain version on the same inputs), counting the seed
             wrapper's calls (graph-captured calls once each); then the
             MC convergence sweep (S_A - E_A and S_T - S_A at the reference's
             512-row QS, QR and CM points and its 128-row QR and 64-row CM
             points, ensembles of 600 to 10^6 under 8 generator seeds).
Optional: ``--phases ...,profile``, a torch.profiler trace of one decode
chunk of each full-width substrate (the analytic one also shadow-sampled)
and of one warm prefix admission - device kernel time by name against the
wall time (summary printed, tables under build/chip_smoke/);
``--phases ...,tiles``, the analytic kernel's tile instantiations
(``TILE_CONFIGS``) timed against each other at every site shape;
``--phases device,host``, the paged-attention wrapper's host cost per call
(``--src DIR`` runs any phase on another checkout's package and kernels,
e.g. ``git archive`` of the parent commit: processes alternating between
the two checkouts time them against each other; the timers are that
package's ``benchmarks.kernel_bench.device_ms`` and ``device_eager_ms``).
The line before the last is a JSON object with every kernel's numbers; the
last line is ``{"ok": true, "device": {...}}``.  Any failure raises and exits
non-zero; without a CUDA device, or outside a checkout of the repository,
the script exits non-zero before printing a result.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "build" / "chip_smoke"  # logs and profiler tables (git-ignored)
PHASES = ("device", "build", "kernels", "design", "serve", "parity",
          "bench")
# not run by default: a profiler trace of one decode chunk per substrate
EXTRA_PHASES = ("profile", "tiles", "host")

# NVIDIA H100 SXM published peaks (data sheet, dense), used for the bounds
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
F32_FLOPS_PER_S = 67e12
F64_TC_FLOPS_PER_S = 67e12  # FP64 on the tensor cores

MIXED_LENS = [4, 6, 48, 5, 8, 44, 6, 7]
# slots of the full-width bit-serial serve (phase 5) and its kernel check
BITSERIAL_SLOTS = 4
# the full-width overload serve (phase 5): 8 slots whose full provisioning is
# 8 * 7 + 1 = 57 KV blocks; 20 makes lazy allocation preempt
OVERLOAD_SLOTS, OVERLOAD_REQUESTS, OVERLOAD_GEN, OVERLOAD_KV_BLOCKS = 8, 24, 16, 20
# the full-width prefix-sharing serve (phase 5): 16 requests over 8 slots
# behind a 256-token shared prompt, in a 90-block pool that must evict
PREFIX_SLOTS, PREFIX_REQUESTS, PREFIX_SHARED = 8, 16, 256
PREFIX_KV_BLOCKS = 90
# matmul shapes of musicgen-medium (K, M): attention, MLP in, MLP out, head
SITE_SHAPES = ((1536, 1536), (1536, 6144), (6144, 1536), (1536, 2048))
# (BM, BN, BK, TM, TN) instantiations of the analytic kernel's tile template
# timed against each other by the optional tiles phase
TILE_CONFIGS = ((64, 64, 16, 4, 4), (8, 64, 32, 1, 4))


def say(phase: str, msg: str):
    print(f"[{phase}] {msg}", flush=True)


def wall_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds per eager call (CUDA events around a run of calls):
    the device time, or the host's time to issue the call where that is
    longer (``kernel_bench.device_eager_ms``)."""
    from repro_torch.benchmarks import kernel_bench

    return kernel_bench.device_eager_ms(fn, iters, warmup)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device milliseconds per call: ``iters`` calls captured in one
    CUDA graph, replayed between CUDA events; raises unless the graph holds
    a kernel per call (``kernel_bench.device_ms``)."""
    from repro_torch.benchmarks import kernel_bench

    return kernel_bench.device_ms(fn, iters, warmup)


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

    # the kernel bench's paged shapes, on the very inputs it times
    # (``kernel_bench.paged_operands``: float32 pools, every slot active)
    from repro_torch.benchmarks import kernel_bench as kb

    for shape in kb.PAGED_SHAPES:
        q3, kn3, vn3, pk3, pv3, bt3, pos3, sc3 = kb.paged_operands(shape, dev)
        c3k, a3k, b3k = pa.paged_attention_decode(
            q3, kn3, vn3, pk3.clone(), pv3.clone(), bt3, pos3, scale=sc3)
        c3p, a3p, b3p = pa.decode_plain(q3, kn3, vn3, pk3.clone(),
                                        pv3.clone(), bt3, pos3, scale=sc3)
        if not torch.allclose(c3k, c3p, rtol=1e-5, atol=1e-5) or not (
                torch.equal(a3k[1:], a3p[1:])
                and torch.equal(b3k[1:], b3p[1:])):
            raise AssertionError(f"paged attention at the bench's {shape} "
                                 "differs: max abs "
                                 f"{float((c3k - c3p).abs().max())}")
        say("kernels", f"paged_attention at the bench's (slots, blocks, "
            f"block, kv heads, groups, head dim) {shape}: max abs "
            f"{float((c3k - c3p).abs().max()):.3e}, pools equal")

    for _ in range(2):  # the splits' merge order is fixed: the same bits
        again, _, _ = pa.paged_attention_decode(q, kn, vn, pk.clone(),
                                                pv.clone(), bt, pos, active,
                                                scale=scale)
        if not torch.equal(again, ctx_k):
            raise AssertionError("paged attention does not repeat bit for "
                                 "bit")
    # a decode step meets each layer's pools cold: rotate over 4 pool pairs
    # (4 x 102 MB) so no call finds the previous one's rows in the 50 MB L2
    pools = [(pk.clone(), pv.clone()) for _ in range(4)]
    turn = iter(range(10**9))

    def kernel_call():
        pk_r, pv_r = pools[next(turn) % len(pools)]
        pa.paged_attention_decode(q, kn, vn, pk_r, pv_r, bt, pos, active,
                                  scale=scale)

    ms = time_ms(kernel_call)
    eager_ms = wall_ms(kernel_call)
    plain_ms = wall_ms(lambda: pa.decode_plain(
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
    say("kernels", f"paged_attention: max_abs_err={err:.3e} (repeats bit "
        f"for bit) ms={ms:.4f} (eager call {eager_ms:.4f}) plain_ms="
        f"{plain_ms:.4f} library_ms(sdpa)="
        f"{library_ms:.4f} bound_ms={max(t_bytes, t_ops):.5f}; "
        f"{nbytes / 1e9:.2f} GB moved at {nbytes / ms / 1e9:.3f} TB/s, "
        f"{max(t_bytes, t_ops) / ms:.1%} of the bound")
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


def bitserial_fp64_ceiling(plane_rows, k, m, bw):
    """Milliseconds of the gain instantiation's stacked plane product, a
    (plane_rows, K) @ (K, Bw * M) float64 product, at the FP64 tensor-core
    peak of 67 TFLOP/s."""
    return 2 * plane_rows * k * bw * m / F64_TC_FLOPS_PER_S * 1e3


def check_bitserial(dev):
    """Every bit-serial shape of the bit-serial serve's decode step, at its 4
    slots and knobs (7x7 bits, 256-row banks, b_adc 10): the projections
    1536->1536 (wq, wk, wv, wo), 1536->6144 and 6144->1536 (MLP) and the LM
    head 1536->2048.  Each without noise and gain (exact), with gain but no
    noise (exact) and with seeded noise and per-cell gain (at most 0.1% of
    elements may differ by a code).
    The serve path runs the projections with noise and gain (the kernel's
    gain instantiation) and the LM head without (its other instantiation):
    those two are the rows of the kernels line.  Their ``ms`` is the whole
    wrapper call, code casts included, as the serve pays it; ``kernel_ms``
    the kernel alone on operands already in its layout (uint8 codes, f32
    gain), whose result must equal the wrapper's bit for bit.  Each shape's
    line adds the FP64 tensor-core ceiling of the plane product, with the
    plane rows padded to the kernel's 32-row tiles and with the live ones."""
    import torch

    from repro_torch.core.imc_linear import IMCConfig
    from repro_torch.kernels import build, imc_mvm, ops, ref

    imc = IMCConfig(mode="imc_bitserial", bx=7, bw=7, v_wl=0.7)
    gen = torch.Generator(device=dev).manual_seed(1)
    # the C arguments of operands already in the kernel's layout; a checkout
    # without this helper (``--src``) has its whole wrapper calls timed only
    c_args = getattr(imc_mvm, "bitserial_c_args", None)
    b = BITSERIAL_SLOTS
    worst = {True: 0.0, False: 0.0}
    ms, kernel_ms = {}, {}
    for k, m in SITE_SHAPES:
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
        x8, w8 = imc_mvm._code_bytes(xc), imc_mvm._code_bytes(wc)
        fracs, notes = {}, {}
        # without gain and noise (the LM head's instantiation), with gain
        # but no noise (checked only), with both (the projections')
        for g, seed in ((None, None), (gain, None), (gain, 4242)):
            y_k = imc_mvm.imc_bitserial_matmul(xc, wc, g, spec, seed=seed)
            y_p = ref.imc_bitserial_ref(xc, wc, g, spec, seed=seed)
            torch.cuda.synchronize()
            diff = (y_k - y_p).abs()
            frac = float((diff > 0).float().mean())
            if seed is None and frac > 0:
                raise AssertionError(
                    f"bitserial ({k}x{m}, gain {g is not None}) noiseless "
                    f"differs: max abs {float(diff.max())}")
            if seed is None and g is not None:
                continue
            if frac > 1e-3 or float(diff.max()) > step:
                raise AssertionError(
                    f"bitserial ({k}x{m}) with noise and gain: {frac:.2e} of "
                    f"elements differ (limit 1e-3), max {float(diff.max())}")
            worst[g is not None] = max(worst[g is not None],
                                       float(diff.max()))
            fracs[g is not None] = frac
            key = (k, m, g is not None)
            ms[key] = time_ms(lambda: imc_mvm.imc_bitserial_matmul(
                xc, wc, g, spec, seed=seed))
            alone = ""
            if c_args is not None:
                out = torch.empty((b, m), dtype=torch.float32, device=dev)

                def kernel_call(g=g, seed=seed, out=out):
                    err = build.library("bitserial").imc_bitserial_matmul(
                        *c_args(x8, w8, g, out, spec, spec.rows, seed))
                    if err != 0:
                        raise RuntimeError(f"bitserial launch failed: {err}")

                kernel_ms[key] = time_ms(kernel_call)
                torch.cuda.synchronize()
                if not torch.equal(out, y_k):
                    raise AssertionError(f"bitserial ({k}x{m}): the kernel "
                                         "alone and the wrapper differ")
                alone = f" (kernel alone {kernel_ms[key]:.4f})"
            bound, by = bitserial_bound(b, k, m, spec.bw * spec.bx,
                                        g is not None)
            notes[g is not None] = (f"ms={ms[key]:.4f}{alone}, "
                                    f"bound_ms={bound:.5f} ({by})")
        rows_p = 32 * -(-b // (32 // spec.bx))
        padded = bitserial_fp64_ceiling(rows_p, k, m, spec.bw)
        live = bitserial_fp64_ceiling(b * spec.bx, k, m, spec.bw)
        shares = ("" if c_args is None else
                  f" (kernel alone at {padded / kernel_ms[(k, m, True)]:.1%}"
                  f" / {live / kernel_ms[(k, m, True)]:.1%} of them)")
        say("kernels", f"bitserial {b}x{k}x{m} rows={spec.rows} "
            f"b_adc={spec.b_adc}: without noise and gain exact, "
            f"{notes[False]}; with gain and no noise exact; with noise and "
            f"gain {fracs[True]:.2e} of elements differ, {notes[True]}; FP64 "
            f"tensor-core ceiling {padded:.5f} ms at {rows_p} plane rows, "
            f"{live:.5f} ms at the {b * spec.bx} live ones{shares}")
        if (k, m) == (1536, 6144):  # the gain row's shape (MLP wi)
            main_gain = (xc, wc, gain, spec)
        if (k, m) == (1536, 2048):  # the no-gain row's shape (LM head)
            main_lm = (xc, wc, spec)

    xc, wc, gain, spec = main_gain
    gain_plain_ms = wall_ms(lambda: ref.imc_bitserial_ref(
        xc, wc, gain, spec, seed=4242), iters=3, warmup=1)
    bits = spec.bw * spec.bx
    gain_bound, gain_by = bitserial_bound(b, 1536, 6144, bits, True)
    xc, wc, spec = main_lm
    lm_plain_ms = wall_ms(lambda: ref.imc_bitserial_ref(xc, wc, None, spec),
                          iters=3, warmup=1)
    lm_bound, lm_by = bitserial_bound(b, 1536, 2048, bits, False)

    # the kernel's share of one decode step: 48 layers of four 1536->1536
    # projections and the two MLP projections with gain, one LM head without
    def step_ms(t):
        return 48 * (4 * t[(1536, 1536, True)] + t[(1536, 6144, True)]
                     + t[(6144, 1536, True)]) + t[(1536, 2048, False)]

    say("kernels", f"bitserial with noise and gain at {b}x1536x6144: "
        f"ms={ms[(1536, 6144, True)]:.4f} plain_ms={gain_plain_ms:.4f} "
        f"bound_ms={gain_bound:.5f} ({gain_by}); without, LM head "
        f"{b}x1536x2048: ms={ms[(1536, 2048, False)]:.4f} "
        f"plain_ms={lm_plain_ms:.4f} bound_ms={lm_bound:.5f} ({lm_by}); "
        f"wrapper calls of one {b}-slot decode step (289 launches): "
        f"{step_ms(ms):.2f} ms"
        + (f", kernel alone {step_ms(kernel_ms):.2f} ms" if kernel_ms else ""))
    common = {"route": "cuda",
              "source": "src/repro_torch/kernels/csrc/bitserial.cu",
              "replaces": "src/repro/kernels/imc_mvm.py:140",
              "library_ms": None}
    return [dict(common, name="bitserial", max_abs_err=worst[True],
                 ms=ms[(1536, 6144, True)],
                 kernel_ms=kernel_ms.get((1536, 6144, True)),
                 plain_ms=gain_plain_ms, bound_ms=gain_bound,
                 bound_by=gain_by, shape=f"{b}x1536x6144, noise and gain"),
            dict(common, name="bitserial_nogain", max_abs_err=worst[False],
                 ms=ms[(1536, 2048, False)],
                 kernel_ms=kernel_ms.get((1536, 2048, False)),
                 plain_ms=lm_plain_ms, bound_ms=lm_bound, bound_by=lm_by,
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
            plain_ms = wall_ms(lambda: ref.imc_analytic_ref(xs, wc, spec,
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


def int8_bound(b, k, m):
    """(bound_ms, bound_by) of one int8 analytic call: int8 x and w and the
    f32 output (and sigma_yo) moved once over the HBM rate, or the 2 B K M
    int8 operations of the code product over the int8 tensor-core peak."""
    t_bytes = (b * k + k * m + 4 * b * m + 4) / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * b * k * m / INT8_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def check_analytic_int8(dev):
    """The int8 codes route at every musicgen-medium site shape, B = 8 and
    512, at the QR 26 dB design point (unsigned activation codes of its bx
    bits, signed weight codes of its bw, sigma_yo of the first 8 rows' code
    product as ``ops.imc_matmul`` makes it), seeded noise and the ADC.
    Held to the same tolerance as the float32 kernel against its plain
    version (at most 0.1% of outputs one ADC step apart; without the ADC
    allclose(rtol 1e-5, atol 1e-5 * max|y|); the noise alone within 3 ulp of
    sigma_out * z at one shape).  Timed on operands already in int8, (M, K),
    against the float32 SIMT kernel (``csrc/analytic.cu``) on the same codes
    in the order A B B A, against ``torch.matmul`` of the float32 operands
    (product only) and, where it takes the shape (B > 16), ``torch._int_mm``
    of the int8 codes (product only, the x bytes read as int8)."""
    import torch

    from repro_torch.core.design import optimize
    from repro_torch.kernels import imc_mvm, ref

    pt = optimize(n=512, snr_t_target_db=26.0, kinds=("qr",))
    spec = ref.AnalyticSpec(b_adc=pt.b_adc,
                            sigma_out=10.0 ** (-pt.snr_a_db / 20.0),
                            y_clip=4.0)
    raw = ref.AnalyticSpec(b_adc=spec.b_adc, sigma_out=spec.sigma_out,
                           y_clip=spec.y_clip, apply_adc=False)
    step = 2 * spec.y_clip / 2**spec.b_adc
    seed = 1234
    kw = dict(bx=pt.bx, bw=pt.bw, x_signed=False)
    gen = torch.Generator(device=dev).manual_seed(4)
    worst, row = 0.0, None
    for b in (8, 512):
        for k, m in SITE_SHAPES:
            x = torch.rand((b, k), generator=gen, device=dev)
            w = torch.rand((k, m), generator=gen, device=dev) * 2 - 1
            xc, _ = ref.quantize_codes(x, pt.bx, False, x.abs().max())
            wc, _ = ref.quantize_codes(w, pt.bw, True, w.abs().max())
            sig = (xc[:8] @ wc).std(unbiased=False) + 1e-9
            xs = ref.true_div(xc, sig)
            y_k = imc_mvm.imc_analytic_codes_matmul(xc, wc, sig, spec,
                                                    seed=seed, **kw)
            r_k = imc_mvm.imc_analytic_codes_matmul(xc, wc, sig, raw,
                                                    seed=seed, **kw)
            y_p = ref.imc_analytic_ref(xs, wc, spec, seed=seed)
            r_p = ref.imc_analytic_ref(xs, wc, raw, seed=seed)
            torch.cuda.synchronize()
            diff = (y_k - y_p).abs()
            frac = float((diff > 1e-6).float().mean())
            if float(diff.max()) > step + 1e-6 or frac >= 1e-3:
                raise AssertionError(
                    f"analytic_int8 {b}x{k}x{m}: {frac:.2e} of outputs "
                    f"differ (limit 1e-3), max {float(diff.max())} (limit "
                    f"{step})")
            atol = 1e-5 * float(r_p.abs().max())
            if not torch.allclose(r_k, r_p, rtol=1e-5, atol=atol):
                raise AssertionError(
                    f"analytic_int8 {b}x{k}x{m} without the ADC differs: max "
                    f"abs {float((r_k - r_p).abs().max())}")
            if (b, k, m) == (8, 6144, 1536):  # the longest K, fewest rows
                clean = imc_mvm.imc_analytic_codes_matmul(xc, wc, sig, raw,
                                                          **kw)
                z = spec.sigma_out * ref.analytic_output_noise(seed, b, m,
                                                               device=dev)
                eps = torch.finfo(torch.float32).eps
                if not bool(((r_k - clean - z).abs()
                             <= 3 * eps * (z.abs() + r_k.abs())).all()):
                    raise AssertionError("analytic_int8 noise differs from "
                                         "sigma_out * z by more than 3 ulp")
                if not torch.equal(y_k, imc_mvm.imc_analytic_codes_matmul(
                        xc, wc, sig, spec, seed=seed, **kw)):
                    raise AssertionError("analytic_int8 does not repeat bit "
                                         "for bit")
            worst = max(worst, float(diff.max()))
            x8 = xc.to(torch.uint8)
            w8 = wc.t().contiguous().to(torch.int8)
            sig1 = sig.reshape(1)

            def int8_call():
                imc_mvm.analytic_int8_cuda(x8, w8, sig1, spec, seed=seed)

            def simt_call():
                imc_mvm.imc_analytic_matmul(xs, wc, spec, seed=seed)

            t_i8, t_simt = [], []
            for fn, acc in ((int8_call, t_i8), (simt_call, t_simt),
                            (simt_call, t_simt), (int8_call, t_i8)):
                acc.append(time_ms(fn))
            ms, simt_ms = sum(t_i8) / 2, sum(t_simt) / 2
            eager_ms = wall_ms(lambda: imc_mvm.imc_analytic_codes_matmul(
                xc, wc, sig, spec, seed=seed, **kw))
            plain_ms = wall_ms(lambda: ref.imc_analytic_ref(
                ref.true_div(xc, sig), wc, spec, seed=seed))
            mm_ms = time_ms(lambda: torch.matmul(xs, wc))
            int_mm_ms = None
            if b > 16:
                x8s, w8t = x8.view(torch.int8), w8.t()
                int_mm_ms = time_ms(lambda: torch._int_mm(x8s, w8t))
            bound, by = int8_bound(b, k, m)
            if not (ms < min(t_simt)):
                raise AssertionError(
                    f"analytic_int8 {b}x{k}x{m}: {t_i8} ms is not faster "
                    f"than the SIMT kernel's {t_simt} ms")
            say("kernels", f"analytic_int8 {b}x{k}x{m} bx={pt.bx} bw="
                f"{pt.bw} b_adc={spec.b_adc} tile=64x"
                f"{imc_mvm.int8_tile(b, m)}: {frac:.2e} of outputs differ, max_abs_err="
                f"{float(diff.max()):.3e}; ms={t_i8[0]:.4f}/{t_i8[1]:.4f} "
                f"(eager codes-route call with its casts {eager_ms:.4f}) "
                f"simt_ms={t_simt[0]:.4f}/{t_simt[1]:.4f} (A B B A) "
                f"plain_ms={plain_ms:.4f} library_ms(torch.matmul f32, "
                f"product only)={mm_ms:.4f} torch._int_mm_ms="
                + ("n/a" if int_mm_ms is None else f"{int_mm_ms:.4f}")
                + f" bound_ms={bound:.5f} ({by}, {bound / ms:.1%} of it)")
            if (b, k, m) == (512, 1536, 6144):
                row = {"name": "analytic_int8", "route": "cuda",
                       "source": "src/repro_torch/kernels/csrc/"
                                 "analytic_int8.cu",
                       "replaces": "src/repro/kernels/imc_mvm.py:284",
                       "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                       "bound_by": by, "library_ms": mm_ms,
                       "int_mm_ms": int_mm_ms, "simt_ms": simt_ms,
                       "shape": f"{b}x{k}x{m}, noise and ADC"}
    row["max_abs_err"] = worst
    return row


def seed_bound(b, k, m, bits, n_banks, noisy):
    """(bound_ms, bound_by) of one seed bit-serial call: int8 codes read
    once, the float32 noise operand (n_banks, bits, B, M) read once, the
    float32 output written once; the plane products as one multiply-add (2
    operations) per (b, k, m) and plane pair at the int8 rate, as
    ``bitserial_bound`` counts the same plane products without gain."""
    nbytes = (k * m + b * k + 4 * b * m
              + (4 * n_banks * bits * b * m if noisy else 0))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * bits * b * k * m / INT8_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def check_seed_bitserial(dev):
    """The frozen seed bit-serial kernel (the kernel bench's baseline)
    against its plain version at the bench's three ``SHAPES``, on the very
    inputs the bench times (``kernel_bench.bitserial_operands``: 8-bit ADC,
    banks of min(512, K) rows, k_h 60, v_c 55, noise std 0.3), and at the
    main path's bit-serial shape, (4, 1536) @ (1536, 6144) at 7x7 bits,
    256-row banks, 10-bit ADC and the thermal noise in counts of
    musicgen-medium's bit-serial substrate, the noise operand drawn from a
    CUDA generator.  Bit-exact with and without noise (the same operand, exact
    plane counts, the plain version's rounding and order).  Its noiseless
    output is ``bitserial.cu``'s noiseless, gain-free output (the same
    function, its float32 terms summed in another order): allclose(rtol 0,
    atol ``kernel_bench.order_atol``, 8 float32 ulps of the largest partial
    sum in the seed's order).  At the bench's shapes ``bitserial.cu`` is
    also held, with noise and without gain at the bench's counter-hash seed
    (its ``kernel_noise`` config), against ``ref.imc_bitserial_ref`` under
    phase 3's rule: at most 0.1% of outputs differ, none by more than one
    step of the heaviest plane pair.  Times at the main shape: ``ms`` the
    whole wrapper call with noise (casts, layout, the two pack passes and
    the main kernel), ``kernel_ms`` the entry point alone on operands in its
    layout, and ``ms_nonoise`` the wrapper without noise."""
    import torch

    from repro_torch.benchmarks import kernel_bench as kb
    from repro_torch.core.imc_linear import IMCConfig
    from repro_torch.kernels import build, imc_mvm, ops, ref

    cases = [(shape, kb.bitserial_operands(shape, dev))
             for shape in kb.SHAPES]
    mc = ops.matmul_config_from_imc(
        IMCConfig(mode="imc_bitserial", bx=7, bw=7, v_wl=0.7), 1536)
    spec = ref.BitSerialSpec(bx=7, bw=7, b_adc=mc.b_adc, rows=mc.rows,
                             k_h=mc.k_h_counts, v_c=mc.v_c_counts,
                             x_signed=True)
    gen = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn((BITSERIAL_SLOTS, 1536), generator=gen, device=dev)
    w = torch.randn((1536, 6144), generator=gen, device=dev)
    xc, _ = ref.quantize_codes(x, spec.bx, True, x.abs().max())
    wc, _ = ref.quantize_codes(w, spec.bw, True, w.abs().max())
    noise = mc.sigma_thermal_counts * torch.randn(
        (-(-1536 // spec.rows), spec.bw * spec.bx, BITSERIAL_SLOTS, 6144),
        generator=gen, device=dev)
    cases.append(((BITSERIAL_SLOTS, 1536, 6144, 7, 7),
                  (xc, wc, noise, spec, spec)))
    worst = 0.0  # against the plain version, with and without noise
    for (b, k, m, bx, bw), (xc, wc, noise, spec, spec_noisy) in cases:
        for nz in (None, noise):
            y_k = kb.seed_bitserial_matmul(xc, wc, nz, spec)
            y_p = kb.seed_bitserial_plain(xc, wc, nz, spec)
            torch.cuda.synchronize()
            worst = max(worst, float((y_k - y_p).abs().max()))
            if not torch.equal(y_k, y_p):
                raise AssertionError(
                    f"seed_bitserial {b}x{k}x{m} (noise {nz is not None}) "
                    f"differs from its plain version: "
                    f"{float((y_k != y_p).float().mean()):.2e} of outputs, "
                    f"max abs {float((y_k - y_p).abs().max())}")
        y_new = imc_mvm.imc_bitserial_matmul(xc, wc, None, spec)
        y_seed = kb.seed_bitserial_matmul(xc, wc, None, spec)
        err = float((y_seed - y_new).abs().max())
        atol = kb.order_atol(xc, wc, spec)
        if not torch.allclose(y_seed, y_new, rtol=0, atol=atol):
            raise AssertionError(
                f"seed_bitserial {b}x{k}x{m}: the noiseless output is not "
                f"bitserial.cu's (max abs {err} against {atol}, 8 ulps of "
                f"the largest partial sum)")
        noisy = ""
        if spec_noisy is not spec:  # the bench's kernel_noise config
            y_k = imc_mvm.imc_bitserial_matmul(xc, wc, None, spec_noisy,
                                               seed=kb.NOISE_SEED)
            y_p = ref.imc_bitserial_ref(xc, wc, None, spec_noisy,
                                        seed=kb.NOISE_SEED)
            diff = (y_k - y_p).abs()
            frac = float((diff > 0).float().mean())
            step = spec.v_c / 2**spec.b_adc * 2 ** (spec.bw + spec.bx)
            if frac > 1e-3 or float(diff.max()) > step:
                raise AssertionError(
                    f"bitserial {b}x{k}x{m} with noise, no gain: {frac:.2e} "
                    f"of outputs differ (limit 1e-3), max "
                    f"{float(diff.max())} (step {step})")
            noisy = (f"; bitserial.cu with noise (seed {kb.NOISE_SEED}) "
                     f"against its plain version: {frac:.2e} of outputs "
                     f"differ, max {float(diff.max()):.3e}")
        say("kernels", f"seed_bitserial {b}x{k}x{m} {spec.bx}x{spec.bw} "
            f"rows={spec.rows} b_adc={spec.b_adc}: bit-exact with and "
            f"without noise; noiseless against bitserial.cu's: max abs "
            f"{err:.3e} (atol {atol:.3e}){noisy}")

    # the main shape: the last case's operands
    ms = time_ms(lambda: kb.seed_bitserial_matmul(xc, wc, noise, spec))
    ms_nonoise = time_ms(lambda: kb.seed_bitserial_matmul(xc, wc, None, spec))
    x8, w8, rows_p = kb.seed_layout(xc, wc, spec.rows)
    xp, wp = kb.seed_scratch(x8, w8, spec)
    out = torch.empty((BITSERIAL_SLOTS, 6144), dtype=torch.float32,
                      device=dev)

    def kernel_call():
        err = build.library("seed_bitserial").seed_bitserial_matmul(
            *kb.seed_c_args(x8, w8, noise, xp, wp, out, spec, rows_p))
        if err != 0:
            raise RuntimeError(f"seed_bitserial launch failed: {err}")

    kernel_ms = time_ms(kernel_call)
    torch.cuda.synchronize()
    if not torch.equal(out, kb.seed_bitserial_matmul(xc, wc, noise, spec)):
        raise AssertionError("seed_bitserial: the kernel alone and the "
                             "wrapper differ")
    plain_ms = wall_ms(lambda: kb.seed_bitserial_plain(xc, wc, noise, spec),
                       iters=3, warmup=1)
    bits = spec.bw * spec.bx
    n_banks = -(-1536 // spec.rows)
    bound, by = seed_bound(BITSERIAL_SLOTS, 1536, 6144, bits, n_banks, True)
    bound_clean, by_clean = seed_bound(BITSERIAL_SLOTS, 1536, 6144, bits,
                                       n_banks, False)
    say("kernels", f"seed_bitserial at {BITSERIAL_SLOTS}x1536x6144 with "
        f"noise: ms={ms:.4f} (kernel alone {kernel_ms:.4f}) "
        f"plain_ms={plain_ms:.4f} bound_ms={bound:.5f} ({by}, "
        f"{bound / kernel_ms:.1%} of it for the kernel alone); without "
        f"noise ms={ms_nonoise:.4f} bound_ms={bound_clean:.5f} ({by_clean})")
    return {"name": "seed_bitserial", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/seed_bitserial.cu",
            "replaces": "benchmarks/kernel_bench.py:66",
            "launches_are": "wrapper calls in the bench phase, warm-up and "
                            "graph-captured (graph replays uncounted); each "
                            "call is 3 kernels",
            "max_abs_err": worst, "ms": ms, "kernel_ms": kernel_ms,
            "ms_nonoise": ms_nonoise, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": by, "library_ms": None,
            "shape": f"{BITSERIAL_SLOTS}x1536x6144, noise operand"}


# ---------------------------------------------------------------------------
# phase 4: the design study at layer scale, the analytic kernel's path
# ---------------------------------------------------------------------------


def phase_design(dev):
    """Each billed QR and CM design point (min-energy at SNR_T 14 and 26 dB,
    512-row banks) runs every distinct (K, M) of musicgen-medium's matmul
    sites through ``ops.imc_matmul(mode="imc_analytic")`` on the card at
    B = 512, with operands of the design's statistics (x uniform in [0, 1),
    w uniform in [-1, 1)).  Prints the delivered SNR_T beside the design's
    SNR_T and SNR_a, and asserts the paper's bound SNR_T <= SNR_a + 1.5 dB.
    Every billed point has codes of 6 or 8 bits, so every call launches the
    int8 kernel once; one more call with 10-bit codes takes the float32
    kernel, as the width rule says.  Returns those launch counts.  Then
    times one whole ``ops.imc_matmul`` call per shape at the QR 26 dB point
    (after the launches are read, so the timing's launches do not count)."""
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
    # codes wider than 8 bits (assign_precisions allows up to 16) take the
    # float32 kernel: one call at the QR 26 dB point's ADC with 10-bit codes
    wide = ops.IMCMatmulConfig(mode="imc_analytic", bx=10, bw=10,
                               b_adc=timed_cfg.b_adc,
                               snr_a_db=timed_cfg.snr_a_db, x_signed=False)
    k, m = shapes[0]
    x = torch.rand((512, k), generator=gen, device=dev)
    w = torch.rand((k, m), generator=gen, device=dev) * 2 - 1
    y = ops.imc_matmul(x, w, wide, seed=calls + 1)
    if not bool(torch.isfinite(y).all()):
        raise AssertionError("design: the 10-bit call gave non-finite values")
    counts = read_counts()
    launches = {"analytic_int8": counts["analytic_int8"],
                "analytic": counts["analytic"]}
    if launches != {"analytic_int8": calls, "analytic": 1}:
        raise AssertionError(f"design: launches {launches} for {calls} calls "
                             "of at most 8 bits and one of 10 bits")
    say("design", f"launches: {launches} ({calls} calls of 6- or 8-bit "
        "codes on the int8 route, one of 10-bit codes on the float32 one)")
    timed = []
    for k, m in shapes:
        x = torch.rand((512, k), generator=gen, device=dev)
        w = torch.rand((k, m), generator=gen, device=dev) * 2 - 1
        ms = wall_ms(lambda: ops.imc_matmul(x, w, timed_cfg, seed=1),
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
    imc_mvm.analytic_int8_cuda.launches = 0


def read_counts():
    from repro_torch.kernels import imc_mvm, paged_attention

    bs = imc_mvm.bitserial_cuda
    return {"paged_attention": paged_attention.paged_attention_cuda.launches,
            "bitserial": bs.gain_launches,
            "bitserial_nogain": bs.launches - bs.gain_launches,
            "analytic": imc_mvm.analytic_cuda.launches,
            "analytic_int8": imc_mvm.analytic_int8_cuda.launches}


def serve_run(label, argv, n_layers, vocab):
    """Serve through the CLI entry point and check what came out: no failed
    request, tokens in the vocabulary (every request's full ``max_new``
    unless it ran a workload with early stops), one paged-attention launch
    per layer and decode step (warm prefix admissions' suffix steps
    included), and - when metered - a finite J/token at every billed design
    point."""
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
    steps = eng.decode_steps + eng.warm_steps
    if counts["paged_attention"] != n_layers * steps:
        raise AssertionError(
            f"{label}: {counts['paged_attention']} paged-attention launches "
            f"for {eng.decode_steps} decode and {eng.warm_steps} warm steps "
            f"of {n_layers} layers")
    meter = rep["meter"]
    if meter is not None:
        if meter.billed_tokens <= 0 or not rep["energy"] or not all(
                math.isfinite(e.j_per_token) for e in rep["energy"]):
            raise AssertionError(f"{label}: energy report incomplete: "
                                 f"{[e.summary() for e in rep['energy']]}")
    say("serve", f"{label}: {len(fin)} requests, {rep['tokens']} tokens in "
        f"{rep['seconds']:.2f} s, {rep['tok_s']:.1f} tok/s, mean TTFT "
        f"{rep['ttft_ms']:.1f} ms, {eng.decode_steps} decode steps, "
        f"{eng.warm_steps} warm steps, {eng.prefill_calls} prefills, "
        f"launches {counts} ({counts['paged_attention'] / max(steps, 1):.0f} "
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


def prefix_argv(cache: bool):
    """Shared-system-prompt traffic: a 256-token prompt shared by every
    request, tails of 8..40 tokens, in a KV pool (90 blocks) too small to
    keep every finished request's cached blocks, so admissions evict."""
    return ["--arch", "musicgen-medium", "--batch", str(PREFIX_SLOTS),
            "--requests", str(PREFIX_REQUESTS), "--prompt-lens",
            "8,24,16,40,12,32", "--shared-prefix-len", str(PREFIX_SHARED),
            "--gen", "16", "--chunk", "8", "--kv-blocks",
            str(PREFIX_KV_BLOCKS), "--energy-report", "--seed", "0",
            "--prefix-cache" if cache else "--no-prefix-cache"]


def serve_prefix(n_layers, vocab):
    """Prefix-sharing serving at full width: the same argv cold and warm,
    then whole cached prompts through the engine API (the shared prefix
    alone, twice), which copy-on-write its last block on the card.  Checks
    hits, copies, evictions, the allocator's conservation, the billed
    saving and the launches of the warm suffix steps."""
    from repro_torch.launch.serve import Request, serve

    cold_counts, cold = serve_run("prefix cold", prefix_argv(False),
                                  n_layers, vocab)
    warm_counts, warm = serve_run("prefix warm", prefix_argv(True), n_layers,
                                  vocab)
    eng = warm["engine"]
    shared = warm["finished"][0].prompt[:PREFIX_SHARED]
    steps0 = eng.decode_steps + eng.warm_steps
    reset_counts()
    dups = [Request(rid=PREFIX_REQUESTS + i, prompt=shared.copy(), max_new=4)
            for i in range(2)]
    for r in dups:
        serve(eng, [r])
    dup_counts = read_counts()
    steps = eng.decode_steps + eng.warm_steps - steps0
    if dup_counts["paged_attention"] != n_layers * steps:
        raise AssertionError(f"prefix: {dup_counts} launches for {steps} "
                             f"decode and warm steps")
    ps = eng.prefix_stats()
    a = eng.alloc
    referenced = {b for blocks in eng._slot_blocks for b in blocks}
    bad = [r.rid for r in eng.finished if r.error is not None]
    if (ps["hits"] <= 0 or ps["cow_copies"] < 1 or ps["evictions"] < 1
            or bad or dups[0].out != dups[1].out
            or a.free_count + len(referenced) + a.evictable_count
            != a.num_blocks - 1
            or a.used_count != len(referenced) + a.evictable_count
            or warm["meter"].prefix_saved_billed_tokens <= 0):
        raise AssertionError(
            f"prefix: scoreboard {ps}, failed {bad}, copies' tokens "
            f"{[r.out for r in dups]}, free {a.free_count} referenced "
            f"{len(referenced)} idle {a.evictable_count} of "
            f"{a.num_blocks - 1}, saved billed tokens "
            f"{warm['meter'].prefix_saved_billed_tokens}")
    cold_out = {r.rid: r.out for r in cold["finished"]}
    same = sum(t == u for r in warm["finished"] if r.rid in cold_out
               for t, u in zip(r.out, cold_out[r.rid]))
    total = sum(len(o) for o in cold_out.values())
    say("serve", f"prefix: warm {warm['tok_s']:.1f} tok/s, mean TTFT "
        f"{warm['ttft_ms']:.1f} ms; cold {cold['tok_s']:.1f} tok/s, mean "
        f"TTFT {cold['ttft_ms']:.1f} ms; {same} of {total} warm tokens equal "
        f"the cold ones; scoreboard {ps}; billed prefill tokens "
        f"{warm['meter'].prefill_billed_tokens} warm, "
        f"{cold['meter'].prefill_billed_tokens} cold (saved "
        f"{warm['meter'].prefix_saved_billed_tokens}); pool free "
        f"{a.free_count} + referenced {len(referenced)} + idle cached "
        f"{a.evictable_count} = {a.num_blocks - 1}; copy-on-write "
        f"admissions' launches {dup_counts}")
    return [cold_counts, warm_counts, dup_counts]


DRIFT_ARGV = ["--arch", "musicgen-medium", "--batch", "4", "--requests", "8",
              "--prompt-lens", "5,9,32,4,17,6,12,20", "--gen", "16",
              "--chunk", "4", "--imc-mode", "imc_analytic", "--imc-policy",
              "frozen", "--inject-drift", "2.5@4", "--seed", "0"]
DRIFT_FLAGS = ["--recalibrate", "--drift-sample-every", "1",
               "--drift-check-every", "1"]


@contextlib.contextmanager
def chunk_log():
    """Records each decode chunk of the engines made inside (device ms with
    a synchronize on each side, steps, bytes to the host), each drift check
    (``(monitor.chunks_seen, report)``) and the index of the first chunk
    after an ``--inject-drift`` weight shift."""
    import torch

    from repro_torch.launch import serve as serve_mod
    from repro_torch.runtime import drift as drift_lib

    log = {"chunks": [], "checks": [], "injected": []}
    decode_chunk = serve_mod.Engine.decode_chunk
    check, scale_wi = drift_lib.DriftMonitor.check, serve_mod._scale_wi

    def timed(self, n_steps=None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        block = decode_chunk(self, n_steps)
        torch.cuda.synchronize()
        if block.shape[1]:
            log["chunks"].append(((time.perf_counter() - t0) * 1e3,
                                  block.shape[1], block.nbytes))
        return block

    def logged(self, frozen):
        rep = check(self, frozen)
        if rep is not None:
            log["checks"].append((self.chunks_seen, rep))
        return rep

    def marked(p, scale):
        log["injected"].append(len(log["chunks"]))
        return scale_wi(p, scale)

    serve_mod.Engine.decode_chunk = timed
    drift_lib.DriftMonitor.check = logged
    serve_mod._scale_wi = marked
    try:
        yield log
    finally:
        serve_mod.Engine.decode_chunk = decode_chunk
        drift_lib.DriftMonitor.check = check
        serve_mod._scale_wi = scale_wi


def serve_drift(n_layers, vocab):
    """Drift injection at full width on the frozen analytic substrate: the
    run with every chunk shadow-sampled and checked against the same run
    unsampled.  Checks detection at the mlp sites within ``sample_every *
    check_every`` chunks of the shift, a swap, the recovery gap (at most
    1 dB, the reference's bound) and one equal host transfer per chunk."""
    runs = {}
    for label, argv in (("drift unsampled", DRIFT_ARGV),
                        ("drift sampled", DRIFT_ARGV + DRIFT_FLAGS)):
        with chunk_log() as log:
            counts, rep = serve_run(label, argv, n_layers, vocab)
        runs[label] = counts, rep, log
    _, base, base_log = runs["drift unsampled"]
    _, rep, log = runs["drift sampled"]
    eng, mon = rep["engine"], rep["monitor"]
    after = log["injected"][0]
    bound = mon.cfg.sample_every * mon.cfg.check_every
    hits = [(chunk, r.drifted_sites) for chunk, r in log["checks"]
            if chunk > after and {"mlp.wi", "mlp.wo"} & set(r.drifted_sites)]
    if not hits or hits[0][0] - after > bound:
        seen = [(c, r.drifted_sites) for c, r in log["checks"]]
        raise AssertionError(f"drift: no mlp-site drift within {bound} "
                             f"chunks of the shift after chunk {after}: "
                             f"{seen}")
    gaps = [r["recovery_gap_db"] for r in rep["snr_rows"]
            if r["x_max_observed"] > r["x_max_frozen"]]
    if eng.swap_count < 1 or not gaps or max(map(abs, gaps)) > 1.0:
        raise AssertionError(f"drift: {eng.swap_count} swaps, recovery gaps "
                             f"{gaps} dB")
    per_chunk = [b for _, _, b in log["chunks"]]
    if (per_chunk != [b for _, _, b in base_log["chunks"]]
            or any(b != 4 * eng.batch_slots * n
                   for _, n, b in log["chunks"])
            or eng.host_transfer_bytes != base["engine"].host_transfer_bytes):
        raise AssertionError(f"drift: host transfers per chunk differ: "
                             f"{per_chunk} vs {base_log['chunks']}")

    def ms_per_step(chunks):
        return sum(ms for ms, _, _ in chunks) / sum(n for _, n, _ in chunks)

    say("serve", f"drift: {mon.counters()}, {eng.swap_count} swaps; first "
        f"mlp-site drift at chunk {hits[0][0]}, the shift after chunk "
        f"{after}; drifted sites {hits[0][1]}; recovery gaps "
        f"{[round(g, 4) for g in gaps]} dB; "
        f"{ms_per_step(log['chunks']):.2f} ms per sampled step (check "
        f"included), {ms_per_step(base_log['chunks']):.2f} ms per unsampled "
        f"step; {len(per_chunk)} chunks, {sum(per_chunk)} host-transfer "
        f"bytes in each run")
    return [counts for counts, _, _ in runs.values()]


class RefusedLaunch:
    """Stands in for a kernel library whose entry point refuses every
    launch (returns CUDA error 1), counting the calls."""

    def __init__(self, lib, entry):
        self.lib, self.calls = lib, 0
        setattr(self, entry, self.refuse)

    def refuse(self, *args):
        self.calls += 1
        return 1

    def kernel_error_string(self, err):
        return self.lib.kernel_error_string(err)


def serve_faults():
    """Faults at full width on the digital substrate: a transient error
    injected before one decode chunk is retried to the uninjected run's
    tokens; a refused paged-attention launch escapes the engine at once,
    unretried, with no request retired."""
    import numpy as np

    from repro_torch import configs
    from repro_torch.kernels import build
    from repro_torch.launch.serve import Engine, Request, serve
    from repro_torch.models import init_params
    from repro_torch.runtime.fault import TransientDeviceError

    cfg = configs.get("musicgen-medium")
    params = init_params(cfg, seed=0, device="cuda")

    def requests():
        rnp = np.random.default_rng(5)
        return [Request(rid=i, prompt=rnp.integers(0, cfg.vocab_size, n),
                        max_new=8) for i, n in enumerate((5, 17, 9, 30))]

    reset_counts()
    clean = Engine(cfg, params, 4, 64, max_chunk=4)
    want = {r.rid: r.out for r in serve(clean, requests())}
    hits = []

    def injector(phase, info):
        if phase == "decode" and info == 1 and not hits:
            hits.append(info)
            raise TransientDeviceError("injected before decode chunk 1")

    eng = Engine(cfg, params, 4, 64, max_chunk=4, failure_injector=injector)
    got = {r.rid: r.out for r in serve(eng, requests())}
    counts = read_counts()
    steps = clean.decode_steps + eng.decode_steps
    if (not hits or got != want or eng.decode_failures
            or counts["paged_attention"] != cfg.n_layers * steps):
        raise AssertionError(f"faults: injected {hits}, tokens {got} vs "
                             f"{want}, {eng.decode_failures} failed chunks, "
                             f"launches {counts} for {steps} steps")
    real = build.library("paged_attention")
    refused = RefusedLaunch(real, "paged_attention_decode")
    eng = Engine(cfg, params, 4, 64, max_chunk=4)
    eng.admit_pending(requests())
    build._loaded["paged_attention"] = refused
    try:
        eng.decode_chunk()
    except build.KernelLaunchError as e:
        escaped = e
    else:
        raise AssertionError("faults: a refused launch did not escape")
    finally:
        build._loaded["paged_attention"] = real
    if refused.calls != 1 or eng.failed_requests or eng.decode_failures:
        raise AssertionError(f"faults: the refused launch was tried "
                             f"{refused.calls} times; {eng.failed_requests} "
                             f"requests retired")
    say("serve", f"faults: a transient decode error retried to the same "
        f"{sum(map(len, got.values()))} tokens (launches {counts}); a "
        f"refused launch escaped the engine after 1 call, unretried: "
        f"{escaped}")
    return [counts]


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
    runs = [digital, bitserial, overload, *serve_prefix(n_layers, vocab),
            *serve_drift(n_layers, vocab), *serve_faults()]
    counts = {k: sum(c[k] for c in runs) for k in digital
              if not k.startswith("analytic")}
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
    prefix_parity(dev)
    cli_parity(dev)


class TokenProbe:
    """Records the logits behind every token an engine emits, keyed by
    (request id, token index), with the frontier level (index into
    ``ladder``; 0 without one) the engine was at.  With ``force`` ({key:
    token}), each forced token is made the greedy pick after its logits are
    recorded, so the engine follows a given token stream (teacher forcing
    through the engine's own prefill, warm prefill and decode path)."""

    def __init__(self, eng, ladder, force=None):
        self.eng, self.ladder, self.force = eng, ladder, force
        self.logits, self.level = {}, {}
        self.rows, self.step, self.skip, self.head = [], 0, 0, None
        # which rows hold which request, set where a prefill group, a warm
        # prefill or a decode chunk starts: (row, request, index of the
        # row's next token); a warm prefill's suffix steps before its last
        # one emit nothing
        run_chunk, admit_group = eng._run_chunk, eng._admit_group
        try_prefix, warm = eng._try_admit_prefix, eng._warm_prefill

        def _run_chunk(n_steps, active, key):
            self.start([(i, r) for i, r in enumerate(eng.slots)
                        if r is not None])
            return run_chunk(n_steps, active, key)

        def _admit_group(group, slot_ids, bucket):
            self.start(list(enumerate(group)))
            return admit_group(group, slot_ids, bucket)

        def _try_admit_prefix(req, slot):
            self.head = req
            return try_prefix(req, slot)

        def _warm_prefill(slot, bt_row, suffix, start, key):
            self.start([(slot, self.head)], skip=len(suffix) - 1)
            return warm(slot, bt_row, suffix, start, key)

        eng._run_chunk, eng._admit_group = _run_chunk, _admit_group
        eng._try_admit_prefix, eng._warm_prefill = (_try_admit_prefix,
                                                    _warm_prefill)

    def start(self, rows, skip=0):
        self.rows = [(i, r, len(r.out)) for i, r in rows]
        self.step, self.skip = 0, skip

    def emit(self, logits):
        """Called with each (rows, 1, V) logits block the engine argmaxes."""
        level = 0
        if self.ladder is not None:
            designs = [sub.design for sub in self.ladder]
            level = designs.index(self.eng.substrate.design)
        step = self.step - self.skip
        self.step += 1
        if step < 0:
            return logits
        bump = []
        for i, req, idx in self.rows:
            key = (req.rid, idx + step)
            row = logits[i, -1].float().cpu()
            self.logits[key], self.level[key] = row, level
            if self.force is not None and key in self.force:
                bump.append((i, self.force[key], float(row.max()) + 1.0))
        if bump:
            logits = logits.clone()
            for i, tok, top in bump:
                logits[i, -1, tok] = top
        return logits


@contextlib.contextmanager
def probing(ladder=None, force=None):
    """Every engine made inside carries a :class:`TokenProbe` (yielded in
    order of creation) that sees each logits block it argmaxes."""
    from repro_torch.launch import serve as serve_mod

    probes = []
    base = serve_mod.Engine
    model_prefill, model_decode = serve_mod.prefill, serve_mod.decode_step

    class Probed(base):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            probes.append(TokenProbe(self, ladder, force))

    def prefill(*a, **k):
        logits, cache = model_prefill(*a, **k)
        return probes[-1].emit(logits), cache

    def decode_step(*a, **k):
        logits, cache = model_decode(*a, **k)
        return probes[-1].emit(logits), cache

    serve_mod.Engine = Probed
    serve_mod.prefill, serve_mod.decode_step = prefill, decode_step
    try:
        yield probes
    finally:
        serve_mod.Engine = base
        serve_mod.prefill, serve_mod.decode_step = (model_prefill,
                                                    model_decode)


def tie_parity(label, run_a, run_b, ties: bool, strict: bool = False):
    """Hold run A's tokens against run B's.  Each ``run(force)`` returns
    ({rid: tokens}, counters (a JSON string), probe).  Token counts must
    match, and the counters (before any forcing, when ``strict``).  Where
    tokens differ and ``ties`` (the analytic substrate: its MPC ADC makes
    the LM head's logits multiples of one code, so two tokens can tie
    exactly and another summation order breaks the tie the other way), B
    runs again forced through the engine onto A's tokens: it must reproduce
    them and A's counters, and at every token A's pick must be B's greedy
    pick on the same history and frontier level, or the two picks' logits
    must be exactly equal in A or in B.  Every token is compared."""
    import torch

    out_a, cnt_a, probe_a = run_a(None)
    out_b, cnt_b, _ = run_b(None)
    lens_a = {rid: len(o) for rid, o in out_a.items()}
    lens_b = {rid: len(o) for rid, o in out_b.items()}
    if lens_a != lens_b:
        raise AssertionError(f"{label}: request lengths differ, {lens_a} vs "
                             f"{lens_b}")
    if strict and cnt_a != cnt_b:
        raise AssertionError(f"{label}: counters {cnt_a} != {cnt_b}")
    n_tok = sum(lens_b.values())
    if out_a == out_b and cnt_a == cnt_b:
        return f"all {n_tok} tokens and the counters identical ({cnt_a})"
    if not ties:
        raise AssertionError(f"{label}: tokens or counters differ: {out_a} "
                             f"{cnt_a} vs {out_b} {cnt_b}")
    force = {(rid, i): t for rid, o in out_a.items() for i, t in enumerate(o)}
    out_f, cnt_f, probe_b = run_b(force)
    if out_f != out_a or cnt_f != cnt_a:
        raise AssertionError(f"{label}: the run forced onto the other's "
                             f"tokens did not reproduce them or its "
                             f"counters: {out_f} {cnt_f} vs {out_a} {cnt_a}")
    tied = []
    for key, tok in sorted(force.items()):
        lb, la = probe_b.logits[key], probe_a.logits[key]
        if probe_b.level[key] != probe_a.level[key]:
            raise AssertionError(f"{label}: token {key} was emitted at "
                                 f"frontier level {probe_a.level[key]} and "
                                 f"{probe_b.level[key]}")
        mine = int(torch.argmax(lb))  # B's greedy pick
        if mine == tok:
            continue
        if lb[tok] == lb[mine]:
            where = "B"
        elif la[tok] == la[mine]:
            where = "A"
        else:
            raise AssertionError(
                f"{label}: request {key[0]} token {key[1]} (frontier level "
                f"{probe_a.level[key]}) is {tok} in A, where B picks {mine} "
                f"on the same history; logits B {float(lb[tok])!r} vs "
                f"{float(lb[mine])!r}, A {float(la[tok])!r} vs "
                f"{float(la[mine])!r}")
        tied.append(f"request {key[0]} token {key[1]} at level "
                    f"{probe_a.level[key]}: A {tok}, B {mine}, logits "
                    f"exactly equal in {where} ({float(lb[mine])!r})")
    same = sum(out_a[r] == out_b[r] for r in out_b)
    return (f"counters identical ({cnt_a}); tokens identical for {same} of "
            f"{len(out_b)} requests; forced onto A's tokens, B picks A's "
            f"token at {n_tok - len(tied)} of {n_tok} tokens and the rest "
            f"are exact ties: {'; '.join(tied)}")


def overload_parity(dev):
    """The overload path on SMOKE in float32, card (A) against CPU (B): the
    same workload, scheduler, pool and frontier ladder as phase 5's
    overload run.  The virtual clock makes every SLO counter a function of
    the seed, so they must match exactly; tokens under the tie rule."""
    import numpy as np

    from repro_torch import configs
    from repro_torch.core.design import optimize
    from repro_torch.core.substrate import (
        calibrate_model,
        substrate_for_design,
        substrate_ladder,
    )
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models import init_params
    from repro_torch.models.model import tree_map
    from repro_torch.runtime.workload import VirtualClock, make_overload_config

    pt = optimize(n=512, snr_t_target_db=26.0, kinds=("qr",))
    ladder = substrate_ladder(pt, steps=2)
    cfg = configs.get_smoke("musicgen-medium")
    cfg = cfg.replace(imc=substrate_for_design(pt))
    params_cpu = init_params(cfg, seed=0, device="cpu")
    params_gpu = tree_map(lambda t: t.to(dev), params_cpu)
    ref = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 32))
    cfg = calibrate_model(cfg, params_cpu, [ref])
    wcfg = make_overload_config(
        n_requests=OVERLOAD_REQUESTS, seed=0, overload=2.0,
        slots=OVERLOAD_SLOTS, max_new=OVERLOAD_GEN, arrival="bursty")

    def overload(params):
        def run(force):
            with probing(ladder, force) as probes:
                eng = serve_mod.Engine(
                    cfg, params, OVERLOAD_SLOTS, 32 + OVERLOAD_GEN + 8,
                    max_chunk=4, kv_blocks=OVERLOAD_KV_BLOCKS,
                    alloc_policy="lazy", clock=VirtualClock())
                fin, summary = serve_mod.serve_workload(eng, wcfg,
                                                        "deadline", ladder)
            return ({r.rid: r.out for r in fin},
                    json.dumps(summary, sort_keys=True), probes[-1])
        return run

    say("parity", "SMOKE float32 overload, card against CPU: " + tie_parity(
        "overload", overload(params_gpu), overload(params_cpu), ties=True,
        strict=True))


def prefix_parity(dev):
    """Warm prefix admissions on SMOKE in float32, on the three substrates:
    a shared 16-token prompt over five requests, then a whole cached
    16-token prompt twice (copy-on-write).  Warm against cold on the card,
    and warm on the card against warm on the CPU with the same prefix
    scoreboard; on the analytic substrate under the tie rule."""
    import numpy as np

    from repro_torch import configs
    from repro_torch.core.imc_linear import IMCConfig
    from repro_torch.core.substrate import calibrate_model
    from repro_torch.launch import serve as serve_mod
    from repro_torch.models import init_params
    from repro_torch.models.model import tree_map

    for mode in ("digital", "imc_analytic", "imc_bitserial"):
        cfg = configs.get_smoke("musicgen-medium")
        params_cpu = init_params(cfg, seed=0, device="cpu")
        if mode != "digital":
            cfg = cfg.replace(imc=IMCConfig(mode=mode, bx=7, bw=7, v_wl=0.7))
            ref = np.random.default_rng(1).integers(0, cfg.vocab_size,
                                                    (2, 24))
            cfg = calibrate_model(cfg, params_cpu, [ref])
        params_gpu = tree_map(lambda t: t.to(dev), params_cpu)

        def runner(params, cache, counters=True):
            def run(force):
                rnp = np.random.default_rng(3)
                shared = rnp.integers(0, cfg.vocab_size, 16)
                reqs = [serve_mod.Request(
                    rid=i, max_new=5, prompt=np.concatenate(
                        [shared, rnp.integers(0, cfg.vocab_size, n)]))
                    for i, n in enumerate((5, 9, 3, 12, 7))]
                reqs += [serve_mod.Request(rid=5 + i, prompt=shared.copy(),
                                           max_new=5) for i in range(2)]
                with probing(None, force) as probes:
                    eng = serve_mod.Engine(cfg, params, batch_slots=4,
                                           cache_len=48, max_chunk=4,
                                           prefix_cache=cache)
                    for group in (reqs[:1], reqs[1:5], reqs[5:6], reqs[6:]):
                        serve_mod.serve(eng, group)
                if any(r.error for r in eng.finished):
                    raise AssertionError(f"prefix {mode}: failed requests")
                ps = eng.prefix_stats()
                if cache and (ps["hits"] != 6 or ps["cow_copies"] != 2):
                    raise AssertionError(f"prefix {mode}: scoreboard {ps}")
                return ({r.rid: r.out for r in eng.finished},
                        json.dumps(ps, sort_keys=True) if counters else "",
                        probes[-1])
            return run

        ties = mode == "imc_analytic"
        warm_cold = tie_parity(f"prefix {mode} warm vs cold",
                               runner(params_gpu, True, False),
                               runner(params_gpu, False, False), ties)
        card_cpu = tie_parity(f"prefix {mode} card vs CPU",
                              runner(params_gpu, True),
                              runner(params_cpu, True), ties, strict=True)
        say("parity", f"SMOKE float32 prefix {mode} (6 hits, 2 "
            f"copy-on-write): warm against cold on the card: {warm_cold}; "
            f"warm on the card against the CPU: {card_cpu}")


CI_SMOKE3 = ["--arch", "musicgen-medium", "--smoke", "--batch", "4", "--gen",
             "8", "--requests", "6", "--prompt-lens", "5,9,32,4,17,6",
             "--imc-mode", "imc_analytic", "--imc-policy", "frozen",
             "--recalibrate", "--drift-sample-every", "1",
             "--drift-check-every", "1", "--inject-drift", "2.5@3"]
CI_SMOKE5 = ["--arch", "musicgen-medium", "--smoke", "--batch", "4", "--gen",
             "8", "--requests", "8", "--prompt-lens", "4,24,48,6,8,40,5,16",
             "--prefix-cache", "--shared-prefix-len", "16", "--imc-mode",
             "imc_analytic", "--imc-policy", "frozen", "--energy-report"]


def cli_parity(dev):
    """CI serve smokes 3 (drift injection) and 5 (prefix cache) through the
    CLI, card (A) against CPU (B), with the same CPU-made weights: tokens
    under the tie rule, and the prefix scoreboard, billed counts, drift
    counters and each check's drifted sites identical."""
    import io

    from repro_torch.launch import serve as serve_mod
    from repro_torch.models.model import tree_map

    init = serve_mod.init_params

    def runner(argv, device):
        def run(force):
            def params_via_cpu(cfg, seed=0, device=None):
                return tree_map(lambda t: t.to(device),
                                init(cfg, seed=seed, device="cpu"))

            serve_mod.init_params = params_via_cpu
            try:
                with probing(None, force) as probes, chunk_log() as log, \
                        contextlib.redirect_stdout(io.StringIO()):
                    rep = serve_mod.main(argv + ["--device", device])
            finally:
                serve_mod.init_params = init
            eng, meter, mon = rep["engine"], rep["meter"], rep["monitor"]
            if any(r.error for r in rep["finished"]):
                raise AssertionError(f"{argv}: failed requests")
            counters = {
                "prefix": eng.prefix_stats(),
                "billed": None if meter is None else [
                    meter.prefill_billed_tokens, meter.decode_billed_tokens,
                    meter.prefix_saved_billed_tokens],
                "drift": None if mon is None else mon.counters(),
                "drifted": [[c, list(r.drifted_sites)]
                            for c, r in log["checks"]],
                "swaps": eng.swap_count}
            return ({r.rid: r.out for r in rep["finished"]},
                    json.dumps(counters, sort_keys=True), probes[-1])
        return run

    for name, argv in (("CI smoke 3 (drift)", CI_SMOKE3),
                       ("CI smoke 5 (prefix)", CI_SMOKE5)):
        say("parity", f"SMOKE float32 {name}, card against CPU: "
            + tie_parity(name, runner(argv, "cuda"), runner(argv, "cpu"),
                         ties=True))


# ---------------------------------------------------------------------------
# phase 7: the port's benchmark suite and the MC convergence sweep
# ---------------------------------------------------------------------------

BENCH_SUITES = ["fig4", "fig9", "fig10", "fig11", "fig12", "fig13", "pareto",
                "site_snr", "kernel"]


def phase_bench(dev):
    """``repro_torch.benchmarks.run``'s suites on the card, in-process
    (report under build/chip_smoke/bench.json), counting the seed kernel's
    launches; then the MC convergence sweep (``paper_figures.mc_convergence``:
    the reference's 512-row QS, QR and CM points and its 128-row QR and
    64-row CM points; ensembles of 600 to 10^6 under 8 generator seeds).  Checks: every number finite; each MC
    overlay within 3.5 dB of its closed form (the widest band of the
    reference's MC tests); the kernel summaries' noise and gathered-KV
    reductions above 1; per point, the spread over seeds smaller at 10^6
    than at 600."""
    import math

    import torch

    from repro_torch.benchmarks import kernel_bench as kb
    from repro_torch.benchmarks import paper_figures
    from repro_torch.benchmarks import run as bench_run

    reset_counts()
    kb.seed_bitserial_cuda.launches = 0
    t0 = time.perf_counter()
    lines = []
    payload = bench_run.run_suites(BENCH_SUITES, dev, out=lines.append)
    launches = {"seed_bitserial": kb.seed_bitserial_cuda.launches,
                **read_counts()}
    (OUT / "bench.json").write_text(json.dumps(payload, indent=1,
                                               sort_keys=True) + "\n")
    (OUT / "bench.csv").write_text("\n".join(lines) + "\n")

    def numbers(rec):
        return [v for v in rec.values()
                if isinstance(v, (int, float)) and not isinstance(v, bool)]

    for name, suite in payload["suites"].items():
        bad = [r for r in suite["records"]
               if not all(math.isfinite(v) for v in numbers(r))]
        if bad or not suite["records"]:
            raise AssertionError(f"bench suite {name}: no records or a "
                                 f"number that is not finite: {bad[:2]}")
    for fig in paper_figures.MC_FIGS:
        for r in payload["suites"][fig]["records"]:
            if "/S_snrA_" in r["name"]:  # derived: "E=<closed form> ..."
                e_a = float(r["derived"].split("E=")[1].split()[0])
                if abs(r["value"] - e_a) > 3.5:
                    raise AssertionError(f"bench MC overlay {r['name']}: S "
                                         f"{r['value']} vs E {e_a}")
                say("bench", f"{r['name']}: S_A {r['value']} dB, E_A {e_a} "
                    "dB")
    kernel = payload["suites"]["kernel"]["records"]
    for r in kernel:
        if r["bench"] == "bitserial_summary":
            if not r["noise_bytes_reduction"] > 1:
                raise AssertionError(f"bench kernel summary: {r}")
            say("bench", f"bitserial B{r['B']} K{r['K']} M{r['M']} "
                f"{r['bx']}x{r['bw']}: speedup over the seed "
                f"{r['speedup_vs_seed']:.2f} (noise "
                f"{r['speedup_vs_seed_noise']:.2f}), noise bytes "
                f"{r['noise_bytes_before']} -> {r['noise_bytes_after']}")
        elif r["bench"] == "paged_attention_summary":
            if not r["gathered_kv_reduction"] > 1:
                raise AssertionError(f"bench kernel summary: {r}")
            say("bench", f"paged S{r['slots']} N{r['blocks']}: speedup over "
                f"the gather path {r['speedup_vs_gather']:.2f}, gathered KV "
                f"{r['gathered_kv_bytes_before']} -> "
                f"{r['gathered_kv_bytes_after']} bytes")
        elif r["bench"] == "bitserial":
            say("bench", f"bitserial {r['config']} B{r['B']} K{r['K']} "
                f"M{r['M']}: {kb.ms_of(r):.4f} ms ({kb.time_key(r)})")
    if launches["seed_bitserial"] <= 0:
        raise AssertionError(f"bench: the seed kernel never launched: "
                             f"{launches}")
    t_suites = time.perf_counter() - t0
    say("bench", f"suites {','.join(BENCH_SUITES)} in {t_suites:.1f} s "
        f"(report build/chip_smoke/bench.json); wrapper calls counted "
        f"{launches} (3 warm-up and 20 graph-captured calls per timed "
        f"config; the graphs' replays run 40 more uncounted; a seed call is "
        f"3 kernels: pack_x, pack_w, main)")

    t1 = time.perf_counter()
    sweep = paper_figures.mc_convergence(dev)
    (OUT / "mc_convergence.json").write_text(json.dumps(sweep, indent=1)
                                             + "\n")
    for r in sweep:
        vals = [r[k] for k in ("gap_mean_db", "gap_std_db", "adc_mean_db",
                               "adc_std_db", "ms_per_ensemble")]
        if not all(math.isfinite(v) for v in vals):
            raise AssertionError(f"MC convergence: not finite: {r}")
        say("bench", f"MC {r['point']} ens={r['ens']} ({r['seeds']} "
            f"seeds): S_A-E_A {r['gap_mean_db']:+.3f} +- "
            f"{r['gap_std_db']:.3f} dB (E_A {r['e_a_db']:.2f}), S_T-S_A "
            f"{r['adc_mean_db']:+.3f} +- {r['adc_std_db']:.3f} dB, "
            f"{r['ms_per_ensemble']:.1f} ms per ensemble")
    for point in paper_figures.MC_POINTS:
        rs = [r for r in sweep if r["point"] == point]
        if not rs[-1]["gap_std_db"] < rs[0]["gap_std_db"]:
            raise AssertionError(f"MC convergence {point}: the spread over "
                                 f"seeds did not shrink: {rs}")
    say("bench", f"MC convergence sweep in {time.perf_counter() - t1:.1f} s "
        f"(build/chip_smoke/mc_convergence.json); peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    return {"seed_bitserial": launches["seed_bitserial"]}


# ---------------------------------------------------------------------------
# optional: where a decode step's time goes
# ---------------------------------------------------------------------------


def profiled(label, run, what, steps):
    """Time ``run()`` (after one warm call) without the profiler, then
    under it: device time summed over ``torch.profiler``'s kernel rows
    against the wall time; ``steps`` decode steps per call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run()  # warm: every shape of the call seen once
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    plain_wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device kernels only: operator rows repeat their kernels' time
    rows = [(e.self_device_time_total / 1e3, e.count, e.key)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows)
    paged = [r for r in rows if "paged_" in r[2]]  # split and combine passes
    (OUT / f"profile_{label.replace(' ', '_')}.txt").write_text(
        prof.key_averages().table(sort_by="self_device_time_total",
                                  row_limit=40))
    top = "; ".join(f"{k[:48]} {ms:.2f} ms x{n}" for ms, n, k in rows[:6])
    say("profile", f"{label}: {what}: {plain_wall_ms / steps:.2f} ms/step "
        f"without the profiler; with it wall {wall_ms:.1f} ms, device "
        f"kernels {busy_ms:.1f} ms (busy share {busy_ms / wall_ms:.3f}); "
        f"paged attention {sum(r[0] for r in paged):.2f} ms over "
        f"{max((r[1] for r in paged), default=0)} launches; top: {top}")


def profile_chunk(label, cfg, n_slots, prompt_lens, steps, rng,
                  freeze=False, sampled=False):
    """One decode chunk of ``n_slots`` requests; ``sampled``: every chunk
    shadow-recorded and checked by a drift monitor (no swaps)."""
    import numpy as np

    from repro_torch.core.substrate import calibrate_model
    from repro_torch.launch.serve import Engine, Request
    from repro_torch.models import init_params
    from repro_torch.runtime.drift import DriftConfig, DriftMonitor

    params = init_params(cfg, seed=0, device="cuda")
    if freeze:  # the frozen calibration of the serve CLI's --imc-policy
        ref = np.random.default_rng(1).integers(0, cfg.vocab_size,
                                                (2, max(prompt_lens)))
        cfg = calibrate_model(cfg, params, [ref])
    monitor = (DriftMonitor(DriftConfig(sample_every=1, check_every=1,
                                        auto_swap=False))
               if sampled else None)
    rnp = np.random.default_rng(0)
    engine = Engine(cfg, params, n_slots, max(prompt_lens) + 4 * steps + 8,
                    rng=rng, max_chunk=steps, drift_monitor=monitor)
    reqs = [Request(rid=i, prompt=rnp.integers(0, cfg.vocab_size, n),
                    max_new=4 * steps) for i, n in enumerate(prompt_lens)]
    engine.admit_pending(reqs)
    profiled(label, lambda: engine.decode_chunk(steps),
             f"{steps}-step chunk, {n_slots} slots", steps)


def profile_warm(cfg, tail=24):
    """One warm prefix admission beside seven slots mid-generation: a
    256-token cached prefix and a ``tail``-token suffix, prefilled as
    ``tail`` one-active-row decode steps."""
    import numpy as np

    from repro_torch.launch.serve import Engine, Request
    from repro_torch.models import init_params

    params = init_params(cfg, seed=0, device="cuda")
    rnp = np.random.default_rng(0)
    shared = rnp.integers(0, cfg.vocab_size, 256)

    def request(rid, max_new):
        return Request(rid=rid, max_new=max_new, prompt=np.concatenate(
            [shared, rnp.integers(0, cfg.vocab_size, tail)]))

    engine = Engine(cfg, params, 8, 512 + 64, max_chunk=8, prefix_cache=True)
    engine.admit_pending([request(i, 64) for i in range(7)])
    engine.decode_chunk(8)
    rids = iter(range(7, 100))
    hits = engine.prefix_hits
    profiled("prefix warm admission",
             lambda: engine.admit_pending([request(next(rids), 1)]),
             f"{tail}-token suffix beside 7 busy slots", tail)
    if engine.prefix_hits - hits != 3:
        raise AssertionError("the profiled admissions were not warm")


def phase_profile():
    from repro_torch import configs
    from repro_torch.core.design import optimize
    from repro_torch.core.imc_linear import IMCConfig
    from repro_torch.core.substrate import substrate_for_design
    from repro_torch.kernels import prng

    cfg = configs.get("musicgen-medium")
    profile_chunk("digital", cfg, 8, [16, 512, 64, 300, 128, 33, 480, 256],
                  8, None)
    profile_warm(cfg)
    bitserial = cfg.replace(imc=IMCConfig(mode="imc_bitserial", bx=7, bw=7,
                                          v_wl=0.7))
    profile_chunk("imc_bitserial", bitserial, 4, [5, 9, 32, 4], 4,
                  prng.derive_seed(0, 7))
    # the overload serve's substrate: ladder level 0 of --degrade, frozen
    pt = optimize(n=512, snr_t_target_db=26.0, kinds=("qr",))
    analytic = cfg.replace(imc=substrate_for_design(pt))
    lens = [5, 9, 32, 4, 17, 6, 12, 8]
    profile_chunk("imc_analytic", analytic, 8, lens, 4, None, freeze=True)
    profile_chunk("imc_analytic sampled", analytic, 8, lens, 4, None,
                  freeze=True, sampled=True)


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
    for b in (8, 512):
        for k, m in SITE_SHAPES:
            xs, wc = analytic_operands(gen, b, k, m, pt, dev)
            shipped = imc_mvm.imc_analytic_matmul(xs, wc, spec, seed=seed)
            out = torch.empty_like(shipped)

            def call(fn):
                err = fn(xs.data_ptr(), wc.data_ptr(), out.data_ptr(), b, k,
                         m, 1, ctypes.c_uint32(seed), spec.sigma_out, 1,
                         2.0 * spec.y_clip / 2.0**spec.b_adc, -half, half - 1,
                         torch.cuda.current_stream(dev).cuda_stream)
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
                times[names[i]].append(wall_ms(lambda: call(fns[i])))
            say("tiles", f"{b}x{k}x{m}: " + "; ".join(
                f"{n} " + " / ".join(f"{t:.4f}" for t in ts[::2]) + " ms ("
                "eager " + " / ".join(f"{t:.4f}" for t in ts[1::2]) + ")"
                for n, ts in times.items()) + " (outputs equal the shipped "
                "kernel's bit for bit)")


def phase_host(dev):
    """The host's cost of one paged-attention call through the wrapper the
    model calls, ``paged_attention_decode``, at the phase-3 shape and at the
    digital serve's (8 slots, 69-block tables, 553 pool blocks, contexts
    32-528): the host milliseconds to issue a call (200 calls with no
    synchronisation between them, the median of 5 runs; the device ends a
    call sooner than the host issues the next), beside a call's eager time
    (CUDA events) and its device time (graph).  With ``--src`` it times
    another checkout's package the same way."""
    import statistics

    import torch

    from repro_torch.kernels import paged_attention as pa

    shapes = (("phase-3", 130, 8 * 130 + 1,
               [17, 130, 511, 640, 777, 900, 1023, 1040]),
              ("serve", 69, 553, [32, 528, 80, 316, 144, 49, 496, 272]))
    gen = torch.Generator(device=dev).manual_seed(5)
    bf = torch.bfloat16
    b, hkv, hd, bs = 8, 24, 64, 8
    for label, max_blocks, nb, pos in shapes:
        q = torch.randn((b, hkv, 1, hd), generator=gen, device=dev)
        kn = torch.randn((b, hkv, hd), generator=gen, device=dev).to(bf)
        vn = torch.randn((b, hkv, hd), generator=gen, device=dev).to(bf)
        pk = torch.randn((nb, bs, hkv, hd), generator=gen, device=dev).to(bf)
        pv = torch.randn((nb, bs, hkv, hd), generator=gen, device=dev).to(bf)
        perm = torch.randperm(nb - 1, generator=gen, device=dev) + 1
        bt = perm[: b * max_blocks].reshape(b, max_blocks).to(torch.int32)
        pos_t = torch.tensor(pos, dtype=torch.int32, device=dev)
        active = torch.ones(b, dtype=torch.bool, device=dev)

        def call():
            pa.paged_attention_decode(q, kn, vn, pk, pv, bt, pos_t, active,
                                      scale=hd**-0.5)

        runs = []
        for _ in range(5):
            for _ in range(20):
                call()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(200):
                call()
            runs.append((time.perf_counter() - t0) / 200 * 1e3)
            torch.cuda.synchronize()
        say("host", f"paged_attention_decode at the {label} shape: host "
            f"{statistics.median(runs):.4f} ms per call (runs "
            + " / ".join(f"{r:.4f}" for r in runs) + f"), eager "
            f"{wall_ms(call, iters=200):.4f} ms, device {time_ms(call):.4f} "
            f"ms (package {Path(pa.__file__).parents[2]})")


# ---------------------------------------------------------------------------


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma list of {PHASES + EXTRA_PHASES}")
    ap.add_argument("--src", type=Path, default=ROOT / "src",
                    help="the directory that holds the repro_torch package "
                    "(another checkout's, to time it the same way)")
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
    sys.path.insert(0, str(args.src.resolve()))
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

    if "build" in phases:
        t = build.build_all()
        if build.build_log:  # empty when every library was already built
            (OUT / "kernel_build.log").write_text("\n\n".join(
                f"== {n}\n{log}" for n, log in build.build_log.items()))
        say("build", f"{len(build.SOURCES)} kernel libraries ready in "
            f"{t:.1f} s (nvcc -gencode arch=compute_90a,code=sm_90a; ptxas "
            f"report in build/chip_smoke/kernel_build.log)")
        for n, log in build.build_log.items():
            for line in log.splitlines():
                if "registers" in line or "spill" in line:
                    say("build", f"{n}: {line.strip()}")

    kernels = []
    if "kernels" in phases:
        kernels = [check_paged_attention(dev), *check_bitserial(dev),
                   check_analytic(dev), check_analytic_int8(dev),
                   check_seed_bitserial(dev)]
    counts = {}
    if "design" in phases:
        reset_counts()
        counts.update(phase_design(dev))
    if "serve" in phases:
        counts.update(phase_serve())
    if "parity" in phases:
        phase_parity(dev)
    if "bench" in phases:
        counts.update(phase_bench(dev))
    for k in kernels:  # None where the phase that counts it did not run
        k["launches"] = counts.get(k["name"])
    if "profile" in phases:
        phase_profile()
    if "tiles" in phases:
        phase_tiles(dev)
    if "host" in phases:
        phase_host(dev)
    say("done", f"all phases passed in {time.perf_counter() - t_all:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
