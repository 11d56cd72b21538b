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
             graph), and the least time the card could take (bound); the
             paged kernel also at the architectures' layouts (Hkv, G, hd) =
             (32, 1, 96), (8, 7, 128), (1, 48, 128), (8, 2, 256) with
             softcap 50, (8, 2, 64), (8, 6, 128) and (8, 2, 128), and one
             rank's at 1x4, (6, 1, 64), (2, 6, 128), (1, 12, 128), in bf16
             and float32; the bit-serial kernel also at the recurrent and
             MoE shapes (2560 x 10576, 5120 x 2560, 3 rows of 512 x 1024)
             and as four tensor-parallel ranks call it (column offsets);
  4 design   the layer-scale design study, the analytic kernels' path: every
             matmul shape of musicgen-medium at 512 rows through
             ``ops.imc_matmul(mode="imc_analytic")`` at each billed QR and CM
             design point (the int8 kernel), delivered SNR_T against the
             design's prediction, and one 10-bit call (the float kernel);
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
  archs      the public architectures at full published width (bf16,
             seeded random weights), served through the CLI at full depth:
             phi3-mini-3.8b on the digital (metered), bit-serial and frozen
             analytic substrates, gemma2-9b digital (with one 4100-token
             request whose local layers wrap their 4096-token rings) and
             bit-serial, granite-20b digital (48 query heads on one kv
             head), deepseek-coder-33b digital (66.7 GB of weights),
             mamba2-2.7b (SSD layers, no attention) and recurrentgemma-2b
             (RG-LRU and local attention; one 2100-token request wraps its
             2048-token rings) digital and bit-serial, granite-moe-1b-a400m
             (32 experts, top 8) digital and bit-serial, internvl2-2b
             digital; then dbrx-132b at full width and 8 of its 40 layers
             (``reduced``), built and served in-process (the CLI has no
             depth flag); each line: weight bytes, peak memory after init
             and after serving, KV and recurrent-state bytes, tok/s, mean
             TTFT and the launches by route and paged layout; then gemma2's
             window request alone through prefill + decode_step against the
             engine's tokens;
  mesh       tensor-parallel serving: first a bitwise diagnostic of one
             card's cuBLAS products at musicgen-medium's bf16 site shapes
             (each rank's column slice against the whole product's columns,
             the row-parallel float32 partial sum against one product;
             counts of differing elements), then ``--mesh 1x1`` through the
             CLI (one rank over NCCL), then four ranks sharing the card over
             gloo
             (processes): full-width musicgen-medium on digital, bit-serial
             (noise and gain) and frozen analytic, dbrx-132b at 4 of its 40
             layers and granite-20b at 2 of 52 (``reduced``), mamba2-2.7b
             (SSD heads split, the B|C columns on every rank) on digital
             and bit-serial, recurrentgemma-2b (10 query heads: attention
             replicated, RG-LRU width split) digital, and musicgen-medium
             calibrated on the ranks' shards, with drift injected and every
             chunk sampled, with a transient error on rank 2 alone, and
             swapped from frozen analytic to bit-serial between chunks;
             each against the same run on one device (tokens, or knife-edge
             picks within the runs' logit deviation, printed; calibration
             site by site, drift reports, swaps, retries), most also bit
             for bit against one device whose row sites split K as the
             ranks do, the paged kernel at each rank's layout, per-rank
             weight, state and peak bytes, the fault vote's ms;
  train      single-device training: full-width musicgen-medium (bf16,
             seeded random weights) through ``launch.train.main``, 12 steps
             of 8 x 512 tokens with a checkpoint every 6 (each step's loss,
             grad norm and lr, ms a step, tokens/s, model FLOPs against the
             bf16 peak, peak memory against parameters, gradients and Adam
             state; finite losses that fall), resumed to 18 from the
             step-12 checkpoint (restored bit for bit), 4 steps each of the
             imc_analytic and fakequant training modes, one layer's
             attention through the flash Function against plain autograd
             (peak bytes, ms, gradients at rel 1e-5), and the SMOKE train
             step card against CPU in float32; no kernel launches (counted);
  6 parity   the SMOKE configs in float32 (all ten architectures): the
             engine on the card against the
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
             wrapper's calls (graph-captured calls once each), and the
             whole-model SNR sweep (gemma2-9b and mamba2-2.7b SMOKE with
             every matmul on the analytic substrate); then the
             MC convergence sweep (S_A - E_A and S_T - S_A at the reference's
             512-row QS, QR and CM points and its 128-row QR and 64-row CM
             points, ensembles of 600 to 10^6 under 8 generator seeds).
Optional: ``--phases ...,profile``, a torch.profiler trace of one decode
chunk of each full-width substrate (the analytic one also shadow-sampled)
and of one warm prefix admission - device kernel time by name against the
wall time (summary printed, tables under build/chip_smoke/);
``--phases ...,tiles``, the analytic kernel's tile instantiations
(``TILE_CONFIGS``) timed against each other at every site shape;
``--phases device,chunks``, the paged kernel's query rows per CTA timed
against each other at the architectures' layouts;
``--phases device,kprofile``, torch.profiler's kernel rows of one call of
the seed bit-serial wrapper and of the float analytic wrapper;
``--phases device,host``, the paged-attention wrapper's host cost per call;
``--phases device,colsplit``, how many of mamba2-2.7b's ``in_proj``
elements a rank's product over its column segments rounds apart from one
product's (why the mesh phase does not hold mamba2 digital bit for bit)
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
PHASES = ("device", "build", "kernels", "design", "serve", "archs", "mesh",
          "train", "parity", "bench")
# not run by default (the module docstring says what each does)
EXTRA_PHASES = ("profile", "tiles", "host", "kprofile", "chunks",
                "colsplit")

# NVIDIA H100 SXM published peaks (data sheet, dense), used for the bounds
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
TF32_FLOPS_PER_S = 494.7e12
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
# (warpgroups, N, min blocks per SM) instantiations of the analytic kernel's
# tile template, each warpgroup 64 rows x N columns, timed against each
# other by the optional tiles phase: the three it ships (128 x 192, 64 x 96,
# 64 x 64) and 128 x 96
TILE_CONFIGS = ((2, 192, 1), (1, 96, 2), (1, 64, 2), (2, 96, 1))


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
    # an engine's idle rows: slots 5 and 6 never admitted (empty tables:
    # both write block 0 at offset 0 and read it back), slot 3 retired with
    # slot 2's table (it reads the block slot 2 writes); every new row
    # lands before any is read, the highest slot's where two meet, so
    # every row and the whole pools equal the plain version's, every run
    bt_i, pos_i, act_i = bt.clone(), pos.clone(), active.clone()
    bt_i[5:7], pos_i[5:7], act_i[5:7] = 0, 0, False
    bt_i[3], pos_i[3], act_i[3] = bt[2], pos[2], False
    pools_p = (pk.clone(), pv.clone())
    ctx_ip, _, _ = pa.decode_plain(q, kn, vn, *pools_p, bt_i, pos_i, act_i,
                                   scale=scale)
    for _ in range(3):
        pools_k = (pk.clone(), pv.clone())
        ctx_ik, _, _ = pa.paged_attention_decode(q, kn, vn, *pools_k, bt_i,
                                                 pos_i, act_i, scale=scale)
        idle_err = float((ctx_ik - ctx_ip).abs().max())
        if not torch.allclose(ctx_ik, ctx_ip, rtol=1e-5, atol=1e-5) or not (
                torch.equal(pools_k[0], pools_p[0])
                and torch.equal(pools_k[1], pools_p[1])):
            raise AssertionError("paged attention with colliding idle rows "
                                 f"differs from the plain version: max abs "
                                 f"{idle_err}")
    say("kernels", f"paged_attention with colliding idle rows (two empty "
        f"tables, one stale): max abs {idle_err:.3e} in 3 launches, whole "
        f"pools equal")
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


# the paged kernel's layouts of the public architectures with global
# attention: (name, Hkv, G, hd, softcap); each is held in bf16 and float32
# and timed in bf16
PAGED_LAYOUTS = (("phi3-mini-3.8b", 32, 1, 96, None),
                 ("deepseek-coder-33b", 8, 7, 128, None),
                 ("granite-20b", 1, 48, 128, None),
                 ("gemma2-9b", 8, 2, 256, 50.0),
                 ("granite-moe-1b-a400m", 8, 2, 64, None),
                 ("dbrx-132b", 8, 6, 128, None),
                 ("internvl2-2b", 8, 2, 128, None),
                 # one rank's layout at 1x4 (the mesh phase): head-sharded
                 # musicgen-medium and dbrx-132b, granite-20b's replicated
                 # pool under 12 of its 48 query heads
                 ("musicgen-medium 1x4", 6, 1, 64, None),
                 ("dbrx-132b 1x4", 2, 6, 128, None),
                 ("granite-20b 1x4", 1, 12, 128, None))


LAYOUT_SLOTS, LAYOUT_BLOCK, LAYOUT_BLOCKS = 8, 8, 130


def layout_operands(dev, hkv, g, hd, cap, dtype):
    """Phase 3's slot layout at one ``PAGED_LAYOUTS`` entry: 8 slots,
    contexts 17 .. 1023 in 130 blocks of 8, one inactive and one overrun
    row, from a generator seeded by the layout (the queries first, so both
    dtypes see the same ones).  Returns ``(q, k_new, v_new, pk, pv, bt, pos,
    active, scale)``."""
    import torch

    b, bs, max_blocks = LAYOUT_SLOTS, LAYOUT_BLOCK, LAYOUT_BLOCKS
    nb = b * max_blocks + 1
    gen = torch.Generator(device=dev).manual_seed(hkv * 1000 + g * 10 + hd)
    perm = torch.randperm(nb - 1, generator=gen, device=dev) + 1
    bt = perm[: b * max_blocks].reshape(b, max_blocks).to(torch.int32)
    pos = torch.tensor([17, 130, 511, 640, 777, 900, 1023, max_blocks * bs],
                       dtype=torch.int32, device=dev)
    active = torch.ones(b, dtype=torch.bool, device=dev)
    active[6] = False
    q = torch.randn((b, hkv, g, hd), generator=gen, device=dev)
    if cap is not None:  # softcap 50 bites only on large logits
        q = q * 32.0

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    kn, vn = normal(b, hkv, hd), normal(b, hkv, hd)
    pk, pv = normal(nb, bs, hkv, hd), normal(nb, bs, hkv, hd)
    return q, kn, vn, pk, pv, bt, pos, active, hd**-0.5


def check_paged_layouts(dev):
    """The paged kernel at each ``PAGED_LAYOUTS`` entry (``layout_operands``):
    ctx allclose(rtol=1e-5, atol=1e-5) to ``decode_plain`` and the pools
    equal outside block 0, in bf16 and float32; then the bf16 call replayed
    from a CUDA graph against its byte bound, the plain version and SDPA
    over the gathered view (the K/V heads expanded to the query heads
    beforehand, untimed).  Returns one kernel row per layout, named by
    ``paged_attention.layout_key``."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import paged_attention as pa

    b, bs, max_blocks = LAYOUT_SLOTS, LAYOUT_BLOCK, LAYOUT_BLOCKS
    rows_out = []
    for arch, hkv, g, hd, cap in PAGED_LAYOUTS:
        errs = {}
        for dt in (torch.float32, torch.bfloat16):
            q, kn, vn, pk, pv, bt, pos, active, scale = layout_operands(
                dev, hkv, g, hd, cap, dt)
            pk_k, pv_k, pk_p, pv_p = (pk.clone(), pv.clone(), pk.clone(),
                                      pv.clone())
            ctx_k, _, _ = pa.paged_attention_decode(
                q, kn, vn, pk_k, pv_k, bt, pos, active, scale=scale,
                softcap=cap)
            ctx_p, _, _ = pa.decode_plain(q, kn, vn, pk_p, pv_p, bt, pos,
                                          active, scale=scale, softcap=cap)
            torch.cuda.synchronize()
            err = float((ctx_k - ctx_p).abs().max())
            name = pa.layout_key(hkv, g, hd, dt)
            if not torch.allclose(ctx_k, ctx_p, rtol=1e-5, atol=1e-5):
                raise AssertionError(f"paged attention {name} ctx differs: "
                                     f"max abs {err}")
            if not (torch.equal(pk_k[1:], pk_p[1:])
                    and torch.equal(pv_k[1:], pv_p[1:])):
                raise AssertionError(f"paged attention {name}: pools differ "
                                     "outside block 0")
            errs[dt] = err
            del pk_k, pv_k, pk_p, pv_p
        # the bf16 operands (the serve's dtype) are timed: rotate over 4 pool
        # pairs so no call finds the previous one's rows in L2
        pools = [(pk.clone(), pv.clone()) for _ in range(4)]
        turn = iter(range(10**9))

        def kernel_call():
            pk_r, pv_r = pools[next(turn) % len(pools)]
            pa.paged_attention_decode(q, kn, vn, pk_r, pv_r, bt, pos,
                                      active, scale=scale, softcap=cap)

        ms = time_ms(kernel_call)
        plain_ms = wall_ms(lambda: pa.decode_plain(
            q, kn, vn, pk, pv, bt, pos, active, scale=scale, softcap=cap),
            iters=3, warmup=1)
        library_ms = None
        if cap is None:  # SDPA has no softcap
            s_kv = max_blocks * bs
            kg = pk[bt.long()].reshape(b, s_kv, hkv, hd).permute(0, 2, 1, 3)
            vg = pv[bt.long()].reshape(b, s_kv, hkv, hd).permute(0, 2, 1, 3)
            kg = kg.repeat_interleave(g, dim=1)
            vg = vg.repeat_interleave(g, dim=1)
            mask = (torch.arange(s_kv, device=dev)[None, :]
                    <= pos[:, None].long())[:, None, None, :]
            qs = q.reshape(b, hkv * g, 1, hd).to(torch.bfloat16)
            views = [(kg.clone(), vg.clone()) for _ in range(2)]
            del kg, vg

            def library_call():
                kv, vv = views[next(turn) % len(views)]
                F.scaled_dot_product_attention(qs, kv, vv, attn_mask=mask,
                                               scale=scale)

            library_ms = time_ms(library_call)
            del views
        rows = sum(min(int(p) + 1, max_blocks * bs) for p in pos.tolist())
        nbytes = (2 * rows * hkv * hd * 2 + q.numel() * 4
                  + 4 * kn.numel() * 2 + b * hkv * g * hd * 4)
        flops = 4 * rows * hkv * g * hd
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / F32_FLOPS_PER_S * 1e3
        bound = max(t_bytes, t_ops)
        name = pa.layout_key(hkv, g, hd, torch.bfloat16)
        plan = pa.plan_split(b, hkv, g, hd, bs, max_blocks, 2)
        lib = "n/a (softcap)" if library_ms is None else f"{library_ms:.4f}"
        capped = f", softcap {cap:g}" if cap else ""
        say("kernels", f"paged_attention[{name}] ({arch}{capped}): "
            f"max_abs_err bf16 {errs[torch.bfloat16]:.3e} f32 "
            f"{errs[torch.float32]:.3e}, pools equal; grid "
            f"{plan.head_groups * plan.q_chunks}x{b}x{plan.n_splits} "
            f"({plan.q_chunks} query chunks of {plan.gm}); ms={ms:.4f} "
            f"plain_ms={plain_ms:.4f} library_ms(sdpa)={lib} bound_ms="
            f"{bound:.5f} (bytes {t_bytes:.5f}, operations {t_ops:.5f}; "
            f"{nbytes / 1e6:.1f} MB at {nbytes / ms / 1e9:.3f} TB/s, "
            f"{bound / ms:.1%} of the bound)")
        rows_out.append({
            "name": f"paged_attention[{name}]", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
            "replaces": "src/repro/kernels/paged_attention.py:159",
            "max_abs_err": max(errs.values()), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms})
        del pools
    return rows_out


def phase_chunks(dev):
    """The paged kernel's query rows per CTA (``MAX_G_PER_CTA`` of
    ``paged_attention.plan_split``: 1, 2, 4, 8) timed against each other at
    each ``PAGED_LAYOUTS`` entry with G > 1, bf16, in the order A B ... B A
    (graph replays); each must match ``decode_plain``."""
    import torch

    from repro_torch.kernels import paged_attention as pa

    for arch, hkv, g, hd, cap in PAGED_LAYOUTS:
        if g == 1:
            continue
        q, kn, vn, pk, pv, bt, pos, active, scale = layout_operands(
            dev, hkv, g, hd, cap, torch.bfloat16)
        ctx_p, _, _ = pa.decode_plain(q, kn, vn, pk.clone(), pv.clone(), bt,
                                      pos, active, scale=scale, softcap=cap)
        caps = [m for m in (8, 4, 2, 1) if m <= pa._pow2_at_least(g)]
        act = active.to(torch.int32)
        pools = [(pk.clone(), pv.clone()) for _ in range(4)]
        turn = iter(range(10**9))

        def call(m):
            pk_r, pv_r = pools[next(turn) % len(pools)]
            with rows_per_cta(pa, m):
                return pa.paged_attention_cuda(
                    q, kn, vn, pk_r, pv_r, bt, pos, act, scale=scale,
                    softcap=cap)[0]

        def chunks(m):
            with rows_per_cta(pa, m):
                return pa.plan_split(LAYOUT_SLOTS, hkv, g, hd, LAYOUT_BLOCK,
                                     LAYOUT_BLOCKS, 2).q_chunks

        for m in caps:
            ctx = call(m)
            if not torch.allclose(ctx, ctx_p, rtol=1e-5, atol=1e-5):
                raise AssertionError(f"{arch} {m} rows per CTA: ctx differs")
        times = {m: [] for m in caps}
        for m in caps + caps[::-1]:
            times[m].append(time_ms(lambda: call(m)))
        say("chunks", f"{arch} (Hkv, G, hd) = ({hkv}, {g}, {hd}): " + ", ".join(
            f"{m} rows per CTA ({chunks(m)} chunks) "
            f"{t[0]:.4f}/{t[1]:.4f} ms" for m, t in times.items()))


@contextlib.contextmanager
def rows_per_cta(pa, m):
    """Plan the paged kernel with ``m`` query rows per CTA (graph capture
    keeps the plan a call was captured with)."""
    old = pa.MAX_G_PER_CTA
    pa.MAX_G_PER_CTA = m
    pa.plan_split.cache_clear()
    try:
        yield
    finally:
        pa.MAX_G_PER_CTA = old
        pa.plan_split.cache_clear()


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


def bitserial_case(imc, gen, b, k, m, dev):
    """Seeded operands of one bit-serial call at the serve's knobs
    (``imc``): 7-bit codes of a (b, k) x and a (k, m) w, a per-cell gain,
    the spec, and one plane ADC step in output units."""
    import torch

    from repro_torch.kernels import ops, ref

    mc = ops.matmul_config_from_imc(imc, k)
    spec = ref.BitSerialSpec(bx=mc.bx, bw=mc.bw, b_adc=mc.b_adc,
                             rows=mc.rows, k_h=mc.k_h_counts,
                             v_c=mc.v_c_counts, x_signed=True,
                             sigma_noise=mc.sigma_thermal_counts)
    x = torch.randn((b, k), generator=gen, device=dev)
    w = torch.randn((k, m), generator=gen, device=dev)
    xc, _ = ref.quantize_codes(x, 7, True, x.abs().max())
    wc, _ = ref.quantize_codes(w, 7, True, w.abs().max())
    gain = 1.0 + mc.sigma_d * torch.randn((k, m), generator=gen, device=dev)
    step = spec.v_c / 2**spec.b_adc * 2 ** (spec.bw + spec.bx)
    return xc, wc, gain, spec, step


def bitserial_diff(label, xc, wc, g, spec, seed, step):
    """The kernel against its plain version on one call: exact without
    noise; with seeded noise at most 0.1% of elements may differ, by at
    most one ADC step.  Returns (share of elements that differ, the
    largest difference, the kernel's output)."""
    import torch

    from repro_torch.kernels import imc_mvm, ref

    y_k = imc_mvm.imc_bitserial_matmul(xc, wc, g, spec, seed=seed)
    y_p = ref.imc_bitserial_ref(xc, wc, g, spec, seed=seed)
    torch.cuda.synchronize()
    diff = (y_k - y_p).abs()
    frac, worst = float((diff > 0).float().mean()), float(diff.max())
    if seed is None and frac > 0:
        raise AssertionError(f"bitserial {label} (gain {g is not None}) "
                             f"noiseless differs: max abs {worst}")
    if frac > 1e-3 or worst > step:
        raise AssertionError(f"bitserial {label} with noise and gain: "
                             f"{frac:.2e} of elements differ (limit 1e-3), "
                             f"max {worst}")
    return frac, worst, y_k


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
    from repro_torch.kernels import build, imc_mvm, ref

    imc = IMCConfig(mode="imc_bitserial", bx=7, bw=7, v_wl=0.7)
    gen = torch.Generator(device=dev).manual_seed(1)
    # the C arguments of operands already in the kernel's layout; a checkout
    # without this helper (``--src``) has its whole wrapper calls timed only
    c_args = getattr(imc_mvm, "bitserial_c_args", None)
    b = BITSERIAL_SLOTS
    worst = {True: 0.0, False: 0.0}
    ms, kernel_ms = {}, {}
    for k, m in SITE_SHAPES:
        xc, wc, gain, spec, step = bitserial_case(imc, gen, b, k, m, dev)
        x8, w8 = imc_mvm._code_bytes(xc), imc_mvm._code_bytes(wc)
        fracs, notes = {}, {}
        # without gain and noise (the LM head's instantiation), with gain
        # but no noise (checked only), with both (the projections')
        for g, seed in ((None, None), (gain, None), (gain, 4242)):
            frac, diff, y_k = bitserial_diff(f"{k}x{m}", xc, wc, g, spec,
                                             seed, step)
            if seed is None and g is not None:
                continue
            worst[g is not None] = max(worst[g is not None], diff)
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


# bit-serial shapes of the recurrent and MoE architectures' main path, at
# their serve's knobs (7x7 bits): (B, K, M, where)
def check_bitserial_offset(dev):
    """The bit-serial kernel as a tensor-parallel rank calls it: the
    columns of the serve's (4, 1536) @ (1536, 6144) split over
    ``MESH_RANKS`` ranks, noise and gain on; each shard, at its column
    offset, equals its plain version there bit for bit, and the shards side
    by side equal the whole call."""
    import torch

    from repro_torch.core.imc_linear import IMCConfig
    from repro_torch.kernels import imc_mvm, ref

    imc = IMCConfig(mode="imc_bitserial", bx=7, bw=7, v_wl=0.7)
    gen = torch.Generator(device=dev).manual_seed(2)
    b, k, m, tp = BITSERIAL_SLOTS, 1536, 6144, MESH_RANKS
    xc, wc, gain, spec, _ = bitserial_case(imc, gen, b, k, m, dev)
    whole = imc_mvm.imc_bitserial_matmul(xc, wc, gain, spec, seed=4242)
    per, parts = m // tp, []
    for r in range(tp):
        cols = slice(r * per, (r + 1) * per)
        y_k = imc_mvm.imc_bitserial_matmul(xc, wc[:, cols], gain[:, cols],
                                           spec, seed=4242, col0=r * per)
        y_p = ref.imc_bitserial_ref(xc, wc[:, cols], gain[:, cols], spec,
                                    seed=4242, col0=r * per)
        torch.cuda.synchronize()
        if not torch.equal(y_k, y_p):
            raise AssertionError(f"bitserial rank {r} at column offset "
                                 f"{r * per}: max abs "
                                 f"{float((y_k - y_p).abs().max())}")
        parts.append(y_k)
    if not torch.equal(torch.cat(parts, dim=1), whole):
        raise AssertionError("bitserial column shards differ from the whole "
                             "call")
    say("kernels", f"bitserial at column offsets: {tp} shards of {b}x{k}x"
        f"{m} with noise and gain, each bit for bit its plain version at "
        f"its offset, side by side the whole call")


def check_bitserial_segments(dev):
    """The bit-serial kernel as a rank of a 1x``MESH_RANKS`` mesh runs
    mamba2-2.7b's ``in_proj`` (4 slots): the rank's ``z``, ``x``, ``B|C``
    and ``dt`` columns, one launch a segment at its global column offset,
    noise and gain on.  Each launch equals its plain version at its offset
    bit for bit, and a rank's segments side by side equal the whole call's
    columns; rank 0's launches timed from graph replays beside the bound
    of its columns."""
    import torch

    from repro_torch import configs
    from repro_torch.core.imc_linear import IMCConfig
    from repro_torch.kernels import imc_mvm, ref
    from repro_torch.models import ssm

    imc = IMCConfig(mode="imc_bitserial", bx=7, bw=7, v_wl=0.7)
    layout = ssm.in_proj_columns(configs.get("mamba2-2.7b"), MESH_RANKS)
    gen = torch.Generator(device=dev).manual_seed(3)
    b, k, m = BITSERIAL_SLOTS, 2560, layout.total
    xc, wc, gain, spec, _ = bitserial_case(imc, gen, b, k, m, dev)
    whole = imc_mvm.imc_bitserial_matmul(xc, wc, gain, spec, seed=4242)

    def launches(r, check=False):
        out = []
        for a, e in layout.ranks[r]:
            y = imc_mvm.imc_bitserial_matmul(
                xc, wc[:, a:e], gain[:, a:e], spec, seed=4242, col0=a)
            if check:
                y_p = ref.imc_bitserial_ref(xc, wc[:, a:e], gain[:, a:e],
                                            spec, seed=4242, col0=a)
                torch.cuda.synchronize()
                if not torch.equal(y, y_p):
                    raise AssertionError(
                        f"bitserial segment ({a}, {e}) of rank {r}: max abs "
                        f"{float((y - y_p).abs().max())}")
            out.append(y)
        return torch.cat(out, dim=1)

    for r in range(MESH_RANKS):
        if not torch.equal(launches(r, check=True),
                           whole[:, layout.index(r, dev)]):
            raise AssertionError(f"bitserial segments of rank {r} differ "
                                 f"from the whole call's columns")
    m0 = sum(e - a for a, e in layout.ranks[0])
    ms = time_ms(lambda: launches(0))
    bound, by = bitserial_bound(b, k, m0, spec.bw * spec.bx, True)
    say("kernels", f"bitserial mamba2-2.7b in_proj segments at 1x"
        f"{MESH_RANKS}: every rank's launches ({b}x{k} against "
        f"{[list(s) for s in layout.ranks[0]]} of {m} columns on rank 0) bit "
        f"for bit their plain versions and the whole call's columns; rank "
        f"0: {len(layout.ranks[0])} launches, ms={ms:.4f} bound_ms="
        f"{bound:.5f} ({by}, {bound / ms:.1%} of it)")


ARCH_BITSERIAL_SHAPES = (
    (4, 2560, 10576, "mamba2-2.7b ssm.in_proj, 4 slots"),
    (3, 512, 1024, "granite-moe-1b-a400m expert mlp.wo, capacity 3"),
    (4, 5120, 2560, "mamba2-2.7b ssm.out_proj, 4 slots"))


def check_bitserial_shapes(dev):
    """The bit-serial kernel at ``ARCH_BITSERIAL_SHAPES`` (K of 512 and
    5120, M of 10576, which is not a multiple of 64, and 3 rows): each
    against the plain version without noise and gain (exact), with gain and
    no noise (exact) and with seeded noise and gain (at most 0.1% of
    elements may differ by a code); the noisy call with gain (the
    projections' instantiation) and the call without either (the packed
    conv cache's) timed from graph replays, the plain version by wall
    clock, beside the bound."""
    import torch

    from repro_torch.core.imc_linear import IMCConfig
    from repro_torch.kernels import imc_mvm, ref

    imc = IMCConfig(mode="imc_bitserial", bx=7, bw=7, v_wl=0.7)
    gen = torch.Generator(device=dev).manual_seed(2)
    for b, k, m, where in ARCH_BITSERIAL_SHAPES:
        xc, wc, gain, spec, step = bitserial_case(imc, gen, b, k, m, dev)
        notes = []
        for g, seed in ((None, None), (gain, None), (gain, 4242)):
            frac, _, _ = bitserial_diff(f"{b}x{k}x{m}", xc, wc, g, spec,
                                        seed, step)
            if seed is None and g is not None:
                continue
            ms = time_ms(lambda: imc_mvm.imc_bitserial_matmul(
                xc, wc, g, spec, seed=seed))
            plain_ms = wall_ms(lambda: ref.imc_bitserial_ref(
                xc, wc, g, spec, seed=seed), iters=3, warmup=1)
            bound, by = bitserial_bound(b, k, m, spec.bw * spec.bx,
                                        g is not None)
            what = ("with noise and gain, " + f"{frac:.2e} of elements "
                    "differ" if g is not None else
                    "without noise and gain, exact")
            notes.append(f"{what}: ms={ms:.4f} plain_ms={plain_ms:.4f} "
                         f"bound_ms={bound:.5f} ({by}, {bound / ms:.1%} of "
                         f"it)")
        say("kernels", f"bitserial {b}x{k}x{m} ({where}) rows={spec.rows} "
            f"b_adc={spec.b_adc}; with gain and no noise exact; "
            + "; ".join(notes))


def analytic_bound(b, k, m, products):
    """(bound_ms, bound_by) of one analytic call: f32 x, w and out moved once
    over the HBM rate, or the split-TF32 products (2 B K M operations each)
    over the TF32 tensor-core peak: ``products`` is 3, or 2 where every
    weight code is one TF32 limb (an integer of at most 11 bits: the kernel
    skips x_hi w_lo).  The noise draws are not counted."""
    t_bytes = 4 * (b * k + k * m + b * m) / HBM_BYTES_PER_S * 1e3
    t_ops = products * 2 * b * k * m / TF32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def tf32_products(w):
    """The split-TF32 products the analytic kernel runs on float32 ``w``: 3
    if some value has a mantissa bit below TF32's (a nonzero lo limb), else
    2."""
    import torch

    return 2 + int(bool(((w.view(torch.int32) & 0x1FFF) != 0).any()))


def analytic_operands(gen, b, k, m, bx, bw, dev):
    """Seeded analytic-kernel operands: unsigned ``bx``-bit activation codes
    over sigma_yo (of the first 8 rows' code product), signed ``bw``-bit
    weight codes."""
    import torch

    from repro_torch.kernels import ref

    x = torch.rand((b, k), generator=gen, device=dev)
    w = torch.rand((k, m), generator=gen, device=dev) * 2 - 1
    xc, _ = ref.quantize_codes(x, bx, False, x.abs().max())
    wc, _ = ref.quantize_codes(w, bw, True, w.abs().max())
    return ref.true_div(xc, (xc[:8] @ wc).std(unbiased=False) + 1e-9), wc


def check_analytic(dev):
    """The float analytic kernel (split TF32) at every musicgen-medium site
    shape, at B = 8 and B = 512, with the QR 26 dB design point's codes and
    ADC (b_adc from the design, sigma_out = 10^(-SNR_a/20), y_clip 4) and a
    seed, then with 16-bit weight codes (two TF32 limbs) at (1536, 6144).
    With the ADC at most 0.1% of the outputs may differ from the plain
    version, each by at most one ADC step plus 1e-6 (the K order of the sums
    differs); without it allclose(rtol 1e-5, atol 1e-5 * max|y|), and at one
    shape the noise alone (noisy - clean) equals sigma_out * z of the plain
    version within 3 ulp.  The plain version on the card is float32 (TF32
    off).  At B = 512 each noiseless product's largest error against a
    float64 product is printed beside cuBLAS float32's (``torch.matmul``).
    Timed against ``torch.matmul`` f32 (product only)."""
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
    cases = [(b, k, m, pt.bw) for b in (8, 512) for k, m in SITE_SHAPES]
    cases += [(b, 1536, 6144, 16) for b in (8, 512)]
    worst, row = 0.0, None
    for b, k, m, bw in cases:
        xs, wc = analytic_operands(gen, b, k, m, pt.bx, bw, dev)
        y_k = imc_mvm.imc_analytic_matmul(xs, wc, spec, seed=seed)
        y_p = ref.imc_analytic_ref(xs, wc, spec, seed=seed)
        r_k = imc_mvm.imc_analytic_matmul(xs, wc, raw, seed=seed)
        r_p = ref.imc_analytic_ref(xs, wc, raw, seed=seed)
        torch.cuda.synchronize()
        diff = (y_k - y_p).abs()
        frac = float((diff > 1e-6).float().mean())
        label = f"analytic {b}x{k}x{m} bw={bw}"
        if float(diff.max()) > step + 1e-6 or frac >= 1e-3:
            raise AssertionError(
                f"{label}: {frac:.2e} of outputs differ (limit 1e-3), max "
                f"{float(diff.max())} (limit {step})")
        atol = 1e-5 * float(r_p.abs().max())
        if not torch.allclose(r_k, r_p, rtol=1e-5, atol=atol):
            raise AssertionError(
                f"{label} without the ADC differs: max abs "
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
        f64 = ""
        if b == 512:
            y64 = xs.double() @ wc.double()
            clean = imc_mvm.imc_analytic_matmul(xs, wc, raw)
            err64 = float((clean.double() - y64).abs().max())
            cublas64 = float((torch.matmul(xs, wc).double() - y64).abs()
                             .max())
            clean_ms = time_ms(lambda: imc_mvm.imc_analytic_matmul(xs, wc,
                                                                   raw))
            f64 = (f"; noiseless product against float64: max abs "
                   f"{err64:.3e} (cuBLAS f32 {cublas64:.3e}, of max|y| "
                   f"{float(y64.abs().max()):.3e}); without noise and ADC "
                   f"{clean_ms:.4f} ms")
        ms = time_ms(lambda: imc_mvm.imc_analytic_matmul(xs, wc, spec,
                                                         seed=seed))
        plain_ms = wall_ms(lambda: ref.imc_analytic_ref(xs, wc, spec,
                                                        seed=seed))
        lib_ms = time_ms(lambda: torch.matmul(xs, wc))
        products = tf32_products(wc)
        bound, by = analytic_bound(b, k, m, products)
        say("kernels", f"{label} b_adc={spec.b_adc}: {frac:.2e} of outputs "
            f"differ, max_abs_err={float(diff.max()):.3e}; ms={ms:.4f} "
            f"plain_ms={plain_ms:.4f} library_ms(torch.matmul f32, product "
            f"only)={lib_ms:.4f} bound_ms={bound:.5f} ({by}, {products} TF32 "
            f"products, {bound / ms:.1%} of it; 3 products "
            f"{analytic_bound(b, k, m, 3)[0]:.5f}, float32 outside the "
            f"tensor cores {2 * b * k * m / F32_FLOPS_PER_S * 1e3:.5f})"
            + f64)
        if (b, k, m, bw) == (512, 1536, 6144, pt.bw):
            row = {"name": "analytic", "route": "cuda",
                   "source": "src/repro_torch/kernels/csrc/analytic.cu",
                   "replaces": "src/repro/kernels/imc_mvm.py:284",
                   "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                   "bound_by": by, "library_ms": lib_ms,
                   "bound_3xtf32_ms": analytic_bound(b, k, m, 3)[0],
                   "err_f64": err64, "cublas_err_f64": cublas64,
                   "shape": f"{b}x{k}x{m}, {pt.bw}-bit codes, noise and ADC"}
        if (b, bw) == (512, 16):
            row["ms_16bit"] = ms
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
    Held to the same tolerance as the float kernel against its plain
    version (at most 0.1% of outputs one ADC step apart; without the ADC
    allclose(rtol 1e-5, atol 1e-5 * max|y|); the noise alone within 3 ulp of
    sigma_out * z at one shape).  Timed on operands already in int8, (M, K),
    against the float kernel (``csrc/analytic.cu``, split TF32) on the same
    codes in the order A B B A, against ``torch.matmul`` of the float32
    operands (product only) and, where it takes the shape (B > 16),
    ``torch._int_mm`` of the int8 codes (product only, the x bytes read as
    int8)."""
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

            def float_call():
                imc_mvm.imc_analytic_matmul(xs, wc, spec, seed=seed)

            t_i8, t_float = [], []
            for fn, acc in ((int8_call, t_i8), (float_call, t_float),
                            (float_call, t_float), (int8_call, t_i8)):
                acc.append(time_ms(fn))
            ms, float_ms = sum(t_i8) / 2, sum(t_float) / 2
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
            if not (ms < min(t_float)):
                raise AssertionError(
                    f"analytic_int8 {b}x{k}x{m}: {t_i8} ms is not faster "
                    f"than the float kernel's {t_float} ms")
            say("kernels", f"analytic_int8 {b}x{k}x{m} bx={pt.bx} bw="
                f"{pt.bw} b_adc={spec.b_adc} tile=64x"
                f"{imc_mvm.int8_tile(b, m)}: {frac:.2e} of outputs differ, max_abs_err="
                f"{float(diff.max()):.3e}; ms={t_i8[0]:.4f}/{t_i8[1]:.4f} "
                f"(eager codes-route call with its casts {eager_ms:.4f}) "
                f"float_ms={t_float[0]:.4f}/{t_float[1]:.4f} (A B B A) "
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
                       "int_mm_ms": int_mm_ms, "float_ms": float_ms,
                       "shape": f"{b}x{k}x{m}, noise and ADC"}
    row["max_abs_err"] = worst
    return row


def seed_bound(b, k, m, bits, n_banks, noisy):
    """(bound_ms, bound_by) of one seed bit-serial call: the float32 codes
    read once (as the kernel reads them), the float32 noise operand
    (n_banks, bits, B, M) read once, the float32 output written once; the
    plane products as one multiply-add (2 operations) per (b, k, m) and
    plane pair at the int8 rate, as ``bitserial_bound`` counts the same
    plane products without gain."""
    nbytes = (4 * (k * m + b * k) + 4 * b * m
              + (4 * n_banks * bits * b * m if noisy else 0))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * bits * b * k * m / INT8_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def seed_main_operands(dev):
    """The seed kernel's inputs at the main path's bit-serial shape: (4,
    1536) @ (1536, 6144) codes at 7x7 bits, musicgen-medium's bit-serial
    substrate (256-row banks, its 10-bit ADC, k_h and v_c), and a noise
    operand of its thermal noise in counts drawn from a CUDA generator:
    ``(x_codes, w_codes, noise, spec)``."""
    import torch

    from repro_torch.core.imc_linear import IMCConfig
    from repro_torch.kernels import ops, ref

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
    return xc, wc, noise, spec


def check_seed_bitserial(dev):
    """The frozen seed bit-serial kernel (the kernel bench's baseline)
    against its plain version at the bench's three ``SHAPES``, on the very
    inputs the bench times (``kernel_bench.bitserial_operands``: 8-bit ADC,
    banks of min(512, K) rows, k_h 60, v_c 55, noise std 0.3), and at the
    main path's bit-serial shape (``seed_main_operands``).  Bit-exact with
    and without noise (the same operand, exact plane counts, the plain
    version's rounding and order).  Its noiseless output is
    ``bitserial.cu``'s noiseless, gain-free output (the same function, its
    float32 terms summed in another order): allclose(rtol 0, atol
    ``kernel_bench.order_atol``, 8 float32 ulps of the largest partial sum
    in the seed's order).  At the bench's shapes ``bitserial.cu`` is also
    held, with noise and without gain at the bench's counter-hash seed (its
    ``kernel_noise`` config), against ``ref.imc_bitserial_ref`` under phase
    3's rule: at most 0.1% of outputs differ, none by more than one step of
    the heaviest plane pair.  A wrapper call captured in a CUDA graph must
    hold exactly one kernel.  Times at the main shape: ``ms`` the whole
    wrapper call with noise, ``ms_nonoise`` without."""
    import torch

    from repro_torch.benchmarks import kernel_bench as kb
    from repro_torch.kernels import imc_mvm, ref

    cases = [(shape, kb.bitserial_operands(shape, dev))
             for shape in kb.SHAPES]
    xc, wc, noise, spec = seed_main_operands(dev)
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
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        kb.seed_bitserial_matmul(xc, wc, noise, spec)
    kernels = kb._graph_kernels(graph)
    if kernels != 1:
        raise AssertionError(f"seed_bitserial: a wrapper call holds {kernels}"
                             " kernels, not one")
    ms = time_ms(lambda: kb.seed_bitserial_matmul(xc, wc, noise, spec))
    ms_nonoise = time_ms(lambda: kb.seed_bitserial_matmul(xc, wc, None, spec))
    plain_ms = wall_ms(lambda: kb.seed_bitserial_plain(xc, wc, noise, spec),
                       iters=3, warmup=1)
    bits = spec.bw * spec.bx
    n_banks = -(-1536 // spec.rows)
    bound, by = seed_bound(BITSERIAL_SLOTS, 1536, 6144, bits, n_banks, True)
    bound_clean, by_clean = seed_bound(BITSERIAL_SLOTS, 1536, 6144, bits,
                                       n_banks, False)
    say("kernels", f"seed_bitserial at {BITSERIAL_SLOTS}x1536x6144 with "
        f"noise: one kernel per call; ms={ms:.4f} plain_ms={plain_ms:.4f} "
        f"bound_ms={bound:.5f} ({by}, {bound / ms:.1%} of it); without "
        f"noise ms={ms_nonoise:.4f} bound_ms={bound_clean:.5f} ({by_clean},"
        f" {bound_clean / ms_nonoise:.1%} of it)")
    return {"name": "seed_bitserial", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/seed_bitserial.cu",
            "replaces": "benchmarks/kernel_bench.py:66",
            "launches_are": "wrapper calls in the bench phase, warm-up and "
                            "graph-captured (graph replays uncounted); each "
                            "call is one kernel",
            "max_abs_err": worst, "ms": ms, "ms_nonoise": ms_nonoise,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "library_ms": None,
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
    int8 kernel once; one more call with 10-bit codes takes the float
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
    # float kernel: one call at the QR 26 dB point's ADC with 10-bit codes
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
        "codes on the int8 route, one of 10-bit codes on the float one)")
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
# phase archs: the dense public architectures at full width
# ---------------------------------------------------------------------------

PROMPTS = "16,512,64,300,128,33,480,256"
SHORT_PROMPTS = "5,9,32,4,17,6"
# gemma2-9b's window-crossing request: 4100 prompt tokens and 32 new ones
# wrap its local layers' 4096-token rings
WINDOW_PROMPT, WINDOW_GEN = 4100, 32
# twice the largest logit deviation between that request's engine and solo
# runs, all 32 tokens equal (0.1255, NVIDIA H100 80GB HBM3, 700.00 W;
# PERF.md §6)
WINDOW_DEV_CAP = 2 * 0.1255
# recurrentgemma-2b's long request: 2100 prompt tokens wrap its local
# layers' 2048-token rings
RG_LONG_PROMPT = 2100
# (arch, substrate, CLI arguments): full published widths and depths, bf16,
# seeded random weights
ARCH_RUNS = (
    ("phi3-mini-3.8b", "digital",
     ["--batch", "8", "--requests", "8", "--prompt-lens", PROMPTS, "--gen",
      "32", "--chunk", "8", "--energy-report"]),
    ("phi3-mini-3.8b", "imc_bitserial",
     ["--batch", "4", "--requests", "6", "--prompt-lens", SHORT_PROMPTS,
      "--gen", "8", "--chunk", "4", "--imc-mode", "imc_bitserial"]),
    ("phi3-mini-3.8b", "imc_analytic",
     ["--batch", "4", "--requests", "6", "--prompt-lens", SHORT_PROMPTS,
      "--gen", "16", "--chunk", "8", "--imc-mode", "imc_analytic",
      "--imc-policy", "frozen"]),
    ("gemma2-9b", "digital",
     ["--batch", "8", "--requests", "9", "--prompt-lens",
      f"{WINDOW_PROMPT},{PROMPTS}", "--gen", str(WINDOW_GEN), "--chunk",
      "8"]),
    ("gemma2-9b", "imc_bitserial",
     ["--batch", "4", "--requests", "6", "--prompt-lens", SHORT_PROMPTS,
      "--gen", "8", "--chunk", "4", "--imc-mode", "imc_bitserial"]),
    ("granite-20b", "digital",
     ["--batch", "8", "--requests", "8", "--prompt-lens", PROMPTS, "--gen",
      "32", "--chunk", "8"]),
    ("deepseek-coder-33b", "digital",
     ["--batch", "4", "--requests", "8", "--prompt-lens", PROMPTS, "--gen",
      "16", "--chunk", "8"]),
    ("mamba2-2.7b", "digital",
     ["--batch", "8", "--requests", "8", "--prompt-lens", PROMPTS, "--gen",
      "32", "--chunk", "8"]),
    ("mamba2-2.7b", "imc_bitserial",
     ["--batch", "4", "--requests", "6", "--prompt-lens", SHORT_PROMPTS,
      "--gen", "8", "--chunk", "4", "--imc-mode", "imc_bitserial"]),
    ("recurrentgemma-2b", "digital",
     ["--batch", "8", "--requests", "9", "--prompt-lens",
      f"{RG_LONG_PROMPT},{PROMPTS}", "--gen", "32", "--chunk", "8"]),
    ("recurrentgemma-2b", "imc_bitserial",
     ["--batch", "4", "--requests", "6", "--prompt-lens", SHORT_PROMPTS,
      "--gen", "8", "--chunk", "4", "--imc-mode", "imc_bitserial"]),
    ("granite-moe-1b-a400m", "digital",
     ["--batch", "8", "--requests", "8", "--prompt-lens", PROMPTS, "--gen",
      "32", "--chunk", "8"]),
    ("granite-moe-1b-a400m", "imc_bitserial",
     ["--batch", "4", "--requests", "6", "--prompt-lens", SHORT_PROMPTS,
      "--gen", "8", "--chunk", "4", "--imc-mode", "imc_bitserial"]),
    ("internvl2-2b", "digital",
     ["--batch", "8", "--requests", "8", "--prompt-lens", PROMPTS, "--gen",
      "32", "--chunk", "8"]),
)
# dbrx-132b at full width and 8 of its 40 layers (see ``serve_dbrx``)
DBRX_LAYERS = 8


def free_device():
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def window_solo(cfg, params, prompt, engine_tokens, engine_logits):
    """The window-crossing request alone, through ``prefill`` and
    ``decode_step`` on contiguous caches (no engine), teacher-forced on the
    engine's tokens: the solo greedy pick at every position must be the
    engine's token (then the solo greedy run IS the engine's tokens).  Where
    it is not, the pick is reported with both runs' logits, and it passes
    only if the engine's own margin between the two tokens is within the
    two runs' logit deviation there (batch shapes change cuBLAS's bf16
    summation order); the deviation may be at most ``WINDOW_DEV_CAP`` at
    every position."""
    import torch

    from repro_torch.models import decode_step, prefill

    dev = params["embed"].device
    n = len(prompt)
    with torch.inference_mode():
        logits, cache = prefill(params, cfg,
                                torch.as_tensor(prompt, device=dev)[None],
                                n + len(engine_tokens) + 8)
        rows = [logits[0, -1].float().cpu()]
        for tok in engine_tokens[:-1]:
            logits, cache = decode_step(
                params, cfg, torch.tensor([tok], device=dev), cache)
            rows.append(logits[0, 0].float().cpu())
    del cache
    same, edges, worst = 0, [], 0.0
    for i, (tok, solo) in enumerate(zip(engine_tokens, rows)):
        eng = engine_logits[i]
        dev_i = float((eng - solo).abs().max())
        worst = max(worst, dev_i)
        if dev_i > WINDOW_DEV_CAP:
            raise AssertionError(f"gemma2 window request: logits deviate by "
                                 f"{dev_i!r} at {i}, above the cap "
                                 f"{WINDOW_DEV_CAP!r}")
        pick = int(torch.argmax(solo))
        if pick == tok:
            same += 1
            continue
        margin = float(eng[tok] - eng[pick])
        edges.append(f"token {i}: engine {tok}, solo {pick}, engine margin "
                     f"{margin!r}, logit deviation {dev_i!r}")
        if margin > dev_i:
            raise AssertionError(f"gemma2 window request: solo pick {pick} "
                                 f"!= engine token {tok} at {i} beyond the "
                                 f"runs' deviation: {edges[-1]}")
    return same, edges, worst


def phase_archs():
    """``ARCH_RUNS`` through the CLI entry point: every request served with
    tokens in the vocabulary, one paged-attention launch per global layer
    and decode step at the architecture's layout, the bit-serial kernel on
    the bit-serial runs, the init peak under 1.1x the weight bytes; then
    gemma2's window-crossing request alone (``window_solo``)."""
    import torch

    from repro_torch import configs
    from repro_torch.kernels import imc_mvm
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.launch import serve

    totals, layouts = {}, {}
    for arch, mode, args in ARCH_RUNS:
        cfg = configs.get(arch)
        label = f"{arch} {mode}"
        free_device()
        reset_counts()
        pa.paged_attention_cuda.layouts = {}
        window = arch == "gemma2-9b" and mode == "digital"
        with contextlib.ExitStack() as stack:
            # record the logits of the window request only (rid 0)
            probes = (stack.enter_context(probing(rids={0})) if window
                      else None)
            rep = serve.main(["--arch", arch, "--seed", "0"] + args)
        torch.cuda.synchronize()
        counts = read_counts()
        lay = dict(pa.paged_attention_cuda.layouts)
        eng, fin = rep["engine"], rep["finished"]
        bad = [r.rid for r in fin if r.error is not None]
        if bad:
            raise AssertionError(f"{label}: requests {bad} failed")
        for r in fin:
            if len(r.out) != r.max_new or not all(
                    0 <= t < cfg.vocab_size for t in r.out):
                raise AssertionError(f"{label}: request {r.rid} produced "
                                     f"{r.out}")
        check_layouts(label, cfg, lay, eng.decode_steps)
        if mode == "imc_bitserial" and counts["bitserial"] <= 0:
            raise AssertionError(f"{label}: the bit-serial kernel never "
                                 f"launched: {counts}")
        peak_init, weights = rep["init_peak_bytes"], rep["weight_bytes"]
        if peak_init > 1.1 * weights:
            raise AssertionError(f"{label}: init peak {peak_init} bytes > "
                                 f"1.1 x {weights} weight bytes")
        say("archs", f"{label}: " + arch_line(cfg, eng, rep, weights,
                                              peak_init) + f"; launches "
            f"{counts}, paged by layout {lay}")
        meter = rep["meter"]
        if meter is not None:
            from repro_torch.launch.metering import format_report

            say("archs", f"{label} energy (billed prefill tokens "
                f"{meter.prefill_billed_tokens}, decode tokens "
                f"{meter.decode_billed_tokens}):\n"
                + format_report(rep["energy"]))
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v
        for k, v in lay.items():
            layouts[k] = layouts.get(k, 0) + v
        if window:
            req = next(r for r in fin if r.rid == 0)
            if len(req.prompt) != WINDOW_PROMPT:
                raise AssertionError("the window request is not rid 0")
            probe = probes[-1]
            eng_logits = [probe.logits[(req.rid, i)]
                          for i in range(len(req.out))]
            params = eng.params
            del rep, eng, fin, probes, probe
            free_device()
            same, edges, worst = window_solo(cfg, params, req.prompt,
                                             req.out, eng_logits)
            say("archs", f"gemma2-9b window-crossing request alone "
                f"(prefill {WINDOW_PROMPT} tokens + {WINDOW_GEN - 1} "
                f"decode_step, contiguous caches, local rings of "
                f"{cfg.window} wrapped): solo greedy pick equals the "
                f"engine's token at {same} of {len(req.out)} positions; "
                f"largest logit deviation {worst:.4g}"
                + (f"; knife edges: {'; '.join(edges)}" if edges else ""))
            del params
        else:
            del rep, eng, fin
    free_device()
    counts, lay = serve_dbrx()
    for k, v in counts.items():
        totals[k] = totals.get(k, 0) + v
    for k, v in lay.items():
        layouts[k] = layouts.get(k, 0) + v
    free_device()
    for key in [*totals]:
        if key.startswith("analytic"):
            del totals[key]
    totals.update({f"paged_attention[{k}]": v for k, v in layouts.items()})
    return totals


def check_layouts(label, cfg, lay, steps):
    """One paged-attention launch per global layer (remainder layers
    included) and decode step, all at the architecture's layout; none where
    nothing is paged (mamba2, recurrentgemma)."""
    import torch

    from repro_torch.kernels import paged_attention as pa

    kinds = cfg.pattern * cfg.n_full_cycles + cfg.tail_kinds
    n_global = kinds.count("attn")
    want = pa.layout_key(cfg.n_kv_heads, cfg.q_per_kv,
                         cfg.resolved_head_dim, torch.bfloat16)
    expect = {want: n_global * steps} if n_global else {}
    if lay != expect:
        raise AssertionError(f"{label}: paged launches by layout {lay}, want "
                             f"{n_global} global layers x {steps} steps at "
                             f"{want}")


def arch_line(cfg, eng, rep, weights, peak_init):
    """One served architecture's numbers: shapes, memory (weights, init and
    serve peaks, KV pool, rings and recurrent state per slot) and the
    serve's throughput and TTFT."""
    import torch

    peak = torch.cuda.max_memory_allocated()
    fin = rep["finished"]
    attn = (f"(Hkv, G, hd) = ({cfg.n_kv_heads}, {cfg.q_per_kv}, "
            f"{cfg.resolved_head_dim})"
            if {"attn", "local"} & set(cfg.pattern) else "no attention")
    return (f"{cfg.n_layers} layers d_model {cfg.d_model} {attn}; "
            f"weights {weights / 1e9:.2f} GB, peak after init "
            f"{peak_init / 1e9:.2f} GB ({peak_init / weights:.3f}x), after "
            f"serving {peak / 1e9:.2f} GB; KV pool "
            f"{eng.kv_pool_bytes() / 1e9:.3f} GB ("
            f"{eng._fixed_kv_bytes / 1e9:.3f} GB of rings and recurrent "
            f"state; recurrent state {eng.state_bytes_per_slot} bytes per "
            f"slot); {len(fin)} requests, {rep['tokens']} tokens in "
            f"{rep['seconds']:.2f} s, {rep['tok_s']:.1f} tok/s, mean TTFT "
            f"{rep['ttft_ms']:.1f} ms, {eng.decode_steps} decode steps, "
            f"{eng.prefill_calls} prefills")


def serve_dbrx():
    """dbrx-132b at full width (d_model 6144, 16 experts of d_ff 10752, GQA
    48/8 at hd 128) and ``DBRX_LAYERS`` of its 40 layers: each layer holds
    about 3.26 B parameters (6.5 GB in bf16), the embedding and head 2.47
    GB, so 8 layers take about 54.6 GB and 10 would leave no room to serve
    on 80 GB.  The serve CLI has no depth flag (the reference's has none),
    so this builds the cut config, ``init_params`` and the ``Engine`` itself
    and serves digital traffic through ``serve``: 4 slots, the mixed
    prompts, 16 new tokens.  Returns (launch counts, paged launches by
    layout)."""
    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.launch import serve
    from repro_torch.models import init_params, param_bytes

    full = configs.get("dbrx-132b")
    cfg = full.replace(n_layers=DBRX_LAYERS)
    label = f"dbrx-132b digital ({DBRX_LAYERS} of {full.n_layers} layers)"
    lens = [int(n) for n in PROMPTS.split(",")]
    gen = 16
    reset_counts()
    pa.paged_attention_cuda.layouts = {}
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, seed=0, device="cuda")
    weights = param_bytes(params)
    peak_init = torch.cuda.max_memory_allocated() - base
    if peak_init > 1.1 * weights:
        raise AssertionError(f"{label}: init peak {peak_init} bytes > 1.1 x "
                             f"{weights} weight bytes")
    say("archs", f"reduced: n_layers {full.n_layers} -> {DBRX_LAYERS} "
        f"(dbrx-132b: {weights / 1e9:.2f} GB of weights at {DBRX_LAYERS} "
        f"layers; about 6.5 GB a layer in bf16, so 40 layers, about 263 GB, "
        f"wait for tensor-parallel serving over four cards)")
    rnp = np.random.default_rng(0)
    reqs = [serve.Request(rid=i, prompt=rnp.integers(0, cfg.vocab_size, n),
                          max_new=gen) for i, n in enumerate(lens)]
    cache_len = max(lens) + gen + 8
    engine = serve.Engine(cfg, params, 4, cache_len, max_chunk=8)
    t0 = time.perf_counter()
    fin = serve.serve(engine, reqs)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = read_counts()
    lay = dict(pa.paged_attention_cuda.layouts)
    for r in fin:
        if r.error is not None or len(r.out) != gen or not all(
                0 <= t < cfg.vocab_size for t in r.out):
            raise AssertionError(f"{label}: request {r.rid} produced "
                                 f"{r.out} ({r.error})")
    check_layouts(label, cfg, lay, engine.decode_steps)
    tokens = sum(len(r.out) for r in fin)
    ttfts = [r.ttft for r in fin if r.ttft is not None]
    rep = {"finished": fin, "tokens": tokens, "seconds": dt,
           "tok_s": tokens / dt, "ttft_ms": 1e3 * float(np.mean(ttfts))}
    say("archs", f"{label}: " + arch_line(cfg, engine, rep, weights,
                                          peak_init)
        + f"; launches {counts}, paged by layout {lay}")
    del params, engine, fin, reqs
    return counts, lay


# ---------------------------------------------------------------------------
# mesh: tensor-parallel serving
# ---------------------------------------------------------------------------

MESH_RANKS = 4
MESH_LENS = [16, 64, 33, 128]
MESH_GEN = 8
# the drift case scales every mlp.wi weight by this after its first two
# requests (the CLI's --inject-drift 2.5@2)
MESH_DRIFT = 2.5
# fault votes timed alone after the cases
MESH_VOTES = 200
# (label, arch, layers kept (None: all), substrate, noise seed, requests
# (the first of MESH_LENS), cap, feature, the one device held against):
# full published widths; dbrx-132b and granite-20b cut in depth only
# (reduced).  The bit-serial cases keep two of the four slots idle, whose
# rows enter their batch-wide dynamic ranges, and must give the one
# device's tokens exactly (cap None): their banks are whole and their
# noise sites and gain are the single device's.  The others may differ
# only at knife edges, with the two runs' logits at most ``cap`` apart:
# twice the deviation of the case's runs on an H100 (both runs are
# deterministic, so a run repeats it; a rank's cuBLAS products are not one
# device's to the last bit, and a bf16 rounding then moves by one unit).
# ``feature``: "calibrate" freezes the analytic substrate on the ranks'
# shards (one device: on the whole model), "drift" samples and checks
# every chunk and scales mlp.wi after two requests, "fault" raises a
# transient error on rank 2 alone before decode chunk 1, "swap" moves
# frozen analytic to frozen bit-serial after the first chunk.  The one
# device is "plain" (under the cap), "split": one device whose row sites
# are split as the ranks split them (:func:`split_k_rows`), which the run
# must equal bit for bit (:func:`split_k_parity`: tokens, counters, every
# logit), or "both".  mamba2-2.7b digital is not held against "split": a
# rank's in_proj over its column segments rounds apart from the same
# columns of one product over all of them; dbrx-132b and granite-20b are
# held under their caps alone
MESH_CASES = (
    ("musicgen-medium digital", "musicgen-medium", None, "digital", None, 4,
     2 * 0.0546875, None, "both"),
    ("musicgen-medium imc_bitserial (noise and gain, seed 7)",
     "musicgen-medium", None, "imc_bitserial", 7, 2, None, None, "plain"),
    ("musicgen-medium imc_analytic frozen", "musicgen-medium", None,
     "imc_analytic", None, 4, 2 * 0.30078125, None, "both"),
    ("dbrx-132b digital", "dbrx-132b", 4, "digital", None, 4,
     2 * 0.59375, None, "plain"),
    ("granite-20b digital", "granite-20b", 2, "digital", None, 4,
     2 * 0.0625, None, "plain"),
    ("mamba2-2.7b digital", "mamba2-2.7b", None, "digital", None, 4,
     2 * 0.3662109375, None, "plain"),
    ("mamba2-2.7b imc_bitserial (noise and gain, seed 7)", "mamba2-2.7b",
     None, "imc_bitserial", 7, 2, None, None, "plain"),
    ("recurrentgemma-2b digital", "recurrentgemma-2b", None, "digital",
     None, 4, 2 * 0.13671875, None, "both"),
    ("musicgen-medium imc_analytic frozen on the ranks' shards",
     "musicgen-medium", None, "imc_analytic", None, 4, None, "calibrate",
     "split"),
    ("musicgen-medium imc_analytic frozen, drift injected",
     "musicgen-medium", None, "imc_analytic", None, 4, None, "drift",
     "split"),
    ("musicgen-medium digital, a fault on rank 2", "musicgen-medium", None,
     "digital", None, 4, None, "fault", "split"),
    ("musicgen-medium imc_analytic frozen, swapped to imc_bitserial",
     "musicgen-medium", None, "imc_analytic", None, 4, None, "swap",
     "split"),
)


def mesh_cfg(case, calibration):
    """A ``MESH_CASES`` entry's config; a frozen analytic substrate takes
    ``calibration`` (a dict, measured on the whole model), except where the
    case calibrates itself."""
    from repro_torch import configs
    from repro_torch.core import substrate as substrate_lib
    from repro_torch.core.imc_linear import IMCConfig

    _, arch, layers, mode = case[:4]
    cfg = configs.get(arch)
    if layers is not None:
        cfg = cfg.replace(n_layers=layers)
    if mode != "digital":
        sub = substrate_lib.as_substrate(
            IMCConfig(mode=mode, bx=7, bw=7, v_wl=0.7))
        if mode == "imc_analytic" and case[7] != "calibrate":
            sub = sub.frozen(substrate_lib.Calibration.from_dict(calibration))
        cfg = cfg.replace(imc=sub)
    return cfg


def mesh_calibrated(cfg, params, mesh=None):
    """``cfg`` frozen as the CLI freezes it: on a seeded (2, 128) reference
    batch, recorded on this rank's shards of ``mesh`` and reduced over the
    group (one device: on the whole model)."""
    import numpy as np

    from repro_torch.core import parallel
    from repro_torch.core import substrate as substrate_lib
    from repro_torch.launch import sharding

    ref = np.random.default_rng(1).integers(0, cfg.vocab_size,
                                            (2, max(MESH_LENS)))
    group = sharding.shard_group(cfg, mesh) if mesh is not None else None
    with parallel.use(group):
        return substrate_lib.calibrate_model(cfg, params, [ref])


def mesh_serve(case, cfg, params, mesh=None, force=None):
    """Serve a ``MESH_CASES`` entry's prompts (``MESH_GEN`` new tokens
    each) under a :class:`TokenProbe`, on one device or as this rank of
    ``mesh``, with the case's feature; returns (tokens, counters as JSON,
    probe, engine, seconds, what the feature's holds read)."""
    import numpy as np
    import torch

    from repro_torch.core import substrate as substrate_lib
    from repro_torch.core.imc_linear import IMCConfig
    from repro_torch.launch import serve
    from repro_torch.runtime import drift as drift_lib
    from repro_torch.runtime import fault as fault_lib

    label, rng, n_req, feature = case[0], case[4], case[5], case[7]
    rnp = np.random.default_rng(0)
    reqs = [serve.Request(rid=i, prompt=rnp.integers(0, cfg.vocab_size, n),
                          max_new=MESH_GEN)
            for i, n in enumerate(MESH_LENS[:n_req])]
    extra, kw = {}, {}
    if feature == "calibrate":
        cfg = mesh_calibrated(cfg, params, mesh)
        extra["calibration"] = cfg.imc.calibration.to_dict()
    reports = []
    if feature == "drift":
        mon = drift_lib.DriftMonitor(drift_lib.DriftConfig(
            sample_every=1, check_every=1))
        check = mon.check

        def logged(frozen):
            report = check(frozen)
            if report is not None:
                reports.append((mon.chunks_seen, report.drifted_sites))
            return report

        mon.check = logged
        kw["drift_monitor"] = mon
    if feature == "fault" and mesh is not None:
        fired = []

        def injector(phase, info):
            if (phase == "decode" and info == 1 and mesh.rank == 2
                    and not fired):
                fired.append(info)
                raise fault_lib.TransientDeviceError("injected on rank 2")

        kw["failure_injector"] = injector
    with probing(force=force) as probes:
        eng = serve.Engine(cfg, params, 4, max(MESH_LENS) + MESH_GEN + 8,
                           rng=rng, max_chunk=8, mesh=mesh, **kw)
        t0 = time.perf_counter()
        if feature == "drift":
            serve.serve(eng, reqs[:2])
            eng.params = serve._scale_wi(eng.params, MESH_DRIFT)
            serve.serve(eng, reqs[2:])
            fin = eng.finished
        elif feature == "swap":
            pending = list(reqs)
            eng.admit_pending(pending)
            eng.decode_chunk()
            eng.swap_substrate(substrate_lib.as_substrate(
                IMCConfig(mode="imc_bitserial", bx=7, bw=7, v_wl=0.7)))
            while pending or eng.active:
                eng.admit_pending(pending)
                eng.decode_chunk()
            fin = eng.finished
        else:
            fin = serve.serve(eng, reqs)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    for r in fin:
        if r.error is not None or len(r.out) != MESH_GEN or not all(
                0 <= t < cfg.vocab_size for t in r.out):
            raise AssertionError(f"{label}: request {r.rid} produced "
                                 f"{r.out} ({r.error})")
    cnt = json.dumps({"prefill_calls": eng.prefill_calls,
                      "prefill_rows": eng.prefill_rows,
                      "decode_calls": eng.decode_calls,
                      "decode_steps": eng.decode_steps})
    extra.update(reports=reports, swaps=eng.swap_count, retries=eng.retries,
                 decode_failures=eng.decode_failures, votes=eng.votes,
                 vote_ms=1e3 * eng.vote_seconds / max(eng.votes, 1),
                 substrate_swaps=eng.substrate_swaps)
    return ({r.rid: list(r.out) for r in fin}, cnt, probes[-1], eng, dt,
            extra)


def mesh_rank(calibration):
    """One rank of the mesh phase: every ``MESH_CASES`` run on this rank's
    shard (``sharding.init_params``: drawn without the whole model), every
    rank on the one card over gloo.  Returns, on rank 0, each run's tokens,
    counters and logits and every rank's numbers."""
    import torch
    import torch.distributed as dist

    from repro_torch.kernels import paged_attention as pa
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import sharding
    from repro_torch.models import param_bytes

    torch.cuda.set_device(0)
    mesh = mesh_lib.make_serve_mesh(1, MESH_RANKS)
    results = []
    for case in MESH_CASES:
        cfg = mesh_cfg(case, calibration)
        free_device()
        base = torch.cuda.memory_allocated()
        params = sharding.init_params(cfg, mesh, seed=0, device="cuda")
        weights = param_bytes(params)
        peak_init = torch.cuda.max_memory_allocated() - base
        reset_counts()
        pa.paged_attention_cuda.layouts = {}
        out, cnt, probe, eng, dt, extra = mesh_serve(case, cfg, params,
                                                     mesh=mesh)
        mine = {"weights": weights, "peak_init": peak_init,
                "peak": torch.cuda.max_memory_allocated(),
                "pool": eng.kv_pool_bytes_per_device(),
                "state": eng._fixed_kv_bytes,
                "counts": read_counts(),
                "layouts": dict(pa.paged_attention_cuda.layouts),
                "seconds": dt, "retries": extra["retries"],
                "decode_failures": extra["decode_failures"],
                "votes": extra["votes"], "vote_ms": extra["vote_ms"]}
        ranks = [None] * MESH_RANKS
        dist.all_gather_object(ranks, mine)
        results.append({"out": out, "cnt": cnt, "logits": probe.logits,
                        "level": probe.level, "whole": eng.kv_pool_bytes(),
                        "kv_shard": eng.kv_shard, "extra": extra,
                        "steps": eng.decode_steps, "ranks": ranks})
        del params, eng, probe
    # the fault vote alone: a host all-reduce of one integer over the
    # group, timed after a barrier so no rank waits for another's work
    group = sharding.shard_group(mesh_cfg(MESH_CASES[0], calibration), mesh)
    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(MESH_VOTES):
        group.vote(False)
    results.append(1e3 * (time.perf_counter() - t0) / MESH_VOTES)
    return results


# musicgen-medium's matmul sites by shape (K, M) and how a mesh splits
# them: column sites keep K whole and split M, row sites split K (the
# partial sums are all-reduced)
SITE_SPLITS = (((1536, 1536), "attn.wq/wk/wv column, attn.wo row"),
               ((1536, 6144), "mlp.wi column"),
               ((6144, 1536), "mlp.wo row"),
               ((1536, 2048), "lm_head column"))


def mesh_numerics():
    """The diagnostic of the sharded runs' deviation from one device, at
    musicgen-medium's bf16 site shapes (``SITE_SPLITS``) and
    ``MESH_RANKS`` ranks, with 4 rows (a decode step of the mesh runs) and
    128 (a prefill), every shape split both ways: (1) each rank's column
    slice of the weight through ``torch.mm`` against the same columns of
    the whole product; (2) the row-parallel path of
    ``core.imc_linear._matmul`` (each rank's float32 partial over its share
    of K, summed in rank order, rounded to bf16 once) against one device's
    product.  Prints the count of elements that differ bitwise; returns
    the differing elements of the splits the mesh uses, column and row."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(0)
    tp, bf = MESH_RANKS, torch.bfloat16
    used = {"column": 0, "row": 0}
    for rows in (4, 128):
        for (k, m), sites in SITE_SPLITS:
            x = torch.randn((rows, k), generator=gen, device="cuda").to(bf)
            w = (torch.randn((k, m), generator=gen, device="cuda")
                 * k**-0.5).to(bf)
            whole = torch.mm(x, w)
            c, kk = m // tp, k // tp
            col = sum(int((torch.mm(x, w[:, r * c:(r + 1) * c].contiguous())
                           != whole[:, r * c:(r + 1) * c]).sum())
                      for r in range(tp))
            part = torch.zeros((rows, m), dtype=torch.float32, device="cuda")
            for r in range(tp):
                part += torch.mm(x[:, r * kk:(r + 1) * kk].contiguous(),
                                 w[r * kk:(r + 1) * kk].contiguous(),
                                 out_dtype=torch.float32)
            row = int((part.to(bf) != whole).sum())
            used["column"] += col if "column" in sites else 0
            used["row"] += row if "row" in sites else 0
            say("mesh", f"bitwise, {rows} x {k} @ {k} x {m} bf16 ({sites}) "
                f"at 1x{tp}: column slices differ from the whole product at "
                f"{col} of {rows * m} elements; the row-parallel float32 "
                f"partial sum, rounded once, at {row}")
    return used


def phase_colsplit():
    """Why :func:`split_k_rows` cannot reproduce mamba2-2.7b's 1x4 runs: at
    its ``in_proj`` (bf16, K 2560, 10576 columns; 3, 4, 33 and 128 rows,
    the engine's shapes), the count of elements where a rank's product
    over its column segments (``ssm.in_proj_columns``) differs bitwise
    from the same columns of one product over all of them.  Decides
    nothing; not run by default."""
    import torch

    from repro_torch import configs
    from repro_torch.models import ssm

    gen = torch.Generator(device="cuda").manual_seed(1)
    cfg = configs.get("mamba2-2.7b")
    seg = ssm.in_proj_columns(cfg, MESH_RANKS)
    k, m, n_diff, n_all = cfg.d_model, seg.total, 0, 0
    for rows in (3, 4, 33, 128):
        x = torch.randn((rows, k), generator=gen, device="cuda").to(
            torch.bfloat16)
        w = (torch.randn((k, m), generator=gen, device="cuda")
             * k**-0.5).to(torch.bfloat16)
        whole = torch.matmul(x, w)
        for r in range(MESH_RANKS):
            idx = seg.index(r, "cuda")
            part = torch.matmul(x, w[:, idx].contiguous())
            n_diff += int((part != whole[:, idx]).sum())
            n_all += part.numel()
    say("colsplit", f"mamba2-2.7b in_proj at 1x{MESH_RANKS}: a rank's "
        f"product over its column segments differs bitwise from the same "
        f"columns of one product at {n_diff} of {n_all} elements (bf16; "
        f"3, 4, 33 and 128 rows)")


@contextlib.contextmanager
def split_k_rows(cfg, n):
    """One device computing every row-parallel site of ``cfg`` as ``n``
    ranks do (``core.imc_linear._matmul`` under a shard group): ``n``
    float32 partial products over equal shares of K, added in rank order
    (``core.parallel.ShardGroup.sum``) and rounded to bf16 once.  A site
    that the mesh replicates (``sharding.replicated_sites``) runs whole on
    every rank, and so runs the one-device code here, as does every other
    site.  The models call ``linear`` by name, so each calling module's
    name is swapped for a wrapper that marks its split row sites."""
    import torch

    from repro_torch.core import imc_linear
    from repro_torch.launch import sharding
    from repro_torch.models import attention, layers, rglru, ssm, transformer

    modules = (attention, layers, transformer, ssm, rglru)
    inner_linear, inner_matmul = imc_linear.linear, imc_linear._matmul
    replicated = sharding.replicated_sites(cfg, n)
    row = []

    def linear(*a, split=None, site=None, **k):
        row.append(split == "row" and site not in replicated)
        try:
            return inner_linear(*a, split=split, site=site, **k)
        finally:
            row.pop()

    def matmul(x, w, tp=None):
        if tp is not None or not (row and row[-1]):
            return inner_matmul(x, w, tp)
        if x.dtype != torch.bfloat16 or not x.is_cuda:
            raise ValueError("split_k_rows mirrors the bf16 CUDA row sites")
        k = x.shape[-1] // n
        x2 = x.reshape(-1, x.shape[-1])
        acc = None
        for r in range(n):
            part = torch.mm(x2[:, r * k:(r + 1) * k].contiguous(),
                            w[r * k:(r + 1) * k].contiguous(),
                            out_dtype=torch.float32)
            acc = part if acc is None else acc.add_(part)
        return acc.reshape(*x.shape[:-1], w.shape[-1]).to(x.dtype)

    for mod in modules:
        mod.linear = linear
    imc_linear._matmul = matmul
    try:
        yield
    finally:
        for mod in modules:
            mod.linear = inner_linear
        imc_linear._matmul = inner_matmul


def split_k_parity(label, res, one):
    """Hold a 1x``MESH_RANKS`` run (``res``) against one device whose row
    sites are split as the ranks split them (:func:`split_k_rows`; ``one``
    is that run's tokens, counters and probe): tokens, counters and every
    logit, bit for bit.  Prints the verdict; returns the failure or
    None."""
    import torch

    out, cnt, probe = one
    keys = sorted(res["logits"])
    diff = [k for k in keys if k not in probe.logits
            or not torch.equal(probe.logits[k], res["logits"][k])]
    dev = max((float((probe.logits[k] - res["logits"][k]).abs().max())
               for k in diff if k in probe.logits), default=0.0)
    same = (out == res["out"] and cnt == res["cnt"]
            and probe.logits.keys() == res["logits"].keys())
    say("mesh", f"{label} against one device with its row sites split as "
        f"the ranks split them ({MESH_RANKS} float32 partials over equal "
        f"shares of K, added in rank order, rounded once): tokens "
        f"{'equal' if out == res['out'] else 'DIFFER'}, counters "
        f"{'equal' if cnt == res['cnt'] else 'DIFFER'}, {len(diff)} of "
        f"{len(keys)} logit rows differ bitwise (largest deviation {dev})")
    if same and not diff:
        return None
    return (f"{label}: one device with split row sites is not the mesh's "
            f"run bit for bit ({len(diff)} logit rows differ, largest "
            f"deviation {dev}; tokens {out} against {res['out']})")


def phase_mesh():
    """Tensor-parallel serving on the card.  (a) ``--mesh 1x1`` through the
    CLI: one rank over NCCL, full-width musicgen-medium, digital.  (b, c)
    ``MESH_RANKS`` ranks sharing the card over gloo (one process each):
    full-width musicgen-medium (24 heads, 6 per rank) on digital,
    bit-serial with noise and gain, and frozen analytic; dbrx-132b at full
    width and 4 of its 40 layers (4 experts and 2 KV heads per rank);
    granite-20b at 2 of its 52 layers (MQA: the pool replicated, 12 query
    heads per rank); mamba2-2.7b (20 SSD heads a rank, the B|C columns on
    every rank) digital and bit-serial; recurrentgemma-2b (10 query heads:
    the attention and its rings replicated, the RG-LRU width split)
    digital; musicgen-medium frozen analytic calibrated on the ranks'
    shards (the calibration held site by site at rel 1e-5 against the
    whole model's), with drift injected and every chunk sampled and
    checked (the same drift reports and swaps), digital with a transient
    error on rank 2 alone before decode chunk 1 (every rank retries once),
    and frozen analytic swapped to bit-serial after the first chunk.  Each
    run against the same run on one device (plain, or with its row sites
    split as the ranks split them, as the case says): bit-serial, the fault
    and the swap give identical greedy tokens and counters; the others
    too, except picks whose margin lies within the two runs' logit
    deviation, each printed, with the deviation at most the case's cap (a
    rank's cuBLAS products are not one device's to the last bit); one
    paged-attention launch per layer and decode step at the rank's layout;
    per-rank weight bytes, KV pool and state bytes per device, peak memory,
    tok/s (four processes time-sharing one card: not a scaling number) and
    the fault vote's ms.  Returns rank 0's launch counts.  The cases that
    ``MESH_CASES`` marks "split" or "both" are held bit for bit, every
    logit, against one device that splits its row sites' dot products as
    the ranks do (:func:`split_k_parity`): the only difference between the
    mesh and one device."""
    import types

    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.core import substrate as substrate_lib
    from repro_torch.core.imc_linear import IMCConfig
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import sharding
    from repro_torch.models import init_params

    totals, layouts, split_k_failures = {}, {}, []
    free_device()
    used = mesh_numerics()
    say("mesh", f"at the splits the mesh uses: column sites differ from one "
        f"device's product at {used['column']} elements, row sites at "
        f"{used['row']} (one product over K is not the sum of four over "
        f"its quarters: the caps of MESH_CASES; split_k_parity holds the "
        f"rest bit for bit)")
    argv = ["--arch", "musicgen-medium", "--batch", "4", "--requests",
            str(len(MESH_LENS)), "--prompt-lens",
            ",".join(map(str, MESH_LENS)), "--gen", str(MESH_GEN), "--seed",
            "0", "--mesh", "1x1"]
    counts, rep = serve_run("musicgen-medium digital --mesh 1x1 (one rank "
                            "over NCCL)", argv, 48, 2048)
    if rep["engine"].mesh_shape != "1x1":
        raise AssertionError(f"--mesh 1x1 served on {rep['engine'].mesh_shape}")
    for k, v in counts.items():
        totals[k] = totals.get(k, 0) + v
    del rep
    free_device()

    # the frozen analytic case's calibration, measured on the whole model
    cfg = configs.get("musicgen-medium").replace(
        imc=substrate_lib.as_substrate(
            IMCConfig(mode="imc_analytic", bx=7, bw=7, v_wl=0.7)))
    params = init_params(cfg, seed=0, device="cuda")
    ref = np.random.default_rng(1).integers(0, cfg.vocab_size,
                                            (2, max(MESH_LENS)))
    calibration = substrate_lib.calibrate_model(
        cfg, params, [ref]).imc.calibration.to_dict()
    del params
    free_device()

    t0 = time.perf_counter()
    results = mesh_lib.launch(MESH_RANKS, "gloo", mesh_rank, calibration)
    say("mesh", f"{MESH_RANKS} ranks on one card over gloo: "
        f"{len(MESH_CASES)} runs in {time.perf_counter() - t0:.1f} s "
        f"(starting the rank processes included)")
    vote_ms = results.pop()
    say("mesh", f"the fault vote alone (a host all-reduce of one integer "
        f"over gloo, {MESH_VOTES} calls after a barrier): {vote_ms:.4f} ms "
        f"a call on rank 0; in the runs below a rank's vote also waits for "
        f"the slowest rank to reach it")
    free_device()
    for case, res in zip(MESH_CASES, results):
        label, feature = f"{case[0]} at 1x{MESH_RANKS}", case[7]
        cfg = mesh_cfg(case, calibration)
        kinds = cfg.pattern * cfg.n_full_cycles + cfg.tail_kinds
        tp = MESH_RANKS
        if sharding.attention_whole(cfg, tp):  # every head on every rank
            hkv, g = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads
        else:
            hkv = cfg.n_kv_heads // tp if res["kv_shard"] else cfg.n_kv_heads
            g = cfg.n_heads // tp // (hkv if res["kv_shard"] else 1)
        n_attn = kinds.count("attn")
        want = ({pa.layout_key(hkv, g, cfg.resolved_head_dim,
                               torch.bfloat16): n_attn * res["steps"]}
                if n_attn else {})
        bitserial = case[3] == "imc_bitserial" or feature == "swap"
        for r, mine in enumerate(res["ranks"]):
            if mine["layouts"] != want:
                raise AssertionError(f"{label}: rank {r} paged launches by "
                                     f"layout {mine['layouts']}, want {want}")
            if bitserial and (mine["counts"]["bitserial"]
                              + mine["counts"]["bitserial_nogain"]) <= 0:
                raise AssertionError(f"{label}: rank {r} never launched the "
                                     f"bit-serial kernel")
        if res["kv_shard"] and res["ranks"][0]["pool"] * tp != res["whole"]:
            raise AssertionError(f"{label}: pool bytes per device x {tp} != "
                                 f"{res['whole']}")

        def run_a(force, res=res):
            return res["out"], res["cnt"], types.SimpleNamespace(
                logits=res["logits"], level=res["level"])

        whole = {}  # one device's weights, kept for reruns

        def one_device(force, split, case=case, cfg=cfg, whole=whole):
            if not whole:
                free_device()
                whole["params"] = init_params(cfg, seed=0, device="cuda")
            with (split_k_rows(cfg, MESH_RANKS) if split
                  else contextlib.nullcontext()):
                out, cnt, probe, eng, _, extra = mesh_serve(
                    case, cfg, whole["params"], force=force)
            del eng
            return out, cnt, probe, extra

        cap, one = case[6], None
        if case[8] != "split":
            b_runs = []

            def run_b(force, b_runs=b_runs, one_device=one_device):
                b_runs.append(one_device(force, False))
                return b_runs[-1][:3]

            verdict = tie_parity(label, run_a, run_b,
                                 ties=(cap is not None
                                       and case[3] == "imc_analytic"),
                                 edges=cap is not None, strict=cap is None,
                                 cap=cap, show_dev=True)
            say("mesh", f"{label} against one device: {verdict}")
            one = b_runs[0][3]
        if case[8] != "plain":
            split_run = one_device(None, True)
            failed = split_k_parity(label, res, split_run[:3])
            if failed is not None:
                split_k_failures.append(failed)
            one = split_run[3]
        # the feature's holds, against the one device's first run
        mine = res["extra"]
        if feature == "calibrate":
            # the ranks' forward differs from plain one device's by
            # cuBLAS's order at the row sites, which moves a bf16 activation
            # (and so a range) by an ulp: the hold is the split one device
            def rel(cal):
                return max((abs(mine["calibration"][site][f] - v) / abs(v),
                            site, f) for site, st in cal.items()
                           for f, v in st.items())

            held = rel(one["calibration"])
            if (mine["calibration"].keys() != one["calibration"].keys()
                    or held[0] > 1e-5):
                raise AssertionError(f"{label}: calibration on the shards "
                                     f"is rel {held} from split one "
                                     f"device's")
            say("mesh", f"{label}: {len(one['calibration'])} calibration "
                f"sites (x_max, w_max, sigma_yo) on the ranks' shards within "
                f"rel {held[0]!r} ({held[1]}.{held[2]}) of one device's with "
                f"the ranks' row splits (hold: 1e-5)")
        if feature == "drift":
            if (mine["reports"], mine["swaps"]) != (one["reports"],
                                                    one["swaps"]):
                raise AssertionError(f"{label}: drift reports {mine['reports']}"
                                     f" and {mine['swaps']} swaps, one device "
                                     f"{one['reports']} and {one['swaps']}")
            if not one["swaps"]:
                raise AssertionError(f"{label}: no drift was detected")
            say("mesh", f"{label}: the one device's drift reports (chunk, "
                f"drifted sites) {mine['reports']} and {mine['swaps']} "
                f"hot-swaps on every rank")
        if feature == "fault":
            got = [(m["retries"], m["decode_failures"])
                   for m in res["ranks"]]
            if got != [(1, 0)] * MESH_RANKS:
                raise AssertionError(f"{label}: (retries, decode failures) "
                                     f"by rank {got}, want one retry each")
            say("mesh", f"{label}: every rank retried decode chunk 1 once "
                f"(retries, decode failures by rank {got})")
        if feature == "swap" and mine["substrate_swaps"] != 1:
            raise AssertionError(f"{label}: {mine['substrate_swaps']} swaps")
        whole.clear()
        free_device()
        tokens = sum(len(o) for o in res["out"].values())
        for r, mine in enumerate(res["ranks"]):
            say("mesh", f"{label} rank {r}: weights {mine['weights'] / 1e9:.3f}"
                f" GB, init peak {mine['peak_init'] / 1e9:.3f} GB, KV pool "
                f"{mine['pool'] / 1e6:.2f} MB on the device (whole "
                f"{res['whole'] / 1e6:.2f} MB, "
                f"{'head-sharded' if res['kv_shard'] else 'replicated'}; "
                f"rings and recurrent state {mine['state'] / 1e6:.2f} MB), "
                f"peak {mine['peak'] / 1e9:.3f} GB, {tokens} tokens in "
                f"{mine['seconds']:.2f} s = {tokens / mine['seconds']:.1f} "
                f"tok/s (four processes time-sharing one card, not a "
                f"scaling number); "
                + (f"fault vote {mine['vote_ms']:.3f} ms a call over "
                   f"{mine['votes']} calls" if mine["votes"]
                   else "no fault vote (no injector)")
                + f"; launches "
                f"{mine['counts']}, paged by layout {mine['layouts']}")
        for k, v in res["ranks"][0]["counts"].items():
            totals[k] = totals.get(k, 0) + v
        for k, v in res["ranks"][0]["layouts"].items():
            layouts[k] = layouts.get(k, 0) + v
    if split_k_failures:
        raise AssertionError("; ".join(split_k_failures))
    for key in [*totals]:
        if key.startswith("analytic"):
            del totals[key]
    totals.update({f"paged_attention[{k}]": v for k, v in layouts.items()})
    return totals


# ---------------------------------------------------------------------------
# train: single-device training at full width
# ---------------------------------------------------------------------------

# full-width musicgen-medium through ``launch.train.main`` (bf16, seeded
# random weights, the synthetic pipeline), 8 x 512 tokens a step
TRAIN_ARGV = ["--arch", "musicgen-medium", "--batch", "8", "--seq", "512",
              "--lr", "1e-3", "--log-every", "1"]
TRAIN_STEPS, TRAIN_RESUME_STEPS, TRAIN_SAVE_EVERY, IMC_TRAIN_STEPS = 12, 18, 6, 4
# NVIDIA H100 SXM published dense bf16 tensor-core peak
BF16_FLOPS_PER_S = 989e12
# one layer's attention held in (d), (B, S, H, hd): musicgen at the run's
# shape (one 512 x 1024 block: both ways keep a whole score block), and a
# 2048-token sequence of 4 x 2 blocks (autograd keeps every block)
ATTN_SHAPES = ((8, 512, 24, 64), (2, 2048, 24, 64))


def train_run(label, argv):
    """Train in-process through the CLI entry point on the card; returns
    (state, history, peak device bytes of the run, seconds).  Every loss
    must be finite."""
    import math

    import torch

    from repro_torch.launch import train

    free_device()
    t0 = time.perf_counter()
    state, hist = train.main(argv)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    losses = hist["loss"]
    if not losses or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"train {label}: losses {losses}")
    return state, hist, peak, dt


def step_report(label, hist) -> float:
    """Print each step's loss, grad norm and lr; returns the median ms a
    step after the first (which builds and warms up)."""
    import numpy as np

    for r in hist["steps"]:
        say("train", f"{label} step {r['step']}: loss {r['loss']:.4f}, grad "
            f"norm {r['grad_norm']:.4f}, lr {r['lr']:.4e}, {r['ms']:.1f} ms")
    return float(np.median([r["ms"] for r in hist["steps"][1:]]))


def train_flops(cfg, n_params, batch, seq):
    """Model FLOPs of one train step: 6 N per token for the weights, plus
    causal attention (QK^T and PV over the lower triangle, forward and
    twice that backward: 6 B H S^2 hd a layer); recomputation excluded."""
    attn = 6 * batch * cfg.n_heads * seq * seq * cfg.resolved_head_dim \
        * cfg.n_layers
    return 6 * n_params * batch * seq + attn


def check_resumed_state(ckpt_dir, step, state):
    """The checkpoint at ``step`` restores to ``state`` bit for bit."""
    import torch

    from repro_torch import checkpoint, tree

    restored, extra = checkpoint.restore(ckpt_dir, step, state)
    if extra.get("next_step") != step:
        raise AssertionError(f"train: checkpoint {step} extra {extra}")
    bad = [p for (p, a), (_, b) in zip(tree.flatten_with_path(state),
                                       tree.flatten_with_path(restored))
           if a.dtype != b.dtype or not torch.equal(a, b)]
    if bad:
        raise AssertionError(f"train: step {step} restored != saved at {bad}")
    n = len(tree.leaves(state))
    del restored
    return n


def attention_fwd_bwd(dev, shape):
    """(d) One layer's attention at ``shape`` in float32: the flash
    Function (recompute backward) against plain autograd through the blocked
    forward: peak bytes above the inputs and ms of forward + backward
    (CUDA events, mean of 5 after one warm-up), gradients at rel 1e-5."""
    import torch

    from repro_torch import configs
    from repro_torch.models import attention as attn
    from repro_torch.models import transformer as tf

    b, s, h, hd = shape
    dims = tf.attn_dims(configs.get("musicgen-medium"), "attn")
    gen = torch.Generator(device=dev).manual_seed(0)
    q, k, v, dout = (torch.randn((b, s, h, hd), generator=gen, device=dev)
                     for _ in range(4))
    q, k, v = (t.requires_grad_() for t in (q, k, v))

    def plain(q, k, v, dims):
        return attn.flash_forward(q, k, v, dims)[0].reshape(q.shape)

    out = {}
    for name, fn in (("Function", attn.flash_attention), ("plain", plain)):
        def run():
            return torch.autograd.grad(fn(q, k, v, dims), (q, k, v), dout)

        free_device()
        base = torch.cuda.memory_allocated()
        grads = run()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        for _ in range(5):
            run()
        ev[1].record()
        torch.cuda.synchronize()
        out[name] = (grads, peak, ev[0].elapsed_time(ev[1]) / 5)
    for gname, gf, gp in zip("qkv", out["Function"][0], out["plain"][0]):
        err = float((gf - gp).abs().max() / gp.abs().max())
        if not err <= 1e-5:
            raise AssertionError(f"train: d{gname} of the flash Function "
                                 f"off plain autograd by {err:.2e}")
    for name in ("Function", "plain"):
        say("train", f"attention {shape} float32 {name}: forward + backward "
            f"{out[name][2]:.3f} ms, peak {out[name][1] / 1e9:.3f} GB above "
            f"the inputs")


def profile_train_step(dev):
    """(e) One full-width musicgen-medium train step (8 x 512 tokens) under
    ``torch.profiler`` (``profiled``): device time by kernel against the
    wall time; then the forward + backward and the AdamW update timed apart
    (CUDA events)."""
    import torch

    from repro_torch import configs, tree
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.launch import steps as steps_lib
    from repro_torch.models import loss_fn
    from repro_torch.optim import AdamWConfig, update

    cfg = configs.get("musicgen-medium")
    bundle = steps_lib.build_train_step(cfg, AdamWConfig(lr=1e-3),
                                        total_steps=TRAIN_STEPS, device=dev)
    state = bundle.init_state(0)
    tokens = torch.from_numpy(SyntheticLM(DataConfig(
        seed=0, vocab_size=cfg.vocab_size, seq_len=512,
        global_batch=8)).batch(0)["tokens"]).to(dev)

    def step():
        nonlocal state
        state, _ = bundle.step_fn(state, {"tokens": tokens})

    profiled("train step", step, "musicgen-medium full width, 8 x 512 "
             "tokens", 1)
    leaves = tree.leaves(state["params"])
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ev[0].record()
    for p in leaves:
        p.requires_grad_(True)
    loss, _ = loss_fn(state["params"], cfg, {"tokens": tokens})
    grads = torch.autograd.grad(loss, leaves)
    for p in leaves:
        p.requires_grad_(False)
    ev[1].record()
    update(tree.unflatten(state["params"], grads), state["opt"],
           state["params"], AdamWConfig(lr=1e-3), torch.tensor(
               1e-4, device=dev))
    ev[2].record()
    torch.cuda.synchronize()
    say("train", f"one full-width step apart: forward + backward "
        f"{ev[0].elapsed_time(ev[1]):.1f} ms, AdamW update "
        f"{ev[1].elapsed_time(ev[2]):.1f} ms")


def smoke_train_losses(device, steps=3):
    """(e) musicgen-medium SMOKE in float32: ``steps`` AdamW steps of the
    train step from the CPU generator's weights and the pipeline's batches
    on ``device``; returns the losses."""
    import torch

    from repro_torch import configs, tree
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.launch import steps as steps_lib
    from repro_torch.optim import AdamWConfig

    cfg = configs.get_smoke("musicgen-medium")
    bundle = steps_lib.build_train_step(cfg, AdamWConfig(lr=1e-3),
                                        total_steps=steps, device=device)
    state = tree.map_leaves(lambda t: t.to(device),
                            steps_lib.init_train_state(cfg, 0, "cpu"))
    data = SyntheticLM(DataConfig(seed=0, vocab_size=cfg.vocab_size,
                                  seq_len=32, global_batch=2))
    losses = []
    for i in range(steps):
        tokens = torch.from_numpy(data.batch(i)["tokens"]).to(device)
        state, met = bundle.step_fn(state, {"tokens": tokens})
        losses.append(float(met["loss"]))
    return losses


def phase_train(dev):
    """Single-device training on the card.  (a) full-width musicgen-medium
    (48 layers, d_model 1536, bf16, seeded random weights, 1.365 B
    parameters) through ``launch.train.main``: ``TRAIN_STEPS`` steps of 8 x
    512 tokens, checkpoints every ``TRAIN_SAVE_EVERY``: each step's loss,
    grad norm and lr, the median step, tokens/s, model FLOPs and their share
    of the bf16 dense peak, the peak memory against the bytes of parameters,
    gradients and Adam state; finite losses, the mean of the last 3 below
    the first 3 (the reference driver test's rule).  (b) The same directory
    resumed to ``TRAIN_RESUME_STEPS``: the step-12 checkpoint restores to the
    trained state bit for bit, exactly 6 new losses, step 18.  (c)
    ``IMC_TRAIN_STEPS`` steps each with ``--imc-mode imc_analytic`` and
    ``fakequant`` at the same shape.  (d) one layer's attention: the flash
    Function against plain autograd.  (e) a profile of one full-width
    step.  (f) the SMOKE train step, card against CPU in float32, losses at
    rel 1e-5.  No kernel of the repo's TPU kernels runs in training
    (counted)."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from repro_torch import configs, tree
    from repro_torch.models import param_bytes

    reset_counts()
    cfg = configs.get("musicgen-medium")
    tokens = 8 * 512
    root = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        free = shutil.disk_usage(root).free
        say("train", f"checkpoints under a temporary directory, "
            f"{free / 1e9:.0f} GB free")
        ckpt = str(Path(root) / "run")
        state, hist, peak, dt = train_run("full width", [
            *TRAIN_ARGV, "--steps", str(TRAIN_STEPS), "--save-every",
            str(TRAIN_SAVE_EVERY), "--ckpt-dir", ckpt])
        losses = hist["loss"]
        ms = step_report("full width", hist)
        n_params = sum(t.numel() for t in tree.leaves(state["params"]))
        p_bytes = param_bytes(state["params"])
        state_bytes = 2 * p_bytes + 8 * n_params  # params, grads, m and v
        flops = train_flops(cfg, n_params, 8, 512)
        say("train", f"musicgen-medium full width, {n_params} parameters "
            f"({p_bytes / 1e9:.3f} GB bf16), {TRAIN_STEPS} steps of {tokens} "
            f"tokens in {dt:.1f} s (checkpoints included): median "
            f"{ms:.1f} ms a step after the first, {tokens / ms * 1e3:.0f} "
            f"tokens/s; model FLOPs a step {flops:.4e} (6 N tokens "
            f"{6 * n_params * tokens:.4e} + attention), "
            f"{flops / (ms / 1e3) / 1e12:.1f} TFLOP/s = "
            f"{flops / (ms / 1e3) / BF16_FLOPS_PER_S:.3f} of the bf16 dense "
            f"peak; peak memory {peak / 1e9:.2f} GB against "
            f"{state_bytes / 1e9:.2f} GB of parameters, gradients and Adam "
            f"state ({peak / state_bytes:.2f}x)")
        if len(losses) != TRAIN_STEPS:
            raise AssertionError(f"train: {len(losses)} losses")
        if not np.mean(losses[-3:]) < np.mean(losses[:3]):
            raise AssertionError(f"train: the loss did not fall: {losses}")
        n = check_resumed_state(ckpt, TRAIN_STEPS, state)
        say("train", f"the step-{TRAIN_STEPS} checkpoint restores to the "
            f"trained state bit for bit ({n} leaves)")
        del state
        # the resume reads the newest checkpoint; the older one only fills
        # the disk
        shutil.rmtree(Path(ckpt) / f"step_{TRAIN_SAVE_EVERY:08d}")
        state, hist, _, dt = train_run("resume", [
            *TRAIN_ARGV, "--steps", str(TRAIN_RESUME_STEPS), "--save-every",
            str(TRAIN_SAVE_EVERY), "--ckpt-dir", ckpt])
        if len(hist["loss"]) != TRAIN_RESUME_STEPS - TRAIN_STEPS or \
                int(state["step"]) != TRAIN_RESUME_STEPS:
            raise AssertionError(f"train: resume gave {hist['loss']} at step "
                                 f"{int(state['step'])}")
        ms = step_report("resume", hist)
        say("train", f"resumed from step {TRAIN_STEPS} to "
            f"{TRAIN_RESUME_STEPS}: {len(hist['loss'])} new losses in "
            f"{dt:.1f} s, median {ms:.1f} ms a step")
        del state
        shutil.rmtree(ckpt)
        for mode in ("imc_analytic", "fakequant"):
            state, hist, peak, dt = train_run(mode, [
                *TRAIN_ARGV, "--steps", str(IMC_TRAIN_STEPS), "--imc-mode",
                mode, "--ckpt-dir", str(Path(root) / mode)])
            ms = step_report(mode, hist)
            say("train", f"--imc-mode {mode}: {IMC_TRAIN_STEPS} steps, "
                f"median {ms:.1f} ms a step after the first, peak memory "
                f"{peak / 1e9:.2f} GB, losses {hist['loss']}")
            del state
            shutil.rmtree(Path(root) / mode)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    counts = read_counts()
    if any(counts.values()):
        raise AssertionError(f"train: a kernel launched in training: {counts}")
    say("train", f"launches of the repo's kernels in training: {counts} "
        f"(none by design: dynamic IMC modes run as plain tensor code, full "
        f"sequences take flash attention)")

    for shape in ATTN_SHAPES:
        attention_fwd_bwd(dev, shape)
    free_device()
    profile_train_step(dev)
    free_device()
    want, got = smoke_train_losses("cpu"), smoke_train_losses(dev)
    if not np.allclose(got, want, rtol=1e-5, atol=0):
        raise AssertionError(f"train: SMOKE losses card {got} vs CPU {want}")
    say("train", f"SMOKE float32 train steps, card against CPU: losses "
        f"{got} vs {want}, largest relative difference "
        f"{max(abs(g - w) / abs(w) for g, w in zip(got, want)):.2e}")


# ---------------------------------------------------------------------------
# phase 6: card against CPU on the SMOKE config
# ---------------------------------------------------------------------------


# The cap on the logit deviation where phase 6 accepts knife edges: twice
# the largest deviation between the port's and the reference's bit-serial
# replays of SMOKE requests whose tokens match, 0.0827 (deepseek-coder-33b,
# tests/test_torch_archs_serve.py, EDGE_DEV_CAP there): one flipped
# quantizer code.
EDGE_DEV_CAP = 2 * 0.0827

# the SMOKE configs held card against CPU (gemma2's and recurrentgemma's
# windows are 16, so the 48-token prompts wrap their rings)
PARITY_ARCHS = ("musicgen-medium", "phi3-mini-3.8b", "deepseek-coder-33b",
                "granite-20b", "gemma2-9b", "mamba2-2.7b",
                "recurrentgemma-2b", "granite-moe-1b-a400m", "dbrx-132b",
                "internvl2-2b")


@contextlib.contextmanager
def router_margins():
    """Records, for every ``apply_moe`` call made inside, the smallest gap
    between a token's k-th and (k+1)-th router probability (a near tie
    there is a routing knife edge); yields the list of those minima."""
    import torch

    from repro_torch.models import moe

    seen = []
    real = moe.apply_moe

    def apply_moe(params, x, n_experts, top_k, *a, **k):
        probs = torch.softmax(x.reshape(-1, x.shape[-1]).float()
                              @ params["router"], dim=-1)
        top = torch.topk(probs, min(top_k + 1, n_experts), dim=-1).values
        if top.shape[-1] > top_k:
            seen.append(float((top[:, top_k - 1] - top[:, top_k]).min()))
        return real(params, x, n_experts, top_k, *a, **k)

    moe.apply_moe = apply_moe
    try:
        yield seen
    finally:
        moe.apply_moe = real


def phase_parity(dev):
    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.core.imc_linear import IMCConfig
    from repro_torch.core.substrate import calibrate_model
    from repro_torch.launch import serve as serve_mod
    from repro_torch.launch.serve import Request, serve
    from repro_torch.models import init_params
    from repro_torch.tree import map_leaves

    def runner(cfg, params):
        def run(force):
            rnp = np.random.default_rng(11)
            reqs = [Request(rid=i, prompt=rnp.integers(0, cfg.vocab_size, n),
                            max_new=6) for i, n in enumerate(MIXED_LENS)]
            with probing(None, force) as probes:
                eng = serve_mod.Engine(cfg, params, batch_slots=4,
                                       cache_len=48 + 6 + 8, max_chunk=4,
                                       block_size=8)
                done = serve(eng, reqs)
            if any(r.error for r in done):
                raise AssertionError("parity run had failed requests")
            counters = json.dumps([eng.prefill_calls, eng.prefill_rows,
                                   eng.decode_calls, eng.decode_steps])
            return {r.rid: r.out for r in done}, counters, probes[-1]
        return run

    for arch, mode in [(a, m) for a in PARITY_ARCHS
                       for m in ("digital", "imc_bitserial")]:
        cfg = configs.get_smoke(arch)
        params_cpu = init_params(cfg, seed=0, device="cpu")
        if mode != "digital":
            cfg = cfg.replace(imc=IMCConfig(mode=mode, bx=7, bw=7, v_wl=0.7))
            ref = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 24))
            cfg = calibrate_model(cfg, params_cpu, [ref])
        params_gpu = map_leaves(lambda t: t.to(dev), params_cpu)
        reset_counts()
        # the card runs once (A, unforced), so the counts are its launches;
        # musicgen-medium's runs stay strictly identical, as before; a
        # router's near tie is a knife edge of the same kind as a flipped
        # quantizer code, judged by the same rule
        edges = arch != "musicgen-medium" and (mode == "imc_bitserial"
                                               or cfg.n_experts > 0)
        with router_margins() as margins:
            verdict = tie_parity(f"{arch} {mode}", runner(cfg, params_gpu),
                                 runner(cfg, params_cpu), ties=False,
                                 strict=True, edges=edges)
        routed = (f"; smallest router top-{cfg.top_k} margin "
                  f"{min(margins)!r}" if margins else "")
        say("parity", f"{arch} SMOKE float32 {mode}, card against CPU: "
            f"{verdict}{routed}; card launches {read_counts()}")

    overload_parity(dev)
    prefix_parity(dev)
    cli_parity(dev)


class TokenProbe:
    """Records the logits behind every token an engine emits, keyed by
    (request id, token index), with the frontier level (index into
    ``ladder``; 0 without one) the engine was at.  With ``force`` ({key:
    token}), each forced token is made the greedy pick after its logits are
    recorded, so the engine follows a given token stream (teacher forcing
    through the engine's own prefill, warm prefill and decode path).  With
    ``rids``, only those requests' logits are recorded."""

    def __init__(self, eng, ladder, force=None, rids=None):
        self.eng, self.ladder, self.force, self.rids = eng, ladder, force, rids
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
            if self.rids is not None and req.rid not in self.rids:
                continue
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
def probing(ladder=None, force=None, rids=None):
    """Every engine made inside carries a :class:`TokenProbe` (yielded in
    order of creation) that sees each logits block it argmaxes."""
    from repro_torch.launch import serve as serve_mod

    probes = []
    base = serve_mod.Engine
    model_prefill, model_decode = serve_mod.prefill, serve_mod.decode_step

    class Probed(base):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            probes.append(TokenProbe(self, ladder, force, rids))

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


def tie_parity(label, run_a, run_b, ties: bool, strict: bool = False,
               edges: bool = False, cap: float = EDGE_DEV_CAP,
               show_dev: bool = False):
    """Hold run A's tokens against run B's.  Each ``run(force)`` returns
    ({rid: tokens}, counters (a JSON string), probe).  Token counts must
    match, and the counters (before any forcing, when ``strict``).  Where
    tokens differ and ``ties`` (the analytic substrate: its MPC ADC makes
    the LM head's logits multiples of one code, so two tokens can tie
    exactly and another summation order breaks the tie the other way), B
    runs again forced through the engine onto A's tokens: it must reproduce
    them and A's counters, and at every token A's pick must be B's greedy
    pick on the same history and frontier level, or the two picks' logits
    must be exactly equal in A or in B.  With ``edges`` (the bit-serial
    substrate: its kernel equals the plain version bit for bit, but the
    attention and norms around it round differently on the card, so a
    quantizer code can flip where an activation sits on a rounding edge), a
    differing pick passes where B's margin for its pick over A's token is
    within the largest deviation between A's and B's logits at that token
    (a knife edge), and A's and B's logits may deviate by at most
    ``cap`` at any token (``EDGE_DEV_CAP``; None: no cap).  Every token is
    compared; ``show_dev`` reports the largest logit deviation of identical
    runs as well."""
    import torch

    def deviation(probe_a, probe_b):
        worst = max(float((probe_a.logits[k] - probe_b.logits[k]).abs().max())
                    for k in probe_a.logits)
        if cap is not None and worst > cap:
            raise AssertionError(f"{label}: logits deviate by {worst!r}, "
                                 f"above the cap {cap!r}")
        return f"; largest logit deviation {worst!r}"

    out_a, cnt_a, probe_a = run_a(None)
    out_b, cnt_b, probe_b = run_b(None)
    lens_a = {rid: len(o) for rid, o in out_a.items()}
    lens_b = {rid: len(o) for rid, o in out_b.items()}
    if lens_a != lens_b:
        raise AssertionError(f"{label}: request lengths differ, {lens_a} vs "
                             f"{lens_b}")
    if strict and cnt_a != cnt_b:
        raise AssertionError(f"{label}: counters {cnt_a} != {cnt_b}")
    n_tok = sum(lens_b.values())
    if out_a == out_b and cnt_a == cnt_b:
        return (f"all {n_tok} tokens and the counters identical ({cnt_a})"
                + (deviation(probe_a, probe_b) if edges or show_dev
                   else ""))
    if not (ties or edges):
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
        margin, dev = float(lb[mine] - lb[tok]), float((la - lb).abs().max())
        if ties and lb[tok] == lb[mine]:
            where = "B"
        elif ties and la[tok] == la[mine]:
            where = "A"
        elif edges and margin <= dev:
            tied.append(f"request {key[0]} token {key[1]}: A {tok}, B {mine}, "
                        f"B's margin {margin!r} within the runs' logit "
                        f"deviation {dev!r} (a knife edge)")
            continue
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
            f"are exact ties or knife edges: {'; '.join(tied)}"
            + (deviation(probe_a, probe_b) if edges else ""))


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
    from repro_torch.tree import map_leaves
    from repro_torch.runtime.workload import VirtualClock, make_overload_config

    pt = optimize(n=512, snr_t_target_db=26.0, kinds=("qr",))
    ladder = substrate_ladder(pt, steps=2)
    cfg = configs.get_smoke("musicgen-medium")
    cfg = cfg.replace(imc=substrate_for_design(pt))
    params_cpu = init_params(cfg, seed=0, device="cpu")
    params_gpu = map_leaves(lambda t: t.to(dev), params_cpu)
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
    from repro_torch.tree import map_leaves

    for mode in ("digital", "imc_analytic", "imc_bitserial"):
        cfg = configs.get_smoke("musicgen-medium")
        params_cpu = init_params(cfg, seed=0, device="cpu")
        if mode != "digital":
            cfg = cfg.replace(imc=IMCConfig(mode=mode, bx=7, bw=7, v_wl=0.7))
            ref = np.random.default_rng(1).integers(0, cfg.vocab_size,
                                                    (2, 24))
            cfg = calibrate_model(cfg, params_cpu, [ref])
        params_gpu = map_leaves(lambda t: t.to(dev), params_cpu)

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
    from repro_torch.tree import map_leaves

    init = serve_mod.init_params

    def runner(argv, device):
        def run(force):
            def params_via_cpu(cfg, seed=0, device=None):
                return map_leaves(lambda t: t.to(device),
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
                "layer_snr", "site_snr", "kernel"]


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
    for r in payload["suites"]["layer_snr"]["records"]:
        say("bench", f"{r['name']}: {r['value']} ({r['derived']})")
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
    """Instantiations of the analytic kernel's tile template, ``launch<WGS,
    N, MIN_BLOCKS>`` of ``csrc/analytic.cu`` (``TILE_CONFIGS``),
    timed against each other at every site shape, B = 8 and 512, with the QR
    26 dB codes, ADC and noise.  One library holds them all (a source that
    includes analytic.cu, built with the kernels' flags); each one's output
    must equal the shipped kernel's bit for bit (every tile sums each output
    in the same order), and the configurations are timed in the order A B
    ... B A."""
    import ctypes

    import torch

    from repro_torch.core.design import optimize
    from repro_torch.kernels import build, imc_mvm, ref

    names = [f"tile_{64 * wgs}x{n}" for wgs, n, _ in TILE_CONFIGS]
    args = ("const float* x, const float* w, float* out, int B, int K, "
            "int M, int has_noise, uint32_t seed, float sigma, int apply_adc,"
            " float adc_delta, float code_lo, float code_hi, void* stream")
    src = OUT / "analytic_tiles.cu"
    src.write_text('#include "analytic.cu"\n' + "".join(
        f'extern "C" int {n}({args}) {{\n  return launch<{wgs}, {bn}, {mb}>('
        f"x, w, out, B, K, M, Epilogue{{has_noise, seed, sigma, apply_adc, "
        f"adc_delta, code_lo, code_hi}}, (cudaStream_t)stream);\n}}\n"
        for n, (wgs, bn, mb) in zip(names, TILE_CONFIGS)))
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
            xs, wc = analytic_operands(gen, b, k, m, pt.bx, pt.bw, dev)
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
            say("tiles", f"{b}x{k}x{m}: " + "; ".join(
                f"{n} " + " / ".join(f"{t:.4f}" for t in ts) + " ms"
                for n, ts in times.items()) + " (outputs equal the shipped "
                "kernel's bit for bit)")


def phase_kprofile(dev):
    """Where one wrapper call's device time goes: ``torch.profiler``'s
    kernel rows (device ms per call and launches per call, over 10 calls
    after 3 warm ones) of the seed bit-serial wrapper at the main shape
    with its noise operand (``seed_main_operands``), and of the float
    analytic wrapper at (512, 1536) @ (1536, 6144) with 10-bit codes, each
    beside its graph-replayed time; then the seed wrapper's graph-replayed
    time at 1, 4 and 16 batch rows.  With ``--src`` it profiles another
    checkout's package (its wrappers take the same arguments)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.benchmarks import kernel_bench as kb
    from repro_torch.kernels import imc_mvm, ref

    calls = 10
    xc, wc, noise, spec = seed_main_operands(dev)
    gen = torch.Generator(device=dev).manual_seed(6)
    xs, w10 = analytic_operands(gen, 512, 1536, 6144, 10, 10, dev)
    aspec = ref.AnalyticSpec(b_adc=8, sigma_out=0.05, y_clip=4.0)
    for label, fn in (
            ("seed_bitserial (4, 1536) @ (1536, 6144), noise",
             lambda: kb.seed_bitserial_matmul(xc, wc, noise, spec)),
            ("analytic (512, 1536) @ (1536, 6144), 10-bit codes",
             lambda: imc_mvm.imc_analytic_matmul(xs, w10, aspec, seed=7))):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        rows = [(e.self_device_time_total / 1e3 / calls, e.count / calls,
                 e.key) for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and e.self_device_time_total > 0]
        rows.sort(reverse=True)
        say("kprofile", f"{label}: graph-replayed {time_ms(fn):.4f} ms per "
            f"call; device kernels {sum(r[0] for r in rows):.4f} ms per call"
            ": " + "; ".join(f"{k[:60]} {ms:.4f} ms x{n:g}"
                             for ms, n, k in rows)
            + f" (package {Path(kb.__file__).parents[2]})")
    # how the seed wrapper's time grows with the batch: the part that every
    # batch row adds (counts and epilogue) against the part it shares (the
    # weight codes' planes)
    gen = torch.Generator(device=dev).manual_seed(7)
    times = []
    for b in (1, 4, 16):
        xb = ref.quantize_codes(torch.randn((b, 1536), generator=gen,
                                            device=dev), spec.bx, True,
                                torch.tensor(3.0, device=dev))[0]
        nz = noise[:, :, :1].expand(-1, -1, b, -1).contiguous()
        times.append((b, time_ms(lambda: kb.seed_bitserial_matmul(
            xb, wc, nz, spec)), time_ms(lambda: kb.seed_bitserial_matmul(
                xb, wc, None, spec))))
    say("kprofile", "seed_bitserial (B, 1536) @ (1536, 6144) by batch rows: "
        + "; ".join(f"B={b} {t_n:.4f} ms with noise, {t_c:.4f} without"
                    for b, t_n, t_c in times))


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
        kernels = [check_paged_attention(dev), *check_paged_layouts(dev),
                   *check_bitserial(dev)]
        check_bitserial_offset(dev)
        check_bitserial_segments(dev)
        check_bitserial_shapes(dev)
        kernels += [check_analytic(dev),
                   check_analytic_int8(dev), check_seed_bitserial(dev)]
    counts = {}
    if "design" in phases:
        reset_counts()
        counts.update(phase_design(dev))
    if "serve" in phases:
        counts.update(phase_serve())
    if "archs" in phases:
        # the architectures' main path adds to the serve phase's counts
        for k, v in phase_archs().items():
            counts[k] = counts.get(k, 0) + v
    if "mesh" in phases:
        for k, v in phase_mesh().items():
            counts[k] = counts.get(k, 0) + v
    if "train" in phases:
        phase_train(dev)
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
    if "chunks" in phases:
        phase_chunks(dev)
    if "host" in phases:
        phase_host(dev)
    if "kprofile" in phases:
        phase_kprofile(dev)
    if "colsplit" in phases:
        phase_colsplit()
    say("done", f"all phases passed in {time.perf_counter() - t_all:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
