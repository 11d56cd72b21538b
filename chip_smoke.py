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
  4 serve    full-width musicgen-medium (48 layers, d_model 1536, bf16,
             seeded random weights) served by the engine on the digital and
             the bit-serial IMC substrates, counting the kernels' launches;
  5 parity   the SMOKE config in float32: the engine on the card against the
             same engine on the CPU, greedy tokens identical.
Optional (``--phases ...,profile``): a torch.profiler trace of one decode
chunk of each full-width substrate - device kernel time by name against the
chunk's wall time (summary printed, tables under build/chip_smoke/).
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
PHASES = ("device", "build", "kernels", "serve", "parity")
# not run by default: a profiler trace of one decode chunk per substrate
EXTRA_PHASES = ("profile",)

# NVIDIA H100 SXM published peaks (data sheet, dense), used for the bounds
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
F32_FLOPS_PER_S = 67e12

MIXED_LENS = [4, 6, 48, 5, 8, 44, 6, 7]
# slots of the full-width bit-serial serve (phase 4) and its kernel check
BITSERIAL_SLOTS = 4


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


# ---------------------------------------------------------------------------
# phase 4: the main path at full width
# ---------------------------------------------------------------------------


def reset_counts():
    from repro_torch.kernels import imc_mvm, paged_attention

    paged_attention.paged_attention_cuda.launches = 0
    imc_mvm.bitserial_cuda.launches = 0
    imc_mvm.bitserial_cuda.gain_launches = 0


def read_counts():
    from repro_torch.kernels import imc_mvm, paged_attention

    bs = imc_mvm.bitserial_cuda
    return {"paged_attention": paged_attention.paged_attention_cuda.launches,
            "bitserial": bs.gain_launches,
            "bitserial_nogain": bs.launches - bs.gain_launches}


def serve_run(label, argv, n_layers, vocab):
    import torch

    from repro_torch.launch import serve

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    rep = serve.main(argv)
    counts = read_counts()
    eng = rep["engine"]
    fin = rep["finished"]
    bad = [r.rid for r in fin if r.error is not None]
    if bad:
        raise AssertionError(f"{label}: requests {bad} failed")
    for r in fin:
        if len(r.out) != r.max_new or not all(0 <= t < vocab for t in r.out):
            raise AssertionError(f"{label}: request {r.rid} produced "
                                 f"{r.out}")
    if counts["paged_attention"] != n_layers * eng.decode_steps:
        raise AssertionError(
            f"{label}: {counts['paged_attention']} paged-attention launches "
            f"for {eng.decode_steps} decode steps of {n_layers} layers")
    say("serve", f"{label}: {len(fin)} requests, {rep['tokens']} tokens in "
        f"{rep['seconds']:.2f} s, {rep['tok_s']:.1f} tok/s, mean TTFT "
        f"{rep['ttft_ms']:.1f} ms, {eng.decode_steps} decode steps, "
        f"{eng.prefill_calls} prefills, launches {counts} "
        f"({counts['paged_attention'] / max(eng.decode_steps, 1):.0f} "
        f"paged-attention per step), peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return counts


def phase_serve():
    from repro_torch import configs

    cfg = configs.get("musicgen-medium")
    n_layers, vocab = cfg.n_layers, cfg.vocab_size
    digital = serve_run(
        "digital", ["--arch", "musicgen-medium", "--batch", "8",
                    "--requests", "8", "--prompt-lens",
                    "16,512,64,300,128,33,480,256", "--gen", "32",
                    "--chunk", "8", "--seed", "0"], n_layers, vocab)
    bitserial = serve_run(
        "imc_bitserial", ["--arch", "musicgen-medium", "--batch",
                          str(BITSERIAL_SLOTS),
                          "--requests", "6", "--prompt-lens",
                          "5,9,32,4,17,6", "--gen", "8", "--chunk", "4",
                          "--imc-mode", "imc_bitserial", "--seed", "0"],
        n_layers, vocab)
    counts = {k: digital[k] + bitserial[k] for k in digital}
    if min(counts.values()) <= 0:
        raise AssertionError(f"a kernel of the main path never launched: "
                             f"{counts}")
    return counts


# ---------------------------------------------------------------------------
# phase 5: card against CPU on the SMOKE config
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


# ---------------------------------------------------------------------------
# optional: where a decode step's time goes
# ---------------------------------------------------------------------------


def profile_chunk(label, cfg, n_slots, prompt_lens, steps, rng):
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.serve import Engine, Request
    from repro_torch.models import init_params

    params = init_params(cfg, seed=0, device="cuda")
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
    from repro_torch.core.imc_linear import IMCConfig
    from repro_torch.kernels import prng

    cfg = configs.get("musicgen-medium")
    profile_chunk("digital", cfg, 8, [16, 512, 64, 300, 128, 33, 480, 256],
                  8, None)
    cfg = cfg.replace(imc=IMCConfig(mode="imc_bitserial", bx=7, bw=7,
                                    v_wl=0.7))
    profile_chunk("imc_bitserial", cfg, 4, [5, 9, 32, 4], 4,
                  prng.derive_seed(0, 7))


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
        kernels = [check_paged_attention(dev), *check_bitserial(dev)]
    if "serve" in phases:
        counts = phase_serve()
        for k in kernels:
            k["launches"] = counts[k["name"]]
    if "parity" in phases:
        phase_parity(dev)
    if "profile" in phases:
        phase_profile()
    say("done", f"all phases passed in {time.perf_counter() - t_all:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
