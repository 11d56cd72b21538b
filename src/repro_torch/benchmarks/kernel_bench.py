"""Kernel micro-bench of the port: per-shape times and the bytes and
operations each bit-serial kernel and the paged-attention kernel move.

Benches the port's bit-serial kernel (``csrc/bitserial.cu``: planes built in
registers, noise from a counter hash inside the kernel) against the frozen
SEED kernel (``csrc/seed_bitserial.cu``, the bit-serial matmul before the
in-kernel-noise rewrite: per-plane noise streamed from a precomputed
``(n_banks, Bw*Bx, B, M)`` float32 operand), so every run reports the
before/after of that rewrite, in particular the noise-operand bytes it
removed.  ``seed_bitserial_matmul`` and its plain version live here, beside
the bench that is their only caller, as the reference keeps its seed kernel
in ``benchmarks/kernel_bench.py``.

Also benches the paged-attention decode step: the gather path
(``ref.paged_attention_ref``) materializes every resident slot's KV out of
the block pool (``pool[bt]``) before attending; the kernel streams pool rows
through a shared-memory ring, O(1) in sequence length.

Counters, per call, from the shapes (they describe the port's CUDA kernels,
whichever device ran the record):

  n_banks          banks of ``rows`` rows
  x_code_bytes     activation codes as the kernels read them: the seed's
                   float32 codes as the caller holds them (4 B x K);
                   bitserial.cu's one byte each (B x K padded to its bank
                   layout)
  w_code_bytes     weight codes likewise: the seed's float32 (4 K x M);
                   bitserial.cu's one byte each (K x M, padded likewise)
  plane_bytes      packed bit planes in device memory: both kernels build
                   their planes on chip (0)
  noise_bytes      the noise operand: the seed's (n_banks, Bw*Bx, B, M)
                   float32 read from device memory; bitserial.cu's 4 (the
                   uint32 seed passed by value); 0 without noise
  out_bytes        the float32 (B, M) output
  plane_macs       B*K*M*Bw*Bx: one 0/1 multiply-add per (b, k, m) and
                   plane pair
  kernel_launches  hand-written kernel launches per call (one each)
  gathered_kv_bytes_per_step   KV bytes materialized outside the block pool
                   per decode step: the gather path's pool[bt] copy (every
                   slot's whole table, K and V, float32) against the
                   kernel's shared-memory ring of one CTA (STAGES stages of K
                   and V rows of its heads)

Summaries: ``noise_bytes_reduction`` is the seed's noise bytes over the
rewrite's, ``gathered_kv_reduction`` the gather path's materialized KV over
the kernel's.

Times: on the card ``device_ms``, the mean of ``iters`` calls captured in
one CUDA graph and replayed between CUDA events, after 3 warm-up calls (it
fails unless the graph holds a kernel per call); ``chip_smoke.py`` times its
kernels with the same two functions.  A wrapper's launch counter counts its
Python calls: the warm-up calls and the calls captured into the graph, not
the graph's replays.  The plain bit-serial oracle cannot be captured (its
divisions copy a scalar to the card) and gets ``device_eager_ms``, CUDA events
around eager calls.  On the CPU every config runs its plain version and gets
``cpu_wall_ms``, the CPU's wall time, which is no device time.

``bench_records()`` returns the records ``run.py --json`` writes;
``rows_from_records()`` formats them as CSV rows.
"""
from __future__ import annotations

import ctypes
import math
import time
from typing import List, NamedTuple, Tuple

import torch

from repro_torch.kernels import build, imc_mvm, paged_attention, ref
from repro_torch.kernels.ref import BitSerialSpec, quantize_codes

Row = Tuple[str, float, str]

SHAPES = [
    # (B, K, M, bx, bw)
    (64, 512, 128, 6, 6),
    (128, 1024, 256, 7, 7),
    (32, 2048, 128, 4, 4),
]

PAGED_SHAPES = [
    # (slots, blocks per slot, block_size, kv heads, q groups, head_dim)
    (4, 8, 8, 2, 2, 64),
    (8, 16, 8, 4, 2, 64),
]

# the seed kernel's launch plan: columns per CTA, the shared memory its
# weight plane words may take, batch rows per chunk, warps per CTA
SEED_COLS = 32
SEED_WORD_BYTES = 48 * 1024
SEED_CHUNK = 8
SEED_WARPS = 8
# the shared memory one block may use on the H100
SMEM_BYTES = 232448

# the counter-hash seed of bitserial.cu's noisy config
NOISE_SEED = 17


# ---------------------------------------------------------------------------
# the frozen seed kernel: plain version, launch, dispatch
# ---------------------------------------------------------------------------


def _seed_banks(x_codes, w_codes, noise, spec: BitSerialSpec):
    """Per bank, the seed's float32 terms in its order: a list of ``(weight,
    dp)``, i outer and j inner, ``dp`` the plane pair's dot clipped at k_h,
    plus ``noise[bank, i*Bx + j]`` floored at 0 (with noise), through the
    mid-rise ADC, and ``weight`` the float ``ww[i] * xw[j]``."""
    k = x_codes.shape[1]
    x = x_codes.to(torch.float32)
    w = w_codes.to(torch.float32)
    n_banks = -(-k // spec.rows)
    pad = n_banks * spec.rows - k
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
        w = torch.nn.functional.pad(w, (0, 0, 0, pad))
    ww, xw = spec.plane_weights()
    for bank in range(n_banks):
        sl = slice(bank * spec.rows, (bank + 1) * spec.rows)
        xplanes = [ref.unpack_plane(x[:, sl], j, spec.bx, spec.x_signed)
                   for j in range(spec.bx)]
        terms = []
        for i in range(spec.bw):
            wplane = ref.unpack_plane(w[sl], i, spec.bw, signed=True)
            for j in range(spec.bx):
                dp = torch.clamp(xplanes[j] @ wplane, max=spec.k_h)
                if noise is not None:
                    dp = torch.clamp(dp + noise[bank, i * spec.bx + j],
                                     min=0.0)
                if spec.apply_adc:
                    dp = ref.adc_transfer(dp, spec.b_adc, spec.v_c)
                terms.append((float(ww[i] * xw[j]), dp))
        yield terms


def seed_bitserial_plain(x_codes, w_codes, noise, spec: BitSerialSpec):
    """The seed kernel's function in plain PyTorch: per bank, each plane
    pair's dot clipped at k_h, plus ``noise[bank, i*Bx + j]`` floored at 0
    (with noise), through the mid-rise ADC, summed as ``acc += (ww[i] *
    xw[j]) * dp`` (i outer, j inner) and added to the output bank by bank.
    Returns (B, M) float32 in code units."""
    out = torch.zeros((x_codes.shape[0], w_codes.shape[1]),
                      dtype=torch.float32, device=x_codes.device)
    for terms in _seed_banks(x_codes, w_codes, noise, spec):
        acc = torch.zeros_like(out)
        for weight, dp in terms:
            acc = acc + weight * dp
        out = out + acc
    return out


def order_atol(x_codes, w_codes, spec: BitSerialSpec, ulps: int = 8) -> float:
    """How far two float32 summation orders of the seed's noiseless terms
    (its own and ``bitserial.cu``'s) may differ: ``ulps`` float32 ulps of
    the largest partial sum in the seed's order, over every output.  Partial
    sums run from several to thousands of times larger than the output (the
    sign plane's terms cancel the others'), so the output's magnitude is not
    the scale of their rounding; at the bit-serial serve's (4, 1536) @
    (1536, 6144) the orders differ by 4 of these ulps (0.125 in code
    units)."""
    out = torch.zeros((x_codes.shape[0], w_codes.shape[1]),
                      dtype=torch.float32, device=x_codes.device)
    largest = torch.zeros((), dtype=torch.float32, device=out.device)
    for terms in _seed_banks(x_codes, w_codes, None, spec):
        acc = torch.zeros_like(out)
        for weight, dp in terms:
            acc = acc + weight * dp
            largest = torch.maximum(largest, acc.abs().max())
        out = out + acc
        largest = torch.maximum(largest, out.abs().max())
    return ulps * 2.0 ** (math.frexp(float(largest))[1] - 24)


class SeedPlan(NamedTuple):
    """The seed kernel's launch plan for one call (``seed_plan``)."""

    n_banks: int
    words: int  # 32-row words per bank, even (the count loop takes pairs)
    group: int  # banks whose plane words share memory at once
    chunk: int  # batch rows whose input plane words share memory at once
    b_rows: int  # batch rows per CTA
    smem_bytes: int


def seed_plan(b: int, k: int, m: int, rows: int, bx: int,
              bw: int) -> SeedPlan:
    """How ``csrc/seed_bitserial.cu`` covers a ``(b, k)`` @ ``(k, M)`` call
    with banks of ``rows`` rows: each bank as ``words`` 32-row words (the
    rows past a bank's end, in a ragged last bank or a bank height that is
    not a multiple of 32, are zero codes by predicate), banks in groups
    whose weight plane words fit ``SEED_WORD_BYTES`` of shared memory, batch
    rows in chunks of ``SEED_CHUNK``, and a noise buffer per warp;
    ``smem_bytes`` is what one CTA takes (the entry point refuses more than
    ``SMEM_BYTES``).  Where the ``m`` columns make fewer 32-column CTAs
    than the card has SMs, the batch rows are split over CTAs too
    (``b_rows`` each), so that every SM gets one."""
    n_banks = -(-k // rows)
    words = -(-min(rows, k) // 32)
    words += words % 2
    nb = max(4, bx, bw)  # the kernel's plane-count instantiation
    per_bank = 4 * nb * words * SEED_COLS
    group = max(1, min(n_banks, SEED_WORD_BYTES // per_bank))
    tiles = -(-m // SEED_COLS)
    b_rows = -(-b // max(1, min(b, -(-build.SMS // tiles))))
    chunk = max(1, min(b_rows, SEED_CHUNK))
    smem = 4 * (group * nb * words * SEED_COLS + chunk * group * words * 8
                + group * chunk * SEED_COLS + SEED_WARPS * nb * nb * SEED_COLS)
    return SeedPlan(n_banks, words, group, chunk, b_rows, smem)


def seed_c_args(x, w, noise, out, spec: BitSerialSpec):
    """The arguments of the C entry point ``seed_bitserial_matmul`` for
    float32 codes ``x`` (B, K) and ``w`` (K, M), contiguous, on the current
    stream."""
    b_sz, k = x.shape
    plan = seed_plan(b_sz, k, w.shape[1], spec.rows, spec.bx, spec.bw)
    return (x.data_ptr(), w.data_ptr(),
            None if noise is None else noise.data_ptr(), out.data_ptr(),
            b_sz, k, w.shape[1], spec.rows, spec.bx, spec.bw,
            int(spec.x_signed), plan.words, plan.group, plan.chunk,
            plan.b_rows,
            ctypes.c_float(min(spec.k_h, 3e38)), int(spec.apply_adc),
            ctypes.c_float(spec.v_c / (2.0**spec.b_adc)),
            ctypes.c_float(2.0**spec.b_adc - 1),
            torch.cuda.current_stream(x.device).cuda_stream)


def seed_bitserial_cuda(x_codes, w_codes, noise, spec: BitSerialSpec):
    """Launch the CUDA seed kernel; returns (B, M) f32 in code units."""
    dev = x_codes.device
    if dev.type != "cuda" or w_codes.device != dev:
        raise ValueError("seed_bitserial_cuda needs both operands on one "
                         f"CUDA device, got {x_codes.device} and "
                         f"{w_codes.device}")
    if x_codes.dim() != 2 or w_codes.dim() != 2:
        raise ValueError("seed_bitserial_cuda takes 2-D (B, K) and (K, M) "
                         "codes")
    b_sz, k = x_codes.shape
    k2, m = w_codes.shape
    if k != k2:
        raise ValueError(f"inner dimensions differ: {k} vs {k2}")
    if not (1 <= spec.bx <= 8 and 1 <= spec.bw <= 8):
        raise ValueError(f"bx={spec.bx}, bw={spec.bw}: the kernel takes "
                         "codes of at most 8 bits")
    n_banks = -(-k // spec.rows)
    if noise is not None:
        want = (n_banks, spec.bw * spec.bx, b_sz, m)
        if tuple(noise.shape) != want or noise.device != dev:
            raise ValueError(f"noise must be {want} on {dev}, got "
                             f"{tuple(noise.shape)} on {noise.device}")
        noise = noise.to(torch.float32).contiguous()
    # the kernel reads the codes as float32 (no copy when they are already)
    x = x_codes.to(torch.float32).contiguous()
    w = w_codes.to(torch.float32).contiguous()
    out = torch.empty((b_sz, m), dtype=torch.float32, device=dev)
    err = build.library("seed_bitserial").seed_bitserial_matmul(
        *seed_c_args(x, w, noise, out, spec))
    if err != 0:
        raise build.launch_failed("seed_bitserial", err)
    seed_bitserial_cuda.launches += 1
    return out


seed_bitserial_cuda.launches = 0


def seed_bitserial_matmul(x_codes, w_codes, noise, spec: BitSerialSpec):
    """The frozen seed bit-serial matmul of integer codes ``(B, K) @ (K,
    M)`` with an optional precomputed noise operand ``(n_banks, Bw*Bx, B,
    M)`` in counts; returns (B, M) f32 in code units.  CPU tensors take the
    plain version, CUDA tensors the kernel."""
    if x_codes.device.type == "cpu":
        return seed_bitserial_plain(x_codes, w_codes, noise, spec)
    if x_codes.device.type != "cuda":
        raise ValueError(f"no seed bit-serial kernel for device "
                         f"{x_codes.device}")
    return seed_bitserial_cuda(x_codes, w_codes, noise, spec)


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------


def _graph_kernels(graph) -> int:
    """Kernel nodes of a captured CUDA graph (through libcuda's graph API)."""
    cuda = ctypes.CDLL("libcuda.so.1")
    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    if cuda.cuGraphGetNodes(handle, None, ctypes.byref(n)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    if cuda.cuGraphGetNodes(handle, nodes, ctypes.byref(n)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    kind = ctypes.c_int(0)
    kernels = 0
    for node in nodes:
        if cuda.cuGraphNodeGetType(ctypes.c_void_p(node),
                                   ctypes.byref(kind)) != 0:
            raise RuntimeError("cuGraphNodeGetType failed")
        kernels += kind.value == 0  # CU_GRAPH_NODE_TYPE_KERNEL
    return kernels


def device_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device milliseconds per call of ``fn``: ``iters`` calls captured
    in one CUDA graph (after ``warmup`` calls on a side stream), replayed
    between CUDA events, so the host's time to issue a call (tens of
    microseconds for a Python wrapper) is not counted.  Raises unless the
    graph holds at least one kernel per call: a launch that the capture
    missed would time as nothing."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    nodes = _graph_kernels(graph)
    if nodes < iters:
        raise AssertionError(f"the CUDA graph of {iters} calls holds {nodes} "
                             "kernels: the capture missed launches")
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_eager_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds per eager call between CUDA events (the device
    time, or the host's time to issue the call where that is longer)."""
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


def cpu_wall_ms(fn, iters: int) -> float:
    """Mean CPU wall milliseconds per call (after one warm-up call)."""
    fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters * 1e3


def _time(fn, device, iters: int, capturable: bool = True) -> dict:
    if device.type == "cpu":
        return {"cpu_wall_ms": cpu_wall_ms(fn, iters)}
    if capturable:
        return {"device_ms": device_ms(fn, iters)}
    return {"device_eager_ms": device_eager_ms(fn, iters)}


TIME_KEYS = ("device_ms", "device_eager_ms", "cpu_wall_ms")


def time_key(rec: dict) -> str:
    """Which way the record's time was taken (one of ``TIME_KEYS``)."""
    return next(k for k in TIME_KEYS if k in rec)


def ms_of(rec: dict) -> float:
    """The record's time in milliseconds, whichever way it was taken."""
    return rec[time_key(rec)]


# ---------------------------------------------------------------------------
# counters
# ---------------------------------------------------------------------------


def _structure(b, k, m, bx, bw, rows, design: str, noisy: bool) -> dict:
    """Bytes per operand class, plane MACs and launches of one call of
    ``design`` ("seed" or "kernel"), as each kernel reads its operands
    (module docstring)."""
    n_banks = -(-k // rows)
    counters = {"n_banks": n_banks, "out_bytes": 4 * b * m,
                "plane_macs": b * k * m * bx * bw, "plane_bytes": 0,
                "kernel_launches": 1}
    if design == "seed":  # float32 codes as the caller holds them
        counters.update(x_code_bytes=4 * b * k, w_code_bytes=4 * k * m,
                        noise_bytes=(n_banks * bw * bx * b * m * 4 if noisy
                                     else 0))
    else:  # one byte per code in bitserial.cu's padded layout
        step, tile = imc_mvm.BITSERIAL_K_STEP, imc_mvm.BITSERIAL_N_TILE
        rows_p = -(-rows // step) * step
        kp = n_banks * rows_p if rows % step else -(-k // step) * step
        mp = -(-m // tile) * tile
        counters.update(x_code_bytes=b * kp, w_code_bytes=kp * mp,
                        noise_bytes=4 if noisy else 0)
    return counters


def _paged_structure(slots, blocks, bs, hkv, g, hd, design: str) -> dict:
    """KV bytes materialized outside the block pool per decode step (float32
    K and V): the gather path's pool[bt] copy, or one CTA's shared-memory
    ring of the kernel (``paged_attention.plan_split``)."""
    elt = 4
    if design == "gather":
        gathered = slots * blocks * bs * hkv * hd * elt * 2
    else:
        plan = paged_attention.plan_split(slots, hkv, g, hd, bs, blocks, elt)
        gathered = (paged_attention.STAGES * 2 * plan.stage_rows * plan.heads
                    * hd * elt)
    return {"gathered_kv_bytes_per_step": gathered}


# ---------------------------------------------------------------------------
# records
# ---------------------------------------------------------------------------


def paged_operands(shape, device):
    """The decode-step inputs of one ``PAGED_SHAPES`` entry, from a
    generator seeded with slots * blocks on ``device``: ``(q, k_new, v_new,
    pool_k, pool_v, block_table, pos, scale)``, float32 pools with block 0
    the reserved garbage block, and mid-block tail positions staggered so
    the causal mask varies."""
    slots, blocks, bs, hkv, g, hd = shape
    gen = torch.Generator(device=device).manual_seed(slots * blocks)
    n_pool = slots * blocks + 1

    def normal(*dims):
        return torch.randn(dims, generator=gen, device=device)

    q, kn, vn = normal(slots, hkv, g, hd), normal(slots, hkv, hd), \
        normal(slots, hkv, hd)
    pk, pv = normal(n_pool, bs, hkv, hd), normal(n_pool, bs, hkv, hd)
    bt = (1 + torch.arange(slots * blocks, dtype=torch.int32,
                           device=device)).reshape(slots, blocks)
    pos_b = ((blocks // 2) * bs + 3
             + torch.arange(slots, dtype=torch.int32, device=device))
    return q, kn, vn, pk, pv, bt, pos_b, hd ** -0.5


def paged_attention_records(device, iters: int = 20) -> List[dict]:
    """Decode-step records: the gather path against the kernel (on the CPU,
    the plain streamed walk ``decode_plain`` the wrapper takes there)."""
    records: List[dict] = []
    for shape in PAGED_SHAPES:
        slots, blocks, bs, hkv, g, hd = shape
        q, kn, vn, pk, pv, bt, pos_b, scale = paged_operands(shape, device)
        shape_meta = {"slots": slots, "blocks": blocks, "block_size": bs,
                      "heads": hkv * g, "kv_heads": hkv, "head_dim": hd}
        configs = {
            "gather": lambda: ref.paged_attention_ref(
                q, kn, vn, pk, pv, bt, pos_b, scale=scale),
            "kernel": lambda: paged_attention.paged_attention_decode(
                q, kn, vn, pk, pv, bt, pos_b, scale=scale),
        }
        by_cfg = {}
        for cname, fn in configs.items():
            rec = {"bench": "paged_attention", "config": cname, **shape_meta,
                   **_time(fn, torch.device(device), iters),
                   **_paged_structure(slots, blocks, bs, hkv, g, hd, cname)}
            records.append(rec)
            by_cfg[cname] = rec
        before = by_cfg["gather"]["gathered_kv_bytes_per_step"]
        after = by_cfg["kernel"]["gathered_kv_bytes_per_step"]
        records.append({
            "bench": "paged_attention_summary", **shape_meta,
            "speedup_vs_gather": (ms_of(by_cfg["gather"])
                                  / ms_of(by_cfg["kernel"])),
            "gathered_kv_bytes_before": before,
            "gathered_kv_bytes_after": after,
            "gathered_kv_reduction": before / after,
        })
    return records


def bitserial_operands(shape, device):
    """The inputs of one ``SHAPES`` entry, from a generator seeded with K + M
    on ``device``: ``(x_codes, w_codes, noise, spec, spec_noisy)``, signed
    codes of the shape's widths, banks of min(512, K) rows, an 8-bit ADC,
    k_h 60, v_c 55, and noise of std 0.3 counts: the seed's precomputed
    ``(n_banks, Bw*Bx, B, M)`` operand (the operand class the in-kernel
    noise removed), ``spec_noisy`` for ``bitserial.cu``'s counter hash."""
    b, k, m, bx, bw = shape
    gen = torch.Generator(device=device).manual_seed(k + m)
    x = torch.randn((b, k), generator=gen, device=device)
    w = torch.randn((k, m), generator=gen, device=device)
    xc, _ = quantize_codes(x, bx, True, x.abs().max())
    wc, _ = quantize_codes(w, bw, True, w.abs().max())
    knobs = dict(bx=bx, bw=bw, b_adc=8, rows=min(512, k), k_h=60.0, v_c=55.0,
                 x_signed=True)
    sigma = 0.3
    n_banks = -(-k // knobs["rows"])
    noise = sigma * torch.randn((n_banks, bw * bx, b, m), generator=gen,
                                device=device)
    return (xc, wc, noise, BitSerialSpec(**knobs),
            BitSerialSpec(**knobs, sigma_noise=sigma))


def bench_records(device="cuda", iters: int = 20) -> List[dict]:
    """Machine-readable per-(shape, config) records for ``run.py --json``,
    on ``device`` (the card by default)."""
    device = torch.device(device)
    records: List[dict] = []
    for shape in SHAPES:
        b, k, m, bx, bw = shape
        xc, wc, noise, spec, spec_noisy = bitserial_operands(shape, device)
        rows_bank = spec.rows
        shape_meta = {"B": b, "K": k, "M": m, "bx": bx, "bw": bw,
                      "rows": rows_bank}
        configs = {
            "seed_baseline": (
                lambda: seed_bitserial_matmul(xc, wc, None, spec),
                "seed", False),
            "seed_baseline_noise": (
                lambda: seed_bitserial_matmul(xc, wc, noise, spec_noisy),
                "seed", True),
            "kernel": (
                lambda: imc_mvm.imc_bitserial_matmul(xc, wc, None, spec),
                "kernel", False),
            "kernel_noise": (
                lambda: imc_mvm.imc_bitserial_matmul(xc, wc, None,
                                                     spec_noisy,
                                                     seed=NOISE_SEED),
                "kernel", True),
            "oracle": (lambda: ref.imc_bitserial_ref(xc, wc, None, spec),
                       None, False),
        }
        by_cfg = {}
        for cname, (fn, design, noisy) in configs.items():
            rec = {"bench": "bitserial", "config": cname, **shape_meta,
                   **_time(fn, device, iters, capturable=design is not None)}
            if design is not None:
                rec.update(_structure(b, k, m, bx, bw, rows_bank, design,
                                      noisy))
            records.append(rec)
            by_cfg[cname] = rec
        seed_n, kern_n = by_cfg["seed_baseline_noise"], by_cfg["kernel_noise"]
        records.append({
            "bench": "bitserial_summary", **shape_meta,
            "speedup_vs_seed": (ms_of(by_cfg["seed_baseline"])
                                / ms_of(by_cfg["kernel"])),
            "speedup_vs_seed_noise": ms_of(seed_n) / ms_of(kern_n),
            "noise_bytes_before": seed_n["noise_bytes"],
            "noise_bytes_after": kern_n["noise_bytes"],
            "noise_bytes_reduction": (seed_n["noise_bytes"]
                                      / max(kern_n["noise_bytes"], 1)),
            "kernel_launches_before": seed_n["kernel_launches"],
            "kernel_launches_after": kern_n["kernel_launches"],
        })
    records.extend(paged_attention_records(device, iters=iters))
    return records


def rows_from_records(records: List[dict]) -> List[Row]:
    rows: List[Row] = []
    for r in records:
        if r["bench"].startswith("paged_attention"):
            tag = (f"S{r['slots']}_N{r['blocks']}x{r['block_size']}"
                   f"_H{r['heads']}_D{r['head_dim']}")
            if r["bench"] == "paged_attention_summary":
                rows.append((
                    f"kernel/paged_summary_{tag}", r["speedup_vs_gather"],
                    f"gathered_kv_B {r['gathered_kv_bytes_before']}->"
                    f"{r['gathered_kv_bytes_after']} "
                    f"({r['gathered_kv_reduction']:.1f}x)"))
            else:
                rows.append((
                    f"kernel/paged_{r['config']}_{tag}", ms_of(r),
                    f"{time_key(r)}; gathered_kv_B="
                    f"{r['gathered_kv_bytes_per_step']}"))
            continue
        tag = f"B{r['B']}_K{r['K']}_M{r['M']}_b{r['bx']}x{r['bw']}"
        if r["bench"] == "bitserial_summary":
            rows.append((
                f"kernel/summary_{tag}", r["speedup_vs_seed"],
                f"speedup_noise={r['speedup_vs_seed_noise']:.2f} "
                f"noise_B {r['noise_bytes_before']}->"
                f"{r['noise_bytes_after']} "
                f"launches {r['kernel_launches_before']}->"
                f"{r['kernel_launches_after']}"))
        elif "plane_macs" in r:
            rows.append((
                f"kernel/{r['config']}_{tag}", ms_of(r),
                f"{time_key(r)}; noise_B={r['noise_bytes']} "
                f"w_code_B={r['w_code_bytes']} plane_B={r['plane_bytes']} "
                f"plane_macs={r['plane_macs']} "
                f"launches={r['kernel_launches']}"))
        else:
            rows.append((f"kernel/{r['config']}_{tag}", ms_of(r),
                         f"{time_key(r)}; plain PyTorch oracle"))
    return rows
