"""How often a process's first ``counter_normal`` call on the CPU differs
from later ones, with and without ``prng._vml_ready``.

    PYTHONPATH=src python tests/counter_normal_stress.py [--procs 192]
        [--parallel 12]

starts ``--procs`` processes, ``--parallel`` at a time (each also splits
its ops over torch's threads, so the CPU is loaded), two thirds with the
guard and one third without it.  Each computes the 400 x 300 draws of
``tests/test_torch_kernels.py`` twice and reports how many of its first
call's draws differ from its second's.  For each differing process, the
draws that differ are replayed through MKL's own ``vmsLn`` in its
enhanced-performance mode on the AVX2 code path (``ctypes``, in a process
started with ``MKL_ENABLE_INSTRUCTIONS=AVX2``) and counted where they match.
"""
import argparse
import ctypes
import json
import math
import os
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from repro_torch.kernels import prng

VML_EP, VML_FTZDAZ_OFF, VML_ERRMODE_IGNORE = 0x3, 0x00140000, 0x100


def _draws():
    b = torch.arange(400)[:, None]
    m = torch.arange(300)[None, :]
    return prng.counter_normal(77, prng.TAG_ANALYTIC, b, m).numpy()


def worker(guard: bool, out: str):
    if not guard:
        prng._vml_ready = lambda: None
    first = _draws().copy()
    second = _draws()
    differ = np.flatnonzero(first != second)
    if differ.size:
        np.savez(out, first=first.ravel(), second=second.ravel())
    print(json.dumps({"guard": guard, "differ": int(differ.size),
                      "lo": int(differ.min()) if differ.size else None,
                      "hi": int(differ.max()) if differ.size else None}))


def replay(path: str):
    """Count the first call's differing draws that MKL's AVX2 EP log
    reproduces (sqrt and cos as torch computes them)."""
    d = np.load(path)
    idx = np.flatnonzero(d["first"] != d["second"])
    b = torch.arange(400)[:, None]
    m = torch.arange(300)[None, :]
    u1 = prng.uniform_from_bits(prng.hash_u32(77, prng.TAG_ANALYTIC, b, m, 1),
                                open_zero=True).numpy().ravel()[idx].copy()
    u2 = prng.uniform_from_bits(
        prng.hash_u32(77, prng.TAG_ANALYTIC, b, m, 2)).ravel()[idx]
    lib = ctypes.CDLL(os.path.join(os.path.dirname(torch.__file__), "lib",
                                   "libtorch_cpu.so"))
    lg = np.empty_like(u1)
    ptr = ctypes.POINTER(ctypes.c_float)
    lib.vmsLn(ctypes.c_longlong(u1.size), u1.ctypes.data_as(ptr),
              lg.ctypes.data_as(ptr),
              ctypes.c_longlong(VML_EP | VML_FTZDAZ_OFF | VML_ERRMODE_IGNORE))
    r = torch.sqrt(-2.0 * torch.from_numpy(lg))
    z = r * torch.cos(torch.tensor(2.0 * math.pi, dtype=torch.float32) * u2)
    print(json.dumps({"replayed": int(idx.size),
                      "match": int((z.numpy() == d["first"][idx]).sum())}))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--procs", type=int, default=192)
    ap.add_argument("--parallel", type=int, default=12)
    ap.add_argument("--worker", choices=["on", "off"])
    ap.add_argument("--replay")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if args.worker:
        return worker(args.worker == "on", args.out)
    if args.replay:
        return replay(args.replay)
    tmp = tempfile.mkdtemp()
    guards = [i % 3 != 2 for i in range(args.procs)]

    def run(i):
        out = os.path.join(tmp, f"{i}.npz")
        res = subprocess.run(
            [sys.executable, __file__, "--worker", "on" if guards[i] else "off",
             "--out", out], capture_output=True, text=True, check=True)
        return i, json.loads(res.stdout.strip().splitlines()[-1])

    with ThreadPoolExecutor(args.parallel) as pool:
        results = list(pool.map(run, range(args.procs)))
    for guard in (True, False):
        rows = [r for _, r in results if r["guard"] == guard]
        bad = [r for r in rows if r["differ"]]
        print(f"guard {'on' if guard else 'off'}: {len(bad)} of {len(rows)} "
              f"processes' first calls differ from their second: "
              f"{[(r['differ'], r['lo'], r['hi']) for r in bad]}")
    for i, r in results:
        if r["differ"]:
            res = subprocess.run(
                [sys.executable, __file__, "--replay",
                 os.path.join(tmp, f"{i}.npz")], capture_output=True,
                text=True, check=True,
                env=dict(os.environ, MKL_ENABLE_INSTRUCTIONS="AVX2"))
            rep = json.loads(res.stdout.strip().splitlines()[-1])
            print(f"process {i}: MKL's AVX2 EP log reproduces {rep['match']} "
                  f"of its {rep['replayed']} differing draws")


if __name__ == "__main__":
    main()
