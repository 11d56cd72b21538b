"""The port's benchmark orchestrator: one entry per paper figure/table, the
whole-model SNR sweep, the per-site SNR map and the kernel micro-bench.
Prints ``name,value,derived`` CSV rows and writes a machine-readable JSON
report::

    python -m repro_torch.benchmarks.run --json PATH \
        --only fig4,fig9,fig10,fig11,fig12,fig13,pareto,layer_snr,site_snr,kernel

Runs on the card unless ``--device cpu`` is given (the MC overlays and the
kernel bench then run their plain versions on the CPU, and kernel times are
the CPU's wall time, labelled ``cpu_wall_ms``).  Without ``--json`` the report
goes to ``build/bench/bench_torch.json`` (git-ignored); the reference's
committed ``BENCH_*.json`` baselines are never written.  A suite the port
does not have yet, or an unknown name, raises before anything runs.
"""
from __future__ import annotations

import argparse
import json
import os
import platform
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import torch

from repro_torch.benchmarks import kernel_bench, layer_snr, paper_figures
from repro_torch.core import mc

SCHEMA = "repro-imc-torch-bench/v1"
DEFAULT_JSON = Path(__file__).resolve().parents[3] / "build" / "bench" / \
    "bench_torch.json"
SUITES = (*paper_figures.ALL, "layer_snr", "site_snr", "kernel")
# the reference's suites that wait for later slices of the port
NOT_PORTED = ("model_energy", "serve", "serve_energy",
              "serve_sharded", "serve_prefix", "roofline")


def select(only: Optional[str]) -> List[str]:
    """The suites ``--only`` names (all of ``SUITES`` when None), in the
    order given; raises for a suite that is not ported or not known."""
    names = list(SUITES) if only is None else only.split(",")
    for name in names:
        if name in NOT_PORTED:
            raise NotImplementedError(
                f"suite {name!r} is not ported to PyTorch yet (ROADMAP: "
                "queue 1, benchmarks, tooling and examples)")
        if name not in SUITES:
            raise KeyError(f"unknown suite {name!r}; the port has "
                           f"{', '.join(SUITES)} (ROADMAP lists the rest)")
    return names


def suite_fns(device: torch.device) -> Dict[str, Callable]:
    """Each suite as a function returning ``(records or None, rows)``."""
    fns = {}
    for name, fig in paper_figures.ALL.items():
        if name in paper_figures.MC_FIGS:
            fns[name] = (lambda fig=fig: (None, fig(gen=mc.generator(
                0, device))))
        else:
            fns[name] = (lambda fig=fig: (None, fig()))

    def layer_snr_suite():
        return None, layer_snr.run(device)

    def site_snr():
        records = layer_snr.site_snr_records()
        return records, layer_snr.site_snr_rows(records)

    def kernel():
        records = kernel_bench.bench_records(device)
        return records, kernel_bench.rows_from_records(records)

    fns["layer_snr"] = layer_snr_suite
    fns["site_snr"] = site_snr
    fns["kernel"] = kernel
    return fns


def meta(device: torch.device) -> dict:
    """Provenance of a report: torch, CUDA, the device and, on the card,
    its name and power limit as nvidia-smi reports them."""
    out = {"torch": torch.__version__, "cuda": torch.version.cuda,
           "device": str(device), "python": platform.python_version(),
           "platform": platform.platform()}
    if device.type == "cuda":
        out["device_name"] = torch.cuda.get_device_name(device)
        out["device_count"] = torch.cuda.device_count()
        out["nvidia_smi"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
    return out


def run_suites(names: List[str], device, out=print) -> dict:
    """Run ``names`` on ``device`` (``out`` gets the CSV lines); returns the
    report.  No suite's failure is caught."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run the "
                           "plain versions on the CPU")
    fns = suite_fns(device)
    payload = {"schema": SCHEMA, "meta": meta(device), "suites": {}}
    out("name,value,derived")
    for name in names:
        t0 = time.perf_counter()
        records, rows = fns[name]()
        dt = time.perf_counter() - t0
        for rname, val, derived in rows:
            out(f'{rname},{val},"{derived}"')
        out(f'{name}/_suite_s,{dt:.2f},"suite wall time"')
        if records is None:
            records = [{"name": rname, "value": val, "derived": derived}
                       for rname, val, derived in rows]
        payload["suites"][name] = {"wall_s": dt, "records": records}
    return payload


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default=None,
                    help=f"comma list of {','.join(SUITES)}")
    ap.add_argument("--json", type=Path, default=DEFAULT_JSON,
                    metavar="PATH", help="where the JSON report goes")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.json.name.startswith("BENCH_"):
        ap.error("--json: BENCH_*.json are the reference's baselines")
    names = select(args.only)
    payload = run_suites(names, args.device)
    args.json.parent.mkdir(parents=True, exist_ok=True)
    with open(args.json, "w") as f:
        json.dump(payload, f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"# wrote {os.fspath(args.json)}", file=sys.stderr)
    return payload


if __name__ == "__main__":
    main()
