"""Build and load the hand-written CUDA kernels.

Each ``csrc/*.cu`` source compiles with ``nvcc`` into its own shared library
with a plain C interface under ``build/kernels/`` at the root of the checkout
(listed in ``.gitignore``), at first use; the libraries are loaded with
``ctypes``.  A library's file name carries a hash of its sources and flags, so
an edited source rebuilds and an unchanged one is reused.  ``build_all``
starts one ``nvcc`` per source at once.  Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
SOURCES = ("paged_attention", "bitserial", "analytic", "analytic_int8",
           "seed_bitserial")
# streaming multiprocessors of the H100 the kernels' launch plans fill
SMS = 132

_P, _I, _F, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint32
_SIGNATURES = {
    "paged_attention": ("paged_attention_decode",
                        [_P] * 10 + [_I] * 14 + [_F, _F, _I, _P]),
    "bitserial": ("imc_bitserial_matmul",
                  [_P] * 4 + [_I] * 7 + [_F, _I, _F, _F, _I, _U, _F, _I,
                                         _P]),
    "analytic": ("imc_analytic_matmul",
                 [_P] * 3 + [_I] * 4 + [_U, _F, _I, _F, _F, _F, _P]),
    "analytic_int8": ("imc_analytic_int8_matmul",
                      [_P] * 4 + [_I] * 6 + [_U, _F, _I, _F, _F, _F, _P]),
    "seed_bitserial": ("seed_bitserial_matmul",
                       [_P] * 4 + [_I] * 11 + [_F, _I, _F, _F, _P]),
}

_loaded: Dict[str, ctypes.CDLL] = {}
build_log: Dict[str, str] = {}


def nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the "
                       "CUDA toolkit is installed")


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        if src.suffix == ".cuh" or src.stem == name:
            h.update(src.name.encode())
            h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:12]}.so"


def _start(name: str):
    out = _target(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, started) -> None:
    if started is None:
        return
    proc, tmp, out = started
    log, _ = proc.communicate()
    build_log[name] = log
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)


def build_all(names: List[str] = SOURCES) -> float:
    """Compile every kernel source that is not built yet, one ``nvcc`` per
    source, all started together; returns the wall seconds taken."""
    t0 = time.perf_counter()
    started = {n: _start(n) for n in names}
    for n, s in started.items():
        _finish(n, s)
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel source ``name`` (built on first use),
    with its C entry point's argument types declared."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    _finish(name, _start(name))
    lib = ctypes.CDLL(str(_target(name)))
    fn_name, argtypes = _SIGNATURES[name]
    fn = getattr(lib, fn_name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    lib.kernel_error_string.argtypes = [ctypes.c_int]
    lib.kernel_error_string.restype = ctypes.c_char_p
    _loaded[name] = lib
    return lib


def error_string(name: str, err: int) -> str:
    return f"{err} ({library(name).kernel_error_string(err).decode()})"


class KernelLaunchError(RuntimeError):
    """A kernel launch the card refused (a nonzero status from a kernel's C
    entry point).  Never transient: ``runtime.fault`` does not retry it."""


def launch_failed(name: str, err: int) -> KernelLaunchError:
    """The error a wrapper raises when kernel library ``name`` returns the
    nonzero launch status ``err``."""
    return KernelLaunchError(f"{name} kernel launch failed: "
                             f"{error_string(name, err)}")
