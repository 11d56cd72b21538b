"""Counter-based PRNG shared by the CUDA kernels and their plain versions.

The draw for a noise site is a pure function of ``(seed, counter fields)``:

  bit-serial  z[bank, plane, b, m] = N(seed; TAG_BITSERIAL, bank, plane, b, m)
  analytic    z[b, m]              = N(seed; TAG_ANALYTIC, b, m)

with GLOBAL indices as counters, so the value does not depend on how a kernel
tiles B/M/K.  The hash is a splitmix32-style finalizer chained over the
fields, in uint32 arithmetic with wraparound.  ``csrc/prng.cuh`` is the same
hash in CUDA; ``repro.kernels.prng`` is the JAX reference, reproduced bit for
bit (the tests pin it on iota grids).

uint32 is emulated in int64 with ``& 0xFFFFFFFF``: PyTorch's CPU backend has
no right shift for ``torch.uint32``.  Products are split into 16-bit halves so
no intermediate leaves int64.  Every function also takes plain Python ints,
which is how per-layer seeds are derived on the host.
"""
from __future__ import annotations

import functools
import math

import torch

# domain-separation tags (first counter field) so the two kernels never share
# a counter stream even under the same seed
TAG_BITSERIAL = 0x51
TAG_ANALYTIC = 0xA7

_GOLDEN = 0x9E3779B9  # 2^32 / phi; Weyl increment for field absorption
_MASK = 0xFFFFFFFF


def _u32(v):
    if isinstance(v, torch.Tensor):
        return v.to(torch.int64) & _MASK
    return int(v) & _MASK


def _mul32(a, c: int):
    """(a * c) mod 2^32 for a in [0, 2^32) and a constant c, without
    overflowing int64."""
    lo = a * (c & 0xFFFF)
    hi = (a * (c >> 16)) & 0xFFFF
    return (lo + (hi << 16)) & _MASK


def _mix32(h):
    """splitmix32 finalizer: full avalanche on a uint32."""
    h = _mul32(h ^ (h >> 16), 0x7FEB352D)
    h = _mul32(h ^ (h >> 15), 0x846CA68B)
    return h ^ (h >> 16)


def hash_u32(seed, *fields):
    """Hash ``seed`` and integer counter ``fields`` to uint32 noise bits
    (held in int64, or a Python int when every input is one).  Fields
    broadcast; negative values are taken as their 32-bit two's complement."""
    h = _mix32(_u32(seed) ^ _GOLDEN)
    for f in fields:
        h = _mix32(h ^ ((_mul32(_u32(f), _GOLDEN) + 0x85EBCA6B) & _MASK))
    return h


def uniform_from_bits(bits, open_zero: bool = False):
    """uint32 bits -> f32 uniform from the top 24 bits; ``open_zero=True``
    maps to (0, 1] (safe under log), else [0, 1)."""
    u = (bits >> 8).to(torch.float32)
    if open_zero:
        u = u + 1.0
    return u * (2.0**-24)


@functools.cache
def _vml_ready() -> None:
    """Run torch's CPU log, sqrt and cos once on one element, on the calling
    thread, before any call splits them across threads.

    On an x86 build with MKL, these ops call MKL's vector math (``vmsLn``,
    ``vmsSqrt``, ``vmsCos``) in its high-accuracy mode.  Under a loaded
    CPU, a process's first such call, split over several OpenMP threads,
    has been seen to compute one thread's chunk with MKL's AVX2
    enhanced-performance log instead (r off by up to 737 ulp), while every
    later call repeated exactly: MKL sets itself up on first use, and
    concurrent first uses race.  A call below torch's parallel grain runs
    on this thread alone and does that set-up first
    (``tests/counter_normal_stress.py`` counts both cases)."""
    one = torch.ones(1)
    for op in (torch.log, torch.sqrt, torch.cos):
        op(one)


def normal_from_bits(bits_a, bits_b):
    """Two independent uint32 bit arrays -> standard-normal f32 (Box-Muller)."""
    if bits_a.device.type == "cpu":
        _vml_ready()
    u1 = uniform_from_bits(bits_a, open_zero=True)
    u2 = uniform_from_bits(bits_b)
    r = torch.sqrt(-2.0 * torch.log(u1))
    two_pi = torch.tensor(2.0 * math.pi, dtype=torch.float32)
    return r * torch.cos(two_pi.to(u2.device) * u2)


def counter_normal(seed, *fields):
    """Standard-normal draw at the given counter site(s); deterministic in
    ``(seed, fields)`` and independent of tiling."""
    return normal_from_bits(hash_u32(seed, *fields, 1),
                            hash_u32(seed, *fields, 2))


def derive_seed(seed, *fields) -> int:
    """A child seed (Python int) for a counter path, e.g. per layer."""
    return int(hash_u32(int(seed), *(int(f) for f in fields)))
