"""The bit-serial QS-Arch IMC matmul (paper SSIV-B2).

``imc_bitserial_matmul`` dispatches on the device of its operands: CPU
tensors take the plain version ``ref.imc_bitserial_ref``; CUDA tensors launch
the hand-written kernel in ``csrc/bitserial.cu`` (it replaces the TPU kernel
``repro/kernels/imc_mvm.py::_bitserial_kernel``) or raise.  The kernel takes
the integer codes as one byte each and extracts the bit planes in registers;
its noise comes from the counter hash at global ``(bank, plane, b, m)`` sites,
so it matches the plain version draw for draw.

``pack_weight_planes`` (the TPU kernel's host-side (K, Bw, M) plane packer)
is kept for the plain path and for tests; the CUDA kernel does not use it.
The analytic-mode kernel (``_analytic_kernel``) is not ported yet.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.ref import BitSerialSpec, unpack_plane


def pack_weight_planes(w_codes, w_gain, bw: int):
    """(K, Bw, M) f32 weight bit planes with the sign-plane flip and the
    per-cell gain (paper eq. 18) folded in."""
    w = w_codes.to(torch.float32)
    wp = torch.stack([unpack_plane(w, i, bw, signed=True) for i in range(bw)],
                     dim=1)
    if w_gain is not None:
        wp = wp * w_gain.to(torch.float32)[:, None, :]
    return wp


def _code_bytes(codes):
    """Integer codes (any dtype) -> their low 8 bits as uint8: the bit planes
    (two's complement for signed codes, top plane = sign).  The codes must lie
    in their B-bit range, as ``quantize_codes`` makes them; the values are not
    checked here, since that would stall the host on every call."""
    return (codes.to(torch.int16) & 0xFF).to(torch.uint8).contiguous()


def bitserial_cuda(x_codes, w_codes, w_gain, spec: BitSerialSpec,
                   seed: Optional[int] = None):
    """Launch the CUDA bit-serial kernel; returns (B, M) f32 in code units."""
    dev = x_codes.device
    if dev.type != "cuda" or w_codes.device != dev:
        raise ValueError("bitserial_cuda needs both operands on one CUDA "
                         f"device, got {x_codes.device} and {w_codes.device}")
    if x_codes.dim() != 2 or w_codes.dim() != 2:
        raise ValueError("bitserial_cuda takes 2-D (B, K) and (K, M) codes")
    b_sz, k = x_codes.shape
    k2, m = w_codes.shape
    if k != k2:
        raise ValueError(f"inner dimensions differ: {k} vs {k2}")
    if not (1 <= spec.bx <= 8 and 1 <= spec.bw <= 8):
        raise ValueError(f"bx={spec.bx}, bw={spec.bw}: the kernel takes "
                         "codes of at most 8 bits")
    x8 = _code_bytes(x_codes)
    w8 = _code_bytes(w_codes)
    gain = None
    if w_gain is not None:
        if tuple(w_gain.shape) != (k, m) or w_gain.device != dev:
            raise ValueError("w_gain must be (K, M) on the operands' device")
        gain = w_gain.to(torch.float32).contiguous()
    has_noise = seed is not None and spec.sigma_noise > 0.0
    out = torch.empty((b_sz, m), dtype=torch.float32, device=dev)
    lib = build.library("bitserial")
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.imc_bitserial_matmul(
        x8.data_ptr(), w8.data_ptr(),
        None if gain is None else gain.data_ptr(), out.data_ptr(),
        b_sz, k, m, spec.rows, spec.bx, spec.bw, int(spec.x_signed),
        ctypes.c_float(min(spec.k_h, 3e38)), int(spec.apply_adc),
        ctypes.c_float(spec.v_c / (2.0**spec.b_adc)),
        ctypes.c_float(2.0**spec.b_adc - 1), int(has_noise),
        ctypes.c_uint32(int(seed or 0) & 0xFFFFFFFF),
        ctypes.c_float(spec.sigma_noise), stream)
    if err != 0:
        raise RuntimeError("bitserial kernel launch failed: "
                           f"{build.error_string('bitserial', err)}")
    bitserial_cuda.launches += 1
    if gain is not None:  # of them, launches of the gain instantiation
        bitserial_cuda.gain_launches += 1
    return out


bitserial_cuda.launches = 0
bitserial_cuda.gain_launches = 0


def imc_bitserial_matmul(x_codes, w_codes, w_gain, spec: BitSerialSpec,
                         seed: Optional[int] = None):
    """Bit-serial IMC matmul of integer codes ``(B, K) @ (K, M)``; returns
    ``(B, M)`` f32 in code units.  ``seed`` (an int) enables the per-plane
    temporal noise of ``spec.sigma_noise`` counts; ``w_gain`` the per-cell
    mismatch gain.  CPU tensors take the plain version, CUDA tensors the
    kernel."""
    if x_codes.device.type == "cpu":
        return ref.imc_bitserial_ref(x_codes, w_codes, w_gain, spec,
                                     seed=seed)
    if x_codes.device.type != "cuda":
        raise ValueError(f"no bit-serial kernel for device {x_codes.device}")
    return bitserial_cuda(x_codes, w_codes, w_gain, spec, seed=seed)
