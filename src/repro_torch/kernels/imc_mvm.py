"""The IMC matmul kernels: bit-serial QS-Arch (paper SSIV-B2) and the
analytic folded-noise model.

``imc_bitserial_matmul`` dispatches on the device of its operands: CPU
tensors take the plain version ``ref.imc_bitserial_ref``; CUDA tensors launch
the hand-written kernel in ``csrc/bitserial.cu`` (it replaces the TPU kernel
``repro/kernels/imc_mvm.py::_bitserial_kernel``) or raise.  The kernel takes
the integer codes as one byte each and the gain as float32, padded by
``kernel_layout`` to 16-row K steps and 8-column tiles; with gain it sums the
planes on the FP64 tensor cores, without by popcount.  Its noise comes from
the counter hash at global ``(bank, plane, b, m)`` sites, so it matches the
plain version draw for draw.

``pack_weight_planes`` (the TPU kernel's host-side (K, Bw, M) plane packer)
is kept for the plain path and for tests; the CUDA kernel does not use it.

``imc_analytic_matmul`` dispatches the same way: CPU tensors take
``ref.imc_analytic_ref``; CUDA tensors launch ``csrc/analytic.cu`` (it
replaces ``repro/kernels/imc_mvm.py::_analytic_kernel``: the float product
on the TF32 tensor cores, each operand split into two TF32 limbs, so it
keeps float32's precision) or raise.  Its noise is the counter-hash normal
at global ``(b, m)`` sites, as in the plain version.

``imc_analytic_codes_matmul`` is the analytic matmul of integer codes of at
most 8 bits, ``ADC_MPC((x_codes @ w_codes) / sigma_yo + sigma_out z)``: CPU
tensors take the plain version ``ref.imc_analytic_ref(x_codes / sigma_yo,
w_codes)``; CUDA tensors launch ``csrc/analytic_int8.cu``, the exact code
product on the int8 tensor cores with the division by ``sigma_yo`` in the
epilogue, or raise.  ``int8_route_fits`` says which codes it takes;
``ops.imc_matmul`` sends wider codes to ``imc_analytic_matmul``.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.ref import AnalyticSpec, BitSerialSpec, unpack_plane


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


# the bit-serial kernel's layout: bank rows and K in 16-row MMA steps,
# weight columns in 8-column tiles
BITSERIAL_K_STEP, BITSERIAL_N_TILE = 16, 8


def kernel_layout(x, w, w_gain, rows: int):
    """``(x, w, w_gain, rows)`` padded to the bit-serial kernel's layout:
    each bank's rows to a multiple of 16 when ``rows`` is not one (else only
    K, at the end), with zero codes (gain 1), and the columns to a multiple
    of 8 with zero codes.  Banks keep their index and the live (b, m)
    their place, so the result's first M columns, and its noise sites, are
    those of the unpadded call.  Operands already in the layout come back as
    they are."""
    k, m = w.shape
    step, tile = BITSERIAL_K_STEP, BITSERIAL_N_TILE
    pad = torch.nn.functional.pad
    if rows % step:
        n_banks = -(-k // rows)
        rows_p = -(-rows // step) * step

        def banked(t, value=0.0):  # (K, N) -> (n_banks * rows_p, N)
            t = pad(t, (0, 0, 0, n_banks * rows - k), value=value)
            t = pad(t.reshape(n_banks, rows, -1), (0, 0, 0, rows_p - rows),
                    value=value)
            return t.reshape(n_banks * rows_p, -1)

        x = banked(x.t()).t().contiguous()
        w = banked(w)
        if w_gain is not None:
            w_gain = banked(w_gain, 1.0)
        rows = rows_p
    elif k % step:
        kp = -(-k // step) * step
        x = pad(x, (0, kp - k))
        w = pad(w, (0, 0, 0, kp - k))
        if w_gain is not None:
            w_gain = pad(w_gain, (0, 0, 0, kp - k), value=1.0)
    if m % tile:
        mp = -(-m // tile) * tile
        w = pad(w, (0, mp - m))
        if w_gain is not None:
            w_gain = pad(w_gain, (0, mp - m), value=1.0)
    return x, w, w_gain, rows


def bitserial_c_args(x8, w8, gain, out, spec: BitSerialSpec, rows: int,
                     seed: Optional[int] = None, col0: int = 0):
    """The arguments of the C entry point ``imc_bitserial_matmul`` for
    operands already in the kernel's layout (``kernel_layout``: uint8 codes,
    a dense float32 gain or None, ``rows`` the padded bank height), on the
    current stream; ``col0`` is the global index of ``w8``'s first column
    in the noise sites."""
    b_sz, kp = x8.shape
    has_noise = seed is not None and spec.sigma_noise > 0.0
    return (x8.data_ptr(), w8.data_ptr(),
            None if gain is None else gain.data_ptr(), out.data_ptr(),
            b_sz, kp, w8.shape[1], rows, spec.bx, spec.bw,
            int(spec.x_signed), ctypes.c_float(min(spec.k_h, 3e38)),
            int(spec.apply_adc),
            ctypes.c_float(spec.v_c / (2.0**spec.b_adc)),
            ctypes.c_float(2.0**spec.b_adc - 1), int(has_noise),
            ctypes.c_uint32(int(seed or 0) & 0xFFFFFFFF),
            ctypes.c_float(spec.sigma_noise), int(col0),
            torch.cuda.current_stream(x8.device).cuda_stream)


def bitserial_cuda(x_codes, w_codes, w_gain, spec: BitSerialSpec,
                   seed: Optional[int] = None, col0: int = 0):
    """Launch the CUDA bit-serial kernel; returns (B, M) f32 in code units.
    ``col0`` offsets the column of every noise site."""
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
    gain = None
    if w_gain is not None:
        if tuple(w_gain.shape) != (k, m) or w_gain.device != dev:
            raise ValueError("w_gain must be (K, M) on the operands' device")
        gain = w_gain.to(torch.float32)
    x8, w8, gain, rows = kernel_layout(_code_bytes(x_codes),
                                       _code_bytes(w_codes), gain, spec.rows)
    if gain is not None:  # 16-byte copies need an aligned, dense gain
        gain = gain.contiguous()
        if gain.data_ptr() % 16:
            gain = gain.clone()
    mp = w8.shape[1]
    out = torch.empty((b_sz, mp), dtype=torch.float32, device=dev)
    err = build.library("bitserial").imc_bitserial_matmul(
        *bitserial_c_args(x8, w8, gain, out, spec, rows, seed, col0))
    if err != 0:
        raise build.launch_failed("bitserial", err)
    bitserial_cuda.launches += 1
    if gain is not None:  # of them, launches of the gain instantiation
        bitserial_cuda.gain_launches += 1
    return out if mp == m else out[:, :m].contiguous()


bitserial_cuda.launches = 0
bitserial_cuda.gain_launches = 0


def imc_bitserial_matmul(x_codes, w_codes, w_gain, spec: BitSerialSpec,
                         seed: Optional[int] = None, col0: int = 0):
    """Bit-serial IMC matmul of integer codes ``(B, K) @ (K, M)``; returns
    ``(B, M)`` f32 in code units.  ``seed`` (an int) enables the per-plane
    temporal noise of ``spec.sigma_noise`` counts; ``w_gain`` the per-cell
    mismatch gain.  ``col0`` is the global index of ``w_codes``' first
    column in the noise sites (a shard of a weight split by columns).  CPU
    tensors take the plain version, CUDA tensors the kernel."""
    if x_codes.device.type == "cpu":
        return ref.imc_bitserial_ref(x_codes, w_codes, w_gain, spec,
                                     seed=seed, col0=col0)
    if x_codes.device.type != "cuda":
        raise ValueError(f"no bit-serial kernel for device {x_codes.device}")
    return bitserial_cuda(x_codes, w_codes, w_gain, spec, seed=seed,
                          col0=col0)


def analytic_cuda(x, w_codes, spec: AnalyticSpec, seed: Optional[int] = None):
    """Launch the CUDA analytic kernel; returns (B, M) f32 in the units of
    ``x @ w_codes`` (sigma_yo units when ``x`` is codes / sigma_yo)."""
    dev = x.device
    if dev.type != "cuda" or w_codes.device != dev:
        raise ValueError("analytic_cuda needs both operands on one CUDA "
                         f"device, got {x.device} and {w_codes.device}")
    if x.dim() != 2 or w_codes.dim() != 2:
        raise ValueError("analytic_cuda takes 2-D (B, K) and (K, M) operands")
    b_sz, k = x.shape
    k2, m = w_codes.shape
    if k != k2:
        raise ValueError(f"inner dimensions differ: {k} vs {k2}")
    xf = x.to(torch.float32).contiguous()
    wf = w_codes.to(torch.float32).contiguous()
    # the kernel's 16-byte copies: K and M in fours (zero codes add
    # nothing; padded columns are cut off), operands 16-byte aligned
    pk, pm = -k % 4, -m % 4
    if pk:
        xf = torch.nn.functional.pad(xf, (0, pk))
    if pk or pm:
        wf = torch.nn.functional.pad(wf, (0, pm, 0, pk))
    if xf.data_ptr() % 16:
        xf = xf.clone()
    if wf.data_ptr() % 16:
        wf = wf.clone()
    has_noise = seed is not None and spec.sigma_out > 0.0
    half = 2.0 ** (spec.b_adc - 1)
    out = torch.empty((b_sz, m + pm), dtype=torch.float32, device=dev)
    lib = build.library("analytic")
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.imc_analytic_matmul(
        xf.data_ptr(), wf.data_ptr(), out.data_ptr(), b_sz, k + pk, m + pm,
        int(has_noise), ctypes.c_uint32(int(seed or 0) & 0xFFFFFFFF),
        ctypes.c_float(spec.sigma_out), int(spec.apply_adc),
        ctypes.c_float(2.0 * spec.y_clip / 2.0**spec.b_adc),
        ctypes.c_float(-half), ctypes.c_float(half - 1), stream)
    if err != 0:
        raise build.launch_failed("analytic", err)
    analytic_cuda.launches += 1
    return out if not pm else out[:, :m].contiguous()


analytic_cuda.launches = 0


def imc_analytic_matmul(x, w_codes, spec: AnalyticSpec,
                        seed: Optional[int] = None):
    """Analytic-mode IMC matmul ``ADC_MPC(x @ w_codes + sigma_out * z)``;
    returns (B, M) f32.  ``seed`` (an int) enables the folded output noise;
    ``seed=None`` or ``spec.sigma_out == 0`` disables it.  CPU tensors take
    the plain version, CUDA tensors the kernel."""
    if x.device.type == "cpu":
        return ref.imc_analytic_ref(x, w_codes, spec, seed=seed)
    if x.device.type != "cuda":
        raise ValueError(f"no analytic kernel for device {x.device}")
    return analytic_cuda(x, w_codes, spec, seed=seed)


# ---------------------------------------------------------------------------
# the codes route: 8-bit codes on the int8 tensor cores
# ---------------------------------------------------------------------------

INT32_MAX = 2**31 - 1


def int8_route_fits(bx: int, bw: int, x_signed: bool, k: int) -> bool:
    """Whether ``bx``-bit activation codes (signed or not) and ``bw``-bit
    signed weight codes fit the int8 kernel: one byte each, and a K-term sum
    of the largest products inside int32 (so the sums are exact)."""
    if not (1 <= bx <= 8 and 1 <= bw <= 8):
        return False
    x_max = 2 ** (bx - 1) if x_signed else 2**bx - 1
    return k * x_max * 2 ** (bw - 1) <= INT32_MAX


def _check_codes_route(bx: int, bw: int, x_signed: bool, k: int) -> None:
    if not (1 <= bx <= 8 and 1 <= bw <= 8):
        raise ValueError(f"bx={bx}, bw={bw}: the int8 route takes codes of "
                         "at most 8 bits")
    if not int8_route_fits(bx, bw, x_signed, k):
        raise ValueError(f"K={k}: a sum of {k} products of {bx}- and "
                         f"{bw}-bit codes may overflow int32")


def int8_tile(b: int, m: int, sms: int = build.SMS) -> int:
    """N of the int8 kernel's 64 x N output tiles: 128 where that still
    gives one CTA per SM, else 64."""
    return 128 if -(-b // 64) * -(-m // 128) >= sms else 64


def analytic_int8_cuda(x8, w8, sigma_yo, spec: AnalyticSpec,
                       seed: Optional[int] = None):
    """Launch the int8 analytic kernel on ``x8`` (B, K) uint8 or int8 codes
    and ``w8`` (M, K) int8 codes (K-major), with ``sigma_yo`` a one-element
    float32 tensor on the card; returns (B, M) f32 in sigma_yo units."""
    dev = x8.device
    if dev.type != "cuda" or w8.device != dev or sigma_yo.device != dev:
        raise ValueError("analytic_int8_cuda needs its operands on one CUDA "
                         f"device, got {x8.device}, {w8.device} and "
                         f"{sigma_yo.device}")
    if x8.dtype not in (torch.uint8, torch.int8) or w8.dtype != torch.int8:
        raise TypeError(f"codes must be uint8/int8 and int8, got {x8.dtype} "
                        f"and {w8.dtype}")
    if sigma_yo.dtype != torch.float32 or sigma_yo.numel() != 1:
        raise ValueError("sigma_yo must be one float32")
    if x8.dim() != 2 or w8.dim() != 2 or x8.shape[1] != w8.shape[1]:
        raise ValueError(f"operands (B, K) and (M, K) expected, got "
                         f"{tuple(x8.shape)} and {tuple(w8.shape)}")
    b_sz, k = x8.shape
    m = w8.shape[0]
    if not int8_route_fits(8, 8, x8.dtype == torch.int8, k):
        raise ValueError(f"K={k}: a sum of {k} products of 8-bit codes may "
                         "overflow int32")
    pad = -k % 16  # 16-byte rows for the 16-byte copies; zero codes add 0
    if pad:
        x8 = torch.nn.functional.pad(x8, (0, pad))
        w8 = torch.nn.functional.pad(w8, (0, pad))
    x8, w8 = x8.contiguous(), w8.contiguous()
    # the MMA kernel writes its int32 sums here, the epilogue pass turns
    # them into the float outputs in place
    out = torch.empty((b_sz, m), dtype=torch.float32, device=dev)
    has_noise = seed is not None and spec.sigma_out > 0.0
    half = 2.0 ** (spec.b_adc - 1)
    lib = build.library("analytic_int8")
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.imc_analytic_int8_matmul(
        x8.data_ptr(), w8.data_ptr(), sigma_yo.data_ptr(), out.data_ptr(),
        b_sz, k + pad, m, int(x8.dtype == torch.uint8), int8_tile(b_sz, m),
        int(has_noise), ctypes.c_uint32(int(seed or 0) & 0xFFFFFFFF),
        ctypes.c_float(spec.sigma_out), int(spec.apply_adc),
        ctypes.c_float(2.0 * spec.y_clip / 2.0**spec.b_adc),
        ctypes.c_float(-half), ctypes.c_float(half - 1), stream)
    if err != 0:
        raise build.launch_failed("analytic_int8", err)
    analytic_int8_cuda.launches += 1
    return out


analytic_int8_cuda.launches = 0


def _assert_codes_in_range(codes, bits: int, signed: bool, name: str):
    """Raise where a code lies outside its ``bits``-bit range: at once on
    the CPU, as a device-side assert on the card (no host sync; the error
    surfaces at the next synchronisation and leaves the CUDA context
    unusable, as any device-side assert does)."""
    if codes.numel() == 0:
        return
    lo, hi = ((-(2 ** (bits - 1)), 2 ** (bits - 1) - 1) if signed
              else (0, 2**bits - 1))
    mn, mx = torch.aminmax(codes)
    torch._assert_async((mn >= lo) & (mx <= hi),
                        f"{name} codes outside [{lo}, {hi}]")


def imc_analytic_codes_matmul(x_codes, w_codes, sigma_yo, spec: AnalyticSpec,
                              *, bx: int, bw: int, x_signed: bool,
                              seed: Optional[int] = None):
    """Analytic-mode IMC matmul of integer codes, ``ADC_MPC((x_codes @
    w_codes) / sigma_yo + sigma_out * z)``; returns (B, M) f32 in sigma_yo
    units.  ``x_codes`` (B, K) are ``bx``-bit codes (unsigned unless
    ``x_signed``), ``w_codes`` (K, M) ``bw``-bit signed codes, both in any
    dtype that holds them exactly; ``sigma_yo`` a positive float or
    one-element tensor.  Raises unless the widths fit the int8 kernel
    (:func:`int8_route_fits`), and where a code lies outside its width
    (:func:`_assert_codes_in_range`), on every device.  CPU tensors take
    the plain version, CUDA tensors the kernel."""
    k = x_codes.shape[-1]
    _check_codes_route(bx, bw, x_signed, k)
    _assert_codes_in_range(x_codes, bx, x_signed, "activation")
    _assert_codes_in_range(w_codes, bw, True, "weight")
    if x_codes.device.type == "cpu":
        return ref.imc_analytic_ref(
            ref.true_div(x_codes.to(torch.float32), sigma_yo),
            w_codes.to(torch.float32), spec, seed=seed)
    dev = x_codes.device
    if dev.type != "cuda":
        raise ValueError(f"no analytic int8 kernel for device {dev}")
    x8 = x_codes.to(torch.int8 if x_signed else torch.uint8)
    # (K, M) -> (M, K) int8 in one pass: the kernel takes both operands
    # K-major
    w8 = torch.empty((w_codes.shape[1], k), dtype=torch.int8, device=dev)
    w8.copy_(w_codes.t())
    sig = torch.as_tensor(sigma_yo, dtype=torch.float32, device=dev)
    return analytic_int8_cuda(x8, w8, sig.reshape(1), spec, seed=seed)
