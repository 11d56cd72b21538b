"""Paged-attention decode: one token per slot against a paged KV block pool.

Layout (``models.attention.init_paged_kv_cache``): pools ``(num_blocks,
block_size, Hkv, hd)``, a per-slot block table ``(B, max_blocks)``, physical
block 0 reserved as the GARBAGE block.  Each call scatters the new token's
K/V into its slot's tail block and attends over the slot's blocks in LOGICAL
order with an online softmax (running max ``m``, sum ``l``, accumulator
``acc``), so the output does not depend on which physical blocks the
allocator handed out.

Garbage-block-0 write contract (``write_routing``, the single source of truth
for the plain walk, the gather path and the CUDA kernel): the write goes to
the slot's tail block only for an ACTIVE row whose position is in range;
inactive rows (a retired slot's stale table may point at reused blocks) and
OVERRUN rows (``pos >= max_blocks * block_size``) write to block 0.  An
inactive row attends the stale tail value, as the gather path does.

Dispatch (``paged_attention_decode``): tensors on the CPU take the plain
streamed walk ``decode_plain``; CUDA tensors launch the hand-written kernel in
``csrc/paged_attention.cu`` (it replaces the TPU kernel
``repro/kernels/paged_attention.py::_paged_kernel``) or raise.  Both update the
pools IN PLACE and return them.  The kernel writes only the one new row,
where the TPU kernel wrote whole blocks back; the pools agree outside block 0.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import NEG_INF


def write_routing(bt, pos_b, block_size: int, active=None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dest, off): physical block and in-block row of each slot's new K/V,
    following the garbage-block-0 contract."""
    b, max_blocks = bt.shape
    pos_b = pos_b.to(torch.int64)
    rows = torch.arange(b, device=bt.device)
    tail = torch.div(pos_b, block_size, rounding_mode="floor")
    dest = bt[rows, torch.clamp(tail, 0, max_blocks - 1)].to(torch.int64)
    dest = torch.where(tail >= max_blocks, 0, dest)
    if active is not None:
        dest = torch.where(active.to(torch.bool), dest, 0)
    return dest, torch.remainder(pos_b, block_size)


def decode_plain(q, k_new, v_new, pk, pv, bt, pos_b, active=None, *,
                 scale: float, softcap: Optional[float] = None):
    """The plain streamed walk: scatter the new K/V, then fold one
    (B, bs, Hkv, hd) block per step into the m/l/acc recurrence.  The
    gathered ``pool[bt]`` copy is never built."""
    b, max_blocks = bt.shape
    bs = pk.shape[1]
    pos_b = pos_b.to(torch.int64)
    k_new = k_new.to(pk.dtype)
    v_new = v_new.to(pv.dtype)
    dest, off = write_routing(bt, pos_b, bs, active)
    pk[dest, off] = k_new
    pv[dest, off] = v_new
    qf = q.to(torch.float32)
    hkv, g, hd = q.shape[1], q.shape[2], q.shape[3]
    m = torch.full((b, hkv, g), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, hkv, g), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, hkv, g, hd), dtype=torch.float32, device=q.device)
    bt_l = bt.to(torch.int64)
    rows = torch.arange(bs, device=q.device)
    for j in range(max_blocks):
        phys = bt_l[:, j]
        k_blk = pk[phys].to(torch.float32)  # (B, bs, Hkv, hd)
        v_blk = pv[phys].to(torch.float32)
        s = torch.einsum("bhgd,bkhd->bhgk", qf, k_blk) * scale
        if softcap is not None:
            s = softcap * torch.tanh(s / softcap)
        valid = (j * bs + rows)[None, :] <= pos_b[:, None]
        s = torch.where(valid[:, None, None, :], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhgk,bkhd->bhgd", p,
                                                   v_blk)
        m = m_new
    ctx = acc / torch.clamp(l[..., None], min=1e-30)
    return ctx, pk, pv


_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _check(t: torch.Tensor, name: str, shape, dtype, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def paged_attention_cuda(q, k_new, v_new, pk, pv, bt, pos_b, active, *,
                         scale: float, softcap: Optional[float] = None):
    """Launch the CUDA paged-attention kernel: a split pass (one CTA per
    kv head, slot and 128 logical rows) and a combine pass, from one C
    entry point.  ``q`` is f32 ``(B, Hkv, G, hd)``; ``k_new``/``v_new`` are in
    the pool dtype; ``bt``/``pos_b``/``active`` are int32.  Updates the pools
    in place and returns ``(ctx f32, pk, pv)``."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"paged_attention_cuda needs CUDA tensors, got {dev}")
    b, hkv, g, hd = q.shape
    nb, bs = pk.shape[0], pk.shape[1]
    max_blocks = bt.shape[1]
    if pk.dtype not in _DTYPE_CODE:
        raise TypeError(f"unsupported pool dtype {pk.dtype}")
    if g > 8 or hd > 256:
        raise ValueError(f"G={g}, hd={hd}: the kernel takes G <= 8, hd <= 256")
    _check(q, "q", (b, hkv, g, hd), torch.float32, dev)
    _check(k_new, "k_new", (b, hkv, hd), pk.dtype, dev)
    _check(v_new, "v_new", (b, hkv, hd), pk.dtype, dev)
    _check(pk, "pk", (nb, bs, hkv, hd), pk.dtype, dev)
    _check(pv, "pv", (nb, bs, hkv, hd), pk.dtype, dev)
    _check(bt, "bt", (b, max_blocks), torch.int32, dev)
    _check(pos_b, "pos_b", (b,), torch.int32, dev)
    _check(active, "active", (b,), torch.int32, dev)
    lib = build.library("paged_attention")
    split = lib.paged_attention_split_rows()
    n_splits = -(-max_blocks * bs // split)
    scratch = torch.empty((b * hkv * n_splits * g * (hd + 2),),
                          dtype=torch.float32, device=dev)
    ctx = torch.empty((b, hkv, g, hd), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.paged_attention_decode(
        q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), pk.data_ptr(),
        pv.data_ptr(), bt.data_ptr(), pos_b.data_ptr(), active.data_ptr(),
        scratch.data_ptr(), ctx.data_ptr(), b, hkv, g, hd, bs, max_blocks,
        _DTYPE_CODE[pk.dtype], ctypes.c_float(scale),
        ctypes.c_float(0.0 if softcap is None else softcap),
        int(softcap is not None), stream)
    if err != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: "
                           f"{build.error_string('paged_attention', err)}")
    paged_attention_cuda.launches += 1
    return ctx, pk, pv


paged_attention_cuda.launches = 0


def paged_attention_decode(q, k_new, v_new, pk, pv, bt, pos_b, active=None,
                           *, scale: float, softcap: Optional[float] = None):
    """Fused scatter + block-table walk + online-softmax decode attention.

    ``q`` (B, Hkv, G, hd) grouped queries, ``k_new``/``v_new`` (B, Hkv, hd),
    pools (num_blocks, bs, Hkv, hd), ``bt`` (B, max_blocks), ``pos_b`` (B,)
    tokens already cached, ``active`` (B,) write mask or None.  Returns
    ``(ctx (B, Hkv, G, hd) f32, pk, pv)``; the pools are updated in place.
    CPU tensors take :func:`decode_plain`; CUDA tensors launch the kernel.
    """
    # cast ONCE to the pool dtype, before both the scatter and the overlay,
    # so the new token is attended with exactly the value the pool holds
    k_new = k_new.to(pk.dtype)
    v_new = v_new.to(pv.dtype)
    if q.device.type == "cpu":
        return decode_plain(q, k_new, v_new, pk, pv, bt, pos_b, active,
                            scale=scale, softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"no paged-attention kernel for device {q.device}")
    act = (torch.ones(pos_b.shape, dtype=torch.int32, device=q.device)
           if active is None else active.to(torch.int32))
    return paged_attention_cuda(
        q.to(torch.float32).contiguous(), k_new.contiguous(),
        v_new.contiguous(), pk, pv, bt.to(torch.int32).contiguous(),
        pos_b.to(torch.int32).contiguous(), act.contiguous(), scale=scale,
        softcap=softcap)
