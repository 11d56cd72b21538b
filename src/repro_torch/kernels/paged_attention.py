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
inactive row attends the stale tail value, as the gather path does.  Every
new row is written before any row is read, and where several slots route to
the same pool row (inactive slots at one offset of block 0, or a retired
slot's stale table), the highest slot's row lands (``scatter_new_rows``):
an inactive row's output is the same on every run, which matters because
it enters the batch-wide quantizer ranges of the IMC substrates.

Dispatch (``paged_attention_decode``): tensors on the CPU take the plain
streamed walk ``decode_plain``; CUDA tensors launch the hand-written kernel in
``csrc/paged_attention.cu`` (it replaces the TPU kernel
``repro/kernels/paged_attention.py::_paged_kernel``) or raise.  Both update the
pools IN PLACE and return them.  The kernel writes only the one new row,
where the TPU kernel wrote whole blocks back; the pools agree outside block 0.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import List, Optional, Tuple

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


def scatter_new_rows(pk, pv, k_new, v_new, dest, off):
    """Write each slot's new K/V row (all kv heads) at pool row ``(dest,
    off)``, in place; where several slots share a destination the highest
    slot's row lands: every slot writing there writes that row, so the
    result does not depend on the order of the writes (and no shape
    depends on the data, so a CUDA graph can capture it)."""
    key = dest * pk.shape[1] + off
    rows = torch.arange(key.shape[0], device=key.device)
    same = key[None, :] == key[:, None]
    last = torch.where(same, rows[None, :], -1).amax(dim=1)
    pk[dest, off] = k_new[last].to(pk.dtype)
    pv[dest, off] = v_new[last].to(pv.dtype)


def decode_plain(q, k_new, v_new, pk, pv, bt, pos_b, active=None, *,
                 scale: float, softcap: Optional[float] = None):
    """The plain streamed walk: scatter the new K/V, then fold one
    (B, bs, Hkv, hd) block per step into the m/l/acc recurrence.  The
    gathered ``pool[bt]`` copy is never built."""
    b, max_blocks = bt.shape
    bs = pk.shape[1]
    pos_b = pos_b.to(torch.int64)
    dest, off = write_routing(bt, pos_b, bs, active)
    scatter_new_rows(pk, pv, k_new, v_new, dest, off)
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

# the CUDA kernel's plan: at most 8 kv heads per CTA (one warp each), at
# most 2 query rows of each head per CTA (larger groups take several CTAs:
# with 4 or 8 the warps' register state spills; chip_smoke.py --phases
# device,chunks times the choices), and enough splits of each slot's rows
# for about two CTAs per SM of an H100
MAX_HEADS_PER_CTA = 8
MAX_G_PER_CTA = 2
STAGES = 3  # kStages of csrc/paged_attention.cu
ROWS_PER_GROUP = 4  # kRows of csrc/paged_attention.cu
MIN_SPLIT_ROWS = 64


@dataclasses.dataclass(frozen=True)
class SplitPlan:
    """How ``csrc/paged_attention.cu`` covers a call: a grid of (head
    groups x ``q_chunks``, slots, ``n_splits``) CTAs, each over ``heads`` kv
    heads, ``gm`` query rows of each (a chunk: G > gm takes ``q_chunks``
    CTAs) and up to ``split_rows`` logical rows, streamed
    ``stage_rows`` at a time; ``lpr`` lanes hold a row as ``nv`` 16-byte
    vectors each."""

    heads: int
    head_groups: int
    stage_rows: int
    split_rows: int
    n_splits: int
    lpr: int
    nv: int
    gm: int
    q_chunks: int
    scratch_floats: int
    smem_bytes: int

    @functools.cached_property
    def args(self) -> Tuple[int, ...]:
        """The plan's arguments of the C entry point, in its order."""
        return (self.heads, self.stage_rows, self.split_rows, self.n_splits,
                self.lpr, self.nv, self.gm)

    def ranges(self, limit: int) -> List[Tuple[int, int]]:
        """The [lo, hi) logical rows each split reads of a slot whose valid
        rows are [0, limit), as the kernel computes them; splits that get no
        row are left out (their CTAs return at once)."""
        out = []
        for sp in range(self.n_splits):
            lo = sp * self.split_rows
            hi = min(lo + self.split_rows, limit)
            if lo < hi:
                out.append((lo, hi))
        return out


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


@functools.lru_cache(maxsize=256)
def plan_split(b: int, hkv: int, g: int, hd: int, bs: int, max_blocks: int,
               elt: int, sms: int = build.SMS) -> SplitPlan:
    """The kernel's plan from the shapes alone (no position is read on the
    host): the largest divisor of Hkv up to 8 as heads per CTA; query rows
    per CTA the next power of two of G up to ``MAX_G_PER_CTA`` (a power of
    two up to 8), in ``ceil(G / MAX_G_PER_CTA)`` chunks beyond; stage rows
    four per row group of a warp (128 / lpr: at most 32 KB of K and V for 8
    heads, 64 KB for hd * elt = 1024 bytes, where nv = 2);
    split rows, a multiple of the stage rows and at least MIN_SPLIT_ROWS,
    such that a slot at full capacity spans about ``2 * sms / (B * head
    groups * query chunks)`` splits.  Raises for shapes the kernel does not
    take."""
    if g < 1 or not 1 <= hd <= 256 or (hd * elt) % 16:
        raise ValueError(f"G={g}, hd={hd}: the kernel takes G >= 1 and "
                         "hd <= 256 with 16-byte rows per head")
    if MAX_G_PER_CTA not in (1, 2, 4, 8):
        raise ValueError(f"MAX_G_PER_CTA={MAX_G_PER_CTA}: a power of two "
                         "up to 8")
    heads = max(d for d in range(1, min(hkv, MAX_HEADS_PER_CTA) + 1)
                if hkv % d == 0)
    groups = hkv // heads
    row_bytes = heads * hd * elt
    vectors = hd * elt // 16
    lpr = min(32, _pow2_at_least(vectors))
    nv = -(-vectors // lpr)
    stage_rows = ROWS_PER_GROUP * 32 // lpr
    gm = min(_pow2_at_least(g), MAX_G_PER_CTA)
    q_chunks = -(-g // gm)
    cap = max_blocks * bs
    want = -(-2 * sms // (b * groups * q_chunks))
    split_rows = max(-(-cap // want), MIN_SPLIT_ROWS)
    split_rows = -(-split_rows // stage_rows) * stage_rows
    n_splits = -(-cap // split_rows)
    scratch = b * hkv * n_splits * g * (hd + 2) if n_splits > 1 else 0
    smem = STAGES * 2 * stage_rows * row_bytes + 8 * split_rows
    return SplitPlan(heads=heads, head_groups=groups, stage_rows=stage_rows,
                     split_rows=split_rows, n_splits=n_splits, lpr=lpr,
                     nv=nv, gm=gm, q_chunks=q_chunks, scratch_floats=scratch,
                     smem_bytes=smem)


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
    """Launch the CUDA paged-attention kernel: one CTA per (head group and
    query chunk, slot, split of logical rows), planned by
    :func:`plan_split`, and a combine pass over the slots whose rows span
    several splits.  ``q`` is f32 ``(B, Hkv, G, hd)``;
    ``k_new``/``v_new`` are in the pool dtype; ``bt``/``pos_b``/``active``
    are int32.  Updates the pools in place and returns
    ``(ctx f32, pk, pv)``."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"paged_attention_cuda needs CUDA tensors, got {dev}")
    b, hkv, g, hd = q.shape
    nb, bs = pk.shape[0], pk.shape[1]
    max_blocks = bt.shape[1]
    if pk.dtype not in _DTYPE_CODE:
        raise TypeError(f"unsupported pool dtype {pk.dtype}")
    _check(q, "q", (b, hkv, g, hd), torch.float32, dev)
    _check(k_new, "k_new", (b, hkv, hd), pk.dtype, dev)
    _check(v_new, "v_new", (b, hkv, hd), pk.dtype, dev)
    _check(pk, "pk", (nb, bs, hkv, hd), pk.dtype, dev)
    _check(pv, "pv", (nb, bs, hkv, hd), pk.dtype, dev)
    _check(bt, "bt", (b, max_blocks), torch.int32, dev)
    _check(pos_b, "pos_b", (b,), torch.int32, dev)
    _check(active, "active", (b,), torch.int32, dev)
    # the kernel reads these as 16-byte vectors (q as scalars)
    for name, t in (("k_new", k_new), ("v_new", v_new), ("pk", pk),
                    ("pv", pv)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    plan = plan_split(b, hkv, g, hd, bs, max_blocks, pk.element_size())
    scratch = torch.empty((max(plan.scratch_floats, 1),),
                          dtype=torch.float32, device=dev)
    ctx = torch.empty((b, hkv, g, hd), dtype=torch.float32, device=dev)
    lib = build.library("paged_attention")
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.paged_attention_decode(
        q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), pk.data_ptr(),
        pv.data_ptr(), bt.data_ptr(), pos_b.data_ptr(), active.data_ptr(),
        scratch.data_ptr(), ctx.data_ptr(), b, hkv, g, hd, bs, max_blocks,
        _DTYPE_CODE[pk.dtype], *plan.args, ctypes.c_float(scale),
        ctypes.c_float(0.0 if softcap is None else softcap),
        int(softcap is not None), stream)
    if err != 0:
        raise build.launch_failed("paged_attention", err)
    paged_attention_cuda.launches += 1
    key = layout_key(hkv, g, hd, pk.dtype)
    paged_attention_cuda.layouts[key] = (
        paged_attention_cuda.layouts.get(key, 0) + 1)
    return ctx, pk, pv


def layout_key(hkv: int, g: int, hd: int, dtype) -> str:
    """The name of a kernel layout in the launch counts, e.g.
    ``"hkv1_g48_hd128_bf16"``."""
    name = {torch.float32: "f32", torch.bfloat16: "bf16"}[dtype]
    return f"hkv{hkv}_g{g}_hd{hd}_{name}"


paged_attention_cuda.launches = 0
# launches by layout (``layout_key``), counted where ``launches`` is
paged_attention_cuda.layouts = {}


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
