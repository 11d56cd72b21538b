"""GQA/MQA/MHA attention: blocked causal prefill attention (the online-softmax
math of the reference's ``_flash_fwd_impl``, in plain PyTorch ops), the exact
banded path for sliding windows, and single-token decode against either a
contiguous cache (a ring buffer for sliding windows) or a paged KV block pool
(global attention only, as in the reference).

Paged decode takes the paged-attention kernel by default
(``AttnDims.paged_kernel``, from ``cfg.decode_attn="kernel"``: CUDA on the
card, its plain walk on the CPU) or the gather escape hatch
(``decode_attn="gather"``) that materializes ``pool[bt]`` and runs a full-row
softmax.  Both follow the garbage-block-0 write routing.  The pools are
updated IN PLACE (a per-step copy of a multi-GB pool would dominate decode);
so are the contiguous caches.  Flash attention has the reference's
recompute-based backward (``_FlashCore``, a ``torch.autograd.Function``);
banded attention is differentiated by autograd, as the reference's has no
custom VJP.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core.imc_linear import DIGITAL, IMCConfig, linear
from repro_torch.kernels.paged_attention import (
    paged_attention_decode,
    scatter_new_rows,
    write_routing,
)
from repro_torch.kernels.ref import NEG_INF
from repro_torch.models.layers import dense_init, rope


def init_attention(gen, d_model: int, n_heads: int, n_kv: int, head_dim: int,
                   dtype, device):
    return {
        "wq": dense_init(gen, d_model, n_heads * head_dim, dtype, device),
        "wk": dense_init(gen, d_model, n_kv * head_dim, dtype, device),
        "wv": dense_init(gen, d_model, n_kv * head_dim, dtype, device),
        "wo": dense_init(gen, n_heads * head_dim, d_model, dtype, device),
    }


class AttnDims(NamedTuple):
    n_heads: int
    n_kv: int
    head_dim: int
    scale: float
    softcap_val: Optional[float]
    window: Optional[int]
    q_block: int
    kv_block: int
    rope_theta: float
    use_rope: bool
    # paged decode: True takes the paged-attention kernel, False the gather
    # escape hatch (cfg.decode_attn="gather")
    paged_kernel: bool = True
    # tensor parallelism with replicated K/V (Hkv does not divide the model
    # axis): n_heads is this rank's query heads, n_kv every KV head, and
    # the rank's query heads all attend to KV head ``kv_head``
    kv_head: Optional[int] = None


def _project_qkv(params, x, dims: AttnDims, positions, imc, rng,
                 site_prefix: str = "attn"):
    """Q of this rank's query heads and K/V of the heads it holds (column
    splits under tensor parallelism; K/V whole when replicated)."""
    b, s, _ = x.shape
    kv_split = "col" if dims.kv_head is None else None
    q = linear(params["wq"], x, imc, rng, site=f"{site_prefix}.wq",
               split="col").reshape(b, s, dims.n_heads, dims.head_dim)
    k = linear(params["wk"], x, imc, rng, site=f"{site_prefix}.wk",
               split=kv_split).reshape(b, s, dims.n_kv, dims.head_dim)
    v = linear(params["wv"], x, imc, rng, site=f"{site_prefix}.wv",
               split=kv_split).reshape(b, s, dims.n_kv, dims.head_dim)
    if dims.use_rope:
        q = rope(q, positions, dims.rope_theta)
        k = rope(k, positions, dims.rope_theta)
    return q, k, v


def _scores(q_blk, k_blk, dims: AttnDims):
    """q: (B, QB, Hkv, G, hd), k: (B, KB, Hkv, hd) -> (B, Hkv, G, QB, KB)."""
    s = torch.einsum("bqhgd,bkhd->bhgqk", q_blk.to(torch.float32),
                     k_blk.to(torch.float32))
    s = s * dims.scale
    if dims.softcap_val is not None:
        s = dims.softcap_val * torch.tanh(s / dims.softcap_val)
    return s


def _block_mask(q_pos, k_pos, window):
    mask = q_pos[:, None] >= k_pos[None, :]
    if window is not None:
        mask = mask & (q_pos[:, None] - k_pos[None, :] < window)
    return mask


def flash_forward(q, k, v, dims: AttnDims):
    """Blocked causal attention with an online softmax over KV blocks, in
    plain tensor ops (autograd can differentiate it, keeping every score
    block).  q: (B, S, Hq, hd); k, v: (B, S, Hkv, hd).  Returns (out
    (B, S, Hkv, G, hd) in q's dtype, lse (B, Hkv, G, S) float32, the log of
    each row's softmax denominator).  KV blocks wholly in a q block's future
    are skipped: they would add p = 0 and a correction of 1, so the result
    is unchanged.  ``dims.window`` masks keys ``window`` or more positions
    back (the reference's ``_block_mask``)."""
    b, s_q, hq, hd = q.shape
    s_kv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    qb, kb = min(dims.q_block, s_q), min(dims.kv_block, s_kv)
    n_q, n_kv = -(-s_q // qb), -(-s_kv // kb)
    dev = q.device
    qg = q.reshape(b, s_q, hkv, g, hd)
    out = torch.empty((b, s_q, hkv, g, hd), dtype=q.dtype, device=dev)
    lse = torch.empty((b, hkv, g, s_q), dtype=torch.float32, device=dev)
    for iq in range(n_q):
        q0, q1 = iq * qb, min((iq + 1) * qb, s_q)
        q_blk = qg[:, q0:q1]
        nq = q1 - q0
        q_pos = torch.arange(q0, q1, device=dev)
        m = torch.full((b, hkv, g, nq), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((b, hkv, g, nq), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, hkv, g, nq, hd), dtype=torch.float32,
                          device=dev)
        for jk in range(n_kv):
            k0, k1 = jk * kb, min((jk + 1) * kb, s_kv)
            if k0 > q1 - 1:
                break  # every later KV block is in the future of this block
            s = _scores(q_blk, k[:, k0:k1], dims)
            mask = _block_mask(q_pos, torch.arange(k0, k1, device=dev),
                               dims.window)
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            pv = torch.einsum("bhgqk,bkhd->bhgqd", p,
                              v[:, k0:k1].to(torch.float32))
            acc = acc * corr[..., None] + pv
            m = m_new
        o = acc / torch.clamp(l[..., None], min=1e-30)  # (B, Hkv, G, QB, hd)
        out[:, q0:q1] = o.permute(0, 3, 1, 2, 4).to(q.dtype)
        lse[..., q0:q1] = m + torch.log(torch.clamp(l, min=1e-30))
    return out, lse


def flash_backward(q, k, v, out, lse, dout, dims: AttnDims):
    """The reference's recompute-based flash backward (``_flash_bwd``),
    block by block: each score block is recomputed from q, k and the saved
    ``lse``, so memory stays O(block).  Shapes as :func:`flash_forward`'s;
    ``dout`` is (B, S, Hkv, G, hd).  Returns (dq (B, S, Hq, hd), dk, dv) in
    the inputs' dtypes, accumulated in float32 (dk and dv summed over the G
    query heads of each KV head)."""
    b, s_q, hq, hd = q.shape
    s_kv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    qb, kb = min(dims.q_block, s_q), min(dims.kv_block, s_kv)
    n_q, n_kv = -(-s_q // qb), -(-s_kv // kb)
    dev = q.device
    f32 = torch.float32
    qg = q.reshape(b, s_q, hkv, g, hd)
    dout = dout.to(f32)
    # D = rowsum(dout * out): (B, Hkv, G, S)
    dmat = torch.einsum("bshgd,bshgd->bhgs", dout, out.to(f32))
    dq = torch.zeros((b, s_q, hkv, g, hd), dtype=f32, device=dev)
    dk = torch.zeros((b, s_kv, hkv, hd), dtype=f32, device=dev)
    dv = torch.zeros((b, s_kv, hkv, hd), dtype=f32, device=dev)
    for iq in range(n_q):
        q0, q1 = iq * qb, min((iq + 1) * qb, s_q)
        q_blk, do_blk = qg[:, q0:q1], dout[:, q0:q1]
        lse_blk, d_blk = lse[..., q0:q1, None], dmat[..., q0:q1, None]
        q_pos = torch.arange(q0, q1, device=dev)
        for jk in range(n_kv):
            k0, k1 = jk * kb, min((jk + 1) * kb, s_kv)
            if k0 > q1 - 1:
                break  # wholly in the future: p = 0, no gradient
            k_blk, v_blk = k[:, k0:k1].to(f32), v[:, k0:k1].to(f32)
            masked = ~_block_mask(q_pos, torch.arange(k0, k1, device=dev),
                                  dims.window)
            # one score-block-sized buffer at a time where it can be: the
            # block ops below run in place (no autograd here)
            s = _scores(q_blk, k_blk, dims).masked_fill_(masked, NEG_INF)
            p = (s - lse_blk).exp_()  # (B, Hkv, G, QB, KB)
            if dims.softcap_val is None:
                del s
            dv[:, k0:k1] += torch.einsum("bhgqk,bqhgd->bkhd", p, do_blk)
            ds = torch.einsum("bqhgd,bkhd->bhgqk", do_blk, v_blk)  # dp
            ds.sub_(d_blk).mul_(p)
            del p
            if dims.softcap_val is not None:
                # d/ds_raw of c*tanh(s_raw/c) = 1 - (s_capped/c)^2, on a
                # mask-safe s (masked lanes have p = 0 but 0 * inf = nan)
                s.masked_fill_(masked, 0.0).div_(dims.softcap_val)
                ds.mul_(s.square_().neg_().add_(1.0))
                del s
            ds.mul_(dims.scale).masked_fill_(masked, 0.0)
            dq[:, q0:q1] += torch.einsum("bhgqk,bkhd->bqhgd", ds, k_blk)
            dk[:, k0:k1] += torch.einsum("bhgqk,bqhgd->bkhd", ds,
                                         q_blk.to(f32))
    return (dq.reshape(b, s_q, hq, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


class _FlashCore(torch.autograd.Function):
    """Flash attention with the reference's custom VJP: the forward saves
    only q, k, v, the output and the row log-sum-exps, and the backward
    recomputes each score block (``flash_backward``)."""

    @staticmethod
    def forward(ctx, q, k, v, dims):
        out, lse = flash_forward(q, k, v, dims)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.dims = dims
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_backward(q, k, v, out, lse, dout, ctx.dims)
        return dq, dk, dv, None


def flash_attention(q, k, v, dims: AttnDims):
    """Blocked causal attention, O(S * KB) memory, with a true flash
    (recompute-based) backward.  q: (B, S, Hq, hd); k, v: (B, S, Hkv, hd).
    Returns (B, S, Hq, hd)."""
    out = _FlashCore.apply(q, k, v, dims)
    return out.reshape(q.shape)


def banded_attention(q, k, v, dims: AttnDims):
    """Exact sliding-window attention with O(S * W) compute: each q block
    reads only the [q0 - W, q0 + QB) slice of K/V (front-padded by W) and
    takes a full-row softmax over it.  q: (B, S, Hq, hd); k, v: (B, S, Hkv,
    hd).  Returns (B, S, Hq, hd)."""
    b, s, hq, hd = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    w = dims.window
    qb = min(dims.q_block, s)
    n_q = -(-s // qb)
    pad_q = n_q * qb - s
    dev = q.device
    q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, pad_q))
    # front-pad K/V by W so every block's slice is in range
    k_p = torch.nn.functional.pad(k, (0, 0, 0, 0, w, pad_q))
    v_p = torch.nn.functional.pad(v, (0, 0, 0, 0, w, pad_q))
    span = w + qb
    qg = q.reshape(b, n_q, qb, hkv, g, hd)
    out = torch.empty((b, n_q * qb, hkv, g, hd), dtype=torch.float32,
                      device=dev)
    for iq in range(n_q):
        start = iq * qb  # q0 - W in front-padded coordinates
        k_blk = k_p[:, start:start + span]
        v_blk = v_p[:, start:start + span]
        sc = _scores(qg[:, iq], k_blk, dims)  # (B, Hkv, G, QB, span)
        q_pos = iq * qb + torch.arange(qb, device=dev)
        k_pos = iq * qb - w + torch.arange(span, device=dev)  # < 0: pad
        mask = ((q_pos[:, None] >= k_pos[None, :])
                & (q_pos[:, None] - k_pos[None, :] < w)
                & (k_pos >= 0)[None, :] & (k_pos < s)[None, :])
        sc = torch.where(mask, sc, NEG_INF)
        p = torch.softmax(sc, dim=-1)
        o = torch.einsum("bhgqk,bkhd->bhgqd", p, v_blk.to(torch.float32))
        out[:, start:start + qb] = o.permute(0, 3, 1, 2, 4)
    return out.reshape(b, n_q * qb, hq, hd)[:, :s].to(q.dtype)


def attended_kv(k, v, dims: AttnDims):
    """The K/V heads this rank's query heads attend to: all it holds, or,
    with replicated K/V, the one KV head of its query heads (B, S, 1, hd)."""
    if dims.kv_head is None:
        return k, v
    h = slice(dims.kv_head, dims.kv_head + 1)
    return k[:, :, h], v[:, :, h]


def prefill_attention(q, k, v, dims: AttnDims):
    """The full-sequence dispatch of the reference's ``attention_forward``:
    banded when the window is shorter than the sequence, otherwise flash
    with the window dropped (it would cover every causal pair)."""
    k, v = attended_kv(k, v, dims)
    if dims.window is not None and dims.window < q.shape[1]:
        return banded_attention(q, k, v, dims)
    return flash_attention(q, k, v, dims._replace(window=None))


# ---------------------------------------------------------------------------
# decode (one new token against a cache)
# ---------------------------------------------------------------------------


def init_kv_cache(batch: int, cache_len: int, n_kv: int, head_dim: int,
                  dtype, device):
    """Contiguous decode cache ``{"k","v"}`` (B, cache_len, Hkv, hd): a ring
    buffer for sliding windows, a plain append cache for global attention."""
    shape = (batch, cache_len, n_kv, head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


# paged decode: one new token against the block pool


def init_paged_kv_cache(batch: int, num_blocks: int, block_size: int,
                        max_blocks: int, n_kv: int, head_dim: int, dtype,
                        device):
    """Paged KV cache: pools ``pk``/``pv`` (num_blocks, block_size, Hkv, hd)
    plus a per-slot block table ``bt`` (batch, max_blocks).  Physical block 0
    is the GARBAGE block: never allocated, pointed to by unallocated table
    entries, and the target of inactive rows' writes."""
    shape = (num_blocks, block_size, n_kv, head_dim)
    return {
        "pk": torch.zeros(shape, dtype=dtype, device=device),
        "pv": torch.zeros(shape, dtype=dtype, device=device),
        "bt": torch.zeros((batch, max_blocks), dtype=torch.int32,
                          device=device),
    }


def _attend(q, k, v, valid, dims: AttnDims):
    """Single-token attention over a (B, Skv, Hkv, hd) K/V view with a
    (B, Skv) validity mask, as a full-row softmax; shared by the contiguous
    caches and the paged gather path.  Returns ctx (B, Hkv, G, hd) f32."""
    b = q.shape[0]
    k, v = attended_kv(k, v, dims)
    hq, hkv, hd = dims.n_heads, k.shape[2], dims.head_dim
    qg = q.reshape(b, hkv, hq // hkv, hd)
    s = torch.einsum("bhgd,bkhd->bhgk", qg.to(torch.float32),
                     k.to(torch.float32)) * dims.scale
    if dims.softcap_val is not None:
        s = dims.softcap_val * torch.tanh(s / dims.softcap_val)
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhgk,bkhd->bhgd", p, v.to(torch.float32))


def _decode_paged(q, k_new, v_new, cache, pos_b, dims: AttnDims, active):
    """Paged decode: the kernel (scatter + block walk in one launch) or the
    gather escape hatch (scatter, then a full-row softmax over
    ``pool[bt]``).  Paged caches are global-attention only, as in the
    reference."""
    if dims.window is not None:
        raise ValueError("paged KV caches are global-attention only")
    pk, pv, bt = cache["pk"], cache["pv"], cache["bt"]
    b = q.shape[0]
    hq, hkv, hd = dims.n_heads, dims.n_kv, dims.head_dim
    if dims.paged_kernel:
        if dims.kv_head is None:
            qk = q.reshape(b, hkv, hq // hkv, hd)
        else:
            # replicated pools: every KV head's row is written; the query
            # heads sit at their KV head, zeros (discarded) at the others
            qk = q.new_zeros((b, hkv, hq, hd))
            qk[:, dims.kv_head] = q.reshape(b, hq, hd)
        ctx, _, _ = paged_attention_decode(
            qk, k_new[:, 0], v_new[:, 0], pk, pv, bt, pos_b, active,
            scale=dims.scale, softcap=dims.softcap_val)
        if dims.kv_head is not None:
            ctx = ctx[:, dims.kv_head:dims.kv_head + 1]
        return ctx
    dest, off = write_routing(bt, pos_b, pk.shape[1], active)
    scatter_new_rows(pk, pv, k_new[:, 0], v_new[:, 0], dest, off)
    max_blocks, bs = bt.shape[1], pk.shape[1]
    s_kv = max_blocks * bs
    bt_l = bt.to(torch.int64)
    k = pk[bt_l].reshape(b, s_kv, hkv, hd)
    v = pv[bt_l].reshape(b, s_kv, hkv, hd)
    valid = torch.arange(s_kv, device=q.device)[None, :] <= pos_b[:, None]
    return _attend(q, k, v, valid, dims)


def _decode_contiguous(q, k_new, v_new, cache, pos_b, dims: AttnDims):
    """Contiguous decode: a ring buffer (slot ``pos % span``) for sliding
    windows, a plain append (clamped at the last slot) for global
    attention.  Every row writes its own slot (``active`` is a paged-pool
    notion: a retired slot's ring is rewritten whole at its next
    admission).  Once a ring has wrapped, every slot holds an in-window
    key."""
    k_c, v_c = cache["k"], cache["v"]
    b, s_kv = k_c.shape[:2]
    if dims.window is not None:
        slot = torch.remainder(pos_b, s_kv)
    else:
        slot = torch.clamp(pos_b, max=s_kv - 1)
    rows = torch.arange(b, device=q.device)
    k_c[rows, slot] = k_new[:, 0].to(k_c.dtype)
    v_c[rows, slot] = v_new[:, 0].to(v_c.dtype)
    idx = torch.arange(s_kv, device=q.device)
    valid = idx[None, :] <= pos_b[:, None]
    if dims.window is not None:
        valid = valid | (pos_b + 1 >= s_kv)[:, None]
    return _attend(q, k_c, v_c, valid, dims)


def attention_decode(params, x, cache, pos, dims: AttnDims,
                     imc: IMCConfig = DIGITAL, rng=None, active=None,
                     site_prefix: str = "attn"):
    """One token per slot against a cache: a paged ``{"pk","pv","bt"}``
    pool (global attention) or a contiguous ``{"k","v"}`` cache (a ring
    buffer when ``dims.window`` is set).

    ``x`` (B, 1, d); ``pos`` a scalar or (B,) tokens already cached per
    slot; ``active`` (B,) bool rows allowed to write to the pool (others
    write to the garbage block).  Returns ``(y (B, 1, d), cache)``; the
    cache is updated in place.
    """
    b = x.shape[0]
    pos_b = torch.as_tensor(pos, dtype=torch.int64, device=x.device)
    pos_b = pos_b.expand(b) if pos_b.dim() == 0 else pos_b
    q, k_new, v_new = _project_qkv(params, x, dims, pos_b[:, None], imc, rng,
                                   site_prefix)
    if "pk" in cache:
        ctx = _decode_paged(q, k_new, v_new, cache, pos_b, dims, active)
    else:
        ctx = _decode_contiguous(q, k_new, v_new, cache, pos_b, dims)
    ctx = ctx.reshape(b, 1, dims.n_heads * dims.head_dim).to(x.dtype)
    y = linear(params["wo"], ctx, imc, rng, site=f"{site_prefix}.wo",
               split="row")
    return y, cache
