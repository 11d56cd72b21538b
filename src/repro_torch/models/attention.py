"""GQA/MQA/MHA attention: blocked causal prefill attention (the online-softmax
math of the reference's ``_flash_fwd_impl``, in plain PyTorch ops) and
single-token decode over a paged KV block pool.

Paged decode takes the paged-attention kernel by default
(``AttnDims.paged_kernel``, from ``cfg.decode_attn="kernel"``: CUDA on the
card, its plain walk on the CPU) or the gather escape hatch
(``decode_attn="gather"``) that materializes ``pool[bt]`` and runs a full-row
softmax.  Both follow the garbage-block-0 write routing.  The pools are
updated IN PLACE (a per-step copy of a multi-GB pool would dominate decode).
Sliding windows, the contiguous decode cache and the flash backward wait for
later slices.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core.imc_linear import DIGITAL, IMCConfig, linear
from repro_torch.kernels.paged_attention import (
    paged_attention_decode,
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


def _project_qkv(params, x, dims: AttnDims, positions, imc, rng,
                 site_prefix: str = "attn"):
    b, s, _ = x.shape
    q = linear(params["wq"], x, imc, rng, site=f"{site_prefix}.wq").reshape(
        b, s, dims.n_heads, dims.head_dim)
    k = linear(params["wk"], x, imc, rng, site=f"{site_prefix}.wk").reshape(
        b, s, dims.n_kv, dims.head_dim)
    v = linear(params["wv"], x, imc, rng, site=f"{site_prefix}.wv").reshape(
        b, s, dims.n_kv, dims.head_dim)
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


def flash_attention(q, k, v, dims: AttnDims):
    """Blocked causal attention with an online softmax over KV blocks.

    q: (B, S, Hq, hd); k, v: (B, S, Hkv, hd).  Returns (B, S, Hq, hd).  KV
    blocks wholly in a q block's future are skipped: they would add p = 0
    and a correction of 1, so the result is unchanged.
    """
    if dims.window is not None:
        raise NotImplementedError("sliding-window attention is not ported "
                                  "yet (ROADMAP)")
    b, s_q, hq, hd = q.shape
    s_kv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    qb, kb = min(dims.q_block, s_q), min(dims.kv_block, s_kv)
    n_q, n_kv = -(-s_q // qb), -(-s_kv // kb)
    dev = q.device
    qg = q.reshape(b, s_q, hkv, g, hd)
    out = torch.empty((b, s_q, hkv, g, hd), dtype=q.dtype, device=dev)
    for iq in range(n_q):
        q0, q1 = iq * qb, min((iq + 1) * qb, s_q)
        q_blk = qg[:, q0:q1]
        nq = q1 - q0
        q_pos = torch.arange(q0, q0 + qb, device=dev)[:nq]
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
            k_pos = torch.arange(k0, k1, device=dev)
            mask = q_pos[:, None] >= k_pos[None, :]
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
    return out.reshape(b, s_q, hq, hd)


# ---------------------------------------------------------------------------
# paged decode (one new token against the block pool)
# ---------------------------------------------------------------------------


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


def _gather_attend(q, pk, pv, bt, pos_b, dims: AttnDims):
    """Full-row softmax over the gathered ``pool[bt]`` view (escape hatch)."""
    b, max_blocks = bt.shape
    bs = pk.shape[1]
    hq, hkv, hd = dims.n_heads, dims.n_kv, dims.head_dim
    s_kv = max_blocks * bs
    bt_l = bt.to(torch.int64)
    k = pk[bt_l].reshape(b, s_kv, hkv, hd)
    v = pv[bt_l].reshape(b, s_kv, hkv, hd)
    qg = q.reshape(b, hkv, hq // hkv, hd)
    s = torch.einsum("bhgd,bkhd->bhgk", qg.to(torch.float32),
                     k.to(torch.float32)) * dims.scale
    if dims.softcap_val is not None:
        s = dims.softcap_val * torch.tanh(s / dims.softcap_val)
    valid = torch.arange(s_kv, device=q.device)[None, :] <= pos_b[:, None]
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhgk,bkhd->bhgd", p, v.to(torch.float32))


def attention_decode(params, x, cache, pos, dims: AttnDims,
                     imc: IMCConfig = DIGITAL, rng=None, active=None,
                     site_prefix: str = "attn"):
    """One token per slot against a paged ``{"pk","pv","bt"}`` cache.

    ``x`` (B, 1, d); ``pos`` a scalar or (B,) tokens already cached per
    slot; ``active`` (B,) bool rows allowed to write (others write to the
    garbage block).  Returns ``(y (B, 1, d), cache)``; the pools in ``cache``
    are updated in place.
    """
    if "pk" not in cache:
        raise NotImplementedError("only the paged KV cache is ported; the "
                                  "contiguous decode cache waits (ROADMAP)")
    if dims.window is not None:
        raise NotImplementedError("paged KV caches are global-attention only")
    b = x.shape[0]
    pos_b = torch.as_tensor(pos, dtype=torch.int64, device=x.device)
    pos_b = pos_b.expand(b) if pos_b.dim() == 0 else pos_b
    q, k_new, v_new = _project_qkv(params, x, dims, pos_b[:, None], imc, rng,
                                   site_prefix)
    pk, pv, bt = cache["pk"], cache["pv"], cache["bt"]
    hq, hkv, hd = dims.n_heads, dims.n_kv, dims.head_dim
    if dims.paged_kernel:
        qg = q.reshape(b, hkv, hq // hkv, hd)
        ctx, _, _ = paged_attention_decode(
            qg, k_new[:, 0], v_new[:, 0], pk, pv, bt, pos_b, active,
            scale=dims.scale, softcap=dims.softcap_val)
    else:
        dest, off = write_routing(bt, pos_b, pk.shape[1], active)
        pk[dest, off] = k_new[:, 0].to(pk.dtype)
        pv[dest, off] = v_new[:, 0].to(pv.dtype)
        ctx = _gather_attend(q, pk, pv, bt, pos_b, dims)
    ctx = ctx.reshape(b, 1, hq * hd).to(x.dtype)
    y = linear(params["wo"], ctx, imc, rng, site=f"{site_prefix}.wo")
    return y, cache
