"""Block assembly for attention-only decoders.

Parameters of each pattern position are stacked along a leading layer axis
(``n_full_cycles``), as in the JAX reference; the PyTorch forward walks the
layers cycle by cycle in a Python loop over views of the stacked tensors.
Global (``"attn"``) and sliding-window (``"local"``) attention blocks are
ported; SSM and RG-LRU blocks and MoE MLPs wait for later slices.

Two paths share the block code:
  full     a whole sequence (forward / prefill), optionally returning the
           block's K/V for the decode cache (a ring for local blocks);
  decode   one token per slot against the block's cache: a paged KV pool
           for global blocks in the engine, a contiguous cache (ring for
           local blocks) otherwise.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models.layers import apply_mlp, apply_norm, init_mlp, init_norm

ATTN_KINDS = ("attn", "local")


def check_kind(cfg: ArchConfig, kind: str):
    if kind not in ATTN_KINDS:
        raise NotImplementedError(
            f"block kind {kind!r} is not ported yet (ROADMAP)")
    if cfg.n_experts > 0:
        raise NotImplementedError("MoE blocks are not ported yet (ROADMAP)")


def attn_dims(cfg: ArchConfig, kind: str) -> attn_lib.AttnDims:
    hd = cfg.resolved_head_dim
    return attn_lib.AttnDims(
        n_heads=cfg.n_heads,
        n_kv=cfg.n_kv_heads,
        head_dim=hd,
        scale=cfg.attn_logit_scale or hd**-0.5,
        softcap_val=cfg.attn_softcap,
        window=cfg.window if kind == "local" else None,
        q_block=cfg.flash_q_block,
        kv_block=cfg.flash_kv_block,
        rope_theta=cfg.rope_theta,
        use_rope=cfg.pos_kind == "rope",
        paged_kernel=cfg.decode_attn != "gather",
    )


def init_block(gen, cfg: ArchConfig, kind: str, dtype, device):
    check_kind(cfg, kind)
    d = cfg.d_model
    p: Dict[str, Any] = {"norm1": init_norm(cfg.norm_kind, d, dtype, device)}
    if cfg.post_norm:
        p["norm1_post"] = init_norm(cfg.norm_kind, d, dtype, device)
    p["mixer"] = attn_lib.init_attention(gen, d, cfg.n_heads, cfg.n_kv_heads,
                                         cfg.resolved_head_dim, dtype, device)
    p["norm2"] = init_norm(cfg.norm_kind, d, dtype, device)
    if cfg.post_norm:
        p["norm2_post"] = init_norm(cfg.norm_kind, d, dtype, device)
    p["mlp"] = init_mlp(gen, d, cfg.d_ff, cfg.mlp_kind, dtype, device)
    return p


def cache_span(cfg: ArchConfig, kind: str, cache_len: int) -> int:
    """Rows of a block's contiguous cache: the window for a local block
    (its ring), ``cache_len`` for a global one."""
    return min(cfg.window, cache_len) if kind == "local" else cache_len


def init_block_cache(cfg: ArchConfig, kind: str, batch: int, cache_len: int,
                     dtype, device):
    """A block's contiguous decode cache (a ring for local blocks)."""
    check_kind(cfg, kind)
    return attn_lib.init_kv_cache(batch, cache_span(cfg, kind, cache_len),
                                  cfg.n_kv_heads, cfg.resolved_head_dim,
                                  dtype, device)


def init_block_cache_paged(cfg: ArchConfig, kind: str, batch: int,
                           cache_len: int, dtype, num_blocks: int,
                           block_size: int, device):
    """Paged variant: a global block's KV becomes a block pool and block
    table; a local block keeps its contiguous ring (already bounded at the
    window)."""
    check_kind(cfg, kind)
    if kind == "local":
        return init_block_cache(cfg, kind, batch, cache_len, dtype, device)
    max_blocks = -(-cache_len // block_size)
    return attn_lib.init_paged_kv_cache(batch, num_blocks, block_size,
                                        max_blocks, cfg.n_kv_heads,
                                        cfg.resolved_head_dim, dtype, device)


def _mlp_half(p, x, cfg: ArchConfig, rng):
    h = apply_norm(p["norm2"], x, cfg.norm_kind)
    out = apply_mlp(p["mlp"], h, cfg.mlp_kind, cfg.imc, rng)
    if cfg.post_norm:
        out = apply_norm(p["norm2_post"], out, cfg.norm_kind)
    return x + out


def _pack_kv_cache(k, v, cache_len: int, window: Optional[int], dtype,
                   true_len=None):
    """Prefill K/V in the decode-cache layout.

    Global blocks: the linear layout right-padded to ``cache_len``; rows past
    a prompt's true length hold pad garbage that decode masks, then
    overwrites.  Local blocks: the ring of ``w = min(window, cache_len)``
    rows, position p at slot ``p % w``.  With ``true_len`` (bucketed
    prefill) each row's ring is packed from ITS true tail ``[true_len - w,
    true_len)``, or the pad tail would clobber live in-window positions."""
    b, s = k.shape[:2]
    if window is None:
        pad = cache_len - s
        if pad < 0:
            raise ValueError(f"cache_len {cache_len} < sequence {s}")
        pads = (0, 0, 0, 0, 0, pad)
        return {"k": torch.nn.functional.pad(k, pads).to(dtype),
                "v": torch.nn.functional.pad(v, pads).to(dtype)}
    w = min(window, cache_len)
    if s < w:  # slot j = position j for every row, padded or not
        pads = (0, 0, 0, 0, 0, w - s)
        return {"k": torch.nn.functional.pad(k, pads).to(dtype),
                "v": torch.nn.functional.pad(v, pads).to(dtype)}
    if true_len is None:
        start = torch.full((b,), s - w, dtype=torch.int64, device=k.device)
    else:
        tl = torch.as_tensor(true_len, dtype=torch.int64, device=k.device)
        start = torch.clamp(tl - w, 0, s - w)
    # element j of the ring holds position start + j, whose slot is
    # (start + j) % w: gather the source position of every slot instead
    slots = torch.arange(w, device=k.device)
    src = start[:, None] + torch.remainder(slots[None, :] - start[:, None], w)
    rows = torch.arange(b, device=k.device)[:, None]
    return {"k": k[rows, src].to(dtype), "v": v[rows, src].to(dtype)}


def apply_block_full(p, x, cfg: ArchConfig, kind: str, positions, rng,
                     want_cache: bool, cache_len: int, true_len=None):
    """Full-sequence block. Returns (x, cache_or_None)."""
    check_kind(cfg, kind)
    h = apply_norm(p["norm1"], x, cfg.norm_kind)
    dims = attn_dims(cfg, kind)
    q, k, v = attn_lib._project_qkv(p["mixer"], h, dims, positions, cfg.imc,
                                    rng, site_prefix=kind)
    ctx = attn_lib.prefill_attention(q, k, v, dims)
    b, s = h.shape[:2]
    ctx = ctx.reshape(b, s, dims.n_heads * dims.head_dim)
    out = attn_lib.linear(p["mixer"]["wo"], ctx, cfg.imc, rng,
                          site=f"{kind}.wo")
    cache = (_pack_kv_cache(k, v, cache_len, dims.window, x.dtype, true_len)
             if want_cache else None)
    if cfg.post_norm:
        out = apply_norm(p["norm1_post"], out, cfg.norm_kind)
    x = x + out
    return _mlp_half(p, x, cfg, rng), cache


def apply_block_decode(p, x, cfg: ArchConfig, kind: str, cache, pos, rng,
                       active: Optional[torch.Tensor] = None):
    """One-token block against its cache. Returns (x, cache)."""
    check_kind(cfg, kind)
    h = apply_norm(p["norm1"], x, cfg.norm_kind)
    dims = attn_dims(cfg, kind)
    out, cache = attn_lib.attention_decode(p["mixer"], h, cache, pos, dims,
                                           cfg.imc, rng, active=active,
                                           site_prefix=kind)
    if cfg.post_norm:
        out = apply_norm(p["norm1_post"], out, cfg.norm_kind)
    x = x + out
    return _mlp_half(p, x, cfg, rng), cache
