"""Block assembly for attention-only decoders.

Parameters of each pattern position are stacked along a leading layer axis
(``n_full_cycles``), as in the JAX reference; the PyTorch forward walks the
layers in a Python loop over views of the stacked tensors.  Only global
attention blocks (``"attn"``) are ported: sliding-window, SSM and RG-LRU
blocks and MoE MLPs wait for later slices.

Two paths share the block code:
  full     a whole sequence (forward / prefill), optionally returning the
           block's K/V for the decode cache;
  decode   one token per slot against the paged KV cache.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models.layers import apply_mlp, apply_norm, init_mlp, init_norm


def _check_kind(cfg: ArchConfig, kind: str):
    if kind != "attn":
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
    _check_kind(cfg, kind)
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


def init_block_cache_paged(cfg: ArchConfig, kind: str, batch: int,
                           cache_len: int, dtype, num_blocks: int,
                           block_size: int, device):
    """A global-attention block's paged KV pool and block table."""
    _check_kind(cfg, kind)
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


def _pack_kv_cache(k, v, cache_len: int, dtype):
    """Prefill K/V in the linear decode-cache layout (global attention):
    right-padded to ``cache_len``.  Rows past a prompt's true length hold pad
    garbage that decode masks, then overwrites."""
    pad = cache_len - k.shape[1]
    if pad < 0:
        raise ValueError(f"cache_len {cache_len} < sequence {k.shape[1]}")
    pads = (0, 0, 0, 0, 0, pad)
    return {"k": torch.nn.functional.pad(k, pads).to(dtype),
            "v": torch.nn.functional.pad(v, pads).to(dtype)}


def apply_block_full(p, x, cfg: ArchConfig, kind: str, positions, rng,
                     want_cache: bool, cache_len: int):
    """Full-sequence block. Returns (x, cache_or_None)."""
    _check_kind(cfg, kind)
    h = apply_norm(p["norm1"], x, cfg.norm_kind)
    dims = attn_dims(cfg, kind)
    q, k, v = attn_lib._project_qkv(p["mixer"], h, dims, positions, cfg.imc,
                                    rng, site_prefix=kind)
    ctx = attn_lib.flash_attention(q, k, v, dims)
    b, s = h.shape[:2]
    ctx = ctx.reshape(b, s, dims.n_heads * dims.head_dim)
    out = attn_lib.linear(p["mixer"]["wo"], ctx, cfg.imc, rng,
                          site=f"{kind}.wo")
    cache = _pack_kv_cache(k, v, cache_len, x.dtype) if want_cache else None
    if cfg.post_norm:
        out = apply_norm(p["norm1_post"], out, cfg.norm_kind)
    x = x + out
    return _mlp_half(p, x, cfg, rng), cache


def apply_block_decode(p, x, cfg: ArchConfig, kind: str, cache, pos, rng,
                       active: Optional[torch.Tensor] = None):
    """One-token block against the paged cache. Returns (x, cache)."""
    _check_kind(cfg, kind)
    h = apply_norm(p["norm1"], x, cfg.norm_kind)
    dims = attn_dims(cfg, kind)
    out, cache = attn_lib.attention_decode(p["mixer"], h, cache, pos, dims,
                                           cfg.imc, rng, active=active,
                                           site_prefix=kind)
    if cfg.post_norm:
        out = apply_norm(p["norm1_post"], out, cfg.norm_kind)
    x = x + out
    return _mlp_half(p, x, cfg, rng), cache
