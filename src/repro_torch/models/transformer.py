"""Block assembly: pattern-cycled decoder layers.

Layers are grouped by the config's block ``pattern`` (gemma2 = ("local",
"attn"), recurrentgemma = ("rglru", "rglru", "local"), mamba2 = ("ssm",)).
Parameters of each pattern position are stacked along a leading layer axis
(``n_full_cycles``), as in the JAX reference; the remainder layers
(``n_layers % len(pattern)``, ``cfg.tail_kinds``) are applied unstacked
after them.  The PyTorch forward walks the layers in a Python loop over
views of the stacked tensors.

Block kinds: global (``"attn"``) and sliding-window (``"local"``) attention,
the Mamba-2 SSD mixer (``"ssm"``, no MLP half) and the RG-LRU recurrent block
(``"rglru"``); the MLP half is dense or a mixture of experts
(``cfg.n_experts > 0``).

Two paths share the block code:
  full     a whole sequence (forward / prefill), optionally returning the
           block's decode cache (a ring for local blocks, the final state
           and last conv inputs for recurrent ones);
  decode   one token per slot against the block's cache: a paged KV pool
           for global blocks in the engine, a contiguous cache (ring for
           local blocks, fixed-size state for recurrent ones) otherwise.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import parallel
from repro_torch.core.imc_linear import linear
from repro_torch.models import attention as attn_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import rglru as rg_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.layers import apply_mlp, apply_norm, init_mlp, init_norm

ATTN_KINDS = ("attn", "local")
KINDS = ATTN_KINDS + ("ssm", "rglru")


def check_kind(kind: str):
    if kind not in KINDS:
        raise ValueError(f"unknown block kind {kind!r}")


def attn_dims(cfg: ArchConfig, kind: str) -> attn_lib.AttnDims:
    """The attention geometry of a block; under an active shard group
    (``core.parallel``) this rank's: its query heads, and the KV heads it
    holds (its share, or all of them when they are replicated)."""
    hd = cfg.resolved_head_dim
    n_heads, n_kv, kv_head = cfg.n_heads, cfg.n_kv_heads, None
    tp = parallel.active()
    if tp is not None:
        n_heads = cfg.n_heads // tp.size
        if tp.kv_shard:
            n_kv = cfg.n_kv_heads // tp.size
        else:
            g = cfg.n_heads // cfg.n_kv_heads
            if g % n_heads:
                raise ValueError(
                    f"{n_heads} query heads per rank straddle the "
                    f"{cfg.n_kv_heads} replicated KV heads (groups of {g})")
            kv_head = tp.rank * n_heads // g
    return attn_lib.AttnDims(
        n_heads=n_heads,
        n_kv=n_kv,
        head_dim=hd,
        scale=cfg.attn_logit_scale or hd**-0.5,
        softcap_val=cfg.attn_softcap,
        window=cfg.window if kind == "local" else None,
        q_block=cfg.flash_q_block,
        kv_block=cfg.flash_kv_block,
        rope_theta=cfg.rope_theta,
        use_rope=cfg.pos_kind == "rope",
        paged_kernel=cfg.decode_attn != "gather",
        kv_head=kv_head,
    )


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def init_block_parts(gen, cfg: ArchConfig, kind: str, dtype, device):
    """One block's parameters as (path, subtree) pairs in draw order: whole
    modules, except that an MoE half comes one expert stack at a time.
    ``models.model.init_params`` copies each part into its stacked leaves
    before the next one is drawn, which bounds init's transient memory."""
    check_kind(kind)
    d = cfg.d_model
    yield ("norm1",), init_norm(cfg.norm_kind, d, dtype, device)
    if cfg.post_norm:
        yield ("norm1_post",), init_norm(cfg.norm_kind, d, dtype, device)
    if kind in ATTN_KINDS:
        yield ("mixer",), attn_lib.init_attention(
            gen, d, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim,
            dtype, device)
    elif kind == "ssm":
        yield ("mixer",), ssm_lib.init_ssm(
            gen, d, cfg.ssm_expand, cfg.ssm_head_dim, cfg.ssm_groups,
            cfg.ssm_state, cfg.conv_width, dtype, device)
        return  # mamba2 blocks have no separate MLP
    else:
        yield ("mixer",), rg_lib.init_rglru(gen, d, cfg.rnn_width,
                                            cfg.rnn_conv_width, dtype, device)
    yield ("norm2",), init_norm(cfg.norm_kind, d, dtype, device)
    if cfg.post_norm:
        yield ("norm2_post",), init_norm(cfg.norm_kind, d, dtype, device)
    if cfg.n_experts > 0:
        yield from moe_lib.init_moe_parts(gen, d, cfg.d_ff, cfg.n_experts,
                                          cfg.mlp_kind, dtype, device,
                                          prefix=("moe",))
    else:
        yield ("mlp",), init_mlp(gen, d, cfg.d_ff, cfg.mlp_kind, dtype,
                                 device)


def put(tree: Dict[str, Any], path, value):
    """Set ``tree[path[0]][path[1]]... = value``, making the dicts on the
    way."""
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def init_block(gen, cfg: ArchConfig, kind: str, dtype, device):
    p: Dict[str, Any] = {}
    for path, sub in init_block_parts(gen, cfg, kind, dtype, device):
        put(p, path, sub)
    return p


def cache_span(cfg: ArchConfig, kind: str, cache_len: int) -> int:
    """Rows of an attention block's contiguous cache: the window for a
    local block (its ring), ``cache_len`` for a global one."""
    return min(cfg.window, cache_len) if kind == "local" else cache_len


def init_block_cache(cfg: ArchConfig, kind: str, batch: int, cache_len: int,
                     dtype, device):
    """A block's contiguous decode cache: K/V (a ring for local blocks) or
    a recurrent block's fixed-size state."""
    check_kind(kind)
    if kind == "ssm":
        return ssm_lib.init_ssm_cache(batch, cfg, dtype, device)
    if kind == "rglru":
        return rg_lib.init_rglru_cache(batch, cfg.rnn_width,
                                       cfg.rnn_conv_width, dtype, device)
    return attn_lib.init_kv_cache(batch, cache_span(cfg, kind, cache_len),
                                  attn_dims(cfg, kind).n_kv,
                                  cfg.resolved_head_dim, dtype, device)


def init_block_cache_paged(cfg: ArchConfig, kind: str, batch: int,
                           cache_len: int, dtype, num_blocks: int,
                           block_size: int, device):
    """Paged variant: a global block's KV becomes a block pool and block
    table; local rings (bounded at the window) and recurrent states (fixed
    size per slot) keep their contiguous layout."""
    if kind != "attn":
        return init_block_cache(cfg, kind, batch, cache_len, dtype, device)
    max_blocks = -(-cache_len // block_size)
    return attn_lib.init_paged_kv_cache(batch, num_blocks, block_size,
                                        max_blocks, attn_dims(cfg, kind).n_kv,
                                        cfg.resolved_head_dim, dtype, device)


# ---------------------------------------------------------------------------
# apply
# ---------------------------------------------------------------------------


def _mlp_half(p, x, cfg: ArchConfig, rng):
    """Returns (x + MLP(norm(x)), MoE aux loss)."""
    h = apply_norm(p["norm2"], x, cfg.norm_kind)
    if cfg.n_experts > 0:
        out, aux = moe_lib.apply_moe(
            p["moe"], h, cfg.n_experts, cfg.top_k, cfg.capacity_factor,
            cfg.moe_group_size, cfg.mlp_kind, cfg.imc, rng)
    else:
        out, aux = apply_mlp(p["mlp"], h, cfg.mlp_kind, cfg.imc, rng), 0.0
    if cfg.post_norm:
        out = apply_norm(p["norm2_post"], out, cfg.norm_kind)
    return x + out, aux


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


def _pack_ssm_cache(p, h_in, state, cfg: ArchConfig, dtype):
    """SSD decode cache from prefill: the final state and the last conv
    inputs, projected again without noise (as the reference does; a prompt
    shorter than ``conv_width - 1`` leaves fewer rows, which the engine's
    insert right-pads)."""
    proj = linear(p["mixer"]["in_proj"], h_in[:, -(cfg.conv_width - 1):],
                  cfg.imc, site="ssm.in_proj")
    d_inner = cfg.ssm_expand * cfg.d_model
    gn = cfg.ssm_groups * cfg.ssm_state
    xbc = proj[..., d_inner: 2 * d_inner + 2 * gn]
    return {"conv": xbc.to(dtype), "state": state}


def _pack_rglru_cache(p, h_in, h_last, cfg: ArchConfig, dtype):
    xb = linear(p["mixer"]["rg_x"], h_in[:, -(cfg.rnn_conv_width - 1):],
                cfg.imc, site="rg.x")
    return {"conv": xb.to(dtype), "h": h_last}


def _exact_only(kind: str, true_len):
    if true_len is not None:
        # recurrent state would integrate the pad garbage: serve engines use
        # exact-length prefill for recurrent patterns
        raise ValueError(f"bucketed (padded) prefill is not supported for "
                         f"{kind} blocks")


def apply_block_full(p, x, cfg: ArchConfig, kind: str, positions, rng,
                     want_cache: bool, cache_len: int, true_len=None):
    """Full-sequence block. Returns (x, cache_or_None, MoE aux)."""
    check_kind(kind)
    h = apply_norm(p["norm1"], x, cfg.norm_kind)
    cache = None
    if kind in ATTN_KINDS:
        dims = attn_dims(cfg, kind)
        q, k, v = attn_lib._project_qkv(p["mixer"], h, dims, positions,
                                        cfg.imc, rng, site_prefix=kind)
        ctx = attn_lib.prefill_attention(q, k, v, dims)
        b, s = h.shape[:2]
        ctx = ctx.reshape(b, s, dims.n_heads * dims.head_dim)
        out = attn_lib.linear(p["mixer"]["wo"], ctx, cfg.imc, rng,
                              site=f"{kind}.wo", split="row")
        if want_cache:
            cache = _pack_kv_cache(k, v, cache_len, dims.window, x.dtype,
                                   true_len)
    elif kind == "ssm":
        out, state = ssm_lib.ssm_forward(p["mixer"], h, cfg, cfg.imc, rng)
        if want_cache:
            _exact_only(kind, true_len)
            cache = _pack_ssm_cache(p, h, state, cfg, x.dtype)
        if cfg.post_norm:
            out = apply_norm(p["norm1_post"], out, cfg.norm_kind)
        return x + out, cache, 0.0  # mamba2: no MLP half
    else:
        out, h_last = rg_lib.rglru_forward(p["mixer"], h, cfg, cfg.imc, rng)
        if want_cache:
            _exact_only(kind, true_len)
            cache = _pack_rglru_cache(p, h, h_last, cfg, x.dtype)
    if cfg.post_norm:
        out = apply_norm(p["norm1_post"], out, cfg.norm_kind)
    x, aux = _mlp_half(p, x + out, cfg, rng)
    return x, cache, aux


def apply_block_decode(p, x, cfg: ArchConfig, kind: str, cache, pos, rng,
                       active: Optional[torch.Tensor] = None):
    """One-token block against its cache (updated in place). Returns
    (x, cache)."""
    check_kind(kind)
    h = apply_norm(p["norm1"], x, cfg.norm_kind)
    if kind in ATTN_KINDS:
        dims = attn_dims(cfg, kind)
        out, cache = attn_lib.attention_decode(p["mixer"], h, cache, pos,
                                               dims, cfg.imc, rng,
                                               active=active,
                                               site_prefix=kind)
    elif kind == "ssm":
        out, cache = ssm_lib.ssm_decode(p["mixer"], h, cache, cfg, cfg.imc,
                                        rng)
        if cfg.post_norm:
            out = apply_norm(p["norm1_post"], out, cfg.norm_kind)
        return x + out, cache
    else:
        out, cache = rg_lib.rglru_decode(p["mixer"], h, cache, cfg, cfg.imc,
                                         rng)
    if cfg.post_norm:
        out = apply_norm(p["norm1_post"], out, cfg.norm_kind)
    x, _ = _mlp_half(p, x + out, cfg, rng)
    return x, cache
