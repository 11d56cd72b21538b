"""Top-level LM: init, forward, prefill and paged decode.

Parameters mirror the JAX reference's tree: each pattern position's blocks
are stacked along a leading layer axis under ``params["blocks"]["p{i}"]``
(``convert.py`` carries a JAX tree across leaf for leaf).  Caches mirror it
too.  Entry points take an explicit ``device``; ``None`` means the card, and
raises where there is none.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.imc_linear import layer_rng, linear
from repro_torch.models import transformer as tf
from repro_torch.models.layers import (
    apply_norm,
    dtype_of,
    embed_init,
    init_norm,
    sinusoidal_positions,
    softcap,
)


def resolve_device(device=None) -> torch.device:
    """``device`` as a torch.device; None means the card, and raises when
    PyTorch sees no CUDA device (never a silent fall back to the CPU)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' explicitly "
                               "to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def layer_params(stacked, li: int):
    """Layer ``li``'s view of a stacked parameter (or cache) subtree."""
    return tree_map(lambda t: t[li], stacked)


def _check_arch(cfg: ArchConfig):
    if cfg.tail_kinds or any(k != "attn" for k in cfg.pattern):
        raise NotImplementedError(
            f"pattern {cfg.pattern} is not ported yet (ROADMAP)")
    if cfg.modality == "vlm" or cfg.pos_kind == "learned":
        raise NotImplementedError("vlm prefixes and learned positions are "
                                  "not ported yet (ROADMAP)")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def init_params(cfg: ArchConfig, seed: int = 0, device=None) -> Dict[str, Any]:
    """Random parameters from a ``torch.Generator`` seeded with ``seed``, in
    the reference's layout and scales (not its values: JAX's streams are not
    reproducible in PyTorch; use ``convert.params_from_jax`` for those)."""
    _check_arch(cfg)
    device = resolve_device(device)
    dtype = dtype_of(cfg.dtype)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    params: Dict[str, Any] = {
        "embed": embed_init(gen, cfg.padded_vocab, cfg.d_model, dtype, device),
        "final_norm": init_norm(cfg.norm_kind, cfg.d_model, dtype, device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = (torch.randn(
            (cfg.d_model, cfg.padded_vocab), generator=gen, device=device)
            * 0.02).to(dtype)
    blocks = {}
    for pi, kind in enumerate(cfg.pattern):
        layers = [tf.init_block(gen, cfg, kind, dtype, device)
                  for _ in range(cfg.n_full_cycles)]
        blocks[f"p{pi}"] = _stack(layers)
    params["blocks"] = blocks
    return params


def _stack(layers):
    first = layers[0]
    if isinstance(first, dict):
        return {k: _stack([lay[k] for lay in layers]) for k in first}
    return torch.stack(layers)


def init_paged_cache(cfg: ArchConfig, batch: int, cache_len: int,
                     num_blocks: int, block_size: int, device=None):
    """Paged decode cache: per pattern position, pools stacked over layers
    ``(L, num_blocks, block_size, Hkv, hd)`` and block tables
    ``(L, batch, max_blocks)`` (identical contents across layers)."""
    _check_arch(cfg)
    device = resolve_device(device)
    dtype = dtype_of(cfg.dtype)
    n_full = cfg.n_full_cycles
    cache: Dict[str, Any] = {"blocks": {},
                             "pos": torch.zeros((), dtype=torch.int64,
                                                device=device)}
    for pi, kind in enumerate(cfg.pattern):
        one = tf.init_block_cache_paged(cfg, kind, batch, cache_len, dtype,
                                        num_blocks, block_size, device)
        cache["blocks"][f"p{pi}"] = tree_map(
            lambda t: t[None].repeat((n_full,) + (1,) * t.dim()), one)
    return cache


# ---------------------------------------------------------------------------
# embedding / head
# ---------------------------------------------------------------------------


def _embed_inputs(params, cfg: ArchConfig, tokens, positions):
    x = params["embed"][tokens]  # (B, S, d)
    if cfg.emb_scale:
        x = x * torch.tensor(cfg.d_model**0.5, dtype=x.dtype)
    if cfg.pos_kind == "sinusoidal":
        x = x + sinusoidal_positions(positions, cfg.d_model).to(x.dtype)
    return x


def _head(params, cfg: ArchConfig, x):
    x = apply_norm(params["final_norm"], x, cfg.norm_kind)
    if cfg.tie_embeddings:
        logits = torch.einsum("...d,vd->...v", x, params["embed"])
    else:
        logits = linear(params["lm_head"], x, cfg.imc, site="lm_head")
    logits = softcap(logits.to(torch.float32), cfg.final_softcap)
    if cfg.padded_vocab != cfg.vocab_size:
        pad = torch.arange(cfg.padded_vocab, device=x.device) >= cfg.vocab_size
        logits = torch.where(pad, -1e9, logits)
    return logits


# ---------------------------------------------------------------------------
# full sequence: forward / prefill
# ---------------------------------------------------------------------------


def _run_full(params, cfg: ArchConfig, x, positions, rng, want_cache: bool,
              cache_len: int):
    caches = {}
    for pi, kind in enumerate(cfg.pattern):
        stacked = params["blocks"][f"p{pi}"]
        ks, vs = [], []
        for li in range(cfg.n_full_cycles):
            r = layer_rng(layer_rng(rng, pi), li)
            x, c = tf.apply_block_full(layer_params(stacked, li), x, cfg,
                                       kind, positions, r, want_cache,
                                       cache_len)
            if want_cache:
                ks.append(c["k"])
                vs.append(c["v"])
        if want_cache:
            caches[f"p{pi}"] = {"k": torch.stack(ks), "v": torch.stack(vs)}
    return x, caches


def forward(params, cfg: ArchConfig, tokens, rng: Optional[int] = None):
    """Full-sequence logits (B, S, V) and the (zero) MoE aux loss."""
    _check_arch(cfg)
    b, s = tokens.shape
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    x = _embed_inputs(params, cfg, tokens, positions)
    x, _ = _run_full(params, cfg, x, positions, rng, False, 0)
    return _head(params, cfg, x), 0.0


def prefill(params, cfg: ArchConfig, tokens, cache_len: int,
            rng: Optional[int] = None, true_len=None):
    """Process a prompt batch; returns (last-position logits (B, 1, V),
    cache).  With ``true_len`` (B,) the prompts are right-padded to S: logits
    are taken at each row's true last position and ``cache["pos"]`` is
    ``true_len``.  The cache holds each layer's K/V in the linear layout
    ``(L, B, cache_len, Hkv, hd)``."""
    _check_arch(cfg)
    b, s = tokens.shape
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    x = _embed_inputs(params, cfg, tokens, positions)
    x, caches = _run_full(params, cfg, x, positions, rng, True, cache_len)
    if true_len is None:
        x_last = x[:, -1:]
        pos = torch.tensor(s, dtype=torch.int64, device=tokens.device)
    else:
        pos = torch.as_tensor(true_len, dtype=torch.int64,
                              device=tokens.device)
        x_last = x[torch.arange(b, device=tokens.device), pos - 1][:, None]
    return _head(params, cfg, x_last), {"blocks": caches, "pos": pos}


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


def decode_step(params, cfg: ArchConfig, token, cache,
                rng: Optional[int] = None, active=None):
    """One decode step against the paged cache.  ``token`` (B,) is each
    slot's latest token, ``cache["pos"]`` a scalar or (B,) positions, and
    ``active`` (B,) bool the rows allowed to write K/V (inactive rows write to
    the garbage block).  Returns (logits (B, 1, V), cache with pos + 1); the
    pools are updated in place."""
    b = token.shape[0]
    pos = cache["pos"]
    pos_b = torch.as_tensor(pos, device=token.device).to(torch.int64)
    pos_b = pos_b.expand(b) if pos_b.dim() == 0 else pos_b
    x = _embed_inputs(params, cfg, token[:, None], pos_b[:, None])
    for pi, kind in enumerate(cfg.pattern):
        stacked = params["blocks"][f"p{pi}"]
        cstack = cache["blocks"][f"p{pi}"]
        for li in range(cfg.n_full_cycles):
            r = layer_rng(layer_rng(rng, pi), li)
            x, _ = tf.apply_block_decode(layer_params(stacked, li), x, cfg,
                                         kind, layer_params(cstack, li),
                                         pos_b, r, active=active)
    return _head(params, cfg, x), dict(cache, pos=pos + 1)
