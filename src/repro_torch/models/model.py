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
    """Refuse what the port does not serve yet: VLM prefixes and the
    recurrent (SSM, RG-LRU) and MoE kinds.  Remainder layers occur only in
    recurrent patterns."""
    for kind in cfg.pattern:
        tf.check_kind(cfg, kind)
    if cfg.tail_kinds:
        raise NotImplementedError(
            f"pattern {cfg.pattern} leaves remainder layers "
            f"{cfg.tail_kinds}: not ported yet (ROADMAP)")
    if cfg.modality == "vlm":
        raise NotImplementedError("vlm prefixes are not ported yet (ROADMAP)")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def init_params(cfg: ArchConfig, seed: int = 0, device=None) -> Dict[str, Any]:
    """Random parameters from a ``torch.Generator`` seeded with ``seed``, in
    the reference's layout and scales (not its values: JAX's streams are not
    reproducible in PyTorch; use ``convert.params_from_jax`` for those).

    Each stacked block leaf is allocated once and filled layer by layer, in
    the draw order of stacking a list of layers, so the peak memory is the
    weights plus one layer's draws, not twice the weights."""
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
    if cfg.pos_kind == "learned":
        params["pos_table"] = (torch.randn(
            (cfg.max_seq, cfg.d_model), generator=gen, device=device)
            * 0.02).to(dtype)
    n_full = cfg.n_full_cycles
    blocks = {}
    for pi, kind in enumerate(cfg.pattern):
        stacked = None
        for li in range(n_full):
            layer = tf.init_block(gen, cfg, kind, dtype, device)
            if stacked is None:
                stacked = tree_map(lambda t: torch.empty(
                    (n_full,) + tuple(t.shape), dtype=t.dtype,
                    device=t.device), layer)
            _fill(stacked, layer, li)
            del layer  # freed before the next layer's draws
        blocks[f"p{pi}"] = stacked
    params["blocks"] = blocks
    return params


def _fill(stacked, layer, li: int):
    """Copy one layer's leaves into row ``li`` of the stacked leaves."""
    for k, v in layer.items():
        if isinstance(v, dict):
            _fill(stacked[k], v, li)
        else:
            stacked[k][li].copy_(v)


def param_bytes(params) -> int:
    """Bytes of every leaf of a parameter tree."""
    if isinstance(params, dict):
        return sum(param_bytes(v) for v in params.values())
    return params.numel() * params.element_size()


def init_paged_cache(cfg: ArchConfig, batch: int, cache_len: int,
                     num_blocks: int, block_size: int, device=None):
    """Paged decode cache, per pattern position stacked over layers: global
    blocks get pools ``(L, num_blocks, block_size, Hkv, hd)`` and block
    tables ``(L, batch, max_blocks)`` (identical contents across layers);
    local blocks keep contiguous rings ``(L, batch, span, Hkv, hd)``."""
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
        # every leaf starts at zero: allocate the stacked leaves directly
        cache["blocks"][f"p{pi}"] = tree_map(
            lambda t: torch.zeros((n_full,) + tuple(t.shape), dtype=t.dtype,
                                  device=t.device), one)
    return cache


# ---------------------------------------------------------------------------
# embedding / head
# ---------------------------------------------------------------------------


def _embed_inputs(params, cfg: ArchConfig, tokens, positions):
    x = params["embed"][tokens]  # (B, S, d)
    if cfg.emb_scale:
        x = x * torch.tensor(cfg.d_model**0.5, dtype=x.dtype)
    if cfg.pos_kind == "learned":
        x = x + params["pos_table"][positions]
    elif cfg.pos_kind == "sinusoidal":
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
              cache_len: int, true_len=None):
    """Every layer in the reference's order: cycle ``li`` runs pattern
    positions 0, 1, ... (gemma2: local 0, global 0, local 1, ...)."""
    ks = {f"p{pi}": [] for pi in range(len(cfg.pattern))}
    vs = {f"p{pi}": [] for pi in range(len(cfg.pattern))}
    for li in range(cfg.n_full_cycles):
        for pi, kind in enumerate(cfg.pattern):
            r = layer_rng(layer_rng(rng, pi), li)
            x, c = tf.apply_block_full(
                layer_params(params["blocks"][f"p{pi}"], li), x, cfg, kind,
                positions, r, want_cache, cache_len, true_len=true_len)
            if want_cache:
                ks[f"p{pi}"].append(c["k"])
                vs[f"p{pi}"].append(c["v"])
    caches = {}
    if want_cache:
        for key in ks:
            caches[key] = {"k": torch.stack(ks[key]),
                           "v": torch.stack(vs[key])}
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
    are taken at each row's true last position, ``cache["pos"]`` is
    ``true_len`` and each local layer's ring is packed from its row's true
    tail.  The cache holds each global layer's K/V in the linear layout
    ``(L, B, cache_len, Hkv, hd)`` and each local layer's ring ``(L, B,
    min(window, cache_len), Hkv, hd)``; ``decode_step`` takes it as is."""
    _check_arch(cfg)
    b, s = tokens.shape
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    x = _embed_inputs(params, cfg, tokens, positions)
    x, caches = _run_full(params, cfg, x, positions, rng, True, cache_len,
                          true_len=true_len)
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
    """One decode step against the engine's paged cache or the contiguous
    cache ``prefill`` returns.  ``token`` (B,) is each slot's latest token,
    ``cache["pos"]`` a scalar or (B,) positions, and ``active`` (B,) bool
    the rows allowed to write to the paged pools (inactive rows write to the
    garbage block).  Returns (logits (B, 1, V), cache with pos + 1); the
    caches are updated in place."""
    b = token.shape[0]
    pos = cache["pos"]
    pos_b = torch.as_tensor(pos, device=token.device).to(torch.int64)
    pos_b = pos_b.expand(b) if pos_b.dim() == 0 else pos_b
    x = _embed_inputs(params, cfg, token[:, None], pos_b[:, None])
    for li in range(cfg.n_full_cycles):
        for pi, kind in enumerate(cfg.pattern):
            r = layer_rng(layer_rng(rng, pi), li)
            x, _ = tf.apply_block_decode(
                layer_params(params["blocks"][f"p{pi}"], li), x, cfg, kind,
                layer_params(cache["blocks"][f"p{pi}"], li), pos_b, r,
                active=active)
    return _head(params, cfg, x), dict(cache, pos=pos + 1)
