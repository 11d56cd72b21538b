"""Top-level LM: init, forward, the training loss, prefill and paged decode.

Parameters mirror the JAX reference's tree: each pattern position's blocks
are stacked along a leading layer axis under ``params["blocks"]["p{i}"]``
and the remainder layers live unstacked under ``params["tail"]["t{i}"]``
(``convert.py`` carries a JAX tree across leaf for leaf).  Caches mirror it
too.  A ``vlm`` config takes precomputed prefix embeddings (B, P, d_model)
in place of its first P token embeddings.  Entry points take an explicit
``device``; ``None`` means the card, and raises where there is none.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.core import parallel
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
from repro_torch.tree import map_leaves, map_with_path, walk


def resolve_device(device=None) -> torch.device:
    """``device`` as a torch.device; None means the card, and raises when
    PyTorch sees no CUDA device (never a silent fall back to the CPU)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' explicitly "
                               "to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def layer_params(stacked, li: int):
    """Layer ``li``'s view of a stacked parameter (or cache) subtree."""
    return map_leaves(lambda t: t[li], stacked)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def init_params(cfg: ArchConfig, seed: int = 0, device=None,
                shard=None) -> Dict[str, Any]:
    """Random parameters from a ``torch.Generator`` seeded with ``seed``, in
    the reference's layout and scales (not its values: JAX's streams are not
    reproducible in PyTorch; use ``convert.params_from_jax`` for those).

    Each stacked block leaf is allocated once and filled layer by layer, in
    the draw order of stacking a list of layers; a layer is drawn one part
    at a time (a module, or one MoE expert stack), each copied into its row
    before the next is drawn, so the peak memory is the weights plus one
    part's draws, not twice the weights or one whole layer more.

    ``shard(path, tensor)`` (a tuple path, an unstacked leaf) keeps a
    tensor-parallel rank's block of each drawn leaf
    (``launch.sharding.init_params``): the draws are the single device's,
    and only the block is kept."""
    device = resolve_device(device)
    dtype = dtype_of(cfg.dtype)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    if shard is None:
        def shard(path, t):
            return t
    params: Dict[str, Any] = {
        "embed": shard(("embed",), embed_init(
            gen, cfg.padded_vocab, cfg.d_model, dtype, device)),
        "final_norm": init_norm(cfg.norm_kind, cfg.d_model, dtype, device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = shard(("lm_head",), (torch.randn(
            (cfg.d_model, cfg.padded_vocab), generator=gen, device=device)
            * 0.02).to(dtype))
    if cfg.pos_kind == "learned":
        params["pos_table"] = shard(("pos_table",), (torch.randn(
            (cfg.max_seq, cfg.d_model), generator=gen, device=device)
            * 0.02).to(dtype))
    n_full = cfg.n_full_cycles
    blocks = {}
    for pi, kind in enumerate(cfg.pattern):
        stacked: Dict[str, Any] = {}
        for li in range(n_full):
            for path, sub in tf.init_block_parts(gen, cfg, kind, dtype,
                                                 device):
                for leaf_path, t in walk(sub, path):
                    t = shard(("blocks", f"p{pi}") + leaf_path, t)
                    if li == 0:
                        tf.put(stacked, leaf_path, torch.empty(
                            (n_full,) + tuple(t.shape), dtype=t.dtype,
                            device=t.device))
                    _get(stacked, leaf_path)[li].copy_(t)
                del sub, t  # freed before the next part's draws
        blocks[f"p{pi}"] = stacked
    params["blocks"] = blocks
    if cfg.tail_kinds:
        params["tail"] = {
            f"t{ti}": map_with_path(
                lambda p, t, ti=ti: shard(("tail", f"t{ti}") + p, t),
                tf.init_block(gen, cfg, kind, dtype, device))
            for ti, kind in enumerate(cfg.tail_kinds)}
    return params


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
    local blocks keep contiguous rings ``(L, batch, span, Hkv, hd)`` and
    recurrent blocks their per-slot states.  Remainder layers' caches sit
    unstacked under ``cache["tail"]``."""
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
        cache["blocks"][f"p{pi}"] = map_leaves(
            lambda t: torch.zeros((n_full,) + tuple(t.shape), dtype=t.dtype,
                                  device=t.device), one)
    for ti, kind in enumerate(cfg.tail_kinds):
        cache.setdefault("tail", {})[f"t{ti}"] = tf.init_block_cache_paged(
            cfg, kind, batch, cache_len, dtype, num_blocks, block_size,
            device)
    return cache


# ---------------------------------------------------------------------------
# embedding / head
# ---------------------------------------------------------------------------


def _embed_lookup(table, tokens):
    """``table[tokens]``; under an active shard group the table holds this
    rank's vocabulary rows, so the rows it lacks are zeros and the group's
    sum is the whole lookup."""
    tp = parallel.active()
    if tp is None:
        return table[tokens]
    rows = table.shape[0]
    local = tokens - tp.rank * rows
    mine = (local >= 0) & (local < rows)
    x = table[torch.where(mine, local, 0)]
    return tp.sum(torch.where(mine[..., None], x, torch.zeros_like(x)))


def _embed_inputs(params, cfg: ArchConfig, tokens, prefix_embeds, positions):
    x = _embed_lookup(params["embed"], tokens)  # (B, S, d)
    if cfg.emb_scale:
        x = x * torch.tensor(cfg.d_model**0.5, dtype=x.dtype)
    if cfg.modality == "vlm" and prefix_embeds is not None:
        p = prefix_embeds.shape[1]
        x = torch.cat([prefix_embeds.to(x.dtype), x[:, p:]], dim=1)
    if cfg.pos_kind == "learned":
        pos = params["pos_table"][positions]
        tp = parallel.active()
        if tp is not None:  # the table is split over d_model
            pos = tp.gather(pos)
        x = x + pos
    elif cfg.pos_kind == "sinusoidal":
        x = x + sinusoidal_positions(positions, cfg.d_model).to(x.dtype)
    return x


def _head(params, cfg: ArchConfig, x):
    x = apply_norm(params["final_norm"], x, cfg.norm_kind)
    if cfg.tie_embeddings:
        logits = torch.einsum("...d,vd->...v", x, params["embed"])
    else:
        logits = linear(params["lm_head"], x, cfg.imc, site="lm_head",
                        split="col")
    tp = parallel.active()
    if tp is not None:
        # this rank's vocabulary columns: gathered whole before the argmax,
        # so a tie picks the single device's token
        logits = tp.gather(logits)
    logits = softcap(logits.to(torch.float32), cfg.final_softcap)
    if cfg.padded_vocab != cfg.vocab_size:
        pad = torch.arange(cfg.padded_vocab, device=x.device) >= cfg.vocab_size
        logits = torch.where(pad, -1e9, logits)
    return logits


def tail_rng(rng: Optional[int], ti: int) -> Optional[int]:
    """Remainder layer ``ti``'s noise seed (the reference folds in
    ``10_000 + ti``)."""
    return layer_rng(rng, 10_000 + ti)


# ---------------------------------------------------------------------------
# full sequence: forward / prefill
# ---------------------------------------------------------------------------


def _stack_trees(trees):
    if isinstance(trees[0], dict):
        return {k: _stack_trees([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _run_full(params, cfg: ArchConfig, x, positions, rng, want_cache: bool,
              cache_len: int, true_len=None):
    """Every layer in the reference's order: cycle ``li`` runs pattern
    positions 0, 1, ... (gemma2: local 0, global 0, local 1, ...), then the
    remainder layers.  Returns (x, MoE aux summed over layers, stacked
    caches, tail caches)."""
    per_pos = {f"p{pi}": [] for pi in range(len(cfg.pattern))}
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    def cycle(x, li):
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for pi, kind in enumerate(cfg.pattern):
            r = layer_rng(layer_rng(rng, pi), li)
            x, c, a = tf.apply_block_full(
                layer_params(params["blocks"][f"p{pi}"], li), x, cfg, kind,
                positions, r, want_cache, cache_len, true_len=true_len)
            aux = aux + a
            if want_cache:
                per_pos[f"p{pi}"].append(c)
        return x, aux

    # training: each cycle's activations are recomputed in the backward
    # pass, not kept (the reference's jax.checkpoint of the cycle)
    remat = cfg.remat and not want_cache and torch.is_grad_enabled()
    for li in range(cfg.n_full_cycles):
        if remat:
            x, a = torch.utils.checkpoint.checkpoint(
                cycle, x, li, use_reentrant=False)
        else:
            x, a = cycle(x, li)
        aux = aux + a
    tail = {}
    for ti, kind in enumerate(cfg.tail_kinds):
        x, c, a = tf.apply_block_full(
            params["tail"][f"t{ti}"], x, cfg, kind, positions,
            tail_rng(rng, ti), want_cache, cache_len, true_len=true_len)
        aux = aux + a
        tail[f"t{ti}"] = c
    caches = ({k: _stack_trees(v) for k, v in per_pos.items()}
              if want_cache else {})
    return x, aux, caches, tail


def forward(params, cfg: ArchConfig, tokens, prefix_embeds=None,
            rng: Optional[int] = None):
    """Full-sequence logits (B, S, V) and the MoE aux loss (a float32
    scalar, zero without experts)."""
    b, s = tokens.shape
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    x = _embed_inputs(params, cfg, tokens, prefix_embeds, positions)
    x, aux, _, _ = _run_full(params, cfg, x, positions, rng, False, 0)
    return _head(params, cfg, x), aux


def loss_fn(params, cfg: ArchConfig, batch: Dict[str, Any],
            rng: Optional[int] = None, aux_coef: float = 0.01,
            z_coef: float = 1e-4):
    """Next-token cross entropy (in float32) + ``aux_coef`` x the MoE aux
    loss + ``z_coef`` x mean(logz^2), the reference's ``loss_fn``.
    ``batch`` holds ``tokens`` (B, S) and, for a vlm, ``prefix_embeds``.
    Returns (loss, {"ce", "moe_aux", "z_loss"})."""
    tokens = batch["tokens"]
    logits, aux = forward(params, cfg, tokens, batch.get("prefix_embeds"),
                          rng)
    targets = tokens[:, 1:].to(torch.int64)
    lg = logits[:, :-1].to(torch.float32)
    logz = torch.logsumexp(lg, dim=-1)
    ll = torch.gather(lg, -1, targets[..., None])[..., 0] - logz
    ce = -torch.mean(ll)
    z_loss = torch.mean(logz**2)
    loss = ce + aux_coef * aux + z_coef * z_loss
    return loss, {"ce": ce, "moe_aux": aux, "z_loss": z_loss}


def prefill(params, cfg: ArchConfig, tokens, cache_len: int,
            prefix_embeds=None, rng: Optional[int] = None, true_len=None):
    """Process a prompt batch; returns (last-position logits (B, 1, V),
    cache).  With ``true_len`` (B,) the prompts are right-padded to S: logits
    are taken at each row's true last position, ``cache["pos"]`` is
    ``true_len`` and each local layer's ring is packed from its row's true
    tail (recurrent blocks refuse padded prompts).  The cache holds each
    global layer's K/V in the linear layout ``(L, B, cache_len, Hkv, hd)``,
    each local layer's ring ``(L, B, min(window, cache_len), Hkv, hd)`` and
    each recurrent layer's final state and last conv inputs, with the
    remainder layers' under ``cache["tail"]``; ``decode_step`` takes it as
    is."""
    b, s = tokens.shape
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    x = _embed_inputs(params, cfg, tokens, prefix_embeds, positions)
    x, _, caches, tail = _run_full(params, cfg, x, positions, rng, True,
                                   cache_len, true_len=true_len)
    if true_len is None:
        x_last = x[:, -1:]
        pos = torch.tensor(s, dtype=torch.int64, device=tokens.device)
    else:
        pos = torch.as_tensor(true_len, dtype=torch.int64,
                              device=tokens.device)
        x_last = x[torch.arange(b, device=tokens.device), pos - 1][:, None]
    cache = {"blocks": caches, "pos": pos}
    if tail:
        cache["tail"] = tail
    return _head(params, cfg, x_last), cache


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
    x = _embed_inputs(params, cfg, token[:, None], None, pos_b[:, None])
    for li in range(cfg.n_full_cycles):
        for pi, kind in enumerate(cfg.pattern):
            r = layer_rng(layer_rng(rng, pi), li)
            x, _ = tf.apply_block_decode(
                layer_params(params["blocks"][f"p{pi}"], li), x, cfg, kind,
                layer_params(cache["blocks"][f"p{pi}"], li), pos_b, r,
                active=active)
    for ti, kind in enumerate(cfg.tail_kinds):
        x, _ = tf.apply_block_decode(
            params["tail"][f"t{ti}"], x, cfg, kind, cache["tail"][f"t{ti}"],
            pos_b, tail_rng(rng, ti), active=active)
    return _head(params, cfg, x), dict(cache, pos=pos + 1)
