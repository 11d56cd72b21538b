"""Sharding rules for tensor-parallel serving (the serve half of the JAX
reference's ``launch/sharding.py``) and the placement the port builds on
them.

A spec is a tuple with one entry per tensor dimension: an axis name of the
mesh (``"data"``, ``"model"``), a tuple of them, or None (not sharded).  The
path-ordered parameter rules, ``kv_head_partition``, the divisibility
check and ``fallback_replicate`` are the reference's; ``serve_param_spec``
adds the places where explicit per-rank tensors must differ from what
GSPMD would do with the same rules:

  * a site whose unit does not divide the model axis (query heads, SSD
    heads, the RG-LRU width, ``d_ff``, the vocabulary, the experts) is
    whole on every rank (``replicated_sites``), as the reference's
    ``fallback_replicate`` leaves it;
  * when the KV heads do not divide the model axis, the pools are
    replicated, and so are the K/V projections: a column shard of ``wk``
    would split a head across ranks;
  * a row-parallel projection on the bit-serial substrate is placed by its
    OUTPUT columns: a bank's ADC converts its whole dot product, so K is
    never split (``core.imc_linear.linear`` gathers the input instead);
  * the SSD and RG-LRU mixers' per-channel leaves split on their channel
    dimension, and the SSD ``in_proj`` and conv by a rank's segments (its
    ``z``, ``x`` and ``dt`` heads beside the whole ``B|C`` columns:
    ``leaf_columns``).

The training helpers of the reference (``ws``, ``ws_attn``,
``attn_carry_pin``, ``attn_grad_spec``, ``moe_vmap_axes``,
``attn_expand_groups``) wait for the training slice.
"""
from __future__ import annotations

import logging
import re
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.core import parallel
from repro_torch.core import substrate as substrate_lib
from repro_torch.launch.mesh import axis_size
from repro_torch.models import model
from repro_torch.models import ssm as ssm_lib
from repro_torch.tree import keystr, map_with_path, walk

log = logging.getLogger("repro_torch.sharding")


def _entry(e):
    # as JAX's PartitionSpec: a tuple of one axis is that axis, of none None
    if isinstance(e, tuple):
        return None if not e else e[0] if len(e) == 1 else e
    return e


def P(*entries) -> Tuple:
    """A spec: one entry per dimension (``P()`` replicates)."""
    return tuple(_entry(e) for e in entries)


def kv_head_partition(hkv: int, n: int) -> list:
    """Per-shard-group KV head ranges for head-sharded paged pools.

    Returns ``n`` contiguous ``(start, stop)`` half-open ranges partitioning
    ``range(hkv)``: every head lands in exactly one shard group.  The block
    table and BlockAllocator stay WHOLE per shard group; only the head axis
    of the ``(num_blocks, block, Hkv, hd)`` pools is split.

    Raises ValueError when ``hkv`` does not divide evenly over ``n`` shards:
    uneven head padding would silently change per-device KV accounting, so
    callers replicate the pools instead.
    """
    if n < 1 or hkv < 1:
        raise ValueError(f"need hkv >= 1 and n >= 1, got hkv={hkv}, n={n}")
    if hkv % n != 0:
        raise ValueError(
            f"{hkv} KV heads do not partition over {n} shard groups "
            f"({hkv} % {n} != 0); replicate the pools instead")
    per = hkv // n
    return [(i * per, (i + 1) * per) for i in range(n)]


# ---------------------------------------------------------------------------
# parameter specs by path
# ---------------------------------------------------------------------------

_PARAM_RULES = [
    # (regex on the joined path, spec WITHOUT the stacked-layer leading axis)
    # first match wins: the expert rules must precede the generic matmul
    # rules, or expert weights would shard on d_model instead of the experts
    (r"experts/.*(wi|wg)$", P("model", None, None)),  # (E, d, f)
    (r"experts/.*wo$", P("model", None, None)),  # (E, f, d)
    (r"router", P(None, "model")),  # (d, E)
    (r"embed", P("model", None)),  # (vocab, d)
    (r"pos_table", P(None, "model")),  # (max_seq, d)
    (r"lm_head", P(None, "model")),  # (d, vocab)
    (r"(wq|wk|wv)$", P(None, "model")),  # (d, heads*hd)
    (r"wo$", P("model", None)),  # (heads*hd, d) / (f, d)
    (r"(wi|wg)$", P(None, "model")),  # (d, f)
    (r"in_proj$", P(None, "model")),  # ssm (d, inner+...)
    (r"out_proj$", P("model", None)),  # ssm (inner, d)
    (r"(conv_w|conv_b|A_log|dt_bias|D)$", P("model")),  # ssm per-channel
    (r"(rg_x|rg_gate)$", P(None, "model")),  # rglru (d, w)
    (r"rg_out$", P("model", None)),  # (w, d)
    (r"(rg_a|rg_input_gate_w|rg_rec_gate_w)$", P("model")),
    (r"(scale|bias)$", P(None)),  # norms
]


def param_spec(path: str, ndim: int, stacked: bool) -> Tuple:
    """Spec of a parameter at ``path`` (slash-joined), with ``stacked`` True
    when its leading axis is the stacked-layer axis."""
    base = P()
    for pat, spec in _PARAM_RULES:
        if re.search(pat, path):
            base = spec
            break
    entries = list(base)
    if stacked:
        entries = [None] + entries
    return P(*(entries + [None] * ndim)[:ndim])


def tree_param_specs(params, stacked_prefixes: Tuple[str, ...] = ("blocks",)):
    """The spec of every leaf of a parameter tree, by path."""

    def visit(path, leaf):
        pstr = "/".join(path)
        stacked = any(pstr.startswith(p) for p in stacked_prefixes)
        return param_spec(pstr, leaf.dim(), stacked)

    return map_with_path(visit, params)


def validate_divisibility(params, specs, mesh) -> list:
    """(path, shape, spec) of every leaf whose sharded dimension does not
    divide evenly over its axes."""
    flat_specs = dict(walk(specs))
    issues = []
    for path, leaf in walk(params):
        spec = flat_specs[path]
        for dim, entry in enumerate(spec):
            if entry is None:
                continue
            names = entry if isinstance(entry, tuple) else (entry,)
            size = 1
            for n in names:
                size *= axis_size(mesh, n)
            if leaf.shape[dim] % size != 0:
                issues.append((keystr(path), tuple(leaf.shape), spec))
                break
    return issues


def fallback_replicate(specs, issues_paths):
    """``specs`` with full replication at the given (keystr) paths."""
    return map_with_path(lambda path, spec: (
        P() if keystr(path) in issues_paths else spec), specs)


# ---------------------------------------------------------------------------
# the port's placement
# ---------------------------------------------------------------------------

ROW_SITES = ("attn.wo", "local.wo", "mlp.wo", "ssm.out_proj", "rg.out")
_ATTN_LEAVES = ("wq", "wk", "wv", "wo")


def kv_sharded(cfg, tp: int) -> bool:
    """Whether the KV heads (projections, rings and paged pools) split over
    a ``tp``-way model axis: the reference's rule, ``Hkv % tp == 0``."""
    return cfg.n_kv_heads % tp == 0


def attention_whole(cfg, tp: int) -> bool:
    """Whether attention stays whole on every rank of a ``tp``-way axis:
    the query heads do not divide it, or (with replicated KV heads) a
    rank's query heads would straddle two KV heads."""
    if cfg.n_heads % tp:
        return True
    if kv_sharded(cfg, tp):
        return False
    return (cfg.n_heads // cfg.n_kv_heads) % (cfg.n_heads // tp) != 0


def replicated_sites(cfg, tp: int) -> frozenset:
    """The sites whose unit does not divide a ``tp``-way model axis, so
    their weights are whole on every rank (``core.parallel.ShardGroup``'s
    ``replicated``): the attention sites (query heads), the SSD sites (SSD
    heads), the RG-LRU sites (width), the dense MLP (``d_ff``), ``"moe"``
    (experts and router), ``"embed"`` and ``lm_head`` (the padded
    vocabulary) and ``"pos_table"`` (``d_model``, the learned table's
    split)."""
    if tp == 1:
        return frozenset()
    kinds = set(cfg.pattern) | set(cfg.tail_kinds)
    out = set()
    if attention_whole(cfg, tp):
        out |= {f"{k}.{n}" for k in ("attn", "local") for n in _ATTN_LEAVES}
    if "ssm" in kinds and ssm_lib.ssm_dims(
            cfg.d_model, cfg.ssm_expand, cfg.ssm_head_dim, cfg.ssm_groups,
            cfg.ssm_state)[1] % tp:
        out |= {"ssm.in_proj", "ssm.out_proj"}
    if "rglru" in kinds and cfg.rnn_width % tp:
        out |= {"rg.x", "rg.gate", "rg.out"}
    if cfg.n_experts > 0:
        if cfg.n_experts % tp:
            out.add("moe")
    elif cfg.d_ff % tp:
        out |= {"mlp.wi", "mlp.wo"}
    if cfg.padded_vocab % tp:
        out |= {"embed", "lm_head"}
    if cfg.d_model % tp:
        out.add("pos_table")
    return frozenset(out)


def row_sites_by_columns(cfg) -> frozenset:
    """The row-parallel sites that run on the bit-serial substrate: their
    weights are placed by output columns."""
    sub = substrate_lib.as_substrate(cfg.imc)
    return frozenset(s for s in ROW_SITES
                     if sub.site_config(s).mode == "imc_bitserial")


def _kind(cfg, path) -> str:
    kinds = cfg.pattern if path[0] == "blocks" else cfg.tail_kinds
    return kinds[int(path[1][1:])]


def leaf_site(cfg, path) -> Optional[str]:
    """The site (or unit name) whose placement a leaf follows: the
    projection it is, or, for the SSD and RG-LRU per-channel leaves, the
    column site whose channels they carry; None for the norms."""
    name = path[-1]
    if name in ("embed", "lm_head", "pos_table"):
        return name
    if path[0] not in ("blocks", "tail"):
        return None
    if path[2] == "moe":
        return "moe"
    if path[2] == "mlp":
        return "mlp.wo" if name == "wo" else "mlp.wi"
    if path[2] != "mixer":
        return None
    kind = _kind(cfg, path)
    if kind == "ssm":
        return "ssm.out_proj" if name == "out_proj" else "ssm.in_proj"
    if kind == "rglru":
        return {"rg_out": "rg.out", "rg_gate": "rg.gate"}.get(name, "rg.x")
    return f"{kind}.{name}"


def serve_param_spec(cfg, tp: int, path, ndim: int, stacked: bool) -> Tuple:
    """The spec the sharded engine places a leaf by: the reference's rules,
    with whole leaves where the site's unit does not divide
    (:func:`replicated_sites`), replicated K/V projections where the KV
    heads do not, bit-serial row sites by output columns, and the
    recurrent mixers' channels on their last dimension (the SSD
    ``in_proj`` and conv by the segments of :func:`leaf_columns`)."""
    site = leaf_site(cfg, path)
    whole = P(*[None] * ndim)
    if site in replicated_sites(cfg, tp):
        return whole
    name = path[-1]
    if name in ("wk", "wv") and not kv_sharded(cfg, tp):
        return whole
    lead = [None] if stacked else []
    if site in ROW_SITES:
        if site in row_sites_by_columns(cfg):
            return P(*[None] * (ndim - 1), "model")
        if site in ("ssm.out_proj", "rg.out"):
            return P(*lead, "model", None)
    if site is not None and site[:3] in ("ssm", "rg."):
        return P(*[None] * (ndim - 1), "model")
    return param_spec("/".join(path), ndim, stacked)


def leaf_columns(cfg, tp: int, path) -> Optional[parallel.Columns]:
    """The ranks' column segments of a leaf that is not cut into equal
    blocks (the SSD ``in_proj`` and its conv; None for every other)."""
    if (tp == 1 or leaf_site(cfg, path) != "ssm.in_proj"
            or "ssm.in_proj" in replicated_sites(cfg, tp)):
        return None
    if path[-1] == "in_proj":
        return ssm_lib.in_proj_columns(cfg, tp)
    if path[-1] in ("conv_w", "conv_b"):
        return ssm_lib.conv_columns(cfg, tp)
    return None


def shard_tensor(t: torch.Tensor, spec, rank: int, size: int,
                 copy: bool = True,
                 cols: Optional[parallel.Columns] = None) -> torch.Tensor:
    """This rank's block of ``t`` along its ``"model"`` axis: a tensor of
    its own, or with ``copy=False`` a view of ``t``.  With ``cols`` the
    rank's segments of that axis, joined (always a tensor of its own)."""
    for dim, entry in enumerate(spec):
        names = entry if isinstance(entry, tuple) else (entry,)
        if "model" in names:
            if cols is not None:
                return torch.cat([t.narrow(dim, a, b - a)
                                  for a, b in cols.ranks[rank]], dim=dim)
            if t.shape[dim] % size:
                raise ValueError(f"dimension {dim} of {tuple(t.shape)} does "
                                 f"not divide over {size} ranks")
            per = t.shape[dim] // size
            block = t.narrow(dim, rank * per, per)
            return block.contiguous() if copy else block
    return t


def placed_specs(params, cfg, mesh):
    """Every leaf's :func:`serve_param_spec`, with ``fallback_replicate``
    over any leaf whose sharded dimension still does not divide the model
    axis (a leaf cut by :func:`leaf_columns` divides by its segments)."""
    tp = axis_size(mesh, "model")
    specs = map_with_path(lambda path, leaf: serve_param_spec(
        cfg, tp, path, leaf.dim(), path[0] == "blocks"), params)
    issues = {p for p, _, _ in validate_divisibility(params, specs, mesh)}
    issues -= {keystr(p) for p, _ in walk(params)
               if leaf_columns(cfg, tp, p) is not None}
    if issues:
        log.info("replicating leaves that do not divide the %d-way model "
                 "axis: %s", tp, sorted(issues))
    return fallback_replicate(specs, issues)


def shard_params(params, cfg, mesh):
    """This rank's shard of a whole parameter tree, by
    :func:`placed_specs`: sites whose unit does not divide the model axis
    stay whole."""
    tp = axis_size(mesh, "model")
    if tp == 1:
        return params
    flat = dict(walk(placed_specs(params, cfg, mesh)))
    return map_with_path(lambda path, leaf: shard_tensor(
        leaf, flat[path], mesh.rank, tp,
        cols=leaf_columns(cfg, tp, path)), params)


def init_params(cfg, mesh, seed: int = 0, device=None):
    """This rank's shard of ``models.init_params(cfg, seed)``, drawn without
    the whole model on the rank: each module (or MoE expert stack) is drawn
    whole, in the single device's order, cut to this rank's block and
    freed before the next one.  A leaf is placed as :func:`placed_specs`
    places it."""
    tp = axis_size(mesh, "model")

    def cut(path, t):
        spec = serve_param_spec(cfg, tp, path, t.dim(), False)
        if validate_divisibility({"leaf": t}, {"leaf": spec}, mesh) and (
                leaf_columns(cfg, tp, path) is None):
            spec = P(*[None] * t.dim())  # fallback_replicate's leaf
        # a stacked layer's block stays a view: init copies it into its
        # leaf, so the drawn module is never held twice
        return shard_tensor(t, spec, mesh.rank, tp,
                            copy=path[0] != "blocks",
                            cols=leaf_columns(cfg, tp, path))

    return model.init_params(cfg, seed=seed, device=device,
                             shard=cut if tp > 1 else None)


def shard_group(cfg, mesh) -> parallel.ShardGroup:
    """The run-time shard group of this rank of ``mesh`` for ``cfg``.
    Every rank of the mesh must make it (under NCCL it makes the gloo
    group of the fault vote)."""
    tp = axis_size(mesh, "model")
    replicated = replicated_sites(cfg, tp)
    vote_group = None
    if dist.get_backend(mesh.group) == "nccl":
        vote_group = dist.new_group(list(range(mesh.size)), backend="gloo")
    return parallel.ShardGroup(
        group=mesh.group, rank=mesh.rank, size=tp,
        kv_shard=kv_sharded(cfg, tp),
        row_columns=row_sites_by_columns(cfg) - replicated,
        replicated=replicated, vote_group=vote_group)


def replace_params(params, cfg_old, cfg_new, group: parallel.ShardGroup):
    """``params`` placed for ``cfg_new`` where they were placed for
    ``cfg_old``: a leaf whose spec differs (a row site moved on or off the
    bit-serial substrate, placed by columns there and by rows elsewhere)
    is gathered whole over ``group`` and cut by its new spec."""
    tp = group.size

    def move(path, leaf):
        stacked = path[0] == "blocks"
        old = serve_param_spec(cfg_old, tp, path, leaf.dim(), stacked)
        new = serve_param_spec(cfg_new, tp, path, leaf.dim(), stacked)
        if old == new:
            return leaf
        whole = group.gather(leaf, dim=old.index("model"))
        return shard_tensor(whole, new, group.rank, tp)

    return map_with_path(move, params)
