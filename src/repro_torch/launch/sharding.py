"""Sharding rules for tensor-parallel serving (the serve half of the JAX
reference's ``launch/sharding.py``) and the placement the port builds on
them.

A spec is a tuple with one entry per tensor dimension: an axis name of the
mesh (``"data"``, ``"model"``), a tuple of them, or None (not sharded).  The
path-ordered parameter rules, ``kv_head_partition`` and the divisibility
check are the reference's; ``serve_param_spec`` adds the two places where
explicit per-rank tensors must differ from what GSPMD would do with the
same rules:

  * when the KV heads do not divide the model axis, the pools are
    replicated, and so are the K/V projections: a column shard of ``wk``
    would split a head across ranks;
  * a row-parallel projection on the bit-serial substrate is placed by its
    OUTPUT columns: a bank's ADC converts its whole dot product, so K is
    never split (``core.imc_linear.linear`` gathers the input instead).

The training helpers of the reference (``ws``, ``ws_attn``,
``attn_carry_pin``, ``attn_grad_spec``, ``moe_vmap_axes``,
``attn_expand_groups``) wait for the training slice.
"""
from __future__ import annotations

import re
from typing import Tuple

import torch

from repro_torch.core import parallel
from repro_torch.core import substrate as substrate_lib
from repro_torch.launch.mesh import axis_size
from repro_torch.models import model
from repro_torch.tree import keystr, map_with_path, walk


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

ROW_SITES = ("attn.wo", "local.wo", "mlp.wo")


def kv_sharded(cfg, tp: int) -> bool:
    """Whether the KV heads (projections, rings and paged pools) split over
    a ``tp``-way model axis: the reference's rule, ``Hkv % tp == 0``."""
    return cfg.n_kv_heads % tp == 0


def row_sites_by_columns(cfg) -> frozenset:
    """The row-parallel sites that run on the bit-serial substrate: their
    weights are placed by output columns."""
    sub = substrate_lib.as_substrate(cfg.imc)
    return frozenset(s for s in ROW_SITES
                     if sub.site_config(s).mode == "imc_bitserial")


def _site(cfg, path) -> str:
    """The compute site of a row-parallel leaf path (``blocks/p0/mixer/wo``
    -> ``attn.wo``)."""
    if path[-2] == "mlp":
        return "mlp.wo"
    kinds = cfg.pattern if path[0] == "blocks" else cfg.tail_kinds
    return f"{kinds[int(path[1][1:])]}.wo"


def serve_param_spec(cfg, tp: int, path, ndim: int, stacked: bool) -> Tuple:
    """The spec the sharded engine places a leaf by: the reference's rules
    with the two overrides of the module docstring."""
    spec = param_spec("/".join(path), ndim, stacked)
    name = path[-1]
    if name in ("wk", "wv") and not kv_sharded(cfg, tp):
        return P(*[None] * ndim)
    if (name == "wo" and "experts" not in path
            and _site(cfg, path) in row_sites_by_columns(cfg)):
        return P(*[None] * (ndim - 1), "model")
    return spec


def shard_tensor(t: torch.Tensor, spec, rank: int, size: int,
                 copy: bool = True) -> torch.Tensor:
    """This rank's block of ``t`` along its ``"model"`` axis: a tensor of
    its own, or with ``copy=False`` a view of ``t``."""
    for dim, entry in enumerate(spec):
        names = entry if isinstance(entry, tuple) else (entry,)
        if "model" in names:
            if t.shape[dim] % size:
                raise ValueError(f"dimension {dim} of {tuple(t.shape)} does "
                                 f"not divide over {size} ranks")
            per = t.shape[dim] // size
            block = t.narrow(dim, rank * per, per)
            return block.contiguous() if copy else block
    return t


def shard_params(params, cfg, mesh):
    """This rank's shard of a whole parameter tree, by ``serve_param_spec``.
    Raises where a sharded dimension does not divide the model axis (the
    model's collectives assume even shares)."""
    tp = axis_size(mesh, "model")
    if tp == 1:
        return params
    specs = map_with_path(lambda path, leaf: serve_param_spec(
        cfg, tp, path, leaf.dim(), path[0] == "blocks"), params)
    issues = validate_divisibility(params, specs, mesh)
    if issues:
        raise ValueError(f"sharded dimensions do not divide the {tp}-way "
                         f"model axis: {issues}")
    flat = dict(walk(specs))
    return map_with_path(lambda path, leaf: shard_tensor(
        leaf, flat[path], mesh.rank, tp), params)


def init_params(cfg, mesh, seed: int = 0, device=None):
    """This rank's shard of ``models.init_params(cfg, seed)``, drawn without
    the whole model on the rank: each module (or MoE expert stack) is drawn
    whole, in the single device's order, cut to this rank's block and
    freed before the next one."""
    tp = axis_size(mesh, "model")

    def cut(path, t):
        spec = serve_param_spec(cfg, tp, path, t.dim(), False)
        # a stacked layer's block stays a view: init copies it into its
        # leaf, so the drawn module is never held twice
        return shard_tensor(t, spec, mesh.rank, tp,
                            copy=path[0] != "blocks")

    return model.init_params(cfg, seed=seed, device=device,
                             shard=cut if tp > 1 else None)


def shard_group(cfg, mesh) -> parallel.ShardGroup:
    """The run-time shard group of this rank of ``mesh`` for ``cfg``."""
    tp = axis_size(mesh, "model")
    return parallel.ShardGroup(
        group=mesh.group, rank=mesh.rank, size=tp,
        kv_shard=kv_sharded(cfg, tp),
        row_columns=row_sites_by_columns(cfg))
