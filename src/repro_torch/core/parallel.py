"""Tensor parallelism at run time: a rank's shard group and its collectives.

The sharded serve engine keeps every tensor local to its rank (plain tensors
with explicit collectives, not DTensor): column-parallel weights leave their
outputs split over the group, row-parallel ones all-reduce partial sums, and
the model's call sites say which is which (``core.imc_linear.linear``'s
``split``).  The engine activates its group around every model call with
:func:`use`; with no active group every call site runs the single-device
code unchanged.

Every rank runs the same host loop, so the collectives line up: each one
is reached by every rank of the group in the same order.  All-reduce and
all-gather give every rank the same bits, so every decision that follows
from a gathered or reduced tensor (greedy tokens, dynamic quantizer
ranges) agrees across ranks.  A sum adds the ranks' tensors in rank order
(:meth:`ShardGroup.sum`), so its bits do not depend on the backend.

A unit that does not divide the group (query heads, SSD heads, the RG-LRU
width, ``d_ff``, the vocabulary, the experts) stays whole on every rank:
its sites are in :attr:`ShardGroup.replicated`, and :func:`active_for`
hands them no group, so they run the single-device code with no
collective.  A column site whose columns are not one equal block of the
output (the SSD ``in_proj``: a rank's ``z``, ``x`` and ``dt`` heads beside
the whole ``B|C`` columns) says which global columns each rank holds with
a :class:`Columns` layout.

Backend rule: ranks with a card each talk over NCCL; ranks that share a
device (the CPU, or one card time-shared by several processes) over gloo.
Gloo takes every collective used here on CUDA tensors as well (all-reduce
of max, all-gather into one tensor; checked on torch 2.11 by
``chip_smoke.py``'s ``mesh`` phase), so nothing is copied through host
memory.  The host-side fault vote (:meth:`ShardGroup.vote`) runs on CPU
tensors: over the group itself under gloo, over a gloo side group
(``vote_group``) where the group is NCCL.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import functools
from typing import Any, Iterator, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist


class Columns(NamedTuple):
    """Which global output columns of a column-parallel ``(K, total)``
    weight each rank holds: ``ranks[r]`` is rank r's ``(start, stop)``
    segments, in the order its local columns lie.  Every rank holds as
    many columns; a column may lie on several ranks (the SSD ``B|C``
    columns), and then the lowest of them owns it."""

    ranks: Tuple[Tuple[Tuple[int, int], ...], ...]
    total: int

    @classmethod
    def block(cls, size: int, m: int) -> "Columns":
        """Rank r holds the block ``[r m, (r + 1) m)`` of ``size m``."""
        return cls(tuple(((r * m, (r + 1) * m),) for r in range(size)),
                   size * m)

    def index(self, rank: int, device=None) -> torch.Tensor:
        """Rank ``rank``'s local columns as global indices."""
        return _index(self, rank, torch.device(device or "cpu"))

    def owned(self, rank: int, device=None) -> torch.Tensor:
        """Mask of rank ``rank``'s local columns that no lower rank holds."""
        return _owned(self, rank, torch.device(device or "cpu"))


@functools.lru_cache(maxsize=256)
def _index(cols: Columns, rank: int, device) -> torch.Tensor:
    return torch.cat([torch.arange(a, b, device=device)
                      for a, b in cols.ranks[rank]])


@functools.lru_cache(maxsize=256)
def _owned(cols: Columns, rank: int, device) -> torch.Tensor:
    mine = _index(cols, rank, device)
    keep = torch.ones(mine.shape, dtype=torch.bool, device=device)
    for r in range(rank):
        keep &= ~torch.isin(mine, _index(cols, r, device))
    return keep


@dataclasses.dataclass(frozen=True)
class ShardGroup:
    """This rank's place in a tensor-parallel group of ``size`` ranks.

    ``kv_shard`` says whether the KV heads are split over the group (the
    K/V projections column-parallel, the pools head-sharded) or every rank
    holds all of them (``Hkv % size != 0``: the projections and pools are
    replicated, and each rank's query heads attend to one KV head).
    ``row_columns`` names the row-parallel sites whose weights are placed
    by OUTPUT columns instead (the bit-serial substrate's banks must see
    the whole dot product: ``launch.sharding.row_sites_by_columns``).
    ``replicated`` names the sites whose unit does not divide the group
    (``launch.sharding.replicated_sites``): their weights are whole on
    every rank and they run with no collective.  ``vote_group`` is the
    gloo group of :meth:`vote` (None: ``group`` itself)."""

    group: Any
    rank: int
    size: int
    kv_shard: bool = True
    row_columns: frozenset = frozenset()
    replicated: frozenset = frozenset()
    vote_group: Any = None

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """All-reduce sum in rank order, in place; returns ``t``.

        The ranks' tensors are gathered and added as ``((t0 + t1) + t2) +
        ...``: one fixed float expression whatever the backend, where an
        all-reduce adds in an order of its own (gloo's ring order changes
        from chunk to chunk).  So one device that splits a dot product the
        same way gives the same bits (``chip_smoke.py``'s ``mesh`` phase)."""
        flat = t.reshape(-1).contiguous()
        parts = torch.empty(self.size * flat.numel(), dtype=t.dtype,
                            device=t.device)
        dist.all_gather_into_tensor(parts, flat, group=self.group)
        parts = parts.view(self.size, -1)
        acc = parts[0].clone()
        for part in parts[1:]:
            acc.add_(part)
        return t.copy_(acc.view(t.shape))

    def max(self, t: torch.Tensor) -> torch.Tensor:
        """All-reduce max of a tensor (a dynamic range); returns a copy."""
        t = t.clone()
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group)
        return t

    def gather(self, t: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """The ranks' tensors joined along ``dim`` in rank order."""
        t = t.contiguous()
        out = torch.empty((self.size * t.shape[0],) + tuple(t.shape[1:]),
                          dtype=t.dtype, device=t.device)
        dist.all_gather_into_tensor(out, t, group=self.group)
        return torch.cat(out.view((self.size,) + t.shape).unbind(0), dim=dim)

    def gather_columns(self, y: torch.Tensor, cols: Columns) -> torch.Tensor:
        """The ranks' column-split outputs ``y`` (..., m) put back whole
        (..., ``cols.total``) in the single device's column order, each
        column once."""
        parts = self.gather(y[None], dim=0)  # (size, ..., m)
        out = y.new_empty(tuple(y.shape[:-1]) + (cols.total,))
        for r in range(self.size):
            out.index_copy_(-1, cols.index(r, y.device), parts[r])
        return out

    def vote(self, failed: bool) -> bool:
        """Whether any rank of the group says ``failed``: a host-side
        all-reduce of one integer (CPU tensors, so no device sync)."""
        t = torch.tensor([int(failed)], dtype=torch.int32)
        dist.all_reduce(t, op=dist.ReduceOp.MAX,
                        group=self.vote_group or self.group)
        return bool(t.item())

    def span(self, n_total: int):
        """(start, stop) of this rank's equal share of ``n_total``."""
        per = n_total // self.size
        return self.rank * per, (self.rank + 1) * per


_ACTIVE: contextvars.ContextVar[Optional[ShardGroup]] = (
    contextvars.ContextVar("shard_group", default=None))


def active() -> Optional[ShardGroup]:
    """The shard group of the model call in progress (None: one device)."""
    return _ACTIVE.get()


def active_for(site: Optional[str]) -> Optional[ShardGroup]:
    """The active shard group, or None where ``site`` is replicated (its
    unit does not divide the group: the single-device code runs)."""
    tp = _ACTIVE.get()
    if tp is None or site in tp.replicated:
        return None
    return tp


@contextlib.contextmanager
def use(group: Optional[ShardGroup]) -> Iterator[None]:
    """Run the model calls inside under ``group`` (None: one device)."""
    token = _ACTIVE.set(group)
    try:
        yield
    finally:
        _ACTIVE.reset(token)
