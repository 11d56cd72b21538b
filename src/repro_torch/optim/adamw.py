"""AdamW with decoupled weight decay, global-norm clipping, and
bf16-param / f32-state mixed precision: the port of the reference's
``repro/optim/adamw.py`` (``AdamWConfig``, ``OptState``, ``init``,
``global_norm``, ``update``, ``_decay_mask``, ``warmup_cosine``).

The state mirrors the parameter tree (``m`` and ``v`` in float32, one leaf
per parameter).  Where the reference returns new arrays, :func:`update`
changes the parameters, ``m`` and ``v`` IN PLACE (a full-width model's
state is 16 GB; a second copy would double it) with the reference's
arithmetic: each leaf is updated in float32 and cast back to its dtype.  A
caller that keeps an earlier state (a checkpoint being written) copies it
first (``checkpoint.AsyncSaver`` does).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, NamedTuple, Tuple

import torch

from repro_torch import tree as tree_lib
from repro_torch.kernels.ref import true_div


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    # parameters whose path matches are excluded from weight decay
    no_decay_substrings: Tuple[str, ...] = ("scale", "bias", "norm", "A_log",
                                            "dt_bias", "rg_a")


class OptState(NamedTuple):
    m: Any
    v: Any
    count: torch.Tensor  # int32 scalar


def init(params) -> OptState:
    """Zero float32 moments beside every parameter, count 0."""
    ps = tree_lib.leaves(params)
    dev = ps[0].device if ps else torch.device("cpu")

    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    return OptState(m=tree_lib.map_leaves(zeros, params),
                    v=tree_lib.map_leaves(zeros, params),
                    count=torch.zeros((), dtype=torch.int32, device=dev))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's float32 sum of squares (a float32
    scalar on the leaves' device)."""
    total = None
    for x in tree_lib.leaves(tree):
        sq = torch.sum(torch.square(x.to(torch.float32)))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


@torch.no_grad()
def update(grads, state: OptState, params, cfg: AdamWConfig,
           lr: torch.Tensor) -> Tuple[OptState, Dict[str, torch.Tensor]]:
    """One AdamW step, in place: ``params``, ``state.m`` and ``state.v``
    change; returns (the state with its count advanced, metrics
    ``grad_norm`` and ``clip_scale``).  ``grads`` has ``params``' structure
    (its float32 leaves may be overwritten)."""
    gnorm = global_norm(grads)
    # a tensor numerator: ``float / tensor`` would multiply by a reciprocal
    scale = torch.clamp(torch.full_like(gnorm, cfg.grad_clip)
                        / (gnorm + 1e-9), max=1.0)
    count = state.count + 1
    cnt = count.to(torch.float32)
    b1c = 1.0 - torch.pow(cfg.b1, cnt)
    b2c = 1.0 - torch.pow(cfg.b2, cnt)

    decay = _decay_mask(params, cfg)
    flat_p = tree_lib.leaves(params)
    flat_g = tree_lib.leaves(grads)
    flat_m = tree_lib.leaves(state.m)
    flat_v = tree_lib.leaves(state.v)
    for d, g, m, v, p in zip(decay, flat_g, flat_m, flat_v, flat_p):
        g = g.to(torch.float32).mul_(scale)
        m.mul_(cfg.b1).add_(g * (1 - cfg.b1))
        v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        del g
        step = m / b1c
        step.div_(torch.sqrt(v / b2c).add_(cfg.eps))
        if d:
            step.add_(cfg.weight_decay * p.to(torch.float32))
        p.copy_(p.to(torch.float32) - lr * step)
    metrics = {"grad_norm": gnorm, "clip_scale": scale}
    return OptState(state.m, state.v, count), metrics


def _decay_mask(params, cfg: AdamWConfig) -> List[bool]:
    """Per leaf (in tree order): True where weight decay applies, i.e. no
    ``no_decay_substrings`` entry occurs in the leaf's lower-cased path."""
    return [not any(s in path.lower() for s in cfg.no_decay_substrings)
            for path, _ in tree_lib.flatten_with_path(params)]


# ---------------------------------------------------------------------------
# LR schedules
# ---------------------------------------------------------------------------


def warmup_cosine(base_lr: float, warmup: int, total: int,
                  min_frac: float = 0.1) -> Callable:
    """Linear warmup to ``base_lr`` over ``warmup`` steps, then a cosine
    decay to ``min_frac * base_lr`` at ``total``; ``sched(step)`` takes an
    int or an integer tensor and returns a float32 tensor, computed in
    float32 as the reference computes it (IEEE divisions: ``true_div``)."""
    def sched(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = true_div(base_lr * step, max(warmup, 1))
        prog = torch.clamp(true_div(step - warmup, max(total - warmup, 1)),
                           0.0, 1.0)
        # the cosine of the float32 angle, rounded once from float64 (torch's
        # float32 cos can be an ulp off the correctly rounded value)
        c = torch.cos((math.pi * prog).to(torch.float64)).to(torch.float32)
        cos = base_lr * (min_frac + (1 - min_frac) * 0.5 * (1 + c))
        return torch.where(step < warmup, warm, cos)

    return sched
