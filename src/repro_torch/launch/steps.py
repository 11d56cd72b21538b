"""The train step: the training half of the reference's
``repro/launch/steps.py`` (``TrainStepBundle``, the train-state layout
``{"params", "opt", "step"}``, ``build_train_step``) on one device.

Loss and gradients come from ``torch.autograd`` through ``models.loss_fn``;
AdamW (``optim.adamw``) then updates the parameters and moments in place.
FSDP shardings, gradient compression and data-parallel training are not
ported (ROADMAP: the mesh work).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

import torch

from repro_torch import tree as tree_lib
from repro_torch.configs.base import ArchConfig
from repro_torch.models import model as model_lib
from repro_torch.optim import adamw
from repro_torch.runtime.fault import TornState


@dataclasses.dataclass(frozen=True)
class TrainStepBundle:
    step_fn: Callable  # (state, batch) -> (state, metrics)
    init_state: Callable  # (seed) -> state


def init_train_state(cfg: ArchConfig, seed: int = 0, device=None
                     ) -> Dict[str, Any]:
    """``{"params": init_params(cfg, seed), "opt": adamw.init(params),
    "step": 0}`` on ``device`` (None: the card)."""
    params = model_lib.init_params(cfg, seed=seed, device=device)
    return {"params": params, "opt": adamw.init(params),
            "step": torch.zeros((), dtype=torch.int32,
                                device=model_lib.resolve_device(device))}


def build_train_step(
    cfg: ArchConfig,
    opt_cfg: adamw.AdamWConfig = adamw.AdamWConfig(),
    total_steps: int = 10_000,
    device=None,
) -> TrainStepBundle:
    """A ``(state, batch) -> (state, metrics)`` step on ``device`` (None:
    the card, raising where there is none).  ``batch`` holds ``tokens``
    (B, S) and, for a vlm, ``prefix_embeds``, on that device.  The returned
    state holds the same parameter and moment tensors, updated in place,
    and ``step + 1``; the metrics are float32 scalars: loss, lr, ce,
    moe_aux, z_loss, grad_norm, clip_scale."""
    device = model_lib.resolve_device(device)
    sched = adamw.warmup_cosine(opt_cfg.lr, min(100, total_steps // 10 + 1),
                                total_steps)

    def step_fn(state, batch):
        params = state["params"]
        leaves = tree_lib.leaves(params)
        try:
            with torch.enable_grad():
                for p in leaves:
                    p.requires_grad_(True)
                loss, aux_metrics = model_lib.loss_fn(params, cfg, batch)
                grads = torch.autograd.grad(loss, leaves,
                                            materialize_grads=True)
        finally:
            for p in leaves:
                p.requires_grad_(False)
        lr = sched(state["step"])
        try:
            opt, opt_metrics = adamw.update(
                tree_lib.unflatten(params, grads), state["opt"], params,
                opt_cfg, lr)
        except Exception as e:
            raise TornState(f"the optimizer update failed: {e!r}") from e
        metrics = {"loss": loss, "lr": lr, **aux_metrics, **opt_metrics}
        metrics = {k: v.detach().to(torch.float32)
                   for k, v in metrics.items()}
        return ({"params": params, "opt": opt, "step": state["step"] + 1},
                metrics)

    return TrainStepBundle(
        step_fn=step_fn,
        init_state=lambda seed=0: init_train_state(cfg, seed, device),
    )
