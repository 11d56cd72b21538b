"""Carry parameters from the JAX package into the port.

``params_from_jax`` takes the tree of ``repro.models.init_params`` (nested
dicts of arrays, handed over as numpy arrays or anything ``np.asarray``
accepts) and returns the port's parameter tree: the same nested dict layout,
with the stacked ``blocks/p{i}/...`` leaves keeping their leading layer axis.
After conversion both packages compute the same function.  bfloat16 leaves
(numpy's ``ml_dtypes`` bfloat16) are carried bit for bit.  With a
``launch.mesh.Mesh`` the tree comes back as this rank's shard
(``launch.sharding.shard_params``), the input of ``Engine(mesh=)``.
``opt_state_from_jax`` carries the reference's AdamW state (``OptState``:
``m``, ``v``, ``count``) into the port's, so both packages can take the same
optimizer step.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def tensor_from_numpy(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16)
                                .astype(np.int16))
        return bits.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def params_from_jax(tree: Dict[str, Any], device, cfg=None,
                    mesh=None) -> Dict[str, Any]:
    """The port's parameter tree for a JAX ``init_params`` tree; with
    ``mesh`` (and the port's ``cfg``, whose substrate places the bit-serial
    row sites) this rank's shard of it."""
    if mesh is not None:
        from repro_torch.launch import sharding

        return sharding.shard_params(params_from_jax(tree, device), cfg,
                                     mesh)
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    return tensor_from_numpy(tree, torch.device(device))


def opt_state_from_jax(state, device):
    """The port's ``optim.adamw.OptState`` for the reference's (its ``m``
    and ``v`` trees and ``count``, as numpy arrays or anything
    ``np.asarray`` accepts)."""
    from repro_torch.optim.adamw import OptState

    dev = torch.device(device)
    return OptState(m=params_from_jax(state.m, dev),
                    v=params_from_jax(state.v, dev),
                    count=tensor_from_numpy(state.count, dev))
