"""Input-shape registry and ``input_specs()``: the port of the reference's
``repro/configs/shapes.py`` (``ShapeSpec``, ``SHAPES``, ``shape_applicable``,
``input_specs``).

  train_4k      seq_len=4096    global_batch=256   a train step
  prefill_32k   seq_len=32768   global_batch=32    serve prefill
  decode_32k    seq_len=32768   global_batch=128   serve decode_step
  long_500k     seq_len=524288  global_batch=1     decode_step; sub-quadratic
                archs only (mamba2, recurrentgemma) - skips are recorded,
                not silently dropped.

torch has no ``ShapeDtypeStruct``: a :class:`TensorSpec` (shape and dtype,
no storage) stands in for it.  The reference's ``cache_specs`` and
``param_specs`` serve only its dry-run tooling and are not ported.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """A tensor's shape and dtype, with no storage."""

    shape: Tuple[int, ...]
    dtype: torch.dtype


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def shape_applicable(cfg: ArchConfig, shape: ShapeSpec) -> Optional[str]:
    """None if runnable; otherwise a skip reason."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return (
            "long_500k requires sub-quadratic attention; "
            f"{cfg.name} has unbounded-range attention layers"
        )
    return None


def input_specs(cfg: ArchConfig, shape: ShapeSpec) -> Dict[str, TensorSpec]:
    """TensorSpecs for the step inputs (excluding params/cache/state)."""
    b, s = shape.global_batch, shape.seq_len
    if shape.kind in ("train", "prefill"):
        specs = {"tokens": TensorSpec((b, s), torch.int32)}
        if cfg.modality == "vlm":
            specs["prefix_embeds"] = TensorSpec(
                (b, cfg.prefix_len, cfg.d_model), torch.bfloat16)
        return specs
    if shape.kind == "decode":
        return {"token": TensorSpec((b,), torch.int32)}
    raise ValueError(shape.kind)
