"""Shared model-building blocks: norms, embeddings, positions, MLPs.

Functional, like the JAX reference: ``init_*`` return dicts of tensors drawn
from an explicit ``torch.Generator``, and the apply functions are plain
functions of tensors.  Every matmul routes through
``repro_torch.core.imc_linear`` so the IMC execution modes apply model-wide.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.imc_linear import DIGITAL, IMCConfig, linear


def dtype_of(name: str):
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------


def _normal(gen: torch.Generator, shape, device):
    return torch.randn(shape, generator=gen, device=device,
                       dtype=torch.float32)


def dense_init(gen, d_in: int, d_out: int, dtype, device,
               scale: Optional[float] = None):
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    return (_normal(gen, (d_in, d_out), device) * scale).to(dtype)


def embed_init(gen, vocab: int, d: int, dtype, device):
    return (_normal(gen, (vocab, d), device) * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def init_norm(kind: str, d: int, dtype, device):
    if kind == "rmsnorm":
        return {"scale": torch.zeros((d,), dtype=dtype, device=device)}
    if kind == "layernorm":
        return {"scale": torch.zeros((d,), dtype=dtype, device=device),
                "bias": torch.zeros((d,), dtype=dtype, device=device)}
    raise ValueError(kind)


def apply_norm(params, x, kind: str, eps: float = 1e-6):
    xf = x.to(torch.float32)
    if kind == "rmsnorm":
        var = (xf * xf).mean(dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + eps)
        y = y * (1.0 + params["scale"].to(torch.float32))
    else:
        mu = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, keepdim=True, unbiased=False)
        y = (xf - mu) * torch.rsqrt(var + eps)
        y = (y * (1.0 + params["scale"].to(torch.float32))
             + params["bias"].to(torch.float32))
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# positions
# ---------------------------------------------------------------------------


def rope(x, positions, theta: float):
    """Rotary embedding. x: (..., S, H, hd); positions: (..., S)."""
    hd = x.shape[-1]
    half = hd // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = positions[..., :, None].to(torch.float32) * freq
    cos = torch.cos(ang)[..., :, None, :]
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(x.dtype)


def sinusoidal_positions(positions, d: int):
    """(..., S) -> (..., S, d) classic sin/cos table, computed on the fly."""
    half = d // 2
    freq = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=positions.device) / half)
    ang = positions[..., None].to(torch.float32) * freq
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------------------
# softcap
# ---------------------------------------------------------------------------


def softcap(x, cap: Optional[float]):
    if cap is None:
        return x
    return (cap * torch.tanh(x.to(torch.float32) / cap)).to(x.dtype)


# ---------------------------------------------------------------------------
# MLPs (gated + plain), through the IMC layer
# ---------------------------------------------------------------------------


def _gelu(x):
    # jax.nn.gelu's default is the tanh approximation
    return F.gelu(x, approximate="tanh")


def init_mlp(gen, d: int, d_ff: int, kind: str, dtype, device):
    if kind in ("swiglu", "geglu"):
        return {"wi": dense_init(gen, d, d_ff, dtype, device),
                "wg": dense_init(gen, d, d_ff, dtype, device),
                "wo": dense_init(gen, d_ff, d, dtype, device)}
    if kind == "gelu":
        return {"wi": dense_init(gen, d, d_ff, dtype, device),
                "wo": dense_init(gen, d_ff, d, dtype, device)}
    raise ValueError(kind)


def apply_mlp(params, x, kind: str, imc: IMCConfig = DIGITAL, rng=None):
    # site names follow the shared shapes walk (the gate projection shares
    # the "mlp.wi" site: same shape, same design-point assignment)
    if kind in ("swiglu", "geglu"):
        h = linear(params["wi"], x, imc, rng, site="mlp.wi")
        g = linear(params["wg"], x, imc, rng, site="mlp.wi")
        act = F.silu if kind == "swiglu" else _gelu
        h = act(g.to(torch.float32)).to(h.dtype) * h
        return linear(params["wo"], h, imc, rng, site="mlp.wo")
    h = linear(params["wi"], x, imc, rng, site="mlp.wi")
    h = _gelu(h.to(torch.float32)).to(h.dtype)
    return linear(params["wo"], h, imc, rng, site="mlp.wo")
