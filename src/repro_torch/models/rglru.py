"""RG-LRU recurrent block (RecurrentGemma / Griffin).

  x-branch: linear -> temporal conv1d -> RG-LRU
  y-branch: linear -> GeLU
  out = (x-branch * y-branch) -> linear

RG-LRU core (per channel, diagonal gates as in the reference):
  r_t = sigmoid(lam_a * x_t + b_a)
  i_t = sigmoid(lam_i * x_t + b_i)
  a_t = exp(-c * softplus(A) * r_t)
  h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The linear recurrence runs over the sequence as a log-depth associative scan
(the same pairing tree as ``jax.lax.associative_scan``, so the products are
formed in the reference's order) and as one step for decode.  Decode updates
its cache in place.

Under tensor parallelism (an active ``core.parallel`` shard group that the
width divides) a rank holds its share of the width channels: ``rg_x`` and
``rg_gate`` are column sites, the conv, the gates and the scan run on its
channels (all per channel, so its values are the single device's), and
``rg_out`` is a row site.  The cache holds the rank's channels.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import parallel
from repro_torch.core.imc_linear import DIGITAL, IMCConfig, linear
from repro_torch.models.layers import dense_init
from repro_torch.models.ssm import causal_conv, conv_step

RG_C = 8.0  # Griffin's fixed temperature


def init_rglru(gen, d_model: int, width: int, conv_width: int, dtype,
               device):
    def normal(shape):
        return torch.randn(shape, generator=gen, device=device,
                           dtype=torch.float32)

    rg_x = dense_init(gen, d_model, width, dtype, device)
    rg_gate = dense_init(gen, d_model, width, dtype, device)
    rg_out = dense_init(gen, width, d_model, dtype, device)
    conv_w = (normal((conv_width, width)) * 0.1).to(dtype)
    # softplus^-1 of A with a^c in [0.9, 0.999]
    u = torch.rand((width,), generator=gen, device=device,
                   dtype=torch.float32) * (0.999 - 0.9) + 0.9
    rg_a = torch.log(torch.expm1(-torch.log(u) / RG_C))
    zeros = torch.zeros((width,), dtype=torch.float32, device=device)
    return {
        "rg_x": rg_x,
        "rg_gate": rg_gate,
        "rg_out": rg_out,
        "conv_w": conv_w,
        "conv_b": torch.zeros((width,), dtype=dtype, device=device),
        "rg_a": rg_a,
        "rg_input_gate_w": normal((width,)) * 0.1,
        "rg_rec_gate_w": normal((width,)) * 0.1,
        "rg_input_gate_b": zeros,
        "rg_rec_gate_b": zeros.clone(),
    }


def _gelu(x):
    return F.gelu(x, approximate="tanh")  # jax.nn.gelu's default


def _gates(params, xb):
    xf = xb.to(torch.float32)
    r = torch.sigmoid(xf * params["rg_rec_gate_w"] + params["rg_rec_gate_b"])
    i = torch.sigmoid(xf * params["rg_input_gate_w"]
                      + params["rg_input_gate_b"])
    sp = torch.logaddexp(params["rg_a"], torch.zeros_like(params["rg_a"]))
    log_a = -RG_C * sp * r  # (..., W), <= 0
    a = torch.exp(log_a)
    gated_x = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a),
                                     min=1e-12)) * (i * xf)
    return a, gated_x


def _combine(a1, b1, a2, b2):
    return a1 * a2, a2 * b1 + b2


def associative_scan(a, b):
    """Inclusive scan of ``h_t = a_t h_{t-1} + b_t`` over dim 1, by the
    recursion of ``jax.lax.associative_scan``: combine adjacent pairs, scan
    the half-length sequence, then fill in the even positions.  Returns
    (cumulative a, h)."""
    n = a.shape[1]
    if n < 2:
        return a, b
    ra, rb = _combine(a[:, 0:-1:2], b[:, 0:-1:2], a[:, 1::2], b[:, 1::2])
    oa, ob = associative_scan(ra, rb)
    if n % 2 == 0:
        ea, eb = _combine(oa[:, :-1], ob[:, :-1], a[:, 2::2], b[:, 2::2])
    else:
        ea, eb = _combine(oa, ob, a[:, 2::2], b[:, 2::2])
    ea = torch.cat([a[:, :1], ea], dim=1)
    eb = torch.cat([b[:, :1], eb], dim=1)
    out_a, out_b = torch.empty_like(a), torch.empty_like(b)
    out_a[:, 0::2], out_a[:, 1::2] = ea, oa
    out_b[:, 0::2], out_b[:, 1::2] = eb, ob
    return out_a, out_b


def rglru_forward(params, x, cfg, imc: IMCConfig = DIGITAL, rng=None,
                  h0=None):
    """Full-sequence RG block. x: (B, S, d_model).  Returns (y, h_last
    (B, W) float32)."""
    xb = linear(params["rg_x"], x, imc, rng, site="rg.x",
                split="col")  # (B, S, W)
    gate = _gelu(linear(params["rg_gate"], x, imc, rng, site="rg.gate",
                        split="col").to(torch.float32))
    xb = causal_conv(xb, params["conv_w"], params["conv_b"])
    a, gx = _gates(params, xb)  # (B, S, W) f32
    if h0 is not None:
        # fold the initial state in as a virtual step at t=0:
        # h_1 = a_1 h_0 + gx_1 exactly
        gx = gx.clone()
        gx[:, 0] = gx[:, 0] + a[:, 0] * h0.to(torch.float32)
        a = a.clone()
        a[:, 0] = 0.0
    _, h = associative_scan(a, gx)
    y = (h * gate).to(x.dtype)
    out = linear(params["rg_out"], y, imc, rng, site="rg.out", split="row")
    return out, h[:, -1].to(torch.float32)


def init_rglru_cache(batch: int, width: int, conv_width: int, dtype, device):
    """A slot's state and conv inputs (this rank's channels under a shard
    group)."""
    tp = parallel.active_for("rg.x")
    if tp is not None:
        width //= tp.size
    return {
        "conv": torch.zeros((batch, conv_width - 1, width), dtype=dtype,
                            device=device),
        "h": torch.zeros((batch, width), dtype=torch.float32, device=device),
    }


def rglru_decode(params, x, cache, cfg, imc: IMCConfig = DIGITAL, rng=None):
    """One-token step. x: (B, 1, d_model).  Writes the new conv inputs and
    state into ``cache``; returns (y, cache)."""
    xb = linear(params["rg_x"], x, imc, rng, site="rg.x",
                split="col")  # (B, 1, W)
    gate = _gelu(linear(params["rg_gate"], x, imc, rng, site="rg.gate",
                        split="col").to(torch.float32))
    hist = torch.cat([cache["conv"], xb.to(cache["conv"].dtype)], dim=1)
    a, gx = _gates(params, conv_step(hist, params["conv_w"],
                                     params["conv_b"]))  # (B, 1, W)
    h = a[:, 0] * cache["h"] + gx[:, 0]  # (B, W)
    y = (h[:, None, :] * gate).to(x.dtype)
    out = linear(params["rg_out"], y, imc, rng, site="rg.out", split="row")
    cache["conv"].copy_(hist[:, 1:])
    cache["h"].copy_(h)
    return out, cache
