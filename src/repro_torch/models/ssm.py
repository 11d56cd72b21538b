"""Mamba-2 (SSD: state-space duality) mixer in the chunked matmul form.

The selective state-space recurrence

    h[t] = exp(dt[t] A) h[t-1] + dt[t] B[t] (x) x[t];   y[t] = C[t] . h[t] + D x[t]

runs, as in the JAX reference, as chunk-local matmuls (an L x L
decay-masked product inside each chunk) plus a sequential state pass from
chunk to chunk, in the reference's order of sums.  Decode is one state
update per token: the cache is a constant-size state and the last
``conv_width - 1`` conv inputs.  The caches are updated in place.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core.imc_linear import DIGITAL, IMCConfig, linear
from repro_torch.models.layers import dense_init


def ssm_dims(d_model: int, expand: int, head_dim: int, groups: int,
             state: int):
    d_inner = expand * d_model
    n_heads = d_inner // head_dim
    conv_ch = d_inner + 2 * groups * state
    return d_inner, n_heads, conv_ch


def init_ssm(gen, d_model, expand, head_dim, groups, state, conv_width,
             dtype, device):
    d_inner, n_heads, conv_ch = ssm_dims(d_model, expand, head_dim, groups,
                                         state)
    d_proj = 2 * d_inner + 2 * groups * state + n_heads

    def uniform(shape, lo=0.0, hi=1.0):
        u = torch.rand(shape, generator=gen, device=device,
                       dtype=torch.float32)
        return u * (hi - lo) + lo

    in_proj = dense_init(gen, d_model, d_proj, dtype, device)
    conv_w = (torch.randn((conv_width, conv_ch), generator=gen, device=device,
                          dtype=torch.float32) * 0.1).to(dtype)
    # dt_bias: inverse-softplus of dt ~ U[1e-3, 1e-1] (log-uniform)
    dt = torch.exp(uniform((n_heads,)) * (math.log(0.1) - math.log(1e-3))
                   + math.log(1e-3))
    dt_bias = dt + torch.log(-torch.expm1(-dt))
    a_log = torch.log(uniform((n_heads,), 1.0, 16.0))
    out_proj = dense_init(gen, d_inner, d_model, dtype, device)
    return {
        "in_proj": in_proj,
        "conv_w": conv_w,
        "conv_b": torch.zeros((conv_ch,), dtype=dtype, device=device),
        "A_log": a_log,
        "D": torch.ones((n_heads,), dtype=torch.float32, device=device),
        "dt_bias": dt_bias,
        "norm_scale": torch.zeros((d_inner,), dtype=dtype, device=device),
        "out_proj": out_proj,
    }


def causal_conv(x, w, b):
    """Depthwise causal conv. x: (B, S, C), w: (W, C); in x's dtype."""
    width, s = w.shape[0], x.shape[1]
    out = torch.zeros_like(x)
    for u in range(width):
        shift = width - 1 - u
        xs = F.pad(x, (0, 0, shift, 0))[:, :s]
        out = out + xs * w[u]
    return out + b


def conv_step(hist, w, b):
    """The conv's output at the newest of ``hist`` (B, W, C), in float32."""
    f = torch.float32
    return (torch.einsum("bwc,wc->bc", hist.to(f), w.to(f))
            + b.to(f))[:, None, :]


def _gated_norm(y, z, scale, eps=1e-6):
    """Mamba-2 RMSNormGated: rmsnorm(y * silu(z))."""
    f = torch.float32
    y = y * F.silu(z.to(f)).to(y.dtype)
    yf = y.to(f)
    var = (yf * yf).mean(dim=-1, keepdim=True)
    return (yf * torch.rsqrt(var + eps) * (1.0 + scale.to(f))).to(y.dtype)


def split_proj(params, x, cfg, imc, rng):
    d_inner, n_heads, _ = ssm_dims(cfg.d_model, cfg.ssm_expand,
                                   cfg.ssm_head_dim, cfg.ssm_groups,
                                   cfg.ssm_state)
    gn = cfg.ssm_groups * cfg.ssm_state
    proj = linear(params["in_proj"], x, imc, rng, site="ssm.in_proj")
    z = proj[..., :d_inner]
    xbc = proj[..., d_inner: 2 * d_inner + 2 * gn]
    dt_raw = proj[..., 2 * d_inner + 2 * gn:]
    return z, xbc, dt_raw, d_inner, n_heads


def _softplus(x):
    # jax.nn.softplus: log(1 + exp(x)) with no linear cut-over
    return torch.logaddexp(x, torch.zeros_like(x))


def ssm_forward(params, x, cfg, imc: IMCConfig = DIGITAL, rng=None):
    """Full-sequence SSD. x: (B, S, d_model).  Returns (y, final state
    (B, H, N, P) in float32)."""
    b, s, _ = x.shape
    hd, g, n = cfg.ssm_head_dim, cfg.ssm_groups, cfg.ssm_state
    z, xbc, dt_raw, d_inner, n_heads = split_proj(params, x, cfg, imc, rng)
    xbc = F.silu(causal_conv(xbc, params["conv_w"], params["conv_b"])
                 .to(torch.float32)).to(x.dtype)
    xs = xbc[..., :d_inner].reshape(b, s, n_heads, hd)
    bmat = xbc[..., d_inner: d_inner + g * n].reshape(b, s, g, n)
    cmat = xbc[..., d_inner + g * n:].reshape(b, s, g, n)
    dt = _softplus(dt_raw.float() + params["dt_bias"])  # (B,S,H)
    a = -torch.exp(params["A_log"])  # (H,)

    l = min(cfg.ssm_chunk, s)
    nc = -(-s // l)
    pad = nc * l - s
    if pad:
        xs_p = F.pad(xs, (0, 0, 0, 0, 0, pad))
        bmat = F.pad(bmat, (0, 0, 0, 0, 0, pad))
        cmat = F.pad(cmat, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
    else:
        xs_p = xs
    hpg = n_heads // g
    causal = torch.tril(torch.ones((l, l), dtype=torch.bool,
                                   device=x.device))
    state = torch.zeros((b, n_heads, n, hd), dtype=torch.float32,
                        device=x.device)
    ys = []
    for c in range(nc):
        sl = slice(c * l, (c + 1) * l)
        x_ch, b_ch, c_ch = xs_p[:, sl], bmat[:, sl], cmat[:, sl]
        dt_ch = dt[:, sl]
        cum = torch.cumsum(dt_ch * a, dim=1)  # (B,L,H)
        xdt = x_ch.to(torch.float32) * dt_ch[..., None]  # (B,L,H,P)
        # intra: y[l1] += (C[l1].B[l2]) exp(cum[l1]-cum[l2]) dt[l2] x[l2]
        cb = torch.einsum("blgn,bsgn->bgls", c_ch.to(torch.float32),
                          b_ch.to(torch.float32))
        cb = torch.repeat_interleave(cb, hpg, dim=1)  # (B,H,L,L)
        cum_t = cum.transpose(1, 2)
        decay = torch.exp(cum_t[..., :, None] - cum_t[..., None, :])
        m = torch.where(causal, cb * decay, 0.0)
        y = torch.einsum("bhls,bshp->blhp", m, xdt)
        # inter: y[l] += C[l] . (exp(cum[l]) * state_in)
        ch = torch.repeat_interleave(c_ch, hpg, dim=2).to(torch.float32)
        y = y + (torch.einsum("blhn,bhnp->blhp", ch, state)
                 * torch.exp(cum)[..., None])
        # state: S' = exp(cum[-1]) S + sum_l exp(cum[-1]-cum[l]) dt B (x) x
        tail = torch.exp(cum[:, -1:, :] - cum)
        bh = torch.repeat_interleave(b_ch, hpg, dim=2).to(torch.float32)
        s_c = torch.einsum("blhn,blhp->bhnp", bh, xdt * tail[..., None])
        state = torch.exp(cum[:, -1, :])[..., None, None] * state + s_c
        ys.append(y)
    y = torch.cat(ys, dim=1)[:, :s]
    y = y + params["D"][None, None, :, None] * xs.to(torch.float32)
    y = y.reshape(b, s, d_inner).to(x.dtype)
    y = _gated_norm(y, z, params["norm_scale"])
    return linear(params["out_proj"], y, imc, rng, site="ssm.out_proj"), state


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


def init_ssm_cache(batch, cfg, dtype, device):
    _, n_heads, conv_ch = ssm_dims(cfg.d_model, cfg.ssm_expand,
                                   cfg.ssm_head_dim, cfg.ssm_groups,
                                   cfg.ssm_state)
    return {
        "conv": torch.zeros((batch, cfg.conv_width - 1, conv_ch),
                            dtype=dtype, device=device),
        "state": torch.zeros((batch, n_heads, cfg.ssm_state,
                              cfg.ssm_head_dim), dtype=torch.float32,
                             device=device),
    }


def ssm_decode(params, x, cache, cfg, imc: IMCConfig = DIGITAL, rng=None):
    """One-token step. x: (B, 1, d_model).  Writes the new conv inputs and
    state into ``cache``; returns (y, cache)."""
    b = x.shape[0]
    hd, g, n = cfg.ssm_head_dim, cfg.ssm_groups, cfg.ssm_state
    z, xbc, dt_raw, d_inner, n_heads = split_proj(params, x, cfg, imc, rng)
    hist = torch.cat([cache["conv"], xbc.to(cache["conv"].dtype)], dim=1)
    xbc_a = F.silu(conv_step(hist, params["conv_w"],
                             params["conv_b"])).to(x.dtype)
    xs = xbc_a[..., :d_inner].reshape(b, n_heads, hd)
    bmat = xbc_a[..., d_inner: d_inner + g * n].reshape(b, g, n)
    cmat = xbc_a[..., d_inner + g * n:].reshape(b, g, n)
    dt = _softplus(dt_raw.to(torch.float32)[:, 0] + params["dt_bias"])
    a = -torch.exp(params["A_log"])
    hpg = n_heads // g
    decay = torch.exp(dt * a)  # (B,H)
    bh = torch.repeat_interleave(bmat, hpg, dim=1).to(torch.float32)
    ch = torch.repeat_interleave(cmat, hpg, dim=1).to(torch.float32)
    dbx = (dt[..., None, None] * bh[..., :, None]
           * xs.to(torch.float32)[..., None, :])
    state = cache["state"] * decay[..., None, None] + dbx  # (B,H,N,P)
    y = torch.einsum("bhn,bhnp->bhp", ch, state)
    y = y + params["D"][None, :, None] * xs.to(torch.float32)
    y = y.reshape(b, 1, d_inner).to(x.dtype)
    y = _gated_norm(y, z, params["norm_scale"])
    out = linear(params["out_proj"], y, imc, rng, site="ssm.out_proj")
    cache["conv"].copy_(hist[:, 1:])
    cache["state"].copy_(state)
    return out, cache
