"""Mixture-of-Experts with top-k routing and grouped capacity-based dispatch,
as in the JAX reference.

Tokens are routed in groups of ``moe_group_size``.  Within a group each
(token, choice) slot takes a position in its expert's capacity buffer by a
cumulative count in token order; slots past the capacity drop.  The
(E, cap, d) buffer is built by scatter, every expert runs on its whole
buffer (zero rows included), and the outputs gather back to token order
weighted by the renormalized router gates.  Returns the Switch-style
load-balance aux loss beside the output.

Expert products: on the digital substrate one batched matmul per weight over
the expert stack; on the IMC substrates one ``linear`` call per group and
expert, so each sees its own buffer's dynamic ranges and every expert gets
the same noise seed (the reference vmaps one key over the experts).

Under tensor parallelism (an active ``core.parallel`` shard group) the
experts and the router's columns are split over the ranks: every rank
routes with the gathered E logits, runs its own experts, and the weighted
slot outputs are summed over the group.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import parallel
from repro_torch.core import substrate as substrate_lib
from repro_torch.core.imc_linear import DIGITAL, IMCConfig, linear
from repro_torch.models.layers import _gelu, dense_init


def expert_stack(gen, n_experts: int, d_in: int, d_out: int, dtype, device):
    """(E, d_in, d_out) weights, drawn expert by expert into one
    allocation (a float32 transient of one expert at a time)."""
    out = torch.empty((n_experts, d_in, d_out), dtype=dtype, device=device)
    for e in range(n_experts):
        out[e].copy_(dense_init(gen, d_in, d_out, dtype, device))
    return out


def init_moe_parts(gen, d: int, d_ff: int, n_experts: int, mlp_kind: str,
                   dtype, device, prefix=()):
    """The MoE parameters as (``prefix`` + path, tensor) pairs in draw
    order, one expert stack at a time (``models.model.init_params`` copies
    each into its stacked leaf before the next is drawn; nothing here keeps
    a reference to a yielded stack)."""
    yield prefix + ("router",), dense_init(gen, d, n_experts, torch.float32,
                                           device, scale=0.02)
    names = ("wi", "wg", "wo") if mlp_kind in ("swiglu", "geglu") else (
        "wi", "wo")
    for name in names:
        d_in, d_out = (d_ff, d) if name == "wo" else (d, d_ff)
        yield prefix + ("experts", name), expert_stack(
            gen, n_experts, d_in, d_out, dtype, device)


def _expert_linear(w, h, imc, rng, site):
    """h (n, E, cap, d_in) through each expert's w (E, d_in, d_out)."""
    if substrate_lib.as_substrate(imc).site_config(site).mode == "digital":
        # one batched matmul over the experts, the groups folded into rows
        # (broadcasting w over the groups would copy it)
        n, e, c, d_in = h.shape
        y = linear(w, h.transpose(0, 1).reshape(e, n * c, d_in), imc, rng,
                   site=site)
        return y.reshape(e, n, c, -1).transpose(0, 1)
    return torch.stack([
        torch.stack([linear(w[e], h[gi, e], imc, rng, site=site)
                     for e in range(w.shape[0])])
        for gi in range(h.shape[0])])


def _expert_mlp(ep, h, mlp_kind: str, imc: IMCConfig, rng):
    hi = _expert_linear(ep["wi"], h, imc, rng, "mlp.wi")
    if mlp_kind in ("swiglu", "geglu"):
        g = _expert_linear(ep["wg"], h, imc, rng, "mlp.wi")
        act = F.silu if mlp_kind == "swiglu" else _gelu
        hi = act(g.to(torch.float32)).to(hi.dtype) * hi
    else:
        hi = _gelu(hi.to(torch.float32)).to(hi.dtype)
    return _expert_linear(ep["wo"], hi, imc, rng, "mlp.wo")


def apply_moe(params, x, n_experts: int, top_k: int, capacity_factor: float,
              group_size: int, mlp_kind: str, imc: IMCConfig = DIGITAL,
              rng=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (y (B, S, d), aux loss (a float32 scalar)).  The
    router runs in float32."""
    b, s, d = x.shape
    t = b * s
    xt = x.reshape(t, d)
    g_sz = min(group_size, t)
    n_groups = -(-t // g_sz)
    pad = n_groups * g_sz - t
    if pad:
        xt = F.pad(xt, (0, 0, 0, pad))
    xg = xt.reshape(n_groups, g_sz, d)
    cap = max(int(-(-top_k * g_sz * capacity_factor // n_experts)), 1)

    tp = parallel.active()
    logits = torch.einsum("ngd,de->nge", xg.to(torch.float32),
                          params["router"])
    if tp is not None:
        # the router is split over the experts: every rank routes with all
        # E logits, so every rank computes the same routing
        logits = tp.gather(logits)
    probs = torch.softmax(logits, dim=-1)  # (n, g, E)
    # top-k with jax.lax.top_k's tie order (the lower expert first; pad
    # rows' uniform probabilities are all ties)
    gate, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, idx = gate[..., :top_k], idx[..., :top_k]  # (n, g, k)
    gate = gate / (gate.sum(dim=-1, keepdim=True) + 1e-9)

    # position in expert: slots flattened row-major (token-priority order)
    flat_e = idx.reshape(n_groups, g_sz * top_k)
    onehot = F.one_hot(flat_e, n_experts).to(torch.int32)
    pos = torch.cumsum(onehot, dim=1) - 1
    pos_in_e = torch.gather(pos, 2, flat_e[..., None])[..., 0]
    keep = pos_in_e < cap
    overflow = n_experts * cap
    slot = torch.where(keep, flat_e * cap + pos_in_e,
                       torch.full_like(flat_e, overflow))

    # scatter tokens into the capacity buffers (+1 overflow row, dropped)
    rows = torch.arange(n_groups, device=x.device)[:, None]
    x_rep = torch.repeat_interleave(xg, top_k, dim=1)  # (n, g*k, d)
    buf = torch.zeros((n_groups, overflow + 1, d), dtype=xg.dtype,
                      device=x.device)
    buf[rows, slot] = x_rep
    buf = buf[:, :-1].reshape(n_groups, n_experts, cap, d)

    if tp is None:
        h = _expert_mlp(params["experts"], buf, mlp_kind, imc, rng)
    else:
        # this rank's experts run on their buffers; the others' rows stay
        # zero, and each slot's output comes from exactly one rank
        e0, e1 = tp.span(n_experts)
        h = torch.zeros_like(buf)
        h[:, e0:e1] = _expert_mlp(params["experts"], buf[:, e0:e1],
                                  mlp_kind, imc, rng)

    # gather back to slots, weight by the gates, sum over the k choices
    h_flat = torch.cat([h.reshape(n_groups, overflow, d),
                        torch.zeros((n_groups, 1, d), dtype=h.dtype,
                                    device=x.device)], dim=1)
    y_slots = h_flat[rows, slot]  # (n, g*k, d)
    y_slots = y_slots * (gate.reshape(n_groups, -1)[..., None]
                         * keep[..., None]).to(y_slots.dtype)
    if tp is not None:
        tp.sum(y_slots)  # exact: one nonzero term per slot
    y = y_slots.reshape(n_groups, g_sz, top_k, d).sum(dim=2)

    # Switch-style load-balance aux: E * sum_e f_e * p_e, per group
    frac = F.one_hot(idx, n_experts).to(torch.float32).mean(dim=(1, 2))
    pmean = probs.mean(dim=1)
    aux = n_experts * (frac * pmean).sum(dim=-1)
    y = y.reshape(n_groups * g_sz, d)[:t].reshape(b, s, d)
    return y, aux.mean()
