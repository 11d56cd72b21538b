"""The paper's Fig. 2 question at model scale, and per-site SNR_T under an
MPC-style per-site output-ADC override map (the substrate API at layer
scale); the port of the reference's ``benchmarks/layer_snr.py``.

``whole_model_snr_sweep`` runs a SMOKE model with every matmul on the
analytic IMC substrate (all layers noisy) at a ladder of SNR_a levels and
records the training loss against the noiseless baseline.  The reference
draws its noise from ``jax.random``; the port from seeded torch generators
(``linear``'s per-site seeds), so the noisy losses agree statistically, the
baseline exactly.  ``site_snr_records`` is deterministic closed forms, no
model execution.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from repro_torch import configs
from repro_torch.core.design import optimize, with_b_adc
from repro_torch.core.imc_linear import layer_rng
from repro_torch.core.mapping import per_token_matmul_shapes
from repro_torch.core.substrate import AnalyticIMC, substrate_for_design
from repro_torch.launch.metering import (
    energy_for_tokens,
    substrate_energy_for_tokens,
)

# extra output-ADC bits per site group vs the uniform design point: the
# embedding-adjacent sites (output head, attention projections feeding the
# residual stream) get a finer ADC than the FFN sites - the per-site
# precision assignment the paper's MPC criterion (eq. 15) prices per layer
OVERRIDE_EXTRA_BITS = {"lm_head": 2, "attn": 1}


Row = Tuple[str, float, str]
SWEEP_ARCHS = ("gemma2-9b", "mamba2-2.7b")


def _loss(cfg, params, batch, rng=None) -> float:
    from repro_torch.models import loss_fn

    with torch.no_grad():
        return float(loss_fn(params, cfg, batch, rng=rng)[0])


def whole_model_losses(arch: str = "gemma2-9b", b: int = 4, s: int = 128,
                       levels=(10.0, 16.0, 22.0, 28.0, 34.0, 40.0),
                       device=None, params=None, batch=None):
    """(the noiseless loss, [(snr, mean loss over 3 noise seeds)]) of
    ``arch``'s SMOKE config with every matmul on ``AnalyticIMC(bx=8, bw=8,
    snr_a_db=snr)``.  ``params`` and ``batch`` default to seeded draws
    (seed 0 weights, seed 1 tokens of shape (b, s)) on ``device`` (None:
    the card, raising without one)."""
    from repro_torch.models import resolve_device

    cfg = configs.get_smoke(arch)
    dev = resolve_device(device)
    if params is None:
        from repro_torch.models import init_params

        params = init_params(cfg, seed=0, device=dev)
    if batch is None:
        gen = torch.Generator(device=dev).manual_seed(1)
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, s),
                                         generator=gen, device=dev)}
        if cfg.modality == "vlm":
            batch["prefix_embeds"] = torch.randn(
                (b, cfg.prefix_len, cfg.d_model), generator=gen, device=dev)
    base = _loss(cfg, params, batch)
    noisy = []
    for snr in levels:
        noisy_cfg = cfg.replace(imc=AnalyticIMC(bx=8, bw=8, snr_a_db=snr))
        ce = np.mean([_loss(noisy_cfg, params, batch, rng=layer_rng(3, i))
                      for i in range(3)])
        noisy.append((snr, float(ce)))
    return base, noisy


def whole_model_snr_sweep(arch: str = "gemma2-9b", b: int = 4, s: int = 128,
                          levels=(10.0, 16.0, 22.0, 28.0, 34.0, 40.0),
                          device=None, params=None, batch=None) -> List[Row]:
    """The reference's rows of :func:`whole_model_losses`: the baseline,
    then each level's loss and its degradation dCE."""
    base, noisy = whole_model_losses(arch, b, s, levels, device, params,
                                     batch)
    rows: List[Row] = [(f"layer_snr/{arch}/fp_ce", round(base, 4),
                        "baseline")]
    for snr, ce in noisy:
        rows.append((
            f"layer_snr/{arch}/ce_at_{snr:.0f}dB",
            round(ce, 4),
            f"dCE={ce-base:+.4f} (req: small at >=24 dB, paper SSIII-B)",
        ))
    return rows


def run(device=None) -> List[Row]:
    """The ``layer_snr`` suite: the sweep for each of ``SWEEP_ARCHS`` on
    ``device`` (None: the card, raising without one)."""
    rows: List[Row] = []
    for arch in SWEEP_ARCHS:
        rows += whole_model_snr_sweep(arch, device=device)
    return rows


def site_snr_records(arch: str = "musicgen-medium", snr_t_db: float = 14.0,
                     n: int = 512) -> List[dict]:
    """Per-site SNR_T of every matmul site of ``arch`` at (a) the uniform
    min-energy design point for ``snr_t_db`` and (b) a substrate with
    MPC-style per-site B_ADC overrides (``OVERRIDE_EXTRA_BITS``), plus a
    summary record with the J/token cost of the reassignment."""
    cfg = configs.get(arch)
    shapes = per_token_matmul_shapes(cfg)
    pt = optimize(n=n, snr_t_target_db=snr_t_db)
    uniform = substrate_for_design(pt)
    overrides = {}
    for group, extra in OVERRIDE_EXTRA_BITS.items():
        pt_g = with_b_adc(pt, pt.b_adc + extra)
        overrides[group] = {"b_adc": pt_g.b_adc, "design": pt_g}
    boosted = uniform.with_overrides(overrides)

    meta = {"bench": "site_snr", "arch": arch, "substrate": boosted.name,
            "kind": pt.arch_kind, "bank_rows": n, "snr_t_target_db": snr_t_db}
    records: List[dict] = []
    for s in shapes:
        pu = uniform.design_for_site(s.name)
        po = boosted.design_for_site(s.name)
        records.append({
            **meta, "name": s.name, "K": s.k, "M": s.m,
            "b_adc_uniform": pu.b_adc, "b_adc_override": po.b_adc,
            "snr_t_uniform_db": round(pu.snr_t_db, 3),
            "snr_t_override_db": round(po.snr_t_db, 3),
        })
    e_uniform = energy_for_tokens(shapes, pt, 1)["energy_per_token_j"]
    e_boosted = substrate_energy_for_tokens(shapes, boosted,
                                            1)["energy_per_token_j"]
    boosted_sites = [r for r in records
                     if r["b_adc_override"] > r["b_adc_uniform"]]
    records.append({
        **meta, "bench": "site_snr_summary",
        "sites": len(shapes), "sites_boosted": len(boosted_sites),
        "snr_t_uniform_db": round(pt.snr_t_db, 3),
        "snr_t_boosted_min_db": round(
            min(r["snr_t_override_db"] for r in boosted_sites), 3),
        "j_per_token_uniform": e_uniform,
        "j_per_token_override": e_boosted,
        "j_per_token_ratio": round(e_boosted / e_uniform, 4),
    })
    return records


def site_snr_rows(records: List[dict]):
    """CSV rows of :func:`site_snr_records`: each site's SNR_T under the
    override map, then the J/token ratio."""
    rows = []
    for r in records:
        if r["bench"] == "site_snr_summary":
            rows.append((f"site_snr/{r['arch']}/j_per_token_ratio",
                         r["j_per_token_ratio"],
                         f"{r['sites_boosted']} of {r['sites']} sites "
                         f"boosted, min SNR_T {r['snr_t_boosted_min_db']} dB "
                         f"(uniform {r['snr_t_uniform_db']})"))
        else:
            rows.append((f"site_snr/{r['arch']}/{r['name']}",
                         r["snr_t_override_db"],
                         f"B_ADC {r['b_adc_uniform']}->{r['b_adc_override']}"
                         f" (uniform {r['snr_t_uniform_db']} dB)"))
    return rows
