"""Per-site SNR_T of a model's matmul sites under an MPC-style per-site
output-ADC override map (the substrate API at layer scale).

``site_snr_records`` is deterministic closed forms, no model execution.  The
reference's whole-model SNR sweep (``whole_model_snr_sweep``: cross-entropy
under noise injected into every layer of gemma2-9b and mamba2-2.7b) needs
``loss_fn``, which is not ported yet.
"""
from __future__ import annotations

from typing import List

from repro_torch import configs
from repro_torch.core.design import optimize, with_b_adc
from repro_torch.core.mapping import per_token_matmul_shapes
from repro_torch.core.substrate import substrate_for_design
from repro_torch.launch.metering import (
    energy_for_tokens,
    substrate_energy_for_tokens,
)

# extra output-ADC bits per site group vs the uniform design point: the
# embedding-adjacent sites (output head, attention projections feeding the
# residual stream) get a finer ADC than the FFN sites - the per-site
# precision assignment the paper's MPC criterion (eq. 15) prices per layer
OVERRIDE_EXTRA_BITS = {"lm_head": 2, "attn": 1}


def whole_model_snr_sweep(*args, **kwargs):
    raise NotImplementedError(
        "whole_model_snr_sweep is not ported to PyTorch yet: it needs "
        "loss_fn (ROADMAP: queue 1, training)")


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
