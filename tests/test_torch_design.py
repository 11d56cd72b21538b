"""The port's design workflow against the JAX package, on the CPU.

``core.scaling``, ``core.design``, ``core.mapping`` and the design half of
``core.substrate`` are numpy and Python in both packages, so they must agree
exactly: integers and strings equal, floats within rel 1e-12 (the same
numpy operations in the same order; the margin covers nothing but libm).
"""
import dataclasses
import math

import numpy as np
import pytest

from repro import configs as j_configs
from repro.core import design as j_design
from repro.core import mapping as j_mapping
from repro.core import scaling as j_scaling
from repro.core import substrate as j_substrate
from repro_torch import configs as t_configs
from repro_torch import core as t_core
from repro_torch.core import design as t_design
from repro_torch.core import mapping as t_mapping
from repro_torch.core import scaling as t_scaling
from repro_torch.core import substrate as t_substrate
from torch_threads import two_threads  # noqa: F401  (autouse)

ARCH = "musicgen-medium"
REL = 1e-12


def _same(a, b, path="value"):
    """Recursive equality: floats within rel 1e-12, everything else equal."""
    if dataclasses.is_dataclass(a) and not isinstance(a, type):
        assert type(a).__name__ == type(b).__name__, path
        for f in dataclasses.fields(a):
            _same(getattr(a, f.name), getattr(b, f.name), f"{path}.{f.name}")
    elif isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    elif isinstance(a, (float, np.floating)) and not isinstance(a, bool):
        if math.isinf(a) or math.isnan(a):
            assert (a == b) or (math.isnan(a) and math.isnan(b)), path
        else:
            assert b == pytest.approx(a, rel=REL, abs=0.0), (path, a, b)
    else:
        assert a == b, (path, a, b)


@pytest.mark.parametrize("n", [64, 512, 1536, 6144])
@pytest.mark.parametrize("kinds", [("qs",), ("qr",), ("cm",),
                                   ("qs", "qr", "cm")])
def test_optimize_matches_reference(n, kinds):
    for target in (10.0, 14.0, 20.0, 26.0, 32.0):
        for objective in ("energy", "edp", "delay"):
            pj = j_design.optimize(n=n, snr_t_target_db=target, kinds=kinds,
                                   objective=objective)
            pt = t_design.optimize(n=n, snr_t_target_db=target, kinds=kinds,
                                   objective=objective)
            assert (pj is None) == (pt is None), (n, kinds, target)
            if pj is not None:
                _same(pj, pt, f"optimize({n}, {target}, {kinds}, "
                      f"{objective})")


@pytest.mark.parametrize("kind,knobs", [
    ("qs", (0.5, 0.7, 0.85)), ("qr", (1e-15, 3e-15, 9e-15)),
    ("cm", (0.55, 0.7, 0.8))])
def test_evaluate_point_and_b_adc_ladder_match_reference(kind, knobs):
    from repro.core.compute_models import TECH_65NM as J_TECH
    from repro.core.quant import UNIFORM_STATS as J_STATS
    from repro_torch.core.compute_models import TECH_65NM as T_TECH
    from repro_torch.core.quant import UNIFORM_STATS as T_STATS

    seen = 0
    for n, n_banks in ((256, 1), (512, 1), (1536, 4), (6144, 16)):
        for knob in knobs:
            args = (kind, n, n_banks, 7, 7)
            pj = j_design.evaluate_point(*args, J_STATS, J_TECH, knob, 8.0)
            pt = t_design.evaluate_point(*args, T_STATS, T_TECH, knob, 8.0)
            assert (pj is None) == (pt is None)
            if pj is None:
                continue
            seen += 1
            _same(pj, pt)
            _same(pj.arch().snr_a_db(), pt.arch().snr_a_db())
            for b in (pj.b_adc - 2, pj.b_adc, pj.b_adc + 3):
                _same(j_design.with_b_adc(pj, b), t_design.with_b_adc(pt, b))
            _same(j_design.frontier_ladder(pj, steps=4),
                  t_design.frontier_ladder(pt, steps=4))
    assert seen > 0


@pytest.mark.parametrize("smoke", [False, True])
def test_shapes_walk_workload_metrics_and_map_model(smoke):
    cj = j_configs.get_smoke(ARCH) if smoke else j_configs.get(ARCH)
    ct = t_configs.get_smoke(ARCH) if smoke else t_configs.get(ARCH)
    sj = j_mapping.per_token_matmul_shapes(cj)
    st = t_mapping.per_token_matmul_shapes(ct)
    _same(sj, st)
    triples = [(s.k, s.m, s.calls) for s in st]
    for target, kind in ((14.0, "qs"), (14.0, "qr"), (26.0, "qr"),
                         (14.0, "cm")):
        pj = j_design.optimize(n=512, snr_t_target_db=target, kinds=(kind,))
        pt = t_design.optimize(n=512, snr_t_target_db=target, kinds=(kind,))
        _same(j_design.workload_metrics(pj, triples),
              t_design.workload_metrics(pt, triples))
    for target in (14.0, 26.0):
        rj = j_mapping.map_model(sj, target)
        rt = t_mapping.map_model(st, target)
        _same(rj.layers, rt.layers)
        _same(rj.summary(), rt.summary())
        for layer_j, layer_t in zip(rj.layers, rt.layers):
            _same(layer_j.energy_per_mac_j, layer_t.energy_per_mac_j)


def test_pareto_sweep_matches_reference():
    triples = [(s.k, s.m, s.calls) for s in t_mapping.per_token_matmul_shapes(
        t_configs.get(ARCH))]
    for workload in (None, triples):
        _same(j_design.pareto_sweep(512, workload=workload),
              t_design.pareto_sweep(512, workload=workload))


def test_scaling_nodes_match_reference():
    assert t_scaling.SCALING_SEQUENCE == j_scaling.SCALING_SEQUENCE
    assert t_scaling.PAPER_SEQUENCE == j_scaling.PAPER_SEQUENCE
    for name in t_scaling.SCALING_SEQUENCE:
        _same(j_scaling.node(name), t_scaling.node(name))
        pj = j_design.optimize(n=512, snr_t_target_db=14.0,
                               tech=j_scaling.node(name))
        pt = t_design.optimize(n=512, snr_t_target_db=14.0,
                               tech=t_scaling.node(name))
        assert (pj is None) == (pt is None)
        if pj is not None:
            _same(pj, pt)


def _imc_fields(imc):
    return {f.name: getattr(imc, f.name) for f in dataclasses.fields(imc)}


@pytest.mark.parametrize("target,kind", [(14.0, "qs"), (14.0, "qr"),
                                         (14.0, "cm"), (26.0, "qr")])
def test_substrate_for_design_and_ladder_match_reference(target, kind):
    pj = j_design.optimize(n=512, snr_t_target_db=target, kinds=(kind,))
    pt = t_design.optimize(n=512, snr_t_target_db=target, kinds=(kind,))
    ladder_j = j_substrate.substrate_ladder(pj, steps=2)
    ladder_t = t_substrate.substrate_ladder(pt, steps=2)
    assert len(ladder_j) == len(ladder_t) == 3
    for sj, st in zip([j_substrate.substrate_for_design(pj)] + ladder_j,
                      [t_substrate.substrate_for_design(pt)] + ladder_t):
        assert type(sj).__name__ == type(st).__name__
        fj = _imc_fields(sj.imc)
        for name, value in _imc_fields(st.imc).items():
            _same(fj[name], value, name)
        _same(sj.design, st.design)
        for site in (None, "attn.wq", "lm_head"):
            _same(sj.design_for_site(site), st.design_for_site(site))


def test_site_overrides_bill_their_own_design():
    pt = t_core.optimize(n=512, snr_t_target_db=14.0, kinds=("qr",))
    hi = t_design.with_b_adc(pt, pt.b_adc + 2)
    sub = t_core.substrate_for_design(pt).with_overrides({"lm_head": hi})
    assert sub.design_for_site("lm_head") == hi
    assert sub.design_for_site("attn.wq") == pt
    assert sub.with_design(hi).design_for_site("mlp.wi") == hi
    assert t_core.DesignPoint is t_design.DesignPoint
    assert t_core.pareto_sweep is t_design.pareto_sweep
    assert t_core.map_model is t_mapping.map_model
