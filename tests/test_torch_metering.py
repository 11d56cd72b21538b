"""The port's serve-path metering against the JAX package, on the CPU.

``DPMeter`` counters and the energy rollups are host-side integers and
floats in both packages: counters must be equal, J/token, J/request and
EDP/token within rel 1e-12.  The engine integration serves the same digital
SMOKE workload (JAX parameters carried over) on both engines and compares
the meters' counters.
"""
import jax
import numpy as np
import pytest

from repro import configs as j_configs
from repro.core import design as j_design
from repro.core import substrate as j_substrate
from repro.core.mapping import MatmulShape as JShape
from repro.launch import metering as j_metering
from repro.launch import serve as j_serve
from repro.models import init_params as j_init_params
from repro_torch import configs as t_configs
from repro_torch.convert import params_from_jax
from repro_torch.core import design as t_design
from repro_torch.core import substrate as t_substrate
from repro_torch.core.mapping import MatmulShape as TShape
from repro_torch.launch import metering as t_metering
from repro_torch.launch import serve as t_serve
from torch_threads import two_threads  # noqa: F401  (autouse)

ARCH = "musicgen-medium"
SITES = [("a", 512, 4, 2), ("b", 1280, 8, 1), ("lm_head", 512, 16, 1)]


def _counters(meter):
    return {k: v for k, v in vars(meter).items()
            if k not in ("sites", "substrate")}


def _drive(meter):
    """The hand-computed sequences of the reference's metering tests, plus
    every other engine hook once."""
    meter.note_prefill(3, 8, true_lens=[5, 5, 6])
    meter.note_decode(3, 4)
    meter.note_decode(1, 2)
    meter.note_prefill(1, 16)
    meter.note_shed()
    meter.note_preemption()
    meter.note_substrate_swap()
    meter.note_swap()
    meter.note_request_failure()
    meter.note_prefix_miss()
    meter.note_prefix_admission(5, 16, 8)
    meter.note_cow_copy()
    meter.note_shadow_sample()
    meter.note_drift_report({"drifted": True, "sites": ["a"]})
    meter.note_mesh("1x4", 4, 1024)


def _meters():
    mj = j_metering.DPMeter(sites=[JShape(*s) for s in SITES])
    mt = t_metering.DPMeter(sites=[TShape(*s) for s in SITES])
    return mj, mt


def test_meter_counters_match_reference():
    mj, mt = _meters()
    assert _counters(mt) == _counters(mj)  # same keys, all zero
    _drive(mj)
    _drive(mt)
    assert _counters(mt) == _counters(mj)
    assert mt.prefill_billed_tokens == 3 * 8 + 16 + 5
    assert mt.decode_billed_tokens == 14
    for attr in ("billed_tokens", "prefill_pad_tokens"):
        assert getattr(mt, attr) == getattr(mj, attr)
    assert mt.site_triples() == mj.site_triples()
    assert mt.drift_summary() == mj.drift_summary()
    for phase in ("prefill", "decode", "total"):
        for rows in (256, 512):
            assert mt.dp_counts(phase, rows) == mj.dp_counts(phase, rows)


def _close(a, b):
    assert b == pytest.approx(a, rel=1e-12, abs=0.0)


def _same_report(rj, rt):
    for attr in ("prefill_tokens", "decode_tokens", "generated_tokens",
                 "requests"):
        assert getattr(rt, attr) == getattr(rj, attr), attr
    for attr in ("prefill_j", "decode_j", "saved_prefill_j", "total_j",
                 "j_per_token", "j_per_request", "edp_per_token",
                 "delay_per_token_s", "tok_s_compute", "j_per_token_saved"):
        _close(getattr(rj, attr), getattr(rt, attr))


@pytest.mark.parametrize("target,kind", [(14.0, "qs"), (14.0, "qr"),
                                         (14.0, "cm"), (26.0, "qr")])
def test_energy_report_matches_reference(target, kind):
    mj, mt = _meters()
    _drive(mj)
    _drive(mt)
    pj = j_design.optimize(n=512, snr_t_target_db=target, kinds=(kind,))
    pt = t_design.optimize(n=512, snr_t_target_db=target, kinds=(kind,))
    # the uniform-design rollup, the substrate rollup, and a per-site
    # override that bills the head at two more ADC bits
    _same_report(j_metering.serve_energy_report(mj, design=pj),
                 t_metering.serve_energy_report(mt, design=pt))
    sj = j_substrate.substrate_for_design(pj).with_overrides(
        {"lm_head": {"design": j_design.with_b_adc(pj, pj.b_adc + 2)}})
    st = t_substrate.substrate_for_design(pt).with_overrides(
        {"lm_head": {"design": t_design.with_b_adc(pt, pt.b_adc + 2)}})
    rj = j_metering.serve_energy_report(mj, substrate=sj,
                                        generated_tokens=40, requests=4)
    rt = t_metering.serve_energy_report(mt, substrate=st,
                                        generated_tokens=40, requests=4)
    _same_report(rj, rt)
    assert rt.summary().keys() == rj.summary().keys()
    assert t_metering.format_report([rt]) == j_metering.format_report([rj])
    sites_t = [TShape(*s) for s in SITES]
    sites_j = [JShape(*s) for s in SITES]
    for tokens in (1, 37):
        ej = j_metering.energy_for_tokens(sites_j, pj, tokens)
        et = t_metering.energy_for_tokens(sites_t, pt, tokens)
        for key in ej:
            _close(ej[key], et[key])


def test_rollup_refuses_what_the_reference_refuses():
    _, mt = _meters()
    with pytest.raises(ValueError):
        t_metering.serve_energy_report(mt)
    pt = t_design.optimize(n=512, snr_t_target_db=14.0, kinds=("qr",))
    with pytest.raises(ValueError):
        t_metering.serve_energy_report(
            mt, design=pt, substrate=t_substrate.substrate_for_design(pt))
    with pytest.raises(ValueError):
        t_metering.serve_energy_report(
            mt, substrate=t_substrate.substrate_for_design(pt).with_design(
                None))


def test_served_smoke_workload_meters_match_reference():
    """The same digital SMOKE workload (CI serve smoke 1's prompt lengths)
    through both engines: equal meter counters, and the engine stamps its
    substrate on the meter."""
    cfg_j = j_configs.get_smoke(ARCH)
    cfg_t = t_configs.get_smoke(ARCH)
    params_j = j_init_params(jax.random.PRNGKey(0), cfg_j)
    params_t = params_from_jax(jax.tree_util.tree_map(np.asarray, params_j),
                               "cpu")
    lens = [5, 9, 32, 4, 17, 6]

    def run(serve_mod, metering_mod, cfg, params):
        rnp = np.random.default_rng(0)
        reqs = [serve_mod.Request(rid=i, max_new=8,
                                  prompt=rnp.integers(0, cfg.vocab_size, n))
                for i, n in enumerate(lens)]
        meter = metering_mod.DPMeter(cfg)
        engine = serve_mod.Engine(cfg, params, 4, 48, max_chunk=8,
                                  meter=meter)
        done = serve_mod.serve(engine, reqs)
        assert meter.substrate is engine.substrate
        return meter, {r.rid: r.out for r in done}

    mj, out_j = run(j_serve, j_metering, cfg_j, params_j)
    mt, out_t = run(t_serve, t_metering, cfg_t, params_t)
    assert out_t == out_j
    assert _counters(mt) == _counters(mj)
    assert mt.prefill_billed_tokens > mt.prefill_true_tokens > 0
