"""The port's online calibration and fault isolation against the JAX package,
on the CPU.

The detector (``runtime.drift``) keeps the reference's one-sided test and
threshold edges, and its refresh and SNR_T accounting equal the JAX
functions on the same ``Calibration``s within 1e-12.  The engine swaps a
calibration bit-exactly at chunk boundaries, shadow recording changes no
output and no host transfer, and an injected ``mlp.wi`` drift is detected,
swapped and recovered - with per-site shadow stats equal to the JAX
engine's within rtol 1e-5 and identical drift counters, drifted sites and
swaps.  The recorder's device-side maxima leave ``calibrate_model``'s frozen
calibration bit-identical.  Faults: a poison prefill fails alone, a
transient decode fault is retried exactly, a persistent one fails only the
requests in flight, and kernel launch or build failures are never retried.
The CLI with CI serve smoke 3's flags matches the JAX main.
"""
import contextlib
import io
import math

import jax
import numpy as np
import pytest
import torch

from repro import configs as j_configs
from repro.configs.base import ArchConfig as JArch
from repro.core.imc_linear import IMCConfig as JIMC
from repro.core import substrate as j_sub
from repro.launch import serve as j_serve
from repro.models import init_params as j_init_params
from repro.runtime import drift as j_drift
from repro_torch import configs as t_configs
from repro_torch.configs.base import ArchConfig as TArch
from repro_torch.convert import params_from_jax
from repro_torch.core import substrate as t_sub
from repro_torch.core.imc_linear import IMCConfig as TIMC
from repro_torch.core.substrate import Calibration, SiteStats
from repro_torch.kernels import build
from repro_torch.launch import serve as t_serve
from repro_torch.launch.serve import Engine, Request, serve
from repro_torch.models import model as t_model
from repro_torch.runtime import fault as fault_lib
from repro_torch.runtime.drift import (
    DriftConfig,
    DriftMonitor,
    DriftThresholds,
    detect_drift,
    effective_snr_t_db,
    estimated_clip_rate,
    refreshed_calibration,
    site_snr_table,
)

ARCH = "musicgen-medium"


def _cal(**sites):
    return Calibration(tuple(
        (name, SiteStats(*vals)) for name, vals in sites.items()))


FROZEN = _cal(**{"mlp.wi": (1.0, 2.0, 3.0), "attn.wq": (0.5, 1.0, 1.5),
                 "*": (1.0, 2.0, 3.0)})


# ---------------------------------------------------------------------------
# the detector
# ---------------------------------------------------------------------------


def test_one_sided_superset_test():
    below = _cal(**{"mlp.wi": (0.5, 1.0, 1.5)})
    rep = detect_drift(FROZEN, below)
    assert not rep.drifted and all(e.rel_excess == 0.0 for e in rep.entries)
    rep = detect_drift(FROZEN, _cal(**{"mlp.wi": (2.0, 2.0, 3.0)}))
    assert rep.drifted and rep.drifted_sites == ("mlp.wi",)
    (x_entry,) = [e for e in rep.entries if e.field == "x_max"]
    assert x_entry.drifted and x_entry.rel_excess == pytest.approx(1.0)
    assert not any(e.drifted for e in rep.entries if e.field != "x_max")


def test_threshold_edges_and_clip_proxy():
    thr = DriftThresholds(rel_excess=0.25, clip_rate=1.0)  # clip disabled
    assert not detect_drift(FROZEN, _cal(**{"mlp.wi": (1.25, 2.0, 3.0)}),
                            thr).drifted
    assert detect_drift(FROZEN, _cal(**{"mlp.wi": (1.3125, 2.0, 3.0)}),
                        thr).drifted
    assert estimated_clip_rate(1.0, 0.5) < estimated_clip_rate(1.0, 1.0) \
        < estimated_clip_rate(1.0, 2.0)
    assert estimated_clip_rate(1.0, 0.5) < 1e-6
    rep = detect_drift(FROZEN, _cal(**{"mlp.wi": (1.5, 2.0, 3.0)}),
                       DriftThresholds(rel_excess=10.0, clip_rate=1e-3))
    (entry,) = [e for e in rep.entries if e.drifted]
    assert entry.field == "x_max" and entry.clip_rate > 1e-3
    # an unnamed site is checked against "*"; "*" itself is skipped
    rep = detect_drift(FROZEN, _cal(**{"new.site": (3.0, 2.0, 3.0),
                                       "*": (99.0, 99.0, 99.0)}))
    assert rep.checked_sites == 1 and rep.drifted_sites == ("new.site",)
    d = detect_drift(FROZEN, _cal(**{"mlp.wi": (2.0, 2.0, 3.0)})).to_dict()
    assert d["drifted"] is True and d["drifted_sites"] == ["mlp.wi"]


def _random_cals(seed):
    """A frozen and an observed calibration in both packages' types, from
    one seeded draw (some sites drifted, one only observed, one only
    frozen)."""
    rnp = np.random.default_rng(seed)
    names = ["attn.wq", "attn.wo", "mlp.wi", "mlp.wo", "lm_head"]
    frozen = {n: rnp.uniform(0.2, 3.0, 3) for n in names[:-1]}
    frozen["*"] = np.max(list(frozen.values()), axis=0)
    observed = {n: frozen.get(n, frozen["*"]) * rnp.uniform(0.5, 2.5, 3)
                for n in names[1:]}
    observed["brand.new"] = rnp.uniform(0.2, 5.0, 3)

    def both(d):
        t = Calibration(tuple((n, SiteStats(*map(float, v)))
                              for n, v in d.items()))
        j = j_sub.Calibration(tuple((n, j_sub.SiteStats(*map(float, v)))
                                    for n, v in d.items()))
        return t, j

    return both(frozen), both(observed)


@pytest.mark.parametrize("seed", range(4))
def test_refresh_and_snr_accounting_match_reference(seed):
    (ft, fj), (ot, oj) = _random_cals(seed)
    thr = DriftThresholds(rel_excess=0.1, clip_rate=1e-2)
    rt = detect_drift(ft, ot, thr)
    rj = j_drift.detect_drift(fj, oj, j_drift.DriftThresholds(0.1, 1e-2))
    assert rt.to_dict() == rj.to_dict()
    assert rt.summary_line() == rj.summary_line()
    reft, refj = refreshed_calibration(ft, ot), j_drift.refreshed_calibration(
        fj, oj)
    assert reft.site_names() == ft.site_names() == refj.site_names()
    for (nt, st), (nj, sj) in zip(reft.sites, refj.sites):
        assert nt == nj
        for f in ("x_max", "w_max", "sigma_yo"):
            assert getattr(st, f) == pytest.approx(getattr(sj, f), rel=1e-12)
    rows_t = site_snr_table(ft, reft, ot, bx=7)
    rows_j = j_drift.site_snr_table(fj, refj, oj, bx=7)
    assert [r["site"] for r in rows_t] == [r["site"] for r in rows_j]
    for a, b in zip(rows_t, rows_j):
        for k, v in b.items():
            if isinstance(v, float):
                assert a[k] == pytest.approx(v, rel=1e-12, abs=1e-12), k
    for rng_max, obs in ((1.0, 1.0), (1.0, 2.0), (4.0, 1.0), (0.3, 7.0)):
        for bx in (4, 7, 8):
            assert effective_snr_t_db(rng_max, obs, bx) == pytest.approx(
                j_drift.effective_snr_t_db(rng_max, obs, bx), rel=1e-12)
    assert effective_snr_t_db(0.0, 1.0, 7) == -math.inf


def test_effective_snr_degrades_and_recovers():
    fresh = effective_snr_t_db(1.0, 1.0, 7)
    assert effective_snr_t_db(1.0, 2.0, 7) < fresh - 3.0
    assert effective_snr_t_db(4.0, 1.0, 7) == pytest.approx(
        fresh - 20 * np.log10(4.0), abs=0.2)
    obs = _cal(**{"mlp.wi": (2.0, 2.0, 3.0)})
    (row,) = [r for r in site_snr_table(FROZEN, refreshed_calibration(
        FROZEN, obs), obs, bx=7) if r["site"] == "mlp.wi"]
    assert row["degradation_db"] > 3.0
    assert row["recovery_gap_db"] == pytest.approx(0.0, abs=1e-9)


def test_monitor_cadence():
    mon = DriftMonitor(DriftConfig(sample_every=2, check_every=3))
    assert [mon.take_sample() for _ in range(6)] == [True, False] * 3
    assert mon.check(FROZEN) is None and mon.check(FROZEN) is None
    assert mon.checks == 0
    mon.recorder.note("mlp.wi", SiteStats(9.0, 9.0, 9.0))
    assert mon.check(FROZEN) is not None
    assert mon.checks == 1 and mon.drift_events == 1
    mon.recorder.reset()
    assert not mon.recorder.finalize().sites
    with pytest.raises(ValueError):
        DriftConfig(sample_every=0)


# ---------------------------------------------------------------------------
# the retry idiom and what counts as transient
# ---------------------------------------------------------------------------


def test_call_with_retries():
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) == 1:
            raise fault_lib.TransientDeviceError("blip")
        return "ok"

    assert fault_lib.call_with_retries(
        flaky, 1, retryable=fault_lib.is_transient_device_error) == "ok"
    assert len(calls) == 2

    def bug():
        calls.append(1)
        raise ValueError("bug")

    calls.clear()
    with pytest.raises(ValueError):
        fault_lib.call_with_retries(
            bug, 5, retryable=fault_lib.is_transient_device_error)
    assert len(calls) == 1

    def dead():
        calls.append(1)
        raise fault_lib.TransientDeviceError("dead")

    calls.clear()
    with pytest.raises(fault_lib.TransientDeviceError):
        fault_lib.call_with_retries(
            dead, 2, retryable=fault_lib.is_transient_device_error)
    assert len(calls) == 3


def test_transient_errors_exclude_kernel_faults(tmp_path, monkeypatch):
    """Transient: the port's injected device error and a CUDA out-of-memory
    error.  Not transient: a kernel wrapper's launch failure, an ``nvcc``
    failure, a device-side assert, and Python bugs."""
    is_t = fault_lib.is_transient_device_error
    assert is_t(fault_lib.TransientDeviceError("x"))
    assert is_t(torch.cuda.OutOfMemoryError("CUDA out of memory"))
    assert not is_t(ValueError("x"))
    assert not is_t(build.KernelLaunchError("paged_attention kernel launch "
                                            "failed: 1 (invalid argument)"))
    assert not is_t(RuntimeError("CUDA error: device-side assert triggered"))
    if hasattr(torch, "AcceleratorError"):
        assert not is_t(torch.AcceleratorError(
            "CUDA error: device-side assert triggered"))
    # a real nvcc failure, from a compiler that always fails
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "nvcc", lambda: "false")
    monkeypatch.delitem(build._loaded, "analytic", raising=False)
    with pytest.raises(RuntimeError, match="nvcc failed") as info:
        build.library("analytic")
    assert not is_t(info.value)


# ---------------------------------------------------------------------------
# the engine: SMOKE float32, JAX parameters carried over
# ---------------------------------------------------------------------------

_SETUPS = {}
# the reference drift tests' tiny dense model (RoPE, SwiGLU, RMSNorm)
TINY = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
            vocab_size=256, max_seq=128, flash_q_block=16, flash_kv_block=16,
            dtype="float32")


def _setup(mode, arch=ARCH):
    """(JAX cfg, port cfg, JAX params, port params) of ``arch``'s SMOKE
    config (or of ``TINY`` for ``arch="tiny"``), frozen on a reference batch
    for the IMC modes, with the JAX parameters carried over."""
    if (mode, arch) in _SETUPS:
        return _SETUPS[mode, arch]
    if arch == "tiny":
        cfg_j = JArch(name="t", family="dense", **TINY)
        cfg_t = TArch(name="t", family="dense", **TINY)
    else:
        cfg_j = j_configs.get_smoke(arch)
        cfg_t = t_configs.get_smoke(arch)
    if mode != "digital":
        kw = dict(mode=mode, bx=7, bw=7, v_wl=0.7)
        cfg_j, cfg_t = cfg_j.replace(imc=JIMC(**kw)), cfg_t.replace(
            imc=TIMC(**kw))
    params_j = j_init_params(jax.random.PRNGKey(0), cfg_j)
    params_t = params_from_jax(jax.tree_util.tree_map(np.asarray, params_j),
                               "cpu")
    if mode != "digital":
        ref = np.random.default_rng(1).integers(0, cfg_j.vocab_size, (4, 24))
        cfg_j = j_sub.calibrate_model(cfg_j, params_j, [ref])
        cfg_t = t_sub.calibrate_model(cfg_t, params_t, [ref])
    _SETUPS[mode, arch] = cfg_j, cfg_t, params_j, params_t
    return _SETUPS[mode, arch]


def _requests(mod, cfg, lens, max_new, seed=3):
    rnp = np.random.default_rng(seed)
    return [mod.Request(rid=i, prompt=rnp.integers(0, cfg.vocab_size, n),
                        max_new=max_new) for i, n in enumerate(lens)]


def _drive_chunks(engine, reqs, n_steps=2, swap_at=None, new_cal=None):
    """Admit everything, then decode fixed-size chunks, hot-swapping
    ``new_cal`` at the ``swap_at``-th chunk boundary; the token blocks."""
    pending = [Request(rid=r.rid, prompt=r.prompt, max_new=r.max_new)
               for r in reqs]
    engine.admit_pending(pending)
    assert not pending
    chunks = []
    while engine.active:
        if swap_at is not None and len(chunks) == swap_at:
            engine.swap_calibration(new_cal)
        chunks.append(engine.decode_chunk(n_steps).copy())
    return chunks


class _OldRecorder(t_sub.CalibrationRecorder):
    """The recorder as it was: three host reads per observation."""

    def observe(self, site, x, w, y=None):
        with torch.no_grad():
            y = torch.matmul(x, w) if y is None else y
            x_max = float(x.abs().max())
            w_max = float(w.abs().max())
            sigma = float(y.reshape(-1, y.shape[-1]).to(torch.float32)
                          .std(dim=-1, unbiased=False).max())
        self.note(site, SiteStats(x_max + 1e-9, w_max + 1e-9, sigma + 1e-9))


@pytest.mark.parametrize("mode", ["imc_analytic", "imc_bitserial"])
def test_device_maxima_keep_calibration_bit_identical(mode, monkeypatch):
    """Running maxima kept on the device and read once give the very
    ``Calibration`` three host reads per observation gave."""
    _, cfg, _, params = _setup(mode)
    dyn = cfg.replace(imc=t_sub.as_substrate(cfg.imc).dynamic())
    batches = [np.random.default_rng(s).integers(0, cfg.vocab_size, (3, n))
               for s, n in ((1, 24), (2, 9), (3, 17))]
    new = t_sub.calibrate_model(dyn, params, batches).imc.calibration
    monkeypatch.setattr(t_sub, "CalibrationRecorder", _OldRecorder)
    old = t_sub.calibrate_model(dyn, params, batches).imc.calibration
    assert new == old and len(new.sites) == 8


@pytest.mark.parametrize("mode", ["fakequant", "imc_analytic",
                                  "imc_bitserial"])
def test_atomic_swap_bit_exact_within_chunks(mode):
    """A value-identical swap leaves every chunk bit-identical; a refreshed
    swap leaves every chunk before it bit-identical."""
    _, cfg, _, params = _setup(mode)
    reqs = _requests(t_serve, cfg, [5, 9], 7)
    cal = cfg.imc.calibration
    base = _drive_chunks(Engine(cfg, params, batch_slots=2, cache_len=32,
                                max_chunk=4), reqs)
    same = Calibration.from_dict(cal.to_dict())
    assert same is not cal
    eng1 = Engine(cfg, params, batch_slots=2, cache_len=32, max_chunk=4)
    swapped = _drive_chunks(eng1, reqs, swap_at=1, new_cal=same)
    assert len(base) == len(swapped) == 3 and eng1.swap_count == 1
    for b, s in zip(base, swapped):
        np.testing.assert_array_equal(b, s)
    wi = cal.get("mlp.wi")
    grown = refreshed_calibration(cal, _cal(**{"mlp.wi": (
        1.5 * wi.x_max, 1.5 * wi.w_max, 1.5 * wi.sigma_yo)}))
    moved = _drive_chunks(Engine(cfg, params, batch_slots=2, cache_len=32,
                                 max_chunk=4), reqs, swap_at=2, new_cal=grown)
    for b, s in zip(base[:2], moved[:2]):
        np.testing.assert_array_equal(b, s)


def test_swap_and_monitor_guards():
    _, cfg, _, params = _setup("imc_analytic")
    eng = Engine(cfg, params, batch_slots=2, cache_len=32, max_chunk=4)
    cal = cfg.imc.calibration
    with pytest.raises(ValueError, match="site names"):
        eng.swap_calibration(Calibration(tuple(cal.sites[:-1])))
    _, dig, _, dparams = _setup("digital")
    with pytest.raises(ValueError, match="frozen"):
        Engine(dig, dparams, batch_slots=2, cache_len=32).swap_calibration(
            cal)
    with pytest.raises(ValueError, match="frozen"):
        Engine(dig, dparams, batch_slots=2, cache_len=32,
               drift_monitor=DriftMonitor())


def test_shadow_recording_is_passive():
    """Shadow-sampled chunks give the unsampled chunks' tokens bit for bit
    and the same single (slots, T) transfer per chunk; the recorder holds
    device tensors until a check reads them."""
    _, cfg, _, params = _setup("imc_analytic")
    reqs = _requests(t_serve, cfg, [5, 9], 7)
    plain = Engine(cfg, params, batch_slots=2, cache_len=32, max_chunk=4)
    base = _drive_chunks(plain, reqs)
    mon = DriftMonitor(DriftConfig(sample_every=1, check_every=1,
                                   auto_swap=False))
    shadowed = Engine(cfg, params, batch_slots=2, cache_len=32, max_chunk=4,
                      drift_monitor=mon)
    got = _drive_chunks(shadowed, reqs)
    for b, s in zip(base, got):
        np.testing.assert_array_equal(b, s)
    assert mon.samples == len(got)
    assert all(isinstance(t, torch.Tensor)
               for t in mon.recorder._dev.values())
    assert mon.recorder.finalize().sites
    assert shadowed.host_transfer_bytes == plain.host_transfer_bytes


def _scale_wi(p, s):
    if isinstance(p, dict):
        return {k: (v * s if k == "wi" else _scale_wi(v, s))
                for k, v in p.items()}
    return p


def _inject(mod, cfg, params):
    """Serve calibrated traffic, scale every mlp.wi weight 2.5x, serve more;
    the engine, its monitor and each check's (chunk, drifted sites)."""
    thr = dict(rel_excess=0.5, clip_rate=0.05)
    if mod is t_serve:
        mon = DriftMonitor(DriftConfig(sample_every=1, check_every=1,
                                       thresholds=DriftThresholds(**thr)))
    else:
        mon = j_drift.DriftMonitor(j_drift.DriftConfig(
            sample_every=1, check_every=1,
            thresholds=j_drift.DriftThresholds(**thr)))
    eng = mod.Engine(cfg, params, batch_slots=2, cache_len=32, max_chunk=4,
                     drift_monitor=mon)
    checks = []
    check = mon.check

    def logged(frozen):
        rep = check(frozen)
        if rep is not None:
            checks.append((mon.chunks_seen, rep.drifted_sites))
        return rep

    mon.check = logged
    mod.serve(eng, _requests(mod, cfg, [5, 9], 6, seed=3))
    before = mon.chunks_seen
    eng.params = _scale_wi(eng.params, 2.5)
    mod.serve(eng, _requests(mod, cfg, [5, 9], 6, seed=4))
    return eng, mon, checks, before


def test_drift_injection_detected_swapped_and_matches_reference():
    """Calibrated traffic raises no drift; the injected shift is detected
    within ``sample_every * check_every + 1`` chunks and hot-swapped, every
    request completes, drifted sites recover to within 1 dB of a fresh
    range - and the per-site shadow stats, counters, drifted sites and
    swaps equal the JAX engine's.  The reference test's tiny dense model."""
    cfg_j, cfg_t, params_j, params_t = _setup("imc_analytic", "tiny")
    eng, mon, checks, before = _inject(t_serve, cfg_t, params_t)
    assert all(not sites for chunk, sites in checks if chunk <= before)
    assert mon.drift_events >= 1 and eng.swap_count >= 1
    bound = mon.cfg.sample_every * mon.cfg.check_every + 1
    assert mon.first_drift_chunk - before <= bound
    assert all(r.error is None for r in eng.finished)
    rows = site_snr_table(cfg_t.imc.calibration, eng.calibration,
                          mon.last_observed, bx=7)
    drifted = [r for r in rows if r["x_max_observed"] > r["x_max_frozen"]]
    assert any(r["degradation_db"] > 1.0 for r in drifted)
    assert all(abs(r["recovery_gap_db"]) <= 1.0 for r in drifted)

    eng_j, mon_j, checks_j, before_j = _inject(j_serve, cfg_j, params_j)
    assert {r.rid: r.out for r in eng.finished} == {
        r.rid: r.out for r in eng_j.finished}
    assert checks == checks_j and before == before_j
    assert mon.counters() == mon_j.counters()
    assert eng.swap_count == eng_j.swap_count
    jax.effects_barrier()
    obs_t, obs_j = mon.recorder.finalize(), mon_j.recorder.finalize()
    assert obs_t.site_names() == obs_j.site_names()
    for (_, st), (_, sj) in zip(obs_t.sites, obs_j.sites):
        for f in ("x_max", "w_max", "sigma_yo"):
            assert getattr(st, f) == pytest.approx(getattr(sj, f), rel=1e-5)
    for (_, st), (_, sj) in zip(eng.calibration.sites, eng_j._calib.sites):
        for f in ("x_max", "w_max", "sigma_yo"):
            assert getattr(st, f) == pytest.approx(getattr(sj, f), rel=1e-5)


# ---------------------------------------------------------------------------
# faults
# ---------------------------------------------------------------------------


def test_poison_prefill_isolated():
    _, cfg, _, params = _setup("digital")

    def injector(phase, info):
        if phase == "prefill" and 1 in info:
            raise fault_lib.TransientDeviceError("poisoned rid 1")

    eng = Engine(cfg, params, batch_slots=4, cache_len=32, max_chunk=4,
                 failure_injector=injector)
    out = {r.rid: r for r in serve(eng, _requests(t_serve, cfg, [5, 6, 7],
                                                  4))}
    assert out[1].error is not None and out[1].error_kind == "prefill"
    for rid in (0, 2):
        assert out[rid].error is None and len(out[rid].out) == 4
    assert eng.alloc.used_count == 0 and eng.failed_requests == 1


def test_poison_warm_prefill_isolated():
    """A warm admission whose prefill keeps failing retires alone and
    releases every block it linked or allocated."""
    _, cfg, _, params = _setup("digital")
    rnp = np.random.default_rng(2)
    shared = rnp.integers(0, cfg.vocab_size, 16)
    reqs = [Request(rid=i, prompt=np.concatenate(
        [shared, rnp.integers(0, cfg.vocab_size, 3)]), max_new=3)
        for i in range(3)]

    def injector(phase, info):
        if phase == "prefill" and info == (1,):
            raise fault_lib.TransientDeviceError("poisoned warm rid 1")

    eng = Engine(cfg, params, batch_slots=1, cache_len=32, max_chunk=4,
                 prefix_cache=True, failure_injector=injector)
    out = {r.rid: r for r in serve(eng, reqs)}
    assert out[1].error_kind == "prefill" and eng.prefix_hits == 1
    assert out[0].ok and out[2].ok
    assert eng.alloc.used_count == eng.alloc.evictable_count


@pytest.mark.parametrize("mode", ["digital", "imc_bitserial"])
def test_transient_decode_error_retried_exactly(mode):
    _, cfg, _, params = _setup(mode)
    want = {r.rid: r.out for r in serve(
        Engine(cfg, params, batch_slots=2, cache_len=32, max_chunk=4),
        _requests(t_serve, cfg, [5, 9], 6))}
    hits = []

    def injector(phase, info):
        if phase == "decode" and info == 1 and not hits:
            hits.append(1)
            raise fault_lib.TransientDeviceError("blip")

    eng = Engine(cfg, params, batch_slots=2, cache_len=32, max_chunk=4,
                 failure_injector=injector)
    got = {r.rid: r.out for r in serve(eng, _requests(t_serve, cfg, [5, 9],
                                                      6))}
    assert hits and got == want and eng.decode_failures == 0


def test_retry_after_a_partly_run_chunk_is_exact(monkeypatch):
    """A fault in the middle of a chunk (after two of its steps wrote K/V):
    the re-run rewrites those positions with the same values."""
    _, cfg, _, params = _setup("digital")
    want = {r.rid: r.out for r in serve(
        Engine(cfg, params, batch_slots=2, cache_len=32, max_chunk=4),
        _requests(t_serve, cfg, [5, 9], 9))}
    real, calls = t_serve.decode_step, []

    def flaky(*a, **k):
        calls.append(1)
        if len(calls) == 7:  # the third step of the second 4-step chunk
            raise fault_lib.TransientDeviceError("mid-chunk")
        return real(*a, **k)

    monkeypatch.setattr(t_serve, "decode_step", flaky)
    eng = Engine(cfg, params, batch_slots=2, cache_len=32, max_chunk=4)
    got = {r.rid: r.out for r in serve(eng, _requests(t_serve, cfg, [5, 9],
                                                      9))}
    assert len(calls) > 7 and got == want


def test_persistent_decode_error_fails_only_inflight():
    _, cfg, _, params = _setup("digital")
    boom = {"on": True}

    def injector(phase, info):
        if phase == "decode" and boom["on"]:
            raise fault_lib.TransientDeviceError("dead lane")

    eng = Engine(cfg, params, batch_slots=2, cache_len=32, max_chunk=4,
                 failure_injector=injector)
    out = serve(eng, _requests(t_serve, cfg, [5, 9], 6))
    assert len(out) == 2 and all(r.done and r.error_kind == "decode"
                                 for r in out)
    assert eng.decode_failures >= 1 and eng.alloc.used_count == 0
    boom["on"] = False
    out2 = serve(eng, _requests(t_serve, cfg, [7], 4, seed=9))
    assert out2[-1].error is None and len(out2[-1].out) == 4


@pytest.mark.parametrize("where", ["decode", "prefill"])
def test_kernel_launch_failure_escapes_engine(where, monkeypatch):
    """A kernel wrapper's launch failure is not transient: it propagates out
    of the engine on its first occurrence, with no retry and no request
    retired (there is no fallback to catch it)."""
    _, cfg, _, params = _setup("digital")
    calls = []

    def refused(*a, **k):
        calls.append(1)
        raise build.KernelLaunchError("paged_attention kernel launch failed: "
                                      "1 (invalid argument)")

    eng = Engine(cfg, params, batch_slots=2, cache_len=32, max_chunk=4)
    if where == "decode":
        eng.admit_pending(_requests(t_serve, cfg, [5, 9], 6))
        monkeypatch.setattr(t_serve, "decode_step", refused)
        with pytest.raises(build.KernelLaunchError):
            eng.decode_chunk()
    else:
        monkeypatch.setattr(t_serve, "prefill", refused)
        with pytest.raises(build.KernelLaunchError):
            eng.admit_pending(_requests(t_serve, cfg, [5, 9], 6))
    assert len(calls) == 1
    assert eng.failed_requests == 0 and eng.decode_failures == 0


def test_nvcc_failure_escapes_engine(tmp_path, monkeypatch):
    """A kernel source that does not build propagates out of the engine."""
    _, cfg, _, params = _setup("digital")

    def unbuildable(*a, **k):
        monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
        monkeypatch.setattr(build, "nvcc", lambda: "false")
        monkeypatch.delitem(build._loaded, "paged_attention", raising=False)
        build.library("paged_attention")

    monkeypatch.setattr(t_model.tf, "apply_block_decode", unbuildable)
    eng = Engine(cfg, params, batch_slots=2, cache_len=32, max_chunk=4)
    eng.admit_pending(_requests(t_serve, cfg, [5], 6))
    with pytest.raises(RuntimeError, match="nvcc failed"):
        eng.decode_chunk()
    assert eng.decode_failures == 0


# ---------------------------------------------------------------------------
# the CLI against the JAX main: CI serve smoke 3
# ---------------------------------------------------------------------------

SMOKE3 = ["--arch", ARCH, "--smoke", "--batch", "4", "--gen", "8",
          "--requests", "6", "--prompt-lens", "5,9,32,4,17,6",
          "--imc-mode", "imc_analytic", "--imc-policy", "frozen",
          "--recalibrate", "--drift-sample-every", "1",
          "--drift-check-every", "1", "--inject-drift", "2.5@3"]


@pytest.fixture(scope="module")
def jax_smoke3():
    """CI serve smoke 3 through the JAX main once, keeping its engine and
    printed output."""
    engines = []

    class JEngine(j_serve.Engine):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.frozen0 = self._calib
            engines.append(self)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_serve, "Engine", JEngine)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            finished = j_serve.main(SMOKE3)
    return dict(finished=finished, engine=engines[-1], stdout=buf.getvalue())


def test_cli_drift_smoke_matches_reference(jax_smoke3, monkeypatch, capsys):
    ref = jax_smoke3

    def jax_params(cfg, seed=0, device=None):
        cfg_j = j_configs.get_smoke(ARCH).replace(imc=None)
        params = j_init_params(jax.random.PRNGKey(0), cfg_j)
        return params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                               device)

    monkeypatch.setattr(t_serve, "init_params", jax_params)
    rep = t_serve.main(SMOKE3 + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert {r.rid: r.out for r in rep["finished"]} == {
        r.rid: r.out for r in ref["finished"]}
    assert all(r.error is None for r in rep["finished"])
    eng_t, eng_j = rep["engine"], ref["engine"]
    assert eng_t.swap_count == eng_j.swap_count >= 1
    assert rep["monitor"].counters() == eng_j._drift.counters()
    online = [ln for ln in out.splitlines()
              if ln.startswith("online calibration:")]
    assert len(online) == 1 and online[0] in ref["stdout"]
    last_t, last_j = rep["monitor"].last_report, eng_j._drift.last_report
    assert last_t.drifted_sites == last_j.drifted_sites
    assert last_t.checked_sites == last_j.checked_sites
    assert (last_t.worst().site, last_t.worst().field) == (
        last_j.worst().site, last_j.worst().field)
    rows_j = j_drift.site_snr_table(eng_j.frozen0, eng_j._calib,
                                    eng_j._drift.last_observed, bx=7)
    assert [r["site"] for r in rep["snr_rows"]] == [r["site"] for r in rows_j]
    for a, b in zip(rep["snr_rows"], rows_j):
        for k, v in b.items():
            if k != "site":
                assert a[k] == pytest.approx(v, rel=1e-5, abs=1e-4), k
    assert "per-site SNR_T" in out
    jax.effects_barrier()
    obs_t = rep["monitor"].recorder.finalize()
    obs_j = eng_j._drift.recorder.finalize()
    assert obs_t.site_names() == obs_j.site_names()
    for (_, st), (_, sj) in zip(obs_t.sites, obs_j.sites):
        for f in ("x_max", "w_max", "sigma_yo"):
            assert getattr(st, f) == pytest.approx(getattr(sj, f), rel=1e-5)
    gaps = [r["recovery_gap_db"] for r in rep["snr_rows"]
            if r["x_max_observed"] > r["x_max_frozen"]]
    assert gaps and max(abs(g) for g in gaps) <= 1.0
