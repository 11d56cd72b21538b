"""The port's Monte Carlo validators (``repro_torch.core.mc``) against the JAX
reference (``repro.core.mc``), on the CPU.

Draw for draw: the operands and the circuit noise are drawn with
``jax.random`` on the reference's own key schedule (``empirical_snrs``'s
split, then each simulator's), handed as numpy to the reference simulator
(which redraws the same noise from the same key) and to the port's chain.
Tolerances:

  * ``y_ideal`` and ``y_pre``: allclose(rtol 1e-5, atol 1e-5 * max|y|).  The
    sums over N and the plane recombination run in XLA's order on one side
    and PyTorch's on the other (~1e-6 relative; the atol covers instances
    whose signed sum nearly cancels).
  * ``y_post``: a pre-ADC value within that rounding of an ADC edge may land
    on the other side.  At most 0.1% of the chain's ADC conversions (ens x
    Bw*Bx for QS, ens x Bw for QR, ens for CM) may flip, each such
    instance off by at most one ADC step of one plane in output units; every
    other instance is allclose as ``y_pre`` is (the recombination's order).
  * SNRs from the port's float64 running sums: within 0.02 dB of the
    reference's ``empirical_snrs`` on the same draws.

The closed-form bands are the reference tests' (tests/test_mc_validation.py)
with the port's own CPU generator; the 512-row pins are not held, since they
pin JAX's random stream.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core import archs as j_archs
from repro.core import mc as j_mc
from repro_torch.core import archs as t_archs
from repro_torch.core import mc
from torch_threads import two_threads  # noqa: F401  (autouse)

ENS = 600

# (arch class name, knobs) of the 512-row points the reference pins
POINTS = {
    "qs": ("QSArch", dict(bx=6, bw=6, v_wl=0.6)),
    "qr": ("QRArch", dict(bx=6, bw=7, c_o=3e-15)),
    "cm": ("CMArch", dict(bx=6, bw=6, v_wl=0.8)),
}


def _arch(module, kind, n):
    cls, knobs = POINTS[kind]
    return getattr(module, cls)(n=n, **knobs)


def _t(a):
    return torch.tensor(np.asarray(a))


def _reference_draws(kind, k_sim, ens, n, arch):
    """The simulator's noise as the reference draws it from ``k_sim``, as
    the port's draw tuple."""
    normal = jax.random.normal
    if kind == "qs":
        k_cur, k_pw, k_th = jax.random.split(k_sim, 3)
        return mc.QSDraws(_t(normal(k_cur, (ens, n))),
                          _t(normal(k_pw, (arch.bx, ens, n))),
                          _t(normal(k_th, (arch.bw, arch.bx, ens))))
    if kind == "qr":
        k_cap, k_th, _ = jax.random.split(k_sim, 3)
        keys = jax.random.split(k_th, arch.bw)
        th = jax.vmap(lambda k: normal(k, (ens, n)))(keys)
        return mc.QRDraws(_t(normal(k_cap, (ens, n))), _t(th))
    k_cur, k_th, k_cap = jax.random.split(k_sim, 3)
    return mc.CMDraws(_t(normal(k_cur, (ens, arch.bw, n))),
                      _t(normal(k_cap, (ens, n))), _t(normal(k_th, (ens, n))))


def _adc_step_out(kind, arch):
    """(one ADC step of the most heavily weighted plane in output units,
    ADC conversions per instance)."""
    b = arch.b_adc_min()
    if kind == "qs":
        dx = arch.stats.x_max * 2.0 ** -arch.bx
        dw = arch.stats.w_max * 2.0 ** (1 - arch.bw)
        coef = 2.0 ** (arch.bw - 1 + arch.bx - 1)
        return coef * arch.v_c_counts() / 2**b * dx * dw, arch.bw * arch.bx
    dw = arch.stats.w_max * 2.0 ** (1 - arch.bw)
    step_v = 2 * arch.v_c_volts() / 2**b
    if kind == "qr":
        return (2.0 ** (arch.bw - 1) * step_v * arch.n / arch.tech.v_dd
                * arch.stats.x_max * dw), arch.bw
    return step_v * arch.n * arch.stats.x_max / arch.qs.dv_unit * dw, 1


CHAINS = {"qs": (mc.qs_chain, j_mc.mc_qs_arch),
          "qr": (mc.qr_chain, j_mc.mc_qr_arch),
          "cm": (mc.cm_chain, j_mc.mc_cm)}


@pytest.mark.parametrize("n", [64, 512])
@pytest.mark.parametrize("kind", ["qs", "qr", "cm"])
def test_chain_replays_reference_draws(kind, n):
    key = jax.random.PRNGKey(11)
    k_ops, k_sim = jax.random.split(key)
    ja, ta = _arch(j_archs, kind, n), _arch(t_archs, kind, n)
    x, w = j_mc.sample_operands(k_ops, ENS, n, ja.stats)
    t_chain, j_sim = CHAINS[kind]
    j_post, j_pre, j_ideal = (np.asarray(a) for a in j_sim(k_sim, x, w, ja))
    ys = t_chain(_t(x), _t(w), ta, _reference_draws(kind, k_sim, ENS, n, ta))
    t_post, t_pre, t_ideal = (y.numpy() for y in ys)

    for got, want in ((t_ideal, j_ideal), (t_pre, j_pre)):
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())
    step, conversions = _adc_step_out(kind, ta)
    atol = 1e-5 * np.abs(j_post).max()
    flipped = ~np.isclose(t_post, j_post, rtol=1e-5, atol=atol)
    assert flipped.sum() <= 1e-3 * ENS * conversions, flipped.sum()
    assert np.all(np.abs(t_post - j_post) <= step * (1 + 1e-5) + atol), \
        (np.abs(t_post - j_post).max(), step)

    ref = j_mc.empirical_snrs(key, ja, j_sim, ens=ENS)
    got = mc.snrs_from_sums(mc.snr_sums(*ys), ENS)
    for name in ("snr_T_db", "snr_A_db"):
        assert abs(got[name] - ref[name]) < 0.02, (name, got, ref)


def test_adc_quantize_matches_reference():
    v = np.random.default_rng(0).uniform(-0.3, 1.3, 4096).astype(np.float32)
    want = np.asarray(j_mc.adc_quantize(v, 6, -0.1, 1.1))
    got = mc.adc_quantize(torch.tensor(v), 6, -0.1, 1.1).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dist", ["uniform", "gaussian"])
def test_sample_operands_in_range(dist):
    stats = t_archs.QSArch(n=64, bx=6, bw=6).stats
    x, w = mc.sample_operands(mc.generator(1, "cpu"), 5000, 64, stats, dist)
    assert x.shape == w.shape == (5000, 64) and x.dtype == torch.float32
    assert 0.0 <= float(x.min()) and float(x.max()) <= stats.x_max
    assert -stats.w_max <= float(w.min()) and float(w.max()) <= stats.w_max
    if dist == "uniform":
        assert abs(float(w.mean())) < 0.01
        assert abs(float(x.mean()) - stats.x_max / 2) < 0.01


@pytest.mark.parametrize("kind", ["qs", "qr", "cm"])
def test_mc_composes_draw_and_chain(kind):
    """``mc_*(gen, ...)`` is the chain on the draws ``draw_*`` takes from
    the same generator."""
    arch = _arch(t_archs, kind, 32)
    sim = {"qs": mc.mc_qs_arch, "qr": mc.mc_qr_arch, "cm": mc.mc_cm}[kind]
    draw = {"qs": mc.draw_qs, "qr": mc.draw_qr, "cm": mc.draw_cm}[kind]
    g = mc.generator(3, "cpu")
    x, w = mc.sample_operands(g, 50, 32, arch.stats)
    a = sim(mc.generator(4, "cpu"), x, w, arch)
    b = CHAINS[kind][0](x, w, arch, draw(mc.generator(4, "cpu"), 50, 32,
                                         arch))
    for u, v in zip(a, b):
        assert torch.equal(u, v)


def test_chunked_ensemble_equals_unchunked_chain(monkeypatch):
    arch = t_archs.QSArch(n=64, bx=6, bw=6, v_wl=0.8)
    ens = 500
    monkeypatch.setattr(mc, "CHUNK", ens)
    one = mc.empirical_snrs(mc.generator(5, "cpu"), arch, mc.mc_qs_arch,
                            ens=ens)
    monkeypatch.setattr(mc, "CHUNK", 4 * ens)
    big = mc.empirical_snrs(mc.generator(5, "cpu"), arch, mc.mc_qs_arch,
                            ens=ens)
    g = mc.generator(5, "cpu")
    x, w = mc.sample_operands(g, ens, 64, arch.stats)
    plain = mc.snrs_from_sums(mc.snr_sums(*mc.mc_qs_arch(g, x, w, arch)), ens)
    assert one == big == plain


def test_chunked_ensemble_is_a_function_of_seed_ens_and_chunk(monkeypatch):
    arch = t_archs.QRArch(n=64, bx=6, bw=7, c_o=3e-15)
    with monkeypatch.context() as m:
        m.setattr(mc, "CHUNK", 128)
        runs = [mc.empirical_snrs(mc.generator(6, "cpu"), arch,
                                  mc.mc_qr_arch, ens=1000) for _ in range(2)]
    assert runs[0] == runs[1]
    whole = mc.empirical_snrs(mc.generator(6, "cpu"), arch, mc.mc_qr_arch,
                              ens=1000)
    # other chunks draw other numbers: the same statistic, another sample
    assert runs[0] != whole
    assert abs(runs[0]["snr_A_db"] - whole["snr_A_db"]) < 1.0


# ---------------------------------------------------------------------------
# the reference tests' closed-form bands, with the port's generator
# ---------------------------------------------------------------------------


def _gen():
    return mc.generator(0, "cpu")


@pytest.mark.parametrize(
    "v_wl,n", [(0.8, 64), (0.8, 125), (0.7, 128), (0.7, 256), (0.6, 256)]
)
def test_qs_arch_e_vs_s(v_wl, n):
    a = t_archs.QSArch(n=n, bx=6, bw=6, v_wl=v_wl)
    r = mc.empirical_snrs(_gen(), a, mc.mc_qs_arch, ens=600)
    assert abs(r["snr_A_db"] - a.snr_A_db()) < 1.0, (r, a.snr_A_db())
    assert r["snr_T_db"] > r["snr_A_db"] - 1.2


def test_qs_arch_clipping_onset_matches():
    a = t_archs.QSArch(n=200, bx=6, bw=6, v_wl=0.8)
    r = mc.empirical_snrs(_gen(), a, mc.mc_qs_arch, ens=600)
    assert r["snr_A_db"] < 8.0 and a.snr_A_db() < 8.0


@pytest.mark.parametrize("c_o", [1e-15, 3e-15, 9e-15])
def test_qr_arch_e_vs_s(c_o):
    a = t_archs.QRArch(n=128, bx=6, bw=7, c_o=c_o)
    r = mc.empirical_snrs(_gen(), a, mc.mc_qr_arch, ens=2400)
    assert -1.0 < r["snr_A_db"] - a.snr_A_db() < 3.5, (r, a.snr_A_db())


@pytest.mark.parametrize("v_wl,bw", [(0.8, 5), (0.8, 6), (0.7, 7)])
def test_cm_e_vs_s(v_wl, bw):
    a = t_archs.CMArch(n=64, bx=6, bw=bw, v_wl=v_wl)
    r = mc.empirical_snrs(_gen(), a, mc.mc_cm, ens=2400)
    assert abs(r["snr_A_db"] - a.snr_A_db()) < 2.5, (r, a.snr_A_db())


def test_mpc_adc_close_to_pre_adc_snr():
    a = t_archs.QRArch(n=128, bx=6, bw=7, c_o=3e-15)
    r = mc.empirical_snrs(_gen(), a, mc.mc_qr_arch, ens=600)
    assert r["snr_T_db"] > r["snr_A_db"] - 1.0


def test_coarser_adc_degrades():
    a = t_archs.QRArch(n=128, bx=6, bw=7, c_o=3e-15)
    good = mc.empirical_snrs(_gen(), a, mc.mc_qr_arch, ens=400,
                             b_adc=a.b_adc_min())
    bad = mc.empirical_snrs(_gen(), a, mc.mc_qr_arch, ens=400, b_adc=3)
    assert bad["snr_T_db"] < good["snr_T_db"] - 3.0
