"""The port's kernel modules against the JAX reference, on the CPU.

Inputs come from numpy with a seed and go through the JAX function and its
port.  The JAX side runs its Pallas kernels as its own tests do (interpret
mode, or the pure-JAX ``_decode_jax`` walk / ``ref.py`` oracles); the port
runs its plain versions, which is what its wrappers take for CPU tensors.
The CUDA kernels themselves run only on the card: tests/test_torch_cuda.py
holds them against these plain versions there.

Tolerances:
  * ``hash_u32``: bit-equal.
  * ``counter_normal``: within 3 float32 ulp.  log and cos come from
    different libm code (<= 1 ulp each), and XLA's CPU sqrt is not correctly
    rounded (1 ulp, measured); the three compound to 3 ulp on ~0.03% of
    draws.
  * bit-serial without noise and gain: bit-exact against the JAX oracle and
    the single-bank interpret kernel; the multi-bank interpret kernel sums
    its banks in another order, so there the reference's own allclose holds.
  * bit-serial with seed and gain: at most 0.1% of elements differ, each by
    one ADC code at a rounding knife edge.
  * bit-serial at full width (musicgen-medium's 7x7 bits, 256-row banks,
    b_adc 10, K of 1536 and 6144): bit-exact without noise and gain.  With
    them, at most 6e-5 of the plane ADC conversions may flip by a code, each
    element by at most two top-plane codes.  The JAX oracle sums each
    gain-weighted plane in float32; the port sums it in float64 and rounds
    once.  JAX's rounding error moves ~3.7e-5 of the conversions across a
    code edge (measured), and an element holds n_banks * 49 of them: 1.0%
    of elements differ at K=1536 and 4.4% at K=6144.
  * paged attention: ctx allclose(rtol=1e-5, atol=1e-5); pools bit-exact
    outside garbage block 0.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import imc_mvm as j_mvm
from repro.kernels import ops as j_ops
from repro.kernels import paged_attention as j_pa
from repro.kernels import prng as j_prng
from repro.kernels import ref as j_ref
from repro_torch.kernels import imc_mvm as t_mvm
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import paged_attention as t_pa
from repro_torch.kernels import prng as t_prng
from repro_torch.kernels import ref as t_ref

SCALE = 0.25


def _np(x):
    return np.asarray(x)


# ---------------------------------------------------------------------------
# counter PRNG
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 4242, -7, 2**31 - 1])
def test_hash_u32_bit_equal(seed):
    b = np.arange(257)[:, None]
    m = np.arange(131)[None, :]
    hj = _np(j_prng.hash_u32(seed, j_prng.TAG_BITSERIAL, 5,
                             jnp.asarray(b, jnp.int32),
                             jnp.asarray(m, jnp.int32)))
    ht = t_prng.hash_u32(seed, t_prng.TAG_BITSERIAL, 5, torch.tensor(b),
                         torch.tensor(m)).numpy()
    np.testing.assert_array_equal(hj.astype(np.int64), ht)
    # the host-side integer path agrees with the tensor path
    assert t_prng.derive_seed(seed, 3, 9) == int(
        _np(j_prng.hash_u32(seed, 3, 9)))


def test_counter_normal_within_3_ulp():
    b = np.arange(400)[:, None]
    m = np.arange(300)[None, :]
    zj = _np(j_prng.counter_normal(77, j_prng.TAG_ANALYTIC,
                                   jnp.asarray(b, jnp.int32),
                                   jnp.asarray(m, jnp.int32)))
    zt = t_prng.counter_normal(77, t_prng.TAG_ANALYTIC, torch.tensor(b),
                               torch.tensor(m)).numpy()
    ulp = np.spacing(np.abs(zj).astype(np.float32))
    assert np.all(np.abs(zj - zt) <= 3 * ulp)
    assert abs(zt.mean()) < 0.01 and abs(zt.std() - 1.0) < 0.01


# ---------------------------------------------------------------------------
# bit-serial matmul
# ---------------------------------------------------------------------------

# (B, K, M, rows, bx, bw, x_signed): shapes of tests/test_kernels.py
SHAPES = [
    (4, 512, 16, 512, 6, 6, False),
    (130, 700, 257, 512, 4, 5, True),
    (1, 128, 128, 128, 8, 8, True),
    (16, 256, 64, 64, 2, 3, False),
]


def _codes(seed, b, k, m, bx, bw, x_signed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, k)).astype(np.float32)
    if not x_signed:
        x = np.abs(x)
    w = rng.normal(size=(k, m)).astype(np.float32)
    xc, _ = t_ref.quantize_codes(torch.tensor(x), bx, x_signed,
                                 float(np.abs(x).max()))
    wc, _ = t_ref.quantize_codes(torch.tensor(w), bw, True,
                                 float(np.abs(w).max()))
    xj, _ = j_ref.quantize_codes(jnp.asarray(x), bx, x_signed,
                                 float(np.abs(x).max()))
    np.testing.assert_array_equal(_np(xj), xc.numpy())
    return xc, wc


def _spec(mod, shape, **kw):
    _, _, _, rows, bx, bw, xs = shape
    return mod.BitSerialSpec(bx=bx, bw=bw, b_adc=8, rows=rows, k_h=60.0,
                             v_c=55.0, x_signed=xs, **kw)


@pytest.mark.parametrize("shape", SHAPES)
def test_bitserial_noiseless_bit_exact(shape):
    b, k, m = shape[:3]
    xc, wc = _codes(1, b, k, m, shape[4], shape[5], shape[6])
    y_t = t_mvm.imc_bitserial_matmul(xc, wc, None, _spec(t_ref, shape))
    y_ref = j_ref.imc_bitserial_ref(jnp.asarray(xc.numpy()),
                                    jnp.asarray(wc.numpy()), None,
                                    _spec(j_ref, shape))
    np.testing.assert_array_equal(y_t.numpy(), _np(y_ref))
    y_k = j_mvm.imc_bitserial_matmul(jnp.asarray(xc.numpy()),
                                     jnp.asarray(wc.numpy()), None,
                                     _spec(j_ref, shape), interpret=True)
    if -(-k // shape[3]) == 1:
        np.testing.assert_array_equal(y_t.numpy(), _np(y_k))
    else:
        np.testing.assert_allclose(y_t.numpy(), _np(y_k), rtol=1e-6,
                                   atol=1e-3)


@pytest.mark.parametrize("shape", SHAPES[:3])
def test_bitserial_seed_and_gain_flips_rare(shape):
    b, k, m = shape[:3]
    xc, wc = _codes(2, b, k, m, shape[4], shape[5], shape[6])
    gain = (1.0 + 0.1 * np.random.default_rng(3).normal(size=(k, m))
            ).astype(np.float32)
    y_t = t_mvm.imc_bitserial_matmul(xc, wc, torch.tensor(gain),
                                     _spec(t_ref, shape, sigma_noise=0.3),
                                     seed=4242)
    y_k = j_mvm.imc_bitserial_matmul(
        jnp.asarray(xc.numpy()), jnp.asarray(wc.numpy()), jnp.asarray(gain),
        _spec(j_ref, shape, sigma_noise=0.3), seed=4242, interpret=True)
    diff = np.abs(y_t.numpy() - _np(y_k))
    assert float((diff > 0).mean()) <= 1e-3
    # a flip moves one plane's ADC code: at most one step times 2^(i+j)
    step = 55.0 / 2**8 * 2.0 ** (shape[4] + shape[5])
    assert diff.max() <= step + 1e-3


# musicgen-medium's bit-serial projections at 8 slots
FULL_WIDTH = [(8, 1536, 6144), (8, 6144, 1536)]


def _full_width_specs(k, **kw):
    """The serve path's knobs for a K-row matmul, as both packages' specs."""
    from repro_torch.core.imc_linear import IMCConfig

    mc = t_ops.matmul_config_from_imc(
        IMCConfig(mode="imc_bitserial", bx=7, bw=7, v_wl=0.7), k)
    assert (mc.rows, mc.b_adc) == (256, 10)
    spec = dict(bx=7, bw=7, b_adc=mc.b_adc, rows=mc.rows, k_h=mc.k_h_counts,
                v_c=mc.v_c_counts, x_signed=True, **kw)
    return mc, t_ref.BitSerialSpec(**spec), j_ref.BitSerialSpec(**spec)


@pytest.mark.parametrize("shape", FULL_WIDTH)
def test_bitserial_full_width_noiseless_bit_exact(shape):
    b, k, m = shape
    xc, wc = _codes(11, b, k, m, 7, 7, True)
    _, spec_t, spec_j = _full_width_specs(k)
    y_t = t_ref.imc_bitserial_ref(xc, wc, None, spec_t)
    y_j = j_ref.imc_bitserial_ref(jnp.asarray(xc.numpy()),
                                  jnp.asarray(wc.numpy()), None, spec_j)
    np.testing.assert_array_equal(y_t.numpy(), _np(y_j))


def full_width_flips(shape):
    """|port - JAX| of the seeded oracles with per-cell gain at full width,
    the plane ADC conversions per element, and the resolved knobs."""
    b, k, m = shape
    xc, wc = _codes(12, b, k, m, 7, 7, True)
    mc, _, _ = _full_width_specs(k)
    _, spec_t, spec_j = _full_width_specs(
        k, sigma_noise=mc.sigma_thermal_counts)
    gain = (1.0 + mc.sigma_d * np.random.default_rng(13).normal(size=(k, m))
            ).astype(np.float32)
    y_t = t_ref.imc_bitserial_ref(xc, wc, torch.tensor(gain), spec_t,
                                  seed=4242)
    y_j = j_ref.imc_bitserial_ref(jnp.asarray(xc.numpy()),
                                  jnp.asarray(wc.numpy()), jnp.asarray(gain),
                                  spec_j, seed=4242)
    return np.abs(y_t.numpy() - _np(y_j)), -(-k // mc.rows) * 7 * 7, mc


@pytest.mark.parametrize("shape", FULL_WIDTH)
def test_bitserial_full_width_seed_and_gain_flip_rate(shape):
    diff, conversions, mc = full_width_flips(shape)
    assert float((diff > 0).mean()) <= 6e-5 * conversions
    top_code = mc.v_c_counts / 2**mc.b_adc * 2.0 ** (6 + 6)
    assert diff.max() <= 2 * top_code


def test_bitserial_noise_draws_match_oracle():
    """No gain, ADC off: the noisy plane sums agree to float tolerance (the
    draws are the same counter sites)."""
    shape = (64, 512, 128, 512, 6, 6, False)
    xc, wc = _codes(4, 64, 512, 128, 6, 6, False)
    y_t = t_ref.imc_bitserial_ref(
        xc, wc, None, _spec(t_ref, shape, sigma_noise=0.5, apply_adc=False),
        seed=777)
    y_j = j_ref.imc_bitserial_ref(
        jnp.asarray(xc.numpy()), jnp.asarray(wc.numpy()), None,
        _spec(j_ref, shape, sigma_noise=0.5, apply_adc=False), seed=777)
    np.testing.assert_allclose(y_t.numpy(), _np(y_j), rtol=1e-5, atol=1e-2)


def test_pack_weight_planes_matches_reference():
    _, wc = _codes(5, 4, 64, 24, 6, 7, True)
    gain = (1.0 + 0.05 * np.random.default_rng(6).normal(size=(64, 24))
            ).astype(np.float32)
    wp_t = t_mvm.pack_weight_planes(wc, torch.tensor(gain), 7)
    wp_j = j_mvm.pack_weight_planes(jnp.asarray(wc.numpy()),
                                    jnp.asarray(gain), 7)
    np.testing.assert_array_equal(wp_t.numpy(), _np(wp_j))


def test_analytic_ref_matches_reference():
    rng = np.random.default_rng(8)
    x = rng.normal(size=(16, 96)).astype(np.float32)
    w = rng.normal(size=(96, 40)).astype(np.float32)
    kw = dict(b_adc=6, sigma_out=2.0, y_clip=30.0)
    y_t = t_ref.imc_analytic_ref(torch.tensor(x), torch.tensor(w),
                                 t_ref.AnalyticSpec(**kw), seed=99)
    y_j = j_ref.imc_analytic_ref(jnp.asarray(x), jnp.asarray(w),
                                 j_ref.AnalyticSpec(**kw), seed=99)
    diff = np.abs(y_t.numpy() - _np(y_j))
    assert float((diff > 1e-4).mean()) <= 1e-2  # one-code MPC knife edges
    assert diff.max() <= 2 * 30.0 / 2**6 + 1e-4


@pytest.mark.parametrize("mode", ["fakequant", "imc_bitserial"])
def test_imc_matmul_matches_reference(mode):
    rng = np.random.default_rng(9)
    x = rng.normal(size=(6, 300)).astype(np.float32)
    w = rng.normal(size=(300, 20)).astype(np.float32)
    kw = dict(mode=mode, bx=7, bw=7, b_adc=9, rows=128, k_h_counts=40.0,
              v_c_counts=38.0)
    y_t = t_ops.imc_matmul(torch.tensor(x), torch.tensor(w),
                           t_ops.IMCMatmulConfig(**kw))
    y_j = j_ops.imc_matmul(jnp.asarray(x), jnp.asarray(w),
                           j_ops.IMCMatmulConfig(use_kernel=False, **kw))
    np.testing.assert_allclose(y_t.numpy(), _np(y_j), rtol=1e-6, atol=1e-6)


def test_imc_matmul_analytic_mode_waits():
    """The analytic mode runs: on CPU tensors it takes the plain version,
    the fakequant code product through the MPC ADC, and no noise without a
    seed.  (The name dates from when this mode raised while it waited for
    its kernel; it is kept so that test runs before and after pair up.)"""
    rng = np.random.default_rng(12)
    x = torch.tensor(rng.normal(size=(4, 64)).astype(np.float32))
    w = torch.tensor(rng.normal(size=(64, 8)).astype(np.float32))
    cfg = t_ops.IMCMatmulConfig(mode="imc_analytic", bx=7, bw=7, b_adc=8,
                                snr_a_db=30.0)
    y = t_ops.imc_matmul(x, w, cfg)
    fq = t_ops.imc_matmul(x, w, t_ops.IMCMatmulConfig(mode="fakequant",
                                                      bx=7, bw=7))
    assert y.shape == (4, 8) and torch.isfinite(y).all()
    assert torch.equal(y, t_ops.imc_matmul(x, w, cfg))
    step = float((y - fq).abs().max())
    assert 0 < step < 0.1 * float(fq.abs().max())


def test_bitserial_seeded_call_is_reproducible():
    """The gain and thermal draws of a seeded call are a function of the
    seed (the same die and the same noise for the same seed)."""
    rng = np.random.default_rng(10)
    x = torch.tensor(rng.normal(size=(4, 64)).astype(np.float32))
    w = torch.tensor(rng.normal(size=(64, 16)).astype(np.float32))
    cfg = t_ops.IMCMatmulConfig(bx=7, bw=7, b_adc=9, rows=64, sigma_d=0.05,
                                sigma_thermal_counts=0.4, k_h_counts=40.0,
                                v_c_counts=30.0)
    a = t_ops.imc_matmul(x, w, cfg, seed=5)
    assert torch.equal(a, t_ops.imc_matmul(x, w, cfg, seed=5))
    assert not torch.equal(a, t_ops.imc_matmul(x, w, cfg, seed=6))
    assert not torch.equal(a, t_ops.imc_matmul(x, w, cfg))


# ---------------------------------------------------------------------------
# analytic matmul
# ---------------------------------------------------------------------------


def _analytic_operands(shape):
    """Rounded normal codes as in tests/test_kernels.py, divided by the
    product's std (the sigma_yo units the kernel works in)."""
    b, k, m = shape
    rng = np.random.default_rng(sum(shape))
    xc = np.round(rng.normal(size=(b, k)) * 10).astype(np.float32)
    wc = np.round(rng.normal(size=(k, m)) * 10).astype(np.float32)
    sig = np.float32(np.std(xc.astype(np.float64) @ wc) + 1e-6)
    return xc / sig, wc


def _adc_close(y_ref, y, spec):
    """The reference's own tolerance: at most one ADC step (plus 1e-6) and
    fewer than 0.1% of outputs apart - sums in another K order may land on
    the other side of a code edge."""
    d = np.abs(np.asarray(y_ref) - np.asarray(y))
    assert d.max() <= 2 * spec.y_clip / 2**spec.b_adc + 1e-6
    assert (d > 1e-6).mean() < 1e-3


@pytest.mark.parametrize("shape", [(8, 1024, 64), (130, 700, 257),
                                   (1, 64, 1)])
def test_analytic_matmul_matches_reference(shape):
    """The port's dispatch (plain version on the CPU) against JAX's Pallas
    kernel in interpret mode and JAX's oracle, seed 99; without the ADC the
    noise alone (noisy - clean) is sigma_out times the JAX draw within 3
    float32 ulp."""
    xs, wc = _analytic_operands(shape)
    kw = dict(b_adc=8, sigma_out=0.05, y_clip=4.0)
    y_t = t_mvm.imc_analytic_matmul(torch.tensor(xs), torch.tensor(wc),
                                    t_ref.AnalyticSpec(**kw), seed=99)
    spec_j = j_ref.AnalyticSpec(**kw)
    y_k = j_mvm.imc_analytic_matmul(jnp.asarray(xs), jnp.asarray(wc), spec_j,
                                    seed=99, interpret=True)
    y_o = j_ref.imc_analytic_ref(jnp.asarray(xs), jnp.asarray(wc), spec_j,
                                 seed=99)
    _adc_close(y_k, y_t.numpy(), spec_j)
    _adc_close(y_o, y_t.numpy(), spec_j)

    raw_t = t_ref.AnalyticSpec(apply_adc=False, **kw)
    noisy = t_mvm.imc_analytic_matmul(torch.tensor(xs), torch.tensor(wc),
                                      raw_t, seed=99).numpy()
    clean = t_mvm.imc_analytic_matmul(torch.tensor(xs), torch.tensor(wc),
                                      raw_t).numpy()
    b, _, m = shape
    z_j = np.asarray(j_prng.counter_normal(
        99, j_prng.TAG_ANALYTIC, jnp.arange(b, dtype=jnp.int32)[:, None],
        jnp.arange(m, dtype=jnp.int32)[None, :]))
    s = np.float32(0.05) * z_j
    eps = np.finfo(np.float32).eps
    assert np.all(np.abs((noisy - clean) - s)
                  <= 3 * eps * (np.abs(s) + np.abs(noisy)))
    y_raw_j = j_ref.imc_analytic_ref(jnp.asarray(xs), jnp.asarray(wc),
                                     j_ref.AnalyticSpec(apply_adc=False, **kw),
                                     seed=99)
    np.testing.assert_allclose(noisy, np.asarray(y_raw_j), rtol=1e-5,
                               atol=1e-5 * float(np.abs(noisy).max()))


@pytest.mark.parametrize("x_signed", [True, False])
def test_imc_matmul_analytic_noiseless_matches_reference(x_signed):
    """``seed=None`` against JAX's ``key=None``: the same quantization, the
    same dynamic sigma_yo and MPC ADC, no noise.  One ADC step in real
    units may separate outputs at knife edges (<0.1% of them)."""
    rng = np.random.default_rng(13)
    x = rng.normal(size=(24, 300)).astype(np.float32)
    if not x_signed:
        x = np.abs(x)
    w = rng.uniform(-1, 1, size=(300, 40)).astype(np.float32)
    kw = dict(mode="imc_analytic", bx=7, bw=7, b_adc=8, snr_a_db=25.0,
              x_signed=x_signed)
    y_t = t_ops.imc_matmul(torch.tensor(x), torch.tensor(w),
                           t_ops.IMCMatmulConfig(**kw)).numpy()
    y_j = np.asarray(j_ops.imc_matmul(
        jnp.asarray(x), jnp.asarray(w),
        j_ops.IMCMatmulConfig(use_kernel=False, **kw)))
    xc_j, wc_j, dx, dw = j_ops._quantize_operands(
        jnp.asarray(x), jnp.asarray(w), j_ops.IMCMatmulConfig(**kw))
    sig = float(jnp.std(xc_j[:8] @ wc_j) + 1e-9)
    step = 2 * 4.0 / 2**8 * sig * float(dx * dw)
    d = np.abs(y_t - y_j)
    assert d.max() <= step * (1 + 1e-5)
    assert (d > 1e-5 * step).mean() < 1e-3
    # a frozen sigma_yo (code units) and ranges: the port's kernel path with
    # the same constants as JAX's
    frozen = dict(x_max=float(np.abs(x).max()), w_max=1.0, sigma_yo=30.0)
    y_t = t_ops.imc_matmul(torch.tensor(x), torch.tensor(w),
                           t_ops.IMCMatmulConfig(**kw), **frozen).numpy()
    y_j = np.asarray(j_ops.imc_matmul(
        jnp.asarray(x), jnp.asarray(w),
        j_ops.IMCMatmulConfig(use_kernel=True, interpret=True, **kw),
        **frozen))
    d = np.abs(y_t - y_j)
    step = 2 * 4.0 / 2**8 * 30.0 * float(dx * dw)
    assert d.max() <= step * (1 + 1e-5)
    assert (d > 1e-5 * step).mean() < 1e-3


def test_imc_matmul_frozen_sigma_batch_invariant():
    """Frozen ranges and sigma_yo make the public matmul independent of the
    batch composition: rows 3:5 alone equal rows 3:5 of the full batch (the
    port of tests/test_substrate_api.py's test)."""
    rng = np.random.default_rng(14)
    x = torch.tensor(rng.normal(size=(16, 96)).astype(np.float32))
    w = torch.tensor(rng.normal(size=(96, 24)).astype(np.float32))
    cfg = t_ops.IMCMatmulConfig(mode="imc_analytic", bx=7, bw=7, b_adc=8,
                                snr_a_db=25.0)
    kw = dict(x_max=4.0, w_max=float(w.abs().max()), sigma_yo=30.0)
    y_full = t_ops.imc_matmul(x, w, cfg, **kw)
    y_solo = t_ops.imc_matmul(x[3:5], w, cfg, **kw)
    assert torch.equal(y_full[3:5], y_solo)


def test_derive_config_from_arch_matches_reference():
    from repro.core.archs import QSArch as JQSArch
    from repro_torch.core.archs import QSArch as TQSArch

    for n, v_wl in ((256, 0.7), (512, 0.6), (128, 0.8)):
        cj = j_ops.derive_config_from_arch(JQSArch(n=n, bx=7, bw=7,
                                                   v_wl=v_wl), x_signed=False)
        ct = t_ops.derive_config_from_arch(TQSArch(n=n, bx=7, bw=7,
                                                   v_wl=v_wl), x_signed=False)
        for f in ct.__dataclass_fields__:
            assert getattr(ct, f) == getattr(cj, f), f


@pytest.mark.parametrize("mode", ["imc_bitserial", "imc_analytic"])
def test_ops_end_to_end_snr_tracks_analytics(mode):
    """``imc_matmul`` with a QSArch-derived config delivers about the
    analytic SNR: within 3 dB under SNR_A (the reference's test, bit-serial),
    and in the analytic mode within 3 dB under SNR_a and never above it by
    more than the quantization and ADC allow."""
    import dataclasses

    from repro_torch.core.archs import QSArch

    arch = QSArch(n=256, bx=7, bw=7, v_wl=0.7)
    cfg = dataclasses.replace(
        t_ops.derive_config_from_arch(arch, x_signed=False), mode=mode)
    rng = np.random.default_rng(5)
    x = torch.tensor(np.abs(rng.normal(size=(64, 256))).astype(np.float32))
    w = torch.tensor(rng.uniform(-1, 1, size=(256, 64)).astype(np.float32))
    y = t_ops.imc_matmul(x, w, cfg, seed=17).double()
    y0 = x.double() @ w.double()
    err = y - y0
    snr = 10 * np.log10(float(y0.var(unbiased=False))
                        / float(((err - err.mean()) ** 2).mean()))
    if mode == "imc_bitserial":
        assert snr > arch.snr_A_db() - 3.0, (snr, arch.snr_A_db())
    else:
        assert arch.snr_a_db() - 3.0 < snr < arch.snr_a_db() + 1.5, (
            snr, arch.snr_a_db())


def test_analytic_wrappers_refuse_cpu_and_other_devices():
    spec = t_ref.AnalyticSpec()
    with pytest.raises(ValueError, match="CUDA"):
        t_mvm.analytic_cuda(torch.zeros(2, 8), torch.zeros(8, 3), spec)
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="no analytic kernel"):
        t_mvm.imc_analytic_matmul(torch.zeros(2, 8, device=meta),
                                  torch.zeros(8, 3, device=meta), spec)


# ---------------------------------------------------------------------------
# paged attention
# ---------------------------------------------------------------------------


def _paged_state(seed=0, b=4, mb=6, bs=8, nb=24, hkv=2, g=2, hd=16,
                 pos=(3, 11, 29, 47)):
    """Random pools + a disjoint block table (block 0 = garbage), as numpy."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    q = rng.normal(size=(b, hkv, g, hd)).astype(f32)
    kn = rng.normal(size=(b, hkv, hd)).astype(f32)
    vn = rng.normal(size=(b, hkv, hd)).astype(f32)
    pk = rng.normal(size=(nb, bs, hkv, hd)).astype(f32)
    pv = rng.normal(size=(nb, bs, hkv, hd)).astype(f32)
    bt = np.zeros((b, mb), np.int32)
    ids = iter(range(1, nb))
    for row, p in enumerate(pos):
        for j in range(min(p // bs + 1, mb)):
            bt[row, j] = next(ids)
    return q, kn, vn, pk, pv, bt, np.asarray(pos, np.int32)


def _both(state, active=None, softcap=None):
    q, kn, vn, pk, pv, bt, pos = state
    act_j = None if active is None else jnp.asarray(active)
    ref = j_ref.paged_attention_ref(
        *map(jnp.asarray, (q, kn, vn, pk, pv, bt, pos)), act_j, scale=SCALE,
        softcap=softcap)
    walk = j_pa.paged_attention_decode(
        *map(jnp.asarray, (q, kn, vn, pk, pv, bt, pos)), act_j, scale=SCALE,
        softcap=softcap, use_pallas=False)
    act_t = None if active is None else torch.tensor(active)
    port = t_pa.paged_attention_decode(
        *(torch.tensor(a) for a in (q, kn, vn)), torch.tensor(pk),
        torch.tensor(pv), torch.tensor(bt), torch.tensor(pos), act_t,
        scale=SCALE, softcap=softcap)
    return ref, walk, port


def _assert_paged_close(ref, walk, port):
    ctx_t, pk_t, pv_t = (t.numpy() for t in port)
    for ctx_j, pk_j, pv_j in (ref, walk):
        np.testing.assert_allclose(ctx_t, _np(ctx_j), rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(pk_t[1:], _np(pk_j)[1:])
        np.testing.assert_array_equal(pv_t[1:], _np(pv_j)[1:])


@pytest.mark.parametrize("softcap", [None, 30.0])
@pytest.mark.parametrize("g", [1, 2])
def test_paged_attention_matches_reference(softcap, g):
    state = _paged_state(g=g)
    _assert_paged_close(*_both(state, np.array([True, True, False, True]),
                               softcap))


def test_paged_attention_inactive_row_attends_stale_value():
    state = _paged_state(seed=6, b=2, mb=3, bs=4, nb=8, hkv=2, g=1, hd=8,
                         pos=(5, 6))
    ref, walk, port = _both(state, np.array([True, False]))
    _assert_paged_close(ref, walk, port)
    _, _, _, pk, _, bt, pos = state
    tail = int(bt[1, pos[1] // 4])
    np.testing.assert_array_equal(port[1][tail].numpy(), pk[tail])


def test_paged_attention_overrun_row_writes_garbage_block():
    bs, mb = 4, 3
    state = _paged_state(seed=5, b=2, mb=mb, bs=bs, nb=8, hkv=2, g=1, hd=8,
                         pos=(mb * bs, 5))
    ref, walk, port = _both(state)
    _assert_paged_close(ref, walk, port)
    _, kn, _, pk, _, bt, pos = state
    for blk in bt[0]:
        if blk:
            np.testing.assert_array_equal(port[1][blk].numpy(), pk[blk])
    tail = int(bt[1, pos[1] // bs])
    np.testing.assert_array_equal(port[1][tail, pos[1] % bs].numpy(), kn[1])


def test_paged_attention_per_step_across_block_boundary():
    bs, nb, hkv, g, hd = 4, 10, 2, 1, 8
    rng = np.random.default_rng(3)
    pk = rng.normal(size=(nb, bs, hkv, hd)).astype(np.float32)
    pv = rng.normal(size=(nb, bs, hkv, hd)).astype(np.float32)
    bt = np.asarray([[1, 2, 3, 0]], np.int32)
    pk_j, pv_j = jnp.asarray(pk), jnp.asarray(pv)
    pk_t, pv_t = torch.tensor(pk), torch.tensor(pv)
    for pos in range(bs - 2, bs + 3):
        q = rng.normal(size=(1, hkv, g, hd)).astype(np.float32)
        kn = rng.normal(size=(1, hkv, hd)).astype(np.float32)
        vn = rng.normal(size=(1, hkv, hd)).astype(np.float32)
        p = np.asarray([pos], np.int32)
        ctx_j, pk_j, pv_j = j_ref.paged_attention_ref(
            jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), pk_j, pv_j,
            jnp.asarray(bt), jnp.asarray(p), None, scale=SCALE)
        ctx_t, pk_t, pv_t = t_pa.paged_attention_decode(
            torch.tensor(q), torch.tensor(kn), torch.tensor(vn), pk_t, pv_t,
            torch.tensor(bt), torch.tensor(p), None, scale=SCALE)
        np.testing.assert_allclose(ctx_t.numpy(), _np(ctx_j), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_array_equal(pk_t.numpy()[1:], _np(pk_j)[1:])
        np.testing.assert_array_equal(pv_t.numpy()[1:], _np(pv_j)[1:])


def test_gather_version_matches_reference():
    state = _paged_state(seed=2)
    active = np.array([True, False, True, True])
    ref = j_ref.paged_attention_ref(*map(jnp.asarray, state),
                                    jnp.asarray(active), scale=SCALE)
    got = t_ref.paged_attention_ref(*(torch.tensor(a) for a in state),
                                    torch.tensor(active), scale=SCALE)
    np.testing.assert_allclose(got[0].numpy(), _np(ref[0]), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(got[1].numpy()[1:], _np(ref[1])[1:])


def test_write_routing_contract():
    bt = torch.tensor([[3, 4, 0], [5, 6, 7]], dtype=torch.int32)
    dest, off = t_pa.write_routing(bt, torch.tensor([9, 27]), 8)
    assert dest.tolist() == [4, 0]  # row 1 overran 3 blocks * 8
    assert off.tolist() == [1, 3]
    dest, _ = t_pa.write_routing(bt, torch.tensor([9, 9]), 8,
                                 torch.tensor([False, True]))
    assert dest.tolist() == [0, 6]
    dj, oj = j_pa.write_routing(jnp.asarray(bt.numpy()),
                                jnp.asarray([9, 27], jnp.int32), 8, None)
    assert _np(dj).tolist() == [4, 0] and _np(oj).tolist() == [1, 3]


# ---------------------------------------------------------------------------
# the CUDA wrappers never fall back
# ---------------------------------------------------------------------------


def test_cuda_wrappers_refuse_cpu_tensors():
    q, kn, vn, pk, pv, bt, pos = (torch.tensor(a) for a in _paged_state())
    with pytest.raises(ValueError, match="CUDA"):
        t_pa.paged_attention_cuda(q, kn, vn, pk, pv, bt, pos,
                                  torch.ones(4, dtype=torch.int32),
                                  scale=SCALE)
    spec = t_ref.BitSerialSpec(bx=6, bw=6, rows=64)
    with pytest.raises(ValueError, match="CUDA"):
        t_mvm.bitserial_cuda(torch.zeros(2, 64), torch.zeros(64, 8), None,
                             spec)


def test_dispatch_raises_on_other_devices():
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="no bit-serial kernel"):
        t_mvm.imc_bitserial_matmul(torch.zeros(2, 8, device=meta),
                                   torch.zeros(8, 3, device=meta), None,
                                   t_ref.BitSerialSpec())
    q, kn, vn, pk, pv, bt, pos = (torch.tensor(a).to(meta)
                                  for a in _paged_state())
    with pytest.raises(ValueError, match="no paged-attention kernel"):
        t_pa.paged_attention_decode(q, kn, vn, pk, pv, bt, pos, scale=SCALE)


if __name__ == "__main__":
    # PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_kernels.py
    # prints the full-width flip rates of the port's oracle against JAX's
    for shape in FULL_WIDTH:
        diff, conversions, _ = full_width_flips(shape)
        frac = float((diff > 0).mean())
        print(f"{'x'.join(map(str, shape))}: {frac:.4%} of elements differ, "
              f"{frac / conversions:.3e} per plane ADC conversion "
              f"({conversions} per element)")
