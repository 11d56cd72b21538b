"""The port's kernel modules against the JAX reference, on the CPU.

Inputs come from numpy with a seed and go through the JAX function and its
port.  The JAX side runs its Pallas kernels as its own tests do (interpret
mode, or the pure-JAX ``_decode_jax`` walk / ``ref.py`` oracles); the port
runs its plain versions, which is what its wrappers take for CPU tensors.
The CUDA kernels themselves run only on the card: tests/test_torch_cuda.py
holds them against these plain versions there.

Tolerances:
  * ``hash_u32``: bit-equal.
  * ``counter_normal``: |dz| <= 3 ulp(r) + ulp(z), the Box-Muller error
    model (log and cos come from different libm code, XLA's CPU sqrt is not
    correctly rounded; derived in the test).
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
    """Box-Muller z = r cos(theta), r = sqrt(-2 log u1), theta = 2 pi u2,
    held to the formula's own error model rather than to ulps of z: near the
    zeros of cos, z is small while the absolute error of cos(theta) scales
    with r, so ulp(z) is the wrong unit there (the old bound, 3 ulp(z), sat
    exactly on the measured maximum).

    Both packages compute the same theta (one float32 product) and u1, then
    log, sqrt and cos from different code.  Their r can differ by log's
    ulp, halved by the sqrt (<= 1 ulp(r)), plus XLA's sqrt, which is not
    correctly rounded (<= 1 ulp(r)); their cos(theta) by <= 2^-24 absolute,
    which r scales to < 1 ulp(r) (r 2^-24 < ulp(r)); the product z is
    rounded once on each side (<= ulp(z) together).  So

        |z_jax - z_port| <= c ulp(r) + ulp(z),  c = 3.

    Measured on these 120000 draws: the largest error is 2.0 ulp(r), 0.5 of
    the bound (0.67 of it at c = 2, exactly it at c = 1), so c = 3 leaves one
    ulp(r) of margin for another libm's log or cos.

    The port's first call in the process is the one held: under a loaded
    CPU it used to compute one torch thread's chunk with MKL's
    low-accuracy log (r off by up to 737 ulp(r); ``prng._vml_ready``)."""
    b = np.arange(400)[:, None]
    m = np.arange(300)[None, :]
    zj = _np(j_prng.counter_normal(77, j_prng.TAG_ANALYTIC,
                                   jnp.asarray(b, jnp.int32),
                                   jnp.asarray(m, jnp.int32)))
    zt = t_prng.counter_normal(77, t_prng.TAG_ANALYTIC, torch.tensor(b),
                               torch.tensor(m)).numpy()
    # r of every draw, from the shared hash bits, in float64
    u1 = t_prng.uniform_from_bits(
        t_prng.hash_u32(77, t_prng.TAG_ANALYTIC, torch.tensor(b),
                        torch.tensor(m), 1), open_zero=True).double().numpy()
    r = np.sqrt(-2.0 * np.log(u1))
    ulp_r = np.spacing(r.astype(np.float32)).astype(np.float64)
    ulp_z = np.spacing(np.abs(zj).astype(np.float32)).astype(np.float64)
    err = np.abs(zj.astype(np.float64) - zt.astype(np.float64))
    assert err.shape == (400, 300)
    assert np.all(err <= 3.0 * ulp_r + ulp_z)
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


@pytest.mark.parametrize("k", [1536, 6144])
def test_bitserial_gain_plane_sums_exact_in_any_order(k):
    """The premise of the CUDA kernel's FP64 tensor-core route: at the serve
    path's knobs (sigma_d, 256-row banks) every gain-weighted plane count of
    the plain version's formulation is exact in float64, so row order,
    reverse order and the MMA's grouping (16- and 32-row partial sums, then
    in order) give the same bits as the plain version's product, also for
    a bank of 200 rows (not a multiple of 32)."""
    mc, spec, _ = _full_width_specs(k)
    b, m, rows = 4, 32, spec.rows
    xc, wc = _codes(14, b, k, m, 7, 7, True)
    gain = torch.tensor((1.0 + mc.sigma_d * np.random.default_rng(15).normal(
        size=(k, m))).astype(np.float32))
    for lo, hi in ((0, rows), (k - rows, k), (rows, rows + 200)):
        for i in range(7):
            wp = (t_ref.unpack_plane(wc[lo:hi], i, 7, signed=True)
                  * gain[lo:hi]).double()
            for j in range(7):
                xp = t_ref.unpack_plane(xc[:, lo:hi], j, 7,
                                        signed=True).double()
                terms = xp[:, :, None] * wp[None]  # (B, rows, M), exact
                in_order = terms.cumsum(1)[:, -1]
                assert torch.equal(terms.flip(1).cumsum(1)[:, -1], in_order)
                for step in (16, 32):
                    pad = -terms.shape[1] % step
                    parts = torch.nn.functional.pad(terms, (0, 0, 0, pad))
                    parts = parts.reshape(b, -1, step, m).sum(2)
                    assert torch.equal(parts.cumsum(1)[:, -1], in_order)
                assert torch.equal(xp @ wp, in_order)


@pytest.mark.parametrize("shape", SHAPES + [
    (8, 1536, 320, 256, 7, 7, True),   # already in the kernel's layout
    (3, 300, 13, 100, 7, 7, True),     # banks of 100 rows, 13 columns
    (5, 600, 24, 257, 6, 7, False),    # banks of 257 rows, the last of 86
])
@pytest.mark.parametrize("noisy", [False, True])
def test_bitserial_kernel_layout_keeps_the_result(shape, noisy):
    """``kernel_layout`` pads banks to 16-row steps and columns to 8-column
    tiles; the plain version on the padded operands (banks of the padded
    height) gives, in its first M columns, the unpadded result bit for bit,
    noise sites included.  Operands already in the layout stay as they
    are."""
    import dataclasses

    b, k, m, rows = shape[:4]
    xc, wc = _codes(16, b, k, m, shape[4], shape[5], shape[6])
    gain = seed = None
    if noisy:
        gain = torch.tensor((1.0 + 0.1 * np.random.default_rng(17).normal(
            size=(k, m))).astype(np.float32))
        seed = 4242
    spec = _spec(t_ref, shape, sigma_noise=0.3 if noisy else 0.0)
    xp, wp, gp, rows_p = t_mvm.kernel_layout(xc, wc, gain, rows)
    assert rows_p % 16 == 0 and xp.shape[1] % 16 == 0
    assert xp.shape[1] == wp.shape[0] and wp.shape[1] % 8 == 0
    assert xp.shape[1] >= k and -(-xp.shape[1] // rows_p) == -(-k // rows)
    if rows % 16 == 0 and k % 16 == 0 and m % 8 == 0:
        assert xp is xc and wp is wc and gp is gain
    y = t_ref.imc_bitserial_ref(xc, wc, gain, spec, seed=seed)
    y_pad = t_ref.imc_bitserial_ref(
        xp, wp, gp, dataclasses.replace(spec, rows=rows_p), seed=seed)
    assert torch.equal(y_pad[:, :m], y)


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


# the float analytic kernel's arithmetic (csrc/analytic.cu): each operand
# split into two TF32 limbs, x_lo w_hi + x_hi w_lo + x_hi w_hi on the tensor
# cores


def _tf32_rna(v):
    """``cvt.rna.tf32.f32`` in plain torch: float32 rounded to TF32's 10
    mantissa bits, half away from zero (half a TF32 ulp added to the
    magnitude bits, the 13 bits below cleared)."""
    bits = v.to(torch.float32).view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_split(v):
    hi = _tf32_rna(v)
    return hi, _tf32_rna(v - hi)


def _is_tf32(v):
    return bool(((v.view(torch.int32) & 0x1FFF) == 0).all())


def test_tf32_split_of_codes_within_2_11_has_no_lo_limb():
    """Integer codes with |w| <= 2^11 (every code of at most 12 bits, so
    every billed design point's) are one TF32 limb: the kernel skips x_hi
    w_lo on them."""
    w = torch.arange(-2**11, 2**11 + 1, dtype=torch.float32)
    hi, lo = _tf32_split(w)
    assert torch.equal(hi, w) and not bool(lo.any())
    assert _is_tf32(w)
    assert not _is_tf32(torch.tensor([2.0**11 + 1]))


@pytest.mark.parametrize("bits", [12, 13, 14, 15, 16])
def test_tf32_split_of_wide_codes_is_exact_in_two_limbs(bits):
    """Signed codes of 12 to 16 bits are hi + lo exactly, both TF32."""
    w = torch.arange(-2 ** (bits - 1), 2 ** (bits - 1), dtype=torch.float32)
    hi, lo = _tf32_split(w)
    assert _is_tf32(hi) and _is_tf32(lo)
    assert torch.equal(hi.double() + lo.double(), w.double())
    assert bool(lo.any()) == (bits > 12)


def _design_operands(shape, bx, bw):
    """Design-point operands from a numpy seed: unsigned ``bx``-bit codes of
    uniform activations over sigma_yo (the std of the first 8 rows' code
    product), signed ``bw``-bit codes of uniform weights."""
    b, k, m = shape
    rng = np.random.default_rng(sum(shape) + bw)
    xc = np.clip(np.round(rng.uniform(size=(b, k)) * 2.0**bx), 0,
                 2.0**bx - 1)
    wc = np.clip(np.round(rng.uniform(-1, 1, size=(k, m)) * 2.0 ** (bw - 1)),
                 -(2.0 ** (bw - 1)), 2.0 ** (bw - 1) - 1)
    sig = np.float32(np.std(xc[:8] @ wc) + 1e-9)
    return (xc.astype(np.float32) / sig), wc.astype(np.float32)


def _split_tf32_product(x, w):
    """The kernel's product: x_lo w_hi + x_hi w_lo + x_hi w_hi of the TF32
    limbs (x_lo w_lo dropped), each limb product exact in float64, rounded
    once to float32."""
    xh, xl = _tf32_split(x)
    wh, wl = _tf32_split(w)
    y = (xl.double() @ wh.double() + xh.double() @ wl.double()
         + xh.double() @ wh.double())
    return y.to(torch.float32)


@pytest.mark.parametrize("bw", ["design", 16])
@pytest.mark.parametrize("shape", [(8, 1536, 64), (64, 384, 96)])
def test_split_tf32_product_within_phase3_tolerance(shape, bw):
    """The emulated three-product sum on seeded operands of the QR 26 dB
    design point (its bx-bit codes, its bw-bit weight codes or 16-bit ones,
    two limbs), through the plain epilogue (noise seed 99, the design's
    ADC), against ``ref.imc_analytic_ref`` and JAX's Pallas kernel in
    interpret mode under phase 3's tolerance: at most 0.1% of outputs one
    ADC step apart; without the ADC allclose(rtol 1e-5, atol 1e-5 *
    max|y|)."""
    from repro_torch.core.design import optimize

    pt = optimize(n=512, snr_t_target_db=26.0, kinds=("qr",))
    xs, wc = _design_operands(shape, pt.bx, pt.bw if bw == "design" else bw)
    kw = dict(b_adc=pt.b_adc, sigma_out=10.0 ** (-pt.snr_a_db / 20.0),
              y_clip=4.0)
    spec, raw = t_ref.AnalyticSpec(**kw), t_ref.AnalyticSpec(
        apply_adc=False, **kw)
    x_t, w_t = torch.tensor(xs), torch.tensor(wc)
    b, _, m = shape
    y = _split_tf32_product(x_t, w_t) + spec.sigma_out * \
        t_ref.analytic_output_noise(99, b, m)
    y_raw = y.numpy()
    y_adc = t_ref.mpc_adc(y, spec.b_adc, spec.y_clip).numpy()
    want_raw = t_ref.imc_analytic_ref(x_t, w_t, raw, seed=99).numpy()
    np.testing.assert_allclose(y_raw, want_raw, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want_raw).max()))
    _adc_close(t_ref.imc_analytic_ref(x_t, w_t, spec, seed=99).numpy(),
               y_adc, spec)
    y_j = j_mvm.imc_analytic_matmul(jnp.asarray(xs), jnp.asarray(wc),
                                    j_ref.AnalyticSpec(**kw), seed=99,
                                    interpret=True)
    _adc_close(np.asarray(y_j), y_adc, spec)


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


def test_colliding_idle_rows_match_reference():
    """An engine's idle rows: three slots never admitted (empty tables: all
    write block 0 at offset 0 and read it back) and a retired slot whose
    stale table is a live slot's.  The highest slot's row lands where
    several meet (``scatter_new_rows``), as in the reference's gather and
    Pallas versions: every row's output and the whole pools, block 0
    included, equal theirs."""
    q, kn, vn, pk, pv, bt, pos = _paged_state(seed=4, b=6,
                                              pos=(3, 11, 0, 0, 0, 11))
    bt[2:5] = 0
    bt[5] = bt[1]
    active = np.array([True, True, False, False, False, False])
    state = (q, kn, vn, pk, pv, bt, pos)
    got = t_pa.decode_plain(*(torch.tensor(a) for a in state),
                            torch.tensor(active), scale=SCALE)
    gather = t_ref.paged_attention_ref(*(torch.tensor(a) for a in state),
                                       torch.tensor(active), scale=SCALE)
    assert np.array_equal(got[1][0, 0].numpy(), kn[4])
    for ref in (j_ref.paged_attention_ref(*map(jnp.asarray, state),
                                          jnp.asarray(active), scale=SCALE),
                j_pa.paged_attention_decode(*map(jnp.asarray, state),
                                            jnp.asarray(active), scale=SCALE),
                gather):
        np.testing.assert_allclose(got[0].numpy(), _np(ref[0]), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_array_equal(got[1].numpy(), _np(ref[1]))
        np.testing.assert_array_equal(got[2].numpy(), _np(ref[2]))


# ---------------------------------------------------------------------------
# the analytic codes route (int8 kernel on the card)
# ---------------------------------------------------------------------------


def _quantized(b, k, m, bx, bw, x_signed):
    """Codes as ``ops.imc_matmul`` makes them, and its dynamic sigma_yo."""
    rng = np.random.default_rng(b + k + m + bx)
    x = rng.normal(size=(b, k)).astype(np.float32)
    if not x_signed:
        x = np.abs(x)
    w = rng.normal(size=(k, m)).astype(np.float32)
    xc, _ = t_ref.quantize_codes(torch.tensor(x), bx, x_signed,
                                 torch.tensor(np.abs(x).max()))
    wc, _ = t_ref.quantize_codes(torch.tensor(w), bw, True,
                                 torch.tensor(np.abs(w).max()))
    return xc, wc, (xc[:8] @ wc).std(unbiased=False) + 1e-9


@pytest.mark.parametrize("case", [(8, 96, 40, 8, 8, False),
                                  (16, 700, 33, 6, 6, True),
                                  (5, 64, 8, 8, 8, True),
                                  (24, 300, 40, 7, 7, False)])
@pytest.mark.parametrize("seed", [None, 99])
def test_codes_route_plain_matches_reference_bit_for_bit(case, seed):
    """The codes route's plain version (what a CPU tensor takes) equals the
    JAX Pallas kernel in interpret mode and the JAX oracle fed the same
    codes over sigma_yo, bit for bit, with and without noise."""
    b, k, m, bx, bw, xs = case
    xc, wc, sig = _quantized(b, k, m, bx, bw, xs)
    spec = t_ref.AnalyticSpec(b_adc=8, sigma_out=0.05, y_clip=4.0)
    y_t = t_mvm.imc_analytic_codes_matmul(xc, wc, sig, spec, bx=bx, bw=bw,
                                          x_signed=xs, seed=seed).numpy()
    xs_j = jnp.asarray(t_ref.true_div(xc, sig).numpy())
    spec_j = j_ref.AnalyticSpec(b_adc=8, sigma_out=0.05, y_clip=4.0)
    y_o = j_ref.imc_analytic_ref(xs_j, jnp.asarray(wc.numpy()), spec_j,
                                 seed=seed)
    y_k = j_mvm.imc_analytic_matmul(xs_j, jnp.asarray(wc.numpy()), spec_j,
                                    seed=seed, interpret=True)
    np.testing.assert_array_equal(y_t, _np(y_o))
    np.testing.assert_array_equal(y_t, _np(y_k))


def test_int8_route_fits_by_width_and_k():
    """8-bit codes fit while a K-term sum of the largest products stays in
    int32: 255 * 128 * K for unsigned 8-bit activations, 128 * 128 * K for
    signed ones; wider codes never fit."""
    fits = t_mvm.int8_route_fits
    assert fits(8, 8, False, 65793) and not fits(8, 8, False, 65794)
    assert fits(8, 8, True, 131071) and not fits(8, 8, True, 131072)
    assert fits(6, 6, False, 6144) and fits(1, 1, True, 1)
    for bx, bw in ((9, 8), (8, 9), (10, 8), (16, 16), (0, 8)):
        assert not fits(bx, bw, True, 16)


def test_codes_route_raises_outside_int8():
    spec = t_ref.AnalyticSpec()
    xc, wc, sig = _quantized(2, 32, 4, 8, 8, False)
    with pytest.raises(ValueError, match="at most 8 bits"):
        t_mvm.imc_analytic_codes_matmul(xc, wc, sig, spec, bx=10, bw=8,
                                        x_signed=False)
    with pytest.raises(ValueError, match="at most 8 bits"):
        t_mvm.imc_analytic_codes_matmul(xc, wc, sig, spec, bx=8, bw=9,
                                        x_signed=False)
    k = 65794
    with pytest.raises(ValueError, match="overflow int32"):
        t_mvm.imc_analytic_codes_matmul(torch.zeros(1, k), torch.zeros(k, 1),
                                        1.0, spec, bx=8, bw=8, x_signed=False)
    with pytest.raises(ValueError, match="CUDA"):
        t_mvm.analytic_int8_cuda(torch.zeros(2, 32, dtype=torch.uint8),
                                 torch.zeros(4, 32, dtype=torch.int8),
                                 torch.ones(1), spec)
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="no analytic int8 kernel"):
        t_mvm.imc_analytic_codes_matmul(torch.zeros(2, 8, device=meta),
                                        torch.zeros(8, 3, device=meta), 1.0,
                                        spec, bx=8, bw=8, x_signed=False)


@pytest.mark.parametrize("bits,route", [((8, 8), "codes"), ((6, 6), "codes"),
                                        ((10, 8), "float"),
                                        ((8, 12), "float")])
def test_imc_matmul_picks_the_analytic_route_by_width(monkeypatch, bits,
                                                      route):
    """``ops.imc_matmul`` sends codes of at most 8 bits to the codes route
    and wider ones to the float32 kernel's; on the CPU both give the same
    plain output, equal to the pre-route computation."""
    calls = []
    for name in ("imc_analytic_codes_matmul", "imc_analytic_matmul"):
        fn = getattr(t_mvm, name)
        monkeypatch.setattr(t_mvm, name, lambda *a, _fn=fn, _n=name, **k: (
            calls.append(_n), _fn(*a, **k))[1])
    rng = np.random.default_rng(21)
    x = torch.tensor(np.abs(rng.normal(size=(12, 200))).astype(np.float32))
    w = torch.tensor(rng.uniform(-1, 1, size=(200, 24)).astype(np.float32))
    bx, bw = bits
    cfg = t_ops.IMCMatmulConfig(mode="imc_analytic", bx=bx, bw=bw, b_adc=8,
                                snr_a_db=25.0, x_signed=False)
    y = t_ops.imc_matmul(x, w, cfg, seed=3)
    assert calls == ["imc_analytic_codes_matmul" if route == "codes"
                     else "imc_analytic_matmul"]
    xc, dx = t_ref.quantize_codes(x, bx, False, x.abs().max() + 1e-9)
    wc, dw = t_ref.quantize_codes(w, bw, True, w.abs().max() + 1e-9)
    sig = (xc[:8] @ wc).std(unbiased=False) + 1e-9
    spec = t_ref.AnalyticSpec(b_adc=8, sigma_out=10.0 ** (-25.0 / 20.0),
                              y_clip=4.0)
    y0 = t_ref.imc_analytic_ref(t_ref.true_div(xc, sig), wc, spec, seed=3)
    assert torch.equal(y, y0 * sig * (dx * dw))


@pytest.mark.parametrize("shape", [(1, 1536, 1536), (8, 6144, 1536),
                                   (16, 1536, 2048), (17, 720, 1000),
                                   (512, 1536, 6144), (512, 1536, 1536),
                                   (3, 100, 7)])
def test_int8_tile_fills_the_sms(shape):
    """The int8 kernel's 64 x N output tiles: N = 128 only where that still
    gives a CTA per SM, else 64."""
    b, _, m = shape
    n_tile = t_mvm.int8_tile(b, m)
    assert n_tile in (64, 128)
    assert (n_tile == 128) == (-(-b // 64) * -(-m // 128)
                               >= t_mvm.build.SMS)
    assert t_mvm.int8_tile(512, 6144) == 128  # 8 x 48 tiles
    assert t_mvm.int8_tile(512, 1536) == 64   # 8 x 12 would leave SMs idle


@pytest.mark.parametrize("bad", ["x_over", "x_signed_under", "w_over",
                                 "w_under"])
def test_codes_route_raises_on_a_code_outside_its_width(bad):
    """A code one past its width raises (the CPU raises at once; the card
    asserts on the device, see tests/test_torch_cuda.py), where the codes
    one inside it pass."""
    spec = t_ref.AnalyticSpec()
    bx, bw = 6, 7
    x_signed = bad == "x_signed_under"
    x_lo, x_hi = (-32, 31) if x_signed else (0, 63)
    xc = torch.tensor([[x_lo, x_hi, 1.0, 0.0]] * 2)
    wc = torch.tensor([[-64.0, 63.0, 0.0]] * 4)
    kw = dict(bx=bx, bw=bw, x_signed=x_signed)
    assert torch.isfinite(t_mvm.imc_analytic_codes_matmul(
        xc, wc, 100.0, spec, **kw)).all()
    if bad == "x_over":
        xc[1, 1] = x_hi + 1
    elif bad == "x_signed_under":
        xc[0, 0] = x_lo - 1
    elif bad == "w_over":
        wc[2, 1] = 64.0
    else:
        wc[3, 0] = -65.0
    which = "activation" if bad.startswith("x") else "weight"
    with pytest.raises(RuntimeError, match=f"{which} codes outside"):
        t_mvm.imc_analytic_codes_matmul(xc, wc, 100.0, spec, **kw)


# ---------------------------------------------------------------------------
# the paged-attention kernel's split plan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [
    (8, 24, 1, 64, 8, 130, 2),   # chip_smoke.py phase 3, bf16
    (8, 24, 1, 64, 8, 69, 2),    # the digital serve: 552-row capacity
    (4, 2, 2, 64, 8, 6, 4),      # tests/test_torch_cuda.py, f32
    (4, 2, 4, 128, 8, 6, 2),
    (6, 2, 1, 64, 8, 80, 2),
    (3, 5, 2, 16, 16, 9, 4),
    (2, 16, 8, 256, 4, 40, 4),
    (8, 32, 1, 96, 8, 69, 2),    # phi3-mini-3.8b: hd 96
    (4, 8, 7, 128, 8, 67, 2),    # deepseek-coder-33b: G = 7
    (8, 1, 48, 128, 8, 69, 2),   # granite-20b: G = 48 in 24 chunks
    (8, 8, 2, 256, 8, 66, 2),    # gemma2-9b: hd 256
    (3, 1, 12, 64, 8, 9, 4),     # a ragged last chunk
])
def test_paged_split_plan_covers_every_row_once(shape):
    """For every context 1 .. capacity (and overrun rows, clamped to the
    capacity like inactive ones), the splits' row ranges cover [0, limit)
    exactly once in logical order; the scratch holds every used split's
    partial; a stage fits its byte budget; the lanes cover hd."""
    b, hkv, g, hd, bs, max_blocks, elt = shape
    plan = t_pa.plan_split(b, hkv, g, hd, bs, max_blocks, elt)
    cap = max_blocks * bs
    assert hkv % plan.heads == 0 and plan.heads <= t_pa.MAX_HEADS_PER_CTA
    assert plan.head_groups * plan.heads == hkv
    assert plan.split_rows % plan.stage_rows == 0
    assert plan.n_splits * plan.split_rows >= cap
    row_bytes = plan.heads * hd * elt
    assert plan.stage_rows * plan.lpr == 32 * t_pa.ROWS_PER_GROUP
    assert 2 * plan.stage_rows * row_bytes <= 4096 * plan.heads * plan.nv
    assert plan.smem_bytes <= 227 * 1024
    assert plan.lpr * plan.nv * 16 >= hd * elt and plan.nv <= 2
    assert plan.gm in (1, 2, 4, 8) and plan.gm <= t_pa.MAX_G_PER_CTA
    assert plan.q_chunks == -(-g // plan.gm)
    assert plan.gm >= g or plan.gm == t_pa.MAX_G_PER_CTA
    for pos in list(range(cap)) + [cap, cap + 5]:
        limit = min(pos + 1, cap)
        ranges = plan.ranges(limit)
        rows = [r for lo, hi in ranges for r in range(lo, hi)]
        assert rows == list(range(limit))
        used = -(-limit // plan.split_rows)
        assert len(ranges) == used <= plan.n_splits
        if used > 1:  # (m, l) and acc of every (slot, head, split, g)
            assert plan.scratch_floats >= b * hkv * used * g * (hd + 2)


def test_paged_split_plan_fills_the_card():
    """At the phase-3 shape and the serve's capacity the grid holds more
    CTAs than the card has SMs (about two per SM) when every slot is
    full."""
    for max_blocks in (130, 69):
        plan = t_pa.plan_split(8, 24, 1, 64, 8, max_blocks, 2)
        assert 8 * plan.head_groups * plan.n_splits >= 1.5 * t_pa.build.SMS


def test_paged_split_plan_refuses_unaligned_heads():
    with pytest.raises(ValueError, match="16-byte"):
        t_pa.plan_split(2, 2, 1, 12, 8, 4, 2)
    with pytest.raises(ValueError, match="G >= 1"):
        t_pa.plan_split(2, 2, 0, 64, 8, 4, 2)
    with pytest.raises(ValueError, match="hd <= 256"):
        t_pa.plan_split(2, 2, 1, 512, 8, 4, 2)


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
