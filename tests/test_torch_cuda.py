"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: without an NVIDIA GPU every test here skips (a CUDA kernel
has no CPU mode; the plain versions are held against the JAX reference in
tests/test_torch_kernels.py).  This file imports neither JAX nor ``repro``,
so it runs on a machine with PyTorch alone:

  PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: paged attention ctx allclose(rtol=1e-5, atol=1e-5) (the kernel
sums in another order), pools bit-exact outside garbage block 0; the
bit-serial kernel bit-exact, with and without noise and gain (it rounds every
step as the plain version does, and both take gain-weighted plane sums in
float64); the analytic kernel within one ADC step on fewer than 0.1% of the
outputs with the ADC (its K order differs from cuBLAS), allclose(rtol 1e-5,
atol 1e-5 * max|y|) without it, and its noise within 3 ulp of the plain
version's draw.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import build, imc_mvm, paged_attention as pa, ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _paged_state(dev, dtype, seed=0, b=4, mb=6, bs=8, hkv=2, g=2, hd=64,
                 pos=(3, 11, 29, 47)):
    rng = np.random.default_rng(seed)
    nb = b * mb + 1

    def t(*shape):
        return torch.tensor(rng.normal(size=shape), dtype=torch.float32,
                            device=dev)

    q = t(b, hkv, g, hd)
    kn, vn = t(b, hkv, hd).to(dtype), t(b, hkv, hd).to(dtype)
    pk, pv = t(nb, bs, hkv, hd).to(dtype), t(nb, bs, hkv, hd).to(dtype)
    bt = np.zeros((b, mb), np.int32)
    ids = iter(rng.permutation(np.arange(1, nb)))
    for row, p in enumerate(pos):
        for j in range(min(p // bs + 1, mb)):
            bt[row, j] = next(ids)
    return (q, kn, vn, pk, pv, torch.tensor(bt, device=dev),
            torch.tensor(pos, dtype=torch.int32, device=dev))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g,hd,softcap", [(1, 64, None), (2, 16, 30.0),
                                          (4, 128, None)])
def test_paged_attention_kernel_matches_plain(dev, dtype, g, hd, softcap):
    q, kn, vn, pk, pv, bt, pos = _paged_state(dev, dtype, g=g, hd=hd,
                                              pos=(3, 11, 29, 48))
    active = torch.tensor([True, False, True, True], device=dev)
    before = pa.paged_attention_cuda.launches
    ctx_k, pk_k, pv_k = pa.paged_attention_decode(
        q, kn, vn, pk.clone(), pv.clone(), bt, pos, active, scale=0.125,
        softcap=softcap)
    ctx_p, pk_p, pv_p = pa.decode_plain(q, kn, vn, pk.clone(), pv.clone(), bt,
                                        pos, active, scale=0.125,
                                        softcap=softcap)
    torch.cuda.synchronize()
    assert pa.paged_attention_cuda.launches == before + 1
    torch.testing.assert_close(ctx_k, ctx_p, rtol=1e-5, atol=1e-5)
    assert torch.equal(pk_k[1:], pk_p[1:]) and torch.equal(pv_k[1:], pv_p[1:])


def test_paged_attention_long_context(dev):
    """Contexts spanning several 128-row splits, one row per block edge."""
    q, kn, vn, pk, pv, bt, pos = _paged_state(
        dev, torch.bfloat16, b=6, mb=80, g=1, hd=64,
        pos=(0, 127, 128, 255, 639, 640))
    ctx_k, pk_k, _ = pa.paged_attention_decode(q, kn, vn, pk.clone(),
                                               pv.clone(), bt, pos,
                                               scale=0.125)
    ctx_p, pk_p, _ = pa.decode_plain(q, kn, vn, pk.clone(), pv.clone(), bt,
                                     pos, scale=0.125)
    torch.testing.assert_close(ctx_k, ctx_p, rtol=1e-5, atol=1e-5)
    assert torch.equal(pk_k[1:], pk_p[1:])


def _codes(dev, b, k, m, bx, bw, x_signed, seed=1):
    rng = np.random.default_rng(seed)
    x = torch.tensor(rng.normal(size=(b, k)), dtype=torch.float32, device=dev)
    if not x_signed:
        x = x.abs()
    w = torch.tensor(rng.normal(size=(k, m)), dtype=torch.float32, device=dev)
    xc, _ = ref.quantize_codes(x, bx, x_signed, x.abs().max())
    wc, _ = ref.quantize_codes(w, bw, True, w.abs().max())
    return xc, wc


@pytest.mark.parametrize("shape", [
    (4, 512, 16, 512, 6, 6, False),
    (130, 700, 257, 512, 4, 5, True),
    (1, 128, 128, 128, 8, 8, True),
    (16, 256, 64, 64, 2, 3, False),
    (8, 1536, 320, 256, 7, 7, True),
])
@pytest.mark.parametrize("noisy", [False, True])
def test_bitserial_kernel_matches_plain(dev, shape, noisy):
    b, k, m, rows, bx, bw, xs = shape
    xc, wc = _codes(dev, b, k, m, bx, bw, xs)
    spec = ref.BitSerialSpec(bx=bx, bw=bw, b_adc=8, rows=rows, k_h=60.0,
                             v_c=55.0, x_signed=xs,
                             sigma_noise=0.3 if noisy else 0.0)
    gain = None
    if noisy:
        gen = torch.Generator(device=dev).manual_seed(3)
        gain = 1.0 + 0.1 * torch.randn((k, m), generator=gen, device=dev)
    seed = 4242 if noisy else None
    y_k = imc_mvm.imc_bitserial_matmul(xc, wc, gain, spec, seed=seed)
    y_p = ref.imc_bitserial_ref(xc, wc, gain, spec, seed=seed)
    torch.cuda.synchronize()
    assert torch.equal(y_k, y_p), float((y_k - y_p).abs().max())


def _analytic_operands(dev, b, k, m, seed=2):
    rng = np.random.default_rng(seed)
    xc = torch.tensor(np.round(rng.normal(size=(b, k)) * 10),
                      dtype=torch.float32, device=dev)
    wc = torch.tensor(np.round(rng.normal(size=(k, m)) * 10),
                      dtype=torch.float32, device=dev)
    return ref.true_div(xc, (xc @ wc).std(unbiased=False) + 1e-6), wc


@pytest.mark.parametrize("shape", [(8, 1024, 64), (130, 700, 257),
                                   (1, 64, 1), (512, 1536, 6144)])
def test_analytic_kernel_matches_plain(dev, shape):
    assert not torch.backends.cuda.matmul.allow_tf32  # plain version in fp32
    b, k, m = shape
    xs, wc = _analytic_operands(dev, b, k, m)
    spec = ref.AnalyticSpec(b_adc=8, sigma_out=0.05, y_clip=4.0)
    raw = ref.AnalyticSpec(b_adc=8, sigma_out=0.05, y_clip=4.0,
                           apply_adc=False)
    before = imc_mvm.analytic_cuda.launches
    y_k = imc_mvm.imc_analytic_matmul(xs, wc, spec, seed=99)
    y_p = ref.imc_analytic_ref(xs, wc, spec, seed=99)
    r_k = imc_mvm.imc_analytic_matmul(xs, wc, raw, seed=99)
    r_p = ref.imc_analytic_ref(xs, wc, raw, seed=99)
    clean = imc_mvm.imc_analytic_matmul(xs, wc, raw)
    torch.cuda.synchronize()
    assert imc_mvm.analytic_cuda.launches == before + 3
    d = (y_k - y_p).abs()
    assert float(d.max()) <= 2 * spec.y_clip / 2**spec.b_adc + 1e-6
    assert float((d > 1e-6).float().mean()) < 1e-3
    torch.testing.assert_close(r_k, r_p, rtol=1e-5,
                               atol=1e-5 * float(r_p.abs().max()))
    # the noise alone, draw for draw against the plain version's
    z = spec.sigma_out * ref.analytic_output_noise(99, b, m, device=dev)
    eps = torch.finfo(torch.float32).eps
    assert bool(((r_k - clean - z).abs()
                 <= 3 * eps * (z.abs() + r_k.abs())).all())


def test_analytic_kernel_repeats_bit_for_bit(dev):
    xs, wc = _analytic_operands(dev, 64, 1536, 2048, seed=3)
    spec = ref.AnalyticSpec(b_adc=8, sigma_out=0.05, y_clip=4.0)
    a = imc_mvm.imc_analytic_matmul(xs, wc, spec, seed=7)
    assert torch.equal(a, imc_mvm.imc_analytic_matmul(xs, wc, spec, seed=7))
    assert not torch.equal(a, imc_mvm.imc_analytic_matmul(xs, wc, spec,
                                                          seed=8))


def test_analytic_failed_launch_raises(dev):
    """A launch the card refuses (more row tiles than the grid allows)
    raises; nothing falls back to the plain version."""
    b = 65536 * 64 + 1
    xs = torch.zeros((b, 1), device=dev)
    wc = torch.zeros((1, 1), device=dev)
    before = imc_mvm.analytic_cuda.launches
    with pytest.raises(RuntimeError, match="launch failed"):
        imc_mvm.imc_analytic_matmul(xs, wc, ref.AnalyticSpec())
    assert imc_mvm.analytic_cuda.launches == before


def test_analytic_unbuildable_source_raises(dev, tmp_path, monkeypatch):
    """A source nvcc refuses raises at the call; nothing falls back."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "prng.cuh").write_text((build.CSRC / "prng.cuh").read_text())
    (csrc / "analytic.cu").write_text("this is not CUDA\n")
    monkeypatch.setattr(build, "CSRC", csrc)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.delitem(build._loaded, "analytic", raising=False)
    xs, wc = _analytic_operands(dev, 4, 64, 8)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        imc_mvm.imc_analytic_matmul(xs, wc, ref.AnalyticSpec())
