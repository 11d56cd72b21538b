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
float64).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import imc_mvm, paged_attention as pa, ref

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
