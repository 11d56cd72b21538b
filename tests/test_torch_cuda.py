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
float64); both analytic kernels (the float one and the int8 codes route)
within one ADC step on fewer than 0.1% of the outputs with the ADC (the
float kernel's split-TF32 sums run in another order than cuBLAS's; the
int8 kernel's exact code product is divided by sigma_yo once, where the
plain version divides every code first), allclose(rtol 1e-5, atol 1e-5 *
max|y|) without it, and their noise within 3 ulp of the plain version's
draw.  A tensor-parallel mesh of two processes sharing the card over gloo
serves the one-device engine's greedy tokens.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import build, imc_mvm, ops, paged_attention as pa, ref

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
    """Contexts spanning many splits (the plan gives 32-row splits here),
    one row per block edge."""
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hkv,g,hd,softcap", [
    (32, 1, 96, None),    # phi3-mini-3.8b: 4 lanes of 16 hold no vector
    (8, 7, 128, None),    # deepseek-coder-33b
    (1, 48, 128, None),   # granite-20b: 24 query chunks of 2 rows
    (8, 2, 256, 50.0),    # gemma2-9b
    (8, 2, 64, None),     # granite-moe-1b-a400m
    (8, 6, 128, None),    # dbrx-132b: 3 query chunks of 2 rows
    (8, 2, 128, None),    # internvl2-2b
    (6, 1, 64, None),     # musicgen-medium, one rank of 1x4
    (2, 6, 128, None),    # dbrx-132b, one rank of 1x4
    (1, 12, 128, None),   # granite-20b, one rank of 1x4 (replicated pool)
])
def test_paged_attention_architecture_layouts(dev, dtype, hkv, g, hd,
                                              softcap):
    """The dense architectures' layouts, one inactive row and one overrun
    row, contexts over several splits: ctx within tolerance, pools bit-exact
    outside block 0 (each slot's new row written once, by one query chunk),
    one launch."""
    q, kn, vn, pk, pv, bt, pos = _paged_state(
        dev, dtype, b=4, mb=40, hkv=hkv, g=g, hd=hd, pos=(3, 130, 319, 320))
    q = q * 4.0  # larger logits, so the softcap bites
    active = torch.tensor([True, True, False, True], device=dev)
    before = dict(pa.paged_attention_cuda.layouts)
    ctx_k, pk_k, pv_k = pa.paged_attention_decode(
        q, kn, vn, pk.clone(), pv.clone(), bt, pos, active, scale=hd**-0.5,
        softcap=softcap)
    ctx_p, pk_p, pv_p = pa.decode_plain(q, kn, vn, pk.clone(), pv.clone(), bt,
                                        pos, active, scale=hd**-0.5,
                                        softcap=softcap)
    torch.cuda.synchronize()
    key = pa.layout_key(hkv, g, hd, dtype)
    assert pa.paged_attention_cuda.layouts[key] == before.get(key, 0) + 1
    torch.testing.assert_close(ctx_k, ctx_p, rtol=1e-5, atol=1e-5)
    assert torch.equal(pk_k[1:], pk_p[1:]) and torch.equal(pv_k[1:], pv_p[1:])


def test_paged_attention_idle_rows_read_the_last_writer(dev):
    """An engine's idle rows: three slots never admitted (empty tables, all
    writing block 0 at offset 0 and reading it back) and a retired slot
    whose stale table is a live slot's (it reads the row that slot writes).
    Every new row lands before any is read, the highest slot's where
    several meet, so every row's output and the whole pools equal the
    plain version's on every launch."""
    q, kn, vn, pk, pv, bt, pos = _paged_state(
        dev, torch.bfloat16, b=6, hkv=6, g=1, hd=64,
        pos=(3, 11, 0, 0, 0, 11))
    bt[2:5] = 0
    bt[5] = bt[1]
    active = torch.tensor([True, True, False, False, False, False],
                          device=dev)
    ctx_p, pk_p, pv_p = pa.decode_plain(q, kn, vn, pk.clone(), pv.clone(), bt,
                                        pos, active, scale=0.125)
    for _ in range(3):
        ctx_k, pk_k, pv_k = pa.paged_attention_decode(
            q, kn, vn, pk.clone(), pv.clone(), bt, pos, active, scale=0.125)
        torch.testing.assert_close(ctx_k, ctx_p, rtol=1e-5, atol=1e-5)
        assert torch.equal(pk_k, pk_p) and torch.equal(pv_k, pv_p)


def test_init_params_full_width_peak_memory(dev):
    """phi3-mini-3.8b at full width: each stacked leaf is allocated once and
    filled layer by layer, so the peak is under 1.1x the weight bytes."""
    import gc

    from repro_torch import configs
    from repro_torch.models import init_params, param_bytes

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    params = init_params(configs.get("phi3-mini-3.8b"), seed=0, device=dev)
    weights = param_bytes(params)
    peak = torch.cuda.max_memory_allocated() - base
    assert weights > 7e9
    assert peak < 1.1 * weights, (peak, weights)
    del params


def _to(tree, dev):
    return {k: _to(v, dev) if isinstance(v, dict) else v.to(dev)
            for k, v in tree.items()}


def test_ssd_block_full_width_against_cpu(dev):
    """One mamba2-2.7b SSD mixer at full width (d_model 2560, 80 heads x
    64, state 128, chunks of 128) over 300 tokens, in float32 on the card
    against the same mixer and inputs in float32 on the CPU (held against
    the JAX package by tests/test_torch_recurrent.py): the output and the
    final state within 1e-4 of the CPU ones' largest magnitude."""
    from repro_torch import configs
    from repro_torch.models import ssm

    cfg = configs.get("mamba2-2.7b").replace(dtype="float32")
    gen = torch.Generator().manual_seed(0)
    p = ssm.init_ssm(gen, cfg.d_model, cfg.ssm_expand, cfg.ssm_head_dim,
                     cfg.ssm_groups, cfg.ssm_state, cfg.conv_width,
                     torch.float32, "cpu")
    x = torch.randn((2, 300, cfg.d_model), generator=gen)
    y_cpu, s_cpu = ssm.ssm_forward(p, x, cfg)
    y, s = ssm.ssm_forward(_to(p, dev), x.to(dev), cfg)
    assert s.dtype == torch.float32 and s.device.type == dev.type
    for a, b in ((y, y_cpu), (s, s_cpu)):
        err = float((a.cpu() - b).abs().max())
        assert err <= 1e-4 * float(b.abs().max()), err


def test_moe_block_full_width_against_cpu(dev):
    """One granite-moe-1b-a400m MoE half at full width (d_model 1024, 32
    experts of d_ff 512, top 8, capacity 1.25) over 2 x 64 tokens, in
    float32 on the card against the same half and inputs in float32 on the
    CPU (held against the JAX package by tests/test_torch_moe.py): the
    router's top-k choices equal, the output within 1e-4 of the CPU one's
    largest magnitude, the aux loss within 1e-6."""
    from repro_torch import configs
    from repro_torch.models import moe

    cfg = configs.get("granite-moe-1b-a400m")
    gen = torch.Generator().manual_seed(1)
    p = {}
    for path, t in moe.init_moe_parts(gen, cfg.d_model, cfg.d_ff,
                                      cfg.n_experts, cfg.mlp_kind,
                                      torch.float32, "cpu"):
        node = p
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = t
    x = torch.randn((2, 64, cfg.d_model), generator=gen)
    args = (cfg.n_experts, cfg.top_k, cfg.capacity_factor,
            cfg.moe_group_size, cfg.mlp_kind)
    y_cpu, a_cpu = moe.apply_moe(p, x, *args)
    y, a = moe.apply_moe(_to(p, dev), x.to(dev), *args)
    pick = [torch.topk(xs.reshape(-1, cfg.d_model) @ r, cfg.top_k)
            .indices.sort().values.cpu()
            for xs, r in ((x, p["router"]), (x.to(dev), p["router"].to(dev)))]
    assert torch.equal(pick[0], pick[1])
    err = float((y.cpu() - y_cpu).abs().max())
    assert err <= 1e-4 * float(y_cpu.abs().max()), err
    assert abs(float(a) - float(a_cpu)) <= 1e-6


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
    (4, 512, 40, 256, 8, 7, True),   # 8-bit inputs, 7-bit weights
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


@pytest.mark.parametrize("b,k,m,gain", [
    (128, 1536, 1536, True),   # a prefill: 4 slots x 32 prompt tokens
    (1, 6144, 1536, True),     # decode, one slot, 24 banks
    (4, 6144, 1536, True),     # decode, four slots
    (4, 1536, 2048, False),    # the LM head (popcount instantiation)
    (4, 2560, 10576, True),    # mamba2-2.7b ssm.in_proj: M not a multiple
    (3, 2560, 10576, False),   # of 64; its packed conv inputs (no noise)
    (4, 5120, 2560, True),     # mamba2-2.7b ssm.out_proj
    (3, 512, 1024, True),      # granite-moe expert mlp.wo, capacity 3
])
def test_bitserial_kernel_matches_plain_at_serve_shapes(dev, b, k, m, gain):
    """The bit-serial serve's knobs (7x7 bits, 256-row banks, b_adc 10, its
    k_h, v_c, sigma_d and thermal noise), bit for bit, noise included."""
    from repro_torch.core.imc_linear import IMCConfig

    mc = ops.matmul_config_from_imc(
        IMCConfig(mode="imc_bitserial", bx=7, bw=7, v_wl=0.7), k)
    spec = ref.BitSerialSpec(bx=7, bw=7, b_adc=mc.b_adc, rows=mc.rows,
                             k_h=mc.k_h_counts, v_c=mc.v_c_counts,
                             x_signed=True,
                             sigma_noise=mc.sigma_thermal_counts)
    xc, wc = _codes(dev, b, k, m, 7, 7, True, seed=5)
    w_gain, seed = None, None
    if gain:
        gen = torch.Generator(device=dev).manual_seed(6)
        w_gain = 1.0 + mc.sigma_d * torch.randn((k, m), generator=gen,
                                                device=dev)
        seed = 4243
    before = imc_mvm.bitserial_cuda.gain_launches
    y_k = imc_mvm.imc_bitserial_matmul(xc, wc, w_gain, spec, seed=seed)
    y_p = ref.imc_bitserial_ref(xc, wc, w_gain, spec, seed=seed)
    torch.cuda.synchronize()
    assert imc_mvm.bitserial_cuda.gain_launches == before + int(gain)
    assert torch.equal(y_k, y_p), float((y_k - y_p).abs().max())


def test_bitserial_kernel_column_shards_match_the_whole_call(dev):
    """A tensor-parallel rank's call on its columns (``col0``), noise and
    gain on: bit for bit the plain version at the same offset, and the
    shards side by side the whole call."""
    b, k, m, tp = 4, 1536, 384, 4
    spec = ref.BitSerialSpec(bx=7, bw=7, b_adc=10, rows=256, k_h=60.0,
                             v_c=55.0, x_signed=True, sigma_noise=0.3)
    xc, wc = _codes(dev, b, k, m, 7, 7, True, seed=7)
    gen = torch.Generator(device=dev).manual_seed(8)
    gain = 1.0 + 0.1 * torch.randn((k, m), generator=gen, device=dev)
    whole = imc_mvm.imc_bitserial_matmul(xc, wc, gain, spec, seed=4244)
    per, parts = m // tp, []
    for r in range(tp):
        cols = slice(r * per, (r + 1) * per)
        y_k = imc_mvm.imc_bitserial_matmul(xc, wc[:, cols], gain[:, cols],
                                           spec, seed=4244, col0=r * per)
        y_p = ref.imc_bitserial_ref(xc, wc[:, cols], gain[:, cols], spec,
                                    seed=4244, col0=r * per)
        torch.cuda.synchronize()
        assert torch.equal(y_k, y_p), (r, float((y_k - y_p).abs().max()))
        parts.append(y_k)
    assert torch.equal(torch.cat(parts, dim=1), whole)


def test_bitserial_segments_match_the_whole_call(dev):
    """mamba2-2.7b's ``in_proj`` as a rank of a 1x4 mesh holds it (its
    ``z``, ``x`` and ``dt`` heads beside the whole ``B|C`` columns, one
    launch a segment), noise and gain on, at full width: each rank's
    ``ops.imc_matmul`` equals the same columns of the whole call, bit for
    bit."""
    from repro_torch import configs
    from repro_torch.models import ssm

    cfg = configs.get("mamba2-2.7b")
    layout = ssm.in_proj_columns(cfg, 4)
    mcfg = ops.IMCMatmulConfig(bx=7, bw=7, b_adc=10, rows=256, sigma_d=0.05,
                               sigma_thermal_counts=0.3, k_h_counts=60.0,
                               v_c_counts=55.0)
    gen = torch.Generator(device=dev).manual_seed(9)
    x = torch.randn((4, cfg.d_model), generator=gen, device=dev)
    w = torch.randn((cfg.d_model, layout.total), generator=gen, device=dev)
    x_max, w_max = x.abs().max(), w.abs().max()
    whole = ops.imc_matmul(x, w, mcfg, seed=7, x_max=x_max, w_max=w_max)
    for r in range(4):
        idx = layout.index(r, dev)
        before = imc_mvm.bitserial_cuda.launches
        y = ops.imc_matmul(x, w[:, idx], mcfg, seed=7, x_max=x_max,
                           w_max=w_max, cols=(layout.ranks[r], layout.total))
        torch.cuda.synchronize()
        assert imc_mvm.bitserial_cuda.launches - before == len(
            layout.ranks[r])
        assert torch.equal(y, whole[:, idx]), r


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


@pytest.mark.parametrize("b", [8, 512])
def test_analytic_kernel_with_16_bit_codes(dev, b):
    """Weight codes of 16 bits split into two TF32 limbs: against the plain
    version with phase 3's tolerance, and the noiseless product against a
    float64 one within 1e-5 of max|y| (as close as cuBLAS float32 is held
    to the plain version)."""
    gen = torch.Generator(device=dev).manual_seed(16)
    x = torch.rand((b, 1536), generator=gen, device=dev)
    w = torch.rand((1536, 6144), generator=gen, device=dev) * 2 - 1
    xc, _ = ref.quantize_codes(x, 6, False, x.abs().max())
    wc, _ = ref.quantize_codes(w, 16, True, w.abs().max())
    assert bool(((wc.view(torch.int32) & 0x1FFF) != 0).any())  # two limbs
    xs = ref.true_div(xc, (xc[:8] @ wc).std(unbiased=False) + 1e-9)
    spec = ref.AnalyticSpec(b_adc=8, sigma_out=0.05, y_clip=4.0)
    raw = ref.AnalyticSpec(b_adc=8, sigma_out=0.05, y_clip=4.0,
                           apply_adc=False)
    y_k = imc_mvm.imc_analytic_matmul(xs, wc, spec, seed=5)
    y_p = ref.imc_analytic_ref(xs, wc, spec, seed=5)
    r_k = imc_mvm.imc_analytic_matmul(xs, wc, raw, seed=5)
    r_p = ref.imc_analytic_ref(xs, wc, raw, seed=5)
    clean = imc_mvm.imc_analytic_matmul(xs, wc, raw)
    y64 = xs.double() @ wc.double()
    torch.cuda.synchronize()
    d = (y_k - y_p).abs()
    assert float(d.max()) <= 2 * spec.y_clip / 2**spec.b_adc + 1e-6
    assert float((d > 1e-6).float().mean()) < 1e-3
    torch.testing.assert_close(r_k, r_p, rtol=1e-5,
                               atol=1e-5 * float(r_p.abs().max()))
    assert float((clean.double() - y64).abs().max()) <= \
        1e-5 * float(y64.abs().max())


def test_analytic_failed_launch_raises(dev):
    """A launch the card refuses (more 128-row tiles than the grid allows)
    raises; nothing falls back to the plain version."""
    b = 65536 * 128 + 1
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


def _phase3_paged(dev):
    """chip_smoke.py phase 3's shape: 8 slots, musicgen-medium heads (Hkv
    24, G 1, hd 64), bf16 pools of 8-row blocks, contexts 18..1040, one
    inactive and one overrun row."""
    gen = torch.Generator(device=dev).manual_seed(0)
    b, hkv, hd, bs, mb = 8, 24, 64, 8, 130
    nb = b * mb + 1
    bf = torch.bfloat16
    q = torch.randn((b, hkv, 1, hd), generator=gen, device=dev)
    kn = torch.randn((b, hkv, hd), generator=gen, device=dev).to(bf)
    vn = torch.randn((b, hkv, hd), generator=gen, device=dev).to(bf)
    pk = torch.randn((nb, bs, hkv, hd), generator=gen, device=dev).to(bf)
    pv = torch.randn((nb, bs, hkv, hd), generator=gen, device=dev).to(bf)
    perm = torch.randperm(nb - 1, generator=gen, device=dev) + 1
    bt = perm[: b * mb].reshape(b, mb).to(torch.int32)
    pos = torch.tensor([17, 130, 511, 640, 777, 900, 1023, mb * bs],
                       dtype=torch.int32, device=dev)
    active = torch.ones(b, dtype=torch.bool, device=dev)
    active[6] = False
    return q, kn, vn, pk, pv, bt, pos, active


def test_paged_attention_phase3_shape_repeats_bit_for_bit(dev):
    q, kn, vn, pk, pv, bt, pos, active = _phase3_paged(dev)
    ctx_k, pk_k, pv_k = pa.paged_attention_decode(
        q, kn, vn, pk.clone(), pv.clone(), bt, pos, active, scale=0.125)
    ctx_p, pk_p, pv_p = pa.decode_plain(q, kn, vn, pk.clone(), pv.clone(), bt,
                                        pos, active, scale=0.125)
    torch.testing.assert_close(ctx_k, ctx_p, rtol=1e-5, atol=1e-5)
    assert torch.equal(pk_k[1:], pk_p[1:]) and torch.equal(pv_k[1:], pv_p[1:])
    for _ in range(3):  # the splits' merge order is fixed
        again, _, _ = pa.paged_attention_decode(
            q, kn, vn, pk.clone(), pv.clone(), bt, pos, active, scale=0.125)
        assert torch.equal(again, ctx_k)


def _int8_operands(dev, b, k, m, bits, x_signed, seed=5):
    rng = np.random.default_rng(seed)
    x = torch.tensor(rng.normal(size=(b, k)), dtype=torch.float32, device=dev)
    if not x_signed:
        x = x.abs()
    w = torch.tensor(rng.uniform(-1, 1, size=(k, m)), dtype=torch.float32,
                     device=dev)
    xc, _ = ref.quantize_codes(x, bits, x_signed, x.abs().max())
    wc, _ = ref.quantize_codes(w, bits, True, w.abs().max())
    return xc, wc, (xc[:8] @ wc).std(unbiased=False) + 1e-9


@pytest.mark.parametrize("case", [
    (1, 1536, 1536, 8, False), (8, 1536, 6144, 8, False),
    (8, 6144, 1536, 6, True), (16, 1536, 2048, 8, True),
    (17, 1536, 1536, 6, False), (512, 1536, 6144, 8, False),
    (512, 6144, 1536, 6, True), (8, 720, 1000, 8, False),
    (40, 700, 1000, 8, True), (3, 100, 7, 6, False),
])
def test_int8_analytic_kernel_matches_plain(dev, case):
    """The int8 codes route against its plain version: batches 1 to 512
    (64-row tiles, zero rows past B), K = 1536 and 6144 and K
    not a multiple of 32 (720) or of 16 (700, 100), M not a multiple of
    the tile, unsigned and signed activation codes of 6 and 8 bits."""
    assert not torch.backends.cuda.matmul.allow_tf32  # plain version in fp32
    b, k, m, bits, xs = case
    xc, wc, sig = _int8_operands(dev, b, k, m, bits, xs)
    spec = ref.AnalyticSpec(b_adc=8, sigma_out=0.05, y_clip=4.0)
    raw = ref.AnalyticSpec(b_adc=8, sigma_out=0.05, y_clip=4.0,
                           apply_adc=False)
    kw = dict(bx=bits, bw=bits, x_signed=xs)
    before = imc_mvm.analytic_int8_cuda.launches
    y_k = imc_mvm.imc_analytic_codes_matmul(xc, wc, sig, spec, seed=99, **kw)
    r_k = imc_mvm.imc_analytic_codes_matmul(xc, wc, sig, raw, seed=99, **kw)
    clean = imc_mvm.imc_analytic_codes_matmul(xc, wc, sig, raw, **kw)
    xs_p = ref.true_div(xc, sig)
    y_p = ref.imc_analytic_ref(xs_p, wc, spec, seed=99)
    r_p = ref.imc_analytic_ref(xs_p, wc, raw, seed=99)
    torch.cuda.synchronize()
    assert imc_mvm.analytic_int8_cuda.launches == before + 3
    d = (y_k - y_p).abs()
    assert float(d.max()) <= 2 * spec.y_clip / 2**spec.b_adc + 1e-6
    assert float((d > 1e-6).float().mean()) < 1e-3
    torch.testing.assert_close(r_k, r_p, rtol=1e-5,
                               atol=1e-5 * float(r_p.abs().max()))
    z = spec.sigma_out * ref.analytic_output_noise(99, b, m, device=dev)
    eps = torch.finfo(torch.float32).eps
    assert bool(((r_k - clean - z).abs()
                 <= 3 * eps * (z.abs() + r_k.abs())).all())


@pytest.mark.parametrize("b", [8, 512])
def test_int8_analytic_kernel_repeats_bit_for_bit(dev, b):
    """The same bits on every run (exact int32 sums, a fixed epilogue),
    different noise for another seed: B = 8 at K = 6144 (48 slices per CTA)
    and B = 512."""
    xc, wc, sig = _int8_operands(dev, b, 6144, 1536, 8, False, seed=6)
    spec = ref.AnalyticSpec(b_adc=8, sigma_out=0.05, y_clip=4.0)
    kw = dict(bx=8, bw=8, x_signed=False)
    a = imc_mvm.imc_analytic_codes_matmul(xc, wc, sig, spec, seed=7, **kw)
    for _ in range(3):
        assert torch.equal(a, imc_mvm.imc_analytic_codes_matmul(
            xc, wc, sig, spec, seed=7, **kw))
    assert not torch.equal(a, imc_mvm.imc_analytic_codes_matmul(
        xc, wc, sig, spec, seed=8, **kw))


@pytest.mark.parametrize("bx,kernel", [(8, "int8"), (10, "float")])
def test_imc_matmul_routes_analytic_by_width(dev, bx, kernel):
    """``ops.imc_matmul`` launches the int8 kernel for 8-bit codes and the
    float32 SIMT kernel for 10-bit ones, once each."""
    rng = np.random.default_rng(8)
    x = torch.tensor(np.abs(rng.normal(size=(64, 512))), dtype=torch.float32,
                     device=dev)
    w = torch.tensor(rng.uniform(-1, 1, size=(512, 256)),
                     dtype=torch.float32, device=dev)
    cfg = ops.IMCMatmulConfig(mode="imc_analytic", bx=bx, bw=8, b_adc=8,
                              snr_a_db=25.0, x_signed=False)
    i0, f0 = imc_mvm.analytic_int8_cuda.launches, imc_mvm.analytic_cuda.launches
    y = ops.imc_matmul(x, w, cfg, seed=1)
    torch.cuda.synchronize()
    assert torch.isfinite(y).all()
    assert (imc_mvm.analytic_int8_cuda.launches - i0,
            imc_mvm.analytic_cuda.launches - f0) == (
                (1, 0) if kernel == "int8" else (0, 1))


def test_int8_analytic_refuses_codes_outside_int8(dev):
    spec = ref.AnalyticSpec()
    xc, wc, sig = _int8_operands(dev, 4, 64, 8, 8, False)
    before = imc_mvm.analytic_int8_cuda.launches
    with pytest.raises(ValueError, match="at most 8 bits"):
        imc_mvm.imc_analytic_codes_matmul(xc, wc, sig, spec, bx=9, bw=8,
                                          x_signed=False)
    k = 65794
    with pytest.raises(ValueError, match="overflow int32"):
        imc_mvm.imc_analytic_codes_matmul(
            torch.zeros((1, k), device=dev), torch.zeros((k, 1), device=dev),
            sig, spec, bx=8, bw=8, x_signed=False)
    with pytest.raises(TypeError, match="uint8/int8"):
        imc_mvm.analytic_int8_cuda(xc, wc.t().to(torch.int8), sig.reshape(1),
                                   spec)
    assert imc_mvm.analytic_int8_cuda.launches == before


_OUT_OF_RANGE = """
import torch
from repro_torch.kernels import imc_mvm, ref
spec = ref.AnalyticSpec(b_adc=8, sigma_out=0.05, y_clip=4.0)
dev = torch.device("cuda")
xc = torch.randint(0, 64, (8, 256), device=dev).float()
wc = torch.randint(-64, 64, (256, 96), device=dev).float()
kw = dict(bx=6, bw=7, x_signed=False)
y = imc_mvm.imc_analytic_codes_matmul(xc, wc, 100.0, spec, **kw)
torch.cuda.synchronize()
print("in range: ok", bool(torch.isfinite(y).all()), flush=True)
{corrupt}
imc_mvm.imc_analytic_codes_matmul(xc, wc, 100.0, spec, **kw)
torch.cuda.synchronize()
print("out of range: no error", flush=True)
"""


@pytest.mark.parametrize("corrupt", ["xc[3, 7] = 64", "wc[5, 2] = -65"])
def test_int8_analytic_asserts_on_a_code_outside_its_width(dev, corrupt):
    """A code one past its width stops the card with a device-side assert
    (no host sync on the call), where the in-range call before it ran.  In
    a subprocess: a device-side assert leaves the CUDA context unusable."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    src = str(Path(__file__).resolve().parents[1] / "src")
    env = dict(os.environ, PYTHONPATH=src)
    proc = subprocess.run(
        [sys.executable, "-c", _OUT_OF_RANGE.format(corrupt=corrupt)],
        env=env, capture_output=True, text=True, timeout=300)
    assert "in range: ok True" in proc.stdout, proc.stderr[-2000:]
    assert "out of range: no error" not in proc.stdout
    assert proc.returncode != 0
    assert "assert" in proc.stderr.lower(), proc.stderr[-2000:]


# ---------------------------------------------------------------------------
# the serve engine's prefix sharing and fault path on the card
# ---------------------------------------------------------------------------


def _smoke_engine(dev, **kw):
    """musicgen-medium SMOKE in float32 with CPU-made weights moved to
    ``dev`` (the CPU and CUDA generators draw different streams)."""
    from repro_torch import configs
    from repro_torch.launch.serve import Engine
    from repro_torch.models import init_params
    from repro_torch.tree import map_leaves

    cfg = configs.get_smoke("musicgen-medium")
    params = map_leaves(lambda t: t.to(dev),
                      init_params(cfg, seed=0, device="cpu"))
    return Engine(cfg, params, batch_slots=4, cache_len=48, max_chunk=4,
                  **kw)


def _warm_run(dev):
    from repro_torch.launch.serve import Request, serve

    eng = _smoke_engine(dev, prefix_cache=True)
    rnp = np.random.default_rng(3)
    shared = rnp.integers(0, eng.cfg.vocab_size, 16)
    reqs = [Request(rid=i, max_new=5, prompt=np.concatenate(
        [shared, rnp.integers(0, eng.cfg.vocab_size, n)]))
        for i, n in enumerate((5, 9, 3))]
    serve(eng, reqs[:1])
    serve(eng, reqs[1:])
    copies = []
    cow = eng._cow

    def recorded(src, dst):
        copies.append((src, dst))
        cow(src, dst)

    eng._cow = recorded
    dup = Request(rid=3, prompt=shared.copy(), max_new=5)
    pa.paged_attention_cuda.launches = 0
    steps0 = eng.decode_steps + eng.warm_steps
    serve(eng, [dup])  # a whole cached prompt: copy-on-write
    launches = pa.paged_attention_cuda.launches
    return eng, copies, launches, eng.decode_steps + eng.warm_steps - steps0


def test_warm_prefill_and_cow_on_card_match_the_plain_path(dev):
    """Warm admissions on the card (one active row of decode steps through
    the paged-attention kernel, a copy-on-write block) give the CPU's
    tokens (the plain paged attention) and scoreboard; every warm and
    decode step launches the kernel once per layer; the private copy equals
    its shared source but for the re-fed last position."""
    eng, copies, launches, steps = _warm_run(dev)
    cpu, cpu_copies, _, _ = _warm_run(torch.device("cpu"))
    assert {r.rid: r.out for r in eng.finished} == {
        r.rid: r.out for r in cpu.finished}
    assert eng.prefix_stats() == cpu.prefix_stats()
    assert eng.cow_copies == 1 and eng.prefix_hits == 3
    assert copies == cpu_copies and len(copies) == 1
    assert launches == eng.cfg.n_layers * steps > 0
    (src, dst), = copies
    for e in eng._paged_layers():
        for key in ("pk", "pv"):
            pool = e[key]
            assert torch.equal(pool[:, dst, :-1], pool[:, src, :-1])
            torch.testing.assert_close(pool[:, dst, -1], pool[:, src, -1],
                                       rtol=1e-5, atol=1e-5)


def test_refused_kernel_launch_escapes_the_engine(dev):
    """A paged-attention launch the card refuses escapes ``decode_chunk`` at
    once as ``KernelLaunchError``: not retried, no request retired, nothing
    run on the CPU instead."""
    from repro_torch.launch.serve import Request
    from repro_torch.runtime import fault

    eng = _smoke_engine(dev)
    rnp = np.random.default_rng(4)
    eng.admit_pending([Request(rid=i, max_new=4, prompt=rnp.integers(
        0, eng.cfg.vocab_size, n)) for i, n in enumerate((5, 9))])
    real = build.library("paged_attention")
    calls = []

    class Refusing:
        def paged_attention_decode(self, *args):
            calls.append(1)
            return 1  # cudaErrorInvalidValue

        def kernel_error_string(self, err):
            return real.kernel_error_string(err)

    build._loaded["paged_attention"] = Refusing()
    try:
        with pytest.raises(build.KernelLaunchError) as info:
            eng.decode_chunk()
    finally:
        build._loaded["paged_attention"] = real
    assert not fault.is_transient_device_error(info.value)
    assert len(calls) == 1
    assert eng.failed_requests == 0 and eng.decode_failures == 0
    assert eng.active == 2


# ---------------------------------------------------------------------------
# the frozen seed bit-serial kernel (the kernel bench's baseline)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [
    (3, 100, 10, 40, 4, 4, True),      # ragged banks of 40 rows
    (2, 70, 5, 70, 8, 8, False),       # 8-bit unsigned inputs, one bank
    (64, 512, 128, 512, 6, 6, True),   # the bench's SHAPES[0]
    (4, 1536, 6144, 256, 7, 7, True),  # the bit-serial serve's MLP shape
])
def test_seed_bitserial_kernel_matches_plain(dev, shape):
    """Bit-exact with and without the noise operand: the same operand, exact
    plane counts, the plain version's rounding and summation order."""
    from repro_torch.benchmarks import kernel_bench as kb

    b, k, m, rows, bx, bw, xs = shape
    xc, wc = _codes(dev, b, k, m, bx, bw, xs)
    spec = ref.BitSerialSpec(bx=bx, bw=bw, b_adc=8, rows=rows, k_h=60.0,
                             v_c=55.0, x_signed=xs)
    gen = torch.Generator(device=dev).manual_seed(7)
    noise = 0.3 * torch.randn((-(-k // rows), bw * bx, b, m), generator=gen,
                              device=dev)
    before = kb.seed_bitserial_cuda.launches
    for nz in (None, noise):
        y_k = kb.seed_bitserial_matmul(xc, wc, nz, spec)
        y_p = kb.seed_bitserial_plain(xc, wc, nz, spec)
        torch.cuda.synchronize()
        assert torch.equal(y_k, y_p), float((y_k - y_p).abs().max())
    assert kb.seed_bitserial_cuda.launches == before + 2


def test_seed_bitserial_call_is_one_kernel_without_scratch(dev):
    """A wrapper call at the main path's shape is one kernel (a CUDA graph
    of one call holds one kernel node), and allocates nothing but its
    output."""
    from repro_torch.benchmarks import kernel_bench as kb

    b, k, m, rows = 4, 1536, 6144, 256
    xc, wc = _codes(dev, b, k, m, 7, 7, True)
    spec = ref.BitSerialSpec(bx=7, bw=7, b_adc=10, rows=rows, k_h=120.0,
                             v_c=100.0, x_signed=True)
    noise = 0.3 * torch.randn((k // rows, 49, b, m), device=dev)
    kb.seed_bitserial_matmul(xc, wc, noise, spec)  # built, attribute set
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        kb.seed_bitserial_matmul(xc, wc, noise, spec)
    assert kb._graph_kernels(graph) == 1
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    before = kb.seed_bitserial_cuda.launches
    y = kb.seed_bitserial_matmul(xc, wc, noise, spec)
    torch.cuda.synchronize()
    assert kb.seed_bitserial_cuda.launches == before + 1
    assert torch.cuda.max_memory_allocated() - base == \
        torch.cuda.memory_allocated() - base  # nothing freed: no scratch
    assert torch.cuda.memory_allocated() - base <= -(-y.numel() * 4 // 512) \
        * 512
    assert torch.equal(y, kb.seed_bitserial_plain(xc, wc, noise, spec))


@pytest.mark.parametrize("rows,bx,bw", [(256, 7, 7), (512, 6, 6), (64, 4, 5)])
def test_seed_bitserial_kernel_without_noise_is_bitserial(dev, rows, bx, bw):
    """Without noise the seed computes bitserial.cu's function without gain;
    the two sum the same float32 terms in other orders: allclose(rtol 0,
    atol ``order_atol``, 8 float32 ulps of the largest partial sum)."""
    from repro_torch.benchmarks import kernel_bench as kb

    xc, wc = _codes(dev, 4, 1536, 2048, bx, bw, True, seed=8)
    spec = ref.BitSerialSpec(bx=bx, bw=bw, b_adc=10, rows=rows, k_h=120.0,
                             v_c=100.0, x_signed=True)
    y_seed = kb.seed_bitserial_matmul(xc, wc, None, spec)
    y_new = imc_mvm.imc_bitserial_matmul(xc, wc, None, spec)
    torch.cuda.synchronize()
    torch.testing.assert_close(y_seed, y_new, rtol=0,
                               atol=kb.order_atol(xc, wc, spec))


# ---------------------------------------------------------------------------
# the Monte Carlo chains on the card
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["qs", "qr", "cm"])
def test_mc_chain_on_card_matches_cpu(dev, kind):
    """The same operands and draws through each chain on the card and on
    the CPU: y_pre allclose(rtol 1e-5, atol 1e-5 * max|y|) (reductions in
    other orders), the SNRs within 0.02 dB (ADC knife edges may flip)."""
    from repro_torch.core import mc
    from repro_torch.core.archs import CMArch, QRArch, QSArch

    arch, draw, chain = {
        "qs": (QSArch(n=512, bx=6, bw=6, v_wl=0.6), mc.draw_qs, mc.qs_chain),
        "qr": (QRArch(n=512, bx=6, bw=7, c_o=3e-15), mc.draw_qr,
               mc.qr_chain),
        "cm": (CMArch(n=512, bx=6, bw=6, v_wl=0.8), mc.draw_cm, mc.cm_chain),
    }[kind]
    gen = mc.generator(2, "cpu")
    x, w = mc.sample_operands(gen, 4000, 512, arch.stats)
    draws = draw(gen, 4000, 512, arch)
    y_cpu = chain(x, w, arch, draws)
    y_card = chain(x.to(dev), w.to(dev), arch,
                   type(draws)(*(t.to(dev) for t in draws)))
    torch.testing.assert_close(y_card[1].cpu(), y_cpu[1], rtol=1e-5,
                               atol=1e-5 * float(y_cpu[1].abs().max()))
    s_cpu = mc.snrs_from_sums(mc.snr_sums(*y_cpu), 4000)
    s_card = mc.snrs_from_sums(mc.snr_sums(*y_card), 4000)
    for name in ("snr_T_db", "snr_A_db"):
        assert abs(s_card[name] - s_cpu[name]) < 0.02, (s_card, s_cpu)


def test_mc_chunked_ensemble_on_card(dev, monkeypatch):
    """empirical_snrs on a CUDA generator across several chunks: the same
    result twice, within the reference test's band at 512 rows."""
    from repro_torch.core import mc
    from repro_torch.core.archs import QSArch

    arch = QSArch(n=512, bx=6, bw=6, v_wl=0.6)
    monkeypatch.setattr(mc, "CHUNK", 2048)
    runs = [mc.empirical_snrs(mc.generator(3, dev), arch, mc.mc_qs_arch,
                              ens=5000) for _ in range(2)]
    assert runs[0] == runs[1]
    assert abs(runs[0]["snr_A_db"] - arch.snr_A_db()) < 1.0, runs[0]


def _two_rank_tokens(mode):
    """One rank of a 1x2 mesh sharing the card over gloo: musicgen-medium
    SMOKE on ``mode``, weights made on the CPU and cut to this rank's
    shard; rank 0 returns the tokens."""
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import sharding

    cfg, params, reqs = _tp_case(mode)
    mesh = mesh_lib.make_serve_mesh(1, 2)
    params = sharding.shard_params(params, cfg, mesh)
    return _tp_serve(cfg, params, reqs, mesh)


def _tp_case(mode):
    from repro_torch import configs
    from repro_torch.core import substrate as substrate_lib
    from repro_torch.core.imc_linear import IMCConfig
    from repro_torch.launch.serve import Request
    from repro_torch.models import init_params

    cfg = configs.get_smoke("musicgen-medium")
    params = init_params(cfg, seed=0, device="cpu")
    if mode != "digital":
        cfg = cfg.replace(imc=IMCConfig(mode=mode, bx=7, bw=7, v_wl=0.7))
        ref_batch = np.random.default_rng(1).integers(0, 256, (2, 24))
        cfg = substrate_lib.calibrate_model(cfg, params, [ref_batch])
    rnp = np.random.default_rng(2)
    reqs = [Request(rid=i, prompt=rnp.integers(0, 256, n), max_new=6)
            for i, n in enumerate((4, 9, 20, 6))]
    return cfg, params, reqs


def _tp_serve(cfg, params, reqs, mesh=None):
    from repro_torch.launch.serve import Engine, serve
    from repro_torch.tree import map_leaves

    params = map_leaves(lambda t: t.to("cuda"), params)
    eng = Engine(cfg, params, batch_slots=4, cache_len=40, max_chunk=4,
                 mesh=mesh)
    return {r.rid: r.out for r in serve(eng, reqs)}


@pytest.mark.parametrize("mode", ["digital", "imc_bitserial"])
def test_two_ranks_sharing_the_card_match_one_device(dev, mode):
    """A 1x2 mesh of two processes on one card over gloo (head-sharded
    pools, the paged and bit-serial kernels per rank at the local layout)
    serves the one-device engine's greedy tokens."""
    from repro_torch.launch import mesh as mesh_lib

    cfg, params, reqs = _tp_case(mode)
    want = _tp_serve(cfg, params, reqs)
    assert mesh_lib.launch(2, "gloo", _two_rank_tokens, mode) == want


# ---------------------------------------------------------------------------
# training: the train step, the flash backward, checkpoints of card tensors
# ---------------------------------------------------------------------------


def _smoke_train_losses(device, steps=3):
    from repro_torch import configs, tree
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.launch import steps as steps_lib
    from repro_torch.optim import AdamWConfig

    cfg = configs.get_smoke("musicgen-medium")
    bundle = steps_lib.build_train_step(cfg, AdamWConfig(lr=1e-3),
                                        total_steps=steps, device=device)
    # the same weights on both devices: the CPU generator's draws
    state = tree.map_leaves(lambda t: t.to(device),
                            steps_lib.init_train_state(cfg, 0, "cpu"))
    data = SyntheticLM(DataConfig(seed=0, vocab_size=cfg.vocab_size,
                                  seq_len=32, global_batch=2))
    losses = []
    for i in range(steps):
        tokens = torch.from_numpy(data.batch(i)["tokens"]).to(device)
        state, met = bundle.step_fn(state, {"tokens": tokens})
        losses.append(float(met["loss"]))
    return losses, state


def test_smoke_train_step_on_card_matches_cpu(dev):
    """musicgen-medium SMOKE in float32, three AdamW steps from the same
    weights and batches: the card's losses equal the CPU's at rel 1e-5."""
    want, _ = _smoke_train_losses("cpu")
    got, state = _smoke_train_losses(dev)
    assert state["params"]["embed"].is_cuda
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_flash_function_on_card_matches_plain_autograd(dev):
    """The recompute backward against autograd through the blocked forward,
    float32 on the card, GQA with softcap and a ragged last block."""
    from repro_torch.models import attention as attn

    dims = attn.AttnDims(n_heads=8, n_kv=2, head_dim=64, scale=0.125,
                         softcap_val=50.0, window=None, q_block=64,
                         kv_block=64, rope_theta=1e4, use_rope=False)
    gen = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn((2, 150, h, 64), generator=gen, device=dev)
               .requires_grad_() for h in (8, 2, 2))
    dout = torch.randn((2, 150, 8, 64), generator=gen, device=dev)
    grads_f = torch.autograd.grad(attn.flash_attention(q, k, v, dims),
                                  (q, k, v), dout)
    plain = attn.flash_forward(q, k, v, dims)[0].reshape(q.shape)
    grads_p = torch.autograd.grad(plain, (q, k, v), dout)
    for gf, gp in zip(grads_f, grads_p):
        assert gf.is_cuda
        err = (gf - gp).abs().max() / gp.abs().max()
        assert float(err) <= 1e-5


def test_async_save_of_card_tensors(dev, tmp_path):
    """An async save of CUDA tensors (bf16 and float32) followed by an
    in-place change restores the values from before the change."""
    from repro_torch.checkpoint import manager as ckpt

    w = torch.randn((64, 64), device=dev).to(torch.bfloat16)
    m = torch.randn((64, 64), device=dev)
    w0, m0 = w.clone(), m.clone()
    saver = ckpt.AsyncSaver()
    saver.save(str(tmp_path), 1, {"w": w, "m": m})
    w.add_(1.0)
    m.mul_(2.0)
    saver.wait()
    got, _ = ckpt.restore(str(tmp_path), 1, {"w": w, "m": m})
    assert got["w"].is_cuda and got["w"].dtype == torch.bfloat16
    assert torch.equal(got["w"], w0) and torch.equal(got["m"], m0)
