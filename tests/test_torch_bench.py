"""The port's benchmark suite (``repro_torch.benchmarks``) against the JAX
reference's (``benchmarks/``), on the CPU.

Tolerances:
  * the seed bit-serial kernel's plain version against the reference's
    Pallas seed kernel (interpret mode, as the reference runs it), on the
    same numpy codes and noise operand: bit-exact without noise (exact plane
    counts, the same rounding and summation order); with noise at most 0.1%
    of outputs one ADC code of the heaviest plane away (XLA may round the
    noisy sum's division at a knife edge otherwise than PyTorch).  Without
    noise it is also allclose(rtol 0, atol ``order_atol``: 8 float32 ulps
    of the largest partial sum) to the port's bit-serial oracle, the same
    function summed in another order.
  * paper figures without Monte Carlo: the same row names and derived
    strings, values within a relative 1e-6 (integers exact).  The MC
    overlays: the reference tests' closed-form bands (their values are draws
    of another random stream).
  * ``site_snr_records``: equal.
"""
import json
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import benchmarks.layer_snr as j_layer_snr
import benchmarks.paper_figures as j_figs
from benchmarks.kernel_bench import _seed_bitserial_matmul
from repro.kernels import ref as j_ref
from repro_torch.benchmarks import kernel_bench as kb
from repro_torch.benchmarks import layer_snr, paper_figures, run
from repro_torch.core import mc
from repro_torch.core.archs import CMArch, QRArch, QSArch
from repro_torch.kernels import ref
from torch_threads import two_threads  # noqa: F401  (autouse)


def _codes(rng, b, k, m, bx, bw, x_signed):
    x = rng.normal(size=(b, k))
    if not x_signed:
        x = np.abs(x)
    xc = np.clip(np.round(x / np.abs(x).max() * 2.0 ** (bx - x_signed)),
                 -(2 ** (bx - 1)) if x_signed else 0,
                 2 ** (bx - 1) - 1 if x_signed else 2**bx - 1)
    wc = np.clip(np.round(rng.normal(size=(k, m)) * 2.0 ** (bw - 2)),
                 -(2 ** (bw - 1)), 2 ** (bw - 1) - 1)
    return xc.astype(np.float32), wc.astype(np.float32)


SEED_CASES = [
    # (B, K, M, rows, bx, bw, x_signed)
    (5, 96, 12, 32, 4, 4, True),
    (3, 100, 7, 40, 6, 5, False),   # ragged last bank, unsigned inputs
    (4, 64, 9, 64, 7, 7, True),
]


@pytest.mark.parametrize("case", SEED_CASES)
def test_seed_plain_matches_reference_pallas_seed_kernel(case):
    b, k, m, rows, bx, bw, xs = case
    rng = np.random.default_rng(sum(case))
    xc, wc = _codes(rng, b, k, m, bx, bw, xs)
    n_banks = -(-k // rows)
    noise = (0.4 * rng.normal(size=(n_banks, bw * bx, b, m))
             ).astype(np.float32)
    knobs = dict(bx=bx, bw=bw, b_adc=6, rows=rows, k_h=24.0, v_c=22.0,
                 x_signed=xs)
    j_spec, t_spec = j_ref.BitSerialSpec(**knobs), ref.BitSerialSpec(**knobs)
    step = 2.0 ** (bw - 1 + bx - 1) * t_spec.v_c / 2**t_spec.b_adc
    for nz in (None, noise):
        want = np.asarray(_seed_bitserial_matmul(
            jnp.asarray(xc), jnp.asarray(wc),
            None if nz is None else jnp.asarray(nz), j_spec))
        got = kb.seed_bitserial_matmul(
            torch.tensor(xc), torch.tensor(wc),
            None if nz is None else torch.tensor(nz), t_spec).numpy()
        if nz is None:
            np.testing.assert_array_equal(got, want)
        else:
            differ = got != want
            assert differ.mean() <= 1e-3, differ.mean()
            assert np.abs(got - want).max() <= step
    oracle = ref.imc_bitserial_ref(torch.tensor(xc), torch.tensor(wc), None,
                                   t_spec)
    seed = kb.seed_bitserial_plain(torch.tensor(xc), torch.tensor(wc), None,
                                   t_spec)
    torch.testing.assert_close(seed, oracle, rtol=0, atol=kb.order_atol(
        torch.tensor(xc), torch.tensor(wc), t_spec))


def test_seed_dispatch_takes_the_plain_version_on_the_cpu():
    rng = np.random.default_rng(0)
    xc, wc = (torch.tensor(a) for a in _codes(rng, 2, 64, 5, 4, 4, True))
    spec = ref.BitSerialSpec(bx=4, bw=4, b_adc=6, rows=32, k_h=24.0,
                             v_c=22.0, x_signed=True)
    before = kb.seed_bitserial_cuda.launches
    assert torch.equal(kb.seed_bitserial_matmul(xc, wc, None, spec),
                       kb.seed_bitserial_plain(xc, wc, None, spec))
    assert kb.seed_bitserial_cuda.launches == before
    with pytest.raises(ValueError):
        kb.seed_bitserial_cuda(xc, wc, None, spec)


@pytest.mark.parametrize("k,rows", [(100, 40), (96, 32), (70, 64),
                                    (1536, 256)])
def test_seed_plan_covers_ragged_banks(k, rows):
    """The seed kernel's plan (``seed_plan``): each bank as an even number
    of 32-row words, at most one of them past what the bank needs; groups
    that cover every bank once and fit shared memory.  Plane words built as
    the kernel builds them (a code's low 8 bits from an add of 1.5 * 2^23;
    row r of word d live while 32 d + r is below the bank's rows, else a
    zero code) give each bank's plane dots of the plain version, the ragged
    last bank's included."""
    rng = np.random.default_rng(1)
    b, m, bx, bw = 3, 5, 6, 5
    xc, wc = (torch.tensor(a) for a in _codes(rng, b, k, m, bx, bw, True))
    plan = kb.seed_plan(b, k, m, rows, bx, bw)
    need = -(-min(rows, k) // 32)
    assert plan.n_banks == -(-k // rows)
    assert plan.words % 2 == 0 and need <= plan.words <= need + 1
    starts = range(0, plan.n_banks, plan.group)
    assert sum(min(plan.group, plan.n_banks - g) for g in starts) == \
        plan.n_banks
    assert 1 <= plan.chunk <= plan.b_rows and plan.smem_bytes <= kb.SMEM_BYTES
    # 1 column tile: the 3 batch rows split over CTAs of one row each
    assert plan.b_rows == 1

    def low_bits(codes):
        return (codes + 12582912.0).view(torch.int32) & 0xFF

    xb, wb = low_bits(xc), low_bits(wc)
    spec = ref.BitSerialSpec(bx=bx, bw=bw, rows=rows, x_signed=True,
                             apply_adc=False)
    for bank, terms in enumerate(kb._seed_banks(xc, wc, None, spec)):
        live = min(rows, k - bank * rows)
        counts = torch.zeros((bw, bx, b, m), dtype=torch.int64)
        for word in range(plan.words):
            r = 32 * word + torch.arange(32)
            ok = r < live
            rows_k = (bank * rows + r).clamp(max=k - 1)
            xw = torch.where(ok, xb[:, rows_k], 0).to(torch.int64)
            ww = torch.where(ok[:, None], wb[rows_k], 0).to(torch.int64)
            for i in range(bw):
                for j in range(bx):
                    counts[i, j] += ((xw >> j) & 1) @ ((ww >> i) & 1)
        assert len(terms) == bw * bx
        for t, (_, dp) in enumerate(terms):
            assert torch.equal(counts[t // bx, t % bx].to(torch.float32), dp)


# ---------------------------------------------------------------------------
# paper figures and the per-site SNR map
# ---------------------------------------------------------------------------


def _same_rows(got, want):
    assert [r[0] for r in got] == [r[0] for r in want]
    for (name, gv, gd), (_, wv, wd) in zip(got, want):
        assert gd == wd, name
        if isinstance(wv, (int, np.integer)) and not isinstance(wv, bool):
            assert gv == wv, name
        else:
            assert math.isclose(gv, float(wv), rel_tol=1e-6), (name, gv, wv)


@pytest.mark.parametrize("name", ["fig4", "fig12", "fig13", "pareto"])
def test_closed_form_figures_match_reference(name):
    _same_rows(paper_figures.ALL[name](), j_figs.ALL[name]())


# (figure, MC ensemble of the reference test that bands it, band on S - E)
MC_BANDS = {"fig9": (600, -1.0, 1.0), "fig10": (2400, -1.0, 3.5),
            "fig11": (2400, -2.5, 2.5)}


@pytest.mark.parametrize("name", list(MC_BANDS))
def test_mc_figures_match_reference_outside_the_overlay(name):
    ens, lo, hi = MC_BANDS[name]
    got = paper_figures.ALL[name](mc_ens=ens, gen=mc.generator(0, "cpu"))
    want = j_figs.ALL[name]()
    mc_rows = [i for i, r in enumerate(want) if "/S_snrA_" in r[0]]
    assert len(mc_rows) == 1 and [r[0] for r in got] == [r[0] for r in want]
    i = mc_rows[0]
    _same_rows(got[:i] + got[i + 1:], want[:i] + want[i + 1:])
    e_a = float(got[i][2].split("E=")[1].split()[0])
    assert got[i][2] == want[i][2]
    assert lo < got[i][1] - e_a < hi, (got[i], e_a)


def test_site_snr_records_equal_reference():
    assert layer_snr.site_snr_records() == j_layer_snr.site_snr_records()


def test_whole_model_snr_sweep_is_not_ported():
    """(Named when the sweep raised.)  The sweep is ported, and like every
    entry point of the port it runs on the card unless given a device: with
    none it raises where PyTorch sees no GPU, before it builds a model.
    tests/test_torch_train.py holds its rows and values on the CPU against
    the JAX package."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    for call in (lambda: layer_snr.whole_model_snr_sweep("mamba2-2.7b", b=1,
                                                         s=8, levels=(40.0,)),
                 layer_snr.run):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_mc_convergence_records():
    recs = paper_figures.mc_convergence("cpu", ens_values=(200, 400),
                                        seeds=range(2))
    assert [(r["point"], r["ens"]) for r in recs] == [
        (p, e) for p in paper_figures.MC_POINTS for e in (200, 400)]
    assert [r["n"] for r in recs[::2]] == [512, 512, 512, 128, 64]
    for r in recs:
        assert r["seeds"] == 2 and all(math.isfinite(r[k]) for k in (
            "gap_mean_db", "gap_std_db", "adc_mean_db", "adc_std_db"))
    kinds = [type(a) for a, _ in paper_figures.MC_POINTS.values()]
    assert kinds == [QSArch, QRArch, CMArch, QRArch, CMArch]


# ---------------------------------------------------------------------------
# the kernel bench and run.py
# ---------------------------------------------------------------------------


def test_kernel_bench_records_on_the_cpu(monkeypatch):
    monkeypatch.setattr(kb, "SHAPES", [(8, 96, 20, 4, 5)])
    monkeypatch.setattr(kb, "PAGED_SHAPES", [(2, 4, 8, 2, 2, 16)])
    recs = kb.bench_records("cpu", iters=1)
    by = {(r["bench"], r.get("config")): r for r in recs}
    seed_n = by[("bitserial", "seed_baseline_noise")]
    # one (96-row) bank; the seed reads the float32 codes as they are, one
    # launch, no plane scratch; bitserial.cu one byte per code, K padded to
    # 96 (16-row steps) and its columns to 24
    assert seed_n["noise_bytes"] == 1 * 5 * 4 * 8 * 20 * 4
    assert seed_n["x_code_bytes"] == 4 * 8 * 96
    assert seed_n["w_code_bytes"] == 4 * 96 * 20
    assert seed_n["plane_bytes"] == 0
    assert seed_n["plane_macs"] == 8 * 96 * 20 * 20
    assert seed_n["kernel_launches"] == 1
    kern = by[("bitserial", "kernel_noise")]
    assert kern["noise_bytes"] == 4 and kern["w_code_bytes"] == 96 * 24
    summary = by[("bitserial_summary", None)]
    assert summary["noise_bytes_reduction"] == seed_n["noise_bytes"] / 4
    paged = by[("paged_attention_summary", None)]
    assert paged["gathered_kv_bytes_before"] == 2 * 4 * 8 * 2 * 16 * 8
    # the kernel's shared-memory ring: O(1) in sequence length (larger than
    # this toy table's whole KV)
    plan = kb.paged_attention.plan_split(2, 2, 2, 16, 8, 4, 4)
    assert paged["gathered_kv_bytes_after"] == (
        kb.paged_attention.STAGES * 2 * plan.stage_rows * plan.heads * 16 * 4)
    for r in recs:
        if r["bench"] in ("bitserial", "paged_attention"):
            assert kb.time_key(r) == "cpu_wall_ms"
    rows = kb.rows_from_records(recs)
    assert len(rows) == len(recs) and all(r[0].startswith("kernel/")
                                          for r in rows)


def test_run_writes_a_report_for_the_fast_suites(tmp_path):
    path = tmp_path / "bench.json"
    run.main(["--only", "fig4,fig12,fig13,pareto,site_snr", "--json",
              str(path), "--device", "cpu"])
    report = json.loads(path.read_text())
    assert report["schema"] == run.SCHEMA
    assert report["meta"]["device"] == "cpu"
    assert sorted(report["suites"]) == sorted(["fig4", "fig12", "fig13",
                                               "pareto", "site_snr"])
    fig4 = report["suites"]["fig4"]["records"]
    assert fig4[0]["name"] == "fig4/sqnr_qiy_7b_dB"
    assert report["suites"]["site_snr"]["records"][-1]["bench"] == \
        "site_snr_summary"


@pytest.mark.parametrize("only,exc", [("serve", NotImplementedError),
                                      ("fig4,model_energy", NotImplementedError),
                                      ("roofline", NotImplementedError),
                                      ("fig99", KeyError)])
def test_run_refuses_unported_and_unknown_suites(only, exc, tmp_path):
    with pytest.raises(exc):
        run.main(["--only", only, "--json", str(tmp_path / "x.json"),
                  "--device", "cpu"])
    assert not (tmp_path / "x.json").exists()


def test_run_never_writes_a_reference_baseline(tmp_path):
    with pytest.raises(SystemExit):
        run.main(["--only", "fig4", "--json",
                  str(tmp_path / "BENCH_kernels.json"), "--device", "cpu"])
