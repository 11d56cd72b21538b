"""The port's serve engine against the JAX engine, on the CPU.

Greedy tokens must be identical to the JAX ``Engine`` on the committed mixed
workload ``[4, 6, 48, 5, 8, 44, 6, 7]`` with ``rng=None``, on digital, frozen
``imc_analytic`` and frozen ``imc_bitserial`` (musicgen-medium SMOKE in
float32, JAX parameters carried over).  The block allocator keeps the
reference's contract and conservation law.  The CLI with CI serve smoke 1's
flags (``--energy-report``) bills what the JAX main bills, and with smoke 4's
(a 2x bursty overload under deadline scheduling, lazy KV and frontier
degradation) gives the same tokens and SLO counters.
"""
import contextlib
import io

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro import configs as j_configs
from repro.core.imc_linear import IMCConfig as JIMC
from repro.core.substrate import calibrate_model as j_calibrate
from repro.core.substrate import substrate_for_design as j_for_design
from repro.launch import metering as j_metering
from repro.launch import serve as j_serve
from repro.models import init_params as j_init_params
from repro_torch import configs as t_configs
from repro_torch.convert import params_from_jax
from repro_torch.core.imc_linear import IMCConfig as TIMC
from repro_torch.core.substrate import calibrate_model as t_calibrate
from repro_torch.launch import serve as t_serve

ARCH = "musicgen-medium"
MIXED_LENS = [4, 6, 48, 5, 8, 44, 6, 7]


def _setup(mode):
    cfg_j = j_configs.get_smoke(ARCH)
    cfg_t = t_configs.get_smoke(ARCH)
    if mode != "digital":
        kw = dict(mode=mode, bx=7, bw=7, v_wl=0.7)
        cfg_j, cfg_t = cfg_j.replace(imc=JIMC(**kw)), cfg_t.replace(
            imc=TIMC(**kw))
    params_j = j_init_params(jax.random.PRNGKey(0), cfg_j)
    params_t = params_from_jax(jax.tree_util.tree_map(np.asarray, params_j),
                               "cpu")
    if mode != "digital":
        ref = np.random.default_rng(1).integers(0, cfg_j.vocab_size, (2, 24))
        cfg_j = j_calibrate(cfg_j, params_j, [ref])
        cfg_t = t_calibrate(cfg_t, params_t, [ref])
    return cfg_j, cfg_t, params_j, params_t


def _tokens(serve_mod, cfg, params, lens=MIXED_LENS, max_new=6,
            kv_blocks=None, **kw):
    rnp = np.random.default_rng(11)
    reqs = [serve_mod.Request(rid=i, prompt=rnp.integers(0, cfg.vocab_size, n),
                              max_new=max_new)
            for i, n in enumerate(lens)]
    engine = serve_mod.Engine(cfg, params, batch_slots=4,
                              cache_len=48 + max_new + 8, max_chunk=4,
                              block_size=8, kv_blocks=kv_blocks, **kw)
    done = serve_mod.serve(engine, reqs)
    assert all(r.error is None for r in done)
    return {r.rid: r.out for r in done}, engine


@pytest.mark.parametrize("mode", ["digital", "imc_analytic",
                                  "imc_bitserial"])
def test_engine_tokens_match_reference(mode):
    cfg_j, cfg_t, params_j, params_t = _setup(mode)
    out_j, eng_j = _tokens(j_serve, cfg_j, params_j)
    out_t, eng_t = _tokens(t_serve, cfg_t, params_t)
    assert out_t == out_j
    # same scheduling: prefill groups, decode chunks, one transfer per chunk
    assert (eng_t.prefill_calls, eng_t.prefill_rows, eng_t.decode_calls,
            eng_t.decode_steps) == (eng_j.prefill_calls, eng_j.prefill_rows,
                                    eng_j.decode_calls, eng_j.decode_steps)
    assert eng_t.host_transfer_bytes == eng_j.host_transfer_bytes


def test_preemption_resume_matches_ample_pool_and_gather():
    """Recompute-preemption under a tight pool reproduces the ample-pool run
    token for token, on the kernel path and on the gather escape hatch."""
    _, cfg_t, _, params_t = _setup("imc_analytic")
    lens = [4, 6, 48, 5]
    ample, _ = _tokens(t_serve, cfg_t, params_t, lens)
    tight, eng = _tokens(t_serve, cfg_t, params_t, lens, kv_blocks=12)
    gather, _ = _tokens(t_serve, cfg_t.replace(decode_attn="gather"),
                        params_t, lens, kv_blocks=12)
    assert eng.preempt_count >= 1
    assert tight == ample == gather


def test_engine_equals_sequential_under_frozen_calibration():
    _, cfg_t, _, params_t = _setup("imc_bitserial")
    lens = [5, 9, 12]
    batched, _ = _tokens(t_serve, cfg_t, params_t, lens, max_new=4)
    for i, n in enumerate(lens):
        rnp = np.random.default_rng(11)
        prompts = [rnp.integers(0, cfg_t.vocab_size, m) for m in lens]
        eng = t_serve.Engine(cfg_t, params_t, batch_slots=1,
                             cache_len=48 + 4 + 8, max_chunk=4)
        done = t_serve.serve(eng, [t_serve.Request(rid=i, prompt=prompts[i],
                                                   max_new=4)])
        assert done[0].out == batched[i]


def test_reserve_policy_and_oversized_requests():
    cfg_j, cfg_t, params_j, params_t = _setup("digital")
    lazy, _ = _tokens(t_serve, cfg_t, params_t, [4, 6, 48])
    reserve, _ = _tokens(t_serve, cfg_t, params_t, [4, 6, 48],
                         alloc_policy="reserve")
    assert lazy == reserve
    eng = t_serve.Engine(cfg_t, params_t, batch_slots=2, cache_len=16)
    big = t_serve.Request(rid=0, prompt=np.arange(20), max_new=4)
    small = t_serve.Request(rid=1, prompt=np.arange(4), max_new=2)
    done = t_serve.serve(eng, [big, small])
    assert big.error and big.error_kind == "admission"
    assert small.ok and len(small.out) == 2 and len(done) == 2


def test_swap_calibration_keeps_site_names():
    _, cfg_t, _, params_t = _setup("imc_analytic")
    eng = t_serve.Engine(cfg_t, params_t, batch_slots=2, cache_len=32)
    cal = cfg_t.imc.calibration
    eng.swap_calibration(cal.merge(cal))
    assert eng.swap_count == 1 and eng.cfg.imc.calibration == cal
    with pytest.raises(ValueError):
        eng.swap_calibration(type(cal).from_dict(
            {"*": dict(x_max=1.0, w_max=1.0, sigma_yo=1.0)}))


@pytest.mark.parametrize("length", [1, 7, 8, 9, 33, 64, 100])
def test_prefill_bucket_matches_reference(length):
    for cache_len in (16, 64, 10**9):
        assert (t_serve.prefill_bucket(length, True, cache_len)
                == j_serve.prefill_bucket(length, True, cache_len))


def test_cli_serves_on_cpu_and_refuses_unported_flags():
    rep = t_serve.main(["--arch", ARCH, "--smoke", "--batch", "2",
                        "--requests", "3", "--prompt-lens", "4,9", "--gen",
                        "3", "--imc-mode", "imc_bitserial", "--imc-policy",
                        "frozen", "--device", "cpu"])
    assert len(rep["finished"]) == 3 and rep["tokens"] == 9
    assert rep["engine"].host_transfer_bytes > 0
    # tensor-parallel meshes serve (tests/test_torch_sharded.py); slots
    # sharded over data replicas (R > 1) are still refused
    with pytest.raises(SystemExit):
        t_serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                      "--mesh", "2x1"])
    # the prefix and drift flags are ported and run
    rep = t_serve.main(["--arch", ARCH, "--smoke", "--batch", "2",
                        "--requests", "4", "--prompt-lens", "3,9", "--gen",
                        "3", "--imc-mode", "imc_bitserial", "--imc-policy",
                        "frozen", "--prefix-cache", "--shared-prefix-len",
                        "16", "--prefix-dup", "2", "--recalibrate",
                        "--drift-sample-every", "1", "--drift-check-every",
                        "2", "--drift-pause-depth", "8", "--inject-drift",
                        "1.5@2", "--device", "cpu"])
    # the first two share one cold group; both later admissions are hits
    assert rep["tokens"] == 12 and rep["engine"].prefix_hits == 2
    assert rep["monitor"].counters()["shadow_samples"] >= 2
    # --recalibrate needs a frozen substrate, as in the reference
    with pytest.raises(SystemExit):
        t_serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                      "--recalibrate", "--imc-mode", "imc_analytic"])
    # --degrade needs the frozen analytic substrate, as in the reference
    with pytest.raises(SystemExit):
        t_serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                      "--degrade", "--imc-mode", "imc_bitserial"])


@given(num_blocks=st.integers(2, 32),
       ops=st.lists(st.tuples(st.integers(0, 4), st.integers(0, 12)),
                    min_size=1, max_size=80))
@settings(max_examples=60, deadline=None)
def test_allocator_matches_reference_and_conserves(num_blocks, ops):
    """Drive the port's and the reference's allocators with the same
    admit / share / release / cache / evict sequence: identical blocks and
    refcounts, and ``free + referenced + idle_cached == num_blocks - 1``."""
    a_t = t_serve.BlockAllocator(num_blocks)
    a_j = j_serve.BlockAllocator(num_blocks)
    live, cached = [], set()
    for op, n in ops:
        if op == 0:
            got = a_t.alloc(max(1, n % 4))
            assert got == a_j.alloc(max(1, n % 4))
            if got is not None:
                live.append(got)
        elif op == 1 and live:
            src = live[n % len(live)]
            a_t.retain(src)
            a_j.retain(src)
            live.append(list(src))
        elif op == 2 and live:
            blocks = live.pop(n % len(live))
            a_t.free(blocks)
            a_j.free(blocks)
        elif op == 3 and live:
            blocks = live[n % len(live)]
            b = blocks[n % len(blocks)]
            cached.add(b)
            a_t.register_cached(b)
            a_j.register_cached(b)
        elif op == 4:
            refs = {b for blocks in live for b in blocks}
            idle = sorted(cached - refs)
            if idle:
                b = idle[n % len(idle)]
                a_t.evict(b)
                a_j.evict(b)
                cached.remove(b)
        refs = {b for blocks in live for b in blocks}
        held = refs | cached
        assert 0 not in held
        assert a_t.free_count + len(held) == num_blocks - 1
        assert (a_t.free_count, a_t.used_count, a_t.evictable_count) == (
            a_j.free_count, a_j.used_count, a_j.evictable_count)
        for b in held:
            assert a_t.refcount(b) == a_j.refcount(b)


def test_allocator_rejects_double_free():
    a = t_serve.BlockAllocator(4)
    blocks = a.alloc(2)
    a.free(blocks)
    with pytest.raises(ValueError):
        a.free(blocks)
    assert a.alloc(4) is None and a.free_count == 3
    assert torch.tensor(a.alloc(3)).unique().numel() == 3


# ---------------------------------------------------------------------------
# the CLI against the JAX main: CI serve smokes 1 and 4
# ---------------------------------------------------------------------------

SMOKE1 = ["--arch", ARCH, "--smoke", "--batch", "4", "--gen", "8",
          "--requests", "6", "--prompt-lens", "5,9,32,4,17,6",
          "--energy-report"]
SMOKE4 = ["--arch", ARCH, "--smoke", "--batch", "4", "--gen", "8",
          "--requests", "12", "--chunk", "4", "--kv-blocks", "11",
          "--workload", "bursty", "--workload-seed", "0", "--overload", "2.0",
          "--slo-policy", "deadline", "--alloc", "lazy", "--degrade",
          "--imc-mode", "imc_analytic", "--imc-policy", "frozen"]


@pytest.fixture(scope="module")
def jax_mains():
    """Each smoke through the JAX main once, keeping its meter, engine and
    printed output."""
    meters, engines = [], []

    class Meter(j_metering.DPMeter):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            meters.append(self)

    class Engine(j_serve.Engine):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            engines.append(self)

    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_metering, "DPMeter", Meter)
        mp.setattr(j_serve, "Engine", Engine)
        for name, argv in (("smoke1", SMOKE1), ("smoke4", SMOKE4)):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                finished = j_serve.main(argv)
            out[name] = dict(finished=finished, engine=engines[-1],
                             stdout=buf.getvalue(),
                             meter=meters[-1] if name == "smoke1" else None)
    return out


def _port_main(argv, monkeypatch, capsys):
    """The port's main on the CPU with the JAX main's parameters
    (``init_params(PRNGKey(0))``, carried over)."""
    def jax_params(cfg, seed=0, device=None):
        cfg_j = j_configs.get_smoke(ARCH).replace(imc=None)
        params = j_init_params(jax.random.PRNGKey(0), cfg_j)
        return params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                               device)

    monkeypatch.setattr(t_serve, "init_params", jax_params)
    rep = t_serve.main(argv + ["--device", "cpu"])
    return rep, capsys.readouterr().out


def test_cli_energy_report_matches_reference(jax_mains, monkeypatch, capsys):
    ref = jax_mains["smoke1"]
    rep, out = _port_main(SMOKE1, monkeypatch, capsys)
    mj, mt = ref["meter"], rep["meter"]
    for field in ("prefill_billed_tokens", "prefill_true_tokens",
                  "prefill_rows", "prefill_groups", "decode_billed_tokens",
                  "decode_chunks"):
        assert getattr(mt, field) == getattr(mj, field), field
    assert rep["tokens"] == sum(len(r.out) for r in ref["finished"])
    from repro.core.design import optimize

    billed = [(t, k) for t in (14.0, 26.0) for k in ("qs", "qr", "cm")
              if optimize(n=512, snr_t_target_db=t, kinds=(k,)) is not None]
    assert len(rep["energy"]) == len(billed)
    for (t, k), e_t in zip(billed, rep["energy"]):
        e_j = j_metering.serve_energy_report(
            mj, substrate=j_for_design(optimize(n=512, snr_t_target_db=t,
                                                kinds=(k,))),
            generated_tokens=rep["tokens"], requests=len(ref["finished"]))
        for attr in ("j_per_token", "j_per_request", "edp_per_token"):
            assert getattr(e_t, attr) == pytest.approx(
                getattr(e_j, attr), rel=1e-12, abs=0.0), (t, k, attr)
    # the printed energy table is the reference's, line for line
    table = out[out.index("serve-path energy"):].strip()
    assert table in ref["stdout"]


def test_cli_overload_degrade_matches_reference(jax_mains, monkeypatch,
                                                capsys):
    ref = jax_mains["smoke4"]
    rep, out = _port_main(SMOKE4, monkeypatch, capsys)
    tok_j = {r.rid: (r.out, r.error_kind) for r in ref["finished"]}
    tok_t = {r.rid: (r.out, r.error_kind) for r in rep["finished"]}
    assert tok_t == tok_j and len(tok_t) == 12
    eng_j, eng_t = ref["engine"], rep["engine"]
    assert eng_t.clock.now == eng_j.clock.now
    for attr in ("preempt_count", "shed_requests", "substrate_swaps",
                 "decode_steps", "prefill_calls"):
        assert getattr(eng_t, attr) == getattr(eng_j, attr), attr
    summary_j = j_metering.slo_summary(ref["finished"],
                                       elapsed=eng_j.clock.now,
                                       policy="deadline")
    for k, v in summary_j.items():
        assert rep["slo"][k] == v or (v != v and rep["slo"][k] != rep["slo"][k]), k
    assert rep["slo"]["pool_utilization"] == round(
        eng_j.pool_utilization(), 4)
    # the printed SLO summary is the reference's, line for line
    printed = out[out.index("serve_slo ["):].strip()
    assert printed in ref["stdout"]
