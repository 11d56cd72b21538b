"""The port's serve engine against the JAX engine, on the CPU.

Greedy tokens must be identical to the JAX ``Engine`` on the committed mixed
workload ``[4, 6, 48, 5, 8, 44, 6, 7]`` with ``rng=None``, on digital, frozen
``imc_analytic`` and frozen ``imc_bitserial`` (musicgen-medium SMOKE in
float32, JAX parameters carried over).  The block allocator keeps the
reference's contract and conservation law.
"""
import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro import configs as j_configs
from repro.core.imc_linear import IMCConfig as JIMC
from repro.core.substrate import calibrate_model as j_calibrate
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
    for flag in ("--prefix-cache", "--mesh", "--energy-report"):
        with pytest.raises(SystemExit):
            t_serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", flag])


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
