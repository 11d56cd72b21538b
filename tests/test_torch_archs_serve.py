"""The serve engine on the dense public architectures (phi3-mini-3.8b,
deepseek-coder-33b, granite-20b, gemma2-9b) against the JAX engine, on the
CPU, on their SMOKE configs in float32 with the JAX parameters carried over
(``tests/test_torch_archs.py`` holds the models themselves).

Greedy tokens must be identical to the JAX ``Engine`` (``rng=None``) on
digital and frozen imc_analytic, and on frozen imc_bitserial to the JAX
package's greedy run of the same requests up to checked knife edges (see
``test_engine_tokens_match_reference``); with the JAX engine's scheduling
and KV accounting.  Where the window wraps, every request's
tokens equal its sequential run (prefill + decode_step), in the port and in
the JAX package.
"""
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import substrate as j_sub
from repro.core.imc_linear import IMCConfig as JIMC
from repro.launch import serve as j_serve
from repro.models import decode_step as j_decode
from repro.models import prefill as j_prefill
from repro_torch import configs as t_configs
from repro_torch.configs.base import ArchConfig as TArch
from repro_torch.core import substrate as t_sub
from repro_torch.core.imc_linear import IMCConfig as TIMC
from repro_torch.core.substrate import calibrate_model as t_calibrate
from repro_torch.launch import serve as t_serve
from repro_torch.models import decode_step as t_decode
from repro_torch.models import init_params as t_init_params
from repro_torch.models import prefill as t_prefill
from repro_torch.runtime import fault as t_fault
from test_torch_archs import ARCHS, TINY, _np, _smoke, _windowed


_CALIBRATIONS = {}


def _with_mode(cfg_j, cfg_t, params_j, params_t, mode):
    """Both configs on ``mode``, each under its own package's frozen
    calibration on one seeded reference batch, the two held equal site by
    site (as ``tests/test_torch_model.py`` holds them on musicgen).  The
    recorded ranges do not depend on the IMC mode (every site runs the
    noiseless fakequant proxy while recording), so the analytic and
    bit-serial cases of an architecture share one calibration pass in each
    package."""
    if mode == "digital":
        return cfg_j, cfg_t
    kw = dict(mode=mode, bx=7, bw=7, v_wl=0.7)
    cfg_j, cfg_t = cfg_j.replace(imc=JIMC(**kw)), cfg_t.replace(
        imc=TIMC(**kw))
    if cfg_t.name not in _CALIBRATIONS:
        ref = np.random.default_rng(1).integers(0, cfg_j.vocab_size, (2, 24))
        cal_j = j_sub.calibrate_model(cfg_j, params_j, [ref]).imc.calibration
        cal_t = t_calibrate(cfg_t, params_t, [ref]).imc.calibration
        d_j, d_t = cal_j.to_dict(), cal_t.to_dict()
        assert sorted(d_j) == sorted(d_t)
        for site in d_j:
            for f, v in d_j[site].items():
                assert d_t[site][f] == pytest.approx(v, rel=1e-5), (site, f)
        _CALIBRATIONS[cfg_t.name] = cal_j, cal_t
    cal_j, cal_t = _CALIBRATIONS[cfg_t.name]
    return (cfg_j.replace(imc=j_sub.as_substrate(cfg_j.imc).frozen(cal_j)),
            cfg_t.replace(imc=t_sub.as_substrate(cfg_t.imc).frozen(cal_t)))


def _engine_tokens(serve_mod, cfg, params, lens, max_new, **kw):
    rnp = np.random.default_rng(11)
    reqs = [serve_mod.Request(rid=i, prompt=rnp.integers(0, cfg.vocab_size, n),
                              max_new=max_new)
            for i, n in enumerate(lens)]
    engine = serve_mod.Engine(cfg, params, batch_slots=4,
                              cache_len=32 + max_new + 8, max_chunk=4,
                              block_size=8, **kw)
    done = serve_mod.serve(engine, reqs)
    assert all(r.error is None for r in done)
    return {r.rid: r.out for r in done}, engine


def _replay(prefill_fn, decode_fn, prompts, outs, to_dev, to_np,
            max_new=None):
    """Logits of every generated position of several requests at once, each
    on its history ``prompt + out``: one bucketed prefill of the prompts
    (``true_len``), then decode_step on the contiguous caches with per-row
    positions.  With ``outs=None`` the histories are the greedy picks
    themselves (``max_new`` tokens a request).  Returns (rows, len(out),
    V)."""
    lens = [len(p) for p in prompts]
    bucket = t_serve.prefill_bucket(max(lens), True, 10**9)
    toks = np.zeros((len(prompts), bucket), np.int64)
    for r, p in enumerate(prompts):
        toks[r, :len(p)] = p
    logits, cache = prefill_fn(to_dev(toks), to_dev(np.asarray(lens)))
    rows = [to_np(logits)[:, -1]]
    for t in range((max_new if outs is None else len(outs[0])) - 1):
        col = (rows[-1].argmax(-1) if outs is None
               else np.asarray([o[t] for o in outs]))
        logits, cache = decode_fn(to_dev(col), cache)
        rows.append(to_np(logits)[:, 0])
    return np.stack(rows, axis=1)


# The largest logit deviation between the two packages' replays of the
# bit-serial requests whose tokens match, over the four SMOKE configs of
# ``test_engine_tokens_match_reference``: 0.0827 (deepseek-coder-33b; PERF.md
# §6).  A deviation of that size is one flipped quantizer code; every
# deviation is held to twice it, so a knife edge passes only where the port
# stays that close to the reference.
EDGE_DEV_CAP = 2 * 0.0827


def _jax_greedy(cfg_j, params_j, prompts, max_new, cache_len):
    """The reference's greedy run of every request at once (a bucketed
    prefill, then decode_step on the contiguous caches, each row fed its
    own pick): ({rid: tokens}, logits (rows, max_new, V)).  Under frozen
    calibration it is the JAX engine's run (the reference's contract: the
    engine equals sequential execution), in one pass of the bit-serial
    oracle instead of an engine run and a replay."""
    lj = _replay(
        jax.jit(lambda t, n: j_prefill(params_j, cfg_j, t, cache_len,
                                       true_len=n)),
        jax.jit(lambda t, c: j_decode(params_j, cfg_j, t, c)), prompts, None,
        lambda a: jnp.asarray(a, jnp.int32), _np, max_new)
    return {r: [int(t) for t in lj[r].argmax(-1)]
            for r in range(len(prompts))}, lj


def _knife_edges(lj, cfg_t, params_t, prompts, outs, cache_len):
    """The port replays the requests on the reference's histories
    ``prompts[r] + outs[r]`` (``lj``: the reference's logits there).
    Returns the largest logit deviation between them over every position,
    and where the port's greedy pick differs from the reference's: (row,
    position, pick J, pick T, J's margin between the two, the deviation
    there)."""
    lt = _replay(
        lambda t, n: t_prefill(params_t, cfg_t, t, cache_len, true_len=n),
        lambda t, c: t_decode(params_t, cfg_t, t, c), prompts, outs,
        torch.tensor, lambda a: a.numpy())
    edges = []
    for r in range(len(prompts)):
        for i, (a, b) in enumerate(zip(lj[r], lt[r])):
            pj, pt = int(a.argmax()), int(b.argmax())
            if pj != pt:
                edges.append((r, i, pj, pt, float(a[pj] - a[pt]),
                              float(np.abs(a - b).max())))
    return float(np.abs(lj - lt).max()), edges


_JAX_ENGINES = {}


def _jax_engine(arch, mode, cfg_j, cfg_j0, params_j, lens, max_new):
    """The JAX engine's tokens, then its counters and KV accounting, on
    ``mode`` (memoized: the digital run serves the bit-serial case's
    scheduling check too)."""
    if (arch, mode) not in _JAX_ENGINES:
        out, eng = _engine_tokens(j_serve, cfg_j0 if mode == "digital"
                                  else cfg_j, params_j, lens, max_new)
        _JAX_ENGINES[(arch, mode)] = out, (
            eng.prefill_calls, eng.prefill_rows, eng.decode_calls,
            eng.decode_steps, eng._block_bytes, eng._fixed_kv_bytes,
            eng.kv_pool_bytes())
    return _JAX_ENGINES[(arch, mode)]


@pytest.mark.parametrize("mode", ["digital", "imc_analytic",
                                  "imc_bitserial"])
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_tokens_match_reference(arch, mode):
    """Mixed prompt lengths (gemma2's 30-token prompt and 14 new tokens wrap
    its 16-token ring) on both engines: identical greedy tokens and the same
    scheduling.

    imc_bitserial: the port's bit-serial oracle sums the ADC outputs of the
    49 plane pairs in float64 and rounds once, the reference's in float32
    (``tests/test_torch_kernels.py``), so an output differs in its last bits
    and a downstream quantizer code can flip where an activation sits on a
    rounding edge.  The reference's tokens and logits come from one greedy
    run of every request in the JAX package (``_jax_greedy``: under frozen
    calibration the JAX engine's tokens, by the reference's contract, for
    one pass of its bit-serial oracle instead of two), its scheduling and
    KV accounting from the JAX engine's digital run of the same requests;
    the port replays every request on the reference's tokens (a bucketed
    prefill, then decode_step on contiguous caches): the logits may deviate
    by at most ``EDGE_DEV_CAP`` anywhere; every request whose tokens differ
    must have a differing pick, each such pick only where the reference's
    own margin between the two picks is within the packages' logit
    deviation at that position (a knife edge), and the port's engine must
    equal its own sequential greedy run (the frozen-calibration
    contract)."""
    cfg_j0, cfg_t, params_j, params_t = _smoke(arch)
    cfg_j, cfg_t = _with_mode(cfg_j0, cfg_t, params_j, params_t, mode)
    lens, max_new = [5, 30, 9, 3, 17], 14
    out_t, eng_t = _engine_tokens(t_serve, cfg_t, params_t, lens, max_new)
    # the JAX engine's scheduling and KV accounting do not depend on the
    # substrate: the bit-serial case takes them from the digital engine's
    # run of the same requests (shared with the digital case)
    out_j, cnt_j = _jax_engine(arch, "digital" if mode == "imc_bitserial"
                               else mode, cfg_j, cfg_j0, params_j, lens,
                               max_new)
    assert (eng_t.prefill_calls, eng_t.prefill_rows, eng_t.decode_calls,
            eng_t.decode_steps, eng_t._block_bytes, eng_t._fixed_kv_bytes,
            eng_t.kv_pool_bytes()) == cnt_j
    if mode != "imc_bitserial":
        assert out_t == out_j
        return
    rnp = np.random.default_rng(11)
    prompts = [rnp.integers(0, cfg_t.vocab_size, n) for n in lens]
    cache_len = 32 + max_new + 8
    out_j, lj = _jax_greedy(cfg_j, params_j, prompts, max_new, cache_len)
    differ = [rid for rid in out_j if out_t[rid] != out_j[rid]]
    worst, edges = _knife_edges(lj, cfg_t, params_t, prompts,
                                [out_j[r] for r in range(len(lens))],
                                cache_len)
    assert worst <= EDGE_DEV_CAP, worst
    assert {e[0] for e in edges} == set(differ), (differ, edges)
    for r, i, pj, pt, margin, dev in edges:
        assert margin <= dev, (r, i, pj, pt, margin, dev)
    for rid in differ:
        assert out_t[rid] == _greedy_sequential(cfg_t, params_t,
                                                prompts[rid], max_new)


def _greedy_sequential(cfg, params, prompt, max_new):
    """One request alone: exact-length prefill, then decode_step on the
    contiguous caches (the reference serve tests' sequential oracle)."""
    logits, cache = t_prefill(params, cfg, torch.tensor(prompt)[None, :],
                              len(prompt) + max_new + 8)
    out = [int(torch.argmax(logits[0, -1]))]
    while len(out) < max_new:
        logits, cache = t_decode(params, cfg, torch.tensor([out[-1]]), cache)
        out.append(int(torch.argmax(logits[0, 0])))
    return out


@pytest.mark.parametrize("draw", ["paged", "engine"])
def test_sliding_window_wrap(draw):
    """The reference's window-wrap holds (tests/test_serve_paged.py
    ``test_sliding_window_wrap``, tests/test_serve_engine.py
    ``test_engine_beyond_window_unequal``): local layers keep per-slot rings
    that wrap at their own phase while the global layers run paged; generate
    far past the window from bucket-padded prefills of different true
    lengths.  Every request's tokens equal its sequential run; on the
    second test's draws they also equal the JAX engine's."""
    cfg_j, cfg_t, params_j, params_t = _windowed()
    lens, max_new = [6, 13, 20, 27], 24
    # each reference test's prompt draws
    rnp = np.random.default_rng(7 if draw == "paged" else 4)
    prompts = [rnp.integers(0, cfg_t.vocab_size, n) for n in lens]
    engine = t_serve.Engine(cfg_t, params_t, batch_slots=4,
                            cache_len=32 + max_new + 8, max_chunk=8)
    out = t_serve.serve(engine, [t_serve.Request(rid=i, prompt=p,
                                                 max_new=max_new)
                                 for i, p in enumerate(prompts)])
    assert engine.alloc.used_count == 0
    for r in out:
        ref = _greedy_sequential(cfg_t, params_t, prompts[r.rid], max_new)
        assert r.out == ref, (r.rid, r.out, ref)
    if draw == "paged":
        return
    # the JAX engine gives the same tokens
    eng_j = j_serve.Engine(cfg_j, params_j, batch_slots=4,
                           cache_len=32 + max_new + 8, max_chunk=8)
    out_j = j_serve.serve(eng_j, [j_serve.Request(rid=i, prompt=p,
                                                  max_new=max_new)
                                  for i, p in enumerate(prompts)])
    assert {r.rid: r.out for r in out} == {r.rid: r.out for r in out_j}


def test_decode_retry_restores_wrapped_rings(monkeypatch):
    """A transient device error at the last step of a decode chunk, after
    three steps have overwritten rows of gemma2's wrapped 16-token rings
    (prompts of 30 and 20 tokens): the engine puts those rows back before
    it retries, so the retry is exact and every request's tokens equal its
    sequential run."""
    _, cfg, _, params = _smoke("gemma2-9b")
    lens, max_new = [30, 5, 20], 12
    rnp = np.random.default_rng(3)
    prompts = [rnp.integers(0, cfg.vocab_size, n) for n in lens]
    real, calls = t_serve.decode_step, []

    def flaky(*args, **kw):
        calls.append(len(calls))
        if len(calls) == 4:  # step 3 of the first 4-step chunk
            raise t_fault.TransientDeviceError("injected after three steps")
        return real(*args, **kw)

    monkeypatch.setattr(t_serve, "decode_step", flaky)
    engine = t_serve.Engine(cfg, params, batch_slots=4,
                            cache_len=32 + max_new + 8, max_chunk=4)
    out = t_serve.serve(engine, [t_serve.Request(rid=i, prompt=p,
                                                 max_new=max_new)
                                 for i, p in enumerate(prompts)])
    assert engine.decode_failures == 0 and len(calls) > 4
    for r in out:
        assert r.error is None
        ref = _greedy_sequential(cfg, params, prompts[r.rid], max_new)
        assert r.out == ref, (r.rid, r.out, ref)


def test_rings_count_as_fixed_kv_and_disable_prefix_sharing(caplog):
    cfg_j, cfg_t, params_j, params_t = _windowed()
    with caplog.at_level(logging.INFO, logger="repro_torch.serve"):
        eng = t_serve.Engine(cfg_t, params_t, batch_slots=3, cache_len=40,
                             prefix_cache=True)
    assert eng.prefix is None
    assert "prefix cache disabled" in caplog.text
    # 2 local layers x (k, v) x 3 slots x 16 rows x 2 heads x 16 dims x 4 B
    assert eng._fixed_kv_bytes == 2 * 2 * 3 * 16 * 2 * 16 * 4
    eng_j = j_serve.Engine(cfg_j, params_j, batch_slots=3, cache_len=40,
                           prefix_cache=True)
    assert eng_j.prefix is None
    assert eng.kv_pool_bytes() == eng_j.kv_pool_bytes()
    dense = t_serve.Engine(t_configs.get_smoke("phi3-mini-3.8b"),
                           _smoke("phi3-mini-3.8b")[3], batch_slots=2,
                           cache_len=32, prefix_cache=True)
    assert dense.prefix is not None and dense._fixed_kv_bytes == 0


def test_engine_refuses_unported_kinds():
    """Every block kind of the reference is ported (``transformer.KINDS``);
    a kind outside it is refused where the engine builds its cache and
    where the parameters are drawn, as the reference refuses it."""
    from repro_torch.models import transformer as t_tf

    assert set(t_tf.KINDS) == {"attn", "local", "ssm", "rglru"}
    cfg = TArch(name="t", family="hybrid", **TINY,
                pattern=("conv", "attn"), window=16)
    with pytest.raises(ValueError, match="unknown block kind"):
        t_serve.Engine(cfg, {"embed": torch.zeros(1)}, batch_slots=1,
                       cache_len=16)
    with pytest.raises(ValueError, match="unknown block kind"):
        t_init_params(cfg, device="cpu")
