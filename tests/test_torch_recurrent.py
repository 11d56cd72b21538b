"""The recurrent architectures (mamba2-2.7b: SSD layers; recurrentgemma-2b:
RG-LRU and local attention with a remainder tail) in the port against the
JAX package, on the CPU, on their SMOKE configs in float32 with the JAX
parameters carried over by ``repro_torch.convert``.

Tolerances:
  * ``forward`` / ``prefill`` logits and the packed caches (conv inputs,
    SSD state, RG-LRU state, rings): allclose(rtol=1e-5, atol=1e-5).  The
    SSD keeps the reference's chunked sums and the RG-LRU scan its pairing
    tree (``rglru.associative_scan``), so the reference's own 2e-4 for the
    scan is not needed.
  * ``decode_step`` against the JAX ``decode_step`` and against the
    teacher-forced ``forward``: allclose(rtol=1e-5, atol=1e-5).
  * SSD chunk-size invariance: allclose(rtol=2e-4, atol=2e-4), the
    reference's own (tests/test_models.py).
  * the engines: greedy tokens identical to the JAX engine's on digital
    and to each request's sequential run.  Frozen imc_bitserial: one
    request in both packages (mamba2: its prefill and a decode step;
    recurrentgemma: its prefill), the port's logits on the reference's
    tokens within ``EDGE_DEV_CAP`` of the reference's, the tokens
    identical up to checked knife edges, and the engine equal to the
    port's sequential run.
"""
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import serve as j_serve
from repro.models import decode_step as j_decode
from repro.models import forward as j_forward
from repro.models import prefill as j_prefill
from repro.models import rglru as j_rglru
from repro_torch import configs as t_configs
from repro_torch.launch import serve as t_serve
from repro_torch.models import decode_step as t_decode
from repro_torch.models import forward as t_forward
from repro_torch.models import prefill as t_prefill
from repro_torch.models import rglru as t_rglru
from repro_torch.runtime import fault as t_fault
from torch_zoo import (
    assert_bitserial_tokens,
    counters,
    greedy_sequential,
    jax_engine,
    prompts,
    run_engine,
    setup,
)

ARCHS = ["mamba2-2.7b", "recurrentgemma-2b"]
TOL = dict(rtol=1e-5, atol=1e-5)
# digital engine runs: the two 5-token prompts prefill as one group,
# recurrentgemma's 30-token prompts wrap its 16-token rings, the 2- and
# 1-token prompts are shorter than the conv window (four prefill shapes:
# each is a JAX compile)
LENS, MAX_NEW = [5, 5, 30, 2, 30, 1], 10
# bit-serial: one request (the JAX side compiles the bit-serial oracle, the
# costliest part of these tests): mamba2's prefill and a decode step on the
# packed conv inputs and state; recurrentgemma's prefill (its decode graph
# would double the test's time: in a six-worker run of the suite it took
# 75 s with it)
BS_LENS = [6]
BS_NEW = {"mamba2-2.7b": 2, "recurrentgemma-2b": 1}


def _np(x):
    return np.asarray(x)


def _tree_close(t_tree, j_tree, path=()):
    if isinstance(j_tree, dict):
        assert set(t_tree) == set(j_tree), (path, set(t_tree), set(j_tree))
        for k in j_tree:
            _tree_close(t_tree[k], j_tree[k], path + (k,))
        return
    assert tuple(t_tree.shape) == tuple(j_tree.shape), path
    np.testing.assert_allclose(t_tree.numpy(), _np(j_tree), **TOL,
                               err_msg=str(path))


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_and_init_layout_are_the_references(arch):
    import dataclasses

    from repro import configs as j_configs
    from repro_torch.models import init_params, param_bytes

    for get in ("get", "get_smoke"):
        cj, ct = getattr(j_configs, get)(arch), getattr(t_configs, get)(arch)
        for f in dataclasses.fields(cj):
            if f.name != "imc":
                assert getattr(ct, f.name) == getattr(cj, f.name), f.name
    cfg_j, cfg_t, params_j, params_t = setup(arch)
    mine = init_params(cfg_t, seed=3, device="cpu")

    def shapes(tree):
        if isinstance(tree, dict):
            return {k: shapes(v) for k, v in tree.items()}
        return (tuple(tree.shape), str(tree.dtype).split(".")[-1])

    assert shapes(mine) == jax.tree_util.tree_map(
        lambda a: (tuple(a.shape), str(a.dtype)), params_j)
    # what convert carried over: the same tree, tail layers included
    assert shapes(params_t) == shapes(mine)
    assert ("tail" in mine) == bool(cfg_t.tail_kinds)
    n = sum(a.size for a in jax.tree_util.tree_leaves(params_j))
    assert param_bytes(mine) == 4 * n


# forward over 40 tokens, prefill of the first 33 into 48 positions, then
# decode of the other 7
PREFILL, CACHE_LEN = 33, 48
_PREFILLS = {}


def _tokens_and_jax_prefill(arch):
    """The tokens (2, 40) and the JAX prefill of their first ``PREFILL``,
    memoized: two tests share one compile."""
    if arch not in _PREFILLS:
        cfg_j, _, params_j, _ = setup(arch)
        toks = np.random.default_rng(0).integers(0, cfg_j.vocab_size, (2, 40))
        _PREFILLS[arch] = toks, jax.jit(
            lambda t: j_prefill(params_j, cfg_j, t, CACHE_LEN))(
                jnp.asarray(toks[:, :PREFILL], jnp.int32))
    return _PREFILLS[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_prefill_and_caches_match_reference(arch):
    cfg_j, cfg_t, params_j, params_t = setup(arch)
    toks, (lj_pre, cj) = _tokens_and_jax_prefill(arch)
    lj, _ = jax.jit(lambda t: j_forward(params_j, cfg_j, t))(
        jnp.asarray(toks, jnp.int32))
    lt, aux = t_forward(params_t, cfg_t, torch.tensor(toks))
    np.testing.assert_allclose(lt.numpy(), _np(lj), **TOL)
    assert float(aux) == 0.0
    lt, ct = t_prefill(params_t, cfg_t, torch.tensor(toks[:, :PREFILL]),
                       CACHE_LEN)
    np.testing.assert_allclose(lt.numpy(), _np(lj_pre), **TOL)
    _tree_close({k: v for k, v in ct.items() if k != "pos"},
                {k: v for k, v in cj.items() if k != "pos"})
    assert int(ct["pos"]) == int(cj["pos"]) == PREFILL


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_reference_and_teacher_forced_forward(arch):
    cfg_j, cfg_t, params_j, params_t = setup(arch)
    toks, (_, cj) = _tokens_and_jax_prefill(arch)
    full, _ = t_forward(params_t, cfg_t, torch.tensor(toks))
    _, ct = t_prefill(params_t, cfg_t, torch.tensor(toks[:, :PREFILL]),
                      CACHE_LEN)
    step = jax.jit(lambda t, c: j_decode(params_j, cfg_j, t, c))
    for t in range(PREFILL, toks.shape[1]):
        lj, cj = step(jnp.asarray(toks[:, t], jnp.int32), cj)
        lt, ct = t_decode(params_t, cfg_t, torch.tensor(toks[:, t]), ct)
        np.testing.assert_allclose(lt.numpy(), _np(lj), **TOL)
        np.testing.assert_allclose(lt[:, 0].numpy(), full[:, t].numpy(),
                                   **TOL)
    _tree_close({k: v for k, v in ct.items() if k != "pos"},
                {k: v for k, v in cj.items() if k != "pos"})


def test_ssd_chunk_size_invariance():
    """The SSD at chunks of 8, 16 and 40 tokens equals the reference at the
    same chunk, and its logits do not depend on the chunk."""
    cfg_j, cfg_t, params_j, params_t = setup("mamba2-2.7b")
    toks = np.random.default_rng(1).integers(0, cfg_j.vocab_size, (2, 40))
    outs = []
    for chunk in (8, 16, 40):
        cfg_c = cfg_j.replace(ssm_chunk=chunk)
        lj, _ = jax.jit(lambda t: j_forward(params_j, cfg_c, t))(
            jnp.asarray(toks, jnp.int32))
        lt, _ = t_forward(params_t, cfg_t.replace(ssm_chunk=chunk),
                          torch.tensor(toks))
        np.testing.assert_allclose(lt.numpy(), _np(lj), **TOL)
        outs.append(lt.numpy())
    np.testing.assert_allclose(outs[0], outs[1], rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(outs[0], outs[2], rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("s", [24])
def test_rglru_scan_matches_reference_and_h0_fold(s):
    """``rglru_forward`` (the associative scan) equals the reference's,
    with and without an initial state folded in; 24 takes the scan's even
    and odd branches (24, 12, 6, then 3), and the model tests run it at 40
    and 33 tokens."""
    cfg_j, cfg_t, params_j, params_t = setup("recurrentgemma-2b")
    pj = jax.tree_util.tree_map(lambda a: a[0],
                                params_j["blocks"]["p0"]["mixer"])
    pt = {k: v[0] for k, v in params_t["blocks"]["p0"]["mixer"].items()}
    x = np.random.default_rng(s).normal(size=(2, s, cfg_t.d_model))
    h0 = np.random.default_rng(s + 1).normal(size=(2, cfg_t.rnn_width))
    scan = jax.jit(lambda p, v, h: j_rglru.rglru_forward(p, v, cfg_j, h0=h))
    for init in (None, h0):
        yj, hj = scan(pj, jnp.asarray(x, jnp.float32),
                      None if init is None else jnp.asarray(init, jnp.float32))
        yt, ht = t_rglru.rglru_forward(
            pt, torch.tensor(x, dtype=torch.float32), cfg_t,
            h0=None if init is None else torch.tensor(init,
                                                      dtype=torch.float32))
        np.testing.assert_allclose(yt.numpy(), _np(yj), **TOL)
        np.testing.assert_allclose(ht.numpy(), _np(hj), **TOL)


# ---------------------------------------------------------------------------
# the serve engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_digital_matches_reference_and_sequential(arch):
    """Exact-length prefill (no buckets: unequal lengths are admitted and
    served together in one engine batch), identical tokens and counters to
    the JAX engine, and every request that spans the conv window equal to
    its sequential run.  ``LENS`` holds a 2- and a 1-token prompt, shorter
    than the conv window: the engines right-pad their conv-input rows into
    the slot's window alike (the reference's insert; a sequential decode
    cannot run on such a prompt, see ``test_short_prompts_pad_the_conv_
    window_as_the_reference``), so their tokens are held against the JAX
    engine's here."""
    _, cfg_t, _, params_t = setup(arch)
    assert t_serve.needs_exact_prefill(cfg_t)
    assert t_serve.prefill_bucket(17, False, 64) == 17
    out_j, cnt_j = jax_engine(arch, "digital", LENS, MAX_NEW)
    out_t, eng = run_engine(t_serve, cfg_t, params_t, LENS, MAX_NEW)
    assert not eng.bucketable and eng.batch_prefill
    assert eng.prefill_rows > eng.prefill_calls  # the two 5-token prompts
    assert out_t == out_j
    assert counters(eng) == cnt_j
    assert eng.alloc.num_blocks == 1 and eng.alloc.used_count == 0
    assert [n for n in LENS if n < cfg_t.conv_width - 1] == [2, 1]
    for rid, p in enumerate(prompts(cfg_t, LENS)):
        if len(p) >= cfg_t.conv_width - 1:
            assert out_t[rid] == greedy_sequential(cfg_t, params_t, p,
                                                   MAX_NEW)


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_bitserial_matches_reference(arch):
    """Frozen imc_bitserial with ``rng=None``, one request (``BS_NEW``).
    Alone in the engine it runs as its sequential run (the reference's
    frozen-calibration contract), so the JAX package's sequential run is
    the reference: ``assert_bitserial_tokens`` holds the logits and
    tokens.  The batched engines and recurrentgemma's decode are held on
    digital."""
    _, cfg_t, _, params_t = setup(arch, "imc_bitserial")
    new = BS_NEW[arch]
    out_t, eng = run_engine(t_serve, cfg_t, params_t, BS_LENS, new, slots=1)
    assert counters(eng) == (1, 1, new - 1, new - 1)
    assert_bitserial_tokens(arch, out_t, BS_LENS, new)


@pytest.mark.parametrize("arch", ARCHS)
def test_short_prompts_pad_the_conv_window_as_the_reference(arch):
    """A prompt shorter than ``conv_width - 1`` leaves fewer conv-input rows
    in the prefill cache, in both packages, and a sequential decode_step on
    that cache raises in both (the conv window is short).  The engines
    serve such prompts: ``test_engine_digital_matches_reference_and_
    sequential``."""
    cfg_j, cfg_t, params_j, params_t = setup(arch)
    toks = np.random.default_rng(3).integers(0, cfg_j.vocab_size, (1, 2))
    _, cj = jax.jit(lambda t: j_prefill(params_j, cfg_j, t, 8))(
        jnp.asarray(toks, jnp.int32))
    _, ct = t_prefill(params_t, cfg_t, torch.tensor(toks), 8)
    _tree_close({k: v for k, v in ct.items() if k != "pos"},
                {k: v for k, v in cj.items() if k != "pos"})
    assert ct["blocks"]["p0"]["conv"].shape[2] == 2
    with pytest.raises(Exception):
        j_decode(params_j, cfg_j, jnp.asarray(toks[:, 0], jnp.int32), cj)
    with pytest.raises(RuntimeError):
        t_decode(params_t, cfg_t, torch.tensor(toks[:, 0]), ct)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_retry_restores_recurrent_state(arch, monkeypatch):
    """A transient device error at step 2 of the first decode chunk, after
    steps 0 and 1 have advanced every recurrent state (and, on
    recurrentgemma, overwritten rows of the 30-token prompt's wrapped
    rings): the engine puts the state back before it retries, so the tokens
    equal the JAX engine's."""
    _, cfg_t, _, params_t = setup(arch)
    real, calls = t_serve.decode_step, []

    def flaky(*args, **kw):
        calls.append(len(calls))
        if len(calls) == 3:
            raise t_fault.TransientDeviceError("injected after two steps")
        return real(*args, **kw)

    monkeypatch.setattr(t_serve, "decode_step", flaky)
    out_t, eng = run_engine(t_serve, cfg_t, params_t, LENS, MAX_NEW)
    assert eng.decode_failures == 0 and len(calls) > 3
    out_j, _ = jax_engine(arch, "digital", LENS, MAX_NEW)
    assert out_t == out_j


@pytest.mark.parametrize("arch", ARCHS)
def test_recurrent_state_is_fixed_kv_and_disables_prefix_sharing(arch,
                                                                  caplog):
    """Recurrent states count as fixed per-slot bytes (the reference counts
    only the rings: its accounting leaves the states out), and the prefix
    cache is disabled with the log line, as in the reference."""
    cfg_j, cfg_t, params_j, params_t = setup(arch)
    with caplog.at_level(logging.INFO, logger="repro_torch.serve"):
        eng = t_serve.Engine(cfg_t, params_t, batch_slots=3, cache_len=40,
                             prefix_cache=True)
    assert eng.prefix is None
    assert "prefix cache disabled" in caplog.text
    eng_j = j_serve.Engine(cfg_j, params_j, batch_slots=3, cache_len=40,
                           prefix_cache=True)
    assert eng_j.prefix is None
    kinds = cfg_t.pattern * cfg_t.n_full_cycles + cfg_t.tail_kinds
    l_ssm, l_rg = kinds.count("ssm"), kinds.count("rglru")
    d_inner = cfg_t.ssm_expand * cfg_t.d_model
    ssm = ((cfg_t.conv_width - 1) * (d_inner + 2 * cfg_t.ssm_state)
           + d_inner // cfg_t.ssm_head_dim * cfg_t.ssm_state
           * cfg_t.ssm_head_dim)
    rg = (cfg_t.rnn_conv_width - 1) * cfg_t.rnn_width + cfg_t.rnn_width
    state = 4 * (l_ssm * ssm + l_rg * rg)
    assert eng.state_bytes_per_slot == state
    assert eng._fixed_kv_bytes == eng_j._fixed_kv_bytes + 3 * state
    assert eng._block_bytes == eng_j._block_bytes
