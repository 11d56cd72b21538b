"""The mixture-of-experts architectures (granite-moe-1b-a400m: 32 experts top
8 at full width; dbrx-132b: 16 experts top 4) in the port against the JAX
package, on the CPU, on their SMOKE configs in float32 with the JAX
parameters carried over by ``repro_torch.convert``.

Tolerances:
  * ``apply_moe`` output and aux loss, ``forward`` / ``prefill`` logits and
    caches, ``decode_step``: allclose(rtol=1e-5, atol=1e-5).  Routing
    (top-k, capacity slots, drops) must be identical: a different choice
    would move an output far past that.
  * the engines on digital: greedy tokens and counters identical to the
    JAX engine's with the same slot layout.  In decode every slot's token
    routes in one group, retired rows included, so capacity couples the
    rows; the engines are compared with each other, not with sequential
    runs (the reference's engine tests leave MoE out for that reason).
  * frozen imc_bitserial: granite-moe serves eight requests, each
    prefilled alone as the engine does, then one decode step of the eight
    slots together, which routes them as one group at three capacity rows
    per expert; dbrx one request's prefill.  Both packages run the same
    requests that way outside the engine; the port's logits on the
    reference's tokens are within ``EDGE_DEV_CAP`` of the reference's, the
    engine's tokens identical to the reference's up to checked knife edges
    and to the port's own runs.
"""
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ArchConfig as JArch
from repro.models import decode_step as j_decode
from repro.models import forward as j_forward
from repro.models import init_params as j_init_params
from repro.models import moe as j_moe
from repro.models import prefill as j_prefill
from repro_torch.convert import params_from_jax
from repro_torch.launch import serve as t_serve
from repro_torch.models import decode_step as t_decode
from repro_torch.models import forward as t_forward
from repro_torch.models import init_params as t_init_params
from repro_torch.models import moe as t_moe
from repro_torch.models import prefill as t_prefill
from repro_torch.models import transformer as t_tf
from torch_zoo import (
    IMC_BITS,
    assert_bitserial_tokens,
    counters,
    jax_engine,
    run_engine,
    setup,
)
from torch_threads import two_threads  # noqa: F401  (autouse)

ARCHS = ["granite-moe-1b-a400m", "dbrx-132b"]
TOL = dict(rtol=1e-5, atol=1e-5)
# per-request lengths: slots retire at different chunks while others
# decode, so retired rows' last tokens contend for capacity (one prompt
# length: each is a JAX compile, and admission at different chunks already
# gives the rows different positions)
LENS = [5] * 7
NEWS = [3, 10, 6, 10, 4, 8, 10]
# bit-serial (the JAX side compiles the bit-serial oracle: the costliest
# part of these tests): (prompt lengths, new tokens).  granite-moe's decode
# step routes eight slots at ceil(2 * 8 * 1.25 / 8) = 3 capacity rows per
# expert, and these prompts overflow one (one more capacity row there moves
# the logits by about 0.24); dbrx's prefill runs the same code at its own
# widths
BITSERIAL = {"granite-moe-1b-a400m": ([6] * 8, 2), "dbrx-132b": ([6], 1)}

# the reference's dropless decode case (tests/test_models.py)
TINY = dict(n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
            vocab_size=256, max_seq=128, flash_q_block=16, flash_kv_block=16,
            dtype="float32")
DROPLESS = dict(n_experts=8, top_k=2, moe_group_size=32, capacity_factor=8.0)


def _np(x):
    return np.asarray(x)


def _moe_case(case):
    """(cfg, JAX MoE params of layer 0, the port's copy)."""
    if case == "dropless":
        cfg_j = JArch(name="t", family="moe", **TINY, **DROPLESS)
        params_j = j_init_params(jax.random.PRNGKey(0), cfg_j)
    else:
        cfg_j, _, params_j, _ = setup(case)
    moe_j = jax.tree_util.tree_map(lambda a: a[0],
                                   params_j["blocks"]["p0"]["moe"])
    moe_t = params_from_jax(jax.tree_util.tree_map(np.asarray, moe_j), "cpu")
    return cfg_j, moe_j, moe_t


@pytest.mark.parametrize("case,b,s", [("granite-moe-1b-a400m", 2, 40),
                                      ("granite-moe-1b-a400m", 8, 1),
                                      ("dbrx-132b", 1, 70),
                                      ("dropless", 2, 40)])
def test_apply_moe_matches_reference(case, b, s):
    """Grouped routing with capacity 1.25 (tokens drop; 70 tokens make a
    second, padded group of 64) and the dropless case: the output, the aux
    loss and which slots were kept."""
    cfg, moe_j, moe_t = _moe_case(case)
    x = np.random.default_rng(b * 100 + s).normal(size=(b, s, cfg.d_model))
    args = (cfg.n_experts, cfg.top_k, cfg.capacity_factor,
            cfg.moe_group_size, cfg.mlp_kind)
    yj, aj = jax.jit(lambda p, v: j_moe.apply_moe(p, v, *args))(
        moe_j, jnp.asarray(x, jnp.float32))
    yt, at = t_moe.apply_moe(moe_t, torch.tensor(x, dtype=torch.float32),
                             *args)
    np.testing.assert_allclose(yt.numpy(), _np(yj), **TOL)
    np.testing.assert_allclose(float(at), float(aj), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_layout_and_expert_stacks(arch):
    """The port's init has the reference's tree (expert stacks (L, E, d, f),
    the float32 router), and each stacked row holds the draws of one
    ``init_block`` from the same generator."""
    cfg_j, cfg_t, params_j, params_t = setup(arch)
    mine = t_init_params(cfg_t, seed=5, device="cpu")

    def shapes(tree):
        if isinstance(tree, dict):
            return {k: shapes(v) for k, v in tree.items()}
        return (tuple(tree.shape), str(tree.dtype).split(".")[-1])

    assert shapes(mine) == jax.tree_util.tree_map(
        lambda a: (tuple(a.shape), str(a.dtype)), params_j)
    assert shapes(params_t) == shapes(mine)
    gen = torch.Generator(device="cpu")
    gen.manual_seed(5)
    torch.randn((cfg_t.padded_vocab, cfg_t.d_model), generator=gen)
    if not cfg_t.tie_embeddings:
        torch.randn((cfg_t.d_model, cfg_t.padded_vocab), generator=gen)
    for li in range(cfg_t.n_full_cycles):
        layer = t_tf.init_block(gen, cfg_t, "attn", torch.float32, "cpu")
        got = mine["blocks"]["p0"]["moe"]
        assert torch.equal(got["router"][li], layer["moe"]["router"])
        for name in ("wi", "wg", "wo"):
            assert torch.equal(got["experts"][name][li],
                               layer["moe"]["experts"][name])


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_prefill_decode_match_reference(arch):
    cfg_j, cfg_t, params_j, params_t = setup(arch)
    toks = np.random.default_rng(0).integers(0, cfg_j.vocab_size, (2, 40))
    lj, aj = jax.jit(lambda t: j_forward(params_j, cfg_j, t))(
        jnp.asarray(toks, jnp.int32))
    lt, at = t_forward(params_t, cfg_t, torch.tensor(toks))
    np.testing.assert_allclose(lt.numpy(), _np(lj), **TOL)
    np.testing.assert_allclose(float(at), float(aj), **TOL)
    assert float(at) > 0
    lj, cj = jax.jit(lambda t: j_prefill(params_j, cfg_j, t, 48))(
        jnp.asarray(toks[:, :34], jnp.int32))
    lt, ct = t_prefill(params_t, cfg_t, torch.tensor(toks[:, :34]), 48)
    np.testing.assert_allclose(lt.numpy(), _np(lj), **TOL)
    for kv in ("k", "v"):
        np.testing.assert_allclose(ct["blocks"]["p0"][kv].numpy(),
                                   _np(cj["blocks"]["p0"][kv]), **TOL)
    step = jax.jit(lambda t, c: j_decode(params_j, cfg_j, t, c))
    for t in range(34, 40):
        lj, cj = step(jnp.asarray(toks[:, t], jnp.int32), cj)
        lt, ct = t_decode(params_t, cfg_t, torch.tensor(toks[:, t]), ct)
        np.testing.assert_allclose(lt.numpy(), _np(lj), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_matches_reference_engine(arch, monkeypatch):
    """Digital: the JAX engine's tokens and counters with the same slot
    layout, one request per prefill (R = 1), and decode chunks that run
    with retired rows in the routing group."""
    _, cfg_t, _, params_t = setup(arch)
    assert t_serve.needs_exact_prefill(cfg_t)
    seen = []
    real = t_serve.Engine._run_chunk

    def spy(self, n_steps, active, key):
        seen.append(active.tolist())
        return real(self, n_steps, active, key)

    monkeypatch.setattr(t_serve.Engine, "_run_chunk", spy)
    out_j, cnt_j = jax_engine(arch, "digital", LENS, NEWS)
    out_t, eng = run_engine(t_serve, cfg_t, params_t, LENS, NEWS)
    assert not eng.batch_prefill and not eng.bucketable
    assert eng.prefill_calls == eng.prefill_rows == len(LENS)
    assert counters(eng) == cnt_j
    assert out_t == out_j
    assert any(not all(a) for a in seen)  # a retired row contended


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_bitserial_matches_reference(arch):
    """Frozen imc_bitserial with ``rng=None``: the engine prefills each
    request alone (its expert calls at the capacity of one prompt's
    tokens) and, on granite-moe, decodes its eight slots in one routing
    group.  Both packages run the requests the same way outside the engine
    (``assert_bitserial_tokens``: logits and tokens against the JAX
    package's, the engine against the port's own runs)."""
    _, cfg_t, _, params_t = setup(arch, "imc_bitserial")
    lens, new = BITSERIAL[arch]
    out_t, eng = run_engine(t_serve, cfg_t, params_t, lens, new,
                            slots=len(lens))
    assert counters(eng) == (len(lens), len(lens), new - 1, new - 1)
    assert_bitserial_tokens(arch, out_t, lens, new, together=True)


def test_moe_disables_prefix_sharing(caplog):
    """Expert capacity couples the rows, so linking cached blocks would not
    reproduce a prefix: the prefix cache is off, with the log line, while
    the KV accounting is the reference's."""
    from repro.launch import serve as j_serve

    cfg_j, cfg_t, params_j, params_t = setup("granite-moe-1b-a400m")
    with caplog.at_level(logging.INFO, logger="repro_torch.serve"):
        eng = t_serve.Engine(cfg_t, params_t, batch_slots=3, cache_len=40,
                             prefix_cache=True)
    assert eng.prefix is None
    assert "prefix cache disabled" in caplog.text
    eng_j = j_serve.Engine(cfg_j, params_j, batch_slots=3, cache_len=40,
                           prefix_cache=True)
    assert eng_j.prefix is None
    assert (eng._block_bytes, eng._fixed_kv_bytes, eng.kv_pool_bytes()) == (
        eng_j._block_bytes, eng_j._fixed_kv_bytes, eng_j.kv_pool_bytes())


def test_experts_share_one_noise_draw():
    """Under a noise key, the reference vmaps one key over the experts, so
    every expert's bit-serial call draws the same gain and the same noise
    seed; the port hands every expert the same seed.  Two experts with the
    same weights and the same capacity rows therefore give the same noisy
    output in both packages, and a third expert with other weights does
    not."""
    from repro.core.imc_linear import IMCConfig as JIMC
    from repro_torch.core.imc_linear import IMCConfig as TIMC

    kw = dict(mode="imc_bitserial", bx=IMC_BITS, bw=IMC_BITS, v_wl=0.7)
    rnp = np.random.default_rng(9)
    d, f, cap = 64, 32, 3
    w = {k: rnp.normal(size=(3,) + s) / np.sqrt(s[0])
         for k, s in (("wi", (d, f)), ("wg", (d, f)), ("wo", (f, d)))}
    for k in w:
        w[k][1] = w[k][0]
    h = rnp.normal(size=(1, 3, cap, d))
    h[0, 1] = h[0, 0]
    ep_t = {k: torch.tensor(v, dtype=torch.float32) for k, v in w.items()}
    yt = t_moe._expert_mlp(ep_t, torch.tensor(h, dtype=torch.float32),
                           "swiglu", TIMC(**kw), 1234)[0].numpy()
    ep_j = {k: jnp.asarray(v, jnp.float32) for k, v in w.items()}
    yj = np.asarray(jax.jit(jax.vmap(lambda ep, hb: j_moe._expert_mlp(
        ep, hb, "swiglu", JIMC(**kw), jax.random.PRNGKey(3))))(
            ep_j, jnp.asarray(h[0], jnp.float32)))
    for y in (yt, yj):
        np.testing.assert_array_equal(y[0], y[1])
        assert not np.allclose(y[0], y[2])
