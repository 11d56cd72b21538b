"""The dense public architectures (phi3-mini-3.8b, deepseek-coder-33b,
granite-20b, gemma2-9b) in the port against the JAX package, on the CPU, on
their SMOKE configs in float32 with the JAX parameters carried over by
``repro_torch.convert``.

Tolerances:
  * ``forward`` / ``prefill`` logits and caches: allclose(rtol=1e-5,
    atol=1e-5).
  * ``decode_step`` against the teacher-forced ``forward`` (in each
    package): allclose(rtol=1e-5, atol=1e-5); the two sum attention in
    another order (a ring or pool walk against blocked or banded prefill).
  * ``banded_attention`` and ``decode_plain`` (G = 48, hd 96, hd 256 with
    softcap) against the reference's: allclose(rtol=1e-5, atol=1e-5).
  * the serve engines: tests/test_torch_archs_serve.py.
  * the meter's bill of each full config: counters equal, energies within
    rel 1e-12.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as j_configs
from repro.configs.base import ArchConfig as JArch
from repro.core import design as j_design
from repro.core.mapping import per_token_matmul_shapes as j_shapes
from repro.kernels import paged_attention as j_pa
from repro.launch import metering as j_metering
from repro.models import attention as j_attn
from repro.models import decode_step as j_decode
from repro.models import forward as j_forward
from repro.models import init_params as j_init_params
from repro.models import prefill as j_prefill
from repro_torch import configs as t_configs
from repro_torch.configs.base import ArchConfig as TArch
from repro_torch.convert import params_from_jax
from repro_torch.core import design as t_design
from repro_torch.core.mapping import per_token_matmul_shapes as t_shapes
from repro_torch.kernels import paged_attention as t_pa
from repro_torch.launch import metering as t_metering
from repro_torch.models import attention as t_attn
from repro_torch.models import decode_step as t_decode
from repro_torch.models import forward as t_forward
from repro_torch.models import init_params as t_init_params
from repro_torch.models import param_bytes
from repro_torch.models import prefill as t_prefill
from torch_threads import two_threads  # noqa: F401  (autouse)

ARCHS = ["phi3-mini-3.8b", "deepseek-coder-33b", "granite-20b", "gemma2-9b"]
TOL = dict(rtol=1e-5, atol=1e-5)

# the reference serve tests' windowed config (tests/test_serve_paged.py,
# tests/test_serve_engine.py): window 16, softcaps, sandwich norms
TINY = dict(
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=256,
    max_seq=128, flash_q_block=16, flash_kv_block=16, dtype="float32",
)
WINDOWED = dict(pattern=("local", "attn"), window=16, attn_softcap=50.0,
                final_softcap=30.0, post_norm=True, emb_scale=True)

_CACHE = {}


def _np(x):
    return np.asarray(x)


def _pair(cfg_j, cfg_t, key=0):
    """JAX parameters for ``cfg_j`` and the port's copy (memoized)."""
    k = (id(cfg_j), key)
    if k not in _CACHE:
        params_j = j_init_params(jax.random.PRNGKey(key), cfg_j)
        params_t = params_from_jax(
            jax.tree_util.tree_map(np.asarray, params_j), "cpu")
        _CACHE[k] = (params_j, params_t)
    return _CACHE[k]


def _smoke(arch):
    cfg_j, cfg_t = j_configs.get_smoke(arch), t_configs.get_smoke(arch)
    return (cfg_j, cfg_t) + _pair(cfg_j, cfg_t)


def _windowed():
    if "windowed" not in _CACHE:
        cfg_j = JArch(name="t", family="dense", **TINY, **WINDOWED)
        cfg_t = TArch(name="t", family="dense", **TINY, **WINDOWED)
        _CACHE["windowed"] = (cfg_j, cfg_t)
    cfg_j, cfg_t = _CACHE["windowed"]
    return (cfg_j, cfg_t) + _pair(cfg_j, cfg_t)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_are_the_references(arch):
    import dataclasses

    for get in ("get", "get_smoke"):
        cj = getattr(j_configs, get)(arch)
        ct = getattr(t_configs, get)(arch)
        for f in dataclasses.fields(cj):
            if f.name != "imc":
                assert getattr(ct, f.name) == getattr(cj, f.name), f.name
        assert ct.param_count() == cj.param_count()
    assert arch in t_configs.ARCH_NAMES


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_layout_matches_reference(arch):
    cfg_j, cfg_t, params_j, _ = _smoke(arch)
    params_t = t_init_params(cfg_t, seed=3, device="cpu")

    def shapes(tree):
        if isinstance(tree, dict):
            return {k: shapes(v) for k, v in tree.items()}
        return tuple(tree.shape)

    assert shapes(params_t) == jax.tree_util.tree_map(
        lambda a: tuple(a.shape), params_j)
    n = sum(int(np.prod(a.shape))
            for a in jax.tree_util.tree_leaves(params_j))
    assert param_bytes(params_t) == 4 * n


def test_init_params_fills_layers_in_stacking_order():
    """The stacked leaves hold layer ``li``'s draws at row ``li``: the same
    values as initializing the layers one by one from the generator."""
    from repro_torch.models import transformer as tf
    from repro_torch.models.layers import dtype_of

    cfg = t_configs.get_smoke("gemma2-9b")
    params = t_init_params(cfg, seed=5, device="cpu")
    gen = torch.Generator(device="cpu")
    gen.manual_seed(5)
    d = cfg.d_model
    torch.randn((cfg.padded_vocab, d), generator=gen)  # embed
    dt = dtype_of(cfg.dtype)
    for pi, kind in enumerate(cfg.pattern):
        for li in range(cfg.n_full_cycles):
            layer = tf.init_block(gen, cfg, kind, dt, "cpu")
            got = params["blocks"][f"p{pi}"]
            for name in ("wq", "wk", "wv", "wo"):
                assert torch.equal(got["mixer"][name][li],
                                   layer["mixer"][name])
            assert torch.equal(got["mlp"]["wg"][li], layer["mlp"]["wg"])


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch):
    cfg_j, cfg_t, params_j, params_t = _smoke(arch)
    toks = np.random.default_rng(0).integers(0, cfg_j.vocab_size, (2, 40))
    lj, _ = j_forward(params_j, cfg_j, jnp.asarray(toks, jnp.int32))
    lt, _ = t_forward(params_t, cfg_t, torch.tensor(toks))
    np.testing.assert_allclose(lt.numpy(), _np(lj), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_and_caches_match_reference(arch):
    """Bucketed prefill with ragged true lengths: logits at each row's true
    last position, the linear global caches and (gemma2) the local rings
    packed from each row's true tail."""
    cfg_j, cfg_t, params_j, params_t = _smoke(arch)
    toks = np.random.default_rng(2).integers(0, cfg_j.vocab_size, (3, 32))
    true_len = np.asarray([32, 9, 20])
    lj, cj = j_prefill(params_j, cfg_j, jnp.asarray(toks, jnp.int32),
                       cache_len=40, true_len=jnp.asarray(true_len))
    lt, ct = t_prefill(params_t, cfg_t, torch.tensor(toks), 40,
                       true_len=torch.tensor(true_len))
    np.testing.assert_allclose(lt.numpy(), _np(lj), **TOL)
    for key in cj["blocks"]:
        for kv in ("k", "v"):
            assert ct["blocks"][key][kv].shape == cj["blocks"][key][kv].shape
            np.testing.assert_allclose(ct["blocks"][key][kv].numpy(),
                                       _np(cj["blocks"][key][kv]), **TOL)
    assert ct["pos"].tolist() == true_len.tolist()


def _teacher_forced(prefill_fn, decode_fn, params, cfg, toks, n_prompt,
                    to_dev, to_np):
    """Prefill ``n_prompt`` tokens, then decode the rest of ``toks`` one by
    one; returns the logits of every position from n_prompt - 1 on."""
    s = toks.shape[1]
    logits, cache = prefill_fn(params, cfg, to_dev(toks[:, :n_prompt]),
                               s + 4)
    out = [to_np(logits)[:, -1]]
    for t in range(n_prompt, s):
        logits, cache = decode_fn(params, cfg, to_dev(toks[:, t]), cache)
        out.append(to_np(logits)[:, 0])
    return np.stack(out, axis=1)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_equals_teacher_forced_forward(arch):
    """Decode past gemma2's window (16 on SMOKE): every step's logits equal
    the full forward's at that position, in both packages, and the packages
    agree with each other."""
    cfg_j, cfg_t, params_j, params_t = _smoke(arch)
    toks = np.random.default_rng(5).integers(0, cfg_j.vocab_size, (2, 36))
    n_prompt = 12
    full_j, _ = j_forward(params_j, cfg_j, jnp.asarray(toks, jnp.int32))
    full_t, _ = t_forward(params_t, cfg_t, torch.tensor(toks))
    # one compile of the reference's decode step, not one per eager call
    j_dec = jax.jit(lambda p, c, t, cache: j_decode(p, c, t, cache),
                    static_argnums=1)
    dec_j = _teacher_forced(
        lambda p, c, t, n: j_prefill(p, c, t, cache_len=n), j_dec,
        params_j, cfg_j, toks, n_prompt,
        lambda a: jnp.asarray(a, jnp.int32), _np)
    dec_t = _teacher_forced(t_prefill, t_decode, params_t, cfg_t, toks,
                            n_prompt, torch.tensor, lambda a: a.numpy())
    np.testing.assert_allclose(dec_j, _np(full_j)[:, n_prompt - 1:], **TOL)
    np.testing.assert_allclose(dec_t, full_t.numpy()[:, n_prompt - 1:],
                               **TOL)
    np.testing.assert_allclose(dec_t, dec_j, **TOL)


@pytest.mark.parametrize("s,window,g,softcap", [
    (40, 16, 2, 50.0), (33, 8, 1, None), (64, 24, 4, None)])
def test_banded_attention_matches_reference(s, window, g, softcap):
    rng = np.random.default_rng(s)
    hkv, hd = 2, 16
    q = rng.standard_normal((2, s, hkv * g, hd)).astype(np.float32)
    k = rng.standard_normal((2, s, hkv, hd)).astype(np.float32)
    v = rng.standard_normal((2, s, hkv, hd)).astype(np.float32)
    kw = dict(n_heads=hkv * g, n_kv=hkv, head_dim=hd, scale=hd**-0.5,
              softcap_val=softcap, window=window, q_block=16, kv_block=16,
              rope_theta=1e4, use_rope=True)
    oj = j_attn.banded_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), j_attn.AttnDims(**kw))
    ot = t_attn.banded_attention(torch.tensor(q), torch.tensor(k),
                                 torch.tensor(v), t_attn.AttnDims(**kw))
    np.testing.assert_allclose(ot.numpy(), _np(oj), **TOL)
    # the windowed flash path masks the same keys
    of = t_attn.flash_attention(torch.tensor(q), torch.tensor(k),
                                torch.tensor(v), t_attn.AttnDims(**kw))
    np.testing.assert_allclose(of.numpy(), _np(oj), **TOL)


@pytest.mark.parametrize("hkv,g,hd,softcap", [
    (1, 48, 128, None),   # granite-20b: MQA, 48 query heads
    (4, 1, 96, None),     # phi3-mini: hd 96
    (2, 2, 256, 50.0),    # gemma2-9b: hd 256, softcap 50
    (2, 7, 128, None),    # deepseek-coder-33b: 7 query heads per kv head
])
def test_decode_plain_matches_reference_walk(hkv, g, hd, softcap):
    rng = np.random.default_rng(hd + g)
    b, nb, bs, mb = 3, 14, 4, 4
    q = rng.standard_normal((b, hkv, g, hd)).astype(np.float32)
    kn = rng.standard_normal((b, hkv, hd)).astype(np.float32)
    vn = rng.standard_normal((b, hkv, hd)).astype(np.float32)
    pk = rng.standard_normal((nb, bs, hkv, hd)).astype(np.float32)
    pv = rng.standard_normal((nb, bs, hkv, hd)).astype(np.float32)
    bt = np.array([[3, 7, 1, 9], [2, 0, 0, 0], [5, 6, 8, 4]], np.int32)
    pos = np.array([13, 2, 16], np.int32)  # the last row overruns
    active = np.array([True, True, False])
    dest, off = j_pa.write_routing(jnp.asarray(bt), jnp.asarray(pos), bs,
                                   jnp.asarray(active))
    cj, pkj, pvj = j_pa._decode_jax(
        jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(pk),
        jnp.asarray(pv), jnp.asarray(bt), jnp.asarray(pos), dest, off,
        0.125, softcap)
    ct, pkt, pvt = t_pa.decode_plain(
        torch.tensor(q), torch.tensor(kn), torch.tensor(vn),
        torch.tensor(pk), torch.tensor(pv), torch.tensor(bt),
        torch.tensor(pos), torch.tensor(active), scale=0.125,
        softcap=softcap)
    np.testing.assert_allclose(ct.numpy(), _np(cj), **TOL)
    np.testing.assert_array_equal(pkt.numpy()[1:], _np(pkj)[1:])
    np.testing.assert_array_equal(pvt.numpy()[1:], _np(pvj)[1:])


# ---------------------------------------------------------------------------
# metering
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_meter_bills_the_full_config_like_the_reference(arch):
    """``core.mapping`` walks the full config's sites (local layers too) and
    the meter bills a driven workload at a design point as the reference
    does."""
    cfg_j, cfg_t = j_configs.get(arch), t_configs.get(arch)
    sj, st = j_shapes(cfg_j), t_shapes(cfg_t)
    assert [(s.name, s.k, s.m, s.calls) for s in st] == [
        (s.name, s.k, s.m, s.calls) for s in sj]
    mj, mt = j_metering.DPMeter(cfg_j), t_metering.DPMeter(cfg_t)
    for m in (mj, mt):
        m.note_prefill(3, 512, true_lens=[100, 512, 301])
        m.note_decode(8, 32)
        m.note_decode(1, 8)
    assert mt.site_triples() == mj.site_triples()
    for rows in (256, 512):
        assert mt.dp_counts("total", rows) == mj.dp_counts("total", rows)
    for kind in ("qs", "qr", "cm"):
        pj = j_design.optimize(n=512, snr_t_target_db=14.0, kinds=(kind,))
        pt = t_design.optimize(n=512, snr_t_target_db=14.0, kinds=(kind,))
        rj = j_metering.serve_energy_report(mj, design=pj,
                                            generated_tokens=300, requests=3)
        rt = t_metering.serve_energy_report(mt, design=pt,
                                            generated_tokens=300, requests=3)
        for attr in ("total_j", "j_per_token", "edp_per_token"):
            assert getattr(rt, attr) == pytest.approx(getattr(rj, attr),
                                                      rel=1e-12)
