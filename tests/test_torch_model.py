"""The port's analytics, IMC layer, substrate and model against the JAX
reference, on the CPU, on musicgen-medium SMOKE in float32 with the JAX
parameters carried over by ``repro_torch.convert``.

Tolerances: analytics equal to float rounding; ``linear`` allclose, with the
dynamic analytic mode allowed rare one-code MPC flips (its per-batch std is
a reduction summed in another order); ``Calibration`` JSON at rtol=1e-5;
logits and caches allclose(atol=1e-4); paged decode equals gather decode.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as j_configs
from repro.core import archs as j_archs
from repro.core import imc_linear as j_lin
from repro.core import precision as j_prec
from repro.core import substrate as j_sub
from repro.models import decode_step as j_decode
from repro.models import forward as j_forward
from repro.models import init_paged_cache as j_init_paged
from repro.models import init_params as j_init_params
from repro.models import prefill as j_prefill
from repro_torch import configs as t_configs
from repro_torch.convert import params_from_jax
from repro_torch.core import archs as t_archs
from repro_torch.core import imc_linear as t_lin
from repro_torch.core import precision as t_prec
from repro_torch.core import substrate as t_sub
from repro_torch.models import decode_step as t_decode
from repro_torch.models import forward as t_forward
from repro_torch.models import init_paged_cache as t_init_paged
from repro_torch.models import init_params as t_init_params
from repro_torch.models import prefill as t_prefill
from repro_torch.models import resolve_device

ARCH = "musicgen-medium"


def _np(x):
    return np.asarray(x)


@pytest.fixture(scope="module")
def smoke():
    cfg_j = j_configs.get_smoke(ARCH)
    cfg_t = t_configs.get_smoke(ARCH)
    params_j = j_init_params(jax.random.PRNGKey(0), cfg_j)
    params_t = params_from_jax(jax.tree_util.tree_map(np.asarray, params_j),
                               "cpu")
    return cfg_j, cfg_t, params_j, params_t


# ---------------------------------------------------------------------------
# analytics
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,bx,bw,v_wl", [(64, 7, 7, 0.7), (256, 7, 7, 0.7),
                                          (512, 6, 6, 0.8), (128, 4, 5, 0.6)])
def test_analytics_match_reference(n, bx, bw, v_wl):
    a_j = j_archs.QSArch(n=n, bx=bx, bw=bw, v_wl=v_wl)
    a_t = t_archs.QSArch(n=n, bx=bx, bw=bw, v_wl=v_wl)
    for name in ("snr_a_db", "snr_A_db", "v_c_counts", "b_adc_min",
                 "energy_per_dp"):
        assert getattr(a_t, name)() == pytest.approx(getattr(a_j, name)(),
                                                     rel=1e-12)
    assert a_t.k_h == pytest.approx(a_j.k_h, rel=1e-12)
    for cls in ("QRArch", "CMArch"):
        x_j, x_t = getattr(j_archs, cls)(n=n), getattr(t_archs, cls)(n=n)
        assert x_t.snr_A_db() == pytest.approx(x_j.snr_A_db(), rel=1e-12)
        assert x_t.b_adc_min() == x_j.b_adc_min()
    assert t_prec.by_mpc_lower_bound(20.0) == j_prec.by_mpc_lower_bound(20.0)


@pytest.mark.parametrize("n", [64, 128, 1536, 6144])
def test_imc_config_resolution_matches_reference(n):
    c_j = j_lin.IMCConfig(mode="imc_bitserial", bx=7, bw=7, v_wl=0.7)
    c_t = t_lin.IMCConfig(mode="imc_bitserial", bx=7, bw=7, v_wl=0.7)
    assert c_t.bank_rows(n) == c_j.bank_rows(n)
    assert c_t.resolved_b_adc_bitserial(n) == c_j.resolved_b_adc_bitserial(n)
    assert c_t.resolved_b_adc(n) == c_j.resolved_b_adc(n)
    assert c_t.resolved_snr_a_db(n) == pytest.approx(c_j.resolved_snr_a_db(n))


# ---------------------------------------------------------------------------
# the IMC layer
# ---------------------------------------------------------------------------


def _xw(seed=0, b=(3, 5), k=48, m=24):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=b + (k,)).astype(np.float32)
    w = (rng.normal(size=(k, m)) / np.sqrt(k)).astype(np.float32)
    return x, w


@pytest.mark.parametrize("mode", ["digital", "fakequant", "imc_analytic",
                                  "imc_bitserial"])
@pytest.mark.parametrize("policy", ["dynamic", "frozen"])
def test_linear_matches_reference(mode, policy):
    x, w = _xw()
    kw = dict(mode=mode, bx=7, bw=7, v_wl=0.7)
    sub_j = j_sub.as_substrate(j_lin.IMCConfig(**kw))
    sub_t = t_sub.as_substrate(t_lin.IMCConfig(**kw))
    if policy == "frozen":
        stats = {"attn.wq": dict(x_max=3.5, w_max=0.6, sigma_yo=1.1)}
        stats["*"] = dict(x_max=4.0, w_max=0.7, sigma_yo=1.3)
        sub_j = sub_j.frozen(j_sub.Calibration.from_dict(stats))
        sub_t = sub_t.frozen(t_sub.Calibration.from_dict(stats))
    y_j = _np(j_lin.linear(jnp.asarray(w), jnp.asarray(x), sub_j,
                           site="attn.wq"))
    y_t = t_lin.linear(torch.tensor(w), torch.tensor(x), sub_t,
                       site="attn.wq").numpy()
    if mode == "imc_analytic" and policy == "dynamic":
        # one-code MPC flips where the per-batch std rounds differently
        assert float((np.abs(y_t - y_j) > 1e-5).mean()) <= 0.02
    else:
        np.testing.assert_allclose(y_t, y_j, rtol=1e-5, atol=1e-5)


def test_linear_analytic_noise_is_seeded_and_at_snr_a():
    x, w = _xw(b=(64,), k=128, m=64)
    sub = t_sub.AnalyticIMC(bx=8, bw=8, snr_a_db=20.0, b_adc=12)
    xt, wt = torch.tensor(x), torch.tensor(w)
    clean = t_lin.linear(wt, xt, sub)
    a = t_lin.linear(wt, xt, sub, rng=3)
    assert torch.equal(a, t_lin.linear(wt, xt, sub, rng=3))
    snr = 10 * np.log10(float(clean.var()) / float((a - clean).var()))
    assert 17.0 < snr < 21.0


def test_linear_ste_gradient_passes_through():
    x, w = _xw()
    xt = torch.tensor(x, requires_grad=True)
    y = t_lin.linear(torch.tensor(w), xt, t_lin.IMCConfig(mode="fakequant"))
    y.sum().backward()
    g_j = jax.grad(lambda xx: j_lin.linear(
        jnp.asarray(w), xx, j_lin.IMCConfig(mode="fakequant")).sum())(
            jnp.asarray(x))
    np.testing.assert_allclose(xt.grad.numpy(), _np(g_j), rtol=1e-5,
                               atol=1e-6)


def test_layer_rng_is_a_seed_derivation():
    assert t_lin.layer_rng(None, 3) is None
    assert t_lin.layer_rng(7, 3) == t_lin.layer_rng(7, 3)
    assert t_lin.layer_rng(7, 3) != t_lin.layer_rng(7, 4)


# ---------------------------------------------------------------------------
# substrates and calibration
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["imc_analytic", "imc_bitserial"])
def test_calibration_json_matches_reference(smoke, mode):
    cfg_j, cfg_t, params_j, params_t = smoke
    kw = dict(mode=mode, bx=7, bw=7, v_wl=0.7)
    batch = np.random.default_rng(1).integers(0, cfg_j.vocab_size, (2, 24))
    cal_j = j_sub.calibrate_model(cfg_j.replace(imc=j_lin.IMCConfig(**kw)),
                                  params_j, [batch]).imc.calibration
    cal_t = t_sub.calibrate_model(cfg_t.replace(imc=t_lin.IMCConfig(**kw)),
                                  params_t, [batch]).imc.calibration
    d_j, d_t = cal_j.to_dict(), cal_t.to_dict()
    assert sorted(d_j) == sorted(d_t)
    for site in d_j:
        for f, v in d_j[site].items():
            assert d_t[site][f] == pytest.approx(v, rel=1e-5), (site, f)
    # the JSON files are interchangeable between the packages
    back = j_sub.Calibration.from_dict(json.loads(json.dumps(d_t)))
    assert back.site_names() == cal_j.site_names()
    again = t_sub.Calibration.from_dict(json.loads(json.dumps(d_j)))
    assert again.to_dict() == d_j


def test_substrate_api_matches_reference():
    ov = {"lm_head": {"b_adc": 10}, "attn": {"bx": 5}}
    s_j = j_sub.BitSerialIMC(bx=7, bw=7, overrides=ov)
    s_t = t_sub.BitSerialIMC(bx=7, bw=7, overrides=ov)
    for site in ("lm_head", "attn.wq", "mlp.wi", None):
        c_t = s_t.site_config(site)
        assert dataclass_tuple(c_t) == dataclass_tuple(
            s_j.site_config(site), like=c_t)
    assert s_t.site_stats("x") is None
    with pytest.raises(ValueError):
        t_sub.Substrate(policy="frozen")
    with pytest.raises(ValueError):
        t_sub.AnalyticIMC(imc=t_lin.IMCConfig(mode="digital"))
    cal = t_sub.Calibration.from_dict(
        {"*": dict(x_max=1.0, w_max=2.0, sigma_yo=3.0)})
    frozen = s_t.frozen(cal)
    assert frozen.site_stats("mlp.wo").w_max == 2.0
    assert frozen.trace_key == s_t.trace_key[:1] + ("frozen",) + \
        s_t.trace_key[2:]
    assert frozen.dynamic() == s_t
    assert isinstance(t_sub.as_substrate(None), t_sub.DigitalSubstrate)


def dataclass_tuple(c, like=None):
    """The field values of ``c``, taken by the field names of ``like`` (the
    reference's ``use_kernel`` knob has no counterpart in the port)."""
    import dataclasses

    return tuple(getattr(c, f.name) for f in dataclasses.fields(like or c))


def test_recorder_ignores_zero_rows_and_merges_by_max():
    rec = t_sub.CalibrationRecorder()
    x, w = _xw(b=(4,))
    xt, wt = torch.tensor(x), torch.tensor(w)
    rec.observe("s", xt, wt)
    one = rec.finalize()
    rec.observe("s", torch.cat([xt, torch.zeros(3, x.shape[1])]), wt)
    assert rec.finalize() == one
    rec.observe("s", 2 * xt, wt)
    assert rec.finalize().get("s").x_max > one.get("s").x_max


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def test_forward_matches_reference(smoke):
    cfg_j, cfg_t, params_j, params_t = smoke
    toks = np.random.default_rng(0).integers(0, cfg_j.vocab_size, (2, 24))
    lj, _ = j_forward(params_j, cfg_j, jnp.asarray(toks, jnp.int32))
    lt, _ = t_forward(params_t, cfg_t, torch.tensor(toks))
    np.testing.assert_allclose(lt.numpy(), _np(lj), atol=1e-4)


def test_prefill_logits_and_caches_match_reference(smoke):
    cfg_j, cfg_t, params_j, params_t = smoke
    toks = np.random.default_rng(2).integers(0, cfg_j.vocab_size, (3, 32))
    true_len = np.asarray([32, 9, 20])
    lj, cj = j_prefill(params_j, cfg_j, jnp.asarray(toks, jnp.int32),
                       cache_len=40, true_len=jnp.asarray(true_len))
    lt, ct = t_prefill(params_t, cfg_t, torch.tensor(toks), 40,
                       true_len=torch.tensor(true_len))
    np.testing.assert_allclose(lt.numpy(), _np(lj), atol=1e-4)
    for kv in ("k", "v"):
        np.testing.assert_allclose(ct["blocks"]["p0"][kv].numpy(),
                                   _np(cj["blocks"]["p0"][kv]), atol=1e-4)
    assert ct["pos"].tolist() == true_len.tolist()


def _decode_both(cfg_j, cfg_t, params_j, params_t, steps=10):
    """Decode from an empty paged cache on both packages with the same block
    table; returns per-step logits of each."""
    b, nb, bs, cache_len = 3, 16, 4, 16
    cj = j_init_paged(cfg_j, b, cache_len, nb, bs)
    ct = t_init_paged(cfg_t, b, cache_len, nb, bs, device="cpu")
    bt = np.arange(1, 1 + b * 4, dtype=np.int32).reshape(b, 4)
    cj["blocks"]["p0"]["bt"] = jnp.broadcast_to(
        jnp.asarray(bt), cj["blocks"]["p0"]["bt"].shape)
    ct["blocks"]["p0"]["bt"][:] = torch.tensor(bt)
    cj["pos"] = jnp.asarray([0, 2, 5], jnp.int32)
    ct["pos"] = torch.tensor([0, 2, 5])
    active = np.array([True, True, False])
    toks = np.random.default_rng(4).integers(0, cfg_j.vocab_size, (steps, b))
    out_j, out_t = [], []
    for t in range(steps):
        lj, cj = j_decode(params_j, cfg_j, jnp.asarray(toks[t], jnp.int32),
                          cj, active=jnp.asarray(active))
        lt, ct = t_decode(params_t, cfg_t, torch.tensor(toks[t]), ct,
                          active=torch.tensor(active))
        out_j.append(_np(lj))
        out_t.append(lt.numpy())
    return out_j, out_t, ct


@pytest.mark.parametrize("decode_attn", ["kernel", "gather"])
def test_decode_step_matches_reference(smoke, decode_attn):
    cfg_j, cfg_t, params_j, params_t = smoke
    out_j, out_t, _ = _decode_both(cfg_j.replace(decode_attn=decode_attn),
                                   cfg_t.replace(decode_attn=decode_attn),
                                   params_j, params_t)
    for lj, lt in zip(out_j, out_t):
        np.testing.assert_allclose(lt, lj, atol=1e-4)


def test_paged_decode_equals_gather_decode(smoke):
    cfg_j, cfg_t, params_j, params_t = smoke
    _, out_k, ck = _decode_both(cfg_j, cfg_t, params_j, params_t)
    _, out_g, cg = _decode_both(cfg_j, cfg_t.replace(decode_attn="gather"),
                                params_j, params_t)
    for lk, lg in zip(out_k, out_g):
        np.testing.assert_allclose(lk, lg, rtol=1e-5, atol=1e-5)
        assert (lk.argmax(-1) == lg.argmax(-1)).all()
    for key in ("pk", "pv"):
        # layer 0's K/V depend on the embeddings alone: bit-equal; deeper
        # layers see the two attentions' last-ulp differences
        k0, g0 = ck["blocks"]["p0"][key], cg["blocks"]["p0"][key]
        assert torch.equal(k0[0, 1:], g0[0, 1:])
        torch.testing.assert_close(k0[:, 1:], g0[:, 1:], rtol=1e-5,
                                   atol=1e-5)


def test_init_params_layout_matches_reference(smoke):
    cfg_j, cfg_t, params_j, _ = smoke
    params_t = t_init_params(cfg_t, seed=3, device="cpu")
    shapes_j = jax.tree_util.tree_map(lambda a: tuple(a.shape), params_j)

    def shapes(tree):
        if isinstance(tree, dict):
            return {k: shapes(v) for k, v in tree.items()}
        return tuple(tree.shape)

    assert shapes(params_t) == shapes_j
    again = t_init_params(cfg_t, seed=3, device="cpu")
    assert torch.equal(params_t["blocks"]["p0"]["mixer"]["wq"],
                       again["blocks"]["p0"]["mixer"]["wq"])


def test_bf16_params_convert_bit_for_bit():
    cfg = j_configs.get_smoke(ARCH).replace(dtype="bfloat16")
    params = j_init_params(jax.random.PRNGKey(1), cfg)
    wq = np.asarray(params["blocks"]["p0"]["mixer"]["wq"])
    got = params_from_jax(jax.tree_util.tree_map(np.asarray, params), "cpu")
    t = got["blocks"]["p0"]["mixer"]["wq"]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                  wq.view(np.uint16).astype(np.int16))


def test_entry_points_never_fall_back_to_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_init_params(t_configs.get_smoke(ARCH))
    assert resolve_device("cpu") == torch.device("cpu")


def test_unported_archs_raise():
    with pytest.raises(NotImplementedError, match="not ported"):
        t_configs.get("gemma2-9b")
    with pytest.raises(KeyError):
        t_configs.get("no-such-arch")
