"""The port's training slice against the JAX package, on the CPU, in float32
on SMOKE configs, from numpy-seeded inputs and converted parameters
(``repro_torch.convert``).  Each JAX reference run is computed once per
module and shared.

Tolerances:
  - ``loss_fn``: loss, ce, moe_aux and z_loss at rel 1e-5; every gradient
    leaf within 1e-4 of the leaf's largest absolute value.
  - the flash Function: dq, dk, dv at rel 1e-5 of each gradient's largest
    absolute value, against ``jax.vjp`` of the reference's
    ``flash_attention`` and against plain autograd through the port's
    blocked forward.
  - STE paths (fakequant, dynamic imc_analytic with rng=None): loss at rel
    1e-4; per leaf at least 99.9% of the elements within the digital
    tolerance (a flipped ADC code at a knife edge moves the rest; counted).
  - AdamW: params, m, v, grad_norm and clip_scale at rel 1e-6; the decay
    mask equal leaf by leaf; ``warmup_cosine`` equal at every step but
    where the two packages' float32 cosines round apart (one ulp, <= 2% of
    the steps).
  - the pipeline: batches bit-identical; checkpoints: manifests and ``.npy``
    bytes identical, restores equal.
  - three train steps: losses at rel 1e-5, and after them at least 99.9% of
    each parameter leaf within rtol 1e-4, atol 1e-6.
  - the whole-model SNR sweep: the baseline at rel 1e-5, each noisy loss
    within 0.01 of the reference's, at 10 dB as a mean over 32 noise seeds
    (the packages draw different noise; see the test).
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as j_configs
from repro.checkpoint import manager as j_ckpt
from repro.core.imc_linear import IMCConfig as JIMC
from repro.core.substrate import as_substrate as j_as_substrate
from repro.data import pipeline as j_pipe
from repro.models import attention as j_attn
from repro.models import init_params as j_init_params
from repro.models import loss_fn as j_loss_fn
from repro.optim import adamw as j_adamw
from repro_torch import configs as t_configs
from repro_torch import tree as t_tree
from repro_torch.benchmarks import layer_snr as t_layer_snr
from repro_torch.checkpoint import manager as t_ckpt
from repro_torch.configs import shapes as t_shapes
from repro_torch.convert import opt_state_from_jax, params_from_jax
from repro_torch.core.imc_linear import IMCConfig as TIMC
from repro_torch.core.substrate import as_substrate as t_as_substrate
from repro_torch.data import pipeline as t_pipe
from repro_torch.launch import steps as t_steps
from repro_torch.models import attention as t_attn
from repro_torch.models import init_params as t_init_params
from repro_torch.models import loss_fn as t_loss_fn
from repro_torch.optim import adamw as t_adamw

GRAD_ARCHS = ("musicgen-medium", "gemma2-9b", "mamba2-2.7b",
              "recurrentgemma-2b", "granite-moe-1b-a400m", "internvl2-2b")
_CACHE = {}


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """SMOKE shapes gain nothing from more intra-op threads, and the tier-1
    run shares the machine's cores among its workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _keyed(tree):
    """path -> numpy array of a JAX tree, in ``keystr`` form."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in flat}


def _batch(cfg, b=2, s=32, seed=1):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    if cfg.modality == "vlm":
        out["prefix_embeds"] = rng.normal(
            size=(b, cfg.prefix_len, cfg.d_model)).astype(np.float32)
    return out


def _cfgs(arch, mode=None):
    cfg_j, cfg_t = j_configs.get_smoke(arch), t_configs.get_smoke(arch)
    if mode is not None:
        cfg_j = cfg_j.replace(imc=j_as_substrate(JIMC(mode=mode, bx=7, bw=7)))
        cfg_t = cfg_t.replace(imc=t_as_substrate(TIMC(mode=mode, bx=7, bw=7)))
    return cfg_j, cfg_t


def _reference_value_and_grad(arch, mode=None):
    """The reference's jitted ``value_and_grad(loss_fn)`` on ``arch``'s
    SMOKE config, ``(params, batch) -> ((loss, metrics), grads)``: compiled
    once per module for every batch of one shape."""
    key = ("vg", arch, mode)
    if key not in _CACHE:
        cfg_j, _ = _cfgs(arch, mode)
        _CACHE[key] = jax.jit(jax.value_and_grad(
            lambda p, b: j_loss_fn(p, cfg_j, b), has_aux=True))
    return _CACHE[key]


def _reference_params(arch):
    """The reference's ``init_params(PRNGKey(0))`` on ``arch``'s SMOKE
    config: drawn once per module, shared by every mode and test (the
    substrate does not enter the draw)."""
    key = ("params", arch)
    if key not in _CACHE:
        _CACHE[key] = j_init_params(jax.random.PRNGKey(0),
                                    j_configs.get_smoke(arch))
    return _CACHE[key]


def _reference_grad(arch, mode=None):
    """(params as numpy, batch, loss, metrics, grads by path): the
    reference's ``value_and_grad(loss_fn)`` on ``arch``'s SMOKE config."""
    key = ("grad", arch, mode)
    if key not in _CACHE:
        cfg_j, _ = _cfgs(arch, mode)
        params = _reference_params(arch)
        batch = _batch(cfg_j)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        (loss, metrics), grads = _reference_value_and_grad(arch, mode)(
            params, jb)
        _CACHE[key] = (jax.tree_util.tree_map(np.asarray, params), batch,
                       float(loss), {k: float(v) for k, v in metrics.items()},
                       _keyed(grads))
    return _CACHE[key]


def _port_grad(arch, mode=None):
    _, cfg_t = _cfgs(arch, mode)
    params_np, batch = _reference_grad(arch, mode)[:2]
    params = params_from_jax(params_np, "cpu")
    flat = t_tree.flatten_with_path(params)
    for _, p in flat:
        p.requires_grad_(True)
    loss, metrics = t_loss_fn(params, cfg_t,
                              {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, [p for _, p in flat])
    return (float(loss), {k: float(v) for k, v in metrics.items()},
            {path: g.numpy() for (path, _), g in zip(flat, grads)})


def _rel(a, b):
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b)))
                 / max(float(np.max(np.abs(b))), 1e-30))


# ---------------------------------------------------------------------------
# loss_fn and its gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", GRAD_ARCHS)
def test_loss_and_grads_match_reference(arch):
    _, _, loss_j, met_j, grads_j = _reference_grad(arch)
    loss_t, met_t, grads_t = _port_grad(arch)
    assert loss_t == pytest.approx(loss_j, rel=1e-5)
    assert met_t.keys() == met_j.keys() == {"ce", "moe_aux", "z_loss"}
    for k in met_j:
        assert met_t[k] == pytest.approx(met_j[k], rel=1e-5, abs=1e-7), k
    assert grads_t.keys() == grads_j.keys()
    worst = max(_rel(grads_t[p], grads_j[p]) for p in grads_j)
    print(f"{arch}: worst leaf error {worst:.2e} of its largest gradient")
    assert worst <= 1e-4


# ---------------------------------------------------------------------------
# the flash Function
# ---------------------------------------------------------------------------

# (b, s, hq, hkv, hd, softcap, window, q_block, kv_block)
FLASH_CASES = {
    "mha_padded": (2, 37, 4, 4, 16, None, None, 16, 16),
    "gqa_g2": (2, 48, 4, 2, 16, None, None, 16, 16),
    "mqa": (1, 40, 4, 1, 32, None, None, 16, 8),
    "softcap50": (2, 40, 4, 2, 16, 50.0, None, 16, 16),
    "window": (2, 45, 4, 2, 16, None, 10, 16, 16),
}


def _flash_inputs(case, seed=0):
    b, s, hq, hkv, hd = FLASH_CASES[case][:5]
    rng = np.random.default_rng(seed)
    # scaled so the softcap bends the scores
    q = (rng.normal(size=(b, s, hq, hd)) * 3).astype(np.float32)
    k = (rng.normal(size=(b, s, hkv, hd)) * 3).astype(np.float32)
    v = rng.normal(size=(b, s, hkv, hd)).astype(np.float32)
    dout = rng.normal(size=(b, s, hq, hd)).astype(np.float32)
    return q, k, v, dout


def _dims(mod, case):
    _, _, hq, hkv, hd, cap, window, qb, kb = FLASH_CASES[case]
    return mod.AttnDims(n_heads=hq, n_kv=hkv, head_dim=hd, scale=hd**-0.5,
                        softcap_val=cap, window=window, q_block=qb,
                        kv_block=kb, rope_theta=1e4, use_rope=False)


def _port_flash_grads(case, fn):
    q, k, v, dout = (torch.from_numpy(a) for a in _flash_inputs(case))
    q, k, v = (t.requires_grad_(True) for t in (q, k, v))
    out = fn(q, k, v, _dims(t_attn, case))
    return out, torch.autograd.grad(out, (q, k, v), dout)


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_function_matches_reference_vjp(case):
    q, k, v, dout = _flash_inputs(case)
    dims = _dims(j_attn, case)

    @jax.jit
    def ref(q, k, v, dout):
        out, vjp = jax.vjp(
            lambda q, k, v: j_attn.flash_attention(q, k, v, dims), q, k, v)
        return out, vjp(dout)

    out_j, grads_j = ref(q, k, v, dout)
    out_t, grads_t = _port_flash_grads(case, t_attn.flash_attention)
    assert _rel(out_t.detach().numpy(), out_j) <= 1e-5
    for name, gt, gj in zip("qkv", grads_t, grads_j):
        assert _rel(gt.numpy(), gj) <= 1e-5, name

    def plain(q, k, v, dims):  # autograd through the blocked forward
        return t_attn.flash_forward(q, k, v, dims)[0].reshape(q.shape)

    _, grads_p = _port_flash_grads(case, plain)
    for name, gt, gp in zip("qkv", grads_t, grads_p):
        assert _rel(gt.numpy(), gp.numpy()) <= 1e-5, name


# ---------------------------------------------------------------------------
# the STE paths of the IMC layer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["fakequant", "imc_analytic"])
def test_ste_gradients_match_reference(mode):
    _, _, loss_j, _, grads_j = _reference_grad("musicgen-medium", mode)
    loss_t, _, grads_t = _port_grad("musicgen-medium", mode)
    assert loss_t == pytest.approx(loss_j, rel=1e-4)
    flipped = 0
    for path, gj in grads_j.items():
        tol = 1e-4 * max(float(np.max(np.abs(gj))), 1e-30)
        off = int(np.sum(np.abs(grads_t[path] - gj) > tol))
        flipped += off
        assert off <= 1e-3 * gj.size, (path, off, gj.size)
    print(f"{mode}: {flipped} gradient elements off at knife edges")


def test_noise_aware_training_reduces_loss():
    """The port's counterpart of the reference's QAT sanity check, with
    noise on: 30 SGD steps through imc_analytic at SNR_a 22 dB reduce a
    regression loss, for each of five noise seeds."""
    from repro_torch.core.imc_linear import linear

    cfg = TIMC(mode="imc_analytic", bx=6, bw=6, snr_a_db=22.0)
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((32, 1024), generator=gen)
    target = torch.randn((32, 16), generator=gen)
    for seed in range(5):
        w = (torch.randn((1024, 16), generator=gen) * 0.01).requires_grad_()

        def loss(w, rng):
            return torch.mean((linear(w, x, cfg, rng=rng) - target) ** 2)

        l0 = float(loss(w, 100 + seed))
        for i in range(30):
            (g,) = torch.autograd.grad(loss(w, 1000 * seed + i), (w,))
            w = (w - 0.05 * g).detach().requires_grad_()
        assert float(loss(w, 100 + seed)) < 0.7 * l0


# ---------------------------------------------------------------------------
# AdamW and the schedule
# ---------------------------------------------------------------------------


def _adamw_tree(rng):
    def a(*shape, s=1.0):
        return (rng.normal(size=shape) * s).astype(np.float32)

    # two shapes only: the reference's eager update compiles each op per
    # shape
    return {"embed": a(32, 8), "final_norm": {"scale": a(8)},
            "blocks": {"p0": {"attn": {"wq": a(32, 8)},
                              "norm1": {"bias": a(8)},
                              "ssm": {"A_log": a(8), "dt_bias": a(8)}}}}


def test_adamw_updates_match_reference():
    rng = np.random.default_rng(4)
    params = _adamw_tree(rng)
    cfg_j = j_adamw.AdamWConfig(lr=1e-2)
    cfg_t = t_adamw.AdamWConfig(lr=1e-2)
    pj, sj = params, j_adamw.init(params)
    pt = params_from_jax(params, "cpu")
    st = opt_state_from_jax(jax.tree_util.tree_map(np.asarray, sj), "cpu")
    clipped = []
    for i, s in enumerate((0.01, 5.0, 0.02)):  # the second step clips
        grads = jax.tree_util.tree_map(
            lambda p: (rng.normal(size=p.shape) * s).astype(np.float32),
            params)
        lr = 1e-2 * (i + 1) / 3
        pj, sj, mj = j_adamw.update(grads, sj, pj, cfg_j, jnp.float32(lr))
        st, mt = t_adamw.update(params_from_jax(grads, "cpu"), st, pt, cfg_t,
                                torch.tensor(lr, dtype=torch.float32))
        for k in ("grad_norm", "clip_scale"):
            assert float(mt[k]) == pytest.approx(float(mj[k]), rel=1e-6), k
        assert int(st.count) == int(sj.count) == i + 1
        clipped.append(float(mt["clip_scale"]) < 1.0)
        for name, tj, tt in (("params", pj, pt), ("m", sj.m, st.m),
                             ("v", sj.v, st.v)):
            want = _keyed(tj)
            for path, leaf in t_tree.flatten_with_path(tt):
                np.testing.assert_allclose(leaf.numpy(), want[path],
                                           rtol=1e-6, atol=1e-12,
                                           err_msg=f"{name}{path}")
    assert clipped == [False, True, False]


@pytest.mark.parametrize("arch", j_configs.ARCH_NAMES)
def test_decay_mask_matches_reference(arch):
    cfg_j, cfg_t = j_configs.get_smoke(arch), t_configs.get_smoke(arch)
    shapes = jax.eval_shape(lambda: j_init_params(jax.random.PRNGKey(0),
                                                  cfg_j))
    paths_j = list(_keyed(jax.tree_util.tree_map(
        lambda s: np.zeros((), np.float32), shapes)))
    mask_j = dict(zip(paths_j, j_adamw._decay_mask(shapes, j_adamw.AdamWConfig())))
    params_t = t_init_params(cfg_t, seed=0, device="cpu")
    paths_t = [p for p, _ in t_tree.flatten_with_path(params_t)]
    mask_t = dict(zip(paths_t, t_adamw._decay_mask(params_t,
                                                   t_adamw.AdamWConfig())))
    assert mask_t == mask_j
    assert any(mask_t.values()) and not all(mask_t.values())


@pytest.mark.parametrize("base,warmup,total", [(3e-3, 2, 12), (1e-3, 100, 500),
                                               (5e-3, 1, 9)])
def test_warmup_cosine_matches_reference(base, warmup, total):
    """Equal at every step but where the two cosines round differently: at
    most one float32 ulp, at a few steps (XLA's float32 cos is not always
    the correctly rounded value the port takes from float64)."""
    sj = j_adamw.warmup_cosine(base, warmup, total)
    st = t_adamw.warmup_cosine(base, warmup, total)
    steps = range(total + 3)
    want = np.array([np.float32(sj(jnp.int32(i))) for i in steps])
    got = [st(torch.tensor(i, dtype=torch.int32)) for i in steps]
    assert all(g.dtype == torch.float32 for g in got)
    got = np.array([np.float32(g) for g in got])
    np.testing.assert_array_max_ulp(got, want, maxulp=1)
    off = int(np.sum(got != want))
    print(f"{off} of {len(want)} steps one ulp apart")
    assert off <= 0.02 * len(want)
    assert np.array_equal(got[:warmup + 1], want[:warmup + 1])  # the warmup


def test_input_specs_match_reference():
    from repro.configs import shapes as j_shapes

    assert t_shapes.SHAPES.keys() == j_shapes.SHAPES.keys()
    for arch in j_configs.ARCH_NAMES:
        for name, shape in j_shapes.SHAPES.items():
            cfg_j, cfg_t = j_configs.get(arch), t_configs.get(arch)
            assert (t_shapes.shape_applicable(cfg_t, t_shapes.SHAPES[name])
                    == j_shapes.shape_applicable(cfg_j, shape))
            want = j_shapes.input_specs(cfg_j, shape)
            got = t_shapes.input_specs(cfg_t, t_shapes.SHAPES[name])
            assert got.keys() == want.keys()
            for k in want:
                assert got[k].shape == want[k].shape
                assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype)


# ---------------------------------------------------------------------------
# the data pipeline
# ---------------------------------------------------------------------------


def _pipe_cfgs(**kw):
    return j_pipe.DataConfig(**kw), t_pipe.DataConfig(**kw)


def test_synthetic_batches_bit_identical():
    cj, ct = _pipe_cfgs(seed=3, vocab_size=2048, seq_len=64, global_batch=4)
    src_j, src_t = j_pipe.make_source(cj), t_pipe.make_source(ct)
    assert isinstance(src_t, t_pipe.SyntheticLM)
    for step in (0, 1, 2, 7, 1000):
        bj, bt = src_j.batch(step), src_t.batch(step)
        assert bt["tokens"].dtype == bj["tokens"].dtype == np.int32
        np.testing.assert_array_equal(bt["tokens"], bj["tokens"])


@pytest.mark.parametrize("vocab,dtype", [(50257, np.uint16),
                                         (70000, np.uint32)])
def test_memmap_batches_bit_identical(tmp_path, vocab, dtype):
    path = tmp_path / "corpus.bin"
    np.random.default_rng(5).integers(0, vocab, 4000).astype(dtype).tofile(
        path)
    cj, ct = _pipe_cfgs(seed=1, vocab_size=vocab, seq_len=32,
                        global_batch=3, corpus_path=str(path))
    src_j, src_t = j_pipe.make_source(cj), t_pipe.make_source(ct)
    assert isinstance(src_t, t_pipe.MemmapCorpus)
    for step in range(5):
        np.testing.assert_array_equal(src_t.batch(step)["tokens"],
                                      src_j.batch(step)["tokens"])


def test_host_slice_and_prefetch_order():
    cj, ct = _pipe_cfgs(seed=2, vocab_size=512, seq_len=16, global_batch=8)
    src_j, src_t = j_pipe.SyntheticLM(cj), t_pipe.SyntheticLM(ct)
    batch = src_t.batch(4)
    for pi, pc in ((0, 1), (1, 2), (3, 4), (2, 3)):
        got, want = t_pipe.host_slice(batch, pi, pc), j_pipe.host_slice(
            batch, pi, pc)
        np.testing.assert_array_equal(got["tokens"], want["tokens"])
    pf = t_pipe.Prefetcher(src_t, start_step=5, depth=2)
    try:
        for want_step in range(5, 10):
            step, b = next(pf)
            assert step == want_step
            np.testing.assert_array_equal(b["tokens"],
                                          src_j.batch(step)["tokens"])
    finally:
        pf.close()
        pf.thread.join(timeout=5)
    assert not pf.thread.is_alive()


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def _ckpt_tree(rng):
    return {"params": {"w": rng.normal(size=(5, 3)).astype(np.float32),
                       "b": {"x": rng.normal(size=(7,)).astype(np.float32)}},
            "step": np.array(12, np.int32),
            "ids": rng.integers(0, 100, (4, 2)).astype(np.int32)}


def test_checkpoint_layout_equals_reference_and_restores_across(tmp_path):
    tree = _ckpt_tree(np.random.default_rng(0))
    dj, dt = str(tmp_path / "j"), str(tmp_path / "t")
    j_ckpt.save(dj, 3, jax.tree_util.tree_map(jnp.asarray, tree),
                {"next_step": 3})
    t_ckpt.save(dt, 3, params_from_jax(tree, "cpu"), {"next_step": 3})
    sj, st = os.path.join(dj, "step_00000003"), os.path.join(dt,
                                                             "step_00000003")
    assert sorted(os.listdir(sj)) == sorted(os.listdir(st))
    with open(os.path.join(sj, "manifest.json")) as f:
        man_j = json.load(f)
    with open(os.path.join(st, "manifest.json")) as f:
        assert json.load(f) == man_j
    for name in os.listdir(sj):
        with open(os.path.join(sj, name), "rb") as a, \
                open(os.path.join(st, name), "rb") as b:
            assert a.read() == b.read(), name
    like_t = params_from_jax(jax.tree_util.tree_map(np.zeros_like, tree),
                             "cpu")
    got_t, extra = t_ckpt.restore(dj, 3, like_t)
    assert extra == {"next_step": 3}
    got_j, _ = j_ckpt.restore(dt, 3, jax.tree_util.tree_map(jnp.asarray,
                                                             tree))
    want = _keyed(tree)
    for path, leaf in t_tree.flatten_with_path(got_t):
        assert leaf.numpy().dtype == want[path].dtype
        np.testing.assert_array_equal(leaf.numpy(), want[path])
    for path, leaf in _keyed(got_j).items():
        np.testing.assert_array_equal(leaf, want[path])
    assert t_ckpt.latest_step(dj) == j_ckpt.latest_step(dt) == 3


def test_checkpoint_bfloat16_round_trips_bit_for_bit(tmp_path):
    w = torch.randn((6, 40), generator=torch.Generator().manual_seed(1)
                    ).to(torch.bfloat16)
    tree = {"w": w, "s": torch.tensor(3, dtype=torch.int32)}
    t_ckpt.save(str(tmp_path), 1, tree)
    with open(tmp_path / "step_00000001" / "manifest.json") as f:
        assert json.load(f)["leaves"]["['w']"]["dtype"] == "bfloat16"
    got, _ = t_ckpt.restore(str(tmp_path), 1, {"w": torch.zeros_like(w),
                                              "s": torch.zeros_like(tree["s"])})
    assert got["w"].dtype == torch.bfloat16
    assert torch.equal(got["w"].view(torch.int16), w.view(torch.int16))
    assert int(got["s"]) == 3


def test_latest_step_skips_a_corrupt_step_and_cleanup_keeps(tmp_path):
    d = str(tmp_path)
    tree = {"a": torch.arange(6, dtype=torch.float32)}
    for step in range(1, 6):
        t_ckpt.save(d, step, tree)
    os.remove(os.path.join(d, "step_00000005", "arr_00000.npy"))
    with open(os.path.join(d, "step_00000004", "manifest.json"), "w") as f:
        f.write("{not json")
    os.makedirs(os.path.join(d, "step_00000009.tmp"))
    assert t_ckpt.latest_step(d) == j_ckpt.latest_step(d) == 3
    t_ckpt.cleanup(d, keep=2)
    assert sorted(os.listdir(d)) == ["step_00000004", "step_00000005"]


def test_async_save_snapshots_before_an_in_place_change(tmp_path):
    w = torch.arange(1000, dtype=torch.float32)
    b = torch.ones(3, dtype=torch.bfloat16)
    saver = t_ckpt.AsyncSaver()
    saver.save(str(tmp_path), 7, {"w": w, "b": b}, {"next_step": 7})
    w.add_(1.0)  # the optimizer's next step, in place
    b.mul_(3.0)
    saver.wait()
    got, extra = t_ckpt.restore(str(tmp_path), 7, {"w": w, "b": b})
    assert extra == {"next_step": 7}
    assert torch.equal(got["w"], torch.arange(1000, dtype=torch.float32))
    assert torch.equal(got["b"], torch.ones(3, dtype=torch.bfloat16))


# ---------------------------------------------------------------------------
# the slice as a whole: three train steps
# ---------------------------------------------------------------------------


def test_three_train_steps_match_reference():
    arch, steps, lr, b, s = "musicgen-medium", 3, 1e-3, 2, 32
    cfg_j, cfg_t = _cfgs(arch)
    data = t_pipe.SyntheticLM(t_pipe.DataConfig(
        seed=0, vocab_size=cfg_t.vocab_size, seq_len=s, global_batch=b))
    opt_j = j_adamw.AdamWConfig(lr=lr)
    sched = j_adamw.warmup_cosine(lr, min(100, steps // 10 + 1), steps)

    value_and_grad = _reference_value_and_grad(arch)  # shared, compiled once
    update = jax.jit(j_adamw.update, static_argnums=3)

    def ref_step(state, tokens):
        (loss, _), grads = value_and_grad(state["params"], {"tokens": tokens})
        params, opt, _ = update(grads, state["opt"], state["params"], opt_j,
                                sched(state["step"]))
        return {"params": params, "opt": opt, "step": state["step"] + 1}, loss

    params = _reference_params(arch)
    state_j = {"params": params, "opt": j_adamw.init(params),
               "step": jnp.zeros((), jnp.int32)}
    bundle = t_steps.build_train_step(cfg_t, t_adamw.AdamWConfig(lr=lr),
                                      total_steps=steps, device="cpu")
    state_np = jax.tree_util.tree_map(np.asarray, state_j)
    state_t = {"params": params_from_jax(state_np["params"], "cpu"),
               "opt": opt_state_from_jax(state_np["opt"], "cpu"),
               "step": torch.zeros((), dtype=torch.int32)}
    for i in range(steps):
        tokens = data.batch(i)["tokens"]
        state_j, loss_j = ref_step(state_j, jnp.asarray(tokens))
        state_t, met = bundle.step_fn(state_t, {"tokens": torch.from_numpy(
            tokens)})
        assert float(met["loss"]) == pytest.approx(float(loss_j), rel=1e-5)
        assert sorted(met) == sorted(["loss", "lr", "ce", "moe_aux",
                                      "z_loss", "grad_norm", "clip_scale"])
        assert all(v.dtype == torch.float32 for v in met.values())
    assert int(state_t["step"]) == steps
    want = _keyed(state_j["params"])
    worst = (0.0, None)
    for path, leaf in t_tree.flatten_with_path(state_t["params"]):
        got, ref = leaf.numpy(), want[path]
        err = np.abs(got - ref)
        off = err > 1e-6 + 1e-4 * np.abs(ref)
        assert off.sum() <= 1e-3 * ref.size, (path, int(off.sum()))
        i = int(np.argmax(err / (1e-6 + 1e-4 * np.abs(ref))))
        worst = max(worst, (float(err.flat[i]), (path, float(got.flat[i]),
                                                  float(ref.flat[i]))))
    print(f"worst parameter element after {steps} steps: {worst}")


# ---------------------------------------------------------------------------
# the whole-model SNR sweep (benchmarks.layer_snr)
# ---------------------------------------------------------------------------


SNR_SEEDS = 32


def test_whole_model_snr_sweep_matches_reference():
    """gemma2-9b SMOKE, b=2, s=32, at 10 and 40 dB, from the reference
    sweep's own inputs (weights from PRNGKey(0), tokens from PRNGKey(1));
    the reference's losses are its ``loss_fn`` under the sweep's
    substrates and noise keys (``benchmarks/layer_snr.py``), jitted.
    The baseline is deterministic and equal.  A noisy loss is one draw of
    the noise: at 10 dB one seed's loss spreads by ~0.016 in either
    package, so a mean of the sweep's 3 seeds by ~0.01 and two packages'
    3-seed means by ~0.013.  So at 10 dB the packages' means over
    ``SNR_SEEDS`` seeds each (the reference's noise keys
    ``fold_in(PRNGKey(3), i)``, the port's ``layer_rng(3, i)``, the first 3
    of each being its sweep's) are held within 0.01; at 40 dB, where one
    seed spreads by ~0.0013, the sweep's 3-seed means; and the degradation
    at 10 dB above that at 40 dB."""
    from repro.core.substrate import AnalyticIMC as JAnalytic
    from repro_torch.core.imc_linear import layer_rng
    from repro_torch.core.substrate import AnalyticIMC as TAnalytic

    arch, b, s, levels = "gemma2-9b", 2, 32, (10.0, 40.0)
    cfg_j, cfg_t = j_configs.get_smoke(arch), t_configs.get_smoke(arch)
    params = _reference_params(arch)
    toks = jax.random.randint(jax.random.PRNGKey(1), (b, s), 0,
                              cfg_j.vocab_size)
    params_t = params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                               "cpu")
    batch_t = {"tokens": torch.tensor(np.asarray(toks))}
    # the reference sweep's baseline (``layer_snr._loss``: ``loss_fn``),
    # through the gradient holds' compiled ``value_and_grad`` (same shapes)
    (base_j, _), _ = _reference_value_and_grad(arch)(params,
                                                     {"tokens": toks})
    base_j = float(base_j)
    base_t, rows_t = t_layer_snr.whole_model_losses(
        arch, b, s, levels, "cpu", params=params_t, batch=batch_t)
    assert base_t == pytest.approx(base_j, rel=1e-5)
    rows = t_layer_snr.whole_model_snr_sweep(arch, b, s, levels, "cpu",
                                             params=params_t, batch=batch_t)
    assert [r[0] for r in rows] == [f"layer_snr/{arch}/fp_ce"] + [
        f"layer_snr/{arch}/ce_at_{x:.0f}dB" for x in levels]
    assert rows[0][2] == "baseline"
    for r in rows[1:]:
        d, req = r[2].split(" ", 1)
        assert req == "(req: small at >=24 dB, paper SSIII-B)"
        assert float(d[len("dCE="):]) == pytest.approx(r[1] - rows[0][1],
                                                       abs=1.5e-4)
    d_ce = []
    for (snr, row_t), row in zip(rows_t, rows[1:]):
        noisy_j = cfg_j.replace(imc=JAnalytic(bx=8, bw=8, snr_a_db=snr))
        noisy_t = cfg_t.replace(imc=TAnalytic(bx=8, bw=8, snr_a_db=snr))
        n = SNR_SEEDS if snr == 10.0 else 3  # 40 dB: a seed spreads 0.0013
        ref = jax.jit(lambda p, k, c=noisy_j: j_loss_fn(
            p, c, {"tokens": toks}, rng=k)[0])
        draws_j = [float(ref(params, jax.random.fold_in(
            jax.random.PRNGKey(3), i))) for i in range(n)]
        draws_t = [t_layer_snr._loss(noisy_t, params_t, batch_t,
                                     rng=layer_rng(3, i)) for i in range(n)]
        assert row_t == pytest.approx(np.mean(draws_t[:3]), abs=1e-12)
        assert row[1] == round(row_t, 4)
        mean_j, mean_t = np.mean(draws_j), np.mean(draws_t)
        print(f"{snr} dB: 3-seed rows port {row_t:.4f} reference "
              f"{np.mean(draws_j[:3]):.4f}; {n}-seed means port "
              f"{mean_t:.4f} reference {mean_j:.4f} (sd a seed "
              f"{np.std(draws_t):.4f} / {np.std(draws_j):.4f})")
        assert abs(mean_t - mean_j) <= 0.01
        d_ce.append(mean_t - base_t)
    assert d_ce[0] > d_ce[1]
