"""Helpers shared by the CPU tests that hold the recurrent, MoE and VLM
architectures of the port against the JAX package
(``tests/test_torch_recurrent.py``, ``test_torch_moe.py``,
``test_torch_vlm.py``): SMOKE configs in float32 with the JAX parameters
carried over, engine runs of both packages (the JAX ones memoized per
module process, since compiling them is most of the time) and the
bit-serial substrate's hold against the JAX package up to checked knife
edges."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.core import substrate as j_sub
from repro.core.imc_linear import IMCConfig as JIMC
from repro.launch import serve as j_serve
from repro.models import decode_step as j_decode
from repro.models import prefill as j_prefill
from repro_torch.core.imc_linear import IMCConfig as TIMC
from repro_torch.core.substrate import calibrate_model as t_calibrate
from repro_torch.models import decode_step as t_decode
from repro_torch.models import prefill as t_prefill
from test_torch_archs import _np, _smoke
from test_torch_archs_serve import EDGE_DEV_CAP

_RUNS = {}
# operand bits of the IMC substrates here: the JAX package compiles its
# bit-serial oracle with one plane product per pair of bits, and 4 x 4
# planes compile about three times faster than 7 x 7.  The plane loop is
# the same code at every width in both packages; it is held at 7 x 7 by
# tests/test_torch_kernels.py and tests/test_torch_archs_serve.py.
IMC_BITS = 4


def setup(arch, mode="digital"):
    """(cfg_j, cfg_t, params_j, params_t) of ``arch``'s SMOKE config on
    ``mode``, memoized.  An IMC mode runs under the port's frozen
    calibration on a seeded reference batch, installed in both packages
    (the calibration JSON is interchangeable between them,
    ``tests/test_torch_model.py``), so both run the same ranges and the JAX
    side skips its own calibration pass.  Its operands take ``IMC_BITS``
    bits."""
    key = ("setup", arch, mode)
    if key not in _RUNS:
        cfg_j, cfg_t, params_j, params_t = _smoke(arch)
        if mode != "digital":
            kw = dict(mode=mode, bx=IMC_BITS, bw=IMC_BITS, v_wl=0.7)
            ref = np.random.default_rng(1).integers(0, cfg_t.vocab_size,
                                                    (2, 24))
            cfg_t = t_calibrate(cfg_t.replace(imc=TIMC(**kw)), params_t,
                                [ref])
            cal = j_sub.Calibration.from_dict(
                cfg_t.imc.calibration.to_dict())
            cfg_j = cfg_j.replace(
                imc=j_sub.as_substrate(JIMC(**kw)).frozen(cal))
        _RUNS[key] = (cfg_j, cfg_t, params_j, params_t)
    return _RUNS[key]


def prompts(cfg, lens, seed=11):
    rnp = np.random.default_rng(seed)
    return [rnp.integers(0, cfg.vocab_size, n) for n in lens]


def run_engine(serve_mod, cfg, params, lens, max_new, slots=4, chunk=4,
               **kw):
    """Serve seeded prompts of ``lens`` (``max_new`` an int or one per
    request); returns ({rid: tokens}, engine)."""
    news = max_new if isinstance(max_new, (list, tuple)) else (
        [max_new] * len(lens))
    reqs = [serve_mod.Request(rid=i, prompt=p, max_new=news[i])
            for i, p in enumerate(prompts(cfg, lens))]
    engine = serve_mod.Engine(cfg, params, batch_slots=slots,
                              cache_len=32 + max(news) + 8, max_chunk=chunk,
                              block_size=8, **kw)
    done = serve_mod.serve(engine, reqs)
    assert all(r.error is None for r in done), [r.error for r in done]
    return {r.rid: r.out for r in done}, engine


def jax_engine(arch, mode, lens, max_new, slots=4, chunk=4):
    """The JAX engine's tokens and counters for one run, memoized."""
    key = ("jax", arch, mode, tuple(lens), str(max_new), slots, chunk)
    if key not in _RUNS:
        cfg_j, _, params_j, _ = setup(arch, mode)
        out, eng = run_engine(j_serve, cfg_j, params_j, lens, max_new, slots,
                              chunk)
        _RUNS[key] = out, (eng.prefill_calls, eng.prefill_rows,
                           eng.decode_calls, eng.decode_steps)
    return _RUNS[key]


def counters(eng):
    return (eng.prefill_calls, eng.prefill_rows, eng.decode_calls,
            eng.decode_steps)


def greedy_sequential(cfg, params, prompt, max_new):
    """One request alone: exact-length prefill, then decode_step on the
    contiguous caches."""
    logits, cache = t_prefill(params, cfg, torch.tensor(prompt)[None, :],
                              len(prompt) + max_new + 8)
    out = [int(torch.argmax(logits[0, -1]))]
    while len(out) < max_new:
        logits, cache = t_decode(params, cfg, torch.tensor([out[-1]]), cache)
        out.append(int(torch.argmax(logits[0, 0])))
    return out


# ---------------------------------------------------------------------------
# frozen imc_bitserial against the JAX package: both packages run the same
# requests outside the engine, the port also on the reference's tokens
# ---------------------------------------------------------------------------


def _stack(caches, cat):
    """Contiguous caches of single requests as one batch: every leaf
    joined on its batch axis (1, after the stacked layers), the shared
    ``pos`` kept."""
    c0 = caches[0]
    if isinstance(c0, dict):
        return {k: _stack([c[k] for c in caches], cat) for k in c0}
    if c0.ndim == 0:
        assert all(int(c) == int(c0) for c in caches)
        return c0
    return cat(caches)


def _requests(pf, dec, ps, max_new, follow, together, to_dev, to_np, cat):
    """Greedy runs of the prompts ``ps``: each prefilled alone at its exact
    length, then ``decode_step`` on the contiguous caches, each request
    alone or, with ``together``, every request's rows in one batch (how
    the engine decodes its slots; ``max_new`` <= 2).  Each row is fed its
    own greedy pick or, with ``follow``, the reference's tokens.  Returns
    ({rid: picks}, {rid: logits (max_new, V)})."""
    rows, caches = [], []
    for p in ps:
        lg, cache = pf(to_dev(np.asarray(p)[None, :]))
        rows.append([to_np(lg)[0, -1]])
        caches.append(cache)

    def feed(rid):
        i = len(rows[rid]) - 1
        return follow[rid][i] if follow else int(rows[rid][i].argmax())

    if together and max_new > 1:
        assert max_new == 2
        lg, _ = dec(to_dev(np.asarray([feed(r) for r in range(len(ps))])),
                    _stack(caches, cat))
        for rid, r in enumerate(rows):
            r.append(to_np(lg)[rid, 0])
    else:
        for rid, cache in enumerate(caches):
            while len(rows[rid]) < max_new:
                lg, cache = dec(to_dev(np.asarray([feed(rid)])), cache)
                rows[rid].append(to_np(lg)[0, 0])
    return ({rid: [int(x.argmax()) for x in r] for rid, r in enumerate(rows)},
            {rid: np.stack(r) for rid, r in enumerate(rows)})


def jax_requests(arch, lens, max_new, together=False):
    """The JAX package's greedy runs of the seeded prompts of ``lens`` on
    frozen imc_bitserial (``_requests``, prefill and decode_step each
    jitted), memoized: ({rid: tokens}, {rid: logits})."""
    key = ("jax_requests", arch, tuple(lens), max_new, together)
    if key not in _RUNS:
        cfg_j, _, params_j, _ = setup(arch, "imc_bitserial")
        cache_len = max(lens) + max_new + 8

        _RUNS[key] = _requests(
            jax.jit(lambda t: j_prefill(params_j, cfg_j, t, cache_len)),
            jax.jit(lambda t, c: j_decode(params_j, cfg_j, t, c)),
            prompts(cfg_j, lens), max_new, None, together,
            lambda a: jnp.asarray(a, jnp.int32), _np,
            lambda xs: jnp.concatenate(xs, axis=1))
    return _RUNS[key]


def port_requests(arch, lens, max_new, together=False, follow=None):
    """The port's ``_requests`` on frozen imc_bitserial, on its own picks or
    ``follow``'s."""
    _, cfg_t, _, params_t = setup(arch, "imc_bitserial")
    cache_len = max(lens) + max_new + 8
    return _requests(
        lambda t: t_prefill(params_t, cfg_t, t, cache_len),
        lambda t, c: t_decode(params_t, cfg_t, t, c),
        prompts(cfg_t, lens), max_new, follow, together, torch.tensor,
        lambda a: a.numpy(), lambda xs: torch.cat(xs, dim=1))


def assert_bitserial_tokens(arch, out_t, lens, max_new, together=False):
    """The port's engine tokens ``out_t`` on frozen imc_bitserial against
    the JAX package's runs of the same requests (``jax_requests``): the
    port replays the reference's tokens, and its logits deviate from the
    reference's by at most ``EDGE_DEV_CAP`` everywhere; a request whose
    tokens differ has a differing pick there, each only where the
    reference's own margin between the two picks is within the packages'
    deviation (a knife edge); and the engine equals the port's own runs of
    the requests (the frozen-calibration contract)."""
    out_j, lj = jax_requests(arch, lens, max_new, together)
    _, lt = port_requests(arch, lens, max_new, together, follow=out_j)
    for rid in out_j:
        dev = np.abs(lj[rid] - lt[rid]).max(axis=-1)
        assert float(dev.max()) <= EDGE_DEV_CAP, (rid, dev)
        if out_t[rid] == out_j[rid]:
            continue
        edges = [(i, int(a.argmax()), int(b.argmax()))
                 for i, (a, b) in enumerate(zip(lj[rid], lt[rid]))
                 if a.argmax() != b.argmax()]
        assert edges, (rid, out_t[rid], out_j[rid])
        for i, pj, pt in edges:
            margin = float(lj[rid][i, pj] - lj[rid][i, pt])
            assert margin <= dev[i], (rid, i, pj, pt, margin, dev[i])
    own, _ = port_requests(arch, lens, max_new, together)
    assert out_t == own
