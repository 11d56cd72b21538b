"""The port's prefix-sharing paged KV against the JAX package, on the CPU.

The radix index (``runtime.prefix_cache``) gives the reference's results on
the same operation sequences.  The engine's warm admissions (linked shared
blocks and a suffix-only prefill; copy-on-write of a fully cached prompt;
LRU leaf-first eviction under pool pressure; preemption and resume of a
prefix-sharing slot) emit greedy tokens bit-identical to a cold engine on
digital, frozen ``imc_analytic`` and frozen ``imc_bitserial``, and the same
tokens and prefix scoreboard as the JAX engine.  The CLI with CI serve smoke
5's flags matches the JAX main: tokens, the scoreboard line, billed counts,
J/token and the savings lines.  musicgen-medium SMOKE in float32 with the
JAX parameters carried over.
"""
import contextlib
import io

import jax
import numpy as np
import pytest

from repro import configs as j_configs
from repro.core.imc_linear import IMCConfig as JIMC
from repro.core.substrate import calibrate_model as j_calibrate
from repro.core.substrate import substrate_for_design as j_for_design
from repro.launch import metering as j_metering
from repro.launch import serve as j_serve
from repro.models import init_params as j_init_params
from repro.runtime.prefix_cache import PrefixCache as JPrefixCache
from repro_torch import configs as t_configs
from repro_torch.convert import params_from_jax
from repro_torch.core.imc_linear import IMCConfig as TIMC
from repro_torch.core.substrate import calibrate_model as t_calibrate
from repro_torch.launch import serve as t_serve
from repro_torch.launch.serve import BlockAllocator, Engine, Request, serve
from repro_torch.runtime.prefix_cache import PrefixCache

ARCH = "musicgen-medium"
SUBSTRATES = ["digital", "imc_analytic", "imc_bitserial"]

_SETUPS = {}


def _setup(mode):
    """(JAX cfg, port cfg, JAX params, port params): SMOKE, frozen on the
    reference batch for the IMC modes, the JAX parameters carried over."""
    if mode in _SETUPS:
        return _SETUPS[mode]
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
    _SETUPS[mode] = cfg_j, cfg_t, params_j, params_t
    return _SETUPS[mode]


def _shared_requests(mod, cfg, prefix_len, tail_lens, max_new, seed=3):
    rnp = np.random.default_rng(seed)
    prefix = rnp.integers(0, cfg.vocab_size, prefix_len)
    return [mod.Request(rid=i, prompt=np.concatenate(
        [prefix, rnp.integers(0, cfg.vocab_size, n)]), max_new=max_new)
        for i, n in enumerate(tail_lens)]


# ---------------------------------------------------------------------------
# the radix index
# ---------------------------------------------------------------------------


def test_prefix_cache_match_insert_roundtrip():
    pc = PrefixCache(block_size=4)
    toks = list(range(11))  # 2 full chunks + a 3-token partial tail
    assert pc.match(toks) == []
    assert pc.insert(toks, [5, 7, 9]) == [5, 7] and len(pc) == 2
    assert [n.block for n in pc.match(toks)] == [5, 7]
    assert [n.block for n in pc.match(list(range(6)))] == [5]
    assert [n.block for n in pc.match([0, 1, 2, 3, 99, 98, 97, 96])] == [5]
    assert pc.match([99, 98, 97, 96]) == []
    with pytest.raises(ValueError, match="needs 2 blocks"):
        pc.insert(list(range(8)), [1])


def test_prefix_cache_first_writer_wins_and_lru():
    pc = PrefixCache(block_size=4)
    pc.insert(list(range(8)), [3, 4])
    assert pc.insert(list(range(8)), [8, 9]) == []
    assert [n.block for n in pc.match(list(range(8)))] == [3, 4]
    assert pc.insert(list(range(12)), [8, 9, 11]) == [11]
    pc.insert([9, 9, 9, 9], [6])
    with pytest.raises(ValueError, match="leaf"):
        pc.remove(pc.match(list(range(8)))[0])
    pc.insert(list(range(8)), [3, 4])  # stamps 3 and 4, not the leaf 11
    assert [n.block for n in pc.leaves_lru()] == [11, 6]
    pc.remove(pc.leaves_lru()[0])
    assert [n.block for n in pc.match(list(range(12)))] == [3, 4]
    assert [n.block for n in pc.leaves_lru()] == [6, 4] and len(pc) == 3


@pytest.mark.parametrize("seed", range(6))
def test_prefix_cache_ops_match_reference(seed):
    """Seeded insert / match / evict-LRU-leaf sequences over a small token
    alphabet (so chains share prefixes): every result equals the JAX
    package's index."""
    rnp = np.random.default_rng(seed)
    bs = int(rnp.integers(1, 5))
    pt, pj = PrefixCache(bs), JPrefixCache(bs)
    next_block = 1
    for _ in range(120):
        op = rnp.integers(0, 3)
        toks = [int(t) for t in rnp.integers(0, 3, rnp.integers(0, 4 * bs))]
        if op == 0:
            blocks = list(range(next_block, next_block + len(toks) // bs))
            next_block += len(blocks)
            assert pt.insert(toks, blocks) == pj.insert(toks, blocks)
        elif op == 1:
            assert ([n.block for n in pt.match(toks)]
                    == [n.block for n in pj.match(toks)])
        else:
            lt, lj = pt.leaves_lru(), pj.leaves_lru()
            assert [(n.block, n.last_use) for n in lt] == [
                (n.block, n.last_use) for n in lj]
            if lt:
                k = int(rnp.integers(0, len(lt)))
                pt.remove(lt[k])
                pj.remove(lj[k])
        assert len(pt) == len(pj)


def test_allocator_refcount_sharing_and_eviction():
    a = BlockAllocator(6)
    got = a.alloc(2)
    a.retain(got)
    a.free(got)
    assert a.used_count == 2 and a.free_count == 3
    a.register_cached(got[0])
    assert a.evictable_count == 0
    with pytest.raises(ValueError, match="not evictable"):
        a.evict(got[0])
    a.free(got)
    assert a.free_count == 4 and a.evictable_count == 1
    assert a.is_evictable(got[0]) and a.used_count == 1
    with pytest.raises(ValueError, match="double free"):
        a.free([got[0]])
    a.evict(got[0])
    assert a.free_count == 5 and a.used_count == 0
    with pytest.raises(ValueError, match="retain of unallocated"):
        a.retain([got[0]])
    with pytest.raises(ValueError, match="cannot cache unallocated"):
        a.register_cached(3)


# ---------------------------------------------------------------------------
# warm == cold, and the port's engine == the JAX engine
# ---------------------------------------------------------------------------


def _conserved(eng):
    a = eng.alloc
    refs = {b for blocks in eng._slot_blocks for b in blocks}
    assert a.free_count + a.used_count == a.num_blocks - 1
    assert a.used_count >= len(refs)


@pytest.mark.parametrize("substrate", SUBSTRATES)
def test_prefix_hits_bit_identical_to_cold_and_reference(substrate):
    """A shared 16-token system prompt over three requests: the first is a
    cold miss that indexes its blocks, the later ones link the cached chain
    and prefill only their suffix.  Tokens equal the cold engine's and the
    JAX warm engine's, and so does the scoreboard."""
    cfg_j, cfg_t, params_j, params_t = _setup(substrate)
    max_new = 4 if substrate == "imc_bitserial" else 5
    tails = [5, 9, 3] if substrate != "imc_bitserial" else [5, 3]

    cold = Engine(cfg_t, params_t, batch_slots=4, cache_len=48, max_chunk=4)
    cold_out = {r.rid: r.out for r in serve(
        cold, _shared_requests(t_serve, cfg_t, 16, tails, max_new))}

    def warm_run(mod, cfg, params):
        eng = mod.Engine(cfg, params, batch_slots=4, cache_len=48,
                         max_chunk=4, prefix_cache=True)
        rq = _shared_requests(mod, cfg, 16, tails, max_new)
        done = mod.serve(eng, [rq[0]])  # seeds the index (a miss)
        done = done + mod.serve(eng, rq[1:])
        return eng, {r.rid: r.out for r in done}

    warm, warm_out = warm_run(t_serve, cfg_t, params_t)
    assert warm.prefix_hits == len(tails) - 1
    assert warm.prefix_hit_tokens == 16 * (len(tails) - 1)
    assert warm.cow_copies == 0
    assert warm_out == cold_out
    assert warm.alloc.used_count == warm.alloc.evictable_count > 0
    _conserved(warm)
    warm_j, warm_out_j = warm_run(j_serve, cfg_j, params_j)
    assert warm_out == warm_out_j
    assert warm.prefix_stats() == warm_j.prefix_stats()
    assert (warm.prefill_calls, warm.decode_steps, warm.host_transfer_bytes) \
        == (warm_j.prefill_calls, warm_j.decode_steps,
            warm_j.host_transfer_bytes)


@pytest.mark.parametrize("substrate", SUBSTRATES)
def test_cow_on_fully_cached_prompt_bit_identical(substrate):
    """A duplicate prompt of exactly two blocks: the mandatory last-token
    re-feed writes into a private copy of the last shared block, the shared
    block stays unchanged for its peers, and tokens equal a cold run's."""
    _, cfg, _, params = _setup(substrate)
    max_new = 4 if substrate == "imc_bitserial" else 5
    dup = np.random.default_rng(5).integers(0, cfg.vocab_size, 16)

    def mk(rid):
        return Request(rid=rid, prompt=dup.copy(), max_new=max_new)

    cold = Engine(cfg, params, batch_slots=2, cache_len=32, max_chunk=4)
    cold_out = [serve(cold, [mk(i)])[0].out for i in range(3)]
    warm = Engine(cfg, params, batch_slots=2, cache_len=32, max_chunk=4,
                  prefix_cache=True)
    first = serve(warm, [mk(0)])[0].out
    shared = [n.block for n in warm.prefix.match(dup)]
    pools = [e["pk"][:, shared].clone() for e in warm._paged_layers()]
    warm_out = [first] + [serve(warm, [mk(i)])[0].out for i in (1, 2)]
    assert warm.prefix_hits == 2 and warm.cow_copies == 2
    assert len(warm.prefix) == 2  # CoW copies stay private
    assert warm_out == cold_out
    for e, before in zip(warm._paged_layers(), pools):
        assert e["pk"][:, shared].equal(before)
    _conserved(warm)


@pytest.mark.parametrize("substrate", SUBSTRATES)
def test_preempt_resume_of_prefix_sharing_slot_bit_exact(substrate):
    """A pool too small for both sharers' generation: a prefix-sharing slot
    is recompute-preempted (the shared block stays with its peer) and its
    resume rides the cached prefix again; tokens equal an ample pool's."""
    _, cfg, _, params = _setup(substrate)
    tails = [5, 5, 6]

    def run(kv_blocks):
        eng = Engine(cfg, params, batch_slots=2, cache_len=32, max_chunk=4,
                     kv_blocks=kv_blocks, prefix_cache=True)
        rq = _shared_requests(t_serve, cfg, 8, tails, 5)
        done = serve(eng, [rq[0]])
        done = done + serve(eng, rq[1:])
        return eng, {r.rid: r.out for r in done}

    ample_eng, ample = run(16)
    assert ample_eng.preempt_count == 0 and ample_eng.prefix_hits == 2
    tight_eng, tight = run(5)
    assert tight_eng.preempt_count >= 1
    assert tight_eng.prefix_hits > ample_eng.prefix_hits
    assert tight == ample
    assert tight_eng.alloc.used_count == tight_eng.alloc.evictable_count


def test_eviction_under_pool_pressure_keeps_serving():
    """Distinct prompts through a pool with room for about one request:
    admissions reclaim idle cached blocks (LRU leaf-first) and tokens stay
    exact; the JAX engine evicts the same blocks."""
    cfg_j, cfg, params_j, params = _setup("digital")
    rnp = np.random.default_rng(7)
    prompts = [rnp.integers(0, cfg.vocab_size, 16) for _ in range(3)]

    def run(mod, cfg, params, **kw):
        eng = mod.Engine(cfg, params, batch_slots=1, cache_len=32,
                         max_chunk=4, **kw)
        outs = [mod.serve(eng, [mod.Request(rid=i, prompt=p.copy(),
                                            max_new=4)])[0].out
                for i, p in enumerate(prompts)]
        return eng, outs

    _, cold_out = run(t_serve, cfg, params)
    eng, outs = run(t_serve, cfg, params, kv_blocks=4, prefix_cache=True)
    assert eng.prefix_evictions >= 1
    assert outs == cold_out
    assert eng.alloc.free_count + eng.alloc.used_count == 3
    stats = eng.prefix_stats()
    assert stats["evictions"] == eng.prefix_evictions
    assert stats["cached_blocks"] == eng.alloc.evictable_count
    eng_j, outs_j = run(j_serve, cfg_j, params_j, kv_blocks=4,
                        prefix_cache=True)
    assert outs == outs_j and stats == eng_j.prefix_stats()
    assert sorted(n.block for n in eng.prefix.leaves_lru()) == sorted(
        n.block for n in eng_j.prefix.leaves_lru())


def test_warm_admission_beside_mid_decode_slots():
    """A warm admission while other slots are mid-generation: the one-row
    suffix steps leave the resident slots' caches alone, so every request's
    tokens equal its solo cold run's."""
    _, cfg, _, params = _setup("imc_analytic")
    rq = _shared_requests(t_serve, cfg, 16, [3, 7, 12, 2], 6, seed=9)
    solo = {}
    for r in rq:
        eng = Engine(cfg, params, batch_slots=1, cache_len=48, max_chunk=4)
        solo[r.rid] = serve(eng, [Request(rid=r.rid, prompt=r.prompt,
                                          max_new=r.max_new)])[0].out
    eng = Engine(cfg, params, batch_slots=3, cache_len=48, max_chunk=2,
                 prefix_cache=True)
    pending = [rq[0]]
    eng.admit_pending(pending)
    eng.decode_chunk(2)
    pending = list(rq[1:])
    while pending or eng.active:
        eng.admit_pending(pending)
        eng.decode_chunk()
    assert eng.prefix_hits == 3
    assert {r.rid: r.out for r in eng.finished} == solo


# ---------------------------------------------------------------------------
# the CLI against the JAX main: CI serve smoke 5
# ---------------------------------------------------------------------------

SMOKE5 = ["--arch", ARCH, "--smoke", "--batch", "4", "--gen", "8",
          "--requests", "8", "--prompt-lens", "4,24,48,6,8,40,5,16",
          "--prefix-cache", "--shared-prefix-len", "16",
          "--imc-mode", "imc_analytic", "--imc-policy", "frozen",
          "--energy-report"]


@pytest.fixture(scope="module")
def jax_smoke5():
    """CI serve smoke 5 through the JAX main once, keeping its meter, engine
    and printed output."""
    meters, engines = [], []

    class Meter(j_metering.DPMeter):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            meters.append(self)

    class JEngine(j_serve.Engine):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            engines.append(self)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_metering, "DPMeter", Meter)
        mp.setattr(j_serve, "Engine", JEngine)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            finished = j_serve.main(SMOKE5)
    return dict(finished=finished, engine=engines[-1], meter=meters[-1],
                stdout=buf.getvalue())


def _port_main(argv, monkeypatch, capsys):
    def jax_params(cfg, seed=0, device=None):
        cfg_j = j_configs.get_smoke(ARCH).replace(imc=None)
        params = j_init_params(jax.random.PRNGKey(0), cfg_j)
        return params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                               device)

    monkeypatch.setattr(t_serve, "init_params", jax_params)
    rep = t_serve.main(argv + ["--device", "cpu"])
    return rep, capsys.readouterr().out


def test_cli_prefix_smoke_matches_reference(jax_smoke5, monkeypatch, capsys):
    ref = jax_smoke5
    rep, out = _port_main(SMOKE5, monkeypatch, capsys)
    assert {r.rid: r.out for r in rep["finished"]} == {
        r.rid: r.out for r in ref["finished"]}
    assert all(r.error is None for r in rep["finished"])
    eng_t, eng_j = rep["engine"], ref["engine"]
    assert eng_t.prefix_stats() == eng_j.prefix_stats()
    assert eng_t.prefix_hits > 0
    line = [ln for ln in out.splitlines() if ln.startswith("prefix cache:")]
    assert len(line) == 1 and line[0] in ref["stdout"]
    mt, mj = rep["meter"], ref["meter"]
    for field in ("prefill_billed_tokens", "prefill_true_tokens",
                  "prefill_rows", "prefill_groups", "decode_billed_tokens",
                  "decode_chunks", "prefix_lookups", "prefix_hits",
                  "prefix_hit_tokens", "prefix_saved_billed_tokens",
                  "cow_copies"):
        assert getattr(mt, field) == getattr(mj, field), field
    from repro.core.design import optimize

    billed = [(t, k) for t in (14.0, 26.0) for k in ("qs", "qr", "cm")
              if optimize(n=512, snr_t_target_db=t, kinds=(k,)) is not None]
    assert len(rep["energy"]) == len(billed)
    for (t, k), e_t in zip(billed, rep["energy"]):
        e_j = j_metering.serve_energy_report(
            mj, substrate=j_for_design(optimize(n=512, snr_t_target_db=t,
                                                kinds=(k,))),
            generated_tokens=rep["tokens"], requests=len(ref["finished"]))
        for attr in ("j_per_token", "j_per_request", "edp_per_token",
                     "j_per_token_saved"):
            assert getattr(e_t, attr) == pytest.approx(
                getattr(e_j, attr), rel=1e-12, abs=0.0), (t, k, attr)
    # the energy table and the savings lines are the reference's
    table = out[out.index("serve-path energy"):].strip()
    assert "prefix-cache energy savings" in table
    assert table in ref["stdout"]
