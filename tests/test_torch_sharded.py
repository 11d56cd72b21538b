"""Tensor-parallel serving in the port against the JAX package, on the CPU.

The mesh helpers, ``kv_head_partition`` and the parameter rules are held
against ``repro.launch.mesh`` / ``repro.launch.sharding`` (the rules on
every leaf of the ten architectures' SMOKE trees).  The sharded engine runs
in ONE group of four gloo ranks, started as processes when the first engine
test asks for it, after this process has run the JAX engines and the
port's one-device engines the rank results are held to.  Greedy tokens
must be identical: musicgen-medium SMOKE on digital and frozen
``imc_analytic`` (7 x 7 bits) against the JAX engine; frozen
``imc_bitserial`` with and without a noise seed, dynamic ``imc_bitserial``
with a seed and idle slots, and frozen analytic with a seed against the
port's one device; the same preemption schedule in a tight pool; dbrx-132b
SMOKE (expert-sharded MoE) at 1x4 (replicated pools, Hkv = 2) and 1x2
(head-sharded), and granite-20b SMOKE (MQA, replicated pools) against the
JAX engine.
"""
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro import configs as j_configs
from repro.core import substrate as j_sub
from repro.core.imc_linear import IMCConfig as JIMC
from repro.launch import mesh as j_mesh
from repro.launch import serve as j_serve
from repro.launch import sharding as j_shd
from repro.models import init_params as j_init_params
from repro_torch import configs as t_configs
from repro_torch.convert import params_from_jax
from repro_torch.core import substrate as t_sub
from repro_torch.core.imc_linear import IMCConfig as TIMC
from repro_torch.kernels import ops, ref
from repro_torch.launch import mesh as t_mesh
from repro_torch.launch import serve as t_serve
from repro_torch.launch import sharding as t_shd
from repro_torch.models import init_params as t_init_params
from repro_torch.tree import map_with_path, walk

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TP = 4
MUSIC = "musicgen-medium"
# four prompts in one prefill bucket and one decode chunk: each JAX engine
# compiles one prefill and one decode step (exact-length MoE prefill: two
# lengths); the tight pool replays the reference's mixed 4..48 workload
LENS = [4, 6, 6, 4]
GEN = 5
PREEMPT_LENS = [4, 6, 48, 5, 8, 44, 6, 7]
PREEMPT_GEN = 8
SEED = 5  # the noise seed of the seeded runs


# ---------------------------------------------------------------------------
# the pure functions against the reference's
# ---------------------------------------------------------------------------


def _outcome(fn, *args):
    try:
        return ("ok", fn(*args))
    except ValueError as e:
        return ("ValueError", str(e))


def test_kv_head_partition_matches_reference():
    for hkv in range(-1, 17):
        for n in range(-2, 9):
            assert (_outcome(t_shd.kv_head_partition, hkv, n)
                    == _outcome(j_shd.kv_head_partition, hkv, n)), (hkv, n)


def test_parse_mesh_shape_matches_reference():
    for spec in ("1x8", "2x4", "1X4", "", "8", "1x", "x8", "ax2", "1x2x3",
                 "0x4", "1x-2"):
        assert (_outcome(t_mesh.parse_mesh_shape, spec)
                == _outcome(j_mesh.parse_mesh_shape, spec)), spec


def _jax_tree(arch):
    cfg = j_configs.get_smoke(arch)
    return jax.eval_shape(lambda: j_init_params(jax.random.PRNGKey(0), cfg))


def _meta(tree):
    """The port's parameter tree of a JAX shape tree, on the meta device."""
    if isinstance(tree, dict):
        return {k: _meta(v) for k, v in tree.items()}
    return torch.empty(tree.shape, device="meta")


@pytest.mark.parametrize("arch", list(j_configs.ARCH_NAMES))
def test_param_specs_and_divisibility_match_reference(arch):
    jtree = _jax_tree(arch)
    jspecs = j_shd.tree_param_specs(jtree)
    ttree = _meta(jtree)
    tspecs = t_shd.tree_param_specs(ttree)
    flat_j = jax.tree_util.tree_flatten_with_path(
        jspecs, is_leaf=lambda x: isinstance(x, j_shd.P))[0]
    assert len(flat_j) == len(list(walk(tspecs)))
    for path, spec in flat_j:
        keys = tuple(k.key for k in path)
        t_spec = tspecs
        for k in keys:
            t_spec = t_spec[k]
        assert t_spec == tuple(spec), (keys, t_spec, spec)
    # at 1x4 (the port's mesh object carries the reference's axis API)
    mesh = t_mesh.Mesh(1, TP)
    issues_j = j_shd.validate_divisibility(jtree, jspecs, mesh)
    issues_t = t_shd.validate_divisibility(ttree, tspecs, mesh)
    assert [(p, tuple(s), tuple(sp)) for p, s, sp in issues_j] == issues_t
    paths = {p for p, _, _ in issues_t}
    back_t = t_shd.fallback_replicate(tspecs, paths)
    back_j = jax.tree_util.tree_leaves(
        j_shd.fallback_replicate(jspecs, paths),
        is_leaf=lambda x: isinstance(x, j_shd.P))
    assert [s for _, s in walk(back_t)] == [tuple(s) for s in back_j]


def test_meshes_of_one_rank_match_reference():
    """Without a group the port's world is one rank, as the reference's
    test process holds one device: an oversized model axis clamps to 1,
    and a serve mesh wants no more devices than there are."""
    for axis in (None, 1, 8):
        assert (t_mesh.make_host_mesh(axis).shape
                == dict(j_mesh.make_host_mesh(axis).shape))
    for bad in (0, -1):
        assert (_outcome(t_mesh.make_host_mesh, bad)[0]
                == _outcome(j_mesh.make_host_mesh, bad)[0] == "ValueError")
    assert (t_mesh.make_serve_mesh(1, 1).shape
            == dict(j_mesh.make_serve_mesh(1, 1).shape))
    assert (_outcome(t_mesh.make_serve_mesh, 1, 2)
            == _outcome(j_mesh.make_serve_mesh, 1, 2))
    mesh = t_mesh.Mesh(1, TP)
    assert (t_mesh.dp_axes(mesh), t_mesh.axis_size(mesh, "model"),
            t_mesh.axis_size(mesh, "pod"), t_mesh.dp_size(mesh)) == (
        j_mesh.dp_axes(mesh), j_mesh.axis_size(mesh, "model"),
        j_mesh.axis_size(mesh, "pod"), j_mesh.dp_size(mesh))


def test_sharded_init_draws_the_whole_models_shards():
    """Each rank's ``sharding.init_params`` equals its cut of the whole
    model's draw, and the cuts put together are the whole."""
    for arch in (MUSIC, "dbrx-132b", "granite-20b"):
        cfg = t_configs.get_smoke(arch)
        whole = t_init_params(cfg, seed=3, device="cpu")
        shards = []
        for r in range(TP):
            mesh = t_mesh.Mesh(1, TP, None, r)
            mine = t_shd.init_params(cfg, mesh, seed=3, device="cpu")
            cut = t_shd.shard_params(whole, cfg, mesh)
            for (p, a), (_, b) in zip(walk(mine), walk(cut)):
                assert torch.equal(a, b), (arch, r, p)
            shards.append(mine)
        specs = map_with_path(lambda p, t: t_shd.serve_param_spec(
            cfg, TP, p, t.dim(), p[0] == "blocks"), whole)
        for path, t in walk(whole):
            spec = dict(walk(specs))[path]
            parts = [dict(walk(s))[path] for s in shards]
            if "model" in spec:
                t2 = torch.cat(parts, dim=spec.index("model"))
            else:
                t2 = parts[0]
            assert torch.equal(t2, t), (arch, path)


# ---------------------------------------------------------------------------
# the bit-serial plain version by column shards
# ---------------------------------------------------------------------------


def test_bitserial_column_shards_equal_the_whole_call():
    """With noise and the mismatch gain on, the shards' outputs side by
    side equal the whole call bit for bit: the plain version at a column
    offset, and ``ops.imc_matmul`` with its slice of the gain draw."""
    g = torch.Generator().manual_seed(0)
    b, k, m = 3, 80, 24
    spec = ref.BitSerialSpec(bx=7, bw=7, b_adc=6, rows=32, k_h=20.0,
                             v_c=24.0, x_signed=True, sigma_noise=0.7)
    xc = torch.randint(-64, 64, (b, k), generator=g).float()
    wc = torch.randint(-64, 64, (k, m), generator=g).float()
    gain = 1.0 + 0.05 * torch.randn((k, m), generator=g)
    whole = ref.imc_bitserial_ref(xc, wc, gain, spec, seed=99)
    per = m // TP
    parts = [ref.imc_bitserial_ref(xc, wc[:, r * per:(r + 1) * per],
                                   gain[:, r * per:(r + 1) * per], spec,
                                   seed=99, col0=r * per) for r in range(TP)]
    assert torch.equal(torch.cat(parts, dim=1), whole)

    cfg = ops.IMCMatmulConfig(bx=7, bw=7, b_adc=6, rows=32, sigma_d=0.05,
                              sigma_thermal_counts=0.7, k_h_counts=20.0,
                              v_c_counts=24.0)
    x = torch.randn((b, k), generator=g)
    w = torch.randn((k, m), generator=g)
    x_max, w_max = x.abs().max(), w.abs().max()
    whole = ops.imc_matmul(x, w, cfg, seed=7, x_max=x_max, w_max=w_max)
    parts = [ops.imc_matmul(x, w[:, r * per:(r + 1) * per], cfg, seed=7,
                            x_max=x_max, w_max=w_max, cols=(r * per, m))
             for r in range(TP)]
    assert torch.equal(torch.cat(parts, dim=1), whole)


# ---------------------------------------------------------------------------
# the engines: one group of gloo ranks for every case
# ---------------------------------------------------------------------------

RANK_SCRIPT = r"""
import json, sys
import numpy as np
import torch
import torch.distributed as dist
from repro_torch.convert import params_from_jax
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.serve import Engine, Request, serve

torch.set_num_threads(1)
rank, port, d = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
mesh_lib.init_ranks("gloo", rank, int(sys.argv[4]), port)
spec = torch.load(f"{d}/cases.pt", weights_only=False)
out = {}
for c in spec["runs"]:
    mesh = mesh_lib.make_serve_mesh(*c["mesh"])
    if mesh.rank < 0:
        continue
    # the JAX tree (as numpy arrays), converted into this rank's shard
    params = params_from_jax(spec["params"][c["arch"]], "cpu", c["cfg"],
                             mesh)
    eng = Engine(c["cfg"], params, batch_slots=4, cache_len=c["cache_len"],
                 max_chunk=4, block_size=8, rng=c["rng"], mesh=mesh,
                 **c["kw"])
    reqs = [Request(rid=i, prompt=np.asarray(p), max_new=c["gen"])
            for i, p in enumerate(c["prompts"])]
    done = serve(eng, reqs)
    pools = [tuple(g["pk"].shape) for g in eng._paged_layers()]
    out[c["name"]] = dict(
        tokens={r.rid: [int(t) for t in r.out] for r in done},
        errors=[r.error for r in done if r.error is not None],
        per_device=eng.kv_pool_bytes_per_device(), whole=eng.kv_pool_bytes(),
        preempts=eng.preempt_count, kv_shard=eng.kv_shard, pools=pools)
# the group's sum: every rank's float32 partial, widely spread so that the
# order of the additions shows, added in rank order on every rank
from repro_torch.core.parallel import ShardGroup
mesh = mesh_lib.make_serve_mesh(1, int(sys.argv[4]))
gen = torch.Generator().manual_seed(5)
parts = [torch.randn(3 * 1536, generator=gen)
         * torch.exp(4 * torch.randn(3 * 1536, generator=gen))
         for _ in range(mesh.model)]
got = ShardGroup(group=mesh.group, rank=mesh.rank,
                 size=mesh.model).sum(parts[mesh.rank].clone())
want = parts[0].clone()
for p in parts[1:]:
    want += p
out["sum_rank_order"] = int((got != want).sum())
try:
    mesh_lib.make_serve_mesh(1, 8)
except ValueError as e:
    out["too_many"] = str(e)
out["host_mesh"] = [[m.data, m.model] for m in (
    mesh_lib.make_host_mesh(8), mesh_lib.make_host_mesh(3),
    mesh_lib.make_host_mesh())]
if rank == 0:
    with open(f"{d}/out.json", "w") as f:
        json.dump(out, f)
dist.destroy_process_group()
"""


def _prompts(vocab, lens, seed=11):
    rnp = np.random.default_rng(seed)
    return [rnp.integers(0, vocab, n) for n in lens]


def _imc(mode):
    return dict(mode=mode, bx=7, bw=7, v_wl=0.7)


_CASES = {}


def _setup():
    """JAX parameters (carried over), each package's frozen calibration
    and the engine runs' cases."""
    if _CASES:
        return _CASES
    params_j, params_t, cfg_j, cfg_t = {}, {}, {}, {}
    for arch in (MUSIC, "dbrx-132b", "granite-20b"):
        cfg_j[arch] = j_configs.get_smoke(arch)
        cfg_t[arch] = t_configs.get_smoke(arch)
        params_j[arch] = j_init_params(jax.random.PRNGKey(0), cfg_j[arch])
        params_t[arch] = params_from_jax(
            jax.tree_util.tree_map(np.asarray, params_j[arch]), "cpu")
    # each package's own calibration, one for both IMC modes: the recorded
    # ranges do not depend on the mode
    calib = np.random.default_rng(1).integers(0, 256, (2, 48))
    cal_t = t_sub.calibrate_model(
        cfg_t[MUSIC].replace(imc=TIMC(**_imc("imc_analytic"))),
        params_t[MUSIC], [calib]).imc.calibration
    cal_j = j_sub.calibrate_model(
        cfg_j[MUSIC].replace(imc=JIMC(**_imc("imc_analytic"))),
        params_j[MUSIC], [calib]).imc.calibration
    for mode in ("imc_analytic", "imc_bitserial"):
        cfg_t[mode] = cfg_t[MUSIC].replace(
            imc=t_sub.as_substrate(TIMC(**_imc(mode))).frozen(cal_t))
        cfg_j[mode] = cfg_j[MUSIC].replace(
            imc=j_sub.as_substrate(JIMC(**_imc(mode))).frozen(cal_j))
    cfg_t["bitserial_dynamic"] = cfg_t[MUSIC].replace(
        imc=TIMC(**_imc("imc_bitserial")))
    runs = []

    def case(name, key, arch=MUSIC, mesh=(1, TP), rng=None, lens=LENS,
             gen=GEN, **kw):
        runs.append(dict(
            name=name, arch=arch, cfg=cfg_t[key], mesh=mesh, rng=rng,
            gen=gen, kw=kw, prompts=_prompts(cfg_t[key].vocab_size, lens),
            cache_len=max(lens) + 2 * gen + 8))

    case("digital", MUSIC)
    case("analytic", "imc_analytic")
    case("bitserial", "imc_bitserial", lens=LENS[:3], gen=3)
    case("bitserial_seed", "imc_bitserial", rng=SEED, lens=LENS[:3], gen=3)
    case("analytic_seed", "imc_analytic", rng=SEED)
    # dynamic ranges with two of the four slots idle: the idle rows enter
    # every site's batch-wide range, on every rank as on one device
    case("bitserial_dynamic", "bitserial_dynamic", rng=SEED, lens=LENS[:2],
         gen=3)
    case("preempt", "imc_analytic", lens=PREEMPT_LENS, gen=PREEMPT_GEN,
         kv_blocks=11, alloc_policy="lazy")
    case("dbrx", "dbrx-132b", arch="dbrx-132b")
    case("dbrx_1x2", "dbrx-132b", arch="dbrx-132b", mesh=(1, 2))
    case("granite", "granite-20b", arch="granite-20b")
    _CASES.update(runs={c["name"]: c for c in runs}, params_j=params_j,
                  params_t=params_t, cfg_j=cfg_j, spec=dict(
                      runs=runs, params={
                          a: jax.tree_util.tree_map(np.asarray, p)
                          for a, p in params_j.items()}))
    return _CASES


class _Ranks:
    """The group of gloo rank processes serving every case, one thread
    each, at a lower CPU priority: in a suite run by several workers four
    more busy processes would slow every other test."""

    def __init__(self, d):
        self.d = d
        env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
        port = t_mesh.free_port()
        self.logs = [open(d / f"rank{r}.log", "w") for r in range(TP)]
        self.procs = [subprocess.Popen(
            ["nice", "-n", "10", sys.executable, "-c", RANK_SCRIPT, str(r),
             str(port), str(d), str(TP)], cwd=ROOT, env=env, stdout=log,
            stderr=subprocess.STDOUT) for r, log in enumerate(self.logs)]
        self._out = None

    def result(self):
        if self._out is None:
            codes = [p.wait(timeout=600) for p in self.procs]
            logs = "".join((self.d / f"rank{r}.log").read_text()[-3000:]
                           for r in range(TP))
            assert codes == [0] * TP, logs
            self._out = json.loads((self.d / "out.json").read_text())
        return self._out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Run the single-device engines the ranks are held to, then start the
    ranks (never beside this process's own busy threads)."""
    d = tmp_path_factory.mktemp("ranks")
    torch.save(_setup()["spec"], d / "cases.pt")
    for name in ("digital", "analytic", "dbrx", "granite"):
        _jax_tokens(name)
    for name in ("bitserial", "bitserial_seed", "bitserial_dynamic",
                 "analytic_seed", "preempt"):
        _port_one(name)
    group = _Ranks(d)
    try:
        yield group
    finally:
        for p in group.procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in group.logs:
            log.close()


def _serve(serve_mod, cfg, params, c):
    eng = serve_mod.Engine(cfg, params, batch_slots=4,
                           cache_len=c["cache_len"], max_chunk=4,
                           block_size=8, rng=c["rng"], **c["kw"])
    reqs = [serve_mod.Request(rid=i, prompt=p, max_new=c["gen"])
            for i, p in enumerate(c["prompts"])]
    done = serve_mod.serve(eng, reqs)
    assert all(r.error is None for r in done)
    return {r.rid: [int(t) for t in r.out] for r in done}, eng


_ONE = {}


def _jax_tokens(name):
    """The JAX single-device engine's tokens for a case, memoized."""
    if name not in _ONE:
        c = _setup()["runs"][name]
        key = {"analytic": "imc_analytic"}.get(name, c["arch"])
        _ONE[name] = _serve(j_serve, _setup()["cfg_j"][key],
                            _setup()["params_j"][c["arch"]], c)[0]
    return _ONE[name]


def _port_one(name):
    """The port's one-device engine for a case, memoized."""
    if ("port", name) not in _ONE:
        c = _setup()["runs"][name]
        _ONE[("port", name)] = _serve(t_serve, c["cfg"],
                                      _setup()["params_t"][c["arch"]], c)
    return _ONE[("port", name)]


def _sharded(ranks, name):
    out = ranks.result()[name]
    assert out["errors"] == []
    return out


@pytest.mark.parametrize("name", ["digital", "analytic"])
def test_musicgen_1x4_matches_jax_engine(ranks, name):
    want = _jax_tokens(name)
    got = _sharded(ranks, name)
    assert {int(k): v for k, v in got["tokens"].items()} == want
    # Hkv = 4 head-shards over four ranks: (NB, bs, 1, hd) pools per rank
    assert got["kv_shard"] and all(p[-2] == 1 for p in got["pools"])
    assert got["per_device"] * TP == got["whole"]


@pytest.mark.parametrize("name", ["bitserial", "bitserial_seed",
                                  "bitserial_dynamic", "analytic_seed"])
def test_musicgen_1x4_matches_one_device(ranks, name):
    want, _ = _port_one(name)
    got = _sharded(ranks, name)
    assert {int(k): v for k, v in got["tokens"].items()} == want


def test_preemption_schedule_matches_one_device(ranks):
    want, eng = _port_one("preempt")
    got = _sharded(ranks, "preempt")
    assert eng.preempt_count >= 1
    assert got["preempts"] == eng.preempt_count
    assert {int(k): v for k, v in got["tokens"].items()} == want
    assert got["per_device"] * TP == got["whole"] == eng.kv_pool_bytes()


@pytest.mark.parametrize("name,kv_shard", [("dbrx", False),
                                           ("dbrx_1x2", True),
                                           ("granite", False)])
def test_moe_and_replicated_pools_match_jax_engine(ranks, name, kv_shard):
    """dbrx-132b: one expert per rank at 1x4 (Hkv = 2: replicated pools),
    two at 1x2 (head-sharded); granite-20b: MQA, replicated pools."""
    arch = _setup()["runs"][name]["arch"]
    want = _jax_tokens("dbrx" if arch == "dbrx-132b" else name)
    got = _sharded(ranks, name)
    assert {int(k): v for k, v in got["tokens"].items()} == want
    assert got["kv_shard"] == kv_shard
    hkv = t_configs.get_smoke(arch).n_kv_heads
    tp = _setup()["runs"][name]["mesh"][1]
    assert all(p[-2] == (hkv // tp if kv_shard else hkv)
               for p in got["pools"])
    assert got["per_device"] * (tp if kv_shard else 1) == got["whole"]


def test_group_sum_adds_in_rank_order(ranks):
    """``ShardGroup.sum`` is ((t0 + t1) + t2) + t3 to the last bit, whatever
    order the backend's all-reduce would add in (gloo's differs at about a
    quarter of these elements): one device splitting a dot product the
    same way gives the mesh's bits."""
    assert ranks.result()["sum_rank_order"] == 0


def test_meshes_in_a_group_of_four(ranks):
    out = ranks.result()
    assert out["too_many"] == "mesh 1x8 needs 8 devices; only 4 available"
    # model=8 clamps to the four ranks, 3 to the largest divisor below it
    assert out["host_mesh"] == [[1, 4], [2, 2], [1, 4]]


# ---------------------------------------------------------------------------
# refusals and the CLI
# ---------------------------------------------------------------------------


def test_engine_refuses_what_is_not_sharded_yet():
    cfg = t_configs.get_smoke(MUSIC)
    params = t_init_params(cfg, device="cpu")
    with pytest.raises(ValueError, match="R > 1|data replicas"):
        t_serve.Engine(cfg, params, 2, 32, mesh=t_mesh.Mesh(2, 2))
    ssm = t_configs.get_smoke("mamba2-2.7b")
    with pytest.raises(ValueError, match="SSD and RG-LRU"):
        t_serve.Engine(ssm, params, 2, 32, mesh=t_mesh.Mesh(1, TP))
    with pytest.raises(ValueError, match="fault retries"):
        t_serve.Engine(cfg, params, 2, 32, mesh=t_mesh.Mesh(1, TP),
                       failure_injector=lambda *a: None)


CLI = ["--arch", MUSIC, "--smoke", "--batch", "4", "--requests", "5",
       "--prompt-lens", "4,6,20,5", "--gen", "4", "--device", "cpu",
       "--imc-mode", "imc_bitserial", "--imc-policy", "frozen"]


def test_cli_mesh_serves_the_one_device_tokens():
    one = t_serve.main(CLI)
    four = t_serve.main(CLI + ["--mesh", "1x4"])
    assert ({r.rid: r.out for r in four["finished"]}
            == {r.rid: r.out for r in one["finished"]})
    eng = four["engine"]
    assert eng.mesh_shape == "1x4" and eng.kv_shard
    assert eng.kv_pool_bytes_per_device() * TP == eng.kv_pool_bytes()


@pytest.mark.parametrize("mesh,msg", [
    ("2x2", "R > 1"), ("1x0", "mesh axes must be >= 1"),
    (f"1x{(os.cpu_count() or 1) + 1}", "needs .* devices; only")])
def test_cli_mesh_refusals(mesh, msg, capsys):
    with pytest.raises(SystemExit):
        t_serve.main(CLI + ["--mesh", mesh])
    assert msg.split(" .*")[0] in capsys.readouterr().err
