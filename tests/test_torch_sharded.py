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
JAX engine.  Against the port's one device (itself held against the JAX
engine in ``test_torch_recurrent.py``, ``test_torch_drift.py`` and
``test_torch_serve.py``): mamba2-2.7b SMOKE (8 SSD heads, 2 a rank) on
digital and dynamic bit-serial with a noise seed, recurrentgemma-2b SMOKE
with 6 query heads (replicated attention beside a sharded RG-LRU width),
musicgen-medium frozen analytic calibrated on the ranks' shards (the
calibration held site by site), a drift run with every chunk sampled and
checked, a transient error injected on rank 2 alone, and a frozen
analytic to bit-serial substrate swap between chunks.
"""
import inspect
import json
import os
import subprocess
import sys
import textwrap

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
from repro_torch.models import ssm as t_ssm
from repro_torch.models import init_params as t_init_params
from repro_torch.tree import walk
from torch_threads import two_threads  # noqa: F401  (autouse)

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


RG6 = t_configs.get_smoke("recurrentgemma-2b").replace(n_heads=6)


@pytest.mark.parametrize("arch", [MUSIC, "dbrx-132b", "granite-20b",
                                  "mamba2-2.7b", "recurrentgemma-2b", "rg6"])
def test_sharded_init_draws_the_whole_models_shards(arch):
    """Each rank's ``sharding.init_params`` equals its cut of the whole
    model's draw, and the cuts put together are the whole: blocks side by
    side, the SSD ``in_proj`` and conv by their segments (the ``B|C``
    columns on every rank), replicated leaves (recurrentgemma's attention
    with 6 query heads) whole on every rank."""
    cfg = RG6 if arch == "rg6" else t_configs.get_smoke(arch)
    whole = t_init_params(cfg, seed=3, device="cpu")
    shards = []
    for r in range(TP):
        mesh = t_mesh.Mesh(1, TP, None, r)
        mine = t_shd.init_params(cfg, mesh, seed=3, device="cpu")
        cut = t_shd.shard_params(whole, cfg, mesh)
        for (p, a), (_, b) in zip(walk(mine), walk(cut)):
            assert torch.equal(a, b), (arch, r, p)
        shards.append(dict(walk(mine)))
    specs = dict(walk(t_shd.placed_specs(whole, cfg, t_mesh.Mesh(1, TP))))
    split = set()
    for path, t in walk(whole):
        spec, parts = specs[path], [s[path] for s in shards]
        cols = t_shd.leaf_columns(cfg, TP, path)
        if "model" not in spec:
            assert all(torch.equal(q, t) for q in parts), (arch, path)
            continue
        dim = spec.index("model")
        split.add("/".join(path[2:]))
        if cols is None:
            t2 = torch.cat(parts, dim=dim)
        else:
            t2 = torch.full_like(t, float("nan"))
            for r, q in enumerate(parts):
                t2.index_copy_(dim, cols.index(r), q)
        assert torch.equal(t2, t), (arch, path)
    if arch == "rg6":  # 6 heads over 4 ranks: the attention stays whole
        assert not split & {f"mixer/{n}" for n in ("wq", "wk", "wv", "wo")}
        assert {"mixer/rg_x", "mixer/rg_out", "mixer/rg_a", "mixer/conv_w",
                "mlp/wi", "mlp/wo"} <= split
    if arch == "mamba2-2.7b":
        assert {f"mixer/{n}" for n in ("in_proj", "conv_w", "A_log",
                                       "norm_scale", "out_proj")} <= split


# ---------------------------------------------------------------------------
# the bit-serial plain version by column shards
# ---------------------------------------------------------------------------


def test_bitserial_column_shards_equal_the_whole_call():
    """With noise and the mismatch gain on, the shards' outputs side by
    side equal the whole call bit for bit: the plain version at a column
    offset, and ``ops.imc_matmul`` with its slice of the gain draw, by
    one block or by a rank's segments."""
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
                            x_max=x_max, w_max=w_max,
                            cols=(((r * per, (r + 1) * per),), m))
             for r in range(TP)]
    assert torch.equal(torch.cat(parts, dim=1), whole)
    # a rank's columns in several segments (the SSD in_proj's z, x, B|C and
    # dt), one launch a segment, the B|C columns on every rank
    layout = t_ssm.in_proj_columns(t_configs.get_smoke("mamba2-2.7b"), TP)
    w = torch.randn((k, layout.total), generator=g)
    whole = ops.imc_matmul(x, w, cfg, seed=7, x_max=x_max, w_max=w_max)
    for r in range(TP):
        idx = layout.index(r)
        got = ops.imc_matmul(x, w[:, idx], cfg, seed=7, x_max=x_max,
                             w_max=w_max, cols=(layout.ranks[r],
                                                layout.total))
        assert torch.equal(got, whole[:, idx]), r


# ---------------------------------------------------------------------------
# the engines: one group of gloo ranks for every case
# ---------------------------------------------------------------------------

def _drive(c, params, mesh=None):
    """Serve a case's requests on one device, or as this rank of ``mesh``:
    calibrated first where the case says (on the rank's shards under a
    mesh), with a drift monitor sampling and checking every chunk and
    ``mlp.wi`` scaled after the first requests, with a transient error
    injected on one rank before a decode chunk, or with a substrate swap
    after the first decode chunk.  Returns (what the case's tests read,
    the engine).  The rank processes run this function's source."""
    import numpy as np

    from repro_torch.core import parallel
    from repro_torch.core import substrate as sl
    from repro_torch.launch import sharding
    from repro_torch.launch.serve import Engine, Request, _scale_wi, serve
    from repro_torch.runtime import drift as drift_lib
    from repro_torch.runtime import fault as fault_lib

    cfg, kw, out = c["cfg"], dict(c["kw"]), {}
    if c.get("calibrate") is not None:
        group = (sharding.shard_group(cfg, mesh) if mesh is not None
                 else None)
        with parallel.use(group):
            cfg = sl.calibrate_model(cfg, params, [c["calibrate"]])
        out["calibration"] = cfg.imc.calibration.to_dict()
    reports = []
    if c.get("drift"):
        mon = drift_lib.DriftMonitor(drift_lib.DriftConfig(
            sample_every=1, check_every=1))
        check = mon.check

        def logged(frozen):
            report = check(frozen)
            if report is not None:
                reports.append([mon.chunks_seen,
                                list(report.drifted_sites)])
            return report

        mon.check = logged
        kw["drift_monitor"] = mon
    if c.get("fault") is not None:
        fault_rank, fault_chunk = c["fault"]
        fired = []

        def injector(phase, info):
            if (phase == "decode" and info == fault_chunk and not fired
                    and (mesh.rank if mesh is not None else 0)
                    == fault_rank):
                fired.append(info)
                raise fault_lib.TransientDeviceError("injected")

        kw["failure_injector"] = injector
    eng = Engine(cfg, params, batch_slots=4, cache_len=c["cache_len"],
                 max_chunk=4, block_size=8, rng=c["rng"], mesh=mesh, **kw)
    reqs = [Request(rid=i, prompt=np.asarray(p), max_new=c["gen"])
            for i, p in enumerate(c["prompts"])]
    if c.get("drift"):
        serve(eng, reqs[:2])
        eng.params = _scale_wi(eng.params, 2.5)
        serve(eng, reqs[2:])
        done = eng.finished
    elif c.get("swap_to") is not None:
        pending = list(reqs)
        eng.admit_pending(pending)
        eng.decode_chunk()
        eng.swap_substrate(c["swap_to"])
        while pending or eng.active:
            eng.admit_pending(pending)
            eng.decode_chunk()
        done = eng.finished
    else:
        done = serve(eng, reqs)
    out.update(
        tokens={r.rid: [int(t) for t in r.out] for r in done},
        errors=[r.error for r in done if r.error is not None],
        per_device=eng.kv_pool_bytes_per_device(), whole=eng.kv_pool_bytes(),
        state=eng.state_bytes_per_slot, preempts=eng.preempt_count,
        kv_shard=eng.kv_shard, reports=reports, swaps=eng.swap_count,
        retries=eng.retries, decode_failures=eng.decode_failures,
        pools=[tuple(g["pk"].shape) for g in eng._paged_layers()])
    return out, eng


RANK_SCRIPT = r"""
import json, os, sys
import numpy as np
import torch
import torch.distributed as dist
from repro_torch.convert import params_from_jax
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import sharding
# _drive

torch.set_num_threads(1)
rank, port, d = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
mesh_lib.init_ranks("gloo", rank, int(sys.argv[4]), port)
spec = torch.load(f"{d}/cases.pt", weights_only=False)
out = {}
for c in spec["runs"]:
    mesh = mesh_lib.make_serve_mesh(*c["mesh"])
    if mesh.rank < 0:
        continue
    if c["draw"] is None:
        # the JAX tree (as numpy arrays), converted into this rank's shard
        params = params_from_jax(spec["params"][c["arch"]], "cpu", c["cfg"],
                                 mesh)
    else:  # the port's own draw, this rank's shard of it
        params = sharding.init_params(c["cfg"], mesh, seed=c["draw"],
                                      device="cpu")
    res, _ = _drive(c, params, mesh)
    ranks = [None] * mesh.model
    dist.all_gather_object(ranks, [res["retries"], res["decode_failures"]],
                           group=mesh.group)
    res["ranks"] = ranks
    out[c["name"]] = res
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
# end here: the interpreter's teardown frees the groups that this
# script's globals still hold (meshes, engines), and under load a gloo
# group's thread can then abort the process (std::terminate)
sys.stdout.flush()
sys.stderr.flush()
os._exit(0)
""".replace("# _drive\n", textwrap.dedent(inspect.getsource(_drive)))


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
    # the port's own configurations and draws, held against its one device
    cfg_t["mamba2-2.7b"] = t_configs.get_smoke("mamba2-2.7b")
    cfg_t["mamba_bitserial"] = cfg_t["mamba2-2.7b"].replace(
        imc=TIMC(**_imc("imc_bitserial")))
    cfg_t["rg6"] = RG6
    cfg_t["analytic_dynamic"] = cfg_t[MUSIC].replace(
        imc=TIMC(**_imc("imc_analytic")))
    runs = []

    def case(name, key, arch=MUSIC, mesh=(1, TP), rng=None, lens=LENS,
             gen=GEN, draw=None, **kw):
        extra = {k: kw.pop(k) for k in ("calibrate", "drift", "fault",
                                        "swap_to") if k in kw}
        runs.append(dict(
            name=name, arch=arch, cfg=cfg_t[key], mesh=mesh, rng=rng,
            gen=gen, kw=kw, prompts=_prompts(cfg_t[key].vocab_size, lens),
            cache_len=max(lens) + 2 * gen + 8, draw=draw, **extra))

    # a transient error on rank 2 alone before decode chunk 0: the ranks
    # retry together, to the uninjected run's tokens
    case("digital", MUSIC, fault=(2, 0))
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
    case("mamba", "mamba2-2.7b", draw=3, lens=[4, 6, 6], gen=4)
    case("mamba_bitserial", "mamba_bitserial", draw=3, rng=SEED,
         lens=[4, 6], gen=3)
    # 6 query heads over 4 ranks; the 20-token prompt wraps the 16-row ring
    case("rg6", "rg6", draw=3, lens=[4, 20, 6], gen=4)
    case("calibrated", "analytic_dynamic", calibrate=calib)
    case("drift", "imc_analytic", drift=True)
    case("swap", "imc_analytic", lens=LENS[:3], gen=4,
         swap_to=t_sub.as_substrate(TIMC(**_imc("imc_bitserial"))))
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
                 "analytic_seed", "preempt", "mamba", "mamba_bitserial",
                 "rg6", "calibrated", "drift", "swap"):
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
    """The port's one-device run of a case (what ``_drive`` returns, and
    the engine), memoized."""
    if ("port", name) not in _ONE:
        c = _setup()["runs"][name]
        params = (_setup()["params_t"][c["arch"]] if c["draw"] is None
                  else t_init_params(c["cfg"], seed=c["draw"], device="cpu"))
        out, eng = _drive(c, params)
        assert out["errors"] == []
        _ONE[("port", name)] = out, eng
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
    want = _port_one(name)[0]["tokens"]
    got = _sharded(ranks, name)
    assert {int(k): v for k, v in got["tokens"].items()} == want


def test_preemption_schedule_matches_one_device(ranks):
    one, eng = _port_one("preempt")
    got = _sharded(ranks, "preempt")
    assert eng.preempt_count >= 1
    assert got["preempts"] == eng.preempt_count
    assert {int(k): v for k, v in got["tokens"].items()} == one["tokens"]
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


def _tokens(out):
    return {int(k): v for k, v in out["tokens"].items()}


@pytest.mark.parametrize("name", ["mamba", "mamba_bitserial", "rg6"])
def test_recurrent_1x4_matches_one_device(ranks, name):
    """mamba2-2.7b (2 SSD heads a rank, the B|C columns whole on every rank)
    on digital and on dynamic bit-serial with a noise seed (exact: the
    banks, noise sites and gain are the single device's, the gated norm
    runs whole); recurrentgemma-2b with 6 query heads (its attention and
    ring replicated, its RG-LRU width, d_ff and vocabulary sharded).  Each
    rank's cache holds its share of the recurrent state."""
    one, eng = _port_one(name)
    got = _sharded(ranks, name)
    assert _tokens(got) == one["tokens"]
    assert got["whole"] == one["whole"] == eng.kv_pool_bytes()
    cfg = _setup()["runs"][name]["cfg"]
    if name == "rg6":
        assert got["state"] * TP == one["state"]
    if name.startswith("mamba"):  # (heads/4) N P float32 + conv inputs
        d_inner, heads = 2 * cfg.d_model, 2 * cfg.d_model // cfg.ssm_head_dim
        conv = d_inner // TP + 2 * cfg.ssm_groups * cfg.ssm_state
        assert got["state"] == cfg.n_layers * 4 * (
            heads // TP * cfg.ssm_state * cfg.ssm_head_dim
            + (cfg.conv_width - 1) * conv)
        assert got["per_device"] < one["per_device"]


def test_calibration_on_shards_matches_one_device(ranks):
    """Frozen analytic calibrated on the ranks' shards: every site's
    ``x_max``, ``w_max`` and ``sigma_yo`` within rel 1e-5 of the one
    device's calibration (the per-row output moments summed over the
    group), and the one device's greedy tokens."""
    one, _ = _port_one("calibrated")
    got = _sharded(ranks, "calibrated")
    assert got["calibration"].keys() == one["calibration"].keys()
    for site, st in one["calibration"].items():
        for field, v in st.items():
            assert got["calibration"][site][field] == pytest.approx(
                v, rel=1e-5), (site, field)
    assert _tokens(got) == one["tokens"]


def test_drift_monitoring_across_ranks_matches_one_device(ranks):
    """Every chunk sampled and checked, mlp.wi scaled after two requests:
    the ranks read the group-reduced statistics, so every rank makes the
    one device's reports (chunk and drifted sites) and swaps as often."""
    one, _ = _port_one("drift")
    got = _sharded(ranks, "drift")
    assert one["swaps"] >= 1 and any(sites for _, sites in one["reports"])
    assert (got["reports"], got["swaps"]) == (one["reports"], one["swaps"])
    assert _tokens(got) == one["tokens"]


def test_fault_on_one_rank_is_retried_on_every_rank(ranks):
    """A transient error injected on rank 2 alone, before decode chunk 0 of
    the digital run: the ranks vote, every rank retries once, and the
    tokens are the uninjected run's (the JAX engine's)."""
    got = _sharded(ranks, "digital")
    assert _setup()["runs"]["digital"]["fault"] == (2, 0)
    assert _tokens(got) == _jax_tokens("digital")
    assert got["ranks"] == [[1, 0]] * TP  # (retries, decode failures)


def test_substrate_swap_to_bitserial_under_a_mesh(ranks):
    """Frozen analytic, then frozen bit-serial after the first chunk: the
    row sites are gathered and placed again by columns, and the tokens are
    the one device's same swap."""
    one, _ = _port_one("swap")
    got = _sharded(ranks, "swap")
    assert _tokens(got) == one["tokens"]


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
    with pytest.raises(ValueError, match="not in the mesh"):
        t_serve.Engine(cfg, params, 2, 32, mesh=t_mesh.Mesh(1, TP, None, -1))


CLI = ["--arch", MUSIC, "--smoke", "--batch", "4", "--requests", "5",
       "--prompt-lens", "4,6,20,5", "--gen", "4", "--device", "cpu",
       "--imc-mode", "imc_bitserial", "--imc-policy", "frozen"]


def test_cli_mesh_serves_the_one_device_tokens():
    """Frozen bit-serial with online recalibration: the ranks calibrate on
    their shards, sample and check every chunk, and give the one device's
    tokens and monitor counters."""
    drift = ["--recalibrate", "--drift-sample-every", "1",
             "--drift-check-every", "1"]
    one = t_serve.main(CLI + drift)
    four = t_serve.main(CLI + drift + ["--mesh", "1x4"])
    assert ({r.rid: r.out for r in four["finished"]}
            == {r.rid: r.out for r in one["finished"]})
    assert four["monitor"].counters() == one["monitor"].counters()
    assert four["monitor"].checks > 0
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
