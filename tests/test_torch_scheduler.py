"""The port's scheduler, workload generator and SLO rollup against the JAX
package, on the CPU.

Everything here is host-side Python and numpy in both packages, so the
results must be identical: the same queue orders and shed lists, the same
controller levels and time scales, the same workload draw for draw (one
``numpy.random.default_rng(seed)`` stream), and the same SLO summary.
"""
import numpy as np
import pytest

from repro.core import design as j_design
from repro.core import substrate as j_substrate
from repro.launch import metering as j_metering
from repro.launch import scheduler as j_scheduler
from repro.launch.serve import Request as JRequest
from repro.runtime import workload as j_workload
from repro_torch import runtime as t_runtime
from repro_torch.core import design as t_design
from repro_torch.core import substrate as t_substrate
from repro_torch.launch import metering as t_metering
from repro_torch.launch import scheduler as t_scheduler
from repro_torch.launch.serve import Request as TRequest
from repro_torch.runtime import workload as t_workload
from torch_threads import two_threads  # noqa: F401  (autouse)


def _queue(cls, seed, n=12):
    """A seeded queue: fresh and resumed requests, some without deadlines."""
    rng = np.random.default_rng(seed)
    out = []
    for rid in range(n):
        has_deadline = rng.random() < 0.8
        r = cls(rid=rid, prompt=np.arange(int(rng.integers(1, 20))),
                max_new=8,
                arrive_at=float(rng.uniform(0, 20)) if has_deadline else None,
                ttft_deadline=float(rng.choice([2.0, 5.0, 48.0]))
                if has_deadline else None)
        r.out = list(range(int(rng.integers(0, 3)) if rng.random() < 0.3
                           else 0))
        out.append(r)
    return out


@pytest.mark.parametrize("name", ["fifo", "sjf", "deadline"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_policies_order_and_shed_like_reference(name, seed):
    pj, pt = j_scheduler.make_policy(name), t_scheduler.make_policy(name)
    assert type(pt).__name__ == type(pj).__name__ and pt.name == pj.name
    qj, qt = _queue(JRequest, seed), _queue(TRequest, seed)
    for now in (0.0, 6.0, 15.0, 40.0):
        shed_j = [r.rid for r in pj.shed(qj, now)]
        shed_t = [r.rid for r in pt.shed(qt, now)]
        assert shed_t == shed_j
        pj.order(qj, now)
        pt.order(qt, now)
        assert [r.rid for r in qt] == [r.rid for r in qj]
    with pytest.raises(ValueError, match="unknown scheduler policy"):
        t_scheduler.make_policy("lifo")


class _Alloc:
    def __init__(self):
        self.num_blocks = 9
        self.used_count = 0


class _FakeEngine:
    """Model-free engine: the controller reads queue depth and pool use and
    calls ``swap_substrate``."""

    def __init__(self):
        self.queue_depth = 0
        self.batch_slots = 4
        self.alloc = _Alloc()
        self.swaps = []

    def swap_substrate(self, sub, time_scale=1.0):
        self.swaps.append((sub.design.b_adc, time_scale))


def test_pressure_controller_walks_like_reference():
    pj = j_design.optimize(n=512, snr_t_target_db=26.0, kinds=("qr",))
    pt = t_design.optimize(n=512, snr_t_target_db=26.0, kinds=("qr",))
    ej, et = _FakeEngine(), _FakeEngine()
    cj = j_scheduler.PressureController(ej, j_substrate.substrate_ladder(pj))
    ct = t_scheduler.PressureController(et, t_substrate.substrate_ladder(pt))
    assert ct.time_scales == pytest.approx(cj.time_scales, rel=1e-12)
    rng = np.random.default_rng(5)
    levels_j, levels_t = [], []
    for _ in range(60):
        depth, used = int(rng.integers(0, 10)), int(rng.integers(0, 9))
        for eng in (ej, et):
            eng.queue_depth, eng.alloc.used_count = depth, used
        assert ct.pressure() == cj.pressure()
        levels_j.append(cj.update())
        levels_t.append(ct.update())
    assert levels_t == levels_j and len(set(levels_t)) > 1
    assert et.swaps == ej.swaps
    assert ct.counters() == cj.counters()
    with pytest.raises(ValueError, match="high > low"):
        t_scheduler.PressureController(et, [object()], high=0.2, low=0.5)


@pytest.mark.parametrize("kw", [
    dict(arrival="poisson"), dict(arrival="bursty"),
    dict(arrival="bursty", prefix_len=6, prefix_dup=3),
    dict(arrival="poisson", prompt_median=20.0, max_new=16, burst_size=3)])
def test_workload_generate_draw_for_draw(kw):
    for seed in (0, 7):
        wj = j_workload.make_overload_config(n_requests=30, seed=seed,
                                             overload=2.0, slots=8, **kw)
        wt = t_workload.make_overload_config(n_requests=30, seed=seed,
                                             overload=2.0, slots=8, **kw)
        assert wt.mean_interarrival == wj.mean_interarrival
        rj = j_workload.generate(wj, vocab_size=2048)
        rt = t_workload.generate(wt, vocab_size=2048)
        assert len(rt) == len(rj) == 30
        for a, b in zip(rj, rt):
            assert isinstance(b, TRequest)
            np.testing.assert_array_equal(a.prompt, b.prompt)
            for f in ("rid", "max_new", "stop_at", "arrive_at", "rclass",
                      "ttft_deadline", "itl_deadline"):
                assert getattr(b, f) == getattr(a, f), f
    with pytest.raises(ValueError, match="arrival"):
        t_workload.WorkloadConfig(arrival="uniform")
    assert t_runtime.generate is t_workload.generate


def test_virtual_clock_matches_reference():
    cj, ct = j_workload.VirtualClock(), t_workload.VirtualClock()
    for dt, scale in ((2.0, 1.0), (4.0, 0.5), (0.125, 0.875)):
        cj.time_scale = ct.time_scale = scale
        cj.advance(dt * cj.time_scale)
        ct.advance(dt * ct.time_scale)
    assert ct.now == cj.now
    with pytest.raises(ValueError):
        ct.advance(-1.0)


def _finished(cls):
    """The reference's SLO fixture: met, late first token, gappy, shed and
    errored requests, plus one without deadlines."""
    def req(rid, arrive=0.0, ttft=None, itl=None, t_first=None, times=(),
            error_kind=None):
        r = cls(rid=rid, prompt=np.arange(4), max_new=8, arrive_at=arrive,
                ttft_deadline=ttft, itl_deadline=itl)
        r.t_first = t_first
        r.token_times = list(times)
        r.out = list(range(len(times)))
        if error_kind is not None:
            r.error, r.error_kind = f"{error_kind} failure", error_kind
        return r

    return [req(0, ttft=5.0, itl=2.0, t_first=3.0, times=(3.0, 4.0, 5.0)),
            req(1, ttft=2.0, itl=10.0, t_first=6.0, times=(6.0, 7.0)),
            req(2, ttft=50.0, itl=1.5, t_first=1.0, times=(1.0, 2.0, 6.0)),
            req(3, ttft=2.0, error_kind="shed"),
            req(4, error_kind="decode"),
            req(5, arrive=1.5, t_first=4.25, times=(4.25, 5.0, 5.75, 9.0))]


@pytest.mark.parametrize("elapsed", [0.0, 10.0, 37.5])
def test_slo_summary_and_percentile_match_reference(elapsed):
    fj, ft = _finished(JRequest), _finished(TRequest)
    sj = j_metering.slo_summary(fj, elapsed=elapsed, policy="deadline")
    st = t_metering.slo_summary(ft, elapsed=elapsed, policy="deadline")
    assert st.keys() == sj.keys()
    for k in sj:
        assert (st[k] == sj[k]) or (st[k] != st[k] and sj[k] != sj[k]), k
    assert (t_metering.format_slo_summary(st)
            == j_metering.format_slo_summary(sj))
    for r_j, r_t in zip(fj, ft):
        assert t_metering.request_ttft(r_t) == j_metering.request_ttft(r_j)
        assert (t_metering.request_itl_gaps(r_t)
                == j_metering.request_itl_gaps(r_j))
    xs = [3.0, 1.0, 4.0, 1.5, 9.0, 2.0, 6.0]
    for p in (0, 1, 50, 90, 99, 100):
        assert t_metering.percentile(xs, p) == j_metering.percentile(xs, p)
    assert np.isnan(t_metering.percentile([], 50))
