"""The port's simulator core (``repro_torch.sim``), its blame decomposition
(``repro_torch.obs.blame``) and the tracing exporters against the JAX
package's on the same inputs: seeded event traces ``(ts, kind, data)``,
structured trace events and ``JobStats`` for uncoded, coded and hybrid
jobs at several r, under stragglers, crashes, speculation, a placement
bridge and contention; the Perfetto export of the canonical two-job run
equal to the committed ``tests/golden_obs_trace.json``; the blame
exactness law; calibration; workloads.

Tolerance: exact equality everywhere (the port's simulator is the same
float64 NumPy and Python arithmetic in the same order), apart from the
exactness law's own bound of 1e-9 relative."""
import dataclasses
import json
import math
import pathlib

import numpy as np
import pytest

from repro import placement as jpl
from repro import resilience as jres
from repro import sim as jsim
from repro.core.params import SchemeParams as JParams
from repro.obs import blame as jblame
from repro.obs import tracing as jtracing
from repro_torch import placement as tpl
from repro_torch import sim as tsim
from repro_torch.core.params import SchemeParams
from repro_torch.obs import blame as tblame
from repro_torch.obs import tracing as ttracing
from repro_torch.resilience import faults as tfaults

ROOT = pathlib.Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "tests" / "golden_obs_trace.json"


def _costs(mod):
    return mod.CostModel(map=mod.PhaseCoeffs(1e-3, 1e-8),
                         pack=mod.PhaseCoeffs(5e-4, 5e-9),
                         reduce=mod.PhaseCoeffs(1e-3, 1e-8))


def _events(sim):
    return [dataclasses.astuple(e) for e in sim.tracer.events]


def _assert_same_run(t, j):
    """Two finished sims (port, JAX): the same legacy trace, structured
    events, job stats, clock and rng state."""
    assert t.trace == j.trace
    assert _events(t) == _events(j)
    assert [dataclasses.asdict(s) for s in t.stats] == \
        [dataclasses.asdict(s) for s in j.stats]
    assert t.now == j.now
    assert t.rng.integers(2 ** 62) == j.rng.integers(2 ** 62)


def _pair(build):
    """Run ``build(mod)`` for the port and the JAX package."""
    return build(tsim), build(jsim)


def _solo(mod, scheme="hybrid", r=2, stragglers=None, crashes=(),
          telemetry=False, seed=0, topo=None, spec=(48, 16, 2),
          speculation=None, check=True):
    topo = topo or mod.RackTopology(P=4, cross_bw=1e3, intra_bw=1e4)
    sim = mod.ClusterSim(topo, 8, _costs(mod), stragglers=stragglers,
                         seed=seed, telemetry=telemetry)
    sim.submit(mod.JobSpec("j", *spec), scheme, r, time=0.0, check=check,
               speculation=speculation)
    for t, servers in crashes:
        sim.inject_crash(t, servers)
    sim.run()
    return sim


# ---------------------------------------------------------------------------
# Traces and JobStats
# ---------------------------------------------------------------------------

SCHEMES = [("uncoded", 1), ("coded", 2), ("coded", 3), ("hybrid", 1),
           ("hybrid", 2), ("hybrid", 3), ("hybrid", 4),
           ("hybrid_resolvable", 2)]


@pytest.mark.parametrize("scheme,r", SCHEMES, ids=lambda x: str(x))
def test_single_job_trace_equal_jax(scheme, r):
    t, j = _pair(lambda m: _solo(m, scheme, r, check=scheme != "coded"))
    _assert_same_run(t, j)
    (s,) = t.stats
    assert abs(s.jct - math.fsum(s.blame.values())) <= 1e-9 * max(s.jct, 1)


@pytest.mark.parametrize("strag", ["exponential", "rack", "fixed"])
@pytest.mark.parametrize("seed", [0, 7])
def test_stragglers_trace_equal_jax(strag, seed):
    def build(m):
        model = {"exponential": m.ExponentialTail(0.5),
                 "rack": m.RackCorrelated(p_slow=0.5, factor=3.0),
                 "fixed": m.DeterministicSlowdown(
                     (1.0, 2.0, 1.0, 1.0, 1.5, 1.0, 1.0, 1.0))}[strag]
        return _solo(m, stragglers=model, seed=seed)
    t, j = _pair(build)
    _assert_same_run(t, j)


@pytest.mark.parametrize("scheme,r", [("hybrid", 2), ("hybrid", 1),
                                      ("hybrid", 3), ("uncoded", 1)])
@pytest.mark.parametrize("crashes", [
    ((0.0005, (0,)),), ((0.004, (1,)),), ((0.004, (1, 5)),),
    ((0.002, (2,)), (0.006, (6,)))],
    ids=["in_map", "in_shuffle", "two_servers", "twice"])
def test_crash_schedule_trace_equal_jax(scheme, r, crashes):
    t, j = _pair(lambda m: _solo(m, scheme, r, crashes=crashes))
    _assert_same_run(t, j)
    assert t.stats[0].crashes == len(crashes)


def test_fault_injector_schedule_equal_jax():
    tf = tfaults.FaultInjector.random(3, 8, n_events=3, max_servers=2,
                                      max_time=0.01)
    jf = jres.FaultInjector.random(3, 8, n_events=3, max_servers=2,
                                   max_time=0.01)

    def build(m, inj):
        topo = m.RackTopology(P=4, cross_bw=1e3, intra_bw=1e4)
        sim = m.ClusterSim(topo, 8, _costs(m), seed=1)
        sim.submit(m.JobSpec("j", 48, 16, 2), "hybrid", 2, time=0.0)
        inj.inject_into(sim)
        sim.run()
        return sim
    _assert_same_run(build(tsim, tf), build(jsim, jf))


@pytest.mark.parametrize("policy", ["none", "clone", "late", "mantri"])
def test_speculative_map_trace_equal_jax(policy):
    """The task-granular map phase, driven by the JAX package's policies
    (duck-typed: the port's sim calls the same hooks on its own view)."""
    def build(m):
        return _solo(m, stragglers=m.ExponentialTail(1.0), seed=2,
                     speculation=jres.get_policy(policy),
                     crashes=((0.003, (3,)),))
    t, j = _pair(build)
    _assert_same_run(t, j)
    assert t.stats[0].speculation == policy


def test_contending_jobs_and_telemetry_equal_jax():
    def build(m):
        topo = m.RackTopology(P=4, cross_bw=1e3, intra_bw=1e4,
                              rack_bw_scale=(0.5, 1.0, 1.0, 2.0),
                              cross_latency=1e-4)
        sim = m.ClusterSim(topo, 8, _costs(m), seed=3, telemetry=True)
        sim.submit(m.JobSpec("a", 48, 16, 2), "hybrid", 2, time=0.0)
        sim.submit(m.JobSpec("b", 96, 16, 1), "coded", 2, time=0.001,
                   check=False)
        sim.submit(m.JobSpec("c", 48, 16, 4), "uncoded", 1, time=0.002)
        sim.run(until=0.004)             # truncate, then resume
        sim.run()
        return sim
    t, j = _pair(build)
    _assert_same_run(t, j)
    assert t.telemetry.to_dict() == j.telemetry.to_dict()
    assert t.telemetry.utilization() == j.telemetry.utilization()
    assert t.telemetry.cancelled_units() == j.telemetry.cancelled_units()


def test_placement_bridged_jobs_equal_jax():
    jp = JParams(8, 4, 16, 48, 2, r_f=2)
    p = SchemeParams(8, 4, 16, 48, 2, r_f=2)
    replicas = jpl.place_replicas(jp, np.random.default_rng(0))
    jres_ = jpl.solve(jp, replicas, "random", seed=1)
    tres_ = tpl.solve(p, replicas, "random", seed=1)
    assert np.array_equal(tres_.perm, jres_.perm)

    def build(m, res, traffic_for_result):
        topo = m.RackTopology(P=4, cross_bw=1e4, intra_bw=1e5,
                              fetch_latency=1e-4)
        sim = m.ClusterSim(topo, 8, _costs(m), seed=0)
        sim.submit(m.JobSpec("histogram", 48, 16, 1), "hybrid", 2,
                   time=0.0, placement=traffic_for_result(res))
        sim.submit(m.JobSpec("histogram", 48, 16, 1), "hybrid", 2,
                   time=0.0)
        sim.run()
        return sim
    t = build(tsim, tres_, tpl.traffic_for_result)
    j = build(jsim, jres_, jpl.traffic_for_result)
    _assert_same_run(t, j)
    by_id = {s.job_id: s for s in t.stats}
    assert by_id[0].fetch_bytes > 0 and by_id[1].fetch_bytes == 0


def test_placement_traffic_validated_like_jax():
    topo = tsim.RackTopology(P=4)
    sim = tsim.ClusterSim(topo, 8)
    bad = tpl.PlacementTraffic(0.0, (0.0,) * 4, (1.0,) * 7, 1.0, 1.0)
    with pytest.raises(ValueError, match="map_factors"):
        sim.submit(tsim.JobSpec("h", 48, 16, 1), "hybrid", 2, placement=bad)


@pytest.mark.parametrize("scheme,r", [("hybrid", 2), ("coded", 2),
                                      ("uncoded", 1)])
def test_simulate_single_job_equal_jax(scheme, r):
    def build(m):
        topo = m.RackTopology(P=4, cross_bw=2.0, intra_bw=20.0)
        return m.simulate_single_job(m.JobSpec("h", 48, 16, 3), topo, 8,
                                     scheme, r, stragglers=m.ExponentialTail(),
                                     seed=5, check=False)
    t, j = _pair(build)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)


# ---------------------------------------------------------------------------
# The canonical two-job run and its Perfetto golden
# ---------------------------------------------------------------------------

def _golden_sim(m):
    """``tests/test_obs.py``'s canonical run: two hybrid jobs contending,
    non-trivial compute costs, no stragglers."""
    topo = m.RackTopology(P=3, cross_bw=1e3, intra_bw=1e4)
    sim = m.ClusterSim(topo, K=9, cost_model=m.CostModel(
        map=m.PhaseCoeffs(1e-3, 1e-8)), seed=0)
    sim.submit(m.JobSpec("histogram", 72, 18, 1), "hybrid", 2, time=0.0)
    sim.submit(m.JobSpec("histogram", 72, 18, 1), "hybrid", 2, time=0.05)
    sim.run()
    return sim


def test_chrome_trace_equals_committed_golden():
    t = _golden_sim(tsim)
    doc = ttracing.to_chrome_trace(t.tracer.events)
    assert doc == json.loads(GOLDEN.read_text())
    assert ttracing.validate_chrome_trace(doc) == len(doc["traceEvents"])
    assert ttracing.validate_chrome_trace(json.dumps(doc)) == \
        len(doc["traceEvents"])
    _assert_same_run(t, _golden_sim(jsim))


def test_jsonl_and_written_files_equal_jax(tmp_path):
    t, j = _golden_sim(tsim), _golden_sim(jsim)
    for nd in (None, 6, 12):
        assert ttracing.to_jsonl(t.tracer.events, ndigits=nd) == \
            jtracing.to_jsonl(j.tracer.events, ndigits=nd)
    ttracing.to_chrome_trace(t.tracer.events, str(tmp_path / "t.json"))
    jtracing.to_chrome_trace(j.tracer.events, str(tmp_path / "j.json"))
    assert (tmp_path / "t.json").read_text() == \
        (tmp_path / "j.json").read_text()
    ttracing.to_jsonl(t.tracer.events, str(tmp_path / "t.jsonl"))
    assert (tmp_path / "t.jsonl").read_text() == \
        jtracing.to_jsonl(j.tracer.events)


@pytest.mark.parametrize("doc,msg", [
    ({}, "missing traceEvents"),
    ({"traceEvents": [{"name": "a", "ph": "X", "ts": 0, "pid": 0}]},
     "missing 'tid'"),
    ({"traceEvents": [{"name": "a", "ph": "Q", "ts": 0, "pid": 0,
                       "tid": 0}]}, "ph unknown"),
    ({"traceEvents": [{"name": "a", "ph": "X", "ts": 0, "pid": 0,
                       "tid": 0}]}, "without numeric dur"),
    ({"traceEvents": [{"name": "a", "ph": "i", "ts": "0", "pid": 0,
                       "tid": 0}]}, "not numeric")])
def test_validate_chrome_trace_rejects_like_jax(doc, msg):
    for mod in (ttracing, jtracing):
        with pytest.raises(ValueError, match=msg):
            mod.validate_chrome_trace(doc)


def test_tracer_event_and_span_records():
    clock = iter([1.0, 2.5, 4.0]).__next__
    tr = ttracing.Tracer(clock=clock)
    tr.event("mark", job_id=3, data=(1, "x"), why="t")
    with tr.span("map", job_id=3, rack=1):
        pass
    assert [e.to_dict() for e in tr.events] == [
        {"ts": 1.0, "kind": "mark", "job_id": 3, "labels": {"why": "t"},
         "data": [1, "x"]},
        {"ts": 2.5, "kind": "span", "job_id": 3, "phase": "map",
         "labels": {"rack": "1"}, "dur": 1.5}]
    off = ttracing.Tracer(enabled=False)
    off.event("x")
    assert off.events == []


# ---------------------------------------------------------------------------
# Blame
# ---------------------------------------------------------------------------

def _blame_runs(m):
    return [_solo(m), _solo(m, stragglers=m.ExponentialTail(0.5), seed=4),
            _solo(m, crashes=((0.004, (1,)),)), _golden_sim(m)]


def test_blame_exactness_law_and_reports_equal_jax():
    truns, jruns = _blame_runs(tsim), _blame_runs(jsim)
    treps, jreps = [], []
    for t, j in zip(truns, jruns):
        for ts, js in zip(t.stats, j.stats):
            assert abs(ts.jct - math.fsum(ts.blame.values())) <= \
                1e-9 * max(ts.jct, 1.0)
            assert list(ts.blame) == list(tblame.COMPONENTS)
            tr, jr = tblame.blame_report(ts), jblame.blame_report(js)
            assert tr.to_dict() == jr.to_dict()
            assert tr.dominant() == jr.dominant()
            assert tr.share("map") == jr.share("map")
            te = tblame.extract_blame(t.tracer.events, ts)
            assert te.to_dict() == \
                jblame.extract_blame(j.tracer.events, js).to_dict()
            assert abs(te.residual) <= 1e-9 * max(te.jct, 1.0)
            assert [dataclasses.astuple(x) for x in tblame.critical_path(
                t.tracer.events, ts.job_id)] == \
                [dataclasses.astuple(x) for x in jblame.critical_path(
                    j.tracer.events, js.job_id)]
            treps.append(tr)
            jreps.append(jr)
    for q in (0.5, 0.99):
        assert tblame.fleet_blame(treps, q) == jblame.fleet_blame(jreps, q)
    assert tblame.fleet_blame([]) == jblame.fleet_blame([])


def test_decompose_and_phase_timing_blame_equal_jax():
    pt = {"plan_compile": 0.1, "fetch": 0.2, "map": 1.0, "pack": 0.3,
          "shuffle:cross": 2.0, "shuffle:intra": 0.5, "remap": 0.4,
          "reduce": 0.6}
    it = {"fetch": 0.15, "map": 0.8, "shuffle:cross": 1.5}
    ff = {"cross": 1.2, "intra": 0.5}
    args = (6.0, 0.25, pt, it, ff, 0.05)
    assert tblame.decompose(*args) == jblame.decompose(*args)
    assert tblame.decompose(1.0, 0.0, {"map": 1.0}) == \
        jblame.decompose(1.0, 0.0, {"map": 1.0})
    row = {"seconds": {"plan_compile": 0.01, "map": 0.2, "pack": 0.05,
                       "reduce": 0.03},
           "meta": {"K": 16, "P": 4, "Q": 16, "N": 1680, "r": 2,
                    "shuffle_s": 0.4}}
    for bw in ((None, None), (1e5, 1e4)):
        assert tblame.blame_from_phase_timings(row, *bw) == \
            jblame.blame_from_phase_timings(row, *bw)
    bad = {"seconds": {"map": 1.0}, "meta": {"shuffle_s": 0.5}}
    assert tblame.blame_from_phase_timings(bad) == \
        jblame.blame_from_phase_timings(bad)


# ---------------------------------------------------------------------------
# Calibration, costs, workloads
# ---------------------------------------------------------------------------

def test_calibrate_fits_the_same_cost_model():
    rng = np.random.default_rng(0)
    rows = []
    for _ in range(6):
        w = float(rng.integers(1, 10 ** 6))
        rows.append({"work": {"map": w, "pack": 2 * w, "reduce": w / 3,
                              "plan_compile": w / 7},
                     "seconds": {"map": 1e-3 + 2e-8 * w + rng.random() * 1e-5,
                                 "pack": 5e-4 + 1e-8 * w,
                                 "reduce": 3e-9 * w,
                                 "plan_compile": 1e-2}})
    for subset in (rows, rows[:1], [{"work": {}, "seconds": {}}]):
        assert dataclasses.asdict(tsim.calibrate(subset)) == \
            dataclasses.asdict(jsim.calibrate(subset))
    bench = json.loads((ROOT / "BENCH_pipeline.json").read_text())
    tm = tsim.measurements_from_pipeline_bench(bench)
    assert tm == jsim.measurements_from_pipeline_bench(bench)
    assert dataclasses.asdict(tsim.calibrate(tm)) == \
        dataclasses.asdict(jsim.calibrate(tm))
    with pytest.raises(ValueError, match="schema_version"):
        tsim.measurements_from_pipeline_bench({"schema_version": 0})


@pytest.mark.parametrize("scheme", ["uncoded", "coded", "hybrid"])
def test_phase_work_equal_jax(scheme):
    for r in (1, 2, 3):
        p = SchemeParams(16, 4, 16, 1680, r)
        assert tsim.phase_work(p, scheme, 2048) == \
            jsim.phase_work(JParams(16, 4, 16, 1680, r), scheme, 2048)


@pytest.mark.parametrize("kind", ["poisson", "bursty", "diurnal"])
def test_workloads_equal_jax(kind):
    def build(m):
        cat = m.default_catalog(8, 4, families=("binomial", "resolvable"))
        wl = {"poisson": lambda: m.PoissonWorkload(cat, 12, rate=3.0),
              "bursty": lambda: m.BurstyWorkload(cat, 10, 3, 0.5),
              "diurnal": lambda: m.DiurnalWorkload(cat, 9, 1.0, 5.0,
                                                   period=10.0)}[kind]()
        return cat, wl.generate(seed=4)
    (tc, tj), (jc, jj) = _pair(build)
    assert tc == jc
    assert [dataclasses.asdict(x) for x in tj] == \
        [dataclasses.asdict(x) for x in jj]
    assert tsim.valid_subfile_counts(16, 4, (1, 2, 3), coded_rs=(2,)) == \
        jsim.valid_subfile_counts(16, 4, (1, 2, 3), coded_rs=(2,))
    assert tsim.JOB_ZOO == jsim.JOB_ZOO
