"""The port's online scheduler (``repro_torch.sim.scheduler``) against the
JAX package's on the same seeded streams: every ``Decision`` (all fields,
``est_components`` and the placement traffic included), every ``JobStats``
and every trace event, over the fifo/srpt/fair policies, adaptive and
fixed choosers, real plan compiles on and off, the availability charge, the
three deterministic placement solvers and the straggler-aware
``HedgedRPolicy``.  Also the plan-cache knob (``configure_plan_cache`` and
``REPRO_PLAN_CACHE_MAXSIZE``), ``chip_smoke.py``'s copy of
``benchmarks/sim_bench.py`` at the bench's ``--smoke`` sizes, and the
``anneal`` solver's invariants on the CPU.

Both packages' plan caches are cleared and both metrics registries emptied
before every stream: the compile charge reads the process-global plan
cache.  Tolerance: exact equality (the same float64 NumPy and Python
arithmetic in the same order)."""
import dataclasses
import importlib.util
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmarks import sim_bench
from repro import resilience as jres
from repro import sim as jsim
from repro.core import coded_collectives as jcc
from repro.core import degraded as jdeg
from repro.core.params import SchemeParams as JParams
from repro.obs import metrics as jmetrics
from repro_torch import placement as tpl
from repro_torch import resilience as tres
from repro_torch import sim as tsim
from repro_torch.core import coded_collectives as tcc
from repro_torch.core import costs as tcosts
from repro_torch.core import degraded as tdeg
from repro_torch.core.params import TABLE1_GRID, SchemeParams
from repro_torch.obs import metrics as tmetrics

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def _fresh_state():
    """Cold plan and degraded-plan caches and empty registries in both
    packages, before and after: the compile charge reads the process-global
    plan cache, and the availability charge compiles a base plan only when
    its degraded plan is not already in the side cache (filled by any
    earlier test in the process)."""
    for mod in (tcc, jcc):
        mod.plan_cache_clear()
    for mod in (tdeg, jdeg):
        mod.degraded_cache_clear()
    for mod in (tmetrics, jmetrics):
        mod.registry().clear()
    yield
    for mod in (tcc, jcc):
        mod.plan_cache_clear()


# the small catalog: every hybrid r in {1, 2, 3} admissible, sizes 24..96
# (the solvers' cost grows fast with N; flow takes 0.1 s at N = 96)
def _catalog(m):
    return m.default_catalog(8, 4, coded_rs=())


def _cost(m):
    return m.CostModel(map=m.PhaseCoeffs(1e-3, 2e-8),
                       pack=m.PhaseCoeffs(5e-4, 1e-8),
                       reduce=m.PhaseCoeffs(1e-4, 1e-8),
                       plan_compile=m.PhaseCoeffs(2e-3, 5e-6))


def _stream(m, cc, policy="fifo", n_jobs=10, seed=0, stragglers=None,
            cross_bw=1e5, max_concurrent=3, catalog=None, **chooser_kw):
    cc.plan_cache_clear()
    topo = m.RackTopology(P=4, cross_bw=cross_bw, intra_bw=1e7)
    cluster = m.ClusterSim(topo, 8, _cost(m), stragglers, seed)
    chooser = m.SchemeChooser(8, cost_model=_cost(m), **chooser_kw)
    jobs = m.PoissonWorkload(catalog or _catalog(m), n_jobs,
                             rate=4.0).generate(seed)
    stats, sched = m.run_scheduled(jobs, cluster, chooser, policy=policy,
                                   max_concurrent=max_concurrent)
    return {"stats": [dataclasses.asdict(s) for s in stats],
            "decisions": {k: dataclasses.asdict(d)
                          for k, d in sched.decisions.items()},
            "trace": [dataclasses.astuple(e) for e in cluster.tracer.events],
            "legacy": list(cluster.trace), "now": cluster.now}


def _assert_same(build):
    t, j = build(tsim, tcc), build(jsim, jcc)
    assert t["decisions"] == j["decisions"]
    assert t["stats"] == j["stats"]
    assert t["trace"] == j["trace"]
    assert t["legacy"] == j["legacy"] and t["now"] == j["now"]
    assert len(t["decisions"]) == len(t["stats"]) > 0
    return t


# ---------------------------------------------------------------------------
# Scheduled streams
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("policy", ["fifo", "srpt", "fair"])
@pytest.mark.parametrize("adaptive", [True, False],
                         ids=["adaptive", "fixed"])
def test_scheduled_stream_equal_jax(policy, adaptive):
    t = _assert_same(lambda m, cc: _stream(
        m, cc, policy, adaptive=adaptive, fixed=("hybrid", 2),
        stragglers=m.ExponentialTail(0.5)))
    if not adaptive:
        assert {(d["scheme"], d["r"]) for d in t["decisions"].values()} \
            == {("hybrid", 2)}


@pytest.mark.parametrize("compile_real_plans", [True, False])
def test_compile_charge_equal_jax(compile_real_plans):
    """With real compiles the first admission of each plan misses the cache
    and later ones hit it, in both packages alike."""
    t = _assert_same(lambda m, cc: _stream(
        m, cc, n_jobs=12, compile_real_plans=compile_real_plans))
    hits = [d["cache_hit"] for d in t["decisions"].values()]
    if compile_real_plans:
        assert False in hits and True in hits
    else:
        assert all(hits)


@pytest.mark.parametrize("crash_prob", [0.05, 0.5])
def test_availability_charge_equal_jax(crash_prob):
    t = _assert_same(lambda m, cc: _stream(m, cc, "srpt",
                                           crash_prob=crash_prob))
    for d in t["decisions"].values():
        assert d["est_components"]["recovery"] > 0


def test_default_catalog_stream_equal_jax():
    """The default catalog (sizes 168..672) over the bench's topology."""
    _assert_same(lambda m, cc: _stream(
        m, cc, n_jobs=12, cross_bw=1e6, max_concurrent=4,
        catalog=m.default_catalog(8, 4), expected_straggler=1.5,
        stragglers=m.ExponentialTail(0.5)))


@pytest.mark.parametrize("solver", ["greedy", "flow", "local_search"])
def test_placement_solver_stream_equal_jax(solver):
    t = _assert_same(lambda m, cc: _stream(
        m, cc, n_jobs=8, placement_solver=solver, placement_seed=3))
    placed = [d for d in t["decisions"].values()
              if d["placement"] is not None]
    assert placed and all(d["scheme"] == "hybrid" for d in placed)


@pytest.mark.parametrize("policy", ["uniform", "hdfs"])
def test_placement_policy_stream_equal_jax(policy):
    _assert_same(lambda m, cc: _stream(
        m, cc, n_jobs=6, placement_solver="greedy",
        placement_policy=policy, placement_r_f=2))


def test_hedged_r_policy_stream_equal_jax():
    """The straggler-aware chooser: fitted inflation, rack-hedged
    structured placements and the online refit from completions."""
    def build(m, cc):
        res = tres if m is tsim else jres
        rp = res.HedgedRPolicy(8, 4, refit_every=3, placement_seed=1)
        out = _stream(m, cc, n_jobs=12, r_policy=rp,
                      stragglers=m.RackCorrelated(0.3, 3.0))
        out["fit"] = dataclasses.asdict(rp.fit)
        out["window"] = list(rp.window)
        return out
    t, j = build(tsim, tcc), build(jsim, jcc)
    assert t == j
    assert t["fit"]["n_obs"] > 0


def test_speculation_on_scheduled_stream_equal_jax():
    def build(m, cc):
        res = tres if m is tsim else jres
        return _stream(m, cc, n_jobs=6,
                       speculation=res.get_policy("late",
                                                  tasks_per_server=4),
                       stragglers=m.ExponentialTail(1.0))
    _assert_same(build)


def test_recalibrating_scheduler_equal_jax():
    """The online refit: drift fires, the chooser's cost model is refitted
    from the live rows, and the ``sched_refit`` events land alike."""
    def build(m, cc):
        cc.plan_cache_clear()
        topo = m.RackTopology(P=4, cross_bw=2e5, intra_bw=2e6)
        cost = m.CostModel(map=m.PhaseCoeffs(1e-3, 5e-7),
                           pack=m.PhaseCoeffs(5e-4, 2e-7),
                           reduce=m.PhaseCoeffs(1e-3, 5e-7))
        cluster = m.ClusterSim(topo, 8, cost,
                               m.DeterministicSlowdown((3.0,) * 8), 0)
        chooser = m.SchemeChooser(8, cost_model=cost,
                                  compile_real_plans=False)
        sched = m.MultiJobScheduler(chooser, max_concurrent=2,
                                    recalibrate=True, refit_min_rows=3)
        jobs = m.PoissonWorkload(_catalog(m), 16, rate=2.0).generate(0)
        stats = sched.run(jobs, cluster)
        return {"stats": [dataclasses.asdict(s) for s in stats],
                "decisions": {k: dataclasses.asdict(d)
                              for k, d in sched.decisions.items()},
                "trace": [dataclasses.astuple(e)
                          for e in cluster.tracer.events],
                "monitor": sched.drift.state(),
                "cost": dataclasses.asdict(chooser.cost_model)}
    t, j = build(tsim, tcc), build(jsim, jcc)
    assert t == j
    assert t["monitor"]["refits"] >= 1
    assert any(e[1] == "sched_refit" for e in t["trace"])


def test_chooser_estimates_equal_jax():
    """``estimate``, ``estimate_components`` and ``candidates`` on a loaded
    cluster, every candidate."""
    def build(m, cc):
        topo = m.RackTopology(P=4, cross_bw=1e5, intra_bw=1e7)
        cluster = m.ClusterSim(topo, 8, _cost(m), None, 0)
        for spec in m.PoissonWorkload(_catalog(m), 3, 4.0).generate(1):
            cluster.submit(spec, "coded", 2, time=0.0, check=False)
        cluster.run(until=1e-3)
        chooser = m.SchemeChooser(8, cost_model=_cost(m), crash_prob=0.1)
        spec = m.JobSpec("q", 48, 16, 4)
        return [(s, r, chooser.estimate(spec, s, r, cluster),
                 chooser.estimate_components(spec, s, r, cluster))
                for s, r in chooser.candidates()]
    t, j = build(tsim, tcc), build(jsim, jcc)
    assert t == j
    assert any(e is None for _, _, e, _ in t)          # inadmissible
    for _, _, est, comps in t:
        if est is not None:
            assert abs(sum(comps.values()) - est) <= 1e-12 * est


def test_scheduler_rejections_equal_jax():
    for m in (tsim, jsim):
        with pytest.raises(ValueError, match="policy must be one of"):
            m.MultiJobScheduler(m.SchemeChooser(8), policy="lifo")
        with pytest.raises(ValueError, match="max_concurrent"):
            m.MultiJobScheduler(m.SchemeChooser(8), max_concurrent=0)
        chooser = m.SchemeChooser(8, adaptive=False, fixed=("coded", 3))
        cluster = m.ClusterSim(m.RackTopology(P=4), 8)
        with pytest.raises(ValueError, match="inadmissible"):
            chooser.choose(m.JobSpec("j", 24, 16, 1), cluster)
    assert tsim.POLICIES == jsim.POLICIES


# ---------------------------------------------------------------------------
# The annealer through the chooser
# ---------------------------------------------------------------------------

def test_anneal_chooser_without_device_or_card_raises(monkeypatch):
    """No fallback: with no device and no card the chooser (and the
    hedged r-policy) refuse to be built with the annealer; the other
    solvers never resolve a device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsim.SchemeChooser(8, placement_solver="anneal")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tres.HedgedRPolicy(8, 4, placement_solver="anneal")
    assert tsim.SchemeChooser(8, placement_solver="flow"
                              ).placement_device is None
    assert tres.HedgedRPolicy(8, 4).placement_device is None
    assert tsim.SchemeChooser(8, placement_solver="anneal",
                              placement_device="cpu"
                              ).placement_device == torch.device("cpu")


def test_anneal_stream_invariants_on_cpu(monkeypatch):
    """Every annealed placement is a permutation no worse than greedy's
    warm start, on the device the chooser was given; the stream is the same
    on a rerun."""
    calls = []
    solver = tpl.SOLVERS["anneal"]

    def recording(p, C, rng, **kw):
        perm = solver(p, C, rng, n_steps=200, **kw)
        calls.append((kw["device"], p, C, perm))
        return perm
    monkeypatch.setitem(tpl.SOLVERS, "anneal", recording)
    kw = dict(n_jobs=4, placement_solver="anneal", placement_device="cpu")
    first = _stream(tsim, tcc, **kw)
    n = len(calls)
    assert n > 0
    for dev, p, C, perm in calls:
        assert dev == torch.device("cpu")
        assert sorted(perm.tolist()) == list(range(p.N))
        assert tpl.perm_objective(p, C, perm) >= \
            tpl.perm_objective(p, C, tpl.greedy_perm(p, C))
    assert _stream(tsim, tcc, **kw) == first
    assert [c[3].tolist() for c in calls[n:]] == \
        [c[3].tolist() for c in calls[:n]]


# ---------------------------------------------------------------------------
# The plan-cache knob
# ---------------------------------------------------------------------------

def _compile_sequence(cc, Params):
    for n, r in ((48, 2), (96, 2), (48, 2), (48, 3), (96, 2), (48, 2)):
        cc.compile_hybrid_plan(Params(K=8, P=4, Q=16, N=n, r=r))
    cc.compile_hybrid_plan(Params(K=8, P=8, Q=16, N=64, r=2),
                           family="resolvable")
    return cc.plan_cache_info()


@pytest.mark.parametrize("maxsize", [2, 0, None])
def test_configure_plan_cache_equal_jax(maxsize):
    try:
        for cc in (tcc, jcc):
            cc.configure_plan_cache(maxsize)
        t = _compile_sequence(tcc, SchemeParams)
        j = _compile_sequence(jcc, JParams)
        assert t == j
        assert t.maxsize == (128 if maxsize is None else maxsize)
    finally:
        for cc in (tcc, jcc):
            cc.configure_plan_cache()


def test_configure_plan_cache_drops_device_tables():
    plan = tcc.compile_hybrid_plan(SchemeParams(K=8, P=4, Q=16, N=48, r=2))
    tcc.device_plan_tables(plan, torch.device("cpu"))
    tcc.rank_plan_tables(plan, 0, torch.device("cpu"))
    assert tcc.device_plan_tables.cache_info().currsize == 1
    try:
        tcc.configure_plan_cache(4)
        assert tcc.device_plan_tables.cache_info().currsize == 0
        assert tcc.rank_plan_tables.cache_info().currsize == 0
        assert tcc.plan_cache_info() == (0, 0, 4, 0, {})
    finally:
        tcc.configure_plan_cache()


@pytest.mark.parametrize("raw,want", [("7", 7), ("0", 0), ("junk", 128)])
def test_plan_cache_maxsize_env_read_at_import(raw, want):
    code = ("from repro_torch.core import coded_collectives as cc; "
            "print(cc.PLAN_CACHE_MAXSIZE_ENV, cc.plan_cache_info().maxsize)")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           tcc.PLAN_CACHE_MAXSIZE_ENV: raw}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == [jcc.PLAN_CACHE_MAXSIZE_ENV, str(want)]


# ---------------------------------------------------------------------------
# chip_smoke.py's copy of benchmarks/sim_bench.py
# ---------------------------------------------------------------------------

def test_chip_smoke_sim_bench_constants_are_the_bench_s():
    cs = _chip_smoke()
    assert (cs.SCHED_K, cs.SCHED_P) == (sim_bench.K, sim_bench.P)
    assert (cs.SIM_INTRA_BW, cs.SIM_CROSS_BW) == (sim_bench.INTRA_BW,
                                                  sim_bench.CROSS_BW)
    assert list(cs.SIM_FIXED_BASELINES) == sim_bench.FIXED_BASELINES
    assert cs.sim_default_cost(jsim) == sim_bench.DEFAULT_COST
    assert list(TABLE1_GRID) == sim_bench.TABLE1_ROWS


def test_chip_smoke_sim_bench_equals_the_bench_at_smoke():
    """The copy over the port gives ``sim_bench.run(smoke=True)``'s report
    bit for bit (the bench itself running over the JAX package)."""
    cs = _chip_smoke()
    want = sim_bench.run(smoke=True, verbose=False)
    got = cs.sim_bench(np, tsim, tcc, tcosts, SchemeParams, TABLE1_GRID,
                       smoke=True)
    assert got == want
    assert all(got["scheduler_beats_fixed_coded"].values())


def test_bench_diff_flags_every_kind_of_difference():
    cs = _chip_smoke()
    want = {"a": [1.0, 2, {"b": True}], "c": "x"}
    assert cs.bench_diff({"a": [1.0 + 1e-15, 2, {"b": True}], "c": "x"},
                         want) == []
    assert cs.bench_diff({"a": [1.0 + 1e-9, 2, {"b": True}], "c": "x"},
                         want)
    assert cs.bench_diff({"a": [1.0, 3, {"b": True}], "c": "x"}, want)
    assert cs.bench_diff({"a": [1.0, 2, {"b": 1}], "c": "x"}, want)
    assert cs.bench_diff({"a": [1.0, 2], "c": "x"}, want)
    assert cs.bench_diff({"a": [1.0, 2, {"b": True}]}, want)
