"""The port's resilience policies (``repro_torch.resilience``: speculation,
straggler-aware replication, the frontier experiments) against the JAX
package's on the same inputs: each speculation policy's single-job
``JobStats`` and trace on the port's and the JAX simulator, the policy
registry, ``fit_straggler_model``, ``HedgedRPolicy.observe`` and
``placement_for``, one Table I row of the cloning-vs-coding frontier cell
for cell with its curves and invariants, and ``hedged_vs_static_stream``
at ``benchmarks/resilience_bench.py``'s ``--smoke`` size through
``chip_smoke.py``'s copy of the bench's settings.

Tolerance: exact equality (the same float64 NumPy and Python arithmetic
in the same order)."""
import dataclasses
import importlib.util
import pathlib

import numpy as np
import pytest

from benchmarks import resilience_bench
from repro import resilience as jres
from repro import sim as jsim
from repro.core import coded_collectives as jcc
from repro.core import degraded as jdeg
from repro.core.params import SchemeParams as JParams
from repro.obs import metrics as jmetrics
from repro_torch import resilience as tres
from repro_torch import sim as tsim
from repro_torch.core import coded_collectives as tcc
from repro_torch.core import degraded as tdeg
from repro_torch.core.params import SchemeParams
from repro_torch.obs import metrics as tmetrics

ROOT = pathlib.Path(__file__).resolve().parents[1]
T = (tsim, tres, tcc, SchemeParams)
J = (jsim, jres, jcc, JParams)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def _fresh_state():
    for mod in (tcc, jcc):
        mod.plan_cache_clear()
    for mod in (tdeg, jdeg):
        mod.degraded_cache_clear()
    for mod in (tmetrics, jmetrics):
        mod.registry().clear()
    yield
    for mod in (tcc, jcc):
        mod.plan_cache_clear()


def _run(sim):
    return {"stats": [dataclasses.asdict(s) for s in sim.stats],
            "trace": [dataclasses.astuple(e) for e in sim.tracer.events],
            "legacy": list(sim.trace), "now": sim.now}


# ---------------------------------------------------------------------------
# Speculation policies on one job
# ---------------------------------------------------------------------------

def test_policy_registry_equal_jax():
    assert sorted(tres.SPECULATION_POLICIES) == \
        sorted(jres.SPECULATION_POLICIES)
    for name in tres.SPECULATION_POLICIES:
        t, j = tres.get_policy(name), jres.get_policy(name)
        assert t.name == name and type(t).__name__ == type(j).__name__
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert [t.backup_budget(n) for n in (1, 7, 64)] == \
            [j.backup_budget(n) for n in (1, 7, 64)]
    for m in (tres, jres):
        with pytest.raises(ValueError, match="unknown speculation policy"):
            m.get_policy("dolly++")


def _single(m, policy, stragglers, seed, tasks_per_server, scheme, r,
            **kw):
    sim_mod, res = m[0], m[1]
    topo = sim_mod.RackTopology(P=4, cross_bw=1e4, intra_bw=1e5)
    cost = sim_mod.CostModel(map=sim_mod.PhaseCoeffs(1e-4, 1e-6),
                             pack=sim_mod.PhaseCoeffs(5e-5, 1e-7),
                             reduce=sim_mod.PhaseCoeffs(1e-4, 1e-7))
    model = {"exp": sim_mod.ExponentialTail(1.0),
             "rack": sim_mod.RackCorrelated(0.3, 4.0),
             "fixed": sim_mod.DeterministicSlowdown(
                 (1.0, 6.0, 1.0, 1.0, 1.0, 2.5, 1.0, 1.0)),
             "none": None}[stragglers]
    sim = sim_mod.ClusterSim(topo, 8, cost, model, seed)
    pol = res.get_policy(policy, tasks_per_server=tasks_per_server, **kw)
    sim.submit(sim_mod.JobSpec("histogram", 48, 16, 2), scheme, r,
               time=0.0, speculation=pol, check=False)
    sim.run()
    return _run(sim)


@pytest.mark.parametrize("policy,kw", [
    ("none", {}), ("clone", {"n_clones": 1}), ("clone", {"n_clones": 2}),
    ("late", {}), ("mantri", {})], ids=["none", "clone1", "clone2", "late",
                                        "mantri"])
@pytest.mark.parametrize("stragglers", ["exp", "rack", "fixed", "none"])
@pytest.mark.parametrize("tasks_per_server", [None, 2])
def test_speculation_single_job_equal_jax(policy, kw, stragglers,
                                          tasks_per_server):
    t, j = (_single(m, policy, stragglers, 3, tasks_per_server, "hybrid",
                    2, **kw) for m in (T, J))
    assert t == j
    (s,) = t["stats"]
    assert s["speculation"] == policy


@pytest.mark.parametrize("scheme,r", [("uncoded", 1), ("coded", 2),
                                      ("hybrid", 3)])
@pytest.mark.parametrize("policy", ["late", "mantri"])
def test_speculation_schemes_equal_jax(scheme, r, policy):
    t, j = (_single(m, policy, "exp", 11, None, scheme, r)
            for m in (T, J))
    assert t == j


def test_speculation_with_crash_equal_jax():
    def build(m):
        topo = m[0].RackTopology(P=4, cross_bw=1e4, intra_bw=1e5)
        cost = m[0].CostModel(map=m[0].PhaseCoeffs(1e-4, 1e-6))
        sim = m[0].ClusterSim(topo, 8, cost, m[0].ExponentialTail(1.0), 5,
                              speculation=m[1].get_policy("late"))
        sim.submit(m[0].JobSpec("histogram", 48, 16, 1), "hybrid", 2,
                   time=0.0)
        sim.inject_crash(0.002, (3,))
        sim.run()
        return _run(sim)
    assert build(T) == build(J)


# ---------------------------------------------------------------------------
# Straggler fitting and the hedged r-policy
# ---------------------------------------------------------------------------

def _slowdowns(kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "none":
        return (1.0 + 0.02 * rng.random(30)).tolist()
    if kind == "exp":
        return (1.0 + rng.exponential(0.5, size=(200, 16)).max(1)).tolist()
    if kind == "rack":
        return np.where(rng.random(200) < 0.5, 4.0, 1.0).tolist()
    return []


@pytest.mark.parametrize("kind", ["none", "exp", "rack", "empty"])
@pytest.mark.parametrize("K,P", [(16, 4), (9, 3)])
def test_fit_straggler_model_equal_jax(kind, K, P):
    obs = _slowdowns(kind, 1)
    t = tres.fit_straggler_model(obs, K=K, P=P)
    j = jres.fit_straggler_model(obs, K=K, P=P)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.expected_barrier_factor(K, P) == \
        j.expected_barrier_factor(K, P)
    for m in (tres, jres):
        with pytest.raises(ValueError, match="unknown fit kind"):
            m.StragglerFit("bimodal")


def test_hedged_policy_observe_equal_jax():
    class Stats:
        def __init__(self, t):
            self.phase_times = {"map": t}
    out = []
    for res in (tres, jres):
        rp = res.HedgedRPolicy(8, 4, window=6, refit_every=3,
                               hedge_placement=False)
        fits = []
        for t, e in zip((4.0, 1.0, 4.2, 0.5, 1.1, 4.0, 3.9, 1.0, 1.0),
                        (1.0, 1.0, 1.0, 0.0, 1.0, 1.0, 1.0, 1.0, 1.0)):
            rp.observe(Stats(t), expected_map_s=e)
            fits.append(dataclasses.asdict(rp.fit))
        rp.observe(object(), 1.0)                  # no phase_times: skipped
        out.append((fits, list(rp.window),
                    [rp.compute_inflation("hybrid", r) for r in (1, 2, 3)],
                    rp.placement_for(JParams(8, 4, 16, 48, 2, r_f=3))))
    assert out[0] == out[1]
    assert out[0][0][-1]["kind"] == "rack" and out[0][3] is None


@pytest.mark.parametrize("solver", ["greedy", "flow", "local_search"])
@pytest.mark.parametrize("policy", ["resolvable", "aligned"])
@pytest.mark.parametrize("N,r", [(48, 2), (96, 3)])
def test_hedged_placement_for_equal_jax(solver, policy, N, r):
    t = tres.HedgedRPolicy(8, 4, placement_solver=solver,
                           placement_policy=policy, placement_seed=2)
    j = jres.HedgedRPolicy(8, 4, placement_solver=solver,
                           placement_policy=policy, placement_seed=2)
    tp, jp = SchemeParams(8, 4, 16, N, r, r_f=3), JParams(8, 4, 16, N, r,
                                                          r_f=3)
    a, b = t.placement_for(tp, 4), j.placement_for(jp, 4)
    assert (a is None) == (b is None)
    if a is not None:
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        assert t.placement_for(tp, 4) is a                    # cached


def test_slowdowns_from_stats_equal_jax():
    class Stats:
        def __init__(self, t):
            self.phase_times = {} if t is None else {"map": t}
    stats = [Stats(t) for t in (2.0, None, 0.5, 3.0)]
    exp = [1.0, 1.0, 1.0, 0.0]
    assert tres.slowdowns_from_stats(stats, exp) == \
        jres.slowdowns_from_stats(stats, exp) == [2.0, 1.0]


# ---------------------------------------------------------------------------
# The frontier and the hedged stream
# ---------------------------------------------------------------------------

def test_frontier_row_equal_jax_cell_for_cell():
    """The first Table I row at the bench's settings, 3 seeds a cell."""
    cs = _chip_smoke()
    t = cs.resilience_frontier(tres, tsim, tres.TABLE1_ROWS[:1], 3)
    j = cs.resilience_frontier(jres, jsim, jres.TABLE1_ROWS[:1], 3)
    assert [c.to_row() for c in t] == [c.to_row() for c in j]
    assert len(t) == 3 * 3 * 4
    assert tres.check_frontier_invariants(t) == \
        jres.check_frontier_invariants(j)
    for regime in ("none", "exp_tail", "rack"):
        assert tres.frontier_curve(t, regime) == \
            jres.frontier_curve(j, regime)


def test_chip_smoke_resilience_constants_are_the_bench_s():
    cs = _chip_smoke()
    assert cs.res_bench_cost(jsim) == resilience_bench.BENCH_COST
    assert (cs.RES_INTRA_BW, cs.RES_CROSS_BW) == (resilience_bench.INTRA_BW,
                                                  resilience_bench.CROSS_BW)
    assert tres.TABLE1_ROWS == jres.TABLE1_ROWS
    assert tres.DEFAULT_POLICIES == jres.DEFAULT_POLICIES


def test_chip_smoke_hedged_vs_static_equal_jax_at_smoke():
    """``chip_smoke.py``'s ``hedged_vs_static`` over the port equals the
    JAX package's ``hedged_vs_static_stream`` called with
    ``resilience_bench.run``'s settings at ``--smoke``."""
    cs = _chip_smoke()
    got = cs.resilience_hedged(tres, tsim, tcc, smoke=True)
    jcc.plan_cache_clear()
    want = jres.hedged_vs_static_stream(
        K=8, P=4, stragglers=jsim.RackCorrelated(0.25, 4.0),
        cost=resilience_bench.BENCH_COST, intra_bw=1e6, cross_bw=1e5,
        rate=4.0, n_jobs=30, n_probe=15, seed=0)
    assert got == want
    assert got["hedged_beats_static_p99"]


def test_chip_smoke_resilience_determinism_equal_jax():
    cs = _chip_smoke()
    assert cs.resilience_determinism(tres, tsim)
    assert resilience_bench._determinism_check()
