"""The port's placement engine (``repro_torch.placement`` and the facade
``repro_torch.core.locality``) against the JAX package's ``repro.placement``
on the same seeded NumPy inputs: replica draws, the locality objectives, the
four NumPy solvers, structured and joint placement, the Table II drivers
(also against the committed ``BENCH_locality.json``), the sim bridge, and
the annealer's invariants on the CPU.

Tolerance: exact equality (``==`` on floats, ``np.array_equal`` on arrays)
everywhere except the annealer, whose chains draw from ``torch.Generator``
instead of ``jax.random``: it is held to its invariants (a valid
permutation, an objective >= every warm start's, the flow warm start
returned exactly, one result per seed) and to the caller's NumPy stream
after the call, which equals the JAX function's."""
import dataclasses
import json
import pathlib

import numpy as np
import pytest
import torch

from repro.core.params import SchemeParams as JParams
from repro import placement as jpl
from repro.core import locality as jloc
from repro.sim import CostModel as JCost
from repro.sim import PhaseCoeffs as JCoeffs
from repro.sim import RackTopology as JTopo
from repro_torch import placement as tpl
from repro_torch.core import locality as tloc
from repro_torch.core.assignment import (check_hybrid_constraints,
                                         hybrid_assignment,
                                         hybrid_group_of_slot)
from repro_torch.core.params import SchemeParams
from repro_torch.placement import solvers as tsolvers
from repro_torch.sim import CostModel, PhaseCoeffs, RackTopology

BENCH = json.loads((pathlib.Path(__file__).resolve().parents[1]
                    / "BENCH_locality.json").read_text())

# (K, P, r_f, N): the smallest Table II rows (Q = K, r = 2, as the
# benchmark builds them), then r = 3 and r_f = 4 instances
ROWS = [(8, 2, 3, 100), (9, 3, 3, 90), (21, 3, 2, 84), (10, 5, 2, 100)]
EXTRA = [SchemeParams(16, 4, 16, 96, 2, r_f=2),
         SchemeParams(12, 3, 24, 96, 3, r_f=3),
         SchemeParams(8, 4, 16, 48, 2, r_f=4)]


def _params(row, r=2):
    K, P, r_f, N = row
    return SchemeParams(K=K, P=P, Q=K, N=N, r=r, r_f=r_f)


def _jparams(p: SchemeParams) -> JParams:
    return JParams(**dataclasses.asdict(p))


INSTANCES = [_params(row) for row in ROWS] + EXTRA
IDS = [f"K{p.K}P{p.P}N{p.N}r{p.r}rf{p.r_f}" for p in INSTANCES]


def _assert_result_equal(t, j):
    """A port PlacementResult equals a JAX one field by field (wall_s
    aside: it is a clock reading)."""
    assert dataclasses.asdict(t.params) == dataclasses.asdict(j.params)
    assert np.array_equal(t.replicas, j.replicas)
    assert np.array_equal(t.perm, j.perm)
    assert (t.solver, t.lam, t.objective, t.node_locality,
            t.rack_locality) == (j.solver, j.lam, j.objective,
                                 j.node_locality, j.rack_locality)


# ---------------------------------------------------------------------------
# Objectives
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("policy", ["uniform", "hdfs"])
@pytest.mark.parametrize("p", INSTANCES, ids=IDS)
def test_place_replicas_same_draws(p, policy, seed):
    rt, rj = np.random.default_rng(seed), np.random.default_rng(seed)
    t = tpl.place_replicas(p, rt, policy)
    j = jpl.place_replicas(_jparams(p), rj, policy)
    assert t.dtype == j.dtype and np.array_equal(t, j)
    assert rt.integers(2 ** 62) == rj.integers(2 ** 62)    # same stream


@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("p", INSTANCES, ids=IDS)
def test_objectives_equal_jax(p, seed):
    jp = _jparams(p)
    rng = np.random.default_rng(seed)
    replicas = jpl.place_replicas(jp, rng)
    perm = rng.permutation(p.N)
    assert tpl.group_servers(p) == jpl.group_servers(jp)
    assert tpl.n_groups(p) == jpl.n_groups(jp)
    for a, b in zip(tpl.replica_incidence(p, replicas),
                    jpl.replica_incidence(jp, replicas)):
        assert np.array_equal(a, b)
    for a, b in zip(tpl.locality_incidence(p, replicas),
                    jpl.locality_incidence(jp, replicas)):
        assert np.array_equal(a, b)
    for lam in (0.8, 1.0):
        C = tpl.locality_matrix(p, replicas, lam)
        assert np.array_equal(C, jpl.locality_matrix(jp, replicas, lam))
        assert tpl.perm_objective(p, C, perm) == \
            jpl.perm_objective(jp, C, perm)
    assert tpl.locality_of_perm(p, replicas, perm) == \
        jpl.locality_of_perm(jp, replicas, perm)
    t, j = (tpl.nonlocal_load(p, replicas, perm),
            jpl.nonlocal_load(jp, replicas, perm))
    assert np.array_equal(t.node_miss, j.node_miss)
    assert np.array_equal(t.rack_miss, j.rack_miss)
    assert np.array_equal(t.intra_fetch, j.intra_fetch)
    assert t.n_loc == j.n_loc
    for pen in (0.0, 0.5, 2.0):
        assert np.array_equal(tpl.map_work_factors(p, replicas, perm, pen),
                              jpl.map_work_factors(jp, replicas, perm, pen))
        assert tpl.map_load_imbalance(p, replicas, perm, pen) == \
            jpl.map_load_imbalance(jp, replicas, perm, pen)


def test_locality_matrix_rejects_lam_like_jax():
    p = INSTANCES[0]
    replicas = tpl.place_replicas(p, np.random.default_rng(0))
    for lam in (0.5, 1.2):
        with pytest.raises(ValueError):
            tpl.locality_matrix(p, replicas, lam)
        with pytest.raises(ValueError):
            jpl.locality_matrix(_jparams(p), replicas, lam)


# ---------------------------------------------------------------------------
# Solvers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("solver", ["random", "greedy", "flow",
                                    "local_search"])
@pytest.mark.parametrize("p", INSTANCES, ids=IDS)
def test_numpy_solvers_give_jax_permutation(p, solver):
    replicas = jpl.place_replicas(_jparams(p), np.random.default_rng(1))
    t = tpl.solve(p, replicas, solver, seed=4)
    j = jpl.solve(_jparams(p), replicas, solver, seed=4)
    _assert_result_equal(t, j)
    check_hybrid_constraints(hybrid_assignment(p, t.perm.tolist()))


def test_local_search_from_a_warm_start_and_groups_to_perm_equal():
    p = EXTRA[0]
    jp = _jparams(p)
    replicas = jpl.place_replicas(jp, np.random.default_rng(2))
    C = jpl.locality_matrix(jp, replicas)
    init = np.random.default_rng(9).permutation(p.N)
    rt, rj = np.random.default_rng(6), np.random.default_rng(6)
    assert np.array_equal(
        tpl.local_search_perm(p, C, rt, init=init, max_sweeps=7, batch=64),
        jpl.local_search_perm(jp, C, rj, init=init, max_sweeps=7, batch=64))
    assert rt.integers(2 ** 62) == rj.integers(2 ** 62)
    groups = np.repeat(np.arange(tpl.n_groups(p)), p.M)
    np.random.default_rng(1).shuffle(groups)
    assert np.array_equal(tpl.groups_to_perm(p, groups),
                          jpl.groups_to_perm(jp, groups))


def test_solver_rng_and_registry():
    for seed, name, trial in [(0, "flow", 0), (3, "anneal", 2),
                              (7, "local_search", 4)]:
        assert tpl.solver_rng(seed, name, trial).integers(2 ** 62) == \
            jpl.solver_rng(seed, name, trial).integers(2 ** 62)
    assert set(tpl.SOLVERS) == {"random", "greedy", "flow", "local_search",
                                "anneal"}
    assert tpl.DEFAULT_SOLVERS == ("random", "greedy", "flow",
                                   "local_search", "anneal")
    assert tpl.get_solver("anneal") is tpl.SOLVERS["anneal"]
    with pytest.raises(ValueError, match="unknown solver"):
        tpl.get_solver("anneal_jax")


def test_solve_all_every_solver_valid_on_cpu():
    p = EXTRA[0]
    replicas = tpl.place_replicas(p, np.random.default_rng(0))
    res = tpl.solve_all(p, replicas, per_solver_kwargs={
        "anneal": {"device": "cpu", "n_chains": 8, "n_steps": 100}})
    assert list(res) == list(tpl.DEFAULT_SOLVERS)
    for r in res.values():
        assert sorted(r.perm.tolist()) == list(range(p.N))
        check_hybrid_constraints(hybrid_assignment(p, r.perm.tolist()))
    assert res["anneal"].objective >= res["greedy"].objective
    assert "anneal:" in res["anneal"].summary()


# ---------------------------------------------------------------------------
# The annealer (torch; CPU here, the card in test_torch_placement_cuda.py)
# ---------------------------------------------------------------------------

def _anneal_instance(p=EXTRA[0], seed=0):
    replicas = tpl.place_replicas(p, np.random.default_rng(seed))
    return p, replicas, tpl.locality_matrix(p, replicas)


def test_anneal_invariants_on_cpu():
    p, _, C = _anneal_instance()
    warm = [tpl.greedy_perm(p, C),
            np.random.default_rng(4).permutation(p.N)]
    out = tpl.anneal_perm(p, C, np.random.default_rng(2), n_chains=8,
                          n_steps=150, init=warm, device="cpu")
    assert sorted(out.tolist()) == list(range(p.N))
    check_hybrid_constraints(hybrid_assignment(p, out.tolist()))
    obj = tpl.perm_objective(p, C, out)
    assert all(obj >= tpl.perm_objective(p, C, w) for w in warm)
    again = tpl.anneal_perm(p, C, np.random.default_rng(2), n_chains=8,
                            n_steps=150, init=warm, device="cpu")
    assert np.array_equal(out, again)               # same seed, same device


def test_anneal_flow_warm_start_returned_exactly():
    p, _, C = _anneal_instance(seed=1)
    flow = tpl.flow_perm(p, C)
    out = tpl.anneal_perm(p, C, np.random.default_rng(0), n_chains=8,
                          n_steps=100, init_solvers=("flow", "greedy"),
                          device="cpu")
    assert np.array_equal(out, flow)
    assert np.array_equal(flow, jpl.flow_perm(_jparams(p), C))


def test_anneal_beats_random_starts_and_leaves_jax_rng_stream():
    """No warm start worth keeping: the chains must climb.  After the call
    the caller's generator is where the JAX annealer leaves it (random base
    permutations, then one integer for the device seed)."""
    p, _, C = _anneal_instance(seed=2)
    rt, rj = np.random.default_rng(11), np.random.default_rng(11)
    bad = np.argsort(-C[:, 0], kind="stable")        # a poor start
    t = tpl.anneal_perm(p, C, rt, n_chains=6, n_steps=400, init=[bad],
                        device="cpu")
    j = jpl.anneal_perm(_jparams(p), C, rj, n_chains=6, n_steps=2,
                        init=[bad])
    assert rt.integers(2 ** 62) == rj.integers(2 ** 62)
    assert tpl.perm_objective(p, C, t) > tpl.perm_objective(p, C, bad)
    assert sorted(j.tolist()) == list(range(p.N))


def test_anneal_chains_track_best_and_move_on_the_generator():
    p, _, C = _anneal_instance()
    gen = torch.Generator().manual_seed(5)
    base = torch.as_tensor(np.stack([np.random.default_rng(k).permutation(
        p.N) for k in range(4)]))
    gos = torch.as_tensor(hybrid_group_of_slot(p), dtype=torch.int64)
    Ct = torch.as_tensor(C, dtype=torch.float32)
    temps = torch.as_tensor(np.geomspace(1.0, 1e-3, 300),
                            dtype=torch.float32)
    start = Ct.reshape(-1).take(base * C.shape[1] + gos).sum(1)
    best = tsolvers.anneal_chains(base.clone(), Ct, gos, temps, gen)
    end = Ct.reshape(-1).take(best * C.shape[1] + gos).sum(1)
    assert (end >= start).all()
    assert (best.sort(dim=1).values == torch.arange(p.N)).all()


def test_anneal_without_device_or_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    p, replicas, C = _anneal_instance()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpl.anneal_perm(p, C, np.random.default_rng(0), n_steps=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpl.solve(p, replicas, "anneal", n_steps=2)


# ---------------------------------------------------------------------------
# Structured, joint
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("policy", ["resolvable", "aligned"])
@pytest.mark.parametrize("p", INSTANCES + [
    SchemeParams(8, 4, 16, 48, 2, r_f=3),
    SchemeParams(12, 3, 24, 96, 2, r_f=1)], ids=IDS + ["rf3", "rf1"])
def test_structured_replicas_equal_jax(p, policy):
    """Equal placements, or the same ValueError where the spare replicas
    of ``aligned`` run out of in-rack slots (r_f - r >= Kr)."""
    jp = _jparams(p)
    try:
        j = jpl.structured_replicas(jp, policy)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e).replace("[", r"\[")
                           .replace("]", r"\]")):
            tpl.structured_replicas(p, policy)
        return
    t = tpl.structured_replicas(p, policy)
    assert np.array_equal(t, j)
    assert np.array_equal(tpl.replica_load(t, p.K),
                          jpl.replica_load(t, p.K))
    assert tpl.storage_balance(t, p.K) == jpl.storage_balance(t, p.K)
    assert tpl.STRUCTURED_POLICIES == jpl.STRUCTURED_POLICIES


def test_structured_rejects_like_jax():
    p = SchemeParams(8, 4, 16, 48, 2, r_f=9)
    for mod, q in ((tpl, p), (jpl, _jparams(p))):
        with pytest.raises(ValueError):
            mod.structured_replicas(q, "resolvable")
        with pytest.raises(ValueError):
            mod.structured_replicas(q, "nope")


@pytest.mark.parametrize("solver,rounds", [("flow", 3), ("greedy", 4)])
def test_joint_optimize_equal_jax(solver, rounds):
    p = EXTRA[0]
    t = tpl.joint_optimize(p, seed=0, solver=solver, rounds=rounds)
    j = jpl.joint_optimize(_jparams(p), seed=0, solver=solver,
                           rounds=rounds)
    assert (t.rounds_run, t.converged) == (j.rounds_run, j.converged)
    _assert_result_equal(t.best, j.best)
    assert len(t.history) == len(j.history)
    for a, b in zip(t.history, j.history):
        _assert_result_equal(a, b)
    perm = np.random.default_rng(3).permutation(p.N)
    assert np.array_equal(
        tpl.replicate_for_assignment(p, perm, t.best.replicas),
        jpl.replicate_for_assignment(_jparams(p), perm, t.best.replicas))


# ---------------------------------------------------------------------------
# Table II drivers, against the JAX package and the committed benchmark
# ---------------------------------------------------------------------------

DET = ("random", "greedy", "flow", "local_search")
STAT_FIELDS = ("node_mean", "node_std", "rack_mean", "rack_std",
               "objective_mean")


def _bench_row(row):
    for key in ("table2", "table2_time_units"):
        (hit,) = [x for x in BENCH[key] if tuple(x["params"]) == row]
        yield hit


@pytest.mark.parametrize("row", ROWS[:3], ids=str)
def test_table2_trials_equal_jax_and_bench(row):
    """The deterministic solvers' stats, and the flow-vs-random JCTs under
    the benchmark's time-units cluster, equal the JAX driver's on the same
    call and ``BENCH_locality.json``'s, bit for bit."""
    p = _params(row)
    kw = {"local_search": {"max_sweeps": 20}}
    t = tpl.table2_trials(p, BENCH["lam"], BENCH["seed"], BENCH["n_trials"],
                          solvers=DET, per_solver_kwargs=kw)
    j = jpl.table2_trials(_jparams(p), BENCH["lam"], BENCH["seed"],
                          BENCH["n_trials"], solvers=DET,
                          per_solver_kwargs=kw)
    bench, bench_time = _bench_row(row)
    for name in DET:
        ts, js = t.stats[name].as_dict(), j.stats[name].as_dict()
        for f in STAT_FIELDS:
            assert ts[f] == js[f] == bench["solvers"][name][f], (name, f)
        for a, b in zip(t.trials, j.trials):
            _assert_result_equal(a[name], b[name])
    cl = BENCH["time_units_cluster"]
    topo = RackTopology(p.P, cross_bw=cl["cross_bw"],
                        intra_bw=cl["intra_bw"])
    cost = CostModel(map=PhaseCoeffs(0.0, cl["map_beta"]))
    jtopo = JTopo(p.P, cross_bw=cl["cross_bw"], intra_bw=cl["intra_bw"])
    jcost = JCost(map=JCoeffs(0.0, cl["map_beta"]))
    ran, opt = [], []
    for a, b in zip(t.trials, j.trials):
        gap = tpl.jct_gap(a["flow"], a["random"], topo, cost_model=cost)
        assert gap == jpl.jct_gap(b["flow"], b["random"], jtopo,
                                  cost_model=jcost)
        ran.append(gap[0])
        opt.append(gap[1])
    assert float(np.mean(ran)) == bench_time["mean_jct_random"]
    assert float(np.mean(opt)) == bench_time["mean_jct_flow"]
    assert float(np.mean(opt)) < float(np.mean(ran))


@pytest.mark.parametrize("solver", ["optimal", "greedy"])
def test_table2_experiment_and_facade_equal_jax(solver):
    p = _params(ROWS[1])
    t = tloc.table2_experiment(p, seed=2, trials=3, solver=solver)
    j = jloc.table2_experiment(_jparams(p), seed=2, trials=3, solver=solver)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert tloc.optimal_perm is tpl.flow_perm
    assert tloc._groups_to_perm is tpl.groups_to_perm
    assert tloc._locality_incidence is tpl.locality_incidence
    assert sorted(tloc.__all__) == sorted(jloc.__all__)


# ---------------------------------------------------------------------------
# The sim bridge
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("solver", ["random", "greedy", "flow"])
def test_sim_bridge_equal_jax(solver):
    """A JAX PlacementResult carried across field by field (SchemeParams
    rebuilt as the port's) bridges to the same traffic and JCT."""
    jp = JParams(16, 4, 16, 192, 2, r_f=3)
    j = jpl.solve(jp, jpl.place_replicas(jp, np.random.default_rng(0)),
                  solver, seed=1)
    fields = {f.name: getattr(j, f.name)
              for f in dataclasses.fields(j) if f.name != "params"}
    t = tpl.PlacementResult(SchemeParams(**dataclasses.asdict(jp)),
                            **fields)
    asdict = dataclasses.asdict
    for d in (1, 4):
        assert asdict(tpl.traffic_for_result(t, d=d)) == \
            asdict(jpl.traffic_for_result(j, d=d))
    assert asdict(tpl.placement_traffic(t.params, t.replicas, t.perm)) == \
        asdict(jpl.placement_traffic(jp, j.replicas, j.perm))
    topo, jtopo = (RackTopology(4, cross_bw=1e4, intra_bw=1e5),
                   JTopo(4, cross_bw=1e4, intra_bw=1e5))
    cost = CostModel(map=PhaseCoeffs(0.0, 1e-8))
    st = tpl.simulate_placement(t, topo, cost_model=cost, d=2)
    sj = jpl.simulate_placement(j, jtopo, cost_model=JCost(
        map=JCoeffs(0.0, 1e-8)), d=2)
    assert dataclasses.asdict(st) == dataclasses.asdict(sj)
    tr = tpl.traffic_for_result(t)
    assert tr.total_units == jpl.traffic_for_result(j).total_units
    with pytest.raises(dataclasses.FrozenInstanceError):
        t.objective = 0.0
    with pytest.raises(dataclasses.FrozenInstanceError):
        st.finish = 0.0
