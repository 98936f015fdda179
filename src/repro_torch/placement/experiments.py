"""Table II drivers: multi-trial solver comparisons with mean ± std (the
counterpart of the JAX package's ``placement/experiments.py``, same draws).

The paper's Table II averages over random replica-placement instances; the
original ``table2_experiment`` drew its trials from one rng stream and
reported bare means.  :func:`table2_trials` keeps that exact draw sequence
(replicas, then the random baseline permutation, per trial — so the legacy
numbers are reproduced bit-for-bit) while running EVERY registered solver
per trial from independently spawned child rngs, and reporting mean AND
std so Table II comparisons stop being single-draw noise.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..core.params import SchemeParams
from .objectives import (locality_matrix, locality_of_perm, perm_objective,
                         place_replicas)
from .solvers import PlacementResult, random_perm, solve, solver_rng

DEFAULT_SOLVERS = ("random", "greedy", "flow", "local_search", "anneal")


@dataclasses.dataclass(frozen=True)
class SolverTrialStats:
    """Per-solver aggregate over trials (localities in [0, 1])."""
    solver: str
    node_mean: float
    node_std: float
    rack_mean: float
    rack_std: float
    objective_mean: float
    wall_s_mean: float

    def as_dict(self) -> Dict[str, float]:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class Table2Trials:
    """All trials of one Table II row: per-solver stats + raw results."""
    params: SchemeParams
    lam: float
    n_trials: int
    stats: Dict[str, SolverTrialStats]
    trials: List[Dict[str, PlacementResult]]   # [n_trials][solver]


def table2_trials(p: SchemeParams, lam: float = 0.8, seed: int = 0,
                  n_trials: int = 5, policy: str = "uniform",
                  solvers: Sequence[str] = DEFAULT_SOLVERS,
                  per_solver_kwargs: Optional[Dict[str, Dict]] = None,
                  ) -> Table2Trials:
    """Run ``n_trials`` independent replica-placement instances and every
    solver in ``solvers`` on each.

    Draw-order contract: per trial, ``place_replicas`` then one
    ``rng.permutation`` (the random baseline) are drawn from the MASTER rng
    — exactly the legacy ``table2_experiment`` sequence, so 'random',
    'greedy' and 'flow' reproduce its historical numbers exactly.  All
    other solvers consume child rngs keyed on (seed, trial, solver NAME)
    via :func:`repro_torch.placement.solvers.solver_rng`, so adding,
    removing or reordering solvers never perturbs the rest.
    """
    rng = np.random.default_rng(seed)
    kw = per_solver_kwargs or {}
    trials: List[Dict[str, PlacementResult]] = []
    for trial in range(n_trials):
        replicas = place_replicas(p, rng, policy)
        C = locality_matrix(p, replicas, lam)
        rp = random_perm(p, rng)        # master-stream draw (legacy order)
        row: Dict[str, PlacementResult] = {}
        for name in solvers:
            if name == "random":
                t0 = time.perf_counter()
                row[name] = _scored(p, replicas, rp, "random", lam, C,
                                    time.perf_counter() - t0)
            else:
                row[name] = solve(p, replicas, name, lam,
                                  rng=solver_rng(seed, name, trial), C=C,
                                  **kw.get(name, {}))
        trials.append(row)

    stats = {}
    for name in solvers:
        rs = [t[name] for t in trials]
        stats[name] = SolverTrialStats(
            name,
            float(np.mean([r.node_locality for r in rs])),
            float(np.std([r.node_locality for r in rs])),
            float(np.mean([r.rack_locality for r in rs])),
            float(np.std([r.rack_locality for r in rs])),
            float(np.mean([r.objective for r in rs])),
            float(np.mean([r.wall_s for r in rs])))
    return Table2Trials(p, lam, n_trials, stats, trials)


def _scored(p: SchemeParams, replicas: np.ndarray, perm: np.ndarray,
            solver: str, lam: float, C: np.ndarray,
            wall: float) -> PlacementResult:
    node, rack = locality_of_perm(p, replicas, perm)
    return PlacementResult(p, replicas, np.asarray(perm), solver, lam,
                           perm_objective(p, C, perm), node, rack, wall)


# ---------------------------------------------------------------------------
# Legacy Table II driver (repro_torch.core.locality re-exports these)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class LocalityResult:
    node_random: float
    rack_random: float
    node_opt: float
    rack_opt: float
    node_greedy: float
    rack_greedy: float
    # mean ± std upgrade: stds of the same six quantities (0.0 for trials=1)
    node_random_std: float = 0.0
    rack_random_std: float = 0.0
    node_opt_std: float = 0.0
    rack_opt_std: float = 0.0
    node_greedy_std: float = 0.0
    rack_greedy_std: float = 0.0


def table2_experiment(p: SchemeParams, lam: float = 0.8, seed: int = 0,
                      trials: int = 5, policy: str = "uniform",
                      solver: str = "optimal") -> LocalityResult:
    """Run Table II's comparison for one row, averaged over ``trials``
    random replica placements (now also reporting per-metric std).  The
    historical mean fields are bit-identical to the pre-registry
    implementation."""
    opt_name = "flow" if solver == "optimal" else "greedy"
    res = table2_trials(p, lam, seed, trials, policy,
                        solvers=("random", opt_name, "greedy")
                        if opt_name != "greedy" else ("random", "greedy"))
    s_ran = res.stats["random"]
    s_opt = res.stats[opt_name]
    s_grd = res.stats["greedy"]
    return LocalityResult(
        s_ran.node_mean, s_ran.rack_mean, s_opt.node_mean, s_opt.rack_mean,
        s_grd.node_mean, s_grd.rack_mean,
        s_ran.node_std, s_ran.rack_std, s_opt.node_std, s_opt.rack_std,
        s_grd.node_std, s_grd.rack_std)
