"""repro_torch.placement — locality-aware placement engine (paper Section
IV), the counterpart of the JAX package's ``repro.placement``.

The layer between the closed-form core and the simulator: general-r
locality objectives over incidence matrices (:mod:`.objectives`), a
registry of assignment solvers from the random baseline to an exact
min-cost-flow and a torch annealer on the card (:mod:`.solvers`),
resolvable-design structured replica placements (:mod:`.structured`),
alternating joint optimization of replicas and assignment (:mod:`.joint`),
multi-trial Table II drivers (:mod:`.experiments`), and the bridge that
feeds any solved placement into :class:`repro_torch.sim.ClusterSim` as fetch
traffic + map-phase imbalance (:mod:`.sim_bridge`).  Everything but the
annealer is host NumPy: the problem is small by nature (C is at most
N x G floats, 1680 x 24 at the paper's Table I row).
"""
from .objectives import (NonLocalLoad, group_servers, locality_incidence,
                         locality_matrix, locality_of_perm,
                         map_load_imbalance, map_work_factors, n_groups,
                         nonlocal_load, perm_objective, place_replicas,
                         replica_incidence)
from .solvers import (SOLVERS, PlacementResult, anneal_perm, flow_perm,
                      get_solver, greedy_perm, groups_to_perm,
                      local_search_perm, random_perm, register_solver,
                      solve, solve_all, solver_rng)
from .structured import (STRUCTURED_POLICIES, replica_load, storage_balance,
                         structured_replicas)
from .joint import JointResult, joint_optimize, replicate_for_assignment
from .experiments import (DEFAULT_SOLVERS, LocalityResult, SolverTrialStats,
                          Table2Trials, table2_experiment, table2_trials)
from .sim_bridge import (PlacementTraffic, jct_gap, placement_traffic,
                         simulate_placement, traffic_for_result)

__all__ = [
    "NonLocalLoad", "group_servers", "locality_incidence", "locality_matrix",
    "locality_of_perm", "map_load_imbalance", "map_work_factors", "n_groups",
    "nonlocal_load", "perm_objective", "place_replicas", "replica_incidence",
    "SOLVERS", "PlacementResult", "anneal_perm", "flow_perm", "get_solver",
    "greedy_perm", "groups_to_perm", "local_search_perm", "random_perm",
    "register_solver", "solve", "solve_all", "solver_rng",
    "STRUCTURED_POLICIES", "replica_load", "storage_balance",
    "structured_replicas",
    "JointResult", "joint_optimize", "replicate_for_assignment",
    "DEFAULT_SOLVERS", "LocalityResult", "SolverTrialStats", "Table2Trials",
    "table2_experiment", "table2_trials",
    "PlacementTraffic", "jct_gap", "placement_traffic", "simulate_placement",
    "traffic_for_result",
]
