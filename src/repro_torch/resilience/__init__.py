"""repro_torch.resilience — speculative re-execution + straggler-aware
replication, the counterpart of the JAX package's ``repro.resilience``.

The decision layer ON TOP of the cluster simulator: the paper's map
replication r reduces cross-rack shuffle traffic (coding), but replication
is also the classic straggler weapon (cloning / speculative backups).  This
package quantifies when each use of the budget wins:

  * :mod:`.speculation` — policy registry (``none`` / ``clone`` / ``late``
    / ``mantri``) driving the task-granular map phase of
    :class:`repro_torch.sim.cluster.TaskMapPhase`;
  * :mod:`.replication` — straggler-model fitting from observed
    ``JobStats.phase_times`` and the :class:`HedgedRPolicy` that makes
    :class:`repro_torch.sim.SchemeChooser` straggler-aware (priced
    candidates + rack-hedged structured placements);
  * :mod:`.experiments` — the cloning-vs-coding frontier over the Table I
    grid and the hedged-vs-static stream comparison;
  * :mod:`.faults` — seeded crash schedules (:class:`FaultInjector` /
    :class:`FaultSpec`) driving both the engine's recovery ladder
    (``run_job_distributed(faults=...)``) and the simulator's crash events;
  * :mod:`.backoff` — the shared jittered-exponential restart budget.
"""
from .speculation import (LateBackup, MantriRestart, NoSpeculation,
                          ProactiveClone, SPECULATION_POLICIES,
                          SpeculationPolicy, get_policy, register_policy)
from .replication import (HedgedRPolicy, StragglerFit, fit_straggler_model,
                          slowdowns_from_stats)
from .experiments import (DEFAULT_POLICIES, FrontierCell, TABLE1_ROWS,
                          check_frontier_invariants,
                          cloning_vs_coding_frontier, frontier_curve,
                          hedged_vs_static_stream, straggler_regimes)
from .backoff import BackoffPolicy, RestartBudget, RestartBudgetExceeded
from .faults import CRASH_PHASES, CrashEvent, FaultInjector, FaultSpec

__all__ = [
    "BackoffPolicy", "RestartBudget", "RestartBudgetExceeded",
    "CRASH_PHASES", "CrashEvent", "FaultInjector", "FaultSpec",
    "LateBackup", "MantriRestart", "NoSpeculation", "ProactiveClone",
    "SPECULATION_POLICIES", "SpeculationPolicy", "get_policy",
    "register_policy",
    "HedgedRPolicy", "StragglerFit", "fit_straggler_model",
    "slowdowns_from_stats",
    "DEFAULT_POLICIES", "FrontierCell", "TABLE1_ROWS",
    "check_frontier_invariants", "cloning_vs_coding_frontier",
    "frontier_curve", "hedged_vs_static_stream", "straggler_regimes",
]
