"""Section IV — data-locality-aware Map-task assignment (compat facade).

The locality layer lives in the :mod:`repro_torch.placement` subsystem —
general-r objectives, a solver registry (random / greedy / flow /
local_search / anneal), structured replica placements, joint
replica+assignment optimization and a simulator bridge.  This module keeps
the Section-IV API importable from ``repro_torch.core.locality``:
every name below is a re-export, and ``optimal_perm`` is the registry's
``flow`` solver (min-cost max-flow, exact for Theorem IV.1).
"""
from __future__ import annotations

from ..placement.experiments import (LocalityResult, table2_experiment,
                                     table2_trials)
from ..placement.objectives import (group_servers, locality_incidence,
                                    locality_matrix, locality_of_perm,
                                    place_replicas)
from ..placement.solvers import (flow_perm, greedy_perm, groups_to_perm,
                                 random_perm)

# historical names
optimal_perm = flow_perm
_groups_to_perm = groups_to_perm
_locality_incidence = locality_incidence

__all__ = [
    "LocalityResult", "table2_experiment", "table2_trials", "group_servers",
    "locality_incidence", "locality_matrix", "locality_of_perm",
    "place_replicas", "flow_perm", "greedy_perm", "groups_to_perm",
    "random_perm", "optimal_perm",
]
