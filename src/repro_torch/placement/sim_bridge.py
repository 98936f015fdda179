"""Bridge from placement results into the cluster simulator.

Turns Table II's locality PERCENTAGES into JCT TIME (the ROADMAP's "Table II
in time units"): a solved placement becomes

  * **fetch traffic** — every non-local map input must be read over the
    network before the map phase: a (subfile, mapping-server) pair with a
    replica in the server's rack but not on the server costs one intra-rack
    transfer through that rack's ToR; a pair with no replica in the rack
    crosses the root switch.  These flows contend with concurrent jobs'
    shuffles in :class:`repro_torch.sim.network.FluidNetwork` exactly like any
    other traffic (a ``fetch`` stage preceding ``map``).
  * **map-phase imbalance** — a server mapping non-local inputs runs its
    map tasks slower (reads stall behind the fetch pipe); the barrier ends
    at the SLOWEST server, so per-rack locality imbalance shifts the map
    phase time (:func:`repro_torch.placement.objectives.map_work_factors`).

``input_units`` is the network cost of one subfile's raw input in the
fluid network's value-units.  The default ``None`` uses Q * d — the size of
one subfile's INTERMEDIATE values, i.e. a map whose output is as large as
its input; pass the real ratio to skew it.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np

from ..core.params import SchemeParams
from ..sim.cluster import ClusterSim, CostModel, JobStats, StragglerModel
from ..sim.network import RackTopology
from ..sim.workload import JobSpec
from .objectives import locality_of_perm, map_work_factors, nonlocal_load
from .solvers import PlacementResult


@dataclasses.dataclass(frozen=True)
class PlacementTraffic:
    """What the simulator needs to know about one placement: pre-map fetch
    loads (value-units) and per-server map slowdown factors.  Consumed by
    ``ClusterSim.submit(placement=...)``."""
    cross_units: float                      # root-switch fetch load
    intra_units_per_rack: Tuple[float, ...]  # per-ToR fetch load, [P]
    map_factors: Tuple[float, ...]          # per-server map work factor, [K]
    node_locality: float
    rack_locality: float

    @property
    def total_units(self) -> float:
        return self.cross_units + sum(self.intra_units_per_rack)


def placement_traffic(p: SchemeParams, replicas: np.ndarray,
                      perm: Sequence[int],
                      input_units: Optional[float] = None,
                      remote_penalty: float = 0.5) -> PlacementTraffic:
    """Compile a (replicas, perm) placement into :class:`PlacementTraffic`.

    Fully local placements (node locality 1.0) produce zero fetch traffic
    and unit map factors — the sim job then runs exactly as an un-bridged
    submission."""
    if input_units is None:
        input_units = float(p.Q)    # one subfile's intermediate size at d=1;
        # use traffic_for_result (or pass input_units) to scale by a job's d
    load = nonlocal_load(p, replicas, perm)
    racks = np.arange(p.K) // p.Kr
    intra = np.zeros(p.P)
    np.add.at(intra, racks, load.intra_fetch * float(input_units))
    cross = float(load.rack_miss.sum()) * float(input_units)
    node, rack = locality_of_perm(p, replicas, perm)
    factors = map_work_factors(p, replicas, perm, remote_penalty)
    return PlacementTraffic(cross, tuple(intra.tolist()),
                            tuple(factors.tolist()), node, rack)


def traffic_for_result(result: PlacementResult, d: int = 1,
                       remote_penalty: float = 0.5) -> PlacementTraffic:
    """:class:`PlacementTraffic` of a solved :class:`PlacementResult`,
    scaling one subfile's input to Q * d value-units."""
    p = result.params
    return placement_traffic(p, result.replicas, result.perm,
                             input_units=float(p.Q * d),
                             remote_penalty=remote_penalty)


def simulate_placement(result: PlacementResult, topology: RackTopology,
                       spec: Optional[JobSpec] = None,
                       cost_model: CostModel = CostModel(),
                       stragglers: Optional[StragglerModel] = None,
                       seed: int = 0, d: int = 1,
                       remote_penalty: float = 0.5,
                       check: bool = True) -> JobStats:
    """Single hybrid job on an empty cluster under ``result``'s placement —
    the Table-II-in-time-units primitive.  ``spec`` defaults to a job sized
    exactly by the placement's SchemeParams."""
    p = result.params
    if spec is None:
        spec = JobSpec("placement_probe", p.N, p.Q, d)
    sim = ClusterSim(topology, p.K, cost_model, stragglers, seed)
    sim.submit(spec, "hybrid", p.r, time=spec.arrival, check=check,
               placement=traffic_for_result(result, spec.d, remote_penalty))
    (stats,) = sim.run()
    return stats


def jct_gap(opt: PlacementResult, ran: PlacementResult,
            topology: RackTopology, cost_model: CostModel = CostModel(),
            d: int = 1, remote_penalty: float = 0.5,
            seed: int = 0) -> Tuple[float, float]:
    """(jct_random, jct_optimized) of two placements of the SAME instance
    under identical simulator settings — what 64% vs 10% node locality buys
    in seconds."""
    j_ran = simulate_placement(ran, topology, cost_model=cost_model,
                               seed=seed, d=d,
                               remote_penalty=remote_penalty).jct
    j_opt = simulate_placement(opt, topology, cost_model=cost_model,
                               seed=seed, d=d,
                               remote_penalty=remote_penalty).jct
    return j_ran, j_opt
