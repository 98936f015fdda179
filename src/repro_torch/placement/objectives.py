"""Section IV objectives as vectorized incidence-matrix functions, general r.

Everything here is a pure function of three one-hot incidence matrices:

  * ``has_server[i, s]`` — subfile i stores a replica on server s   ([N, K])
  * ``has_rack[i, p]``   — subfile i stores a replica in rack p     ([N, P])
  * group membership     — the servers of each (layer, rack-subset)
    structural group of the hybrid scheme                           ([G, K])

The paper's locality measure C(i, g) = lam*Node + (1-lam)*Rack, the Theorem
IV.1 objective of a permutation, Table II's node/rack locality percentages,
and the per-server non-local map-load (the quantity the simulator bridge
turns into fetch traffic and map-phase imbalance) are all one or two
[N, K] @ [K, G]-shaped products — no Python loops over subfiles or groups.
"""
from __future__ import annotations

import dataclasses
from math import comb
from typing import List, Sequence, Tuple

import numpy as np

from ..core.assignment import hybrid_group_of_slot, rack_subsets, slot_servers
from ..core.params import SchemeParams


# ---------------------------------------------------------------------------
# Storage replica placement (HDFS-style random baselines)
# ---------------------------------------------------------------------------

def place_replicas(p: SchemeParams, rng: np.random.Generator,
                   policy: str = "uniform") -> np.ndarray:
    """Replica locations, shape [N, r_f]; no two replicas share a server.

    ``uniform``: r_f distinct servers uniformly at random (the paper's model).
    ``hdfs``: first replica uniform; second in a different rack; third in the
    second's rack on a different server (Hadoop default for r_f = 3).

    Both policies draw all N subfiles' placements in batched ``rng`` calls
    (the per-subfile Python loop was the Table II setup bottleneck).
    Deterministic alternatives live in :mod:`repro_torch.placement.structured`.
    """
    if policy == "uniform":
        # row-wise uniform random permutation of the K servers, truncated to
        # r_f: identical in distribution to ordered sampling without
        # replacement (rng.choice(K, r_f, replace=False) per row).
        return np.argsort(rng.random((p.N, p.K)), axis=1)[:, :p.r_f] \
            .astype(np.int64)
    if policy != "hdfs":
        raise ValueError(policy)

    out = np.zeros((p.N, p.r_f), dtype=np.int64)
    first = rng.integers(p.K, size=p.N)
    out[:, 0] = first
    if p.r_f >= 2:
        # uniform over the K - Kr servers outside first's rack: draw a rack
        # offset in [1, P) and a slot in [0, Kr)
        rack2 = (first // p.Kr + rng.integers(1, p.P, size=p.N)) % p.P
        out[:, 1] = rack2 * p.Kr + rng.integers(p.Kr, size=p.N)
    if p.r_f >= 3:
        # same rack as the second replica, different slot
        slot3 = (out[:, 1] % p.Kr + rng.integers(1, p.Kr, size=p.N)) % p.Kr
        out[:, 2] = (out[:, 1] // p.Kr) * p.Kr + slot3
    for c in range(3, p.r_f):
        # replicas past the Hadoop triple: uniform over the unchosen servers
        taken = np.zeros((p.N, p.K), dtype=bool)
        np.put_along_axis(taken, out[:, :c], True, axis=1)
        scores = np.where(taken, np.inf, rng.random((p.N, p.K)))
        out[:, c] = scores.argmin(axis=1)
    return out


# ---------------------------------------------------------------------------
# Structural groups and incidences
# ---------------------------------------------------------------------------

def group_servers(p: SchemeParams) -> List[Tuple[int, ...]]:
    """Server tuple of every (layer, rack-subset) group, group-major order
    matching :func:`repro_torch.core.assignment.hybrid_slots`."""
    subsets = rack_subsets(p.P, p.r)
    out = []
    for layer in range(p.n_layers):
        for t_idx in range(len(subsets)):
            out.append(slot_servers(p, layer, t_idx))
    return out


def n_groups(p: SchemeParams) -> int:
    """Number of (layer, rack-subset) groups: Kr * C(P, r)."""
    return p.n_layers * comb(p.P, p.r)


def replica_incidence(p: SchemeParams, replicas: np.ndarray
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """(has_server [N, K], has_rack [N, P]) 0/1 incidences of a replica
    placement."""
    replicas = np.asarray(replicas, dtype=np.int64)
    has_server = np.zeros((p.N, p.K), dtype=np.int64)
    has_server[np.arange(p.N)[:, None], replicas] = 1
    has_rack = np.zeros((p.N, p.P), dtype=np.int64)
    has_rack[np.arange(p.N)[:, None], replicas // p.Kr] = 1
    return has_server, has_rack


def locality_incidence(p: SchemeParams, replicas: np.ndarray
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """(node[i, g], rack[i, g]) integer hit counts of assigning subfile i to
    group g: how many of g's servers host a replica of i / sit in a rack that
    hosts one.  Built as one-hot replica/rack incidence matmuls — the
    O(N*G*r) Python triple loop collapsed to two [N, K] @ [K, G] products."""
    groups = np.asarray(group_servers(p), dtype=np.int64)     # [G, r]
    G = groups.shape[0]
    has_server, has_rack = replica_incidence(p, replicas)
    # group-side incidences: server membership / per-rack server counts
    g_server = np.zeros((G, p.K), dtype=np.int64)
    g_server[np.arange(G)[:, None], groups] = 1               # distinct srvs
    g_rack = np.zeros((G, p.P), dtype=np.int64)
    np.add.at(g_rack, (np.repeat(np.arange(G), groups.shape[1]),
                       (groups // p.Kr).ravel()), 1)
    return has_server @ g_server.T, has_rack @ g_rack.T


def locality_matrix(p: SchemeParams, replicas: np.ndarray,
                    lam: float = 0.8) -> np.ndarray:
    """C[i, g] = lam*NodeLocality + (1-lam)*RackLocality of assigning subfile
    i to group g's server set (Section V's measure, general r >= 1)."""
    if not (0.5 < lam <= 1.0):
        raise ValueError("paper requires lam in (0.5, 1]")
    node, rack = locality_incidence(p, replicas)
    return lam * node + (1.0 - lam) * rack


def locality_of_perm(p: SchemeParams, replicas: np.ndarray,
                     perm: Sequence[int]) -> Tuple[float, float]:
    """(node_locality, rack_locality) in [0, 1] — Table II's percentages:
    fraction of (map-replica, server) placements that are local."""
    node, rack = locality_incidence(p, replicas)
    group_of_slot = hybrid_group_of_slot(p)
    perm = np.asarray(perm, dtype=np.int64)
    denom = p.N * p.r
    return (int(node[perm, group_of_slot].sum()) / denom,
            int(rack[perm, group_of_slot].sum()) / denom)


def perm_objective(p: SchemeParams, C: np.ndarray,
                   perm: Sequence[int]) -> float:
    """Theorem IV.1's objective value sum_slots C(perm[slot], group(slot)) —
    the quantity every solver in :mod:`repro_torch.placement.solvers`
    maximizes."""
    perm = np.asarray(perm, dtype=np.int64)
    return float(C[perm, hybrid_group_of_slot(p)].sum())


# ---------------------------------------------------------------------------
# Per-server non-local map load (the simulator-facing objective)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class NonLocalLoad:
    """Per-server miss counts of one (replicas, perm) placement.

    ``node_miss[s]`` — map tasks at server s whose subfile has NO replica on
    s (the input must be fetched over the network);
    ``rack_miss[s]`` — of those, the tasks with no replica anywhere in s's
    rack either (the fetch crosses the root switch).
    ``n_loc`` — the structural per-server map load M * C(P-1, r-1)
    (identical across servers in the hybrid design: imbalance comes ONLY
    from locality misses, never from task counts).
    """
    node_miss: np.ndarray          # [K] int
    rack_miss: np.ndarray          # [K] int
    n_loc: int

    @property
    def intra_fetch(self) -> np.ndarray:
        """[K] fetches served from within the rack (node miss, rack hit)."""
        return self.node_miss - self.rack_miss


def nonlocal_load(p: SchemeParams, replicas: np.ndarray,
                  perm: Sequence[int]) -> NonLocalLoad:
    """Count per-server node/rack misses of a placement, vectorized: one
    gather over the replica incidences per (slot, mapping-server) pair."""
    groups = np.asarray(group_servers(p), dtype=np.int64)       # [G, r]
    has_server, has_rack = replica_incidence(p, replicas)
    perm = np.asarray(perm, dtype=np.int64)
    srvs = groups[hybrid_group_of_slot(p)]                      # [N, r]
    sub = perm[:, None]                                         # [N, 1]
    node_hit = has_server[sub, srvs]                            # [N, r] 0/1
    rack_hit = has_rack[sub, srvs // p.Kr]                      # [N, r] 0/1
    node_miss = np.zeros(p.K, dtype=np.int64)
    rack_miss = np.zeros(p.K, dtype=np.int64)
    np.add.at(node_miss, srvs.ravel(), 1 - node_hit.ravel())
    np.add.at(rack_miss, srvs.ravel(), 1 - rack_hit.ravel())
    n_loc = p.M * comb(p.P - 1, p.r - 1)
    return NonLocalLoad(node_miss, rack_miss, n_loc)


def map_work_factors(p: SchemeParams, replicas: np.ndarray,
                     perm: Sequence[int],
                     remote_penalty: float = 0.5) -> np.ndarray:
    """[K] multiplicative map-work factors: a non-local map task costs
    (1 + remote_penalty) task-units (input read stalls behind the fetch).
    The map barrier ends at max(factors), so per-RACK locality imbalance
    shifts the simulated map phase — Table II in time units."""
    if remote_penalty < 0:
        raise ValueError("remote_penalty must be >= 0")
    load = nonlocal_load(p, replicas, perm)
    return 1.0 + remote_penalty * load.node_miss / max(load.n_loc, 1)


def map_load_imbalance(p: SchemeParams, replicas: np.ndarray,
                       perm: Sequence[int],
                       remote_penalty: float = 0.5) -> float:
    """max/mean of the per-server effective map work — 1.0 iff perfectly
    balanced.  A per-rack imbalance objective for placement solvers: the
    barrier cost of a placement is its SLOWEST server, so minimizing this
    (equivalently maximizing the minimum locality across servers) is the
    time-domain refinement of maximizing average locality."""
    f = map_work_factors(p, replicas, perm, remote_penalty)
    return float(f.max() / f.mean())
