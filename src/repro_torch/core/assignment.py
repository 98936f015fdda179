"""Map-task (subfile -> server set) assignment designs.

Three designs from the paper:

  * uncoded — each subfile mapped exactly once; server s gets the s-th block
    of N/K subfiles.
  * coded   — Coded MapReduce [Li-Maddah-Ali-Avestimehr]: each r-subset of the
    K servers is assigned J = N / C(K, r) unique subfiles.
  * hybrid  — the paper's scheme: subfiles are split into Kr layers of NP/K;
    within layer j, each r-subset T of the P racks gets M unique subfiles,
    mapped at servers {S_{t j} : t in T} (replication across racks only).

An assignment is represented as

  ``Assignment(scheme, params, servers_of_subfile, meta)``

where ``servers_of_subfile[i]`` is the sorted tuple of flat server ids that
map subfile i.  For the hybrid scheme, ``meta['slot_of_subfile'][i]`` gives
the structural slot (layer, rack_subset_index, w) of subfile i, and a
*permutation* of subfiles over slots yields every other valid hybrid
assignment (the degree of freedom exploited by the Section-IV locality
optimizer).
"""
from __future__ import annotations

import dataclasses
import itertools
from math import comb
from typing import Dict, List, Sequence, Tuple

import numpy as np

from .params import SchemeParams


@dataclasses.dataclass(frozen=True)
class Assignment:
    scheme: str                                   # 'uncoded' | 'coded' | 'hybrid'
    params: SchemeParams
    servers_of_subfile: Tuple[Tuple[int, ...], ...]
    meta: Dict[str, object] = dataclasses.field(default_factory=dict)

    def incidence(self) -> np.ndarray:
        """X[i, s] = 1 iff subfile i is mapped at server s  ([N, K] int64).

        Every derived per-server quantity (:attr:`subfiles_of_server`,
        :meth:`map_load`, :func:`pair_common_counts`) is one vectorized
        reduction of this matrix.
        """
        X = np.zeros((self.params.N, self.params.K), dtype=np.int64)
        srv = np.asarray(self.servers_of_subfile, dtype=np.int64)  # [N, r]
        X[np.arange(self.params.N)[:, None], srv] = 1
        return X

    @property
    def subfiles_of_server(self) -> List[List[int]]:
        X = self.incidence()
        return [np.nonzero(X[:, s])[0].tolist() for s in range(self.params.K)]

    def map_load(self) -> np.ndarray:
        """Number of map tasks executed at each server."""
        return self.incidence().sum(axis=0)

    def rack_load(self) -> np.ndarray:
        """Number of map tasks executed in each rack ([P] int64)."""
        per_server = self.map_load()
        return per_server.reshape(self.params.P, self.params.Kr).sum(axis=1)


# ---------------------------------------------------------------------------
# Structural enumerations
# ---------------------------------------------------------------------------

def rack_subsets(P: int, r: int) -> List[Tuple[int, ...]]:
    """All r-subsets of the P racks, in deterministic (lexicographic) order."""
    return list(itertools.combinations(range(P), r))


def hybrid_slots(params: SchemeParams) -> List[Tuple[int, int, int]]:
    """All (layer, rack_subset_index, w) slots of the hybrid design.

    One slot per subfile; slot order is the canonical subfile order used by
    :func:`hybrid_assignment` when ``perm`` is None.
    """
    params.validate_hybrid()
    slots = []
    n_subsets = comb(params.P, params.r)
    for layer in range(params.n_layers):
        for t_idx in range(n_subsets):
            for w in range(params.M):
                slots.append((layer, t_idx, w))
    return slots


def hybrid_group_of_slot(params: SchemeParams) -> np.ndarray:
    """Group index of every structural slot ([N] int64): slot s belongs to
    (layer, rack-subset) group s // M — :func:`hybrid_slots` is group-major
    with M slots per group.  The basic index map shared by every Section-IV
    objective and solver (:mod:`repro.placement`)."""
    return np.arange(params.N, dtype=np.int64) // params.M


def slot_servers(params: SchemeParams, layer: int, t_idx: int) -> Tuple[int, ...]:
    """Servers mapping the subfiles of slot (layer, t_idx, *)."""
    T = rack_subsets(params.P, params.r)[t_idx]
    return tuple(params.server_id(rack, layer) for rack in T)


# ---------------------------------------------------------------------------
# Assignment constructors
# ---------------------------------------------------------------------------

def uncoded_assignment(params: SchemeParams) -> Assignment:
    params.validate_uncoded()
    per = params.N // params.K
    servers = tuple((i // per,) for i in range(params.N))
    return Assignment("uncoded", params, servers)


def coded_assignment(params: SchemeParams) -> Assignment:
    params.validate_coded()
    subsets = list(itertools.combinations(range(params.K), params.r))
    J = params.J
    servers: List[Tuple[int, ...]] = []
    subset_of_subfile: List[int] = []
    for t_idx, T in enumerate(subsets):
        for _ in range(J):
            servers.append(tuple(T))
            subset_of_subfile.append(t_idx)
    assert len(servers) == params.N
    return Assignment("coded", params, tuple(servers),
                      meta={"subset_of_subfile": tuple(subset_of_subfile)})


def hybrid_assignment(params: SchemeParams,
                      perm: Sequence[int] | None = None) -> Assignment:
    """Hybrid Coded MapReduce assignment.

    ``perm`` is a permutation of range(N): subfile ``perm[slot_index]`` is
    placed into the slot with that index (identity if None).  Any permutation
    yields a valid hybrid scheme — this is the locality-optimization degree of
    freedom of Section IV.
    """
    params.validate_hybrid()
    slots = hybrid_slots(params)
    if perm is None:
        perm = list(range(params.N))
    if sorted(perm) != list(range(params.N)):
        raise ValueError("perm must be a permutation of range(N)")

    servers: List[Tuple[int, ...] | None] = [None] * params.N
    slot_of_subfile: List[Tuple[int, int, int] | None] = [None] * params.N
    for slot_index, (layer, t_idx, w) in enumerate(slots):
        subfile = perm[slot_index]
        servers[subfile] = slot_servers(params, layer, t_idx)
        slot_of_subfile[subfile] = (layer, t_idx, w)
    return Assignment("hybrid", params, tuple(servers),  # type: ignore[arg-type]
                      meta={"slot_of_subfile": tuple(slot_of_subfile),
                            "perm": tuple(perm)})


# ---------------------------------------------------------------------------
# Validation of the structural constraints (Theorem IV.1, conditions 1-4)
# ---------------------------------------------------------------------------

def pair_common_counts(assignment: Assignment) -> np.ndarray:
    """C[j, k] = number of subfiles mapped at both servers j and k."""
    X = assignment.incidence()
    common = X.T @ X
    np.fill_diagonal(common, 0)
    return common


def check_hybrid_constraints(assignment: Assignment) -> None:
    """Assert Theorem IV.1's four constraints hold for a hybrid assignment.

    All four checks are NumPy broadcasts over the pair-common-count matrix —
    no Python loops over server pairs/triples (the transitivity check used to
    be an O(K^3) nested loop).
    """
    p = assignment.params
    common = pair_common_counts(assignment)
    K, M = p.K, p.M
    Y = (common > 0).astype(np.int64)
    offdiag = ~np.eye(K, dtype=bool)
    racks = np.arange(K) // p.Kr

    # (1) no common files within a rack
    same_rack = (racks[:, None] == racks[None, :]) & offdiag
    bad = same_rack & (common != 0)
    assert not bad.any(), np.argwhere(bad)[:1]
    # (2) any pair of servers shares 0 or exactly M subfiles  (r = 2 reading;
    #     for general r the common count over a co-assigned pair is a multiple
    #     of M given by the number of r-subsets containing both racks)
    expected = M * comb(p.P - 2, p.r - 2) if p.r >= 2 else 0
    bad = offdiag & ~np.isin(common, (0, expected))
    assert not bad.any(), (np.argwhere(bad)[:1], expected)
    # (3) degree: each server shares files with exactly (P-1)*[structure] peers
    #     (for r=2 this is P-1; generally the other r-subset members across
    #      all subsets containing the server's rack collapse to the P-1 other
    #      layer members)
    if p.r >= 2:
        deg = Y.sum(axis=1)
        assert (deg == p.P - 1).all(), deg
    # (4) transitivity within a layer: no distinct triple with exactly two
    #     sharing pairs.  Ysum[i, j, k] = Y[i,j] + Y[j,k] + Y[i,k] broadcast.
    Ysum = Y[:, :, None] + Y[None, :, :] + Y[:, None, :]
    idx = np.arange(K)
    distinct = ((idx[:, None, None] != idx[None, :, None])
                & (idx[None, :, None] != idx[None, None, :])
                & (idx[:, None, None] != idx[None, None, :]))
    bad = distinct & (Ysum == 2)
    assert not bad.any(), np.argwhere(bad)[:1]
