"""Deterministic structured replica placements (resolvable-design style).

The paper models storage as HDFS-style RANDOM replica placement and then
optimizes the Map-task assignment around it.  Resolvable-design
constructions (cf. Konstantinidis & Ramamoorthy, arXiv:1908.05666) invert
that: place replicas so the storage layout is ALIGNED with the structure
the assignment needs, and random-vs-optimized stops mattering.

Two constructions, both deterministic (no rng).  ``resolvable`` is
perfectly storage-balanced whenever K | N; ``aligned`` is perfectly
balanced for r_f <= r (the aligned replicas inherit the hybrid design's
exact per-server symmetry; extras beyond r skew toward low-rack servers):

  * ``resolvable`` — replica layer c is a parallel class: subfile i's c-th
    replica lives at rack (rack0(i) + c) mod P, slot (slot0(i) + c // P)
    mod Kr.  Each layer is a bijection of the base layout, so every server
    stores exactly N * r_f / K subfiles and the first min(r_f, P) replicas
    of every subfile sit in DISTINCT racks (HDFS's spread goal, made
    exact).
  * ``aligned`` — replicas sit on the servers that the canonical (identity
    permutation) hybrid assignment will map the slot's subfile from; spare
    replicas (r_f > r) continue in resolvable fashion.  With r_f >= r this
    achieves node locality 1.0 with NO optimization — the upper bound the
    solvers chase, useful as an oracle and for sizing how much locality a
    placement-aware storage tier buys.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from ..core.assignment import hybrid_group_of_slot
from ..core.params import SchemeParams
from ..core.resolvable import cyclic_replica_server
from .objectives import group_servers

STRUCTURED_POLICIES = ("resolvable", "aligned")


def _resolvable_server(p: SchemeParams, base: np.ndarray,
                       c: int) -> np.ndarray:
    """Server of replica shift c from per-subfile base servers — the
    parallel-class shift now shared with the resolvable plan compiler
    (:func:`repro_torch.core.resolvable.cyclic_replica_server`): rotate the
    rack by c and the in-rack slot by c // P (distinct for c < K)."""
    return cyclic_replica_server(p, base, c)


def structured_replicas(p: SchemeParams,
                        policy: str = "resolvable") -> np.ndarray:
    """Deterministic [N, r_f] replica placement (see module docstring).

    Requires r_f <= K (cannot place r_f distinct replicas otherwise).
    """
    if policy not in STRUCTURED_POLICIES:
        raise ValueError(
            f"policy must be one of {STRUCTURED_POLICIES}, got {policy!r}")
    if p.r_f > p.K:
        raise ValueError(f"need r_f <= K for distinct replicas; "
                         f"r_f={p.r_f} K={p.K}")
    out = np.empty((p.N, p.r_f), dtype=np.int64)
    if policy == "resolvable":
        base = np.arange(p.N, dtype=np.int64) % p.K
        for c in range(p.r_f):
            out[:, c] = _resolvable_server(p, base, c)
        return out

    # aligned: slot s of the canonical hybrid assignment is mapped at
    # group_servers[group(s)]; give subfile s (identity perm) its first
    # min(r_f, r) replicas there, then continue resolvably off the first.
    groups = np.asarray(group_servers(p), dtype=np.int64)       # [G, r]
    srvs = groups[hybrid_group_of_slot(p)]                      # [N, r]
    k = min(p.r_f, p.r)
    out[:, :k] = srvs[:, :k]
    for c in range(k, p.r_f):
        # The r aligned servers sit in distinct racks at the SAME layer, so
        # rack rotations of srvs[:, 0] could collide with srvs[:, 1:k] —
        # advance the in-rack slot instead (a shift that is a multiple of P
        # rotates only the slot): distinct while r_f - k < Kr; anything
        # beyond is rejected by the collision check below.
        out[:, c] = _resolvable_server(p, srvs[:, 0], (c - k + 1) * p.P)
    _check_distinct(out)
    return out


def _check_distinct(replicas: np.ndarray) -> None:
    srt = np.sort(replicas, axis=1)
    if (srt[:, 1:] == srt[:, :-1]).any():
        bad = int(np.nonzero((srt[:, 1:] == srt[:, :-1]).any(axis=1))[0][0])
        raise ValueError(f"replica collision for subfile {bad}: "
                         f"{replicas[bad].tolist()}")


def replica_load(replicas: np.ndarray, K: int) -> np.ndarray:
    """[K] subfiles stored per server — the storage-balance check: uniform
    (== N * r_f / K everywhere) for both structured policies when K | N."""
    return np.bincount(np.asarray(replicas).ravel(), minlength=K)


def storage_balance(replicas: np.ndarray, K: int) -> Tuple[int, int]:
    """(min, max) per-server storage load; equal iff perfectly balanced."""
    load = replica_load(replicas, K)
    return int(load.min()), int(load.max())
