"""Solver suite for the Theorem IV.1 assignment problem, with a registry:
the counterpart of the JAX package's ``placement/solvers.py``.  ``random``,
``greedy``, ``flow`` and ``local_search`` are its NumPy code unchanged (the
same permutations from the same inputs); its ``anneal_jax`` is ``anneal``
here, the same chains in torch on the CUDA card.

Choosing the permutation of subfiles over structural slots that maximizes
sum_slots C(perm[slot], group(slot)) subject to each group holding exactly M
subfiles is a transportation problem.  The suite covers the whole
cost/quality spectrum:

  ============  =========================  ==================================
  solver        complexity                 quality
  ============  =========================  ==================================
  random        O(N)                       Table II's 'Ran' baseline
  greedy        O(NG log(NG))              near-optimal, no backtracking
  flow          O(N * E log V), E = NG     EXACT (min-cost max-flow, SSP)
  local_search  O(moves * 1)               anytime; >= its starting point
  anneal        O(steps) on the card       >= greedy (warm start); batched
                                           Metropolis chains — one candidate
                                           swap per chain a step, scored by
                                           vectorized C-gathers in torch
  ============  =========================  ==================================

All solvers return a permutation of range(N) (slot -> subfile), so any
result composes with :func:`repro_torch.core.assignment.hybrid_assignment`
and satisfies Theorem IV.1's constraints BY CONSTRUCTION — swap moves permute
subfiles over slots and can never leave the feasible set.
"""
from __future__ import annotations

import dataclasses
import heapq
import time
import zlib
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core.assignment import hybrid_group_of_slot, rack_subsets
from ..core.params import SchemeParams
from ..distributed.meshes import DeviceLike, resolve_device
from .objectives import locality_matrix, locality_of_perm, perm_objective


# ---------------------------------------------------------------------------
# Primitive solvers (perm-level API)
# ---------------------------------------------------------------------------

def random_perm(p: SchemeParams, rng: np.random.Generator) -> np.ndarray:
    """Table II's 'Ran' baseline: an arbitrary valid hybrid assignment."""
    return rng.permutation(p.N)


def greedy_perm(p: SchemeParams, C: np.ndarray) -> np.ndarray:
    """Greedy: repeatedly place the highest-scoring (subfile, group) pair
    into a free slot.  Fast, near-optimal; used as a scalable fallback."""
    G = C.shape[1]
    cap = np.full(G, p.M, dtype=np.int64)
    order = np.argsort(-C, axis=None)
    assigned = np.full(p.N, -1, dtype=np.int64)
    placed = 0
    for flat in order:
        i, g = divmod(int(flat), G)
        if assigned[i] >= 0 or cap[g] == 0:
            continue
        assigned[i] = g
        cap[g] -= 1
        placed += 1
        if placed == p.N:
            break
    return groups_to_perm(p, assigned)


def flow_perm(p: SchemeParams, C: np.ndarray) -> np.ndarray:
    """Exact solution of Theorem IV.1 via min-cost max-flow (SSP + Dijkstra
    with Johnson potentials).  Integral by flow integrality."""
    n, G = C.shape
    # node ids: 0 = source, 1..n subfiles, n+1..n+G groups, last = sink
    S, T = 0, n + G + 1
    n_nodes = T + 1
    graph: List[List[int]] = [[] for _ in range(n_nodes)]
    # edge arrays
    to: List[int] = []
    cap: List[int] = []
    cost: List[float] = []

    def add_edge(u: int, v: int, c: int, w: float) -> None:
        graph[u].append(len(to)); to.append(v); cap.append(c); cost.append(w)
        graph[v].append(len(to)); to.append(u); cap.append(0); cost.append(-w)

    cmax = float(C.max()) if C.size else 0.0
    for i in range(n):
        add_edge(S, 1 + i, 1, 0.0)
        for g in range(G):
            # shift costs so all are >= 0 for Dijkstra (maximize C == minimize
            # cmax - C); the shift is constant per unit flow, so argmin is
            # unchanged.
            add_edge(1 + i, 1 + n + g, 1, cmax - float(C[i, g]))
    for g in range(G):
        add_edge(1 + n + g, T, p.M, 0.0)

    potential = np.zeros(n_nodes)
    flow_assigned = np.full(n, -1, dtype=np.int64)
    INF = float("inf")
    for _ in range(n):  # one augmentation per subfile (unit flows)
        dist = np.full(n_nodes, INF)
        dist[S] = 0.0
        prev_edge = np.full(n_nodes, -1, dtype=np.int64)
        pq = [(0.0, S)]
        while pq:
            d, u = heapq.heappop(pq)
            if d > dist[u] + 1e-12:
                continue
            for eid in graph[u]:
                if cap[eid] <= 0:
                    continue
                v = to[eid]
                nd = d + cost[eid] + potential[u] - potential[v]
                if nd < dist[v] - 1e-12:
                    dist[v] = nd
                    prev_edge[v] = eid
                    heapq.heappush(pq, (nd, v))
        assert dist[T] < INF, "flow infeasible: check divisibility of N"
        finite = dist < INF
        potential[finite] += dist[finite]
        # augment one unit along S->T
        v = T
        while v != S:
            eid = int(prev_edge[v])
            cap[eid] -= 1
            cap[eid ^ 1] += 1
            v = to[eid ^ 1]
    # read off subfile -> group assignment
    for i in range(n):
        for eid in graph[1 + i]:
            if to[eid] != S and cap[eid ^ 1] > 0 and eid % 2 == 0:
                flow_assigned[i] = to[eid] - 1 - n
                break
    assert (flow_assigned >= 0).all()
    return groups_to_perm(p, flow_assigned)


def local_search_perm(p: SchemeParams, C: np.ndarray,
                      rng: np.random.Generator,
                      init: Optional[Sequence[int]] = None,
                      max_sweeps: int = 20,
                      batch: int = 2048) -> np.ndarray:
    """First-improvement local search over the swap neighborhood.

    A move swaps the subfiles of two slots — always another valid hybrid
    assignment.  Each sweep evaluates ``batch`` random candidate swaps at
    once (vectorized delta = C[j,ga] + C[i,gb] - C[i,ga] - C[j,gb]) and
    applies a non-conflicting improving subset; terminates when a sweep
    finds no improving move (a swap-local optimum) or after ``max_sweeps``.
    Monotone: the result's objective is >= the starting point's.
    """
    perm = np.array(greedy_perm(p, C) if init is None else init,
                    dtype=np.int64, copy=True)
    gos = hybrid_group_of_slot(p)
    for _ in range(max_sweeps):
        a = rng.integers(p.N, size=batch)
        b = rng.integers(p.N, size=batch)
        ia, ib = perm[a], perm[b]
        ga, gb = gos[a], gos[b]
        delta = (C[ib, ga] + C[ia, gb]) - (C[ia, ga] + C[ib, gb])
        improving = np.nonzero(delta > 1e-12)[0]
        if improving.size == 0:
            break            # sampled swap-local optimum: stop early
        # apply a non-conflicting subset, best deltas first (the first
        # candidate always applies: improving excludes a == b, since a
        # self-swap has delta exactly 0)
        touched = np.zeros(p.N, dtype=bool)
        for k in improving[np.argsort(-delta[improving])]:
            sa, sb = int(a[k]), int(b[k])
            if touched[sa] or touched[sb]:
                continue
            perm[sa], perm[sb] = perm[sb], perm[sa]
            touched[sa] = touched[sb] = True
    return perm


def anneal_chains(perms: torch.Tensor, C: torch.Tensor,
                  group_of_slot: torch.Tensor, temps: torch.Tensor,
                  gen: torch.Generator) -> torch.Tensor:
    """The device half of :func:`anneal_perm`: one Metropolis swap step per
    chain and temperature, returning each chain's best permutation.

    ``perms`` is int64 [B, N] (updated in place), ``C`` float32 [N, G],
    ``group_of_slot`` int64 [N] and ``temps`` float32 [n_steps], all on one
    device; ``gen`` lies on that device or on the CPU.  Every step's draws
    (a, b and log u) are made up front on the generator's device and moved
    to the chains' device once.  Each step gathers the deltas, accepts
    where ``delta >= 0`` or ``log(u) * t < delta``, swaps by ``scatter_``
    and keeps a chain's best only when its float64 objective rises by more
    than 1e-6.  The loop is elementwise IEEE arithmetic, gathers and
    scatters only, so from a CPU generator the chains take the same steps
    and return the same permutations on the card and on the CPU (the
    starting objectives are float64 sums of float32 entries, exact in any
    order for a locality matrix's entries).  Nothing in the loop reads a
    value back to the host, so the steps queue on the card without a
    synchronisation.
    """
    n_chains, n = perms.shape
    n_steps = temps.shape[0]
    G = C.shape[1]
    Cf = C.reshape(-1)                                          # [N * G]
    dev = perms.device
    draw = dict(generator=gen, device=gen.device)
    a_all = torch.randint(0, n, (n_steps, n_chains, 1), **draw).to(dev)
    b_all = torch.randint(0, n, (n_steps, n_chains, 1), **draw).to(dev)
    log_u_all = torch.rand((n_steps, n_chains), **draw).clamp_min_(
        1e-12).log_().to(dev)
    obj = Cf.double().take(perms * G + group_of_slot[None, :]).sum(dim=1)
    best_perms, best_obj = perms.clone(), obj.clone()
    zero = torch.zeros((), dtype=obj.dtype, device=dev)
    # one step per temperature, as lax.scan over the schedule
    for step in range(n_steps):
        a, b = a_all[step], b_all[step]                         # [B, 1]
        ia, ib = perms.gather(1, a), perms.gather(1, b)
        ga, gb = group_of_slot.take(a), group_of_slot.take(b)
        delta = ((Cf.take(ib * G + ga) + Cf.take(ia * G + gb))
                 - (Cf.take(ia * G + ga) + Cf.take(ib * G + gb)))[:, 0]
        accept = (delta >= 0) | (log_u_all[step] * temps[step] < delta)
        acc = accept[:, None]
        perms.scatter_(1, a, torch.where(acc, ib, ia))
        perms.scatter_(1, b, torch.where(acc, ia, ib))
        obj = obj + torch.where(accept, delta.double(), zero)
        improved = obj > best_obj + 1e-6          # strictly better only
        best_obj = torch.where(improved, obj, best_obj)
        best_perms = torch.where(improved[:, None], perms, best_perms)
    return best_perms


def anneal_perm(p: SchemeParams, C: np.ndarray,
                rng: np.random.Generator,
                n_chains: int = 64, n_steps: int = 1500,
                t0: float = 1.0, t1: float = 1e-3,
                init: Optional[Sequence[Sequence[int]]] = None,
                init_solvers: Sequence[str] = ("greedy",),
                device: DeviceLike = None) -> np.ndarray:
    """Batched parallel simulated annealing over the swap neighborhood, on
    ``device`` (default: the CUDA card; raises where there is none — pass
    ``device="cpu"`` to run it on the host).

    Runs ``n_chains`` independent Metropolis chains on the device: each
    step proposes one random slot transposition PER CHAIN and evaluates all
    the objective deltas in one vectorized gather over the C matrix, with
    no host round trip inside the step loop (the best permutations are
    copied back once, at the end).  Temperatures follow a geometric
    schedule t0 -> t1.

    ``init`` seeds the first chains with warm-start permutations; without
    it, ``init_solvers`` names cheap solvers to warm-start from (default
    greedy; add 'flow' to polish the exact optimum).  Remaining chains
    start from random permutations drawn from ``rng``; then exactly one
    ``rng.integers(2**31)`` seeds the device generator, so the caller's
    stream advances as the JAX package's ``anneal_jax`` advances it.  The
    chains' own draws come from a host ``torch.Generator``, so the
    permutation found differs from ``anneal_jax``'s bit for bit (its
    guarantees do not) and is the same on every device.  The best
    objective seen by any chain is tracked, and a warm start is only ever
    REPLACED by a strictly better permutation — so the result's objective
    is >= every warm start's, deterministically (ties return the first
    warm start).
    """
    dev = resolve_device(device)
    gos = np.asarray(hybrid_group_of_slot(p))
    warm_fns = {"greedy": greedy_perm, "flow": flow_perm}
    if init is None:
        warm = [np.asarray(warm_fns[name](p, C)) for name in init_solvers]
    else:
        warm = [np.asarray(x, dtype=np.int64) for x in init]
    n_chains = max(n_chains, len(warm))   # never silently drop a warm start
    base = np.empty((n_chains, p.N), dtype=np.int64)
    for k in range(n_chains):
        base[k] = warm[k] if k < len(warm) else rng.permutation(p.N)

    # the chains' draws come from the host generator whatever the device,
    # so the result for a seed is the same on the card and on the CPU
    gen = torch.Generator()
    gen.manual_seed(int(rng.integers(2 ** 31)))
    Cd = torch.as_tensor(np.asarray(C), dtype=torch.float32, device=dev)
    gos_d = torch.as_tensor(gos, dtype=torch.int64, device=dev)
    temps = torch.as_tensor(np.geomspace(t0, t1, num=max(n_steps, 1)),
                            dtype=torch.float32, device=dev)
    best_perms = anneal_chains(torch.as_tensor(base, device=dev), Cd, gos_d,
                               temps, gen)
    # Final selection is EXACT and warm-start-safe: the float32 on-device
    # objective deltas are only a Metropolis heuristic (accumulated rounding
    # could evict a warm start from a chain's tracked best), so the warm
    # starts re-enter the candidate pool here, everything is re-scored in
    # float64 by direct gather, and near-ties (summation-order roundoff) go
    # to the EARLIEST candidate — warm starts first, in caller order.  A
    # warm start is therefore only ever outranked by a meaningfully better
    # permutation, whatever the chains did.
    cand = np.concatenate([np.stack(warm), best_perms.cpu().numpy()], axis=0)
    finals = np.asarray([perm_objective(p, C, perm) for perm in cand])
    return cand[int(np.nonzero(finals >= finals.max() - 1e-9)[0][0])]


def groups_to_perm(p: SchemeParams, group_of_subfile: np.ndarray
                   ) -> np.ndarray:
    """Convert a subfile->group map into a slot permutation (slot_index ->
    subfile), filling each group's M slots in subfile order."""
    G = int(group_of_subfile.max()) + 1 if len(group_of_subfile) else 0
    G = max(G, p.n_layers * len(rack_subsets(p.P, p.r)))
    perm = np.full(p.N, -1, dtype=np.int64)
    next_w = np.zeros(G, dtype=np.int64)
    for i in range(p.N):
        g = int(group_of_subfile[i])
        w = int(next_w[g]); next_w[g] += 1
        assert w < p.M, "group over capacity"
        perm[g * p.M + w] = i
    assert (perm >= 0).all()
    return perm


# ---------------------------------------------------------------------------
# Registry + the PlacementResult envelope
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PlacementResult:
    """One solved placement: the inputs that produced it and its scores.

    The envelope every downstream consumer takes: the sim bridge
    (:mod:`repro_torch.placement.sim_bridge`), the distributed engine
    (``run_job_distributed(placement=...)``), benchmarks and the joint
    optimizer all speak PlacementResult.
    """
    params: SchemeParams
    replicas: np.ndarray           # [N, r_f] storage replica servers
    perm: np.ndarray               # [N] slot -> subfile
    solver: str
    lam: float
    objective: float               # Theorem IV.1 objective value
    node_locality: float           # Table II percentages, in [0, 1]
    rack_locality: float
    wall_s: float                  # solver wall clock (excludes C build)

    def summary(self) -> str:
        return (f"{self.solver}: node {100 * self.node_locality:.1f}% "
                f"rack {100 * self.rack_locality:.1f}% "
                f"obj {self.objective:.1f} ({self.wall_s * 1e3:.1f} ms)")


# solver signature: (params, C, rng, **kwargs) -> perm
Solver = Callable[..., np.ndarray]

SOLVERS: Dict[str, Solver] = {}


def register_solver(name: str) -> Callable[[Solver], Solver]:
    """Register a solver under ``name`` (decorator).  Third-party solvers
    (ILP backends, new metaheuristics) plug in without touching this
    module."""
    def deco(fn: Solver) -> Solver:
        SOLVERS[name] = fn
        return fn
    return deco


def get_solver(name: str) -> Solver:
    try:
        return SOLVERS[name]
    except KeyError:
        raise ValueError(
            f"unknown solver {name!r}; registered: {sorted(SOLVERS)}"
        ) from None


register_solver("random")(lambda p, C, rng, **kw: random_perm(p, rng))
register_solver("greedy")(lambda p, C, rng, **kw: greedy_perm(p, C))
register_solver("flow")(lambda p, C, rng, **kw: flow_perm(p, C))
register_solver("local_search")(
    lambda p, C, rng, **kw: local_search_perm(p, C, rng, **kw))
register_solver("anneal")(
    lambda p, C, rng, **kw: anneal_perm(p, C, rng, **kw))


def solve(p: SchemeParams, replicas: np.ndarray, solver: str = "flow",
          lam: float = 0.8, seed: int = 0,
          rng: Optional[np.random.Generator] = None,
          C: Optional[np.ndarray] = None, **kwargs) -> PlacementResult:
    """Run one registered solver end to end: build the locality matrix
    (unless a precomputed ``C`` is passed), solve, score.  ``wall_s`` times
    the solver alone."""
    fn = get_solver(solver)
    if C is None:
        C = locality_matrix(p, replicas, lam)
    if rng is None:
        rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    perm = fn(p, C, rng, **kwargs)
    wall = time.perf_counter() - t0
    node, rack = locality_of_perm(p, replicas, perm)
    return PlacementResult(p, np.asarray(replicas), np.asarray(perm), solver,
                           lam, perm_objective(p, C, perm), node, rack, wall)


def solver_rng(seed: int, name: str, trial: int = 0) -> np.random.Generator:
    """Independent per-(seed, solver, trial) generator, keyed on the solver
    NAME (stable crc32) — adding, removing or reordering solvers in a suite
    never perturbs any other solver's stream."""
    return np.random.default_rng(
        np.random.SeedSequence((seed, trial, zlib.crc32(name.encode()))))


def solve_all(p: SchemeParams, replicas: np.ndarray,
              solvers: Sequence[str] = ("random", "greedy", "flow",
                                        "local_search", "anneal"),
              lam: float = 0.8, seed: int = 0,
              per_solver_kwargs: Optional[Dict[str, Dict]] = None
              ) -> Dict[str, PlacementResult]:
    """Run several solvers on the SAME (replicas, C) instance — the Table II
    comparison in one call.  Each solver gets an independent child rng keyed
    on its name (:func:`solver_rng`), so editing the suite never perturbs
    the remaining solvers."""
    C = locality_matrix(p, replicas, lam)
    kw = per_solver_kwargs or {}
    return {name: solve(p, replicas, name, lam,
                        rng=solver_rng(seed, name), C=C,
                        **kw.get(name, {}))
            for name in solvers}
