"""Cloning-vs-coding experiments: when does task replication buy more as
SPECULATION fuel (clone / restart, first finisher wins) than as CODING fuel
(the paper's shuffle-traffic reduction)?

Two drivers, both seeded and deterministic:

  * :func:`cloning_vs_coding_frontier` — per Table I row x straggler
    regime, sweep the replication budget: ``uncoded r=1`` (+ clone budget)
    against ``coded``/``hybrid`` at the row's r, under every speculation
    policy.  Each cell reports mean/p99 JCT over independent straggler
    seeds plus backup accounting; ``budget`` counts total map copies
    (``repl x (1 + n_clones)``), so the frontier reads as JCT vs
    replication spend.
  * :func:`hedged_vs_static_stream` — the multi-job check of the hedged
    r-policy (:class:`repro_torch.resilience.replication.HedgedRPolicy`): a
    probe
    stream fits the straggler model online, then the SAME evaluation stream
    runs under (a) the static fetch-aware chooser and (b) the chooser with
    the pre-fit hedged r-policy (straggler-priced candidates +
    deterministic rack-hedged placements).  Under ``RackCorrelated`` the
    hedged policy must win p99 — asserted by ``benchmarks/resilience_bench
    .py``.

:func:`check_frontier_invariants` distills the acceptance criteria from a
frontier: speculation is a bit-identical no-op under ``NoStragglers``, and
``late``/``clone`` improve p99 under ``ExponentialTail``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.params import TABLE1_GRID
from ..sim import (ClusterSim, CostModel, ExponentialTail, JobSpec,
                   NoStragglers, PoissonWorkload, RackCorrelated,
                   RackTopology, SchemeChooser, StragglerModel,
                   default_catalog, run_scheduled, simulate_single_job)
from .replication import HedgedRPolicy
from .speculation import get_policy

# the paper's Table I (K, P, Q, N, r) grid — the same rows every bench
# anchors on (divisibility-violating rows run with check=False)
TABLE1_ROWS: List[Tuple[int, int, int, int, int]] = list(TABLE1_GRID)

DEFAULT_POLICIES: Tuple[Tuple[str, Dict], ...] = (
    ("none", {}),
    ("clone", {"n_clones": 1}),
    ("late", {}),
    ("mantri", {}),
)


def straggler_regimes(exp_scale: float = 1.0, rack_p: float = 0.25,
                      rack_factor: float = 4.0
                      ) -> Dict[str, StragglerModel]:
    """The three regimes of the acceptance grid."""
    return {
        "none": NoStragglers(),
        "exp_tail": ExponentialTail(exp_scale),
        "rack": RackCorrelated(rack_p, rack_factor),
    }


@dataclasses.dataclass(frozen=True)
class FrontierCell:
    """One (row, regime, scheme, r, policy) cell of the frontier."""
    params: Tuple[int, int, int, int, int]
    regime: str
    scheme: str
    r: int
    policy: str
    budget: float                  # total map copies: repl * (1 + clones)
    jcts: Tuple[float, ...]        # per-seed JCTs (kept for exact no-op
    mean_jct: float                # comparisons across policies)
    p99_jct: float
    mean_backups: float
    mean_backup_wins: float

    def to_row(self) -> Dict:
        d = dataclasses.asdict(self)
        d["params"] = list(self.params)
        d["jcts"] = list(self.jcts)
        return d


def _cell(params: Tuple[int, int, int, int, int], regime: str,
          model: StragglerModel, scheme: str, r: int, policy_name: str,
          policy_kwargs: Dict, cost: CostModel, intra_bw: float,
          cross_bw: float, n_seeds: int,
          tasks_per_server: Optional[int]) -> FrontierCell:
    K, P, Q, N, _ = params
    topo = RackTopology(P=P, cross_bw=cross_bw, intra_bw=intra_bw)
    spec = JobSpec("frontier_probe", N, Q, 1)
    policy = get_policy(policy_name, tasks_per_server=tasks_per_server,
                        **policy_kwargs)
    jcts, backups, wins = [], [], []
    for seed in range(n_seeds):
        st = simulate_single_job(spec, topo, K, scheme, r,
                                 cost_model=cost, stragglers=model,
                                 seed=seed, check=False, speculation=policy)
        jcts.append(st.jct)
        backups.append(st.n_backups)
        wins.append(st.n_backup_wins)
    repl = 1 if scheme == "uncoded" else r
    clones = policy_kwargs.get("n_clones", 0) if policy_name == "clone" \
        else 0
    return FrontierCell(params, regime, scheme, r, policy_name,
                        float(repl * (1 + clones)), tuple(jcts),
                        float(np.mean(jcts)),
                        float(np.percentile(jcts, 99)),
                        float(np.mean(backups)), float(np.mean(wins)))


def cloning_vs_coding_frontier(
        rows: Sequence[Tuple[int, int, int, int, int]] = tuple(TABLE1_ROWS),
        policies: Sequence[Tuple[str, Dict]] = DEFAULT_POLICIES,
        regimes: Optional[Dict[str, StragglerModel]] = None,
        cost: Optional[CostModel] = None,
        intra_bw: float = 1e7, cross_bw: float = 1e6,
        n_seeds: int = 10,
        tasks_per_server: Optional[int] = 8) -> List[FrontierCell]:
    """The full frontier grid: every row x regime x replication point
    (uncoded r=1, coded/hybrid at the row's r) x policy.

    ``tasks_per_server`` coalesces map tasks so the N=6900 rows stay cheap
    (speculation semantics are per-task either way); pass None for
    per-subfile tasks.
    """
    if regimes is None:
        regimes = straggler_regimes()
    if cost is None:
        cost = CostModel()
    cells: List[FrontierCell] = []
    for params in rows:
        row_r = params[4]
        points = [("uncoded", 1), ("coded", row_r), ("hybrid", row_r)]
        if row_r != 2:
            points.append(("hybrid", 2))
        for regime, model in regimes.items():
            for scheme, r in points:
                for pol_name, pol_kwargs in policies:
                    cells.append(_cell(params, regime, model, scheme, r,
                                       pol_name, pol_kwargs, cost,
                                       intra_bw, cross_bw, n_seeds,
                                       tasks_per_server))
    return cells


def frontier_curve(cells: Sequence[FrontierCell],
                   regime: str) -> List[Dict]:
    """Best (scheme, r, policy) per replication budget in one regime —
    the literal cloning-vs-coding frontier."""
    best: Dict[float, FrontierCell] = {}
    for c in cells:
        if c.regime != regime:
            continue
        if c.budget not in best or c.p99_jct < best[c.budget].p99_jct:
            best[c.budget] = c
    return [{"budget": b, "scheme": c.scheme, "r": c.r, "policy": c.policy,
             "mean_jct": c.mean_jct, "p99_jct": c.p99_jct}
            for b, c in sorted(best.items())]


def check_frontier_invariants(cells: Sequence[FrontierCell]) -> Dict:
    """The acceptance checks over a frontier grid:

    * ``noop_under_none`` — under ``NoStragglers`` every policy's per-seed
      JCTs are BIT-IDENTICAL to the ``none`` policy's (speculation never
      fires, never hurts);
    * ``late_improves_p99`` / ``clone_improves_p99`` — under
      ``ExponentialTail`` the policy's summed p99 over the grid is strictly
      below ``none``'s, and no single cell regresses beyond float noise;
    * ``mantri_improves_p99_rack`` — under ``RackCorrelated`` (Mantri's
      design regime — cause attribution needs a rack-shaped cause) the
      summed p99 is strictly below ``none``'s.  Only the aggregate is
      asserted: on i.i.d. tails Mantri can misattribute a lone straggler
      to its rack and restart sub-optimally on individual cells.
    """
    by_key: Dict[Tuple, Dict[str, FrontierCell]] = {}
    for c in cells:
        by_key.setdefault((c.params, c.regime, c.scheme, c.r),
                          {})[c.policy] = c
    noop = True
    for (params, regime, scheme, r), pols in by_key.items():
        if regime != "none" or "none" not in pols:
            continue
        base = pols["none"].jcts
        for name, c in pols.items():
            if c.jcts != base:
                noop = False
    out = {"noop_under_none": noop}

    def sums(pol: str, regime: str) -> Tuple[bool, float, float, bool]:
        tot_p, tot_b, pointwise, seen = 0.0, 0.0, True, False
        tol = 1.0 + 1e-9
        for key, pols in by_key.items():
            if key[1] != regime or pol not in pols or "none" not in pols:
                continue
            seen = True
            tot_p += pols[pol].p99_jct
            tot_b += pols["none"].p99_jct
            if pols[pol].p99_jct > pols["none"].p99_jct * tol:
                pointwise = False
        return seen, tot_p, tot_b, pointwise

    for pol in ("late", "clone"):
        seen, tot_p, tot_b, pointwise = sums(pol, "exp_tail")
        out[f"{pol}_improves_p99"] = seen and pointwise and tot_p < tot_b
    seen, tot_p, tot_b, _ = sums("mantri", "rack")
    out["mantri_improves_p99_rack"] = seen and tot_p < tot_b
    return out


def hedged_vs_static_stream(
        K: int = 8, P: int = 4,
        stragglers: Optional[StragglerModel] = None,
        cost: Optional[CostModel] = None,
        intra_bw: float = 1e6, cross_bw: float = 1e5,
        rate: float = 4.0, n_jobs: int = 60, n_probe: int = 30,
        seed: int = 0, max_concurrent: int = 4,
        placement_solver: str = "greedy",
        speculation: Optional[object] = None) -> Dict:
    """Static fetch-aware chooser vs the hedged r-policy on one stream.

    A probe stream (different seed) fits the straggler model through the
    scheduler's own ``r_policy.observe`` feedback loop; the evaluation
    stream then runs twice from identical initial state.  Both choosers are
    placement-aware (same solver) — the hedged one differs exactly by (a)
    straggler-priced candidate estimates and (b) deterministic rack-hedged
    structured placements.
    """
    if stragglers is None:
        stragglers = RackCorrelated(0.25, 4.0)
    if cost is None:
        cost = CostModel()
    catalog = default_catalog(K, P)
    topo = RackTopology(P=P, cross_bw=cross_bw, intra_bw=intra_bw)

    def stream(r_policy, jobs, stream_seed):
        cluster = ClusterSim(topo, K, cost, stragglers, stream_seed)
        chooser = SchemeChooser(K, cost_model=cost,
                                placement_solver=placement_solver,
                                placement_seed=stream_seed,
                                speculation=speculation,
                                r_policy=r_policy)
        stats, sched = run_scheduled(jobs, cluster, chooser,
                                     max_concurrent=max_concurrent)
        jcts = np.asarray([s.jct for s in stats])
        picks: Dict[str, int] = {}
        for s in stats:
            d = sched.decisions[s.job_id]
            key = f"{d.scheme}:r{d.r}"
            picks[key] = picks.get(key, 0) + 1
        return {"mean_jct": float(jcts.mean()),
                "p99_jct": float(np.percentile(jcts, 99)),
                "n_jobs": int(len(jcts)), "decisions": picks}

    # probe: fit online through the scheduler's observe feedback
    r_policy = HedgedRPolicy(K, P, placement_solver=placement_solver,
                             placement_seed=seed)
    probe_jobs = PoissonWorkload(catalog, n_probe, rate).generate(seed + 1)
    stream(r_policy, probe_jobs, seed + 1)
    fit = r_policy.fit

    eval_jobs = PoissonWorkload(catalog, n_jobs, rate).generate(seed)
    static = stream(None, eval_jobs, seed)
    hedged = stream(HedgedRPolicy(K, P, fit=fit,
                                  placement_solver=placement_solver,
                                  placement_seed=seed),
                    eval_jobs, seed)
    return {"fit": dataclasses.asdict(fit), "static": static,
            "hedged": hedged,
            "hedged_beats_static_p99":
                hedged["p99_jct"] < static["p99_jct"],
            "hedged_beats_static_mean":
                hedged["mean_jct"] < static["mean_jct"]}
