"""Straggler-aware replication: fit a straggler model from observed phase
times, price its barrier cost into the scheduler's (scheme, r) choice, and
hedge hybrid map replicas across racks.

The paper buys cheap cross-rack shuffle with extra map replication; this
module closes the loop the ROADMAP asks for: replication is ALSO the
classic straggler weapon, so the right r depends on the tail the cluster
actually exhibits.  Three pieces:

  * :func:`fit_straggler_model` — classify observed per-job map slowdowns
    (``JobStats.phase_times['map'] / expected unstraggled map seconds``)
    into ``none`` / ``exp_tail`` / ``rack`` and estimate the parameters of
    the matching :mod:`repro_torch.sim.cluster` model (`ExponentialTail`
    scale via the order-statistics identity
    ``E[max of K] = 1 + scale * H_K``; `RackCorrelated` ``p_slow`` via
    ``P(job hits a slow rack) = 1 - (1 - p_slow)^P`` and ``factor`` from
    the slow mode's mean).
  * :class:`StragglerFit` — the fitted model plus its
    :meth:`~StragglerFit.expected_barrier_factor`, the mean multiplicative
    inflation a K-server barrier phase suffers under the fit.
  * :class:`HedgedRPolicy` — the ``r_policy`` knob of
    :class:`repro_torch.sim.scheduler.SchemeChooser`: inflates every
    candidate's compute-phase estimates by the fitted barrier factor (so
    map-heavy high-r candidates pay their true straggler exposure, which
    the static chooser ignores) and replaces the random uniform replica
    placement of hybrid admissions with a deterministic rack-spread
    ``resolvable`` structured placement
    (:mod:`repro_torch.placement.structured`) — map replicas hedged across
    racks, so a slow rack neither concentrates fetch traffic nor owns sole
    copies.  It keeps refitting online from completed jobs.
"""
from __future__ import annotations

import dataclasses
import math
from collections import deque
from typing import Deque, Optional, Sequence

import numpy as np

from ..core.params import SchemeParams
from ..distributed.meshes import DeviceLike, resolve_device


def _harmonic(n: int) -> float:
    return sum(1.0 / i for i in range(1, max(n, 1) + 1))


@dataclasses.dataclass(frozen=True)
class StragglerFit:
    """A fitted straggler model: ``kind`` in {'none', 'exp_tail', 'rack'}
    with the matching simulator-model parameters."""
    kind: str
    scale: float = 0.0          # exp_tail: factors ~ 1 + Exp(scale)
    p_slow: float = 0.0         # rack: per-rack slowdown probability
    factor: float = 1.0         # rack: slowdown multiplier
    n_obs: int = 0

    def __post_init__(self) -> None:
        if self.kind not in ("none", "exp_tail", "rack"):
            raise ValueError(f"unknown fit kind {self.kind!r}")

    def expected_barrier_factor(self, K: int, P: int) -> float:
        """Mean multiplicative inflation of a K-server barrier phase:
        E[max_k factor_k].  exp_tail uses the exact max-of-exponentials
        order statistic; rack uses 'any of the P racks slow'."""
        if self.kind == "exp_tail":
            return 1.0 + self.scale * _harmonic(K)
        if self.kind == "rack":
            p_any = 1.0 - (1.0 - self.p_slow) ** P
            return 1.0 + p_any * (self.factor - 1.0)
        return 1.0


def fit_straggler_model(slowdowns: Sequence[float], K: int, P: int,
                        rack_sep: float = 1.6,
                        noise_floor: float = 1.05) -> StragglerFit:
    """Fit a :class:`StragglerFit` from observed per-job map slowdowns.

    ``slowdowns`` are ``observed map seconds / expected unstraggled map
    seconds`` per completed job — i.e. realizations of ``max_k factor_k``
    over the job's K-server barrier.  Classification: everything within
    ``noise_floor`` of 1 is 'none'; a separated bimodal cloud (slow mode >=
    ``rack_sep`` x the fast mode, fast mode near 1 — whole racks either hit
    or don't) fits 'rack'; anything else fits the exponential tail.
    """
    x = np.asarray([max(float(s), 1.0) for s in slowdowns], dtype=float)
    n = len(x)
    if n == 0 or float(x.max()) <= noise_floor:
        return StragglerFit("none", n_obs=n)
    split = 1.0 + 0.5 * (float(x.max()) - 1.0)
    hi, lo = x[x > split], x[x <= split]
    if (len(hi) > 0 and len(lo) > 0 and float(lo.mean()) <= noise_floor
            and float(hi.mean()) >= rack_sep * float(lo.mean())):
        # bimodal: jobs either hit >= 1 slow rack (the hi mode) or none
        q = len(hi) / n
        p_slow = 1.0 - (1.0 - min(q, 1.0 - 1e-12)) ** (1.0 / max(P, 1))
        return StragglerFit("rack", p_slow=float(p_slow),
                            factor=float(hi.mean()), n_obs=n)
    scale = max(float(x.mean()) - 1.0, 0.0) / _harmonic(K)
    return StragglerFit("exp_tail", scale=float(scale), n_obs=n)


class HedgedRPolicy:
    """Straggler-aware r-policy for :class:`repro_torch.sim.scheduler
    .SchemeChooser` (the ``r_policy=`` knob).

    * ``compute_inflation(scheme, r)`` — multiplier the chooser applies to
      every compute-phase estimate; derived from the current fit, so r's
      true straggler exposure is priced per candidate.
    * ``placement_for(p)`` — deterministic rack-spread structured replica
      placement (+ assignment solve) for hybrid admissions, replacing the
      chooser's random draw; returns ``None`` when hedging is off or
      :mod:`repro_torch.placement` rejects the instance.
    * ``observe(stats, expected_map_s)`` — online updates: the scheduler
      feeds every completed job's map time; the policy keeps a sliding
      window of slowdowns and refits every ``refit_every`` completions.

    A pre-computed :class:`StragglerFit` may be injected (offline
    calibration from a probe run); online observations then refine it.
    """

    def __init__(self, K: int, P: int, fit: Optional[StragglerFit] = None,
                 window: int = 64, refit_every: int = 8,
                 hedge_placement: bool = True,
                 placement_policy: str = "resolvable",
                 placement_solver: str = "flow",
                 placement_lam: float = 0.8,
                 placement_remote_penalty: float = 0.5,
                 placement_seed: int = 0,
                 placement_device: DeviceLike = None) -> None:
        """``placement_device`` is the device of the ``'anneal'`` solver
        (default: the CUDA card; with none, construction raises); it is
        resolved and passed to ``placement.solve`` only for that solver."""
        self.K = int(K)
        self.P = int(P)
        self.fit = fit or StragglerFit("none")
        self.window: Deque[float] = deque(maxlen=int(window))
        self.refit_every = int(refit_every)
        self.hedge_placement = bool(hedge_placement)
        self.placement_policy = placement_policy
        self.placement_solver = placement_solver
        self.placement_lam = float(placement_lam)
        self.placement_remote_penalty = float(placement_remote_penalty)
        self.placement_seed = int(placement_seed)
        self.placement_device = (resolve_device(placement_device)
                                 if placement_solver == "anneal" else None)
        self._since_fit = 0
        # structured placements are deterministic per (params, d): solve
        # each instance once (the catalog has a handful), not per admission
        self._placement_cache: dict = {}

    # ---- pricing -----------------------------------------------------------

    def compute_inflation(self, scheme: str, r: int) -> float:
        """Expected barrier inflation of one compute phase for a (scheme, r)
        candidate under the current fit.  The factor itself is r-invariant
        (barriers end at the slowest server either way) — but the chooser
        multiplies it into per-phase seconds that GROW with r, which is
        exactly the exposure the static chooser never prices."""
        return self.fit.expected_barrier_factor(self.K, self.P)

    # ---- hedged placement --------------------------------------------------

    def placement_for(self, p: SchemeParams, d: int = 1) -> Optional[object]:
        """Rack-spread structured placement for one hybrid admission, as
        :class:`repro_torch.placement.sim_bridge.PlacementTraffic` (None when
        hedging is off or the instance is structurally rejected)."""
        if not self.hedge_placement:
            return None
        key = (p, int(d))
        if key in self._placement_cache:
            return self._placement_cache[key]
        kw = ({} if self.placement_device is None
              else {"device": self.placement_device})
        try:
            from ..placement import (solve, structured_replicas,
                                     traffic_for_result)
            replicas = structured_replicas(p, policy=self.placement_policy)
            result = solve(p, replicas, self.placement_solver,
                           self.placement_lam,
                           rng=np.random.default_rng(self.placement_seed),
                           **kw)
            tr = traffic_for_result(result, d,
                                    self.placement_remote_penalty)
        except (ImportError, ValueError):
            tr = None
        self._placement_cache[key] = tr
        return tr

    # ---- online fitting ----------------------------------------------------

    def observe(self, stats: object, expected_map_s: float) -> None:
        """Feed one completed job (its ``phase_times['map']`` vs the
        chooser's unstraggled estimate); refits on a sliding window."""
        t = getattr(stats, "phase_times", {}).get("map")
        if t is None or expected_map_s <= 0:
            return
        self.window.append(max(float(t) / float(expected_map_s), 1.0))
        self._since_fit += 1
        if self._since_fit >= self.refit_every:
            self._since_fit = 0
            self.fit = fit_straggler_model(list(self.window), self.K, self.P)


def slowdowns_from_stats(stats: Sequence[object],
                         expected_map_s: Sequence[float]) -> list:
    """Observed map slowdowns of completed jobs (helper for offline
    calibration: zip a probe run's ``JobStats`` with unstraggled
    expectations and feed :func:`fit_straggler_model`)."""
    out = []
    for s, e in zip(stats, expected_map_s):
        t = getattr(s, "phase_times", {}).get("map")
        if t is not None and e > 0:
            out.append(max(float(t) / float(e), 1.0))
    return out
