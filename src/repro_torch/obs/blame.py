"""JCT blame decomposition: WHY a job took as long as it did.

The paper's argument is an attribution claim — JCT is dominated by where
bytes flow (cross-rack vs intra-rack) and hybrid coding wins by moving
blame between tiers.  This module turns a completed job into a
:class:`BlameReport` decomposing its JCT into named components under an
**exactness law**: the components sum to the measured JCT (zero residual
up to float round-off; the simulator pins ``<= 1e-9`` relative on the full
Table I grid).

Components (``COMPONENTS`` order)::

    queueing       admission wait: submit - arrival
    plan_compile   plan-compilation phase seconds
    fetch          zero-contention ideal of the pre-map input-fetch stage
    map            straggler-free ideal of the map barrier (placement
                   map_factors included — locality imbalance is map blame,
                   not straggle)
    map_straggle   actual map - ideal map (straggler inflation; can be
                   NEGATIVE when speculative backups beat the home server's
                   serial ideal)
    pack           pack barrier seconds (as measured)
    shuffle_cross  failure-free zero-contention ideal of the cross-rack
                   shuffle stages (root-switch drain + latency)
    shuffle_intra  same for the intra-rack stages (bottleneck ToR drain)
    contention     network sharing: sum over completed fetch/shuffle stage
                   runs of (actual - zero-contention ideal of that run)
    reduce         reduce barrier seconds (as measured)
    recovery       crash cost: wasted (crash-voided partial phases) + re-map
                   seconds + (degraded as-run shuffle ideal - failure-free
                   shuffle ideal)

Exactness follows by telescoping: ideal terms cancel against their
(actual - ideal) partners, leaving queueing + every recorded phase second +
crash-voided seconds = finish - arrival.

Two independent paths produce the same report: :func:`decompose` from a
job's bookkeeping (the simulator computes this at job completion and
stores it on ``JobStats.blame``), and :func:`extract_blame`, a
critical-path extractor that walks the ``phase_span`` events of the
structured trace (every sim phase is a barrier, so a single job's phase
chain IS its critical path), recovers crash-voided time from span gaps,
and cross-checks the stored decomposition.

This module is deliberately sim-free (duck-typed ``JobStats``) so
``repro_torch.sim`` can import it without a cycle.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

COMPONENTS: Tuple[str, ...] = (
    "queueing", "plan_compile", "fetch", "map", "map_straggle", "pack",
    "shuffle_cross", "shuffle_intra", "contention", "reduce", "recovery")

_SHUFFLE_TIERS = ("cross", "intra")


def decompose(jct: float, queueing: float, phase_times: Dict[str, float],
              ideal_times: Optional[Dict[str, float]] = None,
              ff_shuffle_ideal: Optional[Dict[str, float]] = None,
              wasted_s: float = 0.0) -> Dict[str, float]:
    """Blame components from a job's bookkeeping (see module docstring).

    ``phase_times`` are the measured phase seconds (``plan_compile``,
    ``fetch``, ``map``, ``pack``, ``shuffle:cross``, ``shuffle:intra``,
    ``remap``, ``reduce``); ``ideal_times`` the zero-contention /
    straggler-free ideals of the completed fetch, map, and (as-run) shuffle
    stage runs; ``ff_shuffle_ideal`` the failure-free shuffle ideals by
    tier; ``wasted_s`` the crash-voided partial-phase seconds.  Missing
    ideals default to the actuals (components degrade gracefully to the
    raw phase decomposition — the sum law holds regardless).
    """
    pt = phase_times
    it = ideal_times or {}
    map_act = pt.get("map", 0.0)
    map_ideal = it.get("map", map_act)
    fetch_act = pt.get("fetch", 0.0)
    fetch_ideal = it.get("fetch", fetch_act)
    sh_act = {k: pt.get(f"shuffle:{k}", 0.0) for k in _SHUFFLE_TIERS}
    sh_ideal = {k: it.get(f"shuffle:{k}", sh_act[k])
                for k in _SHUFFLE_TIERS}
    ff_src = ff_shuffle_ideal or {}
    ff = {k: ff_src.get(k, sh_ideal[k]) for k in _SHUFFLE_TIERS}
    return {
        "queueing": queueing,
        "plan_compile": pt.get("plan_compile", 0.0),
        "fetch": fetch_ideal,
        "map": map_ideal,
        "map_straggle": map_act - map_ideal,
        "pack": pt.get("pack", 0.0),
        "shuffle_cross": ff["cross"],
        "shuffle_intra": ff["intra"],
        "contention": ((fetch_act - fetch_ideal)
                       + sum(sh_act[k] - sh_ideal[k]
                             for k in _SHUFFLE_TIERS)),
        "reduce": pt.get("reduce", 0.0),
        "recovery": (wasted_s + pt.get("remap", 0.0)
                     + sum(sh_ideal[k] - ff[k] for k in _SHUFFLE_TIERS)),
    }


@dataclasses.dataclass(frozen=True)
class BlameReport:
    """One job's JCT decomposition.  ``components`` is keyed in
    ``COMPONENTS`` order (engine-side reports may carry extra fused keys
    like ``map_shuffle_reduce``); ``residual`` is the exactness-law check
    — the simulator keeps it at float round-off."""
    job_id: int
    name: str
    scheme: str
    r: int
    jct: float
    components: Dict[str, float]

    @property
    def residual(self) -> float:
        return self.jct - math.fsum(self.components.values())

    def dominant(self) -> str:
        """Component with the largest blame share."""
        return max(self.components, key=lambda k: (self.components[k], k))

    def share(self, component: str) -> float:
        return (self.components.get(component, 0.0) / self.jct
                if self.jct > 0 else 0.0)

    def to_dict(self) -> Dict[str, object]:
        return {"job_id": self.job_id, "name": self.name,
                "scheme": self.scheme, "r": self.r, "jct": self.jct,
                "components": dict(self.components),
                "residual": self.residual, "dominant": self.dominant()}


def blame_report(stats: object) -> BlameReport:
    """Build a :class:`BlameReport` from a completed job's ``JobStats``
    (duck-typed).  Uses the sim-computed ``stats.blame`` when present,
    else re-derives it from the raw bookkeeping fields."""
    comps = getattr(stats, "blame", None)
    if comps is None:
        comps = decompose(
            stats.finish - stats.arrival, stats.submit - stats.arrival,
            stats.phase_times, getattr(stats, "ideal_times", None),
            getattr(stats, "ff_shuffle_ideal", None),
            getattr(stats, "wasted_s", 0.0))
    return BlameReport(stats.job_id, stats.name, stats.scheme, stats.r,
                       stats.finish - stats.arrival, dict(comps))


# ---------------------------------------------------------------------------
# Critical-path extraction from the structured trace
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PathSegment:
    """One segment of a job's critical path: a phase span, or a ``__void__``
    gap where a crash discarded in-flight work (the span for that phase was
    never recorded because the phase never completed)."""
    phase: str
    start: float
    end: float

    @property
    def dur(self) -> float:
        return self.end - self.start


def critical_path(events: Iterable[object], job_id: int) -> List[PathSegment]:
    """Walk the ``phase_span`` events of one job into its critical path.

    Every sim phase is a BARRIER (map/pack/reduce end at the slowest
    server, a shuffle stage at its last flow + latency), so the phase chain
    of a single job is exactly its critical path: each span's end is the
    dependency that releases the next.  Gaps between consecutive spans are
    crash-voided work (a phase that was interrupted mid-flight leaves no
    span) and surface as ``__void__`` segments — their total equals the
    job's ``wasted_s``.
    """
    spans = sorted(
        (e for e in events
         if getattr(e, "kind", None) == "phase_span"
         and getattr(e, "job_id", None) == job_id
         and getattr(e, "dur", None) is not None),
        key=lambda e: (e.ts, e.ts + e.dur))
    path: List[PathSegment] = []
    for e in spans:
        if path and e.ts > path[-1].end + 1e-12 * max(1.0, abs(e.ts)):
            path.append(PathSegment("__void__", path[-1].end, e.ts))
        path.append(PathSegment(str(e.phase), e.ts, e.ts + e.dur))
    return path


def extract_blame(events: Iterable[object], stats: object,
                  check: bool = True, tol: float = 1e-9) -> BlameReport:
    """Critical-path extractor: rebuild a job's blame decomposition from
    the ``TraceEvent`` stream instead of trusting its recorded
    ``phase_times``.

    Actual phase seconds come from :func:`critical_path` (span durations,
    accumulated per phase; re-run shuffle stages accumulate like the sim
    does), crash-voided seconds from the ``__void__`` gaps, and queueing
    from (first span start - arrival).  Ideal-side inputs still come from
    ``stats`` (they are model quantities, not observable from the trace).
    With ``check=True`` the result is verified against the sim-computed
    ``stats.blame`` to ``tol`` relative — the two independent paths must
    agree.
    """
    path = critical_path(events, stats.job_id)
    if not path:
        raise ValueError(f"no phase_span events for job {stats.job_id}")
    actual: Dict[str, float] = {}
    wasted = 0.0
    for seg in path:
        if seg.phase == "__void__":
            wasted += seg.dur
        else:
            actual[seg.phase] = actual.get(seg.phase, 0.0) + seg.dur
    jct = stats.finish - stats.arrival
    comps = decompose(jct, path[0].start - stats.arrival, actual,
                      getattr(stats, "ideal_times", None),
                      getattr(stats, "ff_shuffle_ideal", None), wasted)
    stored = getattr(stats, "blame", None)
    if check and stored is not None:
        scale = max(1.0, abs(jct))
        for key in set(comps) | set(stored):
            diff = abs(comps.get(key, 0.0) - stored.get(key, 0.0))
            if diff > tol * scale:
                raise ValueError(
                    f"trace-extracted blame disagrees with recorded blame "
                    f"for job {stats.job_id}: {key} differs by {diff:g}")
    return BlameReport(stats.job_id, stats.name, stats.scheme, stats.r,
                       jct, comps)


# ---------------------------------------------------------------------------
# Fleet rollup
# ---------------------------------------------------------------------------

def _quantile(values: Sequence[float], q: float) -> float:
    """Linear-interpolation quantile (numpy 'linear' method) — local so the
    module stays dependency-free and deterministic."""
    xs = sorted(values)
    if not xs:
        return 0.0
    if len(xs) == 1:
        return xs[0]
    pos = q * (len(xs) - 1)
    lo = int(math.floor(pos))
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (pos - lo) * (xs[hi] - xs[lo])


def fleet_blame(reports: Sequence[BlameReport],
                q: float = 0.99) -> Dict[str, object]:
    """Fleet-level rollup: per-component mean / share / per-job quantile,
    plus the decomposition of the JCT TAIL — the mean blame of jobs at or
    above the ``q`` JCT quantile (what is making the p99 slow is the
    question coflow scheduling is judged on)."""
    n = len(reports)
    if n == 0:
        return {"n": 0, "q": q, "jct_mean": 0.0, "jct_q": 0.0,
                "mean": {}, "quantile": {}, "tail_mean": {},
                "tail_share": {}, "max_abs_residual": 0.0}
    keys = sorted({k for rep in reports for k in rep.components})
    jcts = [rep.jct for rep in reports]
    jct_q = _quantile(jcts, q)
    tail = [rep for rep in reports if rep.jct >= jct_q] or list(reports)
    mean = {k: math.fsum(rep.components.get(k, 0.0)
                         for rep in reports) / n for k in keys}
    tail_mean = {k: math.fsum(rep.components.get(k, 0.0)
                              for rep in tail) / len(tail) for k in keys}
    tail_jct = math.fsum(rep.jct for rep in tail)
    return {
        "n": n, "q": q,
        "jct_mean": math.fsum(jcts) / n,
        "jct_q": jct_q,
        "mean": mean,
        "quantile": {k: _quantile([rep.components.get(k, 0.0)
                                   for rep in reports], q) for k in keys},
        "tail_mean": tail_mean,
        "tail_share": {k: (tail_mean[k] * len(tail) / tail_jct
                           if tail_jct > 0 else 0.0) for k in keys},
        "max_abs_residual": max(abs(rep.residual) for rep in reports),
    }


# ---------------------------------------------------------------------------
# Engine-side adapter (measured device/host timings)
# ---------------------------------------------------------------------------

def blame_from_phase_timings(row: Dict[str, object],
                             intra_bw: Optional[float] = None,
                             cross_bw: Optional[float] = None
                             ) -> Dict[str, float]:
    """Blame components from a :func:`repro_torch.mapreduce.engine
    .measure_phase_timings` row (measured per-phase wall clock).

    Host phases map directly; the measured shuffle wall
    (``meta['shuffle_s']``) is split into ``shuffle_cross`` /
    ``shuffle_intra`` by the scheme's closed-form byte ratio — weighted by
    per-tier bandwidths when given, by raw value-units otherwise.  No
    queueing/straggle/contention terms exist in a solo measured run, so the
    exactness law here reduces to: components sum to the measured phase
    seconds plus the measured shuffle wall.
    """
    from ..core.costs import hybrid_cost
    from ..core.params import SchemeParams

    seconds: Dict[str, float] = dict(row.get("seconds", {}))  # type: ignore
    meta: Dict[str, object] = dict(row.get("meta", {}))       # type: ignore
    comps = {
        "plan_compile": float(seconds.get("plan_compile", 0.0)),
        "map": float(seconds.get("map", 0.0)),
        "pack": float(seconds.get("pack", 0.0)),
        "reduce": float(seconds.get("reduce", 0.0)),
    }
    shuffle_s = float(meta.get("shuffle_s", seconds.get("shuffle", 0.0)))
    if shuffle_s > 0:
        try:
            p = SchemeParams(K=int(meta["K"]), P=int(meta["P"]),
                             Q=int(meta["Q"]), N=int(meta["N"]),
                             r=int(meta["r"]))
            c = hybrid_cost(p, check=False)
            intra_w = c.intra / (intra_bw or 1.0)
            cross_w = c.cross / (cross_bw or 1.0)
        except (KeyError, ValueError, TypeError):
            intra_w = cross_w = 1.0
        tot = intra_w + cross_w
        cross_frac = cross_w / tot if tot > 0 else 0.5
        comps["shuffle_cross"] = shuffle_s * cross_frac
        comps["shuffle_intra"] = shuffle_s * (1.0 - cross_frac)
    return comps
