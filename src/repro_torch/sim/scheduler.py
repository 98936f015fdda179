"""Online multi-job scheduler over the cluster simulator: the counterpart
of the JAX package's ``sim/scheduler.py``, the same host NumPy logic (the
same decisions and traces from the same seed).  Its one addition is
``placement_device``, the device of the ``anneal`` placement solver.

Two separable decisions, both made ONLINE as jobs arrive:

  * **scheme choice** (:class:`SchemeChooser`): for each admitted job, pick
    (scheme, r) ∈ {uncoded} ∪ {coded, hybrid} x rs minimizing the job's
    estimated completion time under the CURRENT cluster load — estimated
    with the same cost model and stage-traffic closed forms the simulator
    itself uses, plus the observed backlog on the root/ToR switches and a
    plan-compile charge when the hybrid plan is not in the REAL LRU plan
    cache (:func:`repro_torch.core.coded_collectives.plan_cache_info`);
  * **admission order** (:class:`MultiJobScheduler`): at most
    ``max_concurrent`` jobs share the network at once; the queue drains in
    FIFO, SRPT (shortest estimated completion first) or FAIR
    (least-attained-service per job kind) order.

A fixed-scheme chooser (``adaptive=False``) is the baseline the benchmarks
compare against: same workload, same admission policy, every job forced to
one (scheme, r).
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.coded_collectives import compile_hybrid_plan, plan_cache_info
from ..core.params import SchemeParams
from ..core.plan_registry import family_of_scheme
from ..core.shuffle_plan import scheme_stage_traffic
from ..distributed.meshes import DeviceLike, resolve_device
from ..obs import blame as obs_blame
from ..obs import metrics as obs_metrics
from ..obs.drift import (DriftMonitor, record_blame,
                         record_component_errors)
from .cluster import ClusterSim, CostModel, JobStats, calibrate, phase_work
from .network import ROOT, tor
from .workload import JobSpec

POLICIES = ("fifo", "srpt", "fair")


@dataclasses.dataclass(frozen=True)
class Decision:
    scheme: str
    r: int
    est_jct: float
    compile_s: float            # plan-compile charge (0 on cache hit)
    cache_hit: bool
    # placement bridge of this admission (None unless the chooser runs a
    # placement solver and the job went hybrid): fetch traffic + map factors
    # handed to ClusterSim.submit, plus its achieved localities
    placement: Optional[object] = None
    # speculation policy handed to ClusterSim.submit (None = barrier map)
    speculation: Optional[object] = None
    # component-wise view of est_jct (repro_torch.obs.blame COMPONENTS keys),
    # priced by SchemeChooser.estimate_components for the WINNING candidate;
    # reconciled per-component against the job's actual blame at completion
    est_components: Optional[Dict[str, float]] = None


class SchemeChooser:
    """Greedy myopic (scheme, r) choice by minimum estimated JCT.

    The estimate mirrors the simulator's own model: per-phase affine compute
    costs (optionally inflated by ``expected_straggler`` — e.g. 1 + scale
    for an exponential tail, a quantity operators calibrate from history),
    sequential shuffle stages where each stage drains behind the resource's
    current backlog, and a plan-compile charge on hybrid plan-cache misses.
    It deliberately ignores FUTURE arrivals (online setting).
    """

    def __init__(self, K: int, cost_model: CostModel = CostModel(),
                 rs: Sequence[int] = (1, 2, 3),
                 schemes: Sequence[str] = ("uncoded", "coded", "hybrid",
                                           "hybrid_resolvable"),
                 adaptive: bool = True,
                 fixed: Tuple[str, int] = ("coded", 2),
                 expected_straggler: float = 1.0,
                 compile_real_plans: bool = True,
                 placement_solver: Optional[str] = None,
                 placement_r_f: int = 3,
                 placement_policy: str = "uniform",
                 placement_lam: float = 0.8,
                 placement_remote_penalty: float = 0.5,
                 placement_seed: int = 0,
                 speculation: Optional[object] = None,
                 r_policy: Optional[object] = None,
                 crash_prob: float = 0.0,
                 placement_device: DeviceLike = None) -> None:
        """``placement_solver`` turns on locality-aware placement for every
        hybrid admission: a registered :mod:`repro_torch.placement` solver name
        ('random', 'greedy', 'flow', 'local_search', 'anneal').  Each
        admitted hybrid job draws a random replica placement under
        ``placement_policy`` ('uniform' — the paper's model — or 'hdfs',
        Hadoop's rack-spread rule) with ``placement_r_f`` replicas,
        deterministic in ``placement_seed`` and the admission sequence,
        then solves the Section-IV assignment; the resulting fetch traffic
        + map-phase imbalance ride into the sim via
        :class:`Decision.placement` — and since the estimate prices that
        fetch traffic per candidate, a placement-heavy hybrid can LOSE an
        admission it would have won blind.  ``None`` (default) keeps the
        legacy locality-blind behavior.

        ``placement_device`` is the device the ``'anneal'`` solver's chains
        run on (default: the CUDA card; with none, construction raises —
        pass ``'cpu'`` to anneal on the host).  It is resolved only for
        that solver and passed to ``placement.solve`` only for it; there is
        no fallback to the CPU or to another solver.

        ``speculation`` (a :mod:`repro_torch.resilience.speculation` policy)
        rides into every admission's ``ClusterSim.submit`` — the map phase
        turns task-granular with speculative backups.

        ``r_policy`` (e.g. :class:`repro_torch.resilience.replication
        .HedgedRPolicy`) makes the chooser straggler-aware: candidate
        compute phases are inflated by ``r_policy.compute_inflation(scheme,
        r)`` instead of the static ``expected_straggler`` guess, and hybrid
        admissions take ``r_policy.placement_for(p)`` — a deterministic
        rack-hedged structured placement — over the random draw.  The
        :class:`MultiJobScheduler` feeds every completion back via
        ``r_policy.observe`` so the fit tracks the live cluster.

        ``crash_prob`` is the availability term: the operator's estimate of
        the probability that one server crashes during the job.  Each
        candidate is charged ``crash_prob`` times its expected recovery
        cost — the degraded re-shuffle draining behind the current
        backlogs, plus the re-map of orphaned subfiles where the candidate
        cannot decode around a single failure (r = 1 / uncoded re-run the
        dead server's whole map partition; r >= 2 re-map NOTHING for
        f <= r-1) — so replication r is priced as a failure-tolerance knob,
        not only a communication one.  0.0 (default) keeps the chooser
        availability-blind."""
        self.K = K
        self.cost_model = cost_model
        self.rs = tuple(rs)
        self.schemes = tuple(schemes)
        self.adaptive = adaptive
        self.fixed = fixed
        self.expected_straggler = float(expected_straggler)
        self.compile_real_plans = compile_real_plans
        self.placement_solver = placement_solver
        self.placement_r_f = int(placement_r_f)
        self.placement_policy = placement_policy
        self.placement_lam = float(placement_lam)
        self.placement_remote_penalty = float(placement_remote_penalty)
        self.placement_seed = int(placement_seed)
        self.speculation = speculation
        self.r_policy = r_policy
        self.crash_prob = float(crash_prob)
        self.placement_device = (resolve_device(placement_device)
                                 if placement_solver == "anneal" else None)
        self._placement_seq = 0
        self._admission_replicas: Optional[np.ndarray] = None

    def candidates(self) -> List[Tuple[str, int]]:
        """(scheme, r) grid: hybrid admits r = 1 (degenerates to uncoded
        layers); coded and hybrid_resolvable need r >= 2.  The chooser now
        prices binomial vs resolvable hybrids per admission — inadmissible
        combinations are dropped by :meth:`estimate` returning None."""
        out: List[Tuple[str, int]] = []
        if "uncoded" in self.schemes:
            out.append(("uncoded", 1))
        for scheme in ("coded", "hybrid", "hybrid_resolvable"):
            if scheme in self.schemes:
                out.extend((scheme, r) for r in self.rs if r >= 2 or
                           scheme == "hybrid")
        return out

    def _phase_inflation(self, scheme: str, r: int) -> float:
        """Per-candidate expected straggler inflation of compute phases:
        the fitted barrier factor when an ``r_policy`` is attached (so
        map-heavy high-r candidates pay their true exposure), else the
        static ``expected_straggler`` guess."""
        if self.r_policy is not None:
            return float(self.r_policy.compute_inflation(scheme, r))
        return self.expected_straggler

    def estimate(self, spec: JobSpec, scheme: str, r: int,
                 cluster: ClusterSim,
                 placement: Optional[object] = None) -> Optional[float]:
        """Estimated completion seconds for one candidate; None if the
        scheme's divisibility hypotheses reject (N, Q, r).

        ``placement`` (a ``PlacementTraffic``) makes the estimate
        FETCH-AWARE: the pre-map fetch drains behind the current root/ToR
        backlogs and the map phase is skewed by the placement's worst
        map-work factor — pricing a placement BEFORE choosing, not after.
        """
        try:
            p = SchemeParams(K=self.K, P=cluster.topology.P,
                             Q=spec.Q, N=spec.N, r=r)
            stages = scheme_stage_traffic(p, scheme, check=True)
        except ValueError:
            return None
        est = self._compile_charge(p, scheme, probe=False)[0]
        topo = cluster.topology
        if placement is not None and placement.total_units > 0:
            times = [0.0]
            if placement.cross_units > 0:
                load = placement.cross_units + cluster.network.backlog(ROOT)
                times.append(load / topo.capacity(ROOT))
            for rack, units in enumerate(placement.intra_units_per_rack):
                if units > 0:
                    load = units + cluster.network.backlog(tor(rack))
                    times.append(load / topo.capacity(tor(rack)))
            est += max(times) + topo.latency("fetch")
        map_skew = (max(placement.map_factors)
                    if placement is not None else 1.0)
        infl = self._phase_inflation(scheme, r)
        work = phase_work(p, scheme, spec.d)
        for phase in ("map", "pack", "reduce"):
            secs = self.cost_model.phase_coeffs(phase).seconds(work[phase])
            if phase == "map":
                secs *= map_skew
            est += infl * secs
        for stage in stages:
            times = [0.0]
            if stage.cross_pairs > 0:
                load = (stage.cross_pairs * spec.d
                        + cluster.network.backlog(ROOT))
                times.append(load / topo.capacity(ROOT))
            for rack, pairs in enumerate(stage.intra_pairs_per_rack):
                if pairs > 0:
                    load = pairs * spec.d + cluster.network.backlog(tor(rack))
                    times.append(load / topo.capacity(tor(rack)))
            est += max(times) + topo.latency(stage.stage)
        if self.crash_prob > 0.0:
            est += self.crash_prob * self._recovery_charge(p, scheme, spec,
                                                           cluster)
        return est

    def estimate_components(self, spec: JobSpec, scheme: str, r: int,
                            cluster: ClusterSim,
                            placement: Optional[object] = None
                            ) -> Optional[Dict[str, float]]:
        """Component-wise view of :meth:`estimate`, keyed like
        :data:`repro_torch.obs.blame.COMPONENTS`: the same pieces the estimate
        sums, attributed the same way the simulator attributes the actuals
        — zero-contention stage ideals under ``fetch`` / ``shuffle_*``,
        backlog-induced excess under ``contention``, straggler inflation of
        the map barrier under ``map_straggle``, and the availability charge
        under ``recovery``.  Components sum to :meth:`estimate` up to float
        round-off (``estimate`` itself is untouched — admission decisions
        are bit-identical with or without this view).  ``queueing`` is 0:
        the estimate is priced AT admission and predicts finish - submit.
        """
        try:
            p = SchemeParams(K=self.K, P=cluster.topology.P,
                             Q=spec.Q, N=spec.N, r=r)
            stages = scheme_stage_traffic(p, scheme, check=True)
        except ValueError:
            return None
        comps = {k: 0.0 for k in obs_blame.COMPONENTS}
        comps["plan_compile"] = self._compile_charge(p, scheme,
                                                     probe=False)[0]
        topo = cluster.topology
        if placement is not None and placement.total_units > 0:
            ideal = [0.0]
            loaded = [0.0]
            if placement.cross_units > 0:
                cap = topo.capacity(ROOT)
                ideal.append(placement.cross_units / cap)
                loaded.append((placement.cross_units
                               + cluster.network.backlog(ROOT)) / cap)
            for rack, units in enumerate(placement.intra_units_per_rack):
                if units > 0:
                    cap = topo.capacity(tor(rack))
                    ideal.append(units / cap)
                    loaded.append((units
                                   + cluster.network.backlog(tor(rack)))
                                  / cap)
            comps["fetch"] = max(ideal) + topo.latency("fetch")
            comps["contention"] += max(loaded) - max(ideal)
        map_skew = (max(placement.map_factors)
                    if placement is not None else 1.0)
        infl = self._phase_inflation(scheme, r)
        work = phase_work(p, scheme, spec.d)
        for phase in ("map", "pack", "reduce"):
            secs = self.cost_model.phase_coeffs(phase).seconds(work[phase])
            if phase == "map":
                comps["map"] = secs * map_skew
                comps["map_straggle"] = (infl - 1.0) * secs * map_skew
            else:
                comps[phase] = infl * secs
        for stage in stages:
            ideal = [0.0]
            loaded = [0.0]
            if stage.cross_pairs > 0:
                cap = topo.capacity(ROOT)
                ideal.append(stage.cross_pairs * spec.d / cap)
                loaded.append((stage.cross_pairs * spec.d
                               + cluster.network.backlog(ROOT)) / cap)
            for rack, pairs in enumerate(stage.intra_pairs_per_rack):
                if pairs > 0:
                    cap = topo.capacity(tor(rack))
                    ideal.append(pairs * spec.d / cap)
                    loaded.append((pairs * spec.d
                                   + cluster.network.backlog(tor(rack)))
                                  / cap)
            comps[f"shuffle_{stage.stage}"] += (max(ideal)
                                                + topo.latency(stage.stage))
            comps["contention"] += max(loaded) - max(ideal)
        if self.crash_prob > 0.0:
            comps["recovery"] = self.crash_prob * self._recovery_charge(
                p, scheme, spec, cluster)
        return comps

    def _recovery_charge(self, p: SchemeParams, scheme: str, spec: JobSpec,
                         cluster: ClusterSim) -> float:
        """Expected seconds to recover from ONE server crash mid-shuffle
        (the availability term): the candidate's degraded re-shuffle
        draining behind the current backlogs, plus — where a single failure
        orphans subfiles (r = 1 / uncoded) — a conservative serial re-map
        of the dead server's partition.  r >= 2 candidates re-map nothing,
        so a rising ``crash_prob`` shifts choices toward replication."""
        from ..core.degraded import degraded_stage_traffic
        topo = cluster.topology
        stages, n_remap = degraded_stage_traffic(p, scheme, (0,))
        t = 0.0
        if n_remap:
            t += self._phase_inflation(scheme, p.r) * \
                self.cost_model.map.seconds(float(n_remap) * spec.Q * spec.d)
        for stage in stages:
            times = [0.0]
            if stage.cross_pairs > 0:
                load = (stage.cross_pairs * spec.d
                        + cluster.network.backlog(ROOT))
                times.append(load / topo.capacity(ROOT))
            for rack, pairs in enumerate(stage.intra_pairs_per_rack):
                if pairs > 0:
                    load = pairs * spec.d + cluster.network.backlog(tor(rack))
                    times.append(load / topo.capacity(tor(rack)))
            t += max(times) + topo.latency(stage.stage)
        return t

    def _compile_charge(self, p: SchemeParams, scheme: str,
                        probe: bool) -> Tuple[float, bool]:
        """(compile seconds, cache_hit).  With ``probe``, actually compiles
        the scheme family's plan through the LRU cache and reads the
        PER-FAMILY hit/miss delta from :func:`plan_cache_info` — the cache
        keys on (params, perm, family), so probing a binomial candidate
        never counterfeits a hit for its resolvable sibling."""
        family = family_of_scheme(scheme)
        if family is None or not self.compile_real_plans:
            return 0.0, True
        if probe:
            before = plan_cache_info().families.get(family)
            try:
                compile_hybrid_plan(p, family=family)
                now = plan_cache_info().families[family]
                hit = now.hits > (before.hits if before else 0)
            except ValueError:
                # closed-form-admissible but not executable (r | M fails):
                # nothing cacheable — charge a fresh compile every time
                hit = False
        else:
            hit = False                      # pessimistic while estimating
        if hit:
            return 0.0, True
        return self.cost_model.plan_compile.seconds(p.N), False

    def choose(self, spec: JobSpec, cluster: ClusterSim) -> Decision:
        self._placement_seq += 1          # one replica draw per admission
        self._admission_replicas = None
        if self.adaptive:
            best: Optional[Tuple[float, str, int, Optional[object]]] = None
            for scheme, r in self.candidates():
                est = self.estimate(spec, scheme, r, cluster)
                if est is None:
                    continue                       # inadmissible candidate
                tr = self._candidate_placement(spec, scheme, r, cluster)
                if tr is not None:                 # price the fetch traffic
                    est = self.estimate(spec, scheme, r, cluster,
                                        placement=tr)
                if best is None or est < best[0]:
                    best = (est, scheme, r, tr)
            if best is None:
                raise ValueError(f"no admissible (scheme, r) for {spec}")
            est, scheme, r, placement = best
        else:
            scheme, r = self.fixed
            est = self.estimate(spec, scheme, r, cluster)
            if est is None:
                raise ValueError(
                    f"fixed (scheme, r)={self.fixed} is inadmissible for "
                    f"{spec}; build the workload catalog with "
                    f"valid_subfile_counts so baselines cover the stream")
            placement = self._candidate_placement(spec, scheme, r, cluster)
            if placement is not None:
                est = self.estimate(spec, scheme, r, cluster,
                                    placement=placement)
        p = SchemeParams(K=self.K, P=cluster.topology.P,
                         Q=spec.Q, N=spec.N, r=r, r_f=self.placement_r_f)
        compile_s, hit = self._compile_charge(p, scheme, probe=True)
        obs_metrics.counter(
            "chooser_decisions_total",
            "scheme decisions by (scheme, r, family)").inc(
                scheme=scheme, r=r, family=family_of_scheme(scheme) or "none")
        est_components = self.estimate_components(spec, scheme, r, cluster,
                                                  placement=placement)
        return Decision(scheme, r, est, compile_s, hit, placement,
                        self.speculation, est_components)

    def _candidate_placement(self, spec: JobSpec, scheme: str, r: int,
                             cluster: ClusterSim) -> Optional[object]:
        """Placement traffic of one (admissible) hybrid candidate: the
        r_policy's rack-hedged structured placement when attached, else the
        admission's random replica draw (shared across the candidate rs —
        replicas are r-invariant) solved per r.  None when both knobs are
        off or the instance is structurally rejected.  Imported lazily: the
        sim stays usable without repro_torch.placement.  Resolvable hybrids
        stay placement-blind for now: the Section-IV solver suite reasons over
        the binomial family's rack r-subsets."""
        if scheme != "hybrid":
            return None
        p = SchemeParams(K=self.K, P=cluster.topology.P,
                         Q=spec.Q, N=spec.N, r=r, r_f=self.placement_r_f)
        if self.r_policy is not None:
            tr = self.r_policy.placement_for(p, spec.d)
            if tr is not None:
                return tr
        if self.placement_solver is None:
            return None
        from ..placement import place_replicas, solve, traffic_for_result
        if self._admission_replicas is None:
            rng = np.random.default_rng(
                (self.placement_seed, self._placement_seq))
            self._admission_replicas = place_replicas(
                p, rng, self.placement_policy)
        kw = ({} if self.placement_device is None
              else {"device": self.placement_device})
        try:
            result = solve(p, self._admission_replicas,
                           self.placement_solver, self.placement_lam,
                           rng=np.random.default_rng(
                               (self.placement_seed, self._placement_seq,
                                r)), **kw)
        except ValueError:
            return None
        return traffic_for_result(result, spec.d,
                                  self.placement_remote_penalty)


class MultiJobScheduler:
    """Admits an arrival stream into a :class:`ClusterSim` under a queueing
    policy, consulting a :class:`SchemeChooser` per admission (decisions see
    the cluster state AT ADMISSION, so queued jobs are re-priced when
    capacity frees up)."""

    def __init__(self, chooser: SchemeChooser, policy: str = "fifo",
                 max_concurrent: int = 4,
                 drift: Optional[DriftMonitor] = None,
                 recalibrate: bool = False, refit_window: int = 16,
                 refit_min_rows: int = 4) -> None:
        """Every admission's predicted JCT (:class:`Decision.est_jct`) is
        reconciled against the completed job's actual JCT through
        ``drift`` (a :class:`repro_torch.obs.DriftMonitor`; a default
        ``layer='sim'`` monitor is built when None) — the registry's
        ``jct_*`` histograms/gauges always see the stream.

        ``recalibrate=True`` closes the loop online: completed jobs'
        barrier phase times are kept as calibration rows (the last
        ``refit_window`` of them), and when the monitor's EWMA crosses its
        drift threshold the chooser's cost model is refitted from that
        live stream via :func:`repro_torch.sim.calibrate` (straggler inflation
        is absorbed into the refitted betas).  The stale model's regret is
        banked by the monitor at each refit.  Default False: no behavior
        change, telemetry only."""
        if policy not in POLICIES:
            raise ValueError(f"policy must be one of {POLICIES}")
        if max_concurrent < 1:
            raise ValueError("max_concurrent must be >= 1")
        self.chooser = chooser
        self.policy = policy
        self.max_concurrent = max_concurrent
        self.drift = drift if drift is not None else DriftMonitor()
        self.recalibrate = recalibrate
        self.refit_min_rows = int(refit_min_rows)
        self.decisions: Dict[int, Decision] = {}
        self._queue: List[Tuple[int, JobSpec]] = []
        self._running = 0
        self._seq = 0
        self._service_by_kind: Dict[str, float] = {}
        self._expected_map: Dict[int, float] = {}
        self._specs: Dict[int, JobSpec] = {}
        self._rows: Deque[Dict] = deque(maxlen=int(refit_window))

    # ---- policy ordering ---------------------------------------------------

    def _pop_next(self, cluster: ClusterSim) -> Tuple[int, JobSpec]:
        if self.policy == "fifo":
            idx = 0
        elif self.policy == "srpt":
            ests = [min((e for e in (self.chooser.estimate(s, sch, r, cluster)
                                     for sch, r in self.chooser.candidates())
                         if e is not None), default=float("inf"))
                    for _, s in self._queue]
            idx = int(np.argmin(ests))
        else:                                   # fair: least attained service
            attained = [self._service_by_kind.get(s.name, 0.0)
                        for _, s in self._queue]
            idx = int(np.argmin(attained))
        return self._queue.pop(idx)

    # ---- driving the sim ---------------------------------------------------

    def run(self, jobs: Sequence[JobSpec],
            cluster: ClusterSim) -> List[JobStats]:
        cluster.on_job_done = lambda stats: self._job_done(stats, cluster)
        for spec in sorted(jobs, key=lambda s: s.arrival):
            cluster.at(spec.arrival,
                       lambda s=spec: self._arrive(s, cluster), "arrival")
        return cluster.run()

    def _arrive(self, spec: JobSpec, cluster: ClusterSim) -> None:
        self._queue.append((self._seq, spec))
        self._seq += 1
        cluster.tracer.event("sched_arrival",
                             data=(spec.name, len(self._queue)),
                             policy=self.policy)
        self._drain(cluster)

    def _job_done(self, stats: JobStats, cluster: ClusterSim) -> None:
        self._running -= 1
        rp = self.chooser.r_policy
        if rp is not None:
            # feed the observed map slowdown back into the straggler fit
            rp.observe(stats, self._expected_map.pop(stats.job_id, 0.0))
        self._reconcile(stats, cluster)
        cluster.tracer.event("sched_drain", job_id=stats.job_id,
                             data=(self._running, len(self._queue)),
                             policy=self.policy)
        self._drain(cluster)

    def _reconcile(self, stats: JobStats, cluster: ClusterSim) -> None:
        """Predicted-vs-actual JCT for one completion; refit on drift."""
        d = self.decisions.get(stats.job_id)
        spec = self._specs.pop(stats.job_id, None)
        if d is None:
            return
        # est_jct was priced AT ADMISSION (= submit time), so the actual
        # it predicts is finish - submit, not the arrival-based stats.jct
        fired = self.drift.observe(d.est_jct, stats.finish - stats.submit,
                                   scheme=d.scheme)
        if stats.blame is not None:
            # per-admission blame: fold the job's decomposition into the
            # fleet gauges, and break the chooser's miss down by component
            # (queueing is outside the estimate's scope — see
            # estimate_components — so it is excluded from the comparison)
            record_blame(stats.blame, layer="sim", scheme=d.scheme)
            if d.est_components is not None:
                actual = dict(stats.blame)
                actual["queueing"] = 0.0
                record_component_errors(d.est_components, actual,
                                        layer="sim", scheme=d.scheme)
        if not self.recalibrate or spec is None:
            return
        from .calibration import measurement_row_from_stats
        p = SchemeParams(K=self.chooser.K, P=cluster.topology.P,
                         Q=spec.Q, N=spec.N, r=d.r)
        self._rows.append(
            measurement_row_from_stats(stats, p, d.scheme, spec.d))
        if fired and len(self._rows) >= self.refit_min_rows:
            self.chooser.cost_model = calibrate(list(self._rows))
            self.drift.refitted()
            cluster.tracer.event("sched_refit", job_id=stats.job_id,
                                 data=(len(self._rows),),
                                 policy=self.policy)

    def _drain(self, cluster: ClusterSim) -> None:
        while self._queue and self._running < self.max_concurrent:
            _, spec = self._pop_next(cluster)
            d = self.chooser.choose(spec, cluster)
            job_id = cluster.submit(spec, d.scheme, d.r,
                                    compile_s=d.compile_s,
                                    placement=d.placement,
                                    speculation=d.speculation)
            self.decisions[job_id] = d
            self._specs[job_id] = spec
            # no cache_hit label: it reflects process-global plan-cache
            # state, which would break per-seed bit-identical traces
            cluster.tracer.event("sched_admit", job_id=job_id,
                                 data=(spec.name, d.scheme, d.r),
                                 scheme=d.scheme, r=d.r, policy=self.policy)
            if self.chooser.r_policy is not None:
                p = SchemeParams(K=self.chooser.K, P=cluster.topology.P,
                                 Q=spec.Q, N=spec.N, r=d.r)
                exp = self.chooser.cost_model.map.seconds(
                    phase_work(p, d.scheme, spec.d)["map"])
                if d.placement is not None:      # locality skew is expected,
                    exp *= max(d.placement.map_factors)  # not straggling
                self._expected_map[job_id] = exp
            self._service_by_kind[spec.name] = (
                self._service_by_kind.get(spec.name, 0.0) + d.est_jct)
            self._running += 1


def run_scheduled(jobs: Sequence[JobSpec], cluster: ClusterSim,
                  chooser: SchemeChooser, policy: str = "fifo",
                  max_concurrent: int = 4
                  ) -> Tuple[List[JobStats], MultiJobScheduler]:
    """Convenience wrapper: schedule ``jobs`` on ``cluster``; returns
    (per-job stats, the scheduler with its per-job decisions)."""
    sched = MultiJobScheduler(chooser, policy, max_concurrent)
    stats = sched.run(jobs, cluster)
    return stats, sched
