"""Deterministic discrete-event cluster simulator for (Hybrid) Coded
MapReduce on a server-rack architecture.

A job advances through the phases of the executable pipeline
(:mod:`repro_torch.mapreduce.engine`):

    [plan compile] -> [fetch] -> map -> pack -> shuffle (stages) -> reduce

(``fetch`` appears only for jobs submitted with a placement bridge: the
non-local map inputs of a :mod:`repro_torch.placement` placement move over the
network before map starts — see ``submit(placement=...)``.)

Compute phases (map / pack / reduce) run per server with an affine cost
``alpha + beta * work`` (work units documented on :class:`CostModel`),
multiplied by a pluggable straggler factor, and complete at a barrier (the
phase ends when the SLOWEST server does — stragglers hurt exactly as in
practice).  The shuffle runs as fluid flows on the two-tier network of
:mod:`repro_torch.sim.network`, where concurrent jobs contend for the root
and ToR switches under fair share.  Shuffle stage loads come from the stage-traffic
export of :mod:`repro_torch.core.shuffle_plan` (enumerated schedules) or its
closed-form equivalent — i.e. the simulated traffic IS the schedule the
executable shuffle moves.

Everything is driven by one seeded ``numpy`` Generator and a sequence-
numbered event queue, so a (workload, topology, seed) triple reproduces a
bit-identical event trace.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import (Callable, Deque, Dict, List, Optional, Sequence, Set,
                    Tuple)

import numpy as np

from ..core.assignment import (coded_assignment, hybrid_assignment,
                               uncoded_assignment)
from ..core.degraded import degraded_stage_traffic
from ..core.params import SchemeParams
from ..core.shuffle_plan import StageTraffic, scheme_stage_traffic
from ..obs import blame as obs_blame
from ..obs import metrics as obs_metrics
from ..obs.tracing import Tracer
from .events import Event, EventQueue, TraceEntry
from .network import (ROOT, FluidNetwork, NetworkTelemetry, RackTopology,
                      tor)
from .workload import JobSpec

COMPUTE_PHASES = ("map", "pack", "reduce")


# ---------------------------------------------------------------------------
# Phase cost model + calibration
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PhaseCoeffs:
    """``seconds = alpha + beta * work`` for one phase on one server."""
    alpha: float = 0.0
    beta: float = 0.0

    def seconds(self, work: float) -> float:
        return self.alpha + self.beta * work


@dataclasses.dataclass(frozen=True)
class CostModel:
    """Per-phase affine compute costs.

    Work units (value-units, matching the network's pair x width unit):
      * map    — intermediate values computed per server: n_loc * Q * d
      * pack   — values gathered/laid out per server:     n_loc * Q * d
      * reduce — values folded per server:                N * (Q/K) * d
      * plan_compile — subfiles N (charged once per plan-cache MISS; the
        scheduler reads `repro_torch.core.coded_collectives.plan_cache_info`)
    """
    map: PhaseCoeffs = PhaseCoeffs()
    pack: PhaseCoeffs = PhaseCoeffs()
    reduce: PhaseCoeffs = PhaseCoeffs()
    plan_compile: PhaseCoeffs = PhaseCoeffs()

    def phase_coeffs(self, phase: str) -> PhaseCoeffs:
        return getattr(self, phase)


ZERO_COST = CostModel()


def phase_work(p: SchemeParams, scheme: str, d: int) -> Dict[str, float]:
    """Per-server work units of each compute phase (see :class:`CostModel`).

    ``n_loc`` is the per-server map load: N/K subfiles uncoded, r-fold
    replicated (rN/K) for coded and hybrid — the computation side of the
    paper's computation/communication tradeoff.
    """
    repl = 1 if scheme == "uncoded" else p.r
    n_loc = p.N * repl / p.K
    return {
        "map": n_loc * p.Q * d,
        "pack": n_loc * p.Q * d,
        "reduce": p.N * (p.Q / p.K) * d,
    }


def _fit_affine(work: np.ndarray, secs: np.ndarray) -> PhaseCoeffs:
    """Least-squares fit of secs ~ alpha + beta * work (alpha clipped >= 0)."""
    if len(work) < 2:                     # underdetermined: pure rate model
        return PhaseCoeffs(alpha=0.0,
                           beta=float(max(secs[0] / max(work[0], 1e-12), 0.0)))
    A = np.stack([np.ones_like(work), work], axis=1)
    (alpha, beta), *_ = np.linalg.lstsq(A, secs, rcond=None)
    return PhaseCoeffs(alpha=float(max(alpha, 0.0)), beta=float(max(beta, 0.0)))


def calibrate(measurements: Sequence[Dict[str, object]]) -> CostModel:
    """Fit per-phase alpha/beta from measured phase timings.

    ``measurements`` rows come from
    :func:`repro_torch.mapreduce.engine.measure_phase_timings` (preferred: true
    per-phase split on the real pipeline) or from ``BENCH_pipeline.json``
    rows adapted via :func:`measurements_from_pipeline_bench`.  Each row
    holds ``work`` and ``seconds`` dicts keyed by phase name; phases missing
    everywhere keep zero cost.
    """
    fitted: Dict[str, PhaseCoeffs] = {}
    for phase in COMPUTE_PHASES + ("plan_compile",):
        work, secs = [], []
        for row in measurements:
            w = row["work"].get(phase)            # type: ignore[union-attr]
            s = row["seconds"].get(phase)         # type: ignore[union-attr]
            if w is not None and s is not None:
                work.append(float(w))
                secs.append(float(s))
        if work:
            fitted[phase] = _fit_affine(np.asarray(work), np.asarray(secs))
    return CostModel(**fitted)


#: envelope version of ``BENCH_pipeline.json`` this adapter understands
#: (written by ``benchmarks/_common.emit_report`` — bump together)
PIPELINE_BENCH_SCHEMA_VERSION = 1


def measurements_from_pipeline_bench(report: Dict) -> List[Dict[str, object]]:
    """Adapt ``BENCH_pipeline.json`` rows into :func:`calibrate` rows.

    The legacy-path phase split maps onto the model as: ``map_to_host`` is a
    single-device map of all N subfiles (work N*Q*d), ``host_pack_upload``
    moves the r-fold replicated packed tensor (work r*N*Q*d); the fused
    ``shuffle_reduce`` phase is not separable there — use
    ``measure_phase_timings`` for reduce calibration.

    The report must carry the benchmark envelope of the version this
    adapter understands — a silent schema drift here would mis-calibrate
    every downstream simulation, so an unknown ``schema_version`` raises.
    """
    ver = report.get("schema_version")
    if ver != PIPELINE_BENCH_SCHEMA_VERSION:
        raise ValueError(
            f"BENCH_pipeline report carries schema_version={ver!r}, but "
            f"this adapter understands version "
            f"{PIPELINE_BENCH_SCHEMA_VERSION}. Regenerate the artifact "
            f"with `PYTHONPATH=src python benchmarks/pipeline_bench.py` "
            f"(or update measurements_from_pipeline_bench for the new "
            f"envelope).")
    rows = []
    for x in report.get("results", []):
        N, Q, d, r = x["N"], x["Q"], x["d"], x["r"]
        ph = x["legacy"]["phases_s"]
        rows.append({
            "work": {"map": N * Q * d, "pack": r * N * Q * d},
            "seconds": {"map": ph["map_to_host"],
                        "pack": ph["host_pack_upload"]},
        })
    return rows


# ---------------------------------------------------------------------------
# Straggler models
# ---------------------------------------------------------------------------

class StragglerModel:
    """Multiplicative per-server slowdown factors (>= 1) for one compute
    phase of one job.  Sampled once per (job, phase) from the simulator's
    seeded rng — and, when speculative re-execution is active, RESAMPLED per
    map *wave*: every batch of backup launches draws fresh factors, so a
    re-launched task sees new luck instead of replaying the wave-0 draw.
    Deterministic given the seed either way."""

    def factors(self, rng: np.random.Generator, K: int, P: int) -> np.ndarray:
        raise NotImplementedError


class NoStragglers(StragglerModel):
    def factors(self, rng: np.random.Generator, K: int, P: int) -> np.ndarray:
        return np.ones(K)


@dataclasses.dataclass
class DeterministicSlowdown(StragglerModel):
    """Fixed per-server factors (e.g. one known-slow machine)."""
    server_factors: Tuple[float, ...]

    def factors(self, rng: np.random.Generator, K: int, P: int) -> np.ndarray:
        f = np.asarray(self.server_factors, dtype=float)
        if f.shape != (K,):
            raise ValueError(f"need {K} per-server factors, got {f.shape}")
        if (f < 1.0).any():
            raise ValueError("slowdown factors must be >= 1")
        return f


@dataclasses.dataclass
class ExponentialTail(StragglerModel):
    """1 + Exp(scale) per server — the classic heavy-tail straggler model."""
    scale: float = 0.2

    def factors(self, rng: np.random.Generator, K: int, P: int) -> np.ndarray:
        return 1.0 + rng.exponential(self.scale, size=K)


@dataclasses.dataclass
class RackCorrelated(StragglerModel):
    """Whole racks slow down together (shared ToR/PDU failures): each rack
    is slowed by ``factor`` with probability ``p_slow``."""
    p_slow: float = 0.1
    factor: float = 3.0

    def factors(self, rng: np.random.Generator, K: int, P: int) -> np.ndarray:
        slow = rng.random(P) < self.p_slow
        per_rack = np.where(slow, self.factor, 1.0)
        return np.repeat(per_rack, K // P)


# ---------------------------------------------------------------------------
# Task-granular map phase with speculative re-execution
# ---------------------------------------------------------------------------
#
# With ``submit(speculation=policy)`` the map phase stops being one barrier
# event and becomes per-task execution: every server runs its assigned
# subfile chunks sequentially on one map slot, a pluggable policy
# (the JAX package's ``resilience/speculation.py``, not ported yet —
# duck-typed here, so any object with its hooks will do) observes progress and launches BACKUP
# attempts that contend for real slots (they queue behind the target
# server's own tasks) and for fetch bandwidth (a backup without a local
# input replica moves the input through the fluid network first).  The
# first finisher wins: losing attempts are cancelled — queued ones are
# dropped, fetching ones abort their flow, running ones cancel their
# completion event and free the slot immediately.

@dataclasses.dataclass
class MapTaskAttempt:
    """One execution attempt of one map task on one server."""
    attempt_id: int
    task: "MapTask"
    server: int
    wave: int                       # straggler wave the attempt belongs to
    is_backup: bool
    state: str = "queued"           # queued|fetching|running|done|cancelled
    start: float = -1.0             # compute start time (state >= running)
    fetch_flow: Optional[int] = None
    event: Optional[Event] = None   # pending completion event


@dataclasses.dataclass
class MapTask:
    """One map task: a chunk of the subfiles one server must map.

    ``stores`` are the servers holding the task's input locally (the other
    mappers of the same subfiles) — a backup attempt elsewhere must fetch
    the input intra-rack (replica in its rack) or through the root switch.
    """
    index: int
    server: int                     # home server (whose map output this is)
    subfiles: Tuple[int, ...]
    work: float                     # compute value-units (len * Q * d)
    input_units: float              # network value-units of the raw input
    stores: Tuple[int, ...]
    done: bool = False
    finish: float = -1.0
    attempts: List[MapTaskAttempt] = dataclasses.field(default_factory=list)


def _map_assignment(p: SchemeParams, scheme: str
                    ) -> Tuple[List[List[int]], List[Tuple[int, ...]]]:
    """(subfiles_of_server, servers_of_subfile) of the scheme's real map
    assignment; divisibility-violating instances (simulated with
    ``check=False``, as the paper's Table I does) fall back to a balanced
    round-robin with the same replication factor."""
    try:
        from ..core.resolvable import resolvable_assignment
        mk = {"uncoded": uncoded_assignment, "coded": coded_assignment,
              "hybrid": hybrid_assignment,
              "hybrid_resolvable": resolvable_assignment}[scheme]
        a = mk(p)
        return a.subfiles_of_server, [tuple(s) for s in a.servers_of_subfile]
    except ValueError:
        repl = 1 if scheme == "uncoded" else min(p.r, p.K)
        per: List[List[int]] = [[] for _ in range(p.K)]
        servers_of: List[Tuple[int, ...]] = []
        step = max(1, p.K // repl)
        for i in range(p.N):
            srvs = tuple(sorted((i + j * step) % p.K for j in range(repl)))
            servers_of.append(srvs)
            for s in srvs:
                per[s].append(i)
        return per, servers_of


def _chunk(seq: List[int], n_chunks: Optional[int]) -> List[List[int]]:
    """Split one server's subfile list into tasks: per-subfile by default,
    or ``n_chunks`` near-equal chunks when the policy coalesces."""
    if n_chunks is None or n_chunks <= 0 or n_chunks >= len(seq):
        return [[i] for i in seq]
    return [list(c) for c in np.array_split(np.asarray(seq), n_chunks) if
            len(c)]


class TaskMapPhase:
    """Engine of one job's task-granular map phase (see module comment).

    Doubles as the VIEW handed to speculation-policy hooks: policies read
    ``now / tasks / running / remaining / mean_rate() / rack_rates() /
    server_load() / elapsed() / live_backup() / pick_backup_server()`` and
    return ``[(task_index, server), ...]`` backup requests; the engine
    enforces the budget, slot contention and first-finisher-wins.
    """

    def __init__(self, sim: "ClusterSim", job: "_SimJob",
                 policy: object) -> None:
        self.sim = sim
        self.job = job
        self.policy = policy
        self.K = sim.K
        self.P = sim.topology.P
        self.Kr = self.K // self.P
        p, d = job.params, job.spec.d
        per_server, servers_of = _map_assignment(p, job.scheme)
        unit = float(p.Q * d)            # value-units per subfile (in + out)
        n_chunks = getattr(policy, "tasks_per_server", None)
        self.tasks: List[MapTask] = []
        self.queues: List[Deque[MapTaskAttempt]] = \
            [deque() for _ in range(self.K)]
        self.running: List[Optional[MapTaskAttempt]] = [None] * self.K
        self._attempts: Dict[int, MapTaskAttempt] = {}
        self._next_attempt = 0
        for s in range(self.K):
            for chunk in _chunk(per_server[s], n_chunks):
                stores = set(servers_of[chunk[0]])
                for i in chunk[1:]:
                    stores &= set(servers_of[i])
                stores.add(s)
                task = MapTask(len(self.tasks), s, tuple(chunk),
                               len(chunk) * unit, len(chunk) * unit,
                               tuple(sorted(stores)))
                self.tasks.append(task)
        self.remaining = len(self.tasks)
        self.backup_budget = int(policy.backup_budget(len(self.tasks)))
        self.backups_launched = 0
        self.wave = 0
        pl = job.placement
        self.pl_factors = (np.asarray(pl.map_factors, dtype=float)
                           if pl is not None else np.ones(self.K))
        self.wave_factors: List[np.ndarray] = []
        self.completed: List[Tuple[float, float, int]] = []  # (s, work, srv)
        self.done = False
        self._probes: Dict[int, Event] = {}

    # ---- view API for policies --------------------------------------------

    @property
    def now(self) -> float:
        return self.sim.now

    @property
    def n_tasks(self) -> int:
        return len(self.tasks)

    @property
    def n_done(self) -> int:
        return len(self.tasks) - self.remaining

    def rack_of(self, server: int) -> int:
        return server // self.Kr

    def server_load(self, server: int) -> int:
        # count only LIVE queued attempts: cancelled losers stay in the
        # deque until dispatch skips them, and must not make an idle
        # server look busy to pick_backup_server
        live = sum(1 for a in self.queues[server]
                   if a.state == "queued" and not a.task.done)
        return live + (1 if self.running[server] is not None else 0)

    def elapsed(self, attempt: MapTaskAttempt) -> float:
        return self.now - attempt.start if attempt.state == "running" else 0.0

    def mean_rate(self) -> Optional[float]:
        """Observed seconds per work unit over completed attempts (None
        before the first completion) — the progress yardstick policies
        compare running attempts against."""
        if not self.completed:
            return None
        tot_s = sum(s for s, _, _ in self.completed)
        tot_w = sum(w for _, w, _ in self.completed)
        return tot_s / tot_w if tot_w > 0 else None

    def rack_rates(self) -> List[Optional[float]]:
        """Per-rack observed seconds per work unit (None where no completion
        happened yet) — the cause-attribution signal for Mantri-style
        policies."""
        secs = [0.0] * self.P
        work = [0.0] * self.P
        for s, w, srv in self.completed:
            secs[self.rack_of(srv)] += s
            work[self.rack_of(srv)] += w
        return [secs[r] / work[r] if work[r] > 0 else None
                for r in range(self.P)]

    def live_attempts(self, task: MapTask) -> List[MapTaskAttempt]:
        return [a for a in task.attempts
                if a.state in ("queued", "fetching", "running")]

    def live_backup(self, task: MapTask) -> bool:
        return any(a.is_backup for a in self.live_attempts(task))

    def pick_backup_server(self, task: MapTask,
                           avoid_racks: Sequence[int] = ()
                           ) -> Optional[int]:
        """Least-loaded server for a backup of ``task``: prefers idle slots,
        then input-local servers (no fetch), then rack-local ones; never a
        server already attempting the task.  Deterministic tie-break by
        server id."""
        live = {a.server for a in self.live_attempts(task)}
        best: Optional[Tuple[Tuple[int, int, int], int]] = None
        store_racks = {self.rack_of(s) for s in task.stores}
        for s in range(self.K):
            if s in live or self.rack_of(s) in avoid_racks:
                continue
            locality = (0 if s in task.stores else
                        1 if self.rack_of(s) in store_racks else 2)
            key = (self.server_load(s), locality, s)
            if best is None or key < best[0]:
                best = (key, s)
        return None if best is None else best[1]

    # ---- engine ------------------------------------------------------------

    def start(self) -> None:
        # wave 0: the same single factors() draw the barrier path makes
        self.wave_factors.append(np.asarray(
            self.sim.stragglers.factors(self.sim.rng, self.K, self.P),
            dtype=float))
        for task in self.tasks:
            self._enqueue(task, task.server, wave=0, is_backup=False)
        self._launch_backups(self._validate(
            self.policy.on_phase_start(self)))
        for s in range(self.K):
            self._dispatch(s, steal=False)

    def _enqueue(self, task: MapTask, server: int, wave: int,
                 is_backup: bool) -> MapTaskAttempt:
        a = MapTaskAttempt(self._next_attempt, task, server, wave, is_backup)
        self._next_attempt += 1
        self._attempts[a.attempt_id] = a
        task.attempts.append(a)
        self.queues[server].append(a)
        return a

    def _validate(self, reqs: Sequence[Tuple[int, int]]
                  ) -> List[Tuple[int, int]]:
        out: List[Tuple[int, int]] = []
        claimed: Dict[int, Set[int]] = {}
        for t_idx, server in reqs:
            if self.backups_launched + len(out) >= self.backup_budget:
                break
            if not (0 <= t_idx < len(self.tasks) and 0 <= server < self.K):
                continue
            task = self.tasks[t_idx]
            live = {a.server for a in self.live_attempts(task)}
            live |= claimed.setdefault(t_idx, set())
            if task.done or server in live:
                continue
            claimed[t_idx].add(server)
            out.append((t_idx, server))
        return out

    def _launch_backups(self, reqs: List[Tuple[int, int]]) -> None:
        if not reqs:
            return
        # a fresh wave: re-sample straggler luck for the new launches
        self.wave += 1
        self.wave_factors.append(np.asarray(
            self.sim.stragglers.factors(self.sim.rng, self.K, self.P),
            dtype=float))
        for t_idx, server in reqs:
            self._enqueue(self.tasks[t_idx], server, self.wave,
                          is_backup=True)
            self.backups_launched += 1
            self.job.n_backups += 1
            self.sim._trace("backup_launch",
                            (self.job.job_id, t_idx, server, self.wave))
        for server in sorted({s for _, s in reqs}):
            self._dispatch(server, steal=False)

    def _dispatch(self, server: int, steal: bool = True) -> None:
        if self.done or self.running[server] is not None:
            return
        q = self.queues[server]
        while q:
            a = q.popleft()
            if a.state != "queued" or a.task.done:
                a.state = "cancelled"
                continue
            self.running[server] = a
            if server in a.task.stores:
                self._start_compute(a)
            else:
                a.state = "fetching"
                store_racks = {self.rack_of(s) for s in a.task.stores}
                res = (tor(self.rack_of(server))
                       if self.rack_of(server) in store_racks else ROOT)
                a.fetch_flow = self.sim.network.start_flow(
                    res, a.task.input_units,
                    (self.job.job_id, "spec_fetch", a.attempt_id))
            return
        if not steal or self.remaining <= 0:
            return
        reqs = self._validate(self.policy.on_server_idle(self, server))
        if reqs:
            self._launch_backups(reqs)
            return
        t = self.policy.next_check_time(self, server)
        if t is not None and t > self.sim.now:
            self._schedule_probe(server, t)

    def _schedule_probe(self, server: int, t: float) -> None:
        old = self._probes.get(server)
        if old is not None and not old.cancelled:
            if old.time <= t:
                return                      # an earlier probe already queued
            old.cancel()
        self._probes[server] = self.sim.queue.push(
            t, "spec_probe", (self.job.job_id, server),
            lambda: self._probe(server))

    def _probe(self, server: int) -> None:
        self._probes.pop(server, None)         # fired: allow rescheduling
        if self.done or self.running[server] is not None:
            return
        self._dispatch(server)

    def _start_compute(self, a: MapTaskAttempt) -> None:
        a.state = "running"
        a.start = self.sim.now
        coeffs = self.sim.cost_model.phase_coeffs("map")
        f = self.wave_factors[a.wave][a.server] * self.pl_factors[a.server]
        dur = float(f * coeffs.seconds(a.task.work))
        a.event = self.sim.queue.push(
            self.sim.now + dur, "task_done",
            (self.job.job_id, a.task.index, a.server, a.attempt_id),
            lambda: self._attempt_done(a))

    def fetch_done(self, attempt_id: int) -> None:
        a = self._attempts.get(attempt_id)
        if a is None or a.state != "fetching" or self.done:
            return
        a.fetch_flow = None
        lat = self.sim.topology.latency("fetch")
        if lat > 0:
            self.sim.queue.push(self.sim.now + lat, "spec_fetch_latency",
                                (self.job.job_id, attempt_id),
                                lambda: self._fetch_latency_done(a))
        else:
            self._start_compute(a)

    def _fetch_latency_done(self, a: MapTaskAttempt) -> None:
        if a.state == "fetching" and not self.done and not a.task.done:
            self._start_compute(a)

    def _cancel_attempt(self, a: MapTaskAttempt,
                        reason: str = "speculation") -> None:
        state = a.state
        a.state = "cancelled"
        if state == "fetching":
            if a.fetch_flow is not None:
                self.sim.network.cancel_flow(a.fetch_flow, reason=reason)
                a.fetch_flow = None
            if self.running[a.server] is a:
                self.running[a.server] = None
        elif state == "running":
            if a.event is not None:
                a.event.cancel()
            if self.running[a.server] is a:
                self.running[a.server] = None

    def _attempt_done(self, a: MapTaskAttempt) -> None:
        if a.state != "running" or a.task.done or self.done:
            return
        task = a.task
        task.done = True
        task.finish = self.sim.now
        a.state = "done"
        self.running[a.server] = None
        self.completed.append((self.sim.now - a.start, task.work, a.server))
        self.remaining -= 1
        if a.is_backup:
            self.job.n_backup_wins += 1
        # first finisher wins: kill the losing attempts, free their slots
        freed = []
        for other in task.attempts:
            if other is a or other.state in ("done", "cancelled"):
                continue
            was_busy = other.state in ("fetching", "running")
            self._cancel_attempt(other)
            if was_busy:
                freed.append(other.server)
        if self.remaining == 0:
            self._finish()
            return
        self._launch_backups(self._validate(
            self.policy.on_task_complete(self, task.index)))
        if not self.done:
            for server in sorted(set(freed) | {a.server}):
                self._dispatch(server)

    def crash(self, servers: Sequence[int]) -> None:
        """Apply a server crash to the live task-granular map phase: live
        attempts on the crashed servers are cancelled (fetch flows aborted,
        completion events voided, slots freed), completed tasks whose
        winning attempt ran there are re-queued (their in-memory outputs
        died with the server), and the crashed servers disappear from every
        task's input ``stores`` — a replacement attempt must re-fetch the
        input from surviving replicas (or the root when none survive in
        rack).  Re-queued tasks go back to their home server at the current
        wave; the task engine then re-executes them like any other work, so
        the map phase still ends with ALL outputs present (no degraded
        shuffle needed for crashes absorbed here)."""
        if self.done:
            return
        dead = {int(s) for s in servers}
        for a in list(self._attempts.values()):
            if a.server in dead and a.state in ("queued", "fetching",
                                                "running"):
                self._cancel_attempt(a, reason="crash")
        for task in self.tasks:
            if dead.intersection(task.stores):
                task.stores = tuple(s for s in task.stores if s not in dead)
            if task.done:
                win = next((a for a in task.attempts if a.state == "done"),
                           None)
                if win is not None and win.server in dead:
                    task.done = False
                    task.finish = -1.0
                    win.state = "cancelled"
                    self.remaining += 1
                    self.sim._trace("task_lost",
                                    (self.job.job_id, task.index, win.server))
        for task in self.tasks:
            if not task.done and not self.live_attempts(task):
                self._enqueue(task, task.server, wave=self.wave,
                              is_backup=False)
        for s in range(self.K):
            self._dispatch(s, steal=False)

    def _finish(self) -> None:
        self.done = True
        for a in self._attempts.values():
            if a.state in ("queued", "fetching", "running"):
                self._cancel_attempt(a)
        for q in self.queues:
            q.clear()
        for ev in self._probes.values():
            ev.cancel()
        self._probes.clear()
        self.job.map_waves = self.wave + 1
        self.sim._task_map_done(self.job)


# ---------------------------------------------------------------------------
# The simulator
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _SimJob:
    job_id: int
    spec: JobSpec
    params: SchemeParams
    scheme: str
    stages: List[StageTraffic]
    compile_s: float
    submit_time: float
    # placement bridge (repro_torch.placement.sim_bridge.PlacementTraffic,
    # duck-typed here to keep the sim importable without the placement package):
    # pre-map fetch loads + per-server map-work factors
    placement: Optional[object] = None
    # speculation policy (duck-typed like the placement bridge): non-None turns the map phase task-granular
    speculation: Optional[object] = None
    phase: str = "submitted"
    stage_idx: int = 0
    open_flows: int = 0
    phase_start: float = 0.0
    phase_times: Dict[str, float] = dataclasses.field(default_factory=dict)
    tasks: Optional[TaskMapPhase] = None
    n_backups: int = 0
    n_backup_wins: int = 0
    map_waves: int = 1
    # crash/recovery state (see ClusterSim.inject_crash): servers whose
    # in-memory map outputs are currently lost, the failure set the active
    # recovery stages were compiled for, and the accounting counters
    failed: Tuple[int, ...] = ()
    recovered_for: Tuple[int, ...] = ()
    remap_subfiles: int = 0
    n_crashes: int = 0
    n_recoveries: int = 0
    # rack-level byte accounting: value-units of COMPLETED flows, by tier
    # (cancelled flows' partial progress is not counted — a crashed stage
    # re-runs in full under the degraded schedule)
    bytes_intra: float = 0.0
    bytes_cross: float = 0.0
    bytes_fetch: float = 0.0
    # blame bookkeeping (repro_torch.obs.blame): zero-contention /
    # straggler-free
    # ideal seconds of COMPLETED network stages and the map barrier, the
    # pending ideal of the stage currently in flight (committed at stage
    # completion, discarded when a crash voids the stage), the failure-free
    # shuffle ideals by tier, and crash-voided partial-phase seconds
    ideal_times: Dict[str, float] = dataclasses.field(default_factory=dict)
    pending_ideal: float = 0.0
    ff_ideal: Dict[str, float] = dataclasses.field(default_factory=dict)
    wasted_s: float = 0.0


@dataclasses.dataclass(frozen=True)
class JobStats:
    job_id: int
    name: str
    scheme: str
    r: int
    arrival: float
    submit: float
    finish: float
    phase_times: Dict[str, float]
    # speculative re-execution accounting (task-granular map phase only)
    speculation: Optional[str] = None   # policy name, None = barrier map
    n_backups: int = 0                  # backup attempts launched
    n_backup_wins: int = 0              # tasks won by a backup
    map_waves: int = 1                  # straggler waves sampled for map
    # crash-recovery accounting (ClusterSim.inject_crash)
    crashes: int = 0                    # crash events that hit live state
    remapped_subfiles: int = 0          # subfiles re-mapped (all r owners lost)
    recoveries: int = 0                 # degraded-recovery passes run
    # rack-level byte accounting in value-units (pairs x d) — completed
    # shuffle flows by tier, matching JobResult on the engine side (the
    # paper metric; see repro_torch.obs.bytes), plus pre-map fetch traffic
    intra_rack_bytes: float = 0.0
    cross_rack_bytes: float = 0.0
    fetch_bytes: float = 0.0
    # JCT blame decomposition (repro_torch.obs.blame.decompose): components sum
    # to jct exactly — the exactness law;
    # the raw inputs ride along so repro_torch.obs.blame.extract_blame can
    # rebuild
    # the decomposition independently from the trace and cross-check it
    blame: Optional[Dict[str, float]] = None
    ideal_times: Dict[str, float] = dataclasses.field(default_factory=dict)
    ff_shuffle_ideal: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    wasted_s: float = 0.0

    @property
    def jct(self) -> float:
        """Completion time from ARRIVAL (includes scheduler queueing)."""
        return self.finish - self.arrival


class ClusterSim:
    """Fluid discrete-event simulator of one server-rack cluster.

    ``submit`` may be called before ``run`` (a static batch) or from
    callbacks during the run (the online scheduler).  ``stages`` defaults to
    the closed-form stage traffic of the chosen scheme; pass enumerated
    ``plan_stage_traffic`` output (or loads derived from
    ``plan_transfer_matrices``) to simulate an explicit schedule.
    """

    def __init__(self, topology: RackTopology, K: int,
                 cost_model: CostModel = ZERO_COST,
                 stragglers: StragglerModel | None = None,
                 seed: int = 0,
                 speculation: object | None = None,
                 telemetry: bool = False) -> None:
        """``speculation`` is the cluster-wide default policy applied to
        every submission that does not pass its own (see ``submit``).

        ``telemetry=True`` attaches a :class:`repro_torch.sim.network
        .NetworkTelemetry` observer (per-resource utilization series,
        per-flow lifecycle + rate history) sampled on the sim clock; it is
        purely observational — event order, traces, and stats are
        bit-identical with it on or off."""
        if K % topology.P != 0:
            raise ValueError(f"P={topology.P} must divide K={K}")
        self.topology = topology
        self.K = K
        self.cost_model = cost_model
        self.stragglers = stragglers or NoStragglers()
        self.speculation = speculation
        self.rng = np.random.default_rng(seed)
        self.telemetry: Optional[NetworkTelemetry] = (
            NetworkTelemetry(topology, clock=lambda: self.now)
            if telemetry else None)
        self.network = FluidNetwork(topology, telemetry=self.telemetry)
        self.queue = EventQueue()
        self.now = 0.0
        # structured trace: every event/span as a repro_torch.obs TraceEvent,
        # stamped with the EXACT sim clock (rounding happens only in the
        # exporters — see repro_torch.obs.tracing); the legacy tuple view
        # lives
        # on as the `.trace` property
        self.tracer = Tracer(clock=lambda: self.now, enabled=True)
        self.stats: List[JobStats] = []
        self.on_job_done: Optional[Callable[[JobStats], None]] = None
        self._jobs: Dict[int, _SimJob] = {}
        self._next_job_id = 0

    # ---- public API --------------------------------------------------------

    def at(self, time: float, fn: Callable[[], None], kind: str = "callback",
           data: Tuple = ()) -> None:
        """Schedule an arbitrary callback (arrivals, scheduler wakeups)."""
        self.queue.push(max(time, self.now), kind, data, fn)

    def submit(self, spec: JobSpec, scheme: str, r: int,
               time: float | None = None,
               stages: List[StageTraffic] | None = None,
               compile_s: float = 0.0, check: bool = True,
               placement: object | None = None,
               speculation: object | None = None) -> int:
        """Enqueue a job start; returns its sim job id.

        ``placement`` is a :class:`repro_torch.placement.sim_bridge
        .PlacementTraffic`: its non-local map inputs run as a ``fetch``
        network stage before the map phase (contending with concurrent
        shuffles), and its per-server factors skew the map barrier.

        ``speculation`` is a speculation policy (the JAX package's
        ``resilience/speculation.py`` policies, duck-typed):
        non-None turns this job's map phase task-granular with speculative
        backup launches (defaults to the cluster-wide policy passed to
        ``ClusterSim``; pass the registry's ``none`` policy to force the
        task-granular engine without backups).
        """
        t = self.now if time is None else max(float(time), self.now)
        p = SchemeParams(K=self.K, P=self.topology.P, Q=spec.Q, N=spec.N, r=r)
        if stages is None:
            stages = scheme_stage_traffic(p, scheme, check=check)
        if placement is not None:
            nf = len(getattr(placement, "map_factors", ()))
            if nf != self.K:
                raise ValueError(
                    f"placement.map_factors must have K={self.K} entries, "
                    f"got {nf}")
            if len(placement.intra_units_per_rack) != self.topology.P:
                raise ValueError("placement.intra_units_per_rack must have "
                                 f"P={self.topology.P} entries")
        job = _SimJob(self._next_job_id, spec, p, scheme, stages,
                      float(compile_s), t, placement,
                      speculation if speculation is not None
                      else self.speculation)
        self._next_job_id += 1
        self._jobs[job.job_id] = job
        # failure-free zero-contention shuffle ideals by tier: the
        # shuffle_cross / shuffle_intra blame components
        # (repro_torch.obs.blame)
        d = float(spec.d)
        job.ff_ideal = {"cross": 0.0, "intra": 0.0}
        for st in stages:
            job.ff_ideal[st.stage] += self._stage_ideal(st, d)
        self.queue.push(t, "submit", (job.job_id,),
                        lambda j=job: self._start_job(j))
        return job.job_id

    def inject_crash(self, time: float, servers: Sequence[int]) -> None:
        """Schedule a crash of ``servers`` (flat ids) at sim time ``time``.

        Crash model (matches :mod:`repro_torch.core.degraded` and the engine
        ladder): the servers lose their IN-MEMORY state — map outputs,
        running task attempts, in-flight shuffle bytes — and replacement
        workers rejoin at the same coordinates with empty memory.  Effects
        depend on the phase each live job is in when the crash fires:

          * before map starts (submitted / plan_compile / fetch): nothing
            in memory yet — no effect on that job;
          * task-granular map: live attempts on the crashed servers are
            cancelled (slots freed, fetch flows aborted), finished tasks
            whose winning attempt ran there are re-queued, and the crashed
            servers are stripped from input ``stores`` (a replacement must
            re-fetch);
          * barrier map / pack: the loss is recorded; the degraded recovery
            runs right after the pack barrier (the barrier abstraction has
            no per-server progress to cancel);
          * shuffle: every in-flight flow of the job is cancelled (no
            orphan flows remain — asserted in tests), pending stage events
            voided, and recovery begins immediately;
          * reduce: the phase is voided and recovery re-runs the (degraded)
            shuffle before reducing again.

        Recovery is priced through the same fluid network: a degraded
        unicast re-shuffle (exact loads from the degraded plan where
        compilable), preceded by a re-map phase when subfiles lost all r
        owners — r >= 2 schemes decode around f <= r-1 failures with ZERO
        re-mapped subfiles, r = 1 re-runs the dead servers' map partitions.
        Seeded schedules (:class:`repro_torch.resilience.faults.FaultInjector`
        ``.inject_into(sim)``) keep traces bit-identical across reruns.
        """
        servers_t = tuple(sorted({int(s) for s in servers}))
        for s in servers_t:
            if not 0 <= s < self.K:
                raise ValueError(f"server id {s} out of range [0, {self.K})")
        self.at(time, lambda: self._crash(servers_t), "crash", (servers_t,))

    def run(self, until: float = float("inf")) -> List[JobStats]:
        """Advance until no work is left (or ``until``); returns all
        completed-job stats in completion order."""
        while True:
            # advance in DELTAS, not absolute times: at large t the next
            # flow-completion dt can be below the float resolution of
            # ``now + dt``, and an absolute-time loop would spin forever
            dt_flow = self.network.time_to_next_completion()
            t_event = self.queue.peek_time()
            dt_event = t_event - self.now
            if dt_flow == float("inf") and dt_event == float("inf"):
                break
            if min(self.now + dt_flow, t_event) > until:
                # truncated run: drain flows up to the horizon so a resumed
                # run() continues from consistent state; advance the clock
                # FIRST so completion callbacks stamp times at the horizon
                dt = until - self.now
                self.now = until
                for flow in self.network.advance(dt):
                    self._trace("flow_done", flow.tag)
                    self._flow_done(flow.tag, flow.size)
                break
            if dt_flow < dt_event:
                done = self.network.advance(dt_flow)
                self.now += dt_flow
            else:
                done = self.network.advance(max(dt_event, 0.0))
                self.now = t_event
            for flow in done:
                self._trace("flow_done", flow.tag)
                self._flow_done(flow.tag, flow.size)
            while self.queue and self.queue.peek_time() <= self.now:
                ev = self.queue.pop()
                self._trace(ev.kind, ev.data)
                if ev.fn is not None:
                    ev.fn()
        return self.stats

    @property
    def trace(self) -> List[TraceEntry]:
        """Legacy tuple view of the structured trace: ``(ts, kind, data)``
        for every INSTANT event, exact timestamps, event order preserved.
        Spans (``phase_span`` records with a duration) are excluded — they
        are stamped at their START time, which would break the monotone-time
        reading of the flat event log.  Use ``self.tracer.events`` for the
        full structured stream and the ``repro_torch.obs.tracing``
        exporters for
        rendering."""
        return [(e.ts, e.kind, e.data) for e in self.tracer.events
                if e.dur is None]

    # ---- internals ---------------------------------------------------------

    def _trace(self, kind: str, data: Tuple,
               phase: Optional[str] = None) -> None:
        data = tuple(data)
        job_id = (int(data[0]) if data
                  and isinstance(data[0], (int, np.integer)) else None)
        self.tracer.event(kind, job_id=job_id, phase=phase, data=data)

    def _stage_ideal(self, stage: StageTraffic, d: float) -> float:
        """Zero-contention drain time of one shuffle stage: the slower of
        the root drain and the bottleneck ToR drain, plus the stage latency
        floor (0.0 for an empty stage, which completes instantly)."""
        t = -1.0
        if stage.cross_pairs > 0:
            t = stage.cross_pairs * d / self.topology.capacity(ROOT)
        for rack, load in enumerate(stage.intra_pairs_per_rack):
            if load > 0:
                t = max(t, load * d / self.topology.capacity(tor(rack)))
        if t < 0:
            return 0.0
        return t + self.topology.latency(stage.stage)

    def _fetch_ideal(self, pl: object) -> float:
        """Zero-contention drain time of the pre-map fetch stage."""
        t = -1.0
        if pl.cross_units > 0:
            t = pl.cross_units / self.topology.capacity(ROOT)
        for rack, load in enumerate(pl.intra_units_per_rack):
            if load > 0:
                t = max(t, load / self.topology.capacity(tor(rack)))
        if t < 0:
            return 0.0
        return t + self.topology.latency("fetch")

    def _trace_phase_span(self, job: "_SimJob", phase: str) -> None:
        """Record the job phase that just ENDED as a span from its recorded
        start to now (the Perfetto lane structure of a sim run)."""
        self.tracer.span_at(job.phase_start, self.now, kind="phase_span",
                            job_id=job.job_id, phase=phase,
                            scheme=job.scheme, r=job.params.r)

    def _start_job(self, job: _SimJob) -> None:
        if job.compile_s > 0:
            job.phase = "plan_compile"
            job.phase_start = self.now
            self.queue.push(self.now + job.compile_s, "phase_done",
                            (job.job_id, "plan_compile"),
                            lambda: self._phase_done(job, "plan_compile"))
        else:
            self._begin_fetch(job)

    def _begin_fetch(self, job: _SimJob) -> None:
        """Pre-map input-fetch stage: the non-local map inputs of a bridged
        placement move over the network BEFORE map can start (they contend
        with concurrent jobs' shuffles like any flow).  Placement-less jobs
        (and fully node-local placements) skip straight to map."""
        pl = job.placement
        job.open_flows = 0
        if pl is not None:
            if pl.cross_units > 0:
                self.network.start_flow(ROOT, pl.cross_units,
                                        (job.job_id, "fetch_cross"))
                job.open_flows += 1
            for rack, load in enumerate(pl.intra_units_per_rack):
                if load > 0:
                    self.network.start_flow(tor(rack), load,
                                            (job.job_id, "fetch_intra", rack))
                    job.open_flows += 1
        if job.open_flows == 0:
            self._begin_compute(job, "map")
        else:
            job.phase = "fetch"
            job.phase_start = self.now
            job.pending_ideal = self._fetch_ideal(pl)

    def _begin_compute(self, job: _SimJob, phase: str) -> None:
        if phase == "map" and job.speculation is not None:
            self._begin_task_map(job)
            return
        job.phase = phase
        job.phase_start = self.now
        coeffs = self.cost_model.phase_coeffs(phase)
        work = phase_work(job.params, job.scheme, job.spec.d)[phase]
        factors = self.stragglers.factors(self.rng, self.K, self.topology.P)
        base = np.ones(self.K)
        if phase == "map" and job.placement is not None:
            # locality imbalance compounds with stragglers per server; the
            # barrier still ends at the slowest server
            base = np.asarray(job.placement.map_factors)
            factors = factors * base
        dur = float(np.max(factors) * coeffs.seconds(work))
        if phase == "map":
            # straggler-free barrier ideal (locality imbalance included):
            # the map / map_straggle blame split (repro_torch.obs.blame)
            job.ideal_times["map"] = float(np.max(base)
                                           * coeffs.seconds(work))
        self.queue.push(self.now + dur, "phase_done", (job.job_id, phase),
                        lambda: self._phase_done(job, phase))

    def _begin_shuffle_stage(self, job: _SimJob) -> None:
        stage = job.stages[job.stage_idx]
        job.phase = f"shuffle:{stage.stage}"
        job.phase_start = self.now
        d = job.spec.d
        job.open_flows = 0
        job.pending_ideal = self._stage_ideal(stage, float(d))
        if stage.cross_pairs > 0:
            self.network.start_flow(ROOT, stage.cross_pairs * d,
                                    (job.job_id, "cross"))
            job.open_flows += 1
        for rack, load in enumerate(stage.intra_pairs_per_rack):
            if load > 0:
                self.network.start_flow(tor(rack), load * d,
                                        (job.job_id, "intra", rack))
                job.open_flows += 1
        if job.open_flows == 0:                    # empty stage (e.g. r = K)
            self._stage_done(job)

    def _begin_task_map(self, job: _SimJob) -> None:
        """Task-granular map phase: per-subfile task events with speculative
        backups (see :class:`TaskMapPhase`)."""
        job.phase = "map"
        job.phase_start = self.now
        job.tasks = TaskMapPhase(self, job, job.speculation)
        # straggler-free serial ideal: each home server runs its own tasks
        # back to back at factor pl_factor[s] with no fetches (the home
        # server always stores its inputs) — map_straggle = actual - this,
        # and can go NEGATIVE when speculative backups steal work and beat
        # the home server's serial bound (documented in repro_torch.obs.blame)
        coeffs = self.cost_model.phase_coeffs("map")
        per_server = [0.0] * self.K
        for task in job.tasks.tasks:
            per_server[task.server] += coeffs.seconds(task.work)
        job.ideal_times["map"] = max(
            (float(job.tasks.pl_factors[s]) * per_server[s]
             for s in range(self.K)), default=0.0)
        job.tasks.start()

    def _task_map_done(self, job: _SimJob) -> None:
        job.tasks = None
        self._phase_done(job, "map")

    def _crash(self, servers: Tuple[int, ...]) -> None:
        for job_id in sorted(self._jobs):
            job = self._jobs[job_id]
            if job.phase != "done":
                self._crash_job(job, servers)

    def _crash_job(self, job: _SimJob, servers: Tuple[int, ...]) -> None:
        ph = job.phase
        if ph in ("submitted", "plan_compile", "fetch"):
            return                   # no map output in memory yet
        job.n_crashes += 1
        obs_metrics.counter(
            "sim_crashes_total",
            "crash events that hit a job's live state").inc(
                scheme=job.scheme, phase=ph.split(":")[0])
        if ph == "map" and job.tasks is not None:
            # task-granular map re-executes the lost work itself; its
            # outputs end up fully recovered, so no degraded shuffle
            job.tasks.crash(servers)
            return
        job.failed = tuple(sorted(set(job.failed) | set(servers)))
        if ph in ("map", "pack", "remap"):
            return      # loss recorded; recovery (re)starts after the barrier
        is_shuffle = ph.startswith("shuffle:")
        if is_shuffle:
            n = self.network.cancel_flows(
                lambda tag: tag[0] == job.job_id, reason="crash")
            job.open_flows = 0
            self._trace("flows_cancelled", (job.job_id, n))
        # void the job's pending completions (stage latency / phase barrier)
        self.queue.cancel_where(
            lambda ev: ev.kind in ("stage_latency", "phase_done")
            and bool(ev.data) and ev.data[0] == job.job_id)
        if is_shuffle or ph == "reduce":
            # the voided phase's elapsed time is pure crash waste: it never
            # reaches phase_times, so the exactness law needs it here
            job.wasted_s += self.now - job.phase_start
            job.pending_ideal = 0.0
            self._begin_recovery(job)

    def _begin_recovery(self, job: _SimJob) -> None:
        """Replace the job's remaining shuffle schedule with the degraded
        one (exact loads from the degraded plan where the instance is
        compilable) and run the re-map phase first if subfiles lost all
        their owners."""
        job.n_recoveries += 1
        stages, n_remap = degraded_stage_traffic(job.params, job.scheme,
                                                 job.failed)
        job.stages = list(stages)
        job.stage_idx = 0
        job.recovered_for = job.failed
        job.remap_subfiles += n_remap
        obs_metrics.counter(
            "sim_recoveries_total",
            "degraded-recovery passes run").inc(scheme=job.scheme)
        if n_remap:
            obs_metrics.counter(
                "sim_remapped_subfiles_total",
                "subfiles re-mapped after losing all r owners").inc(
                    n_remap, scheme=job.scheme)
        self._trace("recovery", (job.job_id, job.failed, n_remap))
        if n_remap > 0:
            self._begin_remap(job, n_remap)
        elif job.stages:
            self._begin_shuffle_stage(job)
        else:
            self._begin_compute(job, "reduce")

    def _begin_remap(self, job: _SimJob, n_remap: int) -> None:
        """Re-map the orphaned subfiles, spread across the survivors;
        barrier at the slowest surviving server (fresh straggler draw)."""
        job.phase = "remap"
        job.phase_start = self.now
        coeffs = self.cost_model.phase_coeffs("map")
        work = float(n_remap) * job.spec.Q * job.spec.d
        factors = self.stragglers.factors(self.rng, self.K, self.topology.P)
        dead = set(job.failed)
        alive = [s for s in range(self.K) if s not in dead]
        n_alive = max(len(alive), 1)
        f = max((float(factors[s]) for s in alive), default=1.0)
        dur = f * coeffs.seconds(work / n_alive)
        self.queue.push(self.now + dur, "phase_done", (job.job_id, "remap"),
                        lambda: self._phase_done(job, "remap"))

    def _flow_done(self, tag: Tuple, units: float = 0.0) -> None:
        job = self._jobs[tag[0]]
        kind = tag[1] if len(tag) > 1 else ""
        # rack-level byte accounting: completed value-units by tier
        if kind == "cross":
            job.bytes_cross += units
        elif kind == "intra":
            job.bytes_intra += units
        elif kind in ("fetch_cross", "fetch_intra", "spec_fetch"):
            job.bytes_fetch += units
        if kind == "spec_fetch":
            if job.tasks is not None:
                job.tasks.fetch_done(tag[2])
            return
        job.open_flows -= 1
        if job.open_flows == 0:
            if job.phase == "fetch":
                latency = self.topology.latency("fetch")
                done = lambda: self._fetch_done(job)      # noqa: E731
            else:
                latency = self.topology.latency(
                    job.stages[job.stage_idx].stage)
                done = lambda: self._stage_done(job)      # noqa: E731
            if latency > 0:
                self.queue.push(self.now + latency, "stage_latency",
                                (job.job_id,), done)
            else:
                done()

    def _fetch_done(self, job: _SimJob) -> None:
        job.phase_times["fetch"] = self.now - job.phase_start
        job.ideal_times["fetch"] = (job.ideal_times.get("fetch", 0.0)
                                    + job.pending_ideal)
        job.pending_ideal = 0.0
        self._trace_phase_span(job, "fetch")
        self._begin_compute(job, "map")

    def _stage_done(self, job: _SimJob) -> None:
        key = f"shuffle:{job.stages[job.stage_idx].stage}"
        # accumulate (not assign): recovery re-runs stages after a crash
        job.phase_times[key] = (job.phase_times.get(key, 0.0)
                                + self.now - job.phase_start)
        # commit the as-run zero-contention ideal of the COMPLETED stage
        # run (crash-voided runs discard theirs into wasted_s instead)
        job.ideal_times[key] = (job.ideal_times.get(key, 0.0)
                                + job.pending_ideal)
        job.pending_ideal = 0.0
        self._trace_phase_span(job, key)
        job.stage_idx += 1
        if job.stage_idx < len(job.stages):
            self._begin_shuffle_stage(job)
        else:
            self._begin_compute(job, "reduce")

    def _phase_done(self, job: _SimJob, phase: str) -> None:
        job.phase_times[phase] = (job.phase_times.get(phase, 0.0)
                                  + self.now - job.phase_start)
        self._trace_phase_span(job, phase)
        if phase == "plan_compile":
            self._begin_fetch(job)
        elif phase == "map":
            self._begin_compute(job, "pack")
        elif phase == "pack":
            job.stage_idx = 0
            if job.failed != job.recovered_for:
                # a crash landed during the map/pack barriers: shuffle (and
                # possibly re-map) under the degraded schedule instead
                self._begin_recovery(job)
            elif job.stages:
                self._begin_shuffle_stage(job)
            else:
                self._begin_compute(job, "reduce")
        elif phase == "remap":
            if job.failed != job.recovered_for:
                self._begin_recovery(job)      # cascading crash during remap
            elif job.stages:
                self._begin_shuffle_stage(job)
            else:
                self._begin_compute(job, "reduce")
        elif phase == "reduce":
            job.phase = "done"
            # blame decomposition in canonical component order (exactness
            # law: components sum to jct — see repro_torch.obs.blame)
            blame = obs_blame.decompose(
                jct=self.now - job.spec.arrival,
                queueing=job.submit_time - job.spec.arrival,
                phase_times=job.phase_times,
                ideal_times=job.ideal_times,
                ff_shuffle_ideal=job.ff_ideal,
                wasted_s=job.wasted_s)
            stats = JobStats(job.job_id, job.spec.name, job.scheme,
                             job.params.r, job.spec.arrival, job.submit_time,
                             self.now, dict(job.phase_times),
                             speculation=(getattr(job.speculation, "name",
                                                  "custom")
                                          if job.speculation is not None
                                          else None),
                             n_backups=job.n_backups,
                             n_backup_wins=job.n_backup_wins,
                             map_waves=job.map_waves,
                             crashes=job.n_crashes,
                             remapped_subfiles=job.remap_subfiles,
                             recoveries=job.n_recoveries,
                             intra_rack_bytes=job.bytes_intra,
                             cross_rack_bytes=job.bytes_cross,
                             fetch_bytes=job.bytes_fetch,
                             blame=blame,
                             ideal_times=dict(job.ideal_times),
                             ff_shuffle_ideal=dict(job.ff_ideal),
                             wasted_s=job.wasted_s)
            self.stats.append(stats)
            tot = obs_metrics.counter(
                "shuffle_bytes_total", "shuffle value-units moved, by tier")
            fam = {"hybrid": "binomial",
                   "hybrid_resolvable": "resolvable"}.get(job.scheme, "")
            tot.inc(job.bytes_intra, tier="intra", scheme=job.scheme,
                    family=fam, layer="sim")
            tot.inc(job.bytes_cross, tier="cross", scheme=job.scheme,
                    family=fam, layer="sim")
            # cache gauges stay current in snapshots without a manual pull
            obs_metrics.refresh_cache_metrics()
            self._trace("job_done", (job.job_id, job.scheme, job.params.r))
            if self.on_job_done is not None:
                self.on_job_done(stats)


def simulate_single_job(spec: JobSpec, topology: RackTopology, K: int,
                        scheme: str, r: int,
                        cost_model: CostModel = ZERO_COST,
                        stragglers: StragglerModel | None = None,
                        seed: int = 0, check: bool = True,
                        speculation: object | None = None) -> JobStats:
    """One job, empty cluster — the zero-contention special case whose JCT
    must equal ``CommCost.weighted_time`` when compute costs are zero.
    ``speculation`` switches the map phase to the task-granular speculative
    engine (see :class:`TaskMapPhase`)."""
    sim = ClusterSim(topology, K, cost_model, stragglers, seed)
    sim.submit(spec, scheme, r, time=spec.arrival, check=check,
               speculation=speculation)
    (stats,) = sim.run()
    return stats
