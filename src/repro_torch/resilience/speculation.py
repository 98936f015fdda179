"""Speculative re-execution policies for the task-granular map phase.

The classic straggler weapons, as pluggable policies over
:class:`repro_torch.sim.cluster.TaskMapPhase` (which hands itself to every hook
as the read-only view):

  * ``none``   — task-granular execution, no backups: the baseline that
    isolates what speculation itself buys.
  * ``clone``  — proactive cloning a la Dolly (Ananthanarayanan et al.):
    every task gets ``n_clones`` clones up front, queued BEHIND the target
    servers' own tasks, so clones only run on slack capacity and the
    first finisher wins.
  * ``late``   — LATE-style reactive backups (Zaharia et al.): once enough
    tasks completed to estimate a progress rate, any running attempt slower
    than ``slow_ratio`` x the observed mean gets one backup on the
    least-loaded eligible server (preferring input-local slots), within a
    ``budget_frac`` budget.
  * ``mantri`` — cause-aware restarts (Mantri, Ananthanarayanan et al.):
    per-rack completion rates attribute slowness to a RACK (shared ToR/PDU
    — the paper's server-rack failure domain) or to a lone machine; tasks
    in slow racks are backed up promptly AND away from the afflicted rack,
    lone-machine stragglers wait for the more patient threshold.

Every policy decision is a deterministic function of the view, so a seeded
simulation stays bit-identical across reruns (asserted in
``tests/test_resilience.py``).  Policies return ``[(task_index, server)]``
requests; the engine enforces budget, slot contention, input-fetch flows
and first-finisher-wins cancellation.

Registry idiom mirrors :mod:`repro_torch.placement.solvers`:
``@register_policy``
+ :func:`get_policy`.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Tuple

Request = Tuple[int, int]                      # (task_index, server)

SPECULATION_POLICIES: Dict[str, Callable[..., "SpeculationPolicy"]] = {}


def register_policy(name: str):
    """Class decorator adding a policy factory to the registry."""
    def deco(cls):
        cls.name = name
        SPECULATION_POLICIES[name] = cls
        return cls
    return deco


def get_policy(name: str, **kwargs) -> "SpeculationPolicy":
    """Instantiate a registered policy by name (kwargs = its knobs)."""
    if name not in SPECULATION_POLICIES:
        raise ValueError(f"unknown speculation policy {name!r}; "
                         f"registered: {sorted(SPECULATION_POLICIES)}")
    return SPECULATION_POLICIES[name](**kwargs)


@dataclasses.dataclass
class SpeculationPolicy:
    """Base policy: the hooks the engine calls, all no-ops.

    ``tasks_per_server`` coalesces each server's subfile list into that many
    near-equal chunks (None = one task per subfile, the default); coarser
    tasks bound the event count on big Table I rows.
    """
    tasks_per_server: Optional[int] = None
    name = "base"

    def backup_budget(self, n_tasks: int) -> int:
        """Maximum backup attempts the engine may launch for one job."""
        return 0

    def on_phase_start(self, view) -> List[Request]:
        """Called once when the map phase begins (proactive policies)."""
        return []

    def on_task_complete(self, view, task_index: int) -> List[Request]:
        """Called after every task completion (reactive policies)."""
        return []

    def on_server_idle(self, view, server: int) -> List[Request]:
        """Called when a server drains its queue while tasks remain — the
        work-stealing moment real schedulers speculate on."""
        return []

    def next_check_time(self, view, server: int) -> Optional[float]:
        """When an idle server found nothing to steal: absolute time at
        which the engine should re-invoke the idle hook (None = never).
        Lets thresholds trigger even when no completion events remain."""
        return None


@register_policy("none")
@dataclasses.dataclass
class NoSpeculation(SpeculationPolicy):
    """Task-granular execution without backups — the speculation baseline."""


@register_policy("clone")
@dataclasses.dataclass
class ProactiveClone(SpeculationPolicy):
    """Dolly-style proactive cloning: ``n_clones`` clones of every task,
    spread deterministically across OTHER racks (same layer slot, next
    racks), queued behind the targets' own tasks so they consume only slack
    capacity."""
    n_clones: int = 1
    budget_frac: float = 1.0        # fraction of n_tasks * n_clones allowed

    def backup_budget(self, n_tasks: int) -> int:
        return math.ceil(self.budget_frac * n_tasks * self.n_clones)

    def on_phase_start(self, view) -> List[Request]:
        reqs: List[Request] = []
        for task in view.tasks:
            for j in range(self.n_clones):
                if view.P > 1:
                    hop = 1 + (task.index + j) % (view.P - 1)
                    target = (task.server + view.Kr * hop) % view.K
                else:
                    target = (task.server + 1 + j) % view.K
                reqs.append((task.index, target))
        return reqs


def _rate_threshold_scan(view, threshold_of, min_completed_frac: float
                         ) -> List[Tuple[float, object]]:
    """Running attempts slower than their policy threshold, worst first.

    ``threshold_of(view, attempt) -> ratio``: attempt is slow once
    ``elapsed >= ratio * expected`` where expected = observed mean rate x
    task work.  Returns [(overdue_ratio, attempt)] sorted descending by
    (overdue, -task_index) — deterministic."""
    rate = view.mean_rate()
    if rate is None or rate <= 0:
        return []
    if view.n_done < max(1, math.ceil(min_completed_frac * view.n_tasks)):
        return []
    slow: List[Tuple[float, object]] = []
    for server in range(view.K):
        a = view.running[server]
        if a is None or a.state != "running" or a.task.done:
            continue
        if view.live_backup(a.task):
            continue
        expected = rate * a.task.work
        if expected <= 0:
            continue
        ratio = view.elapsed(a) / expected
        # 1e-9 slack: a probe scheduled AT the crossing time must see the
        # attempt as slow despite float round-off, or the idle server
        # would never re-probe (t == now schedules nothing)
        if ratio >= threshold_of(view, a) - 1e-9:
            slow.append((ratio, a))
    slow.sort(key=lambda x: (-x[0], x[1].task.index))
    return slow


def _next_threshold_crossing(view, threshold_of,
                             min_completed_frac: float) -> Optional[float]:
    """Earliest future time a running, un-backed-up attempt crosses its
    slowness threshold (the probe time an idle server should wake at)."""
    rate = view.mean_rate()
    if rate is None or rate <= 0:
        return None
    if view.n_done < max(1, math.ceil(min_completed_frac * view.n_tasks)):
        return None
    times = []
    for server in range(view.K):
        a = view.running[server]
        if a is None or a.state != "running" or a.task.done:
            continue
        if view.live_backup(a.task):
            continue
        t = a.start + threshold_of(view, a) * rate * a.task.work
        if t > view.now:
            times.append(t)
    return min(times) if times else None


@register_policy("late")
@dataclasses.dataclass
class LateBackup(SpeculationPolicy):
    """LATE-style threshold backups: an attempt running ``slow_ratio``x
    longer than the observed mean (estimated after ``min_completed_frac`` of
    tasks finished) gets ONE backup on the best eligible server; idle
    servers steal the slowest overdue attempt."""
    slow_ratio: float = 1.6
    min_completed_frac: float = 0.15
    budget_frac: float = 0.25

    def backup_budget(self, n_tasks: int) -> int:
        return max(1, math.ceil(self.budget_frac * n_tasks))

    def _threshold(self, view, attempt) -> float:
        return self.slow_ratio

    def on_task_complete(self, view, task_index: int) -> List[Request]:
        reqs: List[Request] = []
        for _, a in _rate_threshold_scan(view, self._threshold,
                                         self.min_completed_frac):
            target = view.pick_backup_server(a.task)
            if target is not None:
                reqs.append((a.task.index, target))
        return reqs

    def on_server_idle(self, view, server: int) -> List[Request]:
        # the idle slot is the trigger, not necessarily the target: an
        # input-local replica holder beats a fetch-bound idle server
        return self.on_task_complete(view, -1)

    def next_check_time(self, view, server: int) -> Optional[float]:
        return _next_threshold_crossing(view, self._threshold,
                                        self.min_completed_frac)


@register_policy("mantri")
@dataclasses.dataclass
class MantriRestart(SpeculationPolicy):
    """Cause-aware restarts: per-rack completion rates flag racks whose
    mean rate exceeds ``rack_factor`` x the cluster mean (shared ToR/PDU
    slowdowns — the `RackCorrelated` failure domain).  Attempts in flagged
    racks are backed up at the prompt ``slow_ratio`` threshold AND placed
    outside the afflicted rack; lone-machine stragglers must overshoot the
    ``patient_ratio`` before restarting anywhere."""
    slow_ratio: float = 1.3
    patient_ratio: float = 2.5
    rack_factor: float = 1.3
    min_completed_frac: float = 0.15
    budget_frac: float = 0.25

    def backup_budget(self, n_tasks: int) -> int:
        return max(1, math.ceil(self.budget_frac * n_tasks))

    def _slow_racks(self, view) -> set:
        mean = view.mean_rate()
        if mean is None or mean <= 0:
            return set()
        return {r for r, rr in enumerate(view.rack_rates())
                if rr is not None and rr > self.rack_factor * mean}

    def _threshold(self, view, attempt) -> float:
        slow = self._slow_racks(view)
        return (self.slow_ratio
                if view.rack_of(attempt.server) in slow
                else self.patient_ratio)

    def _requests(self, view) -> List[Request]:
        slow_racks = self._slow_racks(view)
        reqs: List[Request] = []
        for _, a in _rate_threshold_scan(view, self._threshold,
                                         self.min_completed_frac):
            rack = view.rack_of(a.server)
            avoid = (rack,) if rack in slow_racks else ()
            target = view.pick_backup_server(a.task, avoid_racks=avoid)
            if target is None and avoid:       # cluster-wide slow: anywhere
                target = view.pick_backup_server(a.task)
            if target is not None:
                reqs.append((a.task.index, target))
        return reqs

    def on_task_complete(self, view, task_index: int) -> List[Request]:
        return self._requests(view)

    def on_server_idle(self, view, server: int) -> List[Request]:
        return self._requests(view)

    def next_check_time(self, view, server: int) -> Optional[float]:
        return _next_threshold_crossing(view, self._threshold,
                                        self.min_completed_frac)
