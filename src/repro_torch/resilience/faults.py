"""Fault injection: seeded crash schedules for the executable engine (and
any cluster simulator).

Counterpart of ``repro/resilience/faults.py``.  A :class:`FaultInjector`
is an immutable, seeded schedule of :class:`CrashEvent`\\ s — which
servers die, during which phase, at what (sim) time, on which engine
attempt.  The executable path
(:func:`repro_torch.mapreduce.engine.run_job_distributed` with
``faults=FaultSpec(...)``) applies the events of attempt k to attempt k of
the recovery ladder, masking the crashed servers' in-memory map outputs.
:meth:`FaultInjector.inject_into` registers the events with any simulator
that has ``inject_crash(time, servers)``, such as
:class:`repro_torch.sim.ClusterSim`.

Schedules are plain data built from a seed (the same draws in the same
order as the JAX package's), so a fault experiment is reproducible
bit-for-bit.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np

from .backoff import BackoffPolicy

CRASH_PHASES = ("map", "shuffle")


@dataclasses.dataclass(frozen=True)
class CrashEvent:
    """One crash: ``servers`` (flat ids) die during ``phase`` at sim time
    ``time``; the executable ladder applies it on engine attempt
    ``attempt`` (0 = the first try)."""
    servers: Tuple[int, ...]
    phase: str = "shuffle"
    time: float = 0.0
    attempt: int = 0

    def __post_init__(self):
        if self.phase not in CRASH_PHASES:
            raise ValueError(f"phase must be one of {CRASH_PHASES}")
        object.__setattr__(self, "servers",
                           tuple(sorted({int(s) for s in self.servers})))


@dataclasses.dataclass(frozen=True)
class FaultInjector:
    """An immutable crash schedule (see module docstring)."""
    events: Tuple[CrashEvent, ...] = ()

    @classmethod
    def crash(cls, servers: Sequence[int], phase: str = "shuffle",
              time: float = 0.0, attempt: int = 0) -> "FaultInjector":
        """Single-event schedule: ``servers`` die once."""
        return cls((CrashEvent(tuple(servers), phase, time, attempt),))

    @classmethod
    def rack_crash(cls, p, rack: int, phase: str = "shuffle",
                   time: float = 0.0, attempt: int = 0) -> "FaultInjector":
        """All Kr servers of one rack die (correlated failure — the case
        the per-layer erasure structure does NOT cover for that rack's
        layers beyond r - 1 owners)."""
        servers = tuple(p.server_id(rack, j) for j in range(p.Kr))
        return cls((CrashEvent(servers, phase, time, attempt),))

    @classmethod
    def random(cls, seed: int, K: int, n_events: int = 1,
               max_servers: int = 1, phase: str = "shuffle",
               max_time: float = 0.0, attempt: int = 0) -> "FaultInjector":
        """Seeded random schedule: ``n_events`` crashes, each killing
        1..max_servers distinct servers (uniform), at U(0, max_time) sim
        times.  Same seed -> same schedule, always."""
        rng = np.random.default_rng(seed)
        events = []
        for _ in range(n_events):
            k = int(rng.integers(1, max_servers + 1))
            servers = tuple(int(s) for s in
                            rng.choice(K, size=k, replace=False))
            t = float(rng.uniform(0.0, max_time)) if max_time > 0 else 0.0
            events.append(CrashEvent(servers, phase, t, attempt))
        return cls(tuple(events))

    def events_for_attempt(self, attempt: int) -> Tuple[CrashEvent, ...]:
        """Events the executable ladder applies on engine attempt k — a
        schedule with no events for the retry attempt models transient
        failures (the restart succeeds)."""
        return tuple(e for e in self.events if e.attempt == attempt)

    def all_servers(self) -> Tuple[int, ...]:
        out = set()
        for e in self.events:
            out.update(e.servers)
        return tuple(sorted(out))

    def inject_into(self, sim) -> None:
        """Register every event as a timed crash in a cluster simulator
        (duck-typed on ``inject_crash(time, servers)``)."""
        for e in self.events:
            sim.inject_crash(e.time, e.servers)


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """Everything :func:`repro_torch.mapreduce.engine.run_job_distributed`
    needs to run under injected failures: the crash schedule, the restart
    budget (rung 3 of the ladder), and the recovery policy knobs.

    ``sleep=None`` records backoff delays without sleeping (tests, sim);
    pass ``time.sleep`` to actually wait between restarts.
    ``allow_partial_remap=False`` disables rung 2 — orphaned subfiles then
    escalate straight to a full restart."""
    injector: FaultInjector
    max_restarts: int = 2
    backoff: BackoffPolicy = BackoffPolicy()
    allow_partial_remap: bool = True
    seed: int = 0
    sleep: Optional[object] = None


__all__ = ["CrashEvent", "FaultInjector", "FaultSpec", "CRASH_PHASES"]
