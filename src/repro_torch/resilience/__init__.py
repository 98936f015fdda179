"""repro_torch.resilience — the part of ``repro/resilience`` the port's
engine uses: seeded crash schedules (:mod:`.faults`) driving the recovery
ladder of :mod:`repro_torch.mapreduce.recovery`
(``run_job_distributed(faults=...)``), and the jittered-exponential restart
budget (:mod:`.backoff`).  Speculation, straggler-aware replication and the
frontier experiments wait for the simulator's port.
"""
from .backoff import BackoffPolicy, RestartBudget, RestartBudgetExceeded
from .faults import CRASH_PHASES, CrashEvent, FaultInjector, FaultSpec

__all__ = [
    "BackoffPolicy", "RestartBudget", "RestartBudgetExceeded",
    "CRASH_PHASES", "CrashEvent", "FaultInjector", "FaultSpec",
]
