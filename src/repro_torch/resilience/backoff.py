"""Shared restart budgeting: jittered exponential backoff + max-restart cap.

Counterpart of ``repro/resilience/backoff.py``: the same policy, and the
same seeded draws in the same order, so a backoff schedule is equal to the
JAX package's float for float.  The port's engine recovery ladder
(:mod:`repro_torch.mapreduce.recovery`) is its one restart loop so far.

Delays are deterministic per (seed, attempt): the jitter draws from a
seeded generator, so a recovery run's backoff schedule is reproducible —
the same property the fault injector and the cluster sim guarantee for
their traces.  ``sleep`` is injectable (default: record the delay without
sleeping) because tests and the sim price time themselves; pass
``time.sleep`` to actually wait.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import numpy as np


class RestartBudgetExceeded(RuntimeError):
    """Raised by :meth:`RestartBudget.next_restart` when the max-restart
    budget is spent and no original error was supplied to re-raise."""


@dataclasses.dataclass(frozen=True)
class BackoffPolicy:
    """Jittered exponential backoff: attempt k (0-based) waits
    ``min(base_delay * factor**k, max_delay) * (1 + U(-jitter, +jitter))``
    seconds."""
    base_delay: float = 0.5
    factor: float = 2.0
    max_delay: float = 30.0
    jitter: float = 0.1

    def delay(self, attempt: int, rng: np.random.Generator) -> float:
        d = min(self.base_delay * self.factor ** attempt, self.max_delay)
        if self.jitter:
            d *= 1.0 + float(rng.uniform(-self.jitter, self.jitter))
        return max(d, 0.0)


class RestartBudget:
    """Mutable restart accountant for one job/run.

    ``next_restart(error)`` charges one restart: when the budget still has
    room it computes the (jittered, seeded) backoff delay, records it in
    ``delays``, invokes ``sleep(delay)`` if a sleeper was given, and returns
    the delay; when the budget is exhausted it re-raises ``error`` (or
    :class:`RestartBudgetExceeded` if none was passed), preserving the
    raise-the-original-failure semantics of the trainer's restart loop.
    """

    def __init__(self, max_restarts: int = 3,
                 policy: Optional[BackoffPolicy] = None, seed: int = 0,
                 sleep: Optional[Callable[[float], None]] = None) -> None:
        self.max_restarts = int(max_restarts)
        self.policy = policy if policy is not None else BackoffPolicy()
        self.sleep = sleep
        self.restarts = 0
        self.delays: List[float] = []
        self._rng = np.random.default_rng(seed)

    def next_restart(self, error: Optional[BaseException] = None) -> float:
        self.restarts += 1
        from ..obs import metrics as obs_metrics
        obs_metrics.counter(
            "restart_budget_total",
            "restart-budget consumption across all restart loops").inc(
                outcome=("exceeded" if self.restarts > self.max_restarts
                         else "restart"))
        if self.restarts > self.max_restarts:
            if error is not None:
                raise error
            raise RestartBudgetExceeded(
                f"restart budget exhausted after {self.max_restarts} restarts")
        delay = self.policy.delay(self.restarts - 1, self._rng)
        self.delays.append(delay)
        obs_metrics.histogram(
            "restart_backoff_seconds",
            "backoff delays charged by the restart budget").observe(delay)
        if self.sleep is not None:
            self.sleep(delay)
        return delay

    @property
    def exhausted(self) -> bool:
        return self.restarts > self.max_restarts


__all__ = ["BackoffPolicy", "RestartBudget", "RestartBudgetExceeded"]
