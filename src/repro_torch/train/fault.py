"""Fault tolerance of training: preemption-safe resume, the straggler
schedule of the coded sync, and elastic re-meshing (the port of
``repro/train/fault.py``).

1. **Checkpoint/restart** (:mod:`.checkpoint`): atomic saves and a data
   pipeline that is a pure function of (seed, step)
   (:mod:`repro_torch.data.pipeline`), so a preempted run resumed from
   step s reproduces the uninterrupted run bit for bit.
2. **Straggler tolerance via map replication**: with r = 2 every chunk
   has two owners, and the coded reduce-scatter decodes the exact
   full-batch gradient with any single rack missing
   (:func:`repro_torch.train.trainer.coded_grads_r2` ``failed=``).
3. **Elastic re-meshing**: the chunk-ownership table is a pure function
   of P, so a lost or added rack means a new :class:`ElasticPlan` and a
   new mesh, resumed from the last checkpoint.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterable, Optional, Tuple

import numpy as np

from ..resilience.backoff import RestartBudget
from .checkpoint import latest_step


@dataclasses.dataclass
class PreemptionSimulator:
    """Deterministically 'preempts' (raises) at the given step."""
    preempt_at_step: Optional[int] = None

    def check(self, step: int) -> None:
        if self.preempt_at_step is not None and step == self.preempt_at_step:
            raise InterruptedError(f"simulated preemption at step {step}")


def run_with_restarts(train_loop: Callable[[int], Iterable[Tuple[int, Dict]]],
                      ckpt_dir: str, max_restarts: int = 3,
                      budget: Optional[RestartBudget] = None):
    """Drive ``train_loop(start_step)`` restarting from the latest
    checkpoint on preemption.  Yields (step, metrics) of completed steps.

    Restarts are charged to a :class:`repro_torch.resilience.backoff.
    RestartBudget` (default: ``max_restarts`` restarts, delays recorded
    without sleeping); when it is spent the ``InterruptedError`` is raised
    again."""
    if budget is None:
        budget = RestartBudget(max_restarts=max_restarts)
    while True:
        # as the JAX package: a checkpoint of step 0 alone restarts at 0
        start = (latest_step(ckpt_dir) or -1) + 1
        try:
            yield from train_loop(start)
            return
        except InterruptedError as e:
            budget.next_restart(e)    # raises e when the budget is spent


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    """Chunk assignment for the coded_r2 trainer at the CURRENT rack count;
    rebuilt whenever membership changes (everything downstream is a pure
    function of ``n_pods``)."""
    n_pods: int

    @property
    def n_chunks(self) -> int:
        return self.n_pods * (self.n_pods - 1) // 2

    def batch_divisor(self) -> int:
        """Global batch must divide by this for the chunk layout."""
        return self.n_chunks

    def shrink(self) -> "ElasticPlan":
        if self.n_pods <= 2:
            raise ValueError("cannot shrink below 2 pods")
        return ElasticPlan(self.n_pods - 1)

    def grow(self) -> "ElasticPlan":
        return ElasticPlan(self.n_pods + 1)


def straggler_dropout_schedule(n_steps: int, n_pods: int, rate: float,
                               seed: int = 0) -> np.ndarray:
    """Synthetic straggler trace: step -> failed rack id or -1 (none); the
    JAX package's draws, value for value."""
    rng = np.random.default_rng(seed)
    fail = rng.random(n_steps) < rate
    pods = rng.integers(0, n_pods, n_steps)
    return np.where(fail, pods, -1)
