"""Where a kernel op runs, and what its work is: the predicate every layer
tests for "the card's branch", the dry run that lets a ``meta`` tensor take
that branch, and the recorder of the kernels' reported work.

* :func:`on_card` is true for a CUDA tensor (or device), and for a
  ``meta`` one while :func:`dry_run` is active.  Every device branch of
  the models and the ops tests it, so that a dry run on ``meta`` tensors
  follows the code the card runs (flash attention where the CPU runs the
  blockwise softmax, the ring decode, the SSM's card dispatch), not the
  CPU's.  Outside a dry run a ``meta`` tensor behaves as before: shapes
  only where the code is plain PyTorch, and the ops raise.
* Inside a dry run each op's card path, given ``meta`` tensors, takes the
  route the card would take, allocates what the launch allocates (its
  output and scratch, through the helper the launch itself calls) and
  launches nothing: it counts the call in the op module's ``DRY_CALLS``
  by route, never in ``LAUNCHES``, ``ROUTE_CALLS`` or ``PLAIN_CALLS``.
* :func:`account`, which every op's card path calls between its
  allocations and its launch, hands the call's work (FLOPs and HBM bytes,
  the formula behind its bound in ``PERF.md``) to the recorders of
  :func:`record_work` when one is active, and counts and ends a dry
  run's call: the dry run's shape-only routes and the card's launches
  report the same numbers, the CPU's plain versions nothing (their ATen
  products are visible to ``FlopCounterMode``).

Both settings are process-wide, not per thread: the autograd engine runs
a card backward on a thread of its own, and its kernels report too.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, Iterator, Optional, Tuple, Union

import torch

_DRY = [0]                  # nesting depth of active dry runs
_RECORDERS: list = []       # active work recorders, innermost last


def dry_run_active() -> bool:
    return _DRY[0] > 0


@contextlib.contextmanager
def dry_run() -> Iterator[None]:
    """Within the block a ``meta`` tensor takes the card's branch of every
    op and model function (see the module docstring)."""
    _DRY[0] += 1
    try:
        yield
    finally:
        _DRY[0] -= 1


def on_card(x: Union[torch.Tensor, torch.device]) -> bool:
    """Whether ``x`` (a tensor or a device) takes the card's branch: a CUDA
    one always, a ``meta`` one inside :func:`dry_run`."""
    kind = (x if isinstance(x, torch.device) else x.device).type
    return kind == "cuda" or (kind == "meta" and dry_run_active())


class WorkRecorder:
    """The work the kernels reported in a block: by kernel name, its calls,
    FLOPs and HBM bytes."""

    def __init__(self) -> None:
        self.by_kernel: Dict[str, Dict[str, float]] = {}

    def add(self, kernel: str, flops: float, nbytes: float) -> None:
        row = self.by_kernel.setdefault(kernel, {"calls": 0, "flops": 0.0,
                                                 "bytes": 0.0})
        row["calls"] += 1
        row["flops"] += float(flops)
        row["bytes"] += float(nbytes)

    @property
    def flops(self) -> float:
        return sum(r["flops"] for r in self.by_kernel.values())

    @property
    def bytes(self) -> float:
        return sum(r["bytes"] for r in self.by_kernel.values())


@contextlib.contextmanager
def record_work(recorder: Optional[WorkRecorder] = None
                ) -> Iterator[WorkRecorder]:
    """Collect the kernels' :func:`report` calls of the block."""
    rec = WorkRecorder() if recorder is None else recorder
    _RECORDERS.append(rec)
    try:
        yield rec
    finally:
        _RECORDERS.remove(rec)


def report(kernel: str, flops: float, nbytes: float) -> None:
    """One call's work, to every active recorder (none: nothing)."""
    for rec in _RECORDERS:
        rec.add(kernel, flops, nbytes)


def account(kernel: str, calls: Dict[str, int], key: str, x: torch.Tensor,
            work: Callable[[], Tuple[float, float]]) -> bool:
    """A card-branch call of ``kernel`` on ``x`` whose outputs are
    allocated: its work (``work()``, FLOPs and bytes) reported to the
    active recorders, if any; then True for a dry run's shape-only call
    (a ``meta`` tensor), counted in ``calls[key]``, which the caller
    returns from without launching."""
    if _RECORDERS:
        report(kernel, *work())
    if x.device.type != "meta":
        return False
    calls[key] = calls.get(key, 0) + 1
    return True


__all__ = ["on_card", "dry_run", "dry_run_active", "WorkRecorder",
           "record_work", "report", "account"]
