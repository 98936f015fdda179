"""Deterministic discrete-event primitives for the cluster simulator.

Two ingredients make the whole simulator reproducible bit-for-bit:

  * every scheduled event carries a monotonically increasing sequence
    number, so simultaneous events pop in a deterministic order (the order
    they were scheduled) regardless of heap internals;
  * the trace is a plain list of ``(time, kind, detail)`` tuples appended in
    processing order — two runs with the same seed must produce IDENTICAL
    traces (and the port's equal the JAX package's,
    ``tests/test_torch_sim.py``).
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Any, Callable, List, Optional, Tuple

TraceEntry = Tuple[float, str, Tuple[Any, ...]]


@dataclasses.dataclass(order=True)
class Event:
    time: float
    seq: int
    kind: str = dataclasses.field(compare=False)
    data: Tuple[Any, ...] = dataclasses.field(compare=False, default=())
    # optional callback fired when the event is processed
    fn: Optional[Callable[[], None]] = dataclasses.field(
        compare=False, default=None)
    # cancelled events stay in the heap but are skipped (no trace, no fn) —
    # first-finisher-wins speculation cancels the losing attempt's
    # completion event without disturbing heap order
    cancelled: bool = dataclasses.field(compare=False, default=False)

    def cancel(self) -> None:
        self.cancelled = True


class EventQueue:
    """Min-heap of events keyed on (time, seq) — fully deterministic."""

    def __init__(self) -> None:
        self._heap: List[Event] = []
        self._seq = 0

    def push(self, time: float, kind: str, data: Tuple[Any, ...] = (),
             fn: Optional[Callable[[], None]] = None) -> Event:
        ev = Event(float(time), self._seq, kind, data, fn)
        self._seq += 1
        heapq.heappush(self._heap, ev)
        return ev

    def pop(self) -> Event:
        self._drop_cancelled()
        return heapq.heappop(self._heap)

    def peek_time(self) -> float:
        self._drop_cancelled()
        return self._heap[0].time if self._heap else float("inf")

    def _drop_cancelled(self) -> None:
        while self._heap and self._heap[0].cancelled:
            heapq.heappop(self._heap)

    def cancel_where(self, pred: Callable[["Event"], bool]) -> int:
        """Cancel every pending event matching ``pred``; returns the count.
        Crash handling uses this to void a job's scheduled completions
        (stage latencies, phase barriers) wholesale — cancelled events stay
        in the heap and are skipped, so determinism is untouched."""
        n = 0
        for ev in self._heap:
            if not ev.cancelled and pred(ev):
                ev.cancel()
                n += 1
        return n

    def __len__(self) -> int:
        return len(self._heap)

    def __bool__(self) -> bool:
        return bool(self._heap)
