"""Structured span tracing for the engine: the part of
``repro/obs/tracing.py`` the port's engine uses (``TraceEvent``,
``Tracer.span``, the process-global tracer, and
:func:`spans_from_phase_timings` for ``measure_phase_timings`` rows).
Exporters wait for a later slice.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class TraceEvent:
    """One trace record, same schema as the JAX package's: ``ts`` and
    ``dur`` in seconds, ``kind`` the event type (``"engine_phase"`` for the
    engine's spans), ``phase`` the span name, ``labels`` a sorted tuple of
    (key, str) pairs."""
    ts: float
    kind: str
    job_id: Optional[int] = None
    phase: Optional[str] = None
    labels: Tuple[Tuple[str, str], ...] = ()
    dur: Optional[float] = None
    data: Tuple[Any, ...] = ()


def _labels_of(labels: Dict[str, Any]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class Tracer:
    """Append-only event collector with an injectable clock.

    ``enabled=False`` turns every record call into a near-no-op, so the
    engine's instrumented phases cost nothing when tracing is off.
    """

    def __init__(self, clock: Optional[Callable[[], float]] = None,
                 enabled: bool = True) -> None:
        self.clock = clock if clock is not None else time.perf_counter
        self.enabled = enabled
        self.events: List[TraceEvent] = []

    def span_at(self, start: float, end: float, kind: str = "span",
                job_id: Optional[int] = None, phase: Optional[str] = None,
                data: Tuple[Any, ...] = (), **labels: Any) -> None:
        """Record a completed span with explicit bounds."""
        if not self.enabled:
            return
        self.events.append(TraceEvent(
            float(start), kind, job_id, phase, _labels_of(labels),
            float(end) - float(start), tuple(data)))

    @contextlib.contextmanager
    def span(self, phase: str, job_id: Optional[int] = None,
             kind: str = "span", **labels: Any):
        """Context manager measuring a wall-clock span around its body."""
        if not self.enabled:
            yield self
            return
        t0 = self.clock()
        try:
            yield self
        finally:
            self.span_at(t0, self.clock(), kind, job_id, phase, **labels)

    def clear(self) -> None:
        self.events.clear()


_TRACER = Tracer(enabled=False)


def get_tracer() -> Tracer:
    """The process-global tracer (disabled by default)."""
    return _TRACER


def enable_tracing(enabled: bool = True) -> Tracer:
    """Toggle the global tracer; returns it (cleared on enable so a fresh
    run starts with an empty buffer)."""
    _TRACER.enabled = enabled
    if enabled:
        _TRACER.clear()
    return _TRACER


def spans_from_phase_timings(row: Dict[str, Any],
                             tracer: Optional[Tracer] = None,
                             job_id: Optional[int] = None) -> List[TraceEvent]:
    """Convert one ``measure_phase_timings`` row (see
    :func:`repro_torch.mapreduce.engine.measure_phase_timings`) into
    consecutive per-phase ``device_phase`` spans, recorded on ``tracer``
    (default: the global one) when it is enabled, and returned.

    The row's phases are laid end to end from t=0 — these are best-of
    per-phase timings, not one wall-clock run, so the produced timeline is
    the *idealized* pipeline a calibration fit consumes."""
    tracer = tracer if tracer is not None else _TRACER
    meta = {str(k): v for k, v in row.get("meta", {}).items()}
    t = 0.0
    out: List[TraceEvent] = []
    phases = dict(row["seconds"])
    if "shuffle_s" in meta:                  # measured but reported in meta
        phases["shuffle"] = float(meta["shuffle_s"])
    for phase in ("plan_compile", "map", "pack", "shuffle", "reduce"):
        if phase not in phases:
            continue
        dur = float(phases[phase])
        out.append(TraceEvent(t, "device_phase", job_id, phase,
                              _labels_of({"job": meta.get("job", ""),
                                          "backend": meta.get("backend",
                                                              "")}),
                              dur))
        t += dur
    if tracer.enabled:
        tracer.events.extend(out)
    return out


__all__ = ["TraceEvent", "Tracer", "get_tracer", "enable_tracing",
           "spans_from_phase_timings"]
