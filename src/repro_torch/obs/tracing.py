"""Structured span/event tracing with a stable schema + exporters: the
counterpart of the JAX package's ``obs/tracing.py``, the same schema and
the same exporter output.

One event type serves two layers of the port:

  * the **simulator** (:class:`repro_torch.sim.ClusterSim`) records its
    events as :class:`TraceEvent` (its ``trace`` property keeps the
    ``(time, kind, detail)`` tuple view);
  * the **engine** wraps its host-side phases (plan compile, host pack, the
    fused device program) in spans via the process-global tracer, and
    :func:`spans_from_phase_timings` converts the per-phase timings of
    ``measure_phase_timings`` into spans.

Timestamps are EXACT where recorded (the simulator trace must compare
bit-identically across seeded reruns); rounding happens only in the
exporters, so committed artifacts (the Perfetto golden) stay stable
without perturbing live consumers.

Exporters:

  * :func:`to_jsonl` — one JSON object per line, sorted keys;
  * :func:`to_chrome_trace` — Chrome/Perfetto ``trace_event`` format
    (``{"traceEvents": [...]}``).  Open the file at ``chrome://tracing`` or
    https://ui.perfetto.dev: spans render as nested bars per (pid=job,
    tid=phase lane), instants as marks.  Sim time is seconds and is scaled
    to microseconds on export; engine spans use wall-clock seconds, same
    scaling.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import time
from typing import (Any, Callable, Dict, Iterable, List, Optional, Tuple,
                    Union)

TS_NDIGITS = 12          # exporter-side rounding (float-stable artifacts)


@dataclasses.dataclass(frozen=True)
class TraceEvent:
    """One structured trace record — the stable schema of the whole system.

    ``ts`` is seconds (sim clock or wall clock, per tracer); ``kind`` is the
    event type (the simulator's event kinds, ``"span"`` for timed spans,
    scheduler ``"sched_*"`` kinds...); ``job_id``/``phase`` are filled where
    the producer knows them; ``labels`` is a sorted tuple of (key, str)
    pairs so events stay hashable and compare deterministically; ``dur`` is
    span duration in seconds (None for instants); ``data`` carries the
    legacy positional payload of the simulator's tuple trace.
    """
    ts: float
    kind: str
    job_id: Optional[int] = None
    phase: Optional[str] = None
    labels: Tuple[Tuple[str, str], ...] = ()
    dur: Optional[float] = None
    data: Tuple[Any, ...] = ()

    def to_dict(self, ndigits: Optional[int] = TS_NDIGITS) -> Dict[str, Any]:
        rnd = (lambda x: x) if ndigits is None else \
            (lambda x: round(float(x), ndigits))
        out: Dict[str, Any] = {"ts": rnd(self.ts), "kind": self.kind}
        if self.job_id is not None:
            out["job_id"] = self.job_id
        if self.phase is not None:
            out["phase"] = self.phase
        if self.labels:
            out["labels"] = dict(self.labels)
        if self.dur is not None:
            out["dur"] = rnd(self.dur)
        if self.data:
            out["data"] = _jsonable(self.data)
        return out


def _jsonable(x: Any) -> Any:
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    if isinstance(x, dict):
        return {str(k): _jsonable(v) for k, v in sorted(x.items())}
    if isinstance(x, (str, int, float, bool)) or x is None:
        return x
    if hasattr(x, "item"):                    # numpy scalar
        return x.item()
    return str(x)


def _labels_of(labels: Dict[str, Any]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class Tracer:
    """Append-only event collector with an injectable clock.

    ``enabled=False`` turns every record call into a near-no-op (one
    attribute check), so instrumented hot paths cost nothing when tracing
    is off — the engine's process-global tracer ships disabled and is
    switched on per run/bench via :func:`enable_tracing`.
    """

    def __init__(self, clock: Optional[Callable[[], float]] = None,
                 enabled: bool = True) -> None:
        self.clock = clock if clock is not None else time.perf_counter
        self.enabled = enabled
        self.events: List[TraceEvent] = []

    def event(self, kind: str, job_id: Optional[int] = None,
              phase: Optional[str] = None, data: Tuple[Any, ...] = (),
              ts: Optional[float] = None, **labels: Any) -> None:
        """Record an instant event (no-op when disabled)."""
        if not self.enabled:
            return
        self.events.append(TraceEvent(
            self.clock() if ts is None else float(ts), kind, job_id, phase,
            _labels_of(labels), None, tuple(data)))

    def span_at(self, start: float, end: float, kind: str = "span",
                job_id: Optional[int] = None, phase: Optional[str] = None,
                data: Tuple[Any, ...] = (), **labels: Any) -> None:
        """Record a completed span with explicit bounds (the simulator knows
        its phase start/end times; no wall clock involved)."""
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


# ---------------------------------------------------------------------------
# Process-global tracer (engine + anything without its own clock)
# ---------------------------------------------------------------------------

_TRACER = Tracer(enabled=False)


def get_tracer() -> Tracer:
    """The process-global tracer.  Disabled by default: enabling it is the
    observability switch for the engine's host-side spans."""
    return _TRACER


def enable_tracing(enabled: bool = True) -> Tracer:
    """Toggle the global tracer; returns it (cleared on enable so a fresh
    run starts with an empty buffer)."""
    _TRACER.enabled = enabled
    if enabled:
        _TRACER.clear()
    return _TRACER


# ---------------------------------------------------------------------------
# Span adapters
# ---------------------------------------------------------------------------

def spans_from_phase_timings(row: Dict[str, Any],
                             tracer: Optional[Tracer] = None,
                             job_id: Optional[int] = None) -> List[TraceEvent]:
    """Convert one ``measure_phase_timings`` row (the calibration feed of
    :func:`repro_torch.mapreduce.engine.measure_phase_timings`) into
    consecutive per-phase device-timing spans, recorded on ``tracer``
    (default: the global one) and returned.

    The row's phases are laid end to end from t=0 — these are best-of
    per-phase device timings, not one wall-clock run, so the produced
    timeline is the *idealized* pipeline the calibration fit consumes (and
    exactly what the simulator's cost model reproduces)."""
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
        ev = TraceEvent(t, "device_phase", job_id, phase,
                        _labels_of({"job": meta.get("job", ""),
                                    "backend": meta.get("backend", "")}),
                        dur)
        out.append(ev)
        t += dur
    if tracer.enabled:
        tracer.events.extend(out)
    return out


# ---------------------------------------------------------------------------
# Exporters
# ---------------------------------------------------------------------------

def to_jsonl(events: Iterable[TraceEvent], path: Optional[str] = None,
             ndigits: Optional[int] = TS_NDIGITS) -> str:
    """JSONL export (one event per line, sorted keys, timestamps rounded to
    ``ndigits`` — rounding lives HERE, not in the producers, so committed
    artifacts are stable while live consumers see exact times)."""
    lines = [json.dumps(e.to_dict(ndigits), sort_keys=True) for e in events]
    text = "\n".join(lines) + ("\n" if lines else "")
    if path is not None:
        with open(path, "w") as f:
            f.write(text)
    return text


def to_chrome_trace(events: Iterable[TraceEvent],
                    path: Optional[str] = None,
                    time_scale: float = 1e6) -> Dict[str, Any]:
    """Chrome/Perfetto ``trace_event`` export.

    Spans (``dur`` set) become complete events (``ph="X"``), instants become
    ``ph="i"`` with thread scope.  ``pid`` is the job id (-1 for cluster-
    scope events), ``tid`` the phase lane (falling back to the kind), and
    timestamps are scaled seconds -> microseconds (``time_scale``).  Load
    the written file in ``chrome://tracing`` or https://ui.perfetto.dev.
    """
    te: List[Dict[str, Any]] = []
    for e in events:
        pid = -1 if e.job_id is None else int(e.job_id)
        tid = e.phase if e.phase is not None else e.kind
        args = dict(e.labels)
        if e.data:
            args["data"] = json.dumps(_jsonable(e.data))
        rec: Dict[str, Any] = {
            "name": e.kind if e.phase is None else f"{e.kind}:{e.phase}",
            "cat": e.kind,
            "ts": round(e.ts * time_scale, 3),
            "pid": pid,
            "tid": tid,
            "args": args,
        }
        if e.dur is not None:
            rec["ph"] = "X"
            rec["dur"] = round(e.dur * time_scale, 3)
        else:
            rec["ph"] = "i"
            rec["s"] = "t"
        te.append(rec)
    doc = {"traceEvents": te, "displayTimeUnit": "ms"}
    if path is not None:
        with open(path, "w") as f:
            json.dump(doc, f, sort_keys=True)
    return doc


def validate_chrome_trace(doc: Union[Dict[str, Any], str]) -> int:
    """Sanity-check a ``trace_event`` document (dict or JSON text): required
    keys present, numeric timestamps, known phase codes.  Returns the event
    count; raises ``ValueError`` on malformed input.  Used by the bench to
    assert exported traces really load."""
    if isinstance(doc, str):
        doc = json.loads(doc)
    events = doc.get("traceEvents")
    if not isinstance(events, list):
        raise ValueError("missing traceEvents list")
    for i, e in enumerate(events):
        for k in ("name", "ph", "ts", "pid", "tid"):
            if k not in e:
                raise ValueError(f"traceEvents[{i}] missing {k!r}")
        if not isinstance(e["ts"], (int, float)):
            raise ValueError(f"traceEvents[{i}].ts not numeric")
        if e["ph"] not in ("X", "i", "B", "E", "M"):
            raise ValueError(f"traceEvents[{i}].ph unknown: {e['ph']!r}")
        if e["ph"] == "X" and not isinstance(e.get("dur"), (int, float)):
            raise ValueError(f"traceEvents[{i}] span without numeric dur")
    return len(events)


__all__ = [
    "TraceEvent", "Tracer", "get_tracer", "enable_tracing",
    "spans_from_phase_timings", "to_jsonl", "to_chrome_trace",
    "validate_chrome_trace", "TS_NDIGITS",
]
