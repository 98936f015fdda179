"""Process-local metrics registry: counters, gauges, histograms with labels.

Zero-dependency (stdlib + nothing), deliberately tiny: the point is ONE
shared schema for every counter the system grew ad hoc — plan-cache and
degraded-cache hit/miss/eviction, chooser decisions per (scheme, r, family),
recovery-ladder rungs, restart-budget consumption, sim crash/remap counts,
and the rack-level byte accounting of :mod:`repro_torch.obs.bytes` —
instead of one bespoke NamedTuple per subsystem.

Usage::

    from repro_torch.obs import metrics
    metrics.counter("chooser_decisions_total").inc(
        scheme="hybrid", r="2", family="binomial")
    snap = metrics.snapshot()          # plain nested dict, JSON-ready
    metrics.reset()                    # zero everything (tests, benches)

Design constraints (all load-bearing):

  * **Deterministic snapshots** — label sets and metric names are emitted
    sorted, so two identical runs produce byte-identical ``snapshot()``
    JSON (the same bit-reproducibility contract the simulator trace keeps).
  * **Bounded label cardinality** — each metric refuses more than
    ``max_label_sets`` distinct label combinations (a runaway label like a
    raw job id cannot OOM the registry); the cap is per-metric and
    configurable at declaration.
  * **Cheap when idle** — recording is a dict upsert; there is no I/O, no
    locking beyond the GIL, no background thread.

The existing cache introspection stays where it is
(:func:`repro_torch.core.coded_collectives.plan_cache_info`,
:func:`repro_torch.core.degraded.degraded_cache_info` — core must stay
importable without obs); :func:`collect_cache_metrics` pulls both into the
registry under the unified schema on demand.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, Iterable, List, Optional, Tuple

LabelKey = Tuple[Tuple[str, str], ...]

DEFAULT_MAX_LABEL_SETS = 4096

DEFAULT_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0,
                   float("inf"))


class LabelCardinalityError(RuntimeError):
    """A metric exceeded its ``max_label_sets`` bound — almost always a
    label that should not be a label (a job id, a timestamp, raw bytes)."""


def _label_key(labels: Dict[str, object]) -> LabelKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class _Metric:
    """Shared label bookkeeping of all three metric kinds."""

    kind = "abstract"

    def __init__(self, name: str, help: str = "",
                 max_label_sets: int = DEFAULT_MAX_LABEL_SETS) -> None:
        self.name = name
        self.help = help
        self.max_label_sets = int(max_label_sets)
        self._series: Dict[LabelKey, object] = {}

    def _slot(self, labels: Dict[str, object], default) -> LabelKey:
        key = _label_key(labels)
        if key not in self._series:
            if len(self._series) >= self.max_label_sets:
                raise LabelCardinalityError(
                    f"metric {self.name!r} exceeded max_label_sets="
                    f"{self.max_label_sets}; offending labels: "
                    f"{dict(key)!r}")
            self._series[key] = default
        return key

    def reset(self) -> None:
        self._series.clear()

    def snapshot(self) -> Dict[str, object]:
        samples = {json.dumps(dict(k), sort_keys=True): self._export(v)
                   for k, v in sorted(self._series.items())}
        return {"type": self.kind, "help": self.help, "samples": samples}

    def _export(self, value: object) -> object:
        return value


class Counter(_Metric):
    """Monotonically increasing per-label-set float."""

    kind = "counter"

    def inc(self, value: float = 1.0, **labels: object) -> None:
        if value < 0:
            raise ValueError(f"counter {self.name!r} cannot decrease")
        key = self._slot(labels, 0.0)
        self._series[key] = float(self._series[key]) + float(value)

    def value(self, **labels: object) -> float:
        return float(self._series.get(_label_key(labels), 0.0))


class Gauge(_Metric):
    """Set-to-current-value per label set (cache sizes, backlog, clock)."""

    kind = "gauge"

    def set(self, value: float, **labels: object) -> None:
        key = self._slot(labels, 0.0)
        self._series[key] = float(value)

    def add(self, value: float, **labels: object) -> None:
        key = self._slot(labels, 0.0)
        self._series[key] = float(self._series[key]) + float(value)

    def value(self, **labels: object) -> float:
        return float(self._series.get(_label_key(labels), 0.0))


@dataclasses.dataclass
class _HistState:
    counts: List[int]
    total: float = 0.0
    n: int = 0


class Histogram(_Metric):
    """Cumulative-bucket histogram (Prometheus convention: ``counts[i]``
    observations <= ``buckets[i]``; the last bucket is +inf)."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 buckets: Iterable[float] = DEFAULT_BUCKETS,
                 max_label_sets: int = DEFAULT_MAX_LABEL_SETS) -> None:
        super().__init__(name, help, max_label_sets)
        bs = tuple(sorted(float(b) for b in buckets))
        if not bs or bs[-1] != float("inf"):
            bs = bs + (float("inf"),)
        self.buckets = bs

    def observe(self, value: float, **labels: object) -> None:
        key = self._slot(labels, None)
        st = self._series[key]
        if st is None:
            st = _HistState(counts=[0] * len(self.buckets))
            self._series[key] = st
        for i, b in enumerate(self.buckets):
            if value <= b:
                st.counts[i] += 1
        st.total += float(value)
        st.n += 1

    def _export(self, st: _HistState) -> Dict[str, object]:
        return {"buckets": [b if b != float("inf") else "inf"
                            for b in self.buckets],
                "counts": list(st.counts), "sum": st.total, "count": st.n}


# ---------------------------------------------------------------------------
# Prometheus text exposition helpers
# ---------------------------------------------------------------------------

def _prom_metric_name(name: str) -> str:
    """Sanitize to the Prometheus metric-name charset
    ``[a-zA-Z_:][a-zA-Z0-9_:]*`` (invalid characters become ``_``)."""
    out = [c if (c.isascii() and (c.isalnum() or c in "_:")) else "_"
           for c in name]
    if not out:
        return "_"
    if out[0].isdigit():
        out.insert(0, "_")
    return "".join(out)


def _prom_label_name(name: str) -> str:
    """Label names allow ``[a-zA-Z_][a-zA-Z0-9_]*`` (no colon)."""
    out = [c if (c.isascii() and (c.isalnum() or c == "_")) else "_"
           for c in name]
    if not out:
        return "_"
    if out[0].isdigit():
        out.insert(0, "_")
    return "".join(out)


def _prom_label_value(value: str) -> str:
    """Escape per the exposition format: backslash, double-quote, newline."""
    return (value.replace("\\", r"\\").replace('"', r'\"')
            .replace("\n", r"\n"))


def _prom_labels(pairs: List[Tuple[str, str]]) -> str:
    if not pairs:
        return ""
    return "{" + ",".join(f'{k}="{v}"' for k, v in pairs) + "}"


def _prom_number(v: float) -> str:
    if v == float("inf"):
        return "+Inf"
    if v == float("-inf"):
        return "-Inf"
    if v != v:
        return "NaN"
    return repr(float(v))


class MetricsRegistry:
    """Name -> metric map with declare-on-first-use semantics.

    Re-declaring a name returns the SAME metric object (so call sites never
    need to share handles), but re-declaring with a different kind raises —
    a counter silently becoming a gauge is a bug, not a feature.
    """

    def __init__(self) -> None:
        self._metrics: Dict[str, _Metric] = {}

    def _declare(self, cls, name: str, help: str, **kwargs) -> _Metric:
        m = self._metrics.get(name)
        if m is not None:
            if not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already declared as {m.kind}, "
                    f"cannot redeclare as {cls.kind}")
            return m
        m = cls(name, help, **kwargs)
        self._metrics[name] = m
        return m

    def counter(self, name: str, help: str = "",
                max_label_sets: int = DEFAULT_MAX_LABEL_SETS) -> Counter:
        return self._declare(Counter, name, help,
                             max_label_sets=max_label_sets)

    def gauge(self, name: str, help: str = "",
              max_label_sets: int = DEFAULT_MAX_LABEL_SETS) -> Gauge:
        return self._declare(Gauge, name, help,
                             max_label_sets=max_label_sets)

    def histogram(self, name: str, help: str = "",
                  buckets: Iterable[float] = DEFAULT_BUCKETS,
                  max_label_sets: int = DEFAULT_MAX_LABEL_SETS) -> Histogram:
        return self._declare(Histogram, name, help, buckets=buckets,
                             max_label_sets=max_label_sets)

    def names(self) -> List[str]:
        return sorted(self._metrics)

    def snapshot(self) -> Dict[str, Dict[str, object]]:
        """Plain nested dict (sorted, JSON-ready, deterministic)."""
        return {name: self._metrics[name].snapshot()
                for name in sorted(self._metrics)}

    def snapshot_json(self, indent: Optional[int] = None) -> str:
        return json.dumps(self.snapshot(), indent=indent, sort_keys=True)

    def reset(self) -> None:
        """Zero every series but keep the declarations (helps and bucket
        layouts survive — tests and benches reset between sections)."""
        for m in self._metrics.values():
            m.reset()

    def clear(self) -> None:
        """Drop the declarations too (a fully fresh registry)."""
        self._metrics.clear()

    def to_prometheus_text(self) -> str:
        """Prometheus text exposition (format version 0.0.4) of every
        series: ``# HELP`` / ``# TYPE`` headers, sanitized metric and label
        names, escaped label values, and the histogram ``_bucket`` (with
        cumulative counts and an ``le="+Inf"`` terminal) / ``_sum`` /
        ``_count`` convention.  Output is deterministic: metrics sorted by
        name, series by label key — same contract as :meth:`snapshot`.
        """
        lines: List[str] = []
        for name in sorted(self._metrics):
            m = self._metrics[name]
            pname = _prom_metric_name(name)
            if m.help:
                esc = m.help.replace("\\", r"\\").replace("\n", r"\n")
                lines.append(f"# HELP {pname} {esc}")
            lines.append(f"# TYPE {pname} {m.kind}")
            for key in sorted(m._series):
                val = m._series[key]
                pairs = [(_prom_label_name(k), _prom_label_value(v))
                         for k, v in key]
                if isinstance(m, Histogram):
                    # stored counts are already cumulative (Prometheus
                    # convention) — emit as-is
                    for b, c in zip(m.buckets, val.counts):
                        le = _prom_number(b)
                        lbl = _prom_labels(pairs + [("le", le)])
                        lines.append(f"{pname}_bucket{lbl} {c}")
                    lbl = _prom_labels(pairs)
                    lines.append(f"{pname}_sum{lbl} "
                                 f"{_prom_number(val.total)}")
                    lines.append(f"{pname}_count{lbl} {val.n}")
                else:
                    lines.append(f"{pname}{_prom_labels(pairs)} "
                                 f"{_prom_number(float(val))}")
        return "\n".join(lines) + ("\n" if lines else "")


# ---------------------------------------------------------------------------
# Default process-local registry + module-level conveniences
# ---------------------------------------------------------------------------

_REGISTRY = MetricsRegistry()


def registry() -> MetricsRegistry:
    """The process-local default registry every instrumented call site
    records into (engine, sim, scheduler, recovery, byte accounting)."""
    return _REGISTRY


def counter(name: str, help: str = "", **kwargs) -> Counter:
    return _REGISTRY.counter(name, help, **kwargs)


def gauge(name: str, help: str = "", **kwargs) -> Gauge:
    return _REGISTRY.gauge(name, help, **kwargs)


def histogram(name: str, help: str = "", **kwargs) -> Histogram:
    return _REGISTRY.histogram(name, help, **kwargs)


def snapshot() -> Dict[str, Dict[str, object]]:
    return _REGISTRY.snapshot()


def to_prometheus_text() -> str:
    return _REGISTRY.to_prometheus_text()


def reset() -> None:
    _REGISTRY.reset()


# ---------------------------------------------------------------------------
# Cache collectors: pull the existing one-off counters into the registry
# ---------------------------------------------------------------------------

def refresh_cache_metrics(reg: Optional[MetricsRegistry] = None) -> None:
    """Mirror the plan-cache and degraded-cache introspection counters into
    ``reg`` (default registry) under the unified schema.

    Gauges (they mirror cumulative upstream state, they do not own it):

      * ``plan_cache{event=hit|miss, family=<all|family>}`` — overall and
        per-family counters of :func:`repro_torch.core.coded_collectives
        .plan_cache_info`;
      * ``plan_cache_size{kind=current|max}``;
      * ``degraded_cache{event=hit|miss|eviction}`` and
        ``degraded_cache_size{kind=current|max}`` — the bounded side LRU of
        :func:`repro_torch.core.degraded.degraded_cache_info`.

    Called automatically at every engine ``JobResult`` emission and sim job
    completion, so snapshots carry current cache state without callers
    pulling it by hand; call it directly to refresh outside a job boundary.
    Imported lazily so :mod:`repro_torch.obs.metrics` itself stays
    dependency-free (and importable before torch is loaded).
    """
    from ..core.coded_collectives import plan_cache_info
    from ..core.degraded import degraded_cache_info

    reg = reg if reg is not None else _REGISTRY
    info = plan_cache_info()
    pc = reg.gauge("plan_cache", "LRU plan-cache events (mirrored)")
    pc.set(info.hits, event="hit", family="all")
    pc.set(info.misses, event="miss", family="all")
    for fam, st in info.families.items():
        pc.set(st.hits, event="hit", family=fam)
        pc.set(st.misses, event="miss", family=fam)
    size = reg.gauge("plan_cache_size", "LRU plan-cache occupancy")
    size.set(info.currsize, kind="current")
    size.set(-1 if info.maxsize is None else info.maxsize, kind="max")

    dinfo = degraded_cache_info()
    dc = reg.gauge("degraded_cache",
                   "degraded-plan side-cache events (mirrored)")
    dc.set(dinfo.hits, event="hit")
    dc.set(dinfo.misses, event="miss")
    dc.set(dinfo.evictions, event="eviction")
    dsize = reg.gauge("degraded_cache_size",
                      "degraded-plan side-cache occupancy")
    dsize.set(dinfo.currsize, kind="current")
    dsize.set(-1 if dinfo.maxsize is None else dinfo.maxsize, kind="max")


def collect_cache_metrics(reg: Optional[MetricsRegistry] = None
                          ) -> Dict[str, Dict[str, object]]:
    """:func:`refresh_cache_metrics` plus the refreshed registry snapshot
    (the original pull-style entry point, kept for callers that want the
    snapshot in one call)."""
    reg = reg if reg is not None else _REGISTRY
    refresh_cache_metrics(reg)
    return reg.snapshot()


__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "LabelCardinalityError", "DEFAULT_BUCKETS", "DEFAULT_MAX_LABEL_SETS",
    "registry", "counter", "gauge", "histogram", "snapshot", "reset",
    "refresh_cache_metrics", "collect_cache_metrics",
]
