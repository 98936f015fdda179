"""Process-local metrics registry: the part of ``repro/obs/metrics.py``
the port's engine and recovery ladder use — labelled counters, gauges and
cumulative-bucket histograms with deterministic snapshots, the
module-level ``counter``/``gauge``/``histogram`` helpers, and
:func:`refresh_cache_metrics` bound to the port's plan cache and
degraded-plan side cache.  The Prometheus exposition, ``snapshot`` and
``reset`` helpers wait for a later slice.
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
    """A metric exceeded its ``max_label_sets`` bound."""


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

    def value(self, **labels: object) -> float:
        return float(self._series.get(_label_key(labels), 0.0))

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
        self._series[key] += float(value)


class Gauge(_Metric):
    """Set-to-current-value per label set."""

    kind = "gauge"

    def set(self, value: float, **labels: object) -> None:
        self._series[self._slot(labels, 0.0)] = float(value)


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


class MetricsRegistry:
    """Name -> metric map with declare-on-first-use semantics; re-declaring
    a name with a different kind raises."""

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

    def snapshot(self) -> Dict[str, Dict[str, object]]:
        """Plain nested dict (sorted, JSON-ready, deterministic)."""
        return {name: self._metrics[name].snapshot()
                for name in sorted(self._metrics)}


_REGISTRY = MetricsRegistry()


def registry() -> MetricsRegistry:
    """The process-local default registry."""
    return _REGISTRY


def counter(name: str, help: str = "", **kwargs) -> Counter:
    return _REGISTRY.counter(name, help, **kwargs)


def gauge(name: str, help: str = "", **kwargs) -> Gauge:
    return _REGISTRY.gauge(name, help, **kwargs)


def histogram(name: str, help: str = "", **kwargs) -> Histogram:
    return _REGISTRY.histogram(name, help, **kwargs)


def refresh_cache_metrics(reg: Optional[MetricsRegistry] = None) -> None:
    """Mirror the port's cache counters into ``reg`` (default registry):
    ``plan_cache{event=hit|miss, family=<all|family>}`` and
    ``plan_cache_size{kind=current|max}`` gauges of
    :func:`repro_torch.core.coded_collectives.plan_cache_info`, and
    ``degraded_cache{event=hit|miss|eviction}`` and
    ``degraded_cache_size{kind=current|max}`` of the bounded side LRU of
    :func:`repro_torch.core.degraded.degraded_cache_info`.  Called at every
    engine ``JobResult``."""
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


__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "LabelCardinalityError", "DEFAULT_BUCKETS",
           "DEFAULT_MAX_LABEL_SETS", "registry", "counter", "gauge",
           "histogram", "refresh_cache_metrics"]
