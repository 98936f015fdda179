"""Process-local metrics registry: the part of ``repro/obs/metrics.py``
the port's engine uses — labelled counters and gauges with deterministic
snapshots, and :func:`refresh_cache_metrics` bound to the port's plan
cache.  Histograms, the Prometheus exposition and the degraded-plan cache
gauges wait for later slices.
"""
from __future__ import annotations

import json
from typing import Dict, Optional, Tuple

LabelKey = Tuple[Tuple[str, str], ...]

DEFAULT_MAX_LABEL_SETS = 4096


class LabelCardinalityError(RuntimeError):
    """A metric exceeded its ``max_label_sets`` bound."""


def _label_key(labels: Dict[str, object]) -> LabelKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class _Metric:
    """Shared label bookkeeping of counters and gauges."""

    kind = "abstract"

    def __init__(self, name: str, help: str = "",
                 max_label_sets: int = DEFAULT_MAX_LABEL_SETS) -> None:
        self.name = name
        self.help = help
        self.max_label_sets = int(max_label_sets)
        self._series: Dict[LabelKey, float] = {}

    def _slot(self, labels: Dict[str, object]) -> LabelKey:
        key = _label_key(labels)
        if key not in self._series:
            if len(self._series) >= self.max_label_sets:
                raise LabelCardinalityError(
                    f"metric {self.name!r} exceeded max_label_sets="
                    f"{self.max_label_sets}; offending labels: "
                    f"{dict(key)!r}")
            self._series[key] = 0.0
        return key

    def value(self, **labels: object) -> float:
        return float(self._series.get(_label_key(labels), 0.0))

    def snapshot(self) -> Dict[str, object]:
        samples = {json.dumps(dict(k), sort_keys=True): v
                   for k, v in sorted(self._series.items())}
        return {"type": self.kind, "help": self.help, "samples": samples}


class Counter(_Metric):
    """Monotonically increasing per-label-set float."""

    kind = "counter"

    def inc(self, value: float = 1.0, **labels: object) -> None:
        if value < 0:
            raise ValueError(f"counter {self.name!r} cannot decrease")
        key = self._slot(labels)
        self._series[key] += float(value)


class Gauge(_Metric):
    """Set-to-current-value per label set."""

    kind = "gauge"

    def set(self, value: float, **labels: object) -> None:
        self._series[self._slot(labels)] = float(value)


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

    def snapshot(self) -> Dict[str, Dict[str, object]]:
        """Plain nested dict (sorted, JSON-ready, deterministic)."""
        return {name: self._metrics[name].snapshot()
                for name in sorted(self._metrics)}


_REGISTRY = MetricsRegistry()


def registry() -> MetricsRegistry:
    """The process-local default registry."""
    return _REGISTRY


def refresh_cache_metrics(reg: Optional[MetricsRegistry] = None) -> None:
    """Mirror the port's plan-cache counters into ``reg`` (default
    registry): ``plan_cache{event=hit|miss, family=<all|family>}`` and
    ``plan_cache_size{kind=current|max}`` gauges of
    :func:`repro_torch.core.coded_collectives.plan_cache_info`.  Called at
    every engine ``JobResult``."""
    from ..core.coded_collectives import plan_cache_info

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


__all__ = ["Counter", "Gauge", "MetricsRegistry", "LabelCardinalityError",
           "DEFAULT_MAX_LABEL_SETS", "registry", "refresh_cache_metrics"]
