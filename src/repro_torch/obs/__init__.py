"""repro_torch.obs — unified telemetry across engine, sim and scheduler,
the counterpart of the JAX package's ``repro.obs``:

  * :mod:`.metrics` — process-local counters/gauges/histograms with labels
    (snapshot/reset, bounded cardinality, deterministic JSON, Prometheus
    text);
  * :mod:`.tracing` — structured :class:`TraceEvent` spans and instants
    with JSONL and Chrome/Perfetto ``trace_event`` exporters;
  * :mod:`.bytes` — rack-level byte accounting from compiled plans,
    reconciled against the ``CommCost`` closed forms per job;
  * :mod:`.blame` — per-job JCT blame decomposition, the critical-path
    extractor and fleet-level p99 rollups;
  * :mod:`.drift` — predicted-vs-actual reconciliation, EWMA drift
    detection and the per-component error breakdown;
  * :mod:`.report` — the one-page observatory report
    (``python -m repro_torch.obs.report``).

``repro_torch.core`` never imports ``repro_torch.obs`` (obs.bytes reaches
into core, so the reverse edge would cycle); core's cache counters are
pulled in lazily via :func:`repro_torch.obs.metrics.collect_cache_metrics`.
"""
from . import bytes  # noqa: A004 - module name mirrors the instrument
from . import blame, drift, metrics, report, tracing
from .blame import (COMPONENTS, BlameReport, blame_from_phase_timings,
                    blame_report, critical_path, decompose, extract_blame,
                    fleet_blame)
from .bytes import (ByteReconciliationError, RackBytes, closed_form_bytes,
                    degraded_rack_bytes, plan_rack_bytes, reconcile,
                    record_rack_bytes)
from .drift import (DriftConfig, DriftMonitor, record_blame,
                    record_component_errors, record_prediction)
from .metrics import (Counter, Gauge, Histogram, LabelCardinalityError,
                      MetricsRegistry, collect_cache_metrics,
                      refresh_cache_metrics)
from .report import build_report, render_html, render_markdown, write_report
from .tracing import (TraceEvent, Tracer, enable_tracing, get_tracer,
                      spans_from_phase_timings, to_chrome_trace, to_jsonl,
                      validate_chrome_trace)

__all__ = [
    "metrics", "tracing", "bytes", "drift", "report", "blame",
    "COMPONENTS", "BlameReport", "blame_from_phase_timings", "blame_report",
    "critical_path", "decompose", "extract_blame", "fleet_blame",
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "LabelCardinalityError", "collect_cache_metrics",
    "refresh_cache_metrics",
    "DriftConfig", "DriftMonitor", "record_blame",
    "record_component_errors", "record_prediction",
    "build_report", "render_markdown", "render_html", "write_report",
    "TraceEvent", "Tracer", "get_tracer", "enable_tracing",
    "spans_from_phase_timings", "to_jsonl", "to_chrome_trace",
    "validate_chrome_trace",
    "RackBytes", "ByteReconciliationError", "plan_rack_bytes",
    "degraded_rack_bytes", "closed_form_bytes", "reconcile",
    "record_rack_bytes",
]
