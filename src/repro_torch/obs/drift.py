"""Prediction-drift monitoring: does the model of the machine still match
the machine?

The scheduler admits every job with a predicted JCT (``Decision.est_jct``,
priced from the chooser's :class:`repro_torch.sim.CostModel` and the
closed-form stage traffic).  This module closes the loop on that prediction:

  * :func:`record_prediction` reconciles one (predicted, actual) pair into
    the registry — absolute- and relative-error histograms plus a running
    prediction counter — under a ``layer`` label (``sim`` for scheduler
    admissions, ``engine`` for measured-wall-clock conformance cells);
  * :class:`DriftMonitor` additionally maintains an EWMA of the relative
    error and the cumulative REGRET of the stale model (seconds of
    |predicted - actual| accumulated since the last refit).  When the EWMA
    crosses the configured threshold the monitor reports drift, the caller
    refits (``repro_torch.sim.calibrate`` over the live measurement stream —
    see ``MultiJobScheduler(recalibrate=True)``) and acknowledges via
    :meth:`DriftMonitor.refitted`, which banks the stale model's regret
    into ``stale_model_regret_seconds_total`` and restarts the EWMA
    warm-up for the fresh model.

Everything here is deterministic given a deterministic observation stream:
the histograms, EWMA and regret are pure folds over (predicted, actual)
pairs, so two same-seed sim runs produce byte-identical ``jct_*`` metric
snapshots — pinned by the calibration bench's determinism section.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from . import metrics as _metrics

# Relative-error histogram buckets: 1% .. 2x, then +inf.  Chosen so a
# well-calibrated model concentrates in the first few buckets and a
# regime shift (e.g. 3x straggler inflation) lands visibly in the tail.
REL_ERR_BUCKETS = (0.01, 0.02, 0.05, 0.1, 0.2, 0.35, 0.5, 1.0, 2.0,
                   float("inf"))


def record_prediction(predicted: float, actual: float, layer: str = "sim",
                      reg: Optional[_metrics.MetricsRegistry] = None,
                      **labels: object) -> float:
    """Reconcile one predicted-vs-actual JCT pair into the registry.

    Records ``jct_predictions_total{layer}``,
    ``jct_prediction_error_seconds{layer}`` (absolute) and
    ``jct_prediction_relative_error{layer}``; returns the relative error
    |predicted - actual| / max(actual, eps) so callers can fold it further
    (the :class:`DriftMonitor` EWMA does).  Extra ``labels`` ride onto all
    three metrics — keep them low-cardinality (scheme, not job id).
    """
    reg = reg if reg is not None else _metrics.registry()
    err = abs(float(predicted) - float(actual))
    rel = err / max(abs(float(actual)), 1e-12)
    reg.counter("jct_predictions_total",
                "predicted-vs-actual JCT reconciliations").inc(
                    layer=layer, **labels)
    reg.histogram("jct_prediction_error_seconds",
                  "absolute JCT prediction error |pred - actual| (s)"
                  ).observe(err, layer=layer, **labels)
    reg.histogram("jct_prediction_relative_error",
                  "relative JCT prediction error |pred - actual| / actual",
                  buckets=REL_ERR_BUCKETS).observe(rel, layer=layer,
                                                   **labels)
    return rel


def record_blame(components: Dict[str, float], layer: str = "sim",
                 reg: Optional[_metrics.MetricsRegistry] = None,
                 **labels: object) -> None:
    """Fold one job's blame decomposition (:func:`repro_torch.obs.blame
    .decompose`) into the registry: ``jct_blame_seconds{component,layer}``
    accumulates per-component seconds across completions.  A gauge (via
    ``add``), not a counter, because ``map_straggle`` can go negative when
    speculative backups beat the home server's serial ideal."""
    reg = reg if reg is not None else _metrics.registry()
    # the help string is the JAX package's, verbatim: snapshots (and their
    # sha256) must match it key for key
    g = reg.gauge("jct_blame_seconds",
                  "accumulated JCT blame seconds by component "
                  "(repro.obs.blame exactness-law decomposition)")
    jobs = reg.counter("jct_blame_jobs_total",
                       "jobs folded into jct_blame_seconds")
    for comp in sorted(components):
        g.add(float(components[comp]), component=comp, layer=layer, **labels)
    jobs.inc(layer=layer, **labels)


def record_component_errors(estimated: Dict[str, float],
                            actual: Dict[str, float], layer: str = "sim",
                            reg: Optional[_metrics.MetricsRegistry] = None,
                            **labels: object) -> Dict[str, float]:
    """Per-component prediction-error breakdown: what the chooser's
    estimate missed, component by component (the drift layer's refinement
    of the scalar ``jct_prediction_*`` stream).

    Records ``jct_component_error_seconds{component,layer}`` (absolute
    error histogram) and ``jct_component_bias_seconds{component,layer}``
    (signed actual - estimated, accumulated — positive bias on
    ``contention`` means the chooser systematically under-prices network
    sharing).  Returns the signed errors for callers that fold further.
    """
    reg = reg if reg is not None else _metrics.registry()
    hist = reg.histogram("jct_component_error_seconds",
                         "absolute per-component JCT prediction error (s)")
    bias = reg.gauge("jct_component_bias_seconds",
                     "accumulated signed per-component prediction error "
                     "(actual - estimated, s)")
    out: Dict[str, float] = {}
    for comp in sorted(set(estimated) | set(actual)):
        err = float(actual.get(comp, 0.0)) - float(estimated.get(comp, 0.0))
        out[comp] = err
        hist.observe(abs(err), component=comp, layer=layer, **labels)
        bias.add(err, component=comp, layer=layer, **labels)
    return out


@dataclasses.dataclass(frozen=True)
class DriftConfig:
    """Knobs of the EWMA drift detector.

    ``ewma_alpha`` weights the newest observation; ``threshold`` is the
    EWMA relative error above which drift fires; ``min_observations``
    gates firing until the EWMA has warmed up (and again after every
    refit, so a fresh model gets the same grace period).
    """
    ewma_alpha: float = 0.3
    threshold: float = 0.25
    min_observations: int = 5


class DriftMonitor:
    """EWMA drift detector + regret accountant over a prediction stream.

    One monitor watches one model (one scheduler / one layer).  Feed every
    completion through :meth:`observe`; when it returns True the model has
    drifted — refit it, then call :meth:`refitted`.  The monitor never
    refits by itself: the refit needs the measurement stream, which the
    caller owns (see ``MultiJobScheduler._job_done``).
    """

    def __init__(self, config: DriftConfig = DriftConfig(),
                 layer: str = "sim",
                 reg: Optional[_metrics.MetricsRegistry] = None) -> None:
        self.config = config
        self.layer = layer
        self.reg = reg if reg is not None else _metrics.registry()
        self.ewma: Optional[float] = None
        self.observations = 0            # since last refit
        self.total_observations = 0
        self.refits = 0
        self.drift_events = 0
        self.regret_s = 0.0              # |pred - actual| since last refit

    def observe(self, predicted: float, actual: float,
                **labels: object) -> bool:
        """Fold one completion into the detector; True = drift fired."""
        rel = record_prediction(predicted, actual, layer=self.layer,
                                reg=self.reg, **labels)
        self.regret_s += abs(float(predicted) - float(actual))
        self.observations += 1
        self.total_observations += 1
        a = self.config.ewma_alpha
        self.ewma = rel if self.ewma is None else a * rel + (1 - a) * self.ewma
        g = self.reg.gauge("jct_drift_ewma",
                           "EWMA of relative JCT prediction error")
        g.set(self.ewma, layer=self.layer)
        self.reg.gauge("jct_model_regret_seconds",
                       "cumulative |pred - actual| since last refit"
                       ).set(self.regret_s, layer=self.layer)
        fired = (self.observations >= self.config.min_observations
                 and self.ewma > self.config.threshold)
        if fired:
            self.drift_events += 1
            self.reg.counter("jct_drift_events_total",
                             "EWMA drift-threshold crossings").inc(
                                 layer=self.layer)
        return fired

    def refitted(self) -> None:
        """Acknowledge a model refit: bank the stale model's regret, count
        the refit, and restart the EWMA warm-up for the fresh model."""
        self.reg.counter("jct_model_refits_total",
                         "cost-model refits triggered by drift").inc(
                             layer=self.layer)
        self.reg.counter("stale_model_regret_seconds_total",
                         "regret (s) accumulated by stale models before "
                         "their refit").inc(self.regret_s, layer=self.layer)
        self.refits += 1
        self.regret_s = 0.0
        self.observations = 0
        self.ewma = None
        self.reg.gauge("jct_model_regret_seconds",
                       "cumulative |pred - actual| since last refit"
                       ).set(0.0, layer=self.layer)

    def state(self) -> Dict[str, object]:
        """JSON-ready view (bench reports, debugging)."""
        return {"layer": self.layer, "ewma": self.ewma,
                "observations": self.observations,
                "total_observations": self.total_observations,
                "refits": self.refits, "drift_events": self.drift_events,
                "regret_s": self.regret_s,
                "threshold": self.config.threshold}


__all__ = ["DriftConfig", "DriftMonitor", "record_blame",
           "record_component_errors", "record_prediction",
           "REL_ERR_BUCKETS"]
