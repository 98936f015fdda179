"""Rack-level byte accounting: counterpart of ``repro/obs/bytes.py``.

Derives the per-(src_rack, dst_rack) transfer matrix of the ACTUAL
compiled plan, failure-free or degraded (the port's
:func:`repro_torch.core.coded_collectives.plan_transfer_matrices`), scales
it to value-units (pairs x payload width ``d``), records it into the
metrics registry, and checks it against the ``CommCost`` closed forms.
``multicast='coded'`` counts the paper metric (a coded packet traverses
the root once) — what ``JobResult.intra_rack_bytes`` / ``cross_rack_bytes``
report; ``'unicast'`` the wire format of a unicast realization.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from . import metrics as _metrics


class ByteReconciliationError(AssertionError):
    """Measured schedule bytes do not match the closed-form ``CommCost``."""


@dataclasses.dataclass(frozen=True)
class RackBytes:
    """Value-unit transfer accounting of one shuffle schedule:
    ``cross_matrix[src, dst]`` stage-1 root-switch units, ``intra_per_rack``
    stage-2 units through each ToR, scaled by payload width ``d``."""
    cross_matrix: np.ndarray          # [P, P]
    intra_per_rack: np.ndarray        # [P]
    d: int = 1

    @property
    def cross_total(self) -> float:
        return float(self.cross_matrix.sum())

    @property
    def intra_total(self) -> float:
        return float(self.intra_per_rack.sum())


def plan_rack_bytes(plan, multicast: str = "coded", d: int = 1) -> RackBytes:
    """Rack-level value-units of a compiled plan, failure-free or degraded
    (``plan_transfer_matrices`` dispatches on the ``cross_valid`` schema).
    Accepts a ``HybridShufflePlan`` or a
    :class:`repro_torch.core.degraded.DegradedPlan` (its re-routed plan is
    used)."""
    from ..core.coded_collectives import plan_transfer_matrices
    inner = getattr(plan, "plan", plan)       # DegradedPlan -> its tables
    tm = plan_transfer_matrices(inner, multicast=multicast)
    return RackBytes(np.asarray(tm["cross_rack_matrix"], dtype=float) * d,
                     np.asarray(tm["intra_per_rack"], dtype=float) * d, d)


def degraded_rack_bytes(dplan, d: int = 1) -> RackBytes:
    """Value-units of a degraded recovery schedule: the unicast degraded
    routing plus the orphan-redistribution term (each re-mapped subfile's
    [Q, d] values reach every rack once).  The redistribution has no single
    (src, dst) pair, so it is spread uniformly over off-diagonal entries to
    keep the matrix total exact."""
    rb = plan_rack_bytes(dplan, multicast="unicast", d=d)
    n_remap = int(dplan.orphan_subfiles.size)
    if n_remap == 0:
        return rb
    p = dplan.params
    extra = float(n_remap * p.Q * d)
    cross = rb.cross_matrix.copy()
    off = p.P * (p.P - 1)
    if off > 0:
        add = np.full((p.P, p.P), extra / off)
        np.fill_diagonal(add, 0.0)
        cross = cross + add
    return RackBytes(cross, rb.intra_per_rack, d)


def closed_form_bytes(p, scheme: str, d: int = 1,
                      check: bool = False) -> Dict[str, float]:
    """``CommCost`` closed form of ``scheme`` scaled to value-units:
    {'intra', 'cross', 'total'}; ``check`` validates the scheme's
    divisibility conditions first."""
    from ..core.costs import (coded_cost, hybrid_cost,
                              hybrid_resolvable_cost, uncoded_cost)
    fn = {"uncoded": uncoded_cost, "coded": coded_cost,
          "hybrid": hybrid_cost,
          "hybrid_resolvable": hybrid_resolvable_cost}[scheme]
    c = fn(p, check=check)
    return {"intra": c.intra * d, "cross": c.cross * d,
            "total": c.total * d}


def reconcile(measured_intra: float, measured_cross: float, p, scheme: str,
              d: int = 1, rtol: float = 1e-9, atol: float = 1e-6,
              check: bool = False) -> Dict[str, float]:
    """Assert measured schedule bytes equal the closed form; returns the
    comparison report, raises :class:`ByteReconciliationError` on
    mismatch."""
    cf = closed_form_bytes(p, scheme, d=d, check=check)
    report = {"measured_intra": float(measured_intra),
              "measured_cross": float(measured_cross),
              "closed_intra": cf["intra"], "closed_cross": cf["cross"]}
    for tier in ("intra", "cross"):
        m, c = report[f"measured_{tier}"], report[f"closed_{tier}"]
        if abs(m - c) > atol + rtol * max(abs(m), abs(c)):
            raise ByteReconciliationError(
                f"{tier}-rack bytes do not reconcile for scheme={scheme!r} "
                f"{p}: measured {m!r} != closed-form {c!r}")
    return report


def record_rack_bytes(rb: RackBytes, scheme: str, family: str = "",
                      layer: str = "engine",
                      reg: Optional[_metrics.MetricsRegistry] = None
                      ) -> RackBytes:
    """Record a schedule's rack-level bytes into the metrics registry:
    ``shuffle_bytes_total{tier, scheme, family, layer}`` and
    ``rack_pair_bytes_total{src, dst, layer}``.  Returns ``rb``."""
    reg = reg if reg is not None else _metrics.registry()
    tot = reg.counter("shuffle_bytes_total",
                      "shuffle value-units moved, by tier")
    tot.inc(rb.intra_total, tier="intra", scheme=scheme, family=family,
            layer=layer)
    tot.inc(rb.cross_total, tier="cross", scheme=scheme, family=family,
            layer=layer)
    pair = reg.counter("rack_pair_bytes_total",
                       "cross-rack value-units per (src, dst) rack pair")
    P = rb.cross_matrix.shape[0]
    for src in range(P):
        for dst in range(P):
            v = float(rb.cross_matrix[src, dst])
            if v > 0:
                pair.inc(v, src=src, dst=dst, layer=layer)
    return rb


__all__ = ["RackBytes", "ByteReconciliationError", "plan_rack_bytes",
           "degraded_rack_bytes", "closed_form_bytes", "reconcile",
           "record_rack_bytes"]
