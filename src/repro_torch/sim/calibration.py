"""Calibration artifacts + the sim-to-metal conformance fit.

Two fits live here, one per convention (keeping them straight matters):

  * **Per-phase host fit** — :func:`calibrate_with_residuals` wraps
    :func:`repro_torch.sim.cluster.calibrate` over
    ``measure_phase_timings`` / ``measure_calibration_grid`` rows (HOST
    work conventions: the legacy map phase maps all N subfiles on one
    device) and reports per-phase fit residuals.  The committed artifact
    ``calibration/default_cost_model.json`` (written by
    ``benchmarks/calibration_bench.py``, loaded by
    :func:`load_default_cost_model`) is this fit plus provenance; the port
    reads it and writes its own fits elsewhere.
  * **JCT-level conformance fit** — :class:`ConformanceModel`, fitted by
    :func:`fit_conformance` on measured END-TO-END fused-pipeline wall
    clock.  Its features use the SIM work conventions (per-server
    ``n_loc * Q * d`` map/pack work, per-stage network units), and its
    fitted coefficients distribute exactly into a :class:`CostModel` +
    :class:`RackTopology` pair under which the zero-contention
    :func:`simulate_single_job` JCT REPRODUCES the linear predictor — so
    "sim predicts measured wall clock within the tolerance band" is a
    statement about one fit's residuals, checked by actually running the
    simulator (the calibration bench's conformance section).

The artifact schema is versioned (:data:`COST_MODEL_SCHEMA_VERSION`);
loaders fail legibly on a version they do not understand.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.params import SchemeParams
from ..core.shuffle_plan import scheme_stage_traffic
from .cluster import (COMPUTE_PHASES, CostModel, PhaseCoeffs, calibrate,
                      phase_work)
from .network import RackTopology

COST_MODEL_SCHEMA_VERSION = 1

#: repo-relative path of the committed calibrated-cost-model artifact
DEFAULT_COST_MODEL_PATH = os.path.join("calibration",
                                       "default_cost_model.json")


def _repo_root() -> str:
    # src/repro_torch/sim/calibration.py -> src/repro_torch/sim
    # -> src/repro_torch -> src -> the repo root
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))


# ---------------------------------------------------------------------------
# Per-phase fit with residuals + JSON artifact
# ---------------------------------------------------------------------------

def fit_residuals(model: CostModel,
                  measurements: Sequence[Dict[str, object]]
                  ) -> Dict[str, Dict[str, float]]:
    """Per-phase residuals of ``model`` against ``measurements`` (the same
    row format :func:`repro_torch.sim.cluster.calibrate` consumes): n points,
    RMSE and max absolute error in seconds, and RMSE relative to the mean
    measured seconds (the scale-free figure the bench pins)."""
    out: Dict[str, Dict[str, float]] = {}
    for phase in COMPUTE_PHASES + ("plan_compile",):
        pred, meas = [], []
        for row in measurements:
            w = row["work"].get(phase)            # type: ignore[union-attr]
            s = row["seconds"].get(phase)         # type: ignore[union-attr]
            if w is not None and s is not None:
                pred.append(model.phase_coeffs(phase).seconds(float(w)))
                meas.append(float(s))
        if not meas:
            continue
        err = np.asarray(pred) - np.asarray(meas)
        rmse = float(np.sqrt(np.mean(err ** 2)))
        mean_s = float(np.mean(np.abs(meas)))
        out[phase] = {"n": len(meas), "rmse_s": rmse,
                      "max_abs_err_s": float(np.max(np.abs(err))),
                      "rel_rmse": rmse / mean_s if mean_s > 0 else 0.0}
    return out


def calibrate_with_residuals(measurements: Sequence[Dict[str, object]]
                             ) -> Tuple[CostModel,
                                        Dict[str, Dict[str, float]]]:
    """:func:`calibrate` plus the fit's own residual report."""
    model = calibrate(measurements)
    return model, fit_residuals(model, measurements)


def cost_model_to_dict(model: CostModel) -> Dict[str, Dict[str, float]]:
    return {phase: {"alpha": model.phase_coeffs(phase).alpha,
                    "beta": model.phase_coeffs(phase).beta}
            for phase in COMPUTE_PHASES + ("plan_compile",)}


def cost_model_from_dict(d: Dict[str, Dict[str, float]]) -> CostModel:
    return CostModel(**{phase: PhaseCoeffs(alpha=float(c["alpha"]),
                                           beta=float(c["beta"]))
                        for phase, c in d.items()})


def save_cost_model(model: CostModel, path: str,
                    residuals: Optional[Dict] = None,
                    provenance: Optional[Dict] = None) -> Dict:
    """Write the versioned cost-model artifact; returns the document."""
    doc = {"schema_version": COST_MODEL_SCHEMA_VERSION,
           "cost_model": cost_model_to_dict(model),
           "residuals": residuals or {},
           "provenance": provenance or {}}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(doc, f, indent=2, sort_keys=True)
        f.write("\n")
    return doc


def load_cost_model(path: str) -> Tuple[CostModel, Dict]:
    """Load a saved artifact -> (model, full document).  Fails legibly on
    an unknown ``schema_version`` — regenerate with ``make
    bench-calibration`` or update the loader."""
    with open(path) as f:
        doc = json.load(f)
    ver = doc.get("schema_version")
    if ver != COST_MODEL_SCHEMA_VERSION:
        raise ValueError(
            f"cost-model artifact {path!r} has schema_version={ver!r}; "
            f"this loader understands version {COST_MODEL_SCHEMA_VERSION}. "
            f"Regenerate it with `make bench-calibration` or update "
            f"repro_torch.sim.calibration.")
    return cost_model_from_dict(doc["cost_model"]), doc


def load_default_cost_model() -> Tuple[CostModel, Dict]:
    """The committed 8-device-driver calibration
    (``calibration/default_cost_model.json`` at the repo root, the JAX
    package's CPU fit; the port only reads it)."""
    return load_cost_model(os.path.join(_repo_root(),
                                        DEFAULT_COST_MODEL_PATH))


# ---------------------------------------------------------------------------
# Live measurement rows from completed sim jobs (the online-refit feed)
# ---------------------------------------------------------------------------

def measurement_row_from_stats(stats, p: SchemeParams, scheme: str,
                               d: int) -> Dict[str, object]:
    """Rebuild a :func:`calibrate` row from a completed job's
    :class:`JobStats` — the live measurement stream the scheduler refits
    from.  Work uses the SIM conventions of :func:`phase_work` and seconds
    are the job's observed barrier phase times, so straggler inflation is
    absorbed into the refitted betas (exactly what an online model should
    learn from a shifted regime)."""
    work = dict(phase_work(p, scheme, d))
    seconds = {phase: float(stats.phase_times[phase])
               for phase in COMPUTE_PHASES if phase in stats.phase_times}
    if "plan_compile" in stats.phase_times:
        work["plan_compile"] = float(p.N)
        seconds["plan_compile"] = float(stats.phase_times["plan_compile"])
    return {"work": {k: v for k, v in work.items() if k in seconds},
            "seconds": seconds,
            "meta": {"job_id": stats.job_id, "scheme": scheme, "r": p.r,
                     "N": p.N, "Q": p.Q, "d": d}}


# ---------------------------------------------------------------------------
# JCT-level conformance fit (sim conventions, measured fused wall clock)
# ---------------------------------------------------------------------------

CONFORMANCE_FEATURES = ("const", "map_pack_work", "reduce_work",
                        "cross_units", "intra_units")


def conformance_features(p: SchemeParams, scheme: str, d: int) -> np.ndarray:
    """Feature vector of one grid cell, in sim conventions:

      [1, n_loc*Q*d (map==pack work), N*(Q/K)*d (reduce work),
       total cross-rack units, sum over stages of the max per-rack intra
       units].

    The last two are exactly the quantities a zero-contention
    :class:`ClusterSim` divides by the root / per-ToR capacities (hybrid
    stages carry a single tier each), which is what makes the fitted
    predictor reproducible by an actual sim run — see
    :meth:`ConformanceModel.sim_stats`.
    """
    work = phase_work(p, scheme, d)
    stages = scheme_stage_traffic(p, scheme, check=True)
    cross = sum(st.cross_pairs for st in stages) * d
    intra = sum(max(st.intra_pairs_per_rack) if st.intra_pairs_per_rack
                else 0.0 for st in stages) * d
    return np.array([1.0, work["map"], work["reduce"],
                     float(cross), float(intra)])


@dataclasses.dataclass(frozen=True)
class ConformanceModel:
    """Nonnegative linear JCT predictor over
    :data:`CONFORMANCE_FEATURES`, distributable into (CostModel,
    RackTopology) so the simulator reproduces it exactly."""
    theta: Tuple[float, float, float, float, float]

    def predict(self, p: SchemeParams, scheme: str, d: int) -> float:
        return float(np.dot(np.asarray(self.theta),
                            conformance_features(p, scheme, d)))

    def cost_model(self) -> CostModel:
        """The fitted compute side: the whole map+pack coefficient rides
        on map (pack keeps zero cost — the fused pipeline cannot split
        them), the constant on map.alpha."""
        t0, t_mp, t_red, _, _ = self.theta
        return CostModel(map=PhaseCoeffs(alpha=t0, beta=t_mp),
                         reduce=PhaseCoeffs(alpha=0.0, beta=t_red))

    def topology(self, P: int) -> RackTopology:
        """The fitted network side: capacities are the reciprocal fitted
        rates.  A zero coefficient means that tier's drain time never
        showed above the noise — its capacity goes effectively infinite
        rather than dividing by zero.  ``intra_bw`` is the AGGREGATE intra
        capacity (RackTopology splits it over P ToRs), so the per-ToR drain
        of the max-loaded rack matches ``theta_intra * intra_units``
        exactly.

        Unlike the JAX package (capacity 1e18 below a coefficient of
        1e-15), every positive coefficient keeps its reciprocal and a zero
        one gets 1e30: there, 1e18 added units / 1e18 seconds (2.4e-12 s
        for 2.4e6 cross units) to sub-millisecond jobs, beyond the 1e-9
        relative bound under which the simulator must reproduce
        :meth:`predict`."""
        _, _, _, t_cross, t_intra = self.theta
        huge = 1e30
        cross_bw = 1.0 / t_cross if t_cross > 0.0 else huge
        intra_bw = P / t_intra if t_intra > 0.0 else huge
        return RackTopology(P=P, cross_bw=cross_bw, intra_bw=intra_bw,
                            cross_latency=0.0, intra_latency=0.0,
                            fetch_latency=0.0)

    def sim_stats(self, p: SchemeParams, scheme: str, d: int):
        """Run the actual simulator (zero contention, no stragglers) under
        the distributed (CostModel, RackTopology) — the sim JCT this
        returns equals :meth:`predict` up to float noise, proven in
        tests."""
        from .cluster import simulate_single_job
        from .workload import JobSpec
        spec = JobSpec(f"conformance_N{p.N}_r{p.r}_d{d}", p.N, p.Q, d,
                       arrival=0.0)
        return simulate_single_job(spec, self.topology(p.P), p.K, scheme,
                                   p.r, cost_model=self.cost_model())

    def to_dict(self) -> Dict[str, object]:
        return {"features": list(CONFORMANCE_FEATURES),
                "theta": [float(t) for t in self.theta]}


def fit_conformance(cells: Sequence[Dict[str, object]]) -> ConformanceModel:
    """Least-squares fit of measured fused-pipeline end-to-end seconds
    against :func:`conformance_features`, coefficients clipped
    nonnegative (a negative rate is unphysical; the clip trades a little
    fit quality for a model the simulator can realize as capacities).

    ``cells`` rows: {"p": SchemeParams, "scheme": str, "d": int,
    "measured_s": float}.
    """
    if not cells:
        raise ValueError("fit_conformance needs at least one cell")
    X = np.stack([conformance_features(c["p"], c["scheme"], c["d"])
                  for c in cells])
    y = np.asarray([float(c["measured_s"]) for c in cells])
    theta, *_ = np.linalg.lstsq(X, y, rcond=None)
    return ConformanceModel(tuple(float(max(t, 0.0)) for t in theta))


def conformance_report(model: ConformanceModel,
                       cells: Sequence[Dict[str, object]],
                       via_sim: bool = True) -> List[Dict[str, object]]:
    """Per-cell predicted-vs-measured table.  ``via_sim=True`` predicts by
    RUNNING the simulator under the distributed model (the honest check);
    False uses the linear form directly."""
    rows = []
    for c in cells:
        p, scheme, d = c["p"], c["scheme"], c["d"]
        pred = (model.sim_stats(p, scheme, d).jct if via_sim
                else model.predict(p, scheme, d))
        meas = float(c["measured_s"])
        rows.append({"N": p.N, "Q": p.Q, "r": p.r, "d": d,
                     "scheme": scheme, "measured_s": meas,
                     "predicted_s": float(pred),
                     "rel_err": abs(pred - meas) / max(meas, 1e-12)})
    return rows


__all__ = [
    "COST_MODEL_SCHEMA_VERSION", "DEFAULT_COST_MODEL_PATH",
    "calibrate_with_residuals", "fit_residuals", "cost_model_to_dict",
    "cost_model_from_dict", "save_cost_model", "load_cost_model",
    "load_default_cost_model", "measurement_row_from_stats",
    "CONFORMANCE_FEATURES", "conformance_features", "ConformanceModel",
    "fit_conformance", "conformance_report",
]
