"""repro_torch.sim — rack-level cluster simulator + multi-job scheduler, the
counterpart of the JAX package's ``repro.sim``.

Answers the question the closed forms cannot: what is job completion TIME
under link contention, stragglers, skewed bandwidth, crashes, or a stream
of concurrent jobs?  A discrete-event loop in Python over float64 NumPy, on
the host as in the JAX package: the same seed gives the same trace, event
for event, and the same scheduler decisions.  Seeded crash schedules come
from :class:`repro_torch.resilience.faults.FaultInjector` (``inject_into``)
or :meth:`ClusterSim.inject_crash`; the cost model is fitted by
:mod:`.calibration`, and :mod:`.scheduler` admits job streams.
"""
from .calibration import (ConformanceModel, calibrate_with_residuals,
                          conformance_report, fit_conformance,
                          load_cost_model, load_default_cost_model,
                          measurement_row_from_stats, save_cost_model)
from .cluster import (ClusterSim, CostModel, DeterministicSlowdown,
                      ExponentialTail, JobStats, MapTask, MapTaskAttempt,
                      NoStragglers, PhaseCoeffs, RackCorrelated,
                      StragglerModel, TaskMapPhase, calibrate,
                      measurements_from_pipeline_bench, phase_work,
                      simulate_single_job)
from .network import (ROOT, FlowRecord, FluidNetwork, NetworkTelemetry,
                      RackTopology, resource_key, tor)
from .scheduler import (Decision, MultiJobScheduler, POLICIES, SchemeChooser,
                        run_scheduled)
from .workload import (BurstyWorkload, DiurnalWorkload, JOB_ZOO, JobSpec,
                       PoissonWorkload, Workload, default_catalog,
                       valid_subfile_counts)

__all__ = [
    "ConformanceModel", "calibrate_with_residuals", "conformance_report",
    "fit_conformance", "load_cost_model", "load_default_cost_model",
    "measurement_row_from_stats", "save_cost_model",
    "ClusterSim", "CostModel", "DeterministicSlowdown", "ExponentialTail",
    "JobStats", "MapTask", "MapTaskAttempt", "NoStragglers", "PhaseCoeffs",
    "RackCorrelated", "StragglerModel", "TaskMapPhase", "calibrate",
    "measurements_from_pipeline_bench", "phase_work", "simulate_single_job",
    "ROOT", "FlowRecord", "FluidNetwork", "NetworkTelemetry",
    "RackTopology", "resource_key", "tor",
    "Decision", "MultiJobScheduler", "POLICIES", "SchemeChooser",
    "run_scheduled",
    "BurstyWorkload", "DiurnalWorkload", "JOB_ZOO", "JobSpec",
    "PoissonWorkload", "Workload", "default_catalog", "valid_subfile_counts",
]
