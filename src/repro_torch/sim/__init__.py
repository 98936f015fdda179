"""repro_torch.sim — rack-level cluster simulator, the counterpart of the JAX
package's ``repro.sim`` core.

Answers the question the closed forms cannot: what is job completion TIME
under link contention, stragglers, skewed bandwidth, crashes, or several
concurrent jobs?  A discrete-event loop in Python over float64 NumPy, on
the host as in the JAX package: the same seed gives the same trace, event
for event.  Seeded crash schedules come from
:class:`repro_torch.resilience.faults.FaultInjector` (``inject_into``) or
:meth:`ClusterSim.inject_crash`.  The multi-job scheduler and the
calibration conformance model are not ported yet.
"""
from .cluster import (ClusterSim, CostModel, DeterministicSlowdown,
                      ExponentialTail, JobStats, MapTask, MapTaskAttempt,
                      NoStragglers, PhaseCoeffs, RackCorrelated,
                      StragglerModel, TaskMapPhase, calibrate,
                      measurements_from_pipeline_bench, phase_work,
                      simulate_single_job)
from .network import (ROOT, FlowRecord, FluidNetwork, NetworkTelemetry,
                      RackTopology, resource_key, tor)
from .workload import (BurstyWorkload, DiurnalWorkload, JOB_ZOO, JobSpec,
                       PoissonWorkload, Workload, default_catalog,
                       valid_subfile_counts)

__all__ = [
    "ClusterSim", "CostModel", "DeterministicSlowdown", "ExponentialTail",
    "JobStats", "MapTask", "MapTaskAttempt", "NoStragglers", "PhaseCoeffs",
    "RackCorrelated", "StragglerModel", "TaskMapPhase", "calibrate",
    "measurements_from_pipeline_bench", "phase_work", "simulate_single_job",
    "ROOT", "FlowRecord", "FluidNetwork", "NetworkTelemetry",
    "RackTopology", "resource_key", "tor",
    "BurstyWorkload", "DiurnalWorkload", "JOB_ZOO", "JobSpec",
    "PoissonWorkload", "Workload", "default_catalog", "valid_subfile_counts",
]
