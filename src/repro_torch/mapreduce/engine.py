"""Executable MapReduce engine over torch tensors: counterpart of
``repro/mapreduce/engine.py``.

A job maps each subfile to a dense intermediate tensor V_i in R^{Q x d}
(one length-d value per reduce key), shuffles so the reducer of key q holds
{V_i[q] : all i}, and reduces per key.  The engine reports the paper-metric
communication costs alongside the (bit-exact) results.

Two execution paths:
  * run_job             — dense map of all N subfiles and reduce, with the
    analytic (or message-counted) costs: the oracle.
  * run_job_distributed — the real two-stage hybrid shuffle of
    :mod:`repro_torch.core.coded_collectives`, in its stacked single-card
    form (a :class:`StackedMesh`) or one server per process (a
    :class:`ProcessMesh`: every rank calls it, and every rank returns the
    same global outputs).  Default ``fused=True`` keeps map -> shuffle ->
    reduce on the device with no host round trip between phases: each
    server maps only its own n_loc assigned subfiles (packed on the host
    from the raw input and uploaded once), the shuffle gathers from the
    plan's cached device index tables, and each server reduces its own
    keys.  ``fused=False`` keeps the legacy path (map all N, copy to the
    host, pack there, upload again) for comparison.  ``faults=`` runs the
    job under injected server crashes through the recovery ladder of
    :mod:`repro_torch.mapreduce.recovery` (stacked mesh only).

:func:`measure_phase_timings` / :func:`measure_calibration_grid` time the
legacy path's phases one by one on a stacked mesh, in the JAX package's
row format (the calibration feed of its simulator).

Entry points run on the CUDA card unless the caller asks for the CPU
(``device="cpu"`` for :func:`run_job`, a mesh made with ``device="cpu"``
for :func:`run_job_distributed`); with no device given and no card they
raise.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List

import numpy as np
import torch

from ..core.assignment import (coded_assignment, hybrid_assignment,
                               uncoded_assignment)
from ..core.coded_collectives import (HybridShufflePlan,
                                      compile_hybrid_plan,
                                      device_plan_tables,
                                      hybrid_shuffle, pack_local_values,
                                      rank_plan_tables, reduce_output_keys,
                                      shuffle_device_body,
                                      shuffle_rank_body)
from ..core.costs import (coded_cost, hybrid_cost, hybrid_resolvable_cost,
                          uncoded_cost)
from ..core.params import SchemeParams
from ..core.plan_registry import scheme_of_family
from ..core.resolvable import resolvable_assignment
from ..core.shuffle_plan import count_plan, make_plan
from ..distributed.collectives import all_gather
from ..distributed.meshes import (DeviceLike, ProcessMesh, StackedMesh,
                                  resolve_device)
from ..obs.bytes import plan_rack_bytes, reconcile, record_rack_bytes
from ..obs.metrics import refresh_cache_metrics
from ..obs.tracing import get_tracer, spans_from_phase_timings


@dataclasses.dataclass(frozen=True)
class MapReduceJob:
    name: str
    d: int                          # payload width per (key, subfile)
    # [B, ...] subfile data -> [B, Q, d]
    map_fn: Callable[[torch.Tensor, int], torch.Tensor]
    # [..., N, d] values of one key on all subfiles -> [..., d_out]
    reduce_fn: Callable[[torch.Tensor], torch.Tensor]


@dataclasses.dataclass
class JobResult:
    outputs: torch.Tensor                     # [Q, d_out] final reduced values
    intra_cost: float                         # paper metric (kv pairs)
    cross_cost: float
    scheme: str
    # filled by the recovery ladder when the job ran under injected faults
    # (repro_torch.mapreduce.recovery.RecoveryReport); None on failure-free
    # runs
    recovery: object | None = None
    # rack-level byte accounting in value-units (pairs x payload width d),
    # paper-metric counting, derived from the ACTUAL compiled plan and
    # reconciled against the closed forms (repro_torch.obs.bytes)
    intra_rack_bytes: float = 0.0
    cross_rack_bytes: float = 0.0
    # measured wall-clock blame components from the run's engine_phase
    # spans; None when tracing is disabled.  The fused device program stays
    # one indivisible 'map_shuffle_reduce' entry
    blame: Dict[str, float] | None = None


def _validate_mesh(mesh: StackedMesh | ProcessMesh,
                   p: SchemeParams) -> None:
    """Fail fast (and legibly) on a mesh that does not realize the scheme's
    (P racks) x (Kr servers) grid."""
    names = tuple(mesh.axis_names)
    if "rack" not in names or "server" not in names:
        raise ValueError(
            f"mesh must have axes ('rack', 'server'); got {names!r}")
    shape = dict(mesh.shape)
    if shape["rack"] != p.P or shape["server"] != p.Kr:
        raise ValueError(
            f"mesh shape (rack={shape['rack']}, server={shape['server']}) "
            f"does not match SchemeParams: need rack=P={p.P}, "
            f"server=Kr={p.Kr} (K={p.K} servers in {p.P} racks)")


def _assignment_for(params: SchemeParams, scheme: str):
    return {"uncoded": uncoded_assignment,
            "coded": coded_assignment,
            "hybrid": hybrid_assignment,
            "hybrid_resolvable": resolvable_assignment}[scheme](params)


def _sync(device: torch.device) -> None:
    """Wait for the device (the counterpart of ``block_until_ready``)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def map_phase(job: MapReduceJob, subfiles: torch.Tensor,
              Q: int) -> torch.Tensor:
    """[N, ...] subfile data -> V[N, Q, d]."""
    return job.map_fn(subfiles, Q)


def run_job(job: MapReduceJob, subfiles, params: SchemeParams,
            scheme: str = "hybrid", count_messages: bool = False, *,
            device: DeviceLike = None) -> JobResult:
    """Dense execution with the paper's communication accounting.

    ``count_messages=True`` counts the explicit schedule (slow, exact);
    otherwise the closed forms of Props 1-2 / Thm III.1 are used.
    """
    dev = resolve_device(device)
    V = map_phase(job, torch.as_tensor(subfiles, device=dev), params.Q)
    outputs = job.reduce_fn(V.transpose(0, 1))         # [Q, d_out]
    if count_messages:
        a = _assignment_for(params, scheme)
        counts = count_plan(make_plan(a), params)
        intra, cross = float(counts.intra), float(counts.cross)
    else:
        cost_fn = {"uncoded": uncoded_cost, "coded": coded_cost,
                   "hybrid": hybrid_cost,
                   "hybrid_resolvable": hybrid_resolvable_cost}[scheme]
        c = cost_fn(params)
        intra, cross = c.intra, c.cross
    return JobResult(outputs, intra, cross, scheme,
                     intra_rack_bytes=intra * job.d,
                     cross_rack_bytes=cross * job.d)


def pack_local_subfiles(subfiles, plan: HybridShufflePlan) -> np.ndarray:
    """Distribute raw subfile data into the fused pipeline's per-server
    layout: [K, n_loc, ...] — server (i, j)'s rows are ITS assigned
    subfiles in ``plan.local_subfiles[i, j]`` order (the only host-side
    step of the fused path)."""
    p = plan.params
    return np.asarray(subfiles)[plan.local_subfiles.reshape(p.K, -1)]


def _pack(rows, plan: HybridShufflePlan, mesh) -> np.ndarray:
    """Per-subfile ``rows`` (raw subfiles or mapped values) in the
    per-server layout: [K, n_loc, ...] on a stacked mesh, and on a
    :class:`ProcessMesh` this rank's own [n_loc, ...] alone."""
    if isinstance(mesh, ProcessMesh):
        i, j = mesh.coords
        return np.asarray(rows)[plan.local_subfiles[i, j]]
    return pack_local_subfiles(rows, plan)


def _gather(out: torch.Tensor, mesh) -> torch.Tensor:
    """The reduced rows of every server, [K, q_srv, d_out]: on a
    :class:`ProcessMesh` every rank's [q_srv, d_out], all-gathered in rank
    (= server) order; on a stacked mesh ``out`` itself."""
    if isinstance(mesh, ProcessMesh):
        return all_gather(out[None], mesh, mesh.axis_names)
    return out


def assemble_outputs(out: torch.Tensor,
                     plan: HybridShufflePlan) -> torch.Tensor:
    """[K, Q/K, d_out] per-server reduce rows -> [Q, d_out] in global key
    order, derived explicitly from :func:`reduce_output_keys` (a stable
    argsort of the flattened key ids)."""
    keys = reduce_output_keys(plan)
    flat = out.reshape(out.shape[0] * out.shape[1], -1)
    order = np.argsort(keys.reshape(-1), kind="stable")
    return flat[torch.as_tensor(order, device=flat.device)]


def _fused_map_shuffle_reduce(job: MapReduceJob, plan: HybridShufflePlan,
                              local_subs: torch.Tensor, multicast: str,
                              combine_impl: str) -> torch.Tensor:
    """Map each server's n_loc subfiles, shuffle, and reduce each server's
    keys, all on ``local_subs``'s device: [K, n_loc, ...] -> [K, q_srv,
    d_out]."""
    p = plan.params
    tables = device_plan_tables(plan, local_subs.device)
    vals = job.map_fn(local_subs.flatten(0, 1), p.Q)          # [K*n_loc,Q,d]
    rows = shuffle_device_body(vals.view(p.K, -1, p.Q, vals.shape[-1]),
                               plan, tables, multicast,
                               combine_impl)                  # [K,N,q_srv,d]
    return job.reduce_fn(rows.transpose(1, 2))


def _fused_rank(job: MapReduceJob, plan: HybridShufflePlan,
                local_subs: torch.Tensor, mesh: ProcessMesh, multicast: str,
                combine_impl: str) -> torch.Tensor:
    """:func:`_fused_map_shuffle_reduce` for this rank's server: [n_loc,
    ...] -> [q_srv, d_out]."""
    tables = rank_plan_tables(plan, mesh.rank, mesh.device)
    vals = job.map_fn(local_subs, plan.params.Q)              # [n_loc, Q, d]
    rows = shuffle_rank_body(vals, plan, tables, mesh, multicast,
                             combine_impl)                    # [N, q_srv, d]
    return job.reduce_fn(rows.transpose(0, 1))


def _blame_from_spans(events, cost) -> Dict[str, float] | None:
    """Fold one run's ``engine_phase`` trace spans into blame components
    (the JAX package's ``repro.obs.blame`` schema).  Host phases map
    directly; a measured legacy ``shuffle`` wall is split
    ``shuffle_cross`` / ``shuffle_intra`` by the scheme's closed-form unit
    ratio; the fused device program is kept whole under
    ``map_shuffle_reduce``.  Returns None when no spans were traced."""
    phases: Dict[str, float] = {}
    for ev in events:
        if ev.kind == "engine_phase" and ev.dur is not None:
            phases[ev.phase] = phases.get(ev.phase, 0.0) + float(ev.dur)
    if not phases:
        return None
    comps: Dict[str, float] = {}
    for k in ("plan_compile", "map", "pack", "reduce",
              "map_shuffle_reduce"):
        if k in phases:
            comps[k] = phases[k]
    if "shuffle" in phases:
        tot = cost.intra + cost.cross
        frac = cost.cross / tot if tot > 0 else 0.5
        comps["shuffle_cross"] = phases["shuffle"] * frac
        comps["shuffle_intra"] = phases["shuffle"] * (1.0 - frac)
    return comps


def run_job_distributed(job: MapReduceJob, subfiles,
                        params: SchemeParams,
                        mesh: StackedMesh | ProcessMesh,
                        r: int | None = None, *, fused: bool = True,
                        multicast: str = "unicast",
                        combine_impl: str = "torch",
                        placement: object | None = None,
                        scheme_family: str = "binomial",
                        faults: object | None = None) -> JobResult:
    """The hybrid-scheme job on ``mesh.device`` with the real two-stage
    shuffle (general map-replication r in [1, P]).

    ``mesh`` must have axes ('rack', 'server') with sizes (P, Kr) (see
    :func:`repro_torch.distributed.meshes.make_mesh`, or
    :func:`~repro_torch.distributed.meshes.make_process_mesh` in each rank:
    a rank packs, maps and shuffles only its own server's subfiles, reduces
    its q_srv keys, and all_gathers the reduced rows, so every rank
    returns the whole [Q, d_out] in global key order).  ``r`` overrides
    ``params.r``.  ``scheme_family`` selects the registered plan compiler:
    ``'binomial'`` (the paper's construction) or ``'resolvable'``.
    ``fused`` selects the device-resident path or the legacy host round
    trip (see the module docstring).  ``multicast`` and ``combine_impl``
    are forwarded to the shuffle (coded multicast packets and the CUDA f(.)
    kernels — see :func:`repro_torch.core.coded_collectives
    .shuffle_device_body`).  ``placement`` is a Section-IV slot
    permutation, bare or as any object with ``.perm``; it decides which
    subfile each server maps and leaves the outputs unchanged.  Returns
    outputs identical to :func:`run_job`.

    ``faults`` (a :class:`repro_torch.resilience.faults.FaultSpec`) runs
    the job under injected server crashes through the recovery ladder of
    :mod:`repro_torch.mapreduce.recovery` — decode-around, partial re-map,
    then bounded-retry restart — and fills ``JobResult.recovery``; outputs
    stay bit-identical to the failure-free run.  On a :class:`ProcessMesh`
    it raises ``NotImplementedError``: the ladder runs on a stacked mesh.
    """
    p = params if r is None or r == params.r else \
        dataclasses.replace(params, r=r)
    _validate_mesh(mesh, p)
    ranked = isinstance(mesh, ProcessMesh)
    if faults is not None:
        if ranked:
            raise NotImplementedError(
                "faults= runs the recovery ladder on a StackedMesh "
                "(make_mesh); the process form has no ladder yet")
        from .recovery import run_with_recovery
        res = run_with_recovery(job, subfiles, p, mesh, faults,
                                multicast=multicast,
                                combine_impl=combine_impl,
                                placement=placement,
                                scheme_family=scheme_family)
        refresh_cache_metrics()
        return res
    dev = mesh.device
    perm = getattr(placement, "perm", placement)
    tracer = get_tracer()
    span_lo = len(tracer.events)
    with tracer.span("plan_compile", kind="engine_phase",
                     job=job.name, family=scheme_family):
        plan = compile_hybrid_plan(p, perm=perm, family=scheme_family)
    if fused:
        with tracer.span("pack", kind="engine_phase", job=job.name):
            local_subs = torch.as_tensor(_pack(subfiles, plan, mesh),
                                         device=dev)
        with tracer.span("map_shuffle_reduce", kind="engine_phase",
                         job=job.name, fused="true"):
            if ranked:
                out = _fused_rank(job, plan, local_subs, mesh, multicast,
                                  combine_impl)         # [q_srv, d_out]
            else:
                out = _fused_map_shuffle_reduce(job, plan, local_subs,
                                                multicast, combine_impl)
            out = _gather(out, mesh)                    # [K, q_srv, d_out]
            _sync(dev)
    else:
        with tracer.span("map", kind="engine_phase", job=job.name):
            V = map_phase(job, torch.as_tensor(subfiles, device=dev),
                          p.Q).cpu().numpy()
        with tracer.span("pack", kind="engine_phase", job=job.name):
            local = _pack(V, plan, mesh)                # [K, n_loc, Q, d]
        with tracer.span("shuffle", kind="engine_phase", job=job.name):
            shuffled = hybrid_shuffle(local, plan, mesh, multicast,
                                      combine_impl)
            _sync(dev)
        with tracer.span("reduce", kind="engine_phase", job=job.name):
            # [K, N, q_srv, d]; rows ordered by reduce_ready_order
            out = _gather(job.reduce_fn(shuffled.transpose(-3, -2)), mesh)
            _sync(dev)
    final = assemble_outputs(out, plan)                 # [Q, d_out]
    scheme = scheme_of_family(scheme_family)
    c = (hybrid_resolvable_cost(p) if scheme_family == "resolvable"
         else hybrid_cost(p))
    # rack-level byte accounting off the ACTUAL compiled plan, paper-metric
    # counting, re-reconciled against the closed form on every run
    rb = record_rack_bytes(plan_rack_bytes(plan, "coded", job.d),
                           scheme, scheme_family, layer="engine")
    reconcile(rb.intra_total, rb.cross_total, p, scheme, d=job.d,
              check=False)
    refresh_cache_metrics()
    return JobResult(final, c.intra, c.cross, scheme,
                     intra_rack_bytes=rb.intra_total,
                     cross_rack_bytes=rb.cross_total,
                     blame=_blame_from_spans(tracer.events[span_lo:], c))


# ---------------------------------------------------------------------------
# Per-phase timing instrumentation (calibration feed)
# ---------------------------------------------------------------------------

def _best_of(fn: Callable[[], object], iters: int) -> float:
    """Best host-clock seconds of ``iters`` calls (host phases: each
    ``fn`` ends in a copy or a synchronize, so the device work is in)."""
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def _best_of_device(fn: Callable[[], object], iters: int,
                    device: torch.device) -> float:
    """Best seconds of ``iters`` calls of a device phase: CUDA events
    around each call on the card, the host clock on the CPU."""
    if device.type != "cuda":
        return _best_of(fn, iters)
    best = float("inf")
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / 1e3)
    return best


def measure_phase_timings(job: MapReduceJob, subfiles,
                          params: SchemeParams, mesh: StackedMesh,
                          iters: int = 3) -> Dict[str, object]:
    """Measure the per-phase time of the hybrid pipeline on
    ``mesh.device``, in the row format of the JAX package's
    ``measure_phase_timings`` (the calibration feed of its simulator).

    Phases are timed separately after a warm-up call, best of ``iters``:
    plan compile (cold: the plan cache and the per-plan device tables are
    cleared first), map of all N subfiles including its copy to the host,
    host pack including its upload, the stacked shuffle and the reduce.
    Shuffle and reduce are device phases, timed with CUDA events on the
    card and the host clock on the CPU; the others by the host clock.
    ``work`` holds the value-unit conventions of the JAX row;
    ``meta["backend"]`` names the device type the phases ran on.  On a
    :class:`ProcessMesh` it raises ``NotImplementedError``.
    """
    from ..core.coded_collectives import plan_cache_clear

    if isinstance(mesh, ProcessMesh):
        raise NotImplementedError(
            "measure_phase_timings times the phases on a StackedMesh "
            "(make_mesh); the process form is not timed by phase yet")
    p = params
    dev = mesh.device
    plan_cache_clear()
    t0 = time.perf_counter()
    plan = compile_hybrid_plan(p)
    compile_s = time.perf_counter() - t0

    subs_dev = torch.as_tensor(subfiles, device=dev)
    V_host = map_phase(job, subs_dev, p.Q).cpu().numpy()          # warm-up
    map_s = _best_of(lambda: map_phase(job, subs_dev, p.Q).cpu(), iters)

    def pack():
        local = torch.as_tensor(pack_local_values(V_host, plan), device=dev)
        _sync(dev)
        return local
    local_dev = pack()                                            # warm-up
    pack_s = _best_of(pack, iters)

    shuffled = hybrid_shuffle(local_dev, plan, mesh)              # warm-up
    shuffle_s = _best_of_device(lambda: hybrid_shuffle(local_dev, plan, mesh),
                                iters, dev)

    def reduce():
        return job.reduce_fn(shuffled.transpose(1, 2))
    reduce()                                                      # warm-up
    reduce_s = _best_of_device(reduce, iters, dev)

    d = job.d
    row = {
        "work": {
            "map": float(p.N) * p.Q * d,
            "pack": float(p.K) * plan.local_subfiles.shape[-1] * p.Q * d,
            "reduce": float(p.N) * p.Q * d,
            "plan_compile": float(p.N),
        },
        "seconds": {"map": map_s, "pack": pack_s, "reduce": reduce_s,
                    "plan_compile": compile_s},
        "meta": {"K": p.K, "P": p.P, "Q": p.Q, "N": p.N, "r": p.r, "d": d,
                 "job": job.name, "shuffle_s": shuffle_s,
                 "backend": dev.type},
    }
    if get_tracer().enabled:        # per-phase spans for trace export
        spans_from_phase_timings(row)
    return row


def measure_calibration_grid(job_factory: Callable[[int], MapReduceJob],
                             mesh: StackedMesh, points: List[tuple],
                             iters: int = 3) -> List[Dict[str, object]]:
    """Run :func:`measure_phase_timings` over (params, d) points, each on
    subfiles of 256 int32 tokens drawn from ``default_rng(params.N)`` as in
    the JAX package — enough rows for an affine per-phase fit to be
    overdetermined."""
    rows = []
    for params, d in points:
        job = job_factory(d)
        rng = np.random.default_rng(params.N)
        subs = rng.integers(0, 1 << 16,
                            size=(params.N, 256)).astype(np.int32)
        rows.append(measure_phase_timings(job, subs, params, mesh, iters))
    return rows
