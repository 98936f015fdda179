"""Engine recovery ladder: run a job to completion under injected server
crashes.  Counterpart of ``repro/mapreduce/recovery.py`` on the stacked
single-card layout.

Three rungs, cheapest first (the r-fold map replication is an erasure code
— see :mod:`repro_torch.core.degraded`):

1. **decode-around** — every row lost with the crashed servers still has a
   surviving replica owner (guaranteed for any f <= r-1 failures per
   multicast group), so a degraded plan re-routes stage 1 around the dead
   servers and NOTHING is re-mapped;
2. **partial re-map** — subfiles that lost ALL r owners (orphans) are
   re-mapped on the card and placed into stage 1 as an additive table
   patch; everything else still decodes around;
3. **bounded-retry restart** — unrecoverable attempts (every server dead,
   or orphans with ``allow_partial_remap=False``) burn one restart from the
   :class:`repro_torch.resilience.backoff.RestartBudget` (jittered
   exponential backoff) and re-enter the ladder on the injector's next
   attempt schedule.

Every rung produces outputs BIT-IDENTICAL to the failure-free run: degraded
stage-1 tables reconstruct exactly the failure-free tables (repair reads
are raw replica rows; orphan patches are exact re-mapped values), and
map, stage 2 and reduce run the same code as the fused pipeline.  The
degraded rungs run stage 1 as unicast, so they launch no combine kernel;
the ``none`` and ``restart`` rungs rerun the failure-free job with the
caller's ``multicast`` / ``combine_impl``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..core.coded_collectives import shuffle_device_body
from ..core.costs import hybrid_cost, hybrid_resolvable_cost
from ..core.degraded import DegradedPlan, compile_degraded_plan
from ..core.params import SchemeParams
from ..core.plan_registry import scheme_of_family
from ..obs import metrics as obs_metrics
from ..obs.bytes import degraded_rack_bytes, record_rack_bytes
from ..resilience.backoff import RestartBudget
from ..resilience.faults import FaultSpec

RECOVERY_RUNGS = ("none", "decode_around", "partial_remap", "restart")


class UnrecoverableFailure(RuntimeError):
    """An attempt cannot be salvaged by degraded execution (every server
    dead, or orphaned subfiles with partial re-map disabled) — escalates to
    the restart rung."""


@dataclasses.dataclass(frozen=True)
class RecoveryReport:
    """How a faulted job actually finished: which ladder rung produced the
    returned outputs, which servers were dead during the successful
    attempt, how many subfiles were re-mapped, and the restart accounting
    (delays are the recorded backoff schedule, slept only if the
    :class:`FaultSpec` carried a sleeper)."""
    rung: str
    failed: Tuple[int, ...]
    n_remapped: int
    restarts: int
    backoff_delays: Tuple[float, ...]
    attempts: int


def alive_mask(p: SchemeParams, failed, device) -> torch.Tensor:
    """[K] bool on ``device``: False at the failed flat server ids."""
    alive = np.ones(p.K, dtype=bool)
    alive[list(failed)] = False
    return torch.as_tensor(alive, device=device)


def degraded_device_body(vals: torch.Tensor, dplan: DegradedPlan,
                         tables, alive: torch.Tensor,
                         patch: Optional[torch.Tensor] = None,
                         combine_impl: str = "torch") -> torch.Tensor:
    """Crash mask, then the degraded unicast shuffle (+ orphan patch):
    [K, n_loc, Q, d] mapped values -> [K, N, q_srv, d] reduce rows.

    The mask zeroes the failed servers' map outputs on the device — the
    replacement worker at that coordinate takes part in the exchange with
    empty memory — so whatever those rows held (tests poison them with NaN
    or 0x7fffffff) never reaches an output."""
    vals = torch.where(alive.view(-1, 1, 1, 1), vals, 0)
    return shuffle_device_body(vals, dplan.plan, tables, "unicast",
                               combine_impl, patch=patch)


def patch_rows(dplan: DegradedPlan) -> Tuple[np.ndarray, np.ndarray]:
    """Where each orphan row goes: (dst, src) row indices such that
    ``patch[dst] = orphan_vals.view(n_orphans * P, q_rack, d)[src]``, with
    the patch viewed as [K * n_layer, q_rack, d] — server (i, j) receives
    rack i's key block of every orphan row of layer j (the placement of
    :func:`repro_torch.core.degraded.build_patch`)."""
    p = dplan.params
    n_layer = p.subfiles_per_layer
    index = {int(sf): m for m, sf in enumerate(dplan.orphan_subfiles)}
    layer_sub = np.asarray(dplan.base.layer_subfiles)
    dst, src = [], []
    for j, rows in enumerate(dplan.orphan_rows):
        for t in rows:
            m = index[int(layer_sub[0, j, t])]
            for i in range(p.P):
                dst.append(p.server_id(i, j) * n_layer + int(t))
                src.append(m * p.P + i)
    return np.asarray(dst, dtype=np.int64), np.asarray(src, dtype=np.int64)


def device_patch(dplan: DegradedPlan,
                 orphan_vals: torch.Tensor) -> Optional[torch.Tensor]:
    """The [K, n_layer, q_rack, d] stage-1 patch on ``orphan_vals``'s
    device and in its dtype, placed by index from the re-mapped values
    (``orphan_vals[m]`` is the [Q, d] map output of
    ``dplan.orphan_subfiles[m]``); None when nothing is orphaned.  Same
    bits as the NumPy :func:`~repro_torch.core.degraded.build_patch`."""
    if not dplan.orphan_subfiles.size:
        return None
    p = dplan.params
    q_rack, d = p.Q // p.P, orphan_vals.shape[-1]
    dev = orphan_vals.device
    dst, src = (torch.as_tensor(a, device=dev) for a in patch_rows(dplan))
    patch = orphan_vals.new_zeros((p.K * p.subfiles_per_layer, q_rack, d))
    patch.index_copy_(0, dst, orphan_vals.reshape(-1, q_rack, d)
                      .index_select(0, src))
    return patch.view(p.K, p.subfiles_per_layer, q_rack, d)


def _degraded_map_shuffle_reduce(job, dplan: DegradedPlan,
                                 local_subs: torch.Tensor,
                                 patch: Optional[torch.Tensor],
                                 combine_impl: str) -> torch.Tensor:
    """The degraded program on ``local_subs``'s device: map each server's
    n_loc subfiles (as the fused pipeline does), crash mask, degraded
    unicast shuffle with the patch, reduce: [K, n_loc, ...] -> [K, q_srv,
    d_out]."""
    p = dplan.params
    dev = local_subs.device
    vals = job.map_fn(local_subs.flatten(0, 1), p.Q)         # [K*n_loc,Q,d]
    rows = degraded_device_body(
        vals.view(p.K, -1, p.Q, vals.shape[-1]), dplan,
        dplan.device_tables(dev), alive_mask(p, dplan.failed, dev), patch,
        combine_impl)
    return job.reduce_fn(rows.transpose(1, 2))


def _degraded_attempt(job, subfiles, p: SchemeParams, mesh,
                      failed: Tuple[int, ...], faults: FaultSpec, *,
                      combine_impl: str, placement, scheme_family: str):
    """Rungs 1-2: degraded execution around ``failed``; returns
    (outputs [K, q_srv, d_out], degraded plan, n_remapped, rung)."""
    from .engine import pack_local_subfiles
    if len(failed) >= p.K:
        raise UnrecoverableFailure(
            f"all {p.K} servers failed; no survivors to recover on")
    perm = getattr(placement, "perm", placement)
    dplan = compile_degraded_plan(p, failed, family=scheme_family, perm=perm)
    n_remap = int(dplan.orphan_subfiles.size)
    if n_remap and not faults.allow_partial_remap:
        raise UnrecoverableFailure(
            f"{n_remap} subfiles lost all {p.r} owners and partial re-map "
            f"is disabled")
    dev = mesh.device
    local_subs = torch.as_tensor(pack_local_subfiles(subfiles, dplan.base),
                                 device=dev)
    patch = None
    if n_remap:
        # rung 2: re-map ONLY the orphaned subfiles and place them into
        # stage 1 as a patch
        orphans = torch.as_tensor(np.asarray(subfiles)[dplan.orphan_subfiles],
                                  device=dev)
        patch = device_patch(dplan, job.map_fn(orphans, p.Q))
    out = _degraded_map_shuffle_reduce(job, dplan, local_subs, patch,
                                       combine_impl)
    rung = "partial_remap" if n_remap else "decode_around"
    return out, dplan, n_remap, rung


def run_with_recovery(job, subfiles, p: SchemeParams, mesh,
                      faults: FaultSpec, *, multicast: str = "unicast",
                      combine_impl: str = "torch", placement=None,
                      scheme_family: str = "binomial"):
    """Execute ``job`` under the fault schedule, climbing the recovery
    ladder until an attempt completes; returns the
    :class:`repro_torch.mapreduce.engine.JobResult` with ``.recovery``
    filled.

    ``p`` must already carry the effective r (the engine resolves the
    override before dispatching here).  Attempt k applies
    ``faults.injector.events_for_attempt(k)``; an attempt with no scheduled
    events runs the plain failure-free fused path (that is how transient
    failures resolve after a restart).
    """
    from .engine import JobResult, assemble_outputs, run_job_distributed
    budget = RestartBudget(max_restarts=faults.max_restarts,
                           policy=faults.backoff, seed=faults.seed,
                           sleep=faults.sleep)
    attempt = 0
    while True:
        events = faults.injector.events_for_attempt(attempt)
        failed = tuple(sorted({s for e in events for s in e.servers}))
        try:
            if not failed:
                res = run_job_distributed(
                    job, subfiles, p, mesh, fused=True, multicast=multicast,
                    combine_impl=combine_impl, placement=placement,
                    scheme_family=scheme_family)
                rung = "none" if attempt == 0 else "restart"
                _record_rung(rung, scheme_family)
                res.recovery = RecoveryReport(
                    rung, failed, 0, budget.restarts, tuple(budget.delays),
                    attempt + 1)
                return res
            out, dplan, n_remap, rung = _degraded_attempt(
                job, subfiles, p, mesh, failed, faults,
                combine_impl=combine_impl, placement=placement,
                scheme_family=scheme_family)
            final = assemble_outputs(out, dplan.plan)
            c = (hybrid_resolvable_cost(p) if scheme_family == "resolvable"
                 else hybrid_cost(p))
            scheme = scheme_of_family(scheme_family)
            # the degraded attempt's ACTUAL wire bytes (unicast repair
            # schedule + orphan redistribution), not the failure-free
            # closed form — what a recovery really moved
            rb = record_rack_bytes(degraded_rack_bytes(dplan, job.d),
                                   scheme, scheme_family,
                                   layer="engine_degraded")
            _record_rung(rung, scheme_family)
            res = JobResult(final, c.intra, c.cross, scheme,
                            intra_rack_bytes=rb.intra_total,
                            cross_rack_bytes=rb.cross_total)
            res.recovery = RecoveryReport(
                rung, failed, n_remap, budget.restarts,
                tuple(budget.delays), attempt + 1)
            return res
        except UnrecoverableFailure as e:
            budget.next_restart(e)    # raises e when the budget is spent
            obs_metrics.counter(
                "engine_restarts_total",
                "restart-budget consumption of the recovery ladder").inc(
                    family=scheme_family)
            attempt += 1


def _record_rung(rung: str, family: str) -> None:
    obs_metrics.counter(
        "recovery_rung_total",
        "recovery-ladder rung that produced the returned outputs").inc(
            rung=rung, family=family)


__all__ = ["RecoveryReport", "RECOVERY_RUNGS", "UnrecoverableFailure",
           "alive_mask", "degraded_device_body", "device_patch",
           "patch_rows", "run_with_recovery"]
