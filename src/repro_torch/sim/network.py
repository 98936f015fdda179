"""Two-tier server-rack network: ToR switches + root switch, fluid fair share.

Topology (the paper's Fig. 1): K servers in P racks; every server hangs off
its rack's Top-of-Rack switch, and the P ToR switches hang off one root
switch.  Intra-rack transfers traverse only the sender's ToR; cross-rack
transfers traverse the root (a coded multicast counted ONCE — the paper
metric).

The contention model is processor-sharing fluid flow: each resource (the
root switch, or one ToR switch) divides its capacity EQUALLY among its
active flows.  The simulator aggregates one flow per (job, stage, resource),
so the equal split is per-JOB fairness — the standard abstraction for
datacenter flow-level simulation (cf. flow-level models in coflow/Varys
literature).

Calibration identity: with one job, no stragglers, and a uniform topology,
the hybrid shuffle drains its cross stage in ``cross_pairs / cross_bw``
(single flow on the root) and its intra stage in ``intra_total / intra_bw``
(P parallel per-rack flows of ``intra_total / P`` each on ToR capacity
``intra_bw / P``) — exactly
:meth:`repro_torch.core.costs.CommCost.weighted_time`.
That equality holds on the full Table I grid in the JAX package's
``tests/test_table1_regression.py``, and the port's traces equal its.

Telemetry: an optional :class:`NetworkTelemetry` observer (sampled on the
sim clock, see :class:`repro_torch.sim.ClusterSim`) records per-resource
utilization / active-flow / backlog time series and per-flow lifecycle
records including the full contention-share (rate) history.  It is OFF by
default and records on the same event boundaries the simulator already
processes, so enabling it never changes event order — seeded traces stay
bit-identical with telemetry on or off, and the telemetry itself is
byte-identical per seed.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple, Union

from ..obs import metrics as obs_metrics

Resource = Union[str, Tuple[str, int]]          # 'root' | ('tor', rack)

ROOT: Resource = "root"


def tor(rack: int) -> Resource:
    return ("tor", rack)


def resource_key(res: Resource) -> str:
    """Stable string key for a resource ('root' or 'tor:<rack>') — used as
    the JSON-safe identifier in telemetry exports and report tables."""
    if res == ROOT:
        return "root"
    _, rack = res
    return f"tor:{rack}"


@dataclasses.dataclass(frozen=True)
class RackTopology:
    """Bandwidths are in value-units/s (pairs x payload width d).

    ``cross_bw`` is the root-switch capacity; ``intra_bw`` is the AGGREGATE
    intra tier capacity, split evenly over the P ToR switches (so one rack's
    ToR runs at ``intra_bw / P``) — the convention under which zero-contention
    simulated shuffle time equals ``CommCost.weighted_time(intra_bw,
    cross_bw)``.  ``rack_bw_scale`` skews individual ToR switches (straggling
    racks / heterogeneous hardware); ``cross_latency`` / ``intra_latency``
    add a fixed per-stage latency floor, and ``fetch_latency`` the floor of
    the pre-map input-fetch stage a locality-aware placement generates
    (see :mod:`repro_torch.placement.sim_bridge`).
    """
    P: int
    cross_bw: float = 1.0
    intra_bw: float = 10.0
    rack_bw_scale: Tuple[float, ...] | None = None
    cross_latency: float = 0.0
    intra_latency: float = 0.0
    fetch_latency: float = 0.0

    def __post_init__(self) -> None:
        if self.P < 1 or self.cross_bw <= 0 or self.intra_bw <= 0:
            raise ValueError("need P >= 1 and positive bandwidths")
        if self.rack_bw_scale is not None:
            if len(self.rack_bw_scale) != self.P:
                raise ValueError(f"rack_bw_scale must have P={self.P} entries")
            if any(s <= 0 for s in self.rack_bw_scale):
                raise ValueError("rack_bw_scale entries must be positive")

    def capacity(self, res: Resource) -> float:
        if res == ROOT:
            return self.cross_bw
        _, rack = res
        scale = self.rack_bw_scale[rack] if self.rack_bw_scale else 1.0
        return self.intra_bw / self.P * scale

    def latency(self, stage: str) -> float:
        if stage == "fetch":
            return self.fetch_latency
        return self.cross_latency if stage == "cross" else self.intra_latency

    def resources(self) -> List[Resource]:
        return [ROOT] + [tor(r) for r in range(self.P)]


@dataclasses.dataclass
class Flow:
    flow_id: int
    resource: Resource
    remaining: float                 # value-units left to move
    tag: Tuple                       # (job_id, phase, ...) — for the trace
    size: float = 0.0                # original value-units (byte accounting)


def _tag_stage(tag: Tuple) -> str:
    """Stage label of a flow tag — tags are (job_id, stage, ...) tuples
    ('cross' | 'intra' | 'fetch_cross' | 'fetch_intra' | 'spec_fetch')."""
    return str(tag[1]) if len(tag) > 1 else "unknown"


@dataclasses.dataclass
class FlowRecord:
    """Lifecycle record of one flow: identity, start/end on the sim clock,
    terminal state, bytes drained, and the contention-share history — one
    ``(t, rate)`` entry per rate change (equal share changes exactly when
    the resource's active-flow set changes)."""
    flow_id: int
    resource: str                    # resource_key form
    tag: Tuple
    size: float
    start: float
    end: float = -1.0
    state: str = "active"            # -> 'done' | 'cancelled'
    drained: float = 0.0
    reason: str = ""                 # cancellation reason, '' otherwise
    rates: List[Tuple[float, float]] = dataclasses.field(default_factory=list)

    def to_dict(self) -> Dict[str, object]:
        return {"flow_id": self.flow_id, "resource": self.resource,
                "tag": list(self.tag), "size": self.size,
                "start": self.start, "end": self.end, "state": self.state,
                "drained": self.drained, "reason": self.reason,
                "rates": [list(rc) for rc in self.rates]}


class NetworkTelemetry:
    """Deterministic observer of a :class:`FluidNetwork`.

    Sampled on the injected sim clock at every flow-set change (start /
    finish / cancel) — the exact instants at which equal-share rates can
    change — so the series are lossless for a fluid network while staying
    O(#flow events) in size.  Per resource it keeps ``(t, active_flows,
    backlog)`` samples; per flow a :class:`FlowRecord` with the full rate
    history.  Purely observational: it never mutates the network and emits
    no trace events, so golden traces are untouched.
    """

    def __init__(self, topology: RackTopology,
                 clock: Callable[[], float]) -> None:
        self.topology = topology
        self.clock = clock
        self.flows: Dict[int, FlowRecord] = {}
        self.samples: Dict[str, List[Tuple[float, int, float]]] = {
            resource_key(res): [] for res in topology.resources()}

    # -- lifecycle hooks (driven by FluidNetwork) ---------------------------
    def flow_started(self, flow: Flow) -> None:
        self.flows[flow.flow_id] = FlowRecord(
            flow.flow_id, resource_key(flow.resource), flow.tag,
            flow.size, self.clock())

    def flow_finished(self, flow: Flow) -> None:
        rec = self.flows.get(flow.flow_id)
        if rec is not None:
            rec.end = self.clock()
            rec.state = "done"
            rec.drained = flow.size

    def flow_cancelled(self, flow: Flow, reason: str) -> None:
        rec = self.flows.get(flow.flow_id)
        if rec is not None:
            rec.end = self.clock()
            rec.state = "cancelled"
            rec.drained = max(flow.size - flow.remaining, 0.0)
            rec.reason = reason

    def sample(self, net: "FluidNetwork") -> None:
        """Record one sample per resource (and refresh per-flow rates)."""
        t = self.clock()
        rates = net.rates() if net.flows else {}
        counts: Dict[str, int] = {}
        backlogs: Dict[str, float] = {}
        for f in net.flows.values():
            key = resource_key(f.resource)
            counts[key] = counts.get(key, 0) + 1
            backlogs[key] = backlogs.get(key, 0.0) + f.remaining
        for key, series in self.samples.items():
            row = (t, counts.get(key, 0), backlogs.get(key, 0.0))
            if series and series[-1][0] == t:
                series[-1] = row        # coalesce same-instant events
            elif not series or series[-1][1:] != row[1:]:
                series.append(row)
        for fid in sorted(rates):
            rec = self.flows.get(fid)
            if rec is None:
                continue
            rate = rates[fid]
            if rec.rates and rec.rates[-1][0] == t:
                rec.rates[-1] = (t, rate)
            elif not rec.rates or rec.rates[-1][1] != rate:
                rec.rates.append((t, rate))

    # -- summaries ----------------------------------------------------------
    def utilization(self, until: Optional[float] = None) -> Dict[str, Dict[str, float]]:
        """Per-resource rollup over [first sample, ``until``]: busy seconds
        (>=1 active flow), utilization fraction, time-weighted mean active
        flows, peak backlog, and flow outcome counts."""
        horizon = self.clock() if until is None else float(until)
        out: Dict[str, Dict[str, float]] = {}
        for key, series in self.samples.items():
            busy = 0.0
            flow_time = 0.0
            peak_backlog = 0.0
            span = 0.0
            for i, (t, active, backlog) in enumerate(series):
                t_next = series[i + 1][0] if i + 1 < len(series) else horizon
                dt = max(t_next - t, 0.0)
                span += dt
                if active > 0:
                    busy += dt
                    flow_time += active * dt
                peak_backlog = max(peak_backlog, backlog)
            done = cancelled = 0
            for rec in self.flows.values():
                if rec.resource != key:
                    continue
                if rec.state == "done":
                    done += 1
                elif rec.state == "cancelled":
                    cancelled += 1
            out[key] = {"busy_s": busy,
                        "util": busy / span if span > 0 else 0.0,
                        "mean_active_flows": flow_time / span if span > 0 else 0.0,
                        "peak_backlog": peak_backlog,
                        "flows_done": float(done),
                        "flows_cancelled": float(cancelled)}
        return out

    def cancelled_units(self) -> Dict[str, float]:
        """Partially-drained value-units of cancelled flows, by stage label
        (the telemetry-side mirror of ``flow_cancelled_bytes_total``)."""
        out: Dict[str, float] = {}
        for fid in sorted(self.flows):
            rec = self.flows[fid]
            if rec.state == "cancelled":
                stage = _tag_stage(rec.tag)
                out[stage] = out.get(stage, 0.0) + rec.drained
        return out

    def to_dict(self) -> Dict[str, object]:
        """Deterministic JSON-able dump — byte-identical per seed (pinned
        per seed)."""
        return {"samples": {k: [list(s) for s in self.samples[k]]
                            for k in sorted(self.samples)},
                "flows": [self.flows[fid].to_dict()
                          for fid in sorted(self.flows)]}


class FluidNetwork:
    """Set of active flows advancing under per-resource equal share."""

    def __init__(self, topology: RackTopology,
                 telemetry: Optional[NetworkTelemetry] = None) -> None:
        self.topology = topology
        self.flows: Dict[int, Flow] = {}
        self.telemetry = telemetry
        self._next_id = 0

    def start_flow(self, resource: Resource, size: float, tag: Tuple) -> int:
        fid = self._next_id
        self._next_id += 1
        sz = max(float(size), 0.0)
        self.flows[fid] = Flow(fid, resource, sz, tag, sz)
        if self.telemetry is not None:
            self.telemetry.flow_started(self.flows[fid])
            self.telemetry.sample(self)
        return fid

    def _counts(self) -> Dict[Resource, int]:
        counts: Dict[Resource, int] = {}
        for f in self.flows.values():
            counts[f.resource] = counts.get(f.resource, 0) + 1
        return counts

    def rates(self) -> Dict[int, float]:
        """Current drain rate of every active flow (equal share)."""
        counts = self._counts()
        return {fid: self.topology.capacity(f.resource) / counts[f.resource]
                for fid, f in self.flows.items()}

    def _account_cancel(self, flow: Flow, reason: str) -> None:
        """Wasted-work accounting: a cancelled flow's partially-drained
        units were moved and then thrown away (speculation losers, crash-
        voided stages) — count them instead of dropping them silently."""
        drained = max(flow.size - flow.remaining, 0.0)
        if drained > 0:
            obs_metrics.counter(
                "flow_cancelled_bytes_total",
                "Partially-drained value-units of cancelled flows "
                "(wasted work: speculation losers, crash-voided stages)"
            ).inc(drained, stage=_tag_stage(flow.tag), reason=reason)
        if self.telemetry is not None:
            self.telemetry.flow_cancelled(flow, reason)

    def cancel_flow(self, flow_id: int, reason: str = "cancelled") -> None:
        """Abort an active flow (first-finisher-wins speculation kills the
        losing attempt's input fetch); freed capacity is re-shared among the
        survivors from the next advance.  Unknown/finished ids are no-ops.
        Partially-drained units are counted into
        ``flow_cancelled_bytes_total{stage,reason}``."""
        flow = self.flows.pop(flow_id, None)
        if flow is not None:
            self._account_cancel(flow, reason)
            if self.telemetry is not None:
                self.telemetry.sample(self)

    def cancel_flows(self, match, reason: str = "cancelled") -> int:
        """Abort every active flow whose ``tag`` matches the predicate, in
        deterministic (flow_id) order; returns the number cancelled.  A
        server crash mid-shuffle voids the job's whole in-flight stage —
        ``cancel_flows(lambda tag: tag[0] == job_id)`` guarantees no orphan
        flows keep draining a dead job's bytes (asserted in tests).
        Partially-drained units are counted like :meth:`cancel_flow`."""
        doomed = [fid for fid in sorted(self.flows)
                  if match(self.flows[fid].tag)]
        for fid in doomed:
            self._account_cancel(self.flows[fid], reason)
            del self.flows[fid]
        if doomed and self.telemetry is not None:
            self.telemetry.sample(self)
        return len(doomed)

    def backlog(self, resource: Resource) -> float:
        """Total value-units queued on a resource (scheduler load signal)."""
        return sum(f.remaining for f in self.flows.values()
                   if f.resource == resource)

    def time_to_next_completion(self) -> float:
        """Time until the earliest active flow drains at current rates
        (inf when no flows are active)."""
        rates = self.rates()
        dt = float("inf")
        for fid, f in sorted(self.flows.items()):
            dt = min(dt, f.remaining / rates[fid])
        return dt

    def advance(self, dt: float) -> List[Flow]:
        """Drain all flows for ``dt`` seconds; return completed flows in
        deterministic (flow_id) order.  A flow whose residue would drain in
        under a nanosecond at its current rate completes now — the guard
        that keeps float round-off from stranding un-advanceable slivers."""
        if not self.flows:
            return []
        rates = self.rates()
        done: List[Flow] = []
        for fid in sorted(self.flows):
            f = self.flows[fid]
            f.remaining -= rates[fid] * dt
            if f.remaining <= rates[fid] * 1e-9:
                f.remaining = 0.0
                done.append(f)
        for f in done:
            del self.flows[f.flow_id]
        if done and self.telemetry is not None:
            for f in done:
                self.telemetry.flow_finished(f)
            self.telemetry.sample(self)
        return done
