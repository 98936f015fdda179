"""Explicit data-shuffling schedules for Uncoded / Coded / Hybrid MapReduce.

A *plan* is a deterministic sequence of :class:`Message`.  Counting the
messages of a plan must reproduce the closed forms in :mod:`repro_torch.core.costs`
(that equality is asserted in tests — the schedules are the proof that the
formulas describe a realizable shuffle).

A coded message multicasts ONE linear combination of ``r`` intermediate
values; every intended receiver already knows all components except its own
(side information from replicated map tasks) and recovers its missing value
by subtraction.  :func:`execute_plan` simulates exactly that on integer
payloads and asserts information-completeness at every step, which validates
decodability of the whole schedule — the paper's central claim.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, Iterable, Iterator, List, Tuple

import numpy as np

from .assignment import Assignment, rack_subsets
from .params import SchemeParams

# One component of a (possibly coded) message: this message lets `receiver`
# recover the value of `key` computed on `subfile`.
Component = Tuple[int, int, int]            # (receiver, key, subfile)


@dataclasses.dataclass(frozen=True)
class Message:
    sender: int
    components: Tuple[Component, ...]       # r components for a coded msg
    stage: str                              # 'shuffle' | 'cross' | 'intra'

    @property
    def receivers(self) -> Tuple[int, ...]:
        return tuple(sorted({c[0] for c in self.components}))

    def is_cross(self, p: SchemeParams) -> bool:
        """A message uses the root switch iff any receiver is outside the
        sender's rack (the paper attributes the whole multicast to the root
        switch in that case)."""
        my_rack = p.rack_of(self.sender)
        return any(p.rack_of(rcv) != my_rack for rcv in self.receivers)


@dataclasses.dataclass
class PlanCounts:
    intra: int = 0
    cross: int = 0

    @property
    def total(self) -> int:
        return self.intra + self.cross


def count_plan(plan: Iterable[Message], p: SchemeParams) -> PlanCounts:
    counts = PlanCounts()
    for m in plan:
        if m.is_cross(p):
            counts.cross += 1
        else:
            counts.intra += 1
    return counts


# ---------------------------------------------------------------------------
# Plan generators
# ---------------------------------------------------------------------------

def uncoded_plan(assignment: Assignment) -> Iterator[Message]:
    """Every mapper unicasts each (key, subfile) value to the key's reducer."""
    p = assignment.params
    for subfile, servers in enumerate(assignment.servers_of_subfile):
        (mapper,) = servers
        for key in range(p.Q):
            reducer = p.server_of_key(key)
            if reducer != mapper:
                yield Message(mapper, ((reducer, key, subfile),), "shuffle")


def _chunk(subfiles: List[int], sender_pos: int, n_senders: int) -> List[int]:
    """The sender's share of a receiver's needed subfiles (paper splits the
    M (resp. J) subfiles evenly among the r senders)."""
    per = len(subfiles) // n_senders
    return subfiles[sender_pos * per:(sender_pos + 1) * per]


def coded_plan(assignment: Assignment) -> Iterator[Message]:
    """Coded MapReduce shuffle (Prop. 2 schedule).

    For every (r+1)-subset S of servers, every member `a` multicasts
    (Q/K) * (J/r) coded messages; the message for (u, w) combines, for each
    receiver z in S \\ {a}, the value of z's u-th reduce key on the w-th
    subfile of a's share of the subfiles mapped at T_z = S \\ {z}.
    """
    p = assignment.params
    r = p.r
    if p.J % max(r, 1) != 0:
        raise ValueError(f"executable coded plan needs r|J; J={p.J} r={r}")
    q_per = p.Q // p.K

    # subfiles per server-subset, in deterministic order
    by_subset: Dict[Tuple[int, ...], List[int]] = {}
    for i, servers in enumerate(assignment.servers_of_subfile):
        by_subset.setdefault(tuple(servers), []).append(i)

    for S in itertools.combinations(range(p.K), r + 1):
        for a in S:
            others = [z for z in S if z != a]
            for w in range(p.J // r):
                for u in range(q_per):
                    comps = []
                    for z in others:
                        T_z = tuple(s for s in S if s != z)
                        pos = T_z.index(a)
                        sub = _chunk(by_subset[T_z], pos, r)[w]
                        key = list(p.keys_of_server(z))[u]
                        comps.append((z, key, sub))
                    yield Message(a, tuple(comps), "shuffle")


def hybrid_plan(assignment: Assignment) -> Iterator[Message]:
    """Hybrid Coded MapReduce shuffle (Sec. III schedule): a cross-rack coded
    stage per layer followed by an uncoded intra-rack stage."""
    p = assignment.params
    r = p.r
    if r >= 1 and p.M % max(r, 1) != 0:
        raise ValueError(f"executable hybrid plan needs r|M; M={p.M} r={r}")
    subsets = rack_subsets(p.P, r)
    q_per_rack = p.Q // p.P

    # layer -> rack-subset -> subfiles (deterministic order)
    slot_of = assignment.meta["slot_of_subfile"]
    by_layer_subset: Dict[Tuple[int, int], List[Tuple[int, int]]] = {}
    for subfile, (layer, t_idx, w) in enumerate(slot_of):  # type: ignore[arg-type]
        by_layer_subset.setdefault((layer, t_idx), []).append((w, subfile))
    layer_subset_files = {
        k: [sub for _, sub in sorted(v)] for k, v in by_layer_subset.items()
    }

    # ---- Stage 1: cross-rack coded multicasts, independently per layer ------
    for layer in range(p.n_layers):
        for S in itertools.combinations(range(p.P), r + 1):  # racks
            for a_rack in S:
                sender = p.server_id(a_rack, layer)
                others = [z for z in S if z != a_rack]
                for w in range(p.M // r):
                    for u in range(q_per_rack):
                        comps = []
                        for z_rack in others:
                            T_z = tuple(x for x in S if x != z_rack)
                            t_idx = subsets.index(T_z)
                            pos = T_z.index(a_rack)
                            files = layer_subset_files[(layer, t_idx)]
                            sub = _chunk(files, pos, r)[w]
                            key = list(p.keys_of_rack(z_rack))[u]
                            comps.append((p.server_id(z_rack, layer), key, sub))
                        yield Message(sender, tuple(comps), "cross")

    # ---- Stage 2: intra-rack unicast ----------------------------------------
    # After stage 1, server (rack, layer) holds the values of ALL subfiles of
    # its layer for ALL of its rack's keys; it forwards each in-rack peer's
    # reduce keys for every layer subfile.
    per_layer = p.subfiles_per_layer
    layer_files: Dict[int, List[int]] = {la: [] for la in range(p.n_layers)}
    for subfile, (layer, t_idx, w) in enumerate(slot_of):  # type: ignore[arg-type]
        layer_files[layer].append(subfile)
    for layer in range(p.n_layers):
        assert len(layer_files[layer]) == per_layer
        for rack in range(p.P):
            sender = p.server_id(rack, layer)
            for subfile in layer_files[layer]:
                for key in p.keys_of_rack(rack):
                    reducer = p.server_of_key(key)
                    if reducer != sender:
                        yield Message(sender, ((reducer, key, subfile),),
                                      "intra")


def resolvable_hybrid_plan(assignment: Assignment) -> Iterator[Message]:
    """Resolvable-design hybrid shuffle (see :mod:`repro_torch.core.resolvable`):
    per layer, one coded multicast stream per (non-codeword group, sender
    class); stage 2 is the hybrid scheme's intra-rack unicast verbatim.

    Each message combines r-1 components — one per fellow group member —
    and every receiver maps all other members' missing batches (side
    information), so :func:`execute_plan`'s strict decodability assertions
    prove the schedule, and its counts reproduce
    :func:`repro_torch.core.costs.hybrid_resolvable_cost` (asserted in tests).
    """
    from .resolvable import needed_batch, spc_codewords

    p = assignment.params
    p.validate_hybrid_resolvable()
    q, r = p.spc_q, p.r
    q_per_rack = p.Q // p.P
    cw = spc_codewords(q, r)
    codeword_set = {tuple(c) for c in cw.tolist()}

    slot_of = assignment.meta["slot_of_subfile"]
    # (layer, batch) -> subfiles in w order
    by_layer_batch: Dict[Tuple[int, int], List[Tuple[int, int]]] = {}
    for subfile, (layer, t_idx, w) in enumerate(slot_of):  # type: ignore[arg-type]
        by_layer_batch.setdefault((layer, t_idx), []).append((w, subfile))
    batch_files = {k: [sub for _, sub in sorted(v)]
                   for k, v in by_layer_batch.items()}

    # ---- Stage 1: cross-rack coded multicasts, independently per layer ----
    from .resolvable import batch_index
    for layer in range(p.n_layers):
        for g in itertools.product(range(q), repeat=r):
            if g in codeword_set:
                continue
            for a_cls in range(r):
                a_rack = a_cls * q + g[a_cls]
                sender = p.server_id(a_rack, layer)
                others = [t for t in range(r) if t != a_cls]
                for w in range(p.M_res // (r - 1)):
                    for u in range(q_per_rack):
                        comps = []
                        for t_cls in others:
                            b_t = needed_batch(g, t_cls, q)
                            t_idx = int(batch_index(b_t, q))
                            z_rack = t_cls * q + g[t_cls]
                            pos = a_cls if a_cls < t_cls else a_cls - 1
                            files = batch_files[(layer, t_idx)]
                            sub = _chunk(files, pos, r - 1)[w]
                            key = list(p.keys_of_rack(z_rack))[u]
                            comps.append((p.server_id(z_rack, layer), key,
                                          sub))
                        yield Message(sender, tuple(comps), "cross")

    # ---- Stage 2: intra-rack unicast (identical to the binomial family) ---
    per_layer = p.subfiles_per_layer
    layer_files: Dict[int, List[int]] = {la: [] for la in range(p.n_layers)}
    for subfile, (layer, t_idx, w) in enumerate(slot_of):  # type: ignore[arg-type]
        layer_files[layer].append(subfile)
    for layer in range(p.n_layers):
        assert len(layer_files[layer]) == per_layer
        for rack in range(p.P):
            sender = p.server_id(rack, layer)
            for subfile in layer_files[layer]:
                for key in p.keys_of_rack(rack):
                    reducer = p.server_of_key(key)
                    if reducer != sender:
                        yield Message(sender, ((reducer, key, subfile),),
                                      "intra")


def make_plan(assignment: Assignment) -> Iterator[Message]:
    return {"uncoded": uncoded_plan,
            "coded": coded_plan,
            "hybrid": hybrid_plan,
            "hybrid_resolvable": resolvable_hybrid_plan}[
        assignment.scheme](assignment)


# ---------------------------------------------------------------------------
# Bit-exact execution: proves every schedule is decodable & complete
# ---------------------------------------------------------------------------

def execute_plan(assignment: Assignment,
                 values: np.ndarray,
                 plan: Iterable[Message] | None = None,
                 strict: bool = True) -> List[Dict[Tuple[int, int], int]]:
    """Simulate the shuffle on integer map outputs ``values[subfile, key]``.

    Each server starts knowing values for the subfiles it mapped (all Q keys).
    Coded messages carry the SUM of their component values; a receiver must
    already know every component except its own (asserted when ``strict``)
    and decodes by subtraction.  Returns per-server knowledge dicts; callers
    assert reduce-readiness via :func:`check_reduce_ready`.
    """
    p = assignment.params
    know: List[Dict[Tuple[int, int], int]] = [dict() for _ in range(p.K)]
    for subfile, servers in enumerate(assignment.servers_of_subfile):
        for s in servers:
            for key in range(p.Q):
                know[s][(key, subfile)] = int(values[subfile, key])

    if plan is None:
        plan = make_plan(assignment)
    for m in plan:
        payload = sum(int(values[sub, key]) for (_, key, sub) in m.components)
        if strict:
            for (_, key, sub) in m.components:
                assert (key, sub) in know[m.sender], (
                    f"sender {m.sender} does not know {(key, sub)}")
        for (rcv, key, sub) in m.components:
            side = 0
            for (rcv2, key2, sub2) in m.components:
                if (rcv2, key2, sub2) != (rcv, key, sub):
                    if strict:
                        assert (key2, sub2) in know[rcv], (
                            f"receiver {rcv} lacks side info {(key2, sub2)}")
                    side += know[rcv].get((key2, sub2), int(values[sub2, key2]))
            know[rcv][(key, sub)] = payload - side
    return know


# ---------------------------------------------------------------------------
# Stage traffic export (consumed by the repro.sim network model)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class StageTraffic:
    """Aggregate link loads of one sequential shuffle stage, in pairs.

    ``cross_pairs`` counts root-switch traversals (a multicast counted ONCE,
    the paper metric); ``intra_pairs_per_rack[q]`` counts pairs through rack
    q's ToR switch.  A scheme's shuffle is a SEQUENCE of stages: the hybrid
    scheme is literally sequential (cross coded stage, then intra unicast);
    for uncoded/coded the single mixed stage is split into its cross and
    intra components, matching the serialization assumed by
    :meth:`repro_torch.core.costs.CommCost.weighted_time`.
    """
    stage: str                              # 'cross' | 'intra'
    cross_pairs: float
    intra_pairs_per_rack: Tuple[float, ...]

    @property
    def intra_pairs(self) -> float:
        return float(sum(self.intra_pairs_per_rack))


def _as_stages(cross: float, intra_per_rack: np.ndarray) -> List[StageTraffic]:
    stages = []
    if cross > 0:
        stages.append(StageTraffic("cross", float(cross),
                                   tuple(0.0 for _ in intra_per_rack)))
    if intra_per_rack.sum() > 0:
        stages.append(StageTraffic("intra", 0.0,
                                   tuple(float(x) for x in intra_per_rack)))
    return stages


def plan_stage_traffic(assignment: Assignment) -> List[StageTraffic]:
    """Enumerate the scheme's explicit schedule into per-stage link loads.

    Exact per-rack attribution: an intra message loads its sender's ToR;
    a cross message loads the root once (multicast counted once).  Totals
    are proven equal to the closed forms in tests.
    """
    p = assignment.params
    cross = 0.0
    intra = np.zeros(p.P)
    for m in make_plan(assignment):
        if m.is_cross(p):
            cross += 1.0
        else:
            intra[p.rack_of(m.sender)] += 1.0
    return _as_stages(cross, intra)


def scheme_stage_traffic(p: SchemeParams, scheme: str,
                         check: bool = True) -> List[StageTraffic]:
    """Closed-form stage traffic (Props 1-2 / Thm III.1, balanced per-rack
    split — all three designs are rack-symmetric).  O(1); use this for large
    N where enumerating the schedule is too slow."""
    from .costs import (coded_cost, hybrid_cost, hybrid_resolvable_cost,
                        uncoded_cost)
    cost_fn = {"uncoded": uncoded_cost, "coded": coded_cost,
               "hybrid": hybrid_cost,
               "hybrid_resolvable": hybrid_resolvable_cost}[scheme]
    c = cost_fn(p, check=check)
    return _as_stages(c.cross, np.full(p.P, c.intra / p.P))


def check_reduce_ready(assignment: Assignment,
                       know: List[Dict[Tuple[int, int], int]],
                       values: np.ndarray) -> None:
    """Every server must hold the correct value of each of its reduce keys on
    every subfile."""
    p = assignment.params
    for server in range(p.K):
        for key in p.keys_of_server(server):
            for subfile in range(p.N):
                got = know[server].get((key, subfile))
                assert got is not None, (server, key, subfile)
                assert got == int(values[subfile, key]), (server, key, subfile)
