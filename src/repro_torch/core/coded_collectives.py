"""The Hybrid Coded MapReduce shuffle in PyTorch: plan compilation, its
NumPy oracles, and the two-stage shuffle, for all K servers at once on one
device or for one server per process.  Counterpart of
``repro/core/coded_collectives.py``.

Plan half (NumPy only, identical tables to the JAX package's compiler —
pinned by the sha256 goldens in ``tests/golden_plans.json``): the binomial
compiler, the LRU plan cache with per-family counters, and
:func:`reduce_ready_order`, :func:`reduce_output_keys`,
:func:`pack_local_values`, :func:`plan_transfer_matrices`,
:func:`plan_shuffle_reference` and :func:`simulate_plan_shuffle` — the
port's own oracles on the card.

Shuffle half (stacked form): the K = P * Kr servers of the ('rack',
'server') grid are the leading ``[P, Kr]`` axes of one tensor.  A tiled
all_to_all over 'rack' becomes a transpose ``blocks[src_rack, j, dst_rack]
-> recvd[dst_rack, j, src_rack]``, and the one over 'server' the same
transpose of the two Kr axes.  Every per-server gather and scatter of the
JAX device body folds the server index into the row index, so one
``index_select`` or ``index_add_`` serves all K servers; the row indices
are precomputed per (plan, device) in :class:`DevicePlanTables`.

Shuffle half (process form, the JAX per-device program): on a
:class:`~repro_torch.distributed.meshes.ProcessMesh` each server is one
rank and holds only its own [n_loc, Q, d] values; :func:`shuffle_rank_body`
runs stage 1 as one ``all_to_all_single`` over the 'rack' group and stage 2
as one over the 'server' group, on :func:`rank_plan_tables` — the server's
own slice of the stacked tables.  Both forms share one body and agree bit
for bit.

Data model: intermediate values form V[N, Q, d] (subfile, key, payload);
the reducer of key q needs q's value on ALL N subfiles.
"""
from __future__ import annotations

import dataclasses
import functools
from math import comb
from typing import Dict, Mapping, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..distributed.collectives import all_to_all
from ..distributed.meshes import ProcessMesh
from .assignment import hybrid_assignment, rack_subsets
from .params import SchemeParams
from .plan_registry import (HybridShufflePlan, get_plan_compiler,
                            plan_families, register_plan_compiler)


# ---------------------------------------------------------------------------
# Plan compilation: static index tables for the general-r hybrid shuffle
# ---------------------------------------------------------------------------


@register_plan_compiler("binomial")
def _compile_hybrid_plan_impl(p: SchemeParams,
                              perm: Tuple[int, ...] | None = None
                              ) -> HybridShufflePlan:
    """Uncached binomial plan compilation for any r in [1, P] with r | M.

    All tables are built by vectorized index arithmetic on the structural
    (layer, subset, w) coordinates; cost is O(N + P^2 * C(P, r)).

    ``perm`` places subfile ``perm[slot]`` into each structural slot (the
    Section-IV locality degree of freedom); every positional table is
    perm-independent — only the subfile-id tables (``local_subfiles``,
    ``layer_subfiles``) change.
    """
    p.validate_hybrid()
    r = p.r
    M = p.M
    if M % r != 0:
        raise ValueError(f"executable hybrid plan needs r | M; M={M} r={r}")
    a = hybrid_assignment(p, perm=list(perm) if perm is not None else None)
    subsets = np.asarray(rack_subsets(p.P, r), dtype=np.int64)   # [n_sub, r]
    n_sub = subsets.shape[0]
    slot = np.asarray(a.meta["slot_of_subfile"], dtype=np.int64)  # [N, 3]

    share = M // r                         # rows each replica sources
    n_layer = p.subfiles_per_layer
    c_loc = comb(p.P - 1, r - 1)           # subsets containing a given rack
    c_pair = comb(p.P - 2, r - 1) if p.P >= 2 else 0   # i in T, z not in T
    n_loc = c_loc * M
    n_send = c_pair * share

    # subfile id of each structural slot: S[layer, subset, w]
    S = np.empty((p.Kr, n_sub, M), dtype=np.int64)
    S[slot[:, 0], slot[:, 1], slot[:, 2]] = np.arange(p.N)

    # rack-membership tables over subsets
    t_ids = np.repeat(np.arange(n_sub), r)
    member = np.zeros((p.P, n_sub), dtype=bool)
    member[subsets.ravel(), t_ids] = True              # member[i, t]: i in T_t
    pos_in = np.zeros((p.P, n_sub), dtype=np.int64)
    pos_in[subsets.ravel(), t_ids] = np.tile(np.arange(r), n_sub)

    # subsets containing each rack (ascending) and each subset's rank therein
    ts = np.nonzero(member)[1].reshape(p.P, c_loc)     # [P, c_loc]
    rank = np.zeros((p.P, n_sub), dtype=np.int64)
    rank[np.arange(p.P)[:, None], ts] = np.arange(c_loc)[None, :]

    # layer table is rack-independent; local tables are layer-independent:
    # store broadcast views to keep the [P, Kr, ...] interface without copies
    layer_table = np.broadcast_to(S.reshape(1, p.Kr, n_layer),
                                  (p.P, p.Kr, n_layer))
    local_subfiles = np.ascontiguousarray(
        S[:, ts, :].transpose(1, 0, 2, 3).reshape(p.P, p.Kr, n_loc))
    local_mask = np.broadcast_to(
        np.repeat(member, M, axis=1)[:, None, :], (p.P, p.Kr, n_layer))
    local_pos = np.broadcast_to(
        (ts[:, :, None] * M + np.arange(M)).reshape(p.P, 1, n_loc),
        (p.P, p.Kr, n_loc))

    cross_send_pos = np.zeros((p.P, p.Kr, p.P, n_send), dtype=np.int64)
    cross_recv_pos = np.zeros((p.P, p.Kr, p.P, n_send), dtype=np.int64)
    n_known = max(r - 1, 0)
    mcast_comp_pos = np.zeros((p.P, p.P, n_send, r), dtype=np.int64)
    mcast_comp_rack = np.zeros((p.P, p.P, n_send, r), dtype=np.int64)
    mcast_known_pos = np.zeros((p.P, p.P, n_send, n_known), dtype=np.int64)
    mcast_known_rack = np.zeros((p.P, p.P, n_send, n_known), dtype=np.int64)
    if n_send:
        subset_index = {tuple(T): t for t, T in enumerate(subsets.tolist())}
        off = np.arange(share)
        for i in range(p.P):
            for z in range(p.P):
                if z == i:
                    continue
                # i's share of every subset it maps that z does not
                t_snd = np.nonzero(member[i] & ~member[z])[0]    # [c_pair]
                cross_send_pos[i, :, z, :] = (
                    rank[i, t_snd, None] * M
                    + pos_in[i, t_snd, None] * share + off).reshape(-1)
                # where z's share of the subsets i lacks lands in the table
                t_rcv = np.nonzero(member[z] & ~member[i])[0]
                cross_recv_pos[i, :, z, :] = (
                    t_rcv[:, None] * M
                    + pos_in[z, t_rcv, None] * share + off).reshape(-1)
                # Packet block a of the i -> z stream realizes the multicast
                # group S = T ∪ {z} (T = t_snd[a]): component c serves
                # receiver z2 in S \ {i} with i's share of T_{z2} = S \ {z2}.
                for a, t in enumerate(t_snd):
                    S = tuple(sorted(subsets[t].tolist() + [z]))
                    rows = slice(a * share, (a + 1) * share)
                    for c, z2 in enumerate(x for x in S if x != i):
                        t2 = subset_index[tuple(x for x in S if x != z2)]
                        mcast_comp_pos[i, z, rows, c] = (
                            rank[i, t2] * M + pos_in[i, t2] * share + off)
                        mcast_comp_rack[i, z, rows, c] = z2
                # Receiver i decoding source s = z's stream: packet block a
                # covers T = t_rcv[a] (∋ s, ∌ i), group S = T ∪ {i}; the
                # known components are s's shares of T_{z2}, z2 in S\{s, i} —
                # all mapped locally at i since i ∈ T_{z2}.
                for a, t in enumerate(t_rcv):
                    S = tuple(sorted(subsets[t].tolist() + [i]))
                    rows = slice(a * share, (a + 1) * share)
                    for c, z2 in enumerate(x for x in S if x not in (z, i)):
                        t2 = subset_index[tuple(x for x in S if x != z2)]
                        mcast_known_pos[i, z, rows, c] = (
                            rank[i, t2] * M + pos_in[z, t2] * share + off)
                        mcast_known_rack[i, z, rows, c] = z2
    return HybridShufflePlan(p, local_subfiles, cross_send_pos, layer_table,
                             cross_recv_pos, local_mask, n_send, local_pos,
                             mcast_comp_pos, mcast_comp_rack,
                             mcast_known_pos, mcast_known_rack)


def plan_from_numpy(fields: Mapping[str, object]) -> HybridShufflePlan:
    """Rebuild a :class:`HybridShufflePlan` from another compiler's tables.

    ``fields`` maps each plan field name to its value: the index tables as
    NumPy arrays (e.g. the JAX package's plan, field by field), ``n_send``,
    optionally ``family`` and ``cross_valid``, and ``params`` as a
    :class:`SchemeParams` or a mapping of its fields (K, P, Q, N, r, r_f).
    Lets a test run the port's shuffle on exactly another compiler's tables.
    """
    f = dict(fields)
    params = f.pop("params")
    if not isinstance(params, SchemeParams):
        params = SchemeParams(**dict(params))
    tables = {name: np.asarray(f.pop(name), dtype=np.int64) for name in (
        "local_subfiles", "cross_send_pos", "layer_subfiles",
        "cross_recv_pos", "local_pos", "mcast_comp_pos", "mcast_comp_rack",
        "mcast_known_pos", "mcast_known_rack")}
    cv = f.pop("cross_valid", None)
    plan = HybridShufflePlan(
        params, local_mask=np.asarray(f.pop("local_mask"), dtype=bool),
        n_send=int(f.pop("n_send")), family=str(f.pop("family", "binomial")),
        cross_valid=None if cv is None else np.asarray(cv, dtype=bool),
        **tables)
    if f:
        raise ValueError(f"unknown plan fields: {sorted(f)}")
    return plan


# ---------------------------------------------------------------------------
# Plan cache: LRU with per-family introspection
# ---------------------------------------------------------------------------
#
# Entries are keyed on (params, perm, family) — two families of the same
# (params, perm) are distinct plans — and hit/miss counters are kept per
# family.


class FamilyCacheInfo(NamedTuple):
    hits: int
    misses: int


class PlanCacheInfo(NamedTuple):
    """CacheInfo of the plan cache, extended with per-family counters
    (``families`` maps family name -> :class:`FamilyCacheInfo`; families
    never compiled are absent)."""
    hits: int
    misses: int
    maxsize: int | None
    currsize: int
    families: Dict[str, FamilyCacheInfo]


@functools.lru_cache(maxsize=128)
def _cached_plan(p: SchemeParams, perm: Tuple[int, ...] | None,
                family: str) -> HybridShufflePlan:
    """The cached unit: registry dispatch on the full (params, perm, family)
    key."""
    return get_plan_compiler(family)(p, perm)


_FAMILY_STATS: Dict[str, list] = {}   # family -> [hits, misses]


def compile_hybrid_plan(p: SchemeParams,
                        perm: Sequence[int] | None = None,
                        family: str = "binomial") -> HybridShufflePlan:
    """LRU-cached plan compilation; repeated calls for a seen
    (:class:`SchemeParams`, perm, family) return the SAME plan object.
    ``perm`` is the Section-IV slot permutation of a locality-optimized
    placement (None is the canonical identity layout); ``family`` selects
    the registered plan compiler: ``'binomial'`` (the paper's Sec. III
    construction) or ``'resolvable'`` (:mod:`repro_torch.core.resolvable`).
    """
    key_perm = None if perm is None else tuple(int(x) for x in perm)
    before = _cached_plan.cache_info().misses
    plan = _cached_plan(p, key_perm, family)
    missed = _cached_plan.cache_info().misses > before
    st = _FAMILY_STATS.setdefault(family, [0, 0])
    st[1 if missed else 0] += 1
    return plan


def plan_cache_info() -> PlanCacheInfo:
    """:class:`PlanCacheInfo` of the plan cache."""
    info = _cached_plan.cache_info()
    fams = {f: FamilyCacheInfo(h, m) for f, (h, m) in
            sorted(_FAMILY_STATS.items())}
    return PlanCacheInfo(info.hits, info.misses, info.maxsize, info.currsize,
                         fams)


def plan_cache_clear() -> None:
    """Drop all cached plans AND their device tables (which key on plan
    identity and would otherwise keep evicted plans alive); zero the
    per-family counters."""
    _cached_plan.cache_clear()
    _FAMILY_STATS.clear()
    device_plan_tables.cache_clear()
    rank_plan_tables.cache_clear()


def compile_hybrid_plan_r2(p: SchemeParams) -> HybridShufflePlan:
    """Back-compat alias: the r = 2 instance of :func:`compile_hybrid_plan`
    (rejects other r, as the pre-general-r API did)."""
    if p.r != 2:
        raise ValueError("compile_hybrid_plan_r2 is the r = 2 special case; "
                         "use compile_hybrid_plan for general r")
    return compile_hybrid_plan(p)


# ---------------------------------------------------------------------------
# Execution: all K servers stacked on one device, or one server a process
# ---------------------------------------------------------------------------

MULTICAST_MODES = ("unicast", "coded", "coded_xor")
# "torch" = plain tensor ops (the JAX package's "xla"); "kernel" = the
# hand-written Hopper kernels of repro_torch.kernels.coded_combine (its
# "pallas")
COMBINE_IMPLS = ("torch", "kernel")


@dataclasses.dataclass(frozen=True, eq=False)
class DevicePlanTables:
    """A plan's index tables as int64 row indices on one device, laid out
    for the stacked body.

    Source rows index the mapped values viewed as ``[K * n_loc * P,
    q_rack, d]`` (server s, local row n, key block b -> row ``(s * n_loc +
    n) * P + b``); destination rows index the stacked layer tables
    ``[K * n_layer, q_rack, d]`` (row ``s * n_layer + l``).  Stage-1 slots
    are ordered (rack, layer j, other rack, slot m): the sender's view for
    ``send_src``/``comp_src``, the receiver's for ``known_src``,
    ``recv_dst`` and ``recv_valid``.  :func:`rank_plan_tables` gives one
    server's fields in the same layout with K = 1."""
    local_src: torch.Tensor     # [K * n_loc]
    local_dst: torch.Tensor     # [K * n_loc]
    send_src: torch.Tensor      # [K * P * n_send]
    comp_src: torch.Tensor      # [arity, K * P * n_send]
    known_src: torch.Tensor     # [arity - 1, K * P * n_send]
    recv_dst: torch.Tensor      # [K * P * n_send]
    recv_valid: torch.Tensor    # [K * P * n_send] bool


def _stacked_tables(plan: HybridShufflePlan) -> Dict[str, np.ndarray]:
    """The host-side (NumPy) construction of :class:`DevicePlanTables`."""
    p = plan.params
    P, Kr = p.P, p.Kr
    n_loc = plan.local_subfiles.shape[-1]
    n_layer = p.subfiles_per_layer
    srv = np.arange(p.K).reshape(P, Kr)                 # s = i * Kr + j
    rack = np.arange(P)

    def rows(server, pos, block):
        return (server * n_loc + pos) * P + block

    local_src = rows(srv[:, :, None], np.arange(n_loc), rack[:, None, None])
    local_dst = srv[:, :, None] * n_layer + plan.local_pos
    # [i, j, z, m]: server (i, j)'s slot m toward / from rack z
    s4 = srv[:, :, None, None]
    send_src = rows(s4, plan.cross_send_pos, rack[None, None, :, None])
    recv_dst = s4 * n_layer + plan.cross_recv_pos

    def coded(pos, blk):                 # [P, P, n_send, c] -> [c, i,j,z,m]
        pos = pos.transpose(3, 0, 1, 2)[:, :, None]
        blk = blk.transpose(3, 0, 1, 2)[:, :, None]
        return rows(srv[None, :, :, None, None], pos, blk)

    comp_src = coded(plan.mcast_comp_pos, plan.mcast_comp_rack)
    known_src = coded(plan.mcast_known_pos, plan.mcast_known_rack)
    shape = (P, Kr, P, plan.n_send)
    cv = plan.cross_valid
    if cv is None:
        # binomial: every slot from a distinct source rack is real
        valid = np.broadcast_to(rack[:, None, None, None]
                                != rack[None, None, :, None], shape)
    elif cv.ndim == 4:
        # degraded plans: per-LAYER validity [P, Kr, P, n_send], already
        # the receiver's (i, j, z, m) view (repair streams differ by which
        # servers of the layer died)
        valid = np.asarray(cv)
    else:
        # families with padded streams (resolvable): per-slot mask
        valid = np.broadcast_to(np.asarray(cv)[:, None], shape)
    n_slots = p.K * P * plan.n_send
    return {"local_src": local_src.reshape(-1),
            "local_dst": local_dst.reshape(-1),
            "send_src": send_src.reshape(-1),
            "comp_src": comp_src.reshape(comp_src.shape[0], n_slots),
            "known_src": known_src.reshape(known_src.shape[0], n_slots),
            "recv_dst": recv_dst.reshape(-1),
            "recv_valid": valid.reshape(-1)}


def upload_plan_tables(plan: HybridShufflePlan,
                       device: torch.device) -> DevicePlanTables:
    """:class:`DevicePlanTables` of ``plan`` uploaded to ``device``,
    uncached: the caller owns them (a degraded plan holds its own, so they
    die with its entry in the degraded-plan side cache)."""
    t = _stacked_tables(plan)
    return DevicePlanTables(**{
        k: torch.as_tensor(np.array(v), device=device)
        for k, v in t.items()})


@functools.lru_cache(maxsize=128)
def device_plan_tables(plan: HybridShufflePlan,
                       device: torch.device) -> DevicePlanTables:
    """:class:`DevicePlanTables` of ``plan`` uploaded to ``device`` once and
    cached per (plan, device) (plans hash by identity, and
    :func:`compile_hybrid_plan` returns the same object per config, so a
    repeated shuffle never re-uploads its tables)."""
    return upload_plan_tables(plan, device)


@functools.lru_cache(maxsize=128)
def rank_plan_tables(plan: HybridShufflePlan, rank: int,
                     device: torch.device) -> DevicePlanTables:
    """Server ``rank``'s slice of :class:`DevicePlanTables` on ``device``,
    cached per (plan, rank, device): the stacked tables are ordered with
    the server leading, so a server's slots are one contiguous run; its
    source rows are rebased by ``rank * n_loc * P`` and its destination
    rows by ``rank * n_layer``, to index its own values and layer table."""
    p = plan.params
    src0 = rank * plan.local_subfiles.shape[-1] * p.P
    dst0 = rank * p.subfiles_per_layer
    t = _stacked_tables(plan)

    def mine(name: str, offset: int) -> torch.Tensor:
        a = t[name]
        a = a.reshape(*a.shape[:-1], p.K, a.shape[-1] // p.K)[..., rank, :]
        return torch.as_tensor(np.array(a - offset if offset else a),
                               device=device)
    return DevicePlanTables(
        **{k: mine(k, src0) for k in ("local_src", "send_src", "comp_src",
                                      "known_src")},
        local_dst=mine("local_dst", dst0), recv_dst=mine("recv_dst", dst0),
        recv_valid=mine("recv_valid", 0))


def _combine(streams: torch.Tensor, multicast: str,
             combine_impl: str) -> torch.Tensor:
    """Encode the [arity, ...] component streams into one packet stream —
    the paper's f(.) (eq. (1), unit coefficients) or its GF(2) variant."""
    if combine_impl == "kernel":
        from ..kernels.coded_combine import ops as cc_ops
        if multicast == "coded_xor":
            return cc_ops.xor_encode(streams)
        return cc_ops.coded_encode(
            streams, torch.ones(streams.shape[0], device=streams.device))
    if multicast == "coded_xor":
        return functools.reduce(torch.bitwise_xor, streams.unbind(0))
    return functools.reduce(torch.add, [s.float() for s in streams.unbind(0)]
                            ).to(streams.dtype)


def _uncombine(f: torch.Tensor, known: torch.Tensor, multicast: str,
               combine_impl: str) -> torch.Tensor:
    """Recover the missing component of packet stream ``f`` from the
    [arity-1, ...] known components (receiver side information).  The
    "torch" path subtracts the SUM of the known streams (the JAX "xla"
    order); the kernel subtracts them one by one, then divides (the Pallas
    kernel's order).  They agree bit for bit on integer-valued payloads."""
    if known.shape[0] == 0:
        return f
    if combine_impl == "kernel":
        from ..kernels.coded_combine import ops as cc_ops
        if multicast == "coded_xor":
            return cc_ops.xor_decode(f, known)
        return cc_ops.coded_decode(
            f, known, torch.ones(known.shape[0] + 1, device=f.device))
    if multicast == "coded_xor":
        return functools.reduce(torch.bitwise_xor, known.unbind(0), f)
    acc = functools.reduce(torch.add, [k.float() for k in known.unbind(0)])
    return (f.float() - acc).to(f.dtype)


def shuffle_device_body(vals: torch.Tensor, plan: HybridShufflePlan,
                        tables: DevicePlanTables,
                        multicast: str = "unicast",
                        combine_impl: str = "torch",
                        patch: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """The two-stage hybrid shuffle for all K servers at once, general r.

    ``vals`` is [K, n_loc, Q, d] (or [P, Kr, n_loc, Q, d]): server (i, j)'s
    mapped values at row i * Kr + j, ordered as ``plan.local_subfiles[i,
    j]``.  Returns [K, N, q_srv, d]: per server, its q_srv reduce keys on
    all N subfiles, rows ordered as :func:`reduce_ready_order`.  Shared by
    :func:`hybrid_shuffle` and the fused pipeline of
    :mod:`repro_torch.mapreduce.engine`.

    ``multicast='coded'`` replaces raw stage-1 rows with the paper's coded
    multicast packets f(v_1..v_arity) (unit coefficients), decoded at
    receivers from replicated-map side information; ``'coded_xor'`` is the
    GF(2) variant (integer payloads, bit-exact; float payloads raise).  The
    packet arity is the plan's ``mcast_arity`` (r binomial, r - 1
    resolvable); single-component streams degenerate to unicast.
    ``combine_impl`` selects the encode/decode: ``'torch'`` (plain tensor
    ops, the counterpart of the JAX ``'xla'``) or ``'kernel'`` (the CUDA
    kernels of :mod:`repro_torch.kernels.coded_combine`, the counterpart of
    ``'pallas'``; on a CPU tensor they run their plain versions).

    ``patch`` is a [K, n_layer, q_rack, d] additive stage-1 table
    correction of ``vals``'s dtype — the degraded-recovery path of
    :mod:`repro_torch.mapreduce.recovery` injects re-mapped orphan rows
    through it (those rows receive nothing and their local fill is zero,
    so add == set).  ``None`` costs nothing.
    """
    return _shuffle_body(vals, plan, tables, None, multicast, combine_impl,
                         patch)


def shuffle_rank_body(vals: torch.Tensor, plan: HybridShufflePlan,
                      tables: DevicePlanTables, mesh: ProcessMesh,
                      multicast: str = "unicast",
                      combine_impl: str = "torch",
                      patch: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One server's part of the two-stage hybrid shuffle on a
    :class:`ProcessMesh` (the JAX package's ``shuffle_device_body``).

    ``vals`` is THIS rank's [n_loc, Q, d] mapped values, ordered as
    ``plan.local_subfiles[i, j]``; ``tables`` are its
    :func:`rank_plan_tables`.  Stage 1 is one all_to_all over the mesh's
    'rack' group, stage 2 one over its 'server' group.  Returns the rank's
    [N, q_srv, d] reduce rows (order = :func:`reduce_ready_order`).
    ``multicast``, ``combine_impl`` and ``patch`` (this rank's [n_layer,
    q_rack, d]) as in :func:`shuffle_device_body`; on a CUDA tensor with
    ``combine_impl='kernel'`` every rank launches the combine kernels.
    """
    return _shuffle_body(vals, plan, tables, mesh, multicast, combine_impl,
                         patch)


def _shuffle_body(vals: torch.Tensor, plan: HybridShufflePlan,
                  tables: DevicePlanTables, mesh: Optional[ProcessMesh],
                  multicast: str, combine_impl: str,
                  patch: Optional[torch.Tensor]) -> torch.Tensor:
    """The body of both forms: all K servers stacked (``mesh`` None, each
    exchange a transpose) or this rank's server (each exchange an
    all_to_all over the mesh's group)."""
    if multicast not in MULTICAST_MODES:
        raise ValueError(f"multicast must be one of {MULTICAST_MODES}")
    if combine_impl not in COMBINE_IMPLS:
        raise ValueError(f"combine_impl must be one of {COMBINE_IMPLS}")
    p = plan.params
    P, Kr = p.P, p.Kr
    q_rack, q_srv = p.Q // p.P, p.Q // p.K
    n_layer = p.subfiles_per_layer
    n_srv = p.K if mesh is None else 1
    d = vals.shape[-1]
    n_send = plan.n_send
    arity = plan.mcast_arity
    coded = multicast != "unicast" and arity >= 2

    rows = vals.reshape(-1, q_rack, d)       # [n_srv * n_loc * P, q_rack, d]

    # ---- Stage 1: cross-rack exchange --------------------------------------
    table = vals.new_zeros((n_srv * n_layer, q_rack, d))
    table.index_copy_(0, tables.local_dst,
                      rows.index_select(0, tables.local_src))   # local rows
    if n_send > 0:
        if coded:
            # encode: the arity components of every packet, arity axis
            # first, then f(.) over that axis
            comps = rows.index_select(0, tables.comp_src.reshape(-1))
            blocks = _combine(comps.view(arity, -1, q_rack, d), multicast,
                              combine_impl)
        else:
            blocks = rows.index_select(0, tables.send_src)
        if mesh is None:
            # all_to_all over 'rack': blocks[src, j, dst] -> recvd[dst, j,
            # src]
            recvd = blocks.view(P, Kr, P, n_send, q_rack, d).transpose(0, 2)
            recvd = recvd.reshape(-1, q_rack, d)
        else:
            # blocks by destination rack -> received blocks by source rack
            recvd = all_to_all(blocks, mesh, "rack")
        if coded:
            # decode: subtract the arity-1 known components (rows this
            # server mapped itself — the replicated-map side information)
            known = rows.index_select(0, tables.known_src.reshape(-1))
            recvd = _uncombine(recvd, known.view(arity - 1, -1, q_rack, d),
                               multicast, combine_impl)
        # invalid slots (own rack; padding) all point at row 0: zero them
        # and ACCUMULATE, so the repeated index adds zeros instead of
        # racing to overwrite row 0
        recvd = torch.where(tables.recv_valid[:, None, None], recvd, 0)
        table.index_add_(0, tables.recv_dst, recvd)
    if patch is not None:
        table += patch.reshape(n_srv * n_layer, q_rack, d)

    # ---- Stage 2: intra-rack exchange --------------------------------------
    if mesh is None:
        # table[i, j_src, l, j_dst, :] -> out[i, j_dst, j_src, l, :]
        out = table.view(P, Kr, n_layer, Kr, q_srv, d).permute(
            0, 3, 1, 2, 4, 5)
        return out.reshape(p.K, Kr * n_layer, q_srv, d)
    # table[l, j_dst, :] goes to server j_dst; received by source server
    per_srv = table.view(n_layer, Kr, q_srv, d).transpose(0, 1)
    out = all_to_all(per_srv, mesh, "server")   # [Kr, n_layer, q_srv, d]
    return out.reshape(Kr * n_layer, q_srv, d)


def hybrid_shuffle(values_local, plan: HybridShufflePlan, mesh,
                   multicast: str = "unicast",
                   combine_impl: str = "torch") -> torch.Tensor:
    """Two-stage hybrid shuffle, general r, on ``mesh.device``.

    On a stacked mesh — values_local: [K, n_loc, Q, d] (tensor or array);
      row (i*Kr + j) = server (i, j)'s mapped subfile values, ordered as
      ``plan.local_subfiles[i, j]``.  Returns [K, N, q_srv, d]: per server,
      values of ALL N subfiles for its own q_srv reduce keys, rows ordered
      as :func:`reduce_ready_order`.
    On a :class:`ProcessMesh` — values_local: THIS rank's [n_loc, Q, d];
      returns THIS rank's [N, q_srv, d] (every rank must call it).

    ``multicast`` / ``combine_impl`` select the stage-1 wire format and the
    f(.) implementation — see :func:`shuffle_device_body`.
    """
    vals = torch.as_tensor(values_local, device=mesh.device)
    if isinstance(mesh, ProcessMesh):
        n_loc = plan.local_subfiles.shape[-1]
        if vals.shape[0] != n_loc:
            raise ValueError(f"values_local has {vals.shape[0]} rows; this "
                             f"server maps n_loc={n_loc}")
        tables = rank_plan_tables(plan, mesh.rank, mesh.device)
        return shuffle_rank_body(vals, plan, tables, mesh, multicast,
                                 combine_impl)
    if vals.shape[0] != plan.params.K:
        raise ValueError(f"values_local has {vals.shape[0]} server rows; "
                         f"the plan has K={plan.params.K}")
    tables = device_plan_tables(plan, mesh.device)
    return shuffle_device_body(vals, plan, tables, multicast, combine_impl)


def hybrid_shuffle_r2(values_local, plan: HybridShufflePlan,
                      mesh) -> torch.Tensor:
    """Back-compat alias for :func:`hybrid_shuffle` (r = 2 plans and any
    other compiled plan run through the identical program)."""
    return hybrid_shuffle(values_local, plan, mesh)


# ---------------------------------------------------------------------------
# NumPy layout helpers and oracles
# ---------------------------------------------------------------------------

def reduce_ready_order(plan: HybridShufflePlan) -> np.ndarray:
    """Global subfile id of each output row of :func:`hybrid_shuffle`,
    per server: [P, Kr, N] (layer-major, canonical layer-table order)."""
    p = plan.params
    flat = np.asarray(plan.layer_subfiles).reshape(p.P, p.N)
    return np.broadcast_to(flat[:, None, :], (p.P, p.Kr, p.N))


def reduce_output_keys(plan: HybridShufflePlan) -> np.ndarray:
    """Global key id of each reduce row produced by server s: [K, Q/K].

    Output assembly must place server s's row q at global key
    ``reduce_output_keys(plan)[s, q]`` — derived from the key partition
    explicitly rather than assuming the flat [K * Q/K] order IS key order."""
    p = plan.params
    return np.asarray([list(p.keys_of_server(s)) for s in range(p.K)],
                      dtype=np.int64)


def pack_local_values(values: np.ndarray,
                      plan: HybridShufflePlan) -> np.ndarray:
    """Distribute dense V[N, Q, d] into the per-server layout expected by
    :func:`hybrid_shuffle`: [K, n_loc, Q, d]."""
    p = plan.params
    return values[plan.local_subfiles.reshape(p.K, -1)]


def plan_transfer_matrices(plan: HybridShufflePlan,
                           multicast: str = "coded") -> Dict[str, np.ndarray]:
    """Per-round transfer matrices of the EXECUTABLE hybrid shuffle, in
    <key, value> pairs (all layers summed).

      * ``cross_rack_matrix`` [P, P]: stage-1 pairs the root switch carries
        from rack i to rack z.  ``'unicast'`` counts each destination
        stream as a separate copy; ``'coded'`` / ``'coded_xor'`` count the
        paper metric — each coded packet serves ``mcast_arity`` racks and
        traverses the root ONCE, so the total is the family's closed-form
        cross cost.  Families with padded streams report the actual
        per-pair loads (padding carries no pairs).
      * ``intra_per_rack`` [P]: stage-2 pairs through each ToR switch.

    Degraded plans (4-dim ``cross_valid`` — see
    :mod:`repro_torch.core.degraded`) are counted straight off the valid
    slots: their stage 1 is per-layer repair unicast, so the multicast gain
    is forfeited during recovery regardless of ``multicast``.
    """
    if multicast not in MULTICAST_MODES:
        raise ValueError(f"multicast must be one of {MULTICAST_MODES}")
    p = plan.params
    q_rack, q_srv = p.Q // p.P, p.Q // p.K
    intra_rack = float(p.Kr * (p.Kr - 1) * p.subfiles_per_layer * q_srv)
    cv = plan.cross_valid
    if cv is not None and cv.ndim == 4:
        # valid slots summed over layers and slot axis: [recv i, src z]
        counts = cv.sum(axis=(1, 3)) if cv.size else np.zeros((p.P, p.P))
        return {"cross_rack_matrix": counts.T.astype(float) * q_rack,
                "intra_per_rack": np.full((p.P,), intra_rack)}
    arity = plan.mcast_arity
    gain = arity if (multicast != "unicast" and arity >= 2) else 1
    if plan.family == "resolvable":
        from .resolvable import shared_group_counts
        sh = p.M_res // (p.r - 1)
        cross = (shared_group_counts(p).astype(float)
                 * sh * p.Kr * q_rack / gain)
    else:
        per_stream = float(p.Kr * plan.n_send * q_rack) / gain
        cross = np.full((p.P, p.P), per_stream)
        np.fill_diagonal(cross, 0.0)
    return {"cross_rack_matrix": cross,
            "intra_per_rack": np.full((p.P,), intra_rack)}


def plan_shuffle_reference(values: np.ndarray, p: SchemeParams,
                           family: str = "binomial") -> np.ndarray:
    """Oracle: [K, N, q_srv, d] that a correct shuffle must deliver, in the
    row order of :func:`reduce_ready_order`."""
    plan = compile_hybrid_plan(p, family=family)
    order = reduce_ready_order(plan)
    q_srv = p.Q // p.K
    out = np.zeros((p.K, p.N, q_srv, values.shape[-1]), values.dtype)
    for i in range(p.P):
        for j in range(p.Kr):
            s = p.server_id(i, j)
            keys = list(p.keys_of_server(s))
            out[s] = values[order[i, j]][:, keys, :]
    return out


def simulate_plan_shuffle(values: np.ndarray, plan: HybridShufflePlan,
                          multicast: str = "unicast", *,
                          failed: Sequence[int] = (),
                          patch: Optional[np.ndarray] = None) -> np.ndarray:
    """Re-execute the exact data movement of :func:`hybrid_shuffle` with
    NumPy indexing, server by server: stage-1 table fill (local rows + per
    source rack received blocks), then the stage-2 intra-rack key split.
    Independent of torch, so it validates the index tables of any
    registered plan family.

    ``multicast='coded'`` re-executes the coded wire format instead: each
    stage-1 packet is the SUM of its ``mcast_arity`` components (the
    sender's ``mcast_comp_*`` tables) and the receiver decodes by
    subtracting its arity-1 locally known components (``mcast_known_*``).
    Plans with padded streams contribute only their ``cross_valid`` slots.

    ``failed`` (flat server ids) zeroes those servers' in-memory map
    outputs before the shuffle — the crash model of
    :mod:`repro_torch.core.degraded` — and ``patch`` adds a [K, n_layer,
    q_rack, d] per-server stage-1 correction (re-mapped orphan rows) after
    the table fill, mirroring the ``patch`` argument of
    :func:`shuffle_device_body`.  Together they re-execute a DEGRADED plan
    exactly as the degraded device program does.
    """
    p = plan.params
    q_rack, q_srv = p.Q // p.P, p.Q // p.K
    n_layer = p.subfiles_per_layer
    d = values.shape[-1]
    local = pack_local_values(values, plan).reshape(
        p.P, p.Kr, -1, p.Q, d)                      # [P, Kr, n_loc, Q, d]
    if failed:
        local = local.copy()
        for s in failed:
            local[int(s) // p.Kr, int(s) % p.Kr] = 0
    arity = plan.mcast_arity
    coded = multicast == "coded" and arity >= 2

    # ---- Stage 1: per-server layer table over its rack's q_rack keys ------
    table = np.zeros((p.P, p.Kr, n_layer, q_rack, d), values.dtype)
    for i in range(p.P):
        keys_i = np.arange(i * q_rack, (i + 1) * q_rack)
        for j in range(p.Kr):
            table[i, j, plan.local_pos[i, j]] = local[i, j][:, keys_i]
            if plan.n_send:
                for z in range(p.P):
                    if z == i:
                        continue
                    cv = plan.cross_valid
                    valid = (slice(None) if cv is None
                             else cv[i, j, z] if cv.ndim == 4
                             else cv[i, z])
                    dst = plan.cross_recv_pos[i, j, z][valid]
                    if not coded:
                        # what z sends to i: its share rows, i's rack keys
                        sent = local[z, j][plan.cross_send_pos[z, j, i]][
                            :, keys_i]
                        table[i, j, dst] = sent[valid]
                        continue
                    # sender z encodes packets for destination i
                    cpos = plan.mcast_comp_pos[z, i]     # [n_send, arity]
                    ckey = (plan.mcast_comp_rack[z, i][..., None] * q_rack
                            + np.arange(q_rack))         # [n_send, ar, qr]
                    f = local[z, j][cpos[..., None],
                                    ckey].sum(axis=1)    # [n_send, qr, d]
                    # receiver i decodes with its side information
                    kpos = plan.mcast_known_pos[i, z]    # [n_send, arity-1]
                    kkey = (plan.mcast_known_rack[i, z][..., None] * q_rack
                            + np.arange(q_rack))
                    side = local[i, j][kpos[..., None], kkey].sum(axis=1)
                    table[i, j, dst] = (f - side)[valid]
    if patch is not None:
        table = table + np.asarray(patch).reshape(
            p.P, p.Kr, n_layer, q_rack, d)

    # ---- Stage 2: intra-rack all_to_all == per-server key split -----------
    out = np.zeros((p.K, p.Kr * n_layer, q_srv, d), values.dtype)
    for i in range(p.P):
        for j in range(p.Kr):
            s = p.server_id(i, j)
            # server (i, j) collects key-chunk j of every layer jp's table
            out[s] = table[i, :, :, j * q_srv:(j + 1) * q_srv, :].reshape(
                p.Kr * n_layer, q_srv, d)
    return out


# Register the resolvable-design family (import side effect; kept at module
# bottom — resolvable.py needs only plan_registry/params/assignment).
from . import resolvable as _resolvable_family  # noqa: E402,F401

__all__ = [
    "HybridShufflePlan", "register_plan_compiler", "get_plan_compiler",
    "plan_families", "plan_from_numpy", "compile_hybrid_plan",
    "compile_hybrid_plan_r2",
    "plan_cache_info", "plan_cache_clear",
    "PlanCacheInfo", "FamilyCacheInfo",
    "MULTICAST_MODES", "COMBINE_IMPLS", "DevicePlanTables",
    "upload_plan_tables", "device_plan_tables", "rank_plan_tables",
    "shuffle_device_body", "shuffle_rank_body", "hybrid_shuffle",
    "hybrid_shuffle_r2",
    "reduce_ready_order", "reduce_output_keys", "pack_local_values",
    "plan_transfer_matrices", "plan_shuffle_reference",
    "simulate_plan_shuffle",
]
