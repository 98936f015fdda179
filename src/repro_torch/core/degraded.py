"""Degraded-mode plan recompilation: shuffle around crashed servers.

The paper pays for r-fold map replication as a communication code, but the
same redundancy is an *erasure* code: every layer-table row has r owner
racks, so losing up to r - 1 owners per multicast group leaves the shuffle
decodable WITHOUT re-running map.  :func:`compile_degraded_plan` turns that
observation into executable index tables, for ANY registered plan family —
it reasons only over the base plan's schema (``local_mask`` names the
owners, ``cross_send_pos``/``cross_recv_pos``/``cross_valid`` name the
original routing), never over family internals.

Counterpart of ``repro/core/degraded.py``; the plan half is NumPy only and
yields the same tables as the JAX package's compiler, table by table.

Failure model (matches :mod:`repro_torch.mapreduce.recovery`): the
failure unit is one server — mesh coordinate (rack i, layer j), flat id
``i * Kr + j``.  A crash loses the server's IN-MEMORY map outputs; a
replacement worker rejoins at the same coordinate with empty memory, so the
collective keeps all K participants and the failed coordinates contribute
zeros (tests poison them with garbage to prove no information flows out).

Construction, per layer j (layers fail independently — rack i failing in
layer j says nothing about layer j'):

  * every surviving receiver still needs its non-local rows; a replaced
    receiver needs ALL rows (its local copies died with it);
  * a needed row keeps its ORIGINAL source when that sender survived
    (the base plan's load balance is preserved); rows whose sender died —
    and the replaced receivers' own rows — are re-sourced from the lowest-
    numbered surviving owner rack;
  * rows with NO surviving owner are *orphans*: reported per subfile id so
    the engine can re-map exactly those on survivors and inject them via the
    ``patch`` argument of
    :func:`repro_torch.core.coded_collectives.shuffle_device_body`.

The degraded tables keep the base schema, with two deltas:

  * ``cross_valid`` gains a layer axis — [P, Kr, P, n_send] — because
    repair streams differ per layer (both the device body and the NumPy
    oracle dispatch on ``ndim``);
  * the multicast tables are emptied to arity 1: degraded stage 1 runs
    UNICAST.  Replaced receivers have no side information to decode with,
    and a survivor's repair read is a raw replica row, so coded packets
    would not cover the repairs anyway.  Decode tables of the failure-free
    plan (and the CUDA ``coded_combine`` path) are untouched.

Cache hygiene: degraded plans live in a BOUNDED side LRU keyed
``(params, perm, family, failed)`` — an injected-failure sweep cannot evict
the hot failure-free plans from the main cache of
:mod:`repro_torch.core.coded_collectives` (see :func:`degraded_cache_info`).
A degraded plan holds its own device tables (:meth:`DegradedPlan
.device_tables`), so they are freed with its side-cache entry instead of
pinning the card from the plan-keyed cache of ``device_plan_tables``.
"""
from __future__ import annotations

import dataclasses
import os
import threading
from collections import OrderedDict
from typing import (Any, Callable, Dict, List, NamedTuple, Optional,
                    Sequence, Tuple)

import numpy as np

from .params import SchemeParams
from .plan_registry import HybridShufflePlan, family_of_scheme
from .shuffle_plan import StageTraffic


# ---------------------------------------------------------------------------
# The degraded plan
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class DegradedPlan:
    """A base plan re-routed around ``failed`` servers.

    ``plan`` is a full :class:`HybridShufflePlan` (same schema as the base;
    4-dim ``cross_valid``, arity-1 multicast tables) — every consumer of the
    base schema runs it unchanged.  ``orphan_rows[j]`` lists layer-j rows
    with no surviving owner; ``orphan_subfiles`` the matching global subfile
    ids (what the engine must re-map).  ``n_repaired_rows`` counts
    (receiver, row) deliveries that had to be re-sourced vs the base routing
    — the repair traffic beyond the failure-free unicast schedule.
    """
    base: HybridShufflePlan
    failed: Tuple[int, ...]
    plan: HybridShufflePlan
    orphan_rows: Tuple[np.ndarray, ...]        # per layer j
    orphan_subfiles: np.ndarray                # sorted global subfile ids
    n_repaired_rows: int
    # device -> the re-routed plan's DevicePlanTables, owned by this plan
    _tables: Dict[Any, Any] = dataclasses.field(default_factory=dict,
                                                repr=False)

    @property
    def params(self) -> SchemeParams:
        return self.base.params

    @property
    def decode_around(self) -> bool:
        """True when every lost row keeps a surviving owner — recovery needs
        zero re-mapped subfiles (the f <= r-1 per-group guarantee)."""
        return self.orphan_subfiles.size == 0

    def transfer_loads(self) -> Dict[str, np.ndarray]:
        """Exact wire loads of the degraded shuffle, in <key, value> pairs
        (the shape of :func:`~repro_torch.core.coded_collectives
        .plan_transfer_matrices`): ``cross_rack_matrix[src, dst]`` stage-1
        root-switch pairs (unicast — the multicast gain is forfeited during
        recovery) and ``intra_per_rack`` stage-2 ToR pairs (unchanged from
        the failure-free plan: stage 2 is a per-server key split of full
        layer tables).  Delegates to ``plan_transfer_matrices``, which
        dispatches on the degraded 4-dim ``cross_valid`` schema."""
        from .coded_collectives import plan_transfer_matrices
        return plan_transfer_matrices(self.plan, multicast="unicast")

    def device_tables(self, device):
        """The re-routed plan's
        :class:`~repro_torch.core.coded_collectives.DevicePlanTables` on
        ``device``, uploaded once and held by THIS object — not by the
        plan-keyed ``device_plan_tables`` cache, which would keep every
        evicted degraded plan's tables on the card."""
        tables = self._tables.get(device)
        if tables is None:
            from .coded_collectives import upload_plan_tables
            tables = self._tables[device] = upload_plan_tables(self.plan,
                                                               device)
        return tables


def _failed_mask(p: SchemeParams, failed: Sequence[int]) -> np.ndarray:
    """[P, Kr] bool from flat failed server ids, validated."""
    mask = np.zeros((p.P, p.Kr), dtype=bool)
    for s in failed:
        s = int(s)
        if not 0 <= s < p.K:
            raise ValueError(f"failed server id {s} out of range [0, {p.K})")
        mask[s // p.Kr, s % p.Kr] = True
    return mask


def _compile_degraded(p: SchemeParams, failed: Tuple[int, ...], family: str,
                      perm: Optional[Tuple[int, ...]]) -> DegradedPlan:
    """Uncached construction (see module docstring for the algorithm)."""
    from .coded_collectives import compile_hybrid_plan
    base = compile_hybrid_plan(p, perm=perm, family=family)
    P_, Kr = p.P, p.Kr
    n_layer = p.subfiles_per_layer
    fail_rl = _failed_mask(p, failed)
    if fail_rl.all() and failed:
        raise ValueError("all servers failed; nothing to recover from")

    # per-layer (receiver, source) -> sorted needed rows
    streams: List[List[List[np.ndarray]]] = []   # [Kr][P recv][P src] rows
    orphan_rows: List[np.ndarray] = []
    n_repaired = 0
    local_mask = np.asarray(base.local_mask)
    for j in range(Kr):
        fail_j = fail_rl[:, j]                              # [P]
        owners = local_mask[:, j, :]                        # [P, n_layer]
        alive_owner = owners & ~fail_j[:, None]
        # original stage-1 source of each (receiver, row); -1 = local/none
        src0 = np.full((P_, n_layer), -1, dtype=np.int64)
        if base.n_send:
            for i in range(P_):
                for z in range(P_):
                    if z == i:
                        continue
                    cv = base.cross_valid
                    valid = (slice(None) if cv is None else
                             cv[i, j, z] if cv.ndim == 4 else cv[i, z])
                    src0[i, base.cross_recv_pos[i, j, z][valid]] = z
        # needed rows per receiver: non-local ones, plus ALL rows of a
        # replaced receiver (its local copies died with the crash)
        first_alive = np.where(alive_owner.any(axis=0),
                               alive_owner.argmax(axis=0), -1)  # [n_layer]
        orphan = ~alive_owner.any(axis=0)
        orphan_rows.append(np.nonzero(orphan)[0])
        per_recv: List[List[np.ndarray]] = []
        for i in range(P_):
            need = (~owners[i]) | fail_j[i]
            keep = src0[i] >= 0
            keep &= np.where(keep, ~fail_j[np.clip(src0[i], 0, P_ - 1)],
                             False)
            src = np.where(need & keep, src0[i], -1)
            repair = need & ~keep & ~orphan
            src = np.where(repair, first_alive, src)
            n_repaired += int(repair.sum())
            per_recv.append([np.nonzero(src == z)[0] for z in range(P_)])
        streams.append(per_recv)

    n_send = max((len(rows) for per_recv in streams
                  for by_src in per_recv for rows in by_src), default=0)
    send_pos = np.zeros((P_, Kr, P_, n_send), dtype=np.int64)
    recv_pos = np.zeros((P_, Kr, P_, n_send), dtype=np.int64)
    valid = np.zeros((P_, Kr, P_, n_send), dtype=bool)
    local_pos = np.asarray(base.local_pos)
    for j in range(Kr):
        # sender z's layer-row -> local val-row inverse, per layer
        inv = np.full((P_, n_layer), 0, dtype=np.int64)
        for z in range(P_):
            inv[z, local_pos[z, j]] = np.arange(local_pos.shape[-1])
        for i in range(P_):
            for z in range(P_):
                rows = streams[j][i][z]
                k = len(rows)
                if k == 0:
                    continue
                recv_pos[i, j, z, :k] = rows
                send_pos[z, j, i, :k] = inv[z, rows]
                valid[i, j, z, :k] = True

    # arity-1 multicast tables: degraded stage 1 is unicast by construction
    # (mcast_arity == 1 makes every coded branch degenerate)
    mcast_shape = (P_, P_, n_send, 1)
    plan = HybridShufflePlan(
        p, base.local_subfiles, send_pos, base.layer_subfiles, recv_pos,
        base.local_mask, n_send, base.local_pos,
        np.zeros(mcast_shape, dtype=np.int64),
        np.zeros(mcast_shape, dtype=np.int64),
        np.zeros((P_, P_, n_send, 0), dtype=np.int64),
        np.zeros((P_, P_, n_send, 0), dtype=np.int64),
        family=base.family, cross_valid=valid)
    layer_sub = np.asarray(base.layer_subfiles)
    orphan_subs = np.unique(np.concatenate(
        [layer_sub[0, j, rows] for j, rows in enumerate(orphan_rows)]
    )) if any(len(r) for r in orphan_rows) else np.empty(0, dtype=np.int64)
    return DegradedPlan(base, failed, plan, tuple(orphan_rows),
                        orphan_subs, n_repaired)


# ---------------------------------------------------------------------------
# Bounded side cache (keeps failure sweeps out of the hot plan cache)
# ---------------------------------------------------------------------------

DEGRADED_CACHE_MAXSIZE_ENV = "REPRO_DEGRADED_CACHE_MAXSIZE"
_DEGRADED_CACHE_DEFAULT_MAXSIZE = 32


class DegradedCacheInfo(NamedTuple):
    """Stats of the degraded-plan side cache; ``evictions`` counts entries
    dropped by the LRU bound (the failure-sweep pressure the main plan
    cache is shielded from)."""
    hits: int
    misses: int
    maxsize: Optional[int]
    currsize: int
    evictions: int


class _BoundedLRU:
    """Tiny OrderedDict LRU with explicit hit/miss/eviction counters
    (functools.lru_cache hides evictions)."""

    def __init__(self, maxsize: Optional[int]) -> None:
        self.maxsize = maxsize
        self._data: "OrderedDict[tuple, object]" = OrderedDict()
        self._lock = threading.Lock()
        self.hits = self.misses = self.evictions = 0

    def get_or(self, key: tuple, mk: Callable[[], object]) -> object:
        with self._lock:
            if key in self._data:
                self._data.move_to_end(key)
                self.hits += 1
                return self._data[key]
        value = mk()                       # compile outside the lock
        with self._lock:
            if key in self._data:          # racing compile: keep the first
                self._data.move_to_end(key)
                return self._data[key]
            self.misses += 1
            self._data[key] = value
            if self.maxsize is not None and len(self._data) > self.maxsize:
                self._data.popitem(last=False)
                self.evictions += 1
        return value

    def info(self) -> DegradedCacheInfo:
        return DegradedCacheInfo(self.hits, self.misses, self.maxsize,
                                 len(self._data), self.evictions)

    def clear(self) -> None:
        with self._lock:
            self._data.clear()
            self.hits = self.misses = self.evictions = 0


def _degraded_cache_default_maxsize() -> int:
    raw = os.environ.get(DEGRADED_CACHE_MAXSIZE_ENV, "")
    try:
        return int(raw)
    except ValueError:
        return _DEGRADED_CACHE_DEFAULT_MAXSIZE


def configure_degraded_cache(maxsize: Optional[int] = None) -> None:
    """(Re)build the degraded-plan side cache (``None`` -> the
    ``REPRO_DEGRADED_CACHE_MAXSIZE`` env var, falling back to 32); drops all
    cached degraded plans and zeroes the counters."""
    global _DEGRADED_CACHE
    if maxsize is None:
        maxsize = _degraded_cache_default_maxsize()
    _DEGRADED_CACHE = _BoundedLRU(maxsize)


_DEGRADED_CACHE = _BoundedLRU(_degraded_cache_default_maxsize())


def degraded_cache_info() -> DegradedCacheInfo:
    return _DEGRADED_CACHE.info()


def degraded_cache_clear() -> None:
    _DEGRADED_CACHE.clear()


def compile_degraded_plan(p: SchemeParams, failed: Sequence[int],
                          family: str = "binomial",
                          perm: Sequence[int] | None = None) -> DegradedPlan:
    """Compile the degraded routing of ``(p, perm, family)`` around the
    ``failed`` flat server ids (order/duplicates ignored).

    Family-agnostic: works for every registered plan family through the base
    plan's schema alone.  Results are memoized in a bounded side LRU keyed
    ``(params, perm, family, failed)`` — repeated recoveries of one failure
    set are O(1), and failure sweeps cannot evict hot failure-free plans
    (those live in the main cache of :mod:`repro_torch.core.coded_collectives`).
    An empty ``failed`` is allowed and yields repair-free tables equivalent
    to the base routing (the engine skips degraded execution in that case).
    """
    failed_t = tuple(sorted({int(s) for s in failed}))
    key_perm = None if perm is None else tuple(int(x) for x in perm)
    key = (p, key_perm, family, failed_t)
    return _DEGRADED_CACHE.get_or(
        key, lambda: _compile_degraded(p, failed_t, family, key_perm))


# ---------------------------------------------------------------------------
# Patch construction (orphan re-map injection)
# ---------------------------------------------------------------------------

def build_patch(dplan: DegradedPlan, orphan_values: np.ndarray) -> np.ndarray:
    """Per-server stage-1 patch from re-mapped orphan values (the NumPy
    reference of the device patch built by
    :mod:`repro_torch.mapreduce.recovery`).

    ``orphan_values[m]`` is the [Q, d] map output of subfile
    ``dplan.orphan_subfiles[m]`` (recomputed on survivors).  Returns
    [K, n_layer, q_rack, d]: server (i, j)'s layer table gets its rack's key
    block of every orphan row added AFTER local fill and repair receives
    (orphan rows receive nothing and their local fill is zeros, so add ==
    set).  Zero rows everywhere else."""
    p = dplan.params
    q_rack = p.Q // p.P
    n_layer = p.subfiles_per_layer
    d = orphan_values.shape[-1] if orphan_values.ndim == 3 else 1
    dtype = orphan_values.dtype if orphan_values.size else np.float32
    patch = np.zeros((p.K, n_layer, q_rack, d), dtype=dtype)
    if not dplan.orphan_subfiles.size:
        return patch
    index = {int(sf): m for m, sf in enumerate(dplan.orphan_subfiles)}
    layer_sub = np.asarray(dplan.base.layer_subfiles)
    for j, rows in enumerate(dplan.orphan_rows):
        for t in rows:
            v = orphan_values[index[int(layer_sub[0, j, t])]]   # [Q, d]
            for i in range(p.P):
                patch[p.server_id(i, j), t] = v[i * q_rack:(i + 1) * q_rack]
    return patch


# ---------------------------------------------------------------------------
# Stage-traffic export for the simulator / chooser
# ---------------------------------------------------------------------------

def degraded_stage_traffic(p: SchemeParams, scheme: str,
                           failed: Sequence[int]
                           ) -> Tuple[List[StageTraffic], int]:
    """(degraded shuffle stages, re-mapped subfile count) of recovering
    ``scheme`` after losing ``failed`` servers — the load the sim's crash
    events and the chooser's availability term price.

    Hybrid families compile the EXACT degraded plan when the instance is
    executable (the simulated recovery traffic IS the degraded schedule);
    orphaned subfiles additionally pay a one-per-rack redistribution of
    their re-mapped values (``n_orphans * Q`` cross pairs — the engine
    places them in the patch, a real cluster broadcasts them).  Instances the
    compiler rejects (Table-I rows simulated with ``check=False``) and the
    non-hybrid schemes fall back to a closed-form model: the re-run forfeits
    the multicast gain (cross x arity), each failed server's replacement
    re-receives its n_loc local rows (``f * (rN/K) * (Q/P)`` cross pairs),
    and r = 1 schemes re-map the dead servers' full partitions — the paper's
    erasure-code reading of r, priced as a failure-tolerance knob.
    """
    from .shuffle_plan import scheme_stage_traffic
    failed_t = tuple(sorted({int(s) for s in failed}))
    f = len(failed_t)
    family = family_of_scheme(scheme)
    if family is not None:
        try:
            dp = compile_degraded_plan(p, failed_t, family=family)
            tm = dp.transfer_loads()
            n_remap = int(dp.orphan_subfiles.size)
            cross = float(tm["cross_rack_matrix"].sum()) + n_remap * p.Q
            zeros = tuple(0.0 for _ in range(p.P))
            stages = [StageTraffic("cross", cross, zeros),
                      StageTraffic("intra", 0.0,
                                   tuple(float(x)
                                         for x in tm["intra_per_rack"]))]
            return stages, n_remap
        except ValueError:
            pass
    base = scheme_stage_traffic(p, scheme, check=False)
    repl = 1 if scheme == "uncoded" else p.r
    gain = {"binomial": p.r, "resolvable": p.r - 1}.get(family or "", p.r) \
        if scheme != "uncoded" else 1
    gain = max(int(gain), 1)
    n_remap = (f * p.N) // p.K if repl == 1 else 0
    repair = f * (repl * p.N / p.K) * (p.Q / p.P) + n_remap * p.Q
    stages = []
    for st in base:
        if st.stage == "cross":
            stages.append(StageTraffic("cross",
                                       st.cross_pairs * gain + repair,
                                       st.intra_pairs_per_rack))
        else:
            stages.append(st)
    return stages, int(n_remap)


__all__ = [
    "DegradedPlan", "compile_degraded_plan", "build_patch",
    "degraded_stage_traffic", "degraded_cache_info", "degraded_cache_clear",
    "configure_degraded_cache", "DegradedCacheInfo",
    "DEGRADED_CACHE_MAXSIZE_ENV",
]
