"""Resolvable-design shuffle construction (the low-subpacketization family).

Adapts the single-parity-check (SPC) resolvable designs of Konstantinidis &
Ramamoorthy (arXiv:1908.05666) to the paper's server-rack hybrid scheme:
coding runs ACROSS RACKS within each server layer, exactly like the
binomial Sec. III construction, but the rack r-subsets are replaced by the
parallel classes of an SPC code, collapsing the subpacketization from
C(P, r) to q^{r-1} with q = P / r.

Construction (per layer, P = r * q racks, q >= 2):

  * Rack i belongs to *class* i // q with *value* i % q — the r parallel
    classes of the design.
  * The layer's NP/K subfiles split into B = q^{r-1} *batches* indexed by
    the codewords of the (r, r-1) SPC code over Z_q (last symbol = sum of
    the first r-1, mod q), M = (NP/K)/B subfiles per batch.  Batch b is
    mapped at the r racks {(class t, value b_t)} — one per class, so every
    subfile is mapped r times and every rack maps B/q = q^{r-2} batches:
    the same computation load r N/K as the binomial family.
  * Stage-1 multicast groups are the NON-codewords g in Z_q^r: the r racks
    {(t, g_t)} miss exactly one batch each — member (t, g_t) needs the
    unique codeword b(g, t) agreeing with g off coordinate t, which every
    OTHER member maps (side information).  Each member's missing M-subfile
    block splits into r-1 shares; each of its r-1 peers multicasts one
    coded packet stream combining its shares for all r-1 fellow members,
    so every packet serves r-1 receivers and traverses the root once:
    multicast gain r - 1.
  * Stage 2 (intra-rack) is identical to the binomial family.

Costs (Theorem III.1 analogue, proven against the enumerated schedule in
tests):  cross = QN/(r-1) * (1 - r/P),  intra = QN * (1 - P/K).

The win is the divisibility demand: NP/K must be a multiple of q^{r-1}
(a plain prime power when q is one) instead of C(P, r) — at power-of-two
subfile counts the binomial family is infeasible beyond P = 2 while this
family scales P (hence K) by orders of magnitude.  See docs/scaling.md and
``benchmarks/scale_bench.py``.

The compiled plan shares :class:`~repro_torch.core.plan_registry.HybridShufflePlan`
with the binomial family: packets have ``mcast_arity`` = r - 1 components,
and because same-class rack pairs exchange nothing, the all_to_all streams
are padded to a uniform ``n_send`` with ``cross_valid`` masking the padding.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from .assignment import Assignment
from .params import SchemeParams
from .plan_registry import HybridShufflePlan, register_plan_compiler


# ---------------------------------------------------------------------------
# SPC-code machinery (shared with repro.placement.structured)
# ---------------------------------------------------------------------------

def spc_codewords(q: int, r: int) -> np.ndarray:
    """All q^{r-1} codewords of the (r, r-1) SPC code over Z_q, as an
    [B, r] int64 array in lexicographic order of the first r-1 symbols
    (the batch enumeration order of the resolvable design)."""
    if q < 2 or r < 2:
        raise ValueError(f"SPC code needs q >= 2 and r >= 2; q={q} r={r}")
    B = q ** (r - 1)
    grids = np.meshgrid(*[np.arange(q)] * (r - 1), indexing="ij")
    info = np.stack([g.reshape(-1) for g in grids], axis=1) if r > 1 \
        else np.zeros((B, 0), np.int64)
    parity = info.sum(axis=1) % q
    return np.concatenate([info, parity[:, None]], axis=1).astype(np.int64)


def batch_index(coords: np.ndarray, q: int) -> np.ndarray:
    """Lexicographic batch index of codeword(s) from their first r-1
    symbols (base-q digits, most-significant first)."""
    coords = np.asarray(coords, dtype=np.int64)
    info = coords[..., :-1]
    weights = q ** np.arange(info.shape[-1] - 1, -1, -1, dtype=np.int64)
    return (info * weights).sum(axis=-1)


def needed_batch(g: Sequence[int], t: int, q: int) -> np.ndarray:
    """The unique codeword agreeing with group vector ``g`` on every
    coordinate except ``t`` (the batch that group member (t, g_t) is
    missing).  For a non-codeword g its t-th symbol differs from g_t."""
    b = np.asarray(g, dtype=np.int64).copy()
    r = len(b)
    if t == r - 1:
        b[t] = b[:-1].sum() % q
    else:
        b[t] = (b[-1] - (b[:-1].sum() - b[t])) % q
    return b


def cyclic_replica_server(p: SchemeParams, base: np.ndarray,
                          shift: int) -> np.ndarray:
    """Parallel-class replica shift: rotate the rack by ``shift`` and the
    in-rack slot by ``shift // P`` (distinct servers for shift < K).  The
    primitive behind the structured replica placements of
    :mod:`repro.placement.structured` — each shift is a bijection of the
    base layout, i.e. one parallel class of a resolvable storage design."""
    rack = (base // p.Kr + shift) % p.P
    slot = (base % p.Kr + shift // p.P) % p.Kr
    return rack * p.Kr + slot


# ---------------------------------------------------------------------------
# Map assignment
# ---------------------------------------------------------------------------

def resolvable_assignment(params: SchemeParams,
                          perm: Sequence[int] | None = None) -> Assignment:
    """Resolvable-design map assignment (scheme ``'hybrid_resolvable'``).

    Structural slots are (layer, batch, w), slot-major exactly like the
    binomial family's (layer, subset, w); ``perm`` places subfile
    ``perm[slot]`` into each slot — the same Section-IV locality degree of
    freedom.  ``meta['slot_of_subfile']`` maps each subfile back to its
    slot and ``meta['codewords']`` carries the batch -> codeword table.
    """
    params.validate_hybrid_resolvable()
    p = params
    q, r = p.spc_q, p.r
    cw = spc_codewords(q, r)                              # [B, r]
    B = cw.shape[0]
    M = p.M_res
    n_layer = p.subfiles_per_layer
    if perm is None:
        perm = list(range(p.N))
    if sorted(perm) != list(range(p.N)):
        raise ValueError("perm must be a permutation of range(N)")

    # racks of batch t: class u's member is rack u*q + cw[t, u]
    batch_racks = np.arange(r) * q + cw                   # [B, r]
    servers: List[Optional[Tuple[int, ...]]] = [None] * p.N
    slot_of: List[Optional[Tuple[int, int, int]]] = [None] * p.N
    for layer in range(p.Kr):
        for t in range(B):
            srvs = tuple(sorted(int(rk) * p.Kr + layer
                                for rk in batch_racks[t]))
            for w in range(M):
                slot_index = layer * n_layer + t * M + w
                subfile = perm[slot_index]
                servers[subfile] = srvs
                slot_of[subfile] = (layer, t, w)
    return Assignment("hybrid_resolvable", p, tuple(servers),  # type: ignore[arg-type]
                      meta={"slot_of_subfile": tuple(slot_of),
                            "perm": tuple(perm),
                            "codewords": tuple(map(tuple, cw.tolist()))})


# ---------------------------------------------------------------------------
# Group enumeration shared by the compiler and the message-level schedule
# ---------------------------------------------------------------------------

def shared_groups(p: SchemeParams, sender_rack: int,
                  dest_rack: int) -> np.ndarray:
    """Multicast-group vectors containing both racks, [n, r] in
    lexicographic order of the free coordinates (deterministic — the
    sender's stream layout and the receiver's decode tables enumerate the
    SAME order).  Empty for same-class pairs and for self."""
    q, r = p.spc_q, p.r
    cs, vs = divmod(sender_rack, q)
    cd, vd = divmod(dest_rack, q)
    if cs == cd:
        return np.zeros((0, r), dtype=np.int64)
    free = [t for t in range(r) if t not in (cs, cd)]
    n_free = len(free)
    combos = np.stack(np.meshgrid(*[np.arange(q)] * n_free, indexing="ij"),
                      axis=-1).reshape(-1, n_free) if n_free else \
        np.zeros((1, 0), np.int64)
    g = np.zeros((combos.shape[0], r), dtype=np.int64)
    g[:, cs] = vs
    g[:, cd] = vd
    for k, t in enumerate(free):
        g[:, t] = combos[:, k]
    parity = (g[:, :-1].sum(axis=1) % q) == g[:, -1]      # codeword mask
    return g[~parity]


def max_shared_groups(p: SchemeParams) -> int:
    """Uniform stage-1 stream size: shared-group count of a cross-class
    rack pair — q^{r-2} - q^{r-3} for r >= 3 (codewords with two fixed
    coordinates are q^{r-3}); for r = 2 pairs share at most one group."""
    q, r = p.spc_q, p.r
    if r == 2:
        return 1
    return q ** (r - 2) - (q ** (r - 3) if r >= 3 else 0)


def shared_group_counts(p: SchemeParams) -> np.ndarray:
    """[P, P] actual shared-group counts per (sender, dest) rack pair —
    the unpadded stage-1 stream sizes behind ``plan_transfer_matrices``."""
    q, r = p.spc_q, p.r
    cls = np.arange(p.P) // q
    val = np.arange(p.P) % q
    cross_class = cls[:, None] != cls[None, :]
    if r == 2:
        counts = (cross_class & (val[:, None] != val[None, :])).astype(
            np.int64)
    else:
        counts = cross_class.astype(np.int64) * max_shared_groups(p)
    return counts


# ---------------------------------------------------------------------------
# Plan compiler
# ---------------------------------------------------------------------------

@register_plan_compiler("resolvable")
def compile_resolvable_plan(p: SchemeParams,
                            perm: Tuple[int, ...] | None = None
                            ) -> HybridShufflePlan:
    """Compile the resolvable-design shuffle into executable index tables.

    Same table schema as the binomial compiler (see
    :class:`~repro_torch.core.plan_registry.HybridShufflePlan`); packets carry
    arity = r - 1 components and ``cross_valid`` masks the padded slots of
    same-class (and r = 2 same-value) rack pairs.  Cost is
    O(N + P^2 * q^{r-2} * M) — polynomial in P with exponent set by the
    gain, never a binomial.
    """
    p.validate_hybrid_resolvable()
    q, r = p.spc_q, p.r
    M = p.M_res
    sh = M // (r - 1)
    cw = spc_codewords(q, r)                               # [B, r]
    B = cw.shape[0]
    n_layer = p.subfiles_per_layer
    a = resolvable_assignment(p, perm=list(perm) if perm is not None
                              else None)
    slot = np.asarray(a.meta["slot_of_subfile"], dtype=np.int64)  # [N, 3]

    # subfile id of each structural slot: S[layer, batch, w]
    S = np.empty((p.Kr, B, M), dtype=np.int64)
    S[slot[:, 0], slot[:, 1], slot[:, 2]] = np.arange(p.N)

    # rack-membership over batches: member[i, t] iff rack i maps batch t
    cls = np.arange(p.P) // q
    val = np.arange(p.P) % q
    member = cw[:, cls].T == val[:, None]                  # [P, B]
    n_loc_b = B // q                                       # batches per rack
    ts = np.nonzero(member)[1].reshape(p.P, n_loc_b)       # [P, n_loc_b]
    rank = np.zeros((p.P, B), dtype=np.int64)
    rank[np.arange(p.P)[:, None], ts] = np.arange(n_loc_b)[None, :]

    n_loc = n_loc_b * M
    n_groups = max_shared_groups(p)
    n_send = n_groups * sh

    layer_table = np.broadcast_to(S.reshape(1, p.Kr, n_layer),
                                  (p.P, p.Kr, n_layer))
    local_subfiles = np.ascontiguousarray(
        S[:, ts, :].transpose(1, 0, 2, 3).reshape(p.P, p.Kr, n_loc))
    local_mask = np.broadcast_to(
        np.repeat(member, M, axis=1)[:, None, :], (p.P, p.Kr, n_layer))
    local_pos = np.broadcast_to(
        (ts[:, :, None] * M + np.arange(M)).reshape(p.P, 1, n_loc),
        (p.P, p.Kr, n_loc))

    arity = r - 1
    n_known = arity - 1
    off = np.arange(sh)
    cross_send_pos = np.zeros((p.P, p.Kr, p.P, n_send), dtype=np.int64)
    cross_recv_pos = np.zeros((p.P, p.Kr, p.P, n_send), dtype=np.int64)
    cross_valid = np.zeros((p.P, p.P, n_send), dtype=bool)
    mcast_comp_pos = np.zeros((p.P, p.P, n_send, arity), dtype=np.int64)
    mcast_comp_rack = np.zeros((p.P, p.P, n_send, arity), dtype=np.int64)
    mcast_known_pos = np.zeros((p.P, p.P, n_send, n_known), dtype=np.int64)
    mcast_known_rack = np.zeros((p.P, p.P, n_send, n_known), dtype=np.int64)

    def sender_pos(u_cls: int, t_cls: int) -> int:
        """Share index of sender class u among receiver t's r-1 senders."""
        return u_cls if u_cls < t_cls else u_cls - 1

    for s_rack in range(p.P):
        cu = s_rack // q
        for z_rack in range(p.P):
            if z_rack == s_rack:
                continue
            ct = z_rack // q
            groups = shared_groups(p, s_rack, z_rack)      # [n_g, r]
            for g_idx, g in enumerate(groups):
                rows = slice(g_idx * sh, (g_idx + 1) * sh)
                # --- dest z's missing batch: the unicast stream -----------
                b_z = needed_batch(g, ct, q)
                t_z = int(batch_index(b_z, q))
                pos_z = sender_pos(cu, ct)
                cross_send_pos[s_rack, :, z_rack, rows] = (
                    rank[s_rack, t_z] * M + pos_z * sh + off)
                cross_recv_pos[z_rack, :, s_rack, rows] = (
                    t_z * M + pos_z * sh + off)
                cross_valid[z_rack, s_rack, rows] = True
                # --- coded packet components (identical for every dest in
                # the group: a true multicast payload) ----------------------
                comp_classes = [t for t in range(r) if t != cu]
                for c, t_cls in enumerate(comp_classes):
                    b_t = needed_batch(g, t_cls, q)
                    t_i = int(batch_index(b_t, q))
                    mcast_comp_pos[s_rack, z_rack, rows, c] = (
                        rank[s_rack, t_i] * M
                        + sender_pos(cu, t_cls) * sh + off)
                    mcast_comp_rack[s_rack, z_rack, rows, c] = (
                        t_cls * q + g[t_cls])
                # --- receiver side information: components for the other
                # members, all batches the receiver itself maps ------------
                known_classes = [t for t in range(r) if t not in (cu, ct)]
                for c, t_cls in enumerate(known_classes):
                    b_t = needed_batch(g, t_cls, q)
                    t_i = int(batch_index(b_t, q))
                    mcast_known_pos[z_rack, s_rack, rows, c] = (
                        rank[z_rack, t_i] * M
                        + sender_pos(cu, t_cls) * sh + off)
                    mcast_known_rack[z_rack, s_rack, rows, c] = (
                        t_cls * q + g[t_cls])

    return HybridShufflePlan(p, local_subfiles, cross_send_pos, layer_table,
                             cross_recv_pos, local_mask, n_send, local_pos,
                             mcast_comp_pos, mcast_comp_rack,
                             mcast_known_pos, mcast_known_rack,
                             family="resolvable", cross_valid=cross_valid)
