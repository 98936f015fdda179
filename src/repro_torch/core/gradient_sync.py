"""Gradient aggregation with Hybrid-Coded-MapReduce structure, over a
:class:`repro_torch.distributed.meshes.ProcessMesh`: the counterpart of
``repro/core/gradient_sync.py``.

The paper's map-replication + two-stage shuffle maps onto data-parallel
gradient synchronization as follows (racks = slow-tier groups, e.g. pods
of cards; servers = cards):

  * map task            = computing one microbatch-chunk's gradient
  * replication r = 2   = every chunk {a, b} is computed by racks a AND b
  * cross-rack stage    = coded reduce-scatter over the slow axis: each rack
    pre-sums the chunks it *owns* (unique owner per chunk), omitting chunks
    the destination already has — delivering the receive-side optimum
    G * (1 - r/P) cross-rack bytes per rack instead of uncoded G * (1 - 1/P)
  * intra-rack stage    = ordinary fast-axis reduce-scatter / all-gather

Because gradient aggregation is SUM-reducible, the linear-combining function
f(.) of the paper is realized *natively on the wire* (partial sums), and the
same replication yields STRAGGLER TOLERANCE: any single rack's chunks are
recoverable from its pair partners (:func:`coded_reduce_scatter_r2` with
``failed``).

Where the JAX functions name an axis of the enclosing ``shard_map``, these
take the mesh and the axis name.  The trainer's data-parallel modes
(:mod:`repro_torch.train.trainer`) take the batch layouts of
:func:`batch_pspec`.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from ..distributed.collectives import (all_to_all, hierarchical_psum,
                                       psum_scatter)
from ..distributed.meshes import ProcessMesh

COMBINE_IMPLS = ("torch", "kernel")


def hierarchical_allreduce(x: torch.Tensor, mesh: ProcessMesh,
                           fast_axis: str, slow_axis: str,
                           scatter_dim: int = 0) -> torch.Tensor:
    """Two-stage all-reduce: intra-rack reduce-scatter (fast links), cross-rack
    all-reduce on 1/Kr-sized shards (slow links, all layers in parallel —
    the paper's per-layer decomposition of the cross-rack stage), intra-rack
    all-gather.  Mathematically identical to psum over both axes."""
    return hierarchical_psum(x, mesh, fast_axis, slow_axis, scatter_dim)


def _chunk_pairs(P_: int) -> list[tuple[int, int]]:
    return [(a, b) for a in range(P_) for b in range(a + 1, P_)]


def chunk_index_table(P_: int) -> np.ndarray:
    """T[a] = indices (into the pair list) of chunks containing rack a, in
    ascending partner order; shape [P, P-1]."""
    pairs = _chunk_pairs(P_)
    out = np.zeros((P_, P_ - 1), dtype=np.int64)
    for a in range(P_):
        out[a] = [i for i, pr in enumerate(pairs) if a in pr]
    return out


def _partners_matrix(P_: int) -> np.ndarray:
    pairs = _chunk_pairs(P_)
    out = np.zeros((P_, P_ - 1), dtype=np.int64)
    for a in range(P_):
        out[a] = [pr[0] if pr[1] == a else pr[1]
                  for pr in pairs if a in pr]
    return out


def batch_chunk_for_rack(batch: Union[np.ndarray, torch.Tensor], P_: int,
                         rack: int) -> list:
    """Split a global batch into C(P,2) chunks and return the P-1 chunks that
    rack `rack` must map (replication r=2).  Host-side helper for the data
    pipeline; a tensor is split as ``np.array_split`` splits an array."""
    pairs = _chunk_pairs(P_)
    n = len(pairs)
    chunks = (torch.tensor_split(batch, n) if isinstance(batch, torch.Tensor)
              else np.array_split(np.asarray(batch), n))
    return [chunks[i] for i, pr in enumerate(pairs) if rack in pr]


def coded_reduce_scatter_r2(chunk_grads: torch.Tensor, mesh: ProcessMesh,
                            axis: str, P_: int,
                            failed: Optional[int] = None,
                            combine_impl: str = "torch") -> torch.Tensor:
    """Cross-rack stage of hybrid-coded gradient sync (r = 2).

    chunk_grads: [P-1, G] — this rack's per-chunk gradient partials, rows
      ordered by ascending partner rack (see :func:`chunk_index_table`).
      G must be divisible by P.
    Returns [G/P]: this rack's shard of the TOTAL gradient sum over all
      C(P,2) chunks (each chunk counted exactly once).

    Cross-rack bytes per rack: (P-1) * (P-2)/(P-1) * G/P = G (1 - 2/P),
    the receive-side optimum with r = 2 — vs uncoded G (1 - 1/P).

    ``failed``: id of a straggling/failed rack whose transmissions are lost.
    Ownership of its chunks transparently falls back to the partner rack, so
    the result is STILL the exact full-batch gradient (r=2 erasure tolerance).
    The failed rack's own return value is garbage; survivors are exact.

    ``combine_impl``: implementation of the per-destination linear combining
    f(.) that builds each send block — ``'torch'`` (a 0/1-weighted sum) or
    ``'kernel'`` (the ``coded_encode`` kernel of
    :mod:`repro_torch.kernels.coded_combine`, one launch per destination;
    its plain version on a CPU tensor).
    """
    if combine_impl not in COMBINE_IMPLS:
        raise ValueError(f"combine_impl must be one of {COMBINE_IMPLS}, "
                         f"got {combine_impl!r}")
    me = mesh.axis_index(axis)
    G = chunk_grads.shape[-1]
    if chunk_grads.shape != (P_ - 1, G) or G % P_:
        raise ValueError(f"chunk_grads must be [P-1={P_ - 1}, G] with P | "
                         f"G; got {tuple(chunk_grads.shape)}")
    shard = G // P_
    part = _partners_matrix(P_)[me]             # [P-1] partner rack per chunk
    # ownership: chunk {a,b} owned by min(a,b); if owner failed, partner owns
    own = part > me
    if failed is not None:
        own = np.where(part == failed, me != failed, own)
        own = np.where(me == failed, False, own)

    # send buffer: for each destination z, sum of my OWNED chunks not
    # containing z, restricted to z's shard — the paper's f(.) with 0/1
    # coefficients (a partial sum the destination cannot form itself).
    x = chunk_grads.reshape(P_ - 1, P_, shard)  # split into shards
    sel = [torch.as_tensor((own & (part != z)).astype(np.float32),
                           device=x.device) for z in range(P_)]
    if combine_impl == "kernel":
        from ..kernels.coded_combine import ops as cc_ops
        # coefficients vary per destination: one encode per destination
        sends = torch.stack([cc_ops.coded_encode(x[:, z], sel[z], block_t=8)
                             for z in range(P_)])           # [P, shard]
    else:
        sends = torch.stack([torch.einsum("c,cs->s", sel[z].to(x.dtype),
                                          x[:, z]) for z in range(P_)])
    recvd = all_to_all(sends, mesh, axis)                   # [P, shard]
    if failed is not None:
        keep = (torch.arange(P_, device=x.device) != failed).to(recvd.dtype)
        recvd = recvd * keep[:, None]
    far = recvd.sum(dim=0) - recvd[me]                      # exclude self
    # local part: ALL chunks containing me, each counted once (I am in them)
    local = x.sum(dim=0)[me]
    return far + local


def uncoded_reduce_scatter(grad: torch.Tensor, mesh: ProcessMesh, axis: str,
                           P_: int) -> torch.Tensor:
    """Baseline: plain reduce-scatter of a full local gradient [G] -> [G/P]."""
    return psum_scatter(grad, mesh, axis)


# ---------------------------------------------------------------------------
# Batch layouts of the data-parallel modes (the JAX package's pjit-level
# policies, over the port's ('rack', 'server') process mesh: its 'pod' is
# the port's 'rack', its 'data' the port's 'server')
# ---------------------------------------------------------------------------

DP_MODES = ("dp_flat", "dp_hybrid_r2")


def batch_pspec(mode: str, multi_pod: bool) -> Tuple[str, ...]:
    """The mesh axes the token batch's leading dim is split over, in
    order, under a DP sync mode (replicated over the others).

    dp_flat      — split over every data-parallel axis.
    dp_hybrid_r2 — replicated over 'rack' (the paper's map replication with
                   r = P: every rack maps every chunk => zero cross-rack
                   shuffle), split over 'server' only.
    """
    if mode not in DP_MODES:
        raise ValueError(f"unknown DP mode {mode}")
    if not multi_pod:
        return ("server",)
    return ("rack", "server") if mode == "dp_flat" else ("server",)


def grad_sync_cost(G_bytes: float, P_: int, r: int, mode: str) -> dict:
    """Analytic slow-tier byte cost per rack of one gradient sync (for the
    roofline's collective term).  Receive-side accounting, point-to-point
    links."""
    if mode == "uncoded":
        rs = G_bytes * (1 - 1 / P_)
    elif mode == "coded_r":
        rs = G_bytes * (1 - r / P_)
    elif mode == "full_replication":
        rs = 0.0
    else:
        raise ValueError(mode)
    return {"cross_rack_bytes_per_rack": rs,
            "map_flops_multiplier": {"uncoded": 1, "coded_r": r,
                                     "full_replication": P_}[mode]}


__all__ = ["hierarchical_allreduce", "chunk_index_table",
           "batch_chunk_for_rack", "coded_reduce_scatter_r2",
           "uncoded_reduce_scatter", "DP_MODES", "batch_pspec",
           "grad_sync_cost"]
