"""The concrete MapReduce jobs of ``repro/mapreduce/jobs.py`` in PyTorch.

Each ``map_fn`` is batched over a leading subfile axis ([B, ...] ->
[B, Q, d]); each ``reduce_fn`` reduces the subfile axis, the second to last
([..., N, d] -> [..., d_out]).
"""
from __future__ import annotations

import torch

from .engine import MapReduceJob


def _uint32_mod(x: torch.Tensor, Q: int) -> torch.Tensor:
    """``x.astype(uint32) % Q`` as the JAX jobs compute it, as int64:
    integers wrap modulo 2^32 (negative int32 tokens bucket by their
    unsigned bits); floats truncate toward zero and saturate to
    [0, 2^32 - 1], NaN to 0 (XLA's float -> uint32 conversion)."""
    if x.is_floating_point():
        u = torch.nan_to_num(x.double(), nan=0.0).clamp(0, 2 ** 32 - 1)
        return u.to(torch.int64) % Q
    return (x.to(torch.int64) & 0xFFFFFFFF) % Q


def _flat_bins(bucket: torch.Tensor, Q: int) -> torch.Tensor:
    """[B, n] per-subfile bins -> flat indices into a [B * Q] table."""
    B = bucket.shape[0]
    offs = torch.arange(B, device=bucket.device).view(B, *[1] * (
        bucket.dim() - 1)) * Q
    return (bucket + offs).reshape(-1)


def _counts(bucket: torch.Tensor, Q: int) -> torch.Tensor:
    """[B, n] bins -> [B, Q] int64 occurrence counts."""
    B = bucket.shape[0]
    return torch.bincount(_flat_bins(bucket, Q), minlength=B * Q).view(B, Q)


def histogram_job(vocab_hash_mod: int = 2**16) -> MapReduceJob:
    """WordCount-style: subfile = int32 token array; key = token bucket;
    value = occurrence count in the subfile.  Reduce = total count."""
    def map_fn(tokens: torch.Tensor, Q: int) -> torch.Tensor:   # [B, n]
        counts = _counts(_uint32_mod(tokens, Q), Q)
        return counts[..., None].to(torch.float32)              # [B, Q, 1]

    def reduce_fn(vals: torch.Tensor) -> torch.Tensor:          # [..., N, 1]
        return vals.sum(dim=-2)

    return MapReduceJob("histogram", 1, map_fn, reduce_fn)


def groupby_mean_job() -> MapReduceJob:
    """Group-by-key mean: subfile = [n, 2] (key_src, value) rows; emits
    per-bucket (sum, count); reduce = global mean per bucket."""
    def map_fn(rows: torch.Tensor, Q: int) -> torch.Tensor:     # [B, n, 2]
        B = rows.shape[0]
        flat = _flat_bins(_uint32_mod(rows[..., 0], Q), Q)
        vals = rows[..., 1].to(torch.float32).reshape(-1)
        s = torch.zeros(B * Q, dtype=torch.float32, device=rows.device)
        s.index_add_(0, flat, vals)
        c = torch.bincount(flat, minlength=B * Q).to(torch.float32)
        return torch.stack([s.view(B, Q), c.view(B, Q)], dim=-1)  # [B, Q, 2]

    def reduce_fn(vals: torch.Tensor) -> torch.Tensor:          # [..., N, 2]
        s, c = vals[..., 0].sum(dim=-1), vals[..., 1].sum(dim=-1)
        return torch.stack([s / torch.clamp(c, min=1.0), c], dim=-1)

    return MapReduceJob("groupby_mean", 2, map_fn, reduce_fn)


def wide_histogram_job(d: int) -> MapReduceJob:
    """Histogram with a width-d payload per (key, subfile): counts scaled by
    a fixed integer weight vector.  Integer-valued float32 throughout, so
    every execution path (including coded multicast encode/decode) is
    bit-exact — the shuffle-bound workload."""
    def map_fn(tokens: torch.Tensor, Q: int) -> torch.Tensor:   # [B, n]
        counts = _counts(_uint32_mod(tokens, Q), Q).to(torch.float32)
        w = (torch.arange(d, dtype=torch.float32, device=tokens.device)
             % 7.0) + 1.0
        return counts[..., None] * w                            # [B, Q, d]

    def reduce_fn(vals: torch.Tensor) -> torch.Tensor:          # [..., N, d]
        return vals.sum(dim=-2)

    return MapReduceJob(f"wide_histogram_d{d}", d, map_fn, reduce_fn)


def terasort_bucket_job(key_space: int = 2**20,
                        payload_quantiles: int = 8) -> MapReduceJob:
    """TeraSort bucketing phase: each reducer owns a contiguous key range;
    mappers emit, per range, the count, sum, min and max of their records
    landing in it (zero-padded to ``payload_quantiles`` columns).

    The bucket edges come from ``torch.linspace`` in float32; with Q and
    ``key_space`` powers of two they are exact and equal the JAX job's
    ``jnp.linspace`` edges."""
    def map_fn(records: torch.Tensor, Q: int) -> torch.Tensor:  # [B, n]
        B = records.shape[0]
        rec = records.to(torch.float32).contiguous()
        edges = torch.linspace(0.0, float(key_space), Q + 1,
                               dtype=torch.float32, device=rec.device)
        bucket = torch.clamp(
            torch.searchsorted(edges, rec, right=True) - 1, 0, Q - 1)
        flat = _flat_bins(bucket, Q)
        vals = rec.reshape(-1)

        def scatter(fill, **how):
            t = torch.full((B * Q,), fill, dtype=torch.float32,
                           device=rec.device)
            return t.scatter_reduce_(0, flat, vals, include_self=True, **how)

        counts = torch.bincount(flat, minlength=B * Q).to(torch.float32)
        sums = torch.zeros(B * Q, dtype=torch.float32,
                           device=rec.device).index_add_(0, flat, vals)
        mins = scatter(float("inf"), reduce="amin")
        maxs = scatter(float("-inf"), reduce="amax")
        feats = [counts, sums,
                 torch.where(torch.isfinite(mins), mins, 0.0),
                 torch.where(torch.isfinite(maxs), maxs, 0.0)]
        feats += [counts * 0.0] * max(payload_quantiles - len(feats), 0)
        out = torch.stack(feats[:payload_quantiles], dim=-1)    # [B*Q, pq]
        return out.view(B, Q, -1)

    def reduce_fn(vals: torch.Tensor) -> torch.Tensor:          # [..., N, pq]
        return torch.stack([vals[..., 0].sum(dim=-1),
                            vals[..., 1].sum(dim=-1),
                            vals[..., 2].amin(dim=-1),
                            vals[..., 3].amax(dim=-1)], dim=-1)

    return MapReduceJob("terasort_bucket", payload_quantiles, map_fn,
                        reduce_fn)
