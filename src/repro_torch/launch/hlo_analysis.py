"""Roofline terms of a dry-run cell: the port's ``repro/launch/
hlo_analysis.py``.

The JAX package reads a compiled program: compute and memory from
``compiled.cost_analysis()``, collectives by parsing the HLO text.  The
port has no compiled program.  Its dry run (:mod:`.dryrun`) runs the step
on ``meta`` tensors and counts: ``FlopCounterMode`` for ATen's products,
the kernels' own reports (:func:`repro_torch.kernels._card.record_work`),
and the collectives each rank issues
(:func:`repro_torch.distributed.collectives.record_collectives`), which
stand in for the HLO text.  So ``_COLL_RE``, ``_SHAPE_RE``,
``_shapes_bytes``, ``_parse_groups`` and ``parse_collectives`` have no
counterpart here: :func:`collective_ops` reads the records instead.

Each collective gets the ring algorithm's wire bytes per participating
device (:func:`_wire_bytes`):

    all-gather        out_bytes * (n-1)/n      (sends its shard n-1 times)
    reduce-scatter    out_bytes * (n-1)        (= in_bytes * (n-1)/n)
    all-reduce        2 * in_bytes * (n-1)/n   (RS + AG)
    all-to-all        in_bytes * (n-1)/n
    collective-permute  in_bytes

The port issues only all-to-all and all-gather: its ``psum`` is an
all-to-all of its input and an all-gather of the summed 1/n block, 2
(n-1)/n in_bytes on the wire, an all-reduce's.  Each group is INTRA-POD
(its ranks all in one pod, ``rank // pod_size``) or CROSS-POD; a
cross-pod group's ring crosses pods at (p-1) of its n-1 hops.  The keys
keep the JAX package's names: ``ici`` is the pod's tier, ``dcn`` the tier
between pods.

Hardware model (:data:`HW`): NVIDIA H100 80GB HBM3 (SXM) at its 700 W
limit, from NVIDIA's data sheet (dense rates): HBM 3.35e12 B/s; tensor
cores 989e12 FLOP/s in bf16 and 495e12 in TF32; 67e12 fp32 FLOP/s on the
CUDA cores, the rate of the port's fp32 products, which run with TF32 off;
HBM capacity as ``torch.cuda.get_device_properties(0).total_memory``
reads it on that card.  The pod tier is NVLink 4, 450e9 B/s a direction
per GPU; the tier between pods one NDR InfiniBand port, 400 Gb/s = 50e9
B/s a direction per GPU.  A 16 x 16 pod spans 32 NVLink domains of 8 GPUs,
so pricing every intra-pod byte at NVLink's rate is the best case.
:func:`roofline_terms` prices every FLOP at the bf16 tensor-core rate, as
the JAX package's does.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np

HW = {
    "name": "NVIDIA H100 80GB HBM3",
    "power_limit_w": 700.0,
    "peak_flops_bf16": 989e12,
    "peak_flops_tf32": 495e12,
    "peak_flops_fp32": 67e12,
    "hbm_bw": 3.35e12,
    "ici_bw": 450e9,
    "dcn_bw": 50e9,
    "hbm_bytes": 85_017_493_504,
}


@dataclasses.dataclass
class CollectiveOp:
    kind: str
    bytes_wire: float          # per participating device
    group_size: int
    cross_pod: bool
    line: str                  # the record, as one line of text


def _wire_bytes(kind: str, shapes: List[int], n: int) -> float:
    if not shapes or n <= 1:
        return 0.0
    total = sum(shapes)
    big = max(shapes)
    if kind.startswith("all-gather"):
        # tuple form of -start includes (in, out); out is the largest
        return big * (n - 1) / n
    if kind.startswith("all-reduce"):
        return 2.0 * big * (n - 1) / n
    if kind == "reduce-scatter":
        return big * (n - 1)          # output (scattered) shape parsed
    if kind == "all-to-all":
        return total * (n - 1) / n
    if kind.startswith("collective-permute"):
        return big
    return 0.0


def collective_ops(records: Sequence, pod_size: int) -> List[CollectiveOp]:
    """One :class:`CollectiveOp` a record (a
    :class:`~repro_torch.distributed.collectives.CollectiveRecord`): its
    result's bytes priced on the ring of its group."""
    ops: List[CollectiveOp] = []
    for rec in records:
        n = len(rec.ranks)
        cross = len({r // pod_size for r in rec.ranks}) > 1
        line = (f"{rec.fn}: {rec.kind} {rec.in_bytes} -> {rec.out_bytes} "
                f"bytes over ranks {list(rec.ranks[:4])}"
                f"{'...' if n > 4 else ''} ({n})")
        ops.append(CollectiveOp(rec.kind,
                                _wire_bytes(rec.kind, [rec.out_bytes], n),
                                n, cross, line))
    return ops


def collective_summary(records: Sequence, pod_size: int) -> Dict[str, float]:
    """Per-device wire bytes, split by tier.  For a cross-pod group of size
    n spanning p pods, the portion between pods is modeled as the
    pod-boundary hops of the ring: fraction (p-1)/(n-1) of the wire bytes
    crosses pods, the rest stays in the pod.  ``per_fn`` splits the wire
    bytes by the function that issued them."""
    ops = collective_ops(records, pod_size)
    out = {"ici_bytes": 0.0, "dcn_bytes": 0.0, "n_ops": len(ops),
           "n_cross_pod_ops": 0}
    per_kind: Dict[str, float] = {}
    per_fn: Dict[str, float] = {}
    for rec, op in zip(records, ops):
        per_kind[op.kind] = per_kind.get(op.kind, 0.0) + op.bytes_wire
        per_fn[rec.fn] = per_fn.get(rec.fn, 0.0) + op.bytes_wire
        if op.cross_pod:
            out["n_cross_pod_ops"] += 1
            n = op.group_size
            p = max(2, int(np.ceil(n / pod_size)) if pod_size else 2)
            dcn_frac = (p - 1) / max(n - 1, 1)
            out["dcn_bytes"] += op.bytes_wire * dcn_frac
            out["ici_bytes"] += op.bytes_wire * (1 - dcn_frac)
        else:
            out["ici_bytes"] += op.bytes_wire
    out["per_kind"] = per_kind
    out["per_fn"] = per_fn
    return out


def roofline_terms(flops_per_dev: float, bytes_per_dev: float,
                   ici_bytes: float, dcn_bytes: float,
                   hw: Dict = HW) -> Dict[str, float]:
    """The three roofline terms (seconds) + dominant classification."""
    t_compute = flops_per_dev / hw["peak_flops_bf16"]
    t_memory = bytes_per_dev / hw["hbm_bw"]
    t_ici = ici_bytes / hw["ici_bw"]
    t_dcn = dcn_bytes / hw["dcn_bw"]
    t_coll = t_ici + t_dcn
    terms = {"t_compute": t_compute, "t_memory": t_memory,
             "t_collective": t_coll, "t_ici": t_ici, "t_dcn": t_dcn}
    dom = max(("compute", t_compute), ("memory", t_memory),
              ("collective", t_coll), key=lambda kv: kv[1])
    terms["dominant"] = dom[0]
    terms["t_bound"] = dom[1]
    # roofline fraction: useful-compute time over the bound (perfect overlap
    # model: step time >= max(terms); fraction = t_compute / t_bound)
    terms["roofline_fraction"] = (t_compute / dom[1]) if dom[1] > 0 else 0.0
    return terms


# ---------------------------------------------------------------------------
# (L, S) polynomial cost fitting — see launch/dryrun.py
# ---------------------------------------------------------------------------

def fit_cost_poly(points: List[Tuple[int, int, float]],
                  ) -> Dict[str, float]:
    """Fit cost(L, S) = a + b L + (c + d L) S + (e + f L) S^2 through >= 6
    (L, S, cost) points (least squares; exact when cost is truly polynomial).
    Returns the coefficient dict."""
    A = np.array([[1, L, S, L * S, S * S, L * S * S]
                  for (L, S, _) in points], dtype=np.float64)
    y = np.array([c for (_, _, c) in points], dtype=np.float64)
    coef, *_ = np.linalg.lstsq(A, y, rcond=None)
    return dict(zip("abcdef", coef.tolist()))


def eval_cost_poly(coef: Dict[str, float], L: int, S: int) -> float:
    return (coef["a"] + coef["b"] * L + coef["c"] * S + coef["d"] * L * S
            + coef["e"] * S * S + coef["f"] * L * S * S)
