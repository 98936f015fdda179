"""Multi-pod dry run of the port: run every (architecture x shape x mesh)
cell's production step on ``meta`` tensors, as rank 0 of the production
mesh's world over a fake process group, and extract the roofline terms
(the port's ``repro/launch/dryrun.py``).

The JAX package lowers its step on 512 fake XLA host devices; the port
runs its own on shapes alone.  Each cell runs as rank 0 of a world of 256
(``single``: data 16 x model 16) or 512 (``multi``: pod 2 x data 16 x
model 16) ranks on ``torch.distributed``'s fake process group, whose
collectives move nothing, under :func:`repro_torch.kernels._card.dry_run`,
so the models and the kernel ops take the card's branches on ``meta``
tensors: each kernel op picks the route the card would take, allocates
what its launch allocates and launches nothing (``DRY_CALLS``).

1. **Fit run** — the REAL production step at the FULL configuration
   (``make_train_step`` under the cell's sharding policy, with
   ``tensor_parallel.init_shard_params`` and ``init_opt_state``; or
   ``prefill`` / ``decode_step``), under :class:`MemoryTracker`, the
   counterpart of ``memory_analysis()``: the bytes of every storage from
   the op that first returns it until it is freed, in the card's caching
   allocator's 512-byte granules.  Success proves that the cell's layout
   runs; the peak says whether it fits the card (``fits_hbm``).  A cell
   whose layout the port does not run yet raises through
   ``tensor_parallel``'s ``_todo`` and is recorded ``ok: false`` with its
   text, as the JAX dry run records a failed compile.

2. **Cost runs** — the same step on a reduced (depth, sequence) grid.
   Each is counted exactly: ``FlopCounterMode`` for ATen's products, the
   kernels' own reports for theirs (the formulas of their bounds), the
   bytes every ATen op reads and writes plus the kernels' reported bytes
   (no fusion: an upper bound, as XLA's ``bytes accessed``), and the
   collectives rank 0 issues (:mod:`.hlo_analysis`).  Costs are
   polynomials in depth and S, fitted by :func:`_fit_poly` through the
   grid and evaluated at the full size.  Nothing here needs an unrolled
   program: the port's layers already run in a Python loop.

The analytic capacity and traffic models (:func:`analytic_peak_bytes`,
:func:`analytic_memory_bytes`) are the JAX package's, on the port's
specs; the roofline's memory term reads the traffic model.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh single multi \\
      [--arch qwen2-1.5b ...] [--shape train_4k ...] [--force]
Results are cached per cell in results/dryrun_torch/<mesh>/<arch>__<shape>
.json.  A cell whose layout raises a ``_todo`` prints TODO; any other
failure prints FAIL and makes the command exit non-zero.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback
import weakref
from math import prod
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves as pytree_leaves

from ..configs import ARCHS
from ..configs.base import ArchConfig, SHAPES, ShapeConfig, cell_is_runnable
from ..distributed import sharding as shlib
from ..distributed import tensor_parallel as tpl
from ..distributed.collectives import record_collectives
from ..distributed.sharding import tree_local_bytes
from ..kernels import _card
from ..models import lm
from ..models.frontends import train_batch_specs
from ..train.optimizer import (OptimizerConfig, init_opt_state,
                               optimizer_update)
from ..train.trainer import TrainConfig, _policy_grads, make_train_step
from . import hlo_analysis as hlo
from .mesh import make_mesh_by_kind, mesh_shape_by_kind, pod_size

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "dryrun_torch")

BIG_ARCHS = {"llama3-405b", "grok-1-314b", "qwen2-72b", "llava-next-34b"}
# the per-device costs fitted over the (depth, S) grid: FLOPs, bytes
# accessed, wire bytes in the pod and between pods, and the wire bytes of
# the psums (all-gathers of n times their input)
COST_KEYS = ("flops", "bytes", "ici", "dcn", "psum_wire")
P = shlib.P


# ---------------------------------------------------------------------------
# Per-cell plan
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CellPlan:
    arch: str
    shape: str
    mesh_kind: str
    n_micro: int
    remat_blocks: int
    fsdp: bool
    dtype: Any = torch.bfloat16
    s_points: Tuple[int, ...] = ()
    dp_mode: str = "dp"                  # dp | replicated (pod axis use)
    seq_tp: bool = False                 # Megatron sequence parallelism
    tp2d: bool = False                   # 2D-TP serving (hillclimb variant)
    moe_groups: int = 16                 # sort-dispatch groups == dp size

    @property
    def cfg(self) -> ArchConfig:
        return ARCHS[self.arch]

    @property
    def shape_cfg(self) -> ShapeConfig:
        for s in SHAPES:
            if s.name == self.shape:
                return s
        raise KeyError(self.shape)


def _best_blocks(n: int) -> int:
    """Divisor of n closest to sqrt(n) (2-level remat block count)."""
    best = 1
    for d in range(1, n + 1):
        if n % d == 0 and abs(d - n ** 0.5) < abs(best - n ** 0.5):
            best = d
    return best


def make_plan(arch: str, shape: str, mesh_kind: str,
              dp_mode: str = "dp") -> CellPlan:
    cfg = ARCHS[arch]
    sh = [s for s in SHAPES if s.name == shape][0]
    multi = mesh_kind != "single"
    dp = (2 if (multi and dp_mode == "dp") else 1) * 16   # pod x data
    big = arch in BIG_ARCHS

    if sh.kind == "train":
        rows_per_dev = max(sh.global_batch // dp, 1)
        tokens_per_dev = rows_per_dev * sh.seq_len
        n_micro = 1
        while (tokens_per_dev // n_micro > 4096 and n_micro < rows_per_dev
               and sh.global_batch % (2 * n_micro) == 0):
            n_micro *= 2
        remat_blocks = _best_blocks(cfg.n_layers
                                    - (cfg.moe.first_dense_layers
                                       if cfg.moe else 0))
    else:
        n_micro, remat_blocks = 1, 1

    if cfg.frontend == "vision":
        base = cfg.n_frontend_tokens
        s_points = (base + 256, base + 512, base + 1024)
    elif sh.kind == "train":
        s_points = (512, 1024, 2048)
    elif sh.kind == "prefill":
        s_points = (1024, 2048, 4096)
    else:                                 # decode: S = cache depth
        s_points = (1024, 2048, 4096)
    # FSDP (ZeRO-3) only where params+optimizer cannot fit replicated-
    # over-data; small models keep params on 'model' only (no per-micro
    # re-gather traffic).  Sequence-TP on big train cells (bytes-neutral,
    # divides boundary HBM by the TP degree).
    return CellPlan(arch, shape, mesh_kind, n_micro, remat_blocks,
                    fsdp=big, s_points=s_points, dp_mode=dp_mode,
                    seq_tp=big and sh.kind == "train",
                    moe_groups=dp)   # groups must tile the dp axes


# ---------------------------------------------------------------------------
# Depth grid
# ---------------------------------------------------------------------------

def _with_depth(cfg: ArchConfig, depths: Tuple[int, ...]) -> ArchConfig:
    """depths per varying stack: (main,) or (main, enc) for encdec.
    For MoE with leading dense layers, 'main' counts only the MoE stack."""
    fd = cfg.moe.first_dense_layers if cfg.moe else 0
    kw: Dict[str, Any] = {"n_layers": depths[0] + fd}
    if cfg.family == "encdec":
        kw["encoder_layers"] = depths[1]
    return dataclasses.replace(cfg, **kw)


def depth_grid(cfg: ArchConfig) -> Tuple[List[Tuple[int, ...]],
                                         Tuple[int, ...]]:
    """(depth combos to run, target depth vector)."""
    fd = cfg.moe.first_dense_layers if cfg.moe else 0
    if cfg.family == "encdec":
        combos = [(1, 1), (2, 1), (1, 2)]
        target = (cfg.n_layers, cfg.encoder_layers)
    else:
        combos = [(1,), (2,)]
        target = (cfg.n_layers - fd,)
    return combos, target


def _fit_poly(points: List[Tuple[Tuple[int, ...], int, float]]) -> Dict:
    """Occam fit of cost = (1, depths) (x) S-basis.

    Tries S-bases of increasing order (const, linear, quadratic); keeps
    the SIMPLEST one whose relative residual on the grid points is
    < 0.1%.  This matters for costs with no real S dependence (ring-cache
    / state-space decode): blindly fitting S^2 to constant-in-S data and
    extrapolating x1e5 amplifies lstsq noise into garbage."""
    scale = max((abs(c) for (_, _, c) in points), default=1.0) or 1.0
    for order in (0, 1, 2):
        rows, y = [], []
        for depths, S, c in points:
            dvec = [1.0] + [float(d) for d in depths]
            svec = [float(S) ** k for k in range(order + 1)]
            rows.append(np.outer(dvec, svec).ravel())
            y.append(c / scale)
        A = np.array(rows)
        coef, *_ = np.linalg.lstsq(A, np.array(y), rcond=None)
        resid = np.abs(A @ coef - y).max()
        if resid < 1e-3 or order == 2:
            return {"coef": coef, "order": order, "scale": scale,
                    "resid": float(resid)}
    raise AssertionError("unreachable")


def _eval_poly(fit: Dict, depths: Tuple[int, ...], S: int) -> float:
    dvec = [1.0] + [float(d) for d in depths]
    svec = [float(S) ** k for k in range(fit["order"] + 1)]
    val = float(np.outer(dvec, svec).ravel() @ fit["coef"]) * fit["scale"]
    return max(val, 0.0)


# ---------------------------------------------------------------------------
# Policies, shapes, specs
# ---------------------------------------------------------------------------

def _policy(plan: CellPlan, mesh) -> shlib.ShardingPolicy:
    if plan.tp2d:
        rules = shlib.serve_tp2d_rules(multi_pod=(plan.mesh_kind
                                                  != "single"))
        return shlib.ShardingPolicy(mesh, rules)
    rules = shlib.default_rules(multi_pod=(plan.mesh_kind != "single"),
                                dp_mode=("dp_flat" if plan.dp_mode == "dp"
                                         else "dp_hybrid"),
                                fsdp=plan.fsdp)
    if plan.seq_tp:
        rules = shlib.with_sequence_tp(rules)
    return shlib.ShardingPolicy(mesh, rules)


def _param_shapes(cfg: ArchConfig, dtype) -> Dict:
    return lm.init_params(0, cfg, dtype, device="meta")


def _stacked_specs(params: Any, pspec: Any) -> Tuple[Any, Any]:
    """(leaf shapes, specs) with each layer stack as the JAX package's
    stacked ``[L, ...]`` leaves (an Adafactor state's layout): a stack's
    spec is its layers' :class:`~repro_torch.distributed.sharding.
    LayerSpec` with the ``layers`` entry put back in front."""
    if isinstance(params, dict):
        pairs = {k: _stacked_specs(params[k], pspec[k]) for k in params}
        return ({k: v[0] for k, v in pairs.items()},
                {k: v[1] for k, v in pairs.items()})
    if isinstance(params, list):
        def stack(leaves, specs):
            if isinstance(leaves[0], dict):
                pairs = {k: stack([x[k] for x in leaves],
                                  [s[k] for s in specs]) for k in leaves[0]}
                return ({k: v[0] for k, v in pairs.items()},
                        {k: v[1] for k, v in pairs.items()})
            s0 = specs[0]
            return ((len(leaves),) + tuple(leaves[0].shape),
                    P(getattr(s0, "layers", None), *s0))
        return stack(params, pspec)
    return tuple(params.shape), pspec


def _opt_pspecs(params: Any, pspec: Any, opt_cfg) -> Dict:
    """Sharding specs for the optimizer state tree.

    adamw: moments mirror the parameter specs.  adafactor: the factored
    moments drop the factored dim's axis from the parameter spec (of the
    stacked leaf, as the state is stacked)."""
    if opt_cfg.kind == "adamw":
        return {"m": pspec, "v": pspec, "count": P()}
    shapes, specs = _stacked_specs(params, pspec)

    def fac_spec(shape, s):
        parts = list(s) + [None] * (len(shape) - len(s))
        if len(shape) >= 2:
            return {"vr": P(*parts[:-1]), "vc": P(*(parts[:-2] + parts[-1:]))}
        return {"v": P(*parts)}

    def walk(sh, sp):
        if isinstance(sh, dict):
            return {k: walk(sh[k], sp[k]) for k in sh}
        return fac_spec(sh, sp)
    return {"m": walk(shapes, specs), "count": P()}


def input_specs(cfg: ArchConfig, shape: ShapeConfig,
                seq_len: Optional[int] = None,
                dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """``meta`` stand-ins for one batch of the cell (no allocation)."""
    S = seq_len or shape.seq_len
    sub = dataclasses.replace(shape, seq_len=S)
    return train_batch_specs(cfg, sub, dtype=dtype)


def _train_tc(plan: CellPlan, cfg: ArchConfig, *, cost_mode: bool,
              ) -> TrainConfig:
    big = plan.arch in BIG_ARCHS
    return TrainConfig(
        n_microbatches=1 if cost_mode else plan.n_micro,
        remat=True,
        remat_blocks=1 if cost_mode else plan.remat_blocks,
        grad_dtype=torch.bfloat16 if big else torch.float32,
        dense_moe=False,
        moe_groups=plan.moe_groups,
        # >=300B plans: Adafactor (factored 2nd moment) — optimizer HBM
        # drops from 2x params to ~0; T5/PaLM production recipe
        opt=OptimizerConfig(kind="adafactor" if big else "adamw",
                            moment_dtype=torch.float32),
    )


# ---------------------------------------------------------------------------
# The fake world, the memory tracker and the cost counters
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def fake_world(world_size: int) -> Iterator[None]:
    """This process as rank 0 of a world of ``world_size`` ranks on
    ``torch.distributed``'s fake process group (collectives move nothing),
    destroyed on the way out.  Refuses to start in a process that already
    has a default process group."""
    if dist.is_initialized():
        raise RuntimeError("the dry run needs a process with no default "
                           "process group; one is initialised")
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


GRANULE = 512           # bytes: the CUDA caching allocator's rounding


def _granules(nbytes: int) -> int:
    return -(-nbytes // GRANULE) * GRANULE


class MemoryTracker(TorchDispatchMode):
    """Live device bytes of a block, the counterpart of XLA's
    ``memory_analysis()``: a storage counts from the op that first returns
    it until it is freed (``weakref.finalize`` on the storage), rounded up
    to the caching allocator's 512-byte granules.  :meth:`start` marks the
    step's start (the bytes live then are its arguments) and resets the
    peak; :meth:`finish` classifies the step's outputs."""

    def __init__(self) -> None:
        super().__init__()
        self.live = self.peak = 0
        self._born = 0
        self._start = 0
        self._sizes: Dict[int, Tuple[int, int]] = {}   # id -> (bytes, born)
        self.argument_bytes = self.output_bytes = self.alias_bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in pytree_leaves(out):
            if isinstance(t, torch.Tensor):
                self._adopt(t)
        return out

    def _adopt(self, t: torch.Tensor) -> None:
        s = t.untyped_storage()
        key = id(s)
        if key in self._sizes:
            return
        n = _granules(s.nbytes())
        self._born += 1
        self._sizes[key] = (n, self._born)
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(s, self._free, key)

    def _free(self, key: int) -> None:
        n, _ = self._sizes.pop(key)
        self.live -= n

    def start(self) -> None:
        self._start = self._born
        self.argument_bytes = self.live
        self.peak = self.live

    def finish(self, outputs: Any) -> None:
        seen = set()
        for t in pytree_leaves(outputs):
            if not isinstance(t, torch.Tensor):
                continue
            s = t.untyped_storage()
            if id(s) in seen or id(s) not in self._sizes:
                continue
            seen.add(id(s))
            n, born = self._sizes[id(s)]
            if born <= self._start:
                self.alias_bytes += n
            self.output_bytes += n

    def summary(self) -> Dict[str, Any]:
        peak = self.peak
        temp = peak - self.argument_bytes - self.output_bytes \
            + self.alias_bytes
        return {"argument_bytes": self.argument_bytes,
                "output_bytes": self.output_bytes,
                "temp_bytes": temp, "alias_bytes": self.alias_bytes,
                "peak_bytes": peak, "peak_gib": peak / 2 ** 30,
                "fits_hbm": bool(peak <= hlo.HW["hbm_bytes"])}


class ByteCounter(TorchDispatchMode):
    """Bytes every ATen op of a block reads and writes (its tensor inputs
    and outputs, views moving nothing): no fusion, an upper bound on the
    traffic, as XLA's ``bytes accessed``."""

    def __init__(self) -> None:
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view:
            for t in pytree_leaves((args, kwargs, out)):
                if isinstance(t, torch.Tensor):
                    self.bytes += t.numel() * t.element_size()
        return out


@contextlib.contextmanager
def count_costs(pod_sz: int) -> Iterator[Dict[str, float]]:
    """The block's per-device costs, filled in on exit: ``flops`` (ATen's
    products plus the kernels' reports), ``bytes`` (every ATen op's
    operands plus the kernels' reported bytes), ``ici`` and ``dcn`` wire
    bytes of the collectives issued, and their count."""
    from torch.utils.flop_counter import FlopCounterMode
    out: Dict[str, float] = {}
    flop_mode = FlopCounterMode(display=False)
    with record_collectives() as records, _card.record_work() as work, \
            flop_mode, ByteCounter() as nbytes:
        yield out
    coll = hlo.collective_summary(records, pod_sz)
    out.update({"flops": float(flop_mode.get_total_flops()) + work.flops,
                "bytes": float(nbytes.bytes) + work.bytes,
                "ici": coll["ici_bytes"], "dcn": coll["dcn_bytes"],
                "n_coll": coll["n_ops"], "n_cross": coll["n_cross_pod_ops"],
                "psum_wire": coll["per_fn"].get("psum", 0.0),
                "kernel_flops": work.flops, "per_fn": coll["per_fn"]})


def _op_modules() -> Dict[str, Any]:
    from ..kernels.coded_combine import ops as cc_ops
    from ..kernels.flash_attention import backward as fab
    from ..kernels.flash_attention import ops as fa
    from ..kernels.rwkv_scan import backward as rwb
    from ..kernels.rwkv_scan import ops as rw
    return {"coded_combine": cc_ops, "flash_attention": fa,
            "flash_attention_backward": fab, "wkv_scan": rw,
            "wkv_scan_backward": rwb}


def dry_calls() -> Dict[str, Dict[str, int]]:
    """Every kernel op's ``DRY_CALLS`` by route (a copy)."""
    return {k: dict(m.DRY_CALLS) for k, m in _op_modules().items()}


def reset_dry_calls() -> None:
    for m in _op_modules().values():
        m.DRY_CALLS.clear()


def predict(build: Callable[[], Any],
            call: Callable[[Any], Any]) -> Dict[str, Any]:
    """The dry run of one call on one card (no mesh, no policy): ``build()``
    makes its arguments (``meta`` tensors), ``call(args)`` runs it.
    Returns its memory (:meth:`MemoryTracker.summary`), per-device costs
    (:func:`count_costs`) and every kernel op's ``DRY_CALLS``: what a card
    run of the same call should show as its peak, its FLOPs (ATen's under
    ``FlopCounterMode`` plus the kernels' reports) and its routes."""
    reset_dry_calls()
    with _card.dry_run(), MemoryTracker() as mem:
        args = build()
        mem.start()
        with count_costs(1) as costs:
            out = call(args)
        mem.finish(out)
        del out
    return {"memory": mem.summary(), "costs": costs,
            "dry_calls": dry_calls()}


# ---------------------------------------------------------------------------
# Analytic HBM-capacity model (the fit verdict's cross-check)
# ---------------------------------------------------------------------------

def _unique_leaves(tree: Any) -> Any:
    """``tree`` without the leaves that view another leaf's storage (MLA's
    cache holds its latent and two views of it)."""
    seen = set()

    def keep(x):
        key = x.untyped_storage()._cdata
        if key in seen:
            return None
        seen.add(key)
        return x

    def walk(t):
        if isinstance(t, dict):
            out = {k: walk(v) for k, v in t.items()}
            return {k: v for k, v in out.items() if v is not None}
        if isinstance(t, list):
            return [walk(v) for v in t]
        return keep(t)
    return walk(tree)


def analytic_peak_bytes(plan: CellPlan, cfg: ArchConfig, sh: ShapeConfig,
                        mesh, pol) -> Dict[str, float]:
    dtb = 2.0
    tp = mesh.shape.get("model", 1)
    dp = prod(mesh.shape.values()) // tp
    params = _param_shapes(cfg, plan.dtype)
    pspec = shlib.param_pspecs(params, pol, fsdp=plan.fsdp)
    p_local = tree_local_bytes(params, pspec, mesh)
    out = {"params": p_local}

    heads_local = max(cfg.n_heads // tp, 1)
    d = cfg.d_model
    ff = cfg.d_ff
    if cfg.moe:
        ff = (cfg.moe.top_k + cfg.moe.n_shared) * cfg.moe.d_ff_expert
    if sh.kind == "train":
        tc = _train_tc(plan, cfg, cost_mode=False)
        opt = init_opt_state(params, tc.opt)
        out["opt"] = tree_local_bytes(opt, _opt_pspecs(params, pspec,
                                                       tc.opt), mesh)
        out["grads"] = p_local * tc.grad_dtype.itemsize / dtb
        micro_tok = sh.global_batch * sh.seq_len / dp / plan.n_micro
        bnd_tok = micro_tok / (tp if plan.seq_tp else 1)
        inner = max((cfg.n_layers - (cfg.moe.first_dense_layers if cfg.moe
                                     else 0)) // plan.remat_blocks, 1)
        n_bnd = plan.remat_blocks + inner + cfg.encoder_layers
        out["boundaries"] = n_bnd * bnd_tok * d * dtb
        # live per-layer workspace during recompute+backward (f32):
        out["workspace"] = micro_tok * (6 * d + 2 * ff / tp
                                        + 512 * heads_local) * 4.0
        out["logits"] = 2 * micro_tok * cfg.vocab_size / tp * 4.0
        out["batch"] = sh.global_batch * sh.seq_len / dp * 8.0
    else:
        cache = _unique_leaves(lm.init_cache(cfg, sh.global_batch,
                                             sh.seq_len, plan.dtype,
                                             device="meta"))
        cspec = shlib.cache_pspecs(pol, cache)
        out["cache"] = tree_local_bytes(cache, cspec, mesh)
        tok = (sh.global_batch * sh.seq_len if sh.kind == "prefill"
               else sh.global_batch)
        tok_local = tok / dp
        out["workspace"] = tok_local * (6 * d + 2 * ff / tp
                                        + 512 * heads_local) * 4.0
        if plan.fsdp:       # per-layer weight gather buffer
            out["gather_buf"] = 2 * p_local * mesh.shape.get("data", 1) \
                / max(cfg.n_layers, 1)
    out["total"] = sum(out.values())
    out["total_gib"] = out["total"] / 2 ** 30
    out["fits_hbm"] = bool(out["total"] <= hlo.HW["hbm_bytes"])
    return out


# ---------------------------------------------------------------------------
# Analytic HBM-traffic model (the roofline memory term)
# ---------------------------------------------------------------------------

def _params_local_bytes(plan: CellPlan, cfg: ArchConfig, mesh) -> float:
    pol = _policy(plan, mesh)
    params = _param_shapes(cfg, plan.dtype)
    return tree_local_bytes(params,
                            shlib.param_pspecs(params, pol,
                                               fsdp=plan.fsdp), mesh)


def analytic_memory_bytes(plan: CellPlan, cfg: ArchConfig,
                          sh: ShapeConfig, mesh) -> float:
    dt = 2.0
    n_chips = prod(mesh.shape.values())
    p_local = _params_local_bytes(plan, cfg, mesh)
    d, ff = cfg.d_model, cfg.d_ff
    if cfg.moe:
        m = cfg.moe
        ff = m.top_k * m.d_ff_expert + m.n_shared * m.d_ff_expert
    qkv = cfg.n_heads * cfg.head_dim + 2 * cfg.n_kv_heads * cfg.head_dim
    act_per_tok_layer = (6 * d + 3 * ff + 2 * qkv) * dt   # fwd RW
    L = cfg.n_layers + cfg.encoder_layers

    if sh.kind == "train":
        tokens_local = sh.global_batch * sh.seq_len / n_chips * \
            mesh.shape.get("model", 1)         # activations shard on batch
        micro_tok = tokens_local / plan.n_micro
        # fwd + remat-fwd + bwd activation traffic; boundary save/restore
        acts = plan.n_micro * micro_tok * L * act_per_tok_layer * 3
        weights = 3 * p_local * plan.n_micro    # fwd/remat/bwd reads
        logits = (plan.n_micro * micro_tok * cfg.vocab_size
                  / mesh.shape.get("model", 1) * dt * 3)
        opt = 10 * p_local                      # m,v,params,grads RW
        return weights + acts + logits + opt
    if sh.kind == "prefill":
        tokens_local = sh.global_batch * sh.seq_len / n_chips * \
            mesh.shape.get("model", 1)
        acts = tokens_local * L * act_per_tok_layer
        cache_w = tokens_local * L * 2 * cfg.n_kv_heads * cfg.head_dim * dt
        return p_local + acts + cache_w
    # decode: weights once + cache read once per token step
    if cfg.mla:
        per_tok = (cfg.mla.kv_lora_rank + cfg.mla.rope_head_dim) * dt
    elif cfg.attn_free:
        per_tok = 0.0                          # constant-size state
    else:
        per_tok = 2 * cfg.n_kv_heads * cfg.head_dim * dt
    S_eff = min(sh.seq_len, cfg.sliding_window or sh.seq_len) \
        if cfg.family == "hybrid" else sh.seq_len
    state = 0.0
    if cfg.ssm:
        state = (cfg.n_heads * cfg.ssm.state_dim * cfg.head_dim * 4
                 * sh.global_batch * cfg.n_layers * 2)
    cache_local = (sh.global_batch * S_eff * cfg.n_layers * per_tok
                   + state) / n_chips * mesh.shape.get("model", 1)
    return p_local + cache_local


# ---------------------------------------------------------------------------
# The cells' steps, as rank 0 of the mesh's world
# ---------------------------------------------------------------------------

def _local_groups(plan: CellPlan, pol, n_rows: int) -> int:
    """The sort-dispatch groups of this rank's rows: the plan's groups tile
    the batch axes, so a rank holding 1/n of the rows holds 1/n of them."""
    n, _ = tpl.batch_split(pol, n_rows)
    return max(plan.moe_groups // n, 1) if n > 1 else plan.moe_groups


def _rows(pol, B: int) -> int:
    return B // tpl.batch_split(pol, B)[0]


def _train_state(plan: CellPlan, cfg: ArchConfig, pol, tc: TrainConfig
                 ) -> Dict:
    params = tpl.init_shard_params(0, cfg, pol, plan.dtype, device="meta")
    return {"params": params, "opt": init_opt_state(params, tc.opt),
            "step": torch.zeros((), dtype=torch.int32, device="meta")}


def _run_train_fit(plan: CellPlan, pol, mem: MemoryTracker) -> None:
    cfg, sh = plan.cfg, plan.shape_cfg
    tc = _train_tc(plan, cfg, cost_mode=False)
    rows = max(sh.global_batch // plan.n_micro, 1)
    tc = dataclasses.replace(tc, moe_groups=_local_groups(plan, pol, rows))
    state = _train_state(plan, cfg, pol, tc)
    batch = input_specs(cfg, sh, dtype=plan.dtype)
    step = make_train_step(cfg, tc)
    mem.start()
    with shlib.use_policy(pol):
        out = step(state, batch)
    mem.finish(out)


def _train_cost_point(plan: CellPlan, pol, cfg_d: ArchConfig, S: int,
                      pod_sz: int) -> Tuple[Dict, Dict]:
    """(micro-step costs, apply-step costs) at one (depth, S) point."""
    sh = plan.shape_cfg
    tc = _train_tc(plan, cfg_d, cost_mode=True)
    micro_rows = max(sh.global_batch // plan.n_micro, 1)
    tc = dataclasses.replace(tc, moe_groups=_local_groups(plan, pol,
                                                          micro_rows))
    state = _train_state(plan, cfg_d, pol, tc)
    batch = input_specs(cfg_d, dataclasses.replace(
        sh, global_batch=micro_rows), seq_len=S, dtype=plan.dtype)
    with shlib.use_policy(pol):
        with count_costs(pod_sz) as c_micro:
            grads, _ = _policy_grads(state["params"], cfg_d, tc, batch, pol)
        with count_costs(pod_sz) as c_apply:
            optimizer_update(grads, state["opt"], state["params"], tc.opt,
                             tpl.for_update(cfg_d))
    return c_micro, c_apply


def _serve_args(plan: CellPlan, cfg_d: ArchConfig, S: int, pol,
                decode: bool) -> Tuple[Dict, Dict, Dict]:
    """(this rank's parameters, its cache of depth S, the call's inputs)
    of a serving cell: the rows its batch axes give it."""
    sh = plan.shape_cfg
    B = _rows(pol, sh.global_batch)
    params = tpl.init_shard_params(0, cfg_d, pol, plan.dtype, device="meta")
    meta = dict(device="meta")
    with shlib.use_policy(pol):
        cache = lm.init_cache(cfg_d, B, S, plan.dtype, **meta)
    if decode:
        return params, cache, {"token": torch.empty((B,), dtype=torch.int64,
                                                    **meta)}
    n_front = cfg_d.n_frontend_tokens if cfg_d.frontend == "vision" else 0
    call = {"tokens": torch.empty((B, S - n_front), dtype=torch.int64,
                                  **meta)}
    if cfg_d.frontend == "vision":
        call["prefix_embeds"] = torch.empty((B, n_front, cfg_d.d_model),
                                            dtype=plan.dtype, **meta)
    if cfg_d.family == "encdec":
        call["enc_frames"] = torch.empty((B, cfg_d.encoder_seq,
                                          cfg_d.d_model), dtype=plan.dtype,
                                         **meta)
    return params, cache, call


def _serve_call(plan: CellPlan, cfg_d: ArchConfig, S: int, pol,
                params, cache, call, decode: bool):
    with shlib.use_policy(pol), torch.inference_mode():
        if decode:
            return lm.decode_step(params, cfg_d, call["token"], cache, S - 1)
        return lm.prefill(params, cfg_d, call["tokens"], cache,
                          prefix_embeds=call.get("prefix_embeds"),
                          enc_frames=call.get("enc_frames"),
                          moe_groups=_local_groups(
                              plan, pol, plan.shape_cfg.global_batch))


def _run_serve_fit(plan: CellPlan, pol, mem: MemoryTracker) -> None:
    sh = plan.shape_cfg
    decode = sh.kind != "prefill"
    args = _serve_args(plan, plan.cfg, sh.seq_len, pol, decode)
    mem.start()
    mem.finish(_serve_call(plan, plan.cfg, sh.seq_len, pol, *args, decode))


def _cache_bytes(plan: CellPlan, pol, mesh) -> Dict[str, int]:
    """A serving cell's decode cache a rank: the bytes this rank holds and
    the bytes ``cache_pspecs`` gives it (where heads split inside, the
    port keeps whole the heads a rank's columns touch, the specs cut the
    head dim)."""
    sh = plan.shape_cfg
    B = _rows(pol, sh.global_batch)
    with shlib.use_policy(pol):
        local = lm.init_cache(plan.cfg, B, sh.seq_len, plan.dtype,
                              device="meta")
    full = lm.init_cache(plan.cfg, sh.global_batch, sh.seq_len, plan.dtype,
                         device="meta")
    coords = dict(zip(mesh.axis_names, mesh.coords))
    return {"bytes": tpl.local_bytes(local),
            "spec_bytes": shlib.tree_local_bytes(
                full, shlib.cache_pspecs(pol, full), mesh, coords)}


def _serve_cost_point(plan: CellPlan, pol, cfg_d: ArchConfig, S: int,
                      pod_sz: int) -> Dict:
    decode = plan.shape_cfg.kind != "prefill"
    args = _serve_args(plan, cfg_d, S, pol, decode)
    with count_costs(pod_sz) as got:
        _serve_call(plan, cfg_d, S, pol, *args, decode)
    return got


# ---------------------------------------------------------------------------
# Cell runner
# ---------------------------------------------------------------------------

def _world(mesh_kind: str) -> int:
    return prod(mesh_shape_by_kind(mesh_kind).shape.values())


def run_cell(arch: str, shape: str, mesh_kind: str, *, force: bool = False,
             dp_mode: str = "dp", results_dir: str = RESULTS_DIR,
             overrides: Optional[Dict] = None,
             variant: str = "") -> Dict:
    """``overrides``: CellPlan field overrides for variants (cached under a
    ``__<variant>`` suffix)."""
    cfg = ARCHS[arch]
    sh = [s for s in SHAPES if s.name == shape][0]
    tag = f"{arch}__{shape}" + ("" if dp_mode == "dp" else f"__{dp_mode}") \
        + (f"__{variant}" if variant else "")
    out_dir = os.path.join(results_dir, mesh_kind)
    os.makedirs(out_dir, exist_ok=True)
    out_path = os.path.join(out_dir, tag + ".json")
    if os.path.exists(out_path) and not force:
        with open(out_path) as f:
            return json.load(f)

    runnable, why = cell_is_runnable(cfg, sh)
    result: Dict[str, Any] = {
        "arch": arch, "shape": shape, "mesh": mesh_kind, "dp_mode": dp_mode,
        "runnable": runnable, "skip_reason": why,
        "timestamp": time.strftime("%Y-%m-%d %H:%M:%S"),
    }
    if not runnable:
        with open(out_path, "w") as f:
            json.dump(result, f, indent=1)
        return result

    plan = make_plan(arch, shape, mesh_kind, dp_mode)
    if overrides:
        plan = dataclasses.replace(plan, **overrides)
        result["overrides"] = {k: str(v) for k, v in overrides.items()}
    shape_mesh = mesh_shape_by_kind(mesh_kind)
    psz = pod_size(shape_mesh)
    combos, target = depth_grid(cfg)
    t0 = time.time()
    try:
        with fake_world(_world(mesh_kind)), _card.dry_run():
            mesh = make_mesh_by_kind(mesh_kind, device="meta")
            pol = _policy(plan, mesh)
            result["rank"] = {"rank": mesh.rank,
                              "coords": dict(zip(mesh.axis_names,
                                                 mesh.coords))}
            reset_dry_calls()
            # the layout's shape-only template (meta, no card bytes) is
            # built before the tracker starts
            tpl.layout(cfg, pol)
            with MemoryTracker() as mem:
                (_run_train_fit if sh.kind == "train"
                 else _run_serve_fit)(plan, pol, mem)
            fit = {"memory": mem.summary(), "dry_calls": dry_calls()}
            if sh.kind != "train":
                result["cache"] = _cache_bytes(plan, pol, mesh)
            if sh.kind == "train":
                pts_mi: Dict[str, List] = {k: [] for k in COST_KEYS}
                pts_ap: Dict[str, List] = {k: [] for k in COST_KEYS}
                for depths in combos:
                    cfg_d = _with_depth(cfg, depths)
                    for S in plan.s_points:
                        mi, ap = _train_cost_point(plan, pol, cfg_d, S, psz)
                        for k in pts_mi:
                            pts_mi[k].append((depths, S, mi[k]))
                            pts_ap[k].append((depths, S, ap[k]))
                costs = {}
                for k in pts_mi:
                    poly_m = _fit_poly(pts_mi[k])
                    poly_a = _fit_poly(pts_ap[k])
                    costs[k] = (plan.n_micro
                                * _eval_poly(poly_m, target, sh.seq_len)
                                + _eval_poly(poly_a, target, sh.seq_len))
                tokens = sh.global_batch * sh.seq_len
            else:
                pts: Dict[str, List] = {k: [] for k in COST_KEYS}
                for depths in combos:
                    cfg_d = _with_depth(cfg, depths)
                    for S in plan.s_points:
                        got = _serve_cost_point(plan, pol, cfg_d, S, psz)
                        for k in pts:
                            pts[k].append((depths, S, got[k]))
                costs = {k: _eval_poly(_fit_poly(pts[k]), target,
                                       sh.seq_len) for k in pts}
                tokens = sh.global_batch * (sh.seq_len
                                            if sh.kind == "prefill" else 1)

        n_chips = prod(shape_mesh.shape.values())
        hbm_bytes = analytic_memory_bytes(plan, cfg, sh, shape_mesh)
        terms = hlo.roofline_terms(costs["flops"], hbm_bytes,
                                   costs["ici"], costs["dcn"])
        terms["t_memory_xla_upper"] = costs["bytes"] / hlo.HW["hbm_bw"]
        n_active = lm.count_params(cfg, active_only=True) \
            - lm.count_embedding_params(cfg)
        mult = 6 if sh.kind == "train" else 2
        model_flops = mult * n_active * tokens / n_chips
        shape_pol = _policy(plan, shape_mesh)
        result.update({
            "plan": {"n_micro": plan.n_micro,
                     "remat_blocks": plan.remat_blocks,
                     "fsdp": plan.fsdp, "seq_tp": plan.seq_tp,
                     "s_points": plan.s_points,
                     "depth_combos": combos, "depth_target": target},
            "memory": fit["memory"],
            "dry_calls": fit["dry_calls"],
            "memory_plan": analytic_peak_bytes(plan, cfg, sh, shape_mesh,
                                               shape_pol),
            "per_device": costs,
            "roofline": terms,
            "model_flops_per_device": model_flops,
            "useful_flops_ratio": (model_flops / costs["flops"]
                                   if costs["flops"] else 0.0),
            "elapsed_s": time.time() - t0,
            "ok": True,
        })
    except Exception as e:                                   # noqa: BLE001
        result.update({"ok": False, "error": f"{type(e).__name__}: {e}",
                       "traceback": traceback.format_exc()[-3000:],
                       "elapsed_s": time.time() - t0})
    with open(out_path, "w") as f:
        json.dump(result, f, indent=1, default=str)
    return result


def _is_todo(r: Dict) -> bool:
    """Whether a failed cell raised through ``tensor_parallel``'s ``_todo``
    (a layout the port does not run yet)."""
    err = r.get("error", "")
    return (err.startswith("NotImplementedError")
            and "is not ported yet" in err)


def summary_line(r: Dict, seconds: float) -> str:
    """The CLI's line for one cell's result."""
    if not r.get("runnable", True):
        status = "SKIP"
    elif r.get("ok"):
        m = r["memory"]
        mp = r.get("memory_plan", {})
        status = (f"OK   plan={mp.get('total_gib', 0):.2f}GiB"
                  f"({'fits' if mp.get('fits_hbm') else 'OVER'})"
                  f" peak={m['peak_gib']:.1f} "
                  f"dom={r['roofline']['dominant']:<10} "
                  f"frac={r['roofline']['roofline_fraction']:.3f}")
    elif _is_todo(r):
        status = "TODO " + r.get("error", "")[:120]
    else:
        status = "FAIL " + r.get("error", "")[:120]
    return (f"[{r['mesh']:6s}] {r['arch']:22s} {r['shape']:12s} "
            f"{seconds:6.1f}s  {status}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", nargs="*", default=sorted(ARCHS))
    ap.add_argument("--shape", nargs="*",
                    default=[s.name for s in SHAPES])
    ap.add_argument("--mesh", nargs="*", default=["single", "multi"])
    ap.add_argument("--dp-mode", default="dp",
                    choices=["dp", "replicated"])
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--results-dir", default=RESULTS_DIR)
    args = ap.parse_args()

    n_fail = 0
    for mesh_kind in args.mesh:
        for arch in args.arch:
            for shape in args.shape:
                t0 = time.time()
                r = run_cell(arch, shape, mesh_kind, force=args.force,
                             dp_mode=args.dp_mode,
                             results_dir=args.results_dir)
                n_fail += bool(r.get("runnable", True) and not r.get("ok")
                               and not _is_todo(r))
                print(summary_line(r, time.time() - t0), flush=True)
    if n_fail:
        raise SystemExit(f"{n_fail} cells failed")


if __name__ == "__main__":
    main()
