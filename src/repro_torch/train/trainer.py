"""The training step: microbatch gradient accumulation, remat, and the
paper's hybrid-coded data-parallel gradient sync (the port of
``repro/train/trainer.py``).

Three DP sync modes (``TrainConfig.dp_mode``).  In one process ``dp`` and
``replicated`` are the full-batch step.  On a
:class:`repro_torch.distributed.meshes.ProcessMesh` with axes ('rack',
'server'), one rank a server:

  * 'dp'          — the batch is split over every rank (``batch_pspec(
                    'dp_flat')``) and the gradients are mean-reduced with
                    the two-tier ``hierarchical_allreduce``: the paper's
                    *uncoded* shuffle.
  * 'replicated'  — the batch is replicated over 'rack' and split over
                    'server' (``batch_pspec('dp_hybrid_r2')``): every rack
                    computes the full gradient, ZERO cross-rack bytes, P x
                    map FLOPs — the r = P corner of L_cro = (QN/r)(1 - r/P).
  * 'coded_r2'    — the r = 2 < P scheme: the global batch is split into
                    C(P,2) chunks, chunk {a,b} is mapped by racks a AND b,
                    and the cross-rack stage is the coded reduce-scatter of
                    :mod:`repro_torch.core.gradient_sync` (the
                    ``coded_encode`` kernel on the card) and an all-gather
                    over 'rack' — G(1 - 2/P) cross-rack bytes instead of
                    uncoded G(1 - 1/P), plus single-rack straggler
                    tolerance (``failed=``).

The microbatch loop is a Python loop with a ``grad_dtype`` accumulator;
``remat`` checkpoints each layer (:func:`repro_torch.models.lm.forward`).

Under an active sharding policy on a ('data', 'model') process mesh
(:func:`repro_torch.distributed.sharding.use_policy`), the state holds
this rank's shards (``tensor_parallel.shard_params``): the model-axis
cut, then, where the policy names an FSDP axis (``default_rules``' 'data'),
the overlay's ZeRO-3 cut of ``param_pspecs(..., fsdp=True)``, the JAX
trainer's own test (``_grad_constraint``).  The step takes this rank's
rows of the batch as ``batch_pspecs`` splits them and runs the forward
and backward, which gather each ZeRO-3 leaf before its use and hand its
gradient back reduce-scattered (summed) over the FSDP axis
(:mod:`repro_torch.distributed.fsdp`).  Those gradients are divided by
the axis's size; the replicated leaves' gradients take the mean over the
batch axes (``psum``); no leaf is summed twice.  AdamW runs on the local
shards and Adafactor on the local shards of its factored state, both with
the sums of the whole model (the global norm, Adafactor's means and
update RMS).  :func:`train_state_pspecs` gives the specs of the JAX
package's ``train_step_shardings``, which the state's local bytes meet.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..core.gradient_sync import (batch_pspec, chunk_index_table,
                                  coded_reduce_scatter_r2,
                                  hierarchical_allreduce)
from ..distributed import fsdp
from ..distributed import tensor_parallel as tpl
from ..distributed.collectives import all_gather, psum
from ..distributed.meshes import DeviceLike, ProcessMesh
from ..distributed.sharding import (P, ShardingPolicy, active_policy,
                                    batch_pspecs, local_shape, param_pspecs,
                                    spec_leaves)
from ..kernels._card import on_card
from ..models import lm
from .optimizer import (OptimizerConfig, init_opt_state, optimizer_update,
                        tree_leaves, tree_unflatten)

TRAIN_DP_MODES = ("dp", "replicated", "coded_r2")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    n_microbatches: int = 1
    remat: bool = True
    remat_blocks: int = 1             # 2-level remat (sqrt-L memory)
    scan_layers: bool = True          # accepted; layers run in a loop
    unroll_scans: bool = False        # accepted; no effect
    dp_mode: str = "dp"               # dp | replicated | coded_r2
    grad_dtype: Any = torch.float32   # accumulation dtype
    aux_coef: float = 0.01
    dense_moe: bool = False           # exact dispatch (tiny configs)
    moe_groups: int = 1               # sort-dispatch groups
    mixer_chunk: int = 64
    opt: OptimizerConfig = OptimizerConfig()


def init_train_state(seed: int, cfg: ArchConfig, tc: TrainConfig,
                     dtype=torch.float32, *,
                     device: DeviceLike = None) -> Dict:
    """{"params", "opt", "step"} with parameters drawn from ``seed`` on
    ``device`` (default: the CUDA card; raises without one)."""
    params = lm.init_params(seed, cfg, dtype, device=device)
    dev = tree_leaves(params)[0].device
    return {"params": params, "opt": init_opt_state(params, tc.opt),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def _split_micro(batch: Dict, n: int) -> list:
    def f(x):
        b = x.shape[0]
        if b % n:
            raise ValueError(f"batch {b} does not split into {n} "
                             f"microbatches")
        return x.reshape(n, b // n, *x.shape[1:])
    split = {k: f(v) for k, v in batch.items()}
    return [{k: v[i] for k, v in split.items()} for i in range(n)]


def _loss_fn(params, cfg: ArchConfig, tc: TrainConfig, mb: Dict):
    return lm.lm_loss(params, cfg, mb, aux_coef=tc.aux_coef,
                      scan_layers=tc.scan_layers, remat=tc.remat,
                      dense_moe=tc.dense_moe, mixer_chunk=tc.mixer_chunk,
                      unroll_scans=tc.unroll_scans,
                      remat_blocks=tc.remat_blocks, moe_groups=tc.moe_groups)


def value_and_grad(params, cfg: ArchConfig, tc: TrainConfig, mb: Dict,
                   ) -> Tuple[torch.Tensor, list]:
    """(loss, gradients as a list in :func:`tree_leaves` order) of one
    batch, by ``torch.autograd.grad`` with respect to every leaf."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    with torch.enable_grad():
        loss, _ = _loss_fn(tree_unflatten(params, leaves), cfg, tc, mb)
        grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), list(grads)


def accumulate_grads(params, cfg: ArchConfig, tc: TrainConfig,
                     batch: Dict) -> Tuple[Any, torch.Tensor]:
    """Microbatch grad accumulation.  Returns (grads, mean loss)."""
    n = tc.n_microbatches
    if n == 1:
        loss, grads = value_and_grad(params, cfg, tc, batch)
        return tree_unflatten(params, grads), loss
    acc, loss_sum = None, None
    for mb in _split_micro(batch, n):
        loss, grads = value_and_grad(params, cfg, tc, mb)
        if acc is None:
            acc = [torch.zeros_like(g, dtype=tc.grad_dtype) for g in grads]
            loss_sum = torch.zeros_like(loss)
        for a, g in zip(acc, grads):
            a += g.to(tc.grad_dtype)
        del grads
        loss_sum = loss_sum + loss
    grads = [(a / n).to(tc.grad_dtype) for a in acc]
    return tree_unflatten(params, grads), loss_sum / n


def _flat(grads: list, dtype, pad: int) -> torch.Tensor:
    vec = torch.cat([g.to(dtype).reshape(-1) for g in grads])
    return torch.nn.functional.pad(vec, (0, pad)) if pad else vec


def _unflat(vec: torch.Tensor, params, dtype) -> Any:
    out, off = [], 0
    for p in tree_leaves(params):
        out.append(vec[off:off + p.numel()].reshape(p.shape).to(dtype))
        off += p.numel()
    return tree_unflatten(params, out)


# ---------------------------------------------------------------------------
# coded_r2: chunked batch layout + coded sync over 'rack'
# ---------------------------------------------------------------------------

def chunk_layout_r2(global_batch: int, P_: int) -> Tuple[int, int]:
    """(n_chunks, rows per chunk) for the C(P,2)-chunk layout."""
    n_chunks = P_ * (P_ - 1) // 2
    if global_batch % n_chunks:
        raise ValueError(f"coded_r2 needs C(P,2) = {n_chunks} | the global "
                         f"batch, got {global_batch} for P = {P_}")
    return n_chunks, global_batch // n_chunks


def make_coded_batch_r2(batch: Dict, P_: int) -> Dict:
    """Reorder a [B, ...] batch into the replicated chunk layout
    [P, P-1, B/C(P,2), ...]: row p holds the P-1 chunks rack p maps (each
    chunk appears in exactly its 2 member racks)."""
    table = torch.as_tensor(chunk_index_table(P_))       # [P, P-1] chunk ids

    def f(x):
        n_chunks, rows = chunk_layout_r2(x.shape[0], P_)
        xc = x.reshape(n_chunks, rows, *x.shape[1:])
        return xc[table.to(x.device)]                     # [P, P-1, rows, ...]
    return {k: f(v) for k, v in batch.items()}


def coded_grads_r2(params, cfg: ArchConfig, tc: TrainConfig,
                   coded_batch: Dict, mesh: ProcessMesh,
                   pod_axis: str = "rack", failed: Optional[int] = None,
                   ) -> Tuple[Any, torch.Tensor]:
    """Gradient computation + coded cross-rack sync (r = 2), in every rank.

    coded_batch: the [P, P-1, rows, ...] layout of
    :func:`make_coded_batch_r2` (every rank holds all of it and maps its
    own rack's row).  Every rack maps its P-1 chunks (the 2x map
    replication), then the coded reduce-scatter and an all-gather over
    ``pod_axis`` restore the exact full-batch mean gradient — with any
    single ``failed`` rack's transmissions lost and recovered from its
    pair partners.  The combine is the ``coded_encode`` kernel on the card
    and its plain version on the CPU."""
    P_ = mesh.axis_size(pod_axis)
    me = mesh.axis_index(pod_axis)
    combine_impl = "kernel" if on_card(mesh.device) else "torch"
    n_chunks = P_ * (P_ - 1) // 2
    G = sum(p.numel() for p in tree_leaves(params))
    pad = (-G) % P_
    vecs, loss_sum = [], None
    for c in range(P_ - 1):
        loss, grads = value_and_grad(
            params, cfg, tc, {k: v[me, c] for k, v in coded_batch.items()})
        vecs.append(_flat(grads, tc.grad_dtype, pad))
        del grads
        loss_sum = loss if loss_sum is None else loss_sum + loss
    # [P-1, G+pad] per-chunk partials, partner-ascending order
    shard = coded_reduce_scatter_r2(torch.stack(vecs), mesh, pod_axis, P_,
                                    failed=failed, combine_impl=combine_impl)
    del vecs
    full = all_gather(shard, mesh, pod_axis) / n_chunks   # mean over chunks
    loss = psum(loss_sum / (P_ - 1), mesh, pod_axis) / P_
    return _unflat(full[:G], params, tc.grad_dtype), loss


def _mesh_grads(params, cfg: ArchConfig, tc: TrainConfig, batch: Dict,
                mesh: ProcessMesh) -> Tuple[Any, torch.Tensor]:
    """'dp' / 'replicated' on a ('rack', 'server') process mesh: this
    rank's slice of the batch, then the mean over the ranks that split
    it."""
    if set(mesh.axis_names) != {"rack", "server"}:
        raise ValueError(f"dp / replicated need a ('rack', 'server') mesh, "
                         f"got axes {mesh.axis_names}")
    mode = "dp_flat" if tc.dp_mode == "dp" else "dp_hybrid_r2"
    axes = batch_pspec(mode, multi_pod=mesh.axis_size("rack") > 1)
    n = int(np.prod([mesh.axis_size(a) for a in axes]))
    idx = int(np.ravel_multi_index([mesh.axis_index(a) for a in axes],
                                   [mesh.axis_size(a) for a in axes]))
    B = next(iter(batch.values())).shape[0]
    if B % n:
        raise ValueError(f"batch {B} does not split over {n} ranks")
    local = {k: v[idx * (B // n):(idx + 1) * (B // n)]
             for k, v in batch.items()}
    grads, loss = accumulate_grads(params, cfg, tc, local)
    G = sum(p.numel() for p in tree_leaves(params))
    vec = _flat(tree_leaves(grads), tc.grad_dtype, (-G) % n)
    if axes == ("rack", "server"):
        vec = hierarchical_allreduce(vec, mesh, "server", "rack")
        loss = psum(loss, mesh, ("rack", "server"))
    else:                      # over 'server' only: zero cross-rack bytes
        vec = psum(vec, mesh, "server")
        loss = psum(loss, mesh, "server")
    return _unflat(vec[:G] / n, params, tc.grad_dtype), loss / n


def _policy_grads(params, cfg: ArchConfig, tc: TrainConfig, batch: Dict,
                  policy: ShardingPolicy) -> Tuple[Any, torch.Tensor]:
    """Under a sharding policy: this rank's rows of the batch through the
    sharded model, then the mean over the ranks that split it: a ZeRO-3
    leaf's gradient arrives summed over the FSDP axis and is divided by
    its size, a replicated leaf's is summed over the batch axes."""
    B = next(iter(batch.values())).shape[0]
    with tpl.split_rows(policy, B):
        grads, loss = accumulate_grads(params, cfg, tc,
                                       tpl.local_rows(policy, batch))
    z = fsdp.for_call(cfg)
    leaves = tree_leaves(grads)
    zero3 = ([False] * len(leaves) if z is None
             else [k != "rep" for k in tpl.layout(cfg, policy).zkinds])
    out = [g / z.size if split else g for g, split in zip(leaves, zero3)]
    if tpl.batch_split(policy, B)[0] > 1:
        rep = [i for i, split in enumerate(zero3) if not split]
        if rep:
            vec = tpl.mean_over_batch(
                policy, _flat([leaves[i] for i in rep], tc.grad_dtype, 0), B)
            off = 0
            for i in rep:
                n = leaves[i].numel()
                out[i] = vec[off:off + n].reshape(leaves[i].shape).to(
                    tc.grad_dtype)
                off += n
        loss = tpl.mean_over_batch(policy, loss, B)
    return tree_unflatten(params, out), loss


def train_state_pspecs(state: Dict, policy: ShardingPolicy,
                       fsdp: bool = True, *,
                       batch: Optional[Dict] = None) -> Dict:
    """Partition specs of a train state of the model's full shapes (a
    ``meta``-device state will do) under ``policy``: the JAX package's
    ``train_step_shardings`` as spec trees.  Returns {"state": {"params",
    "opt": {"m", "v", "count"}, "step"}, "batch" (None without a batch),
    "metrics"}."""
    pspec = param_pspecs(state["params"], policy, fsdp=fsdp)
    return {"state": {"params": pspec,
                      "opt": {"m": pspec, "v": pspec, "count": P()},
                      "step": P()},
            "batch": None if batch is None else batch_pspecs(policy, batch),
            "metrics": {"loss": P(), "grad_norm": P(), "lr": P()}}


def state_local_bytes(state: Dict, cfg: ArchConfig,
                      policy: ShardingPolicy) -> Dict[str, Optional[int]]:
    """This rank's bytes of a sharded train state beside its specs':
    ``held``, the bytes of its parameters and optimizer state; ``specs``,
    those :func:`train_state_pspecs` gives a rank (AdamW's m and v; None
    for Adafactor, whose state the JAX shardings do not name); both
    without the kv heads duplicated over the model axis (the layout's one
    difference from the specs, see ``tensor_parallel``), whose bytes are
    ``duplicated``."""
    from .optimizer import tree_map
    kinds = tpl.layout(cfg, policy).kinds
    opt = state["opt"]
    trees = ["params", "m", "v"] if "v" in opt else ["params"]
    held = dup = 0
    for name in trees:
        tree = state["params"] if name == "params" else opt[name]
        for x, kind in zip(tree_leaves(tree), kinds):
            n = x.numel() * x.element_size()
            held, dup = (held, dup + n) if kind == "dup" else (held + n, dup)
    if "v" not in opt:                        # Adafactor's factored state
        held += sum(x.numel() * x.element_size()
                    for x in tree_leaves(opt["m"]))
        return {"held": held, "specs": None, "duplicated": dup}
    meta = {"params": lm.init_params(0, cfg, device="meta")}
    for k in ("m", "v"):
        dtype = tree_leaves(opt[k])[0].dtype
        meta[k] = tree_map(lambda x: x.to(dtype), meta["params"])
    meta["params"] = tree_map(
        lambda x: x.to(tree_leaves(state["params"])[0].dtype),
        meta["params"])
    spec = param_pspecs(meta["params"], policy,
                        fsdp=policy.rules.get("fsdp") is not None)
    want = 0
    for name in trees:
        for x, s_, kind in zip(tree_leaves(meta[name]), spec_leaves(spec),
                               kinds):
            if kind != "dup":
                want += (int(np.prod(local_shape(x.shape, s_, policy.mesh)))
                         * x.element_size())
    return {"held": held, "specs": want, "duplicated": dup}


# ---------------------------------------------------------------------------
# The step
# ---------------------------------------------------------------------------

def make_train_step(cfg: ArchConfig, tc: TrainConfig,
                    mesh: Optional[ProcessMesh] = None) -> Callable:
    """Build step(state, batch) -> (state, metrics).

    For dp_mode='coded_r2', ``batch`` must be in :func:`make_coded_batch_r2`
    layout and ``mesh`` a process mesh with a 'rack' axis; 'dp' and
    'replicated' on a ('rack', 'server') mesh take the whole global batch
    in every rank.  Under a sharding policy active when the step runs
    (dp_mode 'dp', no ``mesh``) every rank takes the whole global batch and
    its state holds its shards (see the module docstring).  The old
    state's tensors are freed when the caller drops them (the JAX
    package's ``donate``)."""
    if tc.dp_mode not in TRAIN_DP_MODES:
        raise ValueError(f"dp_mode must be one of {TRAIN_DP_MODES}, got "
                         f"{tc.dp_mode!r}")
    if tc.dp_mode == "coded_r2" and mesh is None:
        raise ValueError("dp_mode='coded_r2' needs a process mesh")

    def step(state, batch):
        policy, tp = active_policy(), None
        if policy is not None and (mesh is not None or tc.dp_mode != "dp"):
            raise ValueError(f"a sharding policy runs dp_mode 'dp' with no "
                             f"mesh argument, got {tc.dp_mode!r} and "
                             f"{'a' if mesh is not None else 'no'} mesh")
        if policy is not None:
            grads, loss = _policy_grads(state["params"], cfg, tc, batch,
                                        policy)
            tp = tpl.for_update(cfg)
        elif tc.dp_mode == "coded_r2":
            grads, loss = coded_grads_r2(state["params"], cfg, tc, batch,
                                         mesh)
        elif mesh is not None:
            grads, loss = _mesh_grads(state["params"], cfg, tc, batch, mesh)
        else:
            grads, loss = accumulate_grads(state["params"], cfg, tc, batch)
        new_params, new_opt, om = optimizer_update(
            grads, state["opt"], state["params"], tc.opt, tp)
        del grads
        new_state = {"params": new_params, "opt": new_opt,
                     "step": state["step"] + 1}
        return new_state, {"loss": loss, **om}

    return step


__all__ = ["TrainConfig", "TRAIN_DP_MODES", "init_train_state",
           "accumulate_grads", "value_and_grad", "chunk_layout_r2",
           "make_coded_batch_r2", "coded_grads_r2", "make_train_step",
           "train_state_pspecs", "state_local_bytes"]
