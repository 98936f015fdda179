"""End-to-end training entry point (the port of ``repro/launch/train.py``):
synthetic pipeline, the train step with the paper's DP sync modes,
checkpoint/restart and simulated preemption.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \
      --steps 100 --batch 8 --seq 64 --dp-mode dp --ckpt-dir ckpt \
      [--device cpu] [--full]

Runs on the CUDA card unless ``--device`` says otherwise (without a card
and without ``--device cpu`` it raises).  Every arch of ``ARCHS`` runs at
its ``reduced()`` config unless ``--full`` asks for the published widths.
Weights are drawn from ``--seed``.  With ``--ckpt-dir`` a run resumes from
the latest checkpoint there; ``--preempt-at N`` raises before step N (the
checkpoint written before it survives, and the same command resumes).
``--dp-mode coded_r2`` spawns ``--pods`` ranks (one a rack, gloo) through
``repro_torch.distributed.launch.run_ranks``; each maps its P-1 chunks of
every batch, and rank 0 prints the steps.

``--mesh D,M`` (for example ``--mesh 2,2``; dp_mode ``dp``) spawns D x M
ranks on a ('data', 'model') process mesh under ``default_rules`` (its
FSDP overlay is specs only): each holds its shards of the same weights and
moments, takes its rows of every batch, and checkpoints its shards under
``--ckpt-dir``/rank<k>.  The dense family (and the VLM's dense trunk)
runs so, with AdamW; the others raise.  ``--backend`` defaults to gloo on
one card or the CPU and to nccl when there are as many cards as ranks.
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Dict, List

import torch

from ..configs import ARCHS, get_arch
from ..data.pipeline import SyntheticPipeline
from ..distributed import sharding as sh
from ..distributed import tensor_parallel as tpl
from ..distributed.launch import BACKENDS, default_backend, run_ranks
from ..distributed.meshes import make_process_mesh, resolve_device
from ..train.checkpoint import (latest_step, restore_checkpoint,
                                save_checkpoint)
from ..train.fault import PreemptionSimulator
from ..train.optimizer import OptimizerConfig, init_opt_state
from ..train.trainer import (TrainConfig, init_train_state,
                             make_coded_batch_r2, make_train_step)
from .mesh import parse_mesh


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="qwen2-1.5b", choices=sorted(ARCHS))
    ap.add_argument("--full", action="store_true",
                    help="the published widths instead of reduced()")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--n-micro", type=int, default=2)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--optimizer", default="adamw",
                    choices=["adamw", "adafactor"])
    ap.add_argument("--dp-mode", default="dp",
                    choices=["dp", "replicated", "coded_r2"])
    ap.add_argument("--pods", type=int, default=4,
                    help="rack count (ranks) for coded_r2")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--preempt-at", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--mesh", default=None, metavar="D,M",
                    help="train on D x M ranks, a ('data', 'model') mesh")
    ap.add_argument("--backend", default=None, choices=BACKENDS,
                    help="with --mesh (default: nccl with a card a rank, "
                         "else gloo)")
    return ap


def _train(args: argparse.Namespace, device: torch.device, mesh=None,
           log: bool = True, policy=None) -> List[float]:
    """The training loop of one process (or one rank); the losses.  Under
    ``policy`` (active in the caller) the state holds this rank's
    shards."""
    cfg = get_arch(args.arch)
    if not args.full:
        cfg = cfg.reduced()
    tc = TrainConfig(
        n_microbatches=args.n_micro if args.dp_mode != "coded_r2" else 1,
        remat=True, dense_moe=not args.full, dp_mode=args.dp_mode,
        opt=OptimizerConfig(kind=args.optimizer, lr=args.lr,
                            warmup_steps=max(args.steps // 10, 1),
                            decay_steps=args.steps))
    pipe = SyntheticPipeline(cfg, args.batch, args.seq, seed=args.seed,
                             device=device)
    step_fn = make_train_step(cfg, tc, mesh=mesh)
    if policy is None:
        state = init_train_state(args.seed, cfg, tc, device=device)
    else:                       # this rank's shards of the same state
        params = tpl.init_shard_params(args.seed, cfg, policy,
                                       device=device)
        state = {"params": params, "opt": init_opt_state(params, tc.opt),
                 "step": torch.zeros((), dtype=torch.int32, device=device)}
    start = 0
    if args.ckpt_dir and latest_step(args.ckpt_dir) is not None:
        state, start = restore_checkpoint(state, args.ckpt_dir)
        start += 1
        if log:
            print(f"resumed from step {start - 1}")
    sim = PreemptionSimulator(args.preempt_at)
    losses = []
    t0 = time.time()
    for i in range(start, args.steps):
        sim.check(i)
        batch = pipe.batch_at(i)
        if args.dp_mode == "coded_r2":
            batch = make_coded_batch_r2(batch, args.pods)
        state, metrics = step_fn(state, batch)
        losses.append(float(metrics["loss"]))
        # a replicated state is saved by the logging rank, shards by all
        if (args.ckpt_dir and (i + 1) % args.ckpt_every == 0
                and (log or policy is not None)):
            save_checkpoint(state, args.ckpt_dir, i)
        if log and (i % max(args.steps // 20, 1) == 0
                    or i == args.steps - 1):
            print(f"step {i:5d}  loss {losses[-1]:.4f}  "
                  f"gnorm {float(metrics['grad_norm']):.3f}  "
                  f"lr {float(metrics['lr']):.2e}  "
                  f"{(time.time() - t0) / max(i - start + 1, 1):.2f}s/step",
                  flush=True)
    return losses


def _mesh_rank(dev: torch.device, arg_dict: Dict,
               shape: tuple) -> List[float]:
    """One rank of a ``--mesh`` run."""
    args = argparse.Namespace(**arg_dict)
    mesh = make_process_mesh(shape, ("data", "model"), device=dev)
    if args.ckpt_dir:
        args.ckpt_dir = os.path.join(args.ckpt_dir, f"rank{mesh.rank}")
    policy = sh.ShardingPolicy(mesh, sh.default_rules(False))
    with sh.use_policy(policy):
        return _train(args, dev, log=mesh.rank == 0, policy=policy)


def _coded_rank(dev: torch.device, arg_dict: Dict) -> List[float]:
    """One rack of a coded_r2 run (a rank of run_ranks)."""
    args = argparse.Namespace(**arg_dict)
    mesh = make_process_mesh((args.pods,), ("rack",), device=dev)
    return _train(args, dev, mesh=mesh, log=mesh.rank == 0)


def main(argv=None) -> None:
    args = _parser().parse_args(argv)
    dev = resolve_device(args.device)
    print(f"training {args.arch} ({'full' if args.full else 'reduced'}) "
          f"on {dev}, dp_mode {args.dp_mode}"
          + (f", mesh {args.mesh}" if args.mesh else ""))
    if args.mesh is not None:
        if args.dp_mode != "dp":
            raise ValueError(f"--mesh runs dp_mode 'dp', got "
                             f"{args.dp_mode!r}")
        shape = parse_mesh(args.mesh)
        world = shape[0] * shape[1]
        if dev.type == "cuda":
            from ..kernels.flash_attention import backward as fab
            from ..kernels.flash_attention import ops as fa
            fa.build()
            fab.build()
        run_ranks(_mesh_rank, world,
                  backend=args.backend or default_backend(dev, world),
                  device=dev, args=(vars(args), shape), timeout_s=3600.0)
    elif args.dp_mode == "coded_r2":
        if dev.type == "cuda":
            from ..kernels.flash_attention import backward as fab
            from ..kernels.flash_attention import ops as fa
            from ..kernels.rwkv_scan import backward as rwb
            from ..kernels.rwkv_scan import ops as rw
            for mod in (fa, fab, rw, rwb):
                mod.build()
        run_ranks(_coded_rank, args.pods, backend="gloo", device=dev,
                  args=(vars(args),), timeout_s=3600.0)
    else:
        _train(args, dev)
    print("done")


if __name__ == "__main__":
    main()
