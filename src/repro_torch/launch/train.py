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
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, List

import torch

from ..configs import ARCHS, get_arch
from ..data.pipeline import SyntheticPipeline
from ..distributed.meshes import resolve_device
from ..train.checkpoint import (latest_step, restore_checkpoint,
                                save_checkpoint)
from ..train.fault import PreemptionSimulator
from ..train.optimizer import OptimizerConfig
from ..train.trainer import (TrainConfig, init_train_state,
                             make_coded_batch_r2, make_train_step)


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
    return ap


def _train(args: argparse.Namespace, device: torch.device, mesh=None,
           log: bool = True) -> List[float]:
    """The training loop of one process (or one rank); the losses."""
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
    state = init_train_state(args.seed, cfg, tc, device=device)
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
        if args.ckpt_dir and (i + 1) % args.ckpt_every == 0 and log:
            save_checkpoint(state, args.ckpt_dir, i)
        if log and (i % max(args.steps // 20, 1) == 0
                    or i == args.steps - 1):
            print(f"step {i:5d}  loss {losses[-1]:.4f}  "
                  f"gnorm {float(metrics['grad_norm']):.3f}  "
                  f"lr {float(metrics['lr']):.2e}  "
                  f"{(time.time() - t0) / max(i - start + 1, 1):.2f}s/step",
                  flush=True)
    return losses


def _coded_rank(dev: torch.device, arg_dict: Dict) -> List[float]:
    """One rack of a coded_r2 run (a rank of run_ranks)."""
    from ..distributed.meshes import make_process_mesh
    args = argparse.Namespace(**arg_dict)
    mesh = make_process_mesh((args.pods,), ("rack",), device=dev)
    return _train(args, dev, mesh=mesh, log=mesh.rank == 0)


def main(argv=None) -> None:
    args = _parser().parse_args(argv)
    dev = resolve_device(args.device)
    print(f"training {args.arch} ({'full' if args.full else 'reduced'}) "
          f"on {dev}, dp_mode {args.dp_mode}")
    if args.dp_mode == "coded_r2":
        from ..distributed.launch import run_ranks
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
