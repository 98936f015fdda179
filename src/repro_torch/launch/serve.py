"""End-to-end serving entry point: batched prefill + decode on a reduced config
(the port's ``repro/launch/serve.py``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \
      --requests 6 --slots 2 --prompt-len 16 --max-new 8 [--device cpu]

Runs on the CUDA card unless ``--device`` says otherwise; weights are drawn
from ``--seed``.  MoE layers take the capacity-less dispatch
(``dense_moe=True``), as the JAX entry point runs them.  Every arch of
``ARCHS`` runs at its ``reduced()`` config.  A text model serves the
requests through ``ServeEngine.serve``; a model with a frontend
(whisper-large-v3's audio frames, llava-next-34b's patch prefix) takes
stub frontend inputs drawn from ``--seed``, which ``serve`` does not
carry, so its requests run in waves of ``--slots`` prompts of
``--prompt-len`` tokens through ``ServeEngine.generate``.

``--mesh D,M`` (for example ``--mesh 1,4``) spawns D x M ranks through
``repro_torch.distributed.launch.run_ranks`` on a ('data', 'model')
process mesh: each draws its shards of the same weights
(``tensor_parallel.init_shard_params``) and serves under
``default_rules(fsdp=False)``; the dense family (and the VLM's dense
trunk) runs so, the others raise.  ``--backend`` defaults to gloo on one
card or the CPU and to nccl when there are as many cards as ranks.  Rank 0
prints.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict

import numpy as np
import torch

from ..configs import ARCHS, get_arch
from ..distributed import sharding as sh
from ..distributed import tensor_parallel as tpl
from ..distributed.launch import BACKENDS, default_backend, run_ranks
from ..distributed.meshes import make_process_mesh, resolve_device
from ..models import lm
from ..models.frontends import frontend_inputs
from ..serve.engine import Request, ServeEngine
from .mesh import parse_mesh


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="qwen2-1.5b", choices=sorted(ARCHS))
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--mesh", default=None, metavar="D,M",
                    help="serve on D x M ranks, a ('data', 'model') mesh")
    ap.add_argument("--backend", default=None, choices=BACKENDS,
                    help="with --mesh (default: nccl with a card a rank, "
                         "else gloo)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    if args.mesh is None:
        _serve(args, device)
        return
    shape = parse_mesh(args.mesh)
    world = shape[0] * shape[1]
    if device.type == "cuda":
        from ..kernels.flash_attention import ops as fa
        fa.build()
    run_ranks(_serve_rank, world,
              backend=args.backend or default_backend(device, world),
              device=device, args=(vars(args), shape), timeout_s=3600.0)


def _serve_rank(dev: torch.device, arg_dict: Dict, shape: tuple) -> None:
    """One rank of a ``--mesh`` run."""
    args = argparse.Namespace(**arg_dict)
    mesh = make_process_mesh(shape, ("data", "model"), device=dev)
    policy = sh.ShardingPolicy(mesh, sh.default_rules(False, fsdp=False))
    with sh.use_policy(policy):
        _serve(args, dev, policy, log=mesh.rank == 0)


def _serve(args: argparse.Namespace, device: torch.device, policy=None,
           log: bool = True) -> None:
    cfg = get_arch(args.arch).reduced()
    if policy is None:
        params = lm.init_params(args.seed, cfg, device=device)
    else:
        params = tpl.init_shard_params(args.seed, cfg, policy,
                                       device=device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    front = frontend_inputs(gen, cfg, args.slots)
    n_front = cfg.n_frontend_tokens if "prefix_embeds" in front else 0
    eng = ServeEngine(cfg, params, batch_slots=args.slots,
                      max_seq=n_front + args.prompt_len + args.max_new + 8,
                      dense_moe=True, seed=args.seed, device=device)
    rng = np.random.default_rng(args.seed)
    reqs = [Request(rng.integers(0, cfg.vocab_size,
                                 args.prompt_len if front else
                                 rng.integers(4, args.prompt_len + 1)
                                 ).astype(np.int32),
                    max_new_tokens=args.max_new,
                    temperature=args.temperature)
            for _ in range(args.requests)]
    t0 = time.time()
    if front:
        for i in range(0, len(reqs), args.slots):
            wave = reqs[i:i + args.slots]
            prompts = np.zeros((args.slots, args.prompt_len), np.int32)
            for j, r in enumerate(wave):
                prompts[j] = r.prompt
            toks = eng.generate(prompts, args.max_new, args.temperature,
                                **front)
            for j, r in enumerate(wave):
                r.out_tokens, r.done = list(map(int, toks[j])), True
        done = reqs
    else:
        done = eng.serve(reqs)
    if device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.time() - t0
    if not log:
        return
    total_new = sum(len(r.out_tokens) for r in done)
    for i, r in enumerate(done):
        print(f"req {i}: prompt[{len(r.prompt)}] -> {r.out_tokens}")
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else str(device))
    ranks = "" if policy is None else (
        f", {policy.mesh.axis_sizes} ('data', 'model') ranks")
    print(f"{total_new} tokens in {dt:.2f}s ({total_new / dt:.1f} tok/s on "
          f"{where}, reduced config{ranks})")


if __name__ == "__main__":
    main()
