"""Hold a tensor-parallel model against the unsharded one at full depth,
to tell a fault from rounding where a bf16 run's greedy tokens part.

For each dtype, the unsharded port (this process) and the same weights
cut over four gloo ranks on (data 1, model 4) of the one card
(``tensor_parallel.init_shard_params``, the same ``--seed``) run
``chip_smoke.py``'s ``tp_greedy``: ``prefill`` of SLOTS x PROMPT tokens
and NEW greedy ``decode_step``s.  Prints, a line each, the unsharded
run's top-2 logit margins of the first token and its largest |logit|,
then every rank's largest |logit - unsharded| of the first token and of
all steps, against that largest |logit|, and the share of greedy tokens
equal to the unsharded run's.  Needs the card:

    python tools/tp_depth_probe.py [--arch deepseek-v2-lite-16b]
        [--layers N] [--dtypes float32,bfloat16] [--seed 0]

``--layers`` cuts the depth (default: all the arch's layers).  At
DeepSeek-V2-Lite's full depth the unsharded fp32 weights take 62.8 GB of
the card and are freed before the ranks draw theirs.
"""
from __future__ import annotations

import argparse
import dataclasses
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402

SLOTS, PROMPT, NEW, RANKS = 2, 256, 8, 4


def _config(get_arch, arch: str, layers):
    cfg = get_arch(arch)
    return cfg if layers is None else dataclasses.replace(cfg,
                                                          n_layers=layers)


def rank(dev, arch: str, layers, seed: int, dtype_name: str):
    """One rank's logits and tokens (CPU tensors)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.distributed import sharding as sh
    from repro_torch.distributed import tensor_parallel as tpl
    from repro_torch.distributed.meshes import make_process_mesh
    from repro_torch.models import lm
    torch.backends.cuda.matmul.allow_tf32 = False
    dtype = getattr(torch, dtype_name)
    mesh = make_process_mesh((1, RANKS), ("data", "model"), device=dev)
    pol = sh.ShardingPolicy(mesh, sh.default_rules(False, fsdp=False))
    cfg = _config(get_arch, arch, layers)
    prompts = cs.tp_prompts(np, cfg, SLOTS, PROMPT, seed)
    params = tpl.init_shard_params(seed, cfg, pol, dtype, device=dev)
    with sh.use_policy(pol):
        steps, toks = cs.tp_greedy(torch, lm, params, cfg, prompts, NEW,
                                   dtype, dev)
    return {"steps": steps, "tokens": toks}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="deepseek-v2-lite-16b")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--dtypes", default="float32,bfloat16")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.distributed.launch import run_ranks
    from repro_torch.models import lm
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _config(get_arch, args.arch, args.layers)
    prompts = cs.tp_prompts(np, cfg, SLOTS, PROMPT, args.seed)
    for name in args.dtypes.split(","):
        t0 = time.perf_counter()
        dtype = getattr(torch, name)
        params = lm.init_params(args.seed, cfg, dtype, device="cuda")
        steps, toks = cs.tp_greedy(torch, lm, params, cfg, prompts, NEW,
                                   dtype, "cuda")
        del params
        torch.cuda.empty_cache()
        scale = float(steps.abs().max())
        top2 = steps[0].topk(2, -1).values
        print(f"{cfg.name} {cfg.n_layers} layers {name} unsharded: first "
              f"token's top-2 margins {(top2[:, 0] - top2[:, 1]).tolist()}"
              f", max |logit| {scale!r}", flush=True)
        res = run_ranks(rank, RANKS, backend="gloo", device="cuda",
                        args=(args.arch, args.layers, args.seed, name),
                        timeout_s=900.0)
        for r, out in enumerate(res):
            first = float((out["steps"][0] - steps[0]).abs().max())
            every = float((out["steps"] - steps).abs().max())
            agree = float((out["tokens"] == toks).float().mean())
            print(f"{cfg.name} {cfg.n_layers} layers {name} rank {r} of "
                  f"(data 1, model {RANKS}): first token's logits "
                  f"{first / scale!r}, all steps {every / scale!r} of max "
                  f"|logit|; greedy tokens equal to the unsharded run's "
                  f"{agree!r}", flush=True)
        print(f"{name}: {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
