"""Hold a tensor-parallel model against the unsharded one at full depth,
to tell a fault from rounding where a bf16 run's greedy tokens part.

For each dtype, the unsharded port (this process) and the same weights
cut over four gloo ranks on (data 1, model 4) of the one card
(``tensor_parallel.init_shard_params``, the same ``--seed``) run
``chip_smoke.py``'s ``tp_greedy``: ``prefill`` of SLOTS x PROMPT tokens
(and, for Whisper, of its 1,500 stub frames) and NEW greedy
``decode_step``s.  Prints, a line each, the unsharded run's top-2 logit
margins of the first token, its largest |logit| and its wall (in fp32
also the same run with its embedding moved by PERTURB relative, about an
ulp: how far the model itself carries a rounding), then every
rank's largest |logit - unsharded| of the first token and of all steps,
against that largest |logit|, the share of greedy tokens equal to the
unsharded run's, and the rank's wall (host ms, the card synchronised on
both sides; the first call of a process, so it holds the kernels' first
launches).  Needs the card:

    python tools/tp_depth_probe.py [--arch deepseek-v2-lite-16b]
        [--layers N] [--dtypes float32,bfloat16] [--seed 0]

``--arch`` also takes rwkv6-3b, whisper-large-v3 and hymba-1.5b (phase
10 (g), (h) and (i) at full depth).  ``--layers`` cuts the depth
(default: all the arch's layers; Whisper's encoder and decoder each).
The prompt length is that of the arch's fp32 check in phase 10
(``chip_smoke.family_check``: 2,560 for Hymba, past its 2,048 window,
else 256).  At
DeepSeek-V2-Lite's full depth the unsharded fp32 weights take 62.8 GB of
the card and are freed before the ranks draw theirs.
"""
from __future__ import annotations

import argparse
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402

SLOTS, NEW, RANKS = 2, 8, 4
PERTURB = 1e-7


def rank(dev, arch: str, layers, prompt: int, seed: int, dtype_name: str):
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
    cfg = cs.family_config(get_arch, arch, layers)
    prompts = cs.tp_prompts(np, cfg, SLOTS, prompt, seed)
    frames = cs.family_frames(torch, np, cfg, SLOTS, seed, dev)
    params = tpl.init_shard_params(seed, cfg, pol, dtype, device=dev)
    with sh.use_policy(pol):
        (steps, toks), ms = cs.wall(torch, lambda: cs.tp_greedy(
            torch, lm, params, cfg, prompts, NEW, dtype, dev,
            enc_frames=frames))
    return {"steps": steps, "tokens": toks, "ms": ms}


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
    cfg = cs.family_config(get_arch, args.arch, args.layers)
    prompt = cs.family_check(args.arch)[3]
    prompts = cs.tp_prompts(np, cfg, SLOTS, prompt, args.seed)
    frames = cs.family_frames(torch, np, cfg, SLOTS, args.seed, "cuda")
    for name in args.dtypes.split(","):
        t0 = time.perf_counter()
        dtype = getattr(torch, name)
        params = lm.init_params(args.seed, cfg, dtype, device="cuda")
        run = lambda: cs.tp_greedy(torch, lm, params, cfg, prompts, NEW,
                                   dtype, "cuda", enc_frames=frames)
        (steps, toks), ms = cs.wall(torch, run)
        scale = float(steps.abs().max())
        top2 = steps[0].topk(2, -1).values
        print(f"{cfg.name} {cfg.n_layers} layers {name} {SLOTS} x {prompt} "
              f"tokens unsharded: first "
              f"token's top-2 margins {(top2[:, 0] - top2[:, 1]).tolist()}"
              f", max |logit| {scale!r}, wall {ms!r} ms", flush=True)
        if dtype == torch.float32:
            # the model's own sensitivity to rounding: the unsharded run
            # again with its embedding moved by about an ulp (1e-7
            # relative)
            gen = torch.Generator(device="cuda").manual_seed(args.seed)
            params["embed"].mul_(1 + PERTURB * torch.randn(
                params["embed"].shape, generator=gen, device="cuda"))
            moved, _ = run()
            print(f"{cfg.name} {cfg.n_layers} layers {name} unsharded, "
                  f"embedding moved by {PERTURB} relative: all steps "
                  f"{float((moved - steps).abs().max()) / scale!r} of max "
                  f"|logit|", flush=True)
        del params
        torch.cuda.empty_cache()
        res = run_ranks(rank, RANKS, backend="gloo", device="cuda",
                        args=(args.arch, args.layers, prompt, args.seed,
                              name),
                        timeout_s=900.0)
        for r, out in enumerate(res):
            first = float((out["steps"][0] - steps[0]).abs().max())
            every = float((out["steps"] - steps).abs().max())
            agree = float((out["tokens"] == toks).float().mean())
            print(f"{cfg.name} {cfg.n_layers} layers {name} rank {r} of "
                  f"(data 1, model {RANKS}): first token's logits "
                  f"{first / scale!r}, all steps {every / scale!r} of max "
                  f"|logit|; greedy tokens equal to the unsharded run's "
                  f"{agree!r}; wall {out['ms']!r} ms", flush=True)
        print(f"{name}: {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
