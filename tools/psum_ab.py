"""Time ``collectives.psum`` (a reduce-scatter then an all-gather: an
all-to-all and an all-gather over gloo) against the form it replaced (one
all-gather of every member's input, then a sum in rank order) on gloo ranks
of the one card, both in one spawn, in turns (new, old, old, new).

1. The collective alone, at the shapes of phase 10's activation psums in
   bf16: a decode step's ``[4, 1, D]`` and a prefill's ``[4, 1024, D]``,
   at qwen2-72b's D 8,192 and RWKV6-3B's 2,560 on four ranks and at
   Qwen2-1.5B's 1,536 on eight; ms a call (the slowest rank's mean over
   ``--iters`` calls), and the two forms' bits compared.
2. Phase 10's timed bf16 serving rows end to end (``chip_smoke.py``'s
   depths, 4 x 1,024 prompts + 32 new tokens): (b) qwen2-72b, (f)
   DeepSeek-V2-Lite, (g) RWKV6-3B, (h) Whisper-large-v3 and (i) Hymba-1.5B
   on (data 1, model 4), (j) Qwen2-1.5B on (1, 8); TTFT and decode ms a
   step (the slowest rank's), each form twice.  The old form is put in
   place by replacing ``collectives.psum``, which the tensor-parallel
   layer calls through the module.  Needs the card:

    python tools/psum_ab.py [--iters 40] [--rows b f g h i j]

prints a line a case and one ``RESULT`` line of JSON."""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402

# (ranks, D) of the collective's cases; slots and prompt of the rows
COLLECTIVE = ((4, 8192), (4, 2560), (8, 1536))
ROWS = {"b": (cs.TP_ARCH, 4), "f": (cs.MOE_ARCH, 4),
        "g": ("rwkv6-3b", 4), "h": ("whisper-large-v3", 4),
        "i": ("hymba-1.5b", 4), "j": (cs.INSIDE_ARCH, 8)}
TURNS = ("new", "old", "old", "new")


def old_psum(x, mesh, axis):
    """The form psum had: every member's x all-gathered, then summed in
    rank order."""
    import torch.distributed as dist
    from repro_torch.distributed import collectives as col
    group = col._group(mesh, axis)
    parts = [x.new_empty(x.shape) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return col._ordered_sum(parts)


def collective_rank(dev, D: int, iters: int):
    """ms a call of each form at ``[4, 1, D]`` and ``[4, 1024, D]`` bf16,
    in turns, and whether the two forms' bits agree."""
    import torch
    from repro_torch.distributed import collectives as col
    from repro_torch.distributed.meshes import make_process_mesh
    mesh = make_process_mesh((1, col.dist.get_world_size()),
                             ("data", "model"), device=dev)
    forms = {"new": col.psum, "old": old_psum}
    gen = torch.Generator(device=dev).manual_seed(mesh.rank)
    out = {}
    for S in (1, 1024):
        x = torch.randn(4, S, D, generator=gen, device=dev).to(
            torch.bfloat16)
        same = torch.equal(forms["new"](x, mesh, "model"),
                           forms["old"](x, mesh, "model"))
        ms = {"new": [], "old": []}
        for form in TURNS:
            col.dist.barrier()
            _, t = cs.wall(torch, lambda: [forms[form](x, mesh, "model")
                                           for _ in range(iters)])
            ms[form].append(t / iters)
        out[S] = {"same_bits": same, **ms}
    return out


def row_config(get_arch, part: str):
    arch, _ = ROWS[part]
    if part == "b":
        return cs.tp_config(get_arch, cs.TP_TIMED[0])
    if part == "f":
        return cs.moe_config(get_arch, cs.MOE_TIMED[0])
    return cs.family_config(get_arch, arch, cs.FAMILY_TIMED[0])


def row_rank(dev, part: str, seed: int):
    """One rank's TTFT and generate walls of ``part``'s timed bf16 serving
    under each form, in turns."""
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.distributed import collectives as col
    from repro_torch.distributed import sharding as sh
    from repro_torch.distributed import tensor_parallel as tpl
    from repro_torch.distributed.meshes import make_process_mesh
    from repro_torch.serve import engine as serve
    torch.backends.cuda.matmul.allow_tf32 = False
    _, ranks = ROWS[part]
    _, _, slots, plen, new = cs.FAMILY_TIMED
    mesh = make_process_mesh((1, ranks), ("data", "model"), device=dev)
    pol = sh.ShardingPolicy(mesh, sh.default_rules(False, fsdp=False))
    cfg = row_config(get_arch, part)
    prompts = cs.tp_prompts(np, cfg, slots, plen, seed)
    frames = cs.family_frames(torch, np, cfg, slots, seed, dev)
    params = tpl.init_shard_params(seed, cfg, pol, torch.bfloat16,
                                   device=dev)
    forms = {"new": col.psum, "old": old_psum}
    out = {"new": [], "old": []}
    with sh.use_policy(pol):
        eng = serve.ServeEngine(cfg, params, slots, plen + new,
                                torch.bfloat16, device=dev)
        gen = lambda n: eng.generate(prompts, n, enc_frames=frames)
        try:
            for form in TURNS:
                col.psum = forms[form]
                gen(2)                                    # warm-up
                col.dist.barrier()
                _, ttft = cs.wall(torch, lambda: gen(1))
                col.dist.barrier()
                toks, gen_ms = cs.wall(torch, lambda: gen(new))
                out[form].append((ttft, gen_ms, toks))
        finally:
            col.psum = forms["new"]
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=40)
    ap.add_argument("--rows", nargs="*", default=list(ROWS))
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.distributed.launch import run_ranks
    cs.check(torch.cuda.is_available(), "no CUDA device")
    t0 = time.perf_counter()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    result = {"card": card, "collective": [], "rows": {}}
    for ranks, D in COLLECTIVE:
        per = run_ranks(collective_rank, ranks, backend="gloo",
                        device="cuda", args=(D, args.iters), timeout_s=600)
        for S in (1, 1024):
            row = {"ranks": ranks, "shape": [4, S, D], "dtype": "bfloat16",
                   "same_bits": all(p[S]["same_bits"] for p in per)}
            for form in ("new", "old"):
                turns = [max(p[S][form][i] for p in per) for i in range(2)]
                row[f"{form}_ms"] = sum(turns) / 2
                row[f"{form}_ms_turns"] = turns
            print(json.dumps(row), flush=True)
            result["collective"].append(row)
    _, _, slots, plen, new = cs.FAMILY_TIMED
    for part in args.rows:
        arch, ranks = ROWS[part]
        per = run_ranks(row_rank, ranks, backend="gloo", device="cuda",
                        args=(part, args.seed), timeout_s=900)
        row = {"part": part, "arch": arch, "ranks": ranks,
               "layers": row_config(get_arch, part).n_layers,
               "same_tokens": all(np.array_equal(p["new"][i][2],
                                                 p["old"][i][2])
                                  for p in per for i in range(2))}
        for form in ("new", "old"):
            ttft = [max(p[form][i][0] for p in per) for i in range(2)]
            step = [max((p[form][i][1] - p[form][i][0]) / (new - 1)
                        for p in per) for i in range(2)]
            row[f"{form}_ttft_ms"] = ttft
            row[f"{form}_decode_ms_per_step"] = step
        print(json.dumps(row), flush=True)
        result["rows"][part] = row
    result["seconds"] = time.perf_counter() - t0
    print("RESULT " + json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
