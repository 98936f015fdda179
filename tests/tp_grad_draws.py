"""RWKV6's reduced gradients under a model axis over several draws, on gloo
ranks on the CPU: how far the fp32 runs part from a float64 run, and how
far the split parts from the unsharded port when both run float64
throughout (``tp_family_harness.float64_throughout``).

rwkv6-3b's ``reduced()`` at 6 WKV heads of 16 (d_model 96), as
tests/test_torch_tensor_parallel_inside.py widens it, on (data 1, model 2)
(3 whole heads a rank) and (1, 4) (1.5 heads a rank, split inside); the
port's own weights of each seed (``lm.init_params``) and the harness's
batch of that seed.  Each figure is the harness's ``worst`` with its
``FLOOR``: the largest |difference| of a leaf over that leaf's largest
entry (or 1e-3 of the tree's largest, where that is more), over every
gradient leaf.  Run from the repo's root:

    python tests/tp_grad_draws.py [--seeds 0 1 2 3]

prints one line a (model axis, seed): the unsharded fp32 port, the sharded
fp32 run and the sharded float64 run, each against the unsharded float64
run, and the leaf of the sharded fp32 run's largest gap."""
from __future__ import annotations

import argparse
import dataclasses
import pathlib
import sys

sys.path[:0] = [str(pathlib.Path(__file__).resolve().parent),
                str(pathlib.Path(__file__).resolve().parents[1] / "src")]

import torch  # noqa: E402

import tp_family_harness as H  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.distributed import sharding as sh  # noqa: E402
from repro_torch.distributed import tensor_parallel as tpl  # noqa: E402
from repro_torch.distributed.launch import run_ranks  # noqa: E402
from repro_torch.distributed.meshes import make_process_mesh  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.train import trainer as tr  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402

ARCH = "rwkv6-3b"


def config():
    return dataclasses.replace(get_arch(ARCH).reduced(), n_heads=6,
                               n_kv_heads=6, d_model=96)


def grads32(params, cfg, nb):
    _, grads = tr.value_and_grad(params, cfg, H.TC, H.torch_batch(nb))
    return opt.tree_unflatten(params, grads)


def rank(dev, model, seeds):
    """Each seed's gathered fp32 and float64 gradients on (1, ``model``)."""
    cfg = config()
    mesh = make_process_mesh((1, model), ("data", "model"), device=dev)
    pol = sh.ShardingPolicy(mesh, sh.default_rules(False, fsdp=False))
    out = {}
    with sh.use_policy(pol):
        for seed in seeds:
            nb = H.np_batch(cfg, seed)
            local = tpl.shard_params(lm.init_params(seed, cfg, device="cpu"),
                                     cfg, pol)
            out[seed] = [H.leaves(tpl.gather_params(g(local, cfg, nb), cfg,
                                                    pol))
                         for g in (grads32, H.grads64)]
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3])
    args = ap.parse_args()
    cfg = config()
    names = opt.tree_leaves(sh.map_with_path(
        lambda path, leaf, stack: path,
        lm.init_params(0, cfg, device="cpu")))
    for model in (2, 4):
        got = run_ranks(rank, model, backend="gloo", device="cpu",
                        args=(model, args.seeds), timeout_s=600)[0]
        for seed in args.seeds:
            nb = H.np_batch(cfg, seed)
            params = lm.init_params(seed, cfg, device="cpu")
            ref = H.leaves(H.grads64(params, cfg, nb))
            port = H.leaves(grads32(params, cfg, nb))
            g32, g64 = got[seed]
            errs = H.leaf_errs(g32, ref, H.FLOOR)
            print(f"model {model} seed {seed}: port fp32 "
                  f"{H.worst(port, ref, H.FLOOR):.3g}, split fp32 "
                  f"{max(errs):.3g} (at {names[errs.index(max(errs))]}), "
                  f"split float64 {H.worst(g64, ref, H.FLOOR):.3g}")


if __name__ == "__main__":
    main()
