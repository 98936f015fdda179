"""The trainer's data-parallel modes on a process mesh: four gloo ranks on
the CPU (spawned once for the file, as tests/test_torch_distributed.py
spawns them), reduced qwen2, a global batch of 12 x 16 tokens.  Each mode's
gradient and loss against the single-process full-batch step's: 'coded_r2'
over a ('rack',) mesh of four racks with no failure and with each rack
failed, 'dp' and 'replicated' over a (2, 2) ('rack', 'server') mesh; all
within 1e-5 of the tree's largest gradient (fp32; the chunks and slices
sum in other orders).  One full ``make_train_step`` step a mode leaves
every rank with the same parameters.  The rank function imports no JAX."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.data.pipeline import SyntheticPipeline
from repro_torch.distributed.launch import run_ranks
from repro_torch.distributed.meshes import make_process_mesh
from repro_torch.train.optimizer import OptimizerConfig, tree_leaves
from repro_torch.train.trainer import (TrainConfig, _mesh_grads,
                                       accumulate_grads, coded_grads_r2,
                                       init_train_state, make_coded_batch_r2,
                                       make_train_step)

pytestmark = pytest.mark.slow

RANKS = 4
FAILED = [None, 0, 1, 2, 3]
TOL = 1e-5


def _setup(dev):
    cfg = get_arch("qwen2-1.5b").reduced()
    tc = TrainConfig(n_microbatches=1, remat=False, dense_moe=True,
                     opt=OptimizerConfig(lr=1e-3, warmup_steps=2,
                                         decay_steps=50))
    state = init_train_state(0, cfg, tc, device=dev)
    batch = SyntheticPipeline(cfg, 12, 16, device=dev).batch_at(0)
    return cfg, tc, state, batch


def _np(tree):
    return [x.detach().cpu().numpy() for x in tree_leaves(tree)]


def _rank(dev):
    """Every mode's gradients and loss in this rank, and one full step's
    parameters a mode."""
    cfg, tc, state, batch = _setup(dev)
    racks = make_process_mesh((RANKS,), ("rack",), device=dev)
    grid = make_process_mesh((2, 2), ("rack", "server"), device=dev)
    coded = make_coded_batch_r2(batch, RANKS)
    out = {}
    for failed in FAILED:
        g, loss = coded_grads_r2(state["params"], cfg, tc, coded, racks,
                                 failed=failed)
        out[("coded_r2", failed)] = (_np(g), float(loss))
    for mode in ("dp", "replicated"):
        tcm = dataclasses.replace(tc, dp_mode=mode)
        g, loss = _mesh_grads(state["params"], cfg, tcm, batch, grid)
        out[(mode, None)] = (_np(g), float(loss))
    steps = {}
    for mode, mesh, b in (("coded_r2", racks, coded), ("dp", grid, batch),
                          ("replicated", grid, batch)):
        tcm = dataclasses.replace(tc, dp_mode=mode)
        new, m = make_train_step(cfg, tcm, mesh=mesh)(state, b)
        steps[mode] = (_np(new["params"]), float(m["loss"]))
    return out, steps


@pytest.fixture(scope="module")
def ranks():
    return run_ranks(_rank, RANKS, backend="gloo", device="cpu",
                     timeout_s=300)


@pytest.fixture(scope="module")
def reference():
    cfg, tc, state, batch = _setup(torch.device("cpu"))
    g, loss = accumulate_grads(state["params"], cfg, tc, batch)
    return _np(g), float(loss)


@pytest.mark.parametrize("mode,failed", [("coded_r2", f) for f in FAILED]
                         + [("dp", None), ("replicated", None)])
def test_mode_equals_the_full_batch_step(ranks, reference, mode, failed):
    want, want_loss = reference
    scale = max(float(np.abs(w).max()) for w in want)
    for rank, (out, _) in enumerate(ranks):
        got, loss = out[(mode, failed)]
        worst = max(float(np.abs(a - b).max()) for a, b in zip(got, want))
        assert worst <= TOL * scale, (rank, mode, failed, worst / scale)
        assert abs(loss - want_loss) <= 1e-5 * abs(want_loss)


@pytest.mark.parametrize("mode", ["coded_r2", "dp", "replicated"])
def test_a_step_leaves_every_rank_the_same(ranks, mode):
    params0, loss0 = ranks[0][1][mode]
    for _, steps in ranks[1:]:
        params, loss = steps[mode]
        assert loss == loss0
        assert all(np.array_equal(a, b) for a, b in zip(params, params0))
