"""The placement engine on the card: the annealer on ``cuda`` (valid
permutations, an objective >= every warm start's, the flow warm start
returned exactly, one output per seed, no host synchronisation inside the
step loop), and a small placed ``run_job_distributed`` bit-identical to
the identity placement with the combine kernels launched.  Needs a CUDA
card (the ``cuda`` marker; skipped without one) and imports no JAX:

    python -m pytest -q -m cuda tests/test_torch_placement_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch import placement as pl
from repro_torch.core.assignment import (check_hybrid_constraints,
                                         hybrid_assignment,
                                         hybrid_group_of_slot)
from repro_torch.core.coded_collectives import compile_hybrid_plan
from repro_torch.core.params import SchemeParams
from repro_torch.distributed.meshes import make_mesh
from repro_torch.kernels.coded_combine import ops
from repro_torch.mapreduce import engine as eng
from repro_torch.mapreduce import jobs
from repro_torch.placement.solvers import anneal_chains

P16 = SchemeParams(16, 4, 16, 192, 2, r_f=3)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the annealer's default device")
    return torch.device("cuda")


def _instance(p=P16, seed=0):
    replicas = pl.place_replicas(p, np.random.default_rng(seed), "hdfs")
    return replicas, pl.locality_matrix(p, replicas)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1])
def test_anneal_on_the_card_invariants(card, seed):
    _, C = _instance(seed=seed)
    greedy = pl.greedy_perm(P16, C)
    kw = dict(n_chains=32, n_steps=400, init=[greedy])
    out = pl.anneal_perm(P16, C, np.random.default_rng(seed), **kw)
    assert sorted(out.tolist()) == list(range(P16.N))
    check_hybrid_constraints(hybrid_assignment(P16, out.tolist()))
    assert pl.perm_objective(P16, C, out) >= \
        pl.perm_objective(P16, C, greedy)
    again = pl.anneal_perm(P16, C, np.random.default_rng(seed), **kw)
    assert np.array_equal(out, again)
    explicit = pl.anneal_perm(P16, C, np.random.default_rng(seed),
                              device="cuda", **kw)
    assert np.array_equal(out, explicit)


@pytest.mark.cuda
def test_anneal_on_the_card_returns_the_flow_warm_start(card):
    p = SchemeParams(8, 4, 8, 96, 2, r_f=2)
    res = pl.solve(p, pl.place_replicas(p, np.random.default_rng(0)),
                   "anneal", init_solvers=("flow", "greedy"), n_chains=16,
                   n_steps=300)
    flow = pl.solve(p, res.replicas, "flow")
    assert np.array_equal(res.perm, flow.perm)
    assert res.objective == flow.objective


@pytest.mark.cuda
def test_anneal_steps_never_synchronise(card):
    """Every step of the chains queues on the card: under
    ``set_sync_debug_mode("error")`` a host read in the loop would raise."""
    _, C = _instance()
    gos = torch.as_tensor(hybrid_group_of_slot(P16), dtype=torch.int64,
                          device=card)
    base = torch.as_tensor(np.stack([pl.greedy_perm(P16, C)] + [
        np.random.default_rng(k).permutation(P16.N) for k in range(7)]),
        device=card)
    Ct = torch.as_tensor(C, dtype=torch.float32, device=card)
    temps = torch.as_tensor(np.geomspace(1.0, 1e-3, 200),
                            dtype=torch.float32, device=card)
    gen = torch.Generator(device=card)
    gen.manual_seed(3)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        best = anneal_chains(base, Ct, gos, temps, gen)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert best.device.type == "cuda"
    assert (best.sort(dim=1).values == torch.arange(P16.N,
                                                    device=card)).all()


@pytest.mark.cuda
@pytest.mark.parametrize("r", [2, 3])
def test_placed_job_on_the_card_bit_identical(card, r):
    p = SchemeParams(K=8, P=4, Q=16, N=48, r=r, r_f=3)
    replicas, C = _instance(p=p)
    res = pl.solve(p, replicas, "anneal", C=C, n_chains=16, n_steps=300)
    assert res.objective >= pl.solve(p, replicas, "greedy", C=C).objective
    mesh = make_mesh((p.P, p.Kr), ("rack", "server"))
    subfiles = np.random.default_rng(r).integers(
        0, 1 << 16, size=(p.N, 256)).astype(np.int32)
    job = jobs.wide_histogram_job(32)
    kw = dict(fused=True, multicast="coded", combine_impl="kernel")
    ident = eng.run_job_distributed(job, subfiles, p, mesh, **kw)
    ops.reset_launch_counts()
    placed = eng.run_job_distributed(job, subfiles, p, mesh, placement=res,
                                     **kw)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["coded_encode"] == ops.LAUNCHES["coded_decode"] == 1
    assert torch.equal(placed.outputs, ident.outputs)
    dense = eng.run_job(job, subfiles, p, "hybrid").outputs
    assert torch.equal(placed.outputs, dense)
    plan = compile_hybrid_plan(p, perm=res.perm)
    a = hybrid_assignment(p, res.perm.tolist())
    for i in range(p.P):
        for j in range(p.Kr):
            assert sorted(plan.local_subfiles[i, j].tolist()) == \
                sorted(a.subfiles_of_server[p.server_id(i, j)])
