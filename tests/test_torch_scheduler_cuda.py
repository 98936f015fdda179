"""The scheduler's annealer on the card: ``SchemeChooser(placement_solver=
"anneal")`` places every hybrid candidate with the annealer on ``cuda`` by
default, and a seeded ``run_scheduled`` stream gives the same decisions,
``JobStats`` and trace as the same stream with the annealer on the CPU
(the chains draw from a host generator, so they take the same steps on
either device).  Needs a CUDA card (the ``cuda`` marker; skipped without
one) and imports no JAX:

    python -m pytest -q -m cuda tests/test_torch_scheduler_cuda.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import placement as pl
from repro_torch import sim
from repro_torch.core.coded_collectives import plan_cache_clear
from repro_torch.core.params import SchemeParams

COST = sim.CostModel(map=sim.PhaseCoeffs(1e-3, 2e-9),
                     pack=sim.PhaseCoeffs(5e-4, 1e-9),
                     reduce=sim.PhaseCoeffs(1e-4, 1e-9),
                     plan_compile=sim.PhaseCoeffs(2e-3, 5e-6))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the annealer's default device")
    return torch.device("cuda")


def _stream(device, n_jobs=3, seed=0):
    plan_cache_clear()
    topo = sim.RackTopology(P=4, cross_bw=1e5, intra_bw=1e7)
    cluster = sim.ClusterSim(topo, 8, COST, sim.ExponentialTail(0.5), seed)
    kw = {} if device is None else {"placement_device": device}
    # hybrid only: every admission is placed, so the placement reaches the
    # job's stats
    chooser = sim.SchemeChooser(8, cost_model=COST, rs=(2, 3),
                                schemes=("hybrid",),
                                placement_solver="anneal", **kw)
    jobs = sim.PoissonWorkload(sim.default_catalog(8, 4), n_jobs,
                               rate=4.0).generate(seed)
    stats, sched = sim.run_scheduled(jobs, cluster, chooser)
    return (chooser.placement_device,
            [dataclasses.asdict(s) for s in stats],
            {k: dataclasses.asdict(d) for k, d in sched.decisions.items()},
            [dataclasses.astuple(e) for e in cluster.tracer.events])


@pytest.mark.cuda
def test_anneal_stream_on_the_card_equals_the_cpu(card):
    dev, *on_card = _stream(None)
    assert dev.type == "cuda"
    dev_cpu, *on_cpu = _stream("cpu")
    assert dev_cpu.type == "cpu"
    assert on_card == on_cpu


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 3])
def test_anneal_perm_on_the_card_equals_the_cpu(card, seed):
    """From a poor warm start the chains must climb, and take the same
    steps on both devices."""
    p = SchemeParams(8, 4, 8, 96, 2, r_f=2)
    C = pl.locality_matrix(p, pl.place_replicas(p,
                                                np.random.default_rng(seed)))
    bad = np.argsort(-C[:, 0], kind="stable")
    kw = dict(n_chains=16, n_steps=400, init=[bad])
    out = pl.anneal_perm(p, C, np.random.default_rng(seed), device="cuda",
                         **kw)
    cpu = pl.anneal_perm(p, C, np.random.default_rng(seed), device="cpu",
                         **kw)
    assert np.array_equal(out, cpu)
    assert pl.perm_objective(p, C, out) > pl.perm_objective(p, C, bad)
