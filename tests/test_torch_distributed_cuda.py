"""The process form on the card: 8 ranks on ``cuda:0`` (gloo; NCCL refuses
two ranks on one device) at K=8, P=4, Q=16, N=48.  In every rank the coded
shuffle launches the combine kernels (one encode and one decode a shuffle,
never a plain version) and stays bit-exact against the port's NumPy
oracle; ``run_job_distributed`` fused and legacy equals the dense
``run_job``; ``coded_reduce_scatter_r2(combine_impl='kernel')`` launches
``coded_encode`` once per destination rack and its survivors hold the
NumPy total.  Needs a CUDA card (the ``cuda`` marker; skipped without one)
and imports no JAX:

    python -m pytest -q -m cuda tests/test_torch_distributed_cuda.py
"""
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.core import coded_collectives as cc
from repro_torch.core import gradient_sync as gs
from repro_torch.core.params import SchemeParams
from repro_torch.distributed.launch import run_ranks
from repro_torch.distributed.meshes import make_process_mesh
from repro_torch.kernels.coded_combine import ops
from repro_torch.mapreduce import engine as eng
from repro_torch.mapreduce import jobs

KPQN = (8, 4, 16, 48)
SHUFFLES = [(r, mc) for r in (2, 3) for mc in ("coded", "coded_xor")]
G = 4 * 1024


def _payload(p, multicast):
    rng = np.random.default_rng(p.r)
    if multicast == "coded_xor":
        return rng.integers(0, 2 ** 30, size=(p.N, p.Q, 64)).astype(np.int32)
    return rng.integers(-100, 100, size=(p.N, p.Q, 64)).astype(np.float32)


def _chunks():
    rng = np.random.default_rng(5)
    return rng.integers(-1000, 1000, size=(6, G)).astype(np.float32)


def _counted(fn):
    ops.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, dict(ops.LAUNCHES)


def _rank_on_card(dev):
    out = {"device": str(dev), "shuffle": {}, "engine": {}}
    for r, mc in SHUFFLES:
        p = SchemeParams(*KPQN, r=r)
        plan = cc.compile_hybrid_plan(p)
        mesh = make_process_mesh((p.P, p.Kr), ("rack", "server"), device=dev)
        V = _payload(p, mc)
        got, launches = _counted(lambda: cc.hybrid_shuffle(
            V[plan.local_subfiles[mesh.coords]], plan, mesh, mc, "kernel"))
        out["shuffle"][r, mc] = (got.cpu(), launches)
    p = SchemeParams(*KPQN, r=2)
    mesh = make_process_mesh((p.P, p.Kr), ("rack", "server"), device=dev)
    subs = np.random.default_rng(4).integers(
        0, 1 << 16, size=(p.N, 64)).astype(np.int32)
    job = jobs.wide_histogram_job(64)
    out["dense"] = eng.run_job(job, subs, p, "hybrid",
                               device=dev).outputs.cpu()
    for fused in (True, False):
        res, launches = _counted(lambda: eng.run_job_distributed(
            job, subs, p, mesh, fused=fused, multicast="coded",
            combine_impl="kernel"))
        out["engine"][fused] = (res.outputs.cpu(), launches)
    cg = torch.as_tensor(_chunks()[gs.chunk_index_table(p.P)[
        mesh.axis_index("rack")]], device=dev)
    out["crs"] = {}
    for failed in (None, 3):
        shard, launches = _counted(lambda: gs.coded_reduce_scatter_r2(
            cg, mesh, "rack", p.P, failed=failed, combine_impl="kernel"))
        out["crs"][failed] = (shard.cpu(), launches)
    out["world"] = dist.get_world_size()
    return out


@pytest.fixture(scope="module")
def ranks():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    return run_ranks(_rank_on_card, KPQN[0], backend="gloo", device="cuda",
                     timeout_s=300)


def _want(**on):
    want = dict.fromkeys(ops.LAUNCHES, 0)
    want.update(on)
    return want


@pytest.mark.cuda
@pytest.mark.parametrize("r,multicast", SHUFFLES)
def test_coded_shuffle_launches_the_kernels_in_every_rank(ranks, r,
                                                          multicast):
    p = SchemeParams(*KPQN, r=r)
    ref = cc.plan_shuffle_reference(_payload(p, multicast), p)
    pair = ("xor_encode", "xor_decode") if multicast == "coded_xor" else \
        ("coded_encode", "coded_decode")
    for s, res in enumerate(ranks):
        assert res["device"] == "cuda:0"
        got, launches = res["shuffle"][r, multicast]
        np.testing.assert_array_equal(got.numpy(), ref[s])
        assert launches == _want(**dict.fromkeys(pair, 1))


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "legacy"])
def test_engine_on_the_card_equals_run_job(ranks, fused):
    for res in ranks:
        got, launches = res["engine"][fused]
        assert torch.equal(got, ranks[0]["dense"])
        assert launches == _want(coded_encode=1, coded_decode=1)


@pytest.mark.cuda
@pytest.mark.parametrize("failed", [None, 3])
def test_coded_reduce_scatter_launches_one_encode_per_rack(ranks, failed):
    total = _chunks().sum(axis=0).reshape(4, -1)
    for s, res in enumerate(ranks):
        shard, launches = res["crs"][failed]
        assert launches == _want(coded_encode=4)
        if s // 2 != failed:
            np.testing.assert_array_equal(shard.numpy(), total[s // 2])
