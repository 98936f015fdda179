"""The process form of the port's shuffle and engine: one server a process,
'rack' and 'server' as ``torch.distributed`` process groups (gloo, on the
CPU), held bit for bit against the JAX package's oracles
(``plan_shuffle_reference``, ``simulate_plan_shuffle``), the port's stacked
``hybrid_shuffle`` and the JAX ``run_job``; the group-rank order; the mesh
checks; the r = 2 aliases on both kinds of mesh; and the launcher's
failure, time-limit and argument rules.

The ranks are spawned once per world size for the whole file (8 ranks for
K = 8, 12 for K = 12), each bounded by the launcher's time limit.  The rank
functions import nothing of JAX, so the ranks do not load it; the JAX side
runs in the test process.
"""
import itertools
import multiprocessing
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.core import coded_collectives as tcc
from repro_torch.core.params import SchemeParams
from repro_torch.distributed.collectives import all_to_all
from repro_torch.distributed.launch import RankError, run_ranks
from repro_torch.distributed.meshes import make_mesh, make_process_mesh
from repro_torch.kernels.coded_combine import ops
from repro_torch.mapreduce import engine as teng
from repro_torch.mapreduce import jobs as tjobs
from repro_torch.obs.tracing import enable_tracing
from repro_torch.resilience import FaultInjector, FaultSpec

pytestmark = pytest.mark.slow

RANKS_TIMEOUT_S = 300
PLANS = {8: [("binomial", (8, 4, 16, 48, r)) for r in (1, 2, 3)]
         + [("resolvable", (8, 8, 16, 64, 2))],
         12: [("resolvable", (12, 6, 24, 48, 3)),
              ("resolvable", (12, 6, 24, 48, 2))]}
SHUFFLE_CASES = [(world, family, kpqnr)
                 for world, plans in PLANS.items()
                 for family, kpqnr in plans]
PAIRINGS = list(itertools.product(("unicast", "coded", "coded_xor"),
                                  ("torch", "kernel")))
KPQN = (8, 4, 16, 48)
ENGINE_CASES = list(itertools.product(
    (True, False), (1, 2, 3), ("histogram", "groupby_mean"),
    (("unicast", "torch"), ("coded", "kernel"))))
# the tolerances of tests/multidevice/driver_shuffle.py: integer histograms
# exact, float group-by means to rtol 1e-5
ENGINE_RTOL = {"histogram": 0.0, "groupby_mean": 1e-5}
# (shape, names) of the meshes whose group order is pinned, by world size
GROUP_MESHES = {8: [((4, 2), ("rack", "server")), ((8, 1), ("rack", "server")),
                    ((2, 4), ("pod", "data"))],
                12: [((6, 2), ("rack", "server"))]}


def _payload(p, multicast, seed, d=3):
    rng = np.random.default_rng(seed)
    if multicast == "coded_xor":
        return rng.integers(0, 2 ** 30, size=(p.N, p.Q, d)).astype(np.int32)
    # integer-valued float32: every order of sums is exact
    return rng.integers(-100, 100, size=(p.N, p.Q, d)).astype(np.float32)


def _seed(kpqnr, multicast):
    return sum(kpqnr) + len(multicast)


def _engine_inputs(job: str, N: int) -> np.ndarray:
    rng = np.random.default_rng(sum(map(ord, job)))
    if job == "histogram":
        return rng.integers(0, 1 << 16, size=(N, 64)).astype(np.int32)
    return (rng.normal(size=(N, 64, 2)) * 100).astype(np.float32)


def _job(name: str):
    return {"histogram": tjobs.histogram_job,
            "groupby_mean": tjobs.groupby_mean_job}[name]()


def _error(fn):
    """(exception type name, message) of ``fn()``, or None if it returned."""
    try:
        fn()
    except Exception as e:                  # reported to the test process
        return type(e).__name__, str(e)
    return None


# ---------------------------------------------------------------------------
# What each rank runs (module level: the ranks import it by name)
# ---------------------------------------------------------------------------

def _rank_cases(dev, world):
    out = {"rank": dist.get_rank(), "world": dist.get_world_size(),
           "shuffle": {}, "engine": {}, "groups": {}}
    ops.reset_launch_counts()
    # ---- group order: every mesh of this world, in one order on all ranks
    for shape, names in GROUP_MESHES[world]:
        mesh = make_process_mesh(shape, names, device=dev)
        order = {}
        for name in names:
            g = mesh.group(name)
            # who sits at each position of the group, by exchange
            got = all_to_all(torch.full((mesh.axis_size(name),), mesh.rank),
                             mesh, name)
            order[name] = (dist.get_rank(g),
                           dist.get_process_group_ranks(g), got.tolist())
        out["groups"][shape] = (mesh.coords, order)
    # ---- the shuffle, every pairing
    for family, kpqnr in PLANS[world]:
        p = SchemeParams(*kpqnr)
        plan = tcc.compile_hybrid_plan(p, family=family)
        mesh = make_process_mesh((p.P, p.Kr), ("rack", "server"),
                                 device=dev)
        i, j = mesh.coords
        for mc, impl in PAIRINGS:
            V = _payload(p, mc, _seed(kpqnr, mc))
            got = tcc.hybrid_shuffle(V[plan.local_subfiles[i, j]], plan,
                                     mesh, mc, impl)
            out["shuffle"][family, kpqnr, mc, impl] = got
    if world == 8:
        out.update(_rank_engine_and_checks(dev))
    out["launches"] = dict(ops.LAUNCHES)
    return out


def _rank_engine_and_checks(dev):
    out = {"engine": {}}
    p = SchemeParams(*KPQN, r=2)
    mesh = make_process_mesh((p.P, p.Kr), ("rack", "server"), device=dev)
    for fused, r, job, (mc, impl) in ENGINE_CASES:
        res = teng.run_job_distributed(
            _job(job), _engine_inputs(job, p.N), p, mesh, r=r, fused=fused,
            multicast=mc, combine_impl=impl)
        out["engine"][fused, r, job, mc, impl] = (
            res.outputs, res.intra_cost, res.cross_cost, res.scheme,
            res.intra_rack_bytes, res.cross_rack_bytes)
    # the engine's spans land in this rank's own tracer
    tracer = enable_tracing(True)
    try:
        blame = {fused: set(teng.run_job_distributed(
            _job("histogram"), _engine_inputs("histogram", p.N), p, mesh,
            fused=fused).blame) for fused in (True, False)}
    finally:
        enable_tracing(False)
    out["blame"] = blame
    out["span_phases"] = sorted({e.phase for e in tracer.events
                                 if e.kind == "engine_phase"})
    # the r = 2 aliases: the same plan object, the same program
    V = _payload(p, "unicast", 2)
    plan = tcc.compile_hybrid_plan(p)
    plan_r2 = tcc.compile_hybrid_plan_r2(p)
    local = V[plan.local_subfiles[mesh.coords]]
    out["alias"] = (plan_r2 is plan,
                    tcc.hybrid_shuffle_r2(local, plan_r2, mesh),
                    tcc.hybrid_shuffle(local, plan, mesh))
    # the checks a mismatched mesh or an unported option must fail
    subs = _engine_inputs("histogram", p.N)
    job = _job("histogram")
    bad = make_process_mesh((p.Kr, p.P), ("rack", "server"), device=dev)
    unnamed = make_process_mesh((p.P, p.Kr), ("x", "y"), device=dev)
    out["errors"] = {
        "shape": _error(lambda: teng.run_job_distributed(job, subs, p,
                                                         bad)),
        "names": _error(lambda: teng.run_job_distributed(job, subs, p,
                                                         unnamed)),
        "faults": _error(lambda: teng.run_job_distributed(
            job, subs, p, mesh, faults=FaultSpec(FaultInjector.crash((3,))))),
        "phase_timings": _error(lambda: teng.measure_phase_timings(
            job, subs, p, mesh)),
        "world": _error(lambda: make_process_mesh(
            (3, 2), ("rack", "server"), device=dev)),
        "rows": _error(lambda: tcc.hybrid_shuffle(V[:5], plan, mesh)),
        "no_device": _error(lambda: make_process_mesh(
            (p.P, p.Kr), ("rack", "server"))),
    }
    return out


def _rank_raises(dev):
    if dist.get_rank() == 1:
        raise ValueError("planted failure in rank 1")
    dist.barrier()                 # rank 0 waits here for a rank that died


def _rank_hangs(dev):
    if dist.get_rank() == 1:
        time.sleep(3600)
    return dist.get_rank()


@pytest.fixture(scope="module")
def ranks():
    """Every rank's results, by world size: one spawn each."""
    return {world: run_ranks(_rank_cases, world, backend="gloo",
                             device="cpu", args=(world,),
                             timeout_s=RANKS_TIMEOUT_S)
            for world in PLANS}


# ---------------------------------------------------------------------------
# The shuffle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world,family,kpqnr", SHUFFLE_CASES)
@pytest.mark.parametrize("multicast,combine_impl", PAIRINGS)
def test_process_shuffle_bit_exact_vs_jax_oracles_and_stacked(
        ranks, world, family, kpqnr, multicast, combine_impl):
    from repro.core import coded_collectives as jcc
    from repro.core.params import SchemeParams as JParams
    jp = JParams(*kpqnr)
    V = _payload(jp, multicast, _seed(kpqnr, multicast))
    ref = jcc.plan_shuffle_reference(V, jp, family=family)
    sim = jcc.simulate_plan_shuffle(
        V, jcc.compile_hybrid_plan(jp, family=family), multicast)
    plan = tcc.compile_hybrid_plan(SchemeParams(*kpqnr), family=family)
    stacked = tcc.hybrid_shuffle(
        tcc.pack_local_values(V, plan), plan,
        make_mesh((jp.P, jp.Kr), ("rack", "server"), device="cpu"),
        multicast, combine_impl).numpy()
    assert len(ranks[world]) == jp.K
    for s, res in enumerate(ranks[world]):
        got = res["shuffle"][family, kpqnr, multicast, combine_impl]
        assert got.dtype == torch.from_numpy(V).dtype
        np.testing.assert_array_equal(got.numpy(), ref[s])
        np.testing.assert_array_equal(got.numpy(), sim[s])
        np.testing.assert_array_equal(got.numpy(), stacked[s])


@pytest.mark.parametrize("world", list(PLANS))
def test_ranks_report_in_rank_order_and_launch_nothing_on_the_cpu(ranks,
                                                                  world):
    for rank, res in enumerate(ranks[world]):
        assert (res["rank"], res["world"]) == (rank, world)
        assert res["launches"] == dict.fromkeys(ops.LAUNCHES, 0)


@pytest.mark.parametrize("world,shape,names",
                         [(w, s, n) for w, ms in GROUP_MESHES.items()
                          for s, n in ms])
def test_group_rank_order_is_the_axis_coordinate(ranks, world, shape,
                                                 names):
    """Rank = i * Kr + j; ``new_group`` sorts its members, so a rank's
    position in its rack group is i and in its server group j — the order
    every all_to_all of the shuffle relies on."""
    grid = np.arange(world).reshape(shape)
    for rank, res in enumerate(ranks[world]):
        coords, order = res["groups"][shape]
        assert coords == divmod(rank, shape[1])
        for ax, name in enumerate(names):
            pos, members, got = order[name]
            line = np.moveaxis(grid, ax, -1)[
                tuple(c for a, c in enumerate(coords) if a != ax)].tolist()
            assert pos == coords[ax]
            assert members == line
            assert got == line             # position k holds member line[k]


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fused,r,job,pairing", ENGINE_CASES,
                         ids=lambda v: str(v))
def test_process_run_job_distributed_matches_jax_run_job(ranks, fused, r,
                                                         job, pairing):
    import jax.numpy as jnp
    from repro.core.params import SchemeParams as JParams
    from repro.mapreduce import engine as jeng
    from repro.mapreduce import jobs as jjobs
    jp = JParams(*KPQN, r=r)
    jres = jeng.run_job(getattr(jjobs, f"{job}_job")(),
                        jnp.asarray(_engine_inputs(job, jp.N)), jp, "hybrid")
    want = np.asarray(jres.outputs)
    first = None
    for res in ranks[8]:
        outs, intra, cross, scheme, ib, cb = res["engine"][
            (fused, r, job) + pairing]
        np.testing.assert_allclose(outs.numpy(), want, rtol=ENGINE_RTOL[job],
                                   atol=0)
        assert (intra, cross, scheme) == (jres.intra_cost, jres.cross_cost,
                                          jres.scheme)
        # every rank returns the same outputs and the same costs
        if first is None:
            first = (outs, intra, cross, ib, cb)
        assert torch.equal(outs, first[0])
        assert (intra, cross, ib, cb) == first[1:]


def test_process_engine_spans_go_to_each_ranks_tracer(ranks):
    for res in ranks[8]:
        assert res["blame"][True] == {"plan_compile", "pack",
                                      "map_shuffle_reduce"}
        assert res["blame"][False] == {"plan_compile", "map", "pack",
                                       "reduce", "shuffle_cross",
                                       "shuffle_intra"}
        assert res["span_phases"] == ["map", "map_shuffle_reduce", "pack",
                                      "plan_compile", "reduce", "shuffle"]


@pytest.mark.parametrize("case,exc,needle", [
    ("shape", "ValueError", "rack=P=4"),
    ("names", "ValueError", "axes"),
    ("faults", "NotImplementedError", "StackedMesh"),
    ("phase_timings", "NotImplementedError", "StackedMesh"),
    ("world", "ValueError", "holds 6 ranks"),
    ("rows", "ValueError", "n_loc"),
])
def test_process_mesh_checks_raise_legibly(ranks, case, exc, needle):
    for res in ranks[8]:
        got = res["errors"][case]
        assert got is not None and got[0] == exc and needle in got[1], got


def test_process_mesh_without_a_device_needs_a_card(ranks):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card: the default device exists")
    for res in ranks[8]:
        exc, msg = res["errors"]["no_device"]
        assert exc == "RuntimeError" and "no CUDA device" in msg


# ---------------------------------------------------------------------------
# The r = 2 aliases, on both kinds of mesh
# ---------------------------------------------------------------------------

def test_r2_aliases_on_the_process_mesh(ranks):
    for res in ranks[8]:
        same_plan, via_alias, via_general = res["alias"]
        assert same_plan
        assert torch.equal(via_alias, via_general)


def test_r2_aliases_on_the_stacked_mesh():
    p = SchemeParams(*KPQN, r=2)
    plan = tcc.compile_hybrid_plan_r2(p)
    assert plan is tcc.compile_hybrid_plan(p)
    local = tcc.pack_local_values(_payload(p, "unicast", 2), plan)
    mesh = make_mesh((p.P, p.Kr), ("rack", "server"), device="cpu")
    assert torch.equal(tcc.hybrid_shuffle_r2(local, plan, mesh),
                       tcc.hybrid_shuffle(local, plan, mesh))
    with pytest.raises(ValueError, match="r = 2 special case"):
        tcc.compile_hybrid_plan_r2(SchemeParams(*KPQN, r=3))


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------

def _no_rank_left():
    return not any(p.is_alive() for p in multiprocessing.active_children())


def test_a_rank_that_raises_fails_the_parent_with_its_traceback():
    t0 = time.monotonic()
    with pytest.raises(RankError, match=r"(?s)rank 1 of 2 failed.*"
                       r"ValueError: planted failure in rank 1"):
        run_ranks(_rank_raises, 2, backend="gloo", device="cpu",
                  timeout_s=120)
    assert time.monotonic() - t0 < 120
    assert _no_rank_left()


def test_a_rank_that_hangs_fails_the_parent_at_the_time_limit():
    t0 = time.monotonic()
    with pytest.raises(RankError, match=r"ranks \[1\] of 2 still running "
                       r"after 20 s"):
        run_ranks(_rank_hangs, 2, backend="gloo", device="cpu",
                  timeout_s=20)
    assert time.monotonic() - t0 < 60
    assert _no_rank_left()


def test_run_ranks_rejects_what_it_cannot_run():
    with pytest.raises(ValueError, match="backend"):
        run_ranks(_rank_hangs, 2, backend="mpi", device="cpu")
    with pytest.raises(ValueError, match="nccl backend needs"):
        run_ranks(_rank_hangs, 2, backend="nccl", device="cpu")
    if torch.cuda.device_count() < 64:
        with pytest.raises(RuntimeError, match="one rank per card"):
            run_ranks(_rank_hangs, 64, backend="nccl", device="cuda")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run_ranks(_rank_hangs, 2, backend="gloo")
