"""The port's MapReduce engine against the JAX package's ``run_job``:
outputs, paper-metric costs and rack bytes, for the fused and legacy paths,
both plan families, every multicast x combine pairing, a placement
permutation, and all four jobs; plus the no-device rule."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import coded_collectives as jcc
from repro.core.params import SchemeParams as JParams
from repro.mapreduce import engine as jeng
from repro.mapreduce import jobs as jjobs
from repro.obs.bytes import plan_rack_bytes as j_plan_rack_bytes
from repro_torch.core.coded_collectives import plan_cache_info
from repro_torch.core.params import SchemeParams
from repro_torch.distributed.meshes import make_mesh
from repro_torch.kernels.coded_combine import ops
from repro_torch.mapreduce import engine as teng
from repro_torch.mapreduce import jobs as tjobs
from repro_torch.obs.metrics import registry
from repro_torch.obs.tracing import enable_tracing

KPQN = (8, 4, 16, 48)
CONFIGS = [("binomial", 1), ("binomial", 2), ("binomial", 3),
           ("resolvable", 2)]
PAIRINGS = [("unicast", "torch"), ("unicast", "kernel"),
            ("coded", "torch"), ("coded", "kernel")]
JOBS = {
    "histogram": (jjobs.histogram_job, tjobs.histogram_job),
    "wide_histogram": (lambda: jjobs.wide_histogram_job(5),
                       lambda: tjobs.wide_histogram_job(5)),
    "groupby_mean": (jjobs.groupby_mean_job, tjobs.groupby_mean_job),
    "terasort": (jjobs.terasort_bucket_job, tjobs.terasort_bucket_job),
}
SCHEME = {"binomial": "hybrid", "resolvable": "hybrid_resolvable"}


def _inputs(job: str, N: int) -> np.ndarray:
    rng = np.random.default_rng(sum(map(ord, job)))
    if job in ("histogram", "wide_histogram"):
        # full int32 range: negative tokens bucket by their uint32 bits
        return rng.integers(-2 ** 31, 2 ** 31, size=(N, 64)).astype(np.int32)
    if job == "groupby_mean":
        # integer-valued keys and values, negatives included (keys below 0
        # saturate to bucket 0 as XLA's float -> uint32 conversion does)
        return rng.integers(-50, 500, size=(N, 64, 2)).astype(np.float32)
    return rng.integers(0, 2 ** 20, size=(N, 64)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _jax_result(job: str, r: int, family: str):
    jp = JParams(*KPQN, r=r)
    subs = _inputs(job, jp.N)
    jjob = JOBS[job][0]()
    res = jeng.run_job(jjob, jnp.asarray(subs), jp, SCHEME[family])
    rb = j_plan_rack_bytes(jcc.compile_hybrid_plan(jp, family=family),
                           "coded", jjob.d)
    return res, rb, np.asarray(res.outputs)


def _assert_outputs(job: str, got: np.ndarray, want: np.ndarray):
    assert got.shape == want.shape
    if job == "terasort":
        # float sums depend on summation order; counts, min, max are exact
        np.testing.assert_allclose(got[:, 1], want[:, 1], rtol=1e-6)
        got, want = np.delete(got, 1, axis=1), np.delete(want, 1, axis=1)
    np.testing.assert_array_equal(got, want)


def _run(job, family, r, fused, multicast, combine_impl, placement=None):
    p = SchemeParams(*KPQN, r=2)
    mesh = make_mesh((p.P, p.Kr), ("rack", "server"), device="cpu")
    res = teng.run_job_distributed(
        JOBS[job][1](), _inputs(job, p.N), p, mesh, r=r, fused=fused,
        multicast=multicast, combine_impl=combine_impl,
        placement=placement, scheme_family=family)
    jres, jrb, jout = _jax_result(job, r, family)
    _assert_outputs(job, res.outputs.numpy(), jout)
    assert (res.intra_cost, res.cross_cost) == (jres.intra_cost,
                                                jres.cross_cost)
    assert res.scheme == jres.scheme
    assert (res.intra_rack_bytes, res.cross_rack_bytes) == (
        jrb.intra_total, jrb.cross_total)
    return res


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "legacy"])
@pytest.mark.parametrize("family,r", CONFIGS)
@pytest.mark.parametrize("multicast,combine_impl", PAIRINGS)
def test_run_job_distributed_matches_jax_run_job(fused, family, r,
                                                 multicast, combine_impl):
    _run("wide_histogram", family, r, fused, multicast, combine_impl)
    assert ops.LAUNCHES == dict.fromkeys(ops.LAUNCHES, 0)   # CPU: no launch


@pytest.mark.parametrize("job", list(JOBS))
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "legacy"])
def test_every_job_matches_jax(job, fused):
    _run(job, "binomial", 2, fused, "coded", "kernel")


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "legacy"])
def test_placement_perm_leaves_outputs_unchanged(fused):
    class Placement:              # anything with .perm, or a bare perm
        perm = tuple(np.random.default_rng(3).permutation(KPQN[3]).tolist())
    _run("histogram", "binomial", 2, fused, "coded", "kernel",
         placement=Placement())
    _run("histogram", "binomial", 2, fused, "unicast", "torch",
         placement=list(Placement.perm))


def test_run_job_matches_jax_run_job_with_message_counts():
    p = SchemeParams(*KPQN, r=2)
    subs = _inputs("histogram", p.N)
    res = teng.run_job(tjobs.histogram_job(), subs, p, "hybrid",
                       count_messages=True, device="cpu")
    jres = jeng.run_job(jjobs.histogram_job(), jnp.asarray(subs),
                        JParams(*KPQN, r=2), "hybrid", count_messages=True)
    np.testing.assert_array_equal(res.outputs.numpy(),
                                  np.asarray(jres.outputs))
    assert (res.intra_cost, res.cross_cost) == (jres.intra_cost,
                                                jres.cross_cost)


def test_entry_points_raise_without_a_device_on_a_gpu_less_host():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card: the default device exists")
    p = SchemeParams(*KPQN, r=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh((p.P, p.Kr), ("rack", "server"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        teng.run_job(tjobs.histogram_job(), _inputs("histogram", p.N), p)


def test_mesh_checks_and_coded_xor_on_float_job():
    p = SchemeParams(*KPQN, r=2)
    job, subs = tjobs.wide_histogram_job(3), _inputs("histogram", p.N)
    with pytest.raises(ValueError, match="does not match SchemeParams"):
        teng.run_job_distributed(job, subs, p, make_mesh(
            (p.Kr, p.P), ("rack", "server"), device="cpu"))
    with pytest.raises(ValueError, match="axes"):
        teng.run_job_distributed(job, subs, p, make_mesh(
            (p.P, p.Kr), ("x", "y"), device="cpu"))
    mesh = make_mesh((p.P, p.Kr), ("rack", "server"), device="cpu")
    with pytest.raises((RuntimeError, TypeError)):
        teng.run_job_distributed(job, subs, p, mesh, multicast="coded_xor")


def test_engine_records_rack_bytes_and_plan_cache_metrics():
    reg = registry()
    tot = reg.counter("shuffle_bytes_total")
    labels = dict(scheme="hybrid_resolvable", family="resolvable",
                  layer="engine")
    before = {t: tot.value(tier=t, **labels) for t in ("intra", "cross")}
    res = _run("histogram", "resolvable", 2, True, "coded", "torch")
    assert tot.value(tier="intra", **labels) - before["intra"] == \
        res.intra_rack_bytes
    assert tot.value(tier="cross", **labels) - before["cross"] == \
        res.cross_rack_bytes
    info = plan_cache_info()
    snap = reg.snapshot()
    hits = snap["plan_cache"]["samples"]['{"event": "hit", "family": "all"}']
    assert hits == info.hits
    assert snap["plan_cache_size"]["samples"]['{"kind": "current"}'] == \
        info.currsize


def test_engine_spans_fold_into_blame():
    tracer = enable_tracing(True)
    try:
        fused = _run("histogram", "binomial", 2, True, "coded", "torch")
        legacy = _run("histogram", "binomial", 2, False, "coded", "torch")
    finally:
        enable_tracing(False)
    assert set(fused.blame) == {"plan_compile", "pack", "map_shuffle_reduce"}
    assert set(legacy.blame) == {"plan_compile", "map", "pack", "reduce",
                                 "shuffle_cross", "shuffle_intra"}
    assert all(v >= 0 for v in legacy.blame.values())
    phases = {e.phase for e in tracer.events if e.kind == "engine_phase"}
    assert phases == {"plan_compile", "pack", "map_shuffle_reduce", "map",
                      "shuffle", "reduce"}
