"""The port's fault path against the JAX package's: degraded plans table by
table over ``tests/test_faults.py``'s grid, the degraded NumPy oracle
(``simulate_plan_shuffle(failed=, patch=)``), the degraded device body with
poisoned dead servers, the faulted ``run_job_distributed`` (outputs
bit-identical to the JAX ``run_job``, ``RecoveryReport`` equal to one built
from the JAX compiler and restart budget), the seeded backoff and fault
schedules, degraded traffic and rack bytes, the bounded degraded-plan
cache (eviction frees device tables), and ``measure_phase_timings`` rows
with their spans."""
import gc
import math
import weakref

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import coded_collectives as jcc
from repro.core import degraded as jdg
from repro.core.params import SchemeParams as JParams
from repro.mapreduce import engine as jeng
from repro.mapreduce import jobs as jjobs
from repro.obs import bytes as jbytes
from repro.obs import metrics as jmetrics
from repro.obs import tracing as jtracing
from repro import resilience as jres
from repro_torch import resilience as tres
from repro_torch.core import coded_collectives as tcc
from repro_torch.core import degraded as tdg
from repro_torch.core.params import SchemeParams
from repro_torch.distributed.meshes import make_mesh
from repro_torch.kernels.coded_combine import ops
from repro_torch.mapreduce import engine as teng
from repro_torch.mapreduce import jobs as tjobs
from repro_torch.mapreduce import recovery as trec
from repro_torch.obs import bytes as tbytes
from repro_torch.obs import metrics as tmetrics
from repro_torch.obs import tracing as ttracing

KPQN = (8, 4, 16, 48)
FAMILY_GRID = [("binomial", 1), ("binomial", 2), ("binomial", 3),
               ("resolvable", 2)]
FAILED = [(0,), (3,), (7,), (0, 5), (1, 6), (0, 2), (0, 2, 5)]
PAIRINGS = [("unicast", "torch"), ("unicast", "kernel"),
            ("coded", "torch"), ("coded", "kernel")]
D = 3


def _params(r):
    return SchemeParams(*KPQN, r=r), JParams(*KPQN, r=r)


def _values(seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return rng.integers(-100, 100, size=(KPQN[3], KPQN[2], D)).astype(dtype)


def _subfiles(seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(-2 ** 31, 2 ** 31, size=(KPQN[3], 64)).astype(
        np.int32)


def _mesh():
    return make_mesh((KPQN[1], KPQN[0] // KPQN[1]), ("rack", "server"),
                     device="cpu")


# ---------------------------------------------------------------------------
# Degraded plans and the NumPy oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family,r", FAMILY_GRID)
@pytest.mark.parametrize("failed", FAILED)
def test_degraded_plan_tables_match_jax(family, r, failed):
    p, jp = _params(r)
    got = tdg.compile_degraded_plan(p, failed, family=family)
    want = jdg.compile_degraded_plan(jp, failed, family=family)
    for name in ("cross_send_pos", "cross_recv_pos", "cross_valid",
                 "mcast_comp_pos", "mcast_comp_rack", "mcast_known_pos",
                 "mcast_known_rack", "local_subfiles", "local_pos",
                 "local_mask", "layer_subfiles"):
        a, b = getattr(got.plan, name), getattr(want.plan, name)
        assert a.shape == b.shape and a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert got.plan.n_send == want.plan.n_send
    assert got.plan.family == want.plan.family == family
    assert got.failed == want.failed
    assert len(got.orphan_rows) == len(want.orphan_rows)
    for a, b in zip(got.orphan_rows, want.orphan_rows):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got.orphan_subfiles, want.orphan_subfiles)
    assert got.n_repaired_rows == want.n_repaired_rows
    assert got.decode_around == want.decode_around


@pytest.mark.parametrize("family,r", FAMILY_GRID)
@pytest.mark.parametrize("failed", FAILED)
def test_simulate_degraded_shuffle_matches_jax_and_reference(family, r,
                                                            failed):
    p, jp = _params(r)
    V = _values(r)
    dplan = tdg.compile_degraded_plan(p, failed, family=family)
    jplan = jdg.compile_degraded_plan(jp, failed, family=family)
    patch = tdg.build_patch(dplan, V[dplan.orphan_subfiles])
    np.testing.assert_array_equal(
        patch, jdg.build_patch(jplan, V[jplan.orphan_subfiles]))
    got = tcc.simulate_plan_shuffle(V, dplan.plan, failed=dplan.failed,
                                    patch=patch)
    want = jcc.simulate_plan_shuffle(V, jplan.plan, failed=jplan.failed,
                                     patch=patch)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, tcc.plan_shuffle_reference(V, p, family=family))
    # the crash model on the failure-free plan: the same zeros in both
    for mc in ("unicast", "coded"):
        base = tcc.compile_hybrid_plan(p, family=family)
        np.testing.assert_array_equal(
            tcc.simulate_plan_shuffle(V, base, mc, failed=failed),
            jcc.simulate_plan_shuffle(
                V, jcc.compile_hybrid_plan(jp, family=family), mc,
                failed=failed))


# ---------------------------------------------------------------------------
# The degraded device body
# ---------------------------------------------------------------------------

POISON = {np.float32: float("nan"), np.int32: 0x7fffffff}


@pytest.mark.parametrize("family,r", FAMILY_GRID)
@pytest.mark.parametrize("failed", [(3,), (0, 5), (0, 2), (2, 3)])
@pytest.mark.parametrize("dtype", [np.float32, np.int32],
                         ids=["float32", "int32"])
def test_device_body_with_poisoned_dead_servers_matches_jax(family, r,
                                                           failed, dtype):
    """Dead servers' map outputs hold NaN (float) or 0x7fffffff (int):
    the crash mask keeps them out, and the degraded shuffle with the
    device-placed patch equals the JAX oracle of the same plan bit for
    bit."""
    p, jp = _params(r)
    V = _values(10 * r + len(failed), dtype)
    dplan = tdg.compile_degraded_plan(p, failed, family=family)
    jplan = jdg.compile_degraded_plan(jp, failed, family=family)
    vals = torch.as_tensor(tcc.pack_local_values(V, dplan.plan))
    for s in failed:
        vals[s] = POISON[dtype]
    orphan = torch.as_tensor(V[dplan.orphan_subfiles])
    patch = trec.device_patch(dplan, orphan)
    jpatch = jdg.build_patch(jplan, V[jplan.orphan_subfiles])
    if dplan.decode_around:
        assert patch is None
    else:
        assert patch.dtype == vals.dtype
        np.testing.assert_array_equal(patch.numpy(), jpatch)
        np.testing.assert_array_equal(
            patch.numpy(), tdg.build_patch(dplan, V[dplan.orphan_subfiles]))
    dev = torch.device("cpu")
    out = trec.degraded_device_body(
        vals, dplan, dplan.device_tables(dev),
        trec.alive_mask(p, failed, dev), patch)
    want = jcc.simulate_plan_shuffle(V, jplan.plan, failed=jplan.failed,
                                     patch=jpatch)
    assert out.dtype == vals.dtype
    np.testing.assert_array_equal(out.numpy(), want)


@pytest.mark.parametrize("family,r", FAMILY_GRID + [("binomial", 4)])
def test_empty_failure_set_matches_base_routing(family, r):
    """No failure: the degraded tables (arity-1 multicast tables, so an
    empty known-component table; n_send 0 at r = P) route exactly as the
    failure-free plan, on the device body and in the oracle."""
    p = SchemeParams(*KPQN, r=r)
    V = _values(9)
    dplan = tdg.compile_degraded_plan(p, (), family=family)
    assert dplan.plan.mcast_arity == 1 and dplan.decode_around
    dev = torch.device("cpu")
    vals = torch.as_tensor(tcc.pack_local_values(V, dplan.plan))
    out = trec.degraded_device_body(vals, dplan, dplan.device_tables(dev),
                                    trec.alive_mask(p, (), dev))
    ref = tcc.plan_shuffle_reference(V, p, family=family)
    np.testing.assert_array_equal(out.numpy(), ref)
    np.testing.assert_array_equal(
        tcc.simulate_plan_shuffle(V, dplan.plan, failed=()), ref)
    if r == p.P:
        assert dplan.plan.n_send == 0


# ---------------------------------------------------------------------------
# The faulted engine against the JAX package
# ---------------------------------------------------------------------------

_JAX_OUT = {}


def _jax_outputs(r, family):
    key = (r, family)
    if key not in _JAX_OUT:
        res = jeng.run_job(jjobs.wide_histogram_job(D),
                           jnp.asarray(_subfiles()), JParams(*KPQN, r=r),
                           "hybrid" if family == "binomial"
                           else "hybrid_resolvable")
        _JAX_OUT[key] = np.asarray(res.outputs)
    return _JAX_OUT[key]


def _jax_spec(spec):
    """The JAX package's FaultSpec with the same schedule and knobs."""
    inj = jres.FaultInjector(tuple(
        jres.CrashEvent(e.servers, e.phase, e.time, e.attempt)
        for e in spec.injector.events))
    b = spec.backoff
    return jres.FaultSpec(inj, spec.max_restarts,
                          jres.BackoffPolicy(b.base_delay, b.factor,
                                             b.max_delay, b.jitter),
                          spec.allow_partial_remap, spec.seed)


def _jax_report(jspec, jp, family):
    """The report the JAX ladder would give, from its own compiler and
    restart budget (its degraded program needs 8 devices)."""
    budget = jres.RestartBudget(max_restarts=jspec.max_restarts,
                                policy=jspec.backoff, seed=jspec.seed)
    attempt = 0
    while True:
        events = jspec.injector.events_for_attempt(attempt)
        failed = tuple(sorted({s for e in events for s in e.servers}))
        if not failed:
            return ("none" if attempt == 0 else "restart", failed, 0,
                    budget.restarts, tuple(budget.delays), attempt + 1)
        if len(failed) < jp.K:
            dp = jdg.compile_degraded_plan(jp, failed, family=family)
            n = int(dp.orphan_subfiles.size)
            if not n or jspec.allow_partial_remap:
                return ("partial_remap" if n else "decode_around", failed,
                        n, budget.restarts, tuple(budget.delays),
                        attempt + 1)
        err = RuntimeError("unrecoverable")
        budget.next_restart(err)
        attempt += 1


def _faulted(spec, family, r, multicast="unicast", combine_impl="torch",
             placement=None):
    p, jp = _params(r)
    ops.reset_launch_counts()
    res = teng.run_job_distributed(
        tjobs.wide_histogram_job(D), _subfiles(), p, _mesh(),
        multicast=multicast, combine_impl=combine_impl,
        placement=placement, scheme_family=family, faults=spec)
    assert ops.LAUNCHES == dict.fromkeys(ops.LAUNCHES, 0)   # CPU: no launch
    np.testing.assert_array_equal(res.outputs.numpy(),
                                  _jax_outputs(r, family))
    rep = res.recovery
    assert _report_tuple(rep) == _jax_report(_jax_spec(spec), jp,
                                                   family)
    return res


def _report_tuple(rep):
    return (rep.rung, rep.failed, rep.n_remapped, rep.restarts,
            rep.backoff_delays, rep.attempts)


@pytest.mark.parametrize("family,r", FAMILY_GRID)
@pytest.mark.parametrize("multicast,combine_impl", PAIRINGS)
def test_faulted_run_job_distributed_matches_jax(family, r, multicast,
                                                 combine_impl):
    p, jp = _params(r)
    schedules = [tres.FaultInjector.crash(f) for f in FAILED] + [
        tres.FaultInjector.rack_crash(p, 1),
        tres.FaultInjector.random(seed=r, K=p.K, n_events=2,
                                  max_servers=2)]
    rungs = set()
    for inj in schedules:
        res = _faulted(tres.FaultSpec(inj), family, r, multicast,
                       combine_impl)
        rungs.add(res.recovery.rung)
        dplan = tdg.compile_degraded_plan(p, res.recovery.failed,
                                          family=family)
        rb = tbytes.degraded_rack_bytes(dplan, D)
        assert (res.intra_rack_bytes, res.cross_rack_bytes) == (
            rb.intra_total, rb.cross_total)
    assert rungs <= {"decode_around", "partial_remap"}


@pytest.mark.parametrize("family,r", FAMILY_GRID)
@pytest.mark.parametrize("multicast,combine_impl", PAIRINGS)
def test_restart_rung_matches_jax(family, r, multicast, combine_impl):
    """Every server dead on attempt 0: one restart with one seeded backoff
    delay, then the failure-free run; an orphaned first attempt with
    partial re-map disabled restarts too."""
    p, _ = _params(r)
    spec = tres.FaultSpec(tres.FaultInjector.crash(tuple(range(p.K))),
                          max_restarts=2, seed=5)
    res = _faulted(spec, family, r, multicast, combine_impl)
    assert res.recovery.rung == "restart" and res.recovery.restarts == 1
    assert len(res.recovery.backoff_delays) == 1
    no_remap = tres.FaultSpec(tres.FaultInjector.crash((0, 2)),
                              allow_partial_remap=False, seed=3)
    res = _faulted(no_remap, family, r, multicast, combine_impl)
    orphans = tdg.compile_degraded_plan(p, (0, 2), family=family)
    assert res.recovery.rung == ("decode_around" if orphans.decode_around
                                 else "restart")


def test_faulted_run_under_a_placement_and_a_later_attempt():
    """A placement permutation and crash events on attempts 0 and 1 (the
    second attempt decodes around)."""
    class Placement:
        perm = tuple(np.random.default_rng(3).permutation(KPQN[3]).tolist())
    for r in (1, 2):
        _faulted(tres.FaultSpec(tres.FaultInjector.crash((3,))), "binomial",
                 r, placement=Placement())
    inj = tres.FaultInjector((
        tres.CrashEvent(tuple(range(8)), attempt=0),
        tres.CrashEvent((1, 6), attempt=1)))
    res = _faulted(tres.FaultSpec(inj, seed=11), "binomial", 2)
    assert res.recovery.rung == "decode_around"
    assert res.recovery.attempts == 2 and res.recovery.restarts == 1


def test_restart_budget_spent_reraises():
    spec = tres.FaultSpec(tres.FaultInjector(tuple(
        tres.CrashEvent(tuple(range(8)), attempt=a) for a in range(3))),
        max_restarts=1)
    p, _ = _params(2)
    with pytest.raises(trec.UnrecoverableFailure, match="all 8 servers"):
        teng.run_job_distributed(tjobs.wide_histogram_job(D), _subfiles(), p,
                                 _mesh(), faults=spec)


def test_faulted_run_records_rungs_restarts_and_bytes():
    reg = tmetrics.registry()
    rung = reg.counter("recovery_rung_total")
    restarts = reg.counter("engine_restarts_total")
    total = reg.counter("shuffle_bytes_total")
    lab = dict(scheme="hybrid", family="binomial", layer="engine_degraded")
    before = (rung.value(rung="partial_remap", family="binomial"),
              rung.value(rung="restart", family="binomial"),
              restarts.value(family="binomial"),
              total.value(tier="cross", **lab))
    res = _faulted(tres.FaultSpec(tres.FaultInjector.crash((3,))),
                   "binomial", 1)
    _faulted(tres.FaultSpec(tres.FaultInjector.crash(tuple(range(8)))),
             "binomial", 1)
    after = (rung.value(rung="partial_remap", family="binomial"),
             rung.value(rung="restart", family="binomial"),
             restarts.value(family="binomial"),
             total.value(tier="cross", **lab))
    assert after[:3] == (before[0] + 1, before[1] + 1, before[2] + 1)
    assert after[3] - before[3] == res.cross_rack_bytes
    hist = reg.snapshot()["restart_backoff_seconds"]
    assert hist["type"] == "histogram"
    assert sum(s["count"] for s in hist["samples"].values()) >= 1


# ---------------------------------------------------------------------------
# Backoff, budget and schedules against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 7, 123])
def test_backoff_budget_and_random_schedules_match_jax(seed):
    pol = dict(base_delay=0.25, factor=3.0, max_delay=5.0, jitter=0.3)
    tb = tres.RestartBudget(6, tres.BackoffPolicy(**pol), seed=seed)
    jb = jres.RestartBudget(6, jres.BackoffPolicy(**pol), seed=seed)
    for _ in range(6):
        assert tb.next_restart() == jb.next_restart()
    assert tb.delays == jb.delays and not tb.exhausted
    with pytest.raises(tres.RestartBudgetExceeded):
        tb.next_restart()
    assert tb.exhausted
    rng_t, rng_j = np.random.default_rng(seed), np.random.default_rng(seed)
    assert [tres.BackoffPolicy().delay(k, rng_t) for k in range(8)] == \
        [jres.BackoffPolicy().delay(k, rng_j) for k in range(8)]
    for K, n, m, t in ((8, 3, 2, 0.0), (16, 4, 3, 2.5)):
        got = tres.FaultInjector.random(seed, K, n_events=n, max_servers=m,
                                        max_time=t, phase="map")
        want = jres.FaultInjector.random(seed, K, n_events=n, max_servers=m,
                                         max_time=t, phase="map")
        assert [(e.servers, e.phase, e.time, e.attempt)
                for e in got.events] == [
            (e.servers, e.phase, e.time, e.attempt) for e in want.events]
        assert got.all_servers() == want.all_servers()


def test_fault_spec_schedule_semantics():
    p, jp = _params(2)
    assert tres.FaultInjector.rack_crash(p, 1).events[0].servers == \
        jres.FaultInjector.rack_crash(jp, 1).events[0].servers == (2, 3)
    assert tres.CrashEvent((5, 1, 1), phase="map").servers == (1, 5)
    with pytest.raises(ValueError):
        tres.CrashEvent((0,), phase="reduce")
    spec = tres.FaultSpec(tres.FaultInjector.crash((3,)))
    jspec = jres.FaultSpec(jres.FaultInjector.crash((3,)))
    for f in ("max_restarts", "allow_partial_remap", "seed", "sleep"):
        assert getattr(spec, f) == getattr(jspec, f)
    slept = []
    budget = tres.RestartBudget(max_restarts=1, seed=1, sleep=slept.append)
    budget.next_restart()
    assert slept == budget.delays
    with pytest.raises(InterruptedError):
        budget.next_restart(InterruptedError("crash"))

    class Sim:
        def __init__(self):
            self.crashes = []

        def inject_crash(self, t, servers):
            self.crashes.append((t, servers))
    sim = Sim()
    tres.FaultInjector.crash((4, 2), time=1.5).inject_into(sim)
    assert sim.crashes == [(1.5, (2, 4))]


def test_histogram_matches_jax():
    t = tmetrics.MetricsRegistry().histogram("h", "x", buckets=(0.1, 1.0))
    j = jmetrics.MetricsRegistry().histogram("h", "x", buckets=(0.1, 1.0))
    for v, lab in ((0.05, "a"), (0.5, "a"), (3.0, "b"), (0.1, "a")):
        t.observe(v, k=lab)
        j.observe(v, k=lab)
    assert t.snapshot() == j.snapshot()
    reg = tmetrics.MetricsRegistry()
    reg.histogram("x")
    with pytest.raises(TypeError):
        reg.counter("x")


# ---------------------------------------------------------------------------
# Traffic and bytes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family,r", FAMILY_GRID)
def test_degraded_traffic_and_rack_bytes_match_jax(family, r):
    p, jp = _params(r)
    scheme = "hybrid" if family == "binomial" else "hybrid_resolvable"
    for failed in [(), (3,), (0, 2), (0, 2, 5)]:
        got, n = tdg.degraded_stage_traffic(p, scheme, failed)
        want, jn = jdg.degraded_stage_traffic(jp, scheme, failed)
        assert n == jn
        assert [(s.stage, s.cross_pairs, s.intra_pairs_per_rack)
                for s in got] == [(s.stage, s.cross_pairs,
                                   s.intra_pairs_per_rack) for s in want]
        dp = tdg.compile_degraded_plan(p, failed, family=family)
        jd = jdg.compile_degraded_plan(jp, failed, family=family)
        for k, v in dp.transfer_loads().items():
            np.testing.assert_array_equal(v, jd.transfer_loads()[k])
        for mc in ("unicast", "coded"):
            np.testing.assert_array_equal(
                tcc.plan_transfer_matrices(dp.plan, mc)["cross_rack_matrix"],
                jcc.plan_transfer_matrices(jd.plan, mc)["cross_rack_matrix"])
        rb, jrb = tbytes.degraded_rack_bytes(dp, 7), \
            jbytes.degraded_rack_bytes(jd, 7)
        np.testing.assert_array_equal(rb.cross_matrix, jrb.cross_matrix)
        np.testing.assert_array_equal(rb.intra_per_rack, jrb.intra_per_rack)
    # the closed-form fallback of the non-hybrid schemes
    for scheme in ("uncoded", "coded"):
        got, n = tdg.degraded_stage_traffic(p, scheme, (3,))
        want, jn = jdg.degraded_stage_traffic(jp, scheme, (3,))
        assert n == jn and [s.cross_pairs for s in got] == \
            [s.cross_pairs for s in want]


# ---------------------------------------------------------------------------
# The bounded degraded-plan cache
# ---------------------------------------------------------------------------

def test_degraded_cache_counts_evictions_and_frees_device_tables():
    p, _ = _params(2)
    dev = torch.device("cpu")
    tables_before = tcc.device_plan_tables.cache_info().currsize
    tdg.configure_degraded_cache(maxsize=2)
    try:
        first = tdg.compile_degraded_plan(p, (0,))
        held = weakref.ref(first.device_tables(dev).recv_dst)
        assert first.device_tables(dev) is first.device_tables(dev)
        plan_ref = weakref.ref(first)
        del first
        tdg.compile_degraded_plan(p, (1,))
        assert tdg.compile_degraded_plan(p, [1, 1]) is \
            tdg.compile_degraded_plan(p, (1,))
        gc.collect()
        assert held() is not None                # still cached
        tdg.compile_degraded_plan(p, (2,))       # evicts (0,)
        gc.collect()
        assert plan_ref() is None and held() is None
        info = tdg.degraded_cache_info()
        assert (info.hits, info.misses, info.maxsize, info.currsize,
                info.evictions) == (2, 3, 2, 2, 1)
        # a faulted job's degraded tables stay out of the plan-keyed cache
        _faulted(tres.FaultSpec(tres.FaultInjector.crash((5,))), "binomial",
                 2)
        assert tcc.device_plan_tables.cache_info().currsize == \
            tables_before
        tmetrics.refresh_cache_metrics()
        snap = tmetrics.registry().snapshot()
        cur = tdg.degraded_cache_info()
        assert snap["degraded_cache"]["samples"]['{"event": "eviction"}'] \
            == cur.evictions
        assert snap["degraded_cache_size"]["samples"]['{"kind": "max"}'] == 2
    finally:
        tdg.configure_degraded_cache()
    tdg.degraded_cache_clear()
    assert tdg.degraded_cache_info() == (0, 0, 32, 0, 0)


def test_degraded_cache_size_from_environment(monkeypatch):
    monkeypatch.setenv(tdg.DEGRADED_CACHE_MAXSIZE_ENV, "5")
    try:
        tdg.configure_degraded_cache()
        assert tdg.degraded_cache_info().maxsize == 5
    finally:
        monkeypatch.delenv(tdg.DEGRADED_CACHE_MAXSIZE_ENV)
        tdg.configure_degraded_cache()
    assert tdg.degraded_cache_info().maxsize == 32


def test_degraded_plan_rejects_bad_failures():
    p, _ = _params(2)
    for bad in [(8,), (-1,), tuple(range(8))]:
        with pytest.raises(ValueError):
            tdg.compile_degraded_plan(p, bad)


# ---------------------------------------------------------------------------
# Phase timings
# ---------------------------------------------------------------------------

def test_measure_phase_timings_row_matches_jax():
    from repro.distributed.meshes import make_mesh as jmake_mesh
    p, jp = SchemeParams(K=1, P=1, Q=4, N=6, r=1), \
        JParams(K=1, P=1, Q=4, N=6, r=1)
    subs = np.random.default_rng(0).integers(0, 1 << 16, size=(p.N, 64)
                                             ).astype(np.int32)
    row = teng.measure_phase_timings(
        tjobs.histogram_job(), subs, p,
        make_mesh((1, 1), ("rack", "server"), device="cpu"), iters=1)
    jrow = jeng.measure_phase_timings(jjobs.histogram_job(), subs, jp,
                                      jmake_mesh((1, 1), ("rack", "server")),
                                      iters=1)
    assert row["work"] == jrow["work"]
    assert set(row["seconds"]) == set(jrow["seconds"])
    assert set(row["meta"]) == set(jrow["meta"])
    assert {k: v for k, v in row["meta"].items()
            if k not in ("shuffle_s", "backend")} == \
        {k: v for k, v in jrow["meta"].items()
         if k not in ("shuffle_s", "backend")}
    assert row["meta"]["backend"] == "cpu"
    # the same row gives the same spans in both packages
    got = ttracing.spans_from_phase_timings(row, ttracing.Tracer())
    want = jtracing.spans_from_phase_timings(row, jtracing.Tracer())
    assert [(e.ts, e.kind, e.phase, e.labels, e.dur) for e in got] == \
        [(e.ts, e.kind, e.phase, e.labels, e.dur) for e in want]


def test_measure_phase_timings_at_k8_and_the_grid():
    p = SchemeParams(*KPQN, r=2)
    tracer = ttracing.enable_tracing(True)
    try:
        row = teng.measure_phase_timings(tjobs.wide_histogram_job(D),
                                         _subfiles(), p, _mesh(), iters=2)
    finally:
        ttracing.enable_tracing(False)
    n_loc = tcc.compile_hybrid_plan(p).local_subfiles.shape[-1]
    assert row["work"] == {"map": 48.0 * 16 * D, "pack": 8.0 * n_loc * 16 * D,
                           "reduce": 48.0 * 16 * D, "plan_compile": 48.0}
    secs = list(row["seconds"].values()) + [row["meta"]["shuffle_s"]]
    assert all(math.isfinite(s) and s > 0 for s in secs)
    assert [e.phase for e in tracer.events if e.kind == "device_phase"] == \
        ["plan_compile", "map", "pack", "shuffle", "reduce"]
    rows = teng.measure_calibration_grid(
        tjobs.wide_histogram_job, _mesh(),
        [(SchemeParams(*KPQN, r=1), 2), (SchemeParams(*KPQN, r=2), 4)],
        iters=1)
    assert [(r["meta"]["r"], r["meta"]["d"]) for r in rows] == [(1, 2),
                                                                 (2, 4)]
