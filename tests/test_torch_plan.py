"""The port's plan layer against the JAX package's: golden sha256 digests,
table-by-table equality with ``repro.core.coded_collectives``'s compiler,
closed-form costs, transfer matrices and the plan cache."""
import dataclasses
import hashlib
import json
import pathlib

import numpy as np
import pytest

from repro.core import coded_collectives as jcc
from repro.core import costs as jcosts
from repro.core.params import SchemeParams as JParams
from repro_torch.core import coded_collectives as tcc
from repro_torch.core import costs as tcosts
from repro_torch.core.params import TABLE1_GRID, SchemeParams
from repro_torch.core.plan_registry import (family_of_scheme, plan_families,
                                            register_plan_compiler,
                                            scheme_of_family)

GOLDEN_PATH = pathlib.Path(__file__).parent / "golden_plans.json"

RESOLVABLE_PARAMS = [(12, 6, 24, 48, 3), (12, 6, 24, 48, 2), (8, 8, 16, 64, 2),
                     (18, 9, 36, 108, 3), (16, 8, 32, 96, 4)]
CASES = ([("binomial", (8, 4, 16, 48, r), None) for r in (1, 2, 3, 4)]
         + [("resolvable", k, None) for k in RESOLVABLE_PARAMS]
         + [("binomial", (8, 4, 16, 48, 2), 7),
            ("resolvable", (12, 6, 24, 48, 3), 11)])
TABLES = ("local_subfiles", "cross_send_pos", "layer_subfiles",
          "cross_recv_pos", "local_mask", "local_pos", "mcast_comp_pos",
          "mcast_comp_rack", "mcast_known_pos", "mcast_known_rack")


def _digest(plan) -> str:
    """The sha256 of tests/test_resolvable.py's golden digest."""
    fields = json.loads(GOLDEN_PATH.read_text())["fields"]
    h = hashlib.sha256()
    for f in fields:
        a = np.asarray(getattr(plan, f))
        h.update(f.encode())
        h.update(str(a.shape).encode())
        h.update(str(a.dtype).encode())
        h.update(a.tobytes())
    h.update(str(plan.n_send).encode())
    return h.hexdigest()


def _perm(N, seed):
    return None if seed is None else \
        np.random.default_rng(seed).permutation(N).tolist()


@pytest.mark.parametrize("case", json.loads(GOLDEN_PATH.read_text())["cases"],
                         ids=lambda c: f"{c['params']}-perm"
                         f"{c['perm'] is not None}")
def test_port_plans_reproduce_golden_digests(case):
    K, P, Q, N, r = case["params"]
    plan = tcc.compile_hybrid_plan(SchemeParams(K=K, P=P, Q=Q, N=N, r=r),
                                   perm=case["perm"], family="binomial")
    assert _digest(plan) == case["sha256"]
    assert plan.family == "binomial" and plan.cross_valid is None
    assert plan.mcast_arity == r


@pytest.mark.parametrize("family,kpqnr,seed", CASES)
def test_port_tables_equal_jax_tables(family, kpqnr, seed):
    K, P, Q, N, r = kpqnr
    perm = _perm(N, seed)
    tp = tcc.compile_hybrid_plan(SchemeParams(K, P, Q, N, r), perm=perm,
                                 family=family)
    jp = jcc.compile_hybrid_plan(JParams(K, P, Q, N, r), perm=perm,
                                 family=family)
    for name in TABLES:
        a, b = np.asarray(getattr(tp, name)), np.asarray(getattr(jp, name))
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert tp.n_send == jp.n_send
    assert tp.family == jp.family
    assert tp.mcast_arity == jp.mcast_arity
    if jp.cross_valid is None:
        assert tp.cross_valid is None
    else:
        np.testing.assert_array_equal(tp.cross_valid, jp.cross_valid)
    np.testing.assert_array_equal(tcc.reduce_ready_order(tp),
                                  jcc.reduce_ready_order(jp))
    np.testing.assert_array_equal(tcc.reduce_output_keys(tp),
                                  jcc.reduce_output_keys(jp))


@pytest.mark.parametrize("family,kpqnr,seed", CASES)
@pytest.mark.parametrize("multicast", ["unicast", "coded", "coded_xor"])
def test_port_transfer_matrices_equal_jax(family, kpqnr, seed, multicast):
    K, P, Q, N, r = kpqnr
    perm = _perm(N, seed)
    tm = tcc.plan_transfer_matrices(
        tcc.compile_hybrid_plan(SchemeParams(K, P, Q, N, r), perm=perm,
                                family=family), multicast)
    jm = jcc.plan_transfer_matrices(
        jcc.compile_hybrid_plan(JParams(K, P, Q, N, r), perm=perm,
                                family=family), multicast)
    assert tm.keys() == jm.keys()
    for k in tm:
        np.testing.assert_array_equal(tm[k], jm[k])


@pytest.mark.parametrize("kpqnr", TABLE1_GRID)
def test_port_closed_form_costs_equal_jax(kpqnr):
    tp, jp = SchemeParams(*kpqnr), JParams(*kpqnr)
    for fn in ("uncoded_cost", "coded_cost", "hybrid_cost"):
        assert (dataclasses.asdict(getattr(tcosts, fn)(tp, check=False))
                == dataclasses.asdict(getattr(jcosts, fn)(jp, check=False)))


@pytest.mark.parametrize("kpqnr", RESOLVABLE_PARAMS)
def test_port_resolvable_cost_equals_jax(kpqnr):
    t = tcosts.hybrid_resolvable_cost(SchemeParams(*kpqnr))
    j = jcosts.hybrid_resolvable_cost(JParams(*kpqnr))
    assert (t.intra, t.cross) == (j.intra, j.cross)


def test_port_registry_is_its_own():
    assert plan_families() == ("binomial", "resolvable")
    assert scheme_of_family("resolvable") == "hybrid_resolvable"
    assert family_of_scheme("hybrid") == "binomial"
    with pytest.raises(ValueError, match="unknown scheme family"):
        tcc.compile_hybrid_plan(SchemeParams(8, 4, 16, 48, 2),
                                family="steiner")
    with pytest.raises(ValueError, match="already registered"):
        register_plan_compiler("binomial")(lambda p, perm=None: None)


def test_port_plan_cache_counts_per_family():
    tcc.plan_cache_clear()
    p = SchemeParams(8, 4, 16, 48, 2)
    a = tcc.compile_hybrid_plan(p)
    assert tcc.compile_hybrid_plan(p) is a
    tcc.compile_hybrid_plan(p, family="resolvable")
    info = tcc.plan_cache_info()
    assert (info.hits, info.misses, info.currsize) == (1, 2, 2)
    assert info.families == {"binomial": (1, 1), "resolvable": (0, 1)}
    tcc.plan_cache_clear()
    assert tcc.plan_cache_info().currsize == 0


@pytest.mark.parametrize("family,kpqnr,seed", CASES)
def test_plan_from_numpy_rebuilds_jax_plan(family, kpqnr, seed):
    jp = jcc.compile_hybrid_plan(JParams(*kpqnr), perm=_perm(kpqnr[3], seed),
                                 family=family)
    fields = {f.name: getattr(jp, f.name) for f in dataclasses.fields(jp)}
    fields["params"] = dataclasses.asdict(jp.params)
    plan = tcc.plan_from_numpy(fields)
    assert _digest(plan) == _digest(jp)
    assert plan.params == SchemeParams(*kpqnr)
    assert plan.family == family and plan.n_send == jp.n_send
