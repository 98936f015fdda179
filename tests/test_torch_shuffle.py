"""The port's stacked two-stage shuffle, bit-exact against the JAX
package's oracles (``plan_shuffle_reference``, ``simulate_plan_shuffle``)
for both plan families, every multicast wire format and both combine
implementations, on the port's own plans and on plans rebuilt from the JAX
compiler's tables."""
import dataclasses
import itertools

import numpy as np
import pytest
import torch

from repro.core import coded_collectives as jcc
from repro.core.params import SchemeParams as JParams
from repro_torch.core import coded_collectives as tcc
from repro_torch.core.params import SchemeParams
from repro_torch.distributed.meshes import make_mesh
from repro_torch.kernels.coded_combine import ops

PLANS = ([("binomial", (8, 4, 16, 48, r)) for r in (1, 2, 3)]
         + [("resolvable", k) for k in [
             (12, 6, 24, 48, 3), (12, 6, 24, 48, 2), (8, 8, 16, 64, 2),
             (18, 9, 36, 108, 3),
             (16, 8, 32, 96, 4)]])              # arity 3
PAIRINGS = list(itertools.product(("unicast", "coded", "coded_xor"),
                                  ("torch", "kernel")))


def _payload(p, multicast, seed, d=3):
    rng = np.random.default_rng(seed)
    if multicast == "coded_xor":
        return rng.integers(0, 2 ** 30, size=(p.N, p.Q, d)).astype(np.int32)
    # integer-valued float32: every order of sums is exact
    return rng.integers(-100, 100, size=(p.N, p.Q, d)).astype(np.float32)


def _check(plan, jplan, jp, family, multicast, combine_impl, seed):
    V = _payload(jp, multicast, seed)
    mesh = make_mesh((jp.P, jp.Kr), ("rack", "server"), device="cpu")
    out = tcc.hybrid_shuffle(tcc.pack_local_values(V, plan), plan, mesh,
                             multicast, combine_impl)
    assert out.dtype == torch.from_numpy(V).dtype
    ref = jcc.plan_shuffle_reference(V, jp, family=family)
    np.testing.assert_array_equal(out.numpy(), ref)
    np.testing.assert_array_equal(
        out.numpy(), jcc.simulate_plan_shuffle(V, jplan, multicast))


@pytest.mark.parametrize("family,kpqnr", PLANS)
@pytest.mark.parametrize("multicast,combine_impl", PAIRINGS)
def test_stacked_shuffle_bit_exact_vs_jax_oracles(family, kpqnr, multicast,
                                                  combine_impl):
    plan = tcc.compile_hybrid_plan(SchemeParams(*kpqnr), family=family)
    jp = JParams(*kpqnr)
    _check(plan, jcc.compile_hybrid_plan(jp, family=family), jp, family,
           multicast, combine_impl, seed=sum(kpqnr))
    # and the port's own NumPy oracles agree with JAX's
    V = _payload(jp, multicast, seed=1)
    np.testing.assert_array_equal(
        tcc.simulate_plan_shuffle(V, plan, multicast),
        jcc.simulate_plan_shuffle(V, jcc.compile_hybrid_plan(
            jp, family=family), multicast))
    np.testing.assert_array_equal(
        tcc.plan_shuffle_reference(V, plan.params, family=family),
        jcc.plan_shuffle_reference(V, jp, family=family))


@pytest.mark.parametrize("family,kpqnr", PLANS)
@pytest.mark.parametrize("multicast,combine_impl", PAIRINGS)
def test_shuffle_on_plan_rebuilt_from_jax_tables(family, kpqnr, multicast,
                                                 combine_impl):
    jp = JParams(*kpqnr)
    jplan = jcc.compile_hybrid_plan(jp, family=family)
    fields = {f.name: getattr(jplan, f.name)
              for f in dataclasses.fields(jplan)}
    fields["params"] = dataclasses.asdict(jp)
    plan = tcc.plan_from_numpy(fields)
    _check(plan, jplan, jp, family, multicast, combine_impl, seed=7)


@pytest.mark.parametrize("combine_impl", ["torch", "kernel"])
def test_coded_xor_on_float_payload_raises(combine_impl):
    """JAX raises on XOR of float32 payloads; so does the port (it does not
    reinterpret float bits)."""
    p = SchemeParams(8, 4, 16, 48, 2)
    plan = tcc.compile_hybrid_plan(p)
    V = _payload(p, "coded", seed=3)
    mesh = make_mesh((p.P, p.Kr), ("rack", "server"), device="cpu")
    with pytest.raises((RuntimeError, TypeError)):
        tcc.hybrid_shuffle(tcc.pack_local_values(V, plan), plan, mesh,
                           "coded_xor", combine_impl)


def test_shuffle_bfloat16_coded_kernel_path_bit_exact():
    """Small integers are exact in bfloat16, so the coded path is exact on
    bf16 payloads too (the kernels accumulate in fp32)."""
    p = SchemeParams(8, 4, 16, 48, 3)
    plan = tcc.compile_hybrid_plan(p)
    V = np.random.default_rng(5).integers(-8, 8, size=(p.N, p.Q, 4))
    mesh = make_mesh((p.P, p.Kr), ("rack", "server"), device="cpu")
    local = torch.from_numpy(tcc.pack_local_values(V, plan)).to(
        torch.bfloat16)
    for impl in ("torch", "kernel"):
        out = tcc.hybrid_shuffle(local, plan, mesh, "coded", impl)
        assert out.dtype == torch.bfloat16
        np.testing.assert_array_equal(out.float().numpy(),
                                      tcc.plan_shuffle_reference(
                                          V.astype(np.float32), p))


def test_device_tables_cached_per_plan_and_device():
    p = SchemeParams(8, 4, 16, 48, 2)
    plan = tcc.compile_hybrid_plan(p)
    cpu = torch.device("cpu")
    t = tcc.device_plan_tables(plan, cpu)
    assert tcc.device_plan_tables(plan, cpu) is t
    assert t.comp_src.shape == (plan.mcast_arity, p.K * p.P * plan.n_send)
    assert t.recv_dst.dtype == torch.int64
    tcc.plan_cache_clear()
    assert tcc.device_plan_tables(plan, cpu) is not t


def test_shuffle_rejects_bad_modes_and_shapes():
    p = SchemeParams(8, 4, 16, 48, 2)
    plan = tcc.compile_hybrid_plan(p)
    mesh = make_mesh((p.P, p.Kr), ("rack", "server"), device="cpu")
    local = tcc.pack_local_values(_payload(p, "coded", 0), plan)
    with pytest.raises(ValueError, match="multicast"):
        tcc.hybrid_shuffle(local, plan, mesh, "broadcast")
    with pytest.raises(ValueError, match="combine_impl"):
        tcc.hybrid_shuffle(local, plan, mesh, "coded", "pallas")
    with pytest.raises(ValueError, match="server rows"):
        tcc.hybrid_shuffle(local[:4], plan, mesh)
    assert ops.LAUNCHES == dict.fromkeys(ops.LAUNCHES, 0)
