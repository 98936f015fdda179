"""The recovery ladder on the card at K=8, P=4, Q=16, N=48: every rung's
outputs bit-identical to the failure-free run (both plan families, every
r, every multicast x combine pairing), poisoned dead servers held against
the port's NumPy oracle, the launches of each rung (one encode and one
decode for a coded kernel job on the ``none`` and ``restart`` rungs, none
on the degraded rungs), and degraded device tables freed with their
side-cache entry.  Needs a CUDA card (the ``cuda`` marker; skipped without
one) and imports no JAX:

    python -m pytest -q -m cuda tests/test_torch_faults_cuda.py
"""
import gc
import weakref

import numpy as np
import pytest
import torch

from repro_torch.core import coded_collectives as cc
from repro_torch.core import degraded as dg
from repro_torch.core.params import SchemeParams
from repro_torch.distributed.meshes import make_mesh
from repro_torch.kernels.coded_combine import ops
from repro_torch.mapreduce import engine as eng
from repro_torch.mapreduce import jobs
from repro_torch.mapreduce import recovery as rec
from repro_torch.resilience import FaultInjector, FaultSpec

KPQN = (8, 4, 16, 48)
FAMILY_GRID = [("binomial", 1), ("binomial", 2), ("binomial", 3),
               ("resolvable", 2)]
PAIRINGS = [("unicast", "torch"), ("unicast", "kernel"),
            ("coded", "torch"), ("coded", "kernel")]
NO_LAUNCH = {"coded_encode": 0, "coded_decode": 0, "xor_encode": 0,
             "xor_decode": 0}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    return torch.device("cuda")


def _subfiles():
    rng = np.random.default_rng(4)
    return rng.integers(0, 1 << 16, size=(KPQN[3], 64)).astype(np.int32)


def _launches(fn):
    ops.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, dict(ops.LAUNCHES)


@pytest.mark.cuda
@pytest.mark.parametrize("family,r", FAMILY_GRID)
@pytest.mark.parametrize("multicast,combine_impl", PAIRINGS)
def test_every_rung_bit_identical_on_the_card(card, family, r, multicast,
                                              combine_impl):
    p = SchemeParams(*KPQN, r=r)
    mesh = make_mesh((p.P, p.Kr), ("rack", "server"), device=card)
    job, subs = jobs.wide_histogram_job(5), _subfiles()
    kw = dict(multicast=multicast, combine_impl=combine_impl,
              scheme_family=family)
    ref = eng.run_job_distributed(job, subs, p, mesh, **kw).outputs
    coded_pair = dict(NO_LAUNCH, coded_encode=1, coded_decode=1)
    clean = (coded_pair if multicast == "coded" and combine_impl == "kernel"
             and (r if family == "binomial" else r - 1) >= 2 else NO_LAUNCH)
    schedules = [FaultInjector.crash((3,)), FaultInjector.crash((0, 5)),
                 FaultInjector.crash((0, 2)), FaultInjector.rack_crash(p, 1),
                 FaultInjector.crash(tuple(range(p.K)))]
    for inj in schedules:
        res, launches = _launches(lambda: eng.run_job_distributed(
            job, subs, p, mesh, faults=FaultSpec(inj), **kw))
        assert torch.equal(res.outputs, ref), (inj, res.recovery)
        rep = res.recovery
        dplan = None if rep.rung == "restart" else \
            dg.compile_degraded_plan(p, rep.failed, family=family)
        if dplan is None:
            assert rep.restarts == 1 and len(rep.backoff_delays) == 1
            assert launches == clean
        else:
            assert rep.rung == ("decode_around" if dplan.decode_around
                                else "partial_remap")
            assert rep.n_remapped == dplan.orphan_subfiles.size
            assert launches == NO_LAUNCH


@pytest.mark.cuda
@pytest.mark.parametrize("family,r", FAMILY_GRID)
@pytest.mark.parametrize("dtype", [np.float32, np.int32],
                         ids=["float32", "int32"])
def test_poisoned_dead_servers_on_the_card(card, family, r, dtype):
    p = SchemeParams(*KPQN, r=r)
    V = np.random.default_rng(r).integers(-100, 100, size=(
        p.N, p.Q, 3)).astype(dtype)
    poison = float("nan") if dtype == np.float32 else 0x7fffffff
    for failed in [(3,), (0, 2), (2, 3)]:
        dplan = dg.compile_degraded_plan(p, failed, family=family)
        vals = torch.as_tensor(cc.pack_local_values(V, dplan.plan),
                               device=card)
        vals[list(failed)] = poison
        patch = rec.device_patch(
            dplan, torch.as_tensor(V[dplan.orphan_subfiles], device=card))
        out = rec.degraded_device_body(
            vals, dplan, dplan.device_tables(card),
            rec.alive_mask(p, failed, card), patch)
        want = cc.simulate_plan_shuffle(
            V, dplan.plan, failed=failed,
            patch=dg.build_patch(dplan, V[dplan.orphan_subfiles]))
        np.testing.assert_array_equal(out.cpu().numpy(), want)
        np.testing.assert_array_equal(
            want, cc.plan_shuffle_reference(V, p, family=family))


@pytest.mark.cuda
def test_evicted_degraded_tables_leave_the_card(card):
    p = SchemeParams(*KPQN, r=2)
    dg.configure_degraded_cache(maxsize=1)
    try:
        held = weakref.ref(
            dg.compile_degraded_plan(p, (0,)).device_tables(card).send_src)
        gc.collect()
        assert held() is not None
        dg.compile_degraded_plan(p, (1,))
        gc.collect()
        assert held() is None
    finally:
        dg.configure_degraded_cache()
