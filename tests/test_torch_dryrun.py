"""The port's dry run against the JAX package's, and its shape-only pieces.

* The cell shapes, ``cell_is_runnable`` and ``train_batch_specs`` equal the
  JAX package's (the port's tokens are int64, as ``make_train_batch``
  draws them).
* The pure functions of ``launch/hlo_analysis.py`` (``_wire_bytes``,
  ``roofline_terms``, ``fit_cost_poly``, ``collective_summary`` over
  records against the JAX one over the same collectives' HLO lines) equal
  ``repro.launch.hlo_analysis``'s, imported here (it imports no JAX).
* ``make_plan``, ``depth_grid``, ``_fit_poly`` / ``_eval_poly`` and the
  analytic capacity and traffic models equal ``repro.launch.dryrun``'s to
  1e-9 relative on 12 cells covering every family, every shape kind and
  both meshes, the JAX side in ONE subprocess (``repro.launch.dryrun``
  sets ``XLA_FLAGS`` when imported).
* Each kernel op's shape-only route (a ``meta`` tensor inside a dry run):
  the card's route, the plain path's shapes and dtypes, counted in
  ``DRY_CALLS`` only, its work reported; a CPU tensor still takes the
  plain path and reports nothing; a ``meta`` tensor outside a dry run
  still raises.
* The memory tracker's exact peak on a scripted sequence.
"""
import importlib.util
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.launch import hlo_analysis as j_hlo
from repro_torch.configs import ARCHS, SHAPES, cell_is_runnable
from repro_torch.distributed.collectives import CollectiveRecord
from repro_torch.kernels import _card
from repro_torch.kernels.coded_combine import ops as cc_ops
from repro_torch.kernels.flash_attention import backward as fab
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.rwkv_scan import backward as rwb
from repro_torch.kernels.rwkv_scan import ops as rw
from repro_torch.launch import dryrun
from repro_torch.launch import hlo_analysis as hlo
from repro_torch.launch.mesh import mesh_shape_by_kind
from repro_torch.models import frontends, lm

ROOT = pathlib.Path(__file__).resolve().parents[1]
REL = 1e-9

# every family, every shape kind, both meshes
CELLS = [("qwen2-72b", "train_4k", "single"),
         ("granite-3-2b", "decode_32k", "multi"),
         ("llava-next-34b", "prefill_32k", "multi"),
         ("deepseek-v2-lite-16b", "train_4k", "multi"),
         ("grok-1-314b", "decode_32k", "single"),
         ("rwkv6-3b", "long_500k", "single"),
         ("hymba-1.5b", "long_500k", "multi"),
         ("hymba-1.5b", "train_4k", "single"),
         ("whisper-large-v3", "prefill_32k", "multi"),
         ("whisper-large-v3", "train_4k", "single"),
         ("qwen2-1.5b", "decode_32k", "single"),
         ("llama3-405b", "prefill_32k", "multi")]

# (depths, S, cost) point sets for the fits: constant, linear and quadratic
# in S, one with two depth stacks
FIT_SETS = [
    [((d,), s, 5.0 + 2.0 * d) for d in (1, 2) for s in (1024, 2048, 4096)],
    [((d,), s, 3.0 + d * (7.0 + 0.5 * s)) for d in (1, 2)
     for s in (1024, 2048, 4096)],
    [((d,), s, 1.0 + d * (2.0 * s + 0.25 * s * s)) for d in (1, 2)
     for s in (512, 1024, 2048)],
    [((a, b), s, 9.0 + a * s + 3.0 * b * s * s) for a, b in
     ((1, 1), (2, 1), (1, 2)) for s in (1024, 2048, 4096)],
]
FIT_EVAL = [((80,), 32768), ((80,), 524288), ((126,), 4096),
            ((32, 32), 32768)]

JAX_SIDE = r"""
import dataclasses, json, sys
import numpy as np
from repro.configs import ARCHS
from repro.configs.base import SHAPES
from repro.launch import dryrun as d
from repro.launch.mesh import make_mesh_by_kind
cells, fit_sets, fit_eval = json.loads(sys.argv[1])
out = {"cells": [], "fits": []}
meshes = {}
for arch, shape, mk in cells:
    plan = d.make_plan(arch, shape, mk)
    cfg = ARCHS[arch]
    sh = [s for s in SHAPES if s.name == shape][0]
    mesh = meshes.setdefault(mk, make_mesh_by_kind(mk))
    pol = d._policy(plan, mesh)
    peak = d.analytic_peak_bytes(plan, cfg, sh, mesh, pol)
    plan_d = dataclasses.asdict(plan)
    plan_d.pop("dtype")
    out["cells"].append({"plan": plan_d, "grid": d.depth_grid(cfg),
                         "peak": peak,
                         "traffic": d.analytic_memory_bytes(plan, cfg, sh,
                                                            mesh)})
for pts in fit_sets:
    fit = d._fit_poly([(tuple(dp), s, c) for dp, s, c in pts])
    out["fits"].append({"order": fit["order"],
                        "coef": np.asarray(fit["coef"]).tolist(),
                        "values": [d._eval_poly(fit, tuple(dp), s)
                                   for dp, s in fit_eval
                                   if len(dp) == len(pts[0][0])]})
print(json.dumps(out))
"""


def _close(a, b, rel=REL):
    return abs(a - b) <= rel * max(abs(a), abs(b), 1.0)


@pytest.fixture(scope="module")
def jax_side():
    arg = json.dumps([CELLS, FIT_SETS, FIT_EVAL])
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-c", JAX_SIDE, arg], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


# ---------------------------------------------------------------------------
# Configs and batch specs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_shapes_and_runnable_cells_equal_jax(arch):
    from repro.configs import ARCHS as J_ARCHS
    from repro.configs.base import SHAPES as J_SHAPES
    from repro.configs.base import cell_is_runnable as j_runnable
    assert [tuple(vars(s).values()) for s in SHAPES] == \
        [tuple(vars(s).values()) for s in J_SHAPES]
    for sh, jsh in zip(SHAPES, J_SHAPES):
        assert cell_is_runnable(ARCHS[arch], sh) == \
            j_runnable(J_ARCHS[arch], jsh)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_train_batch_specs_equal_jax(arch):
    import jax.numpy as jnp
    from repro.configs import ARCHS as J_ARCHS
    from repro.models.frontends import train_batch_specs as j_specs
    sh = SHAPES[0]
    got = frontends.train_batch_specs(ARCHS[arch], sh)
    want = j_specs(J_ARCHS[arch], sh)
    assert sorted(got) == sorted(want)
    ints = {"tokens", "targets"}
    for k, spec in want.items():
        assert tuple(got[k].shape) == tuple(spec.shape), k
        assert got[k].device.type == "meta"
        if k in ints:
            assert spec.dtype == jnp.int32 and got[k].dtype == torch.int64
        else:
            assert str(got[k].dtype).replace("torch.", "") == \
                str(spec.dtype), k


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_count_embedding_params_equals_jax(arch):
    from repro.configs import ARCHS as J_ARCHS
    from repro.models import lm as j_lm
    assert lm.count_embedding_params(ARCHS[arch]) == \
        j_lm.count_embedding_params(J_ARCHS[arch])


# ---------------------------------------------------------------------------
# hlo_analysis's pure functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["all-gather", "all-gather-start",
                                  "all-reduce", "reduce-scatter",
                                  "all-to-all", "collective-permute",
                                  "send"])
def test_wire_bytes_equal_jax(kind):
    for shapes in ([], [4096], [1024, 16384], [7, 3, 5]):
        for n in (1, 2, 16, 32, 512):
            assert hlo._wire_bytes(kind, shapes, n) == \
                j_hlo._wire_bytes(kind, shapes, n)


def test_roofline_terms_equal_jax_under_one_hw():
    rng = np.random.default_rng(3)
    for _ in range(50):
        args = [float(x) for x in rng.uniform(0, 1e13, 4)]
        if rng.random() < 0.2:
            args[int(rng.integers(0, 4))] = 0.0
        assert hlo.roofline_terms(*args, hw=hlo.HW) == \
            j_hlo.roofline_terms(*args, hw=hlo.HW)
    assert hlo.roofline_terms(0.0, 0.0, 0.0, 0.0)["roofline_fraction"] == 0


def test_fit_cost_poly_equals_jax():
    rng = np.random.default_rng(4)
    pts = [(L, S, float(rng.uniform(1, 1e9))) for L in (1, 2, 3)
           for S in (512, 1024)]
    assert hlo.fit_cost_poly(pts) == j_hlo.fit_cost_poly(pts)
    exact = [(L, S, 3.0 + 2 * L + S * (1 + L) + 0.5 * S * S * L)
             for L in (1, 2) for S in (512, 1024, 2048)]
    coef = hlo.fit_cost_poly(exact)
    assert coef == j_hlo.fit_cost_poly(exact)
    for L, S in ((80, 32768), (3, 4096)):
        assert hlo.eval_cost_poly(coef, L, S) == \
            j_hlo.eval_cost_poly(coef, L, S)
        want = 3.0 + 2 * L + S * (1 + L) + 0.5 * S * S * L
        assert _close(hlo.eval_cost_poly(coef, L, S), want, 1e-6)


def _hlo_line(kind, dims, groups_text):
    shape = ",".join(str(d) for d in dims)
    return (f"  %c = f32[{shape}]{{1,0}} {kind}(f32[{shape}]{{1,0}} %x), "
            f"replica_groups={groups_text}, dimensions={{0}}")


def test_collective_summary_equals_jax_over_the_same_collectives():
    """The same collectives as records (rank 0's group) and as HLO lines
    (every group): intra-pod groups of 16 (model), 16 strided (data), a
    group of 2 across pods, the whole world."""
    pod = 256
    cases = [  # (kind, out dims, rank 0's group, HLO groups)
        ("all-gather", (16, 1024), tuple(range(16)), "[32,16]<=[512]"),
        ("all-to-all", (16, 64), tuple(range(0, 256, 16)),
         "[32,16]<=[2,16,16]T(0,2,1)"),
        ("all-gather", (2, 4096), (0, 256), "[256,2]<=[2,256]T(1,0)"),
        ("all-to-all", (512, 8), tuple(range(512)), "[1,512]<=[512]"),
        ("all-gather", (4, 128), (0, 1, 2, 3), "{{0,1,2,3},{4,5,6,7}}"),
    ]
    records = [CollectiveRecord(kind, "psum" if kind == "all-gather"
                                else "psum_scatter",
                                int(np.prod(dims)) * 4 // len(ranks),
                                int(np.prod(dims)) * 4, ranks)
               for kind, dims, ranks, _ in cases]
    text = "\n".join(_hlo_line(kind, dims, groups)
                     for kind, dims, _, groups in cases)
    got = hlo.collective_summary(records, pod)
    want = j_hlo.collective_summary(text, pod)
    for k in ("ici_bytes", "dcn_bytes", "n_ops", "n_cross_pod_ops"):
        assert _close(got[k], want[k]), (k, got[k], want[k])
    assert got["per_kind"].keys() == want["per_kind"].keys()
    for k in want["per_kind"]:
        assert _close(got["per_kind"][k], want["per_kind"][k])
    assert got["dcn_bytes"] > 0 and got["n_cross_pod_ops"] == 2
    assert _close(sum(got["per_fn"].values()),
                  sum(got["per_kind"].values()))


def test_psum_is_priced_as_the_all_gather_it_issues():
    n, nbytes = 16, 4 << 20
    rec = CollectiveRecord("all-gather", "psum", nbytes, n * nbytes,
                           tuple(range(n)))
    got = hlo.collective_summary([rec], 256)
    assert got["ici_bytes"] == (n - 1) * nbytes
    allreduce = j_hlo._wire_bytes("all-reduce", [nbytes], n)
    assert got["ici_bytes"] / allreduce == pytest.approx(n / 2)


def test_hw_holds_the_cards_figures_only():
    assert hlo.HW["name"] == "NVIDIA H100 80GB HBM3"
    assert (hlo.HW["peak_flops_bf16"], hlo.HW["peak_flops_tf32"],
            hlo.HW["hbm_bw"]) == (989e12, 495e12, 3.35e12)
    assert hlo.HW["ici_bw"] == 450e9 and hlo.HW["dcn_bw"] == 50e9
    assert 79 * 2 ** 30 < hlo.HW["hbm_bytes"] < 80 * 2 ** 30
    tpu = {j_hlo.HW[k] for k in ("peak_flops_bf16", "hbm_bw", "ici_bw",
                                 "dcn_bw", "hbm_bytes")} - {50e9}
    assert len(tpu) == 4 and not tpu & set(hlo.HW.values())


# ---------------------------------------------------------------------------
# The JAX dry run's plan, grid, fits and analytic models
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("i", range(len(CELLS)),
                         ids=["-".join(c) for c in CELLS])
def test_plan_grid_and_analytic_models_equal_jax(i, jax_side):
    arch, shape, mk = CELLS[i]
    want = jax_side["cells"][i]
    plan = dryrun.make_plan(arch, shape, mk)
    got_plan = {k: getattr(plan, k) for k in want["plan"]}
    got_plan["s_points"] = list(plan.s_points)
    assert got_plan == want["plan"]
    assert plan.dtype == torch.bfloat16
    combos, target = dryrun.depth_grid(ARCHS[arch])
    assert [list(c) for c in combos] == want["grid"][0]
    assert list(target) == want["grid"][1]
    mesh = mesh_shape_by_kind(mk)
    sh = [s for s in SHAPES if s.name == shape][0]
    peak = dryrun.analytic_peak_bytes(plan, ARCHS[arch], sh, mesh,
                                      dryrun._policy(plan, mesh))
    for k, v in want["peak"].items():
        if k == "fits_16gib":
            continue
        assert _close(peak[k], v), (k, peak[k], v)
    assert peak["fits_hbm"] == (peak["total"] <= hlo.HW["hbm_bytes"])
    assert _close(dryrun.analytic_memory_bytes(plan, ARCHS[arch], sh, mesh),
                  want["traffic"])


@pytest.mark.parametrize("j", range(len(FIT_SETS)))
def test_fit_poly_and_eval_equal_jax(j, jax_side):
    pts = FIT_SETS[j]
    fit = dryrun._fit_poly(pts)
    want = jax_side["fits"][j]
    assert fit["order"] == want["order"]
    assert all(_close(a, b) for a, b in zip(fit["coef"], want["coef"]))
    got = [dryrun._eval_poly(fit, dp, s) for dp, s in FIT_EVAL
           if len(dp) == len(pts[0][0])]
    assert all(_close(a, b) for a, b in zip(got, want["values"]))


# ---------------------------------------------------------------------------
# Shape-only routes
# ---------------------------------------------------------------------------

def _zero_counts():
    for m in (cc_ops, fa, fab, rw, rwb):
        m.reset_launch_counts()


def _counts():
    out = {"launches": {}, "routes": {}, "plain": {}}
    for m in (cc_ops, fa, fab, rw, rwb):
        out["launches"].update(m.LAUNCHES)
        out["plain"].update(getattr(m, "PLAIN_CALLS", {}))
        for r, n in getattr(m, "ROUTE_CALLS", {}).items():
            out["routes"][f"{m.__name__}.{r}"] = n
    return out


def _silent(counts):
    return not any(v for part in counts.values() for v in part.values())


def _meta(*tensors):
    return [torch.empty(t.shape, dtype=t.dtype, device="meta")
            for t in tensors]


def _rand(shape, dtype, gen):
    return torch.randn(shape, generator=gen).to(dtype)


# (name, B, Sq, Sk, H, KV, hd, dtype, kwargs, route)
FLASH = [
    ("prefill_bf16", 2, 32, 32, 4, 2, 64, torch.bfloat16, {}, "tensor_core"),
    ("decode", 2, 1, 40, 4, 2, 64, torch.bfloat16,
     {"kv_valid": 33, "q_offset": 32}, "split_kv"),
    ("prefill_fp32_window", 1, 24, 24, 2, 1, 32, torch.float32,
     {"window": 8}, "mma_tf32"),
    ("mla_wide", 1, 20, 20, 4, 1, 576, torch.bfloat16, {},
     "tensor_core_wide"),
]


@pytest.mark.parametrize("case", FLASH, ids=[c[0] for c in FLASH])
def test_flash_shape_only_route(case):
    name, B, Sq, Sk, H, KV, hd, dtype, kw, route = case
    gen = torch.Generator().manual_seed(5)
    q = _rand((B, Sq, H, hd), dtype, gen)
    k = _rand((B, Sk, KV, hd), dtype, gen)
    v = _rand((B, Sk, KV, hd), dtype, gen)
    _zero_counts()
    with _card.record_work() as work:
        plain = fa.flash_attention(q, k, v, **kw)
    assert fa.PLAIN_CALLS["flash_attention"] == 1 and not fa.DRY_CALLS
    assert not work.by_kernel                # the plain path reports nothing
    _zero_counts()
    mq, mk, mv = _meta(q, k, v)
    with _card.dry_run(), _card.record_work() as work:
        out = fa.flash_attention(mq, mk, mv, **kw)
    assert out.device.type == "meta"
    assert out.shape == plain.shape and out.dtype == plain.dtype
    assert fa.DRY_CALLS == {route: 1}
    fa.DRY_CALLS.clear()
    assert _silent(_counts())
    want = fa.attention_work(mq, mk, mv, causal=True,
                             window=kw.get("window"),
                             q_offset=kw.get("q_offset", 0),
                             kv_valid=kw.get("kv_valid"))
    assert work.by_kernel == {"flash_attention": {
        "calls": 1, "flops": want[0], "bytes": want[1]}}
    # outside a dry run a meta tensor still raises
    with pytest.raises(ValueError):
        fa.flash_attention(mq, mk, mv, **kw)


def test_flash_shape_only_backward_under_the_function():
    gen = torch.Generator().manual_seed(6)
    q, k, v = (_rand(s, torch.float32, gen) for s in
               ((2, 16, 4, 32), (2, 16, 2, 32), (2, 16, 2, 32)))
    mq, mk, mv = (t.requires_grad_() for t in _meta(q, k, v))
    _zero_counts()
    with _card.dry_run(), _card.record_work() as work:
        out = fa.flash_attention(mq, mk, mv)
        assert type(out.grad_fn).__name__.startswith("FlashAttentionFn")
        dq, dk, dv = torch.autograd.grad(out.sum(), (mq, mk, mv))
    assert [t.shape for t in (dq, dk, dv)] == [q.shape, k.shape, v.shape]
    assert fa.DRY_CALLS == {"mma_tf32": 1}
    assert fab.DRY_CALLS == {"tf32x3": 1}
    assert set(work.by_kernel) == {"flash_attention",
                                   "flash_attention_backward"}
    fl, nb = fa.attention_work(mq, mk, mv, causal=True, window=None,
                               backward=True)
    assert work.by_kernel["flash_attention_backward"]["flops"] == fl
    assert fl == 10.0 * 32 * 4 * 2 * (16 * 17 // 2)
    _zero_counts()
    assert _silent(_counts())


def test_visible_pairs_equal_the_bound_formula():
    """The op's closed form against chip_smoke.py's loop."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    for Sq, Sk, off, valid, causal, window in (
            (64, 64, 0, None, True, None), (1, 2112, 2110, 2111, True, None),
            (40, 300, 100, 200, True, 17), (8, 96, 40, 42, True, 4),
            (5, 50, 0, 30, False, None), (3, 128, 80, 50, True, 8)):
        v = Sk if valid is None else valid
        assert fa.visible_pairs(Sq, off, v, causal, window) == \
            cs.visible_pairs(Sq, Sk, off, valid, causal, window)


# (name, B, S, h, Nk, Nv, dtype, route)
WKV = [("tensor_core", 1, 32, 2, 64, 64, torch.bfloat16, "tensor_core"),
       ("chunk_f32", 2, 20, 3, 16, 32, torch.float32, "chunk_f32"),
       ("step", 1, 8, 2, 64, 64, torch.float32, "step")]


@pytest.mark.parametrize("case", WKV, ids=[c[0] for c in WKV])
def test_wkv_shape_only_route(case):
    name, B, S, h, Nk, Nv, dtype, route = case
    gen = torch.Generator().manual_seed(7)
    r, k = (_rand((B, S, h, Nk), dtype, gen) for _ in range(2))
    v = _rand((B, S, h, Nv), dtype, gen)
    log_w = -torch.rand((B, S, h, Nk), generator=gen)
    u = _rand((h, Nk), torch.float32, gen)
    _zero_counts()
    with _card.record_work() as work:
        out, sT = rw.wkv_scan(r, k, v, log_w, u)
    assert rw.PLAIN_CALLS["wkv_scan"] == 1 and not work.by_kernel
    _zero_counts()
    m = _meta(r, k, v, log_w, u)
    with _card.dry_run(), _card.record_work() as work:
        mout, msT = rw.wkv_scan(*m)
    assert (mout.shape, mout.dtype, msT.shape, msT.dtype) == \
        (out.shape, out.dtype, sT.shape, sT.dtype)
    assert rw.DRY_CALLS == {route: 1}
    rw.DRY_CALLS.clear()
    assert _silent(_counts())
    fl, nb = rw.scan_work(m[0], m[2], m[3])
    assert work.by_kernel == {"wkv_scan": {"calls": 1, "flops": fl,
                                           "bytes": nb}}
    assert fl == 7.0 * B * S * h * Nk * Nv
    with pytest.raises(ValueError):
        rw.wkv_scan(*m)


def test_wkv_inclusive_and_both_backward_routes_shape_only():
    gen = torch.Generator().manual_seed(8)
    B, h, Nk, Nv = 2, 3, 16, 64
    for S, want_bwd in ((80, "chunk"), (20, "step")):
        r, k = (_rand((B, S, h, Nk), torch.float32, gen) for _ in range(2))
        v = _rand((B, S, h, Nv), torch.float32, gen)
        log_w = -torch.rand((B, S, h, Nk), generator=gen)
        u = _rand((h, Nk), torch.float32, gen)
        m = [t.requires_grad_() for t in _meta(r, k, v, log_w, u)]
        _zero_counts()
        with _card.dry_run(), _card.record_work() as work:
            out, _ = rw.wkv_scan(*m)
            grads = torch.autograd.grad(out.sum(), m)
            inc, state = rw.inclusive_scan(*(t.detach() for t in m[:4]))
        assert [g.shape for g in grads] == [t.shape for t in m]
        assert rwb.DRY_CALLS == {want_bwd: 1}
        assert rw.DRY_CALLS == {"chunk_f32": 2}
        assert inc.shape == v.shape and state.shape == (B, h, Nk, Nv)
        assert work.by_kernel["wkv_scan_backward"]["bytes"] == \
            rwb.backward_work(m[0], m[2], m[3], m[4])[1]
        _zero_counts()
        assert _silent(_counts())


@pytest.mark.parametrize("op", ["coded_encode", "coded_decode",
                                "xor_encode", "xor_decode"])
def test_combine_shape_only_route(op):
    xor = op.startswith("xor")
    dtype = torch.int32 if xor else torch.float32
    xs = torch.zeros((3, 40, 16), dtype=dtype)
    args = {"coded_encode": lambda x: (x, [1.0, 2.0, 3.0]),
            "coded_decode": lambda x: (x[0], x[1:], [1.0, 2.0, 3.0]),
            "xor_encode": lambda x: (x,),
            "xor_decode": lambda x: (x[0], x[1:])}[op]
    fn = getattr(cc_ops, op)
    _zero_counts()
    with _card.record_work() as work:
        plain = fn(*args(xs))
    assert not work.by_kernel and not cc_ops.DRY_CALLS
    mxs = torch.empty(xs.shape, dtype=dtype, device="meta")
    with _card.dry_run(), _card.record_work() as work:
        out = fn(*args(mxs))
    assert out.shape == plain.shape and out.dtype == plain.dtype
    assert cc_ops.DRY_CALLS == {op: 1}
    assert work.by_kernel[op]["bytes"] == 4 * 40 * 16 * 4
    _zero_counts()
    assert _silent(_counts())
    with pytest.raises(ValueError):
        fn(*args(mxs))


def test_on_card_is_cuda_or_meta_inside_a_dry_run():
    meta, cpu = torch.empty(2, device="meta"), torch.empty(2)
    assert not _card.on_card(meta) and not _card.on_card(cpu)
    with _card.dry_run():
        with _card.dry_run():
            assert _card.on_card(meta) and _card.on_card(meta.device)
        assert _card.on_card(meta) and not _card.on_card(cpu)
    assert not _card.on_card(meta) and not _card.dry_run_active()
    assert _card.on_card(torch.device("cuda"))


def test_meta_model_outside_a_dry_run_raises_inside_it_runs():
    cfg = ARCHS["qwen2-72b"].reduced()
    params = lm.init_params(0, cfg, device="meta")
    toks = torch.empty((2, 8), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError):
        lm.forward(params, cfg, toks)
    _zero_counts()
    with _card.dry_run():
        logits, _, _ = lm.forward(params, cfg, toks)
    assert logits.shape == (2, 8, cfg.vocab_size)
    assert fa.DRY_CALLS == {"mma_tf32": cfg.n_layers}
    _zero_counts()


# ---------------------------------------------------------------------------
# The memory tracker
# ---------------------------------------------------------------------------

def test_memory_tracker_exact_peak_on_a_scripted_sequence():
    mb4 = 1 << 22
    with dryrun.MemoryTracker() as mem:
        a = torch.empty(mb4 // 4, device="meta")            # 4 MB
        b = torch.empty(mb4 // 4, device="meta")            # 4 MB
        assert (mem.live, mem.peak) == (2 * mb4, 2 * mb4)
        del a
        assert mem.live == mb4
        c = torch.empty(mb4 // 4, device="meta")            # 4 MB again
        view = c.view(2, -1)                                 # no bytes
        c.add_(1.0)                                          # in place
        assert (mem.live, mem.peak) == (2 * mb4, 2 * mb4)
        mem.start()
        d = b + c                                            # 4 MB
        e = torch.empty(100, dtype=torch.uint8, device="meta")  # 1 granule
        assert mem.live == 3 * mb4 + 512
        del d
        mem.finish((c, e))
    s = mem.summary()
    assert s["argument_bytes"] == 2 * mb4
    assert s["peak_bytes"] == 3 * mb4 + 512
    assert s["output_bytes"] == mb4 + 512 and s["alias_bytes"] == mb4
    assert s["temp_bytes"] == mb4
    assert (s["argument_bytes"] + s["temp_bytes"] + s["output_bytes"]
            - s["alias_bytes"]) == s["peak_bytes"]
    del b, c, e, view
    assert mem.live == 0
