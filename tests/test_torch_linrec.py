"""The port's linear recurrence and WKV scan op against the JAX package's
on the CPU (JAX: the Pallas kernel in interpret mode and the jnp forms), on
the grid of tests/test_kernels.py, including S % chunk != 0.  Tolerances:
fp32 3e-4, bf16 3e-2.  The CUDA kernel is held against the same plain
versions in tests/test_torch_kernels_cuda.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rwkv_scan import ops as j_rw_ops
from repro.kernels.rwkv_scan import ref as j_rw_ref
from repro.models import linrec as j_linrec
from repro_torch.kernels.rwkv_scan import ops, ref
from repro_torch.models import linrec

DTYPES = {"float32": (torch.float32, jnp.float32, 3e-4),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, 3e-2)}


def _inputs(B, S, h, Nk, Nv, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    return {"r": f(B, S, h, Nk), "k": f(B, S, h, Nk), "v": f(B, S, h, Nv),
            "w": -np.exp(f(B, S, h, Nk)), "u": 0.1 * f(h, Nk),
            "s0": 0.1 * f(B, h, Nk, Nv)}


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _close(a, b, tol):
    np.testing.assert_allclose(_np(a), _np(b), rtol=tol, atol=tol)


@pytest.fixture(autouse=True)
def _no_launch_on_cpu():
    ops.reset_launch_counts()
    yield
    assert ops.LAUNCHES["wkv_scan"] == 0


@pytest.mark.parametrize("B,S,h,Nk,Nv,chunk", [
    (1, 64, 2, 16, 16, 16),
    (2, 100, 3, 32, 32, 32),      # ragged: S % chunk != 0
    (1, 128, 1, 64, 64, 64),
])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_wkv_scan_matches_jax(B, S, h, Nk, Nv, chunk, dtype):
    x = _inputs(B, S, h, Nk, Nv, seed=S + h)
    tdt, jdt, tol = DTYPES[dtype]
    t = {n: torch.from_numpy(a) for n, a in x.items()}
    j = {n: jnp.asarray(a) for n, a in x.items()}
    r, k, v, w = (t[n].to(tdt) for n in "rkvw")
    jr, jk, jv, jw = (j[n].astype(jdt) for n in "rkvw")
    out, sT = ops.wkv_scan(r, k, v, w, t["u"], t["s0"], chunk=chunk)
    jout, jsT = j_rw_ops.wkv_scan(jr, jk, jv, jw, j["u"], j["s0"],
                                  chunk=chunk)
    assert out.shape == (B, S, h, Nv) and out.dtype == tdt
    assert sT.shape == (B, h, Nk, Nv) and sT.dtype == torch.float32
    _close(out, jout, tol)
    _close(sT, jsT, tol)
    oref, sref = j_linrec.chunked_linear_recurrence(
        jr, jk, jv, jw, u=j["u"], initial_state=j["s0"], mode="rwkv",
        chunk=chunk, return_state=True)
    _close(out, oref, tol)
    _close(sT, sref, tol)
    assert ops.PLAIN_CALLS["wkv_scan"] == 1


def test_wkv_scan_ref_matches_jax_ref():
    """The kernel-layout plain version, [BH, S, N], against JAX's."""
    x = _inputs(1, 40, 3, 16, 8, seed=3)
    bh = lambda a: a[0].transpose(1, 0, 2)                # [h, S, N]
    args = [bh(x[n]) for n in "rkvw"] + [x["u"], x["s0"][0]]
    out, sT = ref.wkv_scan_ref(*map(torch.from_numpy, args), chunk=16)
    jout, jsT = j_rw_ref.wkv_scan_ref(*map(jnp.asarray, args), chunk=16)
    _close(out, jout, 3e-4)
    _close(sT, jsT, 3e-4)


def test_wkv_scan_vs_naive_steps():
    """Op == step-by-step recurrence (the ground-truth semantics), in both
    packages."""
    x = _inputs(1, 48, 2, 16, 16, seed=30)
    t = {n: torch.from_numpy(a) for n, a in x.items()}
    out, sT = ops.wkv_scan(t["r"], t["k"], t["v"], t["w"], t["u"], chunk=16)
    oref, sref = linrec.naive_linear_recurrence(t["r"], t["k"], t["v"],
                                                t["w"], u=t["u"])
    _close(out, oref, 3e-4)
    _close(sT, sref, 3e-4)
    jo, js = j_linrec.naive_linear_recurrence(
        *(jnp.asarray(x[n]) for n in "rkvw"), u=jnp.asarray(x["u"]))
    _close(oref, jo, 3e-4)
    _close(sref, js, 3e-4)


def test_wkv_scan_bf16_streams_with_fp32_decay():
    """The model's mix: r, k, v in bf16, log_w in fp32."""
    x = _inputs(2, 33, 2, 16, 16, seed=5)
    t = {n: torch.from_numpy(a) for n, a in x.items()}
    r, k, v = (t[n].to(torch.bfloat16) for n in "rkv")
    out, sT = ops.wkv_scan(r, k, v, t["w"], t["u"], t["s0"], chunk=8)
    jr, jk, jv = (jnp.asarray(x[n]).astype(jnp.bfloat16) for n in "rkv")
    oref, sref = j_linrec.chunked_linear_recurrence(
        jr, jk, jv, jnp.asarray(x["w"]), u=jnp.asarray(x["u"]),
        initial_state=jnp.asarray(x["s0"]), mode="rwkv", chunk=8,
        return_state=True)
    _close(out, oref, 3e-2)
    _close(sT, sref, 3e-2)


@pytest.mark.parametrize("mode", ["rwkv", "inclusive"])
@pytest.mark.parametrize("chunk", [1, 5, 16])
def test_chunked_recurrence_matches_jax(mode, chunk):
    x = _inputs(2, 21, 2, 8, 12, seed=chunk)
    u = x["u"] if mode == "rwkv" else None
    out, sT = linrec.chunked_linear_recurrence(
        *(torch.from_numpy(x[n]) for n in "rkvw"),
        u=None if u is None else torch.from_numpy(u),
        initial_state=torch.from_numpy(x["s0"]), mode=mode, chunk=chunk,
        return_state=True)
    jout, jsT = j_linrec.chunked_linear_recurrence(
        *(jnp.asarray(x[n]) for n in "rkvw"),
        u=None if u is None else jnp.asarray(u),
        initial_state=jnp.asarray(x["s0"]), mode=mode, chunk=chunk,
        return_state=True)
    _close(out, jout, 3e-4)
    _close(sT, jsT, 3e-4)


@pytest.mark.parametrize("mode", ["rwkv", "inclusive"])
def test_recurrent_step_matches_jax(mode):
    x = _inputs(3, 1, 2, 8, 12, seed=17)
    step = [x[n][:, 0] for n in "rkvw"]
    u = x["u"] if mode == "rwkv" else None
    out, st = linrec.recurrent_step(
        *map(torch.from_numpy, step), torch.from_numpy(x["s0"]),
        None if u is None else torch.from_numpy(u), mode=mode)
    jout, jst = j_linrec.recurrent_step(
        *map(jnp.asarray, step), jnp.asarray(x["s0"]),
        None if u is None else jnp.asarray(u), mode=mode)
    _close(out, jout, 3e-4)
    _close(st, jst, 3e-4)
