"""The plain mirror of the WKV scan's ``tensor_core`` route
(``ref.wkv_subchunk_ref``: chunks, 16-step sub-chunks whose products are
matrix products, diagonal blocks computed directly) against the JAX
package's ``wkv_scan_ref`` (the chunked jnp form) and ``wkv_scan`` (the
Pallas kernel in interpret mode) on the CPU, with numpy inputs from a seed;
and the route choice, a plain function of dtype and shape.  The CUDA kernel
is held against this mirror on the card in tests/test_torch_wkv_cuda.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rwkv_scan import ops as j_ops
from repro.kernels.rwkv_scan import ref as j_ref
from repro_torch.kernels import _build
from repro_torch.kernels.rwkv_scan import ops, ref

# fp32 on both sides, the same function summed in another order and with
# the gates factored at sub-chunk edges: tests/test_kernels.py's fp32
# tolerance
FP32_TOL = 3e-4
# bf16 streams: the output is rounded once to bf16, and with TF32 product
# operands the route's precision (PERF.md: 0.24 of this on the CPU) must
# still pass the card test's WKV_TOL[bf16]
BF16_TOL = 3e-2

# (B, S, h, N, chunk, sub, leaf): S off the chunk (100, 77, 2048 + 17),
# shorter than one sub-chunk (5, 12), and the kernel's blocks (32, 16, 8)
CASES = {
    "ragged_64": (1, 100, 2, 64, 64, 16, None),
    "ragged_kernel_blocks": (2, 77, 3, 32, 32, 16, 8),
    "long_ragged": (1, 2065, 1, 64, 32, 16, 8),
    "below_sub_chunk": (1, 5, 2, 64, 32, 16, 8),
    "below_sub_chunk_n32": (2, 12, 2, 32, 64, 16, None),
    "two_levels_n32": (1, 64, 2, 32, 64, 32, 8),
}


def _inputs(B, S, h, N, seed, *, scale=1.0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    return {"r": f(B, S, h, N), "k": f(B, S, h, N), "v": f(B, S, h, N),
            "w": -np.exp(scale * f(B, S, h, N)), "u": 0.1 * f(h, N),
            "s0": 0.1 * f(B, h, N, N)}


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _close(a, b, tol):
    np.testing.assert_allclose(_np(a), _np(b), rtol=tol, atol=tol)


def _jax_ref(x, s0, B, h, N):
    """JAX's kernel-layout oracle, back in model layout."""
    bh = lambda a: a.transpose(0, 2, 1, 3).reshape(B * h, a.shape[1], N)
    s0 = np.zeros((B, h, N, N), np.float32) if s0 is None else s0
    out, sT = j_ref.wkv_scan_ref(
        *(jnp.asarray(bh(x[n])) for n in "rkvw"),
        jnp.asarray(np.broadcast_to(x["u"], (B, h, N)).reshape(B * h, N)),
        jnp.asarray(s0.reshape(B * h, N, N)), chunk=16)
    out = np.asarray(out).reshape(B, h, -1, N).transpose(0, 2, 1, 3)
    return out, np.asarray(sT).reshape(B, h, N, N)


@pytest.mark.parametrize("with_s0", [True, False], ids=["s0", "zero_s0"])
@pytest.mark.parametrize("case", list(CASES))
def test_mirror_matches_jax_ref(case, with_s0):
    B, S, h, N, chunk, sub, leaf = CASES[case]
    x = _inputs(B, S, h, N, seed=S + N)
    s0 = x["s0"] if with_s0 else None
    t = {n: torch.from_numpy(a) for n, a in x.items()}
    out, sT = ref.wkv_subchunk_ref(
        t["r"], t["k"], t["v"], t["w"], t["u"],
        None if s0 is None else t["s0"], chunk=chunk, sub=sub, leaf=leaf)
    assert out.shape == (B, S, h, N) and out.dtype == torch.float32
    assert sT.shape == (B, h, N, N) and sT.dtype == torch.float32
    jout, jsT = _jax_ref(x, s0, B, h, N)
    _close(out, jout, FP32_TOL)
    _close(sT, jsT, FP32_TOL)


@pytest.mark.parametrize("case", ["ragged_64", "ragged_kernel_blocks",
                                  "below_sub_chunk"])
def test_mirror_matches_jax_pallas_kernel(case):
    """Against the Pallas kernel itself (interpret mode), which pads S to
    its chunk and carries the state across its grid."""
    B, S, h, N, chunk, sub, leaf = CASES[case]
    x = _inputs(B, S, h, N, seed=3 * S)
    t = {n: torch.from_numpy(a) for n, a in x.items()}
    out, sT = ref.wkv_subchunk_ref(*(t[n] for n in ("r", "k", "v", "w", "u",
                                                    "s0")),
                                   chunk=chunk, sub=sub, leaf=leaf)
    jout, jsT = j_ops.wkv_scan(*(jnp.asarray(x[n]) for n in
                                 ("r", "k", "v", "w", "u", "s0")), chunk=16)
    _close(out, jout, FP32_TOL)
    _close(sT, jsT, FP32_TOL)


@pytest.mark.parametrize("case", ["ragged_64", "ragged_kernel_blocks",
                                  "long_ragged"])
def test_tf32_operands_pass_the_bf16_tolerance(case):
    """bf16 r, k, v with the model's fp32 decay, every product operand
    rounded to TF32 as the kernel does: within WKV_TOL[bf16] of the fp32
    chunked recurrence on the same bf16 values."""
    B, S, h, N, chunk, sub, leaf = CASES[case]
    x = _inputs(B, S, h, N, seed=S)
    t = {n: torch.from_numpy(a) for n, a in x.items()}
    r, k, v = (t[n].to(torch.bfloat16) for n in "rkv")
    out, sT = ref.wkv_subchunk_ref(r, k, v, t["w"], t["u"], t["s0"],
                                   chunk=chunk, sub=sub, leaf=leaf,
                                   tf32=True)
    assert out.dtype == torch.bfloat16
    xb = dict(x, **{n: _np(t[n].to(torch.bfloat16)) for n in "rkv"})
    jout, jsT = _jax_ref(xb, x["s0"], B, h, N)
    _close(out, jout, BF16_TOL)
    _close(sT, jsT, BF16_TOL)


@pytest.mark.parametrize("w_bf16", [False, True], ids=["w_fp32", "w_bf16"])
def test_bf16_streams_match_jax_op(w_bf16):
    """bf16 r, k, v (and log_w) through the mirror and JAX's op, both
    rounding the output once to bf16."""
    B, S, h, N = 2, 50, 2, 32
    x = _inputs(B, S, h, N, seed=9)
    t = {n: torch.from_numpy(a) for n, a in x.items()}
    r, k, v = (t[n].to(torch.bfloat16) for n in "rkv")
    w = t["w"].to(torch.bfloat16) if w_bf16 else t["w"]
    out, sT = ref.wkv_subchunk_ref(r, k, v, w, t["u"], t["s0"], chunk=32,
                                   sub=16, leaf=8)
    jdt = jnp.bfloat16
    jw = jnp.asarray(x["w"]).astype(jdt if w_bf16 else jnp.float32)
    jout, jsT = j_ops.wkv_scan(*(jnp.asarray(x[n]).astype(jdt) for n in "rkv"),
                               jw, jnp.asarray(x["u"]), jnp.asarray(x["s0"]),
                               chunk=16)
    _close(out, jout, BF16_TOL)
    _close(sT, jsT, BF16_TOL)


@pytest.mark.parametrize("tf32", [False, True], ids=["fp32", "tf32"])
@pytest.mark.parametrize("S", [100, 2065])
def test_strong_decays_stay_finite(S, tf32):
    """log_w = -exp(3 randn) reaches -1e4 and beyond: every exponent is a
    difference <= 0, so gates underflow to 0 and none overflows."""
    x = _inputs(2, S, 2, 32, seed=S, scale=3.0)
    assert x["w"].min() < -1e4
    t = {n: torch.from_numpy(a) for n, a in x.items()}
    out, sT = ref.wkv_subchunk_ref(*(t[n] for n in ("r", "k", "v", "w", "u",
                                                    "s0")),
                                   chunk=32, sub=16, leaf=8, tf32=tf32)
    assert torch.isfinite(out).all() and torch.isfinite(sT).all()


def test_tf32_round_is_to_nearest_ties_away():
    one = 1.0
    ulp = 2.0 ** -10                    # TF32 keeps 10 mantissa bits
    x = torch.tensor([one + ulp / 2, one + ulp / 4, -(one + ulp / 2),
                      one + 3 * ulp / 4, 0.0, 3.0], dtype=torch.float32)
    want = torch.tensor([one + ulp, one, -(one + ulp), one + ulp, 0.0, 3.0])
    assert torch.equal(ref.tf32_round(x), want)


def test_mirror_rejects_blocks_that_do_not_nest():
    x = torch.zeros(1, 8, 1, 4)
    u = torch.zeros(1, 4)
    with pytest.raises(ValueError):
        ref.wkv_subchunk_ref(x, x, x, x, u, chunk=32, sub=12)
    with pytest.raises(ValueError):
        ref.wkv_subchunk_ref(x, x, x, x, u, chunk=32, sub=16, leaf=5)


@pytest.mark.parametrize("dtype,S,Nk,Nv,want", [
    (torch.bfloat16, 2048, 64, 64, "tensor_core"),     # RWKV6-3B prefill
    (torch.bfloat16, ops.TC_MIN_SEQ, 64, 64, "tensor_core"),
    (torch.bfloat16, 100, 64, 64, "tensor_core"),
    (torch.bfloat16, ops.TC_MIN_SEQ - 1, 64, 64, "step"),
    (torch.bfloat16, 1, 64, 64, "step"),               # a decode step
    (torch.float32, 2048, 64, 64, "step"),             # fp32 streams
    (torch.float32, 2560, 16, 64, "chunk_f32"),        # Hymba's SSM prefill
    (torch.float32, 2048, 32, 32, "chunk_f32"),
    (torch.float32, ops.CHUNK_MIN_SEQ, 32, 64, "chunk_f32"),
    (torch.float32, 100, 4, 8, "chunk_f32"),
    (torch.float32, ops.CHUNK_MIN_SEQ - 1, 16, 64, "step"),
    (torch.float32, 1, 16, 64, "step"),                # Hymba's decode step
    (torch.float32, 2048, 128, 64, "step"),
    (torch.float32, 2048, 64, 128, "step"),
    (torch.bfloat16, 2048, 32, 32, "step"),
    (torch.bfloat16, 2048, 16, 16, "step"),
    (torch.bfloat16, 2048, 64, 128, "step"),
])
def test_route_by_dtype_and_shape(dtype, S, Nk, Nv, want):
    assert ops.route(dtype, S, Nk, Nv) == want


def test_cpu_calls_take_the_plain_version_and_no_route():
    x = _inputs(1, 40, 2, 64, seed=1)
    t = {n: torch.from_numpy(a) for n, a in x.items()}
    ops.reset_launch_counts()
    out, _ = ops.wkv_scan(*(t[n].to(torch.bfloat16) for n in "rkv"), t["w"],
                          t["u"], t["s0"])
    assert out.dtype == torch.bfloat16
    assert ops.PLAIN_CALLS["wkv_scan"] == 1 and ops.LAUNCHES["wkv_scan"] == 0
    assert ops.ROUTE_CALLS == dict.fromkeys(ops.ROUTES, 0)


def test_build_hash_covers_the_chunk_header(tmp_path):
    """Editing csrc/wkv_chunk.cuh, which wkv_scan.cu includes, rebuilds."""
    src = _build.KERNELS_DIR / "rwkv_scan" / "csrc"
    for f in src.iterdir():
        (tmp_path / f.name).write_bytes(f.read_bytes())
    before = _build.source_digest(tmp_path / "wkv_scan.cu")
    assert before == _build.source_digest(src / "wkv_scan.cu")
    header = tmp_path / "wkv_chunk.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    assert _build.source_digest(tmp_path / "wkv_scan.cu") != before
