"""The TF32 tensor-core route of flash attention (``mma_tf32``: the fp32
prefill, and bf16 calls off the wgmma routes) on the CPU: its plain mirror
``ref.attention_mma_ref`` (S and P V on split-TF32 operands, hi = tf32(x)
and lo = tf32(x - hi) rounded to nearest, lo.hi + hi.lo + hi.hi; the base-2
softmax; the reference's masks and its uniform weights for a row that sees
no key) against the JAX package's ``flash_attention`` op (the Pallas kernel
in interpret mode) on the same numpy-seeded fp32 inputs: causal, windowed,
cross (Sq != Sk, positions zero), rows that see no key, per-batch valid
lengths with a batch row at 0; G in {1, 2, 8, 16}, hd in {16, 50, 128, 192,
576}.  Tolerance 2e-5, the card's fp32 gate (phase 5 of chip_smoke.py and
tests/test_torch_kernels_cuda.py's FLASH_TOL); the same mirror with each
operand rounded once to TF32 (``split=False``) misses it, which is why the
kernel splits.  Also the route cases.  The card holds the kernel against
the same mirror in tests/test_torch_flash_mma_cuda.py and chip_smoke.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as j_ops
from repro_torch.kernels.flash_attention import ops, ref

TOL = 2e-5

# (B, Sq, Sk, H, KV, hd, causal, q_offset, kv_valid, window); a tuple of
# valid lengths is one per batch row; Sk <= 128 so that the JAX op pads no
# key (a row that sees no key spreads over every key it holds)
CASES = {
    "causal_g1_hd16": (2, 24, 24, 2, 2, 16, True, 0, None, None),
    "window_g2_hd50": (2, 30, 30, 4, 2, 50, True, 0, None, 7),
    # cross attention: the decoder's 9 queries over 21 encoder keys, no
    # mask (positions zero, as Whisper passes them)
    "cross_g8_hd128": (2, 9, 21, 16, 2, 128, False, 0, None, None),
    # the first six queries sit before every key: uniform weights
    "no_key_rows_g2_hd192": (1, 20, 20, 4, 2, 192, True, -6, None, None),
    # MLA's 16 heads on one latent kv head, a cache's valid prefix per
    # batch row, batch row 2 valid 0 (no row sees a key)
    "per_batch_g16_hd576": (3, 6, 40, 16, 1, 576, True, 34, (40, 17, 0),
                            None),
    "causal_g16_hd576": (1, 12, 12, 16, 1, 576, True, 0, None, None),
    "window_valid_g8_hd128": (2, 16, 48, 8, 1, 128, True, 30, 41, 9),
}


def _inputs(B, Sq, Sk, H, KV, hd, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)   # noqa: E731
    return scale * f(B, Sq, H, hd), scale * f(B, Sk, KV, hd), f(B, Sk, KV, hd)


def _jax_op(q, k, v, causal, q_off, valid, window):
    """The JAX op, one batch row at a time when the valid lengths differ
    (it takes one static valid length)."""
    if not isinstance(valid, tuple):
        return np.asarray(j_ops.flash_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
            window=window, q_offset=q_off, kv_valid=valid))
    return np.concatenate([np.asarray(j_ops.flash_attention(
        jnp.asarray(q[b:b + 1]), jnp.asarray(k[b:b + 1]),
        jnp.asarray(v[b:b + 1]), causal=causal, window=window,
        q_offset=q_off, kv_valid=vb)) for b, vb in enumerate(valid)])


def _mirror(q, k, v, causal, q_off, valid, window, split=True):
    Sq = q.shape[1]
    pos = (torch.zeros(Sq, dtype=torch.int64) if not causal and window is None
           else torch.arange(q_off, q_off + Sq))
    t_valid = torch.tensor(valid) if isinstance(valid, tuple) else valid
    return ref.attention_mma_ref(
        *(torch.from_numpy(x) for x in (q, k, v)), pos, t_valid,
        causal=causal, window=window, split=split)


@pytest.mark.parametrize("case", list(CASES))
def test_mma_mirror_matches_jax_op(case):
    B, Sq, Sk, H, KV, hd, causal, q_off, valid, window = CASES[case]
    q, k, v = _inputs(B, Sq, Sk, H, KV, hd, seed=Sq * H + hd)
    got = _mirror(q, k, v, causal, q_off, valid, window)
    assert got.shape == (B, Sq, H, hd) and got.dtype == torch.float32
    want = _jax_op(q, k, v, causal, q_off, valid, window)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_one_tf32_rounding_misses_the_tolerance():
    """With each operand rounded once to TF32 (10 mantissa bits, 2^-11
    relative) the output leaves 2e-5 of the JAX op's; split, the same case
    keeps it.  Logits of a few units (q and k scaled by 2)."""
    q, k, v = _inputs(2, 24, 24, 12, 2, 128, seed=3, scale=2.0)
    want = _jax_op(q, k, v, True, 0, None, None)
    split = _mirror(q, k, v, True, 0, None, None).numpy()
    single = _mirror(q, k, v, True, 0, None, None, split=False).numpy()
    assert np.abs(split - want).max() < TOL
    assert np.abs(single - want).max() > TOL


@pytest.mark.parametrize("dtype,tol", [(torch.float32, TOL),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("causal", [True, False])
def test_mma_mirror_at_runtime_positions(dtype, tol, causal):
    """Positions out of order and repeated, per-batch valid lengths and a
    window (a runtime tensor, which the JAX op does not take), against the
    port's plain version; bf16 inputs enter the products unsplit (exact in
    TF32)."""
    rng = np.random.default_rng(11 + causal)
    q, k, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(
        dtype) for s in ((2, 6, 8, 50), (2, 90, 2, 50), (2, 90, 2, 50)))
    pos = torch.tensor([60, 3, 89, 40, 40, 0])
    valid = torch.tensor([90, 45])
    for window in (None, 20):
        got = ref.attention_mma_ref(q, k, v, pos, valid, causal=causal,
                                    window=window)
        want = ref.attention_ref(q, k, v, pos, valid, causal=causal,
                                 window=window)
        assert got.dtype == dtype
        torch.testing.assert_close(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype,Sq,H,KV,hd,vec,window,want", [
    (torch.float32, 2048, 12, 2, 128, True, None, "mma_tf32"),
    (torch.float32, 2048, 16, 1, 576, True, None, "mma_tf32"),
    (torch.float32, 256, 16, 2, 128, True, None, "mma_tf32"),
    (torch.float32, 17, 1, 1, 16, False, 4, "mma_tf32"),
    (torch.bfloat16, 64, 4, 2, 40, True, None, "mma_tf32"),
    (torch.bfloat16, 64, 4, 2, 64, False, None, "mma_tf32"),
    (torch.bfloat16, 100, 8, 2, 192, True, None, "mma_tf32"),
    (torch.bfloat16, 2048, 16, 1, 576, True, 1024, "mma_tf32"),
    (torch.bfloat16, 2048, 16, 1, 576, True, None, "tensor_core_wide"),
    (torch.bfloat16, 2048, 12, 2, 128, True, None, "tensor_core"),
    (torch.float32, 1, 16, 1, 576, True, None, "split_kv"),
    (torch.float32, 8, 4, 2, 64, True, None, "split_kv"),
])
def test_route_of_the_mma_route(dtype, Sq, H, KV, hd, vec, window, want):
    assert ops.route(dtype, Sq, H, KV, hd, vec, window) == want


def test_routes_name_mma_tf32_and_count_it():
    assert ops.ROUTES == ("tensor_core", "tensor_core_wide", "split_kv",
                          "mma_tf32")
    assert set(ops.ROUTE_CALLS) == set(ops.ROUTES)
