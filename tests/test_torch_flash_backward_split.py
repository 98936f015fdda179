"""The precision argument of the flash attention backward kernel, on the
CPU: ``ref.attention_backward_split_ref`` computes dQ, dK and dV with every
product's fp32 operands split into TF32 parts (hi = tf32(x), lo =
tf32(x - hi), both rounded to nearest, lo.hi + hi.lo + hi.hi) as the
kernel's ``mma.sync`` products take them, and it is held
against ``jax.grad`` of the JAX package's ``blockwise_attention`` (the
function the port's attention differentiates) on the same numpy-seeded
fp32 inputs: causal, windowed, cross (Sq != Sk), rows that see no key, G
in {1, 2, 6}, hd in {16, 50, 128, 576}.

Tolerance: each gradient within 1e-4 of its largest |entry| (the card's
gate for the fp32 kernel, tests/test_torch_flash_backward_cuda.py); the
split mirror stays near 1e-6.  The same mirror with each operand rounded
once to TF32 (``split=False``) misses 1e-4: that is why the kernel
splits.
The card side is tests/test_torch_flash_backward_cuda.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.attention import blockwise_attention
from repro_torch.kernels.flash_attention import backward, ref

TOL = 1e-4

# (B, Sq, Sk, H, KV, hd, causal, window, positions)
CASES = {
    "causal_g6_hd128": (2, 24, 24, 12, 2, 128, True, None, "arange"),
    "window_g2_hd50": (2, 30, 30, 4, 2, 50, True, 7, "arange"),
    "cross_g1_hd16": (2, 9, 21, 3, 3, 16, False, None, "zeros"),
    "no_key_rows_g2_hd16": (1, 20, 20, 4, 2, 16, True, 5, "shifted"),
    "mla_g6_hd576": (1, 12, 12, 6, 1, 576, True, None, "arange"),
}


def _inputs(B, Sq, Sk, H, KV, hd, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)   # noqa: E731
    return (scale * f(B, Sq, H, hd), scale * f(B, Sk, KV, hd),
            f(B, Sk, KV, hd), f(B, Sq, H, hd))


def _positions(kind, Sq):
    if kind == "zeros":                  # Whisper's cross attention
        return np.zeros(Sq, np.int32)
    if kind == "shifted":                # the first queries see no key
        return np.arange(Sq, dtype=np.int32) - 6
    return np.arange(Sq, dtype=np.int32)


def _jax_grads(q, k, v, dout, pos, causal, window):
    """jax.grad of blockwise attention (one kv block of Sk keys, so a row
    that sees no key spreads its weight over the Sk keys, as the port's
    kernels do) against the cotangent ``dout``."""
    Sk = k.shape[1]

    def f(q, k, v):
        out = blockwise_attention(q, k, v, jnp.asarray(pos), causal=causal,
                                  window=window, kv_block=Sk)
        return jnp.sum(out * dout)
    return [np.asarray(g) for g in jax.grad(f, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))]


def _errs(q, k, v, dout, pos, causal, window, split):
    want = _jax_grads(q, k, v, dout, pos, causal, window)
    got = ref.attention_backward_split_ref(
        *(torch.from_numpy(x) for x in (q, k, v, dout)),
        torch.from_numpy(pos).long(), causal=causal, window=window,
        split=split)
    return [float(np.abs(g.numpy() - w).max() / np.abs(w).max())
            for g, w in zip(got, want)]


@pytest.mark.parametrize("name", list(CASES))
def test_split_mirror_matches_jax_grad(name):
    B, Sq, Sk, H, KV, hd, causal, window, kind = CASES[name]
    q, k, v, dout = _inputs(B, Sq, Sk, H, KV, hd, seed=len(name))
    errs = _errs(q, k, v, dout, _positions(kind, Sq), causal, window, True)
    assert max(errs) < TOL, errs


def test_one_tf32_rounding_misses_the_tolerance():
    """With each operand rounded once to TF32 (10 mantissa bits, 2^-11
    relative) the gradients leave 1e-4 of their largest entry; split, the
    same case keeps it.  Logits of a few units (q and k scaled by 2)."""
    q, k, v, dout = _inputs(2, 24, 24, 12, 2, 128, seed=3, scale=2.0)
    pos = _positions("arange", 24)
    split = _errs(q, k, v, dout, pos, True, None, True)
    single = _errs(q, k, v, dout, pos, True, None, False)
    assert max(split) < TOL, split
    assert max(single) > TOL, single


def test_tf32_round_keeps_ten_mantissa_bits():
    """Round to nearest, ties away from zero, on the 13 dropped bits: the
    rounding the kernel's operands get (one integer add and a mask).  Two
    parts, hi and the rounded rest, hold x to 2^-22 of |x|."""
    x = torch.tensor([1.0 + 2 ** -11, 1.0 + 2 ** -12, -(1.0 + 3 * 2 ** -11),
                      3.0, 1.0 + 2 ** -10], dtype=torch.float32)
    want = torch.tensor([1.0 + 2 ** -10, 1.0, -(1.0 + 2 * 2 ** -10), 3.0,
                         1.0 + 2 ** -10])
    assert torch.equal(ref.tf32_round(x), want)
    y = torch.from_numpy(np.random.default_rng(0).normal(
        size=4096).astype(np.float32))
    hi = ref.tf32_round(y)
    lo = ref.tf32_round(y - hi)
    assert float(((y - hi - lo).abs() / y.abs()).max()) <= 2.0 ** -22


def test_split_mirror_equals_autograd_through_the_plain_version():
    """The mirror and ``attention_backward_ref`` (autograd through the plain
    forward, what the card holds the kernel against) agree in fp32."""
    q, k, v, dout = (torch.from_numpy(x) for x in _inputs(
        2, 17, 17, 6, 3, 32, seed=11))
    pos = torch.arange(17) - 3
    got = ref.attention_backward_split_ref(q, k, v, dout, pos, window=9)
    want = ref.attention_backward_ref(q, k, v, dout, pos, window=9)
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert float((a - b).abs().max() / b.abs().max()) < TOL


@pytest.mark.parametrize("dtype,want", [(torch.float32, "tf32x3"),
                                        (torch.bfloat16, "tf32")])
def test_route_by_dtype(dtype, want):
    assert backward.route(dtype) == want


@pytest.mark.parametrize("hd,aligned", [(64, True), (50, False)])
def test_rows_aligned_on_views_of_a_packed_projection(hd, aligned):
    """q as a view of a packed [B, S, (H + 2 KV) hd] projection: 16-byte
    rows (cp.async staging) at hd 64 in fp32, not at hd 50; a dim of size 1
    adds no offset."""
    qkv = torch.zeros(2, 5, 10 * hd)
    q = qkv[..., :6 * hd].view(2, 5, 6, hd)
    assert backward.rows_aligned(q) is aligned
    assert backward.rows_aligned(torch.zeros(1, 1, 1, 4)[..., :4])
