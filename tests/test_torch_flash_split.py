"""The plain split-kv algorithm (``attention_split_ref``: per-chunk
partials, then a merge in chunk order) against the JAX package's
``flash_attention_ref`` on the CPU, in fp32 at 1e-5: several chunk sizes,
chunks wholly past ``kv_valid``, windowed rows and fully masked rows.  The
card holds the split-kv decode kernel against the same function
(tests/test_torch_kernels_cuda.py, chip_smoke.py).  Also the wrapper's
route choice, a plain function of dtype and shape, the packed argument
block of the split-kv entry point, and the build hash that covers every
file a kernel source can include."""
import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ref as j_ref
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import ops, ref

TOL = 1e-5

# (B, Sq, Sk, H, KV, hd, causal, q_offset, kv_valid, window)
CASES = {
    # one decode step; every chunk past key 100 lies wholly past kv_valid
    "decode_past_valid": (2, 1, 300, 6, 2, 32, True, 99, 100, None),
    # a few queries under a window: rows see only their last 40 keys
    "windowed": (2, 4, 200, 4, 2, 16, True, 150, None, 40),
    # every row sees no key: uniform weights over all Sk keys
    "all_masked": (1, 3, 128, 4, 1, 16, True, 80, 50, 8),
    # rows 40 and 41 see keys 37..41, the rest (positions >= 46) none
    "some_masked": (2, 8, 96, 2, 1, 16, True, 40, 42, 4),
    # no causal mask, a valid prefix
    "non_causal_valid": (2, 2, 150, 4, 4, 32, False, 0, 70, None),
}


def _inputs(B, Sq, Sk, H, KV, hd, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, Sq, H, hd)).astype(np.float32),
            rng.normal(size=(B, Sk, KV, hd)).astype(np.float32),
            rng.normal(size=(B, Sk, KV, hd)).astype(np.float32))


def _jax_model_layout(q, k, v, **kw):
    """JAX's kernel-layout oracle ([B*KV, G, Sq, hd]) in model layout."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    jq = q.reshape(B, Sq, KV, G, hd).transpose(0, 2, 3, 1, 4)
    jk, jv = (x.transpose(0, 2, 1, 3).reshape(B * KV, Sk, hd)
              for x in (k, v))
    out = j_ref.flash_attention_ref(jnp.asarray(jq.reshape(B * KV, G, Sq,
                                                           hd)),
                                    jnp.asarray(jk), jnp.asarray(jv), **kw)
    out = np.asarray(out).reshape(B, KV, G, Sq, hd).transpose(0, 3, 1, 2, 4)
    return out.reshape(B, Sq, H, hd)


@pytest.mark.parametrize("chunk", [8, 32, ops.SPLIT_CHUNK, 128])
@pytest.mark.parametrize("case", list(CASES))
def test_split_ref_matches_jax_ref(case, chunk):
    B, Sq, Sk, H, KV, hd, causal, q_off, valid, window = CASES[case]
    q, k, v = _inputs(B, Sq, Sk, H, KV, hd, len(case) + chunk)
    want = _jax_model_layout(q, k, v, causal=causal, window=window,
                             q_offset=q_off, kv_valid=valid)
    pos = torch.arange(q_off, q_off + Sq)
    got = ref.attention_split_ref(*map(torch.from_numpy, (q, k, v)), pos,
                                  valid, causal=causal, window=window,
                                  chunk=chunk)
    assert got.shape == (B, Sq, H, hd) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("chunk", [16, 64])
def test_split_ref_per_batch_valid_matches_jax_ref(chunk):
    """A [B] tensor of valid lengths: batch row b against JAX's oracle with
    kv_valid = valid[b]; row 0 sees no key under its window."""
    B, Sq, Sk, H, KV, hd = 3, 2, 160, 4, 2, 16
    q, k, v = _inputs(B, Sq, Sk, H, KV, hd, chunk)
    valid, q_off, window = [20, 100, 160], 98, 30
    got = ref.attention_split_ref(*map(torch.from_numpy, (q, k, v)),
                                  torch.arange(q_off, q_off + Sq),
                                  torch.tensor(valid), causal=True,
                                  window=window, chunk=chunk).numpy()
    for b in range(B):
        want = _jax_model_layout(q[b:b + 1], k[b:b + 1], v[b:b + 1],
                                 causal=True, window=window, q_offset=q_off,
                                 kv_valid=valid[b])
        np.testing.assert_allclose(got[b:b + 1], want, rtol=TOL, atol=TOL)


def test_split_ref_matches_attention_ref_in_bf16():
    """In bf16 both plain versions compute in fp32 and round once."""
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16)
               for x in _inputs(2, 1, 700, 12, 2, 64, 3))
    pos = torch.tensor([499])
    a = ref.attention_ref(q, k, v, pos, 500, causal=True)
    s = ref.attention_split_ref(q, k, v, pos, 500, causal=True, chunk=128)
    torch.testing.assert_close(s, a, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("dtype,Sq,H,KV,hd,vec,want", [
    (torch.bfloat16, 2048, 12, 2, 128, True, "tensor_core"),
    (torch.float32, 2048, 12, 2, 128, True, "mma_tf32"),
    (torch.bfloat16, 1, 12, 2, 128, True, "split_kv"),
    (torch.float32, 1, 12, 2, 128, True, "split_kv"),
    (torch.bfloat16, 8, 4, 2, 64, True, "split_kv"),       # 16 rows
    (torch.bfloat16, 17, 2, 2, 64, True, "tensor_core"),   # 17 rows
    (torch.bfloat16, 64, 4, 2, 40, True, "mma_tf32"),     # hd % 16
    (torch.bfloat16, 64, 4, 2, 64, False, "mma_tf32"),    # unaligned
    (torch.bfloat16, 2, 12, 2, 20, False, "split_kv"),     # 12 rows
])
def test_route_by_dtype_and_shape(dtype, Sq, H, KV, hd, vec, want):
    assert ops.route(dtype, Sq, H, KV, hd, vec) == want


def test_packed_args_follow_the_c_layout():
    """The packed ``Args`` that every entry point takes:
    every field at the offset the C ABI gives it (ctypes lays a Structure
    out by that ABI; on the card the library's own offsetof values are
    checked at load)."""
    ctype = {"P": ctypes.c_void_p, "i": ctypes.c_int, "q": ctypes.c_int64,
             "f": ctypes.c_float}

    class Args(ctypes.Structure):
        _fields_ = [(f"f{i}", ctype[c]) for i, c in enumerate(ops.ARGS_CODES)]

    want = [getattr(Args, f"f{i}").offset
            for i in range(len(ops.ARGS_CODES))]
    assert ops.args_offsets() == want
    assert len(want) == 30 and ops._ARGS.size <= ctypes.sizeof(Args)


def test_build_hash_covers_headers(tmp_path):
    """An edit to a header beside the source changes the library's hash, so
    a stale library is never loaded."""
    src = tmp_path / "k.cu"
    src.write_text('#include "k.cuh"\n')
    header = tmp_path / "k.cuh"
    header.write_text("// v1\n")
    first = _build.source_digest(src)
    assert _build.source_digest(src) == first
    header.write_text("// v2\n")
    assert _build.source_digest(src) != first
    src.write_text('#include "k.cuh"\n// edit\n')
    assert len({first, _build.source_digest(src)}) == 2
