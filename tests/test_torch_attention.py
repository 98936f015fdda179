"""The port's attention against the JAX package's on the CPU: the flash
attention op (JAX: the Pallas kernel in interpret mode) on the grid of
tests/test_kernels.py, windows, valid lengths, fully masked rows, and the
model's blockwise / dense attention.  Tolerances: fp32 2e-5, bf16 2e-2
(one bf16 rounding of outputs of magnitude ~1).  The CUDA kernel itself is
held against the same plain versions in tests/test_torch_kernels_cuda.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as j_fa_ops
from repro.kernels.flash_attention import ref as j_fa_ref
from repro.models import attention as j_attn
from repro_torch.kernels.flash_attention import ops, ref
from repro_torch.models import attention

DTYPES = {"float32": (torch.float32, jnp.float32, 2e-5),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, 2e-2)}


def _qkv(B, Sq, Sk, H, KV, hd, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, Sq, H, hd)).astype(np.float32),
            rng.normal(size=(B, Sk, KV, hd)).astype(np.float32),
            rng.normal(size=(B, Sk, KV, hd)).astype(np.float32))


def _both(arrays, dtype):
    tdt, jdt, _ = DTYPES[dtype]
    return ([torch.from_numpy(a).to(tdt) for a in arrays],
            [jnp.asarray(a).astype(jdt) for a in arrays])


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _close(a, b, tol):
    np.testing.assert_allclose(_np(a), _np(b), rtol=tol, atol=tol)


@pytest.fixture(autouse=True)
def _no_launch_on_cpu():
    ops.reset_launch_counts()
    yield
    assert ops.LAUNCHES["flash_attention"] == 0


@pytest.mark.parametrize("B,Sq,Sk,H,KV,hd", [
    (2, 128, 128, 4, 4, 64),      # MHA
    (1, 200, 200, 8, 2, 64),      # GQA, ragged seq
    (2, 64, 256, 4, 1, 128),      # MQA, cross-length (decode-ish)
])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("causal", [True, False])
def test_flash_matches_jax(B, Sq, Sk, H, KV, hd, dtype, causal):
    (q, k, v), (jq, jk, jv) = _both(_qkv(B, Sq, Sk, H, KV, hd, Sq + H),
                                    dtype)
    q_off = Sk - Sq if causal else 0
    out = ops.flash_attention(q, k, v, causal=causal, q_offset=q_off)
    want = j_fa_ops.flash_attention(jq, jk, jv, causal=causal,
                                    q_offset=q_off, block_q=64, block_k=64)
    assert out.shape == (B, Sq, H, hd) and out.dtype == q.dtype
    _close(out, want, DTYPES[dtype][2])
    assert ops.PLAIN_CALLS["flash_attention"] == 1


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flash_ref_matches_jax_ref(dtype):
    """The kernel-layout plain version, [BH, G, Sq, hd], against JAX's."""
    rng = np.random.default_rng(7)
    arrays = [rng.normal(size=(4, 3, 40, 32)).astype(np.float32),
              rng.normal(size=(4, 56, 32)).astype(np.float32),
              rng.normal(size=(4, 56, 32)).astype(np.float32)]
    (q, k, v), (jq, jk, jv) = _both(arrays, dtype)
    for kw in ({"causal": True, "q_offset": 16},
               {"causal": False, "kv_valid": 30},
               {"causal": True, "window": 8, "q_offset": 16}):
        _close(ref.flash_attention_ref(q, k, v, **kw),
               j_fa_ref.flash_attention_ref(jq, jk, jv, **kw),
               DTYPES[dtype][2])


def test_flash_window():
    (q, k, v), (jq, jk, jv) = _both(_qkv(1, 160, 160, 4, 2, 64, 4),
                                    "float32")
    out = ops.flash_attention(q, k, v, causal=True, window=32)
    _close(out, j_fa_ops.flash_attention(jq, jk, jv, causal=True, window=32,
                                         block_q=32, block_k=32), 2e-5)


def test_flash_kv_valid():
    """Decode-style masking: only the first kv_valid keys count."""
    (q, k, v), (jq, jk, jv) = _both(_qkv(2, 8, 128, 4, 4, 64, 7), "float32")
    out = ops.flash_attention(q, k, v, causal=False, kv_valid=57)
    _close(out, j_fa_ops.flash_attention(jq, jk, jv, causal=False,
                                         kv_valid=57, block_q=8,
                                         block_k=32), 2e-5)


def test_flash_runtime_positions_and_valid_lengths():
    """Tensor q_positions and a per-batch kv_valid, as the cache passes
    them, against JAX's dense oracle."""
    (q, k, v), (jq, jk, jv) = _both(_qkv(3, 4, 64, 6, 2, 32, 9), "float32")
    pos = np.array([20, 21, 22, 23])
    valid = np.array([24, 30, 64])
    out = ops.flash_attention(q, k, v, causal=True,
                              q_positions=torch.from_numpy(pos),
                              kv_valid=torch.from_numpy(valid))
    want = j_attn.dense_attention(jq, jk, jv, jnp.asarray(pos),
                                  jnp.asarray(valid), causal=True)
    _close(out, want, 2e-5)


def test_flash_fully_masked_rows_get_the_reference_value():
    """Rows with no visible key get uniform weights over all Sk keys, as
    flash_attention_ref gives them."""
    (q, k, v), (jq, jk, jv) = _both(_qkv(1, 6, 40, 2, 1, 16, 11), "float32")
    out = ops.flash_attention(q, k, v, causal=True, q_offset=10, kv_valid=3,
                              window=4)
    qg = jq.reshape(1, 6, 1, 2, 16).transpose(0, 2, 3, 1, 4).reshape(1, 2,
                                                                     6, 16)
    want = j_fa_ref.flash_attention_ref(qg, jk[:, :, 0], jv[:, :, 0],
                                        causal=True, q_offset=10,
                                        kv_valid=3, window=4)
    want = want.reshape(1, 1, 2, 6, 16).transpose(0, 3, 1, 2, 4).reshape(
        1, 6, 2, 16)
    _close(out, want, 2e-5)
    _close(out[0, 0, 0], np.asarray(jv)[0, :, 0].mean(0), 2e-5)


def test_flash_matches_model_attention():
    """The op equals the model's dense oracle (as in test_kernels.py)."""
    (q, k, v), (jq, jk, jv) = _both(_qkv(2, 96, 96, 8, 2, 64, 11),
                                    "float32")
    out = ops.flash_attention(q, k, v, causal=True)
    _close(out, j_attn.dense_attention(jq, jk, jv, jnp.arange(96),
                                       causal=True), 2e-5)


@pytest.mark.parametrize("causal,window,valid,kv_block", [
    (True, None, None, 512), (True, None, 37, 16), (False, None, 50, 32),
    (True, 8, None, 16)])
def test_blockwise_and_dense_attention_match_jax(causal, window, valid,
                                                 kv_block):
    (q, k, v), (jq, jk, jv) = _both(_qkv(2, 12, 56, 8, 2, 16, 13),
                                    "float32")
    pos = np.arange(30, 42) if valid is not None else np.arange(44, 56)
    jvalid = None if valid is None else jnp.asarray(valid)
    got = attention.blockwise_attention(q, k, v, torch.from_numpy(pos),
                                        valid, causal=causal, window=window,
                                        kv_block=kv_block)
    want = j_attn.blockwise_attention(jq, jk, jv, jnp.asarray(pos), jvalid,
                                      causal=causal, window=window,
                                      kv_block=kv_block)
    _close(got, want, 2e-5)
    dense = attention.dense_attention(q, k, v, torch.from_numpy(pos), valid,
                                      causal=causal, window=window)
    _close(dense, j_attn.dense_attention(jq, jk, jv, jnp.asarray(pos),
                                         jvalid, causal=causal,
                                         window=window), 2e-5)
    _close(got, dense, 2e-5)
