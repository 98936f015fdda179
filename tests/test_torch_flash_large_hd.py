"""Flash attention at head dims over 128, on the CPU: the port's
``flash_attention`` (its plain version on CPU tensors) against the JAX
package's ``flash_attention`` op (the Pallas kernel in interpret mode) at
hd 192 and at MLA's absorbed width 576, causal with a valid prefix; the
plain split-kv algorithm at the chunk the fp32 hd-576 kernel takes; and the
wrapper's route and chunk choice: over hd 128 only an aligned bf16 prefill
at hd 576 takes the tensor cores (``tensor_core_wide``,
tests/test_torch_flash_wide.py).  The card runs the large-hd routes
against the plain versions in tests/test_torch_kernels_cuda.py and
chip_smoke.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as j_ops
from repro_torch.kernels.flash_attention import ops, ref

# the tolerance tests/test_kernels.py holds the flash kernel to in fp32
TOL = 2e-5

# (B, Sq, Sk, H, KV, hd, q_offset, kv_valid): a prefill with MLA's heads
# (16 query heads on one latent kv head), a decode step of the same, and
# the non-absorbed MLA width 192 with grouped heads
CASES = {
    "mla_prefill_hd576": (1, 48, 48, 16, 1, 576, 0, 40),
    "mla_decode_hd576": (2, 1, 70, 16, 1, 576, 60, 61),
    "prefill_hd192": (2, 24, 40, 4, 2, 192, 16, 37),
}


def _inputs(B, Sq, Sk, H, KV, hd, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, Sq, H, hd)).astype(np.float32),
            rng.normal(size=(B, Sk, KV, hd)).astype(np.float32),
            rng.normal(size=(B, Sk, KV, hd)).astype(np.float32))


@pytest.fixture
def no_launch():
    ops.reset_launch_counts()
    yield
    assert ops.LAUNCHES["flash_attention"] == 0


@pytest.mark.parametrize("case", list(CASES))
def test_flash_attention_matches_jax_op_at_large_head_dims(no_launch, case):
    B, Sq, Sk, H, KV, hd, q_off, valid = CASES[case]
    q, k, v = _inputs(B, Sq, Sk, H, KV, hd, hd + Sq)
    want = np.asarray(j_ops.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        q_offset=q_off, kv_valid=valid))
    got = ops.flash_attention(*map(torch.from_numpy, (q, k, v)), causal=True,
                              q_offset=q_off, kv_valid=valid)
    assert got.shape == (B, Sq, H, hd) and got.dtype == torch.float32
    assert ops.PLAIN_CALLS["flash_attention"] == 1
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_split_ref_at_the_large_hd_chunk_matches_attention_ref(dtype):
    """The plain split-kv algorithm at the chunk the hd-576 instance of
    ``dtype`` takes (32 keys in fp32, 64 in bf16), with per-batch valid
    lengths, against the one-pass plain version."""
    B, Sk, H, KV, hd = 3, 200, 16, 1, 576
    chunk = ops.split_chunk(dtype, hd)
    assert chunk == (32 if dtype == torch.float32 else 64)
    q, k, v = (torch.from_numpy(x).to(dtype)
               for x in _inputs(B, 1, Sk, H, KV, hd, 11))
    pos = torch.tensor([180])
    valid = torch.tensor([181, 33, 1])
    a = ref.attention_ref(q, k, v, pos, valid, causal=True)
    s = ref.attention_split_ref(q, k, v, pos, valid, causal=True,
                                chunk=chunk)
    tol = TOL if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(s, a, rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [129, 144, 192, 256, 320, 512, 576])
@pytest.mark.parametrize("Sq,H,KV,want", [
    (2048, 16, 1, "mma_tf32"),      # MLA prefill
    (17, 1, 1, "mma_tf32"),         # just above split_kv
    (1, 16, 1, "split_kv"),          # MLA decode: 16 rows per kv head
    (8, 4, 2, "split_kv"),
])
def test_route_above_128_takes_the_wide_tensor_cores_only_at_bf16_576(
        dtype, hd, Sq, H, KV, want):
    """Over hd 128 a prefill takes ``mma_tf32``, except an aligned bf16
    one at MLA's hd 576, which takes ``tensor_core_wide``; decode takes
    ``split_kv``; nothing takes ``tensor_core``."""
    for vec in (True, False):
        wide = (want == "mma_tf32" and dtype == torch.bfloat16
                and hd == ops.WIDE_HEAD_DIM and vec)
        assert ops.route(dtype, Sq, H, KV, hd, vec) == (
            "tensor_core_wide" if wide else want)


@pytest.mark.parametrize("dtype,hd,chunk", [
    (torch.float32, 64, 64), (torch.float32, 128, 64),
    (torch.float32, 256, 64), (torch.float32, 257, 32),
    (torch.float32, 576, 32), (torch.bfloat16, 128, 64),
    (torch.bfloat16, 576, 64)])
def test_split_chunk_follows_the_instance(dtype, hd, chunk):
    assert ops.split_chunk(dtype, hd) == chunk


def test_head_dim_cap_covers_every_config():
    """Every attention width of the JAX package's configs runs on the card:
    head_dim, and MLA's absorbed kv_lora_rank + rope_head_dim."""
    from repro.configs import ARCHS
    widths = set()
    for cfg in ARCHS.values():
        widths.add(cfg.head_dim)
        if getattr(cfg, "mla", None) is not None:
            widths.add(cfg.mla.kv_lora_rank + cfg.mla.rope_head_dim)
            widths.add(cfg.mla.nope_head_dim + cfg.mla.rope_head_dim)
    assert 576 in widths
    assert max(widths) <= ops.MAX_HEAD_DIM
