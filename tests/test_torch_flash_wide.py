"""The wide tensor-core route of flash attention (bf16 prefill at MLA's
absorbed width, hd 576) on the CPU: its plain mirror
(``ref.attention_wide_ref``: the kernel's 64-row blocks of folded
(position, head) rows, its key tiles in its order, the base-2 online
softmax and P as two bf16 parts) against the JAX package's
``flash_attention`` op (the Pallas kernel in interpret mode), at 16 query
heads on one kv head and at blocks that cut a position's heads apart, with
v that is k (64-key tiles) and v that differs (32-key tiles), int and
per-batch valid lengths and a batch row that sees no key; the route choice
and the key tile; and MLA's attention layer at width 576 through the
route's mirror against the JAX layer.  The card holds the kernel against
the same mirror in tests/test_torch_flash_wide_cuda.py and chip_smoke.py.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.kernels.flash_attention import ops as j_ops
from repro.models import mla as j_mla
from repro_torch.configs import get_arch
from repro_torch.kernels.flash_attention import ops, ref
from repro_torch.models import mla

# phase 5's bf16 tolerance against the fp32 reference
TOL = 2e-2
HD = 576

# (B, Sq, Sk, H, KV, q_offset, kv_valid); a tuple of valid lengths is one
# per batch row
CASES = {
    # 17 rows (one head): one block, keys over two 64-key (three 32-key)
    # tiles
    "rows17": (1, 17, 90, 1, 1, 60, None),
    # MLA's heads: 4 positions x 16 heads fill one block; a cache's valid
    # prefix, keys over four 64-key tiles
    "rows64": (2, 4, 200, 16, 1, 150, 154),
    # 5 heads: the second block starts inside position 12's heads
    "rows65": (1, 13, 160, 5, 1, 100, None),
    # a cache-less prefill (Sk = S) of three blocks, the last of one row
    "rows129": (2, 129, 129, 1, 1, 0, None),
    # per-batch valid lengths; batch row 2 sees no key (uniform weights
    # over all its 128 keys, which the JAX op does not pad)
    "per_batch": (3, 8, 128, 16, 1, 120, (128, 61, 0)),
}


def _bf16(shape, rng):
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(
        torch.bfloat16)


def _inputs(case, shared, seed):
    B, Sq, Sk, H, KV, _, _ = CASES[case]
    rng = np.random.default_rng(seed)
    q = _bf16((B, Sq, H, HD), rng)
    k = _bf16((B, Sk, KV, HD), rng)
    v = k if shared else _bf16((B, Sk, KV, HD), rng)
    return q, k, v


def _jax(x):
    return jnp.asarray(x.float().numpy(), dtype=jnp.bfloat16)


def _jax_op(q, k, v, q_off, valid):
    """The JAX op, one batch row at a time when the valid lengths differ
    (it takes one static valid length)."""
    if not isinstance(valid, tuple):
        out = j_ops.flash_attention(_jax(q), _jax(k), _jax(v), causal=True,
                                    q_offset=q_off, kv_valid=valid)
        return np.asarray(out.astype(jnp.float32))
    return np.concatenate([np.asarray(j_ops.flash_attention(
        _jax(q[b:b + 1]), _jax(k[b:b + 1]), _jax(v[b:b + 1]), causal=True,
        q_offset=q_off, kv_valid=vb).astype(jnp.float32))
        for b, vb in enumerate(valid)])


@pytest.mark.parametrize("shared", [True, False], ids=["v_is_k", "v_differs"])
@pytest.mark.parametrize("case", list(CASES))
def test_wide_mirror_matches_jax_op(case, shared):
    B, Sq, Sk, H, KV, q_off, valid = CASES[case]
    q, k, v = _inputs(case, shared, seed=Sq * H + Sk)
    tile = ops.wide_key_tile(k, v)
    assert tile == (64 if shared else 32)
    pos = torch.arange(q_off, q_off + Sq)
    t_valid = torch.tensor(valid) if isinstance(valid, tuple) else valid
    got = ref.attention_wide_ref(q, k, v, pos, t_valid, causal=True,
                                 key_tile=tile)
    assert got.shape == (B, Sq, H, HD) and got.dtype == torch.bfloat16
    want = _jax_op(q, k, v, q_off, valid)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=TOL, atol=TOL)
    # and the port's own plain version of the function
    plain = ref.attention_ref(q, k, v, pos, t_valid, causal=True)
    torch.testing.assert_close(got, plain, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("tile", [32, 64])
def test_wide_mirror_at_runtime_positions(causal, tile):
    """Positions out of order and repeated (a runtime tensor, which the
    JAX op does not take), against the port's plain version."""
    rng = np.random.default_rng(tile + causal)
    q, k, v = (_bf16(s, rng) for s in ((2, 6, 16, HD), (2, 150, 1, HD),
                                       (2, 150, 1, HD)))
    pos = torch.tensor([90, 3, 140, 40, 40, 0])
    valid = torch.tensor([150, 70])
    got = ref.attention_wide_ref(q, k, v, pos, valid, causal=causal,
                                 key_tile=tile)
    want = ref.attention_ref(q, k, v, pos, valid, causal=causal)
    torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("dtype,Sq,H,KV,hd,vec,window,want", [
    (torch.bfloat16, 2048, 16, 1, 576, True, None, "tensor_core_wide"),
    (torch.bfloat16, 17, 1, 1, 576, True, None, "tensor_core_wide"),
    (torch.bfloat16, 2, 16, 1, 576, True, None, "tensor_core_wide"),
    (torch.float32, 2048, 16, 1, 576, True, None, "mma_tf32"),
    (torch.bfloat16, 2048, 16, 1, 576, False, None, "mma_tf32"),
    (torch.bfloat16, 2048, 16, 1, 192, True, None, "mma_tf32"),
    (torch.bfloat16, 2048, 16, 1, 560, True, None, "mma_tf32"),
    (torch.bfloat16, 2048, 16, 1, 576, True, 1024, "mma_tf32"),
    (torch.bfloat16, 2048, 12, 2, 128, True, 1024, "tensor_core"),
    (torch.bfloat16, 1, 16, 1, 576, True, None, "split_kv"),
    (torch.float32, 1, 16, 1, 576, True, None, "split_kv"),
    (torch.bfloat16, 16, 1, 1, 576, True, None, "split_kv"),
])
def test_route_of_the_wide_route(dtype, Sq, H, KV, hd, vec, window, want):
    assert ops.route(dtype, Sq, H, KV, hd, vec, window) == want


def test_wide_key_tile_follows_the_storage():
    """64-key tiles when v is k: the same tensor, or two views of MLA's
    latent cache with the same strides; 32 otherwise."""
    latent = torch.zeros(2, 40, HD)
    kv = latent[:, :, None, :]
    assert ops.wide_key_tile(kv, kv) == 64
    assert ops.wide_key_tile(kv, latent[:, :, None, :]) == 64
    assert ops.wide_key_tile(kv, kv.clone()) == 32
    assert ops.wide_key_tile(latent[:, ::2, None, :],
                             latent[:, :20, None, :]) == 32


@pytest.fixture
def wide_layer():
    """deepseek-v2-lite-16b's ``reduced()`` MLA at its full absorbed width
    (kv_lora_rank 512 + rope_head_dim 64 = 576), bf16 weights from one
    seeded numpy draw for both packages."""
    cfg, jcfg = get_arch("deepseek-v2-lite-16b").reduced(), \
        J_ARCHS["deepseek-v2-lite-16b"].reduced()
    cfg = dataclasses.replace(cfg, mla=dataclasses.replace(
        cfg.mla, kv_lora_rank=512, rope_head_dim=64))
    jcfg = dataclasses.replace(jcfg, mla=dataclasses.replace(
        jcfg.mla, kv_lora_rank=512, rope_head_dim=64))
    jp = j_mla.init_mla_params(jax.random.PRNGKey(0), jcfg, jnp.float32)
    rng = np.random.default_rng(5)
    jp = {k: (np.asarray(v) + 0.05 * rng.normal(size=v.shape)).astype(
        np.float32) for k, v in jp.items()}
    tp = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in jp.items()}
    jp = {k: jnp.asarray(v, jnp.bfloat16) for k, v in jp.items()}
    return cfg, jcfg, jp, tp


def test_mla_attention_through_the_wide_mirror_matches_jax(wide_layer,
                                                           monkeypatch):
    """The MLA slice: ``mla_attention`` in bf16 at width 576 with its flash
    call taken as the card takes it (the route, then the route's plain
    mirror at the key tile of the tensors MLA passes) against the JAX
    layer, without a cache and with one (a prefill into a longer cache)."""
    cfg, jcfg, jp, tp = wide_layer
    seen = []

    def card_like(q, k, v, q_positions, kv_valid_len=None, *, causal=True,
                  window=None, kv_block=512, unroll=False):
        B, Sq, H, hd = q.shape
        seen.append((ops.route(q.dtype, Sq, H, k.shape[2], hd, True,
                               window), ops.wide_key_tile(k, v)))
        return ref.attention_wide_ref(q, k, v, q_positions, kv_valid_len,
                                      causal=causal,
                                      key_tile=ops.wide_key_tile(k, v))

    monkeypatch.setattr(mla, "blockwise_attention", card_like)
    B, S, max_seq = 2, 24, 40
    x = np.random.default_rng(6).normal(size=(B, S, cfg.d_model)).astype(
        np.float32)
    tx, jx = torch.from_numpy(x).to(torch.bfloat16), jnp.asarray(
        x, jnp.bfloat16)
    pos = np.arange(S)
    got, _ = mla.mla_attention(tp, cfg, tx, torch.from_numpy(pos))
    want, _ = j_mla.mla_attention(jp, jcfg, jx, pos)
    cache = mla.init_mla_cache(cfg, B, max_seq, torch.bfloat16, "cpu")
    jcache = j_mla.init_mla_cache(jcfg, B, max_seq, jnp.bfloat16)
    got_c, cache = mla.mla_attention(tp, cfg, tx, torch.from_numpy(pos),
                                     cache=cache, cache_index=0)
    want_c, _ = j_mla.mla_attention(jp, jcfg, jx, pos, cache=jcache,
                                    cache_index=0)
    assert seen == [("tensor_core_wide", 64)] * 2
    for g, w in ((got, want), (got_c, want_c)):
        w = np.asarray(w.astype(jnp.float32))
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(g.float().numpy(), w, rtol=0,
                                   atol=TOL * scale)
