"""The port's MLA attention (``repro_torch/models/mla.py``) against the JAX
package's on the CPU, float32, at deepseek-v2-lite-16b's ``reduced()``
config, from the same seeded numpy weights and inputs: the projections,
``mla_attention`` without a cache and with one (a prefill, then decode
steps; outputs and the cached c_kv / k_rope within 1e-5), through the
plain attention path.  Also the cache layout (one latent tensor whose
views are c_kv and k_rope), the bf16 rounding of the absorbed scale, and
the flash routes the full-width config takes on the card."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.models import mla as j_mla
from repro_torch.configs import ARCHS, get_arch
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models import mla

NAME = "deepseek-v2-lite-16b"
TOL = 1e-5


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(_np(a), _np(b), rtol=tol, atol=tol)


@pytest.fixture(scope="module")
def layer():
    """(port cfg, JAX cfg, JAX params as numpy, port params); every leaf
    perturbed so the norm weight is not all ones."""
    cfg, jcfg = get_arch(NAME).reduced(), J_ARCHS[NAME].reduced()
    jp = j_mla.init_mla_params(jax.random.PRNGKey(0), jcfg, jnp.float32)
    rng = np.random.default_rng(0)
    jp = {k: np.asarray(v) + 0.05 * rng.normal(size=v.shape).astype(
        np.float32) for k, v in jp.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in jp.items()}
    return cfg, jcfg, jp, tp


def _x(cfg, B, S, seed):
    return np.random.default_rng(seed).normal(
        size=(B, S, cfg.d_model)).astype(np.float32)


def test_init_mla_params_shapes_match_jax(layer):
    cfg, _, jp, _ = layer
    mine = mla.init_mla_params(torch.Generator().manual_seed(0), cfg,
                               torch.float32, "cpu")
    assert {k: tuple(v.shape) for k, v in mine.items()} == \
        {k: v.shape for k, v in jp.items()}
    assert torch.equal(mine["kv_norm"], torch.ones(cfg.mla.kv_lora_rank))


def test_projections_match_jax(layer):
    cfg, jcfg, jp, tp = layer
    x, pos = _x(cfg, 2, 9, seed=1), np.arange(3, 12)
    tx, tpos = torch.from_numpy(x), torch.from_numpy(pos)
    for mine, theirs in zip(mla._project_q(tp, cfg, tx, tpos),
                            j_mla._project_q(jp, jcfg, x, pos)):
        _close(mine, theirs)
    c_kv, k_rope = mla._project_kv_latent(tp, cfg, tx, tpos)
    jc, jk = j_mla._project_kv_latent(jp, jcfg, x, pos)
    assert tuple(k_rope.shape) == jk.shape == (2, 9, 1, 8)
    _close(c_kv, jc)
    _close(k_rope, jk)


def test_mla_attention_without_cache_matches_jax(layer):
    cfg, jcfg, jp, tp = layer
    x = _x(cfg, 2, 11, seed=2)
    pos = np.arange(11)
    fa_ops.reset_launch_counts()
    out, cache = mla.mla_attention(tp, cfg, torch.from_numpy(x),
                                   torch.from_numpy(pos))
    jout, _ = j_mla.mla_attention(jp, jcfg, x, pos)
    assert cache is None and tuple(out.shape) == (2, 11, cfg.d_model)
    _close(out, jout)
    # one attention call, on the plain path (a CPU tensor)
    assert fa_ops.PLAIN_CALLS["flash_attention"] == 1
    assert fa_ops.LAUNCHES["flash_attention"] == 0


def test_mla_attention_with_cache_matches_jax(layer):
    cfg, jcfg, jp, tp = layer
    B, S, n_dec, max_seq = 2, 7, 3, 16
    x = _x(cfg, B, S + n_dec, seed=3)
    cache = mla.init_mla_cache(cfg, B, max_seq, torch.float32, "cpu")
    jcache = j_mla.init_mla_cache(jcfg, B, max_seq, jnp.float32)
    steps = [(0, S)] + [(S + i, 1) for i in range(n_dec)]
    for start, n in steps:
        pos = np.arange(start, start + n)
        out, cache = mla.mla_attention(
            tp, cfg, torch.from_numpy(x[:, start:start + n]),
            torch.from_numpy(pos), cache=cache, cache_index=start)
        jout, jcache = j_mla.mla_attention(
            jp, jcfg, x[:, start:start + n], pos, cache=jcache,
            cache_index=jnp.asarray(start, jnp.int32))
        _close(out, jout)
        _close(cache["c_kv"], jcache["c_kv"])
        _close(cache["k_rope"], jcache["k_rope"])


def test_mla_cache_is_one_latent_tensor():
    cfg = get_arch(NAME).reduced()
    cache = mla.init_mla_cache(cfg, 3, 10, torch.bfloat16, "cpu")
    R, rope = cfg.mla.kv_lora_rank, cfg.mla.rope_head_dim
    assert tuple(cache["latent"].shape) == (3, 10, R + rope)
    assert tuple(cache["c_kv"].shape) == (3, 10, R)
    assert tuple(cache["k_rope"].shape) == (3, 10, rope)
    cache["c_kv"][1, 2] = 1.0
    cache["k_rope"][1, 2] = 2.0
    assert cache["latent"][1, 2, :R].eq(1).all()
    assert cache["latent"][1, 2, R:].eq(2).all()
    assert cache["latent"].dtype == torch.bfloat16
    full = ARCHS[NAME]
    assert mla.mla_cache_bytes_per_token(full) == \
        j_mla.mla_cache_bytes_per_token(J_ARCHS[NAME]) == 576 * 2


def test_absorbed_scale_rounds_in_the_model_dtype():
    """q_full * scale_fix: the factor (sqrt 3 at deepseek-v2-lite) is
    rounded to bf16 before the product, as JAX rounds a weakly typed
    Python scalar, so the bf16 queries the kernel sees are JAX's."""
    m = ARCHS[NAME].mla
    scale_fix = ((m.nope_head_dim + m.rope_head_dim) ** -0.5
                 / ((m.kv_lora_rank + m.rope_head_dim) ** -0.5))
    q = np.random.default_rng(4).normal(size=(4096,)).astype(np.float32)
    jq = np.asarray((jnp.asarray(q, jnp.bfloat16) * scale_fix).astype(
        jnp.float32))
    tq = torch.from_numpy(q).to(torch.bfloat16) * torch.tensor(
        scale_fix, dtype=torch.bfloat16)
    np.testing.assert_array_equal(tq.float().numpy(), jq)


def test_full_width_attention_takes_the_hd576_flash_routes():
    """deepseek-v2-lite's absorbed attention is one kv head of width
    kv_lora_rank + rope_head_dim = 576 shared by 16 query heads: at 8 x
    2048 bf16 it routes to ``tensor_core_wide`` (the wide tensor-core
    prefill), one decode step of 8 slots to ``split_kv``."""
    cfg = ARCHS[NAME]
    hd = cfg.mla.kv_lora_rank + cfg.mla.rope_head_dim
    assert hd == 576 == fa_ops.WIDE_HEAD_DIM <= fa_ops.MAX_HEAD_DIM
    assert fa_ops.route(torch.bfloat16, 2048, cfg.n_heads, 1, hd,
                        True) == "tensor_core_wide"
    assert fa_ops.route(torch.bfloat16, 1, cfg.n_heads, 1, hd,
                        True) == "split_kv"
