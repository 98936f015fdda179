"""LLaVA's patch prefix in the port against the JAX package on the CPU:
the reduced llava-next-34b model's ``forward``, ``prefill`` (prefix then
tokens, positions counting the prefix) and ``decode_step`` from the same
weights and the same numpy patch embeddings within 1e-4 (XLA and ATen sum
in different orders), greedy ``generate`` with the prefix equal to the
JAX engine's (the first decode position is L + n_front), and the
vision-patch stub."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.models import lm as j_lm
from repro.serve import engine as j_engine
from repro_torch.configs import get_arch
from repro_torch.models import frontends, lm
from repro_torch.models.convert import params_from_jax
from repro_torch.serve import engine

NAME = "llava-next-34b"
TOL = 1e-4


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(_np(a), _np(b), rtol=tol, atol=tol)


@pytest.fixture(scope="module")
def model():
    cfg, jcfg = get_arch(NAME).reduced(), J_ARCHS[NAME].reduced()
    params = j_lm.init_params(jax.random.PRNGKey(0), jcfg, jnp.float32)
    leaves, tree = jax.tree.flatten(params)
    rng = np.random.default_rng(0)
    leaves = [np.asarray(x) + 0.05 * rng.normal(size=x.shape).astype(
        np.float32) for x in leaves]
    jparams = jax.tree.unflatten(tree, leaves)
    return cfg, jcfg, jparams, params_from_jax(jparams, cfg, device="cpu")


def _patches(cfg, B, seed=1):
    return (0.02 * np.random.default_rng(seed).normal(
        size=(B, cfg.n_frontend_tokens, cfg.d_model))).astype(np.float32)


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def test_forward_with_prefix_matches_jax(model):
    cfg, jcfg, jparams, params = model
    toks, pe = _tokens(cfg, 2, 14), _patches(cfg, 2)
    logits, _, _ = lm.forward(params, cfg, torch.from_numpy(toks).long(),
                              prefix_embeds=torch.from_numpy(pe))
    jlogits, _, _ = j_lm.forward(jparams, jcfg, jnp.asarray(toks),
                                 prefix_embeds=jnp.asarray(pe))
    assert logits.shape == (2, cfg.n_frontend_tokens + 14, cfg.vocab_size)
    _close(logits, jlogits)
    # the prefix moves every token's logits
    plain, _, _ = lm.forward(params, cfg, torch.from_numpy(toks).long())
    assert float((plain - logits[:, cfg.n_frontend_tokens:]).abs().max()) \
        > 1e-3


def test_prefill_and_decode_with_prefix_match_jax(model):
    cfg, jcfg, jparams, params = model
    B, S, n_pre = 2, 14, 9
    nf = cfg.n_frontend_tokens
    toks, pe = _tokens(cfg, B, S, seed=2), _patches(cfg, B, seed=3)
    full, _, _ = lm.forward(params, cfg, torch.from_numpy(toks).long(),
                            prefix_embeds=torch.from_numpy(pe))
    max_seq = nf + S + 2
    cache = lm.init_cache(cfg, B, max_seq, torch.float32, device="cpu")
    jcache = j_lm.init_cache(jcfg, B, max_seq, jnp.float32)
    lg, cache = lm.prefill(params, cfg, torch.from_numpy(toks[:, :n_pre])
                           .long(), cache, prefix_embeds=torch.from_numpy(pe))
    jlg, jcache = j_lm.prefill(jparams, jcfg, jnp.asarray(toks[:, :n_pre]),
                               jcache, prefix_embeds=jnp.asarray(pe))
    _close(lg, jlg)
    _close(lg, full[:, nf + n_pre - 1], 2e-3)
    for t in range(n_pre, S):
        pos = nf + t                        # positions count the prefix
        lg, cache = lm.decode_step(params, cfg,
                                   torch.from_numpy(toks[:, t]).long(),
                                   cache, pos)
        jlg, jcache = j_lm.decode_step(jparams, jcfg, jnp.asarray(toks[:, t]),
                                       jcache, jnp.asarray(pos, jnp.int32))
        _close(lg, jlg)
        _close(lg, full[:, pos], 2e-3)


def test_generate_with_prefix_matches_jax(model):
    cfg, jcfg, jparams, params = model
    prompts, pe = _tokens(cfg, 2, 7, seed=4), _patches(cfg, 2, seed=5)
    eng = engine.ServeEngine(cfg, params, 2, 32, device="cpu")
    jeng = j_engine.ServeEngine(jcfg, jparams, 2, 32)
    out = eng.generate(prompts, 6, prefix_embeds=pe)
    np.testing.assert_array_equal(
        out, jeng.generate(prompts, 6, prefix_embeds=jnp.asarray(pe)))
    # a torch prefix gives the same tokens, and a prefix that does not fit
    # max_seq raises
    np.testing.assert_array_equal(
        out, eng.generate(prompts, 6, prefix_embeds=torch.from_numpy(pe)))
    with pytest.raises(ValueError, match="max_seq"):
        eng.generate(_tokens(cfg, 2, 20), 6, prefix_embeds=pe)


def test_vision_patches_stub():
    cfg = get_arch(NAME).reduced()
    gen = lambda: torch.Generator().manual_seed(7)
    pe = frontends.vision_patches(gen(), cfg, 3)
    assert pe.shape == (3, cfg.n_frontend_tokens, cfg.d_model)
    assert torch.equal(pe, frontends.vision_patches(gen(), cfg, 3))
    batch = frontends.make_train_batch(gen(), cfg, 2, 20)
    assert batch["tokens"].shape == (2, 20 - cfg.n_frontend_tokens)
    assert batch["prefix_embeds"].shape == (2, cfg.n_frontend_tokens,
                                            cfg.d_model)
    assert "enc_frames" not in batch
