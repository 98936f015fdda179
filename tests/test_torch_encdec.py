"""Whisper's pieces in the port against the JAX package's on the CPU: the
tanh GELU MLP (1e-4) and the sinusoidal tables (to the fp32 rounding of
the angle), the encoder
(``encode``), cross attention (``encode_cross_kv``,
``cross_attn_forward``), the audio-frame stub, and the reduced
whisper-large-v3 model (forward, prefill with the cross keys stored,
decode reading them) from the same weights and the same numpy frames
within 1e-4 (XLA and ATen sum in different orders)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.models import layers as j_layers
from repro.models import lm as j_lm
from repro_torch.configs import get_arch
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models import frontends, layers, lm
from repro_torch.models.convert import params_from_jax

NAME = "whisper-large-v3"
TOL = 1e-4


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(_np(a), _np(b), rtol=tol, atol=tol)


def _rand(*shape, seed=0, scale=1.0):
    return (scale * np.random.default_rng(seed).normal(size=shape)
            ).astype(np.float32)


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


def _frames(cfg, B, seed=1):
    return _rand(B, cfg.encoder_seq, cfg.d_model, seed=seed, scale=0.02)


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def test_gelu_mlp_is_the_tanh_gelu_of_jax():
    x, w1, b1 = _rand(3, 5, 64), _rand(64, 96, seed=1), _rand(96, seed=2)
    w2, b2 = _rand(96, 64, seed=3), _rand(64, seed=4)
    t = torch.from_numpy
    got = layers.gelu_mlp(t(x), t(w1), t(b1), t(w2), t(b2))
    _close(got, j_layers.gelu_mlp(x, w1, b1, w2, b2), 1e-4)
    # the exact GELU would not do
    exact = torch.nn.functional.gelu(t(x) @ t(w1) + t(b1)) @ t(w2) + t(b2)
    assert float((exact - got).abs().max()) > 1e-3


@pytest.mark.parametrize("d", [8, 64, 1280])
def test_sinusoidal_tables_match_jax(d):
    """Equal up to the fp32 rounding of the angle pos * div: XLA's and
    ATen's exp differ by an ulp in some of div's entries, which an angle
    of pos radians carries as pos ulps; held to 4 * 2^-23 * pos + 1e-6."""
    for pos in (np.arange(37), np.array([0, 5, 447, 1499, 3])):
        got = (layers.sinusoidal_positions(37, d) if len(pos) == 37
               else layers.sinusoidal_at(torch.from_numpy(pos), d))
        want = (j_layers.sinusoidal_positions(37, d) if len(pos) == 37
                else j_layers.sinusoidal_at(jnp.asarray(pos), d))
        assert got.dtype == torch.float32 and got.shape == (len(pos), d)
        err = np.abs(got.numpy() - np.asarray(want))
        assert (err <= 1e-6 + 4 * 2.0 ** -23 * pos[:, None]).all(), \
            err.max(1)


def test_encode_matches_jax(model):
    cfg, jcfg, jparams, params = model
    frames = _frames(cfg, 2)
    fa_ops.reset_launch_counts()
    got = lm.encode(params, cfg, torch.from_numpy(frames))
    assert fa_ops.PLAIN_CALLS["flash_attention"] == cfg.encoder_layers
    assert fa_ops.LAUNCHES["flash_attention"] == 0
    _close(got, j_lm.encode(jparams, jcfg, jnp.asarray(frames)))


def test_cross_attention_matches_jax(model):
    cfg, jcfg, jparams, params = model
    enc = _rand(2, cfg.encoder_seq, cfg.d_model, seed=5)
    x = _rand(2, 7, cfg.d_model, seed=6)
    jp = jax.tree.map(lambda a: np.asarray(a)[1],
                      jparams["group0"]["xattn"])
    tp = params["group0"][1]["xattn"]
    kv = lm.encode_cross_kv(tp, cfg, torch.from_numpy(enc))
    jkv = j_lm.encode_cross_kv(jp, jcfg, enc)
    _close(kv["k"], jkv["k"], 1e-5)
    _close(kv["v"], jkv["v"], 1e-5)
    got = lm.cross_attn_forward(tp, cfg, torch.from_numpy(x), kv)
    _close(got, j_lm.cross_attn_forward(jp, jcfg, x, jkv), 1e-5)


def test_forward_matches_jax(model):
    cfg, jcfg, jparams, params = model
    toks, frames = _tokens(cfg, 2, 20), _frames(cfg, 2)
    logits, cache, aux = lm.forward(params, cfg,
                                    torch.from_numpy(toks).long(),
                                    enc_frames=torch.from_numpy(frames))
    jlogits, _, _ = j_lm.forward(jparams, jcfg, jnp.asarray(toks),
                                 enc_frames=jnp.asarray(frames))
    assert logits.shape == (2, 20, cfg.vocab_size) and cache is None
    _close(logits, jlogits)
    assert float(aux) == 0.0


def test_prefill_and_decode_match_jax_and_forward(model):
    cfg, jcfg, jparams, params = model
    B, S, n_pre = 2, 16, 10
    toks, frames = _tokens(cfg, B, S, seed=2), _frames(cfg, B, seed=3)
    full, _, _ = lm.forward(params, cfg, torch.from_numpy(toks).long(),
                            enc_frames=torch.from_numpy(frames))
    cache = lm.init_cache(cfg, B, S + 2, torch.float32, device="cpu")
    jcache = j_lm.init_cache(jcfg, B, S + 2, jnp.float32)
    fa_ops.reset_launch_counts()
    lg, cache = lm.prefill(params, cfg, torch.from_numpy(toks[:, :n_pre])
                           .long(), cache, enc_frames=torch.from_numpy(frames))
    # encoder, then self and cross attention in every decoder layer
    assert fa_ops.PLAIN_CALLS["flash_attention"] == \
        cfg.encoder_layers + 2 * cfg.n_layers
    jlg, jcache = j_lm.prefill(jparams, jcfg, jnp.asarray(toks[:, :n_pre]),
                               jcache, enc_frames=jnp.asarray(frames))
    _close(lg, jlg)
    _close(lg, full[:, n_pre - 1], 2e-3)
    for i in range(cfg.n_layers):
        _close(cache["group0"][i]["cross"]["k"],
               np.asarray(jcache["group0"]["cross"]["k"])[i])
    for pos in range(n_pre, S):
        tok = toks[:, pos]
        fa_ops.reset_launch_counts()
        lg, cache = lm.decode_step(params, cfg, torch.from_numpy(tok).long(),
                                   cache, pos)
        # decode never re-encodes: self and cross attention only
        assert fa_ops.PLAIN_CALLS["flash_attention"] == 2 * cfg.n_layers
        jlg, jcache = j_lm.decode_step(jparams, jcfg, jnp.asarray(tok),
                                       jcache, jnp.asarray(pos, jnp.int32))
        _close(lg, jlg)
        _close(lg, full[:, pos], 2e-3)


def test_missing_frames_raise(model):
    cfg, _, _, params = model
    toks = torch.zeros((1, 4), dtype=torch.long)
    with pytest.raises(ValueError, match="enc_frames"):
        lm.forward(params, cfg, toks)
    cache = lm.init_cache(cfg, 1, 8, torch.float32, device="cpu")
    with pytest.raises(ValueError, match="enc_frames"):
        lm.prefill(params, cfg, toks, cache)


def test_audio_frames_and_train_batch():
    cfg = get_arch(NAME).reduced()
    gen = lambda: torch.Generator().manual_seed(3)
    frames = frontends.audio_frames(gen(), cfg, 2, torch.bfloat16)
    assert frames.shape == (2, cfg.encoder_seq, cfg.d_model)
    assert frames.dtype == torch.bfloat16
    assert 0.01 < float(frames.float().std()) < 0.03
    assert torch.equal(frames, frontends.audio_frames(gen(), cfg, 2,
                                                      torch.bfloat16))
    batch = frontends.make_train_batch(gen(), cfg, 3, 12)
    assert set(batch) == {"tokens", "targets", "loss_mask", "enc_frames"}
    assert batch["tokens"].shape == batch["targets"].shape == (3, 12)
    assert torch.equal(batch["tokens"][:, 1:], batch["targets"][:, :-1])
    assert batch["enc_frames"].shape == (3, cfg.encoder_seq, cfg.d_model)
    assert int(batch["tokens"].max()) < cfg.vocab_size
    assert frontends.frontend_inputs(gen(), get_arch("qwen2-1.5b"), 2) == {}
