"""The port's LM stack against the JAX package's on the CPU, at every
architecture's ``reduced()`` config (dense GQA, VLM, MoE with MLA or GQA,
RWKV6, Hymba, Whisper; frontend inputs as the same numpy arrays):
layers one by one, the parameter carry-over, and ``forward`` (logits and
MoE aux loss) / ``prefill`` / ``decode_step`` logits from the same weights
(fp32, within 1e-4: XLA and ATen sum in different orders).  Also the
port's own invariant (decode matches forward within 2e-3 under the
capacity-less MoE dispatch, as tests/test_models.py holds the JAX package
to) and full-size parameter counts."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.models import layers as j_layers
from repro.models import lm as j_lm
from repro.models import rwkv as j_rwkv
from repro_torch.configs import ARCHS, get_arch
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.rwkv_scan import ops as rw_ops
from repro_torch.models import layers, lm, rwkv
from repro_torch.models.convert import params_from_jax

ARCH_NAMES = sorted(ARCHS)
TOL = 1e-4


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(_np(a), _np(b), rtol=tol, atol=tol)


def _jax_params(cfg, seed=0):
    """JAX parameters with every leaf perturbed, so zero-initialised biases
    and mixes carry real values through both packages."""
    params = j_lm.init_params(jax.random.PRNGKey(seed), cfg, jnp.float32)
    leaves, tree = jax.tree.flatten(params)
    rng = np.random.default_rng(seed)
    leaves = [np.asarray(x) + 0.05 * rng.normal(size=x.shape).astype(
        np.float32) for x in leaves]
    return jax.tree.unflatten(tree, leaves)


@pytest.fixture(scope="module", params=ARCH_NAMES)
def model(request):
    cfg = get_arch(request.param).reduced()
    jparams = _jax_params(J_ARCHS[request.param].reduced())
    params = params_from_jax(jparams, cfg, device="cpu")
    return cfg, jparams, params


@pytest.fixture(autouse=True)
def _no_launch_on_cpu():
    fa_ops.reset_launch_counts()
    rw_ops.reset_launch_counts()
    yield
    assert fa_ops.LAUNCHES["flash_attention"] == 0
    assert rw_ops.LAUNCHES["wkv_scan"] == 0


def _rand(*shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


# ---------------------------------------------------------------------------
# configs and layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ARCH_NAMES)
def test_configs_and_reduced_match_jax(name):
    fields = dataclasses.asdict
    assert fields(ARCHS[name]) == fields(J_ARCHS[name])
    assert fields(get_arch(name).reduced()) == \
        fields(J_ARCHS[name].reduced())


def test_archs_equal_jax():
    assert sorted(ARCHS) == sorted(J_ARCHS)
    assert len(ARCHS) == 10
    for name in ARCHS:
        assert get_arch(name) is ARCHS[name]
        assert [dataclasses.astuple(g) for g in lm.layer_groups(ARCHS[name])
                ] == [dataclasses.astuple(g)
                      for g in j_lm.layer_groups(J_ARCHS[name])]
    with pytest.raises(KeyError, match="unknown arch"):
        get_arch("gpt-5")


def test_norms_and_mlp_match_jax():
    x, w, b = _rand(3, 5, 64), _rand(64, seed=1), _rand(64, seed=2)
    t = lambda a: torch.from_numpy(a)
    _close(layers.rms_norm(t(x), t(w)), j_layers.rms_norm(x, w))
    _close(layers.layer_norm(t(x), t(w), t(b)),
           j_layers.layer_norm(x, w, b))
    w1, w3, w2 = _rand(64, 96, seed=3), _rand(64, 96, seed=4), \
        _rand(96, 64, seed=5)
    _close(layers.swiglu(t(x), t(w1), t(w3), t(w2)),
           j_layers.swiglu(x, w1, w3, w2))
    # bf16 input: fp32 inside, cast back
    xb = t(x).to(torch.bfloat16)
    out = layers.rms_norm(xb, t(w))
    assert out.dtype == torch.bfloat16
    _close(out, j_layers.rms_norm(jnp.asarray(x, jnp.bfloat16), w), 2e-2)


def test_rope_matches_jax():
    x = _rand(2, 7, 3, 16)
    pos = np.arange(5, 12)
    _close(layers.rope_freqs(16, 1e6), j_layers.rope_freqs(16, 1e6), 1e-7)
    _close(layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                             1e6),
           j_layers.apply_rope(x, pos, 1e6), 1e-5)


def test_rwkv_blocks_match_jax():
    cfg = get_arch("rwkv6-3b").reduced()
    jcfg = J_ARCHS["rwkv6-3b"].reduced()
    jp = jax.tree.map(np.asarray, _jax_params(jcfg))["group0"]
    one = lambda tree: jax.tree.map(lambda a: a[0], tree)
    tp, cp = one(jp["tmix"]), one(jp["cmix"])
    tt = {k: torch.from_numpy(v) for k, v in tp.items()}
    ct = {k: torch.from_numpy(v) for k, v in cp.items()}
    x = _rand(2, 9, cfg.d_model, seed=8)
    st = {"shift": _rand(2, cfg.d_model, seed=9),
          "wkv": 0.1 * _rand(2, 4, 16, 16, seed=10)}
    tst = {k: torch.from_numpy(v) for k, v in st.items()}
    out, new = rwkv.tmix_forward(tt, cfg, torch.from_numpy(x), tst, chunk=4)
    jout, jnew = j_rwkv.tmix_forward(tp, jcfg, x, st, chunk=4)
    _close(out, jout)
    _close(new["wkv"], jnew["wkv"])
    _close(new["shift"], jnew["shift"])
    out, new = rwkv.tmix_step(tt, cfg, torch.from_numpy(x[:, 0]), tst)
    jout, jnew = j_rwkv.tmix_step(tp, jcfg, x[:, 0], st)
    _close(out, jout)
    _close(new["wkv"], jnew["wkv"])
    out, shift = rwkv.cmix_forward(ct, torch.from_numpy(x),
                                   tst["shift"])
    jout, jshift = j_rwkv.cmix_forward(cp, x, st["shift"])
    _close(out, jout)
    _close(shift, jshift)
    g = rwkv._group_norm(torch.from_numpy(x), tt["gn_w"], tt["gn_b"], 4)
    _close(g, j_rwkv._group_norm(x, tp["gn_w"], tp["gn_b"], 4))


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def test_params_from_jax_keeps_every_weight(model):
    cfg, jparams, params = model
    counts = {f"group{gi}": g.count
              for gi, g in enumerate(lm.layer_groups(cfg))}
    assert sum(counts.values()) == cfg.n_layers
    if cfg.family == "encdec":                 # the stacked encoder
        counts["encoder"] = cfg.encoder_layers
    assert all(len(params[k]) == n for k, n in counts.items())
    flat, _ = jax.tree_util.tree_flatten_with_path(jparams)
    for path, leaf in flat:
        keys = [p.key for p in path]
        if keys[0] in counts:
            for i in range(counts[keys[0]]):
                node = params[keys[0]][i]
                for key in keys[1:]:
                    node = node[key]
                np.testing.assert_array_equal(node.numpy(),
                                              np.asarray(leaf)[i])
        else:
            node = params
            for key in keys:
                node = node[key]
            np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))


def test_init_params_shapes_match_jax(model):
    cfg, _, converted = model
    mine = lm.init_params(0, cfg, device="cpu")
    assert _shapes(mine) == _shapes(converted)
    assert all(torch.isfinite(t).all() for t in lm.leaves(mine))


def _shapes(tree, path=()):
    """{path: shape} of every leaf of a nested dict / list tree."""
    if isinstance(tree, torch.Tensor):
        return {path: tuple(tree.shape)}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    return {p: s for k, sub in items for p, s in _shapes(sub,
                                                         path + (k,)).items()}


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_count_params_matches_jax(name):
    assert lm.count_params(ARCHS[name]) == j_lm.count_params(J_ARCHS[name])
    assert ARCHS[name].n_params() == lm.count_params(ARCHS[name])


# ---------------------------------------------------------------------------
# forward, prefill, decode against JAX
# ---------------------------------------------------------------------------

def cfg_j(cfg):
    return J_ARCHS[cfg.name].reduced()


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def _front(cfg, B, seed=7):
    """Frontend inputs as numpy arrays: ({torch kwargs}, {JAX kwargs},
    prefix length)."""
    rng = np.random.default_rng(seed)
    kw = {}
    if cfg.frontend == "vision":
        kw["prefix_embeds"] = rng.normal(
            size=(B, cfg.n_frontend_tokens, cfg.d_model)) * 0.02
    if cfg.family == "encdec":
        kw["enc_frames"] = rng.normal(
            size=(B, cfg.encoder_seq, cfg.d_model)) * 0.02
    kw = {k: v.astype(np.float32) for k, v in kw.items()}
    n_front = cfg.n_frontend_tokens if "prefix_embeds" in kw else 0
    return ({k: torch.from_numpy(v) for k, v in kw.items()},
            {k: jnp.asarray(v) for k, v in kw.items()}, n_front)


def test_forward_matches_jax(model):
    cfg, jparams, params = model
    toks = _tokens(cfg, 2, 24)
    tkw, jkw, n_front = _front(cfg, 2)
    logits, _, aux = lm.forward(params, cfg, torch.from_numpy(toks).long(),
                                mixer_chunk=8, **tkw)
    jlogits, _, jaux = j_lm.forward(jparams, cfg_j(cfg), jnp.asarray(toks),
                                    mixer_chunk=8, **jkw)
    assert logits.shape == (2, n_front + 24, cfg.vocab_size)
    _close(logits, jlogits)
    _close(aux, jaux)
    assert (float(aux) > 0.0) == (cfg.moe is not None)


def test_prefill_and_decode_match_jax(model):
    cfg, jparams, params = model
    B, S, n_dec, max_seq = 2, 10, 3, 16
    toks = _tokens(cfg, B, S + n_dec, seed=1)
    tkw, jkw, n_front = _front(cfg, B)
    max_seq += n_front
    cache = lm.init_cache(cfg, B, max_seq, torch.float32, device="cpu")
    jcache = j_lm.init_cache(cfg_j(cfg), B, max_seq, jnp.float32)
    lg, cache = lm.prefill(params, cfg, torch.from_numpy(toks[:, :S]).long(),
                           cache, **tkw)
    jlg, jcache = j_lm.prefill(jparams, cfg_j(cfg), jnp.asarray(toks[:, :S]),
                               jcache, **jkw)
    assert lg.shape == (B, cfg.vocab_size)
    _close(lg, jlg)
    for i in range(n_dec):
        pos = n_front + S + i
        tok = toks[:, S + i]
        lg, cache = lm.decode_step(params, cfg, torch.from_numpy(tok).long(),
                                   cache, pos)
        jlg, jcache = j_lm.decode_step(jparams, cfg_j(cfg), jnp.asarray(tok),
                                       jcache, jnp.asarray(pos, jnp.int32))
        _close(lg, jlg)


def test_decode_matches_forward(model):
    """The port's own invariant at its own weights (init on the CPU)."""
    cfg = model[0]
    params = lm.init_params(3, cfg, device="cpu")
    B, S = 2, 12
    toks = torch.from_numpy(_tokens(cfg, B, S, seed=2)).long()
    tkw, _, nf = _front(cfg, B)
    full, _, _ = lm.forward(params, cfg, toks, mixer_chunk=4,
                            dense_moe=True, **tkw)
    n_pre = S - 2
    cache = lm.init_cache(cfg, B, nf + S + 4, torch.float32, device="cpu")
    lg, cache = lm.prefill(params, cfg, toks[:, :n_pre], cache,
                           mixer_chunk=4, dense_moe=True, **tkw)
    errs = [float((lg - full[:, nf + n_pre - 1]).abs().max())]
    lg, cache = lm.decode_step(params, cfg, toks[:, n_pre], cache,
                               nf + n_pre, dense_moe=True)
    errs.append(float((lg - full[:, nf + n_pre]).abs().max()))
    assert max(errs) < 2e-3, errs
    assert fa_ops.PLAIN_CALLS["flash_attention"] + \
        rw_ops.PLAIN_CALLS["wkv_scan"] > 0
