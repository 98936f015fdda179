"""The port's MoE layer and MoE models against the JAX package's on the
CPU, float32, on the same seeded numpy inputs.

* ``route`` (ids exact, weights within 1e-6) and the load-balance loss.
* The three dispatch paths (``moe_ffn_dense``, ``moe_ffn_capacity``,
  ``moe_ffn_sorted`` with one and two groups) at the default capacity, at
  a tight one (factor 0.5), where token-choices drop, and at capacity
  factor 100, where none does: outputs within 1e-5.  The sorted path's
  keep-mask and slots are exact against the JAX package's dispatch
  (``src/repro/models/moe.py:180-193``, recomputed here from the same ids
  with the same jnp ops).
* Whole models at ``reduced()`` (deepseek-v2-lite-16b: MLA and MoE with
  shared experts and a dense first layer; grok-1-314b: GQA and MoE
  without shared experts) from ``params_from_jax`` weights, with
  ``dense_moe`` both ways: ``forward`` logits and aux, ``prefill`` and
  ``decode_step`` within 1e-4, and greedy ``ServeEngine`` tokens equal.
* Full-size parameter counts (total and active) on the ``meta`` device,
  and the router kept float32 under a bfloat16 model.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.models import lm as j_lm
from repro.models import moe as j_moe
from repro.serve import engine as j_engine
from repro_torch.configs import ARCHS, MoEConfig, get_arch
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.launch import serve as launch_serve
from repro_torch.models import lm, moe
from repro_torch.models.convert import params_from_jax
from repro_torch.serve import engine

MOE_ARCHS = ("deepseek-v2-lite-16b", "grok-1-314b")
# capacity factors: the config's (1.25), one that must drop token-choices,
# and one under which none drops
FACTORS = [None, 0.5, 100.0]
FACTOR_IDS = ["default", "tight", "no_drops"]
OUT_TOL = 1e-5
MODEL_TOL = 1e-4
# (name, MoEConfig, d_model, tokens): the reduced deepseek layer, and one
# with deepseek-v2-lite's routing widths (64 experts, top 6, 2 shared) at a
# narrow d_model
LAYERS = {
    "reduced": (get_arch("deepseek-v2-lite-16b").reduced().moe, 64, 24),
    "wide": (MoEConfig(n_routed=64, n_shared=2, top_k=6, d_ff_expert=16,
                       first_dense_layers=1), 32, 48),
    "no_shared": (get_arch("grok-1-314b").reduced().moe, 64, 24),
}


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _close(a, b, tol):
    np.testing.assert_allclose(_np(a), _np(b), rtol=tol, atol=tol)


def _rand(*shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _layer(name, seed=0):
    """(m, jax params as numpy, port params, x as numpy) of one MoE layer."""
    m, d, T = LAYERS[name]
    cfg = dataclasses.replace(get_arch("deepseek-v2-lite-16b").reduced(),
                              d_model=d, moe=m)
    jp = j_moe.init_moe_params(jax.random.PRNGKey(seed), cfg, jnp.float32)
    jp = {k: np.asarray(v) for k, v in jp.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in jp.items()}
    return m, jp, tp, _rand(T, d, seed=seed + 1)


def _margin(router, x, k):
    """Gap between the k-th and (k+1)-th router probability, per token."""
    probs = np.asarray(jax.nn.softmax(jnp.asarray(x) @ router, axis=-1))
    top = -np.sort(-probs, axis=-1)
    return top[:, k - 1] - top[:, k]


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(LAYERS))
def test_route_matches_jax(name):
    m, jp, tp, x = _layer(name)
    w, ids = moe.route(tp["router"], torch.from_numpy(x), m.top_k)
    jw, jids = j_moe.route(jp["router"], x, m.top_k)
    gap = _margin(jp["router"], x, m.top_k)
    assert np.array_equal(ids.numpy(), np.asarray(jids)), (
        f"ids differ; smallest k-th/(k+1)-th probability gap {gap.min()!r}")
    assert w.dtype == torch.float32
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_aux_load_balance_loss_matches_jax(name):
    m, jp, tp, x = _layer(name, seed=3)
    aux = moe.aux_load_balance_loss(tp["router"], torch.from_numpy(x),
                                    m.top_k)
    _close(aux, j_moe.aux_load_balance_loss(jp["router"], x, m.top_k),
           OUT_TOL)


# ---------------------------------------------------------------------------
# dispatch paths
# ---------------------------------------------------------------------------

def _jax_sorted_dispatch(ids, E, n_groups, C):
    """The JAX package's per-group slot and keep-mask, in sorted order,
    with the token-choice each sorted entry is (moe.py:180-189)."""
    T, k = ids.shape
    Tg = T // n_groups
    out = []
    for el in jnp.asarray(ids).reshape(n_groups, Tg, k):
        e_flat = el.reshape(Tg * k)
        order = jnp.argsort(e_flat, stable=True)
        e_sorted = e_flat[order]
        first = jnp.searchsorted(e_sorted, e_sorted, side="left")
        pos = jnp.arange(Tg * k) - first
        keep = pos < C
        slot = jnp.where(keep, e_sorted * C + pos, 0)
        out.append(tuple(np.asarray(a) for a in (order, slot, keep)))
    return out


@pytest.mark.parametrize("factor", FACTORS, ids=FACTOR_IDS)
@pytest.mark.parametrize("n_groups", [1, 2])
@pytest.mark.parametrize("name", sorted(LAYERS))
def test_sorted_dispatch_keep_and_slots_exact(name, n_groups, factor):
    m, jp, tp, x = _layer(name, seed=5)
    if factor is not None:
        m = dataclasses.replace(m, capacity_factor=factor)
    T, E, k = x.shape[0], m.n_routed, m.top_k
    Tg = T // n_groups
    C = min(max(int(Tg * k * m.capacity_factor / E), 1), Tg * k)
    _, ids = moe.route(tp["router"], torch.from_numpy(x), k)
    slot, keep = moe.sorted_dispatch(ids, E, n_groups, C)
    slot, keep = slot.numpy(), keep.numpy()
    n_kept = 0
    for g, (order, jslot, jkeep) in enumerate(
            _jax_sorted_dispatch(ids.numpy(), E, n_groups, C)):
        s_g = slot[g * Tg:(g + 1) * Tg].reshape(-1)[order]
        k_g = keep[g * Tg:(g + 1) * Tg].reshape(-1)[order]
        np.testing.assert_array_equal(k_g, jkeep)
        np.testing.assert_array_equal(np.where(k_g, s_g - g * E * C, 0),
                                      jslot)
        n_kept += int(jkeep.sum())
    # the kept slots are distinct: the dispatch is a plain indexed copy
    assert len(np.unique(slot[keep])) == n_kept
    if factor == 0.5:
        assert n_kept < T * k, "a tight capacity drops token-choices"
    if factor == 100.0:
        assert n_kept == T * k


@pytest.mark.parametrize("factor", FACTORS, ids=FACTOR_IDS)
@pytest.mark.parametrize("n_groups", [1, 2])
@pytest.mark.parametrize("name", sorted(LAYERS))
def test_moe_ffn_sorted_matches_jax(name, n_groups, factor):
    m, jp, tp, x = _layer(name, seed=7)
    if factor is not None:
        m = dataclasses.replace(m, capacity_factor=factor)
    out = moe.moe_ffn_sorted(tp, m, torch.from_numpy(x), n_groups=n_groups)
    _close(out, j_moe.moe_ffn_sorted(jp, m, x, n_groups=n_groups), OUT_TOL)
    if factor == 100.0:                      # no drop: the exact MoE
        _close(out, moe.moe_ffn_dense(tp, m, torch.from_numpy(x)), OUT_TOL)


@pytest.mark.parametrize("capacity", [None, 2, 10 ** 6])
@pytest.mark.parametrize("name", sorted(LAYERS))
def test_moe_ffn_capacity_matches_jax(name, capacity):
    m, jp, tp, x = _layer(name, seed=9)
    out = moe.moe_ffn_capacity(tp, m, torch.from_numpy(x), capacity)
    _close(out, j_moe.moe_ffn_capacity(jp, m, x, capacity), OUT_TOL)


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_moe_ffn_dense_matches_jax(name):
    m, jp, tp, x = _layer(name, seed=11)
    out = moe.moe_ffn_dense(tp, m, torch.from_numpy(x))
    _close(out, j_moe.moe_ffn_dense(jp, m, x), OUT_TOL)


@pytest.mark.parametrize("dense", [False, True])
def test_moe_ffn_flattens_leading_dims(dense):
    m, jp, tp, x = _layer("wide", seed=13)
    x3 = x.reshape(2, -1, x.shape[-1])
    out = moe.moe_ffn(tp, m, torch.from_numpy(x3), dense_dispatch=dense)
    assert out.shape == x3.shape
    _close(out, j_moe.moe_ffn(jp, m, x3, dense_dispatch=dense), OUT_TOL)


def test_sorted_moe_rejects_uneven_groups():
    m, _, tp, x = _layer("reduced")
    with pytest.raises(ValueError, match="groups"):
        moe.moe_ffn_sorted(tp, m, torch.from_numpy(x[:5]), n_groups=2)


# ---------------------------------------------------------------------------
# whole models at reduced()
# ---------------------------------------------------------------------------

def _jax_params(cfg, seed=0):
    """JAX parameters with every leaf perturbed (as in test_torch_lm.py)."""
    params = j_lm.init_params(jax.random.PRNGKey(seed), cfg, jnp.float32)
    leaves, tree = jax.tree.flatten(params)
    rng = np.random.default_rng(seed)
    leaves = [np.asarray(x) + 0.05 * rng.normal(size=x.shape).astype(
        np.float32) for x in leaves]
    return jax.tree.unflatten(tree, leaves)


@pytest.fixture(scope="module", params=MOE_ARCHS)
def model(request):
    jcfg = J_ARCHS[request.param].reduced()
    jparams = _jax_params(jcfg)
    cfg = get_arch(request.param).reduced()
    return cfg, jcfg, jparams, params_from_jax(jparams, cfg, device="cpu")


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


@pytest.mark.parametrize("dense_moe", [False, True])
def test_forward_logits_and_aux_match_jax(model, dense_moe):
    cfg, jcfg, jparams, params = model
    toks = _tokens(cfg, 2, 24)
    fa_ops.reset_launch_counts()
    logits, _, aux = lm.forward(params, cfg, torch.from_numpy(toks).long(),
                                dense_moe=dense_moe)
    jlogits, _, jaux = j_lm.forward(jparams, jcfg, jnp.asarray(toks),
                                    dense_moe=dense_moe)
    _close(logits, jlogits, MODEL_TOL)
    _close(aux, jaux, MODEL_TOL)
    assert float(aux) > 0
    # one attention call a layer, on the plain path here
    assert fa_ops.PLAIN_CALLS["flash_attention"] == cfg.n_layers
    assert fa_ops.LAUNCHES["flash_attention"] == 0


@pytest.mark.parametrize("dense_moe", [False, True])
def test_forward_moe_groups_matches_jax(model, dense_moe):
    cfg, jcfg, jparams, params = model
    toks = _tokens(cfg, 2, 12, seed=4)
    logits, _, aux = lm.forward(params, cfg, torch.from_numpy(toks).long(),
                                dense_moe=dense_moe, moe_groups=2)
    jlogits, _, jaux = j_lm.forward(jparams, jcfg, jnp.asarray(toks),
                                    dense_moe=dense_moe, moe_groups=2)
    _close(logits, jlogits, MODEL_TOL)
    _close(aux, jaux, MODEL_TOL)


@pytest.mark.parametrize("dense_moe", [False, True])
def test_prefill_and_decode_match_jax(model, dense_moe):
    cfg, jcfg, jparams, params = model
    B, S, n_dec, max_seq = 2, 10, 4, 16
    toks = _tokens(cfg, B, S + n_dec, seed=1)
    cache = lm.init_cache(cfg, B, max_seq, torch.float32, device="cpu")
    jcache = j_lm.init_cache(jcfg, B, max_seq, jnp.float32)
    lg, cache = lm.prefill(params, cfg, torch.from_numpy(toks[:, :S]).long(),
                           cache, dense_moe=dense_moe)
    jlg, jcache = j_lm.prefill(jparams, jcfg, jnp.asarray(toks[:, :S]),
                               jcache, dense_moe=dense_moe)
    _close(lg, jlg, MODEL_TOL)
    for i in range(n_dec):
        pos = S + i
        tok = toks[:, pos]
        lg, cache = lm.decode_step(params, cfg, torch.from_numpy(tok).long(),
                                   cache, pos, dense_moe=dense_moe)
        jlg, jcache = j_lm.decode_step(jparams, jcfg, jnp.asarray(tok),
                                       jcache, jnp.asarray(pos, jnp.int32),
                                       dense_moe=dense_moe)
        _close(lg, jlg, MODEL_TOL)
    # the caches hold the same keys (MLA: the latent and its rope key)
    for gi in range(len(lm.layer_groups(cfg))):
        for li, layer in enumerate(cache[f"group{gi}"]):
            for key, want in jcache[f"group{gi}"].items():
                _close(layer[key], np.asarray(want)[li], MODEL_TOL)


@pytest.mark.parametrize("dense_moe", [False, True])
def test_generate_greedy_matches_jax(model, dense_moe):
    cfg, jcfg, jparams, params = model
    eng = engine.ServeEngine(cfg, params, batch_slots=2, max_seq=32,
                             dense_moe=dense_moe, device="cpu")
    jeng = j_engine.ServeEngine(jcfg, jparams, batch_slots=2, max_seq=32,
                                dense_moe=dense_moe)
    prompts = _tokens(cfg, 2, 9, seed=2)
    out = eng.generate(prompts, 8)
    np.testing.assert_array_equal(out, jeng.generate(prompts, 8))


def test_decode_matches_forward_without_drops(model):
    """The capacity-less dispatch makes decode a function of the token
    alone, so prefill and decode logits equal forward's (the sorted path's
    capacity depends on how many tokens a call routes)."""
    cfg = model[0]
    params = lm.init_params(3, cfg, device="cpu")
    toks = torch.from_numpy(_tokens(cfg, 2, 12, seed=2)).long()
    full, _, _ = lm.forward(params, cfg, toks, dense_moe=True)
    cache = lm.init_cache(cfg, 2, 16, torch.float32, device="cpu")
    lg, cache = lm.prefill(params, cfg, toks[:, :10], cache, dense_moe=True)
    errs = [float((lg - full[:, 9]).abs().max())]
    for pos in (10, 11):
        lg, cache = lm.decode_step(params, cfg, toks[:, pos], cache, pos,
                                   dense_moe=True)
        errs.append(float((lg - full[:, pos]).abs().max()))
    assert max(errs) < 2e-3, errs


def test_launcher_serves_a_moe_arch_on_the_cpu(capsys):
    launch_serve.main(["--arch", "deepseek-v2-lite-16b", "--requests", "3",
                       "--slots", "2", "--max-new", "3", "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.count("req ") == 3 and "tok/s on cpu" in out


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", MOE_ARCHS)
def test_count_params_total_and_active_match_jax(name):
    cfg, jcfg = ARCHS[name], J_ARCHS[name]
    assert lm.count_params(cfg) == j_lm.count_params(jcfg)
    assert lm.count_params(cfg, active_only=True) == \
        j_lm.count_params(jcfg, active_only=True)
    assert cfg.n_active_params() == jcfg.n_active_params()
    assert cfg.n_active_params() < cfg.n_params()


def _routers(params):
    return [layer["moe"]["router"] for key, layers in params.items()
            if key.startswith("group") for layer in layers if "moe" in layer]


@pytest.mark.parametrize("name", MOE_ARCHS)
def test_router_stays_float32_in_a_bfloat16_model(name):
    cfg, jcfg = get_arch(name).reduced(), J_ARCHS[name].reduced()
    jparams = jax.tree.map(np.asarray, j_lm.init_params(
        jax.random.PRNGKey(0), jcfg, jnp.bfloat16))
    converted = params_from_jax(jparams, cfg, device="cpu",
                                dtype=torch.bfloat16)
    drawn = lm.init_params(0, cfg, torch.bfloat16, device="cpu")
    for params in (converted, drawn):
        routers = _routers(params)
        assert len(routers) == cfg.n_layers - cfg.moe.first_dense_layers
        assert all(r.dtype == torch.float32 for r in routers)
        assert params["group0"][0]["ln1"].dtype == torch.bfloat16
        experts = params[f"group{len(lm.layer_groups(cfg)) - 1}"][0]["moe"]
        assert experts["w1"].dtype == torch.bfloat16
    # the carried router is the JAX package's float32 router, bit for bit
    j_router = jparams[f"group{len(lm.layer_groups(cfg)) - 1}"]["moe"][
        "router"]
    assert j_router.dtype == np.float32
    np.testing.assert_array_equal(_routers(converted)[0].numpy(),
                                  j_router[0])
