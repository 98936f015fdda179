"""The port's optimizers against the JAX package's on the CPU: the
learning-rate schedule over 0-120 steps, and AdamW (clipping on and off,
fp32 and bf16 moments) and Adafactor (1-D leaves, stacked 3-D leaves, and
a layer stack of per-layer dicts against its stacked JAX counterpart) on
the same parameters, gradients and state from a numpy seed, over three
updates: every leaf within 1e-6 of the JAX package's, relative to the
leaf's largest entry (fp32 elementwise arithmetic, one rounding apart)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import optimizer as j_opt
from repro_torch.train import optimizer as opt

RTOL = 1e-6
SHAPES = {"a": (7,), "b": (3, 5, 6), "c": (4, 6), "d": (2, 3, 4, 5)}


def _tree(rng, scale=1.0):
    return {k: (scale * rng.normal(size=s)).astype(np.float32)
            for k, s in SHAPES.items()}


def _close(got, want, rtol=RTOL):
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rtol * max(np.abs(want).max(), 1e-30)


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def test_lr_schedule_matches_jax():
    for cfg_kw in ({"lr": 1.0, "warmup_steps": 10, "decay_steps": 100,
                    "min_lr_ratio": 0.1},
                   {"lr": 3e-4, "warmup_steps": 0, "decay_steps": 50},
                   {"lr": 2.0, "warmup_steps": 30, "decay_steps": 30}):
        jc = j_opt.OptimizerConfig(**cfg_kw)
        tc = opt.OptimizerConfig(**cfg_kw)
        for step in range(0, 121):
            want = float(j_opt.lr_at(jc, jnp.asarray(step)))
            got = float(opt.lr_at(tc, torch.tensor(step)))
            assert got == pytest.approx(want, rel=1e-6, abs=1e-12), step
    tc = opt.OptimizerConfig(lr=1.0, warmup_steps=10, decay_steps=100,
                             min_lr_ratio=0.1)
    assert float(opt.lr_at(tc, 5)) == pytest.approx(0.5)
    assert float(opt.lr_at(tc, 1000)) == pytest.approx(0.1)


@pytest.mark.parametrize("clip", [1.0, None])
@pytest.mark.parametrize("moment", ["float32", "bfloat16"])
def test_adamw_matches_jax(clip, moment):
    rng = np.random.default_rng(3)
    params = _tree(rng)
    jc = j_opt.OptimizerConfig(lr=1e-2, warmup_steps=2, decay_steps=20,
                               clip_norm=clip,
                               moment_dtype=getattr(jnp, moment))
    tc = opt.OptimizerConfig(lr=1e-2, warmup_steps=2, decay_steps=20,
                             clip_norm=clip,
                             moment_dtype=getattr(torch, moment))
    jp, tp = params, _t(params)
    jst, tst = j_opt.init_opt_state(jp, jc), opt.init_opt_state(tp, tc)
    for i in range(3):
        grads = _tree(rng, scale=0.7 + i)          # clipping bites at 1.0
        jp, jst, jm = j_opt.adamw_update(grads, jst, jp, jc)
        tp, tst, tm = opt.adamw_update(_t(grads), tst, tp, tc)
        _close(tm["grad_norm"], jm["grad_norm"])
        _close(tm["lr"], jm["lr"])
    for k in SHAPES:
        _close(tp[k], jp[k])
        for name in ("m", "v"):
            assert tst[name][k].dtype == getattr(torch, moment)
            # bf16 moments: both packages round the same fp32 value
            _close(tst[name][k], np.asarray(jst[name][k], np.float32),
                   RTOL if moment == "float32" else 2 ** -8)
    assert int(tst["count"]) == int(jst["count"]) == 3


def test_adafactor_matches_jax():
    rng = np.random.default_rng(5)
    params = _tree(rng)
    jc = j_opt.OptimizerConfig(kind="adafactor", lr=3e-3, warmup_steps=1,
                               decay_steps=50)
    tc = opt.OptimizerConfig(kind="adafactor", lr=3e-3, warmup_steps=1,
                             decay_steps=50)
    jp, tp = params, _t(params)
    jst, tst = j_opt.init_opt_state(jp, jc), opt.init_opt_state(tp, tc)
    for i in range(3):
        grads = _tree(rng, scale=0.5 + i)
        jp, jst, _ = j_opt.optimizer_update(grads, jst, jp, jc)
        tp, tst, _ = opt.optimizer_update(_t(grads), tst, tp, tc)
    for k, shape in SHAPES.items():
        _close(tp[k], jp[k])
        keys = ("vr", "vc") if len(shape) >= 2 else ("v",)
        assert set(tst["m"][k]) == set(keys)
        for name in keys:
            _close(tst["m"][k][name], jst["m"][k][name])


def test_adafactor_layer_stack_matches_jax_stacked():
    """A port layer stack (a list of per-layer dicts) is updated as the JAX
    package updates its stacked [L, ...] leaves, the 1-D per-layer leaves
    (a stacked [L, d]) included: the state stays stacked."""
    rng = np.random.default_rng(7)
    L = 3
    stacked = {"w": rng.normal(size=(L, 5, 6)).astype(np.float32),
               "g": rng.normal(size=(L, 6)).astype(np.float32)}
    jp = {"group0": stacked, "embed": rng.normal(size=(9, 6)).astype(
        np.float32)}
    tp = {"group0": [{k: torch.from_numpy(np.array(v[i]))
                      for k, v in stacked.items()} for i in range(L)],
          "embed": torch.from_numpy(np.array(jp["embed"]))}
    jc = j_opt.OptimizerConfig(kind="adafactor", lr=3e-3, warmup_steps=1)
    tc = opt.OptimizerConfig(kind="adafactor", lr=3e-3, warmup_steps=1)
    jst, tst = j_opt.init_opt_state(jp, jc), opt.init_opt_state(tp, tc)
    assert tst["m"]["group0"]["g"]["vr"].shape == (L,)
    for i in range(3):
        gs = {"w": rng.normal(size=(L, 5, 6)).astype(np.float32),
              "g": rng.normal(size=(L, 6)).astype(np.float32)}
        ge = rng.normal(size=(9, 6)).astype(np.float32)
        jp, jst, _ = j_opt.adafactor_update({"group0": gs, "embed": ge}, jst,
                                            jp, jc)
        tg = {"group0": [{k: torch.from_numpy(np.array(v[j]))
                          for k, v in gs.items()} for j in range(L)],
              "embed": torch.from_numpy(ge)}
        tp, tst, _ = opt.adafactor_update(tg, tst, tp, tc)
    for j in range(L):
        for k in stacked:
            _close(tp["group0"][j][k], jp["group0"][k][j])
    _close(tp["embed"], jp["embed"])
    for k in stacked:
        for name in ("vr", "vc"):
            _close(tst["m"]["group0"][k][name], jst["m"]["group0"][k][name])


def test_global_norm_and_tree_helpers():
    rng = np.random.default_rng(9)
    tree = _tree(rng)
    want = float(j_opt.global_norm(tree))
    _close(opt.global_norm(_t(tree)), want)
    t = {"x": [_t(tree), _t(tree)], "y": torch.ones(2)}
    leaves = opt.tree_leaves(t)
    assert len(leaves) == 2 * len(SHAPES) + 1
    back = opt.tree_unflatten(t, [x * 2 for x in leaves])
    assert list(back) == list(t) and torch.equal(back["y"], 2 * t["y"])
    assert torch.equal(back["x"][1]["b"], 2 * t["x"][1]["b"])
