"""The port's sharding policy (``repro_torch.distributed.sharding``) and
production meshes (``repro_torch.launch.mesh``) against the JAX package's,
on the CPU with no ranks: parameter specs of all ten archs at full width
(the JAX tree by ``jax.eval_shape``, the port's on the ``meta`` device, so
nothing is allocated), batch and cache specs, on the production, coded
and small meshes under every rule set.  The JAX policy reads only
``mesh.shape``, so a namespace holding that dict stands in for its mesh.
Every port spec must equal the JAX spec as a tuple, without the leading
``layers`` entry for a per-layer leaf.  At qwen2-72b on model 4 and
llama3-405b on model 8, every shard from ``shard_params`` (by shape) has
the local shape its spec implies.  Specs are exact: no tolerance."""
import functools
import math
import types

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS
from repro.distributed import sharding as jsh
from repro.launch import mesh as jmesh
from repro.models import lm as j_lm
from repro_torch.configs import ARCHS
from repro_torch.distributed import sharding as sh
from repro_torch.distributed import tensor_parallel as tpl
from repro_torch.distributed.meshes import MeshShape
from repro_torch.launch import mesh as pmesh
from repro_torch.models import lm
from repro_torch.train.trainer import train_state_pspecs

MESHES = {
    "single": (("data", "model"), (16, 16)),
    "multi": (("pod", "data", "model"), (2, 16, 16)),
    "coded4": (("pod", "data", "model"), (4, 8, 16)),
    "1x4": (("data", "model"), (1, 4)),
    "2x4": (("data", "model"), (2, 4)),
    "1x8": (("data", "model"), (1, 8)),
}
# name -> (rules of a module, multi_pod) and whether param_pspecs overlays
# FSDP
RULES = {
    "default_fsdp": (lambda s, mp: s.default_rules(mp, fsdp=True), True),
    "default": (lambda s, mp: s.default_rules(mp, fsdp=False), False),
    "dp_hybrid": (lambda s, mp: s.default_rules(mp, "dp_hybrid"), True),
    "seq_tp": (lambda s, mp: s.with_sequence_tp(s.default_rules(mp)), True),
    "serve_tp2d": (lambda s, mp: s.serve_tp2d_rules(mp), False),
    "seq_parallel": (lambda s, mp: s.sequence_parallel_rules(mp), True),
}
LAYERED = ("group", "encoder")


def _meshes(kind):
    names, sizes = MESHES[kind]
    duck = types.SimpleNamespace(shape=dict(zip(names, sizes)))
    return duck, MeshShape(names, sizes)


def _policies(kind, rules):
    duck, shape = _meshes(kind)
    make, fsdp = RULES[rules]
    mp = "pod" in duck.shape
    return (jsh.ShardingPolicy(duck, make(jsh, mp)),
            sh.ShardingPolicy(shape, make(sh, mp)), fsdp)


@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    return jax.eval_shape(lambda: j_lm.init_params(jax.random.PRNGKey(0),
                                                   J_ARCHS[arch]))


@functools.lru_cache(maxsize=None)
def _port_params(arch):
    return lm.init_params(0, ARCHS[arch], device="meta")


@functools.lru_cache(maxsize=None)
def _jax_cache(arch):
    return jax.eval_shape(lambda: j_lm.init_cache(J_ARCHS[arch], 16, 64,
                                                  jnp.bfloat16))


@functools.lru_cache(maxsize=None)
def _port_cache(arch):
    return lm.init_cache(ARCHS[arch], 16, 64, torch.bfloat16, device="meta")


def _jax_specs(tree, leaf=jsh.P):
    """path -> tuple(spec) of a JAX spec tree (leaves of type ``leaf``)."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, leaf))
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): tuple(spec) for path, spec in flat}


def _port_specs(tree):
    """(JAX path, per-layer?) -> the set of the port's specs there."""
    out = {}

    def add(path, spec, stack):
        parts = path.split("/")
        layered = stack is not None and parts[0].startswith(LAYERED)
        if layered:
            del parts[1]
        out.setdefault(("/".join(parts), layered), set()).add(tuple(spec))
        return spec
    sh.map_with_path(add, tree)
    return out


def _assert_same(port_tree, jax_tree, where):
    want = _jax_specs(jax_tree)
    got = _port_specs(port_tree)
    for (path, layered), specs in got.items():
        if path not in want:            # a port-only leaf (MLA's latent)
            continue
        jspec = want[path][1:] if layered else want[path]
        assert specs == {jspec}, (where, path, specs, want[path])
    missing = set(want) - {p for p, _ in got}
    assert not missing, (where, missing)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_logical_axes_equal_the_jax_packages(arch):
    want = _jax_specs(jsh.param_logical_axes(_jax_params(arch)), tuple)
    got = {}
    sh.map_with_path(lambda path, axes, stack: got.setdefault(
        path, axes), sh.param_logical_axes(_port_params(arch)))
    for path, axes in got.items():
        parts = path.split("/")
        if parts[0].startswith(LAYERED):
            del parts[1]
            assert axes == want["/".join(parts)][1:], path
        else:
            assert axes == want[path], path


def test_rule_sets_equal_the_jax_packages():
    for name, (make, _) in RULES.items():
        for mp in (False, True):
            assert make(sh, mp) == make(jsh, mp), (name, mp)


@pytest.mark.parametrize("rules", sorted(RULES))
@pytest.mark.parametrize("kind", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_specs_equal_the_jax_packages(arch, kind, rules):
    jpol, ppol, fsdp = _policies(kind, rules)
    jspecs = jsh.param_pspecs(_jax_params(arch), jpol, fsdp=fsdp)
    pspecs = sh.param_pspecs(_port_params(arch), ppol, fsdp=fsdp)
    _assert_same(pspecs, jspecs, (arch, kind, rules))
    # batch specs (tokens, targets, mask) at rows the axes do and do not
    # divide
    for B in (1, 12, 512):
        jb = {k: jax.ShapeDtypeStruct((B, 64), jnp.int32)
              for k in ("tokens", "targets", "loss_mask")}
        pb = {k: torch.empty((B, 64), dtype=torch.int32, device="meta")
              for k in jb}
        assert (sh.batch_pspecs(ppol, pb)
                == {k: tuple(v) for k, v in
                    jsh.batch_pspecs(jpol, jb).items()}), B
    # decode caches
    _assert_same(sh.cache_pspecs(ppol, _port_cache(arch)),
                 jsh.cache_pspecs(jpol, _jax_cache(arch)),
                 (arch, kind, rules, "cache"))


@pytest.mark.parametrize("arch", ["qwen2-72b", "llama3-405b"])
def test_train_state_specs_are_the_jax_trainers(arch):
    """``train_state_pspecs`` holds what the JAX ``train_step_shardings``
    builds its shardings from."""
    jpol, ppol, _ = _policies("single", "default_fsdp")
    params = _port_params(arch)
    state = {"params": params, "opt": {"m": params, "v": params},
             "step": None}
    batch = {"tokens": torch.empty((256, 64), dtype=torch.int32,
                                   device="meta")}
    got = train_state_pspecs(state, ppol, batch=batch)
    jparams = jsh.param_pspecs(_jax_params(arch), jpol, fsdp=True)
    for tree in (got["state"]["params"], got["state"]["opt"]["m"],
                 got["state"]["opt"]["v"]):
        _assert_same(tree, jparams, arch)
    assert got["state"]["opt"]["count"] == () == got["state"]["step"]
    assert got["batch"] == {"tokens": ("data", None)}
    assert got["metrics"] == {"loss": (), "grad_norm": (), "lr": ()}


@pytest.mark.parametrize("arch,kind", [("qwen2-72b", "1x4"),
                                       ("llama3-405b", "1x8")])
def test_shards_have_the_specs_local_shapes(arch, kind):
    _, shape = _meshes(kind)
    pol = sh.ShardingPolicy(shape, sh.default_rules(False, fsdp=False))
    params = _port_params(arch)
    specs = sh.param_pspecs(params, pol)
    want = sh.map_with_path(lambda path, x, stack: x, specs)
    tp = tpl.layout(ARCHS[arch], pol)
    assert tp.kv_rep == 1
    n = shape.shape["model"]
    for r in range(n):
        local = tpl.shard_params(params, ARCHS[arch], pol, model_rank=r)
        got = sh.map_with_path(lambda path, x, stack: tuple(x.shape), local)
        implied = sh.map_with_path(
            lambda path, x, stack: sh.local_shape(
                x.shape, tp._spec_at(path), shape), params)
        assert got == implied, r
        assert (tpl.local_bytes(local)
                == sh.tree_local_bytes(params, want, shape))


@pytest.mark.parametrize("kind", ["single", "multi", "coded4"])
def test_mesh_kinds_and_pod_size(kind):
    names, sizes = MESHES[kind]
    got = pmesh.mesh_shape_by_kind(kind)
    assert (got.axis_names, got.axis_sizes) == (names, sizes)
    duck = types.SimpleNamespace(axis_names=names,
                                 devices=types.SimpleNamespace(shape=sizes))
    assert pmesh.pod_size(got) == jmesh.pod_size(duck)
    assert set(pmesh.MESH_KINDS) == set(jmesh.MESH_KINDS)
    with pytest.raises(ValueError, match=f"needs {math.prod(sizes)} ranks"):
        pmesh.make_mesh_by_kind(kind, device="cpu")


def test_specs_pickle_and_compare_as_tuples():
    import pickle
    spec = sh.P(("pod", "data"), None, "model")
    assert pickle.loads(pickle.dumps(spec)) == spec
    assert spec == (("pod", "data"), None, "model")
    assert isinstance(pickle.loads(pickle.dumps(spec)), sh.PartitionSpec)
