"""The FSDP overlay's specs in the port against the JAX package's, with
the stacked ``layers`` entry: on the CPU with no ranks, all ten archs at
full width (the JAX tree by ``jax.eval_shape``, the port's on the
``meta`` device).

* Each per-layer leaf's spec, its kept ``layers`` entry first, equals the
  JAX stacked leaf's whole spec (``tests/test_torch_sharding.py`` holds
  the rest of it, without that entry): the overlay puts 'data' on the
  stack of qwen2-72b's q/k/v biases, Whisper's FFN biases and Hymba's SSM
  leaves, split by whole layers.
* A device's local bytes of the parameters (``tree_local_bytes``) equal
  the JAX specs' block bytes, on every data coordinate.
* The shards ``shard_params`` cuts have the JAX blocks' shapes, a stack
  split by layers as the non-empty per-layer leaves stacked (layers
  ``[k L/n, (k+1) L/n)`` at data coordinate k), on (data, model) = (2, 1)
  and (4, 1) for every arch and (2, 2) and (2, 4) for the dense, VLM and
  MoE families (the others raise under a model axis).  The one documented
  exception: a kv head duplicated over the model axis (KV < model) keeps
  its whole head_dim where the spec splits it.

Specs and shapes are exact: no tolerance."""
import functools
import math
import types

import jax
import pytest

from repro.configs import ARCHS as J_ARCHS
from repro.distributed import sharding as jsh
from repro.models import lm as j_lm
from repro_torch.configs import ARCHS
from repro_torch.distributed import sharding as sh
from repro_torch.distributed import tensor_parallel as tpl
from repro_torch.distributed.meshes import MeshShape
from repro_torch.models import lm

LAYERED = ("group", "encoder")
SPEC_MESHES = ((2, 1), (4, 1), (8, 1), (16, 1), (2, 2), (2, 4), (16, 16))
SHARD_MESHES = ((2, 1), (4, 1), (2, 2), (2, 4))
TP_FAMILIES = ("dense", "vlm", "moe")


@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    return jax.eval_shape(lambda: j_lm.init_params(jax.random.PRNGKey(0),
                                                   J_ARCHS[arch]))


@functools.lru_cache(maxsize=None)
def _port_params(arch):
    return lm.init_params(0, ARCHS[arch], device="meta")


def _policies(shape):
    names = ("data", "model")
    duck = types.SimpleNamespace(shape=dict(zip(names, shape)))
    return (jsh.ShardingPolicy(duck, jsh.default_rules(False)),
            sh.ShardingPolicy(MeshShape(names, shape),
                              sh.default_rules(False)))


def _jax_leaves(arch, shape):
    """JAX path -> (stacked shape, spec tuple, itemsize)."""
    jpol, _ = _policies(shape)
    params = _jax_params(arch)
    specs = jsh.param_pspecs(params, jpol, fsdp=True)
    flat_p, _ = jax.tree_util.tree_flatten_with_path(params)
    flat_s = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, jsh.P))
    out = {}
    for (path, leaf), spec in zip(flat_p, flat_s):
        key = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in path)
        out[key] = (tuple(leaf.shape), tuple(spec), leaf.dtype.itemsize)
    return out


def _jax_key(path):
    parts = path.split("/")
    if parts[0].startswith(LAYERED):
        del parts[1]
    return "/".join(parts)


def _block(shape, spec, mesh_shape):
    size = lambda m: (1 if m is None else math.prod(
        mesh_shape[a] for a in (m if isinstance(m, tuple) else (m,))))
    return tuple(d // size(m) for d, m in zip(shape, spec))


@pytest.mark.parametrize("shape", SPEC_MESHES,
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_per_layer_specs_keep_the_stacked_entry(arch, shape):
    want = _jax_leaves(arch, shape)
    _, ppol = _policies(shape)
    specs = sh.param_pspecs(_port_params(arch), ppol, fsdp=True)
    seen = set()

    def check(path, spec, stack):
        key = _jax_key(path)
        seen.add(key)
        got = tuple(spec)
        if stack is not None:
            got = (getattr(spec, "layers", None),) + got
        assert got == want[key][1], (path, got, want[key][1])
    sh.map_with_path(check, specs)
    assert seen == set(want)


@pytest.mark.parametrize("shape", SHARD_MESHES,
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_local_bytes_equal_the_jax_blocks(arch, shape):
    jleaves = _jax_leaves(arch, shape)
    mesh_shape = dict(zip(("data", "model"), shape))
    want = sum(math.prod(_block(s, spec, mesh_shape)) * size
               for s, spec, size in jleaves.values())
    _, ppol = _policies(shape)
    params = _port_params(arch)
    specs = sh.param_pspecs(params, ppol, fsdp=True)
    assert {_jax_key(p) for p, _ in _port_leaves(params)} == set(jleaves)
    for k in range(shape[0]):
        got = sh.tree_local_bytes(params, specs, ppol.mesh,
                                  {"data": k, "model": 0})
        assert got == want, (k, got, want)


def _port_leaves(tree):
    out = []
    sh.map_with_path(lambda path, x, stack: out.append((path, x)), tree)
    return out


def _shard_cases():
    for shape in SHARD_MESHES:
        for arch in sorted(ARCHS):
            if shape[1] == 1 or ARCHS[arch].family in TP_FAMILIES:
                yield arch, shape


@pytest.mark.parametrize("arch,shape", list(_shard_cases()),
                         ids=lambda v: (v if isinstance(v, str)
                                        else f"{v[0]}x{v[1]}"))
def test_shards_have_the_jax_blocks(arch, shape):
    cfg = ARCHS[arch]
    jleaves = _jax_leaves(arch, shape)
    mesh_shape = dict(zip(("data", "model"), shape))
    _, ppol = _policies(shape)
    params = _port_params(arch)
    tp = tpl.layout(cfg, ppol)
    n, m = shape
    for k in range(n):
        for r in range(m):
            local = tpl.shard_params(params, cfg, ppol, model_rank=r,
                                     data_rank=k)
            stacks = {}
            for path, x in _port_leaves(local):
                key = _jax_key(path)
                full, spec, _ = jleaves[key]
                block = _block(full, spec, mesh_shape)
                if tp.plan[path][0] == "dup":
                    # the documented exception: one whole kv head
                    assert tp.kv_rep > 1
                    block = block[:-1] + (cfg.head_dim,)
                if key == path:
                    assert tuple(x.shape) == block, (path, x.shape, block)
                    continue
                j = int(path.split("/")[1])
                stacks.setdefault(key, []).append((j, tuple(x.shape)))
                held = (spec[0] is None
                        or j // (full[0] // mesh_shape["data"]) == k)
                assert (x.numel() > 0) == held, (path, k)
            for key, rows in stacks.items():
                full, spec, _ = jleaves[key]
                block = _block(full, spec, mesh_shape)
                if tp.plan[f"{key.split('/')[0]}/0/"
                           f"{key.split('/', 1)[1]}"][0] == "dup":
                    block = block[:-1] + (cfg.head_dim,)
                held = [s for _, s in rows if math.prod(s)]
                assert len(set(held)) == 1, (key, held)
                assert (len(held),) + held[0] == block, (key, held, block)
