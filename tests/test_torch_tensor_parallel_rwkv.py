"""Tensor parallelism of the RWKV family on gloo ranks on the CPU, held
against the unsharded port and the JAX package (the worlds and references
of tests/tp_family_harness.py).

Reduced rwkv6-3b: 4 WKV heads of 16, d 64, two layers.  Under a model
axis a rank holds h/tp whole heads of ``tmix`` (``wr``, ``wk``, ``wv``,
``wg`` by columns, ``wo`` by rows, ``u`` by heads) and its block of the
channel-mix FFN (``cmix/wk`` by columns, ``cmix/wv`` by rows, ``cmix/wr``
by columns); the DDLerp, the decay LoRA, ``w0``, the GroupNorm, the lerps
and the layer norms stay whole.  The gradient tests hold every leaf,
so each of the sums a whole weight needs (the decay LoRA, ``gn_w`` /
``gn_b``, the DDLerp streams) and the channel-mix reduction before its
product show as a gradient or logit error when dropped.  The WKV state a
rank holds is its heads ``[B, h/tp, hd, hd]`` (the JAX ``cache_pspecs``
splits the head dim instead: a deliberate difference of layout); the two
shift states stay whole."""
import concurrent.futures
import dataclasses

import numpy as np
import pytest
import torch

import tp_family_harness as H
from repro_torch.configs import get_arch
from repro_torch.distributed import collectives as col
from repro_torch.distributed import sharding as sh
from repro_torch.distributed import tensor_parallel as tpl
from repro_torch.distributed.launch import run_ranks
from repro_torch.distributed.meshes import MeshShape, make_process_mesh
from repro_torch.models import lm, rwkv
from repro_torch.train import optimizer as opt

ARCH = "rwkv6-3b"


def _config(archs, z3: bool = False):
    cfg = archs[ARCH].reduced()
    return H.z3_config(cfg) if z3 else cfg


def port_config(z3: bool = False):
    from repro_torch.configs import ARCHS
    return _config(ARCHS, z3)


def _tmix_step_rank(dev):
    """``rwkv.tmix_step`` on (data 1, model 2): this rank's heads of the
    WKV state, its partial output summed over 'model', the new state's
    heads gathered; beside the unsharded step on the same inputs."""
    cfg = port_config()
    mesh = make_process_mesh((1, 2), ("data", "model"), device=dev)
    pol = sh.ShardingPolicy(mesh, sh.default_rules(False, fsdp=False))
    full = lm.init_params(5, cfg, device="cpu")["group0"][0]["tmix"]
    local = tpl.shard_params({"group0": [{"tmix": full}]}, cfg, pol)
    rng = np.random.default_rng(5)
    draw = lambda *shape: torch.from_numpy(
        rng.normal(size=shape).astype(np.float32))
    h, hd = cfg.n_heads, cfg.head_dim
    x, shift, wkv = draw(H.B, cfg.d_model), draw(H.B, cfg.d_model), \
        draw(H.B, h, hd, hd)
    want, want_state = rwkv.tmix_step(full, cfg, x,
                                      {"shift": shift, "wkv": wkv})
    with sh.use_policy(pol):
        tp = tpl.for_call(cfg, 1)
        mine = tpl._block(wkv, mesh, 1)
        out, new = rwkv.tmix_step(local["group0"][0]["tmix"], cfg, x,
                                  {"shift": shift, "wkv": mine}, tp=tp)
        out = tpl.reduce_from_model(out, mesh)
        state = col.all_gather(new["wkv"], mesh, "model", 1)
    return {"out": (out, want), "wkv": (state, want_state["wkv"]),
            "shift": (new["shift"], want_state["shift"])}


@pytest.fixture(scope="module")
def sides():
    """(the ranks' results by mesh shape, the unsharded port's, the JAX
    package's): the worlds run while this process computes the
    references."""
    from repro.configs import ARCHS as J_ARCHS
    jcfg, z_jcfg = _config(J_ARCHS), _config(J_ARCHS, True)
    cfg, z_cfg = port_config(), port_config(True)
    jp, data = H.jax_draw(jcfg, z_jcfg, cfg, z_cfg, 0)
    with concurrent.futures.ThreadPoolExecutor(len(H.SHAPES) + 1) as pool:
        futs = {shape: pool.submit(run_ranks, H.rank, shape[0] * shape[1],
                                   backend="gloo", device="cpu",
                                   args=(shape, data, port_config),
                                   timeout_s=500)
                for shape in H.SHAPES}
        futs["tmix_step"] = pool.submit(run_ranks, _tmix_step_rank, 2,
                                        backend="gloo", device="cpu",
                                        timeout_s=500)
        ref = H.jax_refs(jp, jcfg, z_jcfg, cfg, z_cfg, data)
        port = H.port_side(cfg, z_cfg, data)
        ranks = {key: f.result() for key, f in futs.items()}
    return ranks, port, ref


def _each(sides, mesh):
    shape, seq = mesh
    return [res[seq] for res in sides[0][shape]]


@pytest.mark.parametrize("mesh", H.MESHES, ids=H.mesh_id)
def test_forward_logits(mesh, sides):
    for want in (sides[1]["logits"].numpy(), sides[2]["logits"]):
        for got in _each(sides, mesh):
            assert got["logits"].shape == want.shape
            assert H.worst([got["logits"].numpy()], [want]) <= H.LOGIT_TOL


@pytest.mark.parametrize("mesh", H.MESHES, ids=H.mesh_id)
def test_prefill_and_decode(mesh, sides):
    """Prefill then greedy decode steps: logits against the unsharded
    port's and the JAX package's, tokens equal, every rank the same
    bits."""
    ranks = _each(sides, mesh)
    for want in (sides[1], sides[2]):
        steps = np.asarray(want["steps"])
        for got in ranks:
            assert H.worst([got["steps"].numpy()], [steps]) <= H.LOGIT_TOL
            assert np.array_equal(got["tokens"].numpy(),
                                  np.asarray(want["tokens"]))
            assert torch.equal(got["steps"], ranks[0]["steps"])


@pytest.mark.parametrize("mesh", H.MESHES, ids=H.mesh_id)
def test_generate_tokens(mesh, sides):
    want = sides[1]["generate"]
    assert np.array_equal(want, sides[1]["tokens"].numpy().T)
    for got in _each(sides, mesh):
        assert np.array_equal(got["generate"], want)


@pytest.mark.parametrize("mesh", H.MESHES, ids=H.mesh_id)
def test_decode_state_shapes(mesh, sides):
    """A rank's WKV state holds its h/tp heads; the time-mix and
    channel-mix shift states are whole."""
    cfg, tp = port_config(), mesh[0][1]
    h, hd, D = cfg.n_heads, cfg.head_dim, cfg.d_model
    for got in _each(sides, mesh):
        for layer in got["cache"]["group0"]:
            assert layer["tmix"]["wkv"] == (H.B, h // tp, hd, hd)
            assert layer["tmix"]["shift"] == (H.B, D)
            assert layer["cmix_shift"] == (H.B, D)


@pytest.mark.parametrize("mesh", H.MESHES, ids=H.mesh_id)
def test_loss_and_gradients(mesh, sides):
    for got in _each(sides, mesh):
        for want in (sides[1], sides[2]):
            assert abs(got["loss"] - want["loss"]) <= H.LOSS_TOL * abs(
                want["loss"])
        assert H.grads_close(got["grads"], sides[1]["grads"],
                             sides[2]["grads"])


def _paths():
    return opt.tree_leaves(sh.map_with_path(
        lambda path, leaf, _: path, lm.init_params(0, port_config(),
                                                   device="meta")))


@pytest.mark.parametrize("mesh", H.MESHES, ids=H.mesh_id)
@pytest.mark.parametrize("leaf", [
    "tmix/w_lora_a", "tmix/w_lora_b", "tmix/w0", "tmix/gn_w", "tmix/gn_b",
    "tmix/mu_x", "tmix/mu", "tmix/maa_w1", "tmix/maa_w2", "cmix/mu_k",
    "cmix/mu_r", "cmix/wv"])
def test_whole_leaf_gradient(leaf, mesh, sides):
    """Each whole leaf that feeds a split computation, and the channel-mix
    value read through its reduction: a rank reads only its heads' part
    of each, so each gradient is a sum over 'model'."""
    idx = [i for i, p in enumerate(_paths()) if p.endswith(leaf)]
    assert len(idx) == 2                                  # both layers
    pick = lambda grads: [grads[i] for i in idx]
    for got in _each(sides, mesh):
        assert H.grads_close(pick(got["grads"]), pick(sides[1]["grads"]),
                             pick(sides[2]["grads"]))


@pytest.mark.parametrize("mesh", H.MESHES, ids=H.mesh_id)
def test_weight_bytes_equal_the_specs(mesh, sides):
    """A rank's bytes equal ``tree_local_bytes`` of the specs (no leaf is
    duplicated over 'model'; the WKV state's layout is the cache's, not a
    weight's)."""
    for got in _each(sides, mesh):
        assert got["bytes"][0] == got["bytes"][1]


@pytest.mark.parametrize("mesh", H.MESHES, ids=H.mesh_id)
def test_shards_round_trip_bit_for_bit(mesh, sides):
    assert all(got["round_trip"] for got in _each(sides, mesh))


@pytest.mark.parametrize("key", ["out", "wkv", "shift"])
def test_tmix_step_under_tp(key, sides):
    """The single-token time-mix step on this rank's heads: its output
    summed over 'model', its new state's heads gathered, and its shift
    (whole) against the unsharded step."""
    for res in sides[0]["tmix_step"]:
        got, want = res[key]
        assert H.worst([got.numpy()], [want.numpy()]) <= H.LOGIT_TOL


def test_zero3_adamw_step(sides):
    """One AdamW step under ZeRO-3 composed with TP on (data 2, model 2):
    the loss and norm against the unsharded full-batch step, the gathered
    gradient against the JAX gradient and the port's, the updated
    parameters against the unsharded AdamW fed that gradient, and a rank's
    state bytes against ``train_state_pspecs``."""
    ranks = sides[0][H.Z3_SHAPE]
    want = sides[1]["step"]
    before = want["before"]
    first = ranks[0]["step"]
    assert "dim" in first["zkinds"]
    for res in ranks:
        got = res["step"]
        assert abs(got["loss"] - want["loss"]) <= H.LOSS_TOL * abs(
            want["loss"])
        assert abs(got["loss"] - sides[2]["step"]["loss"]) <= \
            H.LOSS_TOL * abs(want["loss"])
        assert abs(got["grad_norm"] - want["grad_norm"]) <= \
            H.LOSS_TOL * abs(want["grad_norm"])
        assert H.grads_close(got["grads"], want["grads"],
                             sides[2]["step"]["grads"])
        tree = lambda xs: opt.tree_unflatten(before, xs)
        upd, _, _ = opt.adamw_update(tree(got["grads"]),
                                     opt.init_opt_state(before, H.TC.opt),
                                     before, H.TC.opt)
        assert H.worst([p.numpy() for p in got["params"]],
                       [p.numpy() for p in opt.tree_leaves(upd)]
                       ) <= H.PARAM_TOL
        assert got["bytes"]["held"] == got["bytes"]["specs"]
        assert got["bytes"]["duplicated"] == 0
        assert all(torch.equal(a, b) for a, b in zip(got["params"],
                                                     first["params"]))


def test_zero3_adafactor_step(sides):
    """Two Adafactor steps on the shards of the JAX gradient under ZeRO-3
    and TP on (2, 2) against the unsharded port's and the JAX package's
    update."""
    for res in sides[0][H.Z3_SHAPE]:
        got = [p.numpy() for p in res["adafactor"]]
        assert H.worst(got, [p.numpy() for p in sides[1]["adafactor"]]
                       ) <= H.PARAM_TOL
        assert H.worst(got, sides[2]["step"]["adafactor"]) <= H.PARAM_TOL


@pytest.mark.parametrize("model", [2, 4])
def test_layout(model):
    """The split leaves by the JAX rules (``sharding.py``'s RWKV rows);
    ``tmix/wk`` is never taken for a duplicated kv shard."""
    cfg = port_config()
    pol = sh.ShardingPolicy(MeshShape(("data", "model"), (1, model)),
                            sh.default_rules(False, fsdp=False))
    tp = tpl.layout(cfg, pol)
    plan = {k[len("group0/0/"):]: v for k, v in tp.plan.items()
            if k.startswith("group0/0/")}
    for name in ("tmix/wr", "tmix/wk", "tmix/wv", "tmix/wg", "cmix/wk",
                 "cmix/wr"):
        assert plan[name] == ("model", 1)
    for name in ("tmix/wo", "tmix/u", "cmix/wv"):
        assert plan[name] == ("model", 0)
    for name in ("mu_x", "mu", "maa_w1", "maa_w2", "w0", "w_lora_a",
                 "w_lora_b", "gn_w", "gn_b"):
        assert plan[f"tmix/{name}"] == ("rep", None)
    for name in ("cmix/mu_k", "cmix/mu_r", "ln1/w", "ln1/b", "ln2/w",
                 "ln2/b"):
        assert plan[name] == ("rep", None)
    # at 8 ranks the reduced 4 kv heads would duplicate attention's kv
    # shards; RWKV's wk stays a column split (its heads do not split 8)
    wide = dataclasses.replace(cfg, n_heads=8, n_kv_heads=2, head_dim=8)
    tp8 = tpl.layout(wide, sh.ShardingPolicy(
        MeshShape(("data", "model"), (1, 4)),
        sh.default_rules(False, fsdp=False)))
    assert tp8.kv_rep == 2
    assert tp8.plan["group0/0/tmix/wk"] == ("model", 1)


def test_init_shard_params_is_init_params_cut():
    """Each rank's leaves drawn one layer at a time equal the full draw's
    shards, bit for bit (the card draws RWKV6-3B so)."""
    cfg = port_config()
    pol = sh.ShardingPolicy(MeshShape(("data", "model"), (1, 4)),
                            sh.default_rules(False))
    full = lm.init_params(7, cfg, device="cpu")
    for r in range(4):
        want = tpl.shard_params(full, cfg, pol, model_rank=r)
        got = tpl.init_shard_params(7, cfg, pol, device="cpu", model_rank=r)
        assert all(torch.equal(a, b) for a, b in zip(
            opt.tree_leaves(got), opt.tree_leaves(want))), r


def test_wkv_route_at_the_local_heads():
    """RWKV6-3B at model 4 gives each rank 10 of its 40 heads of 64: bf16
    prefill takes the tensor-core route, fp32 and a decode step the step
    kernel (chip_smoke.py phase 10 (g) launches them), on operands laid
    out as they come: ``(xr @ wr).reshape(B, S, 10, 64)`` is contiguous
    and ``u`` is this rank's rows."""
    from repro_torch.kernels.rwkv_scan import ops as rw
    cfg = get_arch(ARCH)
    pol = sh.ShardingPolicy(MeshShape(("data", "model"), (1, 4)),
                            sh.default_rules(False))
    p = tpl.shard_params(lm.init_params(0, cfg, device="meta"), cfg, pol,
                         model_rank=1)["group0"][0]["tmix"]
    assert tuple(p["u"].shape) == (10, 64) and p["u"].is_contiguous()
    x = torch.empty((2, 8, cfg.d_model), device="meta")
    r = (x @ p["wr"]).reshape(2, 8, 10, 64)
    assert r.is_contiguous()
    assert rw.route(torch.bfloat16, 1024, 64, 64) == "tensor_core"
    assert rw.route(torch.bfloat16, 1, 64, 64) == "step"
    assert rw.route(torch.float32, 256, 64, 64) == "step"
