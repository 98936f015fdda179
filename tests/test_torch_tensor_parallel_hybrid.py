"""Tensor parallelism of the hybrid family (Hymba) on gloo ranks on the
CPU, held against the unsharded port and the JAX package (the worlds and
references of tests/tp_family_harness.py).

Reduced hymba-1.5b has 4 query heads on 1 kv head: both packages widen it
the same way (``dataclasses.replace``) to 15 query heads on 3 kv heads of
16 (inner 240), a window of 12 (shorter than the 16-token prompt, so the
ring wraps at prefill and at every decode step) and a vocabulary of 514,
which model 2 splits and model 4 does not, as Hymba-1.5B's 32,001.  The
heads split inside, as the JAX specs cut the columns: at model 2 a rank
holds 120 of the 240 inner columns (7.5 query heads, 1.5 kv heads; SSM
sub-heads of 8), at model 4 60 (3.75 and 0.75; sub-heads of 4).  Its
``wq``, ``wk``, ``wv``, ``w_in``, ``w_gate``, ``conv`` and ``conv_b`` are
split by columns, ``wo``, ``w_B``, ``w_C``, ``w_dt`` and ``w_out`` by
rows, the MLP by its FFN dim; ``dt_bias``, ``log_a``, ``d_skip``, the
branch norms and the layer norms stay whole.  The gradient tests hold
every leaf, so the sum over 'model' of B, C and dt's cotangents, the
gradient of a boundary head two ranks compute, and each whole leaf's sum
show when dropped."""
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
from repro_torch.models import lm, ssm
from repro_torch.train import optimizer as opt

ARCH = "hymba-1.5b"


def _config(archs, z3: bool = False):
    cfg = dataclasses.replace(archs[ARCH].reduced(), n_heads=15,
                              n_kv_heads=3, sliding_window=12,
                              vocab_size=514)
    return H.z3_config(cfg) if z3 else cfg


def port_config(z3: bool = False):
    from repro_torch.configs import ARCHS
    return _config(ARCHS, z3)


def _policy(mesh):
    return sh.ShardingPolicy(mesh, sh.default_rules(False, fsdp=False))


def _draw(rng, *shape):
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32))


def _step_rank(dev):
    """``ssm.ssm_step`` on (data 1, model 2): this rank's sub-heads of the
    state and its columns of the conv carry, its partial output summed
    over 'model', the new state gathered back to heads; and the forward
    logits of reduced Hymba unwidened (4 heads: the heads split whole, so
    ``dt_bias``, ``log_a`` and ``d_skip`` are split too), both beside the
    unsharded port on the same inputs."""
    cfg = port_config()
    mesh = make_process_mesh((1, 2), ("data", "model"), device=dev)
    pol = _policy(mesh)
    full = lm.init_params(5, cfg, device="cpu")["group0"][0]["ssm"]
    local = tpl.shard_params({"group0": [{"ssm": full}]}, cfg,
                             pol)["group0"][0]["ssm"]
    rng = np.random.default_rng(5)
    h, hd, N = cfg.n_heads, cfg.head_dim, cfg.ssm.state_dim
    W = cfg.ssm.conv_width
    x = _draw(rng, H.B, cfg.d_model)
    conv, state = _draw(rng, H.B, W - 1, h * hd), _draw(rng, H.B, h, N, hd)
    want, want_state = ssm.ssm_step(full, cfg, x,
                                    {"conv": conv, "ssm": state})
    out = {}
    with sh.use_policy(pol):
        tp = tpl.for_call(cfg, 1)
        blk = tp.head_block()
        # [B, h, N, hd] -> this rank's columns as [B, n_sub, N, g]
        cols = state.permute(0, 2, 1, 3).reshape(H.B, N, h * hd)
        mine = cols[..., blk.c0:blk.c1].reshape(H.B, N, blk.n_sub, blk.g)
        got, new = ssm.ssm_step(local, cfg, x, {
            "conv": conv[..., blk.c0:blk.c1].contiguous(),
            "ssm": mine.permute(0, 2, 1, 3).contiguous()}, tp=tp)
        got = tpl.reduce_from_model(got, mesh)
        st = col.all_gather(new["ssm"].permute(0, 2, 1, 3).reshape(
            H.B, N, -1), mesh, "model", 2)
        st = st.reshape(H.B, N, h, hd).permute(0, 2, 1, 3)
        carry = col.all_gather(new["conv"], mesh, "model", 2)
    out["out"] = (got, want)
    out["ssm"] = (st, want_state["ssm"])
    out["conv"] = (carry, want_state["conv"])
    narrow = get_arch(ARCH).reduced()
    params = lm.init_params(6, narrow, device="cpu")
    tokens = torch.from_numpy(rng.integers(0, narrow.vocab_size, (H.B, H.S)))
    want = lm.forward(params, narrow, tokens)[0]
    with sh.use_policy(pol):
        local = tpl.shard_params(params, narrow, pol)
        got = lm.forward(local, narrow, tokens)[0]
        kinds = {name: tpl.layout(narrow, pol).plan[
            f"group0/0/ssm/{name}"][0]
            for name in ("dt_bias", "log_a", "d_skip")}
    out["whole_heads"] = (got, want)
    out["whole_heads_kinds"] = kinds
    return out


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
        futs["step"] = pool.submit(run_ranks, _step_rank, 2,
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
    """Prefill past the window, then greedy decode steps on the ring:
    logits against the unsharded port's and the JAX package's, tokens
    equal, every rank the same bits."""
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
    """A rank's ring holds k and v at the query heads its columns touch
    (G = 1), its conv carry its columns and its SSM state its sub-heads."""
    cfg, tp = port_config(), mesh[0][1]
    hd, N = cfg.head_dim, cfg.ssm.state_dim
    cols = cfg.n_heads * hd // tp
    g = int(np.gcd(hd, cols))
    Wc = min(H.S + H.N_DEC, cfg.sliding_window)
    for r, got in enumerate(_each(sides, mesh)):
        heads = -(-(r + 1) * cols // hd) - r * cols // hd
        for layer in got["cache"]["group0"]:
            assert layer["attn"] == {"k": (H.B, Wc, heads, hd),
                                     "v": (H.B, Wc, heads, hd),
                                     "kpos": (Wc,)}
            assert layer["ssm"] == {
                "conv": (H.B, cfg.ssm.conv_width - 1, cols),
                "ssm": (H.B, cols // g, N, g)}


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
    "ssm/dt_bias", "ssm/log_a", "ssm/d_skip", "ssm/w_B", "ssm/w_C",
    "ssm/w_dt", "attn/wq", "attn/wk", "attn/wv", "bn_a", "bn_s"])
def test_split_leaf_gradient(leaf, mesh, sides):
    """Each leaf whose gradient needs a sum over 'model': the whole
    per-head vectors read at a rank's sub-heads, the row-split B, C and dt
    (each rank reads other heads of their sum), q, k and v (a boundary
    head's gradient is two ranks' parts) and the branch norms (under
    sequence TP each rank norms its block)."""
    idx = [i for i, p in enumerate(_paths()) if p.endswith(leaf)]
    assert len(idx) == 2                                  # both layers
    pick = lambda grads: [grads[i] for i in idx]
    for got in _each(sides, mesh):
        assert H.grads_close(pick(got["grads"]), pick(sides[1]["grads"]),
                             pick(sides[2]["grads"]))


@pytest.mark.parametrize("mesh", H.MESHES, ids=H.mesh_id)
def test_weight_bytes_equal_the_specs(mesh, sides):
    """A rank's bytes equal ``tree_local_bytes`` of the specs: every leaf
    is the specs' block, none duplicated over 'model'."""
    for got in _each(sides, mesh):
        assert got["bytes"][0] == got["bytes"][1]


@pytest.mark.parametrize("mesh", H.MESHES, ids=H.mesh_id)
def test_shards_round_trip_bit_for_bit(mesh, sides):
    assert all(got["round_trip"] for got in _each(sides, mesh))


@pytest.mark.parametrize("key", ["out", "ssm", "conv"])
def test_ssm_step_under_tp(key, sides):
    """The single-token SSM step on this rank's columns: its output summed
    over 'model', its new state's sub-heads and conv columns gathered,
    against the unsharded step."""
    for res in sides[0]["step"]:
        got, want = res[key]
        assert H.worst([got.numpy()], [want.numpy()]) <= H.LOGIT_TOL


def test_heads_that_split_whole(sides):
    """Reduced Hymba unwidened (4 heads, 1 kv head of 16) at model 2: the
    query heads split whole, so the per-head vectors are split by heads;
    the kv head splits inside.  The forward logits equal the unsharded
    port's."""
    for res in sides[0]["step"]:
        got, want = res["whole_heads"]
        assert H.worst([got.numpy()], [want.numpy()]) <= H.LOGIT_TOL
        assert res["whole_heads_kinds"] == dict.fromkeys(
            ("dt_bias", "log_a", "d_skip"), "model")


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
    """The split leaves by the JAX rules (``sharding.py``'s attention, SSM
    and MLP rows): nothing duplicated, the per-head vectors and norms
    whole where the model axis does not divide the 15 heads."""
    cfg = port_config()
    pol = sh.ShardingPolicy(MeshShape(("data", "model"), (1, model)),
                            sh.default_rules(False, fsdp=False))
    tp = tpl.layout(cfg, pol)
    assert tp.inside and tp.kv_rep == 1
    plan = {k[len("group0/0/"):]: v for k, v in tp.plan.items()
            if k.startswith("group0/0/")}
    for name in ("attn/wq", "attn/wk", "attn/wv", "ssm/w_in", "ssm/w_gate",
                 "ssm/conv", "mlp/w1", "mlp/w3"):
        assert plan[name] == ("model", 1)
    for name in ("attn/wo", "ssm/conv_b", "ssm/w_B", "ssm/w_C", "ssm/w_dt",
                 "ssm/w_out", "mlp/w2"):
        assert plan[name] == ("model", 0)
    for name in ("ssm/dt_bias", "ssm/log_a", "ssm/d_skip", "ln1", "ln2",
                 "bn_a", "bn_s"):
        assert plan[name] == ("rep", None)
    assert tp.plan["embed"] == (("model", 0) if cfg.vocab_size % model == 0
                                else ("rep", None))


@pytest.mark.parametrize("model,blocks", [
    (4, [(0, 400, 0, 7, 0, 2), (400, 800, 6, 13, 1, 3),
         (800, 1200, 12, 19, 2, 4), (1200, 1600, 18, 25, 3, 5)]),
    (2, [(0, 800, 0, 13, 0, 3), (800, 1600, 12, 25, 2, 5)])])
def test_head_block_of_hymba_1_5b(model, blocks):
    """Hymba-1.5B's 25 heads of 64 on 5 kv heads: at model 4 a rank holds
    400 inner columns, the 7 query heads they touch (the boundary heads 6,
    12 and 18 on two ranks each), the 2 kv heads those read, and SSM
    sub-heads of g = gcd(64, 400) = 16 (25 a rank); at model 2 800
    columns, 13 heads, 3 kv heads and sub-heads of 32."""
    cfg = get_arch(ARCH)
    pol = sh.ShardingPolicy(MeshShape(("data", "model"), (1, model)),
                            sh.default_rules(False))
    tp = tpl.layout(cfg, pol)
    for r, (c0, c1, h0, h1, kv0, kv1) in enumerate(blocks):
        blk = tp.head_block(r)
        assert (blk.c0, blk.c1, blk.h0, blk.h1, blk.kv0, blk.kv1) == \
            (c0, c1, h0, h1, kv0, kv1)
        assert set(blk.kv_of_heads()) == set(range(kv0, kv1))
        assert blk.g == (16 if model == 4 else 32)
        assert blk.n_sub == 25
        subs = blk.sub_heads()
        assert subs[0] == h0 and subs[-1] == h1 - 1
        assert subs == tuple(sorted(subs))


@pytest.mark.parametrize("shape", [(1, 4), (2, 2), (2, 4)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_shards_are_the_specs_blocks_at_full_width(shape):
    """Hymba-1.5B under ``default_rules`` (the FSDP overlay on 'data'
    after the model-axis cut): each rank's shard of every leaf has the
    shape its spec gives, and its bytes are ``sharding.tree_local_bytes``
    of the specs; at (1, 4) the vocabulary (32,001 = 3 x 10,667) and the
    per-head vectors stay whole."""
    cfg = get_arch(ARCH)
    mesh = MeshShape(("data", "model"), shape)
    pol = sh.ShardingPolicy(mesh, sh.default_rules(False))
    meta = lm.init_params(0, cfg, device="meta")
    specs = sh.param_pspecs(meta, pol, fsdp=True)
    for k in range(shape[0]):
        coords = {"data": k, "model": 2 % shape[1]}
        local = tpl.shard_params(meta, cfg, pol, model_rank=coords["model"],
                                 data_rank=k)
        for x, full, spec in zip(opt.tree_leaves(local),
                                 opt.tree_leaves(meta),
                                 sh.spec_leaves(specs)):
            assert tuple(x.shape) == sh.local_shape(full.shape, spec, mesh,
                                                    coords)
        assert tpl.local_bytes(local) == sh.tree_local_bytes(
            meta, specs, mesh, coords)
    if shape != (1, 4):
        return
    layer = local["group0"][0]
    assert tuple(layer["attn"]["wq"].shape) == (1600, 400)
    assert tuple(layer["attn"]["wk"].shape) == (1600, 80)
    assert tuple(layer["ssm"]["w_B"].shape) == (400, 400)
    assert tuple(layer["ssm"]["w_dt"].shape) == (400, 25)
    assert tuple(layer["ssm"]["dt_bias"].shape) == (25,)
    assert tuple(layer["mlp"]["w1"].shape) == (1600, 1376)
    assert tuple(local["embed"].shape) == (32001, 1600)


@pytest.mark.parametrize("geometry", [
    {"n_heads": 3, "n_kv_heads": 3, "head_dim": 6},
    {"n_heads": 4, "n_kv_heads": 1, "head_dim": 6}])
def test_columns_the_specs_do_not_split_raise(geometry):
    """A geometry whose inner (3 x 6 = 18) or kv width (6) model 4 does
    not divide: the specs leave those leaves whole, and the layout raises
    through the ROADMAP's queue, not the whole-head check."""
    cfg = dataclasses.replace(get_arch(ARCH).reduced(), **geometry)
    pol = sh.ShardingPolicy(MeshShape(("data", "model"), (1, 4)),
                            sh.default_rules(False))
    with pytest.raises(NotImplementedError, match="ROADMAP.md") as err:
        tpl.layout(cfg, pol)
    assert "columns the specs do not split" in str(err.value)


def test_init_shard_params_is_init_params_cut():
    """Each rank's leaves drawn one layer at a time equal the full draw's
    shards, bit for bit (the card draws Hymba-1.5B so)."""
    cfg = port_config()
    pol = sh.ShardingPolicy(MeshShape(("data", "model"), (1, 4)),
                            sh.default_rules(False))
    full = lm.init_params(7, cfg, device="cpu")
    for r in range(4):
        want = tpl.shard_params(full, cfg, pol, model_rank=r)
        got = tpl.init_shard_params(7, cfg, pol, device="cpu", model_rank=r)
        assert all(torch.equal(a, b) for a, b in zip(
            opt.tree_leaves(got), opt.tree_leaves(want))), r


def test_kernel_routes_at_the_local_heads():
    """Hymba-1.5B at model 4 gives each rank 7 query heads at G = 1 (hd
    64): bf16 prefill takes the tensor cores, fp32 the TF32 mma route, a
    decode step split-kv; its SSM scans 25 sub-heads of 16 columns on a
    state of 16: ``chunk_f32`` at prefill, the WKV op's step kernel at a
    decode step and its chunked backward under autograd (chip_smoke.py
    phase 10 (i) launches them)."""
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.rwkv_scan import backward as rwb
    from repro_torch.kernels.rwkv_scan import ops as rw
    cfg = get_arch(ARCH)
    pol = sh.ShardingPolicy(MeshShape(("data", "model"), (1, 4)),
                            sh.default_rules(False))
    blk = tpl.layout(cfg, pol).head_block(1)
    n, hd, N = blk.n_heads, cfg.head_dim, cfg.ssm.state_dim
    assert (n, blk.n_sub, blk.g) == (7, 25, 16)
    assert fa.route(torch.bfloat16, 1024, n, n, hd, True,
                    cfg.sliding_window) == "tensor_core"
    assert fa.route(torch.float32, 2560, n, n, hd, True,
                    cfg.sliding_window) == "mma_tf32"
    assert fa.route(torch.bfloat16, 1, n, n, hd, True) == "split_kv"
    assert rw.route(torch.float32, 1024, N, blk.g) == "chunk_f32"
    assert rw.route(torch.float32, 1, N, blk.g) == "step"
    assert rwb.route(torch.float32, 2048, N, blk.g) == "chunk"
