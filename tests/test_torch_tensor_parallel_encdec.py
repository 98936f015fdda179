"""Tensor parallelism of the enc-dec family on gloo ranks on the CPU, held
against the unsharded port and the JAX package (the worlds and references
of tests/tp_family_harness.py).

Reduced whisper-large-v3 has 5 heads, which split neither 2 nor 4: both
packages widen it the same way (``dataclasses.replace``) to 8 query and 8
kv heads of 16, and to a vocabulary of 514 (2 x 257), which model 2
splits and model 4 does not, as Whisper's 51,866 (2 x 25,933): at model 4
the embedding and the head stay whole on every rank, as their specs say.
Under a model axis a rank holds its heads of the encoder's and the
decoder's self and cross attention (``wq``, ``wk``, ``wv`` and their
biases by columns, ``wo`` by rows) and its block of the GELU MLP (``w1``
and ``b1`` by columns, ``w2`` by rows; ``b2`` whole, added once after the
sum); the frames and the encoder output are whole on every rank, and
the cross cache holds this rank's heads."""
import concurrent.futures
import dataclasses

import numpy as np
import pytest
import torch

import tp_family_harness as H
from repro_torch.configs import get_arch
from repro_torch.distributed import sharding as sh
from repro_torch.distributed import tensor_parallel as tpl
from repro_torch.distributed.launch import run_ranks
from repro_torch.distributed.meshes import MeshShape
from repro_torch.models import lm
from repro_torch.train import optimizer as opt

ARCH = "whisper-large-v3"


def _config(archs, z3: bool = False):
    cfg = dataclasses.replace(archs[ARCH].reduced(), n_heads=8,
                              n_kv_heads=8, vocab_size=514)
    return H.z3_config(cfg) if z3 else cfg


def port_config(z3: bool = False):
    from repro_torch.configs import ARCHS
    return _config(ARCHS, z3)


@pytest.fixture(scope="module")
def sides():
    """(the ranks' results by mesh shape, the unsharded port's, the JAX
    package's): the worlds run while this process computes the
    references."""
    from repro.configs import ARCHS as J_ARCHS
    jcfg, z_jcfg = _config(J_ARCHS), _config(J_ARCHS, True)
    cfg, z_cfg = port_config(), port_config(True)
    jp, data = H.jax_draw(jcfg, z_jcfg, cfg, z_cfg, 0)
    with concurrent.futures.ThreadPoolExecutor(len(H.SHAPES)) as pool:
        futs = {shape: pool.submit(run_ranks, H.rank, shape[0] * shape[1],
                                   backend="gloo", device="cpu",
                                   args=(shape, data, port_config),
                                   timeout_s=500)
                for shape in H.SHAPES}
        ref = H.jax_refs(jp, jcfg, z_jcfg, cfg, z_cfg, data)
        port = H.port_side(cfg, z_cfg, data)
        ranks = {shape: f.result() for shape, f in futs.items()}
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
    """Prefill (the encoder, every layer's cross keys, the prompt) then
    greedy decode steps: logits against the unsharded port's and the JAX
    package's, tokens equal, every rank the same bits."""
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
    """``ServeEngine.generate`` with ``enc_frames`` under the model axis
    gives the unsharded engine's greedy tokens, on every rank."""
    want = sides[1]["generate"]
    assert np.array_equal(want, sides[1]["tokens"].numpy().T)
    for got in _each(sides, mesh):
        assert np.array_equal(got["generate"], want)


@pytest.mark.parametrize("mesh", H.MESHES, ids=H.mesh_id)
def test_cache_shapes(mesh, sides):
    """A rank's self and cross caches hold its KV/tp heads."""
    cfg, tp = port_config(), mesh[0][1]
    kv, hd = cfg.n_kv_heads // tp, cfg.head_dim
    for got in _each(sides, mesh):
        for layer in got["cache"]["group0"]:
            for name in ("k", "v"):
                assert layer["self"][name] == (H.B, H.S + H.N_DEC, kv, hd)
                assert layer["cross"][name] == (H.B, cfg.encoder_seq, kv,
                                                 hd)


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
    "mlp/b1", "mlp/b2", "xattn/wk", "xattn/wq", "ln3/b", "enc_norm/w",
    "embed", "lm_head"])
def test_leaf_gradient(leaf, mesh, sides):
    """The GELU MLP's biases (``b2`` added once after the sum), the cross
    attention's keys (every decoder layer's read the one encoder output,
    whose gradient sums over 'model' once), the norms, and the embedding
    and head (split at model 2, whole at model 4)."""
    idx = [i for i, p in enumerate(_paths()) if p.endswith(leaf)]
    assert idx
    pick = lambda grads: [grads[i] for i in idx]
    for got in _each(sides, mesh):
        assert H.grads_close(pick(got["grads"]), pick(sides[1]["grads"]),
                             pick(sides[2]["grads"]))


@pytest.mark.parametrize("mesh", H.MESHES, ids=H.mesh_id)
def test_weight_bytes_equal_the_specs(mesh, sides):
    for got in _each(sides, mesh):
        assert got["bytes"][0] == got["bytes"][1]


@pytest.mark.parametrize("mesh", H.MESHES, ids=H.mesh_id)
def test_shards_round_trip_bit_for_bit(mesh, sides):
    assert all(got["round_trip"] for got in _each(sides, mesh))


def test_zero3_adamw_step(sides):
    """One AdamW step under ZeRO-3 composed with TP on (data 2, model 2):
    the loss and norm against the unsharded full-batch step, the gathered
    gradient against the port's and the JAX gradient, the updated
    parameters against the unsharded AdamW fed that gradient, and a rank's
    state bytes against ``train_state_pspecs``."""
    ranks = sides[0][H.Z3_SHAPE]
    want = sides[1]["step"]
    before = want["before"]
    first = ranks[0]["step"]
    assert "dim" in first["zkinds"]
    for res in ranks:
        got = res["step"]
        for loss in (want["loss"], sides[2]["step"]["loss"]):
            assert abs(got["loss"] - loss) <= H.LOSS_TOL * abs(loss)
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
    and TP on (2, 2) against the unsharded port's update, and against the
    JAX package's where the gradient is not zero up to rounding (as
    tests/test_torch_zero3.py holds Whisper: Adafactor divides a key
    bias's rounding by its own RMS)."""
    ref = sides[2]["step"]
    top = max(float(np.abs(g).max()) for g in ref["grads"])
    real = [float(np.abs(g).max()) >= H.FLOOR * top for g in ref["grads"]]
    for res in sides[0][H.Z3_SHAPE]:
        got = [p.numpy() for p in res["adafactor"]]
        assert H.worst(got, [p.numpy() for p in sides[1]["adafactor"]]
                       ) <= H.PARAM_TOL
        assert H.worst([a for a, r in zip(got, real) if r],
                       [b for b, r in zip(ref["adafactor"], real) if r]
                       ) <= H.PARAM_TOL


@pytest.mark.parametrize("model,vocab", [(2, True), (4, False)])
def test_layout(model, vocab):
    """The split leaves by the JAX rules; ``xattn/wk`` is never taken for a
    duplicated kv shard; the vocabulary splits only where the axis
    divides it."""
    cfg = port_config()
    pol = sh.ShardingPolicy(MeshShape(("data", "model"), (1, model)),
                            sh.default_rules(False, fsdp=False))
    tp = tpl.layout(cfg, pol)
    assert tp.vocab == vocab
    assert tp.plan["embed"] == (("model", 0) if vocab else ("rep", None))
    assert tp.plan["lm_head"] == (("model", 1) if vocab else ("rep", None))
    for stack, attns in (("encoder", ("attn",)),
                         ("group0", ("attn", "xattn"))):
        plan = {k[len(stack) + 3:]: v for k, v in tp.plan.items()
                if k.startswith(f"{stack}/0/")}
        for a in attns:
            for name in ("wq", "wk", "wv"):
                assert plan[f"{a}/{name}"] == ("model", 1)
            for name in ("bq", "bk", "bv", "wo"):
                assert plan[f"{a}/{name}"] == ("model", 0)
        assert plan["mlp/w1"] == ("model", 1)
        assert plan["mlp/b1"] == plan["mlp/w2"] == ("model", 0)
        assert plan["mlp/b2"] == plan["ln1/w"] == ("rep", None)


def test_init_shard_params_is_init_params_cut():
    cfg = port_config()
    pol = sh.ShardingPolicy(MeshShape(("data", "model"), (1, 4)),
                            sh.default_rules(False))
    full = lm.init_params(7, cfg, device="cpu")
    for r in range(4):
        want = tpl.shard_params(full, cfg, pol, model_rank=r)
        got = tpl.init_shard_params(7, cfg, pol, device="cpu", model_rank=r)
        assert all(torch.equal(a, b) for a, b in zip(
            opt.tree_leaves(got), opt.tree_leaves(want))), r


def test_flash_route_at_the_local_heads():
    """Whisper-large-v3 at model 4 gives each rank 5 of its 20 heads of
    64, its vocabulary of 51,866 stays whole: the encoder's bf16
    self-attention over 1,500 frames and the cross prefill take the
    tensor-core route, a decode step split-kv, fp32 the TF32 mma route
    (chip_smoke.py phase 10 (h) launches them)."""
    from repro_torch.kernels.flash_attention import ops as fa
    cfg = get_arch(ARCH)
    pol = sh.ShardingPolicy(MeshShape(("data", "model"), (1, 4)),
                            sh.default_rules(False))
    tp = tpl.layout(cfg, pol)
    assert not tp.vocab
    p = tpl.shard_params(lm.init_params(0, cfg, device="meta"), cfg, pol,
                         model_rank=2)["group0"][0]["xattn"]
    H_ = p["wq"].shape[1] // cfg.head_dim
    assert H_ == p["wk"].shape[1] // cfg.head_dim == 5
    assert fa.route(torch.bfloat16, 1500, H_, H_, 64, True) == \
        "tensor_core"
    assert fa.route(torch.bfloat16, 1024, H_, H_, 64, True) == \
        "tensor_core"
    assert fa.route(torch.bfloat16, 1, H_, H_, 64, True) == "split_kv"
    assert fa.route(torch.float32, 256, H_, H_, 64, True) == "mma_tf32"
