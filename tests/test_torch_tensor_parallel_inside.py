"""Heads that split inside for the dense, VLM, enc-dec and RWKV families,
on gloo ranks on the CPU, held against the unsharded port and the JAX
package (the model run and references of tests/tp_family_harness.py).

Each arch's ``reduced()`` is widened the same way on both sides
(``dataclasses.replace``) so that the model axis cuts a head: qwen2-1.5b
and llava-next-34b (with its patch prefix) at 6 query heads on 2 kv heads
of 16, so model 4 gives a rank 24 query columns (1.5 heads, all on one kv
head) and 8 kv columns (half a kv head); whisper-large-v3 at its reduced 5
heads of 16, cut at model 2 (2.5 heads a rank) and 4 (1.25); rwkv6-3b at 6
WKV heads of 16 (d_model 96), 1.5 a rank at model 4.  A rank gathers q, k
and v (RWKV: r, k, v and the decay) along the feature dim, runs the heads
its columns touch (attention over the kv heads they read; RWKV's scan and
GroupNorm over whole heads), keeps its columns and multiplies them by its
rows of ``wo``.  Two worlds, (data 1, model 4) and (1, 2), spawned side by
side once for the module, each under the plain rules and under sequence
TP: forward logits, prefill and greedy decode, ``generate``, the decode
state's shapes, the loss and every gradient leaf (in fp32, and run
float64 throughout against the unsharded port's float64 run), a rank's
weight bytes against the specs, the shards' round trip, and one AdamW
step.

The layouts of the four full-size archs at (data 16, model 16) are held
on a shape-only mesh: each rank's shard of every leaf is the block its
spec gives, at model ranks 0, 7 and 15."""
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
from repro_torch.distributed.meshes import MeshShape, make_process_mesh
from repro_torch.models import lm
from repro_torch.train import optimizer as opt
from repro_torch.train import trainer as tr

WIDEN = {"qwen2-1.5b": {"n_heads": 6, "n_kv_heads": 2},
         "llava-next-34b": {"n_heads": 6, "n_kv_heads": 2},
         "whisper-large-v3": {},
         "rwkv6-3b": {"n_heads": 6, "n_kv_heads": 6, "d_model": 96}}
# (model axis, sequence TP) and the archs each world runs
MESHES = ((4, False), (4, True), (2, False), (2, True))
AT = {4: tuple(WIDEN), 2: ("whisper-large-v3",)}
CASES = [(arch, m) for m in MESHES for arch in AT[m[0]]]
# float64 against float64: the split's sums in another order
F64_TOL = 1e-12


def _config(archs, arch):
    return dataclasses.replace(archs[arch].reduced(), **WIDEN[arch])


def port_config(arch):
    from repro_torch.configs import ARCHS
    return _config(ARCHS, arch)


def _policy(mesh, seq):
    rules = sh.default_rules(False, fsdp=False)
    return sh.ShardingPolicy(mesh, sh.with_sequence_tp(rules) if seq
                             else rules)


def _step(params, cfg, nb):
    """One AdamW step on the whole batch: (loss, clipping norm, the new
    parameters as leaves), under whatever policy is active."""
    state = {"params": params, "opt": opt.init_opt_state(params, H.TC.opt),
             "step": torch.zeros((), dtype=torch.int32)}
    new, m = tr.make_train_step(cfg, H.TC)(state, H.torch_batch(nb))
    return float(m["loss"]), float(m["grad_norm"]), new["params"]


def _rank(dev, model, data):
    """Every arch of the (1, ``model``) world, plain and under sequence
    TP; ``data``: each arch's (JAX weights as numpy, batch)."""
    mesh = make_process_mesh((1, model), ("data", "model"), device=dev)
    out = {}
    for arch in data:
        cfg = port_config(arch)
        np_params, nb = data[arch]
        full = H.params_from_jax(np_params, cfg, "cpu")
        meta = lm.init_params(0, cfg, device="meta")
        for seq in (False, True):
            pol = _policy(mesh, seq)
            local = H.params_from_jax(np_params, cfg, "cpu", policy=pol)
            with sh.use_policy(pol):
                got = H.run_model(local, cfg, nb, dev)
                got["grads"] = H.leaves(tpl.gather_params(got["grads"], cfg,
                                                          pol))
                got["grads64"] = H.leaves(tpl.gather_params(
                    H.grads64(local, cfg, nb), cfg, pol))
                tp = tpl.layout(cfg, pol)
                got["inside"] = (tp.inside, tp.expand, tp.kv_rep)
                if not seq:
                    loss, gnorm, new = _step(local, cfg, nb)
                    got["step"] = (loss, gnorm, H.leaves(
                        tpl.gather_params(new, cfg, pol)))
            got["bytes"] = (tpl.local_bytes(local), sh.tree_local_bytes(
                meta, sh.param_pspecs(meta, pol), mesh))
            back = tpl.gather_params(tpl.shard_params(full, cfg, pol), cfg,
                                     pol)
            got["round_trip"] = all(torch.equal(a, b) for a, b in zip(
                opt.tree_leaves(back), opt.tree_leaves(full)))
            out[(arch, seq)] = got
    return out


def _port(arch, data):
    """The unsharded port on the same weights: the model's outputs and one
    AdamW step (with the gradient it took)."""
    cfg = port_config(arch)
    np_params, nb = data[arch]
    out = H.run_model(H.params_from_jax(np_params, cfg, "cpu"), cfg, nb,
                      "cpu")
    out["grads"] = H.leaves(out["grads"])
    out["grads64"] = H.leaves(H.grads64(
        H.params_from_jax(np_params, cfg, "cpu"), cfg, nb))
    before = H.params_from_jax(np_params, cfg, "cpu")
    loss, gnorm, _ = _step(opt.tree_map(lambda x: x.clone(), before), cfg,
                           nb)
    out["step"] = (loss, gnorm, before)
    return out


@pytest.fixture(scope="module")
def sides():
    """(the ranks' results by model axis, the unsharded port's, the JAX
    package's, by arch): the worlds run while this process computes the
    references."""
    import jax

    from repro.configs import ARCHS as J_ARCHS
    from repro.models import lm as j_lm
    jps, data = {}, {}
    for i, arch in enumerate(WIDEN):
        jcfg = _config(J_ARCHS, arch)
        jps[arch] = j_lm.init_params(jax.random.PRNGKey(i), jcfg)
        data[arch] = (jax.tree.map(np.asarray, jps[arch]),
                      H.np_batch(port_config(arch), i))
    with concurrent.futures.ThreadPoolExecutor(len(AT)) as pool:
        futs = {m: pool.submit(run_ranks, _rank, m, backend="gloo",
                               device="cpu", timeout_s=500,
                               args=(m, {a: data[a] for a in AT[m]}))
                for m in AT}
        ref = {arch: H.jax_model_refs(jps[arch], _config(J_ARCHS, arch),
                                      port_config(arch), data[arch][1])
               for arch in WIDEN}
        port = {arch: _port(arch, data) for arch in WIDEN}
        ranks = {m: f.result() for m, f in futs.items()}
    return ranks, port, ref


def _each(sides, arch, mesh):
    model, seq = mesh
    return [res[(arch, seq)] for res in sides[0][model]]


def _id(case):
    arch, (model, seq) = case
    return f"{arch}-model{model}" + ("-seq_tp" if seq else "")


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_layout_splits_inside(case, sides):
    """Every case's layout splits inside heads, keeping the kv heads (no
    expansion, no duplicated kv head)."""
    arch, mesh = case
    for got in _each(sides, arch, mesh):
        assert got["inside"] == (True, False, 1)


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_forward_logits(case, sides):
    arch, mesh = case
    for want in (sides[1][arch]["logits"].numpy(), sides[2][arch]["logits"]):
        for got in _each(sides, arch, mesh):
            assert got["logits"].shape == want.shape
            assert H.worst([got["logits"].numpy()], [want]) <= H.LOGIT_TOL


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_prefill_and_decode(case, sides):
    """Prefill, then greedy decode steps on the cache of the kv heads a
    rank's query heads read (RWKV: the state of the heads its columns
    touch): logits against the unsharded port's and the JAX package's,
    tokens equal, every rank the same bits."""
    arch, mesh = case
    ranks = _each(sides, arch, mesh)
    for want in (sides[1][arch], sides[2][arch]):
        steps = np.asarray(want["steps"])
        for got in ranks:
            assert H.worst([got["steps"].numpy()], [steps]) <= H.LOGIT_TOL
            assert np.array_equal(got["tokens"].numpy(),
                                  np.asarray(want["tokens"]))
            assert torch.equal(got["steps"], ranks[0]["steps"])


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_generate_tokens(case, sides):
    arch, mesh = case
    want = sides[1][arch]["generate"]
    assert np.array_equal(want, sides[1][arch]["tokens"].numpy().T)
    for got in _each(sides, arch, mesh):
        assert np.array_equal(got["generate"], want)


def _touched(cols, hd, r):
    """(first, end) of the heads of hd that columns [r cols, (r+1) cols)
    touch."""
    return r * cols // hd, -(-(r + 1) * cols // hd)


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_decode_state_shapes(case, sides):
    """A rank's cache holds the kv heads its query heads read (GQA, not
    expanded); RWKV's WKV state the heads its columns touch, its shifts
    whole."""
    arch, (model, seq) = case
    cfg = port_config(arch)
    hd = cfg.head_dim
    cols = cfg.n_heads * hd // model
    group = cfg.n_heads // cfg.n_kv_heads
    n_front = cfg.n_frontend_tokens if cfg.frontend == "vision" else 0
    T = n_front + H.S + H.N_DEC
    for r, got in enumerate(_each(sides, arch, (model, seq))):
        h0, h1 = _touched(cols, hd, r)
        nkv = (h1 - 1) // group - h0 // group + 1
        kv = lambda n: {"k": (H.B, n, nkv, hd), "v": (H.B, n, nkv, hd)}
        for layer in got["cache"]["group0"]:
            if cfg.family == "ssm":
                assert layer == {"tmix": {"shift": (H.B, cfg.d_model),
                                          "wkv": (H.B, h1 - h0, hd, hd)},
                                 "cmix_shift": (H.B, cfg.d_model)}
            elif cfg.family == "encdec":
                assert layer == {"self": kv(T), "cross": kv(
                    cfg.encoder_seq)}
            else:
                assert layer == kv(T)


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_loss_and_gradients(case, sides):
    """The loss against the unsharded port's and the JAX package's, and
    every gradient leaf gathered, by ``grads_close``, against the
    unsharded port run float64 throughout and the JAX package: a boundary
    head's gradient summed over the two ranks that compute it (the
    gather's reduce-scatter), RWKV's whole ``u`` summed over 'model'.
    The fp32 unsharded port is not the reference here: its own fp32
    rounding parts from the float64 run by 1.34e-5 on RWKV6's leaves,
    more than GRAD_TOL, where the sharded run reads 7.9e-6 (and by up to
    1.75e-4 on other draws, tests/tp_grad_draws.py)."""
    arch, mesh = case
    for got in _each(sides, arch, mesh):
        for want in (sides[1][arch], sides[2][arch]):
            assert abs(got["loss"] - want["loss"]) <= H.LOSS_TOL * abs(
                want["loss"])
        assert H.grads_close(got["grads"], sides[1][arch]["grads64"],
                             sides[2][arch]["grads"])


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_float64_gradients_equal_the_unsharded_port(case, sides):
    """Run float64 throughout (``float64_throughout``: the model's fp32
    casts and the recurrence's fp32 state kept at float64), every gathered
    gradient leaf equals the unsharded port's to float64 rounding (1.2e-14
    at most here): the split (a boundary head's two parts summed by the
    gather's reduce-scatter, RWKV's ``u`` summed over 'model') computes
    the same function, and what the fp32 runs part by is fp32 rounding."""
    arch, mesh = case
    for got in _each(sides, arch, mesh):
        assert H.worst(got["grads64"], sides[1][arch]["grads64"],
                       H.FLOOR) <= F64_TOL


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_weight_bytes_equal_the_specs(case, sides):
    """A rank's weight bytes equal ``tree_local_bytes`` of the specs: the
    columns the specs cut, nothing duplicated (RWKV's ``u`` whole, as its
    spec at 6 heads over 4)."""
    arch, mesh = case
    for got in _each(sides, arch, mesh):
        assert got["bytes"][0] == got["bytes"][1]


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_shards_round_trip_bit_for_bit(case, sides):
    arch, mesh = case
    assert all(got["round_trip"] for got in _each(sides, arch, mesh))


@pytest.mark.parametrize("case", [c for c in CASES if not c[1][1]],
                         ids=_id)
def test_adamw_step(case, sides):
    """One AdamW step on the sharded parameters: its loss and clipping
    norm against the unsharded step's, its updated parameters against the
    unsharded AdamW fed the gathered gradient, the same bits on every
    rank."""
    arch, mesh = case
    loss, gnorm, before = sides[1][arch]["step"]
    ranks = _each(sides, arch, mesh)
    for got in ranks:
        g_loss, g_norm, params = got["step"]
        assert abs(g_loss - loss) <= H.LOSS_TOL * abs(loss)
        assert abs(g_norm - gnorm) <= H.LOSS_TOL * abs(gnorm)
        tree = lambda xs: opt.tree_unflatten(before, xs)
        upd, _, _ = opt.adamw_update(tree(got["grads"]),
                                     opt.init_opt_state(before, H.TC.opt),
                                     before, H.TC.opt)
        assert H.worst([p.numpy() for p in params],
                       [p.numpy() for p in opt.tree_leaves(upd)]
                       ) <= H.PARAM_TOL
        assert all(torch.equal(a, b) for a, b in zip(
            params, ranks[0]["step"][2]))


FULL = ("qwen2-1.5b", "llava-next-34b", "whisper-large-v3", "rwkv6-3b")


@pytest.mark.parametrize("model_rank", [0, 7, 15])
@pytest.mark.parametrize("arch", FULL)
def test_full_size_shards_are_the_specs_blocks(arch, model_rank):
    """The full-size arch at (data 16, model 16) under ``default_rules``
    (the FSDP overlay on 'data' after the model-axis cut): the layout
    splits inside heads, and each leaf of a rank's shard has the shape its
    spec gives; its bytes are ``tree_local_bytes`` of the specs."""
    cfg = get_arch(arch)
    mesh = MeshShape(("data", "model"), (16, 16))
    pol = sh.ShardingPolicy(mesh, sh.default_rules(False))
    tp = tpl.layout(cfg, pol)
    assert tp.inside and not tp.expand and tp.kv_rep == 1
    meta = lm.init_params(0, cfg, device="meta")
    specs = sh.param_pspecs(meta, pol, fsdp=True)
    coords = {"data": 3, "model": model_rank}
    local = tpl.shard_params(meta, cfg, pol, model_rank=model_rank,
                             data_rank=3)
    for x, full, spec in zip(opt.tree_leaves(local), opt.tree_leaves(meta),
                             sh.spec_leaves(specs)):
        assert tuple(x.shape) == sh.local_shape(full.shape, spec, mesh,
                                                coords)
    assert tpl.local_bytes(local) == sh.tree_local_bytes(meta, specs, mesh,
                                                         coords)


@pytest.mark.parametrize("arch,blocks", [
    # (c0, c1, h0, h1, kv0, kv1) at model ranks 0, 1, 7 and 15
    ("qwen2-1.5b", [(0, 96, 0, 1, 0, 1), (96, 192, 0, 2, 0, 1),
                    (672, 768, 5, 6, 0, 1), (1440, 1536, 11, 12, 1, 2)]),
    ("llava-next-34b", [(0, 448, 0, 4, 0, 1), (448, 896, 3, 7, 0, 1),
                        (3136, 3584, 24, 28, 3, 4),
                        (6720, 7168, 52, 56, 7, 8)]),
    ("whisper-large-v3", [(0, 80, 0, 2, 0, 2), (80, 160, 1, 3, 1, 3),
                          (560, 640, 8, 10, 8, 10),
                          (1200, 1280, 18, 20, 18, 20)]),
    ("rwkv6-3b", [(0, 160, 0, 3, 0, 3), (160, 320, 2, 5, 2, 5),
                  (1120, 1280, 17, 20, 17, 20),
                  (2400, 2560, 37, 40, 37, 40)])])
def test_head_blocks_at_model_16(arch, blocks):
    """A rank's columns, the query heads they touch and the kv heads those
    read at model 16, and one GQA call a rank (every rank's query heads on
    one kv head for qwen2-1.5b and llava-next-34b; one kv head a query
    head for the MHA archs)."""
    cfg = get_arch(arch)
    pol = sh.ShardingPolicy(MeshShape(("data", "model"), (16, 16)),
                            sh.default_rules(False))
    tp = tpl.layout(cfg, pol)
    for r, want in zip((0, 1, 7, 15), blocks):
        blk = tp.head_block(r)
        assert (blk.c0, blk.c1, blk.h0, blk.h1, blk.kv0, blk.kv1) == want
        assert blk.kv_segments() == ((0, blk.n_heads, 0,
                                      blk.kv1 - blk.kv0),)


def test_kv_segments_of_a_block_across_kv_heads():
    """Query heads 5-7 of group 6 read kv heads 0, 1 and 1: two GQA calls;
    heads 4-7 read 0, 0, 1, 1: one call at G = 2."""
    blk = tpl.HeadBlock(5 * 16, 8 * 16, 5, 8, 0, 2, 16, 16, 6)
    assert blk.kv_segments() == ((0, 1, 0, 1), (1, 3, 1, 2))
    blk = tpl.HeadBlock(4 * 16, 8 * 16, 4, 8, 0, 2, 16, 16, 6)
    assert blk.kv_segments() == ((0, 4, 0, 2),)


def test_attend_over_uneven_kv_segments():
    """``lm._attend`` on a block whose query heads 5-7 (group 6) read kv
    heads 0, 1 and 1: one GQA call a kv head, equal to attention with k
    and v expanded to each query head."""
    from repro_torch.models.attention import blockwise_attention

    class _Block:
        inside, expand = True, False

        def head_block(self):
            return tpl.HeadBlock(5 * 16, 8 * 16, 5, 8, 0, 2, 16, 16, 6)
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 9, n, 16, generator=gen) for n in (3, 2, 2))
    pos = torch.arange(9)
    got = lm._attend(q, k, v, pos, _Block(), causal=True)
    idx = torch.tensor([0, 1, 1])
    want = blockwise_attention(q, k.index_select(2, idx),
                               v.index_select(2, idx), pos, causal=True)
    assert torch.equal(got, want)


@pytest.mark.parametrize("geometry", [
    {"n_heads": 5, "n_kv_heads": 5, "head_dim": 6},
    {"n_heads": 6, "n_kv_heads": 1, "head_dim": 6}])
def test_columns_the_specs_do_not_split_raise(geometry):
    """A dense geometry whose query (5 x 6 = 30) or kv (6) width model 4
    does not divide: the specs leave those leaves whole, and the layout
    raises through the ROADMAP's queue."""
    cfg = dataclasses.replace(get_arch("qwen2-1.5b").reduced(), **geometry)
    pol = sh.ShardingPolicy(MeshShape(("data", "model"), (1, 4)),
                            sh.default_rules(False))
    with pytest.raises(NotImplementedError, match="ROADMAP.md") as err:
        tpl.layout(cfg, pol)
    assert "columns the specs do not split" in str(err.value)


def test_whole_heads_keep_their_plan():
    """Layouts whose heads split whole keep the whole-head plan:
    qwen2-72b's 8 kv heads duplicated at model 16, the widened reduced
    qwen2's 6 / 2 heads at model 2."""
    pol16 = sh.ShardingPolicy(MeshShape(("data", "model"), (16, 16)),
                              sh.default_rules(False))
    tp = tpl.layout(get_arch("qwen2-72b"), pol16)
    assert not tp.inside and tp.kv_rep == 2
    pol2 = sh.ShardingPolicy(MeshShape(("data", "model"), (1, 2)),
                             sh.default_rules(False))
    tp = tpl.layout(port_config("qwen2-1.5b"), pol2)
    assert not tp.inside and tp.kv_rep == 1 and tp.local_kv_heads == 1
