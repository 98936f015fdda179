"""The port's dry run (``repro_torch.launch.dryrun``) at the cell level, on
the CPU with no JAX (the gloo ranks import this module).

* The fit through depths 1-2 and three sequence lengths reproduces a
  direct count at depth 3 and a fourth length (FLOPs, bytes, wire bytes)
  of a reduced dense cell on the fake group at (data 2, model 2): serving
  and a train microbatch.
* The collectives a reduced dense train step issues on the fake group at
  (data 2, model 2) on ``meta`` tensors equal those of a real 4-rank gloo
  run of the same step on the CPU (``run_ranks``): kind, issuing
  function, bytes and groups, in order.
* Production cells: ``qwen2-72b x decode_32k x single`` runs (its routes,
  memory, costs and roofline terms); the cells of the archs whose heads
  split inside at model 16 run (``qwen2-1.5b``'s serving cells and its
  train cell's layout, the cheapest cell of the other three); no default
  process group is left after any call, and the dry run refuses to start
  over one.
* The CLI writes its JSON into a temporary directory.
"""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import ARCHS
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.collectives import record_collectives
from repro_torch.distributed.launch import run_ranks
from repro_torch.distributed.meshes import make_process_mesh
from repro_torch.kernels import _card
from repro_torch.launch import dryrun
from repro_torch.models import frontends, lm
from repro_torch.configs import ShapeConfig
from repro_torch.distributed import tensor_parallel as tpl
from repro_torch.train import optimizer as opt
from repro_torch.train import trainer as tr

ROOT = pathlib.Path(__file__).resolve().parents[1]
REL = 1e-9
GRID = (16, 32, 64)           # the fit's sequence lengths
DIRECT = (3, 48)              # (depth, S) of the direct count
# a reduced dense config widened so that the FSDP overlay splits its
# embedding, head and MLP weights (2^16 elements or more)
CFG = dataclasses.replace(ARCHS["qwen2-72b"].reduced(), vocab_size=2048,
                          d_ff=1024)
MESH = (2, 2)
BATCH = (8, 32)               # the collectives' step: rows, tokens
TC = tr.TrainConfig(n_microbatches=2, remat=True,
                    opt=opt.OptimizerConfig(lr=1e-3, warmup_steps=1,
                                            decay_steps=10))


def _close(a, b, rel=REL):
    return abs(a - b) <= rel * max(abs(a), abs(b), 1.0)


def _mesh(device):
    return make_process_mesh(MESH, ("data", "model"), device=device)


def _policy(mesh):
    return sh.ShardingPolicy(mesh, sh.default_rules(False, fsdp=True))


@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k", "train_4k"])
def test_fit_through_depths_1_2_reproduces_a_direct_count(shape):
    plan = dataclasses.replace(dryrun.make_plan("qwen2-72b", shape,
                                                "single"), s_points=GRID)
    pts = {k: [] for k in ("flops", "bytes", "ici")}
    with dryrun.fake_world(4), _card.dry_run():
        pol = dryrun._policy(plan, _mesh("meta"))

        def count(depth, S):
            cfg_d = dryrun._with_depth(CFG, (depth,))
            if shape == "train_4k":
                return dryrun._train_cost_point(plan, pol, cfg_d, S, 4)[0]
            return dryrun._serve_cost_point(plan, pol, cfg_d, S, 4)
        for depth in (1, 2):
            for S in GRID:
                got = count(depth, S)
                for k in pts:
                    pts[k].append(((depth,), S, got[k]))
        direct = count(*DIRECT)
    assert not dist.is_initialized()
    assert direct["ici"] > 0 and direct["flops"] > 0
    for k in pts:
        fit = dryrun._fit_poly(pts[k])
        assert _close(dryrun._eval_poly(fit, (DIRECT[0],), DIRECT[1]),
                      direct[k]), (k, fit["order"], direct[k])


def _records(records):
    return [(r.kind, r.fn, r.in_bytes, r.out_bytes, r.ranks)
            for r in records]


def _batch(device, seed):
    gen = torch.Generator().manual_seed(seed)
    rows, seq = BATCH
    toks = torch.randint(0, CFG.vocab_size, (rows, seq + 1), generator=gen)
    return {"tokens": toks[:, :-1].to(device),
            "targets": toks[:, 1:].to(device),
            "loss_mask": torch.ones((rows, seq), device=device)}


def _step_records(device, params):
    mesh = _mesh(device)
    pol = _policy(mesh)
    state = {"params": params(pol),
             "opt": None,
             "step": torch.zeros((), dtype=torch.int32, device=device)}
    state["opt"] = opt.init_opt_state(state["params"], TC.opt)
    batch = (_batch(device, 3) if device != "meta" else
             frontends.train_batch_specs(CFG, ShapeConfig("b", BATCH[1],
                                                          BATCH[0], "train"),
                                         torch.float32))
    step = tr.make_train_step(CFG, TC)
    with sh.use_policy(pol), record_collectives() as records:
        step(state, batch)
    return _records(records)


def _gloo_rank(dev):
    """One rank of the gloo world: its collective records of one step."""
    return _step_records(
        "cpu", lambda pol: tpl.init_shard_params(0, CFG, pol, device="cpu"))


def test_collective_records_on_the_fake_group_equal_a_gloo_run():
    ranks = run_ranks(_gloo_rank, 4, backend="gloo", device="cpu",
                      timeout_s=300)
    with dryrun.fake_world(4), _card.dry_run():
        fake = _step_records(
            "meta", lambda pol: tpl.init_shard_params(0, CFG, pol,
                                                      device="meta"))
    assert not dist.is_initialized()
    kinds = {r[1] for r in fake}
    assert {"psum", "psum_scatter", "all_gather"} <= kinds
    assert any(r[4] == (0, 2) for r in fake)          # over 'data'
    assert any(r[4] == (0, 1) for r in fake)          # over 'model'
    assert fake == ranks[0]
    # every rank issues the same sequence on its own groups
    assert all(len(r) == len(fake) for r in ranks)


def test_production_decode_cell_runs(tmp_path):
    r = dryrun.run_cell("qwen2-72b", "decode_32k", "single",
                        results_dir=str(tmp_path))
    assert not dist.is_initialized()
    assert r["ok"], r.get("traceback")
    assert r["rank"] == {"rank": 0, "coords": {"data": 0, "model": 0}}
    assert r["dry_calls"]["flash_attention"] == {"split_kv": 80}
    mem = r["memory"]
    assert mem["alias_bytes"] > 0 and mem["fits_hbm"]
    # the cache of 8 rows x 32,768 positions, one kv head of 128 a rank
    assert mem["alias_bytes"] >= 80 * 2 * 8 * 32768 * 128 * 2
    pd = r["per_device"]
    assert pd["flops"] > r["model_flops_per_device"] > 0
    assert pd["ici"] > 0 and pd["dcn"] == 0.0
    assert r["roofline"]["dominant"] in ("compute", "memory", "collective")
    saved = tmp_path / "single" / "qwen2-72b__decode_32k.json"
    assert json.loads(saved.read_text())["ok"]
    # a cached cell is read back, not run again
    again = dryrun.run_cell("qwen2-72b", "decode_32k", "single",
                            results_dir=str(tmp_path))
    assert again["timestamp"] == json.loads(saved.read_text())["timestamp"]


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
@pytest.mark.parametrize("mesh", ["single", "multi"])
def test_qwen2_1_5b_cells_report_the_todo(shape, mesh, tmp_path):
    """qwen2-1.5b's cells, which reported the ``_todo`` of heads that do not
    split whole at model 16, lower now that its heads split inside: the
    serving cells run (``OK``, a peak, a cache of the one kv head a rank's
    1-2 query heads read, 8 x the spec's 16 columns), and the train cell's
    layout under its plan's policy (its step takes minutes on the CPU)
    splits inside heads with every leaf the block its spec gives."""
    if shape == "train_4k":
        plan = dryrun.make_plan("qwen2-1.5b", shape, mesh)
        shape_mesh = dryrun.mesh_shape_by_kind(mesh)
        pol = dryrun._policy(plan, shape_mesh)
        tp = tpl.layout(plan.cfg, pol)
        assert tp.inside and not tp.expand
        meta = lm.init_params(0, plan.cfg, device="meta")
        local = tpl.shard_params(meta, plan.cfg, pol, model_rank=0,
                                 data_rank=0)
        assert tpl.local_bytes(local) == sh.tree_local_bytes(
            meta, sh.param_pspecs(meta, pol, fsdp=plan.fsdp), shape_mesh)
        return
    r = dryrun.run_cell("qwen2-1.5b", shape, mesh,
                        results_dir=str(tmp_path))
    assert not dist.is_initialized()
    assert r["runnable"] and r["ok"], r.get("traceback")
    assert not dryrun._is_todo(r)
    assert r["memory"]["peak_bytes"] > r["memory"]["argument_bytes"] > 0
    assert r["cache"]["bytes"] == 8 * r["cache"]["spec_bytes"]
    assert "OK" in dryrun.summary_line(r, 0.0)


@pytest.mark.parametrize("arch,shape", [
    ("llava-next-34b", "decode_32k"), ("whisper-large-v3", "decode_32k"),
    ("rwkv6-3b", "decode_32k"), ("rwkv6-3b", "long_500k")])
def test_cells_of_heads_that_split_inside_run(arch, shape, tmp_path):
    """The cheapest cell of each other arch whose heads split inside at
    model 16 runs on the single mesh: ``OK``, its routes, and its cache a
    rank against the spec's (LLaVA: the one kv head its 4 query heads
    read, 2 x the spec's 64 columns; Whisper: the 2 heads its 80 columns
    touch, 1.6 x; RWKV6: the 3 WKV heads its 160 columns touch, its
    shifts whole).  rwkv6-3b's ``long_500k`` has one row, which 'data' 16
    does not split: every data rank runs it whole."""
    r = dryrun.run_cell(arch, shape, "single", results_dir=str(tmp_path))
    assert not dist.is_initialized()
    assert r["runnable"] and r["ok"], r.get("traceback")
    assert r["roofline"]["dominant"] == "memory"
    ratio = r["cache"]["bytes"] / r["cache"]["spec_bytes"]
    calls = r["dry_calls"]
    if arch == "rwkv6-3b":
        cfg = ARCHS[arch]
        rows = 8 if shape == "decode_32k" else 1
        state = rows * (3 * 64 * 64 * 4 + 2 * cfg.d_model * 2)
        assert r["cache"]["bytes"] == cfg.n_layers * state
        assert calls["wkv_scan"] == {"step": cfg.n_layers}
    else:
        assert ratio == {"llava-next-34b": 2.0, "whisper-large-v3": 1.6}[arch]
        assert calls["flash_attention"] == {"split_kv": (
            2 if arch == "whisper-large-v3" else 1) * ARCHS[arch].n_layers}


def test_long_500k_cells_of_full_attention_archs_skip(tmp_path):
    r = dryrun.run_cell("qwen2-72b", "long_500k", "multi",
                        results_dir=str(tmp_path))
    assert not r["runnable"] and "long_500k skipped" in r["skip_reason"]


def test_the_dry_run_refuses_an_existing_default_group(tmp_path):
    store = dist.FileStore(str(tmp_path / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        with pytest.raises(RuntimeError, match="no default process group"):
            with dryrun.fake_world(4):
                pass
        r = dryrun.run_cell("qwen2-72b", "decode_32k", "single",
                            results_dir=str(tmp_path))
        assert not r["ok"] and "no default process group" in r["error"]
        assert dist.is_initialized()        # the caller's group is left
    finally:
        dist.destroy_process_group()


def test_the_cli_writes_its_json(tmp_path):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "qwen2-72b", "qwen2-1.5b", "--shape", "decode_32k", "long_500k",
         "--mesh", "single", "--results-dir", str(tmp_path)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 4
    assert "OK" in lines[0] and "SKIP" in lines[1] and "OK" in lines[2]
    assert not any("TODO" in line for line in lines)
    files = sorted(p.name for p in (tmp_path / "single").iterdir())
    assert files == ["qwen2-1.5b__decode_32k.json",
                     "qwen2-1.5b__long_500k.json",
                     "qwen2-72b__decode_32k.json",
                     "qwen2-72b__long_500k.json"]
    ok = json.loads((tmp_path / "single" /
                     "qwen2-72b__decode_32k.json").read_text())
    assert ok["ok"] and ok["roofline"]["t_bound"] > 0
