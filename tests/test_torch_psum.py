"""``collectives.psum`` as a reduce-scatter then an all-gather, on gloo
ranks on the CPU.

The old form, an all-gather of every member's input and an ordered sum,
is kept here as the oracle (:func:`_old_psum`).  Worlds of 2, 3 and 4
ranks, spawned side by side once for the module, each psum inputs in fp32
and bf16 at sizes that n divides and does not, a 0-d tensor (the losses)
and a joint tuple of all the mesh's axes (the trainer's ``("rack",
"server")``); the new form must give the old bits.  The records of one
psum (an all-to-all of the padded input and an all-gather of its block,
both ``fn`` "psum"), their price in ``hlo_analysis`` (2 (n-1)/n of the
input on the wire) and the peak of a psum of 4 MiB under the dry run's
``MemoryTracker`` (below 4 copies of its input) are held too."""
import concurrent.futures

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.distributed import collectives as col
from repro_torch.distributed.launch import run_ranks
from repro_torch.distributed.meshes import make_process_mesh
from repro_torch.launch import hlo_analysis as hlo

WORLDS = (2, 3, 4)
SHAPES = ((), (1,), (7,), (5, 3), (4, 6), (3, 1, 11), (257, 5))
DTYPES = ("float32", "bfloat16")
BIG = 1 << 20                         # fp32 elements of the peak's psum


def _old_psum(x, group):
    """The form psum had: every member's x all-gathered, then summed in
    rank order."""
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    acc = parts[0].clone()
    for part in parts[1:]:
        acc += part
    return acc


def _input(n_rank, shape, dtype):
    rng = np.random.default_rng(1000 * n_rank + len(shape) + sum(shape))
    x = np.asarray(rng.normal(size=shape) * 3.0, dtype=np.float32)
    return torch.from_numpy(x).to(getattr(torch, dtype))


def _rank(dev, n):
    from repro_torch.launch.dryrun import MemoryTracker
    rank = dist.get_rank()
    flat = make_process_mesh((n,), ("model",), device=dev)
    joint = make_process_mesh((1, n), ("rack", "server"), device=dev)
    out = {"sums": {}, "records": {}}
    for shape in SHAPES:
        for dtype in DTYPES:
            x = _input(rank, shape, dtype)
            old = _old_psum(x, flat.group("model"))
            with col.record_collectives() as recs:
                new = col.psum(x, flat, "model")
            out["records"][(shape, dtype)] = [
                (r.kind, r.fn, r.in_bytes, r.out_bytes, r.ranks)
                for r in recs]
            out["sums"][(shape, dtype)] = (
                old, new, col.psum(x, joint, ("rack", "server")),
                col.psum(x, flat, ("model",)))
    with MemoryTracker() as mem:
        x = torch.full((BIG,), float(rank + 1))     # counted as an argument
        mem.start()
        y = col.psum(x, flat, "model")
        mem.finish(y)
    out["peak"] = (mem.summary()["peak_bytes"], x.numel() * 4,
                   float(y[0]), float(y[-1]))
    return out


@pytest.fixture(scope="module")
def worlds():
    with concurrent.futures.ThreadPoolExecutor(len(WORLDS)) as pool:
        futs = {n: pool.submit(run_ranks, _rank, n, backend="gloo",
                               device="cpu", args=(n,), timeout_s=300)
                for n in WORLDS}
        return {n: f.result() for n, f in futs.items()}


def _id(v):
    return "x".join(map(str, v)) or "scalar"


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES, ids=_id)
@pytest.mark.parametrize("n", WORLDS)
def test_psum_keeps_the_bits_of_the_all_gather_form(n, shape, dtype,
                                                    worlds):
    """The reduce-scatter form equals the old all-gather form bit for bit
    on every rank, on one axis, on a one-axis tuple and on the joint tuple
    of a (1, n) mesh; every rank holds the same bits; the sum is the
    members' inputs summed in rank order."""
    want = _input(0, shape, dtype).clone()
    for r in range(1, n):
        want += _input(r, shape, dtype)
    for res in worlds[n]:
        old, new, joint, one = res["sums"][(shape, dtype)]
        assert new.shape == old.shape == torch.Size(shape)
        assert new.dtype == old.dtype == getattr(torch, dtype)
        for got in (new, joint, one):
            assert torch.equal(got, old)
        assert torch.equal(new, want)
        assert torch.equal(new, worlds[n][0]["sums"][(shape, dtype)][1])


@pytest.mark.parametrize("shape", SHAPES, ids=_id)
@pytest.mark.parametrize("n", WORLDS)
def test_psum_records_a_reduce_scatter_and_an_all_gather(n, shape,
                                                         worlds):
    """An all-to-all of the input padded to n blocks of m, then an
    all-gather of one block, both recorded as the psum's; no all-gather of
    n times the input."""
    for dtype in DTYPES:
        item = torch.tensor([], dtype=getattr(torch, dtype)).element_size()
        m = -(-int(np.prod(shape, dtype=np.int64)) // n)
        want = [("all-to-all", "psum", n * m * item, n * m * item,
                 tuple(range(n))),
                ("all-gather", "psum", m * item, n * m * item,
                 tuple(range(n)))]
        for res in worlds[n]:
            assert res["records"][(shape, dtype)] == want


@pytest.mark.parametrize("n", WORLDS)
def test_psum_is_priced_as_an_all_reduce(n, worlds):
    """``hlo_analysis`` prices the two records at 2 (n-1)/n of the input's
    bytes, an all-reduce's ring, where n divides the input."""
    shape = (4, 6) if n != 3 else (3, 1, 11)
    recs = [col.CollectiveRecord(*r) for r in
            worlds[n][0]["records"][(shape, "float32")]]
    nbytes = int(np.prod(shape)) * 4
    summary = hlo.collective_summary(recs, 1 << 10)      # one pod
    assert summary["n_ops"] == 2
    assert summary["per_fn"] == {"psum": pytest.approx(
        2 * (n - 1) / n * nbytes, rel=1e-12)}
    assert summary["dcn_bytes"] == 0.0


@pytest.mark.parametrize("n", WORLDS)
def test_psum_peak_stays_below_four_copies(n, worlds):
    """A psum of 4 MiB under the dry run's tracker: the input, the
    all-to-all's blocks and the summed block, then the gathered result;
    below 4 copies of the input (the all-gather form held n + 1 and
    more)."""
    for res in worlds[n]:
        peak, nbytes, first, last = res["peak"]
        assert peak < 4 * nbytes, (peak / nbytes)
        assert first == last == n * (n + 1) / 2
