"""Spawn the ranks of a process mesh: one process per server.

:func:`run_ranks` starts ``world_size`` processes (``spawn``, never
``fork``), joins them into one ``torch.distributed`` world through a file
rendezvous in a fresh temporary directory (no TCP port, so concurrent runs
cannot collide), calls ``fn(device, *args)`` in each, and returns every
rank's result to the parent, in rank order.

The backend is always the caller's choice; nothing switches it:

* ``"nccl"`` — rank k runs on ``cuda:k``; there must be a card per rank.
* ``"gloo"`` with ``device="cuda"`` — every rank runs on ``cuda:0``.  NCCL
  refuses two ranks on one device, so this is how one card runs K ranks;
  gloo takes CUDA tensors in every collective the port uses.
* ``"gloo"`` with ``device="cpu"`` — the CPU form the tests run.

``device=None`` means the CUDA card and raises where there is none.  On
the card the kernels are built in the parent before the spawn, so the
ranks only load them.  The ranks share the host's cores: each runs its
intra-op threads on an equal share of them (ranks that each took every
core would oversubscribe the host and slow every host-side op by orders
of magnitude).
"""
from __future__ import annotations

import datetime
import os
import pickle
import queue
import tempfile
import time
import traceback
from typing import Any, Callable, List, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from .meshes import DeviceLike, resolve_device

BACKENDS = ("gloo", "nccl")


def default_backend(device: DeviceLike, world_size: int) -> str:
    """``"nccl"`` where there is a card per rank, else ``"gloo"`` (every
    rank on one card, or the CPU)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and torch.cuda.device_count() >= world_size:
        return "nccl"
    return "gloo"


class RankError(RuntimeError):
    """A rank raised, died, or outlived the time limit."""


def _rank_device(backend: str, device: torch.device,
                 rank: int) -> torch.device:
    if device.type != "cuda":
        return device
    return torch.device("cuda", rank if backend == "nccl" else 0)


def _rank_main(rank: int, world_size: int, backend: str, device_type: str,
               init_method: str, fn: Callable, args: Sequence,
               results, timeout_s: float, threads: int) -> None:
    """One rank: join the world, run ``fn``, report the pickled result or
    the traceback on ``results`` as (rank, ok, payload), then leave the
    world (after the report: leaving first would fail the other ranks'
    collectives before this rank's own error is on its way)."""
    try:
        torch.set_num_threads(threads)
        dev = _rank_device(backend, torch.device(device_type), rank)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(
            backend, init_method=init_method, rank=rank,
            world_size=world_size,
            timeout=datetime.timedelta(seconds=timeout_s))
        # plain pickle: the tensors travel by value, not through shared
        # memory that would die with this process
        report = (rank, True, pickle.dumps(fn(dev, *args)))
    except Exception:
        report = (rank, False, traceback.format_exc())
    results.put(report)
    if dist.is_initialized():
        dist.destroy_process_group()


def _stop(procs) -> None:
    procs = [p for p in procs if p.pid is not None]     # the started ones
    for p in procs:
        if p.is_alive():
            p.terminate()
    for p in procs:
        p.join(5)
        if p.is_alive():
            p.kill()
            p.join(5)


def run_ranks(fn: Callable[..., Any], world_size: int, *, backend: str,
              device: DeviceLike = None, args: Sequence = (),
              timeout_s: float = 600.0) -> List[Any]:
    """Run ``fn(device, *args)`` in ``world_size`` spawned ranks and return
    their results by rank.

    ``fn`` must be importable by name (a module-level function) and should
    return CPU tensors or NumPy arrays.  Every rank must finish within
    ``timeout_s`` seconds of the spawn: a rank that raises is re-raised
    here as :class:`RankError` with its rank and traceback (beside those
    of the ranks its failure took down), a rank that dies without a
    report names its exit code, and on the time limit the error names the
    ranks still running.  Every rank is stopped before this returns or
    raises.
    """
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    if world_size < 1:
        raise ValueError(f"world_size must be >= 1, got {world_size}")
    dev = resolve_device(device)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"ranks run on the CPU or a CUDA card, not {dev}")
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError("the nccl backend needs device='cuda'")
        if torch.cuda.device_count() < world_size:
            raise RuntimeError(
                f"nccl runs one rank per card: {world_size} ranks need "
                f"{world_size} cards, this host has "
                f"{torch.cuda.device_count()}")
    if dev.type == "cuda":
        from ..kernels.coded_combine import ops
        ops.build()

    threads = max(1, len(os.sched_getaffinity(0)) // world_size)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    got, failures = {}, {}
    with tempfile.TemporaryDirectory(prefix="rdzv-") as tmp:
        init_method = "file://" + os.path.join(tmp, "rdzv")
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(rank, world_size, backend, dev.type,
                                   init_method, fn, tuple(args), results,
                                   timeout_s, threads))
                 for rank in range(world_size)]
        deadline = time.monotonic() + timeout_s
        try:
            for p in procs:
                p.start()
            while len(got) < world_size and not failures:
                left = deadline - time.monotonic()
                if left <= 0:
                    running = sorted(set(range(world_size)) - set(got))
                    raise RankError(
                        f"ranks {running} of {world_size} still running "
                        f"after {timeout_s} s")
                try:
                    rank, ok, payload = results.get(timeout=min(left, 0.5))
                except queue.Empty:
                    # a rank that died without a report (killed, crashed)
                    for rank, p in enumerate(procs):
                        if (p.exitcode not in (None, 0)
                                and rank not in got):
                            failures[rank] = (f"exited with code "
                                              f"{p.exitcode} and no report")
                    continue
                (got if ok else failures)[rank] = payload
            # a failed rank fails its peers' collectives too: take their
            # reports for a moment, so the error holds every rank's own
            grace = min(deadline, time.monotonic() + 5.0)
            while (failures and len(got) + len(failures) < world_size
                   and time.monotonic() < grace):
                try:
                    rank, ok, payload = results.get(timeout=0.2)
                except queue.Empty:
                    continue
                (got if ok else failures)[rank] = payload
        finally:
            _stop(procs)
            results.close()
            results.cancel_join_thread()
    if failures:
        raise RankError("\n".join(f"rank {rank} of {world_size} failed:\n"
                                  f"{failures[rank]}"
                                  for rank in sorted(failures)))
    return [pickle.loads(got[rank]) for rank in range(world_size)]
