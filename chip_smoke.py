#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card and
check it.

    python3 chip_smoke.py [--seed 0] [--out chiprun_out/chip_smoke.json]

Two paths of the port run here.  MapReduce: the paper's Table I row (K=16,
P=4, Q=16, N=1680) with ``wide_histogram_job(d=2048)``, each subfile
16,384 int32 tokens drawn from ``--seed`` in [0, 2^16); every per-key
total stays below 2^24, so every partial sum of the integer-valued float32
payloads is exact in any order and all results compare bit for bit.  LM
serving: ``ServeEngine`` at full width for qwen2-1.5b and rwkv6-3b, bf16
weights drawn on the card from ``--seed``, 8 slots, ``max_seq`` 2112.

Phases, one printed line each (plus detail lines):

1. device   — ``nvidia-smi`` name and power limit, the card, and the
              kernels' build (one ``nvcc`` per source, all at once).
2. kernels  — each coded-combine kernel against its plain PyTorch version
              on the card, at the main path's launch shapes, at phase
              4c's (one server's share of them; the gradient
              reduce-scatter's [3, 1680 x 2048] with 0/1 coefficients)
              and at odd shapes, with CUDA-event times and the HBM
              bound; where one
              library call computes the same function (``xs.sum(0)``,
              ``torch.sub``, ``torch.bitwise_xor``) kernel and library are
              timed in turns (kernel, library, library, kernel); at the
              main shapes both's device time per call (profiler; every
              ``coded_decode`` row in float32 and bfloat16), taken after
              phase 7 so that its profiler sessions come last.  The
              decode's ``ptxas`` lines are printed here again.
3. shuffle  — ``hybrid_shuffle`` for r in {2, 3} x {unicast, coded} x
              {torch, kernel} and ``coded_xor`` on int32 payloads, bit-exact
              against the port's NumPy ``simulate_plan_shuffle`` and
              ``plan_shuffle_reference``.
4. engine   — ``run_job_distributed`` fused and legacy, binomial r in
              {1, 2, 3} and resolvable r = 2, every multicast x combine
              pairing: outputs bit-exact against the dense ``run_job``,
              costs and rack bytes equal to the closed forms; one profiled
              fused job.
4b. faults  — the recovery ladder at the same row under crash schedules.
4c. ranks   — the process form: 16 ranks on the card over gloo (NCCL
              refuses two ranks on one device), spawned once, each
              drawing the subfiles from ``--seed``.  Each runs fused
              ``run_job_distributed`` for binomial r in {1, 2, 3} x
              {(unicast, torch), (coded, kernel)}, resolvable r = 2 and
              one legacy r = 2 job, a ``coded_xor`` ``hybrid_shuffle`` on
              int32 at r = 2, and ``coded_reduce_scatter_r2(combine_impl=
              "kernel")`` on integer-valued chunk gradients of G = 1536 x
              8960 (one Qwen2-1.5B MLP projection) with no failure and
              rack 3 failed.  Gates: every rank's outputs bit-identical to
              the stacked job's and ``run_job``'s, its shuffle rows to the
              stacked shuffle's, every survivor's shard to the NumPy
              total; every rank's launches one server's; every rank on
              the card.  Walls: the slowest rank's, median of three after
              a warm call, beside the stacked job's timed the same way;
              the exchanges alone; spawn and rendezvous.
4d. locality — Section IV, run last (after phase 7 and phase 2's device
              times: profiles taken after its million-odd eager launches
              held about half of their kernel records).  First the Table
              I row with HDFS replicas (r_f = 3), r in {2, 3}: greedy,
              then the annealer on the card (64 chains, 1,500 steps; its
              step loop run again under ``set_sync_debug_mode("error")``,
              and 200 steps profiled), the fused coded kernel job under
              that placement bit-identical to the identity placement and
              ``run_job`` with one encode and one decode, every server
              mapping the placement's subfiles, and its simulated JCT
              below a random placement's.  Then the ten Table II rows of
              ``BENCH_locality.json`` through the port's ``table2_trials``
              (random, greedy, flow, local_search, and the annealer on
              the card warm-started from flow and greedy, 64 chains,
              1,000 steps): the four deterministic solvers' statistics
              and the flow-vs-random ``jct_gap`` equal the file's (the
              JAX package's numbers), the annealer >= flow, every solver
              above random.
5. lm kernels — ``flash_attention`` and ``wkv_scan`` against their plain
              versions at the serving path's prefill and decode shapes (bf16
              and fp32) and the odd shapes of tests/test_kernels.py, with
              times, bounds (bytes or tensor-core operations) and, for
              attention, the route each call took and
              ``scaled_dot_product_attention`` as the library yardstick,
              timed in turns with the kernel (kernel, SDPA, SDPA, kernel)
              at the prefill and at decode over 1,500 and 2,111 keys,
              and the card's own time per call of both and the kernel's
              device kernels per call (profiler); split-kv decode calls
              also against the plain split-kv algorithm.  WKV: the route
              each call took (``tensor_core`` for bf16 at Nk = Nv = 64,
              ``step`` otherwise), tensor-core calls also against their
              plain mirror ``wkv_subchunk_ref``, and both kernels'
              ``ptxas`` lines with the tensor-core kernel's shared memory
              and blocks an SM.  Head dims over
              128: MLA's absorbed attention at hd 576 (16 query heads on
              one latent kv head; a 1 x 2048 causal prefill on the CUDA
              cores, decode over 1,500 and over per-batch valid keys of a
              2,112-long cache on split-kv) and one odd shape at hd 192.
6. serve    — per arch: ``generate`` (8 prompts of 2,048 tokens; after a
              warm-up call, 1 new token three times for the time to first
              token, 32 new tokens twice: greedy output identical; medians
              of the host-clock walls), ``serve`` (12 requests, prompts of
              64-2,048 tokens, 8-32 new tokens), time to first token,
              decode ms per step, tokens/s, peak memory, a profiled decode
              step; then fp32 at full width: prefill and decode logits
              within 2e-3 of ``forward``'s.
7. card vs cpu — at each arch's ``reduced()`` config, the same weights on
              the card (kernels) and on the CPU (plain versions): the same
              greedy tokens, logits within 1e-4.
8. kernels line — one JSON object with all six kernels: launches on the
              main path and per path, and numbers at the main path's
              largest shape (library times in turns, device times per
              call); for flash and WKV, launches by route (for flash also
              the device kernels per call each route took in phase 5's
              profile).

Launch counts are read per call: zeroed just before every
``hybrid_shuffle``, ``run_job_distributed``, ``generate``, ``serve``,
``forward``, ``prefill`` and ``decode_step`` call and read just after (in
phase 4c, in every rank around each timed call).  A coded shuffle with
``combine_impl="kernel"`` and packet arity >= 2 must launch one encode
and one decode (on the process form, in every rank), other shuffles
none; ``coded_reduce_scatter_r2`` one encode per destination rack; under
faults that holds on the ``none`` and ``restart`` rungs, and the degraded
rungs (``decode_around``, ``partial_remap``: unicast stage 1) launch
none; every LM forward (a prefill or one decode step) must launch its
kernel once per layer (28 flash launches for qwen2-1.5b, 32 WKV launches
for rwkv6-3b) and call no plain version; every time-to-first-token call
runs all of them on the ``tensor_core`` route of its kernel.  Main paths:
the fused engine for the linear pair, the int32 ``hybrid_shuffle`` for
the XOR pair, full-width serving for the LM kernels; the combine
kernels' ``ranks`` path (phase 4c) and the linear pair's ``placed`` path
(phase 4d) must launch too.

The last line is ``{"ok": true, "device": {...}}``.  Any failed check
raises and the script exits non-zero; without a CUDA card it exits 1 and
prints no result.  Imports nothing of JAX or of the JAX package ``repro``.
"""
from __future__ import annotations

import argparse
import json
import math
import pathlib
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = pathlib.Path(__file__).resolve().parent
K, P, Q, N, D = 16, 4, 16, 1680, 2048
TOKENS = 16384
SOURCE = "src/repro_torch/kernels/coded_combine/csrc/coded_combine.cu"
DECODE_SOURCE = ("src/repro_torch/kernels/coded_combine/csrc/"
                 "linear_decode.cuh")
XOR_SOURCE = "src/repro_torch/kernels/coded_combine/csrc/xor_stream.cuh"
FLASH_SOURCE = ("src/repro_torch/kernels/flash_attention/csrc/"
                "flash_attention.cu")
WKV_SOURCE = "src/repro_torch/kernels/rwkv_scan/csrc/wkv_scan.cu"
REPLACES = {"coded_encode": "src/repro/kernels/coded_combine/kernel.py:58",
            "coded_decode": "src/repro/kernels/coded_combine/kernel.py:74",
            "xor_encode": "src/repro/kernels/coded_combine/kernel.py:91",
            "xor_decode": "src/repro/kernels/coded_combine/kernel.py:105",
            "flash_attention":
                "src/repro/kernels/flash_attention/kernel.py:74",
            "wkv_scan": "src/repro/kernels/rwkv_scan/kernel.py:77"}

# published peaks by the name nvidia-smi gives the card, at its full power
# limit (NVIDIA's data sheet, dense): HBM bytes/s, and the tensor cores'
# FLOP/s for each input dtype of the LM kernels (float32 inputs: the TF32
# rate, the fastest the card multiplies them).  "H100 80GB HBM3" is the SXM
# part.  The combine kernels do no multiply worth bounding (r - 1 adds or
# XORs per element read): their bound is bytes alone.
PEAKS = {"NVIDIA H100 80GB HBM3": {"hbm": 3.35e12, "bfloat16": 989e12,
                                   "float32": 495e12}}
KERNELS = ("coded_encode", "coded_decode", "xor_encode", "xor_decode")
LM_KERNELS = ("flash_attention", "wkv_scan")


def say(*parts) -> None:
    print(*parts, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def _tol_text(rtol: float, atol: float) -> str:
    return "exact" if rtol == atol == 0 else f"rtol={rtol},atol={atol}"


class Counts:
    """Zero every kernel's launch count (and its plain-version count) just
    before a call and read them just after: (fn(), launches, plain).  The
    routes of the last call are left in ``routes``, by kernel (flash and
    WKV both have a route named ``tensor_core``)."""

    def __init__(self, torch, mods):
        self.torch, self.mods = torch, mods
        self.routes = {}

    def __call__(self, fn):
        for m in self.mods:
            m.reset_launch_counts()
        out = fn()
        self.torch.cuda.synchronize()
        launches, plain, self.routes = {}, {}, {}
        for m in self.mods:
            launches.update(m.LAUNCHES)
            plain.update(getattr(m, "PLAIN_CALLS", {}))
            if hasattr(m, "ROUTE_CALLS"):
                (kname,) = m.LAUNCHES
                self.routes[kname] = dict(m.ROUTE_CALLS)
        return out, launches, plain


def expected_launches(multicast: str, combine_impl: str, arity: int,
                      rung: str = "none"):
    """The launches one stacked shuffle makes: one encode and one decode
    for all K servers when a coded format runs on the kernels.  Under
    faults, the ``none`` and ``restart`` rungs run that failure-free
    shuffle; the degraded rungs (``decode_around``, ``partial_remap``) run
    stage 1 as unicast and launch nothing."""
    want = dict.fromkeys(KERNELS, 0)
    if rung not in ("none", "restart"):
        return want
    if combine_impl == "kernel" and multicast != "unicast" and arity >= 2:
        pair = (("xor_encode", "xor_decode") if multicast == "coded_xor"
                else ("coded_encode", "coded_decode"))
        want.update(dict.fromkeys(pair, 1))
    return want


def add_counts(total, counts) -> None:
    for k, v in counts.items():
        total[k] += v


def cuda_ms(torch, fn, reps: int = 5, inner: int = 10) -> float:
    """Median over ``reps`` of the mean time of ``inner`` back-to-back
    calls, by CUDA events (one warm-up call first)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def device_per_call(torch, fn, calls: int = 20, sessions: int = 3,
                    tries: int = 9):
    """(the card's own ms per call of ``fn``, device kernels per call), by
    torch.profiler: the median over ``sessions`` profiles of ``calls``
    calls each (``profile_once``).  Unlike back-to-back CUDA-event timing,
    the host's enqueue cost does not enter the time.

    The median, because a session now and then reads a time that belongs
    to no call of its own (on the H100 with torch 2.11, one session of
    roughly twenty read the bf16 decode's time under the fp32 decode's
    name): sessions more than 1 % apart are printed.  A profile with no
    kernel record at all (several in a row, now and then) is printed and
    taken again a second later, ``tries`` profiles at most; the median is
    then over the sessions that held records."""
    takes = []
    for attempt in range(tries):
        got = profile_once(torch, fn, calls)
        if got is None:
            say(f"  profiler: no kernel record in profile {attempt + 1} of "
                f"at most {tries}, taken again")
            time.sleep(1.0)
            continue
        takes.append(got)
        if len(takes) == sessions:
            break
    if not takes:
        raise RuntimeError(f"profiler: no kernel record in {tries} profiles "
                           f"of {calls} calls")
    takes.sort()
    if takes[-1][0] > 1.01 * takes[0][0]:
        say(f"  profiler: sessions read {[round(t[0], 6) for t in takes]} "
            f"ms a call; the median is kept")
    return takes[len(takes) // 2]


def profile_once(torch, fn, calls: int):
    """(device ms per call, device kernels per call) of one profile of
    ``calls`` calls, or None when it holds no kernel record: for each
    kernel name (copies and fills not counted), its mean device time times
    its launches per call.

    Launches per call are each name's event count over ``calls``, rounded:
    the profiler often drops a few of a session's kernel records or hands
    them to the next session (on the H100 with torch 2.11: 17 or 18 of 20
    records in most profiles of a run), and a few records lost or gained
    must not move the time.  Every count that is not a whole multiple of
    ``calls`` is printed."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    ms, kernels = 0.0, 0
    for ev in prof.key_averages():
        if (not str(getattr(ev, "device_type", "")).endswith("CUDA")
                or ev.key.startswith(("Memcpy", "Memset"))):
            continue
        per_call = round(ev.count / calls)
        if ev.count % calls:
            say(f"  profiler: {ev.count} records of {ev.key[:60]} over "
                f"{calls} calls, counted as {per_call} a call")
        ms += device_us(ev) / 1e3 / ev.count * per_call
        kernels += per_call
    return (ms, kernels) if kernels else None


def bound(peaks, nbytes: float, flops: float = 0.0, dtype: str = ""):
    """(least time in ms the card needs, "bytes" or "operations"): the
    bytes over the HBM rate, or the FLOPs over the tensor cores' rate for
    the input dtype, whichever is larger.  No FLOPs: bound by bytes."""
    t_bytes = nbytes / peaks["hbm"] * 1e3
    t_ops = flops / peaks[dtype] * 1e3 if flops else 0.0
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# Phase 2: the four kernels against their plain versions
# ---------------------------------------------------------------------------

def combine_calls(torch, ops, ref, name, xs, c, f, unit):
    """(kernel, plain version, library call or None) of one combine kernel
    on [r, ...] streams ``xs`` (coefficients ``c``, packet ``f``; the
    decodes recover stream 0).  The library call is the one PyTorch call
    that computes the same function: ``xs.sum(0)`` and ``torch.sub`` for
    unit coefficients (the decode at r = 2), ``torch.bitwise_xor`` for
    int32 at r = 2."""
    known, r = xs[1:], xs.shape[0]
    if name == "coded_encode":
        return (lambda: ops.coded_encode(xs, c), lambda: ref.encode_ref(xs, c),
                (lambda: xs.sum(0)) if unit else None)
    if name == "coded_decode":
        return (lambda: ops.coded_decode(f, known, c),
                lambda: ref.decode_ref(f, known, c),
                (lambda: torch.sub(f, known[0])) if unit and r == 2 else None)
    words = xs.view(torch.int32)
    on_int = r == 2 and xs.dtype == torch.int32
    if name == "xor_encode":
        return (lambda: ops.xor_encode(xs), lambda: ref.xor_encode_ref(xs),
                (lambda: torch.bitwise_xor(words[0], words[1]))
                if on_int else None)
    return (lambda: ops.xor_decode(f, known),
            lambda: ref.xor_decode_ref(f, known),
            (lambda: torch.bitwise_xor(f, known[0])) if on_int else None)


def kernel_phase(torch, ops, ref, main_shapes, rank_shapes, grad_shape,
                 peaks, seed):
    """Compare and time every kernel; returns (rows, {kernel: row at the
    main path's largest launch shape}, main rows to profile).  Shapes: the
    main path's, the ranks path's (one server's coded shuffle; one
    destination of the coded gradient reduce-scatter, 0/1 coefficients),
    and odd ones.  A row with a library call times the kernel and the
    library in turns (kernel, library, library, kernel).  The main rows'
    device times per call come later (``profile_main_rows``): every
    profiler session here would cost the later phases' profiles
    records."""
    dev = torch.device("cuda")
    odd = [(r, T, d) for r in (2, 3, 4) for T, d in
           ((1, 7), (257, 40), (300, 130))]
    rows, main, to_profile = [], {}, []

    def record(name, r, T, d, dtype, coeffs, err, tol, fn, plain, library,
               is_main):
        n = T * d
        itemsize = torch.empty((), dtype=dtype).element_size()
        nbytes = (r + 1) * n * itemsize
        big = n >= 1 << 20
        reps, inner = (11, 40) if big else (5, 50)
        row = {"name": name, "r": r, "T": T, "d": d,
               "dtype": str(dtype).replace("torch.", ""),
               "coeffs": coeffs,
               "max_abs_err": err, "tolerance": tol,
               "plain_ms": cuda_ms(torch, plain, reps, inner),
               "library_ms": None, "bytes": nbytes}
        row["bound_ms"], row["bound_by"] = bound(peaks, nbytes)
        if library is None:
            row["ms"] = cuda_ms(torch, fn, reps, inner)
        else:
            # in turns: kernel, library, library, kernel
            turns = [cuda_ms(torch, f, reps, inner)
                     for f in (fn, library, library, fn)]
            row["ms_turns"] = [turns[0], turns[3]]
            row["library_ms_turns"] = [turns[1], turns[2]]
            row["ms"] = statistics.mean(row["ms_turns"])
            row["library_ms"] = statistics.mean(row["library_ms_turns"])
        rows.append(row)
        lib_ms = row["library_ms"]
        lib_txt = "null" if lib_ms is None else f"{lib_ms:.6f}"
        say(f"  kernel {name} r={r} T={T} d={d} {row['dtype']} "
            f"coeffs={row['coeffs']}: kernel_ms={row['ms']:.6f} "
            f"plain_ms={row['plain_ms']:.6f} library_ms={lib_txt} "
            f"bytes={nbytes} bound_ms={row['bound_ms']:.6f} bound / kernel "
            f"{row['bound_ms'] / row['ms']:.4f} max_abs_err={err!r} "
            f"tolerance={tol}")
        if library is not None:
            say(f"    in turns (kernel, library, library, kernel): "
                f"{turns[0]:.6f} {turns[1]:.6f} {turns[2]:.6f} "
                f"{turns[3]:.6f} ms; kernel / library "
                f"{row['ms'] / lib_ms:.4f}")
        if is_main:
            to_profile.append(row)
            main.setdefault(name, row)

    def err_of(a, b):
        return float((a.float() - b.float()).abs().max().item())

    g = torch.Generator(device=dev).manual_seed(seed)
    coeff_of = {"unit": lambda r: torch.ones(r, device=dev),
                "1..r": lambda r: torch.arange(1.0, r + 1.0, device=dev),
                "0/1": lambda r: torch.arange(r, device=dev) % 2 == 0}
    cases = ([(s, "unit", True) for s in main_shapes]
             + [(s, "unit", False) for s in rank_shapes]
             + [(grad_shape, "0/1", False)]
             + [(s, "1..r", False) for s in odd])
    for (r, T, d), coeffs, is_main in cases:
        unit = coeffs == "unit"           # the shuffle's coefficients
        for dtype in (torch.float32, torch.bfloat16):
            xs = torch.randn(r, T, d, generator=g, device=dev).to(dtype)
            c = coeff_of[coeffs](r).float()
            exact = unit and dtype == torch.float32
            enc_tol = (0.0 if exact else
                       1e-6 if dtype == torch.float32 else 3e-2)
            dec_tol = ((0.0, 0.0) if exact else
                       (1e-4, 1e-4) if dtype == torch.float32
                       else (1e-2, 0.15))
            f = ops.coded_encode(xs, c)
            f_ref = ref.encode_ref(xs, c)
            torch.testing.assert_close(f, f_ref, rtol=enc_tol, atol=enc_tol)
            dec = ops.coded_decode(f, xs[1:], c)
            dec_ref = ref.decode_ref(f, xs[1:], c)
            torch.testing.assert_close(dec, dec_ref, rtol=dec_tol[0],
                                       atol=dec_tol[1])
            # the round trip of tests/test_kernels.py (decode of stream 0)
            rt = (1e-4, 1e-4) if dtype == torch.float32 else (1e-2, 0.15)
            torch.testing.assert_close(dec, xs[0], rtol=rt[0], atol=rt[1])
            is_f32 = dtype == torch.float32
            record("coded_encode", r, T, d, dtype, coeffs, err_of(f, f_ref),
                   _tol_text(enc_tol, enc_tol),
                   *combine_calls(torch, ops, ref, "coded_encode", xs, c, f,
                                  unit), is_main and is_f32)
            record("coded_decode", r, T, d, dtype, coeffs,
                   err_of(dec, dec_ref), _tol_text(*dec_tol),
                   *combine_calls(torch, ops, ref, "coded_decode", xs, c, f,
                                  unit), is_main)
        # XOR takes no coefficients: the 0/1 gradient row is linear only
        for dtype in (torch.int32, torch.uint32) if coeffs != "0/1" else ():
            xs = torch.randint(0, 2 ** 30, (r, T, d), generator=g,
                               device=dev, dtype=torch.int32).view(dtype)
            words = xs.view(torch.int32)
            f = ops.xor_encode(xs)
            check(torch.equal(f.view(torch.int32),
                              ref.xor_encode_ref(xs).view(torch.int32)),
                  f"xor_encode r={r} T={T} d={d} {dtype}")
            dec = ops.xor_decode(f, xs[1:])
            check(torch.equal(dec.view(torch.int32), words[0]),
                  f"xor_decode r={r} T={T} d={d} {dtype}")
            is_int = dtype == torch.int32
            for name in ("xor_encode", "xor_decode"):
                record(name, r, T, d, dtype, coeffs, 0.0, "exact",
                       *combine_calls(torch, ops, ref, name, xs, None, f,
                                      True), is_main and is_int and r == 2)
        del xs
    torch.cuda.synchronize()
    return rows, main, to_profile


def profile_main_rows(torch, ops, ref, to_profile, seed):
    """Phase 2's main rows: the kernel's and the library call's device time
    per call (profiler), into each row, on inputs drawn anew at the row's
    shape (a device time does not depend on the values; holding phase 2's
    inputs to the end would add some 1.2 GB to the serving phases' peak
    memory)."""
    g = torch.Generator(device="cuda").manual_seed(seed + 404)
    for row in to_profile:
        r, T, d, name = row["r"], row["T"], row["d"], row["name"]
        if name.startswith("coded"):
            xs = torch.randn(r, T, d, generator=g, device="cuda").to(
                getattr(torch, row["dtype"]))
            c = torch.ones(r, device="cuda")
            f = ops.coded_encode(xs, c)
        else:
            xs = torch.randint(0, 2 ** 30, (r, T, d), generator=g,
                               device="cuda", dtype=torch.int32)
            c, f = None, ops.xor_encode(xs)
        fn, _, library = combine_calls(torch, ops, ref, name, xs, c, f, True)
        row["device_ms"], _ = device_per_call(torch, fn)
        row["library_device_ms"] = (None if library is None else
                                    device_per_call(torch, library)[0])
        lib_dev = row["library_device_ms"]
        say(f"  kernel {row['name']} r={row['r']} T={row['T']} d={row['d']} "
            f"{row['dtype']}: device time per call (profiler) kernel "
            f"{row['device_ms']:.6f} ms, library "
            f"{'null' if lib_dev is None else f'{lib_dev:.6f} ms'}"
            + ("" if lib_dev is None else
               f"; kernel / library {row['device_ms'] / lib_dev:.4f}")
            + f"; bound / kernel {row['bound_ms'] / row['device_ms']:.4f}")


def ptxas_entries(log: str, needle: str):
    """``ptxas -v`` lines (entry, stack and spills, registers) of every
    entry function whose mangled name holds ``needle``."""
    out, keep = [], False
    for line in log.splitlines():
        if "Compiling entry function" in line:
            keep = needle in line
        if keep and ("Compiling entry function" in line
                     or "registers" in line or "spill" in line):
            out.append(line.strip())
    return out


# ---------------------------------------------------------------------------
# Phase 3: the stacked shuffle against the NumPy oracles
# ---------------------------------------------------------------------------

def shuffle_phase(torch, np, cc, count, make_mesh, SchemeParams, seed):
    mesh = make_mesh((P, K // P), ("rack", "server"))
    rng = np.random.default_rng(seed + 1)
    runs, total = [], dict.fromkeys(KERNELS, 0)
    for r in (2, 3):
        p = SchemeParams(K=K, P=P, Q=Q, N=N, r=r)
        plan = cc.compile_hybrid_plan(p)
        for dtype, modes in ((np.float32, ("unicast", "coded")),
                             (np.int32, ("coded_xor",))):
            hi = 100 if dtype == np.float32 else 2 ** 30
            V = rng.integers(-hi if dtype == np.float32 else 0, hi,
                             size=(N, Q, D)).astype(dtype)
            ref = cc.plan_shuffle_reference(V, p)
            ref_dev = torch.as_tensor(ref, device=mesh.device)
            local = torch.as_tensor(cc.pack_local_values(V, plan),
                                    device=mesh.device)
            for mc in modes:
                # the NumPy re-execution of the wire format is an oracle too
                check(np.array_equal(cc.simulate_plan_shuffle(V, plan, mc),
                                     ref), f"simulate r={r} {mc}")
                for impl in ("torch", "kernel"):
                    def run():
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        out = cc.hybrid_shuffle(local, plan, mesh, mc, impl)
                        torch.cuda.synchronize()
                        return out, (time.perf_counter() - t0) * 1e3
                    (out, ms), counts, _ = count(run)
                    tag = f"hybrid_shuffle r={r} {mc} {impl}"
                    check(torch.equal(out, ref_dev), tag)
                    check(counts == expected_launches(mc, impl,
                                                      plan.mcast_arity),
                          f"{tag} launches {counts}")
                    add_counts(total, counts)
                    runs.append({"r": r, "multicast": mc,
                                 "combine_impl": impl,
                                 "dtype": np.dtype(dtype).name, "ms": ms,
                                 "launches": counts})
                    say(f"  shuffle r={r} {mc} {impl} "
                        f"{np.dtype(dtype).name} d={D}: bit-exact, "
                        f"wall_ms={ms:.3f} launches={counts}")
            del ref_dev, local
    return runs, total


# ---------------------------------------------------------------------------
# Phase 4: the engine, fused and legacy
# ---------------------------------------------------------------------------

def engine_phase(torch, np, eng, jobs, count, make_mesh, SchemeParams,
                 costs, reconcile, seed):
    mesh = make_mesh((P, K // P), ("rack", "server"))
    rng = np.random.default_rng(seed)
    subfiles = rng.integers(0, 1 << 16, size=(N, TOKENS)).astype(np.int32)
    job = jobs.wide_histogram_job(D)
    base = SchemeParams(K=K, P=P, Q=Q, N=N, r=2)
    dense = eng.run_job(job, subfiles, base, "hybrid").outputs
    torch.cuda.synchronize()
    check(tuple(dense.shape) == (Q, D) and bool(torch.isfinite(dense).all()),
          "dense run_job output shape / finiteness")
    runs = []
    totals = {path: dict.fromkeys(KERNELS, 0) for path in ("fused", "legacy")}
    configs = [("binomial", 1), ("binomial", 2), ("binomial", 3),
               ("resolvable", 2)]
    for fused in (True, False):
        path = "fused" if fused else "legacy"
        for family, r in configs:
            p = SchemeParams(K=K, P=P, Q=Q, N=N, r=r)
            scheme = "hybrid" if family == "binomial" else \
                "hybrid_resolvable"
            closed = (costs.hybrid_cost(p) if family == "binomial"
                      else costs.hybrid_resolvable_cost(p))
            # binomial packets carry r components, resolvable ones r - 1
            arity = r if family == "binomial" else r - 1
            for mc in ("unicast", "coded"):
                for impl in ("torch", "kernel"):
                    tag = f"{path} {family} r={r} {mc} {impl}"
                    want = expected_launches(mc, impl, arity)
                    walls = []
                    for _ in range(2):              # cold, then warm
                        def run():
                            t0 = time.perf_counter()
                            res = eng.run_job_distributed(
                                job, subfiles, p, mesh, fused=fused,
                                multicast=mc, combine_impl=impl,
                                scheme_family=family)
                            return res, (time.perf_counter() - t0) * 1e3
                        (res, ms), counts, _ = count(run)
                        walls.append(ms)
                        check(counts == want, f"engine {tag} launches "
                              f"{counts}, expected {want}")
                        add_counts(totals[path], counts)
                    check(torch.equal(res.outputs, dense),
                          f"engine {tag} outputs == run_job")
                    check((res.intra_cost, res.cross_cost)
                          == (closed.intra, closed.cross),
                          f"engine {tag} costs == closed form")
                    reconcile(res.intra_rack_bytes, res.cross_rack_bytes, p,
                              scheme, d=D, check=True)
                    runs.append({"fused": fused, "family": family, "r": r,
                                 "multicast": mc, "combine_impl": impl,
                                 "cold_ms": walls[0], "warm_ms": walls[1],
                                 "launches_per_job": want})
                    say(f"  engine {tag}: bit-exact vs run_job, costs and "
                        f"rack bytes = closed form, cold_ms={walls[0]:.3f} "
                        f"warm_ms={walls[1]:.3f} launches_per_job={want}")
    return runs, totals, subfiles, job, mesh


def profile_fused(torch, eng, count, job, subfiles, mesh, SchemeParams,
                  enable_tracing):
    """Device time by kernel, and the engine's host spans, for one warm
    fused r=2 coded/kernel job; also its launch counts."""
    from torch.profiler import ProfilerActivity, profile
    p = SchemeParams(K=K, P=P, Q=Q, N=N, r=2)
    kw = dict(fused=True, multicast="coded", combine_impl="kernel")
    eng.run_job_distributed(job, subfiles, p, mesh, **kw)
    enable_tracing(True)
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            def run():
                t0 = time.perf_counter()
                res = eng.run_job_distributed(job, subfiles, p, mesh, **kw)
                return res, (time.perf_counter() - t0) * 1e3
            (res, wall_ms), counts, _ = count(run)
    finally:
        enable_tracing(False)
    check(counts == expected_launches("coded", "kernel", 2),
          f"profiled fused job launches {counts}")
    busy, by_kernel = device_time(prof)
    # the engine's engine_phase spans, host clock, in ms
    spans = {k: v * 1e3 for k, v in (res.blame or {}).items()}
    return {"wall_ms": wall_ms, "device_busy_ms": busy, "span_ms": spans,
            "launches": counts, "by_kernel": by_kernel}


def device_us(ev) -> float:
    """A profiler event's summed device time in microseconds (its field
    is ``device_time_total`` in newer torch, ``cuda_time_total`` before)."""
    dev_us = getattr(ev, "device_time_total", None)
    return getattr(ev, "cuda_time_total", 0.0) if dev_us is None else dev_us


def device_time(prof):
    """(device busy ms, the 12 largest device-time entries) of a
    torch.profiler run."""
    top = []
    for ev in prof.key_averages():
        # device-side events (the kernels and copies themselves) only, so
        # an operator and the kernels it launched are not counted twice
        if not str(getattr(ev, "device_type", "")).endswith("CUDA"):
            continue
        dev_us = device_us(ev)
        if dev_us > 0:
            top.append((dev_us / 1e3, ev.count, ev.key))
    top.sort(reverse=True)
    return (sum(t for t, _, _ in top),
            [{"ms": t, "count": c, "name": k[:100]} for t, c, k in top[:12]])


# ---------------------------------------------------------------------------
# Phase 4b: the engine under faults (the recovery ladder)
# ---------------------------------------------------------------------------

def faults_phase(torch, np, eng, count, job, subfiles, mesh, SchemeParams,
                 dg, faults, degraded_rack_bytes, smi):
    """The recovery ladder at the Table I row on phase 4's subfiles: each
    configuration under three crash schedules (degraded rungs, asked for
    the coded format on the kernels, which they must not launch), then
    every server dead on attempt 0 (the restart rung: one coded kernel
    job).  Outputs bit-identical to the failure-free fused job; walls by
    the host clock around a call ending in ``torch.cuda.synchronize()``,
    the median of three calls after a warm one."""
    runs, total = [], dict.fromkeys(KERNELS, 0)

    def timed(fn, what, faulted=True, reps=3):
        """(output of the last call, median wall ms, launches of one call):
        every counted call must launch the same kernels; the faulted
        calls' launches make the path's total."""
        fn()                                              # warm
        walls, seen = [], []
        for _ in range(reps):
            def run():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn()
                torch.cuda.synchronize()
                return out, (time.perf_counter() - t0) * 1e3
            (out, ms), counts, _ = count(run)
            walls.append(ms)
            seen.append(counts)
            if faulted:
                add_counts(total, counts)
        check(all(c == seen[0] for c in seen),
              f"faults {what}: launches differ between calls {seen}")
        return out, statistics.median(walls), seen[0]

    kw = dict(multicast="coded", combine_impl="kernel")
    for family, r in (("binomial", 1), ("binomial", 2), ("binomial", 3),
                      ("resolvable", 2)):
        p = SchemeParams(K=K, P=P, Q=Q, N=N, r=r)
        clean, clean_ms, _ = timed(lambda: eng.run_job_distributed(
            job, subfiles, p, mesh, scheme_family=family, **kw),
            f"{family} r={r} failure-free", faulted=False)
        base_send = eng.compile_hybrid_plan(p, family=family).n_send
        say(f"  faults {family} r={r} failure-free fused job: "
            f"wall_ms={clean_ms:.3f} n_send={base_send} [{smi}]")
        for name, inj in (("crash(3)", faults.FaultInjector.crash((3,))),
                          ("crash(0,5)",
                           faults.FaultInjector.crash((0, 5))),
                          ("rack_crash(1)",
                           faults.FaultInjector.rack_crash(p, 1))):
            tag = f"{family} r={r} {name}"
            res, ms, counts = timed(lambda: eng.run_job_distributed(
                job, subfiles, p, mesh, scheme_family=family,
                faults=faults.FaultSpec(inj), **kw), tag)
            rep = res.recovery
            dplan = dg.compile_degraded_plan(p, rep.failed, family=family)
            n_orph = int(dplan.orphan_subfiles.size)
            check(torch.equal(res.outputs, clean.outputs),
                  f"faults {tag}: outputs == failure-free fused job")
            want_rung = "partial_remap" if n_orph else "decode_around"
            check(rep.rung == want_rung and rep.n_remapped == n_orph
                  and (n_orph > 0) == (rep.rung == "partial_remap"),
                  f"faults {tag}: rung {rep.rung} n_remapped "
                  f"{rep.n_remapped}, expected {want_rung} {n_orph}")
            check(counts == expected_launches(kw["multicast"],
                                              kw["combine_impl"], r,
                                              rep.rung),
                  f"faults {tag}: a degraded rung launched {counts}")
            rb = degraded_rack_bytes(dplan, D)
            check((res.intra_rack_bytes, res.cross_rack_bytes)
                  == (rb.intra_total, rb.cross_total),
                  f"faults {tag}: rack bytes == degraded_rack_bytes")
            patch_bytes = (K * p.subfiles_per_layer * (Q // P) * D * 4
                           if n_orph else 0)
            runs.append({"family": family, "r": r, "schedule": name,
                         "failed": list(rep.failed), "rung": rep.rung,
                         "n_remapped": rep.n_remapped, "wall_ms": ms,
                         "clean_wall_ms": clean_ms,
                         "n_send": dplan.plan.n_send,
                         "base_n_send": base_send,
                         "patch_bytes": patch_bytes,
                         "cross_rack_bytes": res.cross_rack_bytes,
                         "launches": counts})
            say(f"  faults {tag}: {rep.rung} n_remapped={rep.n_remapped} "
                f"bit-exact, wall_ms={ms:.3f} (failure-free "
                f"{clean_ms:.3f}) n_send={dplan.plan.n_send} "
                f"patch_bytes={patch_bytes} launches={counts} [{smi}]")
        del clean
    # every server dead on attempt 0: the restart rung reruns the
    # failure-free coded kernel job
    p = SchemeParams(K=K, P=P, Q=Q, N=N, r=2)
    clean = eng.run_job_distributed(job, subfiles, p, mesh, **kw)
    spec = faults.FaultSpec(faults.FaultInjector.crash(tuple(range(K))),
                            max_restarts=2)
    res, ms, counts = timed(lambda: eng.run_job_distributed(
        job, subfiles, p, mesh, faults=spec, **kw), "all dead")
    rep = res.recovery
    check(rep.rung == "restart" and rep.restarts == 1
          and len(rep.backoff_delays) == 1,
          f"faults all dead: {rep}")
    check(torch.equal(res.outputs, clean.outputs),
          "faults all dead: outputs == failure-free fused job")
    check(counts == expected_launches("coded", "kernel", 2, rep.rung),
          f"faults all dead: restart launches {counts}")
    runs.append({"family": "binomial", "r": 2, "schedule": "all dead",
                 "rung": rep.rung, "restarts": rep.restarts,
                 "backoff_delays": list(rep.backoff_delays),
                 "wall_ms": ms, "launches": counts})
    say(f"  faults binomial r=2 all {K} dead: restart restarts=1 "
        f"backoff_s={rep.backoff_delays[0]:.6f} (recorded, not slept) "
        f"bit-exact, wall_ms={ms:.3f} launches={counts} [{smi}]")
    # one phase-timing row at the same configuration
    row = eng.measure_phase_timings(job, subfiles, p, mesh, iters=3)
    secs = dict(row["seconds"], shuffle=row["meta"]["shuffle_s"])
    check(row["meta"]["backend"] == "cuda"
          and all(math.isfinite(v) and v > 0 for v in secs.values()),
          f"measure_phase_timings: every phase finite and > 0: {secs}")
    say("  measure_phase_timings binomial r=2 (ms): " + " ".join(
        f"{k}={v * 1e3:.3f}" for k, v in secs.items()) + f" [{smi}]")
    return runs, total, row


# ---------------------------------------------------------------------------
# Phase 4c: the process form, one server a rank (16 ranks on the card)
# ---------------------------------------------------------------------------

# (fused, family, r, multicast, combine_impl) of every ranks job
RANK_JOBS = ([(True, "binomial", r, mc, impl) for r in (1, 2, 3)
              for mc, impl in (("unicast", "torch"), ("coded", "kernel"))]
             + [(True, "resolvable", 2, "coded", "kernel"),
                (False, "binomial", 2, "coded", "kernel")])
# one Qwen2-1.5B MLP projection: 1536 x 8960 gradient entries a chunk
GRAD_G = 1536 * 8960


def _device_sync(torch, dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _grad_chunk(np, coefs, c: int, lo: int, hi: int):
    """Entries [lo, hi) of gradient chunk ``c``: integer-valued float32 in
    [-1019, 1019] (six chunks sum exactly in any order), from the seeded
    ``coefs``; any slice is made without the rest of the chunk."""
    a, b = (int(v) for v in coefs[c])
    idx = np.arange(lo, hi, dtype=np.int64)
    return ((idx * a + b) % 2039 - 1019).astype(np.float32)


def _xor_payload(np, seed: int, size):
    """The int32 shuffle payload V[n, q, :] = base[n, q] ^ col, from
    ``seed``: any rows are made without the rest."""
    K_, P_, Q_, N_, D_ = size
    rng = np.random.default_rng(seed + 2)
    return (rng.integers(0, 2 ** 30, size=(N_, Q_), dtype=np.int64),
            rng.integers(0, 2 ** 30, size=D_, dtype=np.int64))


def ranks_rank(dev, seed: int, size, tokens: int, grad_G: int):
    """What each rank of phase 4c runs (module level: the ranks import it
    by name).  Every timed call starts after a barrier, with the launch
    counts zeroed just before it and read just after."""
    import hashlib
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.core import coded_collectives as cc
    from repro_torch.core import gradient_sync as gs
    from repro_torch.core.params import SchemeParams
    from repro_torch.distributed.collectives import all_to_all
    from repro_torch.distributed.meshes import make_process_mesh
    from repro_torch.kernels.coded_combine import ops
    from repro_torch.mapreduce import engine as eng
    from repro_torch.mapreduce import jobs
    from repro_torch.obs.tracing import enable_tracing

    t_ready = time.time()
    enable_tracing(True)               # this rank's engine spans (blame)
    K_, P_, Q_, N_, D_ = size
    mesh = make_process_mesh((P_, K_ // P_), ("rack", "server"), device=dev)
    dist.barrier()
    t_mesh = time.time()
    i, j = mesh.coords

    def timed(fn, reps=3):
        """(last output, host ms of each call, launches of each call)."""
        fn()                                                  # warm
        walls, launches = [], []
        for _ in range(reps):
            dist.barrier()
            ops.reset_launch_counts()
            _device_sync(torch, dev)
            t0 = time.perf_counter()
            out = fn()
            _device_sync(torch, dev)
            walls.append((time.perf_counter() - t0) * 1e3)
            launches.append(dict(ops.LAUNCHES))
        return out, walls, launches

    # the engine, on phase 4's subfiles (each rank draws them from --seed)
    subfiles = np.random.default_rng(seed).integers(
        0, 1 << 16, size=(N_, tokens)).astype(np.int32)
    job = jobs.wide_histogram_job(D_)
    res_jobs = {}
    for cfg in RANK_JOBS:
        fused, family, r, mc, impl = cfg
        p = SchemeParams(K=K_, P=P_, Q=Q_, N=N_, r=r)
        res, walls, launches = timed(lambda: eng.run_job_distributed(
            job, subfiles, p, mesh, fused=fused, multicast=mc,
            combine_impl=impl, scheme_family=family))
        res_jobs[cfg] = {"outputs": res.outputs.cpu(),
                         "device": res.outputs.device.type,
                         "spans_s": res.blame,
                         "costs": (res.intra_cost, res.cross_cost,
                                   res.intra_rack_bytes,
                                   res.cross_rack_bytes),
                         "walls_ms": walls, "launches": launches}
    del subfiles

    # the exchanges alone at the r = 2 shuffle's shapes: stage 1 over
    # 'rack' ([P * n_send, q_rack, d]), stage 2 over 'server' ([Kr,
    # n_layer, q_srv, d]), float32
    p = SchemeParams(K=K_, P=P_, Q=Q_, N=N_, r=2)
    plan = cc.compile_hybrid_plan(p)
    stage1 = torch.zeros((P_ * plan.n_send, Q_ // P_, D_), device=dev)
    stage2 = torch.zeros((p.Kr, p.subfiles_per_layer, Q_ // K_, D_),
                         device=dev)
    _, s1_ms, _ = timed(lambda: all_to_all(stage1, mesh, "rack"))
    _, s2_ms, _ = timed(lambda: all_to_all(stage2, mesh, "server"))
    del stage1, stage2

    # the coded_xor shuffle at r = 2 on int32 payloads, held in the rank
    # against its rows of the NumPy reference
    base, col = _xor_payload(np, seed, size)
    local = (base[plan.local_subfiles[i, j]][..., None] ^ col).astype(
        np.int32)                                             # [n_loc, Q, d]
    order = cc.reduce_ready_order(plan)[i, j]                 # [N]
    keys = list(p.keys_of_server(mesh.rank))
    want = (base[order][:, keys][..., None] ^ col).astype(np.int32)
    out, xor_ms, xor_launches = timed(lambda: cc.hybrid_shuffle(
        local, plan, mesh, "coded_xor", "kernel"))
    out = out.cpu().numpy()
    xor = {"exact": bool(np.array_equal(out, want)),
           "sha256": hashlib.sha256(out.tobytes()).hexdigest(),
           "walls_ms": xor_ms, "launches": xor_launches}
    del local, want, out

    # the coded gradient reduce-scatter: this rack's P - 1 chunks on the
    # card, its shard of the total from NumPy
    coefs = np.random.default_rng(seed + 3).integers(1, 2 ** 20, size=(6, 2))
    rack = mesh.axis_index("rack")
    shard = grad_G // P_
    total = sum(_grad_chunk(np, coefs, c, rack * shard, (rack + 1) * shard)
                for c in range(6))
    idx = torch.arange(grad_G, dtype=torch.int64, device=dev)
    cg = torch.stack([((idx * int(coefs[c][0]) + int(coefs[c][1])) % 2039
                       - 1019).to(torch.float32)
                      for c in gs.chunk_index_table(P_)[rack]])   # [P-1, G]
    del idx
    grad = {}
    for failed in (None, 3):
        got, ms, launches = timed(lambda: gs.coded_reduce_scatter_r2(
            cg, mesh, "rack", P_, failed=failed, combine_impl="kernel"))
        grad[failed] = {"exact": bool(np.array_equal(got.cpu().numpy(),
                                                     total)),
                        "survivor": rack != failed, "device": got.device.type,
                        "walls_ms": ms, "launches": launches}
    return {"rank": mesh.rank, "t_ready": t_ready, "t_mesh": t_mesh,
            "device": str(dev), "jobs": res_jobs, "xor": xor, "grad": grad,
            "stage1_ms": s1_ms, "stage2_ms": s2_ms}


def _max_median(walls_by_rank):
    """Median over calls of the slowest rank's wall in each call."""
    return statistics.median(max(call) for call in zip(*walls_by_rank))


def ranks_phase(torch, np, eng, cc, run_ranks, make_mesh, SchemeParams,
                costs, dev, size, tokens, grad_G, seed, subfiles, smi):
    """Phase 4c: 16 ranks on one card (gloo: NCCL refuses two ranks on one
    device), spawned once; see :func:`ranks_rank` for what each runs.
    Holds every rank's job outputs bit for bit against the stacked job's
    (timed here the same way: median of three after a warm call) and
    ``dense``, its shuffle against the stacked shuffle's rows, its launches
    against one server's, and its device.  ``subfiles`` are phase 4's,
    which every rank draws from ``seed`` itself."""
    import hashlib
    from repro_torch.kernels.coded_combine import ops
    from repro_torch.mapreduce import jobs

    K_, P_, Q_, N_, D_ = size
    mesh = make_mesh((P_, K_ // P_), ("rack", "server"), device=dev)
    job = jobs.wide_histogram_job(D_)
    dense = eng.run_job(job, subfiles, SchemeParams(K=K_, P=P_, Q=Q_, N=N_,
                                                    r=2), "hybrid",
                        device=dev).outputs

    def stacked_timed(fn):
        fn()
        walls = []
        for _ in range(3):
            _device_sync(torch, dev)
            t0 = time.perf_counter()
            out = fn()
            _device_sync(torch, dev)
            walls.append((time.perf_counter() - t0) * 1e3)
        return out, statistics.median(walls)

    stacked = {}
    for cfg in RANK_JOBS:
        fused, family, r, mc, impl = cfg
        p = SchemeParams(K=K_, P=P_, Q=Q_, N=N_, r=r)
        stacked[cfg] = stacked_timed(lambda: eng.run_job_distributed(
            job, subfiles, p, mesh, fused=fused, multicast=mc,
            combine_impl=impl, scheme_family=family))
    p2 = SchemeParams(K=K_, P=P_, Q=Q_, N=N_, r=2)
    plan = cc.compile_hybrid_plan(p2)
    base, col = _xor_payload(np, seed, size)
    V = torch.as_tensor(cc.pack_local_values(
        (base[..., None] ^ col).astype(np.int32), plan), device=dev)
    xor_out, xor_stacked_ms = stacked_timed(lambda: cc.hybrid_shuffle(
        V, plan, mesh, "coded_xor", "kernel"))
    xor_digests = [hashlib.sha256(o.cpu().numpy().tobytes()).hexdigest()
                   for o in xor_out]
    del V, xor_out

    t0 = time.time()
    per_rank = run_ranks(ranks_rank, K_, backend="gloo", device=dev.type,
                         args=(seed, size, tokens, grad_G), timeout_s=600)
    wall_s = time.time() - t0
    ready_s = max(r["t_ready"] for r in per_rank) - t0
    mesh_s = max(r["t_mesh"] for r in per_rank) - t0
    total = dict.fromkeys(KERNELS, 0)
    rows = []
    for rank, res in enumerate(per_rank):
        check(res["rank"] == rank and res["device"].startswith(dev.type),
              f"ranks: rank {rank} ran as {res['rank']} on {res['device']}")
    for cfg in RANK_JOBS:
        fused, family, r, mc, impl = cfg
        p = SchemeParams(K=K_, P=P_, Q=Q_, N=N_, r=r)
        closed = (costs.hybrid_cost(p) if family == "binomial"
                  else costs.hybrid_resolvable_cost(p))
        arity = r if family == "binomial" else r - 1
        want = expected_launches(mc, impl, arity)
        tag = (f"{'fused' if fused else 'legacy'} {family} r={r} {mc} "
               f"{impl}")
        s_out, s_ms = stacked[cfg]
        check(torch.equal(s_out.outputs, dense),
              f"ranks {tag}: stacked outputs == run_job")
        ref = s_out.outputs.cpu()
        for rank, res in enumerate(per_rank):
            got = res["jobs"][cfg]
            check(got["device"] == dev.type and torch.equal(got["outputs"],
                                                            ref),
                  f"ranks {tag}: rank {rank}'s outputs == the stacked job's "
                  f"and run_job's, on {got['device']}")
            check(got["costs"][:2] == (closed.intra, closed.cross)
                  and got["costs"][2:] == (s_out.intra_rack_bytes,
                                           s_out.cross_rack_bytes),
                  f"ranks {tag}: rank {rank}'s costs {got['costs']}")
            for counts in got["launches"]:
                check(counts == want, f"ranks {tag}: rank {rank} launched "
                      f"{counts}, one server's are {want}")
                add_counts(total, counts)
        ms = _max_median([res["jobs"][cfg]["walls_ms"] for res in per_rank])
        # the engine's spans of the last timed call, slowest rank each
        spans = {k: max(res["jobs"][cfg]["spans_s"][k] for res in per_rank)
                 * 1e3 for k in per_rank[0]["jobs"][cfg]["spans_s"]}
        rows.append({"config": tag, "ranks_wall_ms": ms,
                     "stacked_wall_ms": s_ms, "span_ms": spans,
                     "launches_per_rank": want})
        say(f"  ranks {tag}: {K_} ranks bit-exact vs the stacked job and "
            f"run_job, wall_ms={ms:.3f} (stacked {s_ms:.3f}) spans (host "
            f"ms, slowest rank) " + " ".join(f"{k}={v:.3f}" for k, v in
                                             spans.items())
            + f" launches_per_rank={want} [{smi}]")
    # the coded_xor shuffle
    want = expected_launches("coded_xor", "kernel", 2)
    for rank, res in enumerate(per_rank):
        x = res["xor"]
        check(x["exact"] and x["sha256"] == xor_digests[rank],
              f"ranks coded_xor shuffle: rank {rank} == the reference and "
              f"the stacked shuffle's rows")
        for counts in x["launches"]:
            check(counts == want, f"ranks coded_xor: rank {rank} launched "
                  f"{counts}")
            add_counts(total, counts)
    xor_ms = _max_median([res["xor"]["walls_ms"] for res in per_rank])
    say(f"  ranks hybrid_shuffle r=2 coded_xor kernel int32 d={D_}: "
        f"bit-exact vs the reference and the stacked shuffle, "
        f"wall_ms={xor_ms:.3f} (stacked {xor_stacked_ms:.3f}) "
        f"launches_per_rank={want} [{smi}]")
    # the gradient reduce-scatter
    grad_rows = {}
    for failed in (None, 3):
        want = dict(dict.fromkeys(KERNELS, 0), coded_encode=P_)
        for rank, res in enumerate(per_rank):
            g = res["grad"][failed]
            check(g["device"] == dev.type and
                  (g["exact"] or not g["survivor"]),
                  f"ranks coded_reduce_scatter_r2 failed={failed}: rank "
                  f"{rank}'s shard == the NumPy total")
            for counts in g["launches"]:
                check(counts == want, f"ranks coded_reduce_scatter_r2: rank "
                      f"{rank} launched {counts}")
                add_counts(total, counts)
        ms = _max_median([res["grad"][failed]["walls_ms"]
                          for res in per_rank])
        grad_rows[str(failed)] = ms
        say(f"  ranks coded_reduce_scatter_r2 kernel G={grad_G} "
            f"failed={failed}: every survivor's shard == the NumPy total, "
            f"wall_ms={ms:.3f} launches_per_rank={want} [{smi}]")
    s1 = _max_median([res["stage1_ms"] for res in per_rank])
    s2 = _max_median([res["stage2_ms"] for res in per_rank])
    say(f"  ranks exchanges alone at the r=2 shapes: stage 1 over 'rack' "
        f"{s1:.3f} ms, stage 2 over 'server' {s2:.3f} ms [{smi}]")
    say(f"  ranks spawn and rendezvous: every rank in its world "
        f"{ready_s:.3f} s and its mesh {mesh_s:.3f} s after the spawn; "
        f"the phase's ranks ran {wall_s:.3f} s")
    say("  ranks collectives: dist.all_to_all_single and dist.all_gather on "
        "CUDA tensors (gloo); staged through the host: none")
    say(f"  ranks nccl: not run: {torch.cuda.device_count()} card(s) here "
        f"and NCCL refuses two ranks on one device; run_ranks(backend="
        f"'nccl') puts rank k on cuda:k and needs a card a rank")
    return {"jobs": rows, "xor_wall_ms": xor_ms,
            "xor_stacked_wall_ms": xor_stacked_ms,
            "grad_wall_ms": grad_rows, "grad_G": grad_G,
            "stage1_ms": s1, "stage2_ms": s2, "ready_s": ready_s,
            "mesh_s": mesh_s, "ranks_s": wall_s, "staged": [],
            "nccl": "not run: one card"}, total


# ---------------------------------------------------------------------------
# Phase 4d: Section IV — placement, the simulator it feeds, a placed job
# ---------------------------------------------------------------------------

TABLE2_SOLVERS = ("random", "greedy", "flow", "local_search", "anneal")
DETERMINISTIC = ("random", "greedy", "flow", "local_search")
STAT_FIELDS = ("node_mean", "node_std", "rack_mean", "rack_std",
               "objective_mean")
# BENCH_locality.json was written by the JAX package's
# benchmarks/table2_locality.py from the same NumPy draws and arithmetic,
# so its statistics and simulated JCTs are expected bit-equal.  The 1e-12
# relative tolerance only leaves room for a NumPy on this machine that
# rounds the last place of a mean or std of five float64 values
# differently; any solver difference moves them by 1e-3 or more.
BENCH_RTOL = 1e-12


def _close(a: float, b: float) -> bool:
    return abs(a - b) <= BENCH_RTOL * max(abs(a), abs(b))


def table2_phase(np, pl, sim, SchemeParams, smi):
    """Phase 4d (a): the ten Table II rows of ``BENCH_locality.json`` with
    the benchmark's solver settings, the annealer on the card."""
    bench = json.loads((ROOT / "BENCH_locality.json").read_text())
    cl = bench["time_units_cluster"]
    kw = {"anneal": {"init_solvers": ("flow", "greedy"), "n_chains": 64,
                     "n_steps": 1000, "device": "cuda"},
          "local_search": {"max_sweeps": 20}}
    rows, exact = [], True
    for row, trow in zip(bench["table2"], bench["table2_time_units"]):
        K_, P_, r_f, N_ = row["params"]
        check(trow["params"] == row["params"],
              f"BENCH_locality.json rows align: {trow['params']}")
        p = SchemeParams(K=K_, P=P_, Q=K_, N=N_, r=2, r_f=r_f)
        t0 = time.perf_counter()
        res = pl.table2_trials(p, lam=bench["lam"], seed=bench["seed"],
                               n_trials=bench["n_trials"],
                               solvers=TABLE2_SOLVERS, per_solver_kwargs=kw)
        solve_s = time.perf_counter() - t0
        s = res.stats
        tag = f"table2 {tuple(row['params'])}"
        for name in DETERMINISTIC:
            for f in STAT_FIELDS:
                got, want = getattr(s[name], f), row["solvers"][name][f]
                check(_close(got, want), f"{tag} {name} {f} {got!r} == "
                      f"BENCH_locality.json's {want!r}")
                exact = exact and got == want
        a, fl = s["anneal"], s["flow"]
        check(a.objective_mean >= fl.objective_mean - 1e-6
              and a.node_mean >= fl.node_mean,
              f"{tag} anneal {a.objective_mean} / {a.node_mean} >= flow "
              f"{fl.objective_mean} / {fl.node_mean}")
        for name in TABLE2_SOLVERS[1:]:
            check(s[name].node_mean > s["random"].node_mean,
                  f"{tag} {name} node locality beats random's")
        topo = sim.RackTopology(P_, cross_bw=cl["cross_bw"],
                                intra_bw=cl["intra_bw"])
        cost = sim.CostModel(map=sim.PhaseCoeffs(0.0, cl["map_beta"]))
        t1 = time.perf_counter()
        gaps = [pl.jct_gap(t["flow"], t["random"], topo, cost_model=cost)
                for t in res.trials]
        sim_s = time.perf_counter() - t1
        j_ran = float(np.mean([g[0] for g in gaps]))
        j_opt = float(np.mean([g[1] for g in gaps]))
        check(_close(j_ran, trow["mean_jct_random"])
              and _close(j_opt, trow["mean_jct_flow"]),
              f"{tag} jct_gap means {j_ran!r}, {j_opt!r} == "
              f"BENCH_locality.json's {trow['mean_jct_random']!r}, "
              f"{trow['mean_jct_flow']!r}")
        exact = exact and (j_ran, j_opt) == (trow["mean_jct_random"],
                                             trow["mean_jct_flow"])
        check(j_opt < j_ran, f"{tag} optimized JCT {j_opt} < random {j_ran}")
        walls = {n: s[n].wall_s_mean * 1e3 for n in TABLE2_SOLVERS}
        rows.append({"params": row["params"],
                     "node_mean": {n: s[n].node_mean for n in TABLE2_SOLVERS},
                     "objective_mean": {n: s[n].objective_mean
                                        for n in TABLE2_SOLVERS},
                     "solver_wall_ms": walls, "mean_jct_random": j_ran,
                     "mean_jct_flow": j_opt, "solve_s": solve_s,
                     "sim_s": sim_s})
        say(f"  {tag}: deterministic solvers and jct_gap == "
            f"BENCH_locality.json; node % random/greedy/flow/local_search/"
            f"anneal " + "/".join(f"{100 * s[n].node_mean:.2f}"
                                  for n in TABLE2_SOLVERS)
            + f"; anneal obj {a.objective_mean:.4f} >= flow "
            f"{fl.objective_mean:.4f}; wall ms per call " + " ".join(
                f"{n}={w:.3f}" for n, w in walls.items())
            + f"; jct {j_ran:.6f} -> {j_opt:.6f} s; {solve_s:.3f} s solve, "
            f"{sim_s:.3f} s sim [{smi}]")
    return rows, exact


def placed_phase(torch, np, pl, sim, eng, cc, count, job, subfiles, mesh,
                 SchemeParams, hybrid_assignment, reconcile, seed, smi):
    """Phase 4d (b): the Table I row under an annealed placement.  HDFS
    replicas (r_f = 3) from ``seed``, greedy then the annealer on the card
    (warm start greedy, 64 chains, 1500 steps), then the fused coded
    kernel job under the placement on phase 4's subfiles against the
    identity placement and ``run_job``, and the simulated JCT of the
    placement against a random one of the same instance."""
    from repro_torch.placement.solvers import anneal_chains
    from repro_torch.core.assignment import hybrid_group_of_slot

    dense = eng.run_job(job, subfiles, SchemeParams(K=K, P=P, Q=Q, N=N, r=2),
                        "hybrid").outputs
    topo = sim.RackTopology(P, cross_bw=1e4, intra_bw=1e5)
    cost = sim.CostModel(map=sim.PhaseCoeffs(0.0, 1e-8))
    rows, total = [], dict.fromkeys(KERNELS, 0)
    for r in (2, 3):
        p = SchemeParams(K=K, P=P, Q=Q, N=N, r=r, r_f=3)
        replicas = pl.place_replicas(p, np.random.default_rng(seed), "hdfs")
        C = pl.locality_matrix(p, replicas)
        greedy = pl.solve(p, replicas, "greedy", C=C)
        tag = f"placed binomial r={r} N={N} C={C.shape[0]}x{C.shape[1]}"
        # the chains alone at the same size, from greedy and random starts
        gos = torch.as_tensor(hybrid_group_of_slot(p), dtype=torch.int64,
                              device="cuda")
        base = torch.as_tensor(np.stack([greedy.perm] + [
            np.random.default_rng(seed + k).permutation(N)
            for k in range(1, 64)]), device="cuda")
        Ct = torch.as_tensor(C, dtype=torch.float32, device="cuda")
        temps = torch.as_tensor(np.geomspace(1.0, 1e-3, 1500),
                                dtype=torch.float32, device="cuda")
        gen = torch.Generator(device="cuda")
        gen.manual_seed(seed)
        if r == 2:
            chains_profile = profile_chains(
                torch, anneal_chains, (base.clone(), Ct, gos, temps[:200],
                                       gen), smi)
        ann = pl.solve(p, replicas, "anneal", C=C,
                       rng=pl.solver_rng(seed, "anneal"),
                       init=[greedy.perm], n_chains=64, n_steps=1500,
                       device="cuda")
        check(ann.objective >= greedy.objective,
              f"{tag}: anneal objective {ann.objective} >= greedy "
              f"{greedy.objective}")
        # one host read at the end, none in the step loop (a synchronising
        # call would raise here)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            best = anneal_chains(base, Ct, gos, temps, gen)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        queued_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        chains_ms = (time.perf_counter() - t0) * 1e3
        check(bool((best.sort(dim=1).values
                    == torch.arange(N, device="cuda")).all()),
              f"{tag}: the chains' best are permutations")
        # the job under the placement, against the identity placement
        check(not np.array_equal(ann.perm, np.arange(N)),
              f"{tag}: the placement moves subfiles")
        plan = cc.compile_hybrid_plan(p, perm=ann.perm)
        a = hybrid_assignment(p, ann.perm.tolist())
        for i in range(P):
            for j in range(K // P):
                check(sorted(plan.local_subfiles[i, j].tolist())
                      == sorted(a.subfiles_of_server[p.server_id(i, j)]),
                      f"{tag}: server ({i}, {j}) maps the placement's "
                      f"subfiles")
        want = expected_launches("coded", "kernel", r)
        kw = dict(fused=True, multicast="coded", combine_impl="kernel")
        walls = {}
        for name, placement in (("identity", None), ("placed", ann)):
            ms_list = []
            for _ in range(4):              # a warm call, then three timed
                def run():
                    t1 = time.perf_counter()
                    res = eng.run_job_distributed(job, subfiles, p, mesh,
                                                  placement=placement, **kw)
                    torch.cuda.synchronize()
                    return res, (time.perf_counter() - t1) * 1e3
                (res, ms), counts, _ = count(run)
                check(counts == want, f"{tag} {name}: launches {counts}, "
                      f"phase 4's fused r={r} coded kernel job {want}")
                if name == "placed":
                    add_counts(total, counts)
                ms_list.append(ms)
            walls[name] = statistics.median(ms_list[1:])
            check(torch.equal(res.outputs, dense),
                  f"{tag} {name}: outputs == run_job")
            reconcile(res.intra_rack_bytes, res.cross_rack_bytes, p,
                      "hybrid", d=D, check=True)
            if name == "identity":
                ident = res.outputs
        check(torch.equal(res.outputs, ident),
              f"{tag}: placed outputs == the identity placement's")
        ran = pl.solve(p, replicas, "random", C=C,
                       rng=pl.solver_rng(seed, "random"))
        t1 = time.perf_counter()
        j_opt = pl.simulate_placement(ann, topo, cost_model=cost).jct
        j_ran = pl.simulate_placement(ran, topo, cost_model=cost).jct
        sim_ms = (time.perf_counter() - t1) * 1e3
        check(j_opt < j_ran, f"{tag}: simulated JCT {j_opt} < random's "
              f"{j_ran}")
        rows.append({"r": r, "greedy": {"objective": greedy.objective,
                                        "node": greedy.node_locality,
                                        "rack": greedy.rack_locality,
                                        "wall_ms": greedy.wall_s * 1e3},
                     "anneal": {"objective": ann.objective,
                                "node": ann.node_locality,
                                "rack": ann.rack_locality,
                                "wall_ms": ann.wall_s * 1e3},
                     "random": {"node": ran.node_locality,
                                "rack": ran.rack_locality},
                     "chains_ms": chains_ms, "chains_queued_ms": queued_ms,
                     "identity_wall_ms": walls["identity"],
                     "placed_wall_ms": walls["placed"],
                     "launches_per_job": want, "jct_random": j_ran,
                     "jct_anneal": j_opt, "sim_ms": sim_ms})
        say(f"  {tag}: greedy obj {greedy.objective:.4f} node "
            f"{100 * greedy.node_locality:.2f}% rack "
            f"{100 * greedy.rack_locality:.2f}% ({greedy.wall_s * 1e3:.3f} "
            f"ms); anneal on cuda obj {ann.objective:.4f} node "
            f"{100 * ann.node_locality:.2f}% rack "
            f"{100 * ann.rack_locality:.2f}% ({ann.wall_s * 1e3:.3f} ms a "
            f"call; the chains alone {chains_ms:.3f} ms, "
            f"{chains_ms / 1500 * 1e3:.1f} us a step, queued in "
            f"{queued_ms:.3f} ms with no synchronisation) [{smi}]")
        say(f"  {tag}: fused coded kernel job under the placement bit-exact "
            f"vs the identity placement and run_job, every server maps the "
            f"placement's subfiles, rack bytes = closed form, "
            f"launches_per_job={want}; wall_ms placed {walls['placed']:.3f} "
            f"identity {walls['identity']:.3f} (median of three after a "
            f"warm call) [{smi}]")
        say(f"  {tag}: simulated JCT anneal {j_opt:.6f} s < random "
            f"{j_ran:.6f} s (node {100 * ran.node_locality:.2f}%), "
            f"RackTopology(P={P}, cross_bw=1e4, intra_bw=1e5), map beta "
            f"1e-8; {sim_ms:.3f} ms [{smi}]")
    return rows, total, chains_profile


def profile_chains(torch, anneal_chains, to_profile, smi):
    """The card's busy time under 200 profiled steps of phase 4d's r = 2
    chains."""
    from torch.profiler import ProfilerActivity, profile
    best, Ct, gos, temps, gen = to_profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        anneal_chains(best.clone(), Ct, gos, temps, gen)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy_ms, top = device_time(prof)
    check(busy_ms > 0, "the annealer's chains ran on the card")
    say(f"  anneal chains, {temps.shape[0]} profiled steps at the Table I "
        f"row (r=2): device busy {busy_ms:.3f} of {wall_ms:.3f} ms, idle "
        f"share {1 - busy_ms / wall_ms:.3f}; the largest: " + ", ".join(
            f"{k['name'][:40]} {k['ms']:.3f} ms x{k['count']}"
            for k in top[:4]) + f" [{smi}]")
    return {"steps": int(temps.shape[0]), "wall_ms": wall_ms,
            "device_busy_ms": busy_ms, "top": top}


# ---------------------------------------------------------------------------
# Phase 5: the LM kernels against their plain versions
# ---------------------------------------------------------------------------

def visible_pairs(Sq, Sk, q_offset, kv_valid, causal, window):
    """(query, key) pairs the masks keep for one (batch, head), and the
    number of distinct keys any query sees: the work this run's data
    needs."""
    valid = Sk if kv_valid is None else min(kv_valid, Sk)
    pairs, key_lo, key_hi = 0, Sk, 0
    for i in range(Sq):
        p = q_offset + i
        hi = min(valid, p + 1) if causal else valid
        lo = max(0, p - window + 1) if window is not None else 0
        if hi > lo:
            pairs += hi - lo
            key_lo, key_hi = min(key_lo, lo), max(key_hi, hi)
    return pairs, max(key_hi - key_lo, 0)


# (tag, B, Sq, Sk, H, KV, hd, causal, q_offset, kv_valid, window): Qwen2-1.5B
# prefill of 8 x 2048 and one decode step against a 2,112-long cache with
# 1,500 and with 2,111 valid keys, then the shapes of tests/test_kernels.py
FLASH_CASES = [
    ("prefill", 8, 2048, 2048, 12, 2, 128, True, 0, None, None),
    ("decode", 8, 1, 2112, 12, 2, 128, True, 1499, 1500, None),
    ("decode_2111", 8, 1, 2112, 12, 2, 128, True, 2110, 2111, None)] + [
    ("odd", B, Sq, Sk, H, KV, hd, causal, Sk - Sq if causal else 0, None,
     None)
    for B, Sq, Sk, H, KV, hd in ((2, 128, 128, 4, 4, 64),
                                 (1, 200, 200, 8, 2, 64),
                                 (2, 64, 256, 4, 1, 128))
    for causal in (True, False)] + [
    ("window", 1, 160, 160, 4, 2, 64, True, 0, None, 32),
    ("kv_valid", 2, 8, 128, 4, 4, 64, False, 0, 57, None),
    # head dims over 128: MLA's absorbed attention (deepseek-v2-lite:
    # kv_lora_rank 512 + rope_head_dim 64 = 576, 16 query heads on one
    # latent kv head), a 1 x 2048 causal prefill and a decode step of 8
    # slots over 1,500 and over per-batch valid keys of a 2,112-long cache;
    # then one odd shape at hd 192
    ("mla_prefill", 1, 2048, 2048, 16, 1, 576, True, 0, None, None),
    ("mla_decode", 8, 1, 2112, 16, 1, 576, True, 1499, 1500, None),
    ("mla_decode_per_batch", 8, 1, 2112, 16, 1, 576, True, 2110,
     (2111, 1500, 1, 64, 2000, 777, 1024, 2048), None),
    ("odd_hd192", 2, 100, 230, 8, 2, 192, True, 130, 200, None)]
FLASH_TIMED = ("prefill", "decode", "decode_2111", "mla_prefill",
               "mla_decode")
# the route a head dim over 128 takes: never the tensor cores
LARGE_HD_ROUTE = {"mla_prefill": "cuda_core", "mla_decode": "split_kv",
                  "mla_decode_per_batch": "split_kv",
                  "odd_hd192": "cuda_core"}
# split-kv against the plain split-kv algorithm, which also computes in fp32
# and rounds once: about one bf16 ulp of the output
FLASH_SPLIT_TOL = {"float32": (2e-5, 2e-5), "bfloat16": (1e-2, 1e-3)}
# (tag, B, S, h, Nk, Nv): RWKV6-3B prefill of 8 x 2048 and one decode step,
# then the ragged shapes of tests/test_kernels.py and a ragged one at
# RWKV6-3B's head width (bf16: the tensor-core route, last chunk masked)
WKV_CASES = [("prefill", 8, 2048, 40, 64, 64), ("decode", 8, 1, 40, 64, 64),
             ("ragged", 1, 64, 2, 16, 16), ("ragged", 2, 100, 3, 32, 32),
             ("ragged", 1, 128, 1, 64, 64), ("ragged", 2, 100, 3, 64, 64)]
# the tensor-core route against its plain mirror (the same TF32 operand
# rounding and chunks; tests/test_torch_wkv_cuda.py's MIRROR_TOL): a TF32
# operand that rounds the other way moves a product of order 20 by 2e-2,
# and the bf16 output may sit one ulp (2^-7 relative) apart
WKV_MIRROR_TOL = {"out": (2e-2, 2e-2), "state": (2e-2, 2e-2)}


def flash_phase(torch, fa, fa_ref, peaks, seed):
    """The flash kernels against ``attention_ref`` on the card, with the
    route each call took: the serving path's prefill and decode shapes
    (timed in turns with SDPA, the library yardstick: kernel, SDPA, SDPA,
    kernel) and the odd shapes of tests/test_kernels.py.  Split-kv calls
    are also held against the plain split-kv algorithm."""
    F = torch.nn.functional
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 101)
    rows, main = [], {}
    for (tag, B, Sq, Sk, H, KV, hd, causal, q_off, valid_case,
         window) in FLASH_CASES:
        # a tuple of valid lengths is one per batch row, a [B] tensor
        per_batch = isinstance(valid_case, tuple)
        valid = (torch.tensor(valid_case, device=dev) if per_batch
                 else valid_case)
        for dtype in (torch.bfloat16, torch.float32):
            q = torch.randn(B, Sq, H, hd, generator=g, device=dev).to(dtype)
            k = torch.randn(B, Sk, KV, hd, generator=g, device=dev).to(dtype)
            v = torch.randn(B, Sk, KV, hd, generator=g, device=dev).to(dtype)
            kw = dict(causal=causal, q_offset=q_off, kv_valid=valid,
                      window=window)
            pos = torch.arange(q_off, q_off + Sq, device=dev)
            fa.reset_launch_counts()
            out = fa.flash_attention(q, k, v, **kw)
            torch.cuda.synchronize()
            routes = [r for r, n in fa.ROUTE_CALLS.items() if n]
            check(len(routes) == 1 and fa.LAUNCHES["flash_attention"] == 1,
                  f"flash {tag}: one launch by one route, got "
                  f"{fa.ROUTE_CALLS}")
            route = routes[0]
            check(hd <= 128 or route == LARGE_HD_ROUTE[tag],
                  f"flash {tag} hd={hd}: route {route}, expected "
                  f"{LARGE_HD_ROUTE.get(tag)}")
            want = fa_ref.attention_ref(q, k, v, pos, valid, causal=causal,
                                        window=window)
            tol = 2e-5 if dtype == torch.float32 else 2e-2
            torch.testing.assert_close(out, want, rtol=tol, atol=tol)
            err = float((out.float() - want.float()).abs().max().item())
            dname = str(dtype).replace("torch.", "")
            if route == "split_kv":
                split = fa_ref.attention_split_ref(
                    q, k, v, pos, valid, causal=causal, window=window,
                    chunk=fa.split_chunk(dtype, hd))
                s_rtol, s_atol = FLASH_SPLIT_TOL[dname]
                torch.testing.assert_close(out, split, rtol=s_rtol,
                                           atol=s_atol)
            # the pairs and keys each batch row's data needs
            pairs = keys = 0
            for b in range(B):
                vb = valid_case[b] if per_batch else valid_case
                p_b, k_b = visible_pairs(Sq, Sk, q_off, vb, causal, window)
                pairs, keys = pairs + p_b, keys + k_b
            size = q.element_size()
            nbytes = size * (2 * q.numel() + 2 * keys * KV * hd)
            flops = 4.0 * hd * pairs * H
            row = {"name": "flash_attention", "case": tag, "B": B, "Sq": Sq,
                   "Sk": Sk, "H": H, "KV": KV, "hd": hd, "causal": causal,
                   "q_offset": q_off, "kv_valid": valid_case,
                   "window": window,
                   "dtype": dname, "route": route,
                   "max_abs_err": err,
                   "tolerance": f"rtol={tol},atol={tol}", "bytes": nbytes,
                   "flops": flops}
            row["bound_ms"], row["bound_by"] = bound(peaks, nbytes, flops,
                                                     dname)
            is_main = tag in FLASH_TIMED
            reps, inner = (5, 5) if is_main else (3, 10)
            if hd > 128 and Sq > 16:            # a CUDA-core prefill
                reps, inner = 3, 2
            kernel = lambda: fa.flash_attention(q, k, v, **kw)
            row["plain_ms"] = cuda_ms(
                torch, lambda: fa_ref.attention_ref(
                    q, k, v, pos, valid, causal=causal, window=window),
                3, 2 if is_main else 10)
            row["library_ms"] = None
            if is_main:
                # one SDPA call on the keys the queries see (prefill: causal
                # over all keys; decode: the valid prefix of the cache)
                kv_n = valid or Sk
                qt = q.transpose(1, 2)
                kt, vt = (x[:, :kv_n].transpose(1, 2) for x in (k, v))
                sdpa = lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=tag.endswith("prefill"),
                    enable_gqa=True)
                # a sanity check of the yardstick (its own bf16 rounding)
                lib_err = float((sdpa().transpose(1, 2).float()
                                 - want.float()).abs().max().item())
                check(lib_err < (1e-2 if dtype == torch.float32 else 0.1),
                      f"SDPA disagrees with the plain version: {lib_err}")
                # in turns: kernel, SDPA, SDPA, kernel
                turns = [cuda_ms(torch, fn, reps, inner)
                         for fn in (kernel, sdpa, sdpa, kernel)]
                row["ms_turns"] = [turns[0], turns[3]]
                row["library_ms_turns"] = [turns[1], turns[2]]
                row["ms"] = statistics.mean(row["ms_turns"])
                row["library_ms"] = statistics.mean(row["library_ms_turns"])
                row["device_ms"], row["device_kernels"] = device_per_call(
                    torch, kernel)
                row["library_device_ms"], _ = device_per_call(torch, sdpa)
                check(row["device_kernels"] >= 1,
                      f"flash {tag}: no kernel on the card in the profile")
                main.setdefault(tag, row)
            else:
                row["ms"] = cuda_ms(torch, kernel, reps, inner)
            rows.append(row)
            lib = row["library_ms"]
            say(f"  kernel flash_attention {tag} B={B} Sq={Sq} Sk={Sk} H={H} "
                f"KV={KV} hd={hd} causal={causal} kv_valid={valid_case} "
                f"window={window} {row['dtype']} route={route}: kernel_ms="
                f"{row['ms']:.6f} plain_ms={row['plain_ms']:.6f} library_ms="
                f"{'null' if lib is None else f'{lib:.6f}'} bound_ms="
                f"{row['bound_ms']:.6f} ({row['bound_by']}) "
                f"max_abs_err={err!r} tolerance={row['tolerance']}")
            if is_main:
                say(f"    in turns (kernel, SDPA, SDPA, kernel): "
                    f"{turns[0]:.6f} {turns[1]:.6f} {turns[2]:.6f} "
                    f"{turns[3]:.6f} ms; kernel / SDPA "
                    f"{row['ms'] / lib:.3f}, bound / kernel "
                    f"{row['bound_ms'] / row['ms']:.3f}; device time per "
                    f"call (profiler) kernel {row['device_ms']:.6f} ms "
                    f"in {row['device_kernels']:g} device kernels, "
                    f"SDPA {row['library_device_ms']:.6f} ms")
            del q, k, v, out, want
    return rows, main


def wkv_phase(torch, rw, rw_ref, peaks, seed):
    """The WKV kernels against the plain chunked recurrence on the card, with
    the route each call took: the serving path's prefill and decode shapes
    (bf16 streams with the fp32 decay the model computes, and all-fp32)
    and the ragged shapes of tests/test_kernels.py.  Tensor-core calls are
    also held against their plain mirror, ``wkv_subchunk_ref``."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 202)
    rows, main = [], {}
    for tag, B, S, h, Nk, Nv in WKV_CASES:
        rnd = lambda *s: torch.randn(s, generator=g, device=dev)
        r32, k32, v32 = rnd(B, S, h, Nk), rnd(B, S, h, Nk), rnd(B, S, h, Nv)
        log_w = -torch.exp(rnd(B, S, h, Nk))
        u, s0 = 0.1 * rnd(h, Nk), 0.1 * rnd(B, h, Nk, Nv)
        for dtype in (torch.bfloat16, torch.float32):
            r, k, v = (x.to(dtype) for x in (r32, k32, v32))
            rw.reset_launch_counts()
            out, sT = rw.wkv_scan(r, k, v, log_w, u, s0)
            torch.cuda.synchronize()
            routes = [w for w, n in rw.ROUTE_CALLS.items() if n]
            check(routes == [rw.route(dtype, S, Nk, Nv)]
                  and rw.LAUNCHES["wkv_scan"] == 1,
                  f"wkv {tag}: one launch on route "
                  f"{rw.route(dtype, S, Nk, Nv)}, got {rw.ROUTE_CALLS}")
            route = routes[0]
            want, want_sT = rw.chunked_linear_recurrence(
                r, k, v, log_w, u=u, initial_state=s0, mode="rwkv",
                chunk=64, return_state=True)
            tol = 3e-4 if dtype == torch.float32 else 3e-2
            torch.testing.assert_close(out, want, rtol=tol, atol=tol)
            torch.testing.assert_close(sT, want_sT, rtol=tol, atol=tol)
            err = max(float((out.float() - want.float()).abs().max()),
                      float((sT - want_sT).abs().max()))
            mirror_err = None
            if route == "tensor_core":
                mo, ms = rw_ref.wkv_subchunk_ref(
                    r, k, v, log_w, u, s0, chunk=rw.TC_CHUNK,
                    sub=rw.TC_SUB, leaf=rw.TC_LEAF, tf32=True)
                for got, ref_, key in ((out, mo, "out"), (sT, ms, "state")):
                    m_rtol, m_atol = WKV_MIRROR_TOL[key]
                    torch.testing.assert_close(got, ref_, rtol=m_rtol,
                                               atol=m_atol)
                mirror_err = max(float((out.float() - mo.float()).abs()
                                       .max()),
                                 float((sT - ms).abs().max()))
                del mo, ms
            size = r.element_size()
            n_in = B * S * h
            nbytes = (size * n_in * (2 * Nk + 2 * Nv) + 4 * n_in * Nk
                      + 4 * h * Nk + 8 * B * h * Nk * Nv)
            # per (t, i, j): k v product, bonus FMA, read FMA, decay FMA
            flops = 7.0 * n_in * Nk * Nv
            dname = str(dtype).replace("torch.", "")
            row = {"name": "wkv_scan", "case": tag, "B": B, "S": S, "h": h,
                   "Nk": Nk, "Nv": Nv, "dtype": dname,
                   "log_w_dtype": "float32", "route": route,
                   "max_abs_err": err, "mirror_max_abs_err": mirror_err,
                   "tolerance": f"rtol={tol},atol={tol}", "bytes": nbytes,
                   "flops": flops, "library_ms": None}
            row["bound_ms"], row["bound_by"] = bound(peaks, nbytes, flops,
                                                     dname)
            is_main = tag in ("prefill", "decode")
            row["ms"] = cuda_ms(torch, lambda: rw.wkv_scan(r, k, v, log_w, u,
                                                           s0),
                                5 if is_main else 3, 5 if is_main else 10)
            row["plain_ms"] = cuda_ms(
                torch, lambda: rw.chunked_linear_recurrence(
                    r, k, v, log_w, u=u, initial_state=s0, mode="rwkv",
                    chunk=64, return_state=True), 3, 1 if is_main else 5)
            if is_main:
                row["device_ms"], _ = device_per_call(
                    torch, lambda: rw.wkv_scan(r, k, v, log_w, u, s0))
            rows.append(row)
            if is_main:
                main.setdefault(tag, row)
            mirror = ("" if mirror_err is None else
                      f" mirror_max_abs_err={mirror_err!r}")
            say(f"  kernel wkv_scan {tag} B={B} S={S} h={h} Nk={Nk} Nv={Nv} "
                f"{row['dtype']} (log_w float32) route={route}: kernel_ms="
                f"{row['ms']:.6f} plain_ms={row['plain_ms']:.6f} "
                f"library_ms=null bound_ms={row['bound_ms']:.6f} "
                f"({row['bound_by']}) max_abs_err={err!r} "
                f"tolerance={row['tolerance']}{mirror}"
                + (f" device_ms={row['device_ms']:.6f}" if is_main else ""))
    return rows, main


# ---------------------------------------------------------------------------
# Phase 6: serving at full width
# ---------------------------------------------------------------------------

SLOTS, PROMPT, NEW, MAX_SEQ = 8, 2048, 32, 2112


def wall(torch, fn):
    """(fn(), host ms) with the card synchronised on both sides."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def serve_phase(torch, np, lm, serve, counts, cfg, kernel, seed):
    """Drive ``ServeEngine.generate`` and ``.serve`` at full width in bf16
    (weights drawn on the card from ``seed``), check launch counts per
    call, greedy determinism, and fp32 decode == forward; time it."""
    L, V = cfg.n_layers, cfg.vocab_size
    rng = np.random.default_rng(seed + 303)
    total = dict.fromkeys(KERNELS + LM_KERNELS, 0)
    routes = {}

    def run(fn, want, what, want_route=None):
        (out, ms), launches, plain = counts(lambda: wall(torch, fn))
        check(launches[kernel] == want and not any(plain.values()),
              f"{cfg.name} {what}: launches {launches} plain {plain}, "
              f"expected {want} {kernel} launches and no plain call")
        for k2, n in launches.items():
            total[k2] += n
        got = counts.routes.get(kernel, {})
        check(want_route is None or got.get(want_route) == want,
              f"{cfg.name} {what}: routes {got}, expected all {want} "
              f"{kernel} calls on {want_route}")
        for r, n in got.items():
            routes[r] = routes.get(r, 0) + n
        return out, ms

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params, init_ms = wall(torch, lambda: lm.init_params(seed, cfg,
                                                         torch.bfloat16))
    n_params = sum(t.numel() for t in lm.leaves(params))
    dev = params["embed"].device
    eng = serve.ServeEngine(cfg, params, batch_slots=SLOTS, max_seq=MAX_SEQ,
                            dtype=torch.bfloat16, seed=seed)
    prompts = rng.integers(0, V, (SLOTS, PROMPT)).astype(np.int32)
    # the first call at these shapes pays one-time costs (allocator growth,
    # GEMM heuristics), which would also bias decode_ms below: warm up
    first, _ = run(lambda: eng.generate(prompts, 1), L,
                   "generate 1 warm-up")
    # time to first token: prefill of 8 x 2048 and the first greedy token
    # every prefill layer on the tensor cores: 28 flash calls on
    # tensor_core, or 32 WKV calls on tensor_core
    ttft = [run(lambda: eng.generate(prompts, 1), L, "generate 1",
                "tensor_core")[1] for _ in range(3)]
    toks, gen_a = run(lambda: eng.generate(prompts, NEW), L * NEW,
                      f"generate {NEW}")
    again, gen_b = run(lambda: eng.generate(prompts, NEW), L * NEW,
                       f"generate {NEW} again")
    check(np.array_equal(toks, again) and np.array_equal(toks[:, :1], first),
          f"{cfg.name}: greedy generate differs between runs")
    check(toks.shape == (SLOTS, NEW) and ((toks >= 0) & (toks < V)).all(),
          f"{cfg.name}: generated tokens out of range")
    ttft_ms, gen_ms = statistics.median(ttft), statistics.median([gen_a,
                                                                  gen_b])
    decode_ms = (gen_ms - ttft_ms) / (NEW - 1)
    # continuous batching: 12 requests, two waves of up to 8 slots
    reqs = [serve.Request(rng.integers(0, V, int(rng.integers(64, PROMPT + 1))
                                       ).astype(np.int32),
                          int(rng.integers(8, NEW + 1))) for _ in range(12)]
    want = sum(L * max(r.max_new_tokens for r in reqs[i:i + SLOTS])
               for i in range(0, len(reqs), SLOTS))
    done, serve_ms = run(lambda: eng.serve(reqs), want, "serve 12 requests")
    check(all(r.done and len(r.out_tokens) == r.max_new_tokens
              for r in done), f"{cfg.name}: serve left a request unfinished")
    n_served = sum(r.max_new_tokens for r in done)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    prof = profile_decode(torch, lm, cfg, params, prompts, counts, kernel)
    del eng, params
    torch.cuda.empty_cache()
    # fp32 at full width: prefill and decode logits equal forward's
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False      # full fp32 products
    try:
        params = lm.init_params(seed, cfg, torch.float32)
        toks32 = torch.as_tensor(rng.integers(0, V, (2, 300)), device=dev)
        n_pre = 298
        with torch.inference_mode():
            (full, _, _), _ = run(lambda: lm.forward(params, cfg, toks32),
                                  L, "forward fp32")
            cache = lm.init_cache(cfg, 2, 304, torch.float32, device=dev)
            (lg_pre, cache), _ = run(lambda: lm.prefill(
                params, cfg, toks32[:, :n_pre], cache), L, "prefill fp32")
            (lg_dec, cache), _ = run(lambda: lm.decode_step(
                params, cfg, toks32[:, n_pre], cache, n_pre), L,
                "decode_step fp32")
        check(bool(torch.isfinite(full).all())
              and tuple(full.shape) == (2, 300, V),
              f"{cfg.name}: forward logits not finite or mis-shaped")
        errs = [float((lg_pre - full[:, n_pre - 1]).abs().max()),
                float((lg_dec - full[:, n_pre]).abs().max())]
        check(max(errs) < 2e-3, f"{cfg.name}: decode vs forward {errs}")
        del params, full, cache
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    torch.cuda.empty_cache()
    res = {"arch": cfg.name, "n_params": n_params, "dtype": "bfloat16",
           "slots": SLOTS, "prompt": PROMPT, "new_tokens": NEW,
           "max_seq": MAX_SEQ, "init_ms": init_ms, "ttft_ms": ttft_ms,
           "ttft_runs_ms": ttft, "generate_runs_ms": [gen_a, gen_b],
           "generate_ms": gen_ms, "decode_ms_per_step": decode_ms,
           "generate_tokens_per_s": SLOTS * NEW / (gen_ms / 1e3),
           "serve_ms": serve_ms, "serve_new_tokens": n_served,
           "serve_tokens_per_s": n_served / (serve_ms / 1e3),
           "serve_prompt_lens": [len(r.prompt) for r in reqs],
           "serve_max_new": [r.max_new_tokens for r in reqs],
           "peak_memory_gb": peak_gb, "decode_vs_forward_fp32": errs,
           "profile": prof, "launches": total, "routes": routes}
    say(f"  serve {cfg.name}: {n_params} params bf16, init_ms={init_ms:.1f}; "
        f"ttft_ms={ttft_ms:.3f} (8 x {PROMPT} prefill + first token) "
        f"decode_ms_per_step={decode_ms:.3f} generate {SLOTS}x{NEW} tokens "
        f"in {gen_ms:.3f} ms ({res['generate_tokens_per_s']:.1f} tok/s); "
        f"serve 12 requests {n_served} tokens in {serve_ms:.3f} ms "
        f"({res['serve_tokens_per_s']:.1f} tok/s); peak memory "
        f"{peak_gb:.3f} GB; greedy identical on two runs")
    say(f"  serve {cfg.name} fp32: |prefill - forward| = {errs[0]!r}, "
        f"|decode - forward| = {errs[1]!r} (limit 2e-3); {L} {kernel} "
        f"launches per forward, prefill and decode step; {kernel} routes "
        f"{routes}")
    say(f"  profile {cfg.name} decode step (x{prof['steps']}): wall_ms="
        f"{prof['wall_ms']:.3f} device_busy_ms={prof['device_busy_ms']:.3f} "
        f"device_idle_share={prof['idle_share']:.3f}")
    for k2 in prof["by_kernel"][:6]:
        say(f"    {k2['ms']:.3f} ms x{k2['count']} {k2['name']}")
    return res


def profile_decode(torch, lm, cfg, params, prompts, counts, kernel,
                   steps: int = 4):
    """Device busy time and idle share of ``steps`` warm decode steps after
    an 8 x 2048 prefill, by torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    dev = params["embed"].device
    with torch.inference_mode():
        cache = lm.init_cache(cfg, SLOTS, MAX_SEQ, torch.bfloat16, device=dev)
        tokens = torch.as_tensor(prompts, device=dev).long()
        logits, cache = lm.prefill(params, cfg, tokens, cache)
        tok = logits.argmax(-1)
        logits, cache = lm.decode_step(params, cfg, tok, cache, PROMPT)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            def run():
                lg = logits
                for i in range(steps):
                    lg, _ = lm.decode_step(params, cfg, lg.argmax(-1), cache,
                                           PROMPT + 1 + i)
                return lg
            (_, ms), launches, _ = counts(lambda: wall(torch, run))
    check(launches[kernel] == steps * cfg.n_layers,
          f"profiled decode launches {launches}")
    busy, by_kernel = device_time(prof)
    return {"steps": steps, "wall_ms": ms, "device_busy_ms": busy,
            "idle_share": 1.0 - busy / ms, "by_kernel": by_kernel}


# ---------------------------------------------------------------------------
# Phase 7: the card (kernels) against the CPU (plain versions)
# ---------------------------------------------------------------------------

def card_vs_cpu_phase(torch, np, lm, serve, counts, get_arch, seed):
    """At each arch's reduced() config, the same fp32 weights on the card
    and on the CPU give the same greedy tokens, and logits within 1e-4
    (fp32 on both sides, TF32 off; the sums run in other orders)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    total = dict.fromkeys(KERNELS + LM_KERNELS, 0)
    rows = []
    try:
        for name in ("qwen2-1.5b", "rwkv6-3b"):
            cfg = get_arch(name).reduced()
            p_cpu = lm.init_params(seed, cfg, device="cpu")
            p_gpu = tree_to(p_cpu, "cuda")
            prompts = np.random.default_rng(seed).integers(
                0, cfg.vocab_size, (2, 24)).astype(np.int32)
            cpu_eng = serve.ServeEngine(cfg, p_cpu, 2, 40, device="cpu")
            gpu_eng = serve.ServeEngine(cfg, p_gpu, 2, 40)
            want = cpu_eng.generate(prompts, 8)
            got, launches, plain = counts(lambda: gpu_eng.generate(prompts,
                                                                   8))
            kernel = "wkv_scan" if cfg.attn_free else "flash_attention"
            check(np.array_equal(got, want)
                  and launches[kernel] == 8 * cfg.n_layers
                  and not any(plain.values()),
                  f"{name} reduced: card {got.tolist()} vs cpu "
                  f"{want.tolist()}, launches {launches}, plain {plain}")
            toks = torch.as_tensor(prompts).long()
            with torch.inference_mode():
                lc = lm.forward(p_cpu, cfg, toks)[0]
                (lg, _, _), launches, _ = counts(
                    lambda: lm.forward(p_gpu, cfg, toks.cuda()))
            err = float((lg.cpu() - lc).abs().max())
            check(err < 1e-4, f"{name} reduced: card vs cpu logits {err}")
            for k2, n in launches.items():
                total[k2] += n
            rows.append({"arch": name, "greedy_equal": True,
                         "max_abs_logit_err": err})
            say(f"  card vs cpu {name} reduced: greedy tokens equal, "
                f"max |logits| error {err!r} (limit 1e-4)")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    return rows, total


def tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_to(v, device) for v in tree]
    return tree.to(device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" /
                                         "chip_smoke.json"))
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import placement as pl
    from repro_torch import sim
    from repro_torch.configs import ARCHS, get_arch
    from repro_torch.core import coded_collectives as cc
    from repro_torch.core.assignment import hybrid_assignment
    from repro_torch.core import costs
    from repro_torch.core import degraded as dg
    from repro_torch.core.params import SchemeParams
    from repro_torch.distributed.launch import run_ranks
    from repro_torch.distributed.meshes import make_mesh
    from repro_torch.kernels import _build
    from repro_torch.kernels.coded_combine import ops, ref
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.rwkv_scan import ops as rw
    from repro_torch.kernels.rwkv_scan import ref as rw_ref
    from repro_torch.mapreduce import engine as eng
    from repro_torch.mapreduce import jobs
    from repro_torch.models import lm
    from repro_torch.obs.bytes import degraded_rack_bytes, reconcile
    from repro_torch.obs.tracing import enable_tracing
    from repro_torch.resilience import faults
    from repro_torch.serve import engine as serve

    t_start = time.perf_counter()
    # ---- 1. device -------------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "--id=0"],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout.strip()
    say(smi)
    smi_name = smi.split(",")[0].strip()
    check(smi_name in PEAKS, f"no published peaks for the card {smi_name!r}; "
          f"known: {sorted(PEAKS)}")
    peaks = PEAKS[smi_name]
    name = torch.cuda.get_device_name(0)
    # one nvcc per kernel source, all started together
    t0 = time.perf_counter()
    with ThreadPoolExecutor(3) as pool:
        list(pool.map(lambda m: m.build(), (ops, fa, rw)))
    build_s = time.perf_counter() - t0
    # an entry exists only if this process ran nvcc (else the library was
    # built earlier from the same sources and only loaded)
    nvcc = dict(_build.BUILD_LOG)
    how = ("; ".join(f"nvcc {k} {v[0]:.3f} s" for k, v in nvcc.items())
           or "loaded libraries built earlier from the same sources")
    say(f"phase device: {name}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; kernels ready in {build_s:.3f} s ({how}); "
        f"HBM {peaks['hbm']:.3e} B/s, tensor cores bf16 "
        f"{peaks['bfloat16']:.3e} / tf32 {peaks['float32']:.3e} FLOP/s "
        f"(data sheet of {smi_name})")
    for lib, (_, ptxas) in nvcc.items():
        for line in ptxas.splitlines():
            if ("Compiling entry function" in line or "registers" in line
                    or "spill" in line):
                say(f"  ptxas {lib}: {line.strip()}")

    # ---- 2. kernels ------------------------------------------------------
    main_shapes = []
    for r in (2, 3):
        plan = cc.compile_hybrid_plan(SchemeParams(K=K, P=P, Q=Q, N=N, r=r))
        main_shapes.append((r, K * P * plan.n_send * (Q // P), D))
    check(main_shapes == [(2, 17920, D), (3, 8960, D)],
          f"main-path launch shapes {main_shapes}")
    # phase 4c's: one server's share, and the gradient's [P-1, G/P]
    rank_shapes = [(r, T // K, d) for r, T, d in main_shapes]
    grad_shape = (P - 1, GRAD_G // P // D, D)
    kernel_rows, main_rows, to_profile = kernel_phase(
        torch, ops, ref, main_shapes, rank_shapes, grad_shape, peaks,
        args.seed)
    say(f"phase kernels: {len(kernel_rows)} kernel/shape/dtype cases match "
        f"their plain versions")
    # the decode instances (r = 1..4 compiled, 0 the runtime stream count)
    if "coded_combine" in nvcc:
        for line in ptxas_entries(nvcc["coded_combine"][1],
                                  "linear_decode_kernel"):
            say(f"  ptxas coded_decode: {line}")

    # ---- 3 + 4. the main paths, launch counts zeroed before each call ----
    count = Counts(torch, (ops,))
    shuffle_runs, shuffle_launches = shuffle_phase(
        torch, np, cc, count, make_mesh, SchemeParams, args.seed)
    say(f"phase shuffle: {len(shuffle_runs)} hybrid_shuffle runs bit-exact "
        f"vs simulate_plan_shuffle and plan_shuffle_reference; launches "
        f"{shuffle_launches}")
    torch.cuda.reset_peak_memory_stats()
    engine_runs, engine_launches, subfiles, job, mesh = engine_phase(
        torch, np, eng, jobs, count, make_mesh, SchemeParams, costs,
        reconcile, args.seed)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    say(f"phase engine: {len(engine_runs)} run_job_distributed runs "
        f"bit-exact vs run_job; peak device memory {peak_gb:.3f} GB; "
        f"launches fused {engine_launches['fused']} legacy "
        f"{engine_launches['legacy']}")
    profile = profile_fused(torch, eng, count, job, subfiles, mesh,
                            SchemeParams, enable_tracing)
    idle = 1.0 - profile["device_busy_ms"] / profile["wall_ms"]
    spans = " ".join(f"{k}={v:.3f}" for k, v in profile["span_ms"].items())
    say(f"  profile fused binomial r=2 coded kernel: wall_ms="
        f"{profile['wall_ms']:.3f} device_busy_ms="
        f"{profile['device_busy_ms']:.3f} device_idle_share={idle:.3f}; "
        f"engine spans (host ms) {spans}")
    for k in profile["by_kernel"][:8]:
        say(f"    {k['ms']:.3f} ms x{k['count']} {k['name']}")

    # ---- 4b. the engine under faults -------------------------------------
    t_faults = time.perf_counter()
    fault_runs, fault_launches, phase_row = faults_phase(
        torch, np, eng, count, job, subfiles, mesh, SchemeParams, dg,
        faults, degraded_rack_bytes, smi)
    say(f"phase faults: {len(fault_runs)} faulted run_job_distributed runs "
        f"bit-exact vs the failure-free fused job, each on its expected "
        f"rung; launches {fault_launches}; "
        f"{time.perf_counter() - t_faults:.1f} s [{smi}]")

    # ---- 4c. the process form: 16 ranks on the card ---------------------
    t_ranks = time.perf_counter()
    ranks_info, ranks_launches = ranks_phase(
        torch, np, eng, cc, run_ranks, make_mesh, SchemeParams, costs,
        mesh.device, (K, P, Q, N, D), TOKENS, GRAD_G, args.seed, subfiles,
        smi)
    say(f"phase ranks: {K} ranks on one card (gloo), every job, the "
        f"coded_xor shuffle and the coded gradient reduce-scatter "
        f"bit-exact, every rank on its server's launches; launches "
        f"{ranks_launches}; {time.perf_counter() - t_ranks:.1f} s [{smi}]")

    # ---- 5. the LM kernels ------------------------------------------------
    flash_rows, flash_main = flash_phase(torch, fa, fa_ref, peaks, args.seed)
    wkv_rows, wkv_main = wkv_phase(torch, rw, rw_ref, peaks, args.seed)
    wkv_case_routes = {}
    for row in wkv_rows:
        wkv_case_routes[row["route"]] = wkv_case_routes.get(row["route"],
                                                            0) + 1
    check(set(wkv_case_routes) == set(rw.ROUTES),
          f"phase 5's WKV cases ran on both routes: {wkv_case_routes}")
    say(f"phase lm kernels: {len(flash_rows)} flash_attention and "
        f"{len(wkv_rows)} wkv_scan shape/dtype cases match their plain "
        f"versions; wkv_scan cases by route {wkv_case_routes}")
    # both WKV kernels as compiled, and the tensor-core kernel's shared
    # memory and blocks an SM as the runtime reports them
    if "wkv_scan" in nvcc:
        for needle in ("wkv_fwd", "wkv_chunk_tc"):
            for line in ptxas_entries(nvcc["wkv_scan"][1], needle):
                say(f"  ptxas wkv_scan: {line}")
    tc_smem, tc_blocks = rw.tc_occupancy()
    say(f"  wkv_scan tensor_core: {tc_smem} bytes of dynamic shared memory "
        f"a block, {tc_blocks} blocks an SM")

    # ---- 6. serving at full width, launch counts per call ----------------
    counts = Counts(torch, (ops, fa, rw))
    serving = {}
    for arch, kernel in (("qwen2-1.5b", "flash_attention"),
                         ("rwkv6-3b", "wkv_scan")):
        serving[arch] = serve_phase(torch, np, lm, serve, counts,
                                    ARCHS[arch], kernel, args.seed)
        say(f"phase serve {arch}: ServeEngine generate and serve at full "
            f"width on the card; launches {serving[arch]['launches']}")

    # ---- 7. the card against the CPU at the reduced configs --------------
    cmp_rows, cmp_launches = card_vs_cpu_phase(torch, np, lm, serve, counts,
                                               get_arch, args.seed)
    say("phase card vs cpu: reduced qwen2-1.5b and rwkv6-3b give the same "
        "greedy tokens on the card (kernels) and the CPU (plain versions)")

    # ---- 2, continued: device time per call of the main combine rows ----
    profile_main_rows(torch, ops, ref, to_profile, args.seed)
    say("phase kernels (device time): the main combine rows profiled")

    # ---- 4d. Section IV: placement, the simulator, a placed job ---------
    # (after every other profile, and the Table I row before Table II: on
    # the card, profiles taken after this phase's million-odd eager
    # launches held about half of their kernel records)
    t_loc = time.perf_counter()
    placed_rows, placed_launches, chains_profile = placed_phase(
        torch, np, pl, sim, eng, cc, count, job, subfiles, mesh,
        SchemeParams, hybrid_assignment, reconcile, args.seed, smi)
    t_table2 = time.perf_counter()
    table2_rows, table2_exact = table2_phase(np, pl, sim, SchemeParams, smi)
    table2_s = time.perf_counter() - t_table2
    locality_s = time.perf_counter() - t_loc
    say(f"phase locality: the ten Table II rows == BENCH_locality.json "
        f"({'bit for bit' if table2_exact else f'within {BENCH_RTOL} rel'}) "
        f"for random/greedy/flow/local_search and jct_gap, anneal on cuda "
        f">= flow, optimized JCT < random; the Table I row (r=2, 3) placed "
        f"by the annealer, bit-exact and on the combine kernels; launches "
        f"{placed_launches}; {table2_s:.1f} s Table II, {locality_s:.1f} s "
        f"the phase [{smi}]")

    # ---- 8. kernels line -------------------------------------------------
    by_path = {"shuffle": shuffle_launches, **engine_launches,
               "profiled": profile["launches"], "faults": fault_launches,
               "ranks": ranks_launches, "placed": placed_launches,
               **{f"serve {a}": r["launches"] for a, r in serving.items()},
               "card_vs_cpu": cmp_launches}
    # each kernel's main path: the fused engine for the linear pair, the
    # int32 hybrid_shuffle for the XOR pair, full-width serving for the LM
    # kernels
    main_path = {"coded_encode": "fused", "coded_decode": "fused",
                 "xor_encode": "shuffle", "xor_decode": "shuffle",
                 "flash_attention": "serve qwen2-1.5b",
                 "wkv_scan": "serve rwkv6-3b"}
    main_rows.update(flash_attention=flash_main["prefill"],
                     wkv_scan=wkv_main["prefill"])
    sources = {k: SOURCE for k in KERNELS}
    sources.update(coded_decode=DECODE_SOURCE,
                   xor_encode=XOR_SOURCE, xor_decode=XOR_SOURCE,
                   flash_attention=FLASH_SOURCE, wkv_scan=WKV_SOURCE)
    flash_routes = serving["qwen2-1.5b"]["routes"]
    check(flash_routes.get("tensor_core", 0) > 0
          and flash_routes.get("split_kv", 0) > 0,
          f"serving qwen2-1.5b took the tensor-core prefill and the "
          f"split-kv decode: {flash_routes}")
    wkv_routes = serving["rwkv6-3b"]["routes"]
    check(wkv_routes.get("tensor_core", 0) > 0
          and wkv_routes.get("step", 0) > 0,
          f"serving rwkv6-3b took the tensor-core prefill and the step "
          f"decode: {wkv_routes}")
    kernels = []
    for kname in KERNELS + LM_KERNELS:
        launches = by_path[main_path[kname]].get(kname, 0)
        check(launches > 0, f"{kname} launched on its main path "
              f"({main_path[kname]}): {by_path}")
        check(kname not in KERNELS or by_path["ranks"][kname] > 0,
              f"{kname} launched on the ranks path: {by_path['ranks']}")
        check(kname not in ("coded_encode", "coded_decode")
              or by_path["placed"][kname] > 0,
              f"{kname} launched on the placed path: {by_path['placed']}")
        row = main_rows[kname]
        kernels.append({"name": kname, "route": "cuda",
                        "source": sources[kname],
                        "replaces": REPLACES[kname],
                        "launches": launches,
                        "launches_by_path": {k: v.get(kname, 0)
                                             for k, v in by_path.items()},
                        "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                        "plain_ms": row["plain_ms"],
                        "bound_ms": row["bound_ms"],
                        "bound_by": row["bound_by"],
                        "library_ms": row["library_ms"],
                        "device_ms": row["device_ms"],
                        "library_device_ms": row.get("library_device_ms")})
        if kname == "flash_attention":
            # device kernels per call, by route, as profiled in phase 5
            per_call = {r["route"]: r["device_kernels"] for r in flash_rows
                        if "device_kernels" in r}
            check(set(per_call) >= {r for r, n in flash_routes.items() if n},
                  f"every flash route of the main path profiled: "
                  f"{per_call}")
            # phase 5's checked calls at head dims over 128, by route
            large_hd = {}
            for r in flash_rows:
                if r["hd"] > 128:
                    large_hd[r["route"]] = large_hd.get(r["route"], 0) + 1
            check(set(large_hd) == {"cuda_core", "split_kv"},
                  f"head dims over 128 ran on both routes: {large_hd}")
            kernels[-1].update(launches_by_route=flash_routes,
                               device_kernels_per_call=per_call,
                               hd_over_128_calls_by_route=large_hd)
        if kname == "wkv_scan":
            # by route on the main path (prefill on tensor_core, decode's
            # one-step calls on step), and phase 5's checked cases
            kernels[-1].update(launches_by_route=wkv_routes,
                               checked_cases_by_route=wkv_case_routes,
                               tc_smem_bytes=tc_smem,
                               tc_blocks_per_sm=tc_blocks)
    say(f"phase kernels line: launches by path {by_path}")
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({
        "device": smi, "torch": torch.__version__, "build_s": build_s,
        "nvcc": nvcc, "engine_peak_memory_gb": peak_gb,
        "kernels": kernel_rows, "shuffle": shuffle_runs,
        "engine": engine_runs, "profile": profile,
        "faults": fault_runs, "phase_timings": phase_row,
        "ranks": ranks_info,
        "locality": {"table2": table2_rows, "table2_exact": table2_exact,
                     "table2_s": table2_s, "placed": placed_rows,
                     "chains_profile": chains_profile,
                     "phase_s": locality_s},
        "lm_kernels": flash_rows + wkv_rows, "serving": serving,
        "card_vs_cpu": cmp_rows, "launches": by_path,
        "seconds": time.perf_counter() - t_start}, indent=1))
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
