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
              on the card, at the main path's launch shapes and at odd
              shapes, with CUDA-event times and the HBM bound; where one
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
``forward``, ``prefill`` and ``decode_step`` call and read just after.  A
coded shuffle with ``combine_impl="kernel"`` and packet arity >= 2 must
launch one encode and one decode, other shuffles none; under faults that
holds on the ``none`` and ``restart`` rungs, and the degraded rungs
(``decode_around``, ``partial_remap``: unicast stage 1) launch none; every
LM forward
(a prefill or one decode step) must launch its kernel once per layer (28
flash launches for qwen2-1.5b, 32 WKV launches for rwkv6-3b) and call no
plain version; every time-to-first-token call runs all of them on the
``tensor_core`` route of its kernel.  Main paths: the fused engine for the
linear pair, the int32 ``hybrid_shuffle`` for the XOR pair, full-width
serving for the LM kernels.

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


def kernel_phase(torch, ops, ref, main_shapes, peaks, seed):
    """Compare and time every kernel; returns (rows, {kernel: row at the
    main path's largest launch shape}, main rows to profile).  A row with
    a library call times the kernel and the library in turns (kernel,
    library, library, kernel).  The main rows' device times per call come
    later (``profile_main_rows``): every profiler session here would cost
    the later phases' profiles records."""
    dev = torch.device("cuda")
    odd = [(r, T, d) for r in (2, 3, 4) for T, d in
           ((1, 7), (257, 40), (300, 130))]
    rows, main, to_profile = [], {}, []

    def record(name, r, T, d, dtype, unit, err, tol, fn, plain, library,
               is_main):
        n = T * d
        itemsize = torch.empty((), dtype=dtype).element_size()
        nbytes = (r + 1) * n * itemsize
        big = n >= 1 << 20
        reps, inner = (11, 40) if big else (5, 50)
        row = {"name": name, "r": r, "T": T, "d": d,
               "dtype": str(dtype).replace("torch.", ""),
               "coeffs": "unit" if unit else "1..r",
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
    for (r, T, d), is_main in ([(s, True) for s in main_shapes]
                               + [(s, False) for s in odd]):
        unit = is_main                    # the shuffle's coefficients
        for dtype in (torch.float32, torch.bfloat16):
            xs = torch.randn(r, T, d, generator=g, device=dev).to(dtype)
            c = (torch.ones(r, device=dev) if unit
                 else torch.arange(1.0, r + 1.0, device=dev))
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
            record("coded_encode", r, T, d, dtype, unit, err_of(f, f_ref),
                   _tol_text(enc_tol, enc_tol),
                   *combine_calls(torch, ops, ref, "coded_encode", xs, c, f,
                                  unit), is_main and is_f32)
            record("coded_decode", r, T, d, dtype, unit,
                   err_of(dec, dec_ref), _tol_text(*dec_tol),
                   *combine_calls(torch, ops, ref, "coded_decode", xs, c, f,
                                  unit), is_main)
        for dtype in (torch.int32, torch.uint32):
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
                record(name, r, T, d, dtype, True, 0.0, "exact",
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
    from repro_torch.configs import ARCHS, get_arch
    from repro_torch.core import coded_collectives as cc
    from repro_torch.core import costs
    from repro_torch.core import degraded as dg
    from repro_torch.core.params import SchemeParams
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
    kernel_rows, main_rows, to_profile = kernel_phase(
        torch, ops, ref, main_shapes, peaks, args.seed)
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

    # ---- 8. kernels line -------------------------------------------------
    by_path = {"shuffle": shuffle_launches, **engine_launches,
               "profiled": profile["launches"], "faults": fault_launches,
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
