#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card and
check it.

    python3 chip_smoke.py [--seed 0] [--out chiprun_out/chip_smoke.json]

Configuration: the paper's Table I row (K=16, P=4, Q=16, N=1680) with
``wide_histogram_job(d=2048)``, each subfile 16,384 int32 tokens drawn from
``--seed`` in [0, 2^16).  Every per-key total stays below 2^24, so every
partial sum of the integer-valued float32 payloads is exact in any order
and all results compare bit for bit.

Phases, one printed line each (plus detail lines):

1. device   — ``nvidia-smi`` name and power limit, the card, and the
              kernels' build time (``nvcc`` from the checkout's sources).
2. kernels  — each CUDA kernel against its plain PyTorch version on the
              card, at the main path's launch shapes and at odd shapes,
              with CUDA-event times, the HBM bound and one library call.
3. shuffle  — ``hybrid_shuffle`` for r in {2, 3} x {unicast, coded} x
              {torch, kernel} and ``coded_xor`` on int32 payloads, bit-exact
              against the port's NumPy ``simulate_plan_shuffle`` and
              ``plan_shuffle_reference``.
4. engine   — ``run_job_distributed`` fused and legacy, binomial r in
              {1, 2, 3} and resolvable r = 2, every multicast x combine
              pairing: outputs bit-exact against the dense ``run_job``,
              costs and rack bytes equal to the closed forms.
5. kernels line — one JSON object with each kernel's launches on its
              main path and its numbers at the main path's largest shape.

Launch counts are read per call: they are zeroed just before every
``hybrid_shuffle`` and ``run_job_distributed`` call of phases 3 and 4 and
read just after, and each call must launch exactly the kernels its wire
format needs (one encode and one decode per coded shuffle with
``combine_impl="kernel"`` and packet arity >= 2, none otherwise).  They are
summed per path: ``shuffle`` (direct ``hybrid_shuffle``), ``fused`` and
``legacy`` engine runs, and the ``profiled`` fused job.  The main path of
the linear kernels is the fused engine; that of the XOR kernels is
``hybrid_shuffle`` on int32 payloads (the jobs are float32).

The last line is ``{"ok": true, "device": {...}}``.  Any failed check
raises and the script exits non-zero; without a CUDA card it exits 1 and
prints no result.  Imports nothing of JAX or of the JAX package ``repro``.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
K, P, Q, N, D = 16, 4, 16, 1680, 2048
TOKENS = 16384
SOURCE = "src/repro_torch/kernels/coded_combine/csrc/coded_combine.cu"
REPLACES = {"coded_encode": "src/repro/kernels/coded_combine/kernel.py:58",
            "coded_decode": "src/repro/kernels/coded_combine/kernel.py:74",
            "xor_encode": "src/repro/kernels/coded_combine/kernel.py:91",
            "xor_decode": "src/repro/kernels/coded_combine/kernel.py:105"}

# published peaks by the name nvidia-smi gives the card, at its full power
# limit (NVIDIA's data sheet): HBM bytes/s and float32 FLOP/s outside the
# tensor cores.  "H100 80GB HBM3" is the SXM part.
PEAKS = {"NVIDIA H100 80GB HBM3": (3.35e12, 67e12)}
KERNELS = ("coded_encode", "coded_decode", "xor_encode", "xor_decode")


def say(*parts) -> None:
    print(*parts, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def _tol_text(rtol: float, atol: float) -> str:
    return "exact" if rtol == atol == 0 else f"rtol={rtol},atol={atol}"


def counted(ops, fn):
    """``fn()`` with the launch counts zeroed just before it and read just
    after; returns (its result, {kernel: launches})."""
    ops.reset_launch_counts()
    out = fn()
    return out, dict(ops.LAUNCHES)


def expected_launches(multicast: str, combine_impl: str, arity: int):
    """The launches one stacked shuffle makes: one encode and one decode
    for all K servers when a coded format runs on the kernels."""
    want = dict.fromkeys(KERNELS, 0)
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


# ---------------------------------------------------------------------------
# Phase 2: the four kernels against their plain versions
# ---------------------------------------------------------------------------

def kernel_phase(torch, ops, ref, main_shapes, peaks, seed):
    """Compare and time every kernel; returns {kernel: row at the main
    path's largest launch shape}."""
    bw, flops = peaks
    dev = torch.device("cuda")
    odd = [(r, T, d) for r in (2, 3, 4) for T, d in
           ((1, 7), (257, 40), (300, 130))]
    rows, main = [], {}

    def bound(nbytes, nops):
        t_bytes, t_ops = nbytes / bw * 1e3, nops / flops * 1e3
        return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                     else "operations")

    def record(name, r, T, d, dtype, unit, err, tol, fn, plain, library,
               nops, is_main):
        n = T * d
        itemsize = torch.empty((), dtype=dtype).element_size()
        nbytes = (r + 1) * n * itemsize
        big = n >= 1 << 20
        reps, inner = (7, 20) if big else (5, 50)
        row = {"name": name, "r": r, "T": T, "d": d,
               "dtype": str(dtype).replace("torch.", ""),
               "coeffs": "unit" if unit else "1..r",
               "max_abs_err": err, "tolerance": tol,
               "ms": cuda_ms(torch, fn, reps, inner),
               "plain_ms": cuda_ms(torch, plain, reps, inner),
               "library_ms": (None if library is None
                              else cuda_ms(torch, library, reps, inner)),
               "bytes": nbytes}
        row["bound_ms"], row["bound_by"] = bound(nbytes, nops * n)
        rows.append(row)
        lib_ms = row["library_ms"]
        lib_txt = "null" if lib_ms is None else f"{lib_ms:.6f}"
        say(f"  kernel {name} r={r} T={T} d={d} {row['dtype']} "
            f"coeffs={row['coeffs']}: kernel_ms={row['ms']:.6f} "
            f"plain_ms={row['plain_ms']:.6f} library_ms={lib_txt} "
            f"bytes={nbytes} bound_ms={row['bound_ms']:.6f} "
            f"max_abs_err={err!r} tolerance={tol}")
        if is_main:
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
            known = xs[1:]
            record("coded_encode", r, T, d, dtype, unit, err_of(f, f_ref),
                   _tol_text(enc_tol, enc_tol),
                   lambda: ops.coded_encode(xs, c),
                   lambda: ref.encode_ref(xs, c),
                   (lambda: xs.sum(0)) if unit else None, 2 * r - 1,
                   is_main and dtype == torch.float32)
            record("coded_decode", r, T, d, dtype, unit,
                   err_of(dec, dec_ref), _tol_text(*dec_tol),
                   lambda: ops.coded_decode(f, known, c),
                   lambda: ref.decode_ref(f, known, c),
                   (lambda: torch.sub(f, known[0])) if unit and r == 2
                   else None, 2 * r - 1,
                   is_main and dtype == torch.float32)
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
            known = xs[1:]
            record("xor_encode", r, T, d, dtype, True, 0.0, "exact",
                   lambda: ops.xor_encode(xs),
                   lambda: ref.xor_encode_ref(xs),
                   (lambda: torch.bitwise_xor(words[0], words[1]))
                   if r == 2 and is_int else None, r - 1,
                   is_main and is_int and r == 2)
            record("xor_decode", r, T, d, dtype, True, 0.0, "exact",
                   lambda: ops.xor_decode(f, known),
                   lambda: ref.xor_decode_ref(f, known),
                   (lambda: torch.bitwise_xor(f, known[0]))
                   if r == 2 and is_int else None, r - 1,
                   is_main and is_int and r == 2)
        del xs
    torch.cuda.synchronize()
    return rows, main


# ---------------------------------------------------------------------------
# Phase 3: the stacked shuffle against the NumPy oracles
# ---------------------------------------------------------------------------

def shuffle_phase(torch, np, cc, ops, make_mesh, SchemeParams, seed):
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
                    (out, ms), counts = counted(ops, run)
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

def engine_phase(torch, np, eng, jobs, ops, make_mesh, SchemeParams, costs,
                 reconcile, seed):
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
                        (res, ms), counts = counted(ops, run)
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


def profile_fused(torch, eng, ops, job, subfiles, mesh, SchemeParams,
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
            (res, wall_ms), counts = counted(ops, run)
    finally:
        enable_tracing(False)
    check(counts == expected_launches("coded", "kernel", 2),
          f"profiled fused job launches {counts}")
    top = []
    for ev in prof.key_averages():
        # device-side events (the kernels and copies themselves) only, so
        # an operator and the kernels it launched are not counted twice
        if not str(getattr(ev, "device_type", "")).endswith("CUDA"):
            continue
        dev_us = getattr(ev, "device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "cuda_time_total", 0.0)
        if dev_us > 0:
            top.append((dev_us / 1e3, ev.count, ev.key))
    top.sort(reverse=True)
    busy = sum(t for t, _, _ in top)
    # the engine's engine_phase spans, host clock, in ms
    spans = {k: v * 1e3 for k, v in (res.blame or {}).items()}
    return {"wall_ms": wall_ms, "device_busy_ms": busy, "span_ms": spans,
            "launches": counts,
            "by_kernel": [{"ms": t, "count": c, "name": k[:100]}
                          for t, c, k in top[:12]]}


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
    from repro_torch.core import coded_collectives as cc
    from repro_torch.core import costs
    from repro_torch.core.params import SchemeParams
    from repro_torch.distributed.meshes import make_mesh
    from repro_torch.kernels import _build
    from repro_torch.kernels.coded_combine import ops, ref
    from repro_torch.mapreduce import engine as eng
    from repro_torch.mapreduce import jobs
    from repro_torch.obs.bytes import reconcile
    from repro_torch.obs.tracing import enable_tracing

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
    build_s = ops.build()
    # an entry exists only if this process ran nvcc (else the library was
    # built earlier from the same sources and only loaded)
    nvcc_s, ptxas = _build.BUILD_LOG.get("coded_combine", (None, ""))
    how = ("loaded a library built earlier from the same sources"
           if nvcc_s is None else f"nvcc took {nvcc_s:.3f} s")
    say(f"phase device: {name}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; kernels ready in {build_s:.3f} s ({how}); "
        f"HBM {peaks[0]:.3e} B/s, fp32 {peaks[1]:.3e} FLOP/s "
        f"(data sheet of {smi_name})")
    for line in ptxas.splitlines():
        if "registers" in line or "spill" in line:
            say(f"  ptxas: {line.strip()}")

    # ---- 2. kernels ------------------------------------------------------
    main_shapes = []
    for r in (2, 3):
        plan = cc.compile_hybrid_plan(SchemeParams(K=K, P=P, Q=Q, N=N, r=r))
        main_shapes.append((r, K * P * plan.n_send * (Q // P), D))
    check(main_shapes == [(2, 17920, D), (3, 8960, D)],
          f"main-path launch shapes {main_shapes}")
    kernel_rows, main_rows = kernel_phase(torch, ops, ref, main_shapes,
                                          peaks, args.seed)
    say(f"phase kernels: {len(kernel_rows)} kernel/shape/dtype cases match "
        f"their plain versions")

    # ---- 3 + 4. the main paths, launch counts zeroed before each call ----
    shuffle_runs, shuffle_launches = shuffle_phase(
        torch, np, cc, ops, make_mesh, SchemeParams, args.seed)
    say(f"phase shuffle: {len(shuffle_runs)} hybrid_shuffle runs bit-exact "
        f"vs simulate_plan_shuffle and plan_shuffle_reference; launches "
        f"{shuffle_launches}")
    torch.cuda.reset_peak_memory_stats()
    engine_runs, engine_launches, subfiles, job, mesh = engine_phase(
        torch, np, eng, jobs, ops, make_mesh, SchemeParams, costs, reconcile,
        args.seed)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    say(f"phase engine: {len(engine_runs)} run_job_distributed runs "
        f"bit-exact vs run_job; peak device memory {peak_gb:.3f} GB; "
        f"launches fused {engine_launches['fused']} legacy "
        f"{engine_launches['legacy']}")
    profile = profile_fused(torch, eng, ops, job, subfiles, mesh,
                            SchemeParams, enable_tracing)
    idle = 1.0 - profile["device_busy_ms"] / profile["wall_ms"]
    spans = " ".join(f"{k}={v:.3f}" for k, v in profile["span_ms"].items())
    say(f"  profile fused binomial r=2 coded kernel: wall_ms="
        f"{profile['wall_ms']:.3f} device_busy_ms="
        f"{profile['device_busy_ms']:.3f} device_idle_share={idle:.3f}; "
        f"engine spans (host ms) {spans}")
    for k in profile["by_kernel"][:8]:
        say(f"    {k['ms']:.3f} ms x{k['count']} {k['name']}")

    # ---- 5. kernels line -------------------------------------------------
    by_path = {"shuffle": shuffle_launches, **engine_launches,
               "profiled": profile["launches"]}
    # each kernel's main path: the fused engine for the linear pair, the
    # int32 hybrid_shuffle for the XOR pair
    main_path = {"coded_encode": "fused", "coded_decode": "fused",
                 "xor_encode": "shuffle", "xor_decode": "shuffle"}
    kernels = []
    for kname in KERNELS:
        launches = by_path[main_path[kname]][kname]
        check(launches > 0, f"{kname} launched on its main path "
              f"({main_path[kname]}): {by_path}")
        row = main_rows[kname]
        kernels.append({"name": kname, "route": "cuda", "source": SOURCE,
                        "replaces": REPLACES[kname],
                        "launches": launches,
                        "launches_by_path": {k: v[kname]
                                             for k, v in by_path.items()},
                        "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                        "plain_ms": row["plain_ms"],
                        "bound_ms": row["bound_ms"],
                        "bound_by": row["bound_by"],
                        "library_ms": row["library_ms"]})
    say(f"phase kernels line: launches by path {by_path}")
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({
        "device": smi, "torch": torch.__version__, "build_s": build_s,
        "nvcc_s": nvcc_s, "engine_peak_memory_gb": peak_gb,
        "ptxas": ptxas, "kernels": kernel_rows, "shuffle": shuffle_runs,
        "engine": engine_runs, "profile": profile, "launches": by_path,
        "seconds": time.perf_counter() - t_start}, indent=1))
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
