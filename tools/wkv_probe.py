#!/usr/bin/env python3
"""Probes of the WKV scan's kernels on one CUDA card: the tensor-core
kernel (``src/repro_torch/kernels/rwkv_scan/csrc/wkv_chunk.cuh``) at
RWKV6-3B's prefill shape (8 x 2048, 40 heads of 64, bf16 streams, fp32
decay), and the fp32 chunk-parallel kernels (``csrc/wkv_chunk_f32.cuh``)
at Hymba's SSM prefill (8 x 2,560, 25 heads, state 16, head 64, inclusive
mode) and RWKV6-3B's fp32 prefill (rwkv mode).  Each builds its own copy
of the kernel sources with ``nvcc`` (the flags of
``repro_torch.kernels._build``) and needs a card:

    python tools/wkv_probe.py phases            # cycles a chunk, by phase
    python tools/wkv_probe.py tf32-bits         # does the low 13 bits count?
    python tools/wkv_probe.py ab NAME=HEADER ... # header variants in turns
    python tools/wkv_probe.py chunk-f32 NAME=kC:64,kMinBlocksC:3 ...
    python tools/wkv_probe.py f32-phases [CONST:VALUE,...]

``chunk-f32`` rewrites the named constants of wkv_chunk_f32.cuh a variant
(``NAME=`` alone keeps the file as it is), builds the variants side by
side, and times each at both shapes in turns (A B .. B A), one process a
timing, with its largest error against the plain version
``ref.wkv_chunk_f32_ref``, a hash of its output's bits and its device time
by kernel (profiler).  ``f32-phases`` patches ``clock64()`` reads in at
the phase comments of ``chunk_out`` and prints each warp's mean cycles a
chunk by phase at both shapes (the waits and barriers of the chunk loop,
block sums, M's diagonal blocks, the block states, out).

``phases`` patches ``clock64()`` reads in at the kernel's phase comments and
prints each warp's mean cycles a chunk per phase (the reads are issued
where the scheduler puts them, so a phase boundary can move a few hundred
cycles between warps; the total is sound).  ``tf32-bits`` runs one m16n8k8
TF32 product whose A operand has bits below TF32's 10-bit mantissa set:
reading back 1.0 for 1 + 0x1fff ulps shows the tensor cores drop them,
which the kernel's one-add rounding relies on.  ``ab`` builds each given
copy of ``wkv_chunk.cuh`` and times them in turns (A B .. B A, twice), one
process per timing, since two libraries with the same kernel names do not
mix in one process.
"""
from __future__ import annotations

import ctypes
import hashlib
import json
import pathlib
import re
import shutil
import concurrent.futures
import statistics
import subprocess
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
CSRC = ROOT / "src/repro_torch/kernels/rwkv_scan/csrc"
B, S, H, N = 8, 2048, 40, 64
PHASES = [  # (text in the kernel, clock read after it or before it)
    ("    __syncthreads();       // stage cur landed; chunk c - 1 done "
     "with both\n", "after"),
    ("    // ---- inter-chunk", "before"),
    ("    // ---- diagonal sub-chunk", "before"),
    ("    // ---- row block 1 after", "before"),
    ("    // ---- state: rows", "before"),
    ("    // ---- o += M . v", "before"),
    ("    // ---- the new state's TF32 copy", "before")]
NAMES = ["wait+barrier", "copies+running sums", "inter", "diagonal",
         "M[1][0]", "state+barrier", "M.v+store", "state copy"]


def build(workdir: pathlib.Path, header: str | None = None,
          patch=None, f32_consts: dict | None = None, edit=None,
          ) -> tuple[pathlib.Path, str]:
    """Copy the kernel sources to ``workdir`` (``header`` in place of
    wkv_chunk.cuh, ``patch`` applied to the two texts, ``f32_consts`` the
    new values of wkv_chunk_f32.cuh's constants), build, return the
    library and nvcc's -Xptxas -v report."""
    from repro_torch.kernels import _build
    for f in CSRC.iterdir():
        shutil.copy(f, workdir / f.name)
    if f32_consts:
        path = workdir / "wkv_chunk_f32.cuh"
        text = path.read_text()
        for name, value in f32_consts.items():
            text, n = re.subn(rf"constexpr int {name} = \d+;",
                              f"constexpr int {name} = {value};", text)
            if n != 1:
                raise RuntimeError(f"no constant {name} in {path.name}")
        path.write_text(text)
    if header:
        shutil.copy(header, workdir / "wkv_chunk.cuh")
    if patch:
        h, c = patch((workdir / "wkv_chunk.cuh").read_text(),
                     (workdir / "wkv_scan.cu").read_text())
        (workdir / "wkv_chunk.cuh").write_text(h)
        (workdir / "wkv_scan.cu").write_text(c)
    if edit:
        edit(workdir)
    so = workdir / "libprobe.so"
    p = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
                        str(so), str(workdir / "wkv_scan.cu")],
                       capture_output=True, text=True)
    if p.returncode:
        raise RuntimeError(p.stderr)
    return so, p.stderr


def prefill_call(torch, lib):
    """The prefill inputs from seed 1 and a launcher of ``lib``'s kernel."""
    from repro_torch.kernels import _build
    lib.wkv_forward_tc.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 8
                                   + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    rnd = lambda *s: torch.randn(s, generator=g, device=dev)
    r, k, v = (rnd(B, S, H, N).bfloat16() for _ in range(3))
    w, u, s0 = -torch.exp(rnd(B, S, H, N)), 0.1 * rnd(H, N), \
        0.1 * rnd(B, H, N, N)
    out, sT = torch.empty_like(v), torch.empty(B, H, N, N, device=dev)
    ptrs = [x.data_ptr() for x in (r, k, v, w, u, s0, out, sT)]

    def call():
        rc = lib.wkv_forward_tc(0, *ptrs, B, S, H, N, N,
                                _build.stream_handle())
        if rc:
            raise RuntimeError(f"wkv_forward_tc returned {rc}")
    return call, (r, k, v, w, u, s0, out, sT)


def events_ms(torch, fn, reps=7, inner=20) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times)


def phases(torch) -> None:
    def patch(h, c):
        for i, (mark, where) in enumerate(PHASES):
            if h.count(mark) != 1:
                raise RuntimeError(f"phase mark not found once: {mark!r}")
            h = h.replace(mark, mark + f"    PH({i})\n" if where == "after"
                          else f"    PH({i})\n" + mark)
        h = h.replace("  const int nc = (T_len + kC - 1) / kC;\n",
                      "  const int nc = (T_len + kC - 1) / kC;\n"
                      "  long long clk_acc[8] = {}, clk_t = clock64();\n")
        h = h.replace("  }\n\n  float* sTh = sT",
                      "    PH(7)\n  }\n\n  float* sTh = sT")
        h = h.replace("  float* sTh = sT",
                      "  if (lane == 0)\n    for (int i = 0; i < 8; ++i)\n"
                      "      g_clk[(blockIdx.x * 4 + wid) * 8 + i] = "
                      "clk_acc[i];\n  float* sTh = sT")
        h = h.replace("namespace wkvtc {\n", "namespace wkvtc {\n"
                      "__device__ long long g_clk[1 << 16];\n"
                      "#define PH(i) { long long n_ = clock64(); "
                      "clk_acc[i] += n_ - clk_t; clk_t = n_; }\n")
        c = c.rstrip()[:-len('}  // extern "C"')] + (
            "int read_clk(long long* out, int n) { return (int)"
            "cudaMemcpyFromSymbol(out, wkvtc::g_clk, n * sizeof(long "
            "long)); }\n}  // extern \"C\"\n")
        return h, c

    so, _ = build(pathlib.Path(tempfile.mkdtemp()), patch=patch)
    lib = ctypes.CDLL(str(so))
    call, _ = prefill_call(torch, lib)
    print(f"instrumented kernel {events_ms(torch, call):.5f} ms")
    n = B * H * 4 * 8
    buf = (ctypes.c_longlong * n)()
    lib.read_clk.argtypes = [ctypes.c_void_p, ctypes.c_int]
    if lib.read_clk(ctypes.addressof(buf), n):
        raise RuntimeError("read_clk failed")
    chunks = -(-S // 32)
    for w in range(4):
        per = [statistics.mean(buf[(b * 4 + w) * 8 + i] for b in range(B * H))
               / chunks for i in range(8)]
        print(f"warp {w}: " + ", ".join(f"{nm} {x:.0f}" for nm, x in
                                        zip(NAMES, per))
              + f"; total {sum(per):.0f} cycles a chunk")


def tf32_bits(torch) -> None:
    from repro_torch.kernels import _build
    d = pathlib.Path(tempfile.mkdtemp())
    (d / "probe.cu").write_text(r'''
#include <cuda_runtime.h>
#include <stdint.h>
__global__ void one(float* out, uint32_t a) {
  uint32_t a0 = threadIdx.x ? 0u : a, b0 = threadIdx.x ? 0u : 0x3f800000u;
  float d[4] = {0.f, 0.f, 0.f, 0.f};
  asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
               "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
               : "r"(a0), "r"(0u), "r"(0u), "r"(0u), "r"(b0), "r"(0u));
  if (threadIdx.x == 0) out[0] = d[0];   // A[0][0] * B[0][0]
}
extern "C" int run(float* out, unsigned a) {
  one<<<1, 32>>>(out, a);
  return (int)cudaDeviceSynchronize();
}
''')
    p = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
                        str(d / "p.so"), str(d / "probe.cu")],
                       capture_output=True, text=True)
    if p.returncode:
        raise RuntimeError(p.stderr)
    lib = ctypes.CDLL(str(d / "p.so"))
    lib.run.argtypes = [ctypes.c_void_p, ctypes.c_uint]
    out = torch.zeros(1, device="cuda")
    for bits, what in ((0x3F801FFF, "1 + 0x1fff ulps (below TF32)"),
                       (0x3F800FFF + 0x1000, "1 + 0xfff ulps, + half ulp"),
                       (0x3F801000 + 0x1000, "1 + 0x1000 ulps, + half ulp"),
                       (0x3F802000, "1 + 2^-10")):
        if lib.run(out.data_ptr(), bits):
            raise RuntimeError("probe kernel failed")
        print(f"A = {bits:#x} ({what}) -> A * 1 = {out.item()!r}")


def ab(torch, specs) -> None:
    sos = {}
    for spec in specs:
        name, header = spec.split("=", 1)
        so, log = build(pathlib.Path(tempfile.mkdtemp()), header=header)
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
        print(f"{name}: {regs[-1] if regs else '?'}", flush=True)
        sos[name] = str(so)
    times = {n: [] for n in sos}
    for _ in range(2):
        for name in list(sos) + list(sos)[::-1]:
            p = subprocess.run([sys.executable, __file__, "_time", sos[name]],
                               capture_output=True, text=True)
            if p.returncode:
                raise RuntimeError(p.stderr[-2000:])
            times[name].append(float(p.stdout.split()[-1]))
            print(f"  {name}: {times[name][-1]:.5f} ms", flush=True)
    for name, ts in times.items():
        print(f"{name}: median {statistics.median(ts):.5f} ms of {len(ts)}")


F32_SHAPES = {  # tag: (B, S, H, Nk, Nv, inclusive)
    "hymba_prefill": (8, 2560, 25, 16, 64, True),
    "rwkv6_f32_prefill": (8, 2048, 40, 64, 64, False)}


def chunk_f32(torch, specs) -> None:
    """Build each ``NAME=CONST:VALUE,...`` variant of wkv_chunk_f32.cuh and
    time them in turns at both shapes, one process a timing."""
    variants = {}
    for spec in specs:
        name, _, rest = spec.partition("=")
        variants[name] = dict(kv.split(":") for kv in rest.split(",")
                              if kv)
    with concurrent.futures.ThreadPoolExecutor(len(variants)) as pool:
        built = dict(zip(variants, pool.map(
            lambda c: build(pathlib.Path(tempfile.mkdtemp()),
                            f32_consts=c), variants.values())))
    for name, (so, log) in built.items():
        print(f"{name} {variants[name]}:", flush=True)
        for needle in ("chunk_state", "chunk_scan", "chunk_out"):
            keep = False
            for ln in log.splitlines():
                if "Compiling entry function" in ln:
                    keep = needle in ln and ("Li16E" in ln or "Li64E" in ln
                                             or needle == "chunk_scan")
                if keep and ("registers" in ln or "spill" in ln
                             or "Compiling" in ln):
                    print("   ", ln.strip()[:160], flush=True)
    times = {n: [] for n in built}
    for name in list(built) + list(built)[::-1]:
        p = subprocess.run([sys.executable, __file__, "_time_f32",
                            str(built[name][0])], capture_output=True,
                           text=True)
        if p.returncode:
            raise RuntimeError(p.stderr[-3000:])
        res = json.loads(p.stdout.strip().splitlines()[-1])
        times[name].append(res)
        print(f"  {name}: " + "; ".join(
            f"{tag} {r['ms']:.5f} ms (err {r['max_abs_err']:.3g}, bits "
            f"{r['bits'][:12]}, by kernel {r['device_ms_by_kernel']}"
            + (f", step/chunk/chunk/step in turns "
               f"{r['turns_step_chunk_chunk_step_ms']}"
               if "turns_step_chunk_chunk_step_ms" in r else "") + ")"
            for tag, r in res.items()), flush=True)
    for name, runs in times.items():
        print(f"{name}: " + ", ".join(
            f"{tag} {min(r[tag]['ms'] for r in runs):.5f}-"
            f"{max(r[tag]['ms'] for r in runs):.5f} ms"
            for tag in F32_SHAPES), flush=True)


F32_PHASES = ["    // ---- block sums", "    // ---- M's diagonal blocks",
              "    // ---- the blocks' starting states", "    // ---- out = Qh"]
F32_PHASE_NAMES = ["wait+barriers", "block sums", "M diag", "block states",
                   "out"]


def f32_phases(torch, spec: str) -> None:
    """Cycles a chunk by phase of chunk_out (one variant)."""
    consts = dict(kv.split(":") for kv in spec.split(",") if kv)

    def patch(workdir):
        path = workdir / "wkv_chunk_f32.cuh"
        h = path.read_text()
        for i, mark in enumerate(F32_PHASES):
            if h.count(mark) != 1:
                raise RuntimeError(f"phase mark not found once: {mark!r}")
            h = h.replace(mark, f"    PH({i})\n" + mark)
        body_end = ("          if (4 * cg + q < a.nv) o[q] = acc[r][q];\n"
                    "      }\n    }\n  });\n}")
        if h.count(body_end) != 1:
            raise RuntimeError("chunk_out's end not found once")
        h = h.replace(body_end, body_end[:-len("  });\n}")]
                      + "    PH(4)\n  });\n  if (tid % 32 == 0)\n"
                      "    for (int i = 0; i < 5; ++i)\n"
                      "      g_clk[((int64_t(blockIdx.y) * gridDim.x + "
                      "blockIdx.x) * 16 + tid / 32) * 5 + i] = clk_acc[i];\n}")
        h = h.replace("  SmemCFixed<NK>& x = sm.x;\n",
                      "  SmemCFixed<NK>& x = sm.x;\n"
                      "  long long clk_acc[5] = {}, clk_t = clock64();\n")
        h = h.replace("namespace wkvf32 {\n", "namespace wkvf32 {\n"
                      "__device__ long long g_clk[1 << 21];\n"
                      "#define PH(i) { long long n_ = clock64(); "
                      "clk_acc[i] += n_ - clk_t; clk_t = n_; }\n")
        path.write_text(h)
        c = (workdir / "wkv_scan.cu").read_text().rstrip()
        c = c[:-len('}  // extern "C"')] + (
            "int read_clk(long long* out, int n) { return (int)"
            "cudaMemcpyFromSymbol(out, wkvf32::g_clk, n * sizeof(long "
            "long)); }\n}  // extern \"C\"\n")
        (workdir / "wkv_scan.cu").write_text(c)

    so, _ = build(pathlib.Path(tempfile.mkdtemp()), f32_consts=consts,
                  edit=patch)
    lib = ctypes.CDLL(str(so))
    lib.read_clk.argtypes = [ctypes.c_void_p, ctypes.c_int]
    for tag, res in time_f32(torch, str(so), lib=lib,
                             after=_read_phases).items():
        print(f"{tag}: {res['ms']:.5f} ms; " + res["phases"], flush=True)


def _read_phases(lib, B, S, H, chunk, warps=8):
    """Each warp's mean cycles a chunk by phase, from the last call (one
    block a chunk)."""
    blocks = B * H * -(-S // chunk)
    n = blocks * 16 * 5
    buf = (ctypes.c_longlong * n)()
    if lib.read_clk(ctypes.addressof(buf), n):
        raise RuntimeError("read_clk failed")
    chunks = blocks
    out = []
    for w in range(warps):
        per = [sum(buf[(b * 16 + w) * 5 + i] for b in range(blocks)) / chunks
               for i in range(5)]
        out.append(f"warp {w}: " + ", ".join(
            f"{nm} {x:.0f}" for nm, x in zip(F32_PHASE_NAMES, per))
            + f"; total {sum(per):.0f}")
    return "cycles a chunk: " + " | ".join(out)


def time_f32(torch, so, lib=None, after=None) -> dict:
    """One variant's times, errors, bit hashes and device time by kernel
    at both shapes (inputs from seed 1)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.rwkv_scan import ops, ref
    lib = lib or ctypes.CDLL(so)
    lib.wkv_forward_chunk_f32.argtypes = [ctypes.c_int, ctypes.c_void_p,
                                          ctypes.c_void_p]
    chunk = lib.wkv_chunk_f32_chunk()
    dev = torch.device("cuda")
    out_all = {}
    for tag, (B, S, H, Nk, Nv, incl) in F32_SHAPES.items():
        g = torch.Generator(device=dev).manual_seed(1)
        rnd = lambda *s: torch.randn(s, generator=g, device=dev)
        q, k, v = rnd(B, S, H, Nk), rnd(B, S, H, Nk), rnd(B, S, H, Nv)
        if incl:
            dt = torch.nn.functional.softplus(rnd(B, S, H))
            w = dt[..., None] * -torch.linspace(1.0, 16.0, Nk, device=dev)
            k = k * dt[..., None]
            u = None
        else:
            w, u = -torch.exp(rnd(B, S, H, Nk)), 0.1 * rnd(H, Nk)
        s0 = 0.1 * rnd(B, H, Nk, Nv)
        out, sT = torch.empty_like(v), torch.empty_like(s0)
        args, scratch = ops.chunk_f32_args(q, k, v, w, u, s0, out, sT,
                                           chunk=chunk)

        def call():
            rc = lib.wkv_forward_chunk_f32(int(incl), ctypes.addressof(args),
                                           _build.stream_handle())
            if rc:
                raise RuntimeError(f"wkv_forward_chunk_f32 returned {rc}")
        call()
        torch.cuda.synchronize()
        po, ps = ref.wkv_chunk_f32_ref(
            q, k, v, w, u, s0, mode="inclusive" if incl else "rwkv")
        err = max(float((out - po).abs().max()),
                  float((sT - ps).abs().max()))
        del po, ps
        bits = hashlib.sha256(out.cpu().numpy().tobytes()
                              + sT.cpu().numpy().tobytes()).hexdigest()
        ms = events_ms(torch, call)
        prof = torch.profiler
        with prof.profile(activities=[prof.ProfilerActivity.CUDA]) as pr:
            for _ in range(10):
                call()
            torch.cuda.synchronize()
        by_kernel = {}
        for e in pr.key_averages():
            t = getattr(e, "device_time_total", None)
            if t is None:
                t = e.cuda_time_total
            for name in ("chunk_state", "chunk_scan", "chunk_out"):
                if name in e.key and t:
                    by_kernel[name] = round(t / 10 / 1e3, 6)
        out_all[tag] = {"ms": ms, "max_abs_err": err, "bits": bits,
                        "device_ms_by_kernel": by_kernel}
        if not incl:
            # the step kernel on the same inputs, in turns with the route
            lib.wkv_forward.argtypes = ([ctypes.c_int] * 2
                                        + [ctypes.c_void_p] * 8
                                        + [ctypes.c_int] * 5
                                        + [ctypes.c_void_p])
            o2, s2 = torch.empty_like(out), torch.empty_like(sT)
            ptrs = [x.data_ptr() for x in (q, k, v, w, u, s0, o2, s2)]

            def step():
                rc = lib.wkv_forward(0, 0, *ptrs, B, S, H, Nk, Nv,
                                     _build.stream_handle())
                if rc:
                    raise RuntimeError(f"wkv_forward returned {rc}")
            turns = [events_ms(torch, f) for f in (step, call, call, step)]
            out_all[tag]["turns_step_chunk_chunk_step_ms"] = turns
        if after:
            call()
            torch.cuda.synchronize()
            out_all[tag]["phases"] = after(lib, B, S, H, chunk)
    return out_all


def main(argv) -> int:
    import torch
    if not torch.cuda.is_available():
        print("wkv_probe: no CUDA device available", file=sys.stderr)
        return 1
    if argv[:1] == ["phases"]:
        phases(torch)
    elif argv[:1] == ["tf32-bits"]:
        tf32_bits(torch)
    elif argv[:1] == ["ab"] and len(argv) > 1:
        ab(torch, argv[1:])
    elif argv[:1] == ["chunk-f32"] and len(argv) > 1:
        chunk_f32(torch, argv[1:])
    elif argv[:1] == ["f32-phases"]:
        f32_phases(torch, argv[1] if len(argv) > 1 else "")
    elif argv[:1] == ["_time_f32"]:
        print(json.dumps(time_f32(torch, argv[1])))
    elif argv[:1] == ["_time"]:
        call, _ = prefill_call(torch, ctypes.CDLL(argv[1]))
        print(events_ms(torch, call))
    else:
        print(__doc__, file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
