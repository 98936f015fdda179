"""Probe the WKV backward's ``chunk`` route
(``src/repro_torch/kernels/rwkv_scan/csrc/wkv_backward_chunk.cuh``) on the
card.  Three modes:

    python tools/wkv_bwd_probe.py turns
    python tools/wkv_bwd_probe.py phases LINE,LINE,...
    python tools/wkv_bwd_probe.py variants base 'NAME=OLD=>NEW;;OLD=>NEW' ...

``turns`` builds the library as the port does, prints the ptxas lines of
the route's kernels, holds it against its mirror ``ref.wkv_backward_chunk_ref``
and the plain backward at small shapes, then at ``CASES`` times the route
and the ``step`` kernels at the same shape in turns (chunk, step, step,
chunk; CUDA events) with the profiler's device ms by kernel.

``phases`` reads ``chunk_grads``' cycles a block by phase: a copy of
``csrc/`` with a ``clock64`` read after each given line of the header
(thread 0 of each block adds its deltas to a device array), averaged over
the blocks of one call at RWKV6's and Hymba's train microbatch.

``variants`` times variants of the header in turns, one process each (two
libraries holding the same kernel names in one process fail to launch).
A variant is a name and text substitutions on the header, ``OLD=>NEW``
pairs joined by ``;;`` (``base`` is the header as it is; a substitution
that matches nothing is refused).  Each is built with nvcc (all at once)
into ``src/repro_torch/kernels/_build/variants/wkv_bwd/<name>/`` and runs
``CASES`` in fp32 (its largest error against the mirror relative to each
gradient's largest entry, a hash of the output bits, CUDA-event ms, the
profiler's device ms by kernel), in the order given and then reversed:
one ``RESULT`` line of JSON a run, then the variants' ptxas spills.
"""
from __future__ import annotations

import concurrent.futures
import ctypes
import hashlib
import json
import pathlib
import shutil
import statistics
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
CSRC = ROOT / "src/repro_torch/kernels/rwkv_scan/csrc"
HEADER = "wkv_backward_chunk.cuh"
OUT = ROOT / "src/repro_torch/kernels/_build/variants/wkv_bwd"
# (tag, B, S, h, Nk, Nv, decay): chip_smoke.py's TRAIN_WKV_CASES rows
CASES = [("rwkv6_train", 8, 2048, 40, 64, 64, "rwkv"),
         ("rwkv6_train_micro", 4, 2048, 40, 64, 64, "rwkv"),
         ("hymba_ssm_micro", 4, 2560, 25, 16, 64, "hymba"),
         ("hymba_ssm", 8, 2560, 25, 16, 64, "hymba")]


def build(name: str, subs: str):
    d = OUT / name
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(CSRC, d)
    text = (d / HEADER).read_text()
    for sub in filter(None, subs.split(";;")):
        old, new = sub.split("=>")
        if old not in text:
            raise ValueError(f"{name}: {old!r} is not in {HEADER}")
        text = text.replace(old, new)
    (d / HEADER).write_text(text)
    proc = subprocess.run(
        ["/usr/local/cuda/bin/nvcc", "-gencode", "arch=compute_90a,"
         "code=sm_90a", "-std=c++17", "-O3", "-shared", "-Xcompiler",
         "-fPIC", "-Xptxas", "-v", "-o", str(d / "lib.so"),
         str(d / "wkv_backward.cu")], capture_output=True, text=True)
    spills, fn = [], None
    for line in proc.stderr.splitlines():
        if "Function properties for" in line:
            fn = line.split("for")[-1].strip()
        if "spill" in line and not line.strip().startswith("0 bytes"):
            spills.append(f"{fn}: {line.strip()}")
    if proc.returncode:
        raise RuntimeError(proc.stderr[-3000:])
    return name, spills


def inputs(torch, B, S, h, Nk, Nv, decay, seed=0):
    """RWKV6's (log_w = -exp(N(0, 1) - 1)) or Hymba's SSM identity's
    (log_w = -softplus(.) A, A in [1, 16], r = q exp(log_w), u = 0)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    mk = lambda *s: torch.randn(*s, device="cuda", generator=g)
    k, v, dout = 0.5 * mk(B, S, h, Nk), mk(B, S, h, Nv), mk(B, S, h, Nv)
    if decay == "hymba":
        log_w = -torch.nn.functional.softplus(mk(B, S, h, Nk)) \
            * torch.linspace(1.0, 16.0, Nk, device="cuda")
        r = mk(B, S, h, Nk) * torch.exp(log_w)
        u = torch.zeros(h, Nk, device="cuda")
    else:
        log_w = -torch.exp(mk(B, S, h, Nk) - 1.0)
        r, u = 0.5 * mk(B, S, h, Nk), 0.5 * mk(h, Nk)
    return r, k, v, log_w, u, dout


def run(name: str) -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    lib = ctypes.CDLL(str(OUT / name / "lib.so"))
    _build.load_library = lambda n, s: lib
    from repro_torch.kernels.rwkv_scan import backward as rwb
    from repro_torch.kernels.rwkv_scan import ref as rw_ref
    out = {"variant": name, "device": torch.cuda.get_device_name(0)}
    for tag, B, S, h, Nk, Nv, decay in CASES:
        x = inputs(torch, B, S, h, Nk, Nv, decay)
        call = lambda: rwb.wkv_scan_backward(*x)
        got = call()
        mirror = rw_ref.wkv_backward_chunk_ref(*x)
        err = max(float((a - m).abs().max() / m.abs().max())
                  for a, m in zip(got, mirror))
        bits = hashlib.sha256(b"".join(
            a.contiguous().view(torch.int32).cpu().numpy().tobytes()
            for a in got)).hexdigest()[:12]
        del mirror
        for _ in range(3):
            call()
        times = []
        for _ in range(5):
            a, b = torch.cuda.Event(True), torch.cuda.Event(True)
            a.record()
            for _ in range(5):
                call()
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b) / 5)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                call()
            torch.cuda.synchronize()
        dev = {e.key.split("(")[0]: round(e.device_time_total / 1e3
                                          / e.count, 5)
               for e in prof.key_averages() if e.device_time_total > 0}
        out[tag] = {"ms": statistics.median(times), "max_rel_err": err,
                    "bits": bits, "device_ms": dev}
        del x, got
        torch.cuda.empty_cache()
    print("RESULT " + json.dumps(out), flush=True)


def turns() -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels.rwkv_scan import backward as rwb
    from repro_torch.kernels.rwkv_scan import ref as rw_ref
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, torch.__version__, flush=True)
    print("build s", rwb.build(), flush=True)
    for _, (_, log) in _build.BUILD_LOG.items():
        keep = False
        for line in log.splitlines():
            if "Compiling entry function" in line:
                keep = "wkvbc" in line
            if keep:
                print("  ", line.strip()[:200])
    rel = lambda a, b: float((a.float() - b.float()).abs().max()
                             / b.float().abs().max())
    for shape, decay in [((1, 130, 2, 16, 64), "rwkv"),
                         ((2, 200, 2, 64, 64), "rwkv"),
                         ((1, 300, 2, 16, 64), "hymba")]:
        x = inputs(torch, *shape, decay)
        got = rwb.wkv_scan_backward(*x)
        m = rw_ref.wkv_backward_chunk_ref(*x)
        p = rw_ref.wkv_backward_ref(*x, chunk=16)
        print("check", shape, decay, "against the mirror / the plain "
              "version", [f"{rel(a, b):.2e}/{rel(a, c):.2e}"
                          for a, b, c in zip(got, m, p)], flush=True)

    def ms(fn, reps=3, inner=3):
        fn()
        torch.cuda.synchronize()
        out = []
        for _ in range(reps):
            a, b = torch.cuda.Event(True), torch.cuda.Event(True)
            a.record()
            for _ in range(inner):
                fn()
            b.record()
            torch.cuda.synchronize()
            out.append(a.elapsed_time(b) / inner)
        return min(out)
    for tag, B, S, h, Nk, Nv, decay in CASES:
        x = inputs(torch, B, S, h, Nk, Nv, decay)
        chunk = lambda: rwb.wkv_scan_backward(*x)
        step = lambda: rwb._launch_step(*x)
        t = [ms(chunk), ms(step), ms(step), ms(chunk)]
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                chunk()
            torch.cuda.synchronize()
        dev = [(e.key.split("(")[0], round(e.device_time_total / 1e3
                                            / e.count, 4))
               for e in prof.key_averages() if e.device_time_total > 0]
        print("time", tag, (B, S, h, Nk, Nv), "chunk/step/step/chunk",
              [round(v, 4) for v in t], "device ms", dev, smi, flush=True)
        del x
        torch.cuda.empty_cache()


def phases(lines: str) -> None:
    import torch
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    marks = [int(a) for a in lines.split(",")]
    d = OUT / "phases"
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(CSRC, d)
    out = []
    for i, line in enumerate((CSRC / HEADER).read_text().splitlines(), 1):
        out.append(line)
        if line.startswith("namespace wkvbc {"):
            out.append("__device__ unsigned long long ph[32];")
        if "chunk_grads(const Args a) {" in line:
            out.append("  long long last = clock64();")
        if i in marks:
            out.append(f"  if (threadIdx.x == 0) {{ long long now = "
                       f"clock64(); atomicAdd(&ph[{marks.index(i)}], "
                       f"(unsigned long long)(now - last)); last = now; }}")
    text = "\n".join(out) + "\n" + (
        'extern "C" int read_ph(unsigned long long* h) { return (int)'
        "cudaMemcpyFromSymbol(h, wkvbc::ph, sizeof(wkvbc::ph)); }\n"
        'extern "C" int zero_ph() { unsigned long long z[32] = {}; return '
        "(int)cudaMemcpyToSymbol(wkvbc::ph, z, sizeof(z)); }\n")
    (d / HEADER).write_text(text)
    proc = subprocess.run(
        ["/usr/local/cuda/bin/nvcc", *_build.NVCC_FLAGS, "-o",
         str(d / "lib.so"), str(d / "wkv_backward.cu")],
        capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(proc.stderr[-3000:])
    lib = ctypes.CDLL(str(d / "lib.so"))
    _build.load_library = lambda n, s: lib
    from repro_torch.kernels.rwkv_scan import backward as rwb
    for tag, B, S, h, Nk, Nv, decay in CASES[1:3]:
        x = inputs(torch, B, S, h, Nk, Nv, decay)
        rwb.wkv_scan_backward(*x)
        torch.cuda.synchronize()
        lib.zero_ph()
        rwb.wkv_scan_backward(*x)
        torch.cuda.synchronize()
        got = (ctypes.c_ulonglong * 32)()
        lib.read_ph(got)
        blocks = B * h * -(-S // rwb.CHUNK)
        cyc = [got[i] / blocks for i in range(len(marks))]
        print(tag, "cycles a block of chunk_grads after lines", marks,
              [round(c) for c in cyc], "total", round(sum(cyc)), flush=True)


def main(argv) -> int:
    if argv and argv[0] == "--run":
        run(argv[1])
        return 0
    if argv[:1] == ["turns"]:
        turns()
        return 0
    if argv[:1] == ["phases"]:
        phases(argv[1])
        return 0
    if argv[:1] != ["variants"]:
        print(__doc__)
        return 2
    specs = [("base", "")] + [
        (a.split("=", 1)[0], a.split("=", 1)[1]) for a in argv[1:]
        if a != "base"]
    with concurrent.futures.ThreadPoolExecutor(len(specs)) as pool:
        built = list(pool.map(lambda s: build(*s), specs))
    names = [n for n, _ in built]
    for name in names + names[::-1]:
        proc = subprocess.run([sys.executable, __file__, "--run", name],
                              capture_output=True, text=True)
        lines = [l for l in proc.stdout.splitlines()
                 if l.startswith("RESULT")]
        print(lines[-1] if lines else f"FAILED {name}: "
              f"{proc.stderr[-2000:]}", flush=True)
    for name, spills in built:
        print(f"spills {name}: {spills}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
