"""Time tile configurations of the flash attention backward kernel
(``src/repro_torch/kernels/flash_attention/csrc/flash_backward.cu``) in
turns on the card, one process each (two libraries holding the same kernel
names in one process fail to launch).

Each variant rewrites one ``Cfg<HD>`` of the source (the dq kernel's RW,
QDW, BC and the dkdv kernel's KW, KDW, BR) and builds it with nvcc into
``src/repro_torch/kernels/_build/variants/``; ``base`` is the source as it
is.  Every variant runs the cases below in fp32 (error against autograd
through the plain version, CUDA-event ms, each kernel's device ms), in the
order given and then reversed:

    python tools/flash_bwd_variants.py 576:2,4,8,2,4,8 128:4,1,16,4,2,16

prints one ``RESULT`` line of JSON a run and the variants' ptxas spills.
"""
from __future__ import annotations

import concurrent.futures
import ctypes
import json
import pathlib
import re
import statistics
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
SRC = ROOT / "src/repro_torch/kernels/flash_attention/csrc/flash_backward.cu"
OUT = ROOT / "src/repro_torch/kernels/_build/variants"
FIELDS = ("RW", "QDW", "BC", "KW", "KDW", "BR")
# (tag, B, Sq, Sk, H, KV, hd, causal): chip_smoke.py's training shapes
CASES = [("qwen2_train", 4, 2048, 2048, 12, 2, 128, True),
         ("whisper_encoder", 8, 1500, 1500, 20, 20, 64, False),
         ("mla", 8, 2048, 2048, 16, 1, 576, True)]


def build(name: str, spec: str):
    text = SRC.read_text()
    if spec:
        hd, values = spec.split(":")
        line = ", ".join(f"{f} = {v}" for f, v in zip(FIELDS,
                                                        values.split(",")))
        text, n = re.subn(r"(template <> struct Cfg<%s> \{\n  static "
                          r"constexpr int )[^;]*;" % hd, r"\g<1>" + line + ";",
                          text)
        assert n == 1, spec
    d = OUT / name
    d.mkdir(parents=True, exist_ok=True)
    (d / "flash_backward.cu").write_text(text)
    proc = subprocess.run(
        ["/usr/local/cuda/bin/nvcc", "-gencode", "arch=compute_90a,"
         "code=sm_90a", "-std=c++17", "-O3", "-shared", "-Xcompiler",
         "-fPIC", "-Xptxas", "-v", "-I", str(SRC.parent), "-o",
         str(d / "lib.so"), str(d / "flash_backward.cu")],
        capture_output=True, text=True)
    spills, fn = [], None
    for line in proc.stderr.splitlines():
        if "Function properties for" in line:
            fn = line.split("for")[-1].strip()
        if "spill" in line and not line.strip().startswith("0 bytes"):
            spills.append(f"{fn}: {line.strip()}")
    if proc.returncode:
        raise RuntimeError(proc.stderr[-3000:])
    return name, spills


def run(name: str) -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels.flash_attention import backward as fab
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention import ref as fa_ref
    lib = ctypes.CDLL(str(OUT / name / "lib.so"))
    lib.fa_backward.argtypes = [ctypes.c_int, ctypes.c_void_p,
                                ctypes.c_void_p]
    lib.fa_backward.restype = ctypes.c_int
    fab._library = lambda: lib
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    res = {"variant": name, "device": torch.cuda.get_device_name(0)}
    for tag, B, Sq, Sk, H, KV, hd, causal in CASES:
        g = torch.Generator(device=dev).manual_seed(0)
        mk = lambda *s: torch.randn(*s, generator=g, device=dev)  # noqa
        q, k, v, dout = (mk(B, Sq, H, hd), mk(B, Sk, KV, hd),
                         mk(B, Sk, KV, hd), mk(B, Sq, H, hd))
        pos = torch.arange(Sq, device=dev)
        with torch.no_grad():
            out = fa.flash_attention(q, k, v, q_positions=pos, causal=causal)
        kern = lambda: fab.flash_attention_backward(  # noqa: E731
            q, k, v, out, dout, q_positions=pos, causal=causal)
        got = kern()
        want = fa_ref.attention_backward_ref(q, k, v, dout, pos,
                                             causal=causal)
        errs = [float((a - b).abs().max() / b.abs().max())
                for a, b in zip(got, want)]
        del want, got
        reps = 1 if hd > 128 else 5
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in "ab")
        times = []
        for _ in range(3):
            t0.record()
            for _ in range(reps):
                kern()
            t1.record()
            torch.cuda.synchronize()
            times.append(t0.elapsed_time(t1) / reps)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            kern()
            torch.cuda.synchronize()
        kernels = {ev.key.split("(")[0].split("::")[-1]:
                   ev.device_time_total / 1e3
                   for ev in prof.key_averages() if "_mma<" in ev.key}
        res[tag] = {"max_rel_err": max(errs), "ms": statistics.median(times),
                    "device_ms": kernels}
        del q, k, v, dout, out
        torch.cuda.empty_cache()
    print("RESULT", json.dumps(res), flush=True)


def main(argv) -> int:
    if argv[:1] == ["--run"]:
        run(argv[1])
        return 0
    specs = {"base": ""}
    specs.update({f"cfg{hd_spec.replace(':', '_').replace(',', '-')}":
                  hd_spec for hd_spec in argv})
    with concurrent.futures.ThreadPoolExecutor(len(specs)) as pool:
        for name, spills in pool.map(lambda kv: build(*kv), specs.items()):
            print("built", name, specs[name] or "(the source)",
                  "spills:", spills or "none", flush=True)
    names = list(specs)
    for name in names + names[::-1]:
        subprocess.run([sys.executable, __file__, "--run", name], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
