"""Time tile configurations of the TF32 tensor-core flash forward
(``src/repro_torch/kernels/flash_attention/csrc/flash_mma.cuh``, route
``mma_tf32``) in turns on the card, one process each (two libraries holding
the same kernel names in one process fail to launch).

Each variant rewrites one ``Cfg<HD>`` of the header (RW groups of 16 rows,
DW warps splitting hd, BC keys a tile) in a copy of the ``csrc/``
directory and builds ``flash_attention.cu`` with nvcc into
``src/repro_torch/kernels/_build/fwd_variants/``; ``base`` is the source as
it is.  Every variant runs the fp32 cases below (MLA's prefill with v apart
and v = k, Qwen2's serving prefill and its training microbatch): error
against the plain version, CUDA-event ms, in the order given and then
reversed:

    python tools/flash_fwd_variants.py 576:2,4,8 128:4,1,16

prints one ``RESULT`` line of JSON a run and the variants' ptxas registers
and spills.
"""
from __future__ import annotations

import concurrent.futures
import ctypes
import json
import pathlib
import re
import shutil
import statistics
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
CSRC = ROOT / "src/repro_torch/kernels/flash_attention/csrc"
OUT = ROOT / "src/repro_torch/kernels/_build/fwd_variants"
FIELDS = ("RW", "DW", "BC")
# (tag, B, Sq, Sk, H, KV, hd, kv_valid, v_is_k): chip_smoke.py's fp32
# prefill shapes
CASES = [("mla_prefill", 8, 2048, 2112, 16, 1, 576, 2048, False),
         ("mla_prefill_shared", 8, 2048, 2112, 16, 1, 576, 2048, True),
         ("prefill", 8, 2048, 2048, 12, 2, 128, None, False),
         ("train_microbatch", 4, 2048, 2048, 12, 2, 128, None, False)]


def build(name: str, spec: str):
    d = OUT / name
    if d.exists():
        shutil.rmtree(d)
    shutil.copytree(CSRC, d)
    text = (d / "flash_mma.cuh").read_text()
    if spec:
        hd, values = spec.split(":")
        line = ", ".join(f"{f} = {v}" for f, v in zip(FIELDS,
                                                        values.split(",")))
        text, n = re.subn(r"(template <> struct Cfg<%s> \{\n  static "
                          r"constexpr int )[^;]*;" % hd, r"\g<1>" + line + ";",
                          text)
        assert n == 1, spec
    (d / "flash_mma.cuh").write_text(text)
    proc = subprocess.run(
        ["/usr/local/cuda/bin/nvcc", "-gencode", "arch=compute_90a,"
         "code=sm_90a", "-std=c++17", "-O3", "-shared", "-Xcompiler",
         "-fPIC", "-Xptxas", "-v", "-o", str(d / "lib.so"),
         str(d / "flash_attention.cu")], capture_output=True, text=True)
    notes, fn = [], None
    for line in proc.stderr.splitlines():
        if "Function properties for" in line:
            fn = line.split("for")[-1].strip()
        if "Compiling entry function" in line:
            fn = line.split("'")[1] if "'" in line else line
        if fn and "flash_mma" in fn and ("registers" in line
                                         or ("spill" in line and not line
                                             .strip().startswith("0 bytes"))):
            notes.append(f"{fn}: {line.strip()}")
    if proc.returncode:
        raise RuntimeError(proc.stderr[-3000:])
    return name, notes


def run(name: str) -> None:
    import torch
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention import ref as fa_ref
    lib = ctypes.CDLL(str(OUT / name / "lib.so"))
    for fn in (lib.fa_forward_mma, lib.fa_forward_tc, lib.fa_forward_tc_wide):
        fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    fa._library = lambda: lib
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    res = {"variant": name, "device": torch.cuda.get_device_name(0)}
    for tag, B, Sq, Sk, H, KV, hd, valid, shared in CASES:
        g = torch.Generator(device=dev).manual_seed(0)
        q = torch.randn(B, Sq, H, hd, generator=g, device=dev)
        k = torch.randn(B, Sk, KV, hd, generator=g, device=dev)
        v = k if shared else torch.randn(B, Sk, KV, hd, generator=g,
                                         device=dev)
        kern = lambda: fa.flash_attention(  # noqa: E731
            q, k, v, causal=True, kv_valid=valid)
        fa.reset_launch_counts()
        out = kern()
        torch.cuda.synchronize()
        assert fa.ROUTE_CALLS["mma_tf32"] == 1, fa.ROUTE_CALLS
        want = fa_ref.attention_ref(q, k, v, torch.arange(Sq, device=dev),
                                    valid, causal=True)
        err = float((out - want).abs().max())
        same = bool(torch.equal(out, kern()))
        del want
        reps = 2 if hd > 128 else 10
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in "ab")
        times = []
        for _ in range(3):
            t0.record()
            for _ in range(reps):
                kern()
            t1.record()
            torch.cuda.synchronize()
            times.append(t0.elapsed_time(t1) / reps)
        res[tag] = {"max_abs_err": err, "same_bits": same,
                    "ms": statistics.median(times)}
        del q, k, v, out
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
        for name, notes in pool.map(lambda kv: build(*kv), specs.items()):
            print("built", name, specs[name] or "(the source)", flush=True)
            for line in notes:
                print("  ", line, flush=True)
    names = list(specs)
    for name in names + names[::-1]:
        subprocess.run([sys.executable, __file__, "--run", name], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
