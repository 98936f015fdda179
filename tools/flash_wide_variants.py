"""Time variants of the wide tensor-core flash kernel
(``src/repro_torch/kernels/flash_attention/csrc/flash_tc_wide.cuh``, bf16
prefill at hd 576) in turns on the card, one process each (two libraries
holding the same kernel names in one process fail to launch).

Each variant rewrites the header by the text substitutions in ``VARIANTS``
and builds ``flash_attention.cu`` with nvcc into
``src/repro_torch/kernels/_build/variants_wide/``; ``base`` is the source as it
is.  Every variant runs DeepSeek-V2-Lite's prefill (q [8, 2048, 16, 576]
over 2,048 valid keys of a 2,112-long cache) with v = k and with v drawn
apart: the error against ``attention_ref``, against the plain mirror
``attention_wide_ref`` (with the variant's rounding of P) and the count of
outputs outside the mirror's (1e-2, 1e-3), a hash of the output's bits,
then kernel and SDPA ms by CUDA events in turns (kernel, SDPA, SDPA,
kernel) and the kernel's device ms (profiler), in the order given and
then reversed:

    python tools/flash_wide_variants.py p_once lockstep two_barriers

prints one ``RESULT`` line of JSON a run and the variants' ptxas lines.
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
CSRC = ROOT / "src/repro_torch/kernels/flash_attention/csrc"
OUT = ROOT / "src/repro_torch/kernels/_build/variants_wide"

_PV_LO = """      wgmma_rs_n256(o_wide, pl[kk], dw);
      wgmma_rs_n32(o_narrow, pl[kk], dn);
"""
_ISSUE = "    if (it + 1 < n_t) issue(t - 1, st ^ 1);\n"
_PUBLISH = """    tc::cp_async_wait<0>();
    tc::fence_async_shared();
    __syncthreads();
"""
_S_END = """      else wgmma_ss_n32(s, da, db, kk > 0);
    }
    tc::wg_commit();
"""
_PV_END = """    tc::fence_regs(o_narrow);
  }
"""
_RESCALE = """#pragma unroll
      for (int d = 0; d < 32; ++d) {
        o_wide[d][2 * r] *= corr;
        o_wide[d][2 * r + 1] *= corr;
      }
#pragma unroll
      for (int d = 0; d < 4; ++d) {
        o_narrow[d][2 * r] *= corr;
        o_narrow[d][2 * r + 1] *= corr;
      }
"""
_STAGGER = ("    if (SHARED && wg == 1) named_sync<kSBar>();\n",
            "    if (SHARED && wg == 0) named_arrive<kSBar>();\n")
# name -> (substitutions of the header, P rounded to bf16 twice (hi + lo))
VARIANTS = {
    "base": ((), True),
    # P rounded to bf16 once: one P V product a tile
    "p_once": (((_PV_LO, ""),), False),
    # the next tile's copies issued behind the S products
    "late_issue": (((_ISSUE, ""), (_S_END, _S_END + _ISSUE)), True),
    # both warpgroups issue their S products at once (no named barrier)
    "lockstep": (tuple((line, "") for line in _STAGGER), True),
    # two barriers a tile: the next tile's copies issued before this
    # tile's wait, the stage freed by a barrier at the tile's end
    "two_barriers": (((_PUBLISH + _ISSUE,
                       "    if (it + 1 < n_t) {\n"
                       "      issue(t - 1, st ^ 1);\n"
                       "      tc::cp_async_wait<1>();\n"
                       "    } else {\n"
                       "      tc::cp_async_wait<0>();\n"
                       "    }\n"
                       "    tc::fence_async_shared();\n"
                       "    __syncthreads();\n"),
                      (_PV_END, "    tc::fence_regs(o_narrow);\n"
                       "    __syncthreads();\n  }\n")), True),
    # O rescaled only where a row of the warp moved its max
    "rescale_skip": (((_RESCALE, "      if (__any_sync(0xffffffffu, corr "
                       "!= 1.f)) {\n" + _RESCALE + "      }\n"),), True),
}


def build(name: str):
    subs, _ = VARIANTS[name]
    d = OUT / name
    if d.exists():
        shutil.rmtree(d)
    shutil.copytree(CSRC, d)
    text = (d / "flash_tc_wide.cuh").read_text()
    for old, new in subs:
        assert text.count(old) == 1, (name, old)
        text = text.replace(old, new)
    (d / "flash_tc_wide.cuh").write_text(text)
    proc = subprocess.run(
        ["/usr/local/cuda/bin/nvcc", "-gencode", "arch=compute_90a,"
         "code=sm_90a", "-std=c++17", "-O3", "-shared", "-Xcompiler",
         "-fPIC", "-Xptxas", "-v", "-o", str(d / "lib.so"),
         str(d / "flash_attention.cu")], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(proc.stderr[-3000:])
    lines, keep = [], False
    for line in proc.stderr.splitlines():
        if "Compiling entry function" in line:
            keep = "flash_tc_wide_fwd" in line
        if keep and ("registers" in line or "spill" in line):
            lines.append(line.strip())
    return name, lines


def run(name: str) -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention import ref as fa_ref
    lib_path = str(OUT / name / "lib.so")
    _build.load_library = lambda n, s: ctypes.CDLL(lib_path)
    fa.build()
    split_p = VARIANTS[name][1]
    F = torch.nn.functional
    dev = torch.device("cuda")
    res = {"variant": name, "device": torch.cuda.get_device_name(0)}
    for tag, shared in (("mla_prefill_shared", True), ("mla_prefill", False)):
        g = torch.Generator(device=dev).manual_seed(0)
        mk = lambda *s: torch.randn(*s, generator=g, device=dev).to(  # noqa
            torch.bfloat16)
        q, k = mk(8, 2048, 16, 576), mk(8, 2112, 1, 576)
        v = k if shared else mk(8, 2112, 1, 576)
        pos = torch.arange(2048, device=dev)
        kw = dict(causal=True, kv_valid=2048, q_positions=pos)
        fa.reset_launch_counts()
        out = fa.flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        assert fa.ROUTE_CALLS["tensor_core_wide"] == 1, fa.ROUTE_CALLS
        want = fa_ref.attention_ref(q, k, v, pos, 2048)
        mirror = fa_ref.attention_wide_ref(
            q, k, v, pos, 2048, key_tile=fa.wide_key_tile(k, v),
            split_p=split_p)
        o, m = out.float(), mirror.float()
        row = {"max_abs_err": float((o - want.float()).abs().max()),
               "mirror_max_abs_err": float((o - m).abs().max()),
               "mirror_n_outside": int(((o - m).abs()
                                        > 1e-3 + 1e-2 * m.abs()).sum()),
               "bits": hashlib.sha256(out.cpu().view(torch.int16).numpy()
                                      .tobytes()).hexdigest()[:16]}
        del want, mirror, o, m
        kern = lambda: fa.flash_attention(q, k, v, **kw)  # noqa: E731
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k[:, :2048],
                                                   v[:, :2048]))
        sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, enable_gqa=True, is_causal=True)

        def ms(fn, reps=5, inner=5):
            fn()
            torch.cuda.synchronize()
            times = []
            for _ in range(reps):
                t0, t1 = (torch.cuda.Event(enable_timing=True)
                          for _ in "ab")
                t0.record()
                for _ in range(inner):
                    fn()
                t1.record()
                torch.cuda.synchronize()
                times.append(t0.elapsed_time(t1) / inner)
            return statistics.median(times)

        turns = [ms(fn) for fn in (kern, sdpa, sdpa, kern)]
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            kern()
            torch.cuda.synchronize()
        row.update(ms_turns=[turns[0], turns[3]],
                   sdpa_ms_turns=[turns[1], turns[2]],
                   device_ms=sum(ev.device_time_total for ev in
                                 prof.key_averages()
                                 if "flash_tc_wide" in ev.key) / 1e3)
        res[tag] = row
        del q, k, v, out
        torch.cuda.empty_cache()
    print("RESULT", json.dumps(res), flush=True)


def main(argv) -> int:
    if argv[:1] == ["--run"]:
        run(argv[1])
        return 0
    names = ["base"] + [a for a in argv if a != "base"]
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        for name, lines in pool.map(build, names):
            print("built", name, "ptxas:", lines, flush=True)
    for name in names + names[::-1]:
        subprocess.run([sys.executable, __file__, "--run", name], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
