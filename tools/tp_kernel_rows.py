"""Time the flash and WKV kernels at the local-head shapes of
``chip_smoke.py``'s phase 10 in turns with one library call, as phase 5
times its main rows (the same code: ``flash_phase`` and ``wkv_phase`` on
phase 5's own cases of the tags below, each held against its plain
version and route-gated there as in phase 5).

Flash, each row in bf16 and fp32, against the plain version and (where
timed) one ``scaled_dot_product_attention`` call in turns (kernel, SDPA,
SDPA, kernel), with the profiler's device ms of each:

* (h2)'s Whisper-large-v3 at model 4: the encoder's bidirectional
  self-attention ``[4, 1500, 5, 64]`` and the cross prefill of the 1,024
  prompt tokens over the 1,500 encoder keys;
* (f)'s DeepSeek-V2-Lite rows that phase 5 leaves untimed: the G = 4
  hd-576 decode step over 1,055 keys (bf16), the (f1) fp32 check ``[2,
  256, 4, 576]`` and the G = 8 bf16 prefill (model 2);
* (i)'s Hymba-1.5B at model 4 (7 query heads at G = 1, window 2,048):
  (i2)'s prefill ``[4, 1024, 7, 64]`` and its last decode step over the
  1,056-slot ring, (i1)'s prefill ``[2, 2560, 7, 64]`` past the window
  and a decode step over the full 2,048-slot ring.

WKV, (g2)'s RWKV6-3B at model 4, ``[4, 1024, 10, 64]`` (the bf16 prefill
on ``tensor_core``) and one decode step ``[4, 1, 10, 64]`` (``step``),
each in bf16 and fp32, with the plain chunked recurrence (no library call
computes it); and (i)'s Hymba SSM scan on a rank's 25 sub-heads of 16
(``ssm_scan_phase``: the inclusive prefills ``[4, 1024]`` and ``[2,
2560]`` on ``chunk_f32`` and a decode step on ``step``, fp32, against the
plain inclusive recurrence).  Flash at (j)'s Qwen2-1.5B at model 8 (2
query heads on one kv head of 128, split inside): the prefill ``[4, 1024,
2, 128]`` into 1,056 keys (fp32 too, on ``mma_tf32``), its last decode
step and the fp32 check ``[2, 256, 2, 128]``.  Needs the card:

    python tools/tp_kernel_rows.py [--seed 0] [--tags CASE ...]

``--tags`` runs only the named cases.

prints each row as phase 5 does and one ``RESULT`` line of JSON.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402

# phase 5's cases timed here: (h2)'s Whisper rows, then the MLA rows that
# phase 5 holds but leaves untimed; (g2)'s WKV rows
WHISPER = ("tp_whisper_encoder", "tp_whisper_cross_prefill")
MLA = ("tp_mla_decode", "tp_mla_check", "tp_mla_prefill_g8")
WKV = ("tp_prefill", "tp_decode")
HYMBA = ("tp_hymba_prefill", "tp_hymba_decode", "tp_hymba_check",
         "tp_hymba_check_decode")
SSM = ("tp_hymba_inclusive_prefill", "tp_hymba_inclusive_decode",
       "tp_hymba_inclusive_check")
INSIDE = ("tp_inside_prefill", "tp_inside_decode", "tp_inside_check")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tags", nargs="*", default=None,
                    help="run only these of the cases (default: all)")
    args = ap.parse_args(argv)
    keep = lambda tags: tuple(t for t in tags
                              if args.tags is None or t in args.tags)
    flash = keep(MLA + WHISPER + HYMBA + INSIDE)

    import torch
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.rwkv_scan import ops as rw
    from repro_torch.kernels.rwkv_scan import ref as rw_ref
    from repro_torch.models import linrec, ssm
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "--id=0"],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout.strip()
    print(smi, flush=True)
    peaks = cs.card_peaks(smi.split(",")[0].strip())
    fa.build()
    rw.build()
    flash_rows, _ = cs.flash_phase(
        torch, fa, fa_ref, peaks, args.seed,
        cases=[c for c in cs.FLASH_CASES if c[0] in flash], timed=flash,
        mma_timed=keep(("tp_mla_check", "tp_hymba_check",
                        "tp_inside_prefill", "tp_inside_check")))
    wkv_rows, _ = cs.wkv_phase(
        torch, rw, rw_ref, peaks, args.seed,
        cases=[c for c in cs.WKV_CASES if c[0] in keep(WKV)],
        timed=keep(WKV))
    ssm_rows, _ = cs.ssm_scan_phase(
        torch, rw, rw_ref, ssm, linrec, peaks, args.seed,
        cases=[c for c in cs.SSM_CASES if c[0] in keep(SSM)])
    print("RESULT " + json.dumps({"card": smi, "flash": flash_rows,
                                  "wkv": wkv_rows, "ssm": ssm_rows}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
