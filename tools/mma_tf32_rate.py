"""The card's rate for ``mma.sync.m16n8k8`` with TF32 operands and fp32
accumulators: the instruction the flash attention backward kernel
(``src/repro_torch/kernels/flash_attention/csrc/flash_backward.cu``) runs
all its products on, so the ceiling its times are read against.

Each warp keeps CHAINS independent accumulators and issues STEPS rounds of
one mma into each; the grid puts WARPS warps on every SM.  Prints TFLOP/s
(2 * 16 * 8 * 8 FLOPs an mma) by CUDA events for a few (warps, chains).
Needs the card and nvcc (built into ``src/repro_torch/kernels/_build/``):

    python tools/mma_tf32_rate.py
"""
from __future__ import annotations

import ctypes
import pathlib
import subprocess
import sys

SRC = r"""
#include <cuda_runtime.h>
#include <stdint.h>
template <int CHAINS>
__global__ void rate(float* out, int steps, uint32_t seed) {
  float d[CHAINS][4] = {};
  const uint32_t a = seed ^ threadIdx.x, b = seed * 3u + threadIdx.x;
  for (int s = 0; s < steps; ++s) {
#pragma unroll
    for (int c = 0; c < CHAINS; ++c)
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
          : "+f"(d[c][0]), "+f"(d[c][1]), "+f"(d[c][2]), "+f"(d[c][3])
          : "r"(a), "r"(b), "r"(a + c), "r"(b + c), "r"(a ^ c), "r"(b));
  }
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < CHAINS; ++c) s += d[c][0] + d[c][1] + d[c][2] + d[c][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int launch(int chains, int blocks, int threads, float* out,
                      int steps) {
  if (chains == 1) rate<1><<<blocks, threads>>>(out, steps, 7u);
  if (chains == 4) rate<4><<<blocks, threads>>>(out, steps, 7u);
  if (chains == 8) rate<8><<<blocks, threads>>>(out, steps, 7u);
  if (chains == 16) rate<16><<<blocks, threads>>>(out, steps, 7u);
  return (int)cudaGetLastError();
}
"""


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card")
        return 1
    root = pathlib.Path(__file__).resolve().parents[1]
    out_dir = root / "src" / "repro_torch" / "kernels" / "_build"
    out_dir.mkdir(parents=True, exist_ok=True)
    src, lib_path = out_dir / "mma_tf32_rate.cu", out_dir / "libmma_rate.so"
    src.write_text(SRC)
    subprocess.run(["/usr/local/cuda/bin/nvcc", "-gencode",
                    "arch=compute_90a,code=sm_90a", "-O3", "-shared",
                    "-Xcompiler", "-fPIC", "-o", str(lib_path), str(src)],
                   check=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.launch.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p,
                                                 ctypes.c_int]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    name = torch.cuda.get_device_name(0)
    steps = 4096
    for warps in (4, 8, 16):
        for chains in (1, 4, 8, 16):
            out = torch.empty(sms * warps * 32, device="cuda")
            args = (chains, sms, warps * 32, out.data_ptr(), steps)
            if lib.launch(*args) != 0:       # too many registers a block
                print(f"{warps} warps an SM, {chains} chains: not launched")
                continue
            torch.cuda.synchronize()
            t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in "ab")
            t0.record()
            for _ in range(5):
                lib.launch(*args)
            t1.record()
            torch.cuda.synchronize()
            ms = t0.elapsed_time(t1) / 5
            flops = 2.0 * 16 * 8 * 8 * chains * steps * warps * sms
            print(f"mma.sync m16n8k8 tf32: {warps} warps an SM, {chains} "
                  f"chains a warp: {flops / ms / 1e9:.1f} TFLOP/s "
                  f"({ms:.4f} ms) [{name}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
