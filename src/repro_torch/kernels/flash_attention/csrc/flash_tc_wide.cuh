// Wide tensor-core route of flash attention: bf16 prefill at hd 576 (MLA's
// absorbed attention: kv_lora_rank 512 + rope_head_dim 64, 16 query heads
// on one latent kv head) with more than 16 (query, head) rows per (batch,
// kv head).  Included by flash_attention.cu, which holds the shared Args;
// builds on the wgmma helpers of flash_tc.cuh.
//
// Bound: at DeepSeek-V2-Lite's prefill (q [8, 2048, 16, 576], one kv head,
// 2,048 valid keys of a 2,112-long cache, causal) the function does
// 6.19e11 FLOPs of bf16 products (4 hd a visible pair) against 0.6 GB of
// q, k, v and out, so the tensor-core rate bounds it (0.626 ms at 989
// TFLOP/s).  What hd 576 changes against flash_tc.cuh's hd <= 128:
//
//   * Rows: one block per 64 folded (position, head) rows of one (batch,
//     kv head), n_rows = Sq * G as the TF32 mma kernel folds them (4
//     positions x 16 heads at MLA), so each K / V tile read from L2 serves
//     every query head of the kv head.  Blocks of the latest rows (the most
//     keys under a causal mask) start first, over every (batch, kv head);
//     each block walks its key tiles from the last (the diagonal) back.
//   * Registers: a 64-row fp32 O of 576 columns is 288 registers a thread
//     in one warpgroup, over the 255 a thread may hold.  Two warpgroups
//     (256 threads, one block an SM) split O by columns, 288 each: the
//     first takes columns [0, 256) and [256, 288), the second [288, 320)
//     and [320, 576), each as one wgmma m64n256k16 and one m64n32k16 per 16
//     keys (wgmma's N is at most 256; the n32 pieces start at a 64-column
//     block's first and middle 64 bytes and stay inside its 128-byte rows).
//     144 O accumulators, 32 (or 16) S accumulators and 32 (16) P registers
//     a thread, no setmaxnreg: ptxas gives 255 registers and 32 bytes of
//     spill with 64-key tiles, 241 and none with 32-key tiles.
//   * Products: each warpgroup computes the whole S = Q K^T tile (36 k16
//     steps of m64n{BN}k16, Q and K K-major in shared memory), so both see
//     the same S bits and their softmax statistics agree without an
//     exchange.  O += P V takes P from registers (the S accumulator layout
//     is the A-register layout of P) as two bf16 parts, hi = bf16(p) and
//     lo = bf16(p - hi), and V MN-major, transposed by the descriptor; fp32
//     accumulators.  With P rounded to bf16 once, a row that sees a few
//     keys moves by a bf16 step of one p when S's last bits move it across
//     a rounding boundary (2 and 4 of 151 M outputs at the serving shape
//     left the plain mirror's 1e-2 / 1e-3); hi + lo keeps about 16 bits of
//     p and cost 18 % (2.88 -> 3.39 ms on an H100 SXM at 700 W,
//     tools/flash_wide_variants.py).  So the kernel runs 2x the function's
//     products; the bound counts the function's.  With 64-key tiles the
//     second warpgroup issues its S products once the first's are done
//     (a named barrier), so that each one's softmax runs beside the
//     other's products.
//   * Shared memory (227 KB a block): Q for 64 rows is 73,728 bytes.  When
//     v is k (MLA's call: the same pointer and strides, detected by the
//     entry point) one 64-key tile serves as K (K-major for S) and as V
//     (MN-major for P V): Q and two 73,728-byte stages, 222,272 bytes with
//     the alignment slack and block state.  When v differs, 32-key K and V
//     tiles share a stage of the same size.
//   * Loads: all 256 threads copy the next tile by 16-byte cp.async into
//     the free stage while the current one is multiplied (one barrier a
//     tile: 2.5 % faster than two at the serving shape), in the 128-byte
//     swizzled layout of flash_tc.cuh (64-column blocks of 128-byte rows,
//     chunks XOR-ed by row % 8, tiles 1024-byte aligned); rows past the
//     block's keys are zero-filled by the copy.
//   * Softmax and masks as flash_tc.cuh: online, in registers, base 2; a
//     row's max and sum reduce over the 4 lanes of a quad; masks per element
//     only on tiles some row sees partly; the block's key range is [0, the
//     largest visible end of its rows), widened to [0, Sk) when a row sees
//     none (uniform weights over all Sk keys, as the reference gives).  No
//     atomics: the range reduces by warp reductions, and two calls give the
//     same bits.
//
// Causal or not, int or per-batch kv_valid and runtime q positions; no
// window (a windowed call takes the TF32 mma route).
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <stdint.h>

#include "flash_tc.cuh"

namespace tcw {

constexpr int HD = 576;
constexpr int BM = 64;                   // folded rows of a block
constexpr int NT = 256;                  // two warpgroups
constexpr int NK = HD / 16;              // k16 steps over hd
constexpr int Q_BYTES = BM * HD * 2;
// shared K / V: one 64-key tile; separate: 32-key K and V tiles
template <bool SHARED> struct Tile {
  static constexpr int BN = SHARED ? 64 : 32;
  static constexpr int KV_BYTES = BN * HD * 2;
  static constexpr int STAGE = (SHARED ? 1 : 2) * KV_BYTES;
};
// 1024 bytes of alignment slack, Q, two stages, 6 ints of block state
template <bool SHARED>
constexpr int smem_bytes() {
  return 1024 + Q_BYTES + 2 * Tile<SHARED>::STAGE + 32;
}

// d (+)= a b, m64n32k16: a and b K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[4][4],
                                             uint64_t da, uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d += a b, m64n32k16: a (bf16) from registers, b MN-major in shared
// memory (transposed on read)
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[4][4],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += a b, m64n256k16: a (bf16) from registers, b MN-major in shared
// memory (transposed on read)
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[32][4],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3]),
        "+f"(d[16][0]), "+f"(d[16][1]), "+f"(d[16][2]), "+f"(d[16][3]),
        "+f"(d[17][0]), "+f"(d[17][1]), "+f"(d[17][2]), "+f"(d[17][3]),
        "+f"(d[18][0]), "+f"(d[18][1]), "+f"(d[18][2]), "+f"(d[18][3]),
        "+f"(d[19][0]), "+f"(d[19][1]), "+f"(d[19][2]), "+f"(d[19][3]),
        "+f"(d[20][0]), "+f"(d[20][1]), "+f"(d[20][2]), "+f"(d[20][3]),
        "+f"(d[21][0]), "+f"(d[21][1]), "+f"(d[21][2]), "+f"(d[21][3]),
        "+f"(d[22][0]), "+f"(d[22][1]), "+f"(d[22][2]), "+f"(d[22][3]),
        "+f"(d[23][0]), "+f"(d[23][1]), "+f"(d[23][2]), "+f"(d[23][3]),
        "+f"(d[24][0]), "+f"(d[24][1]), "+f"(d[24][2]), "+f"(d[24][3]),
        "+f"(d[25][0]), "+f"(d[25][1]), "+f"(d[25][2]), "+f"(d[25][3]),
        "+f"(d[26][0]), "+f"(d[26][1]), "+f"(d[26][2]), "+f"(d[26][3]),
        "+f"(d[27][0]), "+f"(d[27][1]), "+f"(d[27][2]), "+f"(d[27][3]),
        "+f"(d[28][0]), "+f"(d[28][1]), "+f"(d[28][2]), "+f"(d[28][3]),
        "+f"(d[29][0]), "+f"(d[29][1]), "+f"(d[29][2]), "+f"(d[29][3]),
        "+f"(d[30][0]), "+f"(d[30][1]), "+f"(d[30][2]), "+f"(d[30][3]),
        "+f"(d[31][0]), "+f"(d[31][1]), "+f"(d[31][2]), "+f"(d[31][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// named barrier kSBar over both warpgroups: the first arrives when its S
// products are done, the second waits for it before issuing its own
constexpr int kSBar = 1;                 // barrier 0 is __syncthreads
template <int ID>
__device__ __forceinline__ void named_sync() {
  asm volatile("bar.sync %0, %1;\n" :: "n"(ID), "n"(NT) : "memory");
}
template <int ID>
__device__ __forceinline__ void named_arrive() {
  asm volatile("bar.arrive %0, %1;\n" :: "n"(ID), "n"(NT) : "memory");
}

template <typename Args, bool SHARED>
__global__ void __launch_bounds__(NT, 1)
flash_tc_wide_fwd(const Args a) {
  constexpr int BN = Tile<SHARED>::BN;
  constexpr int KV_BYTES = Tile<SHARED>::KV_BYTES;
  constexpr int STAGE = Tile<SHARED>::STAGE;
  extern __shared__ __align__(128) uint8_t w_smem[];
  const uint32_t s_raw = tc::smem_u32(w_smem);
  const uint32_t s_q = (s_raw + 1023) & ~1023u;
  const uint32_t s_kv = s_q + Q_BYTES;   // stage st at + st STAGE
  int* s_int = reinterpret_cast<int*>(w_smem + (s_q - s_raw) + Q_BYTES
                                      + 2 * STAGE);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2, wq = warp & 3;
  const int G = a.H / a.KV;
  const int n_rows = a.Sq * G;
  const int n_bk = a.B * a.KV;
  const int n_rb = (n_rows + BM - 1) / BM;
  const int rb = n_rb - 1 - static_cast<int>(blockIdx.x) / n_bk;
  const int bk = static_cast<int>(blockIdx.x) % n_bk;
  const int b = bk / a.KV, kvh = bk % a.KV, r0 = rb * BM;
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(a.q);
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(a.k);
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(a.v);
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.out);

  int valid = a.kv_valid ? a.kv_valid[b] : a.kv_valid_n;
  valid = min(max(valid, 0), a.Sk);
  // the end of the keys folded row R sees (they start at key 0)
  auto row_hi = [&](int R) {
    const int qi = R / G;
    const int pos = a.q_pos ? a.q_pos[qi] : a.q_offset + qi;
    return a.causal ? min(valid, pos + 1) : valid;
  };

  // ---- Q tile (its own copy group): row r is folded row r0 + r
  tc::load_tile<HD, BM, NT>(s_q, a.hd, q,
                            [&](int r) -> const __nv_bfloat16* {
    const int R = r0 + r;
    if (R >= n_rows) return nullptr;
    return q + b * a.q_sb + (R / G) * a.q_ss + (kvh * G + R % G) * a.q_sh;
  });
  tc::cp_async_commit();

  // ---- the block's key range [0, hi): the largest end over its rows, or
  // [0, Sk) when a row sees no key; all_hi: the keys every row sees
  if (warp < 2) {
    const int R = r0 + tid;
    const bool real = R < n_rows;
    const int h = real ? row_hi(R) : 0;
    const bool seen = real && h > 0;
    const int mx = __reduce_max_sync(0xffffffffu, seen ? h : 0);
    const int mn = __reduce_min_sync(0xffffffffu, seen ? h : a.Sk);
    const unsigned none = __ballot_sync(0xffffffffu, real && h <= 0);
    if (lane == 0) {
      s_int[3 * warp] = mx;
      s_int[3 * warp + 1] = mn;
      s_int[3 * warp + 2] = none != 0u;
    }
  }
  __syncthreads();
  const bool empty = s_int[2] || s_int[5];
  const int hi = empty ? a.Sk : max(s_int[0], s_int[3]);
  const int all_hi = min(s_int[1], s_int[4]);

  // this thread's two rows: warp row g = lane / 4 and g + 8
  int rhi[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int R = r0 + wq * 16 + (lane >> 2) + 8 * e;
    rhi[e] = R < n_rows ? row_hi(R) : a.Sk;
  }
  const float scale = a.scale * tc::kLog2e;
  float m[2] = {-1e30f, -1e30f}, l[2] = {0.f, 0.f};
  // O columns of this warpgroup: o_wide at c_wide (256 columns), o_narrow
  // at c_narrow (32 columns)
  const int c_wide = wg ? 320 : 0, c_narrow = 256 + 32 * wg;
  float o_wide[32][4], o_narrow[4][4];
#pragma unroll
  for (int d = 0; d < 32; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) o_wide[d][e] = 0.f;
#pragma unroll
  for (int d = 0; d < 4; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) o_narrow[d][e] = 0.f;

  const int n_t = (hi + BN - 1) / BN;
  auto issue = [&](int t, int st) {
    const int j0 = t * BN;
    const uint32_t dk = s_kv + st * STAGE;
    tc::load_tile<HD, BN, NT>(dk, a.hd, k,
                              [&](int r) -> const __nv_bfloat16* {
      const int j = j0 + r;
      return j < hi ? k + b * a.k_sb + j * a.k_ss + kvh * a.k_sh : nullptr;
    });
    if constexpr (!SHARED)
      tc::load_tile<HD, BN, NT>(dk + KV_BYTES, a.hd, v,
                                [&](int r) -> const __nv_bfloat16* {
        const int j = j0 + r;
        return j < hi ? v + b * a.v_sb + j * a.v_ss + kvh * a.v_sh : nullptr;
      });
    tc::cp_async_commit();
  };
  if (n_t > 0) issue(n_t - 1, 0);

  for (int it = 0; it < n_t; ++it) {
    const int t = n_t - 1 - it, st = it & 1;
    // one barrier a tile: past it, this tile's copies are visible and
    // every thread is done with the other stage, which takes the next
    // tile's copies
    tc::cp_async_wait<0>();
    tc::fence_async_shared();
    __syncthreads();
    if (it + 1 < n_t) issue(t - 1, st ^ 1);
    const uint32_t sk = s_kv + st * STAGE;
    const uint32_t sv = SHARED ? sk : sk + KV_BYTES;
    const int j0 = t * BN;

    // ---- S = Q K^T: the block's 64 rows x BN keys, in each warpgroup;
    // step kk is 32 bytes into 64-column block kk / 4
    float s[BN / 8][4];
#pragma unroll
    for (int n = 0; n < BN / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
    // with 64-key tiles the second warpgroup issues its products after
    // the first's are done, so that each one's softmax overlaps the other's
    // products (7 % at the serving shape; 2 % slower with 32-key tiles)
    if (SHARED && wg == 1) named_sync<kSBar>();
    tc::fence_regs(s);
    tc::wg_fence();
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      const uint64_t da = tc::gmma_desc(
          s_q + (kk >> 2) * BM * 128 + (kk & 3) * 32, 16, 1024);
      const uint64_t db = tc::gmma_desc(
          sk + (kk >> 2) * BN * 128 + (kk & 3) * 32, 16, 1024);
      if constexpr (BN == 64) tc::wgmma_ss_n64(s, da, db, kk > 0);
      else wgmma_ss_n32(s, da, db, kk > 0);
    }
    tc::wg_commit();
    tc::wg_wait0();
    tc::fence_regs(s);
    if (SHARED && wg == 0) named_arrive<kSBar>();

    // ---- scale and mask (only where some row sees part of the tile)
    const bool full = !empty && j0 + BN <= all_hi;
#pragma unroll
    for (int n = 0; n < BN / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * scale;
        if (!full) {
          const int key = j0 + n * 8 + 2 * (lane & 3) + (e & 1);
          if (key >= hi) x = -CUDART_INF_F;                 // skipped
          else if (key >= rhi[e >> 1]) x = -1e30f;          // NEG_INF
        }
        s[n][e] = x;
      }

    // ---- online softmax, base 2; a row lives on the 4 lanes of a quad
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = m[r];
#pragma unroll
      for (int n = 0; n < BN / 8; ++n)
        mx = fmaxf(mx, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float corr = exp2f(m[r] - mx);
      m[r] = mx;
      l[r] *= corr;
#pragma unroll
      for (int d = 0; d < 32; ++d) {
        o_wide[d][2 * r] *= corr;
        o_wide[d][2 * r + 1] *= corr;
      }
#pragma unroll
      for (int d = 0; d < 4; ++d) {
        o_narrow[d][2 * r] *= corr;
        o_narrow[d][2 * r + 1] *= corr;
      }
#pragma unroll
      for (int n = 0; n < BN / 8; ++n)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float p = exp2f(s[n][2 * r + c] - mx);
          l[r] += p;
          s[n][2 * r + c] = p;
        }
    }

    // ---- O += P V: P from the S registers as two bf16 A operands, hi =
    // bf16(p) and lo = bf16(p - hi), so that the product keeps about 16
    // bits of p
    uint32_t ph[BN / 16][4], pl[BN / 16][4];
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float x0 = s[2 * kk + (u >> 1)][2 * (u & 1)];
        const float x1 = s[2 * kk + (u >> 1)][2 * (u & 1) + 1];
        __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
        ph[kk][u] = *reinterpret_cast<uint32_t*>(&h);
        pl[kk][u] = tc::pack_bf16(x0 - __low2float(h), x1 - __high2float(h));
      }
    // V as the MN-major B operand: 16 keys (two 8-row groups 1024 bytes
    // apart) a step, hd in 64-column blocks BN * 128 bytes apart; the
    // narrow piece starts 64 bytes into block 4 for the second warpgroup
    tc::fence_regs(o_wide);
    tc::fence_regs(o_narrow);
    tc::wg_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      const uint32_t vk = sv + kk * 16 * 128;
      const uint64_t dw = tc::gmma_desc(vk + (c_wide / 64) * BN * 128,
                                        BN * 128, 1024);
      const uint64_t dn = tc::gmma_desc(vk + 4 * BN * 128 + 64 * wg,
                                        BN * 128, 1024);
      wgmma_rs_n256(o_wide, ph[kk], dw);
      wgmma_rs_n32(o_narrow, ph[kk], dn);
      wgmma_rs_n256(o_wide, pl[kk], dw);
      wgmma_rs_n32(o_narrow, pl[kk], dn);
    }
    tc::wg_commit();
    tc::wg_wait0();
    tc::fence_regs(o_wide);
    tc::fence_regs(o_narrow);
  }

  // ---- out = O / max(l, 1e-30) in bf16, layout [B, Sq, H, hd]: this
  // warpgroup's 288 columns of its rows
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lr = l[r];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    const int R = r0 + wq * 16 + (lane >> 2) + 8 * r;
    if (R >= n_rows) continue;
    const float inv = 1.f / fmaxf(lr, 1e-30f);
    const int qi = R / G, h = kvh * G + R % G;
    __nv_bfloat16* orow = out + ((int64_t(b) * a.Sq + qi) * a.H + h) * HD
                          + 2 * (lane & 3);
#pragma unroll
    for (int d = 0; d < 32; ++d)
      *reinterpret_cast<__nv_bfloat162*>(orow + c_wide + d * 8) =
          __floats2bfloat162_rn(o_wide[d][2 * r] * inv,
                                o_wide[d][2 * r + 1] * inv);
#pragma unroll
    for (int d = 0; d < 4; ++d)
      *reinterpret_cast<__nv_bfloat162*>(orow + c_narrow + d * 8) =
          __floats2bfloat162_rn(o_narrow[d][2 * r] * inv,
                                o_narrow[d][2 * r + 1] * inv);
  }
}

template <typename Args, bool SHARED>
int launch(const Args& a, cudaStream_t stream) {
  constexpr int smem = smem_bytes<SHARED>();
  static_assert(smem <= 232448, "wide flash block over the shared memory");
  static bool configured = false;        // one attribute call per variant
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_tc_wide_fwd<Args, SHARED>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const int n_rows = a.Sq * (a.H / a.KV);
  const int blocks = (n_rows + BM - 1) / BM * a.B * a.KV;
  flash_tc_wide_fwd<Args, SHARED><<<blocks, NT, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// v is k (the same pointer and strides): one tile serves as K and V
template <typename Args>
int dispatch(const Args& a, cudaStream_t stream) {
  const bool shared = a.v == a.k && a.v_sb == a.k_sb && a.v_ss == a.k_ss
                      && a.v_sh == a.k_sh;
  return shared ? launch<Args, true>(a, stream)
                : launch<Args, false>(a, stream);
}

}  // namespace tcw
