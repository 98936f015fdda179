// Tensor-core route of flash attention: bf16 prefill with more than 16
// (query, head) rows per (batch, kv head).  Included by flash_attention.cu,
// which holds the shared Args and the split-kv route.
//
// Bound: at the serving prefill (8 x 2048, H 12, KV 2, hd 128, causal) the
// work is 103 GFLOP of bf16 products against 16 MB of q, k, v and out, so
// the card's tensor-core rate bounds it (0.104 ms at 989 TFLOP/s).  The
// design keeps the tensor cores fed and moves nothing in fp32 that need not:
//
//   * Work split: one block per (batch, head, tile of BM = 64 or 128 query
//     positions), one or two warpgroups of 4 warps, 64 query rows each.
//     The blocks of the latest query tiles (the most keys under a causal
//     mask) are launched first, and each block walks its key tiles from the
//     last (the diagonal, the masked one) to the first.  The G heads of a
//     kv head re-read its K / V tiles from L2 (16 MB at the serving shape,
//     inside L2's 50 MB).
//   * Loads: Q once, then K / V tiles of 64 keys in bf16 through a ring of
//     two shared-memory stages filled by 16-byte cp.async copies, so the
//     next tile's copy overlaps this tile's products.  Each tile is stored
//     in 64-column blocks of 128-byte rows with the 16-byte chunks of row r
//     XOR-swizzled by r % 8: wgmma's 128-byte swizzle, tiles 1024-byte
//     aligned.  Rows past the valid keys and columns past hd are
//     zero-filled by the copy itself.
//   * Products: S = Q K^T as wgmma m64n64k16 (Q and K K-major in shared
//     memory) and O += P V as wgmma m64n{hd}k16 with P from registers as
//     bf16 (the accumulator layout of S is the A-register layout of P) and
//     V read MN-major (transposed by the descriptor), fp32 accumulators.
//     Each product is waited for before the softmax reads it: no overlap of
//     the softmax with the tensor cores inside a warpgroup yet; two blocks
//     per SM let one block's softmax overlap the other's products.
//   * Softmax: online, in registers, base 2 (scores pre-scaled by
//     log2(e) / sqrt(hd)); a row's max and sum reduce over the 4 lanes that
//     hold it.  m, l and O stay fp32.
//   * Masks per element from runtime positions, only on the tiles some row
//     of the block sees partly; the block's key range is the union of its
//     rows' visible keys, widened to [0, Sk) when a row sees none (uniform
//     weights over all Sk keys, as the reference gives).  Inside the range
//     a masked score is NEG_INF; outside it the key is skipped (weight 0).
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <stdint.h>

namespace tc {

constexpr int kBN = 64;                  // keys per tile
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; with pred false the 16 bytes are zero-filled
// and nothing is read
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// ---- wgmma (sm_90a): a warpgroup of 4 warps multiplies 64 rows at once;
// operands in shared memory are read through 64-bit descriptors

// descriptor of an operand in the 128-byte swizzled layout above (tile
// bases 1024-byte aligned): start address, leading and stride byte
// offsets, layout type 1 (128-byte swizzle)
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
         | static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16
         | static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32
         | static_cast<uint64_t>(1) << 62;
}
__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep the compiler from moving accumulator reads or writes across the
// asynchronous products
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[j][e]) :: "memory");
}
// make the cp.async writes to shared memory visible to wgmma's reads
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// d (+)= a b, m64n64k16: a and b K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[8][4],
                                             uint64_t da, uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d += a b, m64n64k16: a (bf16) from registers, b MN-major in shared
// memory (transposed on read)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[8][4],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += a b, m64n128k16: a (bf16) from registers, b MN-major in shared
// memory (transposed on read)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[16][4],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
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
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// byte offset of 16-byte chunk c of row r in a tile of ROWS rows: 64-column
// blocks of 128-byte rows, chunks swizzled by r % 8
template <int ROWS>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return static_cast<uint32_t>((((c >> 3) * ROWS + r) << 7)
                               + (((c & 7) ^ (r & 7)) << 4));
}

// Copy ROWS rows of HD bf16 columns into a swizzled tile: row(r) is the
// source row or null (zero-filled), columns >= hd are zero-filled.
template <int HD, int ROWS, int NT, typename RowFn>
__device__ __forceinline__ void load_tile(uint32_t dst, int hd,
                                          const void* any, RowFn row) {
  constexpr int CPR = HD / 8, N = ROWS * CPR;
#pragma unroll
  for (int it = 0; it < (N + NT - 1) / NT; ++it) {
    const int c = threadIdx.x + it * NT;
    if (N % NT != 0 && c >= N) break;
    const int r = c / CPR, cc = c % CPR;
    const __nv_bfloat16* p = cc * 8 < hd ? row(r) : nullptr;
    cp_async16(dst + swz<ROWS>(r, cc), p ? p + cc * 8 : any, p != nullptr);
  }
}

template <int HD, int WARPS>
constexpr int smem_bytes() {
  // 1024 bytes of alignment slack, the Q tile, two stages of K and V
  // tiles, then 5 ints of block state
  return 1024 + 16 * WARPS * HD * 2 + 2 * 2 * kBN * HD * 2 + 32;
}

// two blocks per SM (at most 128 registers a thread with 8 warps): one
// block's softmax overlaps the other's products
template <typename Args, int HD, int WARPS>
__global__ void __launch_bounds__(WARPS * 32, 2)
flash_tc_fwd(const Args a) {
  constexpr int NT = WARPS * 32;
  constexpr int BM = 16 * WARPS;         // query rows of the block
  constexpr int Q_BYTES = BM * HD * 2, KV_BYTES = kBN * HD * 2;
  constexpr int NK = HD / 16;            // k16 steps over hd
  extern __shared__ __align__(128) uint8_t tc_smem[];
  // tiles start 1024-byte aligned, as the swizzle pattern repeats
  const uint32_t s_raw = smem_u32(tc_smem);
  const uint32_t s_q = (s_raw + 1023) & ~1023u;
  const uint32_t s_kv = s_q + Q_BYTES;   // stage st: K at + 2 st KV_BYTES
  int* s_int = reinterpret_cast<int*>(tc_smem + (s_q - s_raw) + Q_BYTES
                                      + 4 * KV_BYTES);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int G = a.H / a.KV;
  const int b = blockIdx.x / a.H, h = blockIdx.x % a.H, kvh = h / G;
  const int i0 = (gridDim.y - 1 - blockIdx.y) * BM;   // latest tiles first
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(a.q);
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(a.k);
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(a.v);
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.out);

  int valid = a.kv_valid ? a.kv_valid[b] : a.kv_valid_n;
  valid = min(max(valid, 0), a.Sk);
  auto row_range = [&](int i, int& lo, int& hi) {
    const int pos = a.q_pos ? a.q_pos[i] : a.q_offset + i;
    hi = a.causal ? min(valid, pos + 1) : valid;
    lo = a.has_window ? max(0, pos - a.window + 1) : 0;
  };

  // ---- Q tile (its own copy group), then the block's key range: the
  // union of its rows' ranges, and the keys every row sees
  load_tile<HD, BM, NT>(s_q, a.hd, q, [&](int r) -> const __nv_bfloat16* {
    const int i = i0 + r;
    return i < a.Sq ? q + b * a.q_sb + i * a.q_ss + h * a.q_sh : nullptr;
  });
  cp_async_commit();
  if (tid == 0) {
    s_int[0] = a.Sk; s_int[1] = 0; s_int[2] = 0;    // lo, hi, empty
    s_int[3] = 0; s_int[4] = a.Sk;                   // max lo, min hi
  }
  __syncthreads();
  if (tid < BM && i0 + tid < a.Sq) {
    int lo, hi;
    row_range(i0 + tid, lo, hi);
    if (hi <= lo) {
      s_int[2] = 1;
    } else {
      atomicMin(&s_int[0], lo); atomicMax(&s_int[1], hi);
      atomicMax(&s_int[3], lo); atomicMin(&s_int[4], hi);
    }
  }
  __syncthreads();
  const bool empty = s_int[2] != 0;
  const int lo = empty ? 0 : s_int[0], hi = empty ? a.Sk : s_int[1];
  const int all_lo = s_int[3], all_hi = s_int[4];

  // this thread's two rows: warp row g = lane / 4 and g + 8
  int rlo[2], rhi[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int i = i0 + warp * 16 + (lane >> 2) + 8 * e;
    rlo[e] = 0; rhi[e] = a.Sk;
    if (i < a.Sq) row_range(i, rlo[e], rhi[e]);
  }
  const float scale = a.scale * kLog2e;
  float m[2] = {-1e30f, -1e30f}, l[2] = {0.f, 0.f};
  float o[HD / 8][4];
#pragma unroll
  for (int d = 0; d < HD / 8; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[d][e] = 0.f;

  const int t_lo = lo / kBN;
  const int n_t = hi > lo ? (hi + kBN - 1) / kBN - t_lo : 0;
  auto issue = [&](int t, int st) {
    const int j0 = (t_lo + t) * kBN;
    const uint32_t dk = s_kv + 2 * st * KV_BYTES;
    load_tile<HD, kBN, NT>(dk, a.hd, k, [&](int r) -> const __nv_bfloat16* {
      const int j = j0 + r;
      return j < hi ? k + b * a.k_sb + j * a.k_ss + kvh * a.k_sh : nullptr;
    });
    load_tile<HD, kBN, NT>(dk + KV_BYTES, a.hd, v,
                           [&](int r) -> const __nv_bfloat16* {
      const int j = j0 + r;
      return j < hi ? v + b * a.v_sb + j * a.v_ss + kvh * a.v_sh : nullptr;
    });
    cp_async_commit();
  };
  if (n_t > 0) issue(n_t - 1, 0);

  for (int it = 0; it < n_t; ++it) {
    const int t = n_t - 1 - it, st = it & 1;
    if (it + 1 < n_t) {
      issue(t - 1, st ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_async_shared();
    __syncthreads();
    const uint32_t sk = s_kv + 2 * st * KV_BYTES, sv = sk + KV_BYTES;
    const int j0 = (t_lo + t) * kBN;

    // ---- S = Q K^T: 16 rows x 64 keys per warp
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
    // the warpgroup's 64 rows of Q against the 64 keys, k16 at a time:
    // step kk is 32 bytes into 64-column block kk / 4
    const uint32_t qw = s_q + (warp >> 2) * 64 * 128;
    fence_regs(s);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < NK; ++kk)
      wgmma_ss_n64(s,
                   gmma_desc(qw + (kk >> 2) * BM * 128 + (kk & 3) * 32,
                             16, 1024),
                   gmma_desc(sk + (kk >> 2) * kBN * 128 + (kk & 3) * 32,
                             16, 1024),
                   kk > 0);
    wg_commit();
    wg_wait0();
    fence_regs(s);

    // ---- scale and mask (only where some row sees part of the tile)
    const bool full = !empty && j0 >= all_lo && j0 + kBN <= all_hi;
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * scale;
        if (!full) {
          const int key = j0 + n * 8 + 2 * (lane & 3) + (e & 1);
          const int r = e >> 1;
          if (key < lo || key >= hi) x = -CUDART_INF_F;     // skipped
          else if (key < rlo[r] || key >= rhi[r]) x = -1e30f;  // NEG_INF
        }
        s[n][e] = x;
      }

    // ---- online softmax, base 2; a row lives on the 4 lanes of a quad
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = m[r];
#pragma unroll
      for (int n = 0; n < 8; ++n)
        mx = fmaxf(mx, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float corr = exp2f(m[r] - mx);
      m[r] = mx;
      l[r] *= corr;
#pragma unroll
      for (int d = 0; d < HD / 8; ++d) {
        o[d][2 * r] *= corr;
        o[d][2 * r + 1] *= corr;
      }
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float p = exp2f(s[n][2 * r + c] - mx);
          l[r] += p;
          s[n][2 * r + c] = p;
        }
    }

    // ---- O += P V: P from the S registers as the bf16 A operand
    uint32_t pa[kBN / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      pa[kk][0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[kk][1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[kk][2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[kk][3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
    }
    // V tile as the MN-major B operand: 16 keys (two 8-row groups 1024
    // bytes apart) per step, hd in 64-column blocks kBN * 128 bytes apart
    fence_regs(o);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      const uint64_t db = gmma_desc(sv + kk * 16 * 128, kBN * 128, 1024);
      if constexpr (HD == 128) wgmma_rs_n128(o, pa[kk], db);
      else wgmma_rs_n64(o, pa[kk], db);
    }
    wg_commit();
    wg_wait0();
    fence_regs(o);
    __syncthreads();                     // before the ring reuses the stage
  }

  // ---- out = O / max(l, 1e-30) in bf16, layout [B, Sq, H, hd]
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lr = l[r];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    const int i = i0 + warp * 16 + (lane >> 2) + 8 * r;
    if (i >= a.Sq) continue;
    const float inv = 1.f / fmaxf(lr, 1e-30f);
    __nv_bfloat16* orow = out + ((int64_t(b) * a.Sq + i) * a.H + h) * a.hd;
#pragma unroll
    for (int d = 0; d < HD / 8; ++d) {
      const int col = d * 8 + 2 * (lane & 3);
      if (col < a.hd)
        *reinterpret_cast<__nv_bfloat162*>(orow + col) =
            __floats2bfloat162_rn(o[d][2 * r] * inv, o[d][2 * r + 1] * inv);
    }
  }
}

template <typename Args, int HD, int WARPS>
int launch(const Args& a, cudaStream_t stream) {
  constexpr int BM = 16 * WARPS;
  constexpr int smem = smem_bytes<HD, WARPS>();
  static bool configured = false;        // one attribute call per variant
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_tc_fwd<Args, HD, WARPS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  dim3 grid(a.B * a.H, (a.Sq + BM - 1) / BM);
  flash_tc_fwd<Args, HD, WARPS><<<grid, WARPS * 32, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// hd <= 64 pads to 64 columns, else 128; 64-row tiles for short queries
template <typename Args>
int dispatch(const Args& a, cudaStream_t stream) {
  if (a.hd <= 64)
    return a.Sq <= 64 ? tc::launch<Args, 64, 4>(a, stream)
                      : tc::launch<Args, 64, 8>(a, stream);
  return a.Sq <= 64 ? tc::launch<Args, 128, 4>(a, stream)
                    : tc::launch<Args, 128, 8>(a, stream);
}

}  // namespace tc
