// Hopper (sm_90a) flash attention forward: online-softmax attention with
// GQA and causal / sliding-window / valid-length masks.  Replaces
// _flash_kernel / flash_attention_pallas of
// src/repro/kernels/flash_attention/kernel.py (the Pallas TPU kernel).
//
// Built by repro_torch/kernels/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// into a shared library with a plain C interface, loaded with ctypes.  The
// entry point launches on the caller's stream, allocates nothing, does not
// synchronise, and returns cudaGetLastError().
//
// What it computes (flash_attention_ref's function, model layout):
//   q [B, Sq, H, hd], k / v [B, Sk, KV, hd], H = KV * G, read in place
//   through their strides (last dim contiguous; no transpose, no padding),
//   out [B, Sq, H, hd] contiguous in q's dtype.  Query i sits at position
//   q_pos[i] (or q_offset + i); key j of batch b counts when
//   j < kv_valid[b] (or kv_valid_n), j <= pos (causal) and
//   j > pos - window (window).  Masked scores are NEG_INF = -1e30 as in
//   the reference; scores, the running max m, the denominator l and the
//   accumulator are fp32; the result is acc / max(l, 1e-30).
//
// Design (simple and right first; no tensor cores yet):
//   * One block of 4 warps serves RB = 4 * RW (query, head) rows of one
//     (batch, kv head): the G query heads of a kv head share every K/V tile
//     read, so K/V are read once per group, not once per query head.
//   * The kv loop runs inside the block over tiles of BK = 32 keys staged
//     in shared memory as fp32, with 16-byte loads that a thread issues
//     together before it stores any (one memory latency per tile, not one
//     per element).  It covers only the keys some row of the
//     block can see: [min window start, min(kv_valid, last causal key + 1)),
//     so a decode step reads kv_valid keys of the cache, not max_seq.
//   * A row whose keys are all masked gets the reference's value (uniform
//     weights over all Sk keys): a block holding such a row widens its
//     range to [0, Sk), where every key of that row scores NEG_INF.  Keys
//     outside the block's range are skipped outright (weight 0).
//   * Scores: lane j of a warp scores key j of the tile for each of the
//     warp's RW rows (fp32 FMAs over hd, Q rows broadcast from shared
//     memory).  Softmax: warp max / sum per row.  P.V: each lane owns hd/32
//     output columns of each row; P goes through shared memory.
//   * fp32 on CUDA cores bounds it by operations: 4 * hd FLOPs per (row,
//     visible key) against the card's fp32 rate, far from the bf16 tensor
//     core bound; wgmma tiles and TMA loads are later work.
//   * Decode (Sq = 1) gives only B * KV blocks; split-kv is later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBK = 32;                 // keys per tile (one per lane)
constexpr float kNegInf = -1e30f;       // the reference's mask value

constexpr int kF32 = 0;                 // dtype codes shared with ops.py
constexpr int kBF16 = 1;

__device__ inline float to_f32(float v) { return v; }
__device__ inline float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ inline void store(float* p, float v) { *p = v; }
__device__ inline void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ inline float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ inline float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

struct Args {
  const void* q; const void* k; const void* v; void* out;
  int B, Sq, Sk, H, KV, hd;
  int64_t q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  const int* q_pos; int q_offset;
  const int* kv_valid; int kv_valid_n;
  int causal, has_window, window;
  float scale;
  int vec;            // every row of q, k, v starts 16-byte aligned
};

// 16 bytes of T widened to fp32
template <typename T> struct Vec16;

template <> struct Vec16<float> {
  static constexpr int V = 4;
  __device__ static void widen(const uint4& raw, float* x) {
    x[0] = __uint_as_float(raw.x); x[1] = __uint_as_float(raw.y);
    x[2] = __uint_as_float(raw.z); x[3] = __uint_as_float(raw.w);
  }
};

template <> struct Vec16<__nv_bfloat16> {
  static constexpr int V = 8;
  __device__ static void widen(const uint4& raw, float* x) {
    const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
    for (int e = 0; e < V; ++e) x[e] = __bfloat162float(h[e]);
  }
};

// Stage ROWS rows of hd elements into dst (row r at dst + r * stride) as
// fp32, zero past hd and for rows whose source row(r) is null.  With vec,
// each thread issues all its 16-byte loads before its first store, so the
// loads of a tile are in flight together; else one element at a time.
template <typename T, int HD, int ROWS, typename RowFn>
__device__ inline void stage(float* dst, int stride, int hd, bool vec,
                             RowFn row) {
  if (vec) {
    constexpr int V = Vec16<T>::V, CPR = HD / V, N = ROWS * CPR;
    constexpr int IT = (N + kThreads - 1) / kThreads;
    uint4 raw[IT];
#pragma unroll
    for (int it = 0; it < IT; ++it) {
      const int c = threadIdx.x + it * kThreads;
      const int r = c / CPR, d = (c % CPR) * V;
      const T* p = (c < N && d < hd) ? row(r) : nullptr;
      raw[it] = p ? *reinterpret_cast<const uint4*>(p + d)
                  : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int it = 0; it < IT; ++it) {
      const int c = threadIdx.x + it * kThreads;
      if (c >= N) continue;
      float x[V];
      Vec16<T>::widen(raw[it], x);
      float4* o = reinterpret_cast<float4*>(dst + (c / CPR) * stride
                                            + (c % CPR) * V);
#pragma unroll
      for (int e = 0; e < V / 4; ++e)
        o[e] = make_float4(x[4 * e], x[4 * e + 1], x[4 * e + 2],
                           x[4 * e + 3]);
    }
  } else {
    for (int e = threadIdx.x; e < ROWS * HD; e += kThreads) {
      const int r = e / HD, d = e % HD;
      const T* p = d < hd ? row(r) : nullptr;
      dst[r * stride + d] = p ? to_f32(p[d]) : 0.f;
    }
  }
}

// shared-memory floats of one block: Q rows, K tile (rows padded by 4 so
// lane j's float4 reads of row j fall in distinct banks), V tile, P rows
template <int HD, int RW>
constexpr int smem_floats() {
  return kWarps * RW * HD + kBK * (HD + 4) + kBK * HD + kWarps * RW * kBK;
}

template <typename T, int HD, int RW>
__global__ void __launch_bounds__(kThreads)
flash_fwd(const Args a) {
  constexpr int RB = kWarps * RW;       // rows per block
  constexpr int DPL = HD / 32;          // output columns per lane
  constexpr int KS = HD + 4;            // K tile row stride
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                     // [RB][HD]
  float* ks = qs + RB * HD;             // [kBK][KS]
  float* vs = ks + kBK * KS;            // [kBK][HD]
  float* ps = vs + kBK * HD;            // [RB][kBK]
  __shared__ int s_lo, s_hi, s_empty;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int G = a.H / a.KV;
  const int b = blockIdx.y / a.KV, kvh = blockIdx.y % a.KV;
  const int r0 = blockIdx.x * RB;
  const int n_rows = a.Sq * G;
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  T* out = static_cast<T*>(a.out);

  int valid = a.kv_valid ? a.kv_valid[b] : a.kv_valid_n;
  valid = min(max(valid, 0), a.Sk);

  // ---- the block's key range: the union of its rows' visible keys
  if (tid == 0) { s_lo = a.Sk; s_hi = 0; s_empty = 0; }
  __syncthreads();
  const int q_first = r0 / G;
  const int q_last = min(r0 + RB - 1, n_rows - 1) / G;
  for (int qi = q_first + tid; qi <= q_last; qi += kThreads) {
    const int pos = a.q_pos ? a.q_pos[qi] : a.q_offset + qi;
    const int hi = a.causal ? min(valid, pos + 1) : valid;
    const int lo = a.has_window ? max(0, pos - a.window + 1) : 0;
    if (hi <= lo) {
      s_empty = 1;
    } else {
      atomicMin(&s_lo, lo);
      atomicMax(&s_hi, hi);
    }
  }
  // ---- Q rows of the block as fp32, zero past hd and past the last row
  stage<T, HD, RB>(qs, HD, a.hd, a.vec, [&](int r) -> const T* {
    const int row = r0 + r;
    if (row >= n_rows) return nullptr;
    return q + b * a.q_sb + (row / G) * a.q_ss + (kvh * G + row % G) * a.q_sh;
  });
  __syncthreads();
  const int lo = s_empty ? 0 : s_lo;
  const int hi = s_empty ? a.Sk : s_hi;

  // per-row state; row i of this warp is block row warp + kWarps * i
  int pos[RW];
  bool live[RW];
  float m[RW], l[RW], acc[RW][DPL];
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    const int row = r0 + warp + kWarps * i;
    live[i] = row < n_rows;
    const int qi = live[i] ? row / G : 0;
    pos[i] = a.q_pos ? a.q_pos[qi] : a.q_offset + qi;
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DPL; ++c) acc[i][c] = 0.f;
  }

  for (int j0 = lo; j0 < hi; j0 += kBK) {
    // ---- stage the K and V tiles as fp32 (zero past hd and past hi)
    stage<T, HD, kBK>(ks, KS, a.hd, a.vec, [&](int j) -> const T* {
      return j0 + j < hi ? k + b * a.k_sb + (j0 + j) * a.k_ss + kvh * a.k_sh
                         : nullptr;
    });
    stage<T, HD, kBK>(vs, HD, a.hd, a.vec, [&](int j) -> const T* {
      return j0 + j < hi ? v + b * a.v_sb + (j0 + j) * a.v_ss + kvh * a.v_sh
                         : nullptr;
    });
    __syncthreads();

    // ---- scores of key j0 + lane for the warp's rows
    float s[RW];
#pragma unroll
    for (int i = 0; i < RW; ++i) s[i] = 0.f;
    const float4* krow = reinterpret_cast<const float4*>(ks + lane * KS);
#pragma unroll 4
    for (int d4 = 0; d4 < HD / 4; ++d4) {
      const float4 kk = krow[d4];
#pragma unroll
      for (int i = 0; i < RW; ++i) {
        const float4 qq = reinterpret_cast<const float4*>(
            qs + (warp + kWarps * i) * HD)[d4];
        s[i] = fmaf(qq.x, kk.x, s[i]);
        s[i] = fmaf(qq.y, kk.y, s[i]);
        s[i] = fmaf(qq.z, kk.z, s[i]);
        s[i] = fmaf(qq.w, kk.w, s[i]);
      }
    }

    // ---- masks and the online softmax, one row at a time
    const int key = j0 + lane;
    float* prow = ps + warp * RW * kBK;
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      float x;
      if (key >= hi) {
        x = -CUDART_INF_F;              // outside the block's range: skip
      } else {
        bool ok = key < valid;
        if (a.causal) ok = ok && key <= pos[i];
        if (a.has_window) ok = ok && key > pos[i] - a.window;
        x = ok ? s[i] * a.scale : kNegInf;
      }
      const float m_new = fmaxf(m[i], warp_max(x));
      const float p = expf(x - m_new);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + warp_sum(p);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DPL; ++c) acc[i][c] *= corr;
      prow[i * kBK + lane] = p;
    }
    __syncwarp();

    // ---- acc += P V over the tile's keys
#pragma unroll 4
    for (int j4 = 0; j4 < kBK / 4; ++j4) {
      float vv[4][DPL];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int c = 0; c < DPL; ++c)
          vv[jj][c] = vs[(4 * j4 + jj) * HD + lane + 32 * c];
#pragma unroll
      for (int i = 0; i < RW; ++i) {
        const float4 pp = reinterpret_cast<const float4*>(
            prow + i * kBK)[j4];
#pragma unroll
        for (int c = 0; c < DPL; ++c) {
          acc[i][c] = fmaf(pp.x, vv[0][c], acc[i][c]);
          acc[i][c] = fmaf(pp.y, vv[1][c], acc[i][c]);
          acc[i][c] = fmaf(pp.z, vv[2][c], acc[i][c]);
          acc[i][c] = fmaf(pp.w, vv[3][c], acc[i][c]);
        }
      }
    }
    __syncthreads();                    // before the next tile overwrites
  }

  // ---- out = acc / max(l, 1e-30) in q's dtype, layout [B, Sq, H, hd]
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    if (!live[i]) continue;
    const int row = r0 + warp + kWarps * i;
    const int qi = row / G, h = kvh * G + row % G;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    T* o = out + ((int64_t(b) * a.Sq + qi) * a.H + h) * a.hd;
#pragma unroll
    for (int c = 0; c < DPL; ++c) {
      const int d = lane + 32 * c;
      if (d < a.hd) store(o + d, acc[i][c] * inv);
    }
  }
}

template <typename T, int HD, int RW>
int launch(const Args& a, cudaStream_t stream) {
  constexpr int RB = kWarps * RW;
  const size_t smem = sizeof(float) * smem_floats<HD, RW>();
  static bool configured = false;       // one attribute call per variant
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_fwd<T, HD, RW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const int n_rows = a.Sq * (a.H / a.KV);
  dim3 grid((n_rows + RB - 1) / RB, a.B * a.KV);
  flash_fwd<T, HD, RW><<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int dispatch_rows(const Args& a, cudaStream_t stream) {
  // few rows per (batch, kv head), as in decode: small blocks
  if (a.Sq * (a.H / a.KV) <= 4 * kWarps) return launch<T, HD, 4>(a, stream);
  return launch<T, HD, 16>(a, stream);
}

template <typename T>
int dispatch(const Args& a, cudaStream_t stream) {
  if (a.hd <= 32) return dispatch_rows<T, 32>(a, stream);
  if (a.hd <= 64) return dispatch_rows<T, 64>(a, stream);
  return dispatch_rows<T, 128>(a, stream);
}

}  // namespace

extern "C" {

// Returns a cudaError_t (0 = launched).  hd <= 128; strides in elements.
// q_pos may be null (positions q_offset + i), kv_valid may be null (one
// valid length kv_valid_n for every batch row).  vec != 0 promises that
// hd is a multiple of 16 bytes' worth of elements and that every row of
// q, k and v starts 16-byte aligned (16-byte loads).
int fa_forward(int dtype, const void* q, const void* k, const void* v,
               void* out, int B, int Sq, int Sk, int H, int KV, int hd,
               int64_t q_sb, int64_t q_ss, int64_t q_sh,
               int64_t k_sb, int64_t k_ss, int64_t k_sh,
               int64_t v_sb, int64_t v_ss, int64_t v_sh,
               const int* q_pos, int q_offset, const int* kv_valid,
               int kv_valid_n, int causal, int has_window, int window,
               float scale, int vec, void* stream) {
  if (hd < 1 || hd > 128 || KV < 1 || H % KV != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || Sq == 0) return 0;
  Args a{q, k, v, out, B, Sq, Sk, H, KV, hd,
         q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
         q_pos, q_offset, kv_valid, kv_valid_n,
         causal, has_window, window, scale, vec};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return dispatch<float>(a, s);
  if (dtype == kBF16) return dispatch<__nv_bfloat16>(a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
