// Hopper (sm_90a) flash attention forward: online-softmax attention with
// GQA and causal / sliding-window / valid-length masks.  Replaces
// _flash_kernel / flash_attention_pallas of
// src/repro/kernels/flash_attention/kernel.py (the Pallas TPU kernel).
//
// Built by repro_torch/kernels/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// into a shared library with a plain C interface, loaded with ctypes.  The
// entry points launch on the caller's stream, allocate nothing (scratch
// comes from the caller), do not synchronise, and return
// cudaGetLastError().
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
// Four routes; the caller (ops.py) picks one by dtype, shape and arguments:
//   fa_forward_tc    bf16 prefill on the tensor cores at hd <= 128
//                    (flash_tc.cuh).
//   fa_forward_tc_wide
//                    bf16 prefill on the tensor cores at hd 576, MLA's
//                    absorbed width, without a window (flash_tc_wide.cuh):
//                    64 folded (position, head) rows a block, O split by
//                    columns over two warpgroups.
//   fa_forward_split decode (at most 16 (query, head) rows per (batch, kv
//                    head)), fp32 or bf16 (flash_split below): the key range
//                    is cut into chunks, one block per (batch, kv head,
//                    chunk) copies the chunk's K and V once for all its rows
//                    and writes a partial (m, l, acc) to the caller's fp32
//                    scratch, and flash_merge combines the partials in chunk
//                    order (two calls give the same bits).  Decode reads
//                    each cached key once and is bound by those bytes; the
//                    chunks give B * KV * chunks blocks where one block per
//                    (batch, kv head) gave 16 on 132 SMs.
//   fa_forward_mma   everything else (flash_mma.cuh): the fp32 prefill, and
//                    bf16 calls with hd not a multiple of 16, hd 129-575, a
//                    window over hd 128, or rows not 16-byte aligned.  Every
//                    product is mma.sync.m16n8k8 TF32 with fp32
//                    accumulators, fp32 operands split into two TF32 parts
//                    (three mma a product): within a few fp32 roundoffs of
//                    fp32 products.
//
// Head dims: 1..576 (MLA's absorbed attention works at kv_lora_rank +
// rope_head_dim = 576).  Each route has instances padded to HD = 32, 64,
// 128 (the tensor-core route stops there: wgmma m64n{HD}k16 and tiles of HD
// swizzled columns), then 256 and 576 (the wide tensor-core route has only
// 576).  Above 128 the TF32 and split-kv instances take another shape so
// that a block fits the 227 KB of shared memory and its accumulators stay
// in registers: the TF32 kernel splits hd over 2 (HD 256) or 4 (HD 576)
// warps, and the fp32 split-kv kernel at HD 576 takes chunks of 32 keys
// instead of 64 (split_chunk).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <stddef.h>
#include <stdint.h>

#include "flash_mma.cuh"
#include "flash_tc.cuh"
#include "flash_tc_wide.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
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
  // split-kv route only: the partials' scratch (m, l) [chunks, B * Sq * H,
  // 2] and acc [chunks, B * Sq * H, hd]
  float* part_ml; float* part_acc;
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

// 16-byte loads a thread keeps in flight while staging: all of a tile's
// when they are at most kStageLoads, else batches of kStageBatch
constexpr int kStageLoads = 16;
constexpr int kStageBatch = 8;

// Stage ROWS rows of hd elements into dst (row r at dst + r * stride) as
// fp32, zero past hd and for rows whose source row(r) is null.  With vec,
// each thread issues its 16-byte loads (all, or a batch) before its first
// store, so the loads of a tile are in flight together; else one element
// at a time.
template <typename T, int HD, int ROWS, typename RowFn>
__device__ inline void stage(float* dst, int stride, int hd, bool vec,
                             RowFn row) {
  if (vec) {
    constexpr int V = Vec16<T>::V, CPR = HD / V, N = ROWS * CPR;
    constexpr int IT = (N + kThreads - 1) / kThreads;
    constexpr int BATCH = IT <= kStageLoads ? IT : kStageBatch;
#pragma unroll
    for (int it0 = 0; it0 < IT; it0 += BATCH) {
      uint4 raw[BATCH];
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        const int c = threadIdx.x + (it0 + u) * kThreads;
        const int r = c / CPR, d = (c % CPR) * V;
        const T* p = (c < N && d < hd) ? row(r) : nullptr;
        raw[u] = p ? *reinterpret_cast<const uint4*>(p + d)
                   : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        const int c = threadIdx.x + (it0 + u) * kThreads;
        if (c >= N) continue;
        float x[V];
        Vec16<T>::widen(raw[u], x);
        float4* o = reinterpret_cast<float4*>(dst + (c / CPR) * stride
                                              + (c % CPR) * V);
#pragma unroll
        for (int e = 0; e < V / 4; ++e)
          o[e] = make_float4(x[4 * e], x[4 * e + 1], x[4 * e + 2],
                             x[4 * e + 3]);
      }
    }
  } else {
    for (int e = threadIdx.x; e < ROWS * HD; e += kThreads) {
      const int r = e / HD, d = e % HD;
      const T* p = d < hd ? row(r) : nullptr;
      dst[r * stride + d] = p ? to_f32(p[d]) : 0.f;
    }
  }
}

// ---------------------------------------------------------------------------
// Split-kv route (decode): at most kSplitRows (query, head) rows per (batch,
// kv head).  One block per (batch, kv head, chunk of kChunk keys): the
// chunk's K and V rows are copied to shared memory at once (cp.async, one
// memory latency per block), thread t < kChunk scores key t for every row,
// each warp takes the softmax of some rows, and thread d sums column d of
// P V.  The block writes its unnormalised partial (m, l, acc) per row;
// flash_merge below combines the chunks.
// ---------------------------------------------------------------------------

constexpr int kSplitRows = 16;
constexpr int kChunk = 64;              // keys per chunk, one per thread
static_assert(kChunk <= kThreads && kChunk % 4 == 0, "one key per thread");
constexpr int kMaxSmem = 232448;        // opt-in shared memory of a block

// Keys per chunk of the instance for hd (ops.split_chunk mirrors it): fp32
// at HD 576 takes half a chunk, since 64 keys of K and V would need
// 336,896 bytes of shared memory
constexpr int split_chunk(bool f32, int hd) {
  return f32 && hd > 256 ? kChunk / 2 : kChunk;
}

template <typename T, int HD, int CH>
constexpr int split_smem_bytes() {
  // Q rows and scores as fp32, K rows padded by 16 bytes (conflict-free
  // 16-byte reads by one thread per row), V rows
  return 4 * kSplitRows * (HD + CH)
         + CH * (HD * int(sizeof(T)) + 16) + CH * HD * int(sizeof(T));
}

template <typename T, int HD, int CH>
__global__ void __launch_bounds__(kThreads)
flash_split(const Args a) {
  constexpr int KROW = HD * int(sizeof(T)) + 16;    // bytes per K row
  constexpr int VROW = HD * int(sizeof(T));
  constexpr int PER16 = 16 / int(sizeof(T));        // elements per 16 bytes
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                                  // [kSplitRows][HD]
  float* ss = qs + kSplitRows * HD;                  // [kSplitRows][CH]
  char* kbuf = reinterpret_cast<char*>(ss + kSplitRows * CH);
  char* vbuf = kbuf + CH * KROW;
  __shared__ int s_lo, s_hi, s_empty;
  __shared__ int s_qlo[kSplitRows], s_qhi[kSplitRows];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int G = a.H / a.KV;
  const int b = blockIdx.y / a.KV, kvh = blockIdx.y % a.KV;
  const int R = a.Sq * G;
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);

  int valid = a.kv_valid ? a.kv_valid[b] : a.kv_valid_n;
  valid = min(max(valid, 0), a.Sk);

  // ---- each query's visible keys; the block's range is their union,
  // widened to [0, Sk) when a query sees none, cut to this chunk
  if (tid == 0) { s_lo = a.Sk; s_hi = 0; s_empty = 0; }
  __syncthreads();
  if (tid < a.Sq) {
    const int pos = a.q_pos ? a.q_pos[tid] : a.q_offset + tid;
    const int hi = a.causal ? min(valid, pos + 1) : valid;
    const int lo = a.has_window ? max(0, pos - a.window + 1) : 0;
    s_qlo[tid] = lo;
    s_qhi[tid] = hi;
    if (hi <= lo) {
      s_empty = 1;
    } else {
      atomicMin(&s_lo, lo);
      atomicMax(&s_hi, hi);
    }
  }
  stage<T, HD, kSplitRows>(qs, HD, a.hd, a.vec, [&](int r) -> const T* {
    if (r >= R) return nullptr;
    return q + b * a.q_sb + (r / G) * a.q_ss + (kvh * G + r % G) * a.q_sh;
  });
  __syncthreads();
  const int c0 = static_cast<int>(blockIdx.z) * CH;
  const int lo = max(s_empty ? 0 : s_lo, c0);
  const int n = max(min(s_empty ? a.Sk : s_hi, c0 + CH) - lo, 0);
  const int n4 = (n + 3) & ~3;          // P V reads keys four at a time

  // ---- K and V rows [lo, lo + n) to shared memory, zero past hd and for
  // the rows up to n4
  if (a.vec) {
    constexpr int PIECES = HD / PER16;
    for (int e = tid; e < n4 * PIECES; e += kThreads) {
      const int j = e / PIECES, d = (e % PIECES) * PER16;
      const bool ok = j < n && d < a.hd;
      const int64_t key = lo + j;
      tc::cp_async16(tc::smem_u32(kbuf + j * KROW + d * int(sizeof(T))),
                     ok ? k + b * a.k_sb + key * a.k_ss + kvh * a.k_sh + d
                        : k, ok);
      tc::cp_async16(tc::smem_u32(vbuf + j * VROW + d * int(sizeof(T))),
                     ok ? v + b * a.v_sb + key * a.v_ss + kvh * a.v_sh + d
                        : v, ok);
    }
    tc::cp_async_commit();
    tc::cp_async_wait<0>();
  } else {
    for (int e = tid; e < n4 * HD; e += kThreads) {
      const int j = e / HD, d = e % HD;
      const bool ok = j < n && d < a.hd;
      const int64_t key = lo + j;
      reinterpret_cast<T*>(kbuf + j * KROW)[d] =
          ok ? k[b * a.k_sb + key * a.k_ss + kvh * a.k_sh + d] : T(0.f);
      reinterpret_cast<T*>(vbuf + j * VROW)[d] =
          ok ? v[b * a.v_sb + key * a.v_ss + kvh * a.v_sh + d] : T(0.f);
    }
  }
  __syncthreads();

  // ---- scores: thread t < CH takes key lo + t for every row (0 past
  // n)
  if (tid < CH) {
    const int t = tid;
    float s[kSplitRows];
#pragma unroll
    for (int r = 0; r < kSplitRows; ++r) s[r] = 0.f;
    if (t < n) {
      const char* krow = kbuf + t * KROW;
#pragma unroll 4
      for (int d0 = 0; d0 < HD; d0 += 8) {
        float kx[8];
        Vec16<T>::widen(*reinterpret_cast<const uint4*>(
                            krow + d0 * int(sizeof(T))), kx);
        if (PER16 == 4)
          Vec16<T>::widen(*reinterpret_cast<const uint4*>(
                              krow + (d0 + 4) * int(sizeof(T))), kx + 4);
#pragma unroll
        for (int r = 0; r < kSplitRows; ++r) {
          if (r >= R) break;
          const float4 q0 = *reinterpret_cast<const float4*>(qs + r * HD
                                                             + d0);
          const float4 q1 = *reinterpret_cast<const float4*>(qs + r * HD
                                                             + d0 + 4);
          s[r] = fmaf(q0.x, kx[0], s[r]); s[r] = fmaf(q0.y, kx[1], s[r]);
          s[r] = fmaf(q0.z, kx[2], s[r]); s[r] = fmaf(q0.w, kx[3], s[r]);
          s[r] = fmaf(q1.x, kx[4], s[r]); s[r] = fmaf(q1.y, kx[5], s[r]);
          s[r] = fmaf(q1.z, kx[6], s[r]); s[r] = fmaf(q1.w, kx[7], s[r]);
        }
      }
    }
    const int key = lo + t;
#pragma unroll
    for (int r = 0; r < kSplitRows; ++r) {
      if (r >= R) break;
      const int qi = r / G;
      const bool ok = key >= s_qlo[qi] && key < s_qhi[qi];
      ss[r * CH + t] = t >= n ? 0.f : ok ? s[r] * a.scale : kNegInf;
    }
  }
  __syncthreads();

  // ---- softmax of each row over the chunk: m (NEG_INF with no key), l,
  // and p in place of the scores
  const int64_t rows = int64_t(a.B) * a.Sq * a.H;
  auto prow = [&](int r) -> int64_t {
    return int64_t(blockIdx.z) * rows
           + (int64_t(b) * a.Sq + r / G) * a.H + kvh * G + r % G;
  };
  for (int r = warp; r < R; r += kWarps) {
    float* srow = ss + r * CH;
    float mx = kNegInf;
    for (int t = lane; t < n; t += 32) mx = fmaxf(mx, srow[t]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int t = lane; t < n; t += 32) {
      const float p = expf(srow[t] - mx);
      srow[t] = p;
      sum += p;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      a.part_ml[2 * prow(r)] = mx;
      a.part_ml[2 * prow(r) + 1] = sum;
    }
  }
  __syncthreads();

  // ---- acc = P V: thread d sums column d (and d + kThreads, ... when HD >
  // kThreads) over the chunk's keys
  constexpr int DT = (HD + kThreads - 1) / kThreads;
#pragma unroll
  for (int dd = 0; dd < DT; ++dd) {
    const int d = tid + dd * kThreads;
    if (d >= a.hd) break;
    float acc[kSplitRows];
#pragma unroll
    for (int r = 0; r < kSplitRows; ++r) acc[r] = 0.f;
    for (int t = 0; t < n4; t += 4) {
      float vv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        vv[u] = to_f32(reinterpret_cast<const T*>(vbuf + (t + u) * VROW)[d]);
#pragma unroll
      for (int r = 0; r < kSplitRows; ++r) {
        if (r >= R) break;
        const float4 p = *reinterpret_cast<const float4*>(
            ss + r * CH + t);
        acc[r] = fmaf(p.x, vv[0], acc[r]); acc[r] = fmaf(p.y, vv[1], acc[r]);
        acc[r] = fmaf(p.z, vv[2], acc[r]); acc[r] = fmaf(p.w, vv[3], acc[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < kSplitRows; ++r) {
      if (r >= R) break;
      a.part_acc[prow(r) * a.hd + d] = acc[r];
    }
  }
}

// Merge the chunks' partials of one output row, in chunk order:
// out = sum_s e_s acc_s / max(sum_s e_s l_s, 1e-30), e_s = exp(m_s - M),
// M = max_s m_s.  One block per row, one thread per column.
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_merge(const Args a, int n_chunks) {
  const int64_t row = blockIdx.x;
  const int64_t rows = int64_t(a.B) * a.Sq * a.H;
  float M = kNegInf;
  for (int s = 0; s < n_chunks; ++s)
    M = fmaxf(M, a.part_ml[2 * (s * rows + row)]);
  float L = 0.f;
  for (int s = 0; s < n_chunks; ++s)
    L += a.part_ml[2 * (s * rows + row) + 1]
         * expf(a.part_ml[2 * (s * rows + row)] - M);
  const float inv = 1.f / fmaxf(L, 1e-30f);
  T* o = static_cast<T*>(a.out) + row * a.hd;
  for (int d = threadIdx.x; d < a.hd; d += kThreads) {
    float acc = 0.f;
    for (int s = 0; s < n_chunks; ++s)
      acc += a.part_acc[(s * rows + row) * a.hd + d]
             * expf(a.part_ml[2 * (s * rows + row)] - M);
    store(o + d, acc * inv);
  }
}

// the chunks' partials, then their merge on the same stream
template <typename T, int HD>
int launch_split(const Args& a, int n_chunks, cudaStream_t stream) {
  constexpr int CH = split_chunk(sizeof(T) == 4, HD);
  constexpr int smem = split_smem_bytes<T, HD, CH>();
  static_assert(smem <= kMaxSmem, "split-kv block over the shared memory");
  static bool configured = false;       // one attribute call per variant
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_split<T, HD, CH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  dim3 grid(1, a.B * a.KV, n_chunks);
  flash_split<T, HD, CH><<<grid, kThreads, smem, stream>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  flash_merge<T><<<a.B * a.Sq * a.H, kThreads, 0, stream>>>(a, n_chunks);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_split(const Args& a, int n_chunks, cudaStream_t stream) {
  if (a.hd <= 32) return launch_split<T, 32>(a, n_chunks, stream);
  if (a.hd <= 64) return launch_split<T, 64>(a, n_chunks, stream);
  if (a.hd <= 128) return launch_split<T, 128>(a, n_chunks, stream);
  if (a.hd <= 256) return launch_split<T, 256>(a, n_chunks, stream);
  return launch_split<T, 576>(a, n_chunks, stream);
}

}  // namespace

extern "C" {

// Each entry point returns a cudaError_t (0 = launched).  hd <= 576;
// strides in elements.  q_pos may be null (positions q_offset + i),
// kv_valid may be null (one valid length kv_valid_n for every batch row).
// vec != 0 promises that hd is a multiple of 16 bytes' worth of elements
// and that every row of q, k and v starts 16-byte aligned (16-byte loads).

static bool bad_shape(int hd, int H, int KV) {
  return hd < 1 || hd > 576 || KV < 1 || H % KV != 0;
}

// Every route runs once per layer per step, where the host's cost of
// passing some 30 scalars through ctypes would set a decode call's time, so
// each takes the Args block packed by the caller (layout checked against
// fa_args_offsets at load), as a void pointer: a parameter of the unnamed
// namespace's Args type would give it internal linkage.

// The TF32 tensor-core route: any dtype code, alignment and hd <= 576.
int fa_forward_mma(int dtype, const void* args, void* stream) {
  const Args* a = static_cast<const Args*>(args);
  if (bad_shape(a->hd, a->H, a->KV))
    return static_cast<int>(cudaErrorInvalidValue);
  if (a->B == 0 || a->Sq == 0 || a->H == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return fmma::dispatch<Args, float>(*a, s);
  if (dtype == kBF16) return fmma::dispatch<Args, __nv_bfloat16>(*a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The tensor-core route: bf16, hd <= 128 and a multiple of 16, vec.
int fa_forward_tc(int dtype, const void* args, void* stream) {
  const Args* a = static_cast<const Args*>(args);
  if (bad_shape(a->hd, a->H, a->KV) || dtype != kBF16 || a->hd % 16 != 0
      || a->hd > 128 || !a->vec)
    return static_cast<int>(cudaErrorInvalidValue);
  if (a->B == 0 || a->Sq == 0) return 0;
  return tc::dispatch(*a, static_cast<cudaStream_t>(stream));
}

// The wide tensor-core route: bf16, hd 576, vec, no window.  When v is k
// (the same pointer and strides, MLA's call) one shared-memory tile serves
// as both.
int fa_forward_tc_wide(int dtype, const void* args, void* stream) {
  const Args* a = static_cast<const Args*>(args);
  if (bad_shape(a->hd, a->H, a->KV) || dtype != kBF16
      || a->hd != tcw::HD || !a->vec || a->has_window)
    return static_cast<int>(cudaErrorInvalidValue);
  if (a->B == 0 || a->Sq == 0) return 0;
  return tcw::dispatch(*a, static_cast<cudaStream_t>(stream));
}

// The split-kv route: Sq * H / KV <= 16 rows per (batch, kv head); the key
// range [0, Sk) is cut into n_chunks = max(ceil(Sk / chunk), 1) chunks of
// split_chunk(dtype, hd) keys; a->part_ml and a->part_acc hold
// n_chunks * B * Sq * H * 2 and n_chunks * B * Sq * H * hd floats.
// Launches two kernels.
int fa_forward_split(int dtype, const void* args, int n_chunks,
                     void* stream) {
  const Args* a = static_cast<const Args*>(args);
  const int64_t chunk = split_chunk(dtype == kF32, a->hd);
  if (bad_shape(a->hd, a->H, a->KV) || a->Sq * (a->H / a->KV) > kSplitRows
      || n_chunks != (a->Sk > chunk ? (a->Sk + chunk - 1) / chunk : 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (a->B == 0 || a->Sq == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return dispatch_split<float>(*a, n_chunks, s);
  if (dtype == kBF16) return dispatch_split<__nv_bfloat16>(*a, n_chunks, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The byte offset of each field of Args, in declaration order, into out
// (at most n entries); returns the number of fields.
int fa_args_offsets(int64_t* out, int n) {
  const int64_t offs[] = {
      offsetof(Args, q), offsetof(Args, k), offsetof(Args, v),
      offsetof(Args, out), offsetof(Args, B), offsetof(Args, Sq),
      offsetof(Args, Sk), offsetof(Args, H), offsetof(Args, KV),
      offsetof(Args, hd), offsetof(Args, q_sb), offsetof(Args, q_ss),
      offsetof(Args, q_sh), offsetof(Args, k_sb), offsetof(Args, k_ss),
      offsetof(Args, k_sh), offsetof(Args, v_sb), offsetof(Args, v_ss),
      offsetof(Args, v_sh), offsetof(Args, q_pos), offsetof(Args, q_offset),
      offsetof(Args, kv_valid), offsetof(Args, kv_valid_n),
      offsetof(Args, causal), offsetof(Args, has_window),
      offsetof(Args, window), offsetof(Args, scale), offsetof(Args, vec),
      offsetof(Args, part_ml), offsetof(Args, part_acc)};
  const int count = static_cast<int>(sizeof(offs) / sizeof(offs[0]));
  for (int i = 0; i < count && i < n; ++i) out[i] = offs[i];
  return count;
}

}  // extern "C"
