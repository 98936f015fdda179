// Hopper (sm_90a) flash attention backward: dQ, dK and dV of the forward
// kernels' function (flash_attention.cu, flash_tc.cuh).  The JAX package
// has no backward Pallas kernel (jax.value_and_grad differentiates its jnp
// attention), so this kernel replaces none; it is what makes the port's
// attention differentiable on the card (ops.py wraps forward and backward
// in a torch.autograd.Function).
//
// Built by repro_torch/kernels/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// into a shared library with a plain C interface, loaded with ctypes.  The
// entry point launches on the caller's stream, allocates nothing (lse and
// delta scratch come from the caller), does not synchronise, and returns
// cudaGetLastError().
//
// What it computes (autograd through ref.attention_ref, model layout):
//   q, dq [B, Sq, H, hd], k, v, dk, dv [B, Sk, KV, hd], o, do [B, Sq, H,
//   hd], H = KV * G.  q, k, v, o and do are read in place through their
//   strides (last dim contiguous); dq, dk, dv are written contiguous.
//   Query i sits at q_pos[i] (or q_offset + i); key j counts when j <= pos
//   (causal) and j > pos - window (window); every key j < Sk is valid (the
//   wrapper refuses kv_valid under autograd).  With s = scale * q.k over
//   the visible keys, P = softmax(s) and lse the row's log-sum-exp:
//     dV_j = sum_i P_ij dO_i            (summed over the G query heads)
//     dS_ij = P_ij (dO_i . V_j - D_i),  D_i = dO_i . O_i
//     dQ_i = scale sum_j dS_ij K_j,     dK_j = scale sum_i dS_ij Q_i
//   A row that sees no key has uniform weights 1 / Sk over all Sk keys in
//   the forward (every score NEG_INF): it adds dO_i / Sk to every dV_j and
//   nothing to dQ or dK (its scores do not depend on q or k).
//
// Design (FlashAttention-2's backward without its tuning), two kernels:
//   fab_dq   one block per (b, kv head, tile of RQ query rows), rows being
//            the (query, head) pairs of the kv head's G heads.  Pass 1:
//            D per row from the saved O, then the row's lse over the
//            visible key tiles (online max / sum, fp32); pass 3: the key
//            tiles again, recomputing P and dS, accumulating dQ in
//            registers.  Writes lse and D to scratch for fab_dkdv.
//            Recomputing lse leaves the tuned forward kernels untouched.
//   fab_dkdv one block per (b, kv head, tile of BK keys): K and V of the
//            tile stay in shared memory while the block walks every query
//            tile that can see them (all G heads), recomputing P and dS
//            and accumulating dK and dV in registers.
// Every output element is written by one thread of one block after a
// fixed-order loop: no atomics, and two calls give the same bits.  Tiles
// are staged as fp32 in shared memory (rows padded by one float so that
// lanes reading different rows hit different banks); every product is an
// fp32 FMA on the CUDA cores, so the kernel is bound by operations: about
// 12 * hd FLOPs per visible (row, key) pair (pass 1's scores, then S, dP,
// dV, dK and dQ), three times the forward's 4 * hd.  Head dims 1..576 run
// on instances padded to HD = 32, 64, 128, 256 and 576, whose tiles shrink
// as HD grows so that a block's accumulators stay in registers and its
// tiles in the 227 KB of shared memory.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <stdint.h>

namespace fa_bwd {

constexpr int kThreads = 256;
constexpr int kF32 = 0;                 // dtype codes shared with the wrapper
constexpr int kBF16 = 1;

__device__ inline float to_f32(float v) { return v; }
__device__ inline float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ inline void store(float* p, float v) { *p = v; }
__device__ inline void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

struct BwdArgs {
  const void* q; const void* k; const void* v; const void* o;
  const void* dout;
  void* dq; void* dk; void* dv;
  float* lse; float* delta;             // scratch [B, H, Sq] each
  int B, Sq, Sk, H, KV, hd;
  int64_t q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  int64_t o_sb, o_ss, o_sh, d_sb, d_ss, d_sh;
  const int* q_pos; int q_offset;
  int causal, has_window, window;
  float scale;
};

// query rows a block serves (RQ) and keys a tile holds (BK), by instance
template <int HD> struct Tile;
template <> struct Tile<32> { static constexpr int RQ = 64, BK = 32; };
template <> struct Tile<64> { static constexpr int RQ = 64, BK = 32; };
template <> struct Tile<128> { static constexpr int RQ = 32, BK = 32; };
template <> struct Tile<256> { static constexpr int RQ = 16, BK = 16; };
template <> struct Tile<576> { static constexpr int RQ = 16, BK = 8; };

// One query row of a (b, kv head) block: flattened index rr = i * G + g.
struct Row {
  int64_t qoff, ooff, doff;             // element offsets of q, o, do rows
  int i, h, lo, hi;                     // visible keys [lo, hi)
  bool valid;
};

__device__ inline Row make_row(const BwdArgs& a, int b, int kvh, int rr) {
  Row w;
  const int G = a.H / a.KV;
  w.valid = rr < a.Sq * G;
  w.i = w.valid ? rr / G : 0;
  w.h = kvh * G + (w.valid ? rr % G : 0);
  w.qoff = b * a.q_sb + w.i * a.q_ss + w.h * a.q_sh;
  w.ooff = b * a.o_sb + w.i * a.o_ss + w.h * a.o_sh;
  w.doff = b * a.d_sb + w.i * a.d_ss + w.h * a.d_sh;
  const int pos = a.q_pos ? a.q_pos[w.i] : a.q_offset + w.i;
  // clamp in 64 bits: pos - window + 1 and pos + 1 may leave int range
  const long long lo = a.has_window
      ? (long long)pos - (long long)a.window + 1 : 0;
  const long long hi = a.causal ? (long long)pos + 1 : (long long)a.Sk;
  w.lo = (int)(lo < 0 ? 0 : (lo > a.Sk ? a.Sk : lo));
  w.hi = (int)(hi < 0 ? 0 : (hi > a.Sk ? a.Sk : hi));
  if (!w.valid) { w.lo = 0; w.hi = 0; }
  return w;
}

// Stage ROWS rows of hd elements into dst (row r at dst + r * (HD + 1)) as
// fp32: row r from base + off(r), zero past hd and where off(r) < 0.
template <typename T, int HD, int ROWS, typename OffFn>
__device__ inline void stage(float* dst, const T* base, int hd, OffFn off) {
  for (int e = threadIdx.x; e < ROWS * HD; e += kThreads) {
    const int r = e / HD, d = e % HD;
    const int64_t o = off(r);
    dst[r * (HD + 1) + d] = (o >= 0 && d < hd) ? to_f32(base[o + d]) : 0.f;
  }
}

// a . b over HD padded fp32 elements of two staged rows
template <int HD>
__device__ inline float dot(const float* a, const float* b) {
  float s = 0.f;
#pragma unroll 8
  for (int d = 0; d < HD; ++d) s = fmaf(a[d], b[d], s);
  return s;
}

template <int HD>
constexpr int dq_smem_floats() {
  return (2 * Tile<HD>::RQ + 2 * Tile<HD>::BK) * (HD + 1)
         + Tile<HD>::RQ * (Tile<HD>::BK + 1) + 2 * Tile<HD>::RQ;
}

template <int HD>
constexpr int dkdv_smem_floats() {
  return (2 * Tile<HD>::RQ + 2 * Tile<HD>::BK) * (HD + 1)
         + 2 * Tile<HD>::RQ * (Tile<HD>::BK + 1) + 2 * Tile<HD>::RQ;
}

// ---------------------------------------------------------------------------
// fab_dq: D and lse per row (pass 1), then dQ (pass 3)
// ---------------------------------------------------------------------------
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) fab_dq(BwdArgs a) {
  constexpr int RQ = Tile<HD>::RQ, BK = Tile<HD>::BK, LD = HD + 1;
  constexpr int TPR = kThreads / RQ;    // threads a row in the row loops
  constexpr int NACC = RQ * HD / kThreads;
  extern __shared__ float smem[];
  float* Qs = smem;                     // [RQ][LD]
  float* dOs = Qs + RQ * LD;            // [RQ][LD]
  float* Ks = dOs + RQ * LD;            // [BK][LD]
  float* Vs = Ks + BK * LD;             // [BK][LD]
  float* Ss = Vs + BK * LD;             // [RQ][BK + 1] scores, then dS
  float* lse_s = Ss + RQ * (BK + 1);    // [RQ]
  float* D_s = lse_s + RQ;              // [RQ]
  __shared__ Row rows_s[RQ];
  __shared__ int klo, khi;

  const int b = blockIdx.y / a.KV, kvh = blockIdx.y % a.KV;
  const int r0 = blockIdx.x * RQ;
  const int tid = threadIdx.x;
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* o = static_cast<const T*>(a.o);
  const T* dout = static_cast<const T*>(a.dout);

  if (tid == 0) { klo = a.Sk; khi = 0; }
  __syncthreads();
  if (tid < RQ) {
    const Row w = make_row(a, b, kvh, r0 + tid);
    rows_s[tid] = w;
    if (w.hi > w.lo) { atomicMin(&klo, w.lo); atomicMax(&khi, w.hi); }
  }
  __syncthreads();
  stage<T, HD, RQ>(Qs, q, a.hd, [&](int r) -> int64_t {
    return rows_s[r].valid ? rows_s[r].qoff : -1; });
  stage<T, HD, RQ>(dOs, dout, a.hd, [&](int r) -> int64_t {
    return rows_s[r].valid ? rows_s[r].doff : -1; });
  __syncthreads();

  // pass 1a: D = dO . O per row, TPR adjacent lanes a row
  const int my_r = tid / TPR, my_t = tid % TPR;
  {
    const Row& w = rows_s[my_r];
    float s = 0.f;
    if (w.valid)
      for (int d = my_t; d < a.hd; d += TPR)
        s = fmaf(dOs[my_r * LD + d], to_f32(o[w.ooff + d]), s);
#pragma unroll
    for (int off = TPR / 2; off > 0; off >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, off);
    if (my_t == 0) D_s[my_r] = s;
  }

  // pass 1b: lse per row over its visible keys
  float m = -CUDART_INF_F, l = 0.f;
  const int t_lo = (klo / BK) * BK;
  for (int j0 = t_lo; j0 < khi; j0 += BK) {
    stage<T, HD, BK>(Ks, k, a.hd, [&](int j) -> int64_t {
      return j0 + j < a.Sk ? b * a.k_sb + (int64_t)(j0 + j) * a.k_ss
                             + kvh * a.k_sh : -1; });
    __syncthreads();
    for (int e = tid; e < RQ * BK; e += kThreads) {
      const int r = e / BK, j = e % BK;
      Ss[r * (BK + 1) + j] = a.scale * dot<HD>(Qs + r * LD, Ks + j * LD);
    }
    __syncthreads();
    const int lo = rows_s[my_r].lo, hi = rows_s[my_r].hi;
    for (int j = my_t; j < BK; j += TPR) {
      const int key = j0 + j;
      if (key < lo || key >= hi) continue;
      const float s = Ss[my_r * (BK + 1) + j];
      const float mn = fmaxf(m, s);
      l = l * expf(m - mn) + expf(s - mn);
      m = mn;
    }
    __syncthreads();
  }
  {
    float mall = m;
#pragma unroll
    for (int off = TPR / 2; off > 0; off >>= 1)
      mall = fmaxf(mall, __shfl_xor_sync(0xffffffffu, mall, off));
    float lt = (l > 0.f) ? l * expf(m - mall) : 0.f;
#pragma unroll
    for (int off = TPR / 2; off > 0; off >>= 1)
      lt += __shfl_xor_sync(0xffffffffu, lt, off);
    if (my_t == 0) {
      // a row with no visible key: lse = +inf marks it (uniform weights)
      const float lse = lt > 0.f ? mall + logf(lt) : CUDART_INF_F;
      lse_s[my_r] = lse;
      const Row& w = rows_s[my_r];
      if (w.valid) {
        const int64_t idx = ((int64_t)b * a.H + w.h) * a.Sq + w.i;
        a.lse[idx] = lse;
        a.delta[idx] = D_s[my_r];
      }
    }
  }
  __syncthreads();

  // pass 3: dQ = scale * sum_j dS_ij K_j
  float acc[NACC];
#pragma unroll
  for (int n = 0; n < NACC; ++n) acc[n] = 0.f;
  for (int j0 = t_lo; j0 < khi; j0 += BK) {
    auto koff = [&](int j) -> int64_t {
      return j0 + j < a.Sk ? b * a.k_sb + (int64_t)(j0 + j) * a.k_ss
                             + kvh * a.k_sh : -1; };
    auto voff = [&](int j) -> int64_t {
      return j0 + j < a.Sk ? b * a.v_sb + (int64_t)(j0 + j) * a.v_ss
                             + kvh * a.v_sh : -1; };
    stage<T, HD, BK>(Ks, k, a.hd, koff);
    stage<T, HD, BK>(Vs, v, a.hd, voff);
    __syncthreads();
    for (int e = tid; e < RQ * BK; e += kThreads) {
      const int r = e / BK, j = e % BK, key = j0 + j;
      float ds = 0.f;
      const float lse = lse_s[r];
      if (key >= rows_s[r].lo && key < rows_s[r].hi
          && lse != CUDART_INF_F) {
        const float s = a.scale * dot<HD>(Qs + r * LD, Ks + j * LD);
        const float dp = dot<HD>(dOs + r * LD, Vs + j * LD);
        const float p = expf(s - lse);
        ds = p * (dp - D_s[r]);
      }
      Ss[r * (BK + 1) + j] = ds;
    }
    __syncthreads();
#pragma unroll
    for (int n = 0; n < NACC; ++n) {
      const int e = tid + n * kThreads, r = e / HD, c = e % HD;
      float s = acc[n];
#pragma unroll
      for (int j = 0; j < BK; ++j)
        s = fmaf(Ss[r * (BK + 1) + j], Ks[j * LD + c], s);
      acc[n] = s;
    }
    __syncthreads();
  }
  T* dq = static_cast<T*>(a.dq);
#pragma unroll
  for (int n = 0; n < NACC; ++n) {
    const int e = tid + n * kThreads, r = e / HD, c = e % HD;
    const Row& w = rows_s[r];
    if (w.valid && c < a.hd)
      store(dq + (((int64_t)b * a.Sq + w.i) * a.H + w.h) * a.hd + c,
            a.scale * acc[n]);
  }
}

// ---------------------------------------------------------------------------
// fab_dkdv: dK and dV of one key tile over every query tile that sees it
// ---------------------------------------------------------------------------
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) fab_dkdv(BwdArgs a) {
  constexpr int RQ = Tile<HD>::RQ, BK = Tile<HD>::BK, LD = HD + 1;
  constexpr int NACC = BK * HD / kThreads;
  extern __shared__ float smem[];
  float* Ks = smem;                     // [BK][LD]
  float* Vs = Ks + BK * LD;             // [BK][LD]
  float* Qs = Vs + BK * LD;             // [RQ][LD]
  float* dOs = Qs + RQ * LD;            // [RQ][LD]
  float* Ps = dOs + RQ * LD;            // [RQ][BK + 1]
  float* dSs = Ps + RQ * (BK + 1);      // [RQ][BK + 1]
  float* lse_s = dSs + RQ * (BK + 1);   // [RQ]
  float* D_s = lse_s + RQ;              // [RQ]
  __shared__ Row rows_s[RQ];

  const int b = blockIdx.y / a.KV, kvh = blockIdx.y % a.KV;
  const int j0 = blockIdx.x * BK;
  const int j1 = min(j0 + BK, a.Sk);
  const int tid = threadIdx.x;
  const int G = a.H / a.KV;
  const int rows = a.Sq * G;
  const float inv_sk = 1.f / (float)a.Sk;
  const T* q = static_cast<const T*>(a.q);
  const T* dout = static_cast<const T*>(a.dout);

  stage<T, HD, BK>(Ks, static_cast<const T*>(a.k), a.hd,
                   [&](int j) -> int64_t {
    return j0 + j < a.Sk ? b * a.k_sb + (int64_t)(j0 + j) * a.k_ss
                           + kvh * a.k_sh : -1; });
  stage<T, HD, BK>(Vs, static_cast<const T*>(a.v), a.hd,
                   [&](int j) -> int64_t {
    return j0 + j < a.Sk ? b * a.v_sb + (int64_t)(j0 + j) * a.v_ss
                           + kvh * a.v_sh : -1; });

  float dk_acc[NACC], dv_acc[NACC];
#pragma unroll
  for (int n = 0; n < NACC; ++n) { dk_acc[n] = 0.f; dv_acc[n] = 0.f; }

  for (int r0 = 0; r0 < rows; r0 += RQ) {
    // the tile's rows: visible ranges, lse and D; does any row see a key
    // of this tile (or see none at all: uniform weights over every key)?
    int need = 0;
    if (tid < RQ) {
      const Row w = make_row(a, b, kvh, r0 + tid);
      rows_s[tid] = w;
      float lse = 0.f, D = 0.f;
      if (w.valid) {
        const int64_t idx = ((int64_t)b * a.H + w.h) * a.Sq + w.i;
        lse = a.lse[idx]; D = a.delta[idx];
        need = (lse == CUDART_INF_F) || (w.lo < j1 && w.hi > j0);
      }
      lse_s[tid] = lse; D_s[tid] = D;
    }
    if (!__syncthreads_or(need)) continue;
    stage<T, HD, RQ>(Qs, q, a.hd, [&](int r) -> int64_t {
      return rows_s[r].valid ? rows_s[r].qoff : -1; });
    stage<T, HD, RQ>(dOs, dout, a.hd, [&](int r) -> int64_t {
      return rows_s[r].valid ? rows_s[r].doff : -1; });
    __syncthreads();
    for (int e = tid; e < RQ * BK; e += kThreads) {
      const int r = e / BK, j = e % BK, key = j0 + j;
      float p = 0.f, ds = 0.f;
      const float lse = lse_s[r];
      if (key < a.Sk && r0 + r < rows) {
        if (lse == CUDART_INF_F) {
          p = inv_sk;
        } else if (key >= rows_s[r].lo && key < rows_s[r].hi) {
          const float s = a.scale * dot<HD>(Qs + r * LD, Ks + j * LD);
          const float dp = dot<HD>(dOs + r * LD, Vs + j * LD);
          p = expf(s - lse);
          ds = p * (dp - D_s[r]);
        }
      }
      Ps[r * (BK + 1) + j] = p;
      dSs[r * (BK + 1) + j] = ds;
    }
    __syncthreads();
#pragma unroll
    for (int n = 0; n < NACC; ++n) {
      const int e = tid + n * kThreads, j = e / HD, c = e % HD;
      float sv = dv_acc[n], sk = dk_acc[n];
#pragma unroll 4
      for (int r = 0; r < RQ; ++r) {
        sv = fmaf(Ps[r * (BK + 1) + j], dOs[r * LD + c], sv);
        sk = fmaf(dSs[r * (BK + 1) + j], Qs[r * LD + c], sk);
      }
      dv_acc[n] = sv; dk_acc[n] = sk;
    }
    __syncthreads();
  }
  T* dk = static_cast<T*>(a.dk);
  T* dv = static_cast<T*>(a.dv);
#pragma unroll
  for (int n = 0; n < NACC; ++n) {
    const int e = tid + n * kThreads, j = e / HD, c = e % HD;
    if (j0 + j < a.Sk && c < a.hd) {
      const int64_t off = (((int64_t)b * a.Sk + j0 + j) * a.KV + kvh)
                          * a.hd + c;
      store(dk + off, a.scale * dk_acc[n]);
      store(dv + off, dv_acc[n]);
    }
  }
}

template <typename T, int HD>
int launch(const BwdArgs& a, cudaStream_t stream) {
  constexpr int RQ = Tile<HD>::RQ, BK = Tile<HD>::BK;
  const int G = a.H / a.KV;
  const size_t dq_bytes = sizeof(float) * dq_smem_floats<HD>();
  const size_t kv_bytes = sizeof(float) * dkdv_smem_floats<HD>();
  cudaFuncSetAttribute(fab_dq<T, HD>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)dq_bytes);
  cudaFuncSetAttribute(fab_dkdv<T, HD>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)kv_bytes);
  const dim3 g1((a.Sq * G + RQ - 1) / RQ, a.B * a.KV);
  fab_dq<T, HD><<<g1, kThreads, dq_bytes, stream>>>(a);
  const cudaError_t e1 = cudaGetLastError();
  if (e1 != cudaSuccess) return (int)e1;
  const dim3 g2((a.Sk + BK - 1) / BK, a.B * a.KV);
  fab_dkdv<T, HD><<<g2, kThreads, kv_bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const BwdArgs& a, cudaStream_t s) {
  if (a.hd <= 32) return launch<T, 32>(a, s);
  if (a.hd <= 64) return launch<T, 64>(a, s);
  if (a.hd <= 128) return launch<T, 128>(a, s);
  if (a.hd <= 256) return launch<T, 256>(a, s);
  return launch<T, 576>(a, s);
}

}  // namespace fa_bwd

extern "C" {

// sizeof(BwdArgs), so the wrapper can check its ctypes mirror
int fa_backward_args_size() { return (int)sizeof(fa_bwd::BwdArgs); }

// Returns a cudaError_t (0 = launched).  dtype: q, k, v, o, do and the
// gradients (0 = fp32, 1 = bf16); 1 <= hd <= 576, H a multiple of KV.
int fa_backward(int dtype, const void* args, void* stream) {
  const fa_bwd::BwdArgs& a = *static_cast<const fa_bwd::BwdArgs*>(args);
  if (a.hd < 1 || a.hd > 576 || a.KV < 1 || a.H % a.KV)
    return (int)cudaErrorInvalidValue;
  if (a.B == 0 || a.Sq == 0 || a.Sk == 0 || a.H == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == fa_bwd::kF32) return fa_bwd::dispatch<float>(a, s);
  if (dtype == fa_bwd::kBF16) return fa_bwd::dispatch<__nv_bfloat16>(a, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
