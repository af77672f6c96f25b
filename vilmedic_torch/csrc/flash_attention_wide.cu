// Flash attention, forward and backward, on the CUDA cores at the head dims
// no tensor-core kernel takes, wider than the 16 CTAs of Hopper's largest
// cluster split: float32 above 1024 (f32 up to 128 is flash_attention_f32.cu,
// from 129 to 1024 flash_attention_f32_split.cu) and bfloat16 above 5120
// (bf16 from 129 to 5120 is flash_attention_wide_tc.cu). Any head dim that
// is a multiple of 64.
//
// Replaces, at those head dims: vilmedic_tpu/ops/flash_attention.py::_kernel
// (forward, with `with_lse`, reached through `_flash_bhtd`) and
// ::_bwd_dq_kernel / ::_bwd_dkv_kernel (through `_flash_bwd_bhtd`): JAX's v1
// path, which takes any head dim (Mosaic pads the VMEM tile). The function,
// the rounding points and the masking are those of flash_attention.cu and
// flash_attention_bwd.cu (their header comments give the formulas):
//   out = softmax(q k^T * scale + bias, causal limit) v, lse per row;
//   dq = scale dS k, dk = scale dS^T q, dv = p^T dO, dbias = sum_r dS,
//   with p rounded to V's (dO's) dtype before P V (p^T dO), dS to K's
//   (Q's) dtype before dS K (dS^T Q), in bf16.
//
// What bounds it on the H100: the same products as the tensor-core kernels
// (at B 16, T 1370, 3 heads of 256: 92 GFLOP forward), here on the CUDA
// cores in f32 (67 TFLOP/s). It is the simple kernel that makes every head
// dim run; its times are in PERF.md.
//
// Design: 256 threads own 32 rows of one (b, h) (queries: forward, dq; keys:
// dk/dv) and one slab of at most 256 output columns (a head dim above 256
// takes several slabs, blockIdx.y = h * slabs + slab, each recomputing the
// scores). Per streamed tile of 32 rows (keys; queries for dk/dv):
//   - the scores (and dP) are summed over D in chunks of 64 columns staged
//     in shared memory as f32 (rows past T are zeros); thread t holds the 4
//     scores of its own row t / 8 against streamed rows t % 8 + 8 e, and a
//     row's 8 threads are neighbouring lanes, so its max and sums are
//     3-step shuffles;
//   - the probabilities (dS, P^T and dS^T), rounded where the plain
//     versions round, go to shared memory;
//   - the output accumulators (O; dq; dk and dv) live in shared memory as
//     f32, 32 x 256 each: per chunk of 64 output columns a thread adds the
//     products of 8 (row, column) pairs, O rescaled by the tile's alpha.
// Online softmax in the natural-log domain with expf, the running max from
// -1e9, the denominator floored at 1e-30.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace {

using namespace flash;

constexpr int kThreads = 256;
constexpr int BR = 32;     // rows a block owns (queries; keys for dk/dv)
constexpr int BT = 32;     // rows per streamed tile (keys; queries for dk/dv)
constexpr int DC = 64;     // head-dim columns per staged chunk
constexpr int LD = DC + 1; // chunk row stride (f32 words), bank-spreading
constexpr int PLD = BT + 1;
constexpr int OS = 256;    // output columns per slab

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// x rounded to T and widened back: the plain versions' rounding points
template <typename T>
__device__ __forceinline__ float round_to(float x) { return to_f32(from_f32<T>(x)); }

// max / sum over the 8 neighbouring lanes that share a row
__device__ __forceinline__ float group8_max(float x) {
#pragma unroll
  for (int o = 1; o < 8; o <<= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float group8_sum(float x) {
#pragma unroll
  for (int o = 1; o < 8; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Rows [r0, r0 + 32) x columns [c0, c0 + 64) of one head, as f32, zero past
// T. `src` points at the item's and head's first element; rows are HD apart.
template <typename T>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ src, int T_, long long HD,
                                      int r0, int c0, int tid) {
  for (int i = tid; i < BT * DC; i += kThreads) {
    const int r = i / DC, c = i % DC;
    dst[r * LD + c] = r0 + r < T_ ? to_f32(src[(r0 + r) * HD + c0 + c]) : 0.f;
  }
}

// acc[e] += a[own] . b[tid % 8 + 8 e] over one staged chunk (own = tid / 8)
__device__ __forceinline__ void dot_chunk(float (&acc)[4], const float* a, const float* b,
                                          int tid) {
  const float* ar = a + (tid / 8) * LD;
  const float* br = b + (tid % 8) * LD;
#pragma unroll 8
  for (int d = 0; d < DC; ++d) {
    const float x = ar[d];
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[e] = fmaf(x, br[8 * e * LD + d], acc[e]);
  }
}

// acc[r][col0 + c] = acc[r][col0 + c] * alpha[r] (alpha null: 1) +
// sum_j p[r][j] x[j][c] for the 32 x 64 pairs of one staged chunk x
__device__ __forceinline__ void accumulate_chunk(float* acc, int col0, const float* p,
                                                 const float* x, const float* alpha, int tid) {
  const int c = tid % DC;
#pragma unroll
  for (int e = 0; e < BR / 4; ++e) {
    const int r = tid / DC + 4 * e;
    float s = 0.f;
#pragma unroll 8
    for (int j = 0; j < BT; ++j) s = fmaf(p[r * PLD + j], x[j * LD + c], s);
    float* at = acc + r * OS + col0 + c;
    *at = (alpha != nullptr ? *at * alpha[r] : *at) + s;
  }
}

// shared-memory words of each kernel
constexpr int kChunk = BT * LD;
constexpr int kFwdWords = 2 * kChunk + BR * PLD + BR + BT + BR * OS;
constexpr int kDqWords = 4 * kChunk + BR * PLD + BT + BR * OS;
constexpr int kDkvWords = 4 * kChunk + 2 * BR * PLD + 2 * BT + 2 * BR * OS;

// ------------------------------------------------------------------ forward
template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_wide(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   const float* __restrict__ bias, T* __restrict__ o, float* __restrict__ lse,
                   int Tq, int Tk, int H, int D, int slabs, int causal, float scale) {
  extern __shared__ float sm[];
  float* qc = sm;               // Q chunk
  float* kc = qc + kChunk;      // K chunk, then V chunk
  float* ps = kc + kChunk;      // P (BR x PLD)
  float* alpha_s = ps + BR * PLD;
  float* bs = alpha_s + BR;     // the tile's key bias
  float* os = bs + BT;          // O accumulator (BR x OS)
  const int q0 = blockIdx.x * BR, h = blockIdx.y / slabs, slab = blockIdx.y % slabs;
  const int b = blockIdx.z;
  const int s0 = slab * OS, sw = min(OS, D - s0);
  const int tid = threadIdx.x, own = tid / 8, o8 = tid % 8;
  const int row = q0 + own;
  const int off = Tk - Tq;
  const long long HD = (long long)H * D;
  const T* qb = q + (long long)b * Tq * HD + (long long)h * D;
  const T* kb = k + (long long)b * Tk * HD + (long long)h * D;
  const T* vb = v + (long long)b * Tk * HD + (long long)h * D;
  for (int i = tid; i < BR * OS; i += kThreads) os[i] = 0.f;
  float m = kMaskValue, l = 0.f;

  const int n_tiles = key_tiles(q0, BR, Tq, Tk, BT, causal);
  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * BT;
    float s[4] = {0.f, 0.f, 0.f, 0.f};
    for (int c0 = 0; c0 < D; c0 += DC) {
      stage(qc, qb, Tq, HD, q0, c0, tid);
      stage(kc, kb, Tk, HD, k0, c0, tid);
      if (c0 == 0 && tid < BT)
        bs[tid] = (bias != nullptr && k0 + tid < Tk) ? bias[(long long)b * Tk + k0 + tid] : 0.f;
      __syncthreads();
      dot_chunk(s, qc, kc, tid);
      __syncthreads();
    }
    float mx = m;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = k0 + o8 + 8 * e;
      float x = s[e] * scale + bs[o8 + 8 * e];
      if (causal && c > row + off) x = kMaskValue;
      if (c >= Tk) x = -INFINITY;
      s[e] = x;
      mx = fmaxf(mx, x);
    }
    mx = group8_max(mx);
    const float alpha = expf(m - mx);
    m = mx;
    float psum = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = expf(s[e] - m);
      psum += p;
      ps[own * PLD + o8 + 8 * e] = round_to<T>(p);  // p in V's dtype before P V
    }
    l = l * alpha + psum;
    if (o8 == 0) alpha_s[own] = alpha;
    __syncthreads();
    for (int c0 = s0; c0 < s0 + sw; c0 += DC) {
      stage(kc, vb, Tk, HD, k0, c0, tid);
      __syncthreads();
      accumulate_chunk(os, c0 - s0, ps, kc, alpha_s, tid);
      __syncthreads();
    }
  }

  l = group8_sum(l);
  const float den = fmaxf(l, 1e-30f);
  if (o8 == 0) {
    alpha_s[own] = den;
    if (lse != nullptr && slab == 0 && row < Tq)
      lse[((long long)b * H + h) * Tq + row] = m + logf(den);
  }
  __syncthreads();
  T* ob = o + (long long)b * Tq * HD + (long long)h * D + s0;
  for (int i = tid; i < BR * sw; i += kThreads) {
    const int r = i / sw, c = i % sw;
    if (q0 + r < Tq) ob[(q0 + r) * HD + c] = from_f32<T>(os[r * OS + c] / alpha_s[r]);
  }
}

// ------------------------------------------------------------------------ dq
template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_wide(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      const float* __restrict__ bias, const T* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      T* __restrict__ dq, int Tq, int Tk, int H, int D, int slabs, int causal,
                      float scale) {
  extern __shared__ float sm[];
  float* qc = sm;
  float* kc = qc + kChunk;   // K chunk (scores, then dS K)
  float* dc = kc + kChunk;   // dO chunk
  float* vc = dc + kChunk;   // V chunk
  float* dss = vc + kChunk;  // dS (BR x PLD)
  float* bs = dss + BR * PLD;
  float* acc = bs + BT;      // dq accumulator (BR x OS)
  const int q0 = blockIdx.x * BR, h = blockIdx.y / slabs, slab = blockIdx.y % slabs;
  const int b = blockIdx.z;
  const int s0 = slab * OS, sw = min(OS, D - s0);
  const int tid = threadIdx.x, own = tid / 8, o8 = tid % 8;
  const int row = q0 + own;
  const int off = Tk - Tq;
  const long long HD = (long long)H * D;
  const long long qoff = (long long)b * Tq * HD + (long long)h * D;
  const long long koff = (long long)b * Tk * HD + (long long)h * D;
  const long long soff = ((long long)b * H + h) * Tq + row;
  const float lse_r = row < Tq ? lse[soff] : 0.f;
  const float delta_r = row < Tq ? delta[soff] : 0.f;
  for (int i = tid; i < BR * OS; i += kThreads) acc[i] = 0.f;

  const int n_tiles = key_tiles(q0, BR, Tq, Tk, BT, causal);
  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * BT;
    float s[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f};
    for (int c0 = 0; c0 < D; c0 += DC) {
      stage(qc, q + qoff, Tq, HD, q0, c0, tid);
      stage(kc, k + koff, Tk, HD, k0, c0, tid);
      stage(dc, dout + qoff, Tq, HD, q0, c0, tid);
      stage(vc, v + koff, Tk, HD, k0, c0, tid);
      if (c0 == 0 && tid < BT)
        bs[tid] = (bias != nullptr && k0 + tid < Tk) ? bias[(long long)b * Tk + k0 + tid] : 0.f;
      __syncthreads();
      dot_chunk(s, qc, kc, tid);
      dot_chunk(dp, dc, vc, tid);
      __syncthreads();
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = k0 + o8 + 8 * e;
      float x = s[e] * scale + bs[o8 + 8 * e];
      if (causal && c > row + off) x = kMaskValue;
      const float p = c < Tk ? expf(x - lse_r) : 0.f;
      dss[own * PLD + o8 + 8 * e] = round_to<T>(p * (dp[e] - delta_r));  // dS in K's dtype
    }
    __syncthreads();
    for (int c0 = s0; c0 < s0 + sw; c0 += DC) {
      stage(kc, k + koff, Tk, HD, k0, c0, tid);
      __syncthreads();
      accumulate_chunk(acc, c0 - s0, dss, kc, nullptr, tid);
      __syncthreads();
    }
  }

  T* out = dq + qoff + s0;
  for (int i = tid; i < BR * sw; i += kThreads) {
    const int r = i / sw, c = i % sw;
    if (q0 + r < Tq) out[(q0 + r) * HD + c] = from_f32<T>(acc[r * OS + c] * scale);
  }
}

// -------------------------------------------------------------------- dk / dv
template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_wide(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                       const float* __restrict__ bias, const T* __restrict__ dout,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       T* __restrict__ dk, T* __restrict__ dv, float* __restrict__ dbias, int Tq,
                       int Tk, int H, int D, int slabs, int causal, float scale) {
  extern __shared__ float sm[];
  float* kc = sm;
  float* qc = kc + kChunk;   // Q chunk (scores, then dS^T Q)
  float* vc = qc + kChunk;
  float* dc = vc + kChunk;   // dO chunk (scores, then P^T dO)
  float* pts = dc + kChunk;  // P^T (BR x PLD)
  float* dst = pts + BR * PLD;  // dS^T
  float* ls = dst + BR * PLD;   // the tile's lse; +inf past Tq (p = 0)
  float* dls = ls + BT;         // and delta
  float* acc_k = dls + BT;      // dk, dv accumulators (BR x OS each)
  float* acc_v = acc_k + BR * OS;
  const int k0 = blockIdx.x * BR, h = blockIdx.y / slabs, slab = blockIdx.y % slabs;
  const int b = blockIdx.z;
  const int s0 = slab * OS, sw = min(OS, D - s0);
  const int tid = threadIdx.x, own = tid / 8, o8 = tid % 8;
  const int key = k0 + own;
  const int off = Tk - Tq;
  const long long HD = (long long)H * D;
  const long long qoff = (long long)b * Tq * HD + (long long)h * D;
  const long long koff = (long long)b * Tk * HD + (long long)h * D;
  const float* lb = lse + ((long long)b * H + h) * Tq;
  const float* db = delta + ((long long)b * H + h) * Tq;
  const bool real = key < Tk;
  const float bias_k = (bias != nullptr && real) ? bias[(long long)b * Tk + key] : 0.f;
  for (int i = tid; i < 2 * BR * OS; i += kThreads) acc_k[i] = 0.f;
  float dbs = 0.f;

  const int n_q = (Tq + BT - 1) / BT;
  for (int jt = first_query_tile(k0, Tq, Tk, BT, causal); jt < n_q; ++jt) {
    const int rq0 = jt * BT;
    float st[4] = {0.f, 0.f, 0.f, 0.f}, dpt[4] = {0.f, 0.f, 0.f, 0.f};
    for (int c0 = 0; c0 < D; c0 += DC) {
      stage(kc, k + koff, Tk, HD, k0, c0, tid);
      stage(qc, q + qoff, Tq, HD, rq0, c0, tid);
      stage(vc, v + koff, Tk, HD, k0, c0, tid);
      stage(dc, dout + qoff, Tq, HD, rq0, c0, tid);
      if (c0 == 0 && tid < BT) {
        const int r = rq0 + tid;
        ls[tid] = r < Tq ? lb[r] : INFINITY;
        dls[tid] = r < Tq ? db[r] : 0.f;
      }
      __syncthreads();
      dot_chunk(st, kc, qc, tid);
      dot_chunk(dpt, vc, dc, tid);
      __syncthreads();
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = o8 + 8 * e;
      float x = st[e] * scale + bias_k;
      if (causal && key > rq0 + i + off) x = kMaskValue;
      const float p = real ? expf(x - ls[i]) : 0.f;
      const float ds = p * (dpt[e] - dls[i]);
      dbs += ds;
      pts[own * PLD + i] = round_to<T>(p);   // p in dO's dtype before P^T dO
      dst[own * PLD + i] = round_to<T>(ds);  // dS in Q's dtype before dS^T Q
    }
    __syncthreads();
    for (int c0 = s0; c0 < s0 + sw; c0 += DC) {
      stage(dc, dout + qoff, Tq, HD, rq0, c0, tid);
      stage(qc, q + qoff, Tq, HD, rq0, c0, tid);
      __syncthreads();
      accumulate_chunk(acc_v, c0 - s0, pts, dc, nullptr, tid);
      accumulate_chunk(acc_k, c0 - s0, dst, qc, nullptr, tid);
      __syncthreads();
    }
  }

  dbs = group8_sum(dbs);
  if (slab == 0 && o8 == 0 && real) dbias[((long long)b * H + h) * Tk + key] = dbs;
  T* dko = dk + koff + s0;
  T* dvo = dv + koff + s0;
  for (int i = tid; i < BR * sw; i += kThreads) {
    const int r = i / sw, c = i % sw;
    if (k0 + r < Tk) {
      dko[(k0 + r) * HD + c] = from_f32<T>(acc_k[r * OS + c] * scale);
      dvo[(k0 + r) * HD + c] = from_f32<T>(acc_v[r * OS + c]);
    }
  }
}

// the grid of a wide kernel over `rows` rows a block; 0 if out of range
bool wide_grid(dim3& grid, int rows, int B, int H, int D, int& slabs) {
  slabs = (D + OS - 1) / OS;
  if (B <= 0 || rows <= 0 || H <= 0 || D <= 0 || D % DC != 0 || B > 65535 ||
      (long long)H * slabs > 65535)
    return false;
  grid = dim3((rows + BR - 1) / BR, H * slabs, B);
  return true;
}

template <typename Kernel>
int allow_smem(Kernel kernel, int words, bool (&done)[hopper::kMaxDevices]) {
  return hopper::allow_dynamic_smem((const void*)kernel, words * 4, done);
}

template <typename T>
int launch_fwd(const void* q, const void* k, const void* v, const void* bias, void* o, void* lse,
               int B, int Tq, int Tk, int H, int D, int causal, float scale, cudaStream_t s) {
  dim3 grid;
  int slabs = 0;
  if (Tk <= 0 || !wide_grid(grid, Tq, B, H, D, slabs)) return (int)cudaErrorInvalidValue;
  static bool done[hopper::kMaxDevices] = {};
  int st = allow_smem(flash_fwd_wide<T>, kFwdWords, done);
  if (st != 0) return st;
  flash_fwd_wide<T><<<grid, kThreads, kFwdWords * 4, s>>>(
      (const T*)q, (const T*)k, (const T*)v, (const float*)bias, (T*)o, (float*)lse, Tq, Tk, H,
      D, slabs, causal, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dq(const void* q, const void* k, const void* v, const void* bias, const void* dout,
              const void* lse, const void* delta, void* dq, int B, int Tq, int Tk, int H, int D,
              int causal, float scale, cudaStream_t s) {
  dim3 grid;
  int slabs = 0;
  if (Tk <= 0 || !wide_grid(grid, Tq, B, H, D, slabs)) return (int)cudaErrorInvalidValue;
  static bool done[hopper::kMaxDevices] = {};
  int st = allow_smem(flash_bwd_dq_wide<T>, kDqWords, done);
  if (st != 0) return st;
  flash_bwd_dq_wide<T><<<grid, kThreads, kDqWords * 4, s>>>(
      (const T*)q, (const T*)k, (const T*)v, (const float*)bias, (const T*)dout,
      (const float*)lse, (const float*)delta, (T*)dq, Tq, Tk, H, D, slabs, causal, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dkv(const void* q, const void* k, const void* v, const void* bias, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv, void* dbias, int B,
               int Tq, int Tk, int H, int D, int causal, float scale, cudaStream_t s) {
  dim3 grid;
  int slabs = 0;
  if (Tq <= 0 || !wide_grid(grid, Tk, B, H, D, slabs)) return (int)cudaErrorInvalidValue;
  static bool done[hopper::kMaxDevices] = {};
  int st = allow_smem(flash_bwd_dkv_wide<T>, kDkvWords, done);
  if (st != 0) return st;
  flash_bwd_dkv_wide<T><<<grid, kThreads, kDkvWords * 4, s>>>(
      (const T*)q, (const T*)k, (const T*)v, (const float*)bias, (const T*)dout,
      (const float*)lse, (const float*)delta, (T*)dk, (T*)dv, (float*)dbias, Tq, Tk, H, D, slabs,
      causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// As vt_flash_attention_f32 (flash_attention_f32.cu); D any multiple of 64.
extern "C" int vt_flash_attention_wide(const void* q, const void* k, const void* v,
                                       const void* bias, void* o, void* lse, int B, int Tq,
                                       int Tk, int H, int D, int causal, float scale,
                                       void* stream) {
  return launch_fwd<float>(q, k, v, bias, o, lse, B, Tq, Tk, H, D, causal, scale,
                           (cudaStream_t)stream);
}

// As vt_flash_attention_bwd_dq_f32 (flash_attention_f32.cu).
extern "C" int vt_flash_attention_bwd_dq_wide(const void* q, const void* k, const void* v,
                                              const void* bias, const void* dout,
                                              const void* lse, const void* delta, void* dq,
                                              int B, int Tq, int Tk, int H, int D, int causal,
                                              float scale, void* stream) {
  return launch_dq<float>(q, k, v, bias, dout, lse, delta, dq, B, Tq, Tk, H, D, causal, scale,
                          (cudaStream_t)stream);
}

// As vt_flash_attention_bwd_dkv_f32 (flash_attention_f32.cu).
extern "C" int vt_flash_attention_bwd_dkv_wide(const void* q, const void* k, const void* v,
                                               const void* bias, const void* dout,
                                               const void* lse, const void* delta, void* dk,
                                               void* dv, void* dbias, int B, int Tq, int Tk,
                                               int H, int D, int causal, float scale,
                                               void* stream) {
  return launch_dkv<float>(q, k, v, bias, dout, lse, delta, dk, dv, dbias, B, Tq, Tk, H, D,
                           causal, scale, (cudaStream_t)stream);
}

// The same three in bfloat16 (operands, out, dq, dk, dv), for heads wider
// than a cluster of flash_attention_wide_tc.cu splits.
extern "C" int vt_flash_attention_wide_bf16(const void* q, const void* k, const void* v,
                                            const void* bias, void* o, void* lse, int B, int Tq,
                                            int Tk, int H, int D, int causal, float scale,
                                            void* stream) {
  return launch_fwd<__nv_bfloat16>(q, k, v, bias, o, lse, B, Tq, Tk, H, D, causal, scale,
                                   (cudaStream_t)stream);
}

extern "C" int vt_flash_attention_bwd_dq_wide_bf16(const void* q, const void* k, const void* v,
                                                   const void* bias, const void* dout,
                                                   const void* lse, const void* delta, void* dq,
                                                   int B, int Tq, int Tk, int H, int D,
                                                   int causal, float scale, void* stream) {
  return launch_dq<__nv_bfloat16>(q, k, v, bias, dout, lse, delta, dq, B, Tq, Tk, H, D, causal,
                                  scale, (cudaStream_t)stream);
}

extern "C" int vt_flash_attention_bwd_dkv_wide_bf16(const void* q, const void* k, const void* v,
                                                    const void* bias, const void* dout,
                                                    const void* lse, const void* delta, void* dk,
                                                    void* dv, void* dbias, int B, int Tq, int Tk,
                                                    int H, int D, int causal, float scale,
                                                    void* stream) {
  return launch_dkv<__nv_bfloat16>(q, k, v, bias, dout, lse, delta, dk, dv, dbias, B, Tq, Tk, H,
                                   D, causal, scale, (cudaStream_t)stream);
}
