// Reorder-free beam-decode self-attention with the in-place KV-cache write,
// written for Hopper (sm_90a).
//
// Replaces: vilmedic_tpu/ops/beam_cache_attention.py::_kernel, reached through
// `_fused_impl` / `fused_beam_cache_attention`: stage (a), and stage (b)
// `return_stats` when the stats pointers are given (no int8 cache, no fused
// prefix).
//
// What it computes, per (row n, head h): one decode step of attention for the
// beam living in row n. The keys are the cache entries K[t, group*rows + j]
// whose ancestry mask entry mask[group, r, t*rows + j] is 1 (t < index), plus
// the current step's own k_new/v_new as an analytic extra lane. This step's
// K/V is then written into the caches at t = index.
//
// What bounds it on the H100: bytes and latency, not FLOPs. A (row, head)
// reads index * D keys and values (one ancestor per t in a beam search) and
// does 4 * index * D FLOPs. At beam 8 many rows share ancestors, so much of
// the read hits L2.
//
// Design: one thread block per (row, head), four warps. Warp w walks the
// positions t = w, w + 4, ... and keeps its own online softmax (m, l, acc) in
// f32; the lanes split the head dimension (D / 32 values each) and the score
// is a warp-shuffle sum. Within a position the warp ballots the mask bytes of
// the group's slots and visits only the set ones, so masked lanes cost
// nothing; the TPU kernel's -1e9 bias gives those lanes exp(-1e9 - m) == 0 in
// f32, so skipping them gives the same numbers. Warp 0 is seeded with the
// current-step lane (m = s_cur, l = 1, acc = v_new), as the TPU kernel seeds
// its online softmax; the four warps merge through shared memory at the end.
//
// Stage (b): with m_out/l_out non-null, warp 0 also writes the per-(row, head)
// softmax max and denominator it holds after the merge, in the scaled-score
// domain, over the ancestor lanes plus the current-step lane. The prefix-LM
// decode merges them with its beam-shared prefix segment.
//
// Rounding points follow the TPU kernel: q * scale is rounded to the cache
// type for the cache dots; the current-step score uses the f32 q * scale and
// f32 k_new; p is rounded to the cache type before the PV product; l, acc and
// the output stay f32.
//
// Race freedom, by construction: a block reads cache positions t < index
// only, and writes position t == index only, at its own (row, head) slice.
// No block reads what another block writes in the same launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;

template <typename T>
__device__ __forceinline__ float to_f(T x);
template <>
__device__ __forceinline__ float to_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// float -> cache type -> float: the rounding a cast to the cache dtype makes
template <typename T>
__device__ __forceinline__ float round_to(float x);
template <>
__device__ __forceinline__ float round_to<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T, int D>
__global__ void __launch_bounds__(32 * kWarps)
    beam_cache_attention_kernel(T* __restrict__ kc, T* __restrict__ vc,
                                const T* __restrict__ q,
                                const T* __restrict__ knew,
                                const T* __restrict__ vnew,
                                const uint8_t* __restrict__ mask,
                                float* __restrict__ out, float* __restrict__ m_out,
                                float* __restrict__ l_out, int N, int H,
                                int T_len, int rows, int index, float scale) {
  constexpr int E = D / 32;  // head-dim values per lane
  const int n = blockIdx.x;
  const int h = blockIdx.y;
  const int lane = threadIdx.x;
  const int warp = threadIdx.y;
  const long long HD = (long long)H * D;
  const int group = n / rows;
  const int r = n % rows;
  const long long col = (long long)h * D + lane * E;
  const long long row_off = n * HD + col;

  float qf[E], qr[E];
  float s_cur = 0.f;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    qf[e] = to_f(q[row_off + e]) * scale;
    qr[e] = round_to<T>(qf[e]);
    s_cur += qf[e] * to_f(knew[row_off + e]);
  }
  s_cur = warp_sum(s_cur);

  float m, l, acc[E];
  if (warp == 0) {
    m = s_cur;
    l = 1.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] = to_f(vnew[row_off + e]);
  } else {
    m = -INFINITY;
    l = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] = 0.f;
  }

  const uint8_t* mrow = mask + ((long long)group * rows + r) * ((long long)T_len * rows);
  for (int t = warp; t < index; t += kWarps) {
    for (int j0 = 0; j0 < rows; j0 += 32) {
      const int j = j0 + lane;
      const bool live = j < rows && mrow[(long long)t * rows + j] != 0;
      unsigned bits = __ballot_sync(0xffffffffu, live);
      while (bits) {
        const int jj = j0 + __ffs(bits) - 1;
        bits &= bits - 1;
        const long long off = ((long long)t * N + (long long)group * rows + jj) * HD + col;
        float s = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) s += qr[e] * to_f(kc[off + e]);
        s = warp_sum(s);
        const float m_new = fmaxf(m, s);
        const float alpha = expf(m - m_new);
        const float p = expf(s - m_new);
        l = l * alpha + p;
        const float pr = round_to<T>(p);
#pragma unroll
        for (int e = 0; e < E; ++e) acc[e] = acc[e] * alpha + pr * to_f(vc[off + e]);
        m = m_new;
      }
    }
  }

  __shared__ float sm_m[kWarps];
  __shared__ float sm_l[kWarps];
  __shared__ float sm_acc[kWarps][D];
  if (lane == 0) {
    sm_m[warp] = m;
    sm_l[warp] = l;
  }
#pragma unroll
  for (int e = 0; e < E; ++e) sm_acc[warp][lane * E + e] = acc[e];
  __syncthreads();

  if (warp == 0) {
    float mx = sm_m[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w]);
    float lsum = 0.f, o[E];
#pragma unroll
    for (int e = 0; e < E; ++e) o[e] = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(sm_m[w] - mx);  // exp(-inf) == 0 for an idle warp
      lsum += sm_l[w] * c;
#pragma unroll
      for (int e = 0; e < E; ++e) o[e] += sm_acc[w][lane * E + e] * c;
    }
#pragma unroll
    for (int e = 0; e < E; ++e) out[row_off + e] = o[e] / lsum;
    if (m_out != nullptr && lane == 0) {
      m_out[(long long)n * H + h] = mx;
      l_out[(long long)n * H + h] = lsum;
    }

    // this step's K/V into the caches at t == index (never read above)
    const long long woff = ((long long)index * N + n) * HD + col;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      kc[woff + e] = knew[row_off + e];
      vc[woff + e] = vnew[row_off + e];
    }
  }
}

template <typename T>
int launch(void* kc, void* vc, const void* q, const void* knew, const void* vnew,
           const void* mask, void* out, void* m_out, void* l_out, int N, int H, int D,
           int T_len, int rows, int index, float scale, void* stream) {
  const dim3 grid(N, H);
  const dim3 block(32, kWarps);
  cudaStream_t s = (cudaStream_t)stream;
#define VT_BEAM_ATTN_CASE(DD)                                                  \
  case DD:                                                                     \
    beam_cache_attention_kernel<T, DD><<<grid, block, 0, s>>>(                 \
        (T*)kc, (T*)vc, (const T*)q, (const T*)knew, (const T*)vnew,           \
        (const uint8_t*)mask, (float*)out, (float*)m_out, (float*)l_out, N, H, \
        T_len, rows, index, scale);                                            \
    break;
  switch (D) {
    VT_BEAM_ATTN_CASE(32)
    VT_BEAM_ATTN_CASE(64)
    VT_BEAM_ATTN_CASE(128)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef VT_BEAM_ATTN_CASE
  return (int)cudaGetLastError();
}

}  // namespace

// m_out/l_out: (N, H) f32 softmax stats (stage b), or both null (stage a)
extern "C" int vt_beam_cache_attention_f32(void* kc, void* vc, const void* q,
                                           const void* knew, const void* vnew,
                                           const void* mask, void* out, void* m_out,
                                           void* l_out, int N, int H, int D,
                                           int T_len, int rows, int index,
                                           float scale, void* stream) {
  return launch<float>(kc, vc, q, knew, vnew, mask, out, m_out, l_out, N, H, D,
                       T_len, rows, index, scale, stream);
}

extern "C" int vt_beam_cache_attention_bf16(void* kc, void* vc, const void* q,
                                            const void* knew, const void* vnew,
                                            const void* mask, void* out, void* m_out,
                                            void* l_out, int N, int H, int D,
                                            int T_len, int rows, int index,
                                            float scale, void* stream) {
  return launch<__nv_bfloat16>(kc, vc, q, knew, vnew, mask, out, m_out, l_out, N,
                               H, D, T_len, rows, index, scale, stream);
}
