// Reorder-free beam-decode self-attention with the in-place KV-cache write,
// written for Hopper (sm_90a).
//
// Replaces: vilmedic_tpu/ops/beam_cache_attention.py::_kernel, reached through
// `_fused_impl` / `fused_beam_cache_attention`, all four stages:
//   (a) the plain step;
//   (b) `return_stats`: the softmax max and denominator, when the stats
//       pointers are given;
//   (c) `kv_scales`: int8 caches with per-lane K/V scales;
//   (d) `prefix`: a beam-shared prefix K/V streamed through the same online
//       softmax.
// (c) and (d) exclude each other, as in the JAX package.
//
// What it computes, per (row n, head h): one decode step of attention for the
// beam living in row n. The keys are the cache entries K[t, group*rows + j]
// whose ancestry mask entry mask[group, r, t*rows + j] is 1 (t < index), plus
// the current step's own k_new/v_new as an analytic extra lane, plus in stage
// (d) the first p_real prefix keys of item n / beams. This step's K/V is then
// written into the caches at t = index.
//
// What bounds it on the H100: bytes and latency, not FLOPs. A (row, head)
// reads index * D keys and values (one ancestor per t in a beam search) and
// does 4 * index * D FLOPs. At beam 8 many rows share ancestors, so much of
// the read hits L2. Stage (c) halves (bf16) or quarters (f32) the cache bytes.
// Stage (d) adds the prefix: at the VisionLanguage decode shape (batch 16,
// P 1370, H*D 768, bf16) one layer's prefix K/V is 16*1370*768*2 B*2 = 67 MB,
// 20 us at 3.35 TB/s if read once. Here every (row, head) block reads its own
// item's prefix, so the 8 beams of an item read it 8 times (537 MB, 160 us
// if none of the re-reads hit the 50 MB L2). The 8 blocks of an item and head
// are launched next to each other (blockIdx.x = row), so they stream the
// same prefix at about the same time and most re-reads should come from L2.
// One block per (item, head) sharing prefix tiles in shared memory would
// remove the re-read; that is later work.
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
// In stage (d) each warp first walks prefix keys p = 4w .. 4w + 3, then
// p + 16, ...: four independent dot products per iteration, one online
// softmax update for the four, then the ancestor lanes as above. Keys past
// p_real are never read: the kernel masks its own ragged tail.
//
// Stage (b): with m_out/l_out non-null, warp 0 also writes the per-(row, head)
// softmax max and denominator it holds after the merge, in the scaled-score
// domain, over every key attended. The prefix-LM decode merges them with its
// beam-shared prefix segment.
//
// Rounding points follow the TPU kernel. Stages (a), (b), (d): q * scale is
// rounded to the cache type for the cache and prefix dots; the current-step
// score uses the f32 q * scale and f32 k_new; p is rounded to the cache type
// before the PV product; l, acc and the output stay f32. Stage (c): the
// caches are int8 and q/k_new/v_new keep their own type (f32 or bf16); the
// per-lane K scale folds into the query, (q * scale)_f32 * ks rounded once to
// q's type; p is rounded to q's type; the V scale factors out of the whole
// accumulation: acc is seeded with v_new / vs and the output is
// (acc / l) * vs. This step's K/V are written as
// int8(clamp(rint(x / s), -127, 127)): rint rounds half to even, as
// jnp.round does, and the division is IEEE (no fast math in the build).
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
constexpr int kKeys = 4;  // prefix keys per warp iteration (stage d)

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
template <>
__device__ __forceinline__ float to_f<int8_t>(int8_t x) {
  return (float)x;
}

// float -> T -> float: the rounding a cast to dtype T makes
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

__device__ __forceinline__ int8_t quantize(float x, float s) {
  return (int8_t)fminf(fmaxf(rintf(x / s), -127.f), 127.f);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Q: the type of q/k_new/v_new (float or bf16). C: the caches' type (Q, or
// int8_t when QUANT). PREFIX: stage (d), pk/pv in type C.
template <typename Q, typename C, int D, bool QUANT, bool PREFIX>
__global__ void __launch_bounds__(32 * kWarps)
    beam_cache_attention_kernel(C* __restrict__ kc, C* __restrict__ vc,
                                const Q* __restrict__ q,
                                const Q* __restrict__ knew,
                                const Q* __restrict__ vnew,
                                const uint8_t* __restrict__ mask,
                                const float* __restrict__ kv_scales,
                                const C* __restrict__ pk, const C* __restrict__ pv,
                                float* __restrict__ out, float* __restrict__ m_out,
                                float* __restrict__ l_out, int N, int H, int T_len,
                                int rows, int index, int P, int p_real, int beams,
                                float scale) {
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

  float ks[E], vs[E];
  if constexpr (QUANT) {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      ks[e] = kv_scales[col + e];
      vs[e] = kv_scales[HD + col + e];
    }
  }
  float qd[E];
  float s_cur = 0.f;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const float qf = to_f(q[row_off + e]) * scale;
    s_cur += qf * to_f(knew[row_off + e]);
    if constexpr (QUANT) {
      qd[e] = round_to<Q>(qf * ks[e]);
    } else {
      qd[e] = round_to<C>(qf);
    }
  }
  s_cur = warp_sum(s_cur);

  float m, l, acc[E];
  if (warp == 0) {
    m = s_cur;
    l = 1.f;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      if constexpr (QUANT) {
        acc[e] = to_f(vnew[row_off + e]) / vs[e];
      } else {
        acc[e] = to_f(vnew[row_off + e]);
      }
    }
  } else {
    m = -INFINITY;
    l = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] = 0.f;
  }

  if constexpr (PREFIX) {
    const long long base = (long long)(n / beams) * P * HD + col;
    const C* pkr = pk + base;
    const C* pvr = pv + base;
    // p0 is the same for every lane of a warp: the shuffles stay uniform
    for (int p0 = warp * kKeys; p0 < p_real; p0 += kWarps * kKeys) {
      float s[kKeys];
#pragma unroll
      for (int i = 0; i < kKeys; ++i) {
        s[i] = 0.f;
        if (p0 + i < p_real) {
          const C* kr = pkr + (long long)(p0 + i) * HD;
#pragma unroll
          for (int e = 0; e < E; ++e) s[i] += qd[e] * to_f(kr[e]);
        }
      }
#pragma unroll
      for (int i = 0; i < kKeys; ++i) s[i] = warp_sum(s[i]);
      float m_new = m;
#pragma unroll
      for (int i = 0; i < kKeys; ++i)
        if (p0 + i < p_real) m_new = fmaxf(m_new, s[i]);
      const float alpha = expf(m - m_new);
      l *= alpha;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[e] *= alpha;
#pragma unroll
      for (int i = 0; i < kKeys; ++i) {
        if (p0 + i < p_real) {
          const float p = expf(s[i] - m_new);
          l += p;
          const float pr = round_to<Q>(p);
          const C* vr = pvr + (long long)(p0 + i) * HD;
#pragma unroll
          for (int e = 0; e < E; ++e) acc[e] += pr * to_f(vr[e]);
        }
      }
      m = m_new;
    }
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
        for (int e = 0; e < E; ++e) s += qd[e] * to_f(kc[off + e]);
        s = warp_sum(s);
        const float m_new = fmaxf(m, s);
        const float alpha = expf(m - m_new);
        const float p = expf(s - m_new);
        l = l * alpha + p;
        const float pr = round_to<Q>(p);
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
    for (int e = 0; e < E; ++e) {
      if constexpr (QUANT) {
        out[row_off + e] = o[e] / lsum * vs[e];
      } else {
        out[row_off + e] = o[e] / lsum;
      }
    }
    if (m_out != nullptr && lane == 0) {
      m_out[(long long)n * H + h] = mx;
      l_out[(long long)n * H + h] = lsum;
    }

    // this step's K/V into the caches at t == index (never read above)
    const long long woff = ((long long)index * N + n) * HD + col;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      if constexpr (QUANT) {
        kc[woff + e] = quantize(to_f(knew[row_off + e]), ks[e]);
        vc[woff + e] = quantize(to_f(vnew[row_off + e]), vs[e]);
      } else {
        kc[woff + e] = knew[row_off + e];
        vc[woff + e] = vnew[row_off + e];
      }
    }
  }
}

struct Args {
  void *kc, *vc;
  const void *q, *knew, *vnew, *mask, *kv_scales, *pk, *pv;
  void *out, *m_out, *l_out;
  int N, H, T_len, rows, index, P, p_real, beams;
  float scale;
  cudaStream_t stream;
};

template <typename Q, typename C, int D, bool QUANT, bool PREFIX>
void run(const Args& a) {
  beam_cache_attention_kernel<Q, C, D, QUANT, PREFIX>
      <<<dim3(a.N, a.H), dim3(32, kWarps), 0, a.stream>>>(
          (C*)a.kc, (C*)a.vc, (const Q*)a.q, (const Q*)a.knew, (const Q*)a.vnew,
          (const uint8_t*)a.mask, (const float*)a.kv_scales, (const C*)a.pk,
          (const C*)a.pv, (float*)a.out, (float*)a.m_out, (float*)a.l_out, a.N, a.H,
          a.T_len, a.rows, a.index, a.P, a.p_real, a.beams, a.scale);
}

template <typename Q, int D>
void run_stage(const Args& a) {
  if (a.kv_scales != nullptr) {
    run<Q, int8_t, D, true, false>(a);
  } else if (a.pk != nullptr) {
    run<Q, Q, D, false, true>(a);
  } else {
    run<Q, Q, D, false, false>(a);
  }
}

template <typename Q>
int launch(const Args& a, int D) {
  if (a.kv_scales != nullptr && a.pk != nullptr) return (int)cudaErrorInvalidValue;
  if (a.pk != nullptr && (a.beams <= 0 || a.p_real <= 0 || a.p_real > a.P))
    return (int)cudaErrorInvalidValue;
  switch (D) {
    case 32:
      run_stage<Q, 32>(a);
      break;
    case 64:
      run_stage<Q, 64>(a);
      break;
    case 128:
      run_stage<Q, 128>(a);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// The suffix names the type of q/k_new/v_new. The caches are in that type,
// or int8 when kv_scales ((2, H*D) f32, stage c) is non-null. pk/pv: the
// (B, P, H*D) prefix in the caches' type (stage d), or both null. m_out/l_out:
// (N, H) f32 softmax stats (stage b), or both null.
#define VT_BEAM_ATTN_ENTRY(NAME, Q)                                                \
  extern "C" int NAME(void* kc, void* vc, const void* q, const void* knew,         \
                      const void* vnew, const void* mask, const void* kv_scales,   \
                      const void* pk, const void* pv, void* out, void* m_out,      \
                      void* l_out, int N, int H, int D, int T_len, int rows,       \
                      int index, int P, int p_real, int beams, float scale,        \
                      void* stream) {                                              \
    const Args a{kc,    vc,    q,      knew,  vnew,  mask,  kv_scales, pk,         \
                 pv,    out,   m_out,  l_out, N,     H,     T_len,     rows,       \
                 index, P,     p_real, beams, scale, (cudaStream_t)stream};        \
    return launch<Q>(a, D);                                                        \
  }

VT_BEAM_ATTN_ENTRY(vt_beam_cache_attention_f32, float)
VT_BEAM_ATTN_ENTRY(vt_beam_cache_attention_bf16, __nv_bfloat16)

#undef VT_BEAM_ATTN_ENTRY
