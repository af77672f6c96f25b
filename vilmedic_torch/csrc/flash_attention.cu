// Flash attention forward (tiled online softmax), written for Hopper (sm_90a).
//
// Replaces: vilmedic_tpu/ops/flash_attention.py::_kernel_v2 (reached through
// `_flash_bthd`, the (B, T, H*D) layout) and ::_kernel (through `_flash_bhtd`,
// the (B*H, T, D) layout). The two differ only in how they lay heads out on
// the TPU's 128 lanes; one kernel covers both. The per-row log-sum-exp the
// TPU forward saves for its backward is not written (no backward yet).
//
// What it computes, per (batch b, head h, query row r):
//   s[c]  = (q[r] . k[c]) * scale + bias[b, c]      f32, over keys c < Tk
//   s[c]  = -1e9 where causal and c > r + Tk - Tq   (replaced, as the TPU does)
//   out[r] = sum_c exp(s[c] - m) v[c] / max(sum_c exp(s[c] - m), 1e-30)
// with the running max m starting at -1e9. q, k, v are read in place from the
// (B, T, H*D) layout through the head stride; out is written in q's dtype.
//
// What bounds it on the H100: at the VisionLanguage shapes (B 16, T 1370,
// H 12, D 64) one call is 4 * B * H * Tq * Tk * D = 92 GFLOP against 54 MB
// of q, k, v and out, so the tensor cores (bf16) or the FMA units (f32) bound
// it, not memory: K and V tiles are re-read from L2 by every query tile.
//
// Design, kept simple first (no TMA, no wgmma, no warp specialisation):
//   - bf16: one block of 4 warps owns a (b, h, 64-query) tile; each warp owns
//     16 query rows whose Q fragments stay in registers. The block loops over
//     64-key tiles of K and V staged in shared memory. S = Q K^T and O += P V
//     are mma.sync m16n8k16 bf16 products with f32 accumulation; the S
//     accumulators are reused in registers as the A operand of P V (rounded
//     to bf16 there, as the TPU rounds p to V's dtype), so S never leaves the
//     registers. Online softmax in f32: each quad of lanes shares a row, its
//     max is a two-step shuffle, its denominator a per-lane partial summed at
//     the end.
//   - f32: CUDA-core FMA, no TF32 (its 10-bit mantissa would break f32
//     parity). One block of 256 threads owns 64 query rows, 4 threads per
//     row, each holding a quarter of the head dimension (strided, so the
//     four read neighbouring shared-memory words); the score is a quad
//     shuffle sum, and the key tiles are 32 wide.
//   - Causal: key tiles wholly above the diagonal of the block's last row are
//     never loaded; the others mask per element.
//   - The ragged last key tile is masked in the kernel (keys >= Tk get
//     exp(-inf) = 0 and zero V), and query rows >= Tq are computed on zero Q
//     and not stored; the wrapper pads nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kMaskValue = -1e9f;  // the TPU kernel's finite mask value
constexpr int BQ = 64;               // query rows per block

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// d += a (16x16, row-major) * b (16x8, column-major), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Number of key tiles a block visits: all of them, or under the causal mask
// those up to the one holding the last key its last real row may see.
__device__ __forceinline__ int key_tiles(int q0, int Tq, int Tk, int bk, int causal) {
  int n = (Tk + bk - 1) / bk;
  if (causal) {
    const int last_key = min(q0 + BQ, Tq) - 1 + (Tk - Tq);
    n = last_key < 0 ? 0 : min(n, last_key / bk + 1);
  }
  return n;
}

// ------------------------------------------------------------------ bf16 path
template <int D>
__global__ void __launch_bounds__(128)
    flash_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          const float* __restrict__ bias, __nv_bfloat16* __restrict__ o,
                          int Tq, int Tk, int H, int causal, float scale) {
  constexpr int BK = 64;
  constexpr int LD = D + 8;  // shared row stride (bf16): 16-byte rows, no bank conflicts
  constexpr int KC = D / 16; // k-steps of Q K^T
  constexpr int DN = D / 8;  // 8-wide output column tiles
  constexpr int NT = BK / 8; // 8-key score tiles
  __shared__ __align__(16) __nv_bfloat16 ks[BK * LD];
  __shared__ __align__(16) __nv_bfloat16 vs[BK * LD];
  __shared__ float bs[BK];

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;   // fragment row group
  const int t4 = lane % 4;  // position in the quad
  const long long HD = (long long)H * D;
  const int off = Tk - Tq;
  const __nv_bfloat16* qb = q + (long long)b * Tq * HD + (long long)h * D;
  const __nv_bfloat16* kb = k + (long long)b * Tk * HD + (long long)h * D;
  const __nv_bfloat16* vb = v + (long long)b * Tk * HD + (long long)h * D;
  const int r0 = q0 + warp * 16 + g;  // this lane's two rows
  const int r1 = r0 + 8;

  uint32_t qa[KC][4];
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
    const int c = kc * 16 + t4 * 2;
    qa[kc][0] = r0 < Tq ? ld_u32(qb + r0 * HD + c) : 0u;
    qa[kc][1] = r1 < Tq ? ld_u32(qb + r1 * HD + c) : 0u;
    qa[kc][2] = r0 < Tq ? ld_u32(qb + r0 * HD + c + 8) : 0u;
    qa[kc][3] = r1 < Tq ? ld_u32(qb + r1 * HD + c + 8) : 0u;
  }

  float acc[DN][4];
#pragma unroll
  for (int dn = 0; dn < DN; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dn][e] = 0.f;
  float m0 = kMaskValue, m1 = kMaskValue;  // running row maxima
  float l0 = 0.f, l1 = 0.f;                // this lane's part of the denominators

  const int n_tiles = key_tiles(q0, Tq, Tk, BK, causal);
  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * BK;
    for (int i = tid; i < BK * D / 8; i += 128) {
      const int r = i / (D / 8);
      const int c = (i % (D / 8)) * 8;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
      if (k0 + r < Tk) {
        kv = *reinterpret_cast<const uint4*>(kb + (k0 + r) * HD + c);
        vv = *reinterpret_cast<const uint4*>(vb + (k0 + r) * HD + c);
      }
      *reinterpret_cast<uint4*>(ks + r * LD + c) = kv;
      *reinterpret_cast<uint4*>(vs + r * LD + c) = vv;
    }
    if (tid < BK)
      bs[tid] = (bias != nullptr && k0 + tid < Tk) ? bias[(long long)b * Tk + k0 + tid] : 0.f;
    __syncthreads();

    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        const __nv_bfloat16* kr = ks + (j * 8 + g) * LD + kc * 16 + t4 * 2;
        mma_bf16(s[j], qa[kc], ld_u32(kr), ld_u32(kr + 8));
      }
    }

    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kk = j * 8 + t4 * 2 + e;
        const int c = k0 + kk;
        float x0 = s[j][e] * scale + bs[kk];
        float x1 = s[j][2 + e] * scale + bs[kk];
        if (causal) {
          if (c > r0 + off) x0 = kMaskValue;
          if (c > r1 + off) x1 = kMaskValue;
        }
        if (c >= Tk) x0 = x1 = -INFINITY;
        s[j][e] = x0;
        s[j][2 + e] = x1;
        mx0 = fmaxf(mx0, x0);
        mx1 = fmaxf(mx1, x1);
      }
    }
#pragma unroll
    for (int o2 = 1; o2 < 4; o2 <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o2));
    }
    const float alpha0 = expf(m0 - mx0);
    const float alpha1 = expf(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[j][e] = expf(s[j][e] - m0);
        s[j][2 + e] = expf(s[j][2 + e] - m1);
        ps0 += s[j][e];
        ps1 += s[j][2 + e];
      }
    }
    l0 = l0 * alpha0 + ps0;
    l1 = l1 * alpha1 + ps1;
#pragma unroll
    for (int dn = 0; dn < DN; ++dn) {
      acc[dn][0] *= alpha0;
      acc[dn][1] *= alpha0;
      acc[dn][2] *= alpha1;
      acc[dn][3] *= alpha1;
    }

#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) {
      // two 8-key score tiles form the A operand of one 16-key step
      const uint32_t pa[4] = {pack_f32(s[2 * kc][0], s[2 * kc][1]),
                              pack_f32(s[2 * kc][2], s[2 * kc][3]),
                              pack_f32(s[2 * kc + 1][0], s[2 * kc + 1][1]),
                              pack_f32(s[2 * kc + 1][2], s[2 * kc + 1][3])};
#pragma unroll
      for (int dn = 0; dn < DN; ++dn) {
        const __nv_bfloat16* vr = vs + (kc * 16 + t4 * 2) * LD + dn * 8 + g;
        mma_bf16(acc[dn], pa, pack_bf16(vr[0], vr[LD]), pack_bf16(vr[8 * LD], vr[9 * LD]));
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int o2 = 1; o2 < 4; o2 <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, o2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, o2);
  }
  const float d0 = fmaxf(l0, 1e-30f);
  const float d1 = fmaxf(l1, 1e-30f);
  __nv_bfloat16* ob = o + (long long)b * Tq * HD + (long long)h * D;
#pragma unroll
  for (int dn = 0; dn < DN; ++dn) {
    const int c = dn * 8 + t4 * 2;
    if (r0 < Tq)
      *reinterpret_cast<uint32_t*>(ob + r0 * HD + c) = pack_f32(acc[dn][0] / d0, acc[dn][1] / d0);
    if (r1 < Tq)
      *reinterpret_cast<uint32_t*>(ob + r1 * HD + c) = pack_f32(acc[dn][2] / d1, acc[dn][3] / d1);
  }
}

// ------------------------------------------------------------------- f32 path
template <int D>
__global__ void __launch_bounds__(256)
    flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ bias,
                         float* __restrict__ o, int Tq, int Tk, int H, int causal,
                         float scale) {
  constexpr int BK = 32;
  constexpr int E = D / 4;  // head-dim values per thread: columns e * 4 + quad
  __shared__ __align__(16) float ks[BK * D];
  __shared__ __align__(16) float vs[BK * D];
  __shared__ float bs[BK];

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int quad = tid % 4;
  const int row = q0 + tid / 4;
  const long long HD = (long long)H * D;
  const int off = Tk - Tq;
  const float* kb = k + (long long)b * Tk * HD + (long long)h * D;
  const float* vb = v + (long long)b * Tk * HD + (long long)h * D;

  float qv[E], acc[E];
  const float* qr = q + ((long long)b * Tq + row) * HD + (long long)h * D;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    qv[e] = row < Tq ? qr[e * 4 + quad] : 0.f;
    acc[e] = 0.f;
  }
  float m = kMaskValue, l = 0.f;

  const int n_tiles = key_tiles(q0, Tq, Tk, BK, causal);
  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * BK;
    for (int i = tid; i < BK * D / 4; i += 256) {
      const int r = i / (D / 4);
      const int c = (i % (D / 4)) * 4;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
      if (k0 + r < Tk) {
        kv = *reinterpret_cast<const float4*>(kb + (k0 + r) * HD + c);
        vv = *reinterpret_cast<const float4*>(vb + (k0 + r) * HD + c);
      }
      *reinterpret_cast<float4*>(ks + r * D + c) = kv;
      *reinterpret_cast<float4*>(vs + r * D + c) = vv;
    }
    if (tid < BK)
      bs[tid] = (bias != nullptr && k0 + tid < Tk) ? bias[(long long)b * Tk + k0 + tid] : 0.f;
    __syncthreads();

    float s[BK];
    float mx = m;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      float part = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) part += qv[e] * ks[j * D + e * 4 + quad];
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      const int c = k0 + j;
      float x = part * scale + bs[j];
      if (causal && c > row + off) x = kMaskValue;
      if (c >= Tk) x = -INFINITY;
      s[j] = x;
      mx = fmaxf(mx, x);
    }
    const float alpha = expf(m - mx);
    m = mx;
    float ps = 0.f;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      s[j] = expf(s[j] - m);
      ps += s[j];
    }
    l = l * alpha + ps;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      float a = acc[e] * alpha;
#pragma unroll
      for (int j = 0; j < BK; ++j) a += s[j] * vs[j * D + e * 4 + quad];
      acc[e] = a;
    }
    __syncthreads();
  }

  if (row < Tq) {
    const float den = fmaxf(l, 1e-30f);
    float* orow = o + ((long long)b * Tq + row) * HD + (long long)h * D;
#pragma unroll
    for (int e = 0; e < E; ++e) orow[e * 4 + quad] = acc[e] / den;
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* bias, void* o, int B,
           int Tq, int Tk, int H, int D, int causal, float scale, void* stream) {
  if (B <= 0 || Tq <= 0 || Tk <= 0 || H <= 0 || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((Tq + BQ - 1) / BQ, H, B);
  cudaStream_t s = (cudaStream_t)stream;
  const bool bf16 = sizeof(T) == 2;
#define VT_FLASH_CASE(DD)                                                              \
  case DD:                                                                             \
    if (bf16)                                                                          \
      flash_fwd_bf16_kernel<DD><<<grid, 128, 0, s>>>(                                  \
          (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,  \
          (const float*)bias, (__nv_bfloat16*)o, Tq, Tk, H, causal, scale);            \
    else                                                                               \
      flash_fwd_f32_kernel<DD><<<grid, 256, 0, s>>>(                                   \
          (const float*)q, (const float*)k, (const float*)v, (const float*)bias,       \
          (float*)o, Tq, Tk, H, causal, scale);                                        \
    break;
  switch (D) {
    VT_FLASH_CASE(32)
    VT_FLASH_CASE(64)
    VT_FLASH_CASE(128)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef VT_FLASH_CASE
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, Tq, H*D), k/v (B, Tk, H*D), bias (B, Tk) f32 additive or null, o like q
extern "C" int vt_flash_attention_f32(const void* q, const void* k, const void* v,
                                      const void* bias, void* o, int B, int Tq, int Tk,
                                      int H, int D, int causal, float scale, void* stream) {
  return launch<float>(q, k, v, bias, o, B, Tq, Tk, H, D, causal, scale, stream);
}

extern "C" int vt_flash_attention_bf16(const void* q, const void* k, const void* v,
                                       const void* bias, void* o, int B, int Tq, int Tk,
                                       int H, int D, int causal, float scale, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, bias, o, B, Tq, Tk, H, D, causal, scale, stream);
}
