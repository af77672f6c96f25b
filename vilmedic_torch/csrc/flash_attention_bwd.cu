// Flash attention backward (FlashAttention-2 split, two kernels, no atomics),
// written for Hopper (sm_90a).
//
// Replaces: vilmedic_tpu/ops/flash_attention.py::_bwd_dq_kernel_v2 and
// ::_bwd_dkv_kernel_v2 (reached through `_flash_bwd_bthd`, the (B, T, H*D)
// layout) and ::_bwd_dq_kernel / ::_bwd_dkv_kernel (through `_flash_bwd_bhtd`,
// the (B*H, T, D) layout). As for the forward (flash_attention.cu), the two
// TPU layouts differ only in how heads sit on the 128 lanes; one pair of
// kernels covers both.
//
// What it computes, per (batch b, head h), from the forward's per-row
// log-sum-exp lse[b, h, r] and delta[b, h, r] = sum_d dO[r, d] * O[r, d]:
//   s[r, c]  = (q[r] . k[c]) * scale + bias[b, c]      f32, keys c < Tk
//   s[r, c]  = -1e9 where causal and c > r + Tk - Tq  (replaced, as the TPU does)
//   p[r, c]  = exp(s[r, c] - lse[r])
//   dP[r, c] = dO[r] . v[c]                            f32
//   dS[r, c] = p[r, c] * (dP[r, c] - delta[r])         f32
//   dq[r]    = scale * sum_c dS[r, c] k[c]             (dS rounded to k's dtype)
//   dv[c]    = sum_r p[r, c] dO[r]                     (p rounded to dO's dtype)
//   dk[c]    = scale * sum_r dS[r, c] q[r]             (dS rounded to q's dtype)
//   dbias[b, h, c] = sum_r dS[r, c]                    (f32, unrounded)
// The rounding points are the TPU kernels'. dbias is per head; the wrapper
// sums it over heads, as the JAX wrappers do.
//
// What bounds it on the H100: at the VisionLanguage training shape (B 16,
// T 1470, H 12, D 64, causal) the two kernels do seven T x T x D products
// per (b, h) (the dq kernel recomputes S and dP, the dk/dv kernel S and dP
// again): ~186 GFLOP against ~100 MB of operands, so the tensor cores (bf16)
// or the FMA units (f32) bound it, not memory.
//
// Design, kept simple first (no TMA, no wgmma, no pipelining):
//   - dq kernel, one block per (b, h, 64-query tile): as the forward, each of
//     4 warps owns 16 query rows whose Q and dO fragments stay in registers;
//     the block loops over key tiles (64 keys, 32 at D 128) of K and V staged
//     in shared memory, up to the causal limit. S = Q K^T and dP = dO V^T are
//     mma.sync m16n8k16 bf16 products with f32 accumulation; dS is formed in
//     the S registers and reused, rounded to bf16, as the A operand of dS K.
//   - dk/dv kernel, one block per (b, h, 64-key tile): each warp owns 16 keys
//     whose K and V fragments stay in registers, and computes the transposed
//     products S^T = K Q^T and dP^T = V dO^T against query tiles (64 rows, 32
//     at D 128) of Q, dO, lse and delta staged in shared memory, from the
//     first tile whose rows can see the block's keys. P^T and dS^T feed
//     dV += P^T dO and dK += dS^T Q straight from the accumulator registers;
//     dbias sums dS^T per key in registers and once across the quad at the
//     end. No block writes another's rows, so the result is the same from
//     run to run.
//   - f32: CUDA-core FMA, no TF32 (it would break f32 parity). 256 threads,
//     4 per query row (dq) or key row (dk/dv), each holding a quarter of the
//     head dimension; the two dot products per (row, key) are quad shuffle
//     sums.
//   - Ragged tails are masked in the kernels: keys >= Tk get p = 0 and zero
//     K/V rows; query rows >= Tq get zero Q/dO and lse = +inf (p = 0) in the
//     dk/dv kernel, and are not stored by the dq kernel. The wrapper pads
//     nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kMaskValue = -1e9f;  // the TPU kernels' finite mask value
constexpr int BQ = 64;               // query rows per dq block
constexpr int BKB = 64;              // key rows per dk/dv block

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

// Key tiles a dq block visits: all, or under the causal mask those up to the
// one holding the last key its last real row may see.
__device__ __forceinline__ int key_tiles(int q0, int Tq, int Tk, int bk, int causal) {
  int n = (Tk + bk - 1) / bk;
  if (causal) {
    const int last_key = min(q0 + BQ, Tq) - 1 + (Tk - Tq);
    n = last_key < 0 ? 0 : min(n, last_key / bk + 1);
  }
  return n;
}

// First query tile a dk/dv block visits: under the causal mask, the one
// holding the first row that may see the block's first key.
__device__ __forceinline__ int first_query_tile(int k0, int Tq, int Tk, int bq, int causal) {
  const int first_row = k0 - (Tk - Tq);
  return (causal && first_row > 0) ? first_row / bq : 0;
}

// Stage rows [r0, r0 + R) of a (T, H*D) head slice into shared memory, zero
// past T.
template <int R, int D, int LD, int NTHREADS>
__device__ __forceinline__ void stage_bf16(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                           long long HD, int r0, int T, int tid) {
  for (int i = tid; i < R * D / 8; i += NTHREADS) {
    const int r = i / (D / 8);
    const int c = (i % (D / 8)) * 8;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < T) x = *reinterpret_cast<const uint4*>(src + (r0 + r) * HD + c);
    *reinterpret_cast<uint4*>(dst + r * LD + c) = x;
  }
}

template <int R, int D, int NTHREADS>
__device__ __forceinline__ void stage_f32(float* dst, const float* src, long long HD, int r0,
                                          int T, int tid) {
  for (int i = tid; i < R * D / 4; i += NTHREADS) {
    const int r = i / (D / 4);
    const int c = (i % (D / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < T) x = *reinterpret_cast<const float4*>(src + (r0 + r) * HD + c);
    *reinterpret_cast<float4*>(dst + r * D + c) = x;
  }
}

// A fragments (m16n8k16) of rows r0 and r1 = r0 + 8 of a (T, H*D) head slice
template <int KC>
__device__ __forceinline__ void load_a(uint32_t (&a)[KC][4], const __nv_bfloat16* src,
                                       long long HD, int r0, int r1, int T, int t4) {
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
    const int c = kc * 16 + t4 * 2;
    a[kc][0] = r0 < T ? ld_u32(src + r0 * HD + c) : 0u;
    a[kc][1] = r1 < T ? ld_u32(src + r1 * HD + c) : 0u;
    a[kc][2] = r0 < T ? ld_u32(src + r0 * HD + c + 8) : 0u;
    a[kc][3] = r1 < T ? ld_u32(src + r1 * HD + c + 8) : 0u;
  }
}

// ------------------------------------------------------------ bf16 dq kernel
template <int D, int BK>
__global__ void __launch_bounds__(128)
    flash_bwd_dq_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                             const __nv_bfloat16* __restrict__ k,
                             const __nv_bfloat16* __restrict__ v,
                             const float* __restrict__ bias,
                             const __nv_bfloat16* __restrict__ dout,
                             const float* __restrict__ lse, const float* __restrict__ delta,
                             __nv_bfloat16* __restrict__ dq, int Tq, int Tk, int H, int causal,
                             float scale) {
  constexpr int LD = D + 8;   // shared row stride (bf16): 16-byte rows, no bank conflicts
  constexpr int KC = D / 16;  // k-steps over the head dim
  constexpr int DN = D / 8;   // 8-wide dq column tiles
  constexpr int NT = BK / 8;  // 8-key score tiles
  __shared__ __align__(16) __nv_bfloat16 ks[BK * LD];
  __shared__ __align__(16) __nv_bfloat16 vs[BK * LD];
  __shared__ float bs[BK];

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t4 = lane % 4;
  const long long HD = (long long)H * D;
  const int off = Tk - Tq;
  const long long qoff = (long long)b * Tq * HD + (long long)h * D;
  const __nv_bfloat16* kb = k + (long long)b * Tk * HD + (long long)h * D;
  const __nv_bfloat16* vb = v + (long long)b * Tk * HD + (long long)h * D;
  const int r0 = q0 + warp * 16 + g;
  const int r1 = r0 + 8;

  uint32_t qa[KC][4], da[KC][4];
  load_a<KC>(qa, q + qoff, HD, r0, r1, Tq, t4);
  load_a<KC>(da, dout + qoff, HD, r0, r1, Tq, t4);
  const float* lb = lse + ((long long)b * H + h) * Tq;
  const float* db = delta + ((long long)b * H + h) * Tq;
  const float lse0 = r0 < Tq ? lb[r0] : 0.f, lse1 = r1 < Tq ? lb[r1] : 0.f;
  const float dl0 = r0 < Tq ? db[r0] : 0.f, dl1 = r1 < Tq ? db[r1] : 0.f;

  float acc[DN][4];
#pragma unroll
  for (int dn = 0; dn < DN; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dn][e] = 0.f;

  const int n_tiles = key_tiles(q0, Tq, Tk, BK, causal);
  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * BK;
    stage_bf16<BK, D, LD, 128>(ks, kb, HD, k0, Tk, tid);
    stage_bf16<BK, D, LD, 128>(vs, vb, HD, k0, Tk, tid);
    if (tid < BK)
      bs[tid] = (bias != nullptr && k0 + tid < Tk) ? bias[(long long)b * Tk + k0 + tid] : 0.f;
    __syncthreads();

    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        const __nv_bfloat16* kr = ks + (j * 8 + g) * LD + kc * 16 + t4 * 2;
        const __nv_bfloat16* vr = vs + (j * 8 + g) * LD + kc * 16 + t4 * 2;
        mma_bf16(s[j], qa[kc], ld_u32(kr), ld_u32(kr + 8));
        mma_bf16(dp[j], da[kc], ld_u32(vr), ld_u32(vr + 8));
      }
    }

    // dS in place of S
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
        const float p0 = c < Tk ? expf(x0 - lse0) : 0.f;
        const float p1 = c < Tk ? expf(x1 - lse1) : 0.f;
        s[j][e] = p0 * (dp[j][e] - dl0);
        s[j][2 + e] = p1 * (dp[j][2 + e] - dl1);
      }
    }

#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) {
      // two 8-key dS tiles form the A operand of one 16-key step
      const uint32_t pa[4] = {pack_f32(s[2 * kc][0], s[2 * kc][1]),
                              pack_f32(s[2 * kc][2], s[2 * kc][3]),
                              pack_f32(s[2 * kc + 1][0], s[2 * kc + 1][1]),
                              pack_f32(s[2 * kc + 1][2], s[2 * kc + 1][3])};
#pragma unroll
      for (int dn = 0; dn < DN; ++dn) {
        const __nv_bfloat16* kr = ks + (kc * 16 + t4 * 2) * LD + dn * 8 + g;
        mma_bf16(acc[dn], pa, pack_bf16(kr[0], kr[LD]), pack_bf16(kr[8 * LD], kr[9 * LD]));
      }
    }
    __syncthreads();
  }

  __nv_bfloat16* ob = dq + qoff;
#pragma unroll
  for (int dn = 0; dn < DN; ++dn) {
    const int c = dn * 8 + t4 * 2;
    if (r0 < Tq)
      *reinterpret_cast<uint32_t*>(ob + r0 * HD + c) =
          pack_f32(acc[dn][0] * scale, acc[dn][1] * scale);
    if (r1 < Tq)
      *reinterpret_cast<uint32_t*>(ob + r1 * HD + c) =
          pack_f32(acc[dn][2] * scale, acc[dn][3] * scale);
  }
}

// -------------------------------------------------------- bf16 dk/dv kernel
template <int D, int BQT>
__global__ void __launch_bounds__(128)
    flash_bwd_dkv_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                              const __nv_bfloat16* __restrict__ k,
                              const __nv_bfloat16* __restrict__ v,
                              const float* __restrict__ bias,
                              const __nv_bfloat16* __restrict__ dout,
                              const float* __restrict__ lse, const float* __restrict__ delta,
                              __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                              float* __restrict__ dbias, int Tq, int Tk, int H, int causal,
                              float scale) {
  constexpr int LD = D + 8;
  constexpr int KC = D / 16;
  constexpr int DN = D / 8;
  constexpr int NT = BQT / 8;  // 8-query score tiles
  __shared__ __align__(16) __nv_bfloat16 qs[BQT * LD];
  __shared__ __align__(16) __nv_bfloat16 dos[BQT * LD];
  __shared__ float ls[BQT];
  __shared__ float dls[BQT];

  const int k0 = blockIdx.x * BKB;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t4 = lane % 4;
  const long long HD = (long long)H * D;
  const int off = Tk - Tq;
  const long long koff = (long long)b * Tk * HD + (long long)h * D;
  const __nv_bfloat16* qb = q + (long long)b * Tq * HD + (long long)h * D;
  const __nv_bfloat16* ob = dout + (long long)b * Tq * HD + (long long)h * D;
  const float* lb = lse + ((long long)b * H + h) * Tq;
  const float* db = delta + ((long long)b * H + h) * Tq;
  const int c0 = k0 + warp * 16 + g;  // this lane's two keys
  const int c1 = c0 + 8;

  uint32_t ka[KC][4], va[KC][4];
  load_a<KC>(ka, k + koff, HD, c0, c1, Tk, t4);
  load_a<KC>(va, v + koff, HD, c0, c1, Tk, t4);
  const float bias0 = (bias != nullptr && c0 < Tk) ? bias[(long long)b * Tk + c0] : 0.f;
  const float bias1 = (bias != nullptr && c1 < Tk) ? bias[(long long)b * Tk + c1] : 0.f;

  float dka[DN][4], dva[DN][4];
#pragma unroll
  for (int dn = 0; dn < DN; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[dn][e] = dva[dn][e] = 0.f;
  float db0 = 0.f, db1 = 0.f;

  const int n_q = (Tq + BQT - 1) / BQT;
  for (int jt = first_query_tile(k0, Tq, Tk, BQT, causal); jt < n_q; ++jt) {
    const int qr0 = jt * BQT;
    stage_bf16<BQT, D, LD, 128>(qs, qb, HD, qr0, Tq, tid);
    stage_bf16<BQT, D, LD, 128>(dos, ob, HD, qr0, Tq, tid);
    if (tid < BQT) {
      const bool real = qr0 + tid < Tq;
      ls[tid] = real ? lb[qr0 + tid] : INFINITY;  // p = 0 on the ragged rows
      dls[tid] = real ? db[qr0 + tid] : 0.f;
    }
    __syncthreads();

    float s[NT][4], dp[NT][4];  // S^T and dP^T: rows = keys, columns = queries
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        const __nv_bfloat16* qr = qs + (j * 8 + g) * LD + kc * 16 + t4 * 2;
        const __nv_bfloat16* dr = dos + (j * 8 + g) * LD + kc * 16 + t4 * 2;
        mma_bf16(s[j], ka[kc], ld_u32(qr), ld_u32(qr + 8));
        mma_bf16(dp[j], va[kc], ld_u32(dr), ld_u32(dr + 8));
      }
    }

    // P^T in place of S^T, dS^T in place of dP^T
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int il = j * 8 + t4 * 2 + e;
        const int r = qr0 + il;
        float x0 = s[j][e] * scale + bias0;
        float x1 = s[j][2 + e] * scale + bias1;
        if (causal) {
          if (c0 > r + off) x0 = kMaskValue;
          if (c1 > r + off) x1 = kMaskValue;
        }
        const float p0 = c0 < Tk ? expf(x0 - ls[il]) : 0.f;
        const float p1 = c1 < Tk ? expf(x1 - ls[il]) : 0.f;
        const float ds0 = p0 * (dp[j][e] - dls[il]);
        const float ds1 = p1 * (dp[j][2 + e] - dls[il]);
        db0 += ds0;
        db1 += ds1;
        s[j][e] = p0;
        s[j][2 + e] = p1;
        dp[j][e] = ds0;
        dp[j][2 + e] = ds1;
      }
    }

#pragma unroll
    for (int kc = 0; kc < BQT / 16; ++kc) {
      const uint32_t pa[4] = {pack_f32(s[2 * kc][0], s[2 * kc][1]),
                              pack_f32(s[2 * kc][2], s[2 * kc][3]),
                              pack_f32(s[2 * kc + 1][0], s[2 * kc + 1][1]),
                              pack_f32(s[2 * kc + 1][2], s[2 * kc + 1][3])};
      const uint32_t sa[4] = {pack_f32(dp[2 * kc][0], dp[2 * kc][1]),
                              pack_f32(dp[2 * kc][2], dp[2 * kc][3]),
                              pack_f32(dp[2 * kc + 1][0], dp[2 * kc + 1][1]),
                              pack_f32(dp[2 * kc + 1][2], dp[2 * kc + 1][3])};
#pragma unroll
      for (int dn = 0; dn < DN; ++dn) {
        const __nv_bfloat16* dr = dos + (kc * 16 + t4 * 2) * LD + dn * 8 + g;
        const __nv_bfloat16* qr = qs + (kc * 16 + t4 * 2) * LD + dn * 8 + g;
        mma_bf16(dva[dn], pa, pack_bf16(dr[0], dr[LD]), pack_bf16(dr[8 * LD], dr[9 * LD]));
        mma_bf16(dka[dn], sa, pack_bf16(qr[0], qr[LD]), pack_bf16(qr[8 * LD], qr[9 * LD]));
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int o2 = 1; o2 < 4; o2 <<= 1) {
    db0 += __shfl_xor_sync(0xffffffffu, db0, o2);
    db1 += __shfl_xor_sync(0xffffffffu, db1, o2);
  }
  float* dbb = dbias + ((long long)b * H + h) * Tk;
  if (t4 == 0) {
    if (c0 < Tk) dbb[c0] = db0;
    if (c1 < Tk) dbb[c1] = db1;
  }
#pragma unroll
  for (int dn = 0; dn < DN; ++dn) {
    const int c = dn * 8 + t4 * 2;
    if (c0 < Tk) {
      *reinterpret_cast<uint32_t*>(dk + koff + c0 * HD + c) =
          pack_f32(dka[dn][0] * scale, dka[dn][1] * scale);
      *reinterpret_cast<uint32_t*>(dv + koff + c0 * HD + c) = pack_f32(dva[dn][0], dva[dn][1]);
    }
    if (c1 < Tk) {
      *reinterpret_cast<uint32_t*>(dk + koff + c1 * HD + c) =
          pack_f32(dka[dn][2] * scale, dka[dn][3] * scale);
      *reinterpret_cast<uint32_t*>(dv + koff + c1 * HD + c) = pack_f32(dva[dn][2], dva[dn][3]);
    }
  }
}

// ------------------------------------------------------------- f32 dq kernel
template <int D>
__global__ void __launch_bounds__(256)
    flash_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v, const float* __restrict__ bias,
                            const float* __restrict__ dout, const float* __restrict__ lse,
                            const float* __restrict__ delta, float* __restrict__ dq, int Tq,
                            int Tk, int H, int causal, float scale) {
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
  const long long roff = ((long long)b * Tq + row) * HD + (long long)h * D;
  const bool real = row < Tq;

  float qv[E], dov[E], acc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    qv[e] = real ? q[roff + e * 4 + quad] : 0.f;
    dov[e] = real ? dout[roff + e * 4 + quad] : 0.f;
    acc[e] = 0.f;
  }
  const long long soff = ((long long)b * H + h) * Tq + row;
  const float lse_r = real ? lse[soff] : 0.f;
  const float delta_r = real ? delta[soff] : 0.f;

  const int n_tiles = key_tiles(q0, Tq, Tk, BK, causal);
  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * BK;
    stage_f32<BK, D, 256>(ks, kb, HD, k0, Tk, tid);
    stage_f32<BK, D, 256>(vs, vb, HD, k0, Tk, tid);
    if (tid < BK)
      bs[tid] = (bias != nullptr && k0 + tid < Tk) ? bias[(long long)b * Tk + k0 + tid] : 0.f;
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float sp = 0.f, dpp = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        sp += qv[e] * ks[j * D + e * 4 + quad];
        dpp += dov[e] * vs[j * D + e * 4 + quad];
      }
      sp += __shfl_xor_sync(0xffffffffu, sp, 1);
      sp += __shfl_xor_sync(0xffffffffu, sp, 2);
      dpp += __shfl_xor_sync(0xffffffffu, dpp, 1);
      dpp += __shfl_xor_sync(0xffffffffu, dpp, 2);
      const int c = k0 + j;
      float x = sp * scale + bs[j];
      if (causal && c > row + off) x = kMaskValue;
      const float p = c < Tk ? expf(x - lse_r) : 0.f;
      const float ds = p * (dpp - delta_r);
#pragma unroll
      for (int e = 0; e < E; ++e) acc[e] += ds * ks[j * D + e * 4 + quad];
    }
    __syncthreads();
  }

  if (real) {
#pragma unroll
    for (int e = 0; e < E; ++e) dq[roff + e * 4 + quad] = acc[e] * scale;
  }
}

// --------------------------------------------------------- f32 dk/dv kernel
template <int D>
__global__ void __launch_bounds__(256)
    flash_bwd_dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                             const float* __restrict__ v, const float* __restrict__ bias,
                             const float* __restrict__ dout, const float* __restrict__ lse,
                             const float* __restrict__ delta, float* __restrict__ dk,
                             float* __restrict__ dv, float* __restrict__ dbias, int Tq, int Tk,
                             int H, int causal, float scale) {
  constexpr int BQT = 32;
  constexpr int E = D / 4;
  __shared__ __align__(16) float qs[BQT * D];
  __shared__ __align__(16) float dos[BQT * D];
  __shared__ float ls[BQT];
  __shared__ float dls[BQT];

  const int k0 = blockIdx.x * BKB;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int quad = tid % 4;
  const int key = k0 + tid / 4;
  const long long HD = (long long)H * D;
  const int off = Tk - Tq;
  const float* qb = q + (long long)b * Tq * HD + (long long)h * D;
  const float* ob = dout + (long long)b * Tq * HD + (long long)h * D;
  const float* lb = lse + ((long long)b * H + h) * Tq;
  const float* db = delta + ((long long)b * H + h) * Tq;
  const long long koff = ((long long)b * Tk + key) * HD + (long long)h * D;
  const bool real = key < Tk;

  float kv[E], vv[E], dka[E], dva[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    kv[e] = real ? k[koff + e * 4 + quad] : 0.f;
    vv[e] = real ? v[koff + e * 4 + quad] : 0.f;
    dka[e] = dva[e] = 0.f;
  }
  const float bias_k = (bias != nullptr && real) ? bias[(long long)b * Tk + key] : 0.f;
  float dbs = 0.f;

  const int n_q = (Tq + BQT - 1) / BQT;
  for (int jt = first_query_tile(k0, Tq, Tk, BQT, causal); jt < n_q; ++jt) {
    const int qr0 = jt * BQT;
    stage_f32<BQT, D, 256>(qs, qb, HD, qr0, Tq, tid);
    stage_f32<BQT, D, 256>(dos, ob, HD, qr0, Tq, tid);
    if (tid < BQT) {
      const bool row_real = qr0 + tid < Tq;
      ls[tid] = row_real ? lb[qr0 + tid] : INFINITY;  // p = 0 on the ragged rows
      dls[tid] = row_real ? db[qr0 + tid] : 0.f;
    }
    __syncthreads();

#pragma unroll 4
    for (int i = 0; i < BQT; ++i) {
      float sp = 0.f, dpp = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        sp += kv[e] * qs[i * D + e * 4 + quad];
        dpp += vv[e] * dos[i * D + e * 4 + quad];
      }
      sp += __shfl_xor_sync(0xffffffffu, sp, 1);
      sp += __shfl_xor_sync(0xffffffffu, sp, 2);
      dpp += __shfl_xor_sync(0xffffffffu, dpp, 1);
      dpp += __shfl_xor_sync(0xffffffffu, dpp, 2);
      float x = sp * scale + bias_k;
      if (causal && key > qr0 + i + off) x = kMaskValue;
      const float p = real ? expf(x - ls[i]) : 0.f;
      const float ds = p * (dpp - dls[i]);
      dbs += ds;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        dva[e] += p * dos[i * D + e * 4 + quad];
        dka[e] += ds * qs[i * D + e * 4 + quad];
      }
    }
    __syncthreads();
  }

  if (real) {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      dk[koff + e * 4 + quad] = dka[e] * scale;
      dv[koff + e * 4 + quad] = dva[e];
    }
    if (quad == 0) dbias[((long long)b * H + h) * Tk + key] = dbs;
  }
}

bool bad_shape(int B, int Tq, int Tk, int H) {
  return B <= 0 || Tq <= 0 || Tk <= 0 || H <= 0 || B > 65535 || H > 65535;
}

template <typename T>
int launch_dq(const void* q, const void* k, const void* v, const void* bias, const void* dout,
              const void* lse, const void* delta, void* dq, int B, int Tq, int Tk, int H, int D,
              int causal, float scale, void* stream) {
  if (bad_shape(B, Tq, Tk, H)) return (int)cudaErrorInvalidValue;
  const dim3 grid((Tq + BQ - 1) / BQ, H, B);
  cudaStream_t s = (cudaStream_t)stream;
  const bool bf16 = sizeof(T) == 2;
#define VT_DQ_CASE(DD, BKK)                                                               \
  case DD:                                                                                \
    if (bf16)                                                                             \
      flash_bwd_dq_bf16_kernel<DD, BKK><<<grid, 128, 0, s>>>(                             \
          (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,     \
          (const float*)bias, (const __nv_bfloat16*)dout, (const float*)lse,              \
          (const float*)delta, (__nv_bfloat16*)dq, Tq, Tk, H, causal, scale);             \
    else                                                                                  \
      flash_bwd_dq_f32_kernel<DD><<<grid, 256, 0, s>>>(                                   \
          (const float*)q, (const float*)k, (const float*)v, (const float*)bias,          \
          (const float*)dout, (const float*)lse, (const float*)delta, (float*)dq, Tq, Tk, \
          H, causal, scale);                                                              \
    break;
  switch (D) {
    VT_DQ_CASE(32, 64)
    VT_DQ_CASE(64, 64)
    VT_DQ_CASE(128, 32)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef VT_DQ_CASE
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dkv(const void* q, const void* k, const void* v, const void* bias, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv, void* dbias, int B,
               int Tq, int Tk, int H, int D, int causal, float scale, void* stream) {
  if (bad_shape(B, Tq, Tk, H)) return (int)cudaErrorInvalidValue;
  const dim3 grid((Tk + BKB - 1) / BKB, H, B);
  cudaStream_t s = (cudaStream_t)stream;
  const bool bf16 = sizeof(T) == 2;
#define VT_DKV_CASE(DD, BQQ)                                                              \
  case DD:                                                                                \
    if (bf16)                                                                             \
      flash_bwd_dkv_bf16_kernel<DD, BQQ><<<grid, 128, 0, s>>>(                            \
          (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,     \
          (const float*)bias, (const __nv_bfloat16*)dout, (const float*)lse,              \
          (const float*)delta, (__nv_bfloat16*)dk, (__nv_bfloat16*)dv, (float*)dbias, Tq, \
          Tk, H, causal, scale);                                                          \
    else                                                                                  \
      flash_bwd_dkv_f32_kernel<DD><<<grid, 256, 0, s>>>(                                  \
          (const float*)q, (const float*)k, (const float*)v, (const float*)bias,          \
          (const float*)dout, (const float*)lse, (const float*)delta, (float*)dk,         \
          (float*)dv, (float*)dbias, Tq, Tk, H, causal, scale);                           \
    break;
  switch (D) {
    VT_DKV_CASE(32, 64)
    VT_DKV_CASE(64, 64)
    VT_DKV_CASE(128, 32)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef VT_DKV_CASE
  return (int)cudaGetLastError();
}

}  // namespace

// q/dout/dq (B, Tq, H*D), k/v (B, Tk, H*D), bias (B, Tk) f32 additive or null,
// lse/delta (B, H, Tq) f32
extern "C" int vt_flash_attention_bwd_dq_f32(const void* q, const void* k, const void* v,
                                             const void* bias, const void* dout,
                                             const void* lse, const void* delta, void* dq,
                                             int B, int Tq, int Tk, int H, int D, int causal,
                                             float scale, void* stream) {
  return launch_dq<float>(q, k, v, bias, dout, lse, delta, dq, B, Tq, Tk, H, D, causal, scale,
                          stream);
}

extern "C" int vt_flash_attention_bwd_dq_bf16(const void* q, const void* k, const void* v,
                                              const void* bias, const void* dout,
                                              const void* lse, const void* delta, void* dq,
                                              int B, int Tq, int Tk, int H, int D, int causal,
                                              float scale, void* stream) {
  return launch_dq<__nv_bfloat16>(q, k, v, bias, dout, lse, delta, dq, B, Tq, Tk, H, D, causal,
                                  scale, stream);
}

// as above; dk/dv (B, Tk, H*D), dbias (B, H, Tk) f32 per head
extern "C" int vt_flash_attention_bwd_dkv_f32(const void* q, const void* k, const void* v,
                                              const void* bias, const void* dout,
                                              const void* lse, const void* delta, void* dk,
                                              void* dv, void* dbias, int B, int Tq, int Tk,
                                              int H, int D, int causal, float scale,
                                              void* stream) {
  return launch_dkv<float>(q, k, v, bias, dout, lse, delta, dk, dv, dbias, B, Tq, Tk, H, D,
                           causal, scale, stream);
}

extern "C" int vt_flash_attention_bwd_dkv_bf16(const void* q, const void* k, const void* v,
                                               const void* bias, const void* dout,
                                               const void* lse, const void* delta, void* dk,
                                               void* dv, void* dbias, int B, int Tq, int Tk,
                                               int H, int D, int causal, float scale,
                                               void* stream) {
  return launch_dkv<__nv_bfloat16>(q, k, v, bias, dout, lse, delta, dk, dv, dbias, B, Tq, Tk,
                                   H, D, causal, scale, stream);
}
