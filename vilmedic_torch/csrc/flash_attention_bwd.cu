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
// sums it over heads, as the JAX wrappers do. A causal row that sees no key
// (Tq > Tk) weighs every key, as the finite mask gives: its dq block visits
// every key tile, and every dk/dv block starts at the first query tile.
//
// What bounds it on the H100: at the VisionLanguage training shape (B 16,
// T 1470, H 12, D 64, causal) the two kernels do seven T x T x D products
// per (b, h) (the dq kernel recomputes S and dP, the dk/dv kernel S and dP
// again): ~186 GFLOP against ~100 MB of operands, so the tensor cores (bf16)
// or the FMA units (f32) bound it, not memory.
//
// Design (bf16), warp-specialised as the forward (hopper_common.cuh): a CTA
// of 384 threads, warpgroup 0 the producer (setmaxnreg 40), warpgroups 1 and 2
// the consumers (232), each owning 64 rows of the CTA's 128.
//   - dq kernel, one CTA per (b, h, 128-query tile): Q and dO (and each
//     consumer's lse, times log2 e, and delta in registers) load once; a
//     2-stage TMA ring carries 64-key tiles of K and V, with the key bias
//     (times log2 e, -inf past Tk) written beside them by the producer warp.
//     S = Q K^T and dP = dO V^T are shared-shared wgmma m64n64k16; dS is
//     formed in the S registers and rounded to bf16 as the register A of
//     dQ += dS K (wgmma m64nDk16, K read MN-major).
//   - dk/dv kernel, one CTA per (b, h, 128-key tile): K and V load once; the
//     ring carries 64-row tiles of Q and dO, with their lse (times log2 e;
//     +inf past Tq, so p = 0 there) and delta. S^T = K Q^T and dP^T = V dO^T
//     are shared-shared wgmma; P^T and dS^T, rounded to bf16 in registers,
//     are the register A of dV += P^T dO and dK += dS^T Q (dO and Q read
//     MN-major). dbias sums dS^T per key in registers and once across the
//     quad at the end. The ring starts at the first query tile whose rows can
//     see the CTA's keys.
//   - Probabilities are ex2.approx of one FMA per score (scale * log2 e
//     folded in) less the scaled lse; only tiles that cross the causal
//     diagonal take the masked body. Epilogues stage the bf16 rows through
//     the warpgroup's own Q (dq) or K/V (dk, dv) rows in shared memory and
//     write them with 16-byte stores.
//   - No block writes another's rows and every sum runs in a fixed order, so
//     the result is the same from run to run.
//   - What bounds it now (PERF.md, K5 row): as for the forward, not memory;
//     each warpgroup runs its two score products, the exponentials and its
//     one or two P-type products in series. At the training shape the pair
//     runs at about a quarter of the bf16 bound, under half the time of the
//     library's backward; dk/dv at D 128 spills (its four accumulators need
//     224 registers before any other value).
//   - f32 (parity checks only): CUDA-core FMA, no TF32 (it would break f32
//     parity). 256 threads, 4 per query row (dq) or key row (dk/dv), each
//     holding a quarter of the head dimension; the two dot products per
//     (row, key) are quad shuffle sums. Ragged tails are masked in the
//     kernels: keys >= Tk get p = 0 and zero K/V rows; query rows >= Tq get
//     zero Q/dO and lse = +inf (p = 0) in the dk/dv kernel, and are not
//     stored by the dq kernel. The wrapper pads nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper_common.cuh"

namespace {

constexpr float kMaskValue = -1e9f;  // the TPU kernels' finite mask value
constexpr int BQ = 64;               // query rows per f32 dq block
constexpr int BKB = 64;              // key rows per f32 dk/dv block

// Key tiles a dq block of query rows [q0, q0 + rows) visits: all, or under
// the causal mask those up to the one holding the last key its last real row
// may see; every tile where the block holds a row that sees no key (Tq > Tk).
__device__ __forceinline__ int key_tiles(int q0, int rows, int Tq, int Tk, int bk, int causal) {
  int n = (Tk + bk - 1) / bk;
  const int off = Tk - Tq;
  if (causal && q0 + off >= 0) n = min(n, (min(q0 + rows, Tq) - 1 + off) / bk + 1);
  return n;
}

// First query tile a dk/dv block visits: under the causal mask, the one
// holding the first row that may see the block's first key; the first tile
// where some rows see no key at all (Tq > Tk), since those weigh every key.
__device__ __forceinline__ int first_query_tile(int k0, int Tq, int Tk, int bq, int causal) {
  const int first_row = k0 - (Tk - Tq);
  return (causal && Tk >= Tq && first_row > 0) ? first_row / bq : 0;
}

// Stage rows [r0, r0 + R) of a (T, H*D) head slice into shared memory, zero
// past T.
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

// ------------------------------------------------------------ bf16 kernels

constexpr int kThreads = 384;  // producer warpgroup + 2 consumer warpgroups
constexpr int kRows = 128;     // rows a CTA owns (queries for dq, keys for dk/dv)
constexpr int kTile = 64;      // rows per ring tile (keys for dq, queries for dk/dv)
constexpr int kStages = 2;     // ring depth
constexpr float kMaskL2 = kMaskValue * hopper::kLog2e;  // the finite mask, log2 domain

template <int D>
struct DqTiles {  // shared-memory offsets (bytes)
  static constexpr int Q = 0;
  static constexpr int DO = Q + kRows * D * 2;
  static constexpr int K = DO + kRows * D * 2;
  static constexpr int V = K + kStages * kTile * D * 2;
  static constexpr int BIAS = V + kStages * kTile * D * 2;
  static constexpr int BAR = BIAS + kStages * kTile * 4;  // resident, full[kStages], empty[kStages]
  static constexpr int SMEM = BAR + (1 + 2 * kStages) * 8 + 1024;  // + alignment slack
};

template <int D>
struct DkvTiles {
  static constexpr int K = 0;
  static constexpr int V = K + kRows * D * 2;
  static constexpr int Q = V + kRows * D * 2;
  static constexpr int DO = Q + kStages * kTile * D * 2;
  static constexpr int LSE = DO + kStages * kTile * D * 2;
  static constexpr int DELTA = LSE + kStages * kTile * 4;
  static constexpr int BAR = DELTA + kStages * kTile * 4;
  static constexpr int SMEM = BAR + (1 + 2 * kStages) * 8 + 1024;
};

// dS of one key tile, in place of S (dq kernel)
template <bool MASK>
__device__ __forceinline__ void dq_scores(float (&sc)[32], const float (&dp)[32], const float* bs,
                                          int k0, int r0, int r1, int off, int Tk, int t4,
                                          float sl2, float lse0, float lse1, float dl0,
                                          float dl1) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 bv = *reinterpret_cast<const float2*>(bs + 8 * j + 2 * t4);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float bias = e ? bv.y : bv.x;
      float x0 = fmaf(sc[4 * j + e], sl2, bias);
      float x1 = fmaf(sc[4 * j + 2 + e], sl2, bias);
      if (MASK) {
        const int c = k0 + 8 * j + 2 * t4 + e;
        if (c < Tk) {
          if (c > r0 + off) x0 = kMaskL2;
          if (c > r1 + off) x1 = kMaskL2;
        }
      }
      sc[4 * j + e] = hopper::fast_exp2(x0 - lse0) * (dp[4 * j + e] - dl0);
      sc[4 * j + 2 + e] = hopper::fast_exp2(x1 - lse1) * (dp[4 * j + 2 + e] - dl1);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_bf16_kernel(const __grid_constant__ CUtensorMap tm_q,
                             const __grid_constant__ CUtensorMap tm_do,
                             const __grid_constant__ CUtensorMap tm_k,
                             const __grid_constant__ CUtensorMap tm_v,
                             const float* __restrict__ bias, const float* __restrict__ lse,
                             const float* __restrict__ delta, __nv_bfloat16* __restrict__ dq,
                             int Tq, int Tk, int H, int causal, float scale, float scale_log2) {
  using L = DqTiles<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hopper::align_1024(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::BAR);
  float* bias_s = reinterpret_cast<float*>(smem + L::BIAS);
  const int q0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int off = Tk - Tq;
  const int n_tiles = key_tiles(q0, kRows, Tq, Tk, kTile, causal);
  hopper::init_ring<kStages>(bars, 2 * 128);

  if (threadIdx.x < 128) {  // ---- producer warpgroup: Q, dO once, then K/V tiles and key bias
    hopper::setmaxnreg_dec<40>();
    if (threadIdx.x < 32)
      hopper::ring_producer<D, kStages, kRows, kTile>(
          smem, bars, &tm_q, L::Q, &tm_do, L::DO, &tm_k, L::K, &tm_v, L::V, q0, 0, n_tiles, h, b,
          [&](int s, int k0, int lane) {
            hopper::key_bias_log2(bias_s + s * kTile, bias, b, Tk, k0, kTile, lane);
          });
    return;
  }

  // ---- consumer warpgroups: 64 query rows each
  hopper::setmaxnreg_inc<232>();
  const int cw = threadIdx.x / 128 - 1;
  const int tw = threadIdx.x % 128;
  const int g = (tw % 32) / 4;
  const int t4 = tw % 4;
  const int wq0 = q0 + cw * 64;
  const int r0 = wq0 + (tw / 32) * 16 + g;
  const int r1 = r0 + 8;
  const int w_last = min(wq0 + 63, Tq - 1);
  const bool nokey = causal && wq0 + off < 0;
  const float* lb = lse + ((long long)b * H + h) * Tq;
  const float* db = delta + ((long long)b * H + h) * Tq;
  const float lse0 = r0 < Tq ? lb[r0] * hopper::kLog2e : 0.f;
  const float lse1 = r1 < Tq ? lb[r1] * hopper::kLog2e : 0.f;
  const float dl0 = r0 < Tq ? db[r0] : 0.f;
  const float dl1 = r1 < Tq ? db[r1] : 0.f;
  const uint32_t qs = hopper::smem_u32(smem + L::Q);
  const uint32_t dos = hopper::smem_u32(smem + L::DO);

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  hopper::mbar_wait(&bars[0], 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % kStages;
    const int k0 = it * kTile;
    hopper::mbar_wait(&bars[1 + s], (it / kStages) & 1);
    if (!causal || nokey || k0 <= w_last + off) {
      const uint32_t ks = hopper::smem_u32(smem + L::K + s * kTile * D * 2);
      const uint32_t vs = hopper::smem_u32(smem + L::V + s * kTile * D * 2);
      float sc[32], dp[32];
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        hopper::wgmma_ss<kTile>(sc, hopper::desc_k<D>(qs, kRows, cw * 64, kk),
                                hopper::desc_k<D>(ks, kTile, 0, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        hopper::wgmma_ss<kTile>(dp, hopper::desc_k<D>(dos, kRows, cw * 64, kk),
                                hopper::desc_k<D>(vs, kTile, 0, kk), kk > 0);
      hopper::wgmma_commit();
      hopper::wgmma_wait_all();
      hopper::fence_operand(sc);
      hopper::fence_operand(dp);
      const float* bs = bias_s + s * kTile;
      if (causal && (nokey || k0 + kTile - 1 > wq0 + off))
        dq_scores<true>(sc, dp, bs, k0, r0, r1, off, Tk, t4, scale_log2, lse0, lse1, dl0, dl1);
      else
        dq_scores<false>(sc, dp, bs, k0, r0, r1, off, Tk, t4, scale_log2, lse0, lse1, dl0, dl1);
      uint32_t da[kTile / 16][4];
#pragma unroll
      for (int kc = 0; kc < kTile / 16; ++kc) hopper::pack_a(da[kc], sc, kc);
      hopper::fence_operand(acc);
      hopper::wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < kTile / 16; ++kc)
        hopper::wgmma_rs<D>(acc, da[kc], hopper::desc_mn<D>(ks, kTile, kc), 1);
      hopper::wgmma_commit();
      hopper::wgmma_wait_all();
      hopper::fence_operand(acc);
    }
    hopper::mbar_arrive(&bars[1 + kStages + s]);  // release the stage
  }
  hopper::store_rows<D>(acc, scale, scale, smem + L::Q, kRows, cw * 64,
                        dq + (((long long)b * Tq + wq0) * H + h) * D, (long long)H * D, Tq - wq0,
                        1 + cw);
}

// P^T and dS^T of one query tile, in place of S^T and dP^T, with dbias's
// per-key sums (dk/dv kernel)
template <bool MASK>
__device__ __forceinline__ void dkv_scores(float (&st)[32], float (&dpt)[32], const float* ls,
                                           const float* dls, int rq0, int c0, int c1, int off,
                                           int Tk, int t4, float sl2, float bias0, float bias1,
                                           float& db0, float& db1) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 lv = *reinterpret_cast<const float2*>(ls + 8 * j + 2 * t4);
    const float2 dv = *reinterpret_cast<const float2*>(dls + 8 * j + 2 * t4);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float l = e ? lv.y : lv.x;
      const float dl = e ? dv.y : dv.x;
      float x0 = fmaf(st[4 * j + e], sl2, bias0);
      float x1 = fmaf(st[4 * j + 2 + e], sl2, bias1);
      if (MASK) {
        const int r = rq0 + 8 * j + 2 * t4 + e;
        if (c0 < Tk && c0 > r + off) x0 = kMaskL2;
        if (c1 < Tk && c1 > r + off) x1 = kMaskL2;
      }
      const float p0 = hopper::fast_exp2(x0 - l);
      const float p1 = hopper::fast_exp2(x1 - l);
      const float ds0 = p0 * (dpt[4 * j + e] - dl);
      const float ds1 = p1 * (dpt[4 * j + 2 + e] - dl);
      db0 += ds0;
      db1 += ds1;
      st[4 * j + e] = p0;
      st[4 * j + 2 + e] = p1;
      dpt[4 * j + e] = ds0;
      dpt[4 * j + 2 + e] = ds1;
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkv_bf16_kernel(const __grid_constant__ CUtensorMap tm_q,
                              const __grid_constant__ CUtensorMap tm_do,
                              const __grid_constant__ CUtensorMap tm_k,
                              const __grid_constant__ CUtensorMap tm_v,
                              const float* __restrict__ bias, const float* __restrict__ lse,
                              const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
                              __nv_bfloat16* __restrict__ dv, float* __restrict__ dbias, int Tq,
                              int Tk, int H, int causal, float scale, float scale_log2) {
  using L = DkvTiles<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hopper::align_1024(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::BAR);
  float* lse_s = reinterpret_cast<float*>(smem + L::LSE);
  float* delta_s = reinterpret_cast<float*>(smem + L::DELTA);
  const int k0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int off = Tk - Tq;
  const int t0 = first_query_tile(k0, Tq, Tk, kTile, causal);
  const int n_tiles = (Tq + kTile - 1) / kTile - t0;
  hopper::init_ring<kStages>(bars, 2 * 128);

  if (threadIdx.x < 128) {  // ---- producer warpgroup: K, V once, then Q/dO tiles and stats
    hopper::setmaxnreg_dec<40>();
    if (threadIdx.x < 32) {
      const float* lb = lse + ((long long)b * H + h) * Tq;
      const float* db = delta + ((long long)b * H + h) * Tq;
      hopper::ring_producer<D, kStages, kRows, kTile>(
          smem, bars, &tm_k, L::K, &tm_v, L::V, &tm_q, L::Q, &tm_do, L::DO, k0, t0, n_tiles, h, b,
          [&](int s, int rq0, int lane) {
            for (int j = lane; j < kTile; j += 32) {
              const int r = rq0 + j;
              lse_s[s * kTile + j] = r < Tq ? lb[r] * hopper::kLog2e : INFINITY;  // p = 0 past Tq
              delta_s[s * kTile + j] = r < Tq ? db[r] : 0.f;
            }
          });
    }
    return;
  }

  // ---- consumer warpgroups: 64 keys each
  hopper::setmaxnreg_inc<232>();
  const int cw = threadIdx.x / 128 - 1;
  const int tw = threadIdx.x % 128;
  const int g = (tw % 32) / 4;
  const int t4 = tw % 4;
  const int kw0 = k0 + cw * 64;  // this warpgroup's first key
  const int c0 = kw0 + (tw / 32) * 16 + g;
  const int c1 = c0 + 8;
  const float bias0 = c0 >= Tk ? -INFINITY
                               : (bias != nullptr ? bias[(long long)b * Tk + c0] * hopper::kLog2e
                                                  : 0.f);
  const float bias1 = c1 >= Tk ? -INFINITY
                               : (bias != nullptr ? bias[(long long)b * Tk + c1] * hopper::kLog2e
                                                  : 0.f);
  const uint32_t ks = hopper::smem_u32(smem + L::K);
  const uint32_t vs = hopper::smem_u32(smem + L::V);

  float dka[D / 2], dva[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;
  float db0 = 0.f, db1 = 0.f;

  hopper::mbar_wait(&bars[0], 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % kStages;
    const int rq0 = (t0 + it) * kTile;
    hopper::mbar_wait(&bars[1 + s], (it / kStages) & 1);
    const int r_last = min(rq0 + kTile - 1, Tq - 1);
    if (!causal || rq0 + off < 0 || kw0 <= r_last + off) {
      const uint32_t qs = hopper::smem_u32(smem + L::Q + s * kTile * D * 2);
      const uint32_t dos = hopper::smem_u32(smem + L::DO + s * kTile * D * 2);
      float st[32], dpt[32];
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        hopper::wgmma_ss<kTile>(st, hopper::desc_k<D>(ks, kRows, cw * 64, kk),
                                hopper::desc_k<D>(qs, kTile, 0, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        hopper::wgmma_ss<kTile>(dpt, hopper::desc_k<D>(vs, kRows, cw * 64, kk),
                                hopper::desc_k<D>(dos, kTile, 0, kk), kk > 0);
      hopper::wgmma_commit();
      hopper::wgmma_wait_all();
      hopper::fence_operand(st);
      hopper::fence_operand(dpt);
      const float* ls = lse_s + s * kTile;
      const float* dls = delta_s + s * kTile;
      if (causal && (rq0 + off < 0 || kw0 + 63 > rq0 + off))
        dkv_scores<true>(st, dpt, ls, dls, rq0, c0, c1, off, Tk, t4, scale_log2, bias0, bias1,
                         db0, db1);
      else
        dkv_scores<false>(st, dpt, ls, dls, rq0, c0, c1, off, Tk, t4, scale_log2, bias0, bias1,
                          db0, db1);
      uint32_t pa[kTile / 16][4], sa[kTile / 16][4];
#pragma unroll
      for (int kc = 0; kc < kTile / 16; ++kc) {
        hopper::pack_a(pa[kc], st, kc);
        hopper::pack_a(sa[kc], dpt, kc);
      }
      hopper::fence_operand(dva);
      hopper::fence_operand(dka);
      hopper::wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < kTile / 16; ++kc) {
        hopper::wgmma_rs<D>(dva, pa[kc], hopper::desc_mn<D>(dos, kTile, kc), 1);
        hopper::wgmma_rs<D>(dka, sa[kc], hopper::desc_mn<D>(qs, kTile, kc), 1);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait_all();
      hopper::fence_operand(dva);
      hopper::fence_operand(dka);
    }
    hopper::mbar_arrive(&bars[1 + kStages + s]);  // release the stage
  }

  db0 = hopper::quad_sum(db0);
  db1 = hopper::quad_sum(db1);
  if (t4 == 0) {
    float* dbb = dbias + ((long long)b * H + h) * Tk;
    if (c0 < Tk) dbb[c0] = db0;
    if (c1 < Tk) dbb[c1] = db1;
  }
  const long long row0 = ((long long)b * Tk + kw0) * H + h;
  hopper::store_rows<D>(dka, scale, scale, smem + L::K, kRows, cw * 64, dk + row0 * D,
                        (long long)H * D, Tk - kw0, 1 + cw);
  hopper::store_rows<D>(dva, 1.f, 1.f, smem + L::V, kRows, cw * 64, dv + row0 * D,
                        (long long)H * D, Tk - kw0, 1 + cw);
}

template <int D>
int launch_dq_bf16(const void* q, const void* k, const void* v, const void* bias,
                   const void* dout, const void* lse, const void* delta, void* dq, int B, int Tq,
                   int Tk, int H, int causal, float scale, cudaStream_t stream) {
  using L = DqTiles<D>;
  CUtensorMap tm_q, tm_do, tm_k, tm_v;
  int st = hopper::make_tensor_map<D>(&tm_q, q, B, Tq, H, kRows);
  if (st == 0) st = hopper::make_tensor_map<D>(&tm_do, dout, B, Tq, H, kRows);
  if (st == 0) st = hopper::make_tensor_map<D>(&tm_k, k, B, Tk, H, kTile);
  if (st == 0) st = hopper::make_tensor_map<D>(&tm_v, v, B, Tk, H, kTile);
  if (st != 0) return st;
  static bool smem_set[hopper::kMaxDevices] = {};
  st = hopper::allow_dynamic_smem((const void*)flash_bwd_dq_bf16_kernel<D>, L::SMEM, smem_set);
  if (st != 0) return st;
  const dim3 grid((Tq + kRows - 1) / kRows, H, B);
  flash_bwd_dq_bf16_kernel<D><<<grid, kThreads, L::SMEM, stream>>>(
      tm_q, tm_do, tm_k, tm_v, (const float*)bias, (const float*)lse, (const float*)delta,
      (__nv_bfloat16*)dq, Tq, Tk, H, causal, scale, scale * hopper::kLog2e);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv_bf16(const void* q, const void* k, const void* v, const void* bias,
                    const void* dout, const void* lse, const void* delta, void* dk, void* dv,
                    void* dbias, int B, int Tq, int Tk, int H, int causal, float scale,
                    cudaStream_t stream) {
  using L = DkvTiles<D>;
  CUtensorMap tm_q, tm_do, tm_k, tm_v;
  int st = hopper::make_tensor_map<D>(&tm_q, q, B, Tq, H, kTile);
  if (st == 0) st = hopper::make_tensor_map<D>(&tm_do, dout, B, Tq, H, kTile);
  if (st == 0) st = hopper::make_tensor_map<D>(&tm_k, k, B, Tk, H, kRows);
  if (st == 0) st = hopper::make_tensor_map<D>(&tm_v, v, B, Tk, H, kRows);
  if (st != 0) return st;
  static bool smem_set[hopper::kMaxDevices] = {};
  st = hopper::allow_dynamic_smem((const void*)flash_bwd_dkv_bf16_kernel<D>, L::SMEM, smem_set);
  if (st != 0) return st;
  const dim3 grid((Tk + kRows - 1) / kRows, H, B);
  flash_bwd_dkv_bf16_kernel<D><<<grid, kThreads, L::SMEM, stream>>>(
      tm_q, tm_do, tm_k, tm_v, (const float*)bias, (const float*)lse, (const float*)delta,
      (__nv_bfloat16*)dk, (__nv_bfloat16*)dv, (float*)dbias, Tq, Tk, H, causal, scale,
      scale * hopper::kLog2e);
  return (int)cudaGetLastError();
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

  const int n_tiles = key_tiles(q0, BQ, Tq, Tk, BK, causal);
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

int launch_dq_f32(const void* q, const void* k, const void* v, const void* bias,
                  const void* dout, const void* lse, const void* delta, void* dq, int B, int Tq,
                  int Tk, int H, int D, int causal, float scale, cudaStream_t s) {
  const dim3 grid((Tq + BQ - 1) / BQ, H, B);
#define VT_DQ_CASE(DD)                                                                    \
  case DD:                                                                                \
    flash_bwd_dq_f32_kernel<DD><<<grid, 256, 0, s>>>(                                     \
        (const float*)q, (const float*)k, (const float*)v, (const float*)bias,            \
        (const float*)dout, (const float*)lse, (const float*)delta, (float*)dq, Tq, Tk,   \
        H, causal, scale);                                                                \
    break;
  switch (D) {
    VT_DQ_CASE(16)
    VT_DQ_CASE(32)
    VT_DQ_CASE(64)
    VT_DQ_CASE(128)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef VT_DQ_CASE
  return (int)cudaGetLastError();
}

int launch_dkv_f32(const void* q, const void* k, const void* v, const void* bias,
                   const void* dout, const void* lse, const void* delta, void* dk, void* dv,
                   void* dbias, int B, int Tq, int Tk, int H, int D, int causal, float scale,
                   cudaStream_t s) {
  const dim3 grid((Tk + BKB - 1) / BKB, H, B);
#define VT_DKV_CASE(DD)                                                                   \
  case DD:                                                                                \
    flash_bwd_dkv_f32_kernel<DD><<<grid, 256, 0, s>>>(                                    \
        (const float*)q, (const float*)k, (const float*)v, (const float*)bias,            \
        (const float*)dout, (const float*)lse, (const float*)delta, (float*)dk,           \
        (float*)dv, (float*)dbias, Tq, Tk, H, causal, scale);                             \
    break;
  switch (D) {
    VT_DKV_CASE(16)
    VT_DKV_CASE(32)
    VT_DKV_CASE(64)
    VT_DKV_CASE(128)
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
  if (bad_shape(B, Tq, Tk, H)) return (int)cudaErrorInvalidValue;
  return launch_dq_f32(q, k, v, bias, dout, lse, delta, dq, B, Tq, Tk, H, D, causal, scale,
                       (cudaStream_t)stream);
}

extern "C" int vt_flash_attention_bwd_dq_bf16(const void* q, const void* k, const void* v,
                                              const void* bias, const void* dout,
                                              const void* lse, const void* delta, void* dq,
                                              int B, int Tq, int Tk, int H, int D, int causal,
                                              float scale, void* stream) {
  if (bad_shape(B, Tq, Tk, H)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 16:
      return launch_dq_bf16<16>(q, k, v, bias, dout, lse, delta, dq, B, Tq, Tk, H, causal,
                                scale, s);
    case 32:
      return launch_dq_bf16<32>(q, k, v, bias, dout, lse, delta, dq, B, Tq, Tk, H, causal,
                                scale, s);
    case 64:
      return launch_dq_bf16<64>(q, k, v, bias, dout, lse, delta, dq, B, Tq, Tk, H, causal,
                                scale, s);
    case 128:
      return launch_dq_bf16<128>(q, k, v, bias, dout, lse, delta, dq, B, Tq, Tk, H, causal,
                                 scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// as above; dk/dv (B, Tk, H*D), dbias (B, H, Tk) f32 per head
extern "C" int vt_flash_attention_bwd_dkv_f32(const void* q, const void* k, const void* v,
                                              const void* bias, const void* dout,
                                              const void* lse, const void* delta, void* dk,
                                              void* dv, void* dbias, int B, int Tq, int Tk,
                                              int H, int D, int causal, float scale,
                                              void* stream) {
  if (bad_shape(B, Tq, Tk, H)) return (int)cudaErrorInvalidValue;
  return launch_dkv_f32(q, k, v, bias, dout, lse, delta, dk, dv, dbias, B, Tq, Tk, H, D,
                        causal, scale, (cudaStream_t)stream);
}

extern "C" int vt_flash_attention_bwd_dkv_bf16(const void* q, const void* k, const void* v,
                                               const void* bias, const void* dout,
                                               const void* lse, const void* delta, void* dk,
                                               void* dv, void* dbias, int B, int Tq, int Tk,
                                               int H, int D, int causal, float scale,
                                               void* stream) {
  if (bad_shape(B, Tq, Tk, H)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 16:
      return launch_dkv_bf16<16>(q, k, v, bias, dout, lse, delta, dk, dv, dbias, B, Tq, Tk, H,
                                 causal, scale, s);
    case 32:
      return launch_dkv_bf16<32>(q, k, v, bias, dout, lse, delta, dk, dv, dbias, B, Tq, Tk, H,
                                 causal, scale, s);
    case 64:
      return launch_dkv_bf16<64>(q, k, v, bias, dout, lse, delta, dk, dv, dbias, B, Tq, Tk, H,
                                 causal, scale, s);
    case 128:
      return launch_dkv_bf16<128>(q, k, v, bias, dout, lse, delta, dk, dv, dbias, B, Tq, Tk,
                                  H, causal, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
