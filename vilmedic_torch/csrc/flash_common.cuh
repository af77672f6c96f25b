// What the flash-attention kernels share: flash_attention.cu (K4),
// flash_attention_bwd.cu (K5), and at the wide head dims
// flash_attention_wide_tc.cu and flash_attention_gemm.cu (the mask). The
// TPU kernels' finite mask, the tiles a block visits, and the per-tile score
// arithmetic on the wgmma accumulator layout (hopper_common.cuh): the
// forward's online softmax, the dq kernels' dS and the dk/dv kernels' P^T
// and dS^T.

#pragma once

#include "hopper_common.cuh"

namespace flash {

constexpr float kMaskValue = -1e9f;  // the TPU kernels' finite mask value
constexpr float kMaskL2 = kMaskValue * hopper::kLog2e;  // the finite mask, log2 domain

// Number of key tiles a block of query rows [q0, q0 + rows) visits: all of
// them, or under the causal mask those up to the one holding the last key its
// last real row may see. A block holding a row that sees no key at all
// (Tq > Tk) visits every tile: under the finite mask such a row averages V
// (and in the backward weighs every key).
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

// One key tile's scores -> probabilities, in place (log2 domain), with the
// running max and this lane's part of the row sums updated and the factors
// (alpha) that rescale the output accumulator returned (the forward).
template <bool MASK, int BK>
__device__ __forceinline__ void softmax_tile(float (&sc)[BK / 2], const float* bs, int k0, int r0,
                                             int r1, int off, int Tk, int t4, float sl2,
                                             float& m0, float& m1, float& l0, float& l1,
                                             float& alpha0, float& alpha1) {
  float mx0 = m0, mx1 = m1;
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
    const float2 bv = *reinterpret_cast<const float2*>(bs + 8 * j + 2 * t4);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float b = e ? bv.y : bv.x;
      float x0 = fmaf(sc[4 * j + e], sl2, b);
      float x1 = fmaf(sc[4 * j + 2 + e], sl2, b);
      if (MASK) {
        const int c = k0 + 8 * j + 2 * t4 + e;
        if (c < Tk) {
          if (c > r0 + off) x0 = kMaskL2;
          if (c > r1 + off) x1 = kMaskL2;
        }
      }
      sc[4 * j + e] = x0;
      sc[4 * j + 2 + e] = x1;
      mx0 = fmaxf(mx0, x0);
      mx1 = fmaxf(mx1, x1);
    }
  }
  mx0 = hopper::quad_max(mx0);
  mx1 = hopper::quad_max(mx1);
  alpha0 = hopper::fast_exp2(m0 - mx0);
  alpha1 = hopper::fast_exp2(m1 - mx1);
  m0 = mx0;
  m1 = mx1;
  float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      sc[4 * j + e] = hopper::fast_exp2(sc[4 * j + e] - mx0);
      sc[4 * j + 2 + e] = hopper::fast_exp2(sc[4 * j + 2 + e] - mx1);
      ps0 += sc[4 * j + e];
      ps1 += sc[4 * j + 2 + e];
    }
  }
  l0 = l0 * alpha0 + ps0;
  l1 = l1 * alpha1 + ps1;
}

// dS of one key tile, in place of S (the dq kernels).
template <bool MASK, int BK>
__device__ __forceinline__ void dq_scores(float (&sc)[BK / 2], const float (&dp)[BK / 2],
                                          const float* bs, int k0, int r0, int r1, int off,
                                          int Tk, int t4, float sl2, float lse0, float lse1,
                                          float dl0, float dl1) {
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
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

// P^T and dS^T of one tile of BQ query rows, in place of S^T and dP^T (the
// accumulator's rows are keys c0 and c1, its columns the tile's queries,
// whose lse (log2 domain) and delta are at ls and dls), with dbias's per-key
// sums (the dk/dv kernels).
template <bool MASK, int BQ>
__device__ __forceinline__ void dkv_scores(float (&st)[BQ / 2], float (&dpt)[BQ / 2], const float* ls,
                                           const float* dls, int rq0, int c0, int c1, int off,
                                           int Tk, int t4, float sl2, float bias0, float bias1,
                                           float& db0, float& db1) {
#pragma unroll
  for (int j = 0; j < BQ / 8; ++j) {
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

}  // namespace flash
