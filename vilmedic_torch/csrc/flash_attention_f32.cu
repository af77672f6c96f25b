// Flash attention in float32, forward (K4) and backward (K5), at head dims
// 16, 32, 64 and 128, on Hopper's tensor cores as three-pass TF32 (sm_90a).
//
// Replaces, in float32: vilmedic_tpu/ops/flash_attention.py::_kernel_v2 and
// ::_kernel (the forward, with `with_lse`, through `_flash_bthd` and
// `_flash_bhtd`), ::_bwd_dq_kernel_v2 / ::_bwd_dkv_kernel_v2 and
// ::_bwd_dq_kernel / ::_bwd_dkv_kernel (the backward, through
// `_flash_bwd_bthd` and `_flash_bwd_bhtd`). The function, the masking and the
// rounding points are those of the bf16 kernels (flash_attention.cu and
// flash_attention_bwd.cu give the formulas), which in f32 round nothing:
// f32 p, the finite -1e9 mask and running-max floor, the 1e-30 denominator
// floor, lse in natural log, dbias from the unrounded dS, every sum in a
// fixed order (no atomics: two runs are bitwise equal).
//
// What bounds it on the H100: at the VisionLanguage tower (B 16, T 1370,
// H 12, D 64) a forward is 4 * B * H * T^2 * D = 92 GFLOP. On the CUDA
// cores (67 TFLOP/s) that is 1.38 ms, and a kernel that reads one 32-bit
// shared-memory word per FMA gets about a quarter of it. TF32 on the tensor
// cores runs at 495 TFLOP/s but keeps 10 mantissa bits, which alone would
// miss the f32 route's parity with the plain version by two orders.
//
// Design: three passes. Each f32 operand a = hi + lo, hi = a rounded to TF32
// (nearest, ties away: (bits + 2^12) & ~(2^13 - 1)), lo = a - hi (exact in
// f32; the tensor core reads its TF32 truncation). A product is
// lo_a * hi_b + hi_a * lo_b + hi_a * hi_b, summed in the f32 accumulator
// (lo * lo, below 2^-22 of the product, is dropped), so 3 x 92 GFLOP at
// 495 TFLOP/s bound the tower at 0.56 ms.
//   - wgmma takes TF32 operands only K-major (no transpose bit): the depth of
//     the product runs along each operand's contiguous axis. A operands come
//     from registers: Q (and dO; K and V in dk/dv) is loaded once per thread
//     into shared memory in the register layout of wgmma m64nNk8's A
//     fragment (thread, k-step: (g, t4), (g + 8, t4), (g, t4 + 4),
//     (g + 8, t4 + 4)) and read back per k-step as one float4; P and dS come
//     from the score accumulator, whose columns 2 t4 and 2 t4 + 1 stand in
//     for the fragment's t4 and t4 + 4 (kperm: keys 0 2 4 6 1 3 5 7 of each
//     group of 8), with the B operand's keys stored in that order.
//   - B operands are split tiles in shared memory, 128-byte swizzled (64 at
//     16 columns) as the descriptors read them (hopper_common.cuh: an f32
//     tile of C columns is laid out as a bf16 tile of 2C). They are written
//     by threads, not TMA: the transposes and the split need a pass anyway.
//   - Warp-specialised: warpgroup 0 produces, warpgroups 1 and 2 (1 at head
//     dim 128 in the backward) consume 64 rows each (queries; keys in
//     dk/dv). The producer copies each K / V tile (Q / dO in dk/dv) by
//     cp.async into a plain row-major landing buffer, then writes into a
//     2-stage ring (1 stage for dk/dv at 128) its hi and lo halves, K-major
//     as landed for S = Q K^T, dP = dO V^T, S^T = K Q^T, dP^T = V dO^T, and,
//     transposed in kperm order in the same pass, those of the products
//     over keys (or queries): V^T for P V, K^T for dS K, Q^T and dO^T for
//     dS^T Q and P^T dO; with the tile's key bias (lse, delta); full / empty
//     mbarriers hand the stages over. The split runs under the consumers'
//     products; the consumers run independently of each other.
//   - The tensor core sums each tile's product from zero; a running f32 sum
//     across the tiles (RunningSum) adds it by round-to-nearest FMAs (the
//     forward's rescale by alpha folded in).
//   - Online softmax, dS, P^T / dS^T and the masks are flash_common.cuh's
//     (log2 domain, ex2.approx), on the same accumulator layout as bf16.
//   - Per head dim (Fwd, Dq, Dkv below) the key (query) tile, the consumer
//     warpgroups and the ring keep the shared memory (ring, landing buffer,
//     A fragments, running sums at 128) within 227 KB, and the registers
//     within the 168 a thread that three warpgroups leave, without spills
//     (255 with one consumer warpgroup). No setmaxnreg: a build that raised
//     the consumers to 224 still spilled where 168 did not suffice.
//   - Epilogues write f32 from the running sums (float2 a lane and row);
//     out is sum / max(l, 1e-30), dq / dk times the scale.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "flash_tf32.cuh"
#include "hopper_common.cuh"

namespace {

using namespace flash;
using namespace tf32;

// ------------------------------------------------------------------ forward

template <int D, int NC, int BK, int STAGES, bool MS>
__global__ void __launch_bounds__(128 * (NC + 1), 1)
    flash_fwd_three_pass_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                const float* __restrict__ v, const float* __restrict__ bias,
                                float* __restrict__ o, float* __restrict__ lse, int Tq, int Tk,
                                int H, int causal, float scale_log2) {
  // stage: K hi, lo, V^T hi, lo, key bias; areas Q (, O); landed K, V
  using L = Layout<D, NC, BK, STAGES, 4, 1 + MS>;
  constexpr int NT = L::NT;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hopper::align_1024(smem_raw);
  uint64_t* bars = init_split_ring<STAGES, NC>(L::bars(smem));
  const int q0 = blockIdx.x * 64 * NC, h = blockIdx.y, b = blockIdx.z;
  const int off = Tk - Tq;
  const long long HD = (long long)H * D;
  const int n_tiles = key_tiles(q0, 64 * NC, Tq, Tk, BK, causal);

  if (threadIdx.x < 128) {  // ---- producer: K, V tiles split into the ring, with the key bias
    const int tid = threadIdx.x;
    const float* kb = k + (long long)b * Tk * HD + (long long)h * D;
    const float* vb = v + (long long)b * Tk * HD + (long long)h * D;
    produce<STAGES>(
        bars, n_tiles,
        [&](int it) {
          land_rows<BK, D, 128>(L::land(smem, 0), kb, HD, it * BK, Tk, tid);
          land_rows<BK, D, 128>(L::land(smem, 1), vb, HD, it * BK, Tk, tid);
        },
        [&](int s, int it) {
          split_tile<BK, D, 128, true, false>(L::land(smem, 0), L::tile(smem, s, 0),
                                              L::tile(smem, s, 1), nullptr, nullptr, tid);
          split_tile<BK, D, 128, false, true>(L::land(smem, 1), nullptr, nullptr,
                                              L::tile(smem, s, 2), L::tile(smem, s, 3), tid);
          stage_bias(L::stats(smem, s), bias, b, Tk, it * BK, BK, tid);
        });
    return;
  }

  // ---- consumers: 64 query rows a warpgroup
  const int tid = threadIdx.x - 128;
  const int tw = tid % 128, g = (tw % 32) / 4, t4 = tw % 4;
  const int wq0 = q0 + (tid / 128) * 64;  // this warpgroup's first row
  const int r0 = wq0 + (tw / 32) * 16 + g, r1 = r0 + 8;
  const int w_last = min(wq0 + 63, Tq - 1);
  const bool nokey = causal && wq0 + off < 0;  // holds a row that sees no key
  const float4* qa = L::area(smem, 0);
  stash_fragments<D, NT>(L::area(smem, 0), q + (long long)b * Tq * HD + (long long)h * D, HD,
                         r0, Tq, tid);
  RunningSum<D / 2, MS, NT> o_sum(L::area(smem, 1), tid);
  float m0 = kMaskL2, m1 = kMaskL2;  // running row maxima (log2 domain)
  float l0 = 0.f, l1 = 0.f;          // this lane's part of the denominators

  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % STAGES;
    const int k0 = it * BK;
    hopper::mbar_wait(&bars[s], (it / STAGES) & 1);
    if (!causal || nokey || k0 <= w_last + off) {
      float sc[BK / 2], pv[D / 2];
      mma_tf32x3<BK, D, 8>(
          sc, [&](int kk, float (&r)[4]) { area_fragment(qa, kk, NT, tid, r); },
          L::tile_u32(smem, s, 0), L::tile_u32(smem, s, 1));
      float alpha0, alpha1;
      const float* bs = L::stats(smem, s);
      if (causal && (nokey || k0 + BK - 1 > wq0 + off))
        softmax_tile<true, BK>(sc, bs, k0, r0, r1, off, Tk, t4, scale_log2, m0, m1, l0, l1,
                               alpha0, alpha1);
      else
        softmax_tile<false, BK>(sc, bs, k0, r0, r1, off, Tk, t4, scale_log2, m0, m1, l0, l1,
                                alpha0, alpha1);
      mma_tf32x3<D, BK, 8>(
          pv, [&](int kk, float (&r)[4]) { acc_fragment(sc, kk, r); }, L::tile_u32(smem, s, 2),
          L::tile_u32(smem, s, 3));
      o_sum.add(pv, alpha0, alpha1);
    }
    hopper::mbar_arrive(&bars[STAGES + s]);  // release the stage
  }

  l0 = hopper::quad_sum(l0);
  l1 = hopper::quad_sum(l1);
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  float out[D / 2];
  o_sum.load(out);
  store_acc<D, true>(out, d0, d1, o + (long long)b * Tq * HD + (long long)h * D, HD, r0, Tq, t4);
  if (lse != nullptr && t4 == 0) {
    float* lb = lse + ((long long)b * H + h) * Tq;
    if (r0 < Tq) lb[r0] = m0 * hopper::kLn2 + logf(d0);
    if (r1 < Tq) lb[r1] = m1 * hopper::kLn2 + logf(d1);
  }
}

// ------------------------------------------------------------------------ dq

template <int D, int NC, int BK, int STAGES, bool MS>
__global__ void __launch_bounds__(128 * (NC + 1), 1)
    flash_bwd_dq_three_pass_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                   const float* __restrict__ v, const float* __restrict__ bias,
                                   const float* __restrict__ dout, const float* __restrict__ lse,
                                   const float* __restrict__ delta, float* __restrict__ dq,
                                   int Tq, int Tk, int H, int causal, float scale,
                                   float scale_log2) {
  // stage: K hi, lo, V hi, lo, K^T hi, lo, key bias; areas Q, dO (, dq);
  // landed K, V
  using L = Layout<D, NC, BK, STAGES, 6, 2 + MS>;
  constexpr int NT = L::NT;
  constexpr int CH = D >= 128 ? 4 : 8;  // A halves of 4 k-steps beside a 64-register dq
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hopper::align_1024(smem_raw);
  uint64_t* bars = init_split_ring<STAGES, NC>(L::bars(smem));
  const int q0 = blockIdx.x * 64 * NC, h = blockIdx.y, b = blockIdx.z;
  const int off = Tk - Tq;
  const long long HD = (long long)H * D;
  const int n_tiles = key_tiles(q0, 64 * NC, Tq, Tk, BK, causal);

  if (threadIdx.x < 128) {  // ---- producer: K (direct and transposed), V, key bias
    const int tid = threadIdx.x;
    const float* kb = k + (long long)b * Tk * HD + (long long)h * D;
    const float* vb = v + (long long)b * Tk * HD + (long long)h * D;
    produce<STAGES>(
        bars, n_tiles,
        [&](int it) {
          land_rows<BK, D, 128>(L::land(smem, 0), kb, HD, it * BK, Tk, tid);
          land_rows<BK, D, 128>(L::land(smem, 1), vb, HD, it * BK, Tk, tid);
        },
        [&](int s, int it) {
          split_tile<BK, D, 128, true, true>(L::land(smem, 0), L::tile(smem, s, 0),
                                             L::tile(smem, s, 1), L::tile(smem, s, 4),
                                             L::tile(smem, s, 5), tid);
          split_tile<BK, D, 128, true, false>(L::land(smem, 1), L::tile(smem, s, 2),
                                              L::tile(smem, s, 3), nullptr, nullptr, tid);
          stage_bias(L::stats(smem, s), bias, b, Tk, it * BK, BK, tid);
        });
    return;
  }

  // ---- consumers: 64 query rows a warpgroup
  const int tid = threadIdx.x - 128;
  const int tw = tid % 128, g = (tw % 32) / 4, t4 = tw % 4;
  const int wq0 = q0 + (tid / 128) * 64;
  const int r0 = wq0 + (tw / 32) * 16 + g, r1 = r0 + 8;
  const int w_last = min(wq0 + 63, Tq - 1);
  const bool nokey = causal && wq0 + off < 0;
  const long long qoff = (long long)b * Tq * HD + (long long)h * D;
  const float* lb = lse + ((long long)b * H + h) * Tq;
  const float* db = delta + ((long long)b * H + h) * Tq;
  const float lse0 = r0 < Tq ? lb[r0] * hopper::kLog2e : 0.f;
  const float lse1 = r1 < Tq ? lb[r1] * hopper::kLog2e : 0.f;
  const float dl0 = r0 < Tq ? db[r0] : 0.f;
  const float dl1 = r1 < Tq ? db[r1] : 0.f;
  const float4* qa = L::area(smem, 0);
  const float4* da = L::area(smem, 1);
  stash_fragments<D, NT>(L::area(smem, 0), q + qoff, HD, r0, Tq, tid);
  stash_fragments<D, NT>(L::area(smem, 1), dout + qoff, HD, r0, Tq, tid);
  RunningSum<D / 2, MS, NT> dq_sum(L::area(smem, 2), tid);

  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % STAGES;
    const int k0 = it * BK;
    hopper::mbar_wait(&bars[s], (it / STAGES) & 1);
    if (!causal || nokey || k0 <= w_last + off) {
      float sc[BK / 2], dp[BK / 2], dqt[D / 2];
      mma_tf32x3<BK, D, CH>(
          sc, [&](int kk, float (&r)[4]) { area_fragment(qa, kk, NT, tid, r); },
          L::tile_u32(smem, s, 0), L::tile_u32(smem, s, 1));
      mma_tf32x3<BK, D, CH>(
          dp, [&](int kk, float (&r)[4]) { area_fragment(da, kk, NT, tid, r); },
          L::tile_u32(smem, s, 2), L::tile_u32(smem, s, 3));
      const float* bs = L::stats(smem, s);
      if (causal && (nokey || k0 + BK - 1 > wq0 + off))
        dq_scores<true, BK>(sc, dp, bs, k0, r0, r1, off, Tk, t4, scale_log2, lse0, lse1, dl0,
                            dl1);
      else
        dq_scores<false, BK>(sc, dp, bs, k0, r0, r1, off, Tk, t4, scale_log2, lse0, lse1, dl0,
                             dl1);
      mma_tf32x3<D, BK, 8>(
          dqt, [&](int kk, float (&r)[4]) { acc_fragment(sc, kk, r); }, L::tile_u32(smem, s, 4),
          L::tile_u32(smem, s, 5));
      dq_sum.add(dqt, 1.f, 1.f);
    }
    hopper::mbar_arrive(&bars[STAGES + s]);
  }
  float acc[D / 2];
  dq_sum.load(acc);
  store_acc<D, false>(acc, scale, scale, dq + qoff, HD, r0, Tq, t4);
}

// -------------------------------------------------------------------- dk / dv

template <int D, int NC, int BQ, int STAGES, bool MS>
__global__ void __launch_bounds__(128 * (NC + 1), 1)
    flash_bwd_dkv_three_pass_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                    const float* __restrict__ v, const float* __restrict__ bias,
                                    const float* __restrict__ dout, const float* __restrict__ lse,
                                    const float* __restrict__ delta, float* __restrict__ dk,
                                    float* __restrict__ dv, float* __restrict__ dbias, int Tq,
                                    int Tk, int H, int causal, float scale, float scale_log2) {
  // stage: Q hi, lo, dO hi, lo, Q^T hi, lo, dO^T hi, lo, lse and delta;
  // areas K, V (, dk, dv); landed Q, dO
  using L = Layout<D, NC, BQ, STAGES, 8, 2 + 2 * MS>;
  constexpr int NT = L::NT;
  constexpr int CH = D >= 64 ? 4 : 8;  // beside two running sums in registers (or D 128)
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hopper::align_1024(smem_raw);
  uint64_t* bars = init_split_ring<STAGES, NC>(L::bars(smem));
  const int k0 = blockIdx.x * 64 * NC, h = blockIdx.y, b = blockIdx.z;
  const int off = Tk - Tq;
  const long long HD = (long long)H * D;
  const int t0 = first_query_tile(k0, Tq, Tk, BQ, causal);
  const int n_tiles = (Tq + BQ - 1) / BQ - t0;
  const float* lb = lse + ((long long)b * H + h) * Tq;
  const float* db = delta + ((long long)b * H + h) * Tq;

  if (threadIdx.x < 128) {  // ---- producer: Q, dO (direct and transposed), lse, delta
    const int tid = threadIdx.x;
    const float* qb = q + (long long)b * Tq * HD + (long long)h * D;
    const float* ob = dout + (long long)b * Tq * HD + (long long)h * D;
    produce<STAGES>(
        bars, n_tiles,
        [&](int it) {
          land_rows<BQ, D, 128>(L::land(smem, 0), qb, HD, (t0 + it) * BQ, Tq, tid);
          land_rows<BQ, D, 128>(L::land(smem, 1), ob, HD, (t0 + it) * BQ, Tq, tid);
        },
        [&](int s, int it) {
          split_tile<BQ, D, 128, true, true>(L::land(smem, 0), L::tile(smem, s, 0),
                                             L::tile(smem, s, 1), L::tile(smem, s, 4),
                                             L::tile(smem, s, 5), tid);
          split_tile<BQ, D, 128, true, true>(L::land(smem, 1), L::tile(smem, s, 2),
                                             L::tile(smem, s, 3), L::tile(smem, s, 6),
                                             L::tile(smem, s, 7), tid);
          if (tid < BQ) {
            const int r = (t0 + it) * BQ + tid;
            float* st = L::stats(smem, s);
            st[tid] = r < Tq ? lb[r] * hopper::kLog2e : INFINITY;  // p = 0 past Tq
            st[BQ + tid] = r < Tq ? db[r] : 0.f;
          }
        });
    return;
  }

  // ---- consumers: 64 keys a warpgroup
  const int tid = threadIdx.x - 128;
  const int tw = tid % 128, g = (tw % 32) / 4, t4 = tw % 4;
  const int kw0 = k0 + (tid / 128) * 64;  // this warpgroup's first key
  const int c0 = kw0 + (tw / 32) * 16 + g, c1 = c0 + 8;
  const float bias0 = c0 >= Tk ? -INFINITY
                               : (bias != nullptr ? bias[(long long)b * Tk + c0] * hopper::kLog2e
                                                  : 0.f);
  const float bias1 = c1 >= Tk ? -INFINITY
                               : (bias != nullptr ? bias[(long long)b * Tk + c1] * hopper::kLog2e
                                                  : 0.f);
  const long long koff = (long long)b * Tk * HD + (long long)h * D;
  const float4* ka = L::area(smem, 0);
  const float4* va = L::area(smem, 1);
  stash_fragments<D, NT>(L::area(smem, 0), k + koff, HD, c0, Tk, tid);
  stash_fragments<D, NT>(L::area(smem, 1), v + koff, HD, c0, Tk, tid);
  RunningSum<D / 2, MS, NT> dk_sum(L::area(smem, 2), tid), dv_sum(L::area(smem, 3), tid);
  float db0 = 0.f, db1 = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % STAGES;
    const int rq0 = (t0 + it) * BQ;
    hopper::mbar_wait(&bars[s], (it / STAGES) & 1);
    const int r_last = min(rq0 + BQ - 1, Tq - 1);
    if (!causal || rq0 + off < 0 || kw0 <= r_last + off) {
      float st[BQ / 2], dpt[BQ / 2], t[D / 2];
      mma_tf32x3<BQ, D, CH>(
          st, [&](int kk, float (&r)[4]) { area_fragment(ka, kk, NT, tid, r); },
          L::tile_u32(smem, s, 0), L::tile_u32(smem, s, 1));
      mma_tf32x3<BQ, D, CH>(
          dpt, [&](int kk, float (&r)[4]) { area_fragment(va, kk, NT, tid, r); },
          L::tile_u32(smem, s, 2), L::tile_u32(smem, s, 3));
      const float* ls = L::stats(smem, s);
      if (causal && (rq0 + off < 0 || kw0 + 63 > rq0 + off))
        dkv_scores<true, BQ>(st, dpt, ls, ls + BQ, rq0, c0, c1, off, Tk, t4, scale_log2, bias0,
                             bias1, db0, db1);
      else
        dkv_scores<false, BQ>(st, dpt, ls, ls + BQ, rq0, c0, c1, off, Tk, t4, scale_log2, bias0,
                              bias1, db0, db1);
      mma_tf32x3<D, BQ, 8>(
          t, [&](int kk, float (&r)[4]) { acc_fragment(st, kk, r); }, L::tile_u32(smem, s, 6),
          L::tile_u32(smem, s, 7));
      dv_sum.add(t, 1.f, 1.f);
      mma_tf32x3<D, BQ, 8>(
          t, [&](int kk, float (&r)[4]) { acc_fragment(dpt, kk, r); }, L::tile_u32(smem, s, 4),
          L::tile_u32(smem, s, 5));
      dk_sum.add(t, 1.f, 1.f);
    }
    hopper::mbar_arrive(&bars[STAGES + s]);
  }

  db0 = hopper::quad_sum(db0);
  db1 = hopper::quad_sum(db1);
  if (t4 == 0) {
    float* dbb = dbias + ((long long)b * H + h) * Tk;
    if (c0 < Tk) dbb[c0] = db0;
    if (c1 < Tk) dbb[c1] = db1;
  }
  float acc[D / 2];
  dk_sum.load(acc);
  store_acc<D, false>(acc, scale, scale, dk + koff, HD, c0, Tk, t4);
  dv_sum.load(acc);
  store_acc<D, false>(acc, 1.f, 1.f, dv + koff, HD, c0, Tk, t4);
}

// ------------------------------------------------------------------ launches

// (NC consumer warpgroups, rows of a streamed tile, ring stages, running sums
// in shared memory) by head dim: within 227 KB of shared memory and the
// registers (chip_smoke.py prints ptxas's counts; 64-query dk/dv tiles at
// D 32 spilled)
template <int D>
struct Fwd {
  static constexpr int NC = 2, BK = D <= 32 ? 128 : D == 64 ? 64 : 16, STAGES = 2;
  static constexpr bool MS = D >= 128;
};
template <int D>
struct Dq {
  static constexpr int NC = D >= 128 ? 1 : 2, BK = D <= 32 ? 64 : 2048 / D, STAGES = 2;
  static constexpr bool MS = D >= 128;
};
template <int D>
struct Dkv {
  static constexpr int NC = D >= 128 ? 1 : 2, BQ = D <= 16 ? 64 : D >= 128 ? 16 : 32;
  static constexpr int STAGES = D >= 128 ? 1 : 2;
  static constexpr bool MS = D >= 128;
};

template <int D>
int launch_fwd(const void* q, const void* k, const void* v, const void* bias, void* o, void* lse,
               int B, int Tq, int Tk, int H, int causal, float scale, cudaStream_t s) {
  using C = Fwd<D>;
  constexpr int SMEM = Layout<D, C::NC, C::BK, C::STAGES, 4, 1 + C::MS>::SMEM;
  static bool done[hopper::kMaxDevices] = {};
  const auto kernel = flash_fwd_three_pass_kernel<D, C::NC, C::BK, C::STAGES, C::MS>;
  const int st = hopper::allow_dynamic_smem((const void*)kernel, SMEM, done);
  if (st != 0) return st;
  const dim3 grid((Tq + 64 * C::NC - 1) / (64 * C::NC), H, B);
  kernel<<<grid, 128 * (C::NC + 1), SMEM, s>>>((const float*)q, (const float*)k,
                                               (const float*)v, (const float*)bias, (float*)o,
                                               (float*)lse, Tq, Tk, H, causal,
                                               scale * hopper::kLog2e);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* bias, const void* dout,
              const void* lse, const void* delta, void* dq, int B, int Tq, int Tk, int H,
              int causal, float scale, cudaStream_t s) {
  using C = Dq<D>;
  constexpr int SMEM = Layout<D, C::NC, C::BK, C::STAGES, 6, 2 + C::MS>::SMEM;
  static bool done[hopper::kMaxDevices] = {};
  const auto kernel = flash_bwd_dq_three_pass_kernel<D, C::NC, C::BK, C::STAGES, C::MS>;
  const int st = hopper::allow_dynamic_smem((const void*)kernel, SMEM, done);
  if (st != 0) return st;
  const dim3 grid((Tq + 64 * C::NC - 1) / (64 * C::NC), H, B);
  kernel<<<grid, 128 * (C::NC + 1), SMEM, s>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)bias, (const float*)dout,
      (const float*)lse, (const float*)delta, (float*)dq, Tq, Tk, H, causal, scale,
      scale * hopper::kLog2e);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* bias, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv, void* dbias, int B,
               int Tq, int Tk, int H, int causal, float scale, cudaStream_t s) {
  using C = Dkv<D>;
  constexpr int SMEM = Layout<D, C::NC, C::BQ, C::STAGES, 8, 2 + 2 * C::MS>::SMEM;
  static bool done[hopper::kMaxDevices] = {};
  const auto kernel = flash_bwd_dkv_three_pass_kernel<D, C::NC, C::BQ, C::STAGES, C::MS>;
  const int st = hopper::allow_dynamic_smem((const void*)kernel, SMEM, done);
  if (st != 0) return st;
  const dim3 grid((Tk + 64 * C::NC - 1) / (64 * C::NC), H, B);
  kernel<<<grid, 128 * (C::NC + 1), SMEM, s>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)bias, (const float*)dout,
      (const float*)lse, (const float*)delta, (float*)dk, (float*)dv, (float*)dbias, Tq, Tk, H,
      causal, scale, scale * hopper::kLog2e);
  return (int)cudaGetLastError();
}

bool bad_shape(int B, int Tq, int Tk, int H) {
  return B <= 0 || Tq <= 0 || Tk <= 0 || H <= 0 || B > 65535 || H > 65535;
}

}  // namespace

// q (B, Tq, H*D), k/v (B, Tk, H*D) f32, bias (B, Tk) f32 additive or null,
// o like q, lse (B, H, Tq) f32 or null; D 16, 32, 64 or 128
extern "C" int vt_flash_attention_f32(const void* q, const void* k, const void* v,
                                      const void* bias, void* o, void* lse, int B, int Tq,
                                      int Tk, int H, int D, int causal, float scale,
                                      void* stream) {
  if (bad_shape(B, Tq, Tk, H)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 16:
      return launch_fwd<16>(q, k, v, bias, o, lse, B, Tq, Tk, H, causal, scale, s);
    case 32:
      return launch_fwd<32>(q, k, v, bias, o, lse, B, Tq, Tk, H, causal, scale, s);
    case 64:
      return launch_fwd<64>(q, k, v, bias, o, lse, B, Tq, Tk, H, causal, scale, s);
    case 128:
      return launch_fwd<128>(q, k, v, bias, o, lse, B, Tq, Tk, H, causal, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// q/dout/dq (B, Tq, H*D), k/v (B, Tk, H*D) f32, bias (B, Tk) f32 additive or
// null, lse/delta (B, H, Tq) f32
extern "C" int vt_flash_attention_bwd_dq_f32(const void* q, const void* k, const void* v,
                                             const void* bias, const void* dout,
                                             const void* lse, const void* delta, void* dq,
                                             int B, int Tq, int Tk, int H, int D, int causal,
                                             float scale, void* stream) {
  if (bad_shape(B, Tq, Tk, H)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 16:
      return launch_dq<16>(q, k, v, bias, dout, lse, delta, dq, B, Tq, Tk, H, causal, scale, s);
    case 32:
      return launch_dq<32>(q, k, v, bias, dout, lse, delta, dq, B, Tq, Tk, H, causal, scale, s);
    case 64:
      return launch_dq<64>(q, k, v, bias, dout, lse, delta, dq, B, Tq, Tk, H, causal, scale, s);
    case 128:
      return launch_dq<128>(q, k, v, bias, dout, lse, delta, dq, B, Tq, Tk, H, causal, scale, s);
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
  const cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 16:
      return launch_dkv<16>(q, k, v, bias, dout, lse, delta, dk, dv, dbias, B, Tq, Tk, H, causal,
                            scale, s);
    case 32:
      return launch_dkv<32>(q, k, v, bias, dout, lse, delta, dk, dv, dbias, B, Tq, Tk, H, causal,
                            scale, s);
    case 64:
      return launch_dkv<64>(q, k, v, bias, dout, lse, delta, dk, dv, dbias, B, Tq, Tk, H, causal,
                            scale, s);
    case 128:
      return launch_dkv<128>(q, k, v, bias, dout, lse, delta, dk, dv, dbias, B, Tq, Tk, H, causal,
                             scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
