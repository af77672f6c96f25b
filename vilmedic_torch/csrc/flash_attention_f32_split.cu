// Flash attention in float32 at the wide head dims, forward (K4) and
// backward (K5), on Hopper's tensor cores as three-pass TF32 (sm_90a), the
// head dim split across a thread block cluster: every padded head dim from
// 192 to 1024 (n = D / 64 CTAs of 64 columns, 3 to 16).
//
// Replaces, in float32 at those head dims:
// vilmedic_tpu/ops/flash_attention.py::_kernel (the forward, with
// `with_lse`, through `_flash_bhtd`, :161) and ::_bwd_dq_kernel /
// ::_bwd_dkv_kernel (the backward, through `_flash_bwd_bhtd`, :569 and
// :581), JAX's v1 path, which takes any head dim. The function, the masking
// and the rounding points are flash_attention_f32.cu's: f32 p, the finite
// -1e9 mask and running-max floor, the 1e-30 denominator floor, the causal
// limit c <= r + Tk - Tq, lse in natural log, dbias per head from the
// unrounded dS; ragged tails are masked here (keys past Tk carry a -inf
// bias, query rows past Tq a +inf lse and are not stored), the wrapper pads
// only the head dim.
//
// What bounds it on the H100: the tensor cores. At B 16, T 1370, 3 heads of
// 320 the forward is 4 * B * H * T^2 * D = 115 GFLOP, three TF32 passes of
// it at 495 TFLOP/s 0.70 ms (1.72 ms at the f32 FMA rate, 67 TFLOP/s); the
// bytes (72 MB of q, k, v and out at 3.35 TB/s, 0.02 ms) do not bound it.
//
// Design: flash_attention_f32.cu's three passes (each operand split into
// hi + lo, lo hi + hi lo + hi hi on register-A wgmma m64nNk8, a producer
// warpgroup that lands each tile by cp.async and writes its hi / lo halves,
// direct and transposed in kperm order, into a ring; each tile's product
// summed from zero and added to a running f32 sum by round-to-nearest
// FMAs: flash_tf32.cuh), joined with flash_attention_wide_tc.cu's split of
// the head dim (split_rounds.cuh):
//   - A cluster of n CTAs shares one block of 64 rows (queries; keys in
//     dk/dv). Each CTA holds 64 columns of Q, K, V and dO (its lands start
//     at column rank * 64) and writes those columns of O, dQ, dK and dV; no
//     product is repeated across the cluster. One consumer warpgroup and the
//     producer warpgroup: 256 threads, so a thread keeps up to 255
//     registers.
//   - Each tile's partial S (and dP; S^T and dP^T in dk/dv) over the CTA's
//     columns, three passes, is a round: summed over the cluster in rank
//     order, so every CTA holds the same bits of S and runs the same
//     softmax, masks and dS (lse and dbias written by rank 0). The sum is a
//     reduce-scatter, then an all-gather, both pushed by st.async onto the
//     receivers' mbarriers (split_rounds.cuh): each CTA sums n slots of a
//     1/n slice and sends the sums, about two partial tiles moved a CTA and
//     round whatever n. Reading the n - 1 other partials through distributed
//     shared memory, as flash_attention_wide_tc.cu does from 3 CTAs, cost
//     the forward about as much time on an H100 as its products (PERF.md).
//   - Both hops of a round are hidden. Step it: tile it's round is reduced
//     (its scatter went out a step before), tile it + 1's partial is
//     computed and scattered, tile it - 1's output product runs (P V, dS K,
//     P^T dO and dS^T Q), then tile it's round is collected. The 3-stage
//     ring holds tiles it - 1 to it + 1; 2 sets of exchange buffers rotate.
//     Tiles: 32 keys forward, 16 keys (dq) or query rows (dk/dv) backward,
//     within 227 KB of shared memory (ring, two landing buffers, A
//     fragments, exchange buffers).
//   - The dk/dv kernel visits every query tile from the first that may see
//     its keys: a tile that sees none (Tq > Tk) gives p = 0 exactly, so it
//     adds zeros, and every CTA takes the same rounds.
//   - 128-column shares (heads above 1024) do not fit: the dq kernel's ring
//     of K, V and K^T halves (3 stages of 16-key tiles, 150 KB), its landing
//     buffer and its Q and dO fragments (64 KB) pass 227 KB. Wider f32 heads
//     run on flash_attention_gemm.cu.
//   - Deterministic: no atomics; every output element is written by one
//     block, and every sum runs in a fixed order.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "flash_tf32.cuh"
#include "hopper_common.cuh"
#include "split_rounds.cuh"

namespace {

using namespace flash;
using namespace tf32;

constexpr int kShare = 64;     // columns of the head a CTA holds
constexpr int kThreads = 256;  // the producer warpgroup, then the consumer warpgroup
constexpr int kStages = 3;
constexpr int kLands = 2;    // landing buffers: the next tile's copies run while one is split
constexpr int kBuffers = 2;  // sets of exchange buffers (rounds in flight)
constexpr int kUnits = 4;    // float4s of a round's partial a thread (16 floats)

// the per-kernel shared memory (flash_tf32.cuh's Layout, one consumer
// warpgroup): split tiles a stage, A-fragment areas, the exchange buffers,
// and the rounds' barriers (two a set) after the ring's
template <int BK, int SPLITS, int AREAS>
using SplitLayout = Layout<kShare, 1, BK, kStages, SPLITS, AREAS,
                           kBuffers * rounds::set_units<kUnits>() * 16, 2 * kBuffers, kLands>;

// landing buffer of tensor i (0, 1) of tile it
template <typename L>
__device__ __forceinline__ float* landed(uint8_t* smem, int it, int i) {
  return L::land(smem, 2 * (it % kLands) + i);
}

constexpr int kXFull = 2 * kStages;  // the rounds' barriers, after full[] and empty[]

// The barriers of a split kernel: the ring's (one consumer warpgroup) and
// the rounds', then a cluster barrier, so that no CTA pushes into another
// before its barriers are set. No barrier is needed at the end: every byte
// pushed into a CTA is waited for by that CTA before it exits, and no CTA
// reads another's shared memory.
__device__ __forceinline__ void init_split_barriers(uint64_t* bars) {
  rounds::init_barriers(bars, kXFull, 2 * kBuffers, rounds::kGroup);
  init_split_ring<kStages, 1>(bars);
  hopper::cluster_sync();
}

// ------------------------------------------------------------------ forward

struct FwdSplit {
  static constexpr int BK = 32;
  // stage: K hi, lo, V^T hi, lo, key bias; area Q; partial S
  using L = SplitLayout<BK, 4, 1>;
  static_assert(BK / 2 == 4 * kUnits, "a round: one m64nBK tile");
};

__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_split_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, const float* __restrict__ bias,
                           float* __restrict__ o, float* __restrict__ lse, int Tq, int Tk, int H,
                           int causal, float scale_log2) {
  using L = FwdSplit::L;
  constexpr int BK = FwdSplit::BK;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hopper::align_1024(smem_raw);
  uint64_t* bars = L::bars(smem);
  const uint32_t n = hopper::cluster_size(), rank = hopper::cluster_rank();
  const int q0 = blockIdx.x / n * rounds::kRows, h = blockIdx.y, b = blockIdx.z;
  const int off = Tk - Tq;
  const long long HD = (long long)H * n * kShare;
  const long long col = (long long)h * n * kShare + rank * kShare;  // this CTA's first column
  const int n_tiles = key_tiles(q0, rounds::kRows, Tq, Tk, BK, causal);
  init_split_barriers(bars);

  if (threadIdx.x < 128) {  // ---- producer: K, V tiles split into the ring, with the key bias
    const int tid = threadIdx.x;
    const float* kb = k + (long long)b * Tk * HD + col;
    const float* vb = v + (long long)b * Tk * HD + col;
    produce<kStages, kLands>(
        bars, n_tiles,
        [&](int it) {
          land_rows<BK, kShare, 128>(landed<L>(smem, it, 0), kb, HD, it * BK, Tk, tid);
          land_rows<BK, kShare, 128>(landed<L>(smem, it, 1), vb, HD, it * BK, Tk, tid);
        },
        [&](int s, int it) {
          split_tile<BK, kShare, 128, true, false>(landed<L>(smem, it, 0), L::tile(smem, s, 0),
                                                   L::tile(smem, s, 1), nullptr, nullptr, tid);
          split_tile<BK, kShare, 128, false, true>(landed<L>(smem, it, 1), nullptr, nullptr,
                                                   L::tile(smem, s, 2), L::tile(smem, s, 3), tid);
          stage_bias(L::stats(smem, s), bias, b, Tk, it * BK, BK, tid);
        });
    return;
  }

  // ---- the consumer warpgroup: 64 query rows
  const int tid = threadIdx.x - 128;
  const int g = (tid % 32) / 4, t4 = tid % 4;
  const int r0 = q0 + (tid / 32) * 16 + g, r1 = r0 + 8;
  const bool nokey = causal && q0 + off < 0;  // holds a row that sees no key
  const float4* qa = L::area(smem, 0);
  stash_fragments<kShare, 128>(L::area(smem, 0), q + (long long)b * Tq * HD + col, HD, r0, Tq,
                               tid);
  RunningSum<kShare / 2, false, 128> o_sum(L::area(smem, 0), tid);
  float m0 = kMaskL2, m1 = kMaskL2;  // running row maxima (log2 domain)
  float l0 = 0.f, l1 = 0.f;          // this lane's part of the denominators
  float4* xs = reinterpret_cast<float4*>(L::xbuf(smem));
  float p[BK / 2];                   // tile it - 1's P
  float alpha0 = 1.f, alpha1 = 1.f;  // and the factors its softmax gave

  // tile j's partial S (this CTA's columns), scattered
  auto partial = [&](int j) {
    const int s = j % kStages;
    hopper::mbar_wait(&bars[s], (j / kStages) & 1);
    float sc[BK / 2];
    mma_tf32x3<BK, kShare, 8>(
        sc, [&](int kk, float (&r)[4]) { area_fragment(qa, kk, 128, tid, r); },
        L::tile_u32(smem, s, 0), L::tile_u32(smem, s, 1));
    rounds::scatter<kBuffers>(xs, &bars[kXFull], j, n, rank, tid, sc);
  };
  // O = O alpha + P V over tile j (this CTA's columns), then release its stage
  auto pv = [&](int j) {
    const int s = j % kStages;
    float t[kShare / 2];
    mma_tf32x3<kShare, BK, 8>(
        t, [&](int kk, float (&r)[4]) { acc_fragment(p, kk, r); }, L::tile_u32(smem, s, 2),
        L::tile_u32(smem, s, 3));
    o_sum.add(t, alpha0, alpha1);
    hopper::mbar_arrive(&bars[kStages + s]);
  };

  partial(0);
  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * BK;
    rounds::reduce<kBuffers, kUnits>(xs, &bars[kXFull], it, n, rank, tid);
    if (it + 1 < n_tiles) partial(it + 1);
    if (it > 0) pv(it - 1);
    float sc[BK / 2];
    rounds::collect<kBuffers>(xs, &bars[kXFull], it, tid, sc);  // S over every column
    const float* bs = L::stats(smem, it % kStages);
    if (causal && (nokey || k0 + BK - 1 > q0 + off))
      softmax_tile<true, BK>(sc, bs, k0, r0, r1, off, Tk, t4, scale_log2, m0, m1, l0, l1, alpha0,
                             alpha1);
    else
      softmax_tile<false, BK>(sc, bs, k0, r0, r1, off, Tk, t4, scale_log2, m0, m1, l0, l1, alpha0,
                              alpha1);
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) p[i] = sc[i];
  }
  pv(n_tiles - 1);

  l0 = hopper::quad_sum(l0);
  l1 = hopper::quad_sum(l1);
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  float out[kShare / 2];
  o_sum.load(out);
  store_acc<kShare, true>(out, d0, d1, o + (long long)b * Tq * HD + col, HD, r0, Tq, t4);
  if (lse != nullptr && t4 == 0 && rank == 0) {
    float* lb = lse + ((long long)b * H + h) * Tq;
    if (r0 < Tq) lb[r0] = m0 * hopper::kLn2 + logf(d0);
    if (r1 < Tq) lb[r1] = m1 * hopper::kLn2 + logf(d1);
  }
}

// ------------------------------------------------------------------------ dq

struct DqSplit {
  static constexpr int BK = 16;
  // stage: K hi, lo, V hi, lo, K^T hi, lo, key bias; areas Q, dO; partial S, dP
  using L = SplitLayout<BK, 6, 2>;
  static_assert(BK == 4 * kUnits, "a round: two m64nBK tiles");
};

__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_split_kernel(const float* __restrict__ q, const float* __restrict__ k,
                              const float* __restrict__ v, const float* __restrict__ bias,
                              const float* __restrict__ dout, const float* __restrict__ lse,
                              const float* __restrict__ delta, float* __restrict__ dq, int Tq,
                              int Tk, int H, int causal, float scale, float scale_log2) {
  using L = DqSplit::L;
  constexpr int BK = DqSplit::BK;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hopper::align_1024(smem_raw);
  uint64_t* bars = L::bars(smem);
  const uint32_t n = hopper::cluster_size(), rank = hopper::cluster_rank();
  const int q0 = blockIdx.x / n * rounds::kRows, h = blockIdx.y, b = blockIdx.z;
  const int off = Tk - Tq;
  const long long HD = (long long)H * n * kShare;
  const long long col = (long long)h * n * kShare + rank * kShare;
  const int n_tiles = key_tiles(q0, rounds::kRows, Tq, Tk, BK, causal);
  init_split_barriers(bars);

  if (threadIdx.x < 128) {  // ---- producer: K (direct and transposed), V, key bias
    const int tid = threadIdx.x;
    const float* kb = k + (long long)b * Tk * HD + col;
    const float* vb = v + (long long)b * Tk * HD + col;
    produce<kStages, kLands>(
        bars, n_tiles,
        [&](int it) {
          land_rows<BK, kShare, 128>(landed<L>(smem, it, 0), kb, HD, it * BK, Tk, tid);
          land_rows<BK, kShare, 128>(landed<L>(smem, it, 1), vb, HD, it * BK, Tk, tid);
        },
        [&](int s, int it) {
          split_tile<BK, kShare, 128, true, true>(landed<L>(smem, it, 0), L::tile(smem, s, 0),
                                                  L::tile(smem, s, 1), L::tile(smem, s, 4),
                                                  L::tile(smem, s, 5), tid);
          split_tile<BK, kShare, 128, true, false>(landed<L>(smem, it, 1), L::tile(smem, s, 2),
                                                   L::tile(smem, s, 3), nullptr, nullptr, tid);
          stage_bias(L::stats(smem, s), bias, b, Tk, it * BK, BK, tid);
        });
    return;
  }

  // ---- the consumer warpgroup: 64 query rows
  const int tid = threadIdx.x - 128;
  const int g = (tid % 32) / 4, t4 = tid % 4;
  const int r0 = q0 + (tid / 32) * 16 + g, r1 = r0 + 8;
  const bool nokey = causal && q0 + off < 0;
  const long long qoff = (long long)b * Tq * HD + col;
  const float* lb = lse + ((long long)b * H + h) * Tq;
  const float* db = delta + ((long long)b * H + h) * Tq;
  const float lse0 = r0 < Tq ? lb[r0] * hopper::kLog2e : 0.f;
  const float lse1 = r1 < Tq ? lb[r1] * hopper::kLog2e : 0.f;
  const float dl0 = r0 < Tq ? db[r0] : 0.f;
  const float dl1 = r1 < Tq ? db[r1] : 0.f;
  const float4* qa = L::area(smem, 0);
  const float4* da = L::area(smem, 1);
  stash_fragments<kShare, 128>(L::area(smem, 0), q + qoff, HD, r0, Tq, tid);
  stash_fragments<kShare, 128>(L::area(smem, 1), dout + qoff, HD, r0, Tq, tid);
  RunningSum<kShare / 2, false, 128> dq_sum(L::area(smem, 0), tid);
  float4* xs = reinterpret_cast<float4*>(L::xbuf(smem));
  float ds[BK / 2];  // tile it - 1's dS

  // tile j's partial S and dP (this CTA's columns), scattered
  auto partial = [&](int j) {
    const int s = j % kStages;
    hopper::mbar_wait(&bars[s], (j / kStages) & 1);
    float sc[BK / 2], dp[BK / 2];
    mma_tf32x3<BK, kShare, 8>(
        sc, [&](int kk, float (&r)[4]) { area_fragment(qa, kk, 128, tid, r); },
        L::tile_u32(smem, s, 0), L::tile_u32(smem, s, 1));
    mma_tf32x3<BK, kShare, 8>(
        dp, [&](int kk, float (&r)[4]) { area_fragment(da, kk, 128, tid, r); },
        L::tile_u32(smem, s, 2), L::tile_u32(smem, s, 3));
    rounds::scatter<kBuffers>(xs, &bars[kXFull], j, n, rank, tid, sc, dp);
  };
  // dQ += dS K over tile j (this CTA's columns), then release its stage
  auto product = [&](int j) {
    const int s = j % kStages;
    float t[kShare / 2];
    mma_tf32x3<kShare, BK, 8>(
        t, [&](int kk, float (&r)[4]) { acc_fragment(ds, kk, r); }, L::tile_u32(smem, s, 4),
        L::tile_u32(smem, s, 5));
    dq_sum.add(t, 1.f, 1.f);
    hopper::mbar_arrive(&bars[kStages + s]);
  };

  partial(0);
  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * BK;
    rounds::reduce<kBuffers, kUnits>(xs, &bars[kXFull], it, n, rank, tid);
    if (it + 1 < n_tiles) partial(it + 1);
    if (it > 0) product(it - 1);
    float sc[BK / 2], dp[BK / 2];
    rounds::collect<kBuffers>(xs, &bars[kXFull], it, tid, sc, dp);  // over every column
    const float* bs = L::stats(smem, it % kStages);
    if (causal && (nokey || k0 + BK - 1 > q0 + off))
      dq_scores<true, BK>(sc, dp, bs, k0, r0, r1, off, Tk, t4, scale_log2, lse0, lse1, dl0, dl1);
    else
      dq_scores<false, BK>(sc, dp, bs, k0, r0, r1, off, Tk, t4, scale_log2, lse0, lse1, dl0, dl1);
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) ds[i] = sc[i];
  }
  product(n_tiles - 1);

  float acc[kShare / 2];
  dq_sum.load(acc);
  store_acc<kShare, false>(acc, scale, scale, dq + qoff, HD, r0, Tq, t4);
}

// -------------------------------------------------------------------- dk / dv

struct DkvSplit {
  static constexpr int BQ = 16;
  // stage: Q hi, lo, dO hi, lo, Q^T hi, lo, dO^T hi, lo, lse and delta;
  // areas K, V; partial S^T, dP^T
  using L = SplitLayout<BQ, 8, 2>;
  static_assert(BQ == 4 * kUnits, "a round: two m64nBQ tiles");
};

__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkv_split_kernel(const float* __restrict__ q, const float* __restrict__ k,
                               const float* __restrict__ v, const float* __restrict__ bias,
                               const float* __restrict__ dout, const float* __restrict__ lse,
                               const float* __restrict__ delta, float* __restrict__ dk,
                               float* __restrict__ dv, float* __restrict__ dbias, int Tq, int Tk,
                               int H, int causal, float scale, float scale_log2) {
  using L = DkvSplit::L;
  constexpr int BQ = DkvSplit::BQ;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hopper::align_1024(smem_raw);
  uint64_t* bars = L::bars(smem);
  const uint32_t n = hopper::cluster_size(), rank = hopper::cluster_rank();
  const int k0 = blockIdx.x / n * rounds::kRows, h = blockIdx.y, b = blockIdx.z;
  const int off = Tk - Tq;
  const long long HD = (long long)H * n * kShare;
  const long long col = (long long)h * n * kShare + rank * kShare;
  const int t0 = first_query_tile(k0, Tq, Tk, BQ, causal);
  const int n_tiles = (Tq + BQ - 1) / BQ - t0;
  const float* lb = lse + ((long long)b * H + h) * Tq;
  const float* db = delta + ((long long)b * H + h) * Tq;
  init_split_barriers(bars);

  if (threadIdx.x < 128) {  // ---- producer: Q, dO (direct and transposed), lse, delta
    const int tid = threadIdx.x;
    const float* qb = q + (long long)b * Tq * HD + col;
    const float* ob = dout + (long long)b * Tq * HD + col;
    produce<kStages, kLands>(
        bars, n_tiles,
        [&](int it) {
          land_rows<BQ, kShare, 128>(landed<L>(smem, it, 0), qb, HD, (t0 + it) * BQ, Tq, tid);
          land_rows<BQ, kShare, 128>(landed<L>(smem, it, 1), ob, HD, (t0 + it) * BQ, Tq, tid);
        },
        [&](int s, int it) {
          split_tile<BQ, kShare, 128, true, true>(landed<L>(smem, it, 0), L::tile(smem, s, 0),
                                                  L::tile(smem, s, 1), L::tile(smem, s, 4),
                                                  L::tile(smem, s, 5), tid);
          split_tile<BQ, kShare, 128, true, true>(landed<L>(smem, it, 1), L::tile(smem, s, 2),
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

  // ---- the consumer warpgroup: 64 keys
  const int tid = threadIdx.x - 128;
  const int g = (tid % 32) / 4, t4 = tid % 4;
  const int c0 = k0 + (tid / 32) * 16 + g, c1 = c0 + 8;
  const float bias0 = c0 >= Tk ? -INFINITY
                               : (bias != nullptr ? bias[(long long)b * Tk + c0] * hopper::kLog2e
                                                  : 0.f);
  const float bias1 = c1 >= Tk ? -INFINITY
                               : (bias != nullptr ? bias[(long long)b * Tk + c1] * hopper::kLog2e
                                                  : 0.f);
  const long long koff = (long long)b * Tk * HD + col;
  const float4* ka = L::area(smem, 0);
  const float4* va = L::area(smem, 1);
  stash_fragments<kShare, 128>(L::area(smem, 0), k + koff, HD, c0, Tk, tid);
  stash_fragments<kShare, 128>(L::area(smem, 1), v + koff, HD, c0, Tk, tid);
  RunningSum<kShare / 2, false, 128> dk_sum(L::area(smem, 0), tid), dv_sum(L::area(smem, 0), tid);
  float db0 = 0.f, db1 = 0.f;
  float4* xs = reinterpret_cast<float4*>(L::xbuf(smem));
  float pt[BQ / 2], dst[BQ / 2];  // tile it - 1's P^T and dS^T

  // tile j's partial S^T and dP^T (this CTA's columns), scattered
  auto partial = [&](int j) {
    const int s = j % kStages;
    hopper::mbar_wait(&bars[s], (j / kStages) & 1);
    float st[BQ / 2], dpt[BQ / 2];
    mma_tf32x3<BQ, kShare, 8>(
        st, [&](int kk, float (&r)[4]) { area_fragment(ka, kk, 128, tid, r); },
        L::tile_u32(smem, s, 0), L::tile_u32(smem, s, 1));
    mma_tf32x3<BQ, kShare, 8>(
        dpt, [&](int kk, float (&r)[4]) { area_fragment(va, kk, 128, tid, r); },
        L::tile_u32(smem, s, 2), L::tile_u32(smem, s, 3));
    rounds::scatter<kBuffers>(xs, &bars[kXFull], j, n, rank, tid, st, dpt);
  };
  // dV += P^T dO and dK += dS^T Q over tile j (this CTA's columns), then
  // release its stage
  auto products = [&](int j) {
    const int s = j % kStages;
    float t[kShare / 2];
    mma_tf32x3<kShare, BQ, 8>(
        t, [&](int kk, float (&r)[4]) { acc_fragment(pt, kk, r); }, L::tile_u32(smem, s, 6),
        L::tile_u32(smem, s, 7));
    dv_sum.add(t, 1.f, 1.f);
    mma_tf32x3<kShare, BQ, 8>(
        t, [&](int kk, float (&r)[4]) { acc_fragment(dst, kk, r); }, L::tile_u32(smem, s, 4),
        L::tile_u32(smem, s, 5));
    dk_sum.add(t, 1.f, 1.f);
    hopper::mbar_arrive(&bars[kStages + s]);
  };

  partial(0);
  for (int it = 0; it < n_tiles; ++it) {
    const int rq0 = (t0 + it) * BQ;
    rounds::reduce<kBuffers, kUnits>(xs, &bars[kXFull], it, n, rank, tid);
    if (it + 1 < n_tiles) partial(it + 1);
    if (it > 0) products(it - 1);
    float st[BQ / 2], dpt[BQ / 2];
    rounds::collect<kBuffers>(xs, &bars[kXFull], it, tid, st, dpt);  // over every column
    const float* ls = L::stats(smem, it % kStages);
    if (causal && (rq0 + off < 0 || k0 + rounds::kRows - 1 > rq0 + off))
      dkv_scores<true, BQ>(st, dpt, ls, ls + BQ, rq0, c0, c1, off, Tk, t4, scale_log2, bias0,
                           bias1, db0, db1);
    else
      dkv_scores<false, BQ>(st, dpt, ls, ls + BQ, rq0, c0, c1, off, Tk, t4, scale_log2, bias0,
                            bias1, db0, db1);
#pragma unroll
    for (int i = 0; i < BQ / 2; ++i) pt[i] = st[i], dst[i] = dpt[i];
  }
  products(n_tiles - 1);

  db0 = hopper::quad_sum(db0);
  db1 = hopper::quad_sum(db1);
  if (t4 == 0 && rank == 0) {
    float* dbb = dbias + ((long long)b * H + h) * Tk;
    if (c0 < Tk) dbb[c0] = db0;
    if (c1 < Tk) dbb[c1] = db1;
  }
  float acc[kShare / 2];
  dk_sum.load(acc);
  store_acc<kShare, false>(acc, scale, scale, dk + koff, HD, c0, Tk, t4);
  dv_sum.load(acc);
  store_acc<kShare, false>(acc, 1.f, 1.f, dv + koff, HD, c0, Tk, t4);
}

// ------------------------------------------------------------------ launches

// Set the kernel's dynamic shared memory once per device, then launch it as
// clusters of n CTAs over the rows' blocks.
template <typename... Params, typename... Args>
int launch(void (*kernel)(Params...), int smem, bool (&smem_set)[hopper::kMaxDevices], int rows,
           int n, int H, int B, cudaStream_t stream, Args... args) {
  const int st = hopper::allow_dynamic_smem((const void*)kernel, smem, smem_set);
  if (st != 0) return st;
  return rounds::launch_kernel(kernel, rounds::row_grid(rows, n, H, B), kThreads, smem, n, stream,
                               args...);
}

// whether head dim D is n shares of kShare columns that the kernels take
bool bad_args(int B, int Tq, int Tk, int H, int D, int n) {
  return B <= 0 || Tq <= 0 || Tk <= 0 || H <= 0 || B > 65535 || H > 65535 || n < 2 ||
         n > rounds::kMaxSplit || D != n * kShare;
}

}  // namespace

// float32 only. q (B, Tq, H*D), k/v (B, Tk, H*D), bias (B, Tk) f32 additive
// or null, o like q, lse (B, H, Tq) f32 or null; D = n * 64, n the CTAs of a
// cluster (2 to 16)
extern "C" int vt_flash_attention_f32_split(const void* q, const void* k, const void* v,
                                            const void* bias, void* o, void* lse, int B, int Tq,
                                            int Tk, int H, int D, int n, int causal, float scale,
                                            void* stream) {
  if (bad_args(B, Tq, Tk, H, D, n)) return (int)cudaErrorInvalidValue;
  static bool smem_set[hopper::kMaxDevices] = {};
  return launch(flash_fwd_split_kernel, FwdSplit::L::SMEM, smem_set, Tq, n, H, B,
                (cudaStream_t)stream, (const float*)q, (const float*)k, (const float*)v,
                (const float*)bias, (float*)o, (float*)lse, Tq, Tk, H, causal,
                scale * hopper::kLog2e);
}

// q/dout/dq (B, Tq, H*D), k/v (B, Tk, H*D), bias (B, Tk) f32 or null,
// lse/delta (B, H, Tq) f32; D and n as above
extern "C" int vt_flash_attention_bwd_dq_f32_split(const void* q, const void* k, const void* v,
                                                   const void* bias, const void* dout,
                                                   const void* lse, const void* delta, void* dq,
                                                   int B, int Tq, int Tk, int H, int D, int n,
                                                   int causal, float scale, void* stream) {
  if (bad_args(B, Tq, Tk, H, D, n)) return (int)cudaErrorInvalidValue;
  static bool smem_set[hopper::kMaxDevices] = {};
  return launch(flash_bwd_dq_split_kernel, DqSplit::L::SMEM, smem_set, Tq, n, H, B,
                (cudaStream_t)stream, (const float*)q, (const float*)k, (const float*)v,
                (const float*)bias, (const float*)dout, (const float*)lse, (const float*)delta,
                (float*)dq, Tq, Tk, H, causal, scale, scale * hopper::kLog2e);
}

// as above; dk/dv (B, Tk, H*D), dbias (B, H, Tk) f32 per head
extern "C" int vt_flash_attention_bwd_dkv_f32_split(const void* q, const void* k, const void* v,
                                                    const void* bias, const void* dout,
                                                    const void* lse, const void* delta, void* dk,
                                                    void* dv, void* dbias, int B, int Tq, int Tk,
                                                    int H, int D, int n, int causal, float scale,
                                                    void* stream) {
  if (bad_args(B, Tq, Tk, H, D, n)) return (int)cudaErrorInvalidValue;
  static bool smem_set[hopper::kMaxDevices] = {};
  return launch(flash_bwd_dkv_split_kernel, DkvSplit::L::SMEM, smem_set, Tk, n, H, B,
                (cudaStream_t)stream, (const float*)q, (const float*)k, (const float*)v,
                (const float*)bias, (const float*)dout, (const float*)lse, (const float*)delta,
                (float*)dk, (float*)dv, (float*)dbias, Tq, Tk, H, causal, scale,
                scale * hopper::kLog2e);
}
