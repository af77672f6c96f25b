// Flash attention at the wide head dims, bf16, on the tensor cores: the
// forward and the backward pair (dq, then dk/dv/dbias) at every head dim
// above 128 (padded to 256, 320, or a width a cluster splits), written for
// Hopper (sm_90a).
//
// Replaces, at those head dims: vilmedic_tpu/ops/flash_attention.py::_kernel
// (the forward, with `with_lse`, reached through `_flash_bhtd`) and
// ::_bwd_dq_kernel / ::_bwd_dkv_kernel (through `_flash_bwd_bhtd`), JAX's v1
// path, which takes any head dim. The function, the rounding points and the
// masking are those of flash_attention.cu and flash_attention_bwd.cu (their
// header comments give the formulas): f32 scores of the bf16 operands times
// the true scale, the f32 key bias (0 / -1e9), the causal limit
// c <= r + Tk - Tq, the running max from -1e9, the denominator floored at
// 1e-30; p rounded to bf16 before P V and p^T dO, dS before dS K and dS^T Q;
// dbias per head in f32 from the unrounded dS. A causal row that sees no key
// (Tq > Tk) averages, or weighs, every key. Ragged tails are masked here (keys
// past Tk carry a -inf bias, query rows past Tq a +inf lse and are not
// stored); the wrapper pads only the head dim.
//
// What bounds it on the H100: the tensor cores. At B 16, T 1370, 3 heads of
// 320 the forward is 4 * B * H * T^2 * D = 115 GFLOP against 72 MB of q, k, v
// and out (0.117 ms at 989 TFLOP/s, 0.021 ms at 3.35 TB/s). Measured (PERF.md,
// rows 4 and 6): the forward at about a third of that bound, the backward at
// a seventh; a warpgroup runs its products and its softmax in series. Split
// heads (384 and up) reach about a fifth and a tenth.
//
// Why these kernels are not flash_attention.cu / flash_attention_bwd.cu at a
// wider D: there a CTA holds two consumer warpgroups of 64 rows under
// __launch_bounds__(384, 1), so ptxas allocates each thread at most 168
// registers, and a wide head's f32 accumulators do not fit (the D 256
// forward spills; the backward's dK and dV at D 256 are 256 registers a
// thread). Here a CTA has at most 8 warps, so a thread may keep up to 255
// registers (the register file is handed out by groups of four warps: a
// ninth warp would cost as twelve and cut that to 168):
//   - Forward: a CTA of 160 threads, one consumer warpgroup of 64 query rows
//     and a producer warp (hopper::ring_producer). The warp loads Q once and
//     64-key tiles of K and V into a 2-stage TMA ring (128-byte swizzle, a
//     head row as D / 64 boxes), with the key bias beside them. S = Q K^T is
//     wgmma m64n64k16 from shared memory; O += P V takes the packed bf16 P
//     as register A against V read MN-major, as n128 products over pairs of
//     64-column chunks and an n64 product for an odd last chunk (at D 320:
//     n128, n128, n64), so O is D / 2 f32 registers a thread (160 at D 320).
//     Shared memory: Q 32 KB + the ring 128 KB at D 256; 40 + 160 KB at 320.
//     Timed against this design on the card and not kept (PERF.md, PR 20):
//     two consumer warpgroups sharing each K/V tile (no producer warp, so
//     that each keeps 255 registers; 32-key tiles at D 320), no faster at D
//     256 and slower at D 320; the next tile's S issued before this tile's
//     P V, its softmax run while P V is in flight, slower (each P V then
//     waits for a tile the 2-stage ring has just begun to load; a 3-stage
//     ring fits only at D 256) and spilling at D 320; at D 256 two CTAs an
//     SM of one warpgroup each (no producer warp, 32-key tiles), slower.
//   - dq: a CTA of 160 threads, one consumer warpgroup of 64 query rows and
//     a producer warp (hopper::ring_producer): Q and dO stay (128 rows of
//     both would not fit beside a ring); the ring carries K and V tiles of
//     64 keys (32 at D 320, within shared memory and the registers: dQ's
//     160 plus S and dP). S and dP are wgmma from shared memory; dS is
//     formed in the S registers and is register A of dQ += dS K (K read
//     MN-major).
//   - dk/dv: a CTA of 256 threads, two warpgroups, owns 64 keys: K and V
//     stay, the ring carries tiles of 64 query rows (32 at D 320) of Q and
//     dO with their lse and delta. Warpgroup 0 computes S^T = K Q^T, P^T,
//     and dV += P^T dO; warpgroup 1 computes dP^T = V dO^T, dS^T (from P^T
//     handed over in shared memory as f32, 16 KB at 64 query rows), dbias,
//     and dK += dS^T Q. Each holds one D-wide accumulator (D / 2 registers)
//     and runs two of the four products. Two named barriers order the
//     hand-over: "P^T written" and "P^T read".
//   - dk/dv has no producer warp (a ninth warp would cut every thread to
//     168 registers): the first warp of warpgroup 1, which trails
//     warpgroup 0 (it waits for P^T), refills a stage by TMA once warpgroup
//     0 has released it, and fetches the next tile's lse and delta into
//     registers a tile ahead, so that their loads do not stall it.
//   - Online softmax in the log2 domain (scale * log2 e folded into one FMA,
//     ex2.approx), only tiles across the causal diagonal masked, epilogues
//     staged through the CTA's own resident tiles and written with 16-byte
//     stores: as in flash_attention.cu and flash_attention_bwd.cu.
//   - Deterministic: no atomics; every output element is written by one
//     block, and every sum runs in a fixed order.
//
// Above 320 (SPLIT): a thread block cluster of n CTAs splits the head dim.
// One warpgroup's O at m64n384 alone would be 192 registers a thread, and
// Q beside a 2-stage ring of 64-key K and V tiles 240 KB. So each CTA runs
// the kernels above at w = D / n columns (the caller gives n, from 2 to 16;
// w 192, 256 or 320: the wrapper pads bf16 heads to 384, 512 and 640 as
// pairs, 768 to 1280 as 3 or 4, up to 5120 as 16; above 8, the portable
// cluster size, the kernel opts into non-portable clusters), over the same
// 64 rows as the others: its TMA boxes start at column rank * w, and it
// writes those columns of O, dQ, dK and dV. No product is repeated across
// the cluster. The score tiles need every column, so each tile is a round:
// every CTA's partial S (and dP; S^T or dP^T in dk/dv, per warpgroup) is
// summed over the cluster, and every CTA gets the same bits of S, so all
// run the same softmax, masks and dS.
//   - A pair pushes its partial into the other CTA's shared memory by
//     st.async, which completes transaction bytes on that CTA's round
//     barrier (armed by one local arrival), and adds the other's partial to
//     its own (a + b is b + a). From 3 CTAs each CTA writes its partial into
//     its own shared memory, each of its threads arrives on the others'
//     round barriers (mbarrier.arrive.release.cluster), and each reads the n
//     partials through distributed shared memory and sums them in rank
//     order; a last round (`done`) keeps its shared memory alive until the
//     others have read it. Two mechanisms, because each wins where it runs:
//     a pair that pulls as the larger clusters do ran 1.3-1.7x slower on an
//     H100 (PERF.md, the split heads' findings), and pushing to n - 1 CTAs
//     would need n receive buffers a round (at 16 CTAs of 320 columns,
//     256 KB).
//   - A round's latency is hidden: tile it's partial goes out, then tile
//     it - 1's output product (P V, dS K, P^T dO or dS^T Q) runs, then the
//     round is summed. Waited on at once, the rounds took about as long as
//     the products.
//   - The partials double-buffer: a CTA writes a buffer again two rounds
//     on, after every other CTA has sent the round between, which each did
//     after reading the buffer.
//   - The ring is 3 stages deep (a tile's stage frees a tile later), and
//     tiles shrink to fit it and the partials: 64 keys in the forward at
//     w 192, else 32; 32 keys (query rows in dk/dv) in the backward, 16 at
//     w 320.
//   - lse and dbias are the same in every CTA; rank 0 writes them. Still
//     deterministic: no atomics, fixed orders.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "hopper_common.cuh"
#include "split_rounds.cuh"

namespace {

using namespace flash;
using namespace rounds;

constexpr int kStages = 2;     // ring depth of a CTA that holds the whole head
constexpr int kOneGroup = 160;   // one consumer warpgroup + the producer warp
constexpr int kTwoGroups = 256;  // two consumer warpgroups, no producer warp (dk/dv)
constexpr int kMaxSmem = 232448;  // dynamic shared memory a CTA may take

// named barriers of the dk/dv kernel (1 and 2 are the epilogues' warpgroup barriers)
constexpr int kBarPFull = 3;  // P^T is in shared memory
constexpr int kBarPFree = 4;  // P^T has been read

// acc (m64nD) += A (registers, one 16-deep k-step) * B, where B is the
// k-step kc of a ROWS x D tile at shared address `base` read MN-major: n128
// products over pairs of 64-column chunks, n64 over an odd last chunk. The
// pieces of acc concatenate to the m64nD accumulator layout.
template <int D, int ROWS>
__device__ __forceinline__ void wgmma_rs_wide(float (&acc)[D / 2], const uint32_t (&a)[4],
                                              uint32_t base, int kc) {
  constexpr int CHUNK = ROWS * 128;  // bytes of one 64-column chunk of the tile
#pragma unroll
  for (int n = 0; n < D / 128; ++n)
    hopper::wgmma_rs_n128(*reinterpret_cast<float(*)[64]>(&acc[64 * n]), a,
                          hopper::desc_mn<D>(base + 2 * n * CHUNK, ROWS, kc), 1);
  if constexpr (D % 128 != 0)
    hopper::wgmma_rs_n64(*reinterpret_cast<float(*)[32]>(&acc[64 * (D / 128)]), a,
                         hopper::desc_mn<D>(base + (D / 64 - 1) * CHUNK, ROWS, kc), 1);
}

// ------------------------------------------------------------------ forward

// D is the CTA's columns: the head dim, or its share of a split head. A
// split CTA's ring is 3 deep: a tile's output product runs a tile late
// (under the next round), and its stage frees only then.
template <int D, bool SPLIT>
struct FwdTiles {  // shared-memory offsets (bytes)
  static constexpr int STAGES = SPLIT ? 3 : kStages;
  static constexpr int BK = SPLIT && D > 192 ? 32 : 64;  // keys per ring tile
  static constexpr int Q = 0;
  static constexpr int K = Q + kRows * D * 2;
  static constexpr int V = K + STAGES * BK * D * 2;
  static constexpr int BIAS = V + STAGES * BK * D * 2;
  static constexpr int X = BIAS + STAGES * BK * 4;  // SPLIT: the partial S, two buffers
  static constexpr int BAR = X + (SPLIT ? 2 * kRows * BK * 4 : 0);
  // resident, full[STAGES], empty[STAGES]; SPLIT: the rounds' two, then done
  static constexpr int XFULL = 1 + 2 * STAGES;
  static constexpr int DONE = XFULL + 2;
  static constexpr int SMEM = BAR + (SPLIT ? DONE + 1 : XFULL) * 8 + 1024;  // + alignment slack
  static_assert(SMEM <= kMaxSmem, "forward: shared memory");
};

template <int D, bool SPLIT>
__global__ void __launch_bounds__(kOneGroup, 1)
    flash_fwd_wide_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const float* __restrict__ bias, __nv_bfloat16* __restrict__ o,
                          float* __restrict__ lse, int Tq, int Tk, int H, int causal,
                          float scale_log2) {
  using L = FwdTiles<D, SPLIT>;
  constexpr int BK = L::BK;
  constexpr int STAGES = L::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hopper::align_1024(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::BAR);
  float* bias_s = reinterpret_cast<float*>(smem + L::BIAS);
  const uint32_t n = SPLIT ? hopper::cluster_size() : 1;  // CTAs over the head dim
  const uint32_t rank = SPLIT ? hopper::cluster_rank() : 0;
  const int col0 = rank * D;   // this CTA's first column of the head
  const int width = n * D;     // the head dim
  const int q0 = blockIdx.x / n * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int off = Tk - Tq;
  const int n_tiles = key_tiles(q0, kRows, Tq, Tk, BK, causal);
  if constexpr (SPLIT) {
    init_barriers(bars, L::XFULL, 2, round_arrivals(n));
    init_barriers(bars, L::DONE, 1, (n - 1) * kGroup);
  }
  hopper::init_ring<STAGES>(bars, kGroup);
  if constexpr (SPLIT) hopper::cluster_sync();  // every CTA's barriers, before any arrival

  if (threadIdx.x >= kGroup) {  // ---- producer warp: Q once, then K/V tiles and key bias
    hopper::ring_producer<D, STAGES, kRows, BK>(
        smem, bars, &tm_q, L::Q, nullptr, 0, &tm_k, L::K, &tm_v, L::V, q0, 0, n_tiles, h, b,
        [&](int s, int k0, int lane) {
          hopper::key_bias_log2(bias_s + s * BK, bias, b, Tk, k0, BK, lane);
        },
        col0);
    return;
  }

  // ---- the consumer warpgroup: 64 query rows
  const int tw = threadIdx.x;
  const int g = (tw % 32) / 4;
  const int t4 = tw % 4;
  const int r0 = q0 + (tw / 32) * 16 + g;
  const int r1 = r0 + 8;
  const bool nokey = causal && q0 + off < 0;  // holds a row that sees no key
  const uint32_t qs = hopper::smem_u32(smem + L::Q);

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m0 = kMaskL2, m1 = kMaskL2;  // running row maxima (log2 domain)
  float l0 = 0.f, l1 = 0.f;          // this lane's part of the denominators

  // S of key tile it (this CTA's columns' share when SPLIT), issued
  auto scores = [&](float (&sc)[BK / 2], int it) {
    const int s = it % STAGES;
    hopper::mbar_wait(&bars[1 + s], (it / STAGES) & 1);
    const uint32_t ks = hopper::smem_u32(smem + L::K + s * BK * D * 2);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      hopper::wgmma_ss<BK>(sc, hopper::desc_k<D>(qs, kRows, 0, kk),
                           hopper::desc_k<D>(ks, BK, 0, kk), kk > 0);
    hopper::wgmma_commit();
  };
  // the online softmax of tile it's scores (every column's), O rescaled, P packed
  auto softmax = [&](float (&sc)[BK / 2], int it, uint32_t (&pa)[BK / 16][4]) {
    const int s = it % STAGES;
    const int k0 = it * BK;
    float alpha0, alpha1;
    if (causal && (nokey || k0 + BK - 1 > q0 + off))
      softmax_tile<true, BK>(sc, bias_s + s * BK, k0, r0, r1, off, Tk, t4, scale_log2, m0, m1,
                             l0, l1, alpha0, alpha1);
    else
      softmax_tile<false, BK>(sc, bias_s + s * BK, k0, r0, r1, off, Tk, t4, scale_log2, m0, m1,
                              l0, l1, alpha0, alpha1);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      acc[4 * j + 0] *= alpha0;
      acc[4 * j + 1] *= alpha0;
      acc[4 * j + 2] *= alpha1;
      acc[4 * j + 3] *= alpha1;
    }
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) hopper::pack_a(pa[kc], sc, kc);
  };
  // O += P V over tile it, then release its stage
  auto pv = [&](const uint32_t (&pa)[BK / 16][4], int it) {
    const int s = it % STAGES;
    const uint32_t vs = hopper::smem_u32(smem + L::V + s * BK * D * 2);
    hopper::fence_operand(acc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) wgmma_rs_wide<D, BK>(acc, pa[kc], vs, kc);
    hopper::wgmma_commit();
    hopper::wgmma_wait_all();
    hopper::fence_operand(acc);
    hopper::mbar_arrive(&bars[1 + STAGES + s]);  // release the stage
  };

  hopper::mbar_wait(&bars[0], 0);
  if constexpr (!SPLIT) {
    for (int it = 0; it < n_tiles; ++it) {
      float sc[BK / 2];
      scores(sc, it);
      hopper::wgmma_wait_all();
      hopper::fence_operand(sc);
      uint32_t pa[BK / 16][4];
      softmax(sc, it, pa);
      pv(pa, it);
    }
  } else {
    // tile it - 1's P V runs while tile it's round is in flight
    float* xs = reinterpret_cast<float*>(smem + L::X);
    uint32_t pa[BK / 16][4];  // tile it - 1's P
    for (int it = 0; it < n_tiles; ++it) {
      float sc[BK / 2];
      scores(sc, it);
      hopper::wgmma_wait_all();
      hopper::fence_operand(sc);
      send_partial(xs, &bars[L::XFULL], it, n, rank, tw, sc);
      if (it > 0) pv(pa, it - 1);
      sum_round(xs, &bars[L::XFULL], it, n, tw, sc);  // S over every column
      softmax(sc, it, pa);
    }
    pv(pa, n_tiles - 1);
    publish(&bars[L::DONE], n, rank);  // done reading the others' partials
  }

  // epilogue: normalise; the bf16 rows leave through the Q tile
  l0 = hopper::quad_sum(l0);
  l1 = hopper::quad_sum(l1);
  const float d0 = fmaxf(l0, 1e-30f);
  const float d1 = fmaxf(l1, 1e-30f);
  hopper::store_rows<D>(acc, 1.f / d0, 1.f / d1, smem + L::Q, kRows, 0,
                        o + (((long long)b * Tq + q0) * H + h) * width + col0,
                        (long long)H * width, Tq - q0, 1);
  if (lse != nullptr && t4 == 0 && rank == 0) {
    float* lb = lse + ((long long)b * H + h) * Tq;
    if (r0 < Tq) lb[r0] = m0 * hopper::kLn2 + logf(d0);
    if (r1 < Tq) lb[r1] = m1 * hopper::kLn2 + logf(d1);
  }
  if constexpr (SPLIT) hopper::mbar_wait<true>(&bars[L::DONE], 0);  // the others are done with ours
}

// --------------------------------------------------------------------- dq

template <int D, bool SPLIT>
struct DqTiles {
  static constexpr int STAGES = SPLIT ? 3 : kStages;
  // keys per ring tile: within shared memory and the registers
  static constexpr int BK = SPLIT ? (D > 256 ? 16 : 32) : (D > 256 ? 32 : 64);
  static constexpr int Q = 0;
  static constexpr int DO = Q + kRows * D * 2;
  static constexpr int K = DO + kRows * D * 2;
  static constexpr int V = K + STAGES * BK * D * 2;
  static constexpr int BIAS = V + STAGES * BK * D * 2;
  static constexpr int X = BIAS + STAGES * BK * 4;  // SPLIT: the partial S and dP, two buffers
  static constexpr int BAR = X + (SPLIT ? 2 * 2 * kRows * BK * 4 : 0);
  static constexpr int XFULL = 1 + 2 * STAGES;
  static constexpr int DONE = XFULL + 2;
  static constexpr int SMEM = BAR + (SPLIT ? DONE + 1 : XFULL) * 8 + 1024;
  static_assert(SMEM <= kMaxSmem, "dq: shared memory");
};

template <int D, bool SPLIT>
__global__ void __launch_bounds__(kOneGroup, 1)
    flash_bwd_dq_wide_kernel(const __grid_constant__ CUtensorMap tm_q,
                             const __grid_constant__ CUtensorMap tm_do,
                             const __grid_constant__ CUtensorMap tm_k,
                             const __grid_constant__ CUtensorMap tm_v,
                             const float* __restrict__ bias, const float* __restrict__ lse,
                             const float* __restrict__ delta, __nv_bfloat16* __restrict__ dq,
                             int Tq, int Tk, int H, int causal, float scale, float scale_log2) {
  using L = DqTiles<D, SPLIT>;
  constexpr int BK = L::BK;
  constexpr int STAGES = L::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hopper::align_1024(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::BAR);
  float* bias_s = reinterpret_cast<float*>(smem + L::BIAS);
  const uint32_t n = SPLIT ? hopper::cluster_size() : 1;
  const uint32_t rank = SPLIT ? hopper::cluster_rank() : 0;
  const int col0 = rank * D;
  const int width = n * D;
  const int q0 = blockIdx.x / n * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int off = Tk - Tq;
  const int n_tiles = key_tiles(q0, kRows, Tq, Tk, BK, causal);
  if constexpr (SPLIT) {
    init_barriers(bars, L::XFULL, 2, round_arrivals(n));
    init_barriers(bars, L::DONE, 1, (n - 1) * kGroup);
  }
  hopper::init_ring<STAGES>(bars, 128);
  if constexpr (SPLIT) hopper::cluster_sync();

  if (threadIdx.x >= kGroup) {  // ---- producer warp: Q, dO once, then K/V tiles and key bias
    hopper::ring_producer<D, STAGES, kRows, BK>(
        smem, bars, &tm_q, L::Q, &tm_do, L::DO, &tm_k, L::K, &tm_v, L::V, q0, 0, n_tiles, h, b,
        [&](int s, int k0, int lane) {
          hopper::key_bias_log2(bias_s + s * BK, bias, b, Tk, k0, BK, lane);
        },
        col0);
    return;
  }

  // ---- the consumer warpgroup: 64 query rows
  const int tw = threadIdx.x;
  const int g = (tw % 32) / 4;
  const int t4 = tw % 4;
  const int r0 = q0 + (tw / 32) * 16 + g;
  const int r1 = r0 + 8;
  const bool nokey = causal && q0 + off < 0;
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

  // S and dP of key tile it (this CTA's columns' share when SPLIT), issued
  auto scores = [&](float (&sc)[BK / 2], float (&dp)[BK / 2], int it) {
    const int s = it % STAGES;
    hopper::mbar_wait(&bars[1 + s], (it / STAGES) & 1);
    const uint32_t ks = hopper::smem_u32(smem + L::K + s * BK * D * 2);
    const uint32_t vs = hopper::smem_u32(smem + L::V + s * BK * D * 2);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      hopper::wgmma_ss<BK>(sc, hopper::desc_k<D>(qs, kRows, 0, kk),
                           hopper::desc_k<D>(ks, BK, 0, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      hopper::wgmma_ss<BK>(dp, hopper::desc_k<D>(dos, kRows, 0, kk),
                           hopper::desc_k<D>(vs, BK, 0, kk), kk > 0);
    hopper::wgmma_commit();
  };
  // dS of tile it (from every column's S and dP), packed
  auto ds = [&](float (&sc)[BK / 2], const float (&dp)[BK / 2], int it,
                uint32_t (&da)[BK / 16][4]) {
    const int k0 = it * BK;
    const float* bs = bias_s + (it % STAGES) * BK;
    if (causal && (nokey || k0 + BK - 1 > q0 + off))
      dq_scores<true, BK>(sc, dp, bs, k0, r0, r1, off, Tk, t4, scale_log2, lse0, lse1, dl0, dl1);
    else
      dq_scores<false, BK>(sc, dp, bs, k0, r0, r1, off, Tk, t4, scale_log2, lse0, lse1, dl0, dl1);
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) hopper::pack_a(da[kc], sc, kc);
  };
  // dQ += dS K over tile it, then release its stage
  auto product = [&](const uint32_t (&da)[BK / 16][4], int it) {
    const int s = it % STAGES;
    const uint32_t ks = hopper::smem_u32(smem + L::K + s * BK * D * 2);
    hopper::fence_operand(acc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) wgmma_rs_wide<D, BK>(acc, da[kc], ks, kc);
    hopper::wgmma_commit();
    hopper::wgmma_wait_all();
    hopper::fence_operand(acc);
    hopper::mbar_arrive(&bars[1 + STAGES + s]);  // release the stage
  };

  hopper::mbar_wait(&bars[0], 0);
  if constexpr (!SPLIT) {
    for (int it = 0; it < n_tiles; ++it) {
      float sc[BK / 2], dp[BK / 2];
      scores(sc, dp, it);
      hopper::wgmma_wait_all();
      hopper::fence_operand(sc);
      hopper::fence_operand(dp);
      uint32_t da[BK / 16][4];
      ds(sc, dp, it, da);
      product(da, it);
    }
  } else {
    // tile it - 1's dQ product runs while tile it's round is in flight
    float* xs = reinterpret_cast<float*>(smem + L::X);
    uint32_t da[BK / 16][4];  // tile it - 1's dS
    for (int it = 0; it < n_tiles; ++it) {
      float sc[BK / 2], dp[BK / 2];
      scores(sc, dp, it);
      hopper::wgmma_wait_all();
      hopper::fence_operand(sc);
      hopper::fence_operand(dp);
      send_partial(xs, &bars[L::XFULL], it, n, rank, tw, sc, dp);
      if (it > 0) product(da, it - 1);
      sum_round(xs, &bars[L::XFULL], it, n, tw, sc, dp);  // S and dP over every column
      ds(sc, dp, it, da);
    }
    product(da, n_tiles - 1);
    publish(&bars[L::DONE], n, rank);
  }
  hopper::store_rows<D>(acc, scale, scale, smem + L::Q, kRows, 0,
                        dq + (((long long)b * Tq + q0) * H + h) * width + col0,
                        (long long)H * width, Tq - q0, 1);
  if constexpr (SPLIT) hopper::mbar_wait<true>(&bars[L::DONE], 0);
}

// ------------------------------------------------------------------ dk/dv

// The dk/dv kernel has no producer warp: the first warp of warpgroup 1, the
// filler, loads the resident tiles and the ring. Lane 0 loads ROWS rows of
// one head from `row` of two tensors (a map each), the D columns from
// `col0`, completing on `bar`.
template <int D, int ROWS>
__device__ __forceinline__ void load_rows(uint8_t* smem, uint64_t* bar, const CUtensorMap* ta,
                                          int off_a, const CUtensorMap* tb, int off_b, int row,
                                          int h, int b, int col0) {
  using G = hopper::Tile<D>;
#pragma unroll
  for (int c = 0; c < G::NCH; ++c) {
    hopper::tma_load_4d(smem + off_a + c * ROWS * G::SW, ta, col0 + c * G::CW, h, row, b, bar);
    hopper::tma_load_4d(smem + off_b + c * ROWS * G::SW, tb, col0 + c * G::CW, h, row, b, bar);
  }
}

// The filler warp's fill of ring tile `it` (rows (t0 + it) * ROWS of ta and
// tb) into stage it % STAGES, with `stats(stage, first row, lane)` writing
// the tile's per-row values beside it (from registers: the filler fetches
// them a tile ahead, so that their global loads run under the products and
// do not stall its warpgroup): the stage's full barrier completes on the TMA
// bytes and the warp's arrival. The caller has made sure the stage is free
// (the other warpgroup's release on its empty barrier, its own warpgroup's
// products complete).
template <int D, int ROWS, int STAGES, typename Stats>
__device__ __forceinline__ void fill_stage(uint8_t* smem, uint64_t* bars, const CUtensorMap* ta,
                                           int off_a, const CUtensorMap* tb, int off_b, int it,
                                           int t0, int h, int b, int col0, int lane,
                                           Stats stats) {
  const int s = it % STAGES;
  const int r0 = (t0 + it) * ROWS;
  uint64_t* full = &bars[1 + s];
  if (lane == 0) {
    hopper::mbar_arrive_expect_tx(full, 2 * ROWS * D * 2);
    load_rows<D, ROWS>(smem, full, ta, off_a + s * ROWS * D * 2, tb, off_b + s * ROWS * D * 2, r0,
                       h, b, col0);
  }
  stats(s, r0, lane);
  __syncwarp();
  if (lane == 0) hopper::mbar_arrive(full);  // the per-row values are written
}


template <int D, bool SPLIT>
struct DkvTiles {
  static constexpr int STAGES = SPLIT ? 3 : kStages;
  // query rows per ring tile: within shared memory and the registers
  static constexpr int BQ = SPLIT ? (D > 256 ? 16 : 32) : (D > 256 ? 32 : 64);
  static constexpr int K = 0;
  static constexpr int V = K + kRows * D * 2;
  static constexpr int Q = V + kRows * D * 2;
  static constexpr int DO = Q + STAGES * BQ * D * 2;
  static constexpr int P = DO + STAGES * BQ * D * 2;  // P^T (f32), warpgroup 0 -> 1
  static constexpr int LSE = P + kRows * BQ * 4;
  static constexpr int DELTA = LSE + STAGES * BQ * 4;
  // SPLIT: the partial S^T (warpgroup 0), then dP^T (1), two buffers each
  static constexpr int X = DELTA + STAGES * BQ * 4;
  static constexpr int BAR = X + (SPLIT ? 2 * 2 * kRows * BQ * 4 : 0);
  // SPLIT: the rounds' two of warpgroup 0, of warpgroup 1, then done
  static constexpr int XFULL = 1 + 2 * STAGES;
  static constexpr int DONE = XFULL + 4;
  static constexpr int SMEM = BAR + (SPLIT ? DONE + 1 : XFULL) * 8 + 1024;
  static_assert(SMEM <= kMaxSmem, "dk/dv: shared memory");
};

// P^T of one query tile, in place of S^T (warpgroup 0 of the dk/dv kernel)
template <bool MASK, int BQ>
__device__ __forceinline__ void p_transposed(float (&st)[BQ / 2], const float* ls, int rq0, int c0,
                                             int c1, int off, int Tk, int t4, float sl2,
                                             float bias0, float bias1) {
#pragma unroll
  for (int j = 0; j < BQ / 8; ++j) {
    const float2 lv = *reinterpret_cast<const float2*>(ls + 8 * j + 2 * t4);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float l = e ? lv.y : lv.x;
      float x0 = fmaf(st[4 * j + e], sl2, bias0);
      float x1 = fmaf(st[4 * j + 2 + e], sl2, bias1);
      if (MASK) {
        const int r = rq0 + 8 * j + 2 * t4 + e;
        if (c0 < Tk && c0 > r + off) x0 = kMaskL2;
        if (c1 < Tk && c1 > r + off) x1 = kMaskL2;
      }
      st[4 * j + e] = hopper::fast_exp2(x0 - l);
      st[4 * j + 2 + e] = hopper::fast_exp2(x1 - l);
    }
  }
}

// dS^T of one query tile in place of dP^T, from P^T in shared memory (thread
// tw's values at p[i * 128 + tw]: the two warpgroups' accumulators share one
// layout), with dbias's per-key sums (warpgroup 1 of the dk/dv kernel)
template <int BQ>
__device__ __forceinline__ void ds_transposed(float (&dpt)[BQ / 2], const float* p,
                                              const float* dls, int tw, int t4, float& db0,
                                              float& db1) {
#pragma unroll
  for (int j = 0; j < BQ / 8; ++j) {
    const float2 dv = *reinterpret_cast<const float2*>(dls + 8 * j + 2 * t4);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float dl = e ? dv.y : dv.x;
      const float ds0 = p[(4 * j + e) * 128 + tw] * (dpt[4 * j + e] - dl);
      const float ds1 = p[(4 * j + 2 + e) * 128 + tw] * (dpt[4 * j + 2 + e] - dl);
      db0 += ds0;
      db1 += ds1;
      dpt[4 * j + e] = ds0;
      dpt[4 * j + 2 + e] = ds1;
    }
  }
}

template <int D, bool SPLIT>
__global__ void __launch_bounds__(kTwoGroups, 1)
    flash_bwd_dkv_wide_kernel(const __grid_constant__ CUtensorMap tm_q,
                              const __grid_constant__ CUtensorMap tm_do,
                              const __grid_constant__ CUtensorMap tm_k,
                              const __grid_constant__ CUtensorMap tm_v,
                              const float* __restrict__ bias, const float* __restrict__ lse,
                              const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
                              __nv_bfloat16* __restrict__ dv, float* __restrict__ dbias, int Tq,
                              int Tk, int H, int causal, float scale, float scale_log2) {
  using L = DkvTiles<D, SPLIT>;
  constexpr int BQ = L::BQ;
  constexpr int STAGES = L::STAGES;
  constexpr int NSTAT = (BQ + 31) / 32;  // a lane's per-row values of a tile
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hopper::align_1024(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::BAR);
  float* p_s = reinterpret_cast<float*>(smem + L::P);
  float* lse_s = reinterpret_cast<float*>(smem + L::LSE);
  float* delta_s = reinterpret_cast<float*>(smem + L::DELTA);
  const uint32_t n = SPLIT ? hopper::cluster_size() : 1;
  const uint32_t rank = SPLIT ? hopper::cluster_rank() : 0;
  const int col0 = rank * D;
  const int width = n * D;
  const int k0 = blockIdx.x / n * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int off = Tk - Tq;
  const int t0 = first_query_tile(k0, Tq, Tk, BQ, causal);
  const int n_tiles = (Tq + BQ - 1) / BQ - t0;
  if constexpr (SPLIT) {
    init_barriers(bars, L::XFULL, 4, round_arrivals(n));
    init_barriers(bars, L::DONE, 1, (n - 1) * kTwoGroups);
  }
  hopper::init_ring<STAGES>(bars, kGroup);  // a stage is free once warpgroup 0 releases it
  if constexpr (SPLIT) hopper::cluster_sync();

  // both warpgroups over the CTA's 64 keys: 0 makes P^T and dV, 1 makes
  // dS^T, dK and dbias
  const int role = threadIdx.x / kGroup;
  const int tw = threadIdx.x % kGroup;
  const bool filler = role == 1 && tw < 32;  // the warp that loads the tiles
  const int lane = tw % 32;
  const float* lb = lse + ((long long)b * H + h) * Tq;
  const float* db = delta + ((long long)b * H + h) * Tq;
  // the lse (times log2 e; +inf past Tq, so p = 0 there) and delta of the
  // query tile the filler loads next (`fetched`)
  float nl[NSTAT], nd[NSTAT];
  int fetched = -1;
  auto fetch_stats = [&](int it) {
#pragma unroll
    for (int i = 0; i < NSTAT; ++i) {
      const int r = (t0 + it) * BQ + 32 * i + lane;
      nl[i] = r < Tq ? lb[r] * hopper::kLog2e : INFINITY;
      nd[i] = r < Tq ? db[r] : 0.f;
    }
    fetched = it;
  };
  auto put_stats = [&](int s, int, int) {
#pragma unroll
    for (int i = 0; i < NSTAT; ++i)
      if (32 * i + lane < BQ) {
        lse_s[s * BQ + 32 * i + lane] = nl[i];
        delta_s[s * BQ + 32 * i + lane] = nd[i];
      }
  };
  if (filler) {  // K and V once, then the first stages of Q/dO tiles and their stats
    if (lane == 0) {
      hopper::mbar_arrive_expect_tx(&bars[0], 2 * kRows * D * 2);
      load_rows<D, kRows>(smem, &bars[0], &tm_k, L::K, &tm_v, L::V, k0, h, b, col0);
    }
    for (int it = 0; it < min(STAGES, n_tiles); ++it) {
      fetch_stats(it);
      fill_stage<D, BQ, STAGES>(smem, bars, &tm_q, L::Q, &tm_do, L::DO, it, t0, h, b, col0, lane,
                                put_stats);
    }
  }

  const int g = (tw % 32) / 4;
  const int t4 = tw % 4;
  const int c0 = k0 + (tw / 32) * 16 + g;
  const int c1 = c0 + 8;
  const float bias0 = c0 >= Tk ? -INFINITY
                               : (bias != nullptr ? bias[(long long)b * Tk + c0] * hopper::kLog2e
                                                  : 0.f);
  const float bias1 = c1 >= Tk ? -INFINITY
                               : (bias != nullptr ? bias[(long long)b * Tk + c1] * hopper::kLog2e
                                                  : 0.f);
  const uint32_t ks = hopper::smem_u32(smem + L::K);
  const uint32_t vs = hopper::smem_u32(smem + L::V);

  float acc[D / 2];  // dV (warpgroup 0) or dK (warpgroup 1)
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float db0 = 0.f, db1 = 0.f;
  int done = 0;  // tiles whose P^T has been handed over

  // whether query tile it holds a row that sees one of the CTA's keys
  auto sees = [&](int it) {
    const int rq0 = (t0 + it) * BQ;
    return !causal || rq0 + off < 0 || k0 <= min(rq0 + BQ - 1, Tq - 1) + off;
  };
  // this warpgroup's S^T (0) or dP^T (1) of the query tile in stage s
  // (this CTA's columns' share when SPLIT), issued
  auto partial = [&](float (&x)[BQ / 2], int s) {
    const uint32_t qs = hopper::smem_u32(smem + L::Q + s * BQ * D * 2);
    const uint32_t dos = hopper::smem_u32(smem + L::DO + s * BQ * D * 2);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      hopper::wgmma_ss<BQ>(x, hopper::desc_k<D>(role == 0 ? ks : vs, kRows, 0, kk),
                           hopper::desc_k<D>(role == 0 ? qs : dos, BQ, 0, kk), kk > 0);
    hopper::wgmma_commit();
  };
  // P^T (0), handed over to warpgroup 1; dS^T (1) from it, with dbias's
  // sums; in place of every column's S^T (dP^T) of tile it, then packed
  auto finish = [&](float (&x)[BQ / 2], int it, uint32_t (&xa)[BQ / 16][4]) {
    const int s = it % STAGES;
    const int rq0 = (t0 + it) * BQ;
    if (role == 0) {
      if (causal && (rq0 + off < 0 || k0 + kRows - 1 > rq0 + off))
        p_transposed<true, BQ>(x, lse_s + s * BQ, rq0, c0, c1, off, Tk, t4, scale_log2, bias0,
                               bias1);
      else
        p_transposed<false, BQ>(x, lse_s + s * BQ, rq0, c0, c1, off, Tk, t4, scale_log2, bias0,
                                bias1);
      if (done > 0) hopper::named_sync(kBarPFree, 2 * 128);  // the last P^T has been read
#pragma unroll
      for (int i = 0; i < BQ / 2; ++i) p_s[i * 128 + tw] = x[i];
      hopper::named_arrive(kBarPFull, 2 * 128);
    } else {
      hopper::named_sync(kBarPFull, 2 * 128);
      ds_transposed<BQ>(x, p_s, delta_s + s * BQ, tw, t4, db0, db1);
      hopper::named_arrive(kBarPFree, 2 * 128);
    }
    ++done;
#pragma unroll
    for (int kc = 0; kc < BQ / 16; ++kc) hopper::pack_a(xa[kc], x, kc);
  };
  // dV += P^T dO (0); dK += dS^T Q (1), over query tile it
  auto product = [&](const uint32_t (&xa)[BQ / 16][4], int it) {
    const int s = it % STAGES;
    const uint32_t qs = hopper::smem_u32(smem + L::Q + s * BQ * D * 2);
    const uint32_t dos = hopper::smem_u32(smem + L::DO + s * BQ * D * 2);
    hopper::fence_operand(acc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < BQ / 16; ++kc)
      wgmma_rs_wide<D, BQ>(acc, xa[kc], role == 0 ? dos : qs, kc);
    hopper::wgmma_commit();
    hopper::wgmma_wait_all();
    hopper::fence_operand(acc);
  };
  // query tile it is done with: warpgroup 0 releases its stage; the filler
  // refills it with tile it + STAGES once warpgroup 0 has (its own products
  // have completed, and they follow each warp's reads of the stage's lse and
  // delta)
  auto retire = [&](int it) {
    const int s = it % STAGES;
    if (role == 0) {
      hopper::mbar_arrive(&bars[1 + STAGES + s]);
    } else if (filler && it + STAGES < n_tiles) {
      if (fetched != it + STAGES) fetch_stats(it + STAGES);
      hopper::mbar_wait(&bars[1 + STAGES + s], (it / STAGES) & 1);
      fill_stage<D, BQ, STAGES>(smem, bars, &tm_q, L::Q, &tm_do, L::DO, it + STAGES, t0, h, b,
                                col0, lane, put_stats);
    }
  };

  hopper::mbar_wait(&bars[0], 0);
  if constexpr (!SPLIT) {
    for (int it = 0; it < n_tiles; ++it) {
      // the filler fetches the lse and delta of the tile it loads next
      if (filler && it + STAGES < n_tiles) fetch_stats(it + STAGES);
      hopper::mbar_wait(&bars[1 + it % STAGES], (it / STAGES) & 1);
      if (sees(it)) {
        float x[BQ / 2];  // S^T then P^T (0); dP^T then dS^T (1)
        partial(x, it % STAGES);
        hopper::wgmma_wait_all();
        hopper::fence_operand(x);
        uint32_t xa[BQ / 16][4];
        finish(x, it, xa);
        product(xa, it);
      }
      retire(it);
    }
  } else {
    // the last tile's product (`last`) runs while this tile's round is in
    // flight; its stage is retired after it
    float* xs = reinterpret_cast<float*>(smem + L::X) + role * 2 * kRows * BQ;
    uint64_t* xbars = &bars[L::XFULL + 2 * role];
    uint32_t xa[BQ / 16][4];  // tile last's P^T (0) or dS^T (1), packed
    int last = -1;
    for (int it = 0; it < n_tiles; ++it) {
      if (filler && last >= 0 && last + STAGES < n_tiles) fetch_stats(last + STAGES);
      hopper::mbar_wait(&bars[1 + it % STAGES], (it / STAGES) & 1);
      if (!sees(it)) {  // retire in order: a later tile's stage may wait on last's refill
        if (last >= 0) {
          product(xa, last);
          retire(last);
          last = -1;
        }
        retire(it);
        continue;
      }
      float x[BQ / 2];
      partial(x, it % STAGES);
      hopper::wgmma_wait_all();
      hopper::fence_operand(x);
      send_partial(xs, xbars, done, n, rank, tw, x);
      if (last >= 0) {
        product(xa, last);
        retire(last);
      }
      sum_round(xs, xbars, done, n, tw, x);  // S^T (dP^T) over every column
      finish(x, it, xa);
      last = it;
    }
    if (last >= 0) {
      product(xa, last);
      retire(last);
    }
  }
  // warpgroup 0 waits for the last hand-over to be read: after it warpgroup
  // 1 no longer reads V, and warpgroup 0 no longer reads K, so each may
  // stage its rows through the other's operand
  if (role == 0 && done > 0) hopper::named_sync(kBarPFree, 2 * 128);
  if constexpr (SPLIT) publish(&bars[L::DONE], n, rank);

  const long long row0 = ((long long)b * Tk + k0) * H + h;
  if (role == 0) {
    hopper::store_rows<D>(acc, 1.f, 1.f, smem + L::V, kRows, 0, dv + row0 * width + col0,
                          (long long)H * width, Tk - k0, 1);
  } else {
    db0 = hopper::quad_sum(db0);
    db1 = hopper::quad_sum(db1);
    if (t4 == 0 && rank == 0) {
      float* dbb = dbias + ((long long)b * H + h) * Tk;
      if (c0 < Tk) dbb[c0] = db0;
      if (c1 < Tk) dbb[c1] = db1;
    }
    hopper::store_rows<D>(acc, scale, scale, smem + L::K, kRows, 0, dk + row0 * width + col0,
                          (long long)H * width, Tk - k0, 2);
  }
  if constexpr (SPLIT) hopper::mbar_wait<true>(&bars[L::DONE], 0);
}

// ------------------------------------------------------------------- host

// D: the CTA's columns; n: the CTAs a head (1 unless SPLIT)
template <int D, bool SPLIT>
int launch_fwd(const void* q, const void* k, const void* v, const void* bias, void* o, void* lse,
               int B, int Tq, int Tk, int H, int n, int causal, float scale, cudaStream_t stream) {
  using L = FwdTiles<D, SPLIT>;
  CUtensorMap tm_q, tm_k, tm_v;
  int st = hopper::make_tensor_map<D>(&tm_q, q, B, Tq, H, kRows, n * D);
  if (st == 0) st = hopper::make_tensor_map<D>(&tm_k, k, B, Tk, H, L::BK, n * D);
  if (st == 0) st = hopper::make_tensor_map<D>(&tm_v, v, B, Tk, H, L::BK, n * D);
  if (st != 0) return st;
  static bool smem_set[hopper::kMaxDevices] = {};
  st = hopper::allow_dynamic_smem((const void*)flash_fwd_wide_kernel<D, SPLIT>, L::SMEM, smem_set);
  if (st != 0) return st;
  return launch_kernel(flash_fwd_wide_kernel<D, SPLIT>, row_grid(Tq, n, H, B), kOneGroup,
                       L::SMEM, n, stream, tm_q, tm_k, tm_v, (const float*)bias,
                       (__nv_bfloat16*)o, (float*)lse, Tq, Tk, H, causal,
                       scale * hopper::kLog2e);
}

template <int D, bool SPLIT>
int launch_dq(const void* q, const void* k, const void* v, const void* bias, const void* dout,
              const void* lse, const void* delta, void* dq, int B, int Tq, int Tk, int H, int n,
              int causal, float scale, cudaStream_t stream) {
  using L = DqTiles<D, SPLIT>;
  CUtensorMap tm_q, tm_do, tm_k, tm_v;
  int st = hopper::make_tensor_map<D>(&tm_q, q, B, Tq, H, kRows, n * D);
  if (st == 0) st = hopper::make_tensor_map<D>(&tm_do, dout, B, Tq, H, kRows, n * D);
  if (st == 0) st = hopper::make_tensor_map<D>(&tm_k, k, B, Tk, H, L::BK, n * D);
  if (st == 0) st = hopper::make_tensor_map<D>(&tm_v, v, B, Tk, H, L::BK, n * D);
  if (st != 0) return st;
  static bool smem_set[hopper::kMaxDevices] = {};
  st = hopper::allow_dynamic_smem((const void*)flash_bwd_dq_wide_kernel<D, SPLIT>, L::SMEM,
                                  smem_set);
  if (st != 0) return st;
  return launch_kernel(flash_bwd_dq_wide_kernel<D, SPLIT>, row_grid(Tq, n, H, B),
                       kOneGroup, L::SMEM, n, stream, tm_q, tm_do, tm_k, tm_v,
                       (const float*)bias, (const float*)lse, (const float*)delta,
                       (__nv_bfloat16*)dq, Tq, Tk, H, causal, scale,
                       scale * hopper::kLog2e);
}

template <int D, bool SPLIT>
int launch_dkv(const void* q, const void* k, const void* v, const void* bias, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv, void* dbias, int B,
               int Tq, int Tk, int H, int n, int causal, float scale, cudaStream_t stream) {
  using L = DkvTiles<D, SPLIT>;
  CUtensorMap tm_q, tm_do, tm_k, tm_v;
  int st = hopper::make_tensor_map<D>(&tm_q, q, B, Tq, H, L::BQ, n * D);
  if (st == 0) st = hopper::make_tensor_map<D>(&tm_do, dout, B, Tq, H, L::BQ, n * D);
  if (st == 0) st = hopper::make_tensor_map<D>(&tm_k, k, B, Tk, H, kRows, n * D);
  if (st == 0) st = hopper::make_tensor_map<D>(&tm_v, v, B, Tk, H, kRows, n * D);
  if (st != 0) return st;
  static bool smem_set[hopper::kMaxDevices] = {};
  st = hopper::allow_dynamic_smem((const void*)flash_bwd_dkv_wide_kernel<D, SPLIT>, L::SMEM,
                                  smem_set);
  if (st != 0) return st;
  return launch_kernel(flash_bwd_dkv_wide_kernel<D, SPLIT>, row_grid(Tk, n, H, B),
                       kTwoGroups, L::SMEM, n, stream, tm_q, tm_do, tm_k, tm_v,
                       (const float*)bias, (const float*)lse, (const float*)delta,
                       (__nv_bfloat16*)dk, (__nv_bfloat16*)dv, (float*)dbias, Tq, Tk, H,
                       causal, scale, scale * hopper::kLog2e);
}

bool bad_shape(int B, int Tq, int Tk, int H) {
  return B <= 0 || Tq <= 0 || Tk <= 0 || H <= 0 || B > 65535 || H > 65535;
}

// The columns each of the n CTAs of a head dim D holds, if the kernels are
// built for it: one CTA of 256 or 320; 2 to kMaxSplit CTAs of 192, 256 or
// 320 each. 0 otherwise.
int share_of(int D, int n) {
  if (n < 1 || n > kMaxSplit || D % n != 0) return 0;
  const int w = D / n;
  if (n == 1) return w == 256 || w == 320 ? w : 0;
  return w == 192 || w == 256 || w == 320 ? w : 0;
}

}  // namespace

// bf16 only. q (B, Tq, H*D), k/v (B, Tk, H*D), bias (B, Tk) f32 additive or
// null, o like q, lse (B, H, Tq) f32 or null; n CTAs a head (a cluster above
// 1), D / n columns each, as share_of takes
extern "C" int vt_flash_attention_wide_tc(const void* q, const void* k, const void* v,
                                          const void* bias, void* o, void* lse, int B, int Tq,
                                          int Tk, int H, int D, int n, int causal,
                                          float scale, void* stream) {
  const int w = share_of(D, n);
  if (bad_shape(B, Tq, Tk, H) || w == 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (n == 1)
    return w == 256 ? launch_fwd<256, false>(q, k, v, bias, o, lse, B, Tq, Tk, H, 1, causal,
                                             scale, s)
                    : launch_fwd<320, false>(q, k, v, bias, o, lse, B, Tq, Tk, H, 1, causal,
                                             scale, s);
  switch (w) {
    case 192:
      return launch_fwd<192, true>(q, k, v, bias, o, lse, B, Tq, Tk, H, n, causal, scale, s);
    case 256:
      return launch_fwd<256, true>(q, k, v, bias, o, lse, B, Tq, Tk, H, n, causal, scale, s);
    default:
      return launch_fwd<320, true>(q, k, v, bias, o, lse, B, Tq, Tk, H, n, causal, scale, s);
  }
}

// q/dout/dq (B, Tq, H*D), k/v (B, Tk, H*D), bias (B, Tk) f32 or null,
// lse/delta (B, H, Tq) f32; D and n as above
extern "C" int vt_flash_attention_bwd_dq_wide_tc(const void* q, const void* k, const void* v,
                                                 const void* bias, const void* dout,
                                                 const void* lse, const void* delta, void* dq,
                                                 int B, int Tq, int Tk, int H, int D, int n,
                                                 int causal, float scale, void* stream) {
  const int w = share_of(D, n);
  if (bad_shape(B, Tq, Tk, H) || w == 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (n == 1)
    return w == 256 ? launch_dq<256, false>(q, k, v, bias, dout, lse, delta, dq, B, Tq, Tk, H,
                                            1, causal, scale, s)
                    : launch_dq<320, false>(q, k, v, bias, dout, lse, delta, dq, B, Tq, Tk, H,
                                            1, causal, scale, s);
  switch (w) {
    case 192:
      return launch_dq<192, true>(q, k, v, bias, dout, lse, delta, dq, B, Tq, Tk, H, n,
                                  causal, scale, s);
    case 256:
      return launch_dq<256, true>(q, k, v, bias, dout, lse, delta, dq, B, Tq, Tk, H, n,
                                  causal, scale, s);
    default:
      return launch_dq<320, true>(q, k, v, bias, dout, lse, delta, dq, B, Tq, Tk, H, n,
                                  causal, scale, s);
  }
}

// as above; dk/dv (B, Tk, H*D), dbias (B, H, Tk) f32 per head
extern "C" int vt_flash_attention_bwd_dkv_wide_tc(const void* q, const void* k, const void* v,
                                                  const void* bias, const void* dout,
                                                  const void* lse, const void* delta, void* dk,
                                                  void* dv, void* dbias, int B, int Tq, int Tk,
                                                  int H, int D, int n, int causal,
                                                  float scale, void* stream) {
  const int w = share_of(D, n);
  if (bad_shape(B, Tq, Tk, H) || w == 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (n == 1)
    return w == 256 ? launch_dkv<256, false>(q, k, v, bias, dout, lse, delta, dk, dv, dbias,
                                             B, Tq, Tk, H, 1, causal, scale, s)
                    : launch_dkv<320, false>(q, k, v, bias, dout, lse, delta, dk, dv, dbias,
                                             B, Tq, Tk, H, 1, causal, scale, s);
  switch (w) {
    case 192:
      return launch_dkv<192, true>(q, k, v, bias, dout, lse, delta, dk, dv, dbias, B, Tq, Tk, H,
                                   n, causal, scale, s);
    case 256:
      return launch_dkv<256, true>(q, k, v, bias, dout, lse, delta, dk, dv, dbias, B, Tq, Tk, H,
                                   n, causal, scale, s);
    default:
      return launch_dkv<320, true>(q, k, v, bias, dout, lse, delta, dk, dv, dbias, B, Tq, Tk, H,
                                   n, causal, scale, s);
  }
}
