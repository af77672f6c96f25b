// Flash attention at the wide head dims, bf16, on the tensor cores: the
// forward and the backward pair (dq, then dk/dv/dbias) at head dims 256 and
// 320, written for Hopper (sm_90a).
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
// a seventh; a warpgroup runs its products and its softmax in series.
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace {

using namespace flash;

constexpr int kRows = 64;      // rows a CTA owns (queries; keys for dk/dv)
constexpr int kStages = 2;     // ring depth
constexpr int kOneGroup = 160;   // one consumer warpgroup + the producer warp
constexpr int kTwoGroups = 256;  // two consumer warpgroups, no producer warp (dk/dv)
constexpr int kGroup = 128;      // threads of a warpgroup

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

template <int D>
struct FwdTiles {  // shared-memory offsets (bytes)
  static constexpr int BK = 64;  // keys per ring tile
  static constexpr int Q = 0;
  static constexpr int K = Q + kRows * D * 2;
  static constexpr int V = K + kStages * BK * D * 2;
  static constexpr int BIAS = V + kStages * BK * D * 2;
  static constexpr int BAR = BIAS + kStages * BK * 4;  // resident, full[kStages], empty[kStages]
  static constexpr int SMEM = BAR + (1 + 2 * kStages) * 8 + 1024;  // + alignment slack
};

template <int D>
__global__ void __launch_bounds__(kOneGroup, 1)
    flash_fwd_wide_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const float* __restrict__ bias, __nv_bfloat16* __restrict__ o,
                          float* __restrict__ lse, int Tq, int Tk, int H, int causal,
                          float scale_log2) {
  using L = FwdTiles<D>;
  constexpr int BK = L::BK;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hopper::align_1024(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::BAR);
  float* bias_s = reinterpret_cast<float*>(smem + L::BIAS);
  const int q0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int off = Tk - Tq;
  const int n_tiles = key_tiles(q0, kRows, Tq, Tk, BK, causal);
  hopper::init_ring<kStages>(bars, kGroup);

  if (threadIdx.x >= kGroup) {  // ---- producer warp: Q once, then K/V tiles and key bias
    hopper::ring_producer<D, kStages, kRows, BK>(
        smem, bars, &tm_q, L::Q, nullptr, 0, &tm_k, L::K, &tm_v, L::V, q0, 0, n_tiles, h, b,
        [&](int s, int k0, int lane) {
          hopper::key_bias_log2(bias_s + s * BK, bias, b, Tk, k0, BK, lane);
        });
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

  hopper::mbar_wait(&bars[0], 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % kStages;
    const int k0 = it * BK;
    hopper::mbar_wait(&bars[1 + s], (it / kStages) & 1);
    const uint32_t ks = hopper::smem_u32(smem + L::K + s * BK * D * 2);
    const uint32_t vs = hopper::smem_u32(smem + L::V + s * BK * D * 2);
    float sc[BK / 2];
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      hopper::wgmma_ss<BK>(sc, hopper::desc_k<D>(qs, kRows, 0, kk),
                           hopper::desc_k<D>(ks, BK, 0, kk), kk > 0);
    hopper::wgmma_commit();
    hopper::wgmma_wait_all();
    hopper::fence_operand(sc);
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
    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) hopper::pack_a(pa[kc], sc, kc);
    hopper::fence_operand(acc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) wgmma_rs_wide<D, BK>(acc, pa[kc], vs, kc);
    hopper::wgmma_commit();
    hopper::wgmma_wait_all();
    hopper::fence_operand(acc);
    hopper::mbar_arrive(&bars[1 + kStages + s]);  // release the stage
  }

  // epilogue: normalise; the bf16 rows leave through the Q tile
  l0 = hopper::quad_sum(l0);
  l1 = hopper::quad_sum(l1);
  const float d0 = fmaxf(l0, 1e-30f);
  const float d1 = fmaxf(l1, 1e-30f);
  hopper::store_rows<D>(acc, 1.f / d0, 1.f / d1, smem + L::Q, kRows, 0,
                        o + (((long long)b * Tq + q0) * H + h) * D, (long long)H * D, Tq - q0, 1);
  if (lse != nullptr && t4 == 0) {
    float* lb = lse + ((long long)b * H + h) * Tq;
    if (r0 < Tq) lb[r0] = m0 * hopper::kLn2 + logf(d0);
    if (r1 < Tq) lb[r1] = m1 * hopper::kLn2 + logf(d1);
  }
}

// --------------------------------------------------------------------- dq

template <int D>
struct DqTiles {
  static constexpr int BK = D > 256 ? 32 : 64;  // keys per ring tile
  static constexpr int Q = 0;
  static constexpr int DO = Q + kRows * D * 2;
  static constexpr int K = DO + kRows * D * 2;
  static constexpr int V = K + kStages * BK * D * 2;
  static constexpr int BIAS = V + kStages * BK * D * 2;
  static constexpr int BAR = BIAS + kStages * BK * 4;
  static constexpr int SMEM = BAR + (1 + 2 * kStages) * 8 + 1024;
};

template <int D>
__global__ void __launch_bounds__(kOneGroup, 1)
    flash_bwd_dq_wide_kernel(const __grid_constant__ CUtensorMap tm_q,
                             const __grid_constant__ CUtensorMap tm_do,
                             const __grid_constant__ CUtensorMap tm_k,
                             const __grid_constant__ CUtensorMap tm_v,
                             const float* __restrict__ bias, const float* __restrict__ lse,
                             const float* __restrict__ delta, __nv_bfloat16* __restrict__ dq,
                             int Tq, int Tk, int H, int causal, float scale, float scale_log2) {
  using L = DqTiles<D>;
  constexpr int BK = L::BK;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hopper::align_1024(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::BAR);
  float* bias_s = reinterpret_cast<float*>(smem + L::BIAS);
  const int q0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int off = Tk - Tq;
  const int n_tiles = key_tiles(q0, kRows, Tq, Tk, BK, causal);
  hopper::init_ring<kStages>(bars, 128);

  if (threadIdx.x >= kGroup) {  // ---- producer warp: Q, dO once, then K/V tiles and key bias
    hopper::ring_producer<D, kStages, kRows, BK>(
        smem, bars, &tm_q, L::Q, &tm_do, L::DO, &tm_k, L::K, &tm_v, L::V, q0, 0, n_tiles, h, b,
        [&](int s, int k0, int lane) {
          hopper::key_bias_log2(bias_s + s * BK, bias, b, Tk, k0, BK, lane);
        });
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

  hopper::mbar_wait(&bars[0], 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % kStages;
    const int k0 = it * BK;
    hopper::mbar_wait(&bars[1 + s], (it / kStages) & 1);
    const uint32_t ks = hopper::smem_u32(smem + L::K + s * BK * D * 2);
    const uint32_t vs = hopper::smem_u32(smem + L::V + s * BK * D * 2);
    float sc[BK / 2], dp[BK / 2];
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
    hopper::wgmma_wait_all();
    hopper::fence_operand(sc);
    hopper::fence_operand(dp);
    const float* bs = bias_s + s * BK;
    if (causal && (nokey || k0 + BK - 1 > q0 + off))
      dq_scores<true, BK>(sc, dp, bs, k0, r0, r1, off, Tk, t4, scale_log2, lse0, lse1, dl0, dl1);
    else
      dq_scores<false, BK>(sc, dp, bs, k0, r0, r1, off, Tk, t4, scale_log2, lse0, lse1, dl0, dl1);
    uint32_t da[BK / 16][4];
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) hopper::pack_a(da[kc], sc, kc);
    hopper::fence_operand(acc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) wgmma_rs_wide<D, BK>(acc, da[kc], ks, kc);
    hopper::wgmma_commit();
    hopper::wgmma_wait_all();
    hopper::fence_operand(acc);
    hopper::mbar_arrive(&bars[1 + kStages + s]);  // release the stage
  }
  hopper::store_rows<D>(acc, scale, scale, smem + L::Q, kRows, 0,
                        dq + (((long long)b * Tq + q0) * H + h) * D, (long long)H * D, Tq - q0, 1);
}

// ------------------------------------------------------------------ dk/dv

// The dk/dv kernel has no producer warp: the first warp of warpgroup 1, the
// filler, loads the resident tiles and the ring. Lane 0 loads ROWS rows of
// one head from `row` of two tensors (a map each), completing on `bar`.
template <int D, int ROWS>
__device__ __forceinline__ void load_rows(uint8_t* smem, uint64_t* bar, const CUtensorMap* ta,
                                          int off_a, const CUtensorMap* tb, int off_b, int row,
                                          int h, int b) {
  using G = hopper::Tile<D>;
#pragma unroll
  for (int c = 0; c < G::NCH; ++c) {
    hopper::tma_load_4d(smem + off_a + c * ROWS * G::SW, ta, c * G::CW, h, row, b, bar);
    hopper::tma_load_4d(smem + off_b + c * ROWS * G::SW, tb, c * G::CW, h, row, b, bar);
  }
}

// The filler warp's fill of ring tile `it` (rows (t0 + it) * ROWS of ta and
// tb) into stage it % kStages, with `stats(stage, first row, lane)` writing
// the tile's per-row values beside it (from registers: the filler fetches
// them a tile ahead, so that their global loads run under the products and
// do not stall its warpgroup): the stage's full barrier completes on the TMA
// bytes and the warp's arrival. The caller has made sure the stage is free
// (the other warpgroup's release on its empty barrier, its own warpgroup's
// products complete).
template <int D, int ROWS, typename Stats>
__device__ __forceinline__ void fill_stage(uint8_t* smem, uint64_t* bars, const CUtensorMap* ta,
                                           int off_a, const CUtensorMap* tb, int off_b, int it,
                                           int t0, int h, int b, int lane, Stats stats) {
  const int s = it % kStages;
  const int r0 = (t0 + it) * ROWS;
  uint64_t* full = &bars[1 + s];
  if (lane == 0) {
    hopper::mbar_arrive_expect_tx(full, 2 * ROWS * D * 2);
    load_rows<D, ROWS>(smem, full, ta, off_a + s * ROWS * D * 2, tb, off_b + s * ROWS * D * 2, r0,
                       h, b);
  }
  stats(s, r0, lane);
  __syncwarp();
  if (lane == 0) hopper::mbar_arrive(full);  // the per-row values are written
}


template <int D>
struct DkvTiles {
  static constexpr int BQ = D > 256 ? 32 : 64;  // query rows per ring tile
  static constexpr int K = 0;
  static constexpr int V = K + kRows * D * 2;
  static constexpr int Q = V + kRows * D * 2;
  static constexpr int DO = Q + kStages * BQ * D * 2;
  static constexpr int P = DO + kStages * BQ * D * 2;  // P^T (f32), warpgroup 0 -> 1
  static constexpr int LSE = P + kRows * BQ * 4;
  static constexpr int DELTA = LSE + kStages * BQ * 4;
  static constexpr int BAR = DELTA + kStages * BQ * 4;
  static constexpr int SMEM = BAR + (1 + 2 * kStages) * 8 + 1024;
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

template <int D>
__global__ void __launch_bounds__(kTwoGroups, 1)
    flash_bwd_dkv_wide_kernel(const __grid_constant__ CUtensorMap tm_q,
                              const __grid_constant__ CUtensorMap tm_do,
                              const __grid_constant__ CUtensorMap tm_k,
                              const __grid_constant__ CUtensorMap tm_v,
                              const float* __restrict__ bias, const float* __restrict__ lse,
                              const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
                              __nv_bfloat16* __restrict__ dv, float* __restrict__ dbias, int Tq,
                              int Tk, int H, int causal, float scale, float scale_log2) {
  using L = DkvTiles<D>;
  constexpr int BQ = L::BQ;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hopper::align_1024(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::BAR);
  float* p_s = reinterpret_cast<float*>(smem + L::P);
  float* lse_s = reinterpret_cast<float*>(smem + L::LSE);
  float* delta_s = reinterpret_cast<float*>(smem + L::DELTA);
  const int k0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int off = Tk - Tq;
  const int t0 = first_query_tile(k0, Tq, Tk, BQ, causal);
  const int n_tiles = (Tq + BQ - 1) / BQ - t0;
  hopper::init_ring<kStages>(bars, kGroup);  // a stage is free once warpgroup 0 releases it

  // both warpgroups over the CTA's 64 keys: 0 makes P^T and dV, 1 makes
  // dS^T, dK and dbias
  const int role = threadIdx.x / kGroup;
  const int tw = threadIdx.x % kGroup;
  const bool filler = role == 1 && tw < 32;  // the warp that loads the tiles
  const int lane = tw % 32;
  const float* lb = lse + ((long long)b * H + h) * Tq;
  const float* db = delta + ((long long)b * H + h) * Tq;
  // the lse (times log2 e; +inf past Tq, so p = 0 there) and delta of the
  // query tile the filler loads next
  float nl[BQ / 32], nd[BQ / 32];
  auto fetch_stats = [&](int it) {
#pragma unroll
    for (int i = 0; i < BQ / 32; ++i) {
      const int r = (t0 + it) * BQ + 32 * i + lane;
      nl[i] = r < Tq ? lb[r] * hopper::kLog2e : INFINITY;
      nd[i] = r < Tq ? db[r] : 0.f;
    }
  };
  auto put_stats = [&](int s, int, int) {
#pragma unroll
    for (int i = 0; i < BQ / 32; ++i) {
      lse_s[s * BQ + 32 * i + lane] = nl[i];
      delta_s[s * BQ + 32 * i + lane] = nd[i];
    }
  };
  if (filler) {  // K and V once, then the first stages of Q/dO tiles and their stats
    if (lane == 0) {
      hopper::mbar_arrive_expect_tx(&bars[0], 2 * kRows * D * 2);
      load_rows<D, kRows>(smem, &bars[0], &tm_k, L::K, &tm_v, L::V, k0, h, b);
    }
    for (int it = 0; it < min(kStages, n_tiles); ++it) {
      fetch_stats(it);
      fill_stage<D, BQ>(smem, bars, &tm_q, L::Q, &tm_do, L::DO, it, t0, h, b, lane, put_stats);
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

  hopper::mbar_wait(&bars[0], 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % kStages;
    const int rq0 = (t0 + it) * BQ;
    if (filler && it + kStages < n_tiles) fetch_stats(it + kStages);
    hopper::mbar_wait(&bars[1 + s], (it / kStages) & 1);
    const int r_last = min(rq0 + BQ - 1, Tq - 1);
    if (!causal || rq0 + off < 0 || k0 <= r_last + off) {
      const uint32_t qs = hopper::smem_u32(smem + L::Q + s * BQ * D * 2);
      const uint32_t dos = hopper::smem_u32(smem + L::DO + s * BQ * D * 2);
      float x[BQ / 2];  // S^T then P^T (0); dP^T then dS^T (1)
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        hopper::wgmma_ss<BQ>(x, hopper::desc_k<D>(role == 0 ? ks : vs, kRows, 0, kk),
                             hopper::desc_k<D>(role == 0 ? qs : dos, BQ, 0, kk), kk > 0);
      hopper::wgmma_commit();
      hopper::wgmma_wait_all();
      hopper::fence_operand(x);
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
      uint32_t xa[BQ / 16][4];
#pragma unroll
      for (int kc = 0; kc < BQ / 16; ++kc) hopper::pack_a(xa[kc], x, kc);
      hopper::fence_operand(acc);
      hopper::wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < BQ / 16; ++kc)  // dV += P^T dO; dK += dS^T Q
        wgmma_rs_wide<D, BQ>(acc, xa[kc], role == 0 ? dos : qs, kc);
      hopper::wgmma_commit();
      hopper::wgmma_wait_all();
      hopper::fence_operand(acc);
    }
    if (role == 0) {
      hopper::mbar_arrive(&bars[1 + kStages + s]);  // release the stage
    } else if (filler && it + kStages < n_tiles) {
      // warpgroup 1 is done with the stage here (its products have
      // completed, and they follow each warp's reads of the stage's lse
      // and delta); refill it once warpgroup 0 is done too
      hopper::mbar_wait(&bars[1 + kStages + s], (it / kStages) & 1);
      fill_stage<D, BQ>(smem, bars, &tm_q, L::Q, &tm_do, L::DO, it + kStages, t0, h, b, lane,
                        put_stats);
    }
  }
  // warpgroup 0 waits for the last hand-over to be read: after it warpgroup
  // 1 no longer reads V, and warpgroup 0 no longer reads K, so each may
  // stage its rows through the other's operand
  if (role == 0 && done > 0) hopper::named_sync(kBarPFree, 2 * 128);

  const long long row0 = ((long long)b * Tk + k0) * H + h;
  if (role == 0) {
    hopper::store_rows<D>(acc, 1.f, 1.f, smem + L::V, kRows, 0, dv + row0 * D, (long long)H * D,
                          Tk - k0, 1);
  } else {
    db0 = hopper::quad_sum(db0);
    db1 = hopper::quad_sum(db1);
    if (t4 == 0) {
      float* dbb = dbias + ((long long)b * H + h) * Tk;
      if (c0 < Tk) dbb[c0] = db0;
      if (c1 < Tk) dbb[c1] = db1;
    }
    hopper::store_rows<D>(acc, scale, scale, smem + L::K, kRows, 0, dk + row0 * D,
                          (long long)H * D, Tk - k0, 2);
  }
}

// ------------------------------------------------------------------- host

template <int D>
int launch_fwd(const void* q, const void* k, const void* v, const void* bias, void* o, void* lse,
               int B, int Tq, int Tk, int H, int causal, float scale, cudaStream_t stream) {
  using L = FwdTiles<D>;
  CUtensorMap tm_q, tm_k, tm_v;
  int st = hopper::make_tensor_map<D>(&tm_q, q, B, Tq, H, kRows);
  if (st == 0) st = hopper::make_tensor_map<D>(&tm_k, k, B, Tk, H, L::BK);
  if (st == 0) st = hopper::make_tensor_map<D>(&tm_v, v, B, Tk, H, L::BK);
  if (st != 0) return st;
  static bool smem_set[hopper::kMaxDevices] = {};
  st = hopper::allow_dynamic_smem((const void*)flash_fwd_wide_kernel<D>, L::SMEM, smem_set);
  if (st != 0) return st;
  const dim3 grid((Tq + kRows - 1) / kRows, H, B);
  flash_fwd_wide_kernel<D><<<grid, kOneGroup, L::SMEM, stream>>>(
      tm_q, tm_k, tm_v, (const float*)bias, (__nv_bfloat16*)o, (float*)lse, Tq, Tk, H, causal,
      scale * hopper::kLog2e);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* bias, const void* dout,
              const void* lse, const void* delta, void* dq, int B, int Tq, int Tk, int H,
              int causal, float scale, cudaStream_t stream) {
  using L = DqTiles<D>;
  CUtensorMap tm_q, tm_do, tm_k, tm_v;
  int st = hopper::make_tensor_map<D>(&tm_q, q, B, Tq, H, kRows);
  if (st == 0) st = hopper::make_tensor_map<D>(&tm_do, dout, B, Tq, H, kRows);
  if (st == 0) st = hopper::make_tensor_map<D>(&tm_k, k, B, Tk, H, L::BK);
  if (st == 0) st = hopper::make_tensor_map<D>(&tm_v, v, B, Tk, H, L::BK);
  if (st != 0) return st;
  static bool smem_set[hopper::kMaxDevices] = {};
  st = hopper::allow_dynamic_smem((const void*)flash_bwd_dq_wide_kernel<D>, L::SMEM, smem_set);
  if (st != 0) return st;
  const dim3 grid((Tq + kRows - 1) / kRows, H, B);
  flash_bwd_dq_wide_kernel<D><<<grid, kOneGroup, L::SMEM, stream>>>(
      tm_q, tm_do, tm_k, tm_v, (const float*)bias, (const float*)lse, (const float*)delta,
      (__nv_bfloat16*)dq, Tq, Tk, H, causal, scale, scale * hopper::kLog2e);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* bias, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv, void* dbias, int B,
               int Tq, int Tk, int H, int causal, float scale, cudaStream_t stream) {
  using L = DkvTiles<D>;
  CUtensorMap tm_q, tm_do, tm_k, tm_v;
  int st = hopper::make_tensor_map<D>(&tm_q, q, B, Tq, H, L::BQ);
  if (st == 0) st = hopper::make_tensor_map<D>(&tm_do, dout, B, Tq, H, L::BQ);
  if (st == 0) st = hopper::make_tensor_map<D>(&tm_k, k, B, Tk, H, kRows);
  if (st == 0) st = hopper::make_tensor_map<D>(&tm_v, v, B, Tk, H, kRows);
  if (st != 0) return st;
  static bool smem_set[hopper::kMaxDevices] = {};
  st = hopper::allow_dynamic_smem((const void*)flash_bwd_dkv_wide_kernel<D>, L::SMEM, smem_set);
  if (st != 0) return st;
  const dim3 grid((Tk + kRows - 1) / kRows, H, B);
  flash_bwd_dkv_wide_kernel<D><<<grid, kTwoGroups, L::SMEM, stream>>>(
      tm_q, tm_do, tm_k, tm_v, (const float*)bias, (const float*)lse, (const float*)delta,
      (__nv_bfloat16*)dk, (__nv_bfloat16*)dv, (float*)dbias, Tq, Tk, H, causal, scale,
      scale * hopper::kLog2e);
  return (int)cudaGetLastError();
}

bool bad_shape(int B, int Tq, int Tk, int H) {
  return B <= 0 || Tq <= 0 || Tk <= 0 || H <= 0 || B > 65535 || H > 65535;
}

}  // namespace

// bf16 only. q (B, Tq, H*D), k/v (B, Tk, H*D), bias (B, Tk) f32 additive or
// null, o like q, lse (B, H, Tq) f32 or null; D 256 or 320
extern "C" int vt_flash_attention_wide_tc(const void* q, const void* k, const void* v,
                                          const void* bias, void* o, void* lse, int B, int Tq,
                                          int Tk, int H, int D, int causal, float scale,
                                          void* stream) {
  if (bad_shape(B, Tq, Tk, H)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 256:
      return launch_fwd<256>(q, k, v, bias, o, lse, B, Tq, Tk, H, causal, scale, s);
    case 320:
      return launch_fwd<320>(q, k, v, bias, o, lse, B, Tq, Tk, H, causal, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// q/dout/dq (B, Tq, H*D), k/v (B, Tk, H*D), bias (B, Tk) f32 or null,
// lse/delta (B, H, Tq) f32; D 256 or 320
extern "C" int vt_flash_attention_bwd_dq_wide_tc(const void* q, const void* k, const void* v,
                                                 const void* bias, const void* dout,
                                                 const void* lse, const void* delta, void* dq,
                                                 int B, int Tq, int Tk, int H, int D, int causal,
                                                 float scale, void* stream) {
  if (bad_shape(B, Tq, Tk, H)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 256:
      return launch_dq<256>(q, k, v, bias, dout, lse, delta, dq, B, Tq, Tk, H, causal, scale, s);
    case 320:
      return launch_dq<320>(q, k, v, bias, dout, lse, delta, dq, B, Tq, Tk, H, causal, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// as above; dk/dv (B, Tk, H*D), dbias (B, H, Tk) f32 per head
extern "C" int vt_flash_attention_bwd_dkv_wide_tc(const void* q, const void* k, const void* v,
                                                  const void* bias, const void* dout,
                                                  const void* lse, const void* delta, void* dk,
                                                  void* dv, void* dbias, int B, int Tq, int Tk,
                                                  int H, int D, int causal, float scale,
                                                  void* stream) {
  if (bad_shape(B, Tq, Tk, H)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 256:
      return launch_dkv<256>(q, k, v, bias, dout, lse, delta, dk, dv, dbias, B, Tq, Tk, H,
                             causal, scale, s);
    case 320:
      return launch_dkv<320>(q, k, v, bias, dout, lse, delta, dk, dv, dbias, B, Tq, Tk, H,
                             causal, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
