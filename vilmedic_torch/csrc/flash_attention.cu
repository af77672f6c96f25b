// Flash attention forward (tiled online softmax), written for Hopper (sm_90a).
//
// Replaces: vilmedic_tpu/ops/flash_attention.py::_kernel_v2 (reached through
// `_flash_bthd`, the (B, T, H*D) layout) and ::_kernel (through `_flash_bhtd`,
// the (B*H, T, D) layout). The two differ only in how they lay heads out on
// the TPU's 128 lanes; one kernel covers both. With a non-null `lse` it also
// writes the per-row log-sum-exp the backward (flash_attention_bwd.cu)
// recomputes probabilities from, as the TPU forward's `with_lse` does.
//
// What it computes, per (batch b, head h, query row r):
//   s[c]  = (q[r] . k[c]) * scale + bias[b, c]      f32, over keys c < Tk
//   s[c]  = -1e9 where causal and c > r + Tk - Tq   (replaced, as the TPU does)
//   out[r] = sum_c exp(s[c] - m) v[c] / max(sum_c exp(s[c] - m), 1e-30)
//   lse[b, h, r] = m + log(max(sum_c exp(s[c] - m), 1e-30))   (f32, if asked)
// with the running max m starting at -1e9. q, k, v are read in place from the
// (B, T, H*D) layout through the head stride; out is written in q's dtype.
// A causal row that sees no key (Tq > Tk) averages every V, as the finite
// mask gives: a block holding such a row visits every key tile.
//
// What bounds it on the H100: at the VisionLanguage shapes (B 16, T 1370,
// H 12, D 64) one call is 4 * B * H * Tq * Tk * D = 92 GFLOP against 54 MB
// of q, k, v and out, so the tensor cores bound it, not memory: K and V
// tiles are re-read from L2 by every query tile.
//
// Design (bf16), warp-specialised for Hopper (helpers in hopper_common.cuh):
//   - A CTA of 384 threads owns a (b, h, 128-query) tile: warpgroup 0 is the
//     producer (its registers cut to 40 by setmaxnreg), warpgroups 1 and 2
//     consume 64 query rows each (raised to 232 registers).
//   - One producer thread loads Q once and then K and V tiles of BK keys
//     (128, or 64 at D 128) into a 2-stage ring in dynamic shared memory by
//     TMA (cp.async.bulk.tensor over a (B, T, H, D) tensor map, 128-byte
//     swizzle; 64-byte at D 32, 32-byte at D 16), completing on a full
//     mbarrier per stage;
//     its warp writes the tile's key bias (times log2 e; -inf past Tk) beside
//     it. The consumers release a stage on its empty mbarrier. The copies of
//     the next tile run while the tensor cores work on this one. The tensor
//     maps are encoded on the host for each call (cuTensorMapEncodeTiled,
//     found through cudaGetDriverEntryPoint) and passed as
//     __grid_constant__.
//   - S = Q K^T is one wgmma.mma_async m64nBKk16 per 16 columns of D, both
//     operands read from shared memory through swizzled descriptors (K is
//     K-major, D contiguous); O += P V is the register-A wgmma m64nDk16 per 16
//     keys, P packed from the S accumulator as bf16 (the TPU rounds p to V's
//     dtype) and V read MN-major through the descriptor. Both accumulate in
//     f32 registers; S never leaves them.
//   - Online softmax in the log2 domain: scale * log2(e) is folded into one
//     FMA per score (the bias was scaled when staged), exponentials are
//     ex2.approx, the mask value and running-max floor are -1e9 * log2(e),
//     and the LSE goes back to natural log in the epilogue. The row max and
//     sum follow the accumulator layout (a quad of lanes per row).
//   - Only tiles that cross the causal diagonal take the masked body; the
//     ragged last tile needs none (its keys carry a -inf bias). Causal tiles
//     wholly above the diagonal of the CTA's last row are never loaded; a
//     warpgroup skips (but releases) those above its own rows.
//   - Epilogue: O / max(l, 1e-30) in bf16, staged through the warpgroup's
//     own Q rows in shared memory and written with 16-byte stores (rows past
//     Tq are not written); the f32 LSE, when asked, from one lane per row.
//   - f32 is flash_attention_f32.cu (three-pass TF32 on the same tensor
//     cores; one pass, with TF32's 10-bit mantissa, would break the f32
//     route's parity with the plain version, three keep it), entry
//     vt_flash_attention_f32.
//
// Head dims: 16, 32, 64 and 128 here; bf16 at 256 and 320 is
// flash_attention_wide_tc.cu (whose one consumer warpgroup may keep the
// wide accumulator in registers; an instantiation here at 256 spilled and
// took 1.7-1.9x its time: PERF.md, K4 row), the rest flash_attention_wide_tc.cu
// and flash_attention_gemm.cu.
//
// What bounds the bf16 kernel now (PERF.md, K4 row): not memory. Each
// consumer warpgroup runs S, the softmax and P V of a tile in series, and
// the softmax's work grows with the scores (B * H * Tq * Tk), not with the
// products' operations: PERF.md splits the measured time between the two by
// timing one H * D split into heads of 16 to 128 (time_port.py). No hardware
// counters could be read where it was measured (ncu's counter library does
// not load there). Pipelining P V under the next tile's softmax (with a
// 3-stage ring), the 3-stage ring alone, and turn-taking between the two
// warpgroups were each timed against this design in one call and changed
// nothing beyond the spread, so none is kept.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace {

using namespace flash;

// ------------------------------------------------------------------ bf16 path

constexpr int kThreads = 384;  // producer warpgroup + 2 consumer warpgroups
constexpr int kRows = 128;     // query rows per CTA, 64 per consumer warpgroup
constexpr int kStages = 2;     // K/V ring depth

template <int D>
struct FwdTiles {
  static constexpr int BK = D >= 128 ? 64 : 128;  // keys per tile
  static constexpr int Q = 0;                     // shared-memory offsets (bytes)
  static constexpr int K = Q + kRows * D * 2;
  static constexpr int V = K + kStages * BK * D * 2;
  static constexpr int BIAS = V + kStages * BK * D * 2;
  static constexpr int BAR = BIAS + kStages * BK * 4;  // q_full, full[kStages], empty[kStages]
  static constexpr int SMEM = BAR + (1 + 2 * kStages) * 8 + 1024;  // + alignment slack
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_bf16_kernel(const __grid_constant__ CUtensorMap tm_q,
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
  const int q0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int off = Tk - Tq;
  const int n_tiles = key_tiles(q0, kRows, Tq, Tk, BK, causal);
  float* bias_s = reinterpret_cast<float*>(smem + L::BIAS);
  hopper::init_ring<kStages>(bars, 2 * 128);

  if (threadIdx.x < 128) {  // ---- producer warpgroup: Q once, then K/V tiles and key bias
    hopper::setmaxnreg_dec<40>();
    if (threadIdx.x < 32)
      hopper::ring_producer<D, kStages, kRows, BK>(
          smem, bars, &tm_q, L::Q, nullptr, 0, &tm_k, L::K, &tm_v, L::V, q0, 0, n_tiles, h, b,
          [&](int s, int k0, int lane) {
            hopper::key_bias_log2(bias_s + s * BK, bias, b, Tk, k0, BK, lane);
          });
    return;
  }

  // ---- consumer warpgroups
  hopper::setmaxnreg_inc<232>();
  const int cw = threadIdx.x / 128 - 1;  // 0 or 1
  const int tw = threadIdx.x % 128;
  const int warp = tw / 32;
  const int lane = tw % 32;
  const int g = lane / 4;
  const int t4 = lane % 4;
  const int wq0 = q0 + cw * 64;  // this warpgroup's first row
  const int r0 = wq0 + warp * 16 + g;
  const int r1 = r0 + 8;
  const int w_last = min(wq0 + 63, Tq - 1);
  const bool nokey = causal && wq0 + off < 0;  // holds a row that sees no key
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
    if (!causal || nokey || k0 <= w_last + off) {
      const uint32_t ks = hopper::smem_u32(smem + L::K + s * BK * D * 2);
      const uint32_t vs = hopper::smem_u32(smem + L::V + s * BK * D * 2);
      float sc[BK / 2];
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        hopper::wgmma_ss<BK>(sc, hopper::desc_k<D>(qs, kRows, cw * 64, kk),
                             hopper::desc_k<D>(ks, BK, 0, kk), kk > 0);
      hopper::wgmma_commit();
      hopper::wgmma_wait_all();
      hopper::fence_operand(sc);
      float alpha0, alpha1;
      if (causal && (nokey || k0 + BK - 1 > wq0 + off))
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
      for (int kc = 0; kc < BK / 16; ++kc)
        hopper::wgmma_rs<D>(acc, pa[kc], hopper::desc_mn<D>(vs, BK, kc), 1);
      hopper::wgmma_commit();
      hopper::wgmma_wait_all();
      hopper::fence_operand(acc);
    }
    hopper::mbar_arrive(&bars[1 + kStages + s]);  // release the stage
  }

  // epilogue: normalise; the bf16 rows leave through this warpgroup's Q rows
  l0 = hopper::quad_sum(l0);
  l1 = hopper::quad_sum(l1);
  const float d0 = fmaxf(l0, 1e-30f);
  const float d1 = fmaxf(l1, 1e-30f);
  hopper::store_rows<D>(acc, 1.f / d0, 1.f / d1, smem + L::Q, kRows, cw * 64,
                        o + (((long long)b * Tq + wq0) * H + h) * D, (long long)H * D, Tq - wq0,
                        1 + cw);
  if (lse != nullptr && t4 == 0) {
    float* lb = lse + ((long long)b * H + h) * Tq;
    if (r0 < Tq) lb[r0] = m0 * hopper::kLn2 + logf(d0);
    if (r1 < Tq) lb[r1] = m1 * hopper::kLn2 + logf(d1);
  }
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, const void* bias, void* o,
                void* lse, int B, int Tq, int Tk, int H, int causal, float scale,
                cudaStream_t stream) {
  using L = FwdTiles<D>;
  CUtensorMap tm_q, tm_k, tm_v;
  int st = hopper::make_tensor_map<D>(&tm_q, q, B, Tq, H, kRows);
  if (st == 0) st = hopper::make_tensor_map<D>(&tm_k, k, B, Tk, H, L::BK);
  if (st == 0) st = hopper::make_tensor_map<D>(&tm_v, v, B, Tk, H, L::BK);
  if (st != 0) return st;
  static bool smem_set[hopper::kMaxDevices] = {};
  st = hopper::allow_dynamic_smem((const void*)flash_fwd_bf16_kernel<D>, L::SMEM, smem_set);
  if (st != 0) return st;
  const dim3 grid((Tq + kRows - 1) / kRows, H, B);
  flash_fwd_bf16_kernel<D><<<grid, kThreads, L::SMEM, stream>>>(
      tm_q, tm_k, tm_v, (const float*)bias, (__nv_bfloat16*)o, (float*)lse, Tq, Tk, H, causal,
      scale * hopper::kLog2e);
  return (int)cudaGetLastError();
}

bool bad_shape(int B, int Tq, int Tk, int H) {
  return B <= 0 || Tq <= 0 || Tk <= 0 || H <= 0 || B > 65535 || H > 65535;
}

}  // namespace

// q (B, Tq, H*D), k/v (B, Tk, H*D), bias (B, Tk) f32 additive or null, o like q,
// lse (B, H, Tq) f32 or null
extern "C" int vt_flash_attention_bf16(const void* q, const void* k, const void* v,
                                       const void* bias, void* o, void* lse, int B, int Tq,
                                       int Tk, int H, int D, int causal, float scale,
                                       void* stream) {
  if (bad_shape(B, Tq, Tk, H)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 16:
      return launch_bf16<16>(q, k, v, bias, o, lse, B, Tq, Tk, H, causal, scale, s);
    case 32:
      return launch_bf16<32>(q, k, v, bias, o, lse, B, Tq, Tk, H, causal, scale, s);
    case 64:
      return launch_bf16<64>(q, k, v, bias, o, lse, B, Tq, Tk, H, causal, scale, s);
    case 128:
      return launch_bf16<128>(q, k, v, bias, o, lse, B, Tq, Tk, H, causal, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
