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
// bound it, not memory.
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
//   - f32 is flash_attention_f32.cu (three-pass TF32 on the same tensor
//     cores: the f32 route's parity holds), with the entries
//     vt_flash_attention_bwd_dq_f32 and vt_flash_attention_bwd_dkv_f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace {

using namespace flash;

// ------------------------------------------------------------ bf16 kernels

constexpr int kThreads = 384;  // producer warpgroup + 2 consumer warpgroups
constexpr int kRows = 128;     // rows a CTA owns (queries for dq, keys for dk/dv)
constexpr int kTile = 64;      // rows per ring tile (keys for dq, queries for dk/dv)
constexpr int kStages = 2;     // ring depth

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
        dq_scores<true, kTile>(sc, dp, bs, k0, r0, r1, off, Tk, t4, scale_log2, lse0, lse1, dl0,
                               dl1);
      else
        dq_scores<false, kTile>(sc, dp, bs, k0, r0, r1, off, Tk, t4, scale_log2, lse0, lse1, dl0,
                                dl1);
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
        dkv_scores<true, kTile>(st, dpt, ls, dls, rq0, c0, c1, off, Tk, t4, scale_log2, bias0,
                                bias1, db0, db1);
      else
        dkv_scores<false, kTile>(st, dpt, ls, dls, rq0, c0, c1, off, Tk, t4, scale_log2, bias0,
                                 bias1, db0, db1);
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

bool bad_shape(int B, int Tq, int Tk, int H) {
  return B <= 0 || Tq <= 0 || Tk <= 0 || H <= 0 || B > 65535 || H > 65535;
}

}  // namespace

// q/dout/dq (B, Tq, H*D), k/v (B, Tk, H*D), bias (B, Tk) f32 additive or null,
// lse/delta (B, H, Tq) f32
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
