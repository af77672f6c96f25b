// LM head with per-128-column block statistics, written for Hopper (sm_90a).
//
// Replaces: vilmedic_tpu/ops/blocked_lm_head.py::_kernel, reached through
// `lm_head_blocked_stats`.
//
// What it computes: logits = h @ W^T + b in f32 for h (N, K) and the padded
// head weight W (Vp, K), Vp a multiple of 128 (pad rows of W are zero and
// their bias is -1e30), plus, for every row and every 128-column vocab
// block, the block's max and sum(exp(x - max)). Beam candidate selection
// reads only those stats and the few blocks it picks.
//
// What bounds it on the H100: at N = 128 rows the weight stream (Vp * K
// values) and the f32 logits write are the bytes that matter; at N = 1024
// bytes (the 206 MB of f32 logits) and the 2 * N * K * Vp operations (79
// GFLOP at K = 768, Vp = 50304) weigh about the same.
//
// Output tiles are 128 rows x 128 vocab columns, so a tile is exactly one
// statistics block.
//   - bf16, warp-specialised wgmma: one producer warp keeps a 3-stage ring of
//     (h, W) k-tiles of 64 in flight by TMA (128B swizzle; rows past N and
//     columns past K read zeros), two consumer warpgroups each take 64 rows
//     of the tile by wgmma m64n128k16 with f32 accumulators. The CTAs are
//     persistent and walk the tiles vocab-major (the row tiles of one vocab
//     block next to each other, so W comes from L2 after its first read);
//     the producer runs ahead into the next tile while the consumers'
//     epilogue runs, and two CTAs share an SM, so one's epilogue overlaps
//     the other's products. The epilogue works from the accumulator
//     registers: the bias, the row's max and sum-exp over the 128 columns by
//     two quad shuffles each (a row's columns lie in one quad), and the f32
//     logits written row-major, each quad 32 contiguous bytes.
//   - f32: the CUDA cores (8x8 outputs per thread, 8 k-values per tile), full
//     f32 products, no TF32; the tile goes through shared memory to the same
//     row-wise epilogue.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper_common.cuh"

namespace {

constexpr int BM = 128;       // rows per block
constexpr int BN = 128;       // vocab columns per block == statistics block
constexpr int CS_LD = BN + 4; // f32 epilogue tile stride
constexpr int kThreads = 256;  // the f32 path

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// cs: (BM, CS_LD) f32 products of this block's tile (bias not yet added)
__device__ void epilogue(const float* cs, const float* __restrict__ bias,
                         float* __restrict__ logits, float* __restrict__ bmax,
                         float* __restrict__ bsum, int N, int Vp, int row0,
                         int blk) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int nb = Vp / BN;
  const int col0 = blk * BN;
  const float4 b4 = *reinterpret_cast<const float4*>(bias + col0 + lane * 4);
  for (int rr = warp * 16; rr < warp * 16 + 16; ++rr) {
    const int row = row0 + rr;
    if (row >= N) break;
    float4 x = *reinterpret_cast<const float4*>(cs + rr * CS_LD + lane * 4);
    x.x += b4.x;
    x.y += b4.y;
    x.z += b4.z;
    x.w += b4.w;
    *reinterpret_cast<float4*>(logits + (long long)row * Vp + col0 + lane * 4) = x;
    const float mx = warp_max(fmaxf(fmaxf(x.x, x.y), fmaxf(x.z, x.w)));
    const float se = warp_sum(expf(x.x - mx) + expf(x.y - mx) + expf(x.z - mx) +
                              expf(x.w - mx));
    if (lane == 0) {
      bmax[(long long)row * nb + blk] = mx;
      bsum[(long long)row * nb + blk] = se;
    }
  }
}

// ---------------------------------------------------------------- bf16 path
constexpr int BK = 64;             // k-values per stage: one 128B-swizzled chunk
constexpr int STAGES = 3;
constexpr int kConsumers = 256;    // two warpgroups
constexpr int kWgThreads = kConsumers + 32;  // and the producer warp
constexpr int kStageBytes = 2 * BM * BK * 2;  // h tile + W tile
constexpr int kWgSmem = STAGES * kStageBytes + 1024;  // + the 1024-byte alignment

__global__ void __launch_bounds__(kWgThreads, 2)
    lm_head_wgmma_kernel(const __grid_constant__ CUtensorMap tm_h,
                         const __grid_constant__ CUtensorMap tm_w,
                         const float* __restrict__ bias, float* __restrict__ logits,
                         float* __restrict__ bmax, float* __restrict__ bsum, int N, int Vp,
                         int ksteps, int mtiles, int ntiles) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hopper::align_1024(smem_raw);
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], kConsumers);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();
  const int nb = Vp / BN;

  if (threadIdx.x >= kConsumers) {  // the producer warp
    if (threadIdx.x == kConsumers) {
      int it = 0;
      for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
        const int row0 = (tile % mtiles) * BM, col0 = (tile / mtiles) * BN;
        for (int k = 0; k < ksteps; ++k, ++it) {
          const int s = it % STAGES;
          hopper::mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
          uint8_t* a = smem + s * kStageBytes;
          hopper::mbar_arrive_expect_tx(&full[s], kStageBytes);
          hopper::tma_load_2d(a, &tm_h, k * BK, row0, &full[s]);
          hopper::tma_load_2d(a + BM * BK * 2, &tm_w, k * BK, col0, &full[s]);
        }
      }
    }
    return;
  }

  const int wg = threadIdx.x / 128;  // the consumer warpgroup: rows 64 wg ..
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  int it = 0;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int row0 = (tile % mtiles) * BM, blk = tile / mtiles, col0 = blk * BN;
    float d[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) d[i] = 0.f;
    // one k-step's products stay in flight while the next one's are issued;
    // a stage is released once the products that read it are done
    for (int k = 0; k < ksteps; ++k, ++it) {
      const int s = it % STAGES;
      hopper::mbar_wait(&full[s], (it / STAGES) & 1);
      const uint32_t a = hopper::smem_u32(smem + s * kStageBytes);
      const uint32_t b = a + BM * BK * 2;
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        hopper::wgmma_ss_n128(d, hopper::desc_k<64>(a, BM, 64 * wg, kk),
                              hopper::desc_k<64>(b, BN, 0, kk), 1);
      hopper::wgmma_commit();
      hopper::wgmma_wait_one();
      if (k > 0) hopper::mbar_arrive(&empty[(it + STAGES - 1) % STAGES]);
    }
    hopper::wgmma_wait_all();
    hopper::fence_operand(d);
    hopper::mbar_arrive(&empty[(it + STAGES - 1) % STAGES]);
    // epilogue from the registers: row 16 warp + g (+ 8) of the warpgroup's
    // 64, columns 8 j + 2 t4 (+ 1)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = row0 + 64 * wg + 16 * warp + g + 8 * half;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float2 bj = *reinterpret_cast<const float2*>(bias + col0 + 8 * j + 2 * t4);
        d[4 * j + 2 * half] += bj.x;
        d[4 * j + 2 * half + 1] += bj.y;
        mx = fmaxf(mx, fmaxf(d[4 * j + 2 * half], d[4 * j + 2 * half + 1]));
      }
      mx = hopper::quad_max(mx);
      const float mxl = mx * hopper::kLog2e;
      float se = 0.f;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        se += hopper::fast_exp2(fmaf(d[4 * j + 2 * half], hopper::kLog2e, -mxl));
        se += hopper::fast_exp2(fmaf(d[4 * j + 2 * half + 1], hopper::kLog2e, -mxl));
      }
      se = hopper::quad_sum(se);
      if (row < N) {
        float* out = logits + (long long)row * Vp + col0 + 2 * t4;
#pragma unroll
        for (int j = 0; j < 16; ++j)
          *reinterpret_cast<float2*>(out + 8 * j) =
              make_float2(d[4 * j + 2 * half], d[4 * j + 2 * half + 1]);
        if (t4 == 0) {
          bmax[(long long)row * nb + blk] = mx;
          bsum[(long long)row * nb + blk] = se;
        }
      }
    }
  }
}

// ----------------------------------------------------------------- f32 path
constexpr int BK32 = 8;
constexpr int T_LD = BM + 4;  // k-major f32 tile stride

__global__ void __launch_bounds__(kThreads)
    lm_head_f32_kernel(const float* __restrict__ h, const float* __restrict__ w,
                       const float* __restrict__ bias, float* __restrict__ logits,
                       float* __restrict__ bmax, float* __restrict__ bsum, int N,
                       int K, int Vp) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* as = reinterpret_cast<float*>(smem_raw);  // (BK32, T_LD) k-major
  float* bs = as + BK32 * T_LD;
  float* cs = reinterpret_cast<float*>(smem_raw);

  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const int row0 = blockIdx.x * BM;
  const int blk = blockIdx.y;
  const int col0 = blk * BN;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int lm = tid / 2;        // tile row this thread loads
  const int lk = (tid % 2) * 4;  // its 4 k-values
  for (int k0 = 0; k0 < K; k0 += BK32) {
    const int row = row0 + lm;
    const float4 va = row < N ? *reinterpret_cast<const float4*>(h + (long long)row * K + k0 + lk)
                              : make_float4(0.f, 0.f, 0.f, 0.f);
    const float4 vb = *reinterpret_cast<const float4*>(w + (long long)(col0 + lm) * K + k0 + lk);
    as[(lk + 0) * T_LD + lm] = va.x;
    as[(lk + 1) * T_LD + lm] = va.y;
    as[(lk + 2) * T_LD + lm] = va.z;
    as[(lk + 3) * T_LD + lm] = va.w;
    bs[(lk + 0) * T_LD + lm] = vb.x;
    bs[(lk + 1) * T_LD + lm] = vb.y;
    bs[(lk + 2) * T_LD + lm] = vb.z;
    bs[(lk + 3) * T_LD + lm] = vb.w;
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK32; ++k) {
      float a[8], b[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = as[k * T_LD + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 8; ++j) b[j] = bs[k * T_LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) cs[(ty + 16 * i) * CS_LD + tx + 16 * j] = acc[i][j];
  __syncthreads();
  epilogue(cs, bias, logits, bmax, bsum, N, Vp, row0, blk);
}

constexpr size_t kSmemBytes = (size_t)BM * CS_LD * sizeof(float);
static_assert(2 * BK32 * T_LD * sizeof(float) <= kSmemBytes, "f32 tiles fit");

}  // namespace

// h (N, K) and w (Vp, K) start 16-byte aligned with K a multiple of 8 (the
// tensor maps' rule); persistent CTAs, two per SM.
extern "C" int vt_lm_head_blocked_stats_bf16(const void* h, const void* w,
                                             const void* bias, void* logits,
                                             void* bmax, void* bsum, int N,
                                             int K, int Vp, void* stream) {
  static bool allowed[hopper::kMaxDevices] = {};
  int st = hopper::allow_dynamic_smem((const void*)lm_head_wgmma_kernel, kWgSmem, allowed);
  if (st != 0) return st;
  static hopper::MapCache cache_h, cache_w;
  const CUtensorMap *mh = nullptr, *mw = nullptr;
  if ((st = cache_h.get(&mh, h, N, K, BM)) != 0) return st;
  if ((st = cache_w.get(&mw, w, Vp, K, BN)) != 0) return st;
  const int sms = hopper::sm_count();
  const int mtiles = (N + BM - 1) / BM;
  const int ntiles = mtiles * (Vp / BN);
  const int grid = ntiles < 2 * sms ? ntiles : 2 * sms;
  lm_head_wgmma_kernel<<<grid, kWgThreads, kWgSmem, (cudaStream_t)stream>>>(
      *mh, *mw, (const float*)bias, (float*)logits, (float*)bmax, (float*)bsum, N, Vp,
      (K + BK - 1) / BK, mtiles, ntiles);
  return (int)cudaGetLastError();
}

extern "C" int vt_lm_head_blocked_stats_f32(const void* h, const void* w,
                                            const void* bias, void* logits,
                                            void* bmax, void* bsum, int N,
                                            int K, int Vp, void* stream) {
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        lm_head_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const dim3 grid((N + BM - 1) / BM, Vp / BN);
  lm_head_f32_kernel<<<grid, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
      (const float*)h, (const float*)w, (const float*)bias, (float*)logits,
      (float*)bmax, (float*)bsum, N, K, Vp);
  return (int)cudaGetLastError();
}
