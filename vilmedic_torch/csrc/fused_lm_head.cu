// LM head with each row's top-r logits and logsumexp, written for Hopper
// (sm_90a). The (N, Vp) logits never reach device memory.
//
// Replaces: vilmedic_tpu/ops/fused_lm_head.py::_kernel (with `_peel_topk`),
// reached through `lm_head_topk_lse`.
//
// What it computes: for h (N, K) and the padded head weight W (K, Vp) in the
// JAX layout (Vp a multiple of 128; pad columns of W are zero and their f32
// bias is -1e30), logits = h @ W + b in f32, and per row the r largest
// logits with their columns (ties to the lower column, `lax.top_k`'s order)
// and log(sum(exp(logits))).
//
// What bounds it on the H100: at N = 128 the weight stream (K * Vp values,
// 78.6 MB in bf16 at K 768, Vp 51200); at N = 1024 the 2 * N * K * Vp
// operations (80.5 GFLOP).
//
// Design: the TPU kernel walks the vocabulary tiles in order on one core and
// carries a running top-r and logsumexp from tile to tile. Here the
// vocabulary is split across blocks instead:
//   - `topk_chunk_*`: one block per (128-row tile, chunk of `sub` 128-column
//     vocab tiles). Per vocab tile it computes the (128 x 128) f32 logits
//     (bf16: nvcuda::wmma 16x16x16 with f32 accumulation, double-buffered
//     k-tiles of 32; f32: FMA on the CUDA cores, no TF32), stores them in
//     shared memory, and each warp then folds its 16 rows into the row's
//     running (max, sum-exp) and running top-r list. A list lives in shared
//     memory, one entry per lane, best first; a tile's values enter by
//     repeated warp argmax while the best remaining value beats the list's
//     r-th entry, so after the first tile a row costs about one argmax per
//     tile. Each block writes a partial top-r and (max, sum-exp) per row.
//   - `topk_merge`: one warp per row merges the chunks' partial lists and
//     partial sums into the final top-r and lse.
// Every comparison is on (value, column) pairs, so the result does not
// depend on the order in which chunks or lanes are visited. Speed is a later
// PR's work: no TMA, no wgmma.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int BM = 128;        // rows per block
constexpr int BN = 128;        // vocab columns per tile
constexpr int CS_LD = BN + 4;  // f32 logits tile stride
constexpr int kThreads = 256;
constexpr int kMaxR = 32;      // one list entry per lane
constexpr int kRowsPerWarp = BM / (kThreads / 32);

__device__ __forceinline__ bool beats(float v, int c, float ov, int oc) {
  return v > ov || (v == ov && c < oc);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// every lane ends with the warp's best (v, c)
__device__ __forceinline__ void warp_best(float& v, int& c) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(kFull, v, o);
    const int oc = __shfl_xor_sync(kFull, c, o);
    if (beats(ov, oc, v, c)) {
      v = ov;
      c = oc;
    }
  }
}

// (lv, lc): lane i < r holds entry i of a row's list, best first. (v, c)
// beats entry r - 1 (the caller checked); it takes its place in the order.
__device__ __forceinline__ void insert(float& lv, int& lc, float v, int c, int r, int lane) {
  const bool better = lane < r && beats(lv, lc, v, c);
  const int pos = __popc(__ballot_sync(kFull, better));
  const float uv = __shfl_up_sync(kFull, lv, 1);
  const int uc = __shfl_up_sync(kFull, lc, 1);
  if (lane < r) {
    if (lane == pos) {
      lv = v;
      lc = c;
    } else if (lane > pos) {
      lv = uv;
      lc = uc;
    }
  }
}

// Fold candidates into a list: lane holds `n` candidates (x[j], cols[j]);
// repeated warp argmax over those not yet taken while the best beats entry
// r - 1.
template <int n>
__device__ __forceinline__ void fold(const float (&x)[n], const int (&cols)[n], float& lv,
                                     int& lc, int r, int lane) {
  unsigned taken = 0;
  float tv = __shfl_sync(kFull, lv, r - 1);
  int tc = __shfl_sync(kFull, lc, r - 1);
  while (true) {
    float bv = -INFINITY;
    int bc = INT_MAX;
#pragma unroll
    for (int j = 0; j < n; ++j)
      if (!((taken >> j) & 1u) && beats(x[j], cols[j], bv, bc)) {
        bv = x[j];
        bc = cols[j];
      }
    warp_best(bv, bc);
    if (!beats(bv, bc, tv, tc)) break;
    insert(lv, lc, bv, bc, r, lane);
#pragma unroll
    for (int j = 0; j < n; ++j)
      if (cols[j] == bc) taken |= 1u << j;
    tv = __shfl_sync(kFull, lv, r - 1);
    tc = __shfl_sync(kFull, lc, r - 1);
  }
}

struct RowState {  // per block: the 128 rows' running lists and sums
  float lv[BM][kMaxR];
  int lc[BM][kMaxR];
  float m[BM];
  float s[BM];
};

__device__ void init_rows(RowState* st) {
  for (int i = threadIdx.x; i < BM * kMaxR; i += kThreads) {
    (&st->lv[0][0])[i] = -INFINITY;
    (&st->lc[0][0])[i] = INT_MAX;
  }
  for (int i = threadIdx.x; i < BM; i += kThreads) {
    st->m[i] = -INFINITY;
    st->s[i] = 0.f;
  }
}

// cs: (BM, CS_LD) f32 products of vocab tile `tile` (bias not yet added).
// Warp w folds rows w*16 .. w*16+15 into their running state.
__device__ void fold_tile(const float* cs, const float* __restrict__ bias, RowState* st,
                          int N, int row0, int tile, int r) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int col = tile * BN + lane * 4;
  const float4 b4 = *reinterpret_cast<const float4*>(bias + col);
  const int cols[4] = {col, col + 1, col + 2, col + 3};
  for (int rr = warp * kRowsPerWarp; rr < (warp + 1) * kRowsPerWarp; ++rr) {
    if (row0 + rr >= N) break;
    const float4 p = *reinterpret_cast<const float4*>(cs + rr * CS_LD + lane * 4);
    const float x[4] = {p.x + b4.x, p.y + b4.y, p.z + b4.z, p.w + b4.w};
    const float mx = warp_max(fmaxf(fmaxf(x[0], x[1]), fmaxf(x[2], x[3])));
    const float se = warp_sum(expf(x[0] - mx) + expf(x[1] - mx) + expf(x[2] - mx) +
                              expf(x[3] - mx));
    const float m0 = st->m[rr];
    const float m1 = fmaxf(m0, mx);
    const float s1 = st->s[rr] * expf(m0 - m1) + se * expf(mx - m1);
    float lv = st->lv[rr][lane];
    int lc = st->lc[rr][lane];
    fold(x, cols, lv, lc, r, lane);
    __syncwarp();
    st->lv[rr][lane] = lv;
    st->lc[rr][lane] = lc;
    if (lane == 0) {
      st->m[rr] = m1;
      st->s[rr] = s1;
    }
    __syncwarp();
  }
}

// the block's partial results: part_v/part_c (N, nchunks, r), part_m/part_s (N, nchunks)
__device__ void write_partials(const RowState* st, float* __restrict__ part_v,
                               int* __restrict__ part_c, float* __restrict__ part_m,
                               float* __restrict__ part_s, int N, int row0, int chunk,
                               int nchunks, int r) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int rr = warp * kRowsPerWarp; rr < (warp + 1) * kRowsPerWarp; ++rr) {
    const int row = row0 + rr;
    if (row >= N) break;
    const long long at = (long long)row * nchunks + chunk;
    if (lane < r) {
      part_v[at * r + lane] = st->lv[rr][lane];
      part_c[at * r + lane] = st->lc[rr][lane];
    }
    if (lane == 0) {
      part_m[at] = st->m[rr];
      part_s[at] = st->s[rr];
    }
  }
}

// ---------------------------------------------------------------- bf16 path
constexpr int BK16 = 32;
constexpr int A_LD = BK16 + 8;  // A tile (BM, BK16) stride: 80-byte rows
constexpr int B_LD = BN + 8;    // B tile (BK16, BN) stride: 272-byte rows
constexpr int A_TILE = BM * A_LD;
constexpr int B_TILE = BK16 * B_LD;
constexpr size_t kTileBytes = (size_t)BM * CS_LD * sizeof(float);
static_assert(2 * (A_TILE + B_TILE) * sizeof(__nv_bfloat16) <= kTileBytes, "bf16 tiles fit");

__global__ void __launch_bounds__(kThreads)
    topk_chunk_bf16(const __nv_bfloat16* __restrict__ h, const __nv_bfloat16* __restrict__ w,
                    const float* __restrict__ bias, float* __restrict__ part_v,
                    int* __restrict__ part_c, float* __restrict__ part_m,
                    float* __restrict__ part_s, int N, int K, int Vp, int r, int sub) {
  using namespace nvcuda;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  // [buf][A | B] bf16 tiles during a tile's products, then the f32 logits
  __nv_bfloat16* tiles = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  float* cs = reinterpret_cast<float*>(smem_raw);
  RowState* st = reinterpret_cast<RowState*>(smem_raw + kTileBytes);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int row0 = blockIdx.x * BM;
  const int chunk = blockIdx.y;
  const int nchunks = gridDim.y;
  const int wm = (warp / 2) * 32;  // warp's 32-row slice
  const int wn = (warp % 2) * 64;  // warp's 64-column slice
  const int nb = Vp / BN;
  const int tile_end = min(nb, (chunk + 1) * sub);
  init_rows(st);

  uint4 ra[2], rb[2];
  for (int tile = chunk * sub; tile < tile_end; ++tile) {
    const int col0 = tile * BN;
    // each thread moves two 16-byte vectors of A and two of B per k-tile
    auto load_global = [&](int k0) {
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        const int idx = tid + v * kThreads;  // 0..511
        const int m = idx / 4, kq = (idx % 4) * 8;
        const int row = row0 + m;
        ra[v] = row < N ? *reinterpret_cast<const uint4*>(h + (long long)row * K + k0 + kq)
                        : make_uint4(0u, 0u, 0u, 0u);
        const int kr = idx / 16, cq = (idx % 16) * 8;
        rb[v] = *reinterpret_cast<const uint4*>(w + (long long)(k0 + kr) * Vp + col0 + cq);
      }
    };
    auto store_shared = [&](int buf) {
      __nv_bfloat16* a = tiles + buf * (A_TILE + B_TILE);
      __nv_bfloat16* b = a + A_TILE;
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        const int idx = tid + v * kThreads;
        *reinterpret_cast<uint4*>(a + (idx / 4) * A_LD + (idx % 4) * 8) = ra[v];
        *reinterpret_cast<uint4*>(b + (idx / 16) * B_LD + (idx % 16) * 8) = rb[v];
      }
    };

    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.f);

    const int ktiles = K / BK16;
    load_global(0);
    __syncthreads();  // the previous tile's fold has read cs
    store_shared(0);
    __syncthreads();
    for (int kt = 0; kt < ktiles; ++kt) {
      const int buf = kt & 1;
      if (kt + 1 < ktiles) load_global((kt + 1) * BK16);
      const __nv_bfloat16* a = tiles + buf * (A_TILE + B_TILE);
      const __nv_bfloat16* b = a + A_TILE;
#pragma unroll
      for (int kk = 0; kk < BK16; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb[4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(fa[i], a + (wm + i * 16) * A_LD + kk, A_LD);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          wmma::load_matrix_sync(fb[j], b + kk * B_LD + wn + j * 16, B_LD);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
      }
      if (kt + 1 < ktiles) store_shared(buf ^ 1);
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::store_matrix_sync(cs + (wm + i * 16) * CS_LD + wn + j * 16, acc[i][j], CS_LD,
                                wmma::mem_row_major);
    __syncthreads();
    fold_tile(cs, bias, st, N, row0, tile, r);
  }
  write_partials(st, part_v, part_c, part_m, part_s, N, row0, chunk, nchunks, r);
}

// ----------------------------------------------------------------- f32 path
constexpr int BK32 = 8;
constexpr int T_LD = BM + 4;  // k-major f32 tile stride
static_assert(2 * BK32 * T_LD * sizeof(float) <= kTileBytes, "f32 tiles fit");

__global__ void __launch_bounds__(kThreads)
    topk_chunk_f32(const float* __restrict__ h, const float* __restrict__ w,
                   const float* __restrict__ bias, float* __restrict__ part_v,
                   int* __restrict__ part_c, float* __restrict__ part_m,
                   float* __restrict__ part_s, int N, int K, int Vp, int r, int sub) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* as = reinterpret_cast<float*>(smem_raw);  // (BK32, T_LD) k-major
  float* bs = as + BK32 * T_LD;                    // (BK32, T_LD) k-major
  float* cs = reinterpret_cast<float*>(smem_raw);
  RowState* st = reinterpret_cast<RowState*>(smem_raw + kTileBytes);

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int row0 = blockIdx.x * BM;
  const int chunk = blockIdx.y;
  const int nchunks = gridDim.y;
  const int nb = Vp / BN;
  const int tile_end = min(nb, (chunk + 1) * sub);
  const int lm = tid / 2, lk = (tid % 2) * 4;  // A: tile row and 4 k-values
  const int bk = tid / 32, bn = (tid % 32) * 4;  // B: k-row and 4 columns
  init_rows(st);

  for (int tile = chunk * sub; tile < tile_end; ++tile) {
    const int col0 = tile * BN;
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    __syncthreads();  // the previous tile's fold has read cs
    for (int k0 = 0; k0 < K; k0 += BK32) {
      const int row = row0 + lm;
      const float4 va = row < N
                            ? *reinterpret_cast<const float4*>(h + (long long)row * K + k0 + lk)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
      const float4 vb = *reinterpret_cast<const float4*>(w + (long long)(k0 + bk) * Vp + col0 + bn);
      as[(lk + 0) * T_LD + lm] = va.x;
      as[(lk + 1) * T_LD + lm] = va.y;
      as[(lk + 2) * T_LD + lm] = va.z;
      as[(lk + 3) * T_LD + lm] = va.w;
      *reinterpret_cast<float4*>(bs + bk * T_LD + bn) = vb;
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
    fold_tile(cs, bias, st, N, row0, tile, r);
  }
  write_partials(st, part_v, part_c, part_m, part_s, N, row0, chunk, nchunks, r);
}

// ------------------------------------------------------------------- merge
constexpr int kMergeWarps = 8;

__global__ void __launch_bounds__(kMergeWarps * 32)
    topk_merge(const float* __restrict__ part_v, const int* __restrict__ part_c,
               const float* __restrict__ part_m, const float* __restrict__ part_s,
               float* __restrict__ vals, int* __restrict__ idx, float* __restrict__ lse, int N,
               int nchunks, int r) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kMergeWarps + threadIdx.x / 32;
  if (row >= N) return;
  float lv = -INFINITY, m = -INFINITY, s = 0.f;
  int lc = INT_MAX;
  for (int ch = 0; ch < nchunks; ++ch) {
    const long long at = (long long)row * nchunks + ch;
    float x[1] = {-INFINITY};
    int cols[1] = {INT_MAX};
    if (lane < r) {
      x[0] = part_v[at * r + lane];
      cols[0] = part_c[at * r + lane];
    }
    fold(x, cols, lv, lc, r, lane);
    const float pm = part_m[at];
    const float m1 = fmaxf(m, pm);
    s = s * expf(m - m1) + part_s[at] * expf(pm - m1);
    m = m1;
  }
  if (lane < r) {
    vals[(long long)row * r + lane] = lv;
    idx[(long long)row * r + lane] = lc;
  }
  if (lane == 0) lse[row] = logf(s) + m;
}

constexpr size_t kSmemBytes = kTileBytes + sizeof(RowState);

template <typename T, typename Kernel>
int launch(Kernel kernel, const void* h, const void* w, const void* bias, void* vals, void* idx,
           void* lse, void* part_v, void* part_c, void* part_m, void* part_s, int N, int K,
           int Vp, int r, int sub, void* stream, bool& configured) {
  if (!configured) {  // above 48 KB a block's shared memory must be opted into
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const int nb = Vp / BN;
  const int nchunks = (nb + sub - 1) / sub;
  const dim3 grid((N + BM - 1) / BM, nchunks);
  cudaStream_t s = (cudaStream_t)stream;
  kernel<<<grid, kThreads, kSmemBytes, s>>>(
      (const T*)h, (const T*)w, (const float*)bias, (float*)part_v, (int*)part_c,
      (float*)part_m, (float*)part_s, N, K, Vp, r, sub);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  topk_merge<<<(N + kMergeWarps - 1) / kMergeWarps, kMergeWarps * 32, 0, s>>>(
      (const float*)part_v, (const int*)part_c, (const float*)part_m, (const float*)part_s,
      (float*)vals, (int*)idx, (float*)lse, N, nchunks, r);
  return (int)cudaGetLastError();
}

}  // namespace

// Partials: part_v/part_c (N, nchunks, r), part_m/part_s (N, nchunks) with
// nchunks = ceil(Vp / 128 / sub); outputs vals/idx (N, r), lse (N,).
extern "C" int vt_lm_head_topk_lse_bf16(const void* h, const void* w, const void* bias,
                                        void* vals, void* idx, void* lse, void* part_v,
                                        void* part_c, void* part_m, void* part_s, int N, int K,
                                        int Vp, int r, int sub, void* stream) {
  static bool configured = false;
  return launch<__nv_bfloat16>(topk_chunk_bf16, h, w, bias, vals, idx, lse, part_v, part_c,
                               part_m, part_s, N, K, Vp, r, sub, stream, configured);
}

extern "C" int vt_lm_head_topk_lse_f32(const void* h, const void* w, const void* bias,
                                       void* vals, void* idx, void* lse, void* part_v,
                                       void* part_c, void* part_m, void* part_s, int N, int K,
                                       int Vp, int r, int sub, void* stream) {
  static bool configured = false;
  return launch<float>(topk_chunk_f32, h, w, bias, vals, idx, lse, part_v, part_c, part_m,
                       part_s, N, K, Vp, r, sub, stream, configured);
}
