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
// carries a running top-r and logsumexp from tile to tile. Here work units
// of (128-row tile, chunk of `sub` 128-column vocab tiles) run in parallel,
// each writes partial top-r lists and (max, sum-exp) per row, and a merge
// kernel combines them.
//   - bf16, `topk_wgmma`: persistent and warp-specialised, as K2
//     (blocked_lm_head.cu). One CTA of 288 threads per SM walks the units,
//     row tiles of one vocab chunk next to each other (so W is read from
//     DRAM about once); its producer warp keeps a 4-stage ring (2 at r > 16)
//     of (h, W) k-tiles of 64 in flight by TMA (128B swizzle). W is read in
//     place from its (K, Vp) layout: its tile is the MN-major B operand of
//     wgmma m64n128k16, whose descriptor transposes 16-bit B, so W needs no
//     copy. Two consumer warpgroups take 64 rows each.
//   - Its epilogue works from the accumulator registers: each thread holds 32
//     columns of each of two rows, adds the bias and keeps its own running
//     (max, sum-exp) per row (ex2.approx in the log2 domain). Its own sorted
//     top-r list per row lives in shared memory (at 288 threads ptxas holds
//     a thread to 168 registers), behind a row threshold in registers: at a
//     unit's first tile a bound from the quad's values, then the best of
//     the quad's lists' r-th entries and the least of their ceil(r/4)-th.
//     Only values that beat it go to the thread's 16 candidate slots in
//     shared memory; a warp inserts them, in registers, only when one of its
//     lanes has any. At a unit's end the quad's four lists become the row's
//     one by rank (an entry's place is the count of entries that beat it).
//   - What bounds it now (PERF.md, K6 row): not the tensor cores. Each unit
//     keeps an exact running top r of its columns, which changes ~100 times
//     a row a unit; those inserts, on 8 consumer warps with the epilogue not
//     overlapping the products, take about half of its time.
//   - f32, `topk_chunk_f32`: the CUDA cores (8x8 outputs per thread, no
//     TF32, f32 parity needs full f32 products) into a shared-memory tile,
//     folded by warps into shared-memory lists (the first design).
//   - `topk_merge`: one block per row. A row's top r lies at or above the
//     best of the partial lists' r-th entries and the r-th best of their
//     first entries; the entries that do are gathered in shared memory and
//     each is placed by its rank among them; the (max, sum-exp) partials
//     combine into the lse.
// Every comparison is on (value, column) pairs, so the result does not
// depend on the order in which units, lanes or entries are visited.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "hopper_common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int BM = 128;        // rows per block
constexpr int BN = 128;        // vocab columns per tile
constexpr int CS_LD = BN + 4;  // f32 logits tile stride
constexpr int kThreads = 256;  // the f32 chunk kernel and the merge
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

// the block's partial results: part_v/part_c (N, r, nchunks), part_m/part_s (N, nchunks)
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
    if (lane < r) {  // entry i of list l at (row, i, l)
      part_v[((long long)row * r + lane) * nchunks + chunk] = st->lv[rr][lane];
      part_c[((long long)row * r + lane) * nchunks + chunk] = st->lc[rr][lane];
    }
    if (lane == 0) {
      part_m[at] = st->m[rr];
      part_s[at] = st->s[rr];
    }
  }
}

constexpr size_t kTileBytes = (size_t)BM * CS_LD * sizeof(float);

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

// ---------------------------------------------------------------- bf16 path
constexpr int BK = 64;                        // k-values per stage: one 128B-swizzled chunk
constexpr int kConsumers = 256;               // two warpgroups
constexpr int kWgThreads = kConsumers + 32;   // and the producer warp
constexpr int kHBytes = BM * BK * 2;          // h k-tile
constexpr int kWChunk = BK * 64 * 2;          // 64 vocab columns of a W k-tile
constexpr int kStageBytes = kHBytes + 2 * kWChunk;
constexpr int kSlots = 16;                    // candidate slots a thread: 16 values at a time

// Shared memory of the RC-entry lists (r <= RC): the TMA ring, the
// candidate slots, then the lists; entry i of a thread's list for row half
// h is word (h * RC + i) * kConsumers + thread (a warp's accesses are
// consecutive words).
template <int RC>
struct Smem {
  static constexpr int STAGES = RC <= 16 ? 4 : 2;
  static constexpr int SLOTS = STAGES * kStageBytes;
  static constexpr int LISTS = SLOTS + kSlots * kConsumers * 8;
  static constexpr int BYTES = LISTS + 2 * RC * kConsumers * 8 + 1024;  // + the 1024 alignment
};

// the best (value, column) among a row's quad of lanes, in each of them
__device__ __forceinline__ void quad_best(float& v, int& c) {
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    const float ov = __shfl_xor_sync(kFull, v, o);
    const int oc = __shfl_xor_sync(kFull, c, o);
    if (beats(ov, oc, v, c)) {
      v = ov;
      c = oc;
    }
  }
}

// Insert this thread's n candidates from its slots into its sorted list of
// r entries (capacity RC) in shared memory (entries kConsumers words
// apart): the list is read into registers once, each candidate that beats
// entry r - 1 (tv, tc) takes its place there, worse entries moving down,
// and the list is written back once. Returns whether any was inserted.
template <int RC>
__device__ __forceinline__ bool insert_slots(const float* slot_v, const int* slot_c, int n,
                                             float* lv, int* lc, int r, float& tv, int& tc) {
  float v[RC];
  int cc[RC];
#pragma unroll
  for (int i = 0; i < RC; ++i)
    if (i < r) {
      v[i] = lv[i * kConsumers];
      cc[i] = lc[i * kConsumers];
    }
  bool inserted = false;
  for (int s = 0; s < n; ++s) {
    const float x = slot_v[s * kConsumers];
    const int c = slot_c[s * kConsumers];
    if (!beats(x, c, tv, tc)) continue;
    inserted = true;
    bool done = false;
#pragma unroll
    for (int i = RC - 1; i >= 0; --i) {
      if (i < r && !done) {
        if (i > 0 && beats(x, c, v[i - 1], cc[i - 1])) {
          v[i] = v[i - 1];
          cc[i] = cc[i - 1];
        } else {
          v[i] = x;
          cc[i] = c;
          done = true;
        }
      }
      if (i == r - 1) {
        tv = v[i];
        tc = cc[i];
      }
    }
  }
  if (inserted) {
#pragma unroll
    for (int i = 0; i < RC; ++i)
      if (i < r) {
        lv[i * kConsumers] = v[i];
        lc[i * kConsumers] = cc[i];
      }
  }
  return inserted;
}

// A lower bound on a row's r-th value from the quad's 32 values a lane of
// one row half: each lane's k-th largest (k = ceil(r / 4), so the quad
// holds at least r values at or above the least of the four), the least
// over the quad.
template <int RC>
__device__ __forceinline__ float quad_rth_bound(const float (&d)[64], int half, int r) {
  constexpr int KMAX = RC / 4;
  const int k = (r + 3) / 4;
  float top[KMAX];
#pragma unroll
  for (int i = 0; i < KMAX; ++i) top[i] = -INFINITY;
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float x = d[4 * j + 2 * half + e];
#pragma unroll
      for (int i = 0; i < KMAX; ++i) {  // top stays sorted, largest first
        const float hi = fmaxf(top[i], x);
        x = fminf(top[i], x);
        top[i] = hi;
      }
    }
  float kth = top[0];
#pragma unroll
  for (int i = 1; i < KMAX; ++i)
    if (i == k - 1) kth = top[i];
  kth = fminf(kth, __shfl_xor_sync(kFull, kth, 1));
  return fminf(kth, __shfl_xor_sync(kFull, kth, 2));
}

template <int RC>
__global__ void __launch_bounds__(kWgThreads, 1)
    topk_wgmma(const __grid_constant__ CUtensorMap tm_h, const __grid_constant__ CUtensorMap tm_w,
               const float* __restrict__ bias, float* __restrict__ part_v,
               int* __restrict__ part_c, float* __restrict__ part_m, float* __restrict__ part_s,
               int N, int Vp, int ksteps, int r, int sub, int mtiles, int nchunks) {
  using L = Smem<RC>;
  constexpr int STAGES = L::STAGES;
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
  const int units = mtiles * nchunks;

  if (threadIdx.x >= kConsumers) {  // the producer warp
    if (threadIdx.x == kConsumers) {
      int it = 0;
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        const int row0 = (u % mtiles) * BM, t0 = (u / mtiles) * sub;
        for (int tile = t0; tile < min(nb, t0 + sub); ++tile)
          for (int k = 0; k < ksteps; ++k, ++it) {
            const int s = it % STAGES;
            hopper::mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
            uint8_t* a = smem + s * kStageBytes;
            hopper::mbar_arrive_expect_tx(&full[s], kStageBytes);
            hopper::tma_load_2d(a, &tm_h, k * BK, row0, &full[s]);
            hopper::tma_load_2d(a + kHBytes, &tm_w, tile * BN, k * BK, &full[s]);
            hopper::tma_load_2d(a + kHBytes + kWChunk, &tm_w, tile * BN + 64, k * BK, &full[s]);
          }
      }
    }
    return;
  }

  const int tid = threadIdx.x;
  const int wg = tid / 128;  // the consumer warpgroup: rows 64 wg ..
  const int warp = (tid % 128) / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  float* slot_v = reinterpret_cast<float*>(smem + L::SLOTS) + tid;  // slot i at i * kConsumers
  int* slot_c = reinterpret_cast<int*>(slot_v - tid + kSlots * kConsumers) + tid;
  float* list_v = reinterpret_cast<float*>(smem + L::LISTS) + tid;
  int* list_c = reinterpret_cast<int*>(list_v - tid + 2 * RC * kConsumers) + tid;
  int it = 0;
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const int row0 = (u % mtiles) * BM, chunk = u / mtiles, t0 = chunk * sub;
    // this thread's two rows (g, g + 8 of its warp's 16): running max and
    // sum-exp over its own columns; its own list (entry r - 1: tv, tc) and
    // the row's threshold (rv, rc), below which no value can be in the
    // row's top r
    float tv[2], rv[2], m[2], se[2];
    int tc[2], rc[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      for (int i = 0; i < r; ++i) {
        list_v[(half * RC + i) * kConsumers] = -INFINITY;
        list_c[(half * RC + i) * kConsumers] = INT_MAX;
      }
      tv[half] = rv[half] = m[half] = -INFINITY;
      tc[half] = rc[half] = INT_MAX;
      se[half] = 0.f;
    }
    for (int tile = t0; tile < min(nb, t0 + sub); ++tile) {
      const int col0 = tile * BN;
      float d[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) d[i] = 0.f;
      // one k-step's products stay in flight while the next one's are
      // issued; a stage is released once the products that read it are done
      for (int k = 0; k < ksteps; ++k, ++it) {
        const int s = it % STAGES;
        hopper::mbar_wait(&full[s], (it / STAGES) & 1);
        const uint32_t a = hopper::smem_u32(smem + s * kStageBytes);
        const uint32_t b = a + kHBytes;
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          hopper::wgmma_ss_n128_mn(d, hopper::desc_k<64>(a, BM, 64 * wg, kk),
                                   hopper::desc_mn<128>(b, BK, kk), 1);
        hopper::wgmma_commit();
        hopper::wgmma_wait_one();
        if (k > 0) hopper::mbar_arrive(&empty[(it + STAGES - 1) % STAGES]);
      }
      hopper::wgmma_wait_all();
      hopper::fence_operand(d);
      hopper::mbar_arrive(&empty[(it + STAGES - 1) % STAGES]);
      // epilogue from the registers: row 16 warp + g (+ 8) of the
      // warpgroup's 64, columns 8 j + 2 t4 (+ 1)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float mt = -INFINITY;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const float2 bj = *reinterpret_cast<const float2*>(bias + col0 + 8 * j + 2 * t4);
          d[4 * j + 2 * half] += bj.x;
          d[4 * j + 2 * half + 1] += bj.y;
          mt = fmaxf(mt, fmaxf(d[4 * j + 2 * half], d[4 * j + 2 * half + 1]));
        }
        // (x - max) before the scale, so a tile of -1e30 pad columns sums
        // exp2(0), not the rounding error of -1e30 * log2(e)
        const float mn = fmaxf(m[half], mt);
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            sum += hopper::fast_exp2((d[4 * j + 2 * half + e] - mn) * hopper::kLog2e);
        se[half] = se[half] * hopper::fast_exp2((m[half] - mn) * hopper::kLog2e) + sum;
        m[half] = mn;
        if (tile == t0) {  // start the row's threshold at a bound from this tile
          const float bound = quad_rth_bound<RC>(d, half, r);
          if (beats(bound, INT_MAX, rv[half], rc[half])) {
            rv[half] = bound;
            rc[half] = INT_MAX;
          }
        }
        // values that beat the row's threshold go to this thread's slots, 16
        // at a time; a warp inserts them only when one of its lanes has any
#pragma unroll
        for (int grp = 0; grp < 32 / kSlots; ++grp) {
          int n = 0;
#pragma unroll
          for (int q = 0; q < kSlots; ++q) {
            const int j = (grp * kSlots + q) / 2, e = q % 2;
            const float x = d[4 * j + 2 * half + e];
            const int c = col0 + 8 * j + 2 * t4 + e;
            if (beats(x, c, rv[half], rc[half])) {
              slot_v[n * kConsumers] = x;
              slot_c[n * kConsumers] = c;
              ++n;
            }
          }
          bool inserted = false;
          if (n > 0)
            inserted = insert_slots<RC>(slot_v, slot_c, n, list_v + half * RC * kConsumers,
                                        list_c + half * RC * kConsumers, r, tv[half], tc[half]);
          if (__any_sync(kFull, inserted)) {
            const float* lv = list_v + half * RC * kConsumers;
            // two bounds on the row's r-th value from the quad's lists: the
            // best of their r-th entries, and the least of their
            // ceil(r / 4)-th (four lanes hold r values at or above it)
            float bv = tv[half];
            int bc = tc[half];
            quad_best(bv, bc);
            float kth = lv[((r + 3) / 4 - 1) * kConsumers];
            kth = fminf(kth, __shfl_xor_sync(kFull, kth, 1));
            kth = fminf(kth, __shfl_xor_sync(kFull, kth, 2));
            if (beats(kth, INT_MAX, bv, bc)) {
              bv = kth;
              bc = INT_MAX;
            }
            if (beats(bv, bc, rv[half], rc[half])) {
              rv[half] = bv;
              rc[half] = bc;
            }
          }
        }
      }
    }
    // the unit's partials: the row's top r from its quad's four lists (an
    // entry's place is the count of the four lists' entries that beat it;
    // the row's top r are all in them), and the quad's (max, sum-exp)
    __syncwarp();
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = row0 + 64 * wg + 16 * warp + g + 8 * half;
      const float mq = hopper::quad_max(m[half]);
      const float sq =
          hopper::quad_sum(se[half] * hopper::fast_exp2((m[half] - mq) * hopper::kLog2e));
      if (row < N) {
        const float* lv = list_v + half * RC * kConsumers;
        const int* lc = list_c + half * RC * kConsumers;
        for (int i = 0; i < r; ++i) {
          const float x = lv[i * kConsumers];
          const int c = lc[i * kConsumers];
          int place = i;
          for (int o = 1; o < 4; ++o) {
            const float* ov = lv + ((tid ^ o) - tid);
            const int* oc = lc + ((tid ^ o) - tid);
            for (int j = 0; j < r; ++j) place += beats(ov[j * kConsumers], oc[j * kConsumers], x, c);
          }
          if (place < r) {  // entry i of list l at (row, i, l)
            part_v[((long long)row * r + place) * nchunks + chunk] = x;
            part_c[((long long)row * r + place) * nchunks + chunk] = c;
          }
        }
        if (t4 == 0) {
          part_m[(long long)row * nchunks + chunk] = mq;
          part_s[(long long)row * nchunks + chunk] = sq;
        }
      }
    }
    __syncwarp();  // the lists are read before the next unit resets them
  }
}

// ------------------------------------------------------------------- merge

// (v, c) of the block that beats all others, in every thread
__device__ void block_best(float& v, int& c, float* sv, int* sc) {
  warp_best(v, c);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();
  if (lane == 0) {
    sv[warp] = v;
    sc[warp] = c;
  }
  __syncthreads();
  v = lane < kThreads / 32 ? sv[lane] : -INFINITY;
  c = lane < kThreads / 32 ? sc[lane] : INT_MAX;
  warp_best(v, c);
}

// (max, sum-exp) pairs combined; a pair with sum 0 is empty
__device__ __forceinline__ void lse_combine(float& m, float& s, float om, float os) {
  const float mm = fmaxf(m, om);
  s = (s == 0.f ? 0.f : s * expf(m - mm)) + (os == 0.f ? 0.f : os * expf(om - mm));
  m = mm;
}

// (max, sum-exp) of the block, in every thread
__device__ void block_lse(float& m, float& s, float* sv, float* ss) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    lse_combine(m, s, __shfl_xor_sync(kFull, m, o), __shfl_xor_sync(kFull, s, o));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();
  if (lane == 0) {
    sv[warp] = m;
    ss[warp] = s;
  }
  __syncthreads();
  m = lane < kThreads / 32 ? sv[lane] : -INFINITY;
  s = lane < kThreads / 32 ? ss[lane] : 0.f;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    lse_combine(m, s, __shfl_xor_sync(kFull, m, o), __shfl_xor_sync(kFull, s, o));
}

// One block per row: part_v/part_c (N, r, nlists), entry i of list l at
// (row, i, l), each list r entries, best first; part_m/part_s (N, nstats).
// A row's top r all lie at or above the best of the lists' r-th entries
// (that list alone holds r values at least as good) and at or above the
// r-th best of their first entries (r lists reach it); the entries that do
// are gathered in shared memory (nlists * r entries of room), and each one's
// place in the output is the count of gathered entries that beat it.
__global__ void __launch_bounds__(kThreads)
    topk_merge(const float* __restrict__ part_v, const int* __restrict__ part_c, int nlists,
               const float* __restrict__ part_m, const float* __restrict__ part_s, int nstats,
               float* __restrict__ vals, int* __restrict__ idx, float* __restrict__ lse, int r) {
  extern __shared__ float gathered[];  // values, then columns
  __shared__ float red_v[kThreads / 32], red_s[kThreads / 32];
  __shared__ int red_c[kThreads / 32];
  __shared__ int count;
  const int row = blockIdx.x, tid = threadIdx.x;
  const int n = nlists * r;
  int* gathered_c = reinterpret_cast<int*>(gathered + n);
  if (tid == 0) count = 0;

  float m = -INFINITY, s = 0.f;
  for (int i = tid; i < nstats; i += kThreads)
    lse_combine(m, s, part_m[(long long)row * nstats + i], part_s[(long long)row * nstats + i]);
  block_lse(m, s, red_v, red_s);

  const float* pv = part_v + (long long)row * n;
  const int* pc = part_c + (long long)row * n;
  float tv = -INFINITY;  // the best of the lists' r-th entries
  int tc = INT_MAX;
  for (int l = tid; l < nlists; l += kThreads)
    if (beats(pv[(r - 1) * nlists + l], pc[(r - 1) * nlists + l], tv, tc)) {
      tv = pv[(r - 1) * nlists + l];
      tc = pc[(r - 1) * nlists + l];
    }
  block_best(tv, tc, red_v, red_c);
  if (nlists >= r) {  // and the r-th best of the lists' first entries: r lists reach it
    __syncthreads();  // block_best's reads of red_v are done
    for (int l = tid; l < nlists; l += kThreads) {
      int place = 0;
      for (int j = 0; j < nlists; ++j) place += beats(pv[j], pc[j], pv[l], pc[l]);
      if (place == r - 1) {
        red_v[0] = pv[l];
        red_c[0] = pc[l];
      }
    }
    __syncthreads();
    if (beats(red_v[0], red_c[0], tv, tc)) {
      tv = red_v[0];
      tc = red_c[0];
    }
  }
  for (int e = tid; e < n; e += kThreads)
    if (!beats(tv, tc, pv[e], pc[e])) {
      const int at = atomicAdd(&count, 1);
      gathered[at] = pv[e];
      gathered_c[at] = pc[e];
    }
  __syncthreads();
  const int cnt = count;
  for (int i = tid; i < cnt; i += kThreads) {
    const float x = gathered[i];
    const int c = gathered_c[i];
    int place = 0;
    for (int j = 0; j < cnt; ++j) place += beats(gathered[j], gathered_c[j], x, c);
    if (place < r) {
      vals[(long long)row * r + place] = x;
      idx[(long long)row * r + place] = c;
    }
  }
  if (tid == 0) lse[row] = logf(s) + m;
}

constexpr size_t kSmemBytes = kTileBytes + sizeof(RowState);

int launch_merge(const void* part_v, const void* part_c, int nlists, const void* part_m,
                 const void* part_s, int nstats, void* vals, void* idx, void* lse, int N, int r,
                 cudaStream_t s) {
  const int bytes = nlists * r * 8;
  if (bytes > 48 * 1024) {  // more than 1536 partial entries a row
    const cudaError_t err =
        cudaFuncSetAttribute(topk_merge, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
  }
  topk_merge<<<N, kThreads, bytes, s>>>((const float*)part_v, (const int*)part_c, nlists,
                                        (const float*)part_m, (const float*)part_s, nstats,
                                        (float*)vals, (int*)idx, (float*)lse, r);
  return (int)cudaGetLastError();
}

template <int RC>
int launch_wgmma(const CUtensorMap* mh, const CUtensorMap* mw, const void* bias, void* part_v,
                 void* part_c, void* part_m, void* part_s, int N, int K, int Vp, int r, int sub,
                 cudaStream_t s) {
  static bool allowed[hopper::kMaxDevices] = {};
  const int st = hopper::allow_dynamic_smem((const void*)topk_wgmma<RC>, Smem<RC>::BYTES, allowed);
  if (st != 0) return st;
  const int mtiles = (N + BM - 1) / BM;
  const int nchunks = (Vp / BN + sub - 1) / sub;
  const int units = mtiles * nchunks;
  const int sms = hopper::sm_count();
  topk_wgmma<RC><<<units < sms ? units : sms, kWgThreads, Smem<RC>::BYTES, s>>>(
      *mh, *mw, (const float*)bias, (float*)part_v, (int*)part_c, (float*)part_m,
      (float*)part_s, N, Vp, (K + BK - 1) / BK, r, sub, mtiles, nchunks);
  return (int)cudaGetLastError();
}

}  // namespace

// h (N, K) and w (K, Vp) start 16-byte aligned with K a multiple of 8 (the
// tensor maps' rule), Vp a multiple of 128, 1 <= r <= 32. Partials:
// part_v/part_c (N, r, nchunks), part_m/part_s (N, nchunks) with
// nchunks = ceil(Vp / 128 / sub); outputs vals/idx (N, r), lse (N,).
extern "C" int vt_lm_head_topk_lse_bf16(const void* h, const void* w, const void* bias,
                                        void* vals, void* idx, void* lse, void* part_v,
                                        void* part_c, void* part_m, void* part_s, int N, int K,
                                        int Vp, int r, int sub, void* stream) {
  if (N <= 0 || K <= 0 || Vp % BN != 0 || r < 1 || r > kMaxR || sub < 1)
    return (int)cudaErrorInvalidValue;
  static hopper::MapCache cache_h, cache_w;
  const CUtensorMap *mh = nullptr, *mw = nullptr;
  int st = cache_h.get(&mh, h, N, K, BM);
  if (st == 0) st = cache_w.get(&mw, w, K, Vp, BK);
  if (st != 0) return st;
  const cudaStream_t s = (cudaStream_t)stream;
  st = r <= 16 ? launch_wgmma<16>(mh, mw, bias, part_v, part_c, part_m, part_s, N, K, Vp, r, sub, s)
               : launch_wgmma<32>(mh, mw, bias, part_v, part_c, part_m, part_s, N, K, Vp, r, sub, s);
  if (st != 0) return st;
  const int nchunks = (Vp / BN + sub - 1) / sub;
  return launch_merge(part_v, part_c, nchunks, part_m, part_s, nchunks, vals, idx, lse, N, r, s);
}

// the same with h, w float32; part_v/part_c (N, r, nchunks)
extern "C" int vt_lm_head_topk_lse_f32(const void* h, const void* w, const void* bias,
                                       void* vals, void* idx, void* lse, void* part_v,
                                       void* part_c, void* part_m, void* part_s, int N, int K,
                                       int Vp, int r, int sub, void* stream) {
  if (N <= 0 || K <= 0 || Vp % BN != 0 || r < 1 || r > kMaxR || sub < 1)
    return (int)cudaErrorInvalidValue;
  static bool configured = false;
  if (!configured) {  // above 48 KB a block's shared memory must be opted into
    const cudaError_t err = cudaFuncSetAttribute(
        topk_chunk_f32, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const int nchunks = (Vp / BN + sub - 1) / sub;
  const cudaStream_t s = (cudaStream_t)stream;
  topk_chunk_f32<<<dim3((N + BM - 1) / BM, nchunks), kThreads, kSmemBytes, s>>>(
      (const float*)h, (const float*)w, (const float*)bias, (float*)part_v, (int*)part_c,
      (float*)part_m, (float*)part_s, N, K, Vp, r, sub);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_merge(part_v, part_c, nchunks, part_m, part_s, nchunks, vals, idx, lse, N, r, s);
}
