// Reorder-free beam-decode self-attention with the in-place KV-cache write,
// written for Hopper (sm_90a).
//
// Replaces: vilmedic_tpu/ops/beam_cache_attention.py::_kernel, reached through
// `_fused_impl` / `fused_beam_cache_attention`, all four stages:
//   (a) the plain step;
//   (b) `return_stats`: the softmax max and denominator, when the stats
//       pointers are given;
//   (c) `kv_scales`: int8 caches with per-lane K/V scales;
//   (d) `prefix`: a beam-shared prefix K/V streamed through the same online
//       softmax.
// (c) and (d) exclude each other, as in the JAX package.
//
// What it computes, per (row n, head h): one decode step of attention for the
// beam living in row n. The keys are the cache entries K[t, group*rows + j]
// whose ancestry mask entry mask[group, r, t*rows + j] is 1 (t < index), plus
// the current step's own k_new/v_new as an analytic extra lane, plus in stage
// (d) the first p_real prefix keys of item n / beams. This step's K/V is then
// written into the caches at t = index.
//
// What bounds it on the H100: bytes and latency, not FLOPs. A (row, head)
// reads index * D keys and values (one ancestor per t in a beam search) and
// does 4 * index * D FLOPs. At beam 8 many rows share ancestors, so much of
// the read hits L2. Stage (c) halves (bf16) or quarters (f32) the cache bytes.
// Stage (d) adds the prefix: at the VisionLanguage decode shape (batch 16,
// P 1370, H*D 768, bf16) one layer's prefix K/V is 16*1370*768*2 B*2 = 67 MB,
// 20 us at 3.35 TB/s if read once; the bf16 design reads it once per group.
//
// Two designs, one per type of q/k_new/v_new:
//
// bf16 (the serving paths), redesigned for Hopper: the bytes are the bound,
// so each byte is read once per item-group, in wide asynchronous copies with
// many in flight, and the tensor cores make the arithmetic vanish.
//   - One CTA (4 warps) per (item-group, block of up to 16 of its rows,
//     head, split). The group's rows are the queries, the M of an mma.sync
//     m16n8k16 bf16 flow with f32 accumulators: 8 beams at one item per
//     group, padded to 16.
//   - Keys: the prefix positions of the block's items (stage d), then the
//     group's (t, slot) lanes below `index` that some row of the block names
//     (the union of its ancestry mask rows, compacted into shared memory
//     from the mask with 4-byte loads, in lane order, so every split of a
//     cluster builds the same list; each lane keeps the bits of the rows
//     that see it). Lanes with t >= index are never read.
//   - Key tiles of 64 keys stream through a 3-stage ring of shared memory by
//     cp.async (16-byte copies, zero-filled past the real keys, so a tile's
//     ragged tail is masked in the kernel); each warp takes 16 keys of a
//     tile: S = Q K^T by mma (K by ldmatrix, or int8 widened to bf16 in
//     registers, exact for -127..127), the row mask applied to the score
//     fragments, an online softmax per warp, P packed from the score
//     fragments into the A operand of P V (as in FlashAttention-2).
//   - Splits: where (group, block, head) CTAs are too few for two per SM
//     (the VisionLanguage decode: 16 groups x 12 heads, S = 2), the tiles
//     are dealt round-robin to S CTAs of one thread block cluster. Each CTA merges its
//     warps' (m, l, acc) in shared memory; the cluster's rank 0 reads the
//     others' partials through distributed shared memory, adds the current
//     step's lane, writes out (and the stats) and this step's K/V. One
//     launch per call, no scratch, no second kernel.
//
// float32 (the exactness path the card-vs-CPU beam checks run on): one
// thread block per (row, head), four warps, CUDA cores, described below.
//
// f32 design: one thread block per (row, head), four warps. Warp w walks the
// positions t = w, w + 4, ... and keeps its own online softmax (m, l, acc) in
// f32; the lanes split the head dimension (D / 32 values each) and the score
// is a warp-shuffle sum. Within a position the warp ballots the mask bytes of
// the group's slots and visits only the set ones, so masked lanes cost
// nothing; the TPU kernel's -1e9 bias gives those lanes exp(-1e9 - m) == 0 in
// f32, so skipping them gives the same numbers. Warp 0 is seeded with the
// current-step lane (m = s_cur, l = 1, acc = v_new), as the TPU kernel seeds
// its online softmax; the four warps merge through shared memory at the end.
// In stage (d) each warp first walks prefix keys p = 4w .. 4w + 3, then
// p + 16, ...: four independent dot products per iteration, one online
// softmax update for the four, then the ancestor lanes as above. Keys past
// p_real are never read: the kernel masks its own ragged tail.
//
// Stage (b): with m_out/l_out non-null, warp 0 also writes the per-(row, head)
// softmax max and denominator it holds after the merge, in the scaled-score
// domain, over every key attended. The prefix-LM decode merges them with its
// beam-shared prefix segment.
//
// Rounding points follow the TPU kernel. Stages (a), (b), (d): q * scale is
// rounded to the cache type for the cache and prefix dots; the current-step
// score uses the f32 q * scale and f32 k_new; p is rounded to the cache type
// before the PV product; l, acc and the output stay f32. Stage (c): the
// caches are int8 and q/k_new/v_new keep their own type (f32 or bf16); the
// per-lane K scale folds into the query, (q * scale)_f32 * ks rounded once to
// q's type; p is rounded to q's type; the V scale factors out of the whole
// accumulation: acc is seeded with v_new / vs and the output is
// (acc / l) * vs. This step's K/V are written as
// int8(clamp(rint(x / s), -127, 127)): rint rounds half to even, as
// jnp.round does, and the division is IEEE (no fast math in the build).
//
// Race freedom, by construction: a block reads cache positions t < index
// only, and writes position t == index only, at its own (row, head) slice.
// No block reads what another block writes in the same launch.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper_common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kKeys = 4;  // prefix keys per warp iteration (stage d)

template <typename T>
__device__ __forceinline__ float to_f(T x);
template <>
__device__ __forceinline__ float to_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <>
__device__ __forceinline__ float to_f<int8_t>(int8_t x) {
  return (float)x;
}

// float -> T -> float: the rounding a cast to dtype T makes
template <typename T>
__device__ __forceinline__ float round_to(float x);
template <>
__device__ __forceinline__ float round_to<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ int8_t quantize(float x, float s) {
  return (int8_t)fminf(fmaxf(rintf(x / s), -127.f), 127.f);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// The f32 design. Q: the type of q/k_new/v_new (float; bf16 takes
// mma_path). C: the caches' type (Q, or int8_t when QUANT). PREFIX: stage
// (d), pk/pv in type C.
template <typename Q, typename C, int D, bool QUANT, bool PREFIX>
__global__ void __launch_bounds__(32 * kWarps)
    beam_cache_attention_kernel(C* __restrict__ kc, C* __restrict__ vc,
                                const Q* __restrict__ q,
                                const Q* __restrict__ knew,
                                const Q* __restrict__ vnew,
                                const uint8_t* __restrict__ mask,
                                const float* __restrict__ kv_scales,
                                const C* __restrict__ pk, const C* __restrict__ pv,
                                float* __restrict__ out, float* __restrict__ m_out,
                                float* __restrict__ l_out, int N, int H, int T_len,
                                int rows, int index, int P, int p_real, int beams,
                                float scale) {
  constexpr int E = D / 32;  // head-dim values per lane
  const int n = blockIdx.x;
  const int h = blockIdx.y;
  const int lane = threadIdx.x;
  const int warp = threadIdx.y;
  const long long HD = (long long)H * D;
  const int group = n / rows;
  const int r = n % rows;
  const long long col = (long long)h * D + lane * E;
  const long long row_off = n * HD + col;

  float ks[E], vs[E];
  if constexpr (QUANT) {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      ks[e] = kv_scales[col + e];
      vs[e] = kv_scales[HD + col + e];
    }
  }
  float qd[E];
  float s_cur = 0.f;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const float qf = to_f(q[row_off + e]) * scale;
    s_cur += qf * to_f(knew[row_off + e]);
    if constexpr (QUANT) {
      qd[e] = round_to<Q>(qf * ks[e]);
    } else {
      qd[e] = round_to<C>(qf);
    }
  }
  s_cur = warp_sum(s_cur);

  float m, l, acc[E];
  if (warp == 0) {
    m = s_cur;
    l = 1.f;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      if constexpr (QUANT) {
        acc[e] = to_f(vnew[row_off + e]) / vs[e];
      } else {
        acc[e] = to_f(vnew[row_off + e]);
      }
    }
  } else {
    m = -INFINITY;
    l = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] = 0.f;
  }

  if constexpr (PREFIX) {
    const long long base = (long long)(n / beams) * P * HD + col;
    const C* pkr = pk + base;
    const C* pvr = pv + base;
    // p0 is the same for every lane of a warp: the shuffles stay uniform
    for (int p0 = warp * kKeys; p0 < p_real; p0 += kWarps * kKeys) {
      float s[kKeys];
#pragma unroll
      for (int i = 0; i < kKeys; ++i) {
        s[i] = 0.f;
        if (p0 + i < p_real) {
          const C* kr = pkr + (long long)(p0 + i) * HD;
#pragma unroll
          for (int e = 0; e < E; ++e) s[i] += qd[e] * to_f(kr[e]);
        }
      }
#pragma unroll
      for (int i = 0; i < kKeys; ++i) s[i] = warp_sum(s[i]);
      float m_new = m;
#pragma unroll
      for (int i = 0; i < kKeys; ++i)
        if (p0 + i < p_real) m_new = fmaxf(m_new, s[i]);
      const float alpha = expf(m - m_new);
      l *= alpha;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[e] *= alpha;
#pragma unroll
      for (int i = 0; i < kKeys; ++i) {
        if (p0 + i < p_real) {
          const float p = expf(s[i] - m_new);
          l += p;
          const float pr = round_to<Q>(p);
          const C* vr = pvr + (long long)(p0 + i) * HD;
#pragma unroll
          for (int e = 0; e < E; ++e) acc[e] += pr * to_f(vr[e]);
        }
      }
      m = m_new;
    }
  }

  const uint8_t* mrow = mask + ((long long)group * rows + r) * ((long long)T_len * rows);
  for (int t = warp; t < index; t += kWarps) {
    for (int j0 = 0; j0 < rows; j0 += 32) {
      const int j = j0 + lane;
      const bool live = j < rows && mrow[(long long)t * rows + j] != 0;
      unsigned bits = __ballot_sync(0xffffffffu, live);
      while (bits) {
        const int jj = j0 + __ffs(bits) - 1;
        bits &= bits - 1;
        const long long off = ((long long)t * N + (long long)group * rows + jj) * HD + col;
        float s = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) s += qd[e] * to_f(kc[off + e]);
        s = warp_sum(s);
        const float m_new = fmaxf(m, s);
        const float alpha = expf(m - m_new);
        const float p = expf(s - m_new);
        l = l * alpha + p;
        const float pr = round_to<Q>(p);
#pragma unroll
        for (int e = 0; e < E; ++e) acc[e] = acc[e] * alpha + pr * to_f(vc[off + e]);
        m = m_new;
      }
    }
  }

  __shared__ float sm_m[kWarps];
  __shared__ float sm_l[kWarps];
  __shared__ float sm_acc[kWarps][D];
  if (lane == 0) {
    sm_m[warp] = m;
    sm_l[warp] = l;
  }
#pragma unroll
  for (int e = 0; e < E; ++e) sm_acc[warp][lane * E + e] = acc[e];
  __syncthreads();

  if (warp == 0) {
    float mx = sm_m[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w]);
    float lsum = 0.f, o[E];
#pragma unroll
    for (int e = 0; e < E; ++e) o[e] = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(sm_m[w] - mx);  // exp(-inf) == 0 for an idle warp
      lsum += sm_l[w] * c;
#pragma unroll
      for (int e = 0; e < E; ++e) o[e] += sm_acc[w][lane * E + e] * c;
    }
#pragma unroll
    for (int e = 0; e < E; ++e) {
      if constexpr (QUANT) {
        out[row_off + e] = o[e] / lsum * vs[e];
      } else {
        out[row_off + e] = o[e] / lsum;
      }
    }
    if (m_out != nullptr && lane == 0) {
      m_out[(long long)n * H + h] = mx;
      l_out[(long long)n * H + h] = lsum;
    }

    // this step's K/V into the caches at t == index (never read above)
    const long long woff = ((long long)index * N + n) * HD + col;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      if constexpr (QUANT) {
        kc[woff + e] = quantize(to_f(knew[row_off + e]), ks[e]);
        vc[woff + e] = quantize(to_f(vnew[row_off + e]), vs[e]);
      } else {
        kc[woff + e] = knew[row_off + e];
        vc[woff + e] = vnew[row_off + e];
      }
    }
  }
}


// ------------------------------------------------------- bf16: Hopper design

namespace mma_path {

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;

constexpr int KT = 64;        // keys per tile
constexpr int WK = 16;        // keys per warp and tile
constexpr int kThreads = 128; // 4 warps
constexpr int STAGES = 3;     // ring depth
constexpr int RB = 16;        // rows per CTA: one m16 tile
constexpr int kMaxSplit = 8;  // the portable cluster size
constexpr int kMaxSmem = 200 * 1024;  // dynamic shared memory; the static rest fits beside it

// shared-memory layout of a tile: KT key rows of D values in type C, each
// row padded by 16 bytes (16-byte aligned for cp.async and ldmatrix, and the
// rows of an 8x8 ldmatrix fall in distinct banks)
template <typename C, int D>
struct Layout {
  static constexpr int ROW = D * (int)sizeof(C) + 16;  // bytes per key row
  static constexpr int CH = D * (int)sizeof(C) / 16;   // 16-byte chunks per key row
  static constexpr int TILE = KT * ROW;                // a K (or V) tile
  static constexpr int STAGE = 2 * TILE;
  static constexpr int RING = STAGES * STAGE;
  // after the loop the ring holds the warps' partials, then the CTA's
  static constexpr int WARP_PART = 4 * RB * (D + 2) * 4;
  static constexpr int PART = RB * (D + 2) * 4;
  static_assert(WARP_PART + PART <= RING, "partials fit in the ring");
};

struct Params {
  void *kc, *vc;
  const bf16 *q, *knew, *vnew;
  const uint8_t* mask;
  const float* kv_scales;
  const void *pk, *pv;
  float *out, *m_out, *l_out;
  int N, H, T_len, rows, index, P, p_real, beams, row_blocks, lane_cap, mask_words;
  float scale;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(hopper::smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d (m16n8, f32) += a (m16k16 bf16, row) * b (k16n8 bf16, col)
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two int8 values (lo first) widened to a bf16 pair: exact for -128..127
__device__ __forceinline__ uint32_t widen2(int lo, int hi) {
  return hopper::pack_bf16x2((float)lo, (float)hi);
}

// The B operands of S = Q K^T for the 16 keys from `key0` of a K tile at
// the k-step kk: b[0], b[1] for keys key0..+7, b[2], b[3] for key0+8..+15.
template <typename C, int D>
__device__ __forceinline__ void k_frag(uint32_t (&b)[4], const uint8_t* tile, int key0, int kk,
                                       int lane) {
  using L = Layout<C, D>;
  if constexpr (sizeof(C) == 2) {
    const int mi = lane / 8;
    const uint8_t* at = tile + (key0 + (mi / 2) * 8 + lane % 8) * L::ROW + (kk * 16 + (mi % 2) * 8) * 2;
    ldsm_x4(b, hopper::smem_u32(at));
  } else {
    const int g = lane / 4, t4 = lane % 4;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int8_t* row = reinterpret_cast<const int8_t*>(tile + (key0 + half * 8 + g) * L::ROW);
      const int d0 = kk * 16 + 2 * t4;
      b[2 * half] = widen2(row[d0], row[d0 + 1]);
      b[2 * half + 1] = widen2(row[d0 + 8], row[d0 + 9]);
    }
  }
}

// The B operands of P V for the 16 keys from `key0` of a V tile and the
// head-dim columns 16 c .. 16 c + 15: b[0], b[1] for columns 16c..+7, b[2],
// b[3] for 16c+8..+15.
template <typename C, int D>
__device__ __forceinline__ void v_frag(uint32_t (&b)[4], const uint8_t* tile, int key0, int c,
                                       int lane) {
  using L = Layout<C, D>;
  if constexpr (sizeof(C) == 2) {
    const int mi = lane / 8;
    const uint8_t* at = tile + (key0 + (mi % 2) * 8 + lane % 8) * L::ROW + (c * 16 + (mi / 2) * 8) * 2;
    ldsm_x4_t(b, hopper::smem_u32(at));
  } else {
    const int g = lane / 4, t4 = lane % 4;
    const int8_t* base = reinterpret_cast<const int8_t*>(tile);
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int col = c * 16 + nt * 8 + g;
#pragma unroll
      for (int kh = 0; kh < 2; ++kh) {
        const int k0 = key0 + kh * 8 + 2 * t4;
        b[2 * nt + kh] = widen2(base[k0 * L::ROW + col], base[(k0 + 1) * L::ROW + col]);
      }
    }
  }
}

// C: the caches' (and prefix's) type, bf16 or int8 (QUANT). PREFIX: stage (d).
template <typename C, int D, bool QUANT, bool PREFIX>
__global__ void __launch_bounds__(kThreads) beam_attention_mma_kernel(const Params p) {
  using L = Layout<C, D>;
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* ring = smem;
  int* lane_row = reinterpret_cast<int*>(smem + L::RING);       // cache row t * N + n
  uint16_t* lane_bits = reinterpret_cast<uint16_t*>(lane_row + p.lane_cap);  // rows that see it

  const int split = blockIdx.x;
  const int S = gridDim.x;
  const int g = blockIdx.y / p.row_blocks;
  const int r0 = (blockIdx.y % p.row_blocks) * RB;  // first row of the block in the group
  const int nr = min(RB, p.rows - r0);
  const int n0 = g * p.rows + r0;  // its first global row
  const int h = blockIdx.z;
  const long long HD = (long long)p.H * D;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gq = lane / 4, t4 = lane % 4;  // fragment row, column pair
  const C* kc = static_cast<const C*>(p.kc);
  const C* vc = static_cast<const C*>(p.vc);

  // ---- the union of the block's mask rows below `index`, compacted in
  // lane order: thread tid takes lanes 4 tid .. 4 tid + 3 of each round of
  // 4 * kThreads; a block-wide scan of the threads' counts places them
  __shared__ int s_warp[kThreads / 32];
  int nl = 0;
  const int total = p.index * p.rows;
  const long long mstride = (long long)p.T_len * p.rows;
  const uint8_t* mrow = p.mask + (long long)(g * p.rows + r0) * mstride;
  for (int base = 0; base < total; base += 4 * kThreads) {
    const int i0 = base + 4 * tid;
    uint32_t bits[4] = {0u, 0u, 0u, 0u};
    if (i0 < total) {
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        if (r < nr) {
          const uint8_t* m = mrow + r * mstride + i0;
          uint32_t w;
          if (p.mask_words) {
            w = *reinterpret_cast<const uint32_t*>(m);
          } else {
            w = 0u;
#pragma unroll
            for (int u = 0; u < 4; ++u)
              if (i0 + u < total) w |= (uint32_t)m[u] << (8 * u);
          }
#pragma unroll
          for (int u = 0; u < 4; ++u)
            if ((w >> (8 * u)) & 0xFFu) bits[u] |= 1u << r;
        }
      }
    }
    int mine = 0;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (i0 + u >= total) bits[u] = 0u;
      mine += bits[u] != 0u;
    }
    int incl = mine;  // inclusive scan over the warp
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += v;
    }
    if (lane == 31) s_warp[warp] = incl;
    __syncthreads();
    int at = nl + incl - mine, round = 0;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) {
      at += w < warp ? s_warp[w] : 0;
      round += s_warp[w];
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (bits[u]) {
        const int i = i0 + u, t = i / p.rows, j = i % p.rows;
        lane_row[at] = t * p.N + g * p.rows + j;
        lane_bits[at] = (uint16_t)bits[u];
        ++at;
      }
    }
    nl += round;
    __syncthreads();  // s_warp is rewritten by the next round
  }

  // ---- the key tiles: the prefix of each item of the block, then the lanes
  int item_lo = 0, tpi = 0, n_pre = 0;
  if constexpr (PREFIX) {
    item_lo = n0 / p.beams;
    const int item_hi = (n0 + nr - 1) / p.beams;
    tpi = (p.p_real + KT - 1) / KT;
    n_pre = (item_hi - item_lo + 1) * tpi;
  }
  const int n_tiles = n_pre + (nl + KT - 1) / KT;
  const int my_n = n_tiles > split ? (n_tiles - split + S - 1) / S : 0;

  auto load_tile = [&](int tile, int stage) {
    uint8_t* kd = ring + stage * L::STAGE;
    uint8_t* vd = kd + L::TILE;
    for (int e = tid; e < KT * L::CH; e += kThreads) {
      const int key = e / L::CH, c = e % L::CH;
      const C *ks, *vs;
      bool valid;
      if (PREFIX && tile < n_pre) {
        const int pos = (tile % tpi) * KT + key;
        valid = pos < p.p_real;
        const long long off =
            ((long long)(item_lo + tile / tpi) * p.P + (valid ? pos : 0)) * HD + (long long)h * D;
        ks = static_cast<const C*>(p.pk) + off;
        vs = static_cast<const C*>(p.pv) + off;
      } else {
        const int li = (tile - n_pre) * KT + key;
        valid = li < nl;
        const long long off = (long long)lane_row[valid ? li : 0] * HD + (long long)h * D;
        ks = kc + off;
        vs = vc + off;
      }
      cp_async16(kd + key * L::ROW + c * 16, reinterpret_cast<const uint8_t*>(ks) + c * 16, valid);
      cp_async16(vd + key * L::ROW + c * 16, reinterpret_cast<const uint8_t*>(vs) + c * 16, valid);
    }
  };

  // the rows of the block (bits) that see key `kl` of tile `tile`
  auto visible = [&](int tile, int kl) -> uint32_t {
    if (PREFIX && tile < n_pre) {
      const int item = item_lo + tile / tpi;
      if ((tile % tpi) * KT + kl >= p.p_real) return 0u;
      const int lo = max(item * p.beams - n0, 0), hi = min((item + 1) * p.beams - n0, nr);
      return ((1u << hi) - 1u) & ~((1u << lo) - 1u);
    }
    const int li = (tile - n_pre) * KT + kl;
    return li < nl ? (uint32_t)lane_bits[li] : 0u;
  };

  // prologue: the first STAGES - 1 tiles in flight while the queries load
  for (int k = 0; k < STAGES - 1; ++k) {
    if (k < my_n) load_tile(split + S * k, k);
    cp_async_commit();
  }

  // ---- the queries as mma A operands, rounded as the TPU kernel rounds them
  uint32_t qa[D / 16][4];
  {
    const int rows2[2] = {gq, gq + 8};
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = rows2[i % 2];
        const int d = kk * 16 + 2 * t4 + (i / 2) * 8;
        float x[2] = {0.f, 0.f};
        if (r < nr) {
          const long long off = (long long)(n0 + r) * HD + (long long)h * D + d;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float qf = __bfloat162float(p.q[off + e]) * p.scale;
            x[e] = QUANT ? qf * p.kv_scales[(long long)h * D + d + e] : qf;
          }
        }
        qa[kk][i] = hopper::pack_bf16x2(x[0], x[1]);  // round to bf16 once
      }
    }
  }

  // ---- the ring: each warp's online softmax over its 16 keys of each tile
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
  const int key0 = warp * WK;

  for (int k = 0; k < my_n; ++k) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (k + STAGES - 1 < my_n) load_tile(split + S * (k + STAGES - 1), (k + STAGES - 1) % STAGES);
    cp_async_commit();

    const int tile = split + S * k;
    const uint8_t* kt = ring + (k % STAGES) * L::STAGE;
    const uint8_t* vt = kt + L::TILE;
    float s[2][4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[nt][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t b[4];
      k_frag<C, D>(b, kt, key0, kk, lane);
      mma16816(s[0], qa[kk], b[0], b[1]);
      mma16816(s[1], qa[kk], b[2], b[3]);
    }
    // s[nt][2 * half + e]: row gq + 8 half, key key0 + 8 nt + 2 t4 + e
    uint32_t vis[2][2];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) vis[nt][e] = visible(tile, key0 + nt * 8 + 2 * t4 + e);
    float pr[2][4];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = gq + 8 * half;
      float mt = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[nt][2 * half + e];
          x = (vis[nt][e] >> r) & 1u ? x : -INFINITY;
          mt = fmaxf(mt, x);
        }
      const float mnew = fmaxf(m[half], hopper::quad_max(mt));
      const float ms = mnew == -INFINITY ? 0.f : mnew;  // no key seen yet: p = 0
      const float alpha = hopper::fast_exp2((m[half] - ms) * hopper::kLog2e);
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float x = hopper::fast_exp2((s[nt][2 * half + e] - ms) * hopper::kLog2e);
          pr[nt][2 * half + e] = x;
          sum += x;
        }
      l[half] = l[half] * alpha + sum;  // this thread's share; the quad sums at the end
      m[half] = mnew;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        acc[j][2 * half] *= alpha;
        acc[j][2 * half + 1] *= alpha;
      }
    }
    // P (rounded to bf16) as the A operand of P V: keys 2 t4.. of each n8 tile
    uint32_t pa[4];
    pa[0] = hopper::pack_bf16x2(pr[0][0], pr[0][1]);
    pa[1] = hopper::pack_bf16x2(pr[0][2], pr[0][3]);
    pa[2] = hopper::pack_bf16x2(pr[1][0], pr[1][1]);
    pa[3] = hopper::pack_bf16x2(pr[1][2], pr[1][3]);
#pragma unroll
    for (int c = 0; c < D / 16; ++c) {
      uint32_t b[4];
      v_frag<C, D>(b, vt, key0, c, lane);
      mma16816(acc[2 * c], pa, b[0], b[1]);
      mma16816(acc[2 * c + 1], pa, b[2], b[3]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: it holds the partials from here

  // ---- the warps' partials, then the CTA's
  float* wm = reinterpret_cast<float*>(ring);  // [4][RB]
  float* wl = wm + 4 * RB;                     // [4][RB]
  float* wacc = wl + 4 * RB;                   // [4][RB][D]
  float* pm = reinterpret_cast<float*>(ring + L::WARP_PART);  // [RB]
  float* pl = pm + RB;                                         // [RB]
  float* pacc = pl + RB;                                       // [RB][D]
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = gq + 8 * half;
    const float lq = hopper::quad_sum(l[half]);
    if (t4 == 0) {
      wm[warp * RB + r] = m[half];
      wl[warp * RB + r] = lq;
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      float* at = wacc + (warp * RB + r) * D + j * 8 + 2 * t4;
      at[0] = acc[j][2 * half];
      at[1] = acc[j][2 * half + 1];
    }
  }
  __syncthreads();
  constexpr int PER = D / 8;  // columns per thread: 8 threads per row
  const int row = tid / 8, c0 = (tid % 8) * PER;
  {
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < 4; ++w) mx = fmaxf(mx, wm[w * RB + row]);
    float coef[4], lsum = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const float mw = wm[w * RB + row];
      coef[w] = mw == -INFINITY ? 0.f : expf(mw - mx);
      lsum += coef[w] * wl[w * RB + row];
    }
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      float o = 0.f;
#pragma unroll
      for (int w = 0; w < 4; ++w) o += coef[w] * wacc[(w * RB + row) * D + c0 + i];
      pacc[row * D + c0 + i] = o;
    }
    if (tid % 8 == 0) {
      pm[row] = mx;
      pl[row] = lsum;
    }
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every split's partial is written

  // the current step's lane: f32 q * scale against f32 k_new (every thread
  // takes part in the row's shuffles; rows past nr sum zeros)
  const bool live_row = row < nr;
  const int n = n0 + (live_row ? row : 0);
  const long long qoff = (long long)n * HD + (long long)h * D + c0;
  float sc = 0.f;
#pragma unroll
  for (int i = 0; i < PER; ++i)
    if (live_row)
      sc += __bfloat162float(p.q[qoff + i]) * p.scale * __bfloat162float(p.knew[qoff + i]);
  sc += __shfl_xor_sync(0xffffffffu, sc, 1);
  sc += __shfl_xor_sync(0xffffffffu, sc, 2);
  sc += __shfl_xor_sync(0xffffffffu, sc, 4);

  if (split == 0 && live_row) {
    float vn[PER], ks[PER], vsc[PER];
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      vn[i] = __bfloat162float(p.vnew[qoff + i]);
      if constexpr (QUANT) {
        ks[i] = p.kv_scales[(long long)h * D + c0 + i];
        vsc[i] = p.kv_scales[HD + (long long)h * D + c0 + i];
        vn[i] = vn[i] / vsc[i];
      }
    }
    float mx = sc;
    for (int r = 0; r < S; ++r) mx = fmaxf(mx, cluster.map_shared_rank(pm, r)[row]);
    const float cc = expf(sc - mx);
    float lsum = cc, o[PER];
#pragma unroll
    for (int i = 0; i < PER; ++i) o[i] = cc * vn[i];
    for (int r = 0; r < S; ++r) {
      const float mr = cluster.map_shared_rank(pm, r)[row];
      if (mr == -INFINITY) continue;
      const float cf = expf(mr - mx);
      lsum += cf * cluster.map_shared_rank(pl, r)[row];
      const float* ar = cluster.map_shared_rank(pacc, r) + row * D + c0;
#pragma unroll
      for (int i = 0; i < PER; ++i) o[i] += cf * ar[i];
    }
#pragma unroll
    for (int i = 0; i < PER; ++i) p.out[qoff + i] = QUANT ? o[i] / lsum * vsc[i] : o[i] / lsum;
    if (p.m_out != nullptr && tid % 8 == 0) {
      p.m_out[(long long)n * p.H + h] = mx;
      p.l_out[(long long)n * p.H + h] = lsum;
    }
    // this step's K/V into the caches at t == index (never read above)
    const long long woff = ((long long)p.index * p.N + n) * HD + (long long)h * D + c0;
    C* kw = static_cast<C*>(p.kc) + woff;
    C* vw = static_cast<C*>(p.vc) + woff;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      if constexpr (QUANT) {
        kw[i] = quantize(__bfloat162float(p.knew[qoff + i]), ks[i]);
        vw[i] = quantize(__bfloat162float(p.vnew[qoff + i]), vsc[i]);
      } else {
        kw[i] = p.knew[qoff + i];
        vw[i] = p.vnew[qoff + i];
      }
    }
  }
  cluster.sync();  // the other splits' shared memory outlives rank 0's reads
}

template <typename C, int D, bool QUANT, bool PREFIX>
int run(const Params& prm, int groups, cudaStream_t stream) {
  using L = Layout<C, D>;
  auto kernel = beam_attention_mma_kernel<C, D, QUANT, PREFIX>;
  static bool allowed[hopper::kMaxDevices] = {};
  const int st = hopper::allow_dynamic_smem((const void*)kernel, kMaxSmem, allowed);
  if (st != 0) return st;
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  const size_t smem = L::RING + (size_t)prm.lane_cap * 6;
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  // splits: about two CTAs per SM, and at least 4 of the tiles there can be
  // for each (the VisionLanguage batch's 192 CTAs take S = 2 once a call
  // has 8 tiles to walk); on the H100, S of 3 to 8 timed slower at every
  // stage: the cluster merge costs more than the shorter walks gain
  const int ctas = groups * prm.row_blocks * prm.H;
  const int max_tiles = (PREFIX ? ((RB + prm.beams - 1) / prm.beams + 1) * ((prm.p_real + KT - 1) / KT)
                                : 0) + (prm.lane_cap + KT - 1) / KT;
  int S = (2 * sms + ctas - 1) / ctas;
  S = max(1, min(S, min(kMaxSplit, max_tiles / 4)));
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(S, groups * prm.row_blocks, prm.H);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, kernel, prm);
}

template <int D>
int run_stage(const Params& prm, int groups, cudaStream_t stream) {
  if (prm.kv_scales != nullptr) return run<int8_t, D, true, false>(prm, groups, stream);
  if (prm.pk != nullptr) return run<bf16, D, false, true>(prm, groups, stream);
  return run<bf16, D, false, false>(prm, groups, stream);
}

}  // namespace mma_path

struct Args {
  void *kc, *vc;
  const void *q, *knew, *vnew, *mask, *kv_scales, *pk, *pv;
  void *out, *m_out, *l_out;
  int N, H, T_len, rows, index, P, p_real, beams;
  float scale;
  cudaStream_t stream;
};

template <typename Q, typename C, int D, bool QUANT, bool PREFIX>
void run(const Args& a) {
  beam_cache_attention_kernel<Q, C, D, QUANT, PREFIX>
      <<<dim3(a.N, a.H), dim3(32, kWarps), 0, a.stream>>>(
          (C*)a.kc, (C*)a.vc, (const Q*)a.q, (const Q*)a.knew, (const Q*)a.vnew,
          (const uint8_t*)a.mask, (const float*)a.kv_scales, (const C*)a.pk,
          (const C*)a.pv, (float*)a.out, (float*)a.m_out, (float*)a.l_out, a.N, a.H,
          a.T_len, a.rows, a.index, a.P, a.p_real, a.beams, a.scale);
}

template <typename Q, int D>
void run_stage(const Args& a) {
  if (a.kv_scales != nullptr) {
    run<Q, int8_t, D, true, false>(a);
  } else if (a.pk != nullptr) {
    run<Q, Q, D, false, true>(a);
  } else {
    run<Q, Q, D, false, false>(a);
  }
}

// the bf16 design: rows in blocks of 16, the mask's union compacted per
// block in shared memory (lane ids below 2^31)
int launch_mma(const Args& a, int D) {
  if ((long long)a.T_len * a.N >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  mma_path::Params p{a.kc, a.vc, (const __nv_bfloat16*)a.q, (const __nv_bfloat16*)a.knew,
                     (const __nv_bfloat16*)a.vnew, (const uint8_t*)a.mask,
                     (const float*)a.kv_scales, a.pk, a.pv, (float*)a.out, (float*)a.m_out,
                     (float*)a.l_out, a.N, a.H, a.T_len, a.rows, a.index, a.P, a.p_real,
                     a.beams, 0, 0, 0, a.scale};
  p.row_blocks = (a.rows + mma_path::RB - 1) / mma_path::RB;
  p.lane_cap = ((a.index * a.rows + 7) / 8) * 8;
  p.mask_words = a.rows % 4 == 0 && reinterpret_cast<uintptr_t>(a.mask) % 4 == 0;
  const int groups = a.N / a.rows;
  int st;
  switch (D) {
    case 32:
      st = mma_path::run_stage<32>(p, groups, a.stream);
      break;
    case 64:
      st = mma_path::run_stage<64>(p, groups, a.stream);
      break;
    case 128:
      st = mma_path::run_stage<128>(p, groups, a.stream);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (st != 0) return st;
  return (int)cudaGetLastError();
}

template <typename Q>
int launch(const Args& a, int D) {
  if (a.kv_scales != nullptr && a.pk != nullptr) return (int)cudaErrorInvalidValue;
  if (a.pk != nullptr && (a.beams <= 0 || a.p_real <= 0 || a.p_real > a.P))
    return (int)cudaErrorInvalidValue;
  if constexpr (sizeof(Q) == 2) {
    return launch_mma(a, D);
  } else {
    switch (D) {
      case 32:
        run_stage<Q, 32>(a);
        break;
      case 64:
        run_stage<Q, 64>(a);
        break;
      case 128:
        run_stage<Q, 128>(a);
        break;
      default:
        return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
  }
}

}  // namespace

// The suffix names the type of q/k_new/v_new. The caches are in that type,
// or int8 when kv_scales ((2, H*D) f32, stage c) is non-null. pk/pv: the
// (B, P, H*D) prefix in the caches' type (stage d), or both null. m_out/l_out:
// (N, H) f32 softmax stats (stage b), or both null.
#define VT_BEAM_ATTN_ENTRY(NAME, Q)                                                \
  extern "C" int NAME(void* kc, void* vc, const void* q, const void* knew,         \
                      const void* vnew, const void* mask, const void* kv_scales,   \
                      const void* pk, const void* pv, void* out, void* m_out,      \
                      void* l_out, int N, int H, int D, int T_len, int rows,       \
                      int index, int P, int p_real, int beams, float scale,        \
                      void* stream) {                                              \
    const Args a{kc,    vc,    q,      knew,  vnew,  mask,  kv_scales, pk,         \
                 pv,    out,   m_out,  l_out, N,     H,     T_len,     rows,       \
                 index, P,     p_real, beams, scale, (cudaStream_t)stream};        \
    return launch<Q>(a, D);                                                        \
  }

VT_BEAM_ATTN_ENTRY(vt_beam_cache_attention_f32, float)
VT_BEAM_ATTN_ENTRY(vt_beam_cache_attention_bf16, __nv_bfloat16)

#undef VT_BEAM_ATTN_ENTRY
