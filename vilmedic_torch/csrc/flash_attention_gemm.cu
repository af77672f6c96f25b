// Flash attention, forward and backward, at the head dims wider than the 16
// CTAs of Hopper's largest cluster split: bfloat16 above 5120 and float32
// above 1024 (bf16 from 129 to 5120 is flash_attention_wide_tc.cu, f32 from
// 129 to 1024 flash_attention_f32_split.cu). Any head dim that is a
// multiple of 64. Written for Hopper (sm_90a).
//
// Replaces, at those head dims: vilmedic_tpu/ops/flash_attention.py::_kernel
// (forward, with `with_lse`, reached through `_flash_bhtd`) and
// ::_bwd_dq_kernel / ::_bwd_dkv_kernel (through `_flash_bwd_bhtd`): JAX's v1
// path, which takes any head dim. The function, the rounding points and the
// masking are those of the plain versions (ops/flash_attention.py):
//   s = (q k^T) * scale + bias, -1e9 where causal and c > r + Tk - Tq,
//   m = max(max_c s, -1e9), p = exp(s - m), l = max(sum_c p, 1e-30),
//   out = (round_v(p) v) / l, lse = m + log l;
//   p = exp(s - lse), dS = p (dO v^T - delta), dq = scale round_k(dS) k,
//   dk = scale round_q(dS)^T q, dv = round_do(p)^T dO, dbias = sum_r dS,
// with round_x the rounding to x's dtype (the identity in f32). A causal row
// that sees no key (Tq > Tk) averages, or weighs, every key.
//
// What bounds it on the H100: the tensor cores. At these widths the scores
// (B * H * Tq * Tk f32) are smaller than the head itself: at B 2, T 1370, 3
// heads of 5184, 45 MB of f32 scores beside 85 MB of bf16 Q. Writing the
// scores to device memory once and reading them back costs about 0.03 ms at
// 3.35 TB/s, against a forward bound of 0.24 ms in bf16. So these kernels
// give up the flash property and compute attention as matrix products of
// long depth (D for the scores, the key or query axis for the outputs),
// the shape wgmma with TMA runs best at, over a score block kept in device
// memory.
//
// Design:
//   - One GEMM kernel (gemm_kernel), instantiated per product kind: a CTA of
//     384 threads owns a tile of 128 rows x BN columns of one (b, h);
//     warpgroup 0 is the producer (one thread keeps a ring of TMA loads in
//     flight: 64 bf16 or 32 f32 of depth a stage, 128-byte swizzle, every
//     operand read through a 4-D tensor map over a (B, R, H, C) tensor, so
//     Q, K, V and dO are read in place); warpgroups 1 and 2 take 64 rows
//     each by wgmma m64nNk16 (bf16) or m64nNk8 (TF32) with both operands in
//     shared memory, and an epilogue works from the accumulator registers.
//     A "dual" instantiation runs two products over the same tile (S and
//     dP in the backward).
//   - The workspace is the caller's (the wrapper allocates it with
//     torch.empty and passes its size and the chunk): the score block of a
//     chunk of query rows (forward, dq) or key rows (dk/dv) for every
//     (b, h), sized by the wrapper under a cap. Each output is written once,
//     rounded once: no sums are carried across chunks.
//   - Forward, per query chunk, three launches: (a) S = scale Q K^T + bias,
//     causal -1e9, f32 into the workspace; (b) softmax_kernel: one warp a
//     row, the row's max m from -1e9, P = exp(S - m) rounded to V's dtype,
//     l = max(sum of the unrounded p, 1e-30), lse; (c) O = P V / l. Score
//     tiles wholly past a tile's causal limit are not computed, and P V's
//     depth stops at it, except for a tile that holds a row seeing no key.
//   - dq entry, per query chunk: a dual product (S = Q K^T, dP = dO V^T)
//     whose epilogue forms p = exp(S - lse) and dS = p (dP - delta), written
//     rounded to K's dtype; then dq = scale dS K.
//   - dk/dv entry, per key chunk: a dual product over transposed tiles (S^T
//     = K Q^T, dP^T = V dO^T: rows are keys), whose epilogue writes P^T and
//     dS^T rounded, and per-tile column sums of the unrounded dS, summed in
//     a fixed order (dbias_reduce_kernel, no atomics) into dbias per head;
//     then dk = scale dS^T Q and dv = P^T dO, their depth from the first
//     query that sees the tile's keys.
//   - bf16: V, K, Q and dO are the MN-major B operand of the output
//     products, read as the flash kernels read V; the tensor cores sum the
//     whole depth, but for the forward's scores: a tensor-core sum over a
//     5184-wide head missed the lse's 1e-5 check against the plain version,
//     so there each stage's product is summed from zero and added to a
//     running f32 sum by round-to-nearest adds, as in f32.
//   - f32: every product in three TF32 passes (lo_a hi_b + hi_a lo_b +
//     hi_a hi_b; TF32 wgmma takes K-major operands only). Q, K, V, dO and
//     the transposes an output product needs (V^T, K^T, Q^T, dO^T) are split
//     into hi and lo once per call into the workspace (split_kernel,
//     split_t_kernel; the split of ops/flash_attention.py::split_tf32), and
//     the epilogues write P, dS, P^T and dS^T as hi and lo halves. Each
//     stage's product is summed from zero by the tensor core and added to
//     a running f32 sum by round-to-nearest adds, as flash_tf32.cuh does.
//   - 64-bit offsets throughout; the entries return cudaErrorInvalidValue
//     for a workspace smaller than the layout needs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "flash_common.cuh"
#include "flash_tf32.cuh"
#include "hopper_common.cuh"

namespace {

using flash::kMaskValue;

constexpr int kThreads = 384;  // producer warpgroup + 2 consumer warpgroups
constexpr int BM = 128;        // rows of a CTA's tile, 64 a consumer warpgroup
constexpr int kRowBytes = 128; // depth bytes of an operand row in a stage
constexpr int kWsAlign = 1024; // workspace regions start on multiples of this

// ------------------------------------------------------- TF32 wgmma (SS)

// D (m64nN, f32) (+)= A (m64k8 tf32, shared, K-major) * B (k8nN tf32,
// shared, K-major); scale_d 0 overwrites D
__device__ __forceinline__ void wgmma_tf32_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                                  int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_tf32_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                                   int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  wgmma_tf32_ss_n64(d, da, db, scale_d);
}

__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  wgmma_tf32_ss_n128(d, da, db, scale_d);
}

// ------------------------------------------------------------ the products

// The tensor maps of one launch: product p's A (rows of the tile, depth
// along C) and B (K-major: rows of the tile's columns, depth along C;
// MN-major: depth along the rows, the tile's columns along C), hi and lo
// halves (lo: TF32 only). Row coordinates start at a_row0 / b_row0.
struct Operands {
  CUtensorMap maps[8];  // [product][A, B][hi, lo]
  int a_row0[2], b_row0[2];
  int H;
  int k_tiles;  // depth stages, where the epilogue does not set the range
  int b_cols;   // MN-major B: its columns (a stage loads none past them)
};

template <bool TF32, int NPROD, int BN, bool MN>
struct Cfg {
  static_assert(!(TF32 && MN), "TF32 wgmma takes K-major operands only");
  static_assert(TF32 ? BN <= 128 : BN % 128 == 0, "one TF32 wgmma a tile, or bf16 n128 products");
  static_assert(BN % 64 == 0 && BN <= 256, "BN");
  static constexpr int HALVES = TF32 ? 2 : 1;
  static constexpr int BK = kRowBytes / (TF32 ? 4 : 2);  // depth elements a stage
  static constexpr int A_BYTES = BM * kRowBytes;
  static constexpr int B_BYTES = BN * kRowBytes;  // MN-major: BK rows x BN bf16, the same
  static constexpr int OP_BYTES = HALVES * (A_BYTES + B_BYTES);
  static constexpr int STAGE = NPROD * OP_BYTES;
  static constexpr int STAGES = 200 * 1024 / STAGE < 4 ? 200 * 1024 / STAGE : 4;
  static constexpr int SMEM = STAGES * STAGE + 1024;  // + the 1024-byte alignment
  static_assert(STAGES >= 2 && SMEM <= 232448, "shared memory of one CTA");
};

// rows [first, last] (absolute) of a tile under the causal limit: its
// columns (keys) from n0 on are all masked, unless a row sees no key
__device__ __forceinline__ bool past_causal_limit(int causal, int first, int last, int n0,
                                                  int off) {
  return causal && first + off >= 0 && n0 > last + off;
}

template <bool TF32, int NPROD, int BN, bool MN, class E>
__global__ void __launch_bounds__(kThreads, 1)
    gemm_kernel(const __grid_constant__ Operands ops, const __grid_constant__ typename E::Params ep) {
  using C = Cfg<TF32, NPROD, BN, MN>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hopper::align_1024(smem_raw);
  __shared__ __align__(8) uint64_t full[C::STAGES], empty[C::STAGES];
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM, bh = blockIdx.z;
  if (E::template skip<BN>(ep, m0, n0)) {
    E::skipped(ep, m0, bh);
    return;
  }
  int k_lo = 0, k_hi = ops.k_tiles;
  E::depth(ep, m0, C::BK, k_lo, k_hi);
  const int n_k = k_hi - k_lo;
  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 256);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // ---- producer warpgroup: one thread issues the loads
    hopper::setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      const int b = bh / ops.H, h = bh % ops.H;
      const int mn_chunks = MN ? min(BN / 64, (ops.b_cols - n0 + 63) / 64) : 0;
      const int bytes = NPROD * (C::HALVES * C::A_BYTES + (MN ? mn_chunks * 64 * kRowBytes
                                                              : C::HALVES * C::B_BYTES));
      for (int it = 0; it < n_k; ++it) {
        const int s = it % C::STAGES;
        hopper::mbar_wait(&empty[s], ((it / C::STAGES) & 1) ^ 1);  // the stage is free
        hopper::mbar_arrive_expect_tx(&full[s], bytes);
        const int k = (k_lo + it) * C::BK;
        uint8_t* st = smem + s * C::STAGE;
#pragma unroll
        for (int p = 0; p < NPROD; ++p) {
          uint8_t* op = st + p * C::OP_BYTES;
#pragma unroll
          for (int x = 0; x < C::HALVES; ++x)
            hopper::tma_load_4d(op + x * C::A_BYTES, &ops.maps[4 * p + x], k, h,
                                ops.a_row0[p] + m0, b, &full[s]);
          uint8_t* bt = op + C::HALVES * C::A_BYTES;
          if constexpr (MN) {
            for (int c = 0; c < mn_chunks; ++c)
              hopper::tma_load_4d(bt + c * 64 * kRowBytes, &ops.maps[4 * p + 2], n0 + 64 * c, h,
                                  ops.b_row0[p] + k, b, &full[s]);
          } else {
#pragma unroll
            for (int x = 0; x < C::HALVES; ++x)
              hopper::tma_load_4d(bt + x * C::B_BYTES, &ops.maps[4 * p + 2 + x], k, h,
                                  ops.b_row0[p] + n0, b, &full[s]);
          }
        }
      }
    }
    return;
  }

  // ---- consumer warpgroups: rows 64 cw .. of the tile
  hopper::setmaxnreg_inc<232>();
  const int cw = threadIdx.x / 128 - 1;
  const int tw = threadIdx.x % 128;
  float acc[NPROD][BN / 2];
#pragma unroll
  for (int p = 0; p < NPROD; ++p)
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[p][i] = 0.f;

  // Each stage's products into d: accumulated (the tensor cores sum the
  // whole depth), or from zero (the first k-step overwrites) when STAGED:
  // then each stage's sum is added to acc by round-to-nearest adds, which
  // the f32 route needs (three TF32 passes) and the forward's bf16 scores
  // too (a tensor-core sum over the whole of a 5184-wide head missed the
  // lse's 1e-5).
  constexpr bool STAGED = TF32 || E::kStagedSums;
  auto issue = [&](float (&d)[NPROD][BN / 2], uint32_t st, bool from_zero) {
#pragma unroll
    for (int p = 0; p < NPROD; ++p) {
      if constexpr (TF32) {
        const uint32_t ah = st + p * C::OP_BYTES, al = ah + C::A_BYTES;
        const uint32_t bh_ = al + C::A_BYTES, bl = bh_ + C::B_BYTES;
#pragma unroll
        for (int kk = 0; kk < C::BK / 8; ++kk) {
          const uint64_t dah = hopper::desc_k<64>(ah, BM, 64 * cw, kk);
          const uint64_t dal = hopper::desc_k<64>(al, BM, 64 * cw, kk);
          const uint64_t dbh = hopper::desc_k<64>(bh_, BN, 0, kk);
          const uint64_t dbl = hopper::desc_k<64>(bl, BN, 0, kk);
          wgmma_tf32_ss(d[p], dal, dbh, kk > 0 || !from_zero);
          wgmma_tf32_ss(d[p], dah, dbl, 1);
          wgmma_tf32_ss(d[p], dah, dbh, 1);
        }
      } else {
        const uint32_t a = st + p * C::OP_BYTES, bt = a + C::A_BYTES;
#pragma unroll
        for (int kk = 0; kk < C::BK / 16; ++kk) {
          const uint64_t da = hopper::desc_k<64>(a, BM, 64 * cw, kk);
          const int scale_d = kk > 0 || !from_zero;
#pragma unroll
          for (int i = 0; i < BN / 128; ++i) {
            float(&di)[64] = *reinterpret_cast<float(*)[64]>(&d[p][64 * i]);
            if constexpr (MN)
              hopper::wgmma_ss_n128_mn(di, da, hopper::desc_mn<128>(bt + i * 2 * 64 * kRowBytes,
                                                                    64, kk), scale_d);
            else
              hopper::wgmma_ss_n128(di, da, hopper::desc_k<64>(bt, BN, 128 * i, kk), scale_d);
          }
        }
      }
    }
  };

  for (int it = 0; it < n_k; ++it) {
    const int s = it % C::STAGES;
    hopper::mbar_wait(&full[s], (it / C::STAGES) & 1);
    const uint32_t st = hopper::smem_u32(smem + s * C::STAGE);
    if constexpr (!STAGED) {
      if (it == 0) {
#pragma unroll
        for (int p = 0; p < NPROD; ++p) hopper::fence_operand(acc[p]);
      }
      hopper::wgmma_fence();
      issue(acc, st, false);
      hopper::wgmma_commit();
      // this stage's products stay in flight while the next stage's are
      // issued; the previous stage is released once its products are done
      hopper::wgmma_wait_one();
      if (it > 0) hopper::mbar_arrive(&empty[(it - 1) % C::STAGES]);
    } else {
      float tmp[NPROD][BN / 2];
#pragma unroll
      for (int p = 0; p < NPROD; ++p) hopper::fence_operand(tmp[p]);
      hopper::wgmma_fence();
      issue(tmp, st, true);
      hopper::wgmma_commit();
      hopper::wgmma_wait_all();
#pragma unroll
      for (int p = 0; p < NPROD; ++p) {
        hopper::fence_operand(tmp[p]);
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) acc[p][i] = __fadd_rn(acc[p][i], tmp[p][i]);
      }
      hopper::mbar_arrive(&empty[s]);  // release the stage
    }
  }
  if constexpr (!STAGED) {
    hopper::wgmma_wait_all();
#pragma unroll
    for (int p = 0; p < NPROD; ++p) hopper::fence_operand(acc[p]);
  }
  E::template store<BN, NPROD>(ep, acc, m0 + 64 * cw, n0, bh, tw);
}

// The accumulator element 4 J + 2 hf + e of a warpgroup's m64nBN product
// sits at row 16 (tw / 32) + (tw % 32) / 4 + 8 hf of its 64 and column
// 8 J + 2 (tw % 4) + e, whatever the wgmma width that produced it.
__device__ __forceinline__ int acc_row(int tw, int hf) { return 16 * (tw / 32) + (tw % 32) / 4 + 8 * hf; }
__device__ __forceinline__ int acc_col(int tw, int J) { return 8 * J + 2 * (tw % 4); }

// s * scale + bias, -1e9 past the causal limit, with the plain version's
// two roundings
__device__ __forceinline__ float score(float acc, float scale, float bias, bool masked) {
  return masked ? kMaskValue : __fadd_rn(__fmul_rn(acc, scale), bias);
}

// x rounded to T, stored as a pair at `at` (T bf16), or as its TF32 hi and
// lo halves at `at` and `lo` (T float; lo null: x itself)
__device__ __forceinline__ void store_pair(__nv_bfloat16* at, __nv_bfloat16*, float x0, float x1) {
  *reinterpret_cast<uint32_t*>(at) = hopper::pack_bf16x2(x0, x1);
}

__device__ __forceinline__ void store_pair(float* at, float* lo, float x0, float x1) {
  if (lo == nullptr) {
    *reinterpret_cast<float2*>(at) = make_float2(x0, x1);
    return;
  }
  uint32_t h0, h1, l0, l1;
  tf32::split(x0, h0, l0);
  tf32::split(x1, h1, l1);
  *reinterpret_cast<uint2*>(at) = make_uint2(h0, h1);
  *reinterpret_cast<uint2*>(lo) = make_uint2(l0, l1);
}

// element (b, r, h, c) of a (B, R, H, C) tensor
__device__ __forceinline__ long long at4(int b, int r, int h, int c, int R, int H, int C) {
  return ((long long)b * R + r) * H * (long long)C + (long long)h * C + c;
}

// ------------------------------------------------------------- epilogues

// Forward scores: S (B, R, H, ld) f32 of the chunk's rows [0, rows),
// absolute query rows row0 + r; columns past Tk are not read.
struct FwdScores {
  static constexpr bool kStagedSums = true;
  struct Params {
    float* s;
    const float* bias;
    int Tq, Tk, ld, R, row0, rows, H, causal;
    float scale;
  };
  template <int BN>
  __device__ static bool skip(const Params& p, int m0, int n0) {
    return past_causal_limit(p.causal, p.row0 + m0, p.row0 + min(m0 + BM, p.rows) - 1, n0,
                             p.Tk - p.Tq);
  }
  __device__ static void skipped(const Params&, int, int) {}
  __device__ static void depth(const Params&, int, int, int&, int&) {}
  template <int BN, int NP>
  __device__ static void store(const Params& p, const float (&acc)[NP][BN / 2], int wr0, int n0,
                               int bh, int tw) {
    const int b = bh / p.H, h = bh % p.H, off = p.Tk - p.Tq;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = wr0 + acc_row(tw, hf);
      if (r >= p.rows) continue;
      const int ra = p.row0 + r;
      float* row = p.s + at4(b, r, h, 0, p.R, p.H, p.ld);
#pragma unroll
      for (int J = 0; J < BN / 8; ++J) {
        const int c = n0 + acc_col(tw, J);
        if (c >= p.Tk) continue;
        float x[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int cc = c + e;
          const float bias = (p.bias != nullptr && cc < p.Tk) ? p.bias[(long long)b * p.Tk + cc] : 0.f;
          x[e] = score(acc[0][4 * J + 2 * hf + e], p.scale, bias, p.causal && cc > ra + off);
        }
        *reinterpret_cast<float2*>(row + c) = make_float2(x[0], x[1]);
      }
    }
  }
};

// An output product: rows row0 + r (r < rows) of a (B, T, H, D) tensor,
// the accumulator divided by den[bh * R + r] (den non-null) or times scale.
// Its depth: over keys up to the tile's causal limit (KEYS), or over
// queries from the first that sees the tile's first key.
template <typename T>
struct Output {
  enum { KEYS = 0, QUERIES = 1 };
  static constexpr bool kStagedSums = false;
  struct Params {
    T* out;
    const float* den;
    float scale;
    int T_rows, D, R, row0, rows, H, Tq, Tk, causal, mode;
  };
  template <int BN>
  __device__ static bool skip(const Params&, int, int) { return false; }
  __device__ static void skipped(const Params&, int, int) {}
  __device__ static void depth(const Params& p, int m0, int bk, int& lo, int& hi) {
    const int off = p.Tk - p.Tq;
    const int first = p.row0 + m0, last = p.row0 + min(m0 + BM, p.rows) - 1;
    if (p.mode == KEYS) {
      int lim = p.Tk;
      if (p.causal && first + off >= 0) lim = min(p.Tk, last + off + 1);
      lo = 0;
      hi = (lim + bk - 1) / bk;
    } else {
      const int first_row = first - off;  // the first query that sees key `first`
      lo = (p.causal && p.Tk >= p.Tq && first_row > 0) ? first_row / bk : 0;
      hi = (p.Tq + bk - 1) / bk;
    }
  }
  template <int BN, int NP>
  __device__ static void store(const Params& p, const float (&acc)[NP][BN / 2], int wr0, int n0,
                               int bh, int tw) {
    const int b = bh / p.H, h = bh % p.H;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = wr0 + acc_row(tw, hf);
      if (r >= p.rows) continue;
      const float den = p.den != nullptr ? p.den[(long long)bh * p.R + r] : 0.f;
      T* row = p.out + at4(b, p.row0 + r, h, 0, p.T_rows, p.H, p.D);
#pragma unroll
      for (int J = 0; J < BN / 8; ++J) {
        const int c = n0 + acc_col(tw, J);
        if (c >= p.D) continue;
        float x[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float a = acc[0][4 * J + 2 * hf + e];
          x[e] = p.den != nullptr ? __fdiv_rn(a, den) : __fmul_rn(a, p.scale);
        }
        store_pair(row + c, (T*)nullptr, x[0], x[1]);
      }
    }
  }
};

// dq's scores (dual: S = Q K^T, dP = dO V^T): dS (B, R, H, ld) rounded to
// T (f32: hi at ds, lo at ds_lo), zero past Tk.
template <typename T>
struct DqScores {
  static constexpr bool kStagedSums = false;
  struct Params {
    T* ds;
    T* ds_lo;
    const float* bias;
    const float* lse;
    const float* delta;
    int Tq, Tk, ld, R, row0, rows, H, causal;
    float scale;
  };
  template <int BN>
  __device__ static bool skip(const Params& p, int m0, int n0) {
    return past_causal_limit(p.causal, p.row0 + m0, p.row0 + min(m0 + BM, p.rows) - 1, n0,
                             p.Tk - p.Tq);
  }
  __device__ static void skipped(const Params&, int, int) {}
  __device__ static void depth(const Params&, int, int, int&, int&) {}
  template <int BN, int NP>
  __device__ static void store(const Params& p, const float (&acc)[NP][BN / 2], int wr0, int n0,
                               int bh, int tw) {
    const int b = bh / p.H, h = bh % p.H, off = p.Tk - p.Tq;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = wr0 + acc_row(tw, hf);
      if (r >= p.rows) continue;
      const int ra = p.row0 + r;
      const float lse = p.lse[(long long)bh * p.Tq + ra];
      const float dl = p.delta[(long long)bh * p.Tq + ra];
      const long long base = at4(b, r, h, 0, p.R, p.H, p.ld);
#pragma unroll
      for (int J = 0; J < BN / 8; ++J) {
        const int c = n0 + acc_col(tw, J);
        if (c >= p.ld) continue;
        float x[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int cc = c + e;
          x[e] = 0.f;
          if (cc < p.Tk) {
            const float bias = p.bias != nullptr ? p.bias[(long long)b * p.Tk + cc] : 0.f;
            const float s = score(acc[0][4 * J + 2 * hf + e], p.scale, bias,
                                  p.causal && cc > ra + off);
            x[e] = __fmul_rn(expf(s - lse), acc[1][4 * J + 2 * hf + e] - dl);
          }
        }
        store_pair(p.ds + base + c, p.ds_lo != nullptr ? p.ds_lo + base + c : nullptr, x[0],
                   x[1]);
      }
    }
  }
};

// dk/dv's scores (dual over transposed tiles: S^T = K Q^T, dP^T = V dO^T;
// rows are keys row0 + r, columns queries): P^T and dS^T (B, R, H, ld)
// rounded to T (f32: hi and lo), zero past Tq; dbp (B * H, R, n_ct) the
// tile's sums of the unrounded dS over its columns.
template <typename T>
struct DkvScores {
  static constexpr bool kStagedSums = false;
  struct Params {
    T* pt;
    T* pt_lo;
    T* dst;
    T* dst_lo;
    float* dbp;
    const float* bias;
    const float* lse;
    const float* delta;
    int Tq, Tk, ld, R, row0, rows, H, causal, n_ct;
    float scale;
  };
  // every query of the tile's columns comes before the first that sees the
  // tile's first key (no row sees no key: Tk >= Tq)
  template <int BN>
  __device__ static bool skip(const Params& p, int m0, int n0) {
    return p.causal && p.Tk >= p.Tq && n0 + BN <= p.row0 + m0 - (p.Tk - p.Tq);
  }
  __device__ static void skipped(const Params& p, int m0, int bh) {
    for (int r = m0 + threadIdx.x; r < min(m0 + BM, p.rows); r += kThreads)
      p.dbp[((long long)bh * p.R + r) * p.n_ct + blockIdx.x] = 0.f;
  }
  __device__ static void depth(const Params&, int, int, int&, int&) {}
  template <int BN, int NP>
  __device__ static void store(const Params& p, const float (&acc)[NP][BN / 2], int wr0, int n0,
                               int bh, int tw) {
    const int b = bh / p.H, h = bh % p.H, off = p.Tk - p.Tq;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = wr0 + acc_row(tw, hf);
      const bool real = r < p.rows;
      const int ka = p.row0 + r;
      const float bias = (real && p.bias != nullptr) ? p.bias[(long long)b * p.Tk + ka] : 0.f;
      const long long base = at4(b, real ? r : 0, h, 0, p.R, p.H, p.ld);
      float dsum = 0.f;
#pragma unroll
      for (int J = 0; J < BN / 8; ++J) {
        const int c = n0 + acc_col(tw, J);
        float pv[2], dv[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int cq = c + e;
          pv[e] = dv[e] = 0.f;
          if (real && cq < p.Tq) {
            const float s = score(acc[0][4 * J + 2 * hf + e], p.scale, bias,
                                  p.causal && ka > cq + off);
            pv[e] = expf(s - p.lse[(long long)bh * p.Tq + cq]);
            dv[e] = __fmul_rn(pv[e], acc[1][4 * J + 2 * hf + e] -
                                         p.delta[(long long)bh * p.Tq + cq]);
          }
          dsum += dv[e];
        }
        if (real && c < p.ld) {
          store_pair(p.pt + base + c, p.pt_lo != nullptr ? p.pt_lo + base + c : nullptr, pv[0],
                     pv[1]);
          store_pair(p.dst + base + c, p.dst_lo != nullptr ? p.dst_lo + base + c : nullptr, dv[0],
                     dv[1]);
        }
      }
      dsum = hopper::quad_sum(dsum);
      if (real && tw % 4 == 0) p.dbp[((long long)bh * p.R + r) * p.n_ct + blockIdx.x] = dsum;
    }
  }
};

// ------------------------------------------------------ elementwise passes

// the forward's softmax: one warp a row of the chunk (bh, r): m from -1e9
// over the keys the row sees, P = exp(S - m) rounded to T (f32: hi, lo),
// zero past them; den = max(sum of the unrounded p, 1e-30); lse
template <typename T>
__global__ void __launch_bounds__(256)
    softmax_kernel(const float* __restrict__ S, T* __restrict__ P, T* __restrict__ P_lo,
                   float* __restrict__ den, float* __restrict__ lse, int BH, int H, int Tq, int Tk,
                   int ld, int R, int row0, int rows, int causal) {
  const long long w = (long long)blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (w >= (long long)BH * rows) return;
  const int bh = (int)(w / rows), r = (int)(w % rows);
  const int b = bh / H, h = bh % H;
  const int ra = row0 + r, off = Tk - Tq;
  const int lim = (causal && ra + off >= 0) ? min(Tk, ra + off + 1) : Tk;
  const long long base = at4(b, r, h, 0, R, H, ld);
  const float* s = S + base;
  float m = kMaskValue;
  for (int c = lane; c < lim; c += 32) m = fmaxf(m, s[c]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  float l = 0.f;
  for (int c = 2 * lane; c < ld; c += 64) {
    const float p0 = c < lim ? expf(s[c] - m) : 0.f;
    const float p1 = c + 1 < lim ? expf(s[c + 1] - m) : 0.f;
    l += p0 + p1;
    store_pair(P + base + c, P_lo != nullptr ? P_lo + base + c : nullptr, p0, p1);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) l += __shfl_xor_sync(0xffffffffu, l, o);
  if (lane == 0) {
    const float d = fmaxf(l, 1e-30f);
    den[(long long)bh * R + r] = d;
    if (lse != nullptr) lse[(long long)bh * Tq + ra] = m + logf(d);
  }
}

// dbias (B * H, Tk) rows row0 + r from the per-tile sums, in tile order
__global__ void __launch_bounds__(256)
    dbias_reduce_kernel(const float* __restrict__ dbp, float* __restrict__ dbias, int BH, int R,
                        int rows, int n_ct, int Tk, int row0) {
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  if (i >= (long long)BH * rows) return;
  const int bh = (int)(i / rows), r = (int)(i % rows);
  const float* src = dbp + ((long long)bh * R + r) * n_ct;
  float s = 0.f;
  for (int t = 0; t < n_ct; ++t) s += src[t];
  dbias[(long long)bh * Tk + row0 + r] = s;
}

// x = hi + lo of an f32 tensor of n elements (TF32 hi, ties away from zero)
__global__ void __launch_bounds__(256)
    split_kernel(const float* __restrict__ x, float* __restrict__ hi, float* __restrict__ lo,
                 long long n) {
  for (long long i = (long long)blockIdx.x * 256 + threadIdx.x; i < n;
       i += (long long)gridDim.x * 256) {
    uint32_t h, l;
    tf32::split(x[i], h, l);
    hi[i] = __uint_as_float(h);
    lo[i] = __uint_as_float(l);
  }
}

// the same for x (B, T, H, D), transposed into (B, D, H, Tp), zero for
// t >= T: 32 x 32 tiles through shared memory
__global__ void __launch_bounds__(256)
    split_t_kernel(const float* __restrict__ x, float* __restrict__ hi, float* __restrict__ lo,
                   int T, int H, int D, int Tp) {
  __shared__ float tile[32][33];
  const int bh = blockIdx.z, b = bh / H, h = bh % H;
  const int t0 = blockIdx.x * 32, d0 = blockIdx.y * 32;
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  for (int i = ty; i < 32; i += 8) {
    const int t = t0 + i;
    tile[i][tx] = t < T ? x[at4(b, t, h, d0 + tx, T, H, D)] : 0.f;
  }
  __syncthreads();
  for (int i = ty; i < 32; i += 8) {
    uint32_t hv, lv;
    tf32::split(tile[tx][i], hv, lv);
    const long long o = at4(b, d0 + i, h, t0 + tx, D, H, Tp);
    hi[o] = __uint_as_float(hv);
    lo[o] = __uint_as_float(lv);
  }
}

// ------------------------------------------------------------------ host side

// a tensor map over a (B, R, H, C) tensor (f32 or bf16) whose box is 128
// bytes of C (64 bf16, 32 f32) by `box_rows` rows of one (b, h), swizzled
// 128B as desc_k<64> / desc_mn<128> read it; boxes past R or C read zeros
int make_map(CUtensorMap* map, const void* ptr, bool f32, int B, int R, int H, int C,
             int box_rows) {
  const hopper::EncodeTiledFn encode = hopper::encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  const cuuint64_t e = f32 ? 4 : 2;
  const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)H, (cuuint64_t)R, (cuuint64_t)B};
  const cuuint64_t strides[3] = {C * e, (cuuint64_t)H * C * e, (cuuint64_t)R * H * C * e};
  const cuuint32_t box[4] = {(cuuint32_t)(kRowBytes / e), 1, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                            4, const_cast<void*>(ptr), dims, strides, box, elem,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// One operand of a product: a (B, R, H, C) tensor and, in f32, its lo half
struct Tensor4 {
  const void* hi;
  const void* lo;
  int R, C;
};

template <bool TF32, int NPROD, int BN, bool MN, class E>
int launch_gemm(Operands& ops, const Tensor4 (&a)[NPROD], const Tensor4 (&b)[NPROD],
                const int (&a_row0)[NPROD], const int (&b_row0)[NPROD], int B, int H, int D_depth,
                const typename E::Params& ep, int n_cols, int rows, cudaStream_t s) {
  using C = Cfg<TF32, NPROD, BN, MN>;
  ops.H = H;
  ops.k_tiles = D_depth / C::BK;
  ops.b_cols = n_cols;
  for (int p = 0; p < NPROD; ++p) {
    ops.a_row0[p] = a_row0[p];
    ops.b_row0[p] = b_row0[p];
    for (int x = 0; x < C::HALVES; ++x) {
      int st = make_map(&ops.maps[4 * p + x], x ? a[p].lo : a[p].hi, TF32, B, a[p].R, H, a[p].C, BM);
      if (st == 0)
        st = make_map(&ops.maps[4 * p + 2 + x], x ? b[p].lo : b[p].hi, TF32, B, b[p].R, H, b[p].C,
                      MN ? C::BK : BN);
      if (st != 0) return st;
    }
  }
  auto kernel = gemm_kernel<TF32, NPROD, BN, MN, E>;
  static bool done[hopper::kMaxDevices] = {};
  const int st = hopper::allow_dynamic_smem((const void*)kernel, C::SMEM, done);
  if (st != 0) return st;
  const dim3 grid((n_cols + BN - 1) / BN, (rows + BM - 1) / BM, B * H);
  kernel<<<grid, kThreads, C::SMEM, s>>>(ops, ep);
  return (int)cudaGetLastError();
}

// Regions of the caller's workspace, each on a kWsAlign boundary, in the
// order ops/flash_attention.py::gemm_workspace_bytes lays them out.
struct Carve {
  uint8_t* base;
  long long used;
  template <typename T>
  T* take(long long elems) {
    used = (used + kWsAlign - 1) / kWsAlign * kWsAlign;
    T* p = reinterpret_cast<T*>(base + used);
    used += elems * (long long)sizeof(T);
    return p;
  }
};

int round64(int x) { return (x + 63) / 64 * 64; }

bool bad_args(int B, int Tq, int Tk, int H, int D, int chunk) {
  return B <= 0 || Tq <= 0 || Tk <= 0 || H <= 0 || D <= 0 || D % 64 != 0 || chunk < 64 ||
         chunk % 64 != 0 || (long long)B * H > 65535;
}

// An f32 operand's hi and lo halves in the workspace: x (B, T, H, D) as it
// is, or transposed (B, D, H, Tp) with Tp = T rounded up to 64
Tensor4 split_target(Carve& cv, int B, int T, int H, int D, bool trans) {
  const long long n = (long long)B * (trans ? round64(T) : T) * H * D;
  float* hi = cv.take<float>(n);
  float* lo = cv.take<float>(n);
  return trans ? Tensor4{hi, lo, D, round64(T)} : Tensor4{hi, lo, T, D};
}

void run_split(const float* x, const Tensor4& t, int B, int T, int H, int D, bool trans,
               cudaStream_t s) {
  float* hi = (float*)t.hi;
  float* lo = (float*)t.lo;
  if (trans) {
    const int Tp = round64(T);
    split_t_kernel<<<dim3(Tp / 32, D / 32, B * H), 256, 0, s>>>(x, hi, lo, T, H, D, Tp);
  } else {
    const long long n = (long long)B * T * H * D;
    split_kernel<<<(unsigned)std::min<long long>((n + 255) / 256, 65536), 256, 0, s>>>(x, hi, lo, n);
  }
}

// the same operand unsplit (bf16: read in place)
Tensor4 plain(const void* x, int R, int C) { return Tensor4{x, nullptr, R, C}; }

// One f32 operand to split: the tensor, its rows, whether transposed
struct SplitJob {
  const void* x;
  int T;
  bool trans;
  Tensor4* into;
};

// carve every split target in order, then the score block; run the splits
// only once the layout is known to fit the caller's workspace
template <int N>
void split_all(Carve& cv, SplitJob (&jobs)[N], int B, int H, int D, bool f32) {
  if (f32)
    for (SplitJob& j : jobs) *j.into = split_target(cv, B, j.T, H, D, j.trans);
}

template <int N>
void run_splits(const SplitJob (&jobs)[N], int B, int H, int D, bool f32, cudaStream_t s) {
  if (f32)
    for (const SplitJob& j : jobs) run_split((const float*)j.x, *j.into, B, j.T, H, D, j.trans, s);
}

template <bool F32>
struct Route {
  using T = typename std::conditional<F32, float, __nv_bfloat16>::type;
  static constexpr int BN_ONE = F32 ? 128 : 256;  // the output products
  static constexpr int BN_SCORES = 128;            // the forward's scores (STAGED)
  static constexpr int BN_DUAL = F32 ? 64 : 128;  // the backward's score pairs
  static constexpr long long HALVES = F32 ? 2 : 1;
};

// -------------------------------------------------------------- forward
template <bool F32>
int gemm_fwd(const void* q, const void* k, const void* v, const void* bias, void* o, void* lse,
             int B, int Tq, int Tk, int H, int D, int causal, float scale, void* ws,
             long long ws_bytes, int chunk, cudaStream_t s) {
  using R = Route<F32>;
  using T = typename R::T;
  if (bad_args(B, Tq, Tk, H, D, chunk) || ws == nullptr) return (int)cudaErrorInvalidValue;
  const int Tkp = round64(Tk), BH = B * H;
  const long long block = (long long)B * chunk * H * Tkp;
  Tensor4 tq = plain(q, Tq, D), tk = plain(k, Tk, D), tv = plain(v, Tk, D);
  SplitJob jobs[] = {{q, Tq, false, &tq}, {k, Tk, false, &tk}, {v, Tk, true, &tv}};  // V^T
  Carve cv{(uint8_t*)ws, 0};
  split_all(cv, jobs, B, H, D, F32);
  float* S = cv.take<float>(block);
  T* P = cv.take<T>(R::HALVES * block);
  float* den = cv.take<float>((long long)BH * chunk);
  if (cv.used > ws_bytes) return (int)cudaErrorInvalidValue;
  run_splits(jobs, B, H, D, F32, s);
  T* P_lo = F32 ? P + block : nullptr;
  const Tensor4 tp{P, P_lo, chunk, Tkp};
  Operands ops;
  for (int r0 = 0; r0 < Tq; r0 += chunk) {
    const int rows = std::min(chunk, Tq - r0);
    typename FwdScores::Params sp{S, (const float*)bias, Tq, Tk, Tkp, chunk, r0, rows, H, causal,
                                  scale};
    int st = launch_gemm<F32, 1, R::BN_SCORES, false, FwdScores>(ops, {tq}, {tk}, {r0}, {0}, B,
                                                                  H, D, sp, Tk, rows, s);
    if (st != 0) return st;
    softmax_kernel<T><<<(unsigned)(((long long)BH * rows + 7) / 8), 256, 0, s>>>(
        S, P, P_lo, den, (float*)lse, BH, H, Tq, Tk, Tkp, chunk, r0, rows, causal);
    st = (int)cudaGetLastError();
    if (st != 0) return st;
    typename Output<T>::Params op{(T*)o, den, 1.f, Tq, D, chunk, r0, rows, H, Tq, Tk, causal,
                                  Output<T>::KEYS};
    st = launch_gemm<F32, 1, R::BN_ONE, !F32, Output<T>>(ops, {tp}, {tv}, {0}, {0}, B, H, Tkp,
                                                          op, D, rows, s);
    if (st != 0) return st;
  }
  return 0;
}

// ------------------------------------------------------------------- dq
template <bool F32>
int gemm_dq(const void* q, const void* k, const void* v, const void* bias, const void* dout,
            const void* lse, const void* delta, void* dq, int B, int Tq, int Tk, int H, int D,
            int causal, float scale, void* ws, long long ws_bytes, int chunk, cudaStream_t s) {
  using R = Route<F32>;
  using T = typename R::T;
  if (bad_args(B, Tq, Tk, H, D, chunk) || ws == nullptr) return (int)cudaErrorInvalidValue;
  const int Tkp = round64(Tk);
  const long long block = (long long)B * chunk * H * Tkp;
  Tensor4 tq = plain(q, Tq, D), tdo = plain(dout, Tq, D), tk = plain(k, Tk, D),
          tv = plain(v, Tk, D), tkt = plain(k, Tk, D);
  SplitJob jobs[] = {{q, Tq, false, &tq}, {dout, Tq, false, &tdo}, {k, Tk, false, &tk},
                     {v, Tk, false, &tv}, {k, Tk, true, &tkt}};  // K^T (B, D, H, Tkp)
  Carve cv{(uint8_t*)ws, 0};
  split_all(cv, jobs, B, H, D, F32);
  T* dS = cv.take<T>(R::HALVES * block);
  if (cv.used > ws_bytes) return (int)cudaErrorInvalidValue;
  run_splits(jobs, B, H, D, F32, s);
  T* dS_lo = F32 ? dS + block : nullptr;
  const Tensor4 tds{dS, dS_lo, chunk, Tkp};
  Operands ops;
  for (int r0 = 0; r0 < Tq; r0 += chunk) {
    const int rows = std::min(chunk, Tq - r0);
    typename DqScores<T>::Params sp{dS, dS_lo, (const float*)bias, (const float*)lse,
                                    (const float*)delta, Tq, Tk, Tkp, chunk, r0, rows, H, causal,
                                    scale};
    int st = launch_gemm<F32, 2, R::BN_DUAL, false, DqScores<T>>(
        ops, {tq, tdo}, {tk, tv}, {r0, r0}, {0, 0}, B, H, D, sp, Tkp, rows, s);
    if (st != 0) return st;
    typename Output<T>::Params op{(T*)dq, nullptr, scale, Tq, D, chunk, r0, rows, H, Tq, Tk,
                                  causal, Output<T>::KEYS};
    st = launch_gemm<F32, 1, R::BN_ONE, !F32, Output<T>>(ops, {tds}, {tkt}, {0}, {0}, B, H, Tkp,
                                                          op, D, rows, s);
    if (st != 0) return st;
  }
  return 0;
}

// ----------------------------------------------------------------- dk / dv
template <bool F32>
int gemm_dkv(const void* q, const void* k, const void* v, const void* bias, const void* dout,
             const void* lse, const void* delta, void* dk, void* dv, void* dbias, int B, int Tq,
             int Tk, int H, int D, int causal, float scale, void* ws, long long ws_bytes,
             int chunk, cudaStream_t s) {
  using R = Route<F32>;
  using T = typename R::T;
  if (bad_args(B, Tq, Tk, H, D, chunk) || ws == nullptr) return (int)cudaErrorInvalidValue;
  const int Tqp = round64(Tq), BH = B * H;
  const int n_ct = (Tqp + R::BN_DUAL - 1) / R::BN_DUAL;
  const long long block = (long long)B * chunk * H * Tqp;
  Tensor4 tk = plain(k, Tk, D), tv = plain(v, Tk, D), tq = plain(q, Tq, D),
          tdo = plain(dout, Tq, D), tqt = plain(q, Tq, D), tdot = plain(dout, Tq, D);
  SplitJob jobs[] = {{k, Tk, false, &tk},   {v, Tk, false, &tv},
                     {q, Tq, false, &tq},   {dout, Tq, false, &tdo},
                     {q, Tq, true, &tqt},   {dout, Tq, true, &tdot}};  // Q^T, dO^T (B, D, H, Tqp)
  Carve cv{(uint8_t*)ws, 0};
  split_all(cv, jobs, B, H, D, F32);
  T* PT = cv.take<T>(R::HALVES * block);
  T* dST = cv.take<T>(R::HALVES * block);
  float* dbp = cv.take<float>((long long)BH * chunk * n_ct);
  if (cv.used > ws_bytes) return (int)cudaErrorInvalidValue;
  run_splits(jobs, B, H, D, F32, s);
  T* PT_lo = F32 ? PT + block : nullptr;
  T* dST_lo = F32 ? dST + block : nullptr;
  const Tensor4 tpt{PT, PT_lo, chunk, Tqp}, tdst{dST, dST_lo, chunk, Tqp};
  Operands ops;
  for (int k0 = 0; k0 < Tk; k0 += chunk) {
    const int rows = std::min(chunk, Tk - k0);
    typename DkvScores<T>::Params sp{PT, PT_lo, dST, dST_lo, dbp, (const float*)bias,
                                     (const float*)lse, (const float*)delta, Tq, Tk, Tqp, chunk,
                                     k0, rows, H, causal, n_ct, scale};
    int st = launch_gemm<F32, 2, R::BN_DUAL, false, DkvScores<T>>(
        ops, {tk, tv}, {tq, tdo}, {k0, k0}, {0, 0}, B, H, D, sp, Tqp, rows, s);
    if (st != 0) return st;
    dbias_reduce_kernel<<<(unsigned)(((long long)BH * rows + 255) / 256), 256, 0, s>>>(
        dbp, (float*)dbias, BH, chunk, rows, n_ct, Tk, k0);
    st = (int)cudaGetLastError();
    if (st != 0) return st;
    typename Output<T>::Params opk{(T*)dk, nullptr, scale, Tk, D, chunk, k0, rows, H, Tq, Tk,
                                   causal, Output<T>::QUERIES};
    st = launch_gemm<F32, 1, R::BN_ONE, !F32, Output<T>>(ops, {tdst}, {tqt}, {0}, {0}, B, H, Tqp,
                                                          opk, D, rows, s);
    if (st != 0) return st;
    typename Output<T>::Params opv{(T*)dv, nullptr, 1.f, Tk, D, chunk, k0, rows, H, Tq, Tk,
                                   causal, Output<T>::QUERIES};
    st = launch_gemm<F32, 1, R::BN_ONE, !F32, Output<T>>(ops, {tpt}, {tdot}, {0}, {0}, B, H,
                                                          Tqp, opv, D, rows, s);
    if (st != 0) return st;
  }
  return 0;
}

}  // namespace

// As vt_flash_attention_f32 (flash_attention_f32.cu), D any multiple of 64,
// with the caller's workspace `ws` of `ws_bytes` bytes and the query rows
// taken `chunk` (a multiple of 64) at a time (ops/flash_attention.py's
// gemm_chunk and gemm_workspace_bytes).
extern "C" int vt_flash_attention_wide(const void* q, const void* k, const void* v,
                                       const void* bias, void* o, void* lse, int B, int Tq,
                                       int Tk, int H, int D, int causal, float scale, void* ws,
                                       long long ws_bytes, int chunk, void* stream) {
  return gemm_fwd<true>(q, k, v, bias, o, lse, B, Tq, Tk, H, D, causal, scale, ws, ws_bytes,
                        chunk, (cudaStream_t)stream);
}

// As vt_flash_attention_bwd_dq_f32, with the workspace and query chunk.
extern "C" int vt_flash_attention_bwd_dq_wide(const void* q, const void* k, const void* v,
                                              const void* bias, const void* dout,
                                              const void* lse, const void* delta, void* dq,
                                              int B, int Tq, int Tk, int H, int D, int causal,
                                              float scale, void* ws, long long ws_bytes,
                                              int chunk, void* stream) {
  return gemm_dq<true>(q, k, v, bias, dout, lse, delta, dq, B, Tq, Tk, H, D, causal, scale, ws,
                       ws_bytes, chunk, (cudaStream_t)stream);
}

// As vt_flash_attention_bwd_dkv_f32, with the workspace and key chunk.
extern "C" int vt_flash_attention_bwd_dkv_wide(const void* q, const void* k, const void* v,
                                               const void* bias, const void* dout,
                                               const void* lse, const void* delta, void* dk,
                                               void* dv, void* dbias, int B, int Tq, int Tk,
                                               int H, int D, int causal, float scale, void* ws,
                                               long long ws_bytes, int chunk, void* stream) {
  return gemm_dkv<true>(q, k, v, bias, dout, lse, delta, dk, dv, dbias, B, Tq, Tk, H, D, causal,
                        scale, ws, ws_bytes, chunk, (cudaStream_t)stream);
}

// The same three in bfloat16 (operands, out, dq, dk, dv), for heads wider
// than a cluster of flash_attention_wide_tc.cu splits.
extern "C" int vt_flash_attention_wide_bf16(const void* q, const void* k, const void* v,
                                            const void* bias, void* o, void* lse, int B, int Tq,
                                            int Tk, int H, int D, int causal, float scale,
                                            void* ws, long long ws_bytes, int chunk,
                                            void* stream) {
  return gemm_fwd<false>(q, k, v, bias, o, lse, B, Tq, Tk, H, D, causal, scale, ws, ws_bytes,
                         chunk, (cudaStream_t)stream);
}

extern "C" int vt_flash_attention_bwd_dq_wide_bf16(const void* q, const void* k, const void* v,
                                                   const void* bias, const void* dout,
                                                   const void* lse, const void* delta, void* dq,
                                                   int B, int Tq, int Tk, int H, int D,
                                                   int causal, float scale, void* ws,
                                                   long long ws_bytes, int chunk, void* stream) {
  return gemm_dq<false>(q, k, v, bias, dout, lse, delta, dq, B, Tq, Tk, H, D, causal, scale, ws,
                        ws_bytes, chunk, (cudaStream_t)stream);
}

extern "C" int vt_flash_attention_bwd_dkv_wide_bf16(const void* q, const void* k, const void* v,
                                                    const void* bias, const void* dout,
                                                    const void* lse, const void* delta, void* dk,
                                                    void* dv, void* dbias, int B, int Tq, int Tk,
                                                    int H, int D, int causal, float scale,
                                                    void* ws, long long ws_bytes, int chunk,
                                                    void* stream) {
  return gemm_dkv<false>(q, k, v, bias, dout, lse, delta, dk, dv, dbias, B, Tq, Tk, H, D, causal,
                         scale, ws, ws_bytes, chunk, (cudaStream_t)stream);
}
