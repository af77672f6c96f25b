// Flash attention in float32, forward (K4) and backward (K5), at head dims
// 16, 32, 64 and 128, on Hopper's tensor cores as three-pass TF32 (sm_90a).
//
// Replaces, in float32: vilmedic_tpu/ops/flash_attention.py::_kernel_v2 and
// ::_kernel (the forward, with `with_lse`, through `_flash_bthd` and
// `_flash_bhtd`), ::_bwd_dq_kernel_v2 / ::_bwd_dkv_kernel_v2 and
// ::_bwd_dq_kernel / ::_bwd_dkv_kernel (the backward, through
// `_flash_bwd_bthd` and `_flash_bwd_bhtd`). The function, the masking and the
// rounding points are those of the bf16 kernels (flash_attention.cu and
// flash_attention_bwd.cu give the formulas), which in f32 round nothing:
// f32 p, the finite -1e9 mask and running-max floor, the 1e-30 denominator
// floor, lse in natural log, dbias from the unrounded dS, every sum in a
// fixed order (no atomics: two runs are bitwise equal).
//
// What bounds it on the H100: at the VisionLanguage tower (B 16, T 1370,
// H 12, D 64) a forward is 4 * B * H * T^2 * D = 92 GFLOP. On the CUDA
// cores (67 TFLOP/s) that is 1.38 ms, and a kernel that reads one 32-bit
// shared-memory word per FMA gets about a quarter of it. TF32 on the tensor
// cores runs at 495 TFLOP/s but keeps 10 mantissa bits, which alone would
// miss the f32 route's parity with the plain version by two orders.
//
// Design: three passes. Each f32 operand a = hi + lo, hi = a rounded to TF32
// (nearest, ties away: (bits + 2^12) & ~(2^13 - 1)), lo = a - hi (exact in
// f32; the tensor core reads its TF32 truncation). A product is
// lo_a * hi_b + hi_a * lo_b + hi_a * hi_b, summed in the f32 accumulator
// (lo * lo, below 2^-22 of the product, is dropped), so 3 x 92 GFLOP at
// 495 TFLOP/s bound the tower at 0.56 ms.
//   - wgmma takes TF32 operands only K-major (no transpose bit): the depth of
//     the product runs along each operand's contiguous axis. A operands come
//     from registers: Q (and dO; K and V in dk/dv) is loaded once per thread
//     into shared memory in the register layout of wgmma m64nNk8's A
//     fragment (thread, k-step: (g, t4), (g + 8, t4), (g, t4 + 4),
//     (g + 8, t4 + 4)) and read back per k-step as one float4; P and dS come
//     from the score accumulator, whose columns 2 t4 and 2 t4 + 1 stand in
//     for the fragment's t4 and t4 + 4 (kperm: keys 0 2 4 6 1 3 5 7 of each
//     group of 8), with the B operand's keys stored in that order.
//   - B operands are split tiles in shared memory, 128-byte swizzled (64 at
//     16 columns) as the descriptors read them (hopper_common.cuh: an f32
//     tile of C columns is laid out as a bf16 tile of 2C). They are written
//     by threads, not TMA: the transposes and the split need a pass anyway.
//   - Warp-specialised: warpgroup 0 produces, warpgroups 1 and 2 (1 at head
//     dim 128 in the backward) consume 64 rows each (queries; keys in
//     dk/dv). The producer copies each K / V tile (Q / dO in dk/dv) by
//     cp.async into a plain row-major landing buffer, then writes into a
//     2-stage ring (1 stage for dk/dv at 128) its hi and lo halves, K-major
//     as landed for S = Q K^T, dP = dO V^T, S^T = K Q^T, dP^T = V dO^T, and,
//     transposed in kperm order in the same pass, those of the products
//     over keys (or queries): V^T for P V, K^T for dS K, Q^T and dO^T for
//     dS^T Q and P^T dO; with the tile's key bias (lse, delta); full / empty
//     mbarriers hand the stages over. The split runs under the consumers'
//     products; the consumers run independently of each other.
//   - The tensor core sums each tile's product from zero; a running f32 sum
//     across the tiles (RunningSum) adds it by round-to-nearest FMAs (the
//     forward's rescale by alpha folded in).
//   - Online softmax, dS, P^T / dS^T and the masks are flash_common.cuh's
//     (log2 domain, ex2.approx), on the same accumulator layout as bf16.
//   - Per head dim (Fwd, Dq, Dkv below) the key (query) tile, the consumer
//     warpgroups and the ring keep the shared memory (ring, landing buffer,
//     A fragments, running sums at 128) within 227 KB, and the registers
//     within the 168 a thread that three warpgroups leave, without spills
//     (255 with one consumer warpgroup). No setmaxnreg: a build that raised
//     the consumers to 224 still spilled where 168 did not suffice.
//   - Epilogues write f32 from the running sums (float2 a lane and row);
//     out is sum / max(l, 1e-30), dq / dk times the scale.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace {

using namespace flash;

constexpr int align1k(int bytes) { return (bytes + 1023) / 1024 * 1024; }

// ------------------------------------------------------------- TF32 split

// x = hi + lo: hi x rounded to TF32 (low 13 bits zero), lo the rest, exact
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// the position of key r of a tile among the K-extent of a transposed tile:
// in each group of 8, keys 0 2 4 6 1 3 5 7 (kperm, see the header)
__device__ __forceinline__ int kperm(int r) { return (r & ~7) | ((r & 1) << 2) | ((r & 7) >> 1); }

// byte offset of element (r, c) of a K-major f32 tile of `rows` rows and F
// columns (the K extent): chunks of 32 columns (128-byte rows; a 16-column
// tile has 64-byte rows), the chunk's 16-byte units XOR-swizzled by the row
// as TMA's 128B / 64B patterns lay them out (desc_k<2F> reads them)
template <int F>
__device__ __forceinline__ uint32_t kmajor_offset(int rows, int r, int c) {
  constexpr int CWF = F < 32 ? F : 32;
  constexpr uint32_t SW = CWF * 4;
  constexpr uint32_t MASK = SW / 16 - 1;
  const uint32_t off = (c / CWF) * rows * SW + r * SW + (c % CWF) * 4;
  return off ^ (((off >> 7) & MASK) << 4);
}

// ------------------------------------------------------------ wgmma (TF32)

// D (m64nN, f32) (+)= A (m64k8 tf32, registers) * B (k8nN tf32, shared,
// K-major); scale_d 0 overwrites D
__device__ __forceinline__ void wgmma_tf32_n16(float (&d)[8], const uint32_t (&a)[4],
                                               uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_tf32_n32(float (&d)[16], const uint32_t (&a)[4],
                                               uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_tf32_n64(float (&d)[32], const uint32_t (&a)[4],
                                               uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_tf32_n128(float (&d)[64], const uint32_t (&a)[4],
                                                uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

template <int N>
__device__ __forceinline__ void wgmma_tf32(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b,
                                           int scale_d) {
  if constexpr (N == 16) wgmma_tf32_n16(d, a, b, scale_d);
  else if constexpr (N == 32) wgmma_tf32_n32(d, a, b, scale_d);
  else if constexpr (N == 64) wgmma_tf32_n64(d, a, b, scale_d);
  else {
    static_assert(N == 128, "wgmma_tf32: N 16 to 128");
    wgmma_tf32_n128(d, a, b, scale_d);
  }
}

// keep registers an asynchronous wgmma reads live up to this point
template <int C>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[C][4]) {
#pragma unroll
  for (int i = 0; i < C; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// acc = A B over a depth of KF (KF / 8 k-steps), in three TF32 passes
// (lo_a hi_b, hi_a lo_b, hi_a hi_b). raw(kk, r) gives A's f32 fragment of
// k-step kk; B's halves are K-major tiles of N rows and KF columns at the
// shared addresses bh and bl. The A halves of CH k-steps are in registers
// at once; each chunk is waited for.
template <int N, int KF, int CH, typename Raw>
__device__ __forceinline__ void mma_tf32x3(float (&acc)[N / 2], Raw raw, uint32_t bh, uint32_t bl) {
  constexpr int KS = KF / 8;
  constexpr int C = CH < KS ? CH : KS;
  static_assert(KS % C == 0, "mma_tf32x3: chunks of equal size");
#pragma unroll
  for (int c0 = 0; c0 < KS; c0 += C) {
    uint32_t ah[C][4], al[C][4];
#pragma unroll
    for (int j = 0; j < C; ++j) {
      float r[4];
      raw(c0 + j, r);
#pragma unroll
      for (int e = 0; e < 4; ++e) split(r[e], ah[j][e], al[j][e]);
    }
    hopper::fence_operand(acc);
    hopper::wgmma_fence();
#pragma unroll
    for (int j = 0; j < C; ++j) {
      const int kk = c0 + j;
      const uint64_t dh = hopper::desc_k<2 * KF>(bh, N, 0, kk);
      const uint64_t dl = hopper::desc_k<2 * KF>(bl, N, 0, kk);
      wgmma_tf32<N>(acc, al[j], dh, kk > 0);
      wgmma_tf32<N>(acc, ah[j], dl, 1);
      wgmma_tf32<N>(acc, ah[j], dh, 1);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait_all();
    hopper::fence_operand(acc);
    fence_regs(ah);
    fence_regs(al);
  }
}

// A fragments of an m64 accumulator's chunk of 8 columns kk (P, dS, P^T,
// dS^T), in kperm order
template <int N>
__device__ __forceinline__ void acc_fragment(const float (&s)[N], int kk, float (&r)[4]) {
  r[0] = s[4 * kk];
  r[1] = s[4 * kk + 2];
  r[2] = s[4 * kk + 1];
  r[3] = s[4 * kk + 3];
}

// ---------------------------------------------------- staging in shared memory

// This thread's A fragments of rows r0 and r0 + 8 of a (T, H * D) head slice
// (`src` at row 0 of the head; rows past T zero) into `area`: k-step kk at
// area[kk * NT + tid], each thread reading back only its own.
template <int D, int NT>
__device__ __forceinline__ void stash_fragments(float4* area, const float* __restrict__ src,
                                                long long HD, int r0, int T, int tid) {
  const int t4 = tid % 4;
  const int r1 = r0 + 8;
  const float* a = src + (long long)r0 * HD;
  const float* b = src + (long long)r1 * HD;
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    const int c = 8 * kk + t4;
    area[kk * NT + tid] = make_float4(r0 < T ? a[c] : 0.f, r1 < T ? b[c] : 0.f,
                                      r0 < T ? a[c + 4] : 0.f, r1 < T ? b[c + 4] : 0.f);
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(hopper::smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// rows [r0, r0 + R) of a (T, H * D) head slice by cp.async into a row-major
// buffer of row stride D + 4 floats; rows past T are zero-filled
template <int R, int D, int NT>
__device__ __forceinline__ void land_rows(float* dst, const float* __restrict__ src, long long HD,
                                          int r0, int T, int tid) {
  for (int i = tid; i < R * D / 4; i += NT) {
    const int r = i / (D / 4), c = (i % (D / 4)) * 4;
    const bool valid = r0 + r < T;
    cp_async16(dst + r * (D + 4) + c, valid ? src + (long long)(r0 + r) * HD + c : src, valid);
  }
}

// The hi and lo halves of a landed R x D tile: DIRECT as K-major tiles of R
// rows and D columns (hi, lo), TRANS transposed, K-major tiles of D rows and
// R columns in kperm order (thi, tlo). Lanes walk the rows, so the landed
// reads, the direct float4 writes and the transposed word writes all spread
// over the banks.
template <int R, int D, int NT, bool DIRECT, bool TRANS>
__device__ __forceinline__ void split_tile(const float* land, uint8_t* hi, uint8_t* lo,
                                           uint8_t* thi, uint8_t* tlo, int tid) {
  for (int i = tid; i < R * D / 4; i += NT) {
    const int r = i % R, c = (i / R) * 4;
    const float4 x = *reinterpret_cast<const float4*>(land + r * (D + 4) + c);
    uint32_t h[4], l[4];
    split(x.x, h[0], l[0]);
    split(x.y, h[1], l[1]);
    split(x.z, h[2], l[2]);
    split(x.w, h[3], l[3]);
    if constexpr (DIRECT) {
      const uint32_t off = kmajor_offset<D>(R, r, c);
      *reinterpret_cast<uint4*>(hi + off) = make_uint4(h[0], h[1], h[2], h[3]);
      *reinterpret_cast<uint4*>(lo + off) = make_uint4(l[0], l[1], l[2], l[3]);
    }
    if constexpr (TRANS) {
      const int p = kperm(r);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const uint32_t off = kmajor_offset<R>(D, c + e, p);
        *reinterpret_cast<uint32_t*>(thi + off) = h[e];
        *reinterpret_cast<uint32_t*>(tlo + off) = l[e];
      }
    }
  }
}

// the key bias of keys [k0, k0 + n) of item b times log2(e) (0 without a
// bias), -inf past Tk
__device__ __forceinline__ void stage_bias(float* dst, const float* __restrict__ bias, int b, int Tk,
                                           int k0, int n, int tid) {
  if (tid < n) {
    const int c = k0 + tid;
    dst[tid] = c >= Tk ? -INFINITY : (bias != nullptr ? bias[(long long)b * Tk + c] * hopper::kLog2e
                                                      : 0.f);
  }
}

// an m64nD accumulator's rows g and g + 8 (r0, r1 < T only), times f0 / f1
// (or divided by them), into a (T, H * D) head slice
template <int D, bool DIVIDE>
__device__ __forceinline__ void store_acc(const float (&acc)[D / 2], float f0, float f1,
                                          float* __restrict__ dst, long long HD, int r0, int T,
                                          int t4) {
  const int r1 = r0 + 8;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int c = 8 * j + 2 * t4;
    if (r0 < T)
      *reinterpret_cast<float2*>(dst + (long long)r0 * HD + c) =
          DIVIDE ? make_float2(acc[4 * j] / f0, acc[4 * j + 1] / f0)
                 : make_float2(acc[4 * j] * f0, acc[4 * j + 1] * f0);
    if (r1 < T)
      *reinterpret_cast<float2*>(dst + (long long)r1 * HD + c) =
          DIVIDE ? make_float2(acc[4 * j + 2] / f1, acc[4 * j + 3] / f1)
                 : make_float2(acc[4 * j + 2] * f1, acc[4 * j + 3] * f1);
  }
}

// The running f32 sum of an output accumulator (O, dq, dk, dv) over the
// tiles. Each tile's product is summed from zero by the tensor core and
// added here by round-to-nearest FMAs: summed across the whole key (query)
// axis inside the tensor core, whose f32 sums do not round to nearest, dk
// at T 1470 missed the f32 tolerance (PERF.md). In registers, or
// (SMEM: at head dim 128, beside the larger accumulators) in this thread's
// own float4s of shared memory, area[i * NT + tid] (tid: the consumer
// thread).
template <int N, bool SMEM, int NT>
struct RunningSum {
  float reg[SMEM ? 1 : N];
  float4* area;  // SMEM: this thread's first float4

  __device__ __forceinline__ RunningSum(float4* a, int tid) : area(a + tid) {
#pragma unroll
    for (int i = 0; i < (SMEM ? N / 4 : N); ++i) {
      if constexpr (SMEM) area[i * NT] = make_float4(0.f, 0.f, 0.f, 0.f);
      else reg[i] = 0.f;
    }
  }

  // sum = sum * f + t, f being f0 on the thread's row g and f1 on g + 8
  __device__ __forceinline__ void add(const float (&t)[N], float f0, float f1) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      if constexpr (SMEM) {
        const float4 x = area[i * NT];
        area[i * NT] =
            make_float4(fmaf(x.x, f0, t[4 * i]), fmaf(x.y, f0, t[4 * i + 1]),
                        fmaf(x.z, f1, t[4 * i + 2]), fmaf(x.w, f1, t[4 * i + 3]));
      } else {
        reg[4 * i] = fmaf(reg[4 * i], f0, t[4 * i]);
        reg[4 * i + 1] = fmaf(reg[4 * i + 1], f0, t[4 * i + 1]);
        reg[4 * i + 2] = fmaf(reg[4 * i + 2], f1, t[4 * i + 2]);
        reg[4 * i + 3] = fmaf(reg[4 * i + 3], f1, t[4 * i + 3]);
      }
    }
  }

  __device__ __forceinline__ void load(float (&t)[N]) const {
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      if constexpr (SMEM) {
        const float4 x = area[i * NT];
        t[4 * i] = x.x, t[4 * i + 1] = x.y, t[4 * i + 2] = x.z, t[4 * i + 3] = x.w;
      } else {
        t[4 * i] = reg[4 * i], t[4 * i + 1] = reg[4 * i + 1];
        t[4 * i + 2] = reg[4 * i + 2], t[4 * i + 3] = reg[4 * i + 3];
      }
    }
  }
};

// The shared memory of one kernel: NC consumer warpgroups, tiles of BK rows;
// a ring of STAGES stages, each SPLITS split tiles of BK x D (4 forward, 6
// dq, 8 dk/dv) and 2 x BK floats of per-row values (bias; lse, delta); one
// landing buffer of two tensors; AREAS per-consumer-thread areas of
// (D / 8) x NT float4s (the A fragments, then the running sums kept in
// shared memory); the ring's mbarriers. Byte offsets from the 1024-aligned
// base.
template <int D, int NC, int BK, int STAGES, int SPLITS, int AREAS>
struct Layout {
  static constexpr int NT = 128 * NC;  // consumer threads
  static constexpr int TILE = BK * D * 4;
  static constexpr int STAGE = SPLITS * TILE + align1k(2 * BK * 4);
  static constexpr int LAND = align1k(BK * (D + 4) * 4);  // one landed tensor
  static constexpr int LANDED = STAGES * STAGE;
  static constexpr int AREA = LANDED + 2 * LAND;
  static constexpr int BAR = AREA + AREAS * (D / 8) * NT * 16;  // full[STAGES], empty[STAGES]
  static constexpr int SMEM = BAR + 2 * STAGES * 8 + 1024;      // + alignment slack
  static_assert(TILE % 1024 == 0, "split tiles on 1024-byte boundaries");
  static_assert(SMEM <= 232448, "shared memory of one CTA");
  __device__ static uint8_t* tile(uint8_t* smem, int stage, int i) {
    return smem + stage * STAGE + i * TILE;
  }
  __device__ static uint32_t tile_u32(uint8_t* smem, int stage, int i) {
    return hopper::smem_u32(tile(smem, stage, i));
  }
  __device__ static float* stats(uint8_t* smem, int stage) {
    return reinterpret_cast<float*>(smem + stage * STAGE + SPLITS * TILE);
  }
  __device__ static float* land(uint8_t* smem, int i) {
    return reinterpret_cast<float*>(smem + LANDED + i * LAND);
  }
  __device__ static float4* area(uint8_t* smem, int i) {
    return reinterpret_cast<float4*>(smem + AREA + i * (D / 8) * NT * 16);
  }
  __device__ static uint64_t* bars(uint8_t* smem) {
    return reinterpret_cast<uint64_t*>(smem + BAR);
  }
};

// A's fragment of k-step kk from a per-thread area
__device__ __forceinline__ void area_fragment(const float4* area, int kk, int nt, int tid,
                                              float (&r)[4]) {
  const float4 f = area[kk * nt + tid];
  r[0] = f.x, r[1] = f.y, r[2] = f.z, r[3] = f.w;
}

// Warp specialisation: warpgroup 0 produces, warpgroups 1..NC consume. The
// ring's barriers: full[s] completes when the 128 producer threads have
// written stage s, empty[s] when every consumer thread has released it.
template <int STAGES, int NC>
__device__ __forceinline__ uint64_t* init_split_ring(uint64_t* bars) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&bars[s], 128);
      hopper::mbar_init(&bars[STAGES + s], 128 * NC);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();
  return bars;
}

// The producer warpgroup's loop over n_tiles tiles: land(it) issues tile
// it's cp.async copies into the landing buffer, fill(s, it) splits the
// landed tile into stage s. Tile it + 1 is copied while the consumers work
// on tile it.
template <int STAGES, typename Land, typename Fill>
__device__ __forceinline__ void produce(uint64_t* bars, int n_tiles, Land land, Fill fill) {
  if (n_tiles > 0) {
    land(0);
    cp_async_commit();
  }
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % STAGES;
    cp_async_wait_all();
    hopper::named_sync(1, 128);  // tile it has landed, every producer thread's copies
    hopper::mbar_wait(&bars[STAGES + s], ((it / STAGES) & 1) ^ 1);  // stage s is free
    fill(s, it);
    hopper::fence_proxy_async();  // the split tiles, for the consumers' wgmma
    hopper::mbar_arrive(&bars[s]);
    hopper::named_sync(1, 128);  // every producer thread has read the landing buffer
    if (it + 1 < n_tiles) {
      land(it + 1);
      cp_async_commit();
    }
  }
}

// ------------------------------------------------------------------ forward

template <int D, int NC, int BK, int STAGES, bool MS>
__global__ void __launch_bounds__(128 * (NC + 1), 1)
    flash_fwd_three_pass_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                const float* __restrict__ v, const float* __restrict__ bias,
                                float* __restrict__ o, float* __restrict__ lse, int Tq, int Tk,
                                int H, int causal, float scale_log2) {
  // stage: K hi, lo, V^T hi, lo, key bias; areas Q (, O); landed K, V
  using L = Layout<D, NC, BK, STAGES, 4, 1 + MS>;
  constexpr int NT = L::NT;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hopper::align_1024(smem_raw);
  uint64_t* bars = init_split_ring<STAGES, NC>(L::bars(smem));
  const int q0 = blockIdx.x * 64 * NC, h = blockIdx.y, b = blockIdx.z;
  const int off = Tk - Tq;
  const long long HD = (long long)H * D;
  const int n_tiles = key_tiles(q0, 64 * NC, Tq, Tk, BK, causal);

  if (threadIdx.x < 128) {  // ---- producer: K, V tiles split into the ring, with the key bias
    const int tid = threadIdx.x;
    const float* kb = k + (long long)b * Tk * HD + (long long)h * D;
    const float* vb = v + (long long)b * Tk * HD + (long long)h * D;
    produce<STAGES>(
        bars, n_tiles,
        [&](int it) {
          land_rows<BK, D, 128>(L::land(smem, 0), kb, HD, it * BK, Tk, tid);
          land_rows<BK, D, 128>(L::land(smem, 1), vb, HD, it * BK, Tk, tid);
        },
        [&](int s, int it) {
          split_tile<BK, D, 128, true, false>(L::land(smem, 0), L::tile(smem, s, 0),
                                              L::tile(smem, s, 1), nullptr, nullptr, tid);
          split_tile<BK, D, 128, false, true>(L::land(smem, 1), nullptr, nullptr,
                                              L::tile(smem, s, 2), L::tile(smem, s, 3), tid);
          stage_bias(L::stats(smem, s), bias, b, Tk, it * BK, BK, tid);
        });
    return;
  }

  // ---- consumers: 64 query rows a warpgroup
  const int tid = threadIdx.x - 128;
  const int tw = tid % 128, g = (tw % 32) / 4, t4 = tw % 4;
  const int wq0 = q0 + (tid / 128) * 64;  // this warpgroup's first row
  const int r0 = wq0 + (tw / 32) * 16 + g, r1 = r0 + 8;
  const int w_last = min(wq0 + 63, Tq - 1);
  const bool nokey = causal && wq0 + off < 0;  // holds a row that sees no key
  const float4* qa = L::area(smem, 0);
  stash_fragments<D, NT>(L::area(smem, 0), q + (long long)b * Tq * HD + (long long)h * D, HD,
                         r0, Tq, tid);
  RunningSum<D / 2, MS, NT> o_sum(L::area(smem, 1), tid);
  float m0 = kMaskL2, m1 = kMaskL2;  // running row maxima (log2 domain)
  float l0 = 0.f, l1 = 0.f;          // this lane's part of the denominators

  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % STAGES;
    const int k0 = it * BK;
    hopper::mbar_wait(&bars[s], (it / STAGES) & 1);
    if (!causal || nokey || k0 <= w_last + off) {
      float sc[BK / 2], pv[D / 2];
      mma_tf32x3<BK, D, 8>(
          sc, [&](int kk, float (&r)[4]) { area_fragment(qa, kk, NT, tid, r); },
          L::tile_u32(smem, s, 0), L::tile_u32(smem, s, 1));
      float alpha0, alpha1;
      const float* bs = L::stats(smem, s);
      if (causal && (nokey || k0 + BK - 1 > wq0 + off))
        softmax_tile<true, BK>(sc, bs, k0, r0, r1, off, Tk, t4, scale_log2, m0, m1, l0, l1,
                               alpha0, alpha1);
      else
        softmax_tile<false, BK>(sc, bs, k0, r0, r1, off, Tk, t4, scale_log2, m0, m1, l0, l1,
                                alpha0, alpha1);
      mma_tf32x3<D, BK, 8>(
          pv, [&](int kk, float (&r)[4]) { acc_fragment(sc, kk, r); }, L::tile_u32(smem, s, 2),
          L::tile_u32(smem, s, 3));
      o_sum.add(pv, alpha0, alpha1);
    }
    hopper::mbar_arrive(&bars[STAGES + s]);  // release the stage
  }

  l0 = hopper::quad_sum(l0);
  l1 = hopper::quad_sum(l1);
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  float out[D / 2];
  o_sum.load(out);
  store_acc<D, true>(out, d0, d1, o + (long long)b * Tq * HD + (long long)h * D, HD, r0, Tq, t4);
  if (lse != nullptr && t4 == 0) {
    float* lb = lse + ((long long)b * H + h) * Tq;
    if (r0 < Tq) lb[r0] = m0 * hopper::kLn2 + logf(d0);
    if (r1 < Tq) lb[r1] = m1 * hopper::kLn2 + logf(d1);
  }
}

// ------------------------------------------------------------------------ dq

template <int D, int NC, int BK, int STAGES, bool MS>
__global__ void __launch_bounds__(128 * (NC + 1), 1)
    flash_bwd_dq_three_pass_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                   const float* __restrict__ v, const float* __restrict__ bias,
                                   const float* __restrict__ dout, const float* __restrict__ lse,
                                   const float* __restrict__ delta, float* __restrict__ dq,
                                   int Tq, int Tk, int H, int causal, float scale,
                                   float scale_log2) {
  // stage: K hi, lo, V hi, lo, K^T hi, lo, key bias; areas Q, dO (, dq);
  // landed K, V
  using L = Layout<D, NC, BK, STAGES, 6, 2 + MS>;
  constexpr int NT = L::NT;
  constexpr int CH = D >= 128 ? 4 : 8;  // A halves of 4 k-steps beside a 64-register dq
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hopper::align_1024(smem_raw);
  uint64_t* bars = init_split_ring<STAGES, NC>(L::bars(smem));
  const int q0 = blockIdx.x * 64 * NC, h = blockIdx.y, b = blockIdx.z;
  const int off = Tk - Tq;
  const long long HD = (long long)H * D;
  const int n_tiles = key_tiles(q0, 64 * NC, Tq, Tk, BK, causal);

  if (threadIdx.x < 128) {  // ---- producer: K (direct and transposed), V, key bias
    const int tid = threadIdx.x;
    const float* kb = k + (long long)b * Tk * HD + (long long)h * D;
    const float* vb = v + (long long)b * Tk * HD + (long long)h * D;
    produce<STAGES>(
        bars, n_tiles,
        [&](int it) {
          land_rows<BK, D, 128>(L::land(smem, 0), kb, HD, it * BK, Tk, tid);
          land_rows<BK, D, 128>(L::land(smem, 1), vb, HD, it * BK, Tk, tid);
        },
        [&](int s, int it) {
          split_tile<BK, D, 128, true, true>(L::land(smem, 0), L::tile(smem, s, 0),
                                             L::tile(smem, s, 1), L::tile(smem, s, 4),
                                             L::tile(smem, s, 5), tid);
          split_tile<BK, D, 128, true, false>(L::land(smem, 1), L::tile(smem, s, 2),
                                              L::tile(smem, s, 3), nullptr, nullptr, tid);
          stage_bias(L::stats(smem, s), bias, b, Tk, it * BK, BK, tid);
        });
    return;
  }

  // ---- consumers: 64 query rows a warpgroup
  const int tid = threadIdx.x - 128;
  const int tw = tid % 128, g = (tw % 32) / 4, t4 = tw % 4;
  const int wq0 = q0 + (tid / 128) * 64;
  const int r0 = wq0 + (tw / 32) * 16 + g, r1 = r0 + 8;
  const int w_last = min(wq0 + 63, Tq - 1);
  const bool nokey = causal && wq0 + off < 0;
  const long long qoff = (long long)b * Tq * HD + (long long)h * D;
  const float* lb = lse + ((long long)b * H + h) * Tq;
  const float* db = delta + ((long long)b * H + h) * Tq;
  const float lse0 = r0 < Tq ? lb[r0] * hopper::kLog2e : 0.f;
  const float lse1 = r1 < Tq ? lb[r1] * hopper::kLog2e : 0.f;
  const float dl0 = r0 < Tq ? db[r0] : 0.f;
  const float dl1 = r1 < Tq ? db[r1] : 0.f;
  const float4* qa = L::area(smem, 0);
  const float4* da = L::area(smem, 1);
  stash_fragments<D, NT>(L::area(smem, 0), q + qoff, HD, r0, Tq, tid);
  stash_fragments<D, NT>(L::area(smem, 1), dout + qoff, HD, r0, Tq, tid);
  RunningSum<D / 2, MS, NT> dq_sum(L::area(smem, 2), tid);

  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % STAGES;
    const int k0 = it * BK;
    hopper::mbar_wait(&bars[s], (it / STAGES) & 1);
    if (!causal || nokey || k0 <= w_last + off) {
      float sc[BK / 2], dp[BK / 2], dqt[D / 2];
      mma_tf32x3<BK, D, CH>(
          sc, [&](int kk, float (&r)[4]) { area_fragment(qa, kk, NT, tid, r); },
          L::tile_u32(smem, s, 0), L::tile_u32(smem, s, 1));
      mma_tf32x3<BK, D, CH>(
          dp, [&](int kk, float (&r)[4]) { area_fragment(da, kk, NT, tid, r); },
          L::tile_u32(smem, s, 2), L::tile_u32(smem, s, 3));
      const float* bs = L::stats(smem, s);
      if (causal && (nokey || k0 + BK - 1 > wq0 + off))
        dq_scores<true, BK>(sc, dp, bs, k0, r0, r1, off, Tk, t4, scale_log2, lse0, lse1, dl0,
                            dl1);
      else
        dq_scores<false, BK>(sc, dp, bs, k0, r0, r1, off, Tk, t4, scale_log2, lse0, lse1, dl0,
                             dl1);
      mma_tf32x3<D, BK, 8>(
          dqt, [&](int kk, float (&r)[4]) { acc_fragment(sc, kk, r); }, L::tile_u32(smem, s, 4),
          L::tile_u32(smem, s, 5));
      dq_sum.add(dqt, 1.f, 1.f);
    }
    hopper::mbar_arrive(&bars[STAGES + s]);
  }
  float acc[D / 2];
  dq_sum.load(acc);
  store_acc<D, false>(acc, scale, scale, dq + qoff, HD, r0, Tq, t4);
}

// -------------------------------------------------------------------- dk / dv

template <int D, int NC, int BQ, int STAGES, bool MS>
__global__ void __launch_bounds__(128 * (NC + 1), 1)
    flash_bwd_dkv_three_pass_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                    const float* __restrict__ v, const float* __restrict__ bias,
                                    const float* __restrict__ dout, const float* __restrict__ lse,
                                    const float* __restrict__ delta, float* __restrict__ dk,
                                    float* __restrict__ dv, float* __restrict__ dbias, int Tq,
                                    int Tk, int H, int causal, float scale, float scale_log2) {
  // stage: Q hi, lo, dO hi, lo, Q^T hi, lo, dO^T hi, lo, lse and delta;
  // areas K, V (, dk, dv); landed Q, dO
  using L = Layout<D, NC, BQ, STAGES, 8, 2 + 2 * MS>;
  constexpr int NT = L::NT;
  constexpr int CH = D >= 64 ? 4 : 8;  // beside two running sums in registers (or D 128)
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hopper::align_1024(smem_raw);
  uint64_t* bars = init_split_ring<STAGES, NC>(L::bars(smem));
  const int k0 = blockIdx.x * 64 * NC, h = blockIdx.y, b = blockIdx.z;
  const int off = Tk - Tq;
  const long long HD = (long long)H * D;
  const int t0 = first_query_tile(k0, Tq, Tk, BQ, causal);
  const int n_tiles = (Tq + BQ - 1) / BQ - t0;
  const float* lb = lse + ((long long)b * H + h) * Tq;
  const float* db = delta + ((long long)b * H + h) * Tq;

  if (threadIdx.x < 128) {  // ---- producer: Q, dO (direct and transposed), lse, delta
    const int tid = threadIdx.x;
    const float* qb = q + (long long)b * Tq * HD + (long long)h * D;
    const float* ob = dout + (long long)b * Tq * HD + (long long)h * D;
    produce<STAGES>(
        bars, n_tiles,
        [&](int it) {
          land_rows<BQ, D, 128>(L::land(smem, 0), qb, HD, (t0 + it) * BQ, Tq, tid);
          land_rows<BQ, D, 128>(L::land(smem, 1), ob, HD, (t0 + it) * BQ, Tq, tid);
        },
        [&](int s, int it) {
          split_tile<BQ, D, 128, true, true>(L::land(smem, 0), L::tile(smem, s, 0),
                                             L::tile(smem, s, 1), L::tile(smem, s, 4),
                                             L::tile(smem, s, 5), tid);
          split_tile<BQ, D, 128, true, true>(L::land(smem, 1), L::tile(smem, s, 2),
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

  // ---- consumers: 64 keys a warpgroup
  const int tid = threadIdx.x - 128;
  const int tw = tid % 128, g = (tw % 32) / 4, t4 = tw % 4;
  const int kw0 = k0 + (tid / 128) * 64;  // this warpgroup's first key
  const int c0 = kw0 + (tw / 32) * 16 + g, c1 = c0 + 8;
  const float bias0 = c0 >= Tk ? -INFINITY
                               : (bias != nullptr ? bias[(long long)b * Tk + c0] * hopper::kLog2e
                                                  : 0.f);
  const float bias1 = c1 >= Tk ? -INFINITY
                               : (bias != nullptr ? bias[(long long)b * Tk + c1] * hopper::kLog2e
                                                  : 0.f);
  const long long koff = (long long)b * Tk * HD + (long long)h * D;
  const float4* ka = L::area(smem, 0);
  const float4* va = L::area(smem, 1);
  stash_fragments<D, NT>(L::area(smem, 0), k + koff, HD, c0, Tk, tid);
  stash_fragments<D, NT>(L::area(smem, 1), v + koff, HD, c0, Tk, tid);
  RunningSum<D / 2, MS, NT> dk_sum(L::area(smem, 2), tid), dv_sum(L::area(smem, 3), tid);
  float db0 = 0.f, db1 = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % STAGES;
    const int rq0 = (t0 + it) * BQ;
    hopper::mbar_wait(&bars[s], (it / STAGES) & 1);
    const int r_last = min(rq0 + BQ - 1, Tq - 1);
    if (!causal || rq0 + off < 0 || kw0 <= r_last + off) {
      float st[BQ / 2], dpt[BQ / 2], t[D / 2];
      mma_tf32x3<BQ, D, CH>(
          st, [&](int kk, float (&r)[4]) { area_fragment(ka, kk, NT, tid, r); },
          L::tile_u32(smem, s, 0), L::tile_u32(smem, s, 1));
      mma_tf32x3<BQ, D, CH>(
          dpt, [&](int kk, float (&r)[4]) { area_fragment(va, kk, NT, tid, r); },
          L::tile_u32(smem, s, 2), L::tile_u32(smem, s, 3));
      const float* ls = L::stats(smem, s);
      if (causal && (rq0 + off < 0 || kw0 + 63 > rq0 + off))
        dkv_scores<true, BQ>(st, dpt, ls, ls + BQ, rq0, c0, c1, off, Tk, t4, scale_log2, bias0,
                             bias1, db0, db1);
      else
        dkv_scores<false, BQ>(st, dpt, ls, ls + BQ, rq0, c0, c1, off, Tk, t4, scale_log2, bias0,
                              bias1, db0, db1);
      mma_tf32x3<D, BQ, 8>(
          t, [&](int kk, float (&r)[4]) { acc_fragment(st, kk, r); }, L::tile_u32(smem, s, 6),
          L::tile_u32(smem, s, 7));
      dv_sum.add(t, 1.f, 1.f);
      mma_tf32x3<D, BQ, 8>(
          t, [&](int kk, float (&r)[4]) { acc_fragment(dpt, kk, r); }, L::tile_u32(smem, s, 4),
          L::tile_u32(smem, s, 5));
      dk_sum.add(t, 1.f, 1.f);
    }
    hopper::mbar_arrive(&bars[STAGES + s]);
  }

  db0 = hopper::quad_sum(db0);
  db1 = hopper::quad_sum(db1);
  if (t4 == 0) {
    float* dbb = dbias + ((long long)b * H + h) * Tk;
    if (c0 < Tk) dbb[c0] = db0;
    if (c1 < Tk) dbb[c1] = db1;
  }
  float acc[D / 2];
  dk_sum.load(acc);
  store_acc<D, false>(acc, scale, scale, dk + koff, HD, c0, Tk, t4);
  dv_sum.load(acc);
  store_acc<D, false>(acc, 1.f, 1.f, dv + koff, HD, c0, Tk, t4);
}

// ------------------------------------------------------------------ launches

// (NC consumer warpgroups, rows of a streamed tile, ring stages, running sums
// in shared memory) by head dim: within 227 KB of shared memory and the
// registers (chip_smoke.py prints ptxas's counts; 64-query dk/dv tiles at
// D 32 spilled)
template <int D>
struct Fwd {
  static constexpr int NC = 2, BK = D <= 32 ? 128 : D == 64 ? 64 : 16, STAGES = 2;
  static constexpr bool MS = D >= 128;
};
template <int D>
struct Dq {
  static constexpr int NC = D >= 128 ? 1 : 2, BK = D <= 32 ? 64 : 2048 / D, STAGES = 2;
  static constexpr bool MS = D >= 128;
};
template <int D>
struct Dkv {
  static constexpr int NC = D >= 128 ? 1 : 2, BQ = D <= 16 ? 64 : D >= 128 ? 16 : 32;
  static constexpr int STAGES = D >= 128 ? 1 : 2;
  static constexpr bool MS = D >= 128;
};

template <int D>
int launch_fwd(const void* q, const void* k, const void* v, const void* bias, void* o, void* lse,
               int B, int Tq, int Tk, int H, int causal, float scale, cudaStream_t s) {
  using C = Fwd<D>;
  constexpr int SMEM = Layout<D, C::NC, C::BK, C::STAGES, 4, 1 + C::MS>::SMEM;
  static bool done[hopper::kMaxDevices] = {};
  const auto kernel = flash_fwd_three_pass_kernel<D, C::NC, C::BK, C::STAGES, C::MS>;
  const int st = hopper::allow_dynamic_smem((const void*)kernel, SMEM, done);
  if (st != 0) return st;
  const dim3 grid((Tq + 64 * C::NC - 1) / (64 * C::NC), H, B);
  kernel<<<grid, 128 * (C::NC + 1), SMEM, s>>>((const float*)q, (const float*)k,
                                               (const float*)v, (const float*)bias, (float*)o,
                                               (float*)lse, Tq, Tk, H, causal,
                                               scale * hopper::kLog2e);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* bias, const void* dout,
              const void* lse, const void* delta, void* dq, int B, int Tq, int Tk, int H,
              int causal, float scale, cudaStream_t s) {
  using C = Dq<D>;
  constexpr int SMEM = Layout<D, C::NC, C::BK, C::STAGES, 6, 2 + C::MS>::SMEM;
  static bool done[hopper::kMaxDevices] = {};
  const auto kernel = flash_bwd_dq_three_pass_kernel<D, C::NC, C::BK, C::STAGES, C::MS>;
  const int st = hopper::allow_dynamic_smem((const void*)kernel, SMEM, done);
  if (st != 0) return st;
  const dim3 grid((Tq + 64 * C::NC - 1) / (64 * C::NC), H, B);
  kernel<<<grid, 128 * (C::NC + 1), SMEM, s>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)bias, (const float*)dout,
      (const float*)lse, (const float*)delta, (float*)dq, Tq, Tk, H, causal, scale,
      scale * hopper::kLog2e);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* bias, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv, void* dbias, int B,
               int Tq, int Tk, int H, int causal, float scale, cudaStream_t s) {
  using C = Dkv<D>;
  constexpr int SMEM = Layout<D, C::NC, C::BQ, C::STAGES, 8, 2 + 2 * C::MS>::SMEM;
  static bool done[hopper::kMaxDevices] = {};
  const auto kernel = flash_bwd_dkv_three_pass_kernel<D, C::NC, C::BQ, C::STAGES, C::MS>;
  const int st = hopper::allow_dynamic_smem((const void*)kernel, SMEM, done);
  if (st != 0) return st;
  const dim3 grid((Tk + 64 * C::NC - 1) / (64 * C::NC), H, B);
  kernel<<<grid, 128 * (C::NC + 1), SMEM, s>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)bias, (const float*)dout,
      (const float*)lse, (const float*)delta, (float*)dk, (float*)dv, (float*)dbias, Tq, Tk, H,
      causal, scale, scale * hopper::kLog2e);
  return (int)cudaGetLastError();
}

bool bad_shape(int B, int Tq, int Tk, int H) {
  return B <= 0 || Tq <= 0 || Tk <= 0 || H <= 0 || B > 65535 || H > 65535;
}

}  // namespace

// q (B, Tq, H*D), k/v (B, Tk, H*D) f32, bias (B, Tk) f32 additive or null,
// o like q, lse (B, H, Tq) f32 or null; D 16, 32, 64 or 128
extern "C" int vt_flash_attention_f32(const void* q, const void* k, const void* v,
                                      const void* bias, void* o, void* lse, int B, int Tq,
                                      int Tk, int H, int D, int causal, float scale,
                                      void* stream) {
  if (bad_shape(B, Tq, Tk, H)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 16:
      return launch_fwd<16>(q, k, v, bias, o, lse, B, Tq, Tk, H, causal, scale, s);
    case 32:
      return launch_fwd<32>(q, k, v, bias, o, lse, B, Tq, Tk, H, causal, scale, s);
    case 64:
      return launch_fwd<64>(q, k, v, bias, o, lse, B, Tq, Tk, H, causal, scale, s);
    case 128:
      return launch_fwd<128>(q, k, v, bias, o, lse, B, Tq, Tk, H, causal, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// q/dout/dq (B, Tq, H*D), k/v (B, Tk, H*D) f32, bias (B, Tk) f32 additive or
// null, lse/delta (B, H, Tq) f32
extern "C" int vt_flash_attention_bwd_dq_f32(const void* q, const void* k, const void* v,
                                             const void* bias, const void* dout,
                                             const void* lse, const void* delta, void* dq,
                                             int B, int Tq, int Tk, int H, int D, int causal,
                                             float scale, void* stream) {
  if (bad_shape(B, Tq, Tk, H)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 16:
      return launch_dq<16>(q, k, v, bias, dout, lse, delta, dq, B, Tq, Tk, H, causal, scale, s);
    case 32:
      return launch_dq<32>(q, k, v, bias, dout, lse, delta, dq, B, Tq, Tk, H, causal, scale, s);
    case 64:
      return launch_dq<64>(q, k, v, bias, dout, lse, delta, dq, B, Tq, Tk, H, causal, scale, s);
    case 128:
      return launch_dq<128>(q, k, v, bias, dout, lse, delta, dq, B, Tq, Tk, H, causal, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// as above; dk/dv (B, Tk, H*D), dbias (B, H, Tk) f32 per head
extern "C" int vt_flash_attention_bwd_dkv_f32(const void* q, const void* k, const void* v,
                                              const void* bias, const void* dout,
                                              const void* lse, const void* delta, void* dk,
                                              void* dv, void* dbias, int B, int Tq, int Tk,
                                              int H, int D, int causal, float scale,
                                              void* stream) {
  if (bad_shape(B, Tq, Tk, H)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 16:
      return launch_dkv<16>(q, k, v, bias, dout, lse, delta, dk, dv, dbias, B, Tq, Tk, H, causal,
                            scale, s);
    case 32:
      return launch_dkv<32>(q, k, v, bias, dout, lse, delta, dk, dv, dbias, B, Tq, Tk, H, causal,
                            scale, s);
    case 64:
      return launch_dkv<64>(q, k, v, bias, dout, lse, delta, dk, dv, dbias, B, Tq, Tk, H, causal,
                            scale, s);
    case 128:
      return launch_dkv<128>(q, k, v, bias, dout, lse, delta, dk, dv, dbias, B, Tq, Tk, H, causal,
                             scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
