// Three-pass TF32 building blocks of the f32 flash kernels on Hopper's
// tensor cores (sm_90a), shared by flash_attention_f32.cu (head dims 16 to
// 128, one CTA a row block) and flash_attention_f32_split.cu (wider heads,
// the head dim split across a thread block cluster): the TF32 split of an
// f32 operand, register-A wgmma m64nNk8 products in three passes, the A
// fragments staged per thread, the producer warpgroup's cp.async landing and
// its split of a landed tile into hi / lo halves (direct, and transposed in
// kperm order), the running f32 sums, and the shared-memory layout of a
// kernel. flash_attention_f32.cu's header comment gives the design.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_common.cuh"

namespace tf32 {

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

// wait until at most N of this thread's cp.async groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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
// shared memory); XBYTES of exchange buffers (a split head's partial
// scores); the ring's mbarriers, then XBARS more. LANDS landing buffers of
// two tensors (produce's). Byte offsets from the 1024-aligned base.
template <int D, int NC, int BK, int STAGES, int SPLITS, int AREAS, int XBYTES = 0, int XBARS = 0,
          int LANDS = 1>
struct Layout {
  static constexpr int NT = 128 * NC;  // consumer threads
  static constexpr int TILE = BK * D * 4;
  static constexpr int STAGE = SPLITS * TILE + align1k(2 * BK * 4);
  static constexpr int LAND = align1k(BK * (D + 4) * 4);  // one landed tensor
  static constexpr int LANDED = STAGES * STAGE;
  static constexpr int AREA = LANDED + 2 * LANDS * LAND;
  static constexpr int X = AREA + AREAS * (D / 8) * NT * 16;
  static constexpr int BAR = X + XBYTES;  // full[STAGES], empty[STAGES], then XBARS
  static constexpr int SMEM = BAR + (2 * STAGES + XBARS) * 8 + 1024;  // + alignment slack
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
  __device__ static float* xbuf(uint8_t* smem) { return reinterpret_cast<float*>(smem + X); }
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
// it's cp.async copies into landing buffer it % LANDS, fill(s, it) splits
// the landed tile into stage s. Tile it + LANDS is issued once tile it is
// split: with one buffer, tile it + 1 is copied while the consumers work on
// tile it; with more, the copies of the next tiles are in flight while the
// producer splits (one cp.async group a tile, empty past the last).
template <int STAGES, int LANDS = 1, typename Land, typename Fill>
__device__ __forceinline__ void produce(uint64_t* bars, int n_tiles, Land land, Fill fill) {
  for (int it = 0; it < LANDS; ++it) {
    if (it < n_tiles) land(it);
    cp_async_commit();
  }
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % STAGES;
    cp_async_wait<LANDS - 1>();
    hopper::named_sync(1, 128);  // tile it has landed, every producer thread's copies
    hopper::mbar_wait(&bars[STAGES + s], ((it / STAGES) & 1) ^ 1);  // stage s is free
    fill(s, it);
    hopper::fence_proxy_async();  // the split tiles, for the consumers' wgmma
    hopper::mbar_arrive(&bars[s]);
    hopper::named_sync(1, 128);  // every producer thread has read the landing buffer
    if (it + LANDS < n_tiles) land(it + LANDS);
    cp_async_commit();
  }
}

}  // namespace tf32
