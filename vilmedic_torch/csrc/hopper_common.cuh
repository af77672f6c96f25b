// Hopper (sm_90a) building blocks shared by the flash-attention kernels
// (flash_attention.cu, K4, flash_attention_bwd.cu, K5, and their wide-head
// counterparts in flash_attention_wide_tc.cu and flash_attention_gemm.cu),
// the LM heads
// (blocked_lm_head.cu, K2, and fused_lm_head.cu, K6) and the beam-cache
// attention (beam_cache_attention.cu, K1): mbarriers, TMA
// tile loads through tensor maps, cluster ranks and distributed shared
// memory, wgmma shared-memory descriptors and the wgmma instructions
// themselves, warp-specialisation helpers, and the host side that encodes a
// tensor map.
//
// Layout conventions (the tiles both kernels stage):
//   - A tile is R rows of one head, D bf16 columns, loaded by TMA from the
//     (B, T, H, D) tensor through a 4-D tensor map, so a box past T reads
//     zeros and never the next item's rows. The tile is stored as D / CW
//     chunks of CW columns (CW = 64, or D below 64); chunk c holds rows of
//     SW = 2 * CW bytes at c * R * SW, swizzled by TMA with the SW-byte
//     pattern (128B; 64B at D 32, 32B at D 16). Every chunk starts on a
//     multiple of the pattern's period (8 * SW bytes).
//   - Read as a K-major wgmma operand (the product's depth runs along D):
//     8-row groups SW * 8 bytes apart (SBO); a 16-column k-step moves the
//     start address by 32 bytes inside the swizzled row (desc_k).
//   - Read as an MN-major operand (the depth runs along the rows, as V in
//     P V): a 16-row k-step moves the start by 16 rows; the chunks are the
//     N blocks, R * SW bytes apart (LBO); 8-row groups again SBO apart
//     (desc_mn).
//   - The wgmma accumulator of a warpgroup's m64nN product gives warp w rows
//     16w + g and 16w + g + 8 (g = lane / 4) and, in each 8-column chunk j,
//     columns 8j + 2 (lane % 4) + {0, 1}: d[4j + 0, 1] on the first row,
//     d[4j + 2, 3] on the second, as mma.sync's m16n8 fragment. The
//     register A operand of m64nNk16 has mma.sync's m16n8k16 A layout, so a
//     score accumulator packs into it without a shuffle (pack_a).

#pragma once

#include <cuda.h>  // CUtensorMap and its enums: types only, libcuda is not linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace hopper {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// ------------------------------------------------------------ shared memory

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// the dynamic shared memory's base, rounded up to 1024 bytes (the 128-byte
// swizzle repeats every 1024; launches ask for 1024 bytes more)
__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  const uint32_t a = smem_u32(p);
  return p + (((a + 1023u) & ~1023u) - a);
}

// -------------------------------------------------------------- mbarriers

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t addr, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(addr), "r"(parity)
      : "memory");
  return done != 0;
}

// the same, acquiring at cluster scope: for arrivals from other CTAs of the
// cluster (mbar_arrive_remote) whose writes the waiter then reads
__device__ __forceinline__ bool mbar_try_wait_cluster(uint32_t addr, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n .reg .pred p;\n mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(addr), "r"(parity)
      : "memory");
  return done != 0;
}

// wait until the phase of parity `parity` has completed (CLUSTER: acquire
// at cluster scope). A wait still open after ~2^34 cycles (seconds) traps:
// a launch error, not a hung card.
template <bool CLUSTER = false>
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  auto ready = [&] {
    return CLUSTER ? mbar_try_wait_cluster(addr, parity) : mbar_try_wait(addr, parity);
  };
  if (ready()) return;
  const long long start = clock64();
  while (!ready())
    if (clock64() - start > (1ll << 34)) __trap();
}

// ------------------------------------------------------------------- TMA

// one box of a 4-D tensor map (coordinates innermost first) into shared
// memory, completing `bytes` on `bar`
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, int c3, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(smem_u32(bar))
      : "memory");
}

// one box of a 2-D tensor map (coordinates innermost first)
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}

// order this thread's earlier async-proxy accesses (TMA, wgmma) of shared
// memory before its later generic ones
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---------------------------------------------------------------- clusters

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t cluster_size() {
  uint32_t n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(n));
  return n;
}

// every thread of every CTA of the cluster (release, then acquire)
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.aligned;\nbarrier.cluster.wait.aligned;\n" ::: "memory");
}

// the shared::cluster address of `p` (in this CTA's shared memory) in CTA
// `rank` of the cluster: the same offset in that CTA's shared memory
__device__ __forceinline__ uint32_t map_rank(const void* p, uint32_t rank) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(a) : "r"(smem_u32(p)), "r"(rank));
  return a;
}

// arrive on an mbarrier of another CTA of the cluster (map_rank address),
// releasing this thread's earlier memory accesses at cluster scope
__device__ __forceinline__ void mbar_arrive_remote(uint32_t bar) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// 16 bytes into another CTA's shared memory (map_rank address), completing
// 16 bytes of transaction count on that CTA's mbarrier `bar` (map_rank)
__device__ __forceinline__ void st_async_f4(uint32_t addr, float4 v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, [%5];\n"
      ::"r"(addr), "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(bar)
      : "memory");
}

__device__ __forceinline__ float4 ld_cluster_f4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

// ------------------------------------------------------ warp specialisation

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// a barrier over the 128 threads of one warpgroup (ids 1.. ; 0 is __syncthreads)
__device__ __forceinline__ void warpgroup_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// a named barrier over `n` threads (ids 1.. ; 0 is __syncthreads): some
// threads arrive without waiting, the others wait for all `n`
__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void named_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// ------------------------------------------------------------------ math

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// the register A operand (k-step kc of 16 columns) of a wgmma from an m64nN
// f32 accumulator, rounded to bf16
template <int NREG>
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&d)[NREG], int kc) {
  a[0] = pack_bf16x2(d[8 * kc + 0], d[8 * kc + 1]);
  a[1] = pack_bf16x2(d[8 * kc + 2], d[8 * kc + 3]);
  a[2] = pack_bf16x2(d[8 * kc + 4], d[8 * kc + 5]);
  a[3] = pack_bf16x2(d[8 * kc + 6], d[8 * kc + 7]);
}

// quad (the 4 lanes sharing an accumulator row) reductions
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ----------------------------------------------------------------- wgmma

template <int D>
struct Tile {
  static constexpr int CW = D < 64 ? D : 64;  // columns per swizzled chunk
  static constexpr int SW = CW * 2;           // bytes per chunk row: the swizzle span
  static constexpr int NCH = D / CW;          // chunks per row
  // descriptor layout type: 1 = 128B, 2 = 64B, 3 = 32B swizzle
  static constexpr uint64_t MODE = SW == 128 ? 1 : SW == 64 ? 2 : 3;
  static_assert(D == 16 || D == 32 || (D % 64 == 0 && D <= 512),
                "head dim 16, 32 or a multiple of 64 up to 512");
};

__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint64_t mode) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFFu) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFFu) << 32) | (mode << 62);
}

// a tile of `rows` rows at shared address `base`, read K-major from row r0
// (a multiple of 8) at the k-step kk of 16 columns
template <int D>
__device__ __forceinline__ uint64_t desc_k(uint32_t base, int rows, int r0, int kk) {
  using G = Tile<D>;
  const int col = kk * 16;
  return make_desc(base + (col / G::CW) * rows * G::SW + r0 * G::SW + (col % G::CW) * 2, 16,
                   8 * G::SW, G::MODE);
}

// the same tile read MN-major (depth along the rows) at the k-step kk of 16 rows
template <int D>
__device__ __forceinline__ uint64_t desc_mn(uint32_t base, int rows, int kk) {
  using G = Tile<D>;
  return make_desc(base + kk * 16 * G::SW, rows * G::SW, 8 * G::SW, G::MODE);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// wait until at most one committed group of wgmma products is in flight
__device__ __forceinline__ void wgmma_wait_one() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

// keep the compiler from moving accesses of an accumulator across the
// asynchronous wgmma (call after wgmma_wait_all, and before the products start)
template <int N>
__device__ __forceinline__ void fence_operand(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (m64nN, f32) (+)= A (m64k16 bf16, shared, K-major) * B (k16nN bf16,
// shared, K-major); scale_d 0 overwrites D
__device__ __forceinline__ void wgmma_ss_n16(float (&d)[8], uint64_t desc_a, uint64_t desc_b,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t desc_a, uint64_t desc_b,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D (m64n128, f32) (+)= A (m64k16 bf16, shared, K-major) * B (k16n128
// bf16, shared, MN-major: the N columns contiguous, read through desc_mn)
__device__ __forceinline__ void wgmma_ss_n128_mn(float (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                                 int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D (m64nN, f32) (+)= A (m64k16 bf16, registers, pack_a) * B (k16nN bf16,
// shared, MN-major); scale_d 0 overwrites D
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8], const uint32_t (&a)[4],
                                             uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4],
                                             uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                             uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
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


// the products by N: S-type (both operands in shared memory) and P-type (A
// in registers, B in shared memory MN-major)
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a, uint64_t b, int scale_d) {
  if constexpr (N == 16) wgmma_ss_n16(d, a, b, scale_d);
  else if constexpr (N == 32) wgmma_ss_n32(d, a, b, scale_d);
  else if constexpr (N == 64) wgmma_ss_n64(d, a, b, scale_d);
  else wgmma_ss_n128(d, a, b, scale_d);
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b,
                                         int scale_d) {
  if constexpr (N == 16) wgmma_rs_n16(d, a, b, scale_d);
  else if constexpr (N == 32) wgmma_rs_n32(d, a, b, scale_d);
  else if constexpr (N == 64) wgmma_rs_n64(d, a, b, scale_d);
  else {
    static_assert(N == 128, "wgmma_rs: N 16 to 128 (wider: flash_attention_wide_tc.cu)");
    wgmma_rs_n128(d, a, b, scale_d);
  }
}

// ------------------------------------------------- warp-specialised ring

// The barriers of a CTA whose producer warp feeds a STAGES-deep ring:
// bars[0] completes when the resident tiles have landed; bars[1 + s] (full)
// when stage s's tiles have landed and the producer warp has written its
// per-row values; bars[1 + STAGES + s] (empty) when all `consumers` threads
// have released stage s.
template <int STAGES>
__device__ __forceinline__ void init_ring(uint64_t* bars, int consumers) {
  if (threadIdx.x == 0) {
    mbar_init(&bars[0], 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&bars[1 + s], 2);  // the TMA bytes + the producer warp's values
      mbar_init(&bars[1 + STAGES + s], consumers);
    }
    fence_barrier_init();
  }
  __syncthreads();
}

// The producer warp: the resident tiles (ta, and tb unless null) of RES rows
// from row `res_row`, once; then for each of `n_tiles` ring tiles the pair
// (tc, td) of ROWS rows from row (t0 + it) * ROWS into stage it % STAGES,
// with `stats(stage, first row, lane)` writing that tile's per-row values
// beside it. Shared-memory offsets are bytes; stage s of a ring tensor sits
// s * ROWS * D * 2 bytes past its offset. Each tile holds the D columns of
// a head row from column `col0` (a CTA that holds part of a wider head).
template <int D, int STAGES, int RES, int ROWS, typename Stats>
__device__ __forceinline__ void ring_producer(uint8_t* smem, uint64_t* bars, const CUtensorMap* ta,
                                              int off_a, const CUtensorMap* tb, int off_b,
                                              const CUtensorMap* tc, int off_c,
                                              const CUtensorMap* td, int off_d, int res_row,
                                              int t0, int n_tiles, int h, int b, Stats stats,
                                              int col0 = 0) {
  using G = Tile<D>;
  const int lane = threadIdx.x % 32;
  if (lane == 0) {
    mbar_arrive_expect_tx(&bars[0], (tb != nullptr ? 2 : 1) * RES * D * 2);
#pragma unroll
    for (int c = 0; c < G::NCH; ++c) {
      tma_load_4d(smem + off_a + c * RES * G::SW, ta, col0 + c * G::CW, h, res_row, b, &bars[0]);
      if (tb != nullptr)
        tma_load_4d(smem + off_b + c * RES * G::SW, tb, col0 + c * G::CW, h, res_row, b,
                    &bars[0]);
    }
  }
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % STAGES;
    uint64_t* full = &bars[1 + s];
    mbar_wait(&bars[1 + STAGES + s], ((it / STAGES) & 1) ^ 1);  // the stage is free
    const int r0 = (t0 + it) * ROWS;
    if (lane == 0) {
      mbar_arrive_expect_tx(full, 2 * ROWS * D * 2);
#pragma unroll
      for (int c = 0; c < G::NCH; ++c) {
        const int dst = s * ROWS * D * 2 + c * ROWS * G::SW;
        tma_load_4d(smem + off_c + dst, tc, col0 + c * G::CW, h, r0, b, full);
        tma_load_4d(smem + off_d + dst, td, col0 + c * G::CW, h, r0, b, full);
      }
    }
    stats(s, r0, lane);
    __syncwarp();
    if (lane == 0) mbar_arrive(full);  // the per-row values are written
  }
}

// the key bias of keys [k0, k0 + n) of item b, times log2(e) (0 without a
// bias), -inf past Tk so that a ragged tile's missing keys weigh nothing;
// written by the 32 lanes of a warp
__device__ __forceinline__ void key_bias_log2(float* dst, const float* bias, int b, int Tk, int k0,
                                              int n, int lane) {
  for (int j = lane; j < n; j += 32) {
    const int c = k0 + j;
    dst[j] = c >= Tk ? -INFINITY : (bias != nullptr ? bias[(long long)b * Tk + c] * kLog2e : 0.f);
  }
}

// ------------------------------------------------------------ epilogue

// A consumer warpgroup's m64nD f32 accumulator, its row g times f0 and row
// g + 8 times f1, rounded to bf16 and written to `n_rows` (at most 64) rows
// of a (T, H, D) tensor from `dst` (this head's element of the first row;
// rows `row_stride` elements apart). The rows are staged through the
// warpgroup's own 64 rows (from tile_row0) of a shared tile of `tile_rows`
// rows laid out as Tile<D> chunks, with a bank-spreading XOR of their
// 16-byte units, then leave with 16-byte stores. The tile's earlier readers
// (TMA, wgmma) must be done; `barrier_id` names the warpgroup's barrier.
template <int D>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 2], float f0, float f1,
                                           uint8_t* tile, int tile_rows, int tile_row0,
                                           __nv_bfloat16* dst, long long row_stride, int n_rows,
                                           int barrier_id) {
  using G = Tile<D>;
  constexpr int UNITS = G::CW / 8;  // 16-byte units per chunk row
  const int tw = threadIdx.x % 128;
  const int g = (tw % 32) / 4;
  const int t4 = tw % 4;
  fence_proxy_async();
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = 8 * j + 2 * t4;
    const int cc = col % G::CW;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int rl = (tw / 32) * 16 + g + 8 * half;
      const float f = half ? f1 : f0;
      uint8_t* at = tile + (col / G::CW) * tile_rows * G::SW + (tile_row0 + rl) * G::SW +
                    (((cc / 8) ^ (rl & (UNITS - 1))) * 16) + (cc % 8) * 2;
      *reinterpret_cast<uint32_t*>(at) =
          pack_bf16x2(acc[4 * j + 2 * half] * f, acc[4 * j + 2 * half + 1] * f);
    }
  }
  warpgroup_sync(barrier_id);
  for (int i = tw; i < 64 * (D / 8); i += 128) {
    const int rl = i / (D / 8);
    const int uu = i % (D / 8);
    if (rl >= n_rows) break;
    const uint8_t* at = tile + (uu / UNITS) * tile_rows * G::SW + (tile_row0 + rl) * G::SW +
                        (((uu % UNITS) ^ (rl & (UNITS - 1))) * 16);
    *reinterpret_cast<uint4*>(dst + rl * row_stride + uu * 8) =
        *reinterpret_cast<const uint4*>(at);
  }
}

// --------------------------------------------------------------- host side

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, found through the runtime's entry-point query so
// that the library need not link libcuda
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t st =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
    return (st == cudaSuccess && found == cudaDriverEntryPointSuccess) ? (EncodeTiledFn)p
                                                                       : nullptr;
  }();
  return fn;
}

constexpr int kMaxDevices = 64;

// Let `kernel` take `bytes` of dynamic shared memory on the current device,
// once per kernel and device (`done`, the caller's static flags), not on
// every launch.
inline int allow_dynamic_smem(const void* kernel, int bytes, bool (&done)[kMaxDevices]) {
  int dev = 0;
  cudaError_t st = cudaGetDevice(&dev);
  if (st != cudaSuccess) return (int)st;
  if (dev < kMaxDevices && done[dev]) return 0;
  st = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (st == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return (int)st;
}

// a tensor map over a (B, T, H, width) bf16 tensor (width D unless given:
// a CTA that holds D of a wider head's columns) whose box is one chunk of
// `rows` rows of one head (Tile<D>), swizzled as the wgmma descriptors read
// it; rows past T read as zeros. Returns a cudaError_t.
template <int D>
inline int make_tensor_map(CUtensorMap* map, const void* ptr, int B, int T, int H, int rows,
                           int width = D) {
  using G = Tile<D>;
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  const cuuint64_t dims[4] = {(cuuint64_t)width, (cuuint64_t)H, (cuuint64_t)T, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)width * 2, (cuuint64_t)H * width * 2,
                                 (cuuint64_t)T * H * width * 2};
  const cuuint32_t box[4] = {(cuuint32_t)G::CW, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
                            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            G::SW == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                            : G::SW == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                          : CU_TENSOR_MAP_SWIZZLE_32B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// a tensor map over a (rows, K) row-major bf16 matrix whose box is 64
// columns of `box_rows` rows, swizzled 128B as desc_k<64> reads it; boxes
// past either edge read zeros. Returns a cudaError_t.
inline int make_matrix_map(CUtensorMap* map, const void* ptr, int rows, int K, int box_rows) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)K * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr),
                            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// make_matrix_map's maps, encoded once per (pointer, shape, box, device):
// an LM head's weight lives for a whole generate and the hidden states'
// buffer is usually reused step to step. A kernel source keeps one cache
// per operand.
struct MapCache {
  static constexpr int kSlots = 8;
  struct Slot {
    const void* ptr;
    int rows, K, box_rows, dev;
    CUtensorMap map;
  } slots[kSlots] = {};
  int next = 0;

  int get(const CUtensorMap** out, const void* ptr, int rows, int K, int box_rows) {
    int dev = 0;
    const cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    for (Slot& s : slots)
      if (s.ptr == ptr && s.rows == rows && s.K == K && s.box_rows == box_rows && s.dev == dev) {
        *out = &s.map;
        return 0;
      }
    Slot& s = slots[next];
    next = (next + 1) % kSlots;
    s.ptr = nullptr;
    const int st = make_matrix_map(&s.map, ptr, rows, K, box_rows);
    if (st != 0) return st;
    s.ptr = ptr;
    s.rows = rows;
    s.K = K;
    s.box_rows = box_rows;
    s.dev = dev;
    *out = &s.map;
    return 0;
  }
};

// the current device's number of SMs (cached per device)
inline int sm_count() {
  static int sms[kMaxDevices] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (dev >= kMaxDevices) {
    int n = 0;
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n;
  }
  if (sms[dev] == 0) cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
  return sms[dev];
}

}  // namespace hopper
