// fp8 (e4m3) cache probes, written for Hopper (sm_90a): the three questions
// the JAX package's fp8 spike asked of the TPU, asked of this card.
//
// Replaces: experiments/spike_fp8_cache.py::main's three Pallas kernels:
//   (a) `kernel` (:26): e4m3 -> f32, times 2, -> e4m3 (any f32 factor here,
//       so that a test can land on the rounding edge: 8 * 58 = 464);
//   (b) `mm_kernel` (:47): a product of two e4m3 matrices with f32
//       accumulation (the TPU widened them to bf16 for its MXU);
//   (c) `dma_kernel` (:72): an asynchronous copy of the first rows of an e4m3
//       slab from device memory to fast memory, then -> f32.
//
// What bounds them on the H100: nothing but latency. At the spike's shapes
// (a 128 x 256 slab, 128 x 128 x 128 product, 8 rows of 256) each moves
// under 100 KB; a launch costs more than the bytes. They are probes that
// the card converts, multiplies and copies fp8 as the port expects, not
// kernels on a hot path.
//
// Design:
//   - e4m3 -> f32 is the bit-level widening PyTorch uses
//     (c10::detail::fp8e4m3fn_to_fp32_value), so a converted NaN keeps the
//     plain version's bits. f32 -> e4m3 is CUDA's
//     __nv_cvt_float_to_fp8(x, __NV_NOSAT, __NV_E4M3): round to nearest
//     even, and a value beyond 464 (448 plus half a step), or an infinity,
//     becomes NaN (0x7F with the sign), as ml_dtypes does. (PyTorch's own
//     cast saturates to 448 instead.)
//   - (b) runs on the fp8 tensor cores, which the TPU lacked:
//     `mma.sync.aligned.m16n8k32.row.col.f32.e4m3.e4m3.f32`, one warp per
//     16 x 8 output tile, A read row-major and B (K, N) gathered into the
//     column-major fragment four bytes at a time.
//   - (c) is one TMA bulk copy (`cp.async.bulk`, completing on an
//     `mbarrier`) of the rows' contiguous bytes into shared memory, then
//     every thread widens its values to f32.

#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float e4m3_to_f32(uint8_t v) {
  const uint32_t w = (uint32_t)v << 24;
  const uint32_t sign = w & 0x80000000u;
  const uint32_t nonsign = w & 0x7FFFFFFFu;
  uint32_t renorm = __clz(nonsign);
  renorm = renorm > 4 ? renorm - 4 : 0;
  const int32_t inf_nan_mask = ((int32_t)(nonsign + 0x01000000u) >> 8) & 0x7F800000;
  const int32_t zero_mask = (int32_t)(nonsign - 1) >> 31;
  const uint32_t bits =
      sign | ((((nonsign << renorm >> 4) + ((0x78u - renorm) << 23)) | (uint32_t)inf_nan_mask) &
              ~(uint32_t)zero_mask);
  return __uint_as_float(bits);
}

__device__ __forceinline__ uint8_t f32_to_e4m3(float x) {
  return (uint8_t)__nv_cvt_float_to_fp8(x, __NV_NOSAT, __NV_E4M3);
}

__global__ void fp8_scale2_kernel(const uint8_t* __restrict__ x, uint8_t* __restrict__ out,
                                  int n, float scale) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = f32_to_e4m3(e4m3_to_f32(x[i]) * scale);
}

// A (M, K) and B (K, N) e4m3, row-major; out (M, N) f32. M % 16, N % 8,
// K % 32 == 0. Warp `tile` computes rows 16 * (tile / (N / 8)) and columns
// 8 * (tile % (N / 8)).
__global__ void fp8_matmul_kernel(const uint8_t* __restrict__ a, const uint8_t* __restrict__ b,
                                  float* __restrict__ out, int M, int N, int K) {
  const int lane = threadIdx.x % 32;
  const int tile = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  if (tile >= (M / 16) * (N / 8)) return;
  const int m0 = (tile / (N / 8)) * 16;
  const int n0 = (tile % (N / 8)) * 8;
  const int g = lane / 4, t = lane % 4;
  float d0 = 0.f, d1 = 0.f, d2 = 0.f, d3 = 0.f;
  for (int k0 = 0; k0 < K; k0 += 32) {
    const uint8_t* ar = a + (long long)(m0 + g) * K + k0 + t * 4;
    const uint32_t a0 = *reinterpret_cast<const uint32_t*>(ar);
    const uint32_t a1 = *reinterpret_cast<const uint32_t*>(ar + 8 * K);
    const uint32_t a2 = *reinterpret_cast<const uint32_t*>(ar + 16);
    const uint32_t a3 = *reinterpret_cast<const uint32_t*>(ar + 8 * K + 16);
    uint32_t b0 = 0, b1 = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      b0 |= (uint32_t)b[(long long)(k0 + t * 4 + j) * N + n0 + g] << (8 * j);
      b1 |= (uint32_t)b[(long long)(k0 + 16 + t * 4 + j) * N + n0 + g] << (8 * j);
    }
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.f32.e4m3.e4m3.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d0), "+f"(d1), "+f"(d2), "+f"(d3)
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
  }
  float* o = out + (long long)(m0 + g) * N + n0 + t * 2;
  o[0] = d0;
  o[1] = d1;
  o[8 * N] = d2;
  o[8 * N + 1] = d3;
}

// the first `nbytes` bytes of x (whole rows) -> shared memory by one bulk
// copy -> f32 out
__global__ void fp8_slab_copy_kernel(const uint8_t* __restrict__ x, float* __restrict__ out,
                                     int nbytes) {
  extern __shared__ __align__(128) uint8_t slab[];
  __shared__ __align__(8) uint64_t bar;
  const uint32_t bar_addr = (uint32_t)__cvta_generic_to_shared(&bar);
  const uint32_t dst = (uint32_t)__cvta_generic_to_shared(slab);
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar_addr) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar_addr),
                 "r"(nbytes)
                 : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
        "[%3];\n" ::"r"(dst),
        "l"(x), "r"(nbytes), "r"(bar_addr)
        : "memory");
  }
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar_addr)
        : "memory");
  }
  for (int i = threadIdx.x; i < nbytes; i += blockDim.x) out[i] = e4m3_to_f32(slab[i]);
}

}  // namespace

extern "C" int vt_fp8_scale2(const void* x, void* out, int n, float scale, void* stream) {
  const int threads = 256;
  fp8_scale2_kernel<<<(n + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)x, (uint8_t*)out, n, scale);
  return (int)cudaGetLastError();
}

extern "C" int vt_fp8_matmul(const void* a, const void* b, void* out, int M, int N, int K,
                             void* stream) {
  const int warps = 4;
  const int tiles = (M / 16) * (N / 8);
  fp8_matmul_kernel<<<(tiles + warps - 1) / warps, warps * 32, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)a, (const uint8_t*)b, (float*)out, M, N, K);
  return (int)cudaGetLastError();
}

// nbytes: a multiple of 16, at most kMaxSlab. The static mbarrier and the
// slab's 128-byte alignment take shared memory beside it, past the 48 KB a
// block has by default at the cap, so the kernel opts in once.
constexpr int kMaxSlab = 48 * 1024;

extern "C" int vt_fp8_slab_copy(const void* x, void* out, int nbytes, void* stream) {
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        fp8_slab_copy_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSlab);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  fp8_slab_copy_kernel<<<1, 256, nbytes, (cudaStream_t)stream>>>((const uint8_t*)x,
                                                                 (float*)out, nbytes);
  return (int)cudaGetLastError();
}
