// uint8 crop + ImageNet normalize, written for Hopper (sm_90a).
//
// Replaces: vilmedic_tpu/ops/image_preproc.py::_pallas_crop_normalize (its
// inner `kernel`), reached through `crop_normalize`.
//
// What bounds it on the H100: bytes. Each output value reads one byte and
// writes four (f32); at B 128, crop 224 the pass moves ~96 MB (~0.029 ms at
// 3.35 TB/s).
//
// Design:
//   - The arithmetic is a table: the output depends only on (channel, byte),
//     so each CTA first fills a 3 x 256 f32 table in shared memory, entry
//     (c, v) = (v * (1/255) - mean_c) / std_c, and then looks every byte up.
//     The table takes the plain version's IEEE ops as PyTorch runs them on
//     the card: dividing a CUDA tensor by a host scalar multiplies by the
//     scalar's f32 reciprocal, then a subtraction and a true division. So
//     the result is the plain version's to the bit, with 768 divides a CTA
//     in place of two per value.
//   - One CTA of 256 threads covers one image and a band of 8 output rows,
//     with 32-bit index math inside the image. Crop offsets are placed as
//     jax.lax.dynamic_slice places them (a negative offset counts from the
//     end, then the window is clamped into the image).
//   - Each cropped row's 3 * crop interleaved RGB bytes are staged in shared
//     memory with 16-byte loads of the aligned words that cover them (the
//     few bytes outside the span share those words, so no load leaves the
//     image's pages), whatever the offset's alignment.
//   - Each thread then takes 4 consecutive x of one output row, reads their
//     12 bytes from shared memory, and writes one float4 to each of the three
//     channel planes (NCHW, what conv2d reads); a warp writes 512 contiguous
//     bytes per plane. A crop that is not a multiple of 4 takes the scalar
//     tail path (its rows are not 16-byte aligned).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 8;         // output rows a CTA covers
constexpr int kTableWords = 3 * 256;

struct ChannelAffine {
  float mean[3];
  float std[3];
};

// bytes a staged row takes: the span, up to 15 bytes before it, rounded to 16
__host__ __device__ __forceinline__ int staged_row_bytes(int crop) {
  return (crop * 3 + 15 + 15) / 16 * 16;
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads)
    crop_normalize_kernel(const uint8_t* __restrict__ img, const int* __restrict__ tops,
                          const int* __restrict__ lefts, float* __restrict__ out, int R,
                          int crop, ChannelAffine ca) {
  extern __shared__ __align__(16) uint8_t sm[];
  float* tab = reinterpret_cast<float*>(sm);
  uint8_t* rows = sm + kTableWords * 4;
  const int b = blockIdx.y, y0 = blockIdx.x * kRows, tid = threadIdx.x;
  const int span = R - crop;
  int top = tops[b], left = lefts[b];
  top = min(max(top < 0 ? top + R : top, 0), span);
  left = min(max(left < 0 ? left + R : left, 0), span);
  const int row_bytes = staged_row_bytes(crop);
  const int nrows = min(kRows, crop - y0);
  const uint8_t* image = img + (size_t)b * R * R * 3;

  const float inv255 = __frcp_rn(255.0f);
  for (int i = tid; i < kTableWords; i += kThreads) {
    const int ch = i >> 8;
    tab[i] = __fdiv_rn(__fsub_rn(__fmul_rn((float)(i & 255), inv255), ca.mean[ch]), ca.std[ch]);
  }
  const int row_words = row_bytes / 16;
  for (int i = tid; i < nrows * row_words; i += kThreads) {
    const int rr = i / row_words, w = i % row_words;
    const uintptr_t src = reinterpret_cast<uintptr_t>(image + ((top + y0 + rr) * R + left) * 3);
    if (w < (int)((src & 15) + crop * 3 + 15) / 16)  // the words that hold the row's span
      reinterpret_cast<uint4*>(rows + rr * row_bytes)[w] =
          reinterpret_cast<const uint4*>(src & ~(uintptr_t)15)[w];
  }
  __syncthreads();

  const int groups = (crop + 3) / 4;
  const int plane = crop * crop;
  float* ob = out + (size_t)b * 3 * plane;
  for (int gi = tid; gi < nrows * groups; gi += kThreads) {
    const int rr = gi / groups, x = (gi % groups) * 4, y = y0 + rr;
    const int head = (int)(reinterpret_cast<uintptr_t>(image + ((top + y) * R + left) * 3) & 15);
    const uint8_t* px = rows + rr * row_bytes + head + x * 3;
    float v[3][4];
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int ch = 0; ch < 3; ++ch)
        v[ch][p] = (VEC || x + p < crop) ? tab[ch * 256 + px[3 * p + ch]] : 0.f;
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      float* o = ob + ch * plane + y * crop + x;
      if (VEC) {
        *reinterpret_cast<float4*>(o) = make_float4(v[ch][0], v[ch][1], v[ch][2], v[ch][3]);
      } else {
#pragma unroll
        for (int p = 0; p < 4; ++p)
          if (x + p < crop) o[p] = v[ch][p];
      }
    }
  }
}

}  // namespace

// img (B, R, R, 3) uint8, tops/lefts (B,) int32, out (B, 3, crop, crop) f32,
// 16-byte aligned; m0..m2 / s0..s2 the channels' mean and std
extern "C" int vt_crop_normalize(const void* img, const void* tops, const void* lefts,
                                 void* out, int B, int R, int crop, float m0, float m1,
                                 float m2, float s0, float s1, float s2, void* stream) {
  const ChannelAffine ca = {{m0, m1, m2}, {s0, s1, s2}};
  if (B <= 0 || B > 65535 || crop <= 0 || crop > R || (long long)R * R * 3 >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  const int smem = kTableWords * 4 + kRows * staged_row_bytes(crop);
  const dim3 grid((crop + kRows - 1) / kRows, B);
  const cudaStream_t s = (cudaStream_t)stream;
  const void* kernel = crop % 4 == 0 ? (const void*)crop_normalize_kernel<true>
                                     : (const void*)crop_normalize_kernel<false>;
  if (smem > 48 * 1024) {  // a crop of more than ~1900 columns
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  if (crop % 4 == 0)
    crop_normalize_kernel<true><<<grid, kThreads, smem, s>>>(
        (const uint8_t*)img, (const int*)tops, (const int*)lefts, (float*)out, R, crop, ca);
  else
    crop_normalize_kernel<false><<<grid, kThreads, smem, s>>>(
        (const uint8_t*)img, (const int*)tops, (const int*)lefts, (float*)out, R, crop, ca);
  return (int)cudaGetLastError();
}

extern "C" const char* vt_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}
