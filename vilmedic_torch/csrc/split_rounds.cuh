// The rounds of a head dim split across a thread block cluster, shared by
// flash_attention_wide_tc.cu (bf16) and flash_attention_f32_split.cu (f32):
// n CTAs (2 to kMaxSplit, launched as one cluster along x) share a block of
// kRows rows, each holding its own columns of the head, and each score tile
// is a round in which every CTA's partial tile is summed over the cluster
// so that every CTA holds the same bits. Two mechanisms, each where it was
// measured faster: flash_attention_wide_tc.cu's (a pair pushes its partial
// into the other CTA by st.async; from 3 CTAs each writes its own and
// reads the others' through distributed shared memory, summing in rank
// order: that file's header comment says why) and flash_attention_f32_
// split.cu's (a reduce-scatter, then an all-gather, both pushed; below). A
// round is taken by one warpgroup of kGroup threads in each CTA.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_common.cuh"

namespace rounds {

constexpr int kRows = 64;      // rows a cluster's CTAs share (queries; keys for dk/dv)
constexpr int kGroup = 128;    // threads of a warpgroup
constexpr int kMaxSplit = 16;  // CTAs of a cluster (above 8: non-portable)

// Init `count` barriers from bars[first], each expecting `arrivals`; thread
// 0, before init_ring (whose fence and barrier then cover them).
__device__ __forceinline__ void init_barriers(uint64_t* bars, int first, int count,
                                              uint32_t arrivals) {
  if (threadIdx.x == 0)
    for (int i = 0; i < count; ++i) hopper::mbar_init(&bars[first + i], arrivals);
}

// This thread's part of a warpgroup's partial tile (an m64nN accumulator,
// NREG = N / 2 floats) into `slot`: float4 i of thread tw at
// (i * 128 + tw) * 4, so a warp writes, and reads, 512 contiguous bytes.
template <int NREG>
__device__ __forceinline__ void put_partial(const float (&x)[NREG], float* slot, int tw) {
#pragma unroll
  for (int i = 0; i < NREG / 4; ++i)
    *reinterpret_cast<float4*>(slot + (i * 128 + tw) * 4) =
        make_float4(x[4 * i], x[4 * i + 1], x[4 * i + 2], x[4 * i + 3]);
}

// Arrive on the barrier at `bar`'s offset in every other CTA of the cluster
// (each expects (n - 1) * its threads' arrivals a round).
__device__ __forceinline__ void publish(uint64_t* bar, uint32_t n, uint32_t rank) {
  for (uint32_t r = 0; r < n; ++r)
    if (r != rank) hopper::mbar_arrive_remote(hopper::map_rank(bar, r));
}

// x = the sum of the n CTAs' partial tiles at `slot`'s offset, in rank order
// (the same values in the same order in every CTA: the same bits).
template <int NREG>
__device__ __forceinline__ void sum_partials(float (&x)[NREG], const float* slot, uint32_t n,
                                             int tw) {
  for (uint32_t r = 0; r < n; ++r) {
    const uint32_t at = hopper::map_rank(slot, r) + tw * 16;
#pragma unroll
    for (int i = 0; i < NREG / 4; ++i) {
      const float4 v = hopper::ld_cluster_f4(at + i * 128 * 16);
      x[4 * i + 0] = r == 0 ? v.x : x[4 * i + 0] + v.x;
      x[4 * i + 1] = r == 0 ? v.y : x[4 * i + 1] + v.y;
      x[4 * i + 2] = r == 0 ? v.z : x[4 * i + 2] + v.z;
      x[4 * i + 3] = r == 0 ? v.w : x[4 * i + 3] + v.w;
    }
  }
}

// A round's barrier (one per partial buffer) expects, each round: a pair
// (n 2) pushes its partial into the other CTA's buffer by st.async, which
// completes transaction bytes on that CTA's barrier, armed by one local
// arrival; from 3 CTAs each CTA's partial stays in its own buffer and every
// thread of the others' warpgroups arrives once it is written.
__device__ __forceinline__ uint32_t round_arrivals(uint32_t n) {
  return n == 2 ? 1 : (n - 1) * kGroup;
}

// one partial tile (NREG floats a thread) into the other CTA of a pair by
// st.async: float4 i of thread tw at `at` (its address there) + i * 2048
template <int NREG>
__device__ __forceinline__ void push_tile(const float (&x)[NREG], uint32_t at, uint32_t rbar) {
#pragma unroll
  for (int i = 0; i < NREG / 4; ++i)
    hopper::st_async_f4(at + i * 128 * 16,
                        make_float4(x[4 * i], x[4 * i + 1], x[4 * i + 2], x[4 * i + 3]), rbar);
}

// x += the partial tile at `slot` in this CTA's shared memory
template <int NREG>
__device__ __forceinline__ void add_local(float (&x)[NREG], const float* slot, int tw) {
#pragma unroll
  for (int i = 0; i < NREG / 4; ++i) {
    const float4 v = *reinterpret_cast<const float4*>(slot + (i * 128 + tw) * 4);
    x[4 * i + 0] += v.x;
    x[4 * i + 1] += v.y;
    x[4 * i + 2] += v.z;
    x[4 * i + 3] += v.w;
  }
}

// Send this warpgroup's partial tiles (one or two) of round `round`
// (counting from 0), one after the other in buffer round % 2 of `slots`:
// pushed into the other CTA's buffer (n 2), or written to this CTA's and
// announced on the round's barrier of every other CTA.
template <typename... Tiles>
__device__ __forceinline__ void send_partial(float* slots, uint64_t* bars, int round, uint32_t n,
                                             uint32_t rank, int tw, const Tiles&... tiles) {
  constexpr int floats = ((sizeof(Tiles) / 4) + ...);  // a thread's, over the tiles
  float* slot = slots + (round & 1) * 128 * floats;
  uint64_t* bar = &bars[round & 1];
  if (n == 2) {
    if (tw == 0) hopper::mbar_arrive_expect_tx(bar, 128 * floats * 4);  // the other's partial
    uint32_t at = hopper::map_rank(slot, rank ^ 1) + tw * 16;
    const uint32_t rbar = hopper::map_rank(bar, rank ^ 1);
    ((push_tile(tiles, at, rbar), at += 128 * sizeof(Tiles)), ...);
  } else {
    ((put_partial(tiles, slot, tw), slot += 128 * (sizeof(Tiles) / 4)), ...);
    publish(bar, n, rank);
  }
}

// Once every CTA has sent round `round`: the tiles = the sum of the
// cluster's partials, in place. A pair adds the other's partial to its own
// (own + other is other + own: both CTAs get the same bits); from 3 CTAs the
// partials are summed in rank order.
template <typename... Tiles>
__device__ __forceinline__ void sum_round(const float* slots, uint64_t* bars, int round,
                                          uint32_t n, int tw, Tiles&... tiles) {
  constexpr int floats = ((sizeof(Tiles) / 4) + ...);
  const float* slot = slots + (round & 1) * 128 * floats;
  hopper::mbar_wait<true>(&bars[round & 1], (round >> 1) & 1);
  if (n == 2)
    ((add_local(tiles, slot, tw), slot += 128 * (sizeof(Tiles) / 4)), ...);
  else
    ((sum_partials(tiles, slot, n, tw), slot += 128 * (sizeof(Tiles) / 4)), ...);
}

// the grid of a kernel over `rows` rows a CTA, `n` CTAs a row block
inline dim3 row_grid(int rows, int n, int H, int B) {
  return dim3((rows + kRows - 1) / kRows * n, H, B);
}

// Launch `kernel`, as clusters of n CTAs along x (n 1: no cluster; above 8,
// the portable size, the kernel is let take a non-portable cluster).
template <typename... Params, typename... Args>
int launch_kernel(void (*kernel)(Params...), dim3 grid, int threads, int smem, int n,
                  cudaStream_t stream, Args... args) {
  if (n > 8) {
    const cudaError_t st =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (st != cudaSuccess) return (int)st;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = n > 1 ? 1 : 0;
  const cudaError_t st = cudaLaunchKernelEx(&cfg, kernel, args...);
  return st != cudaSuccess ? (int)st : (int)cudaGetLastError();
}

// ------------------------------------------------ reduce-scatter, all-gather

// The f32 split kernels' rounds (any n from 2): bandwidth-lean, where a pull
// from 3 CTAs reads n - 1 partial tiles a CTA and round. A round's partial
// is U = kGroup * F units of 16 bytes (unit f * kGroup + tw: float4 f of
// thread tw's tiles, in order); CTA j owns units [j U / n, (j + 1) U / n).
//   - scatter: each unit goes to its owner's slot of the sender's rank (by
//     st.async into another CTA, completing bytes on its scatter barrier; a
//     plain store into this one's);
//   - reduce: an owner sums its units' n slots in rank order and sends the
//     sums to every CTA (st.async onto their collect barriers), so every
//     CTA gets the same bits;
//   - collect: each thread reads its units' sums back.
// A CTA moves about two partial tiles a round, whatever n. The caller
// spaces the three steps out (a round's reduce a tile after its scatter,
// its collect after the next tile's products) so that both hops are
// hidden. Each set of buffers (NB of them, round % NB) is n slots of
// ceil(U / n) units, then U units of sums, with two barriers (scatter,
// collect), each expecting the kGroup threads of its own CTA (thread 0's
// arrival also expecting the bytes the others send). A set is written again
// NB rounds on: a CTA scatters round r + 1 after it has collected round r -
// 1, so every owner has reduced round r - 1 and collected r - 2 (NB 2).

template <int F>
__host__ __device__ constexpr int set_units() {  // one set of buffers, in units
  return 2 * kGroup * F + kMaxSplit;
}

template <int NREG, int F>
__device__ __forceinline__ void to_units(float4 (&u)[F], int& i, const float (&x)[NREG]) {
#pragma unroll
  for (int j = 0; j < NREG / 4; ++j, ++i)
    u[i] = make_float4(x[4 * j], x[4 * j + 1], x[4 * j + 2], x[4 * j + 3]);
}

template <int NREG, int F>
__device__ __forceinline__ void from_units(float (&x)[NREG], int& i, const float4 (&u)[F]) {
#pragma unroll
  for (int j = 0; j < NREG / 4; ++j, ++i) {
    x[4 * j] = u[i].x, x[4 * j + 1] = u[i].y;
    x[4 * j + 2] = u[i].z, x[4 * j + 3] = u[i].w;
  }
}

// Scatter this thread's partial tiles (one or two) of round `round` (set
// round % NB of `sets`, its barriers at bars[2 * set], [2 * set + 1]).
template <int NB, typename... Tiles>
__device__ __forceinline__ void scatter(float4* sets, uint64_t* bars, int round, uint32_t n,
                                        uint32_t rank, int tw, const Tiles&... tiles) {
  constexpr int F = ((int)(sizeof(Tiles) / 16) + ...);
  constexpr int U = kGroup * F;
  float4* slots = sets + (round % NB) * set_units<F>();
  uint64_t* bar = &bars[2 * (round % NB)];
  const int S = (U + n - 1) / n;  // units of a slot
  float4 v[F];
  int i = 0;
  (to_units(v, i, tiles), ...);
#pragma unroll
  for (int f = 0; f < F; ++f) {
    const int u = f * kGroup + tw;
    const uint32_t j = ((u + 1) * n - 1) / U;  // the owner
    float4* at = &slots[rank * S + u - j * U / n];
    if (j == rank)
      *at = v[f];
    else
      hopper::st_async_f4(hopper::map_rank(at, j), v[f], hopper::map_rank(bar, j));
  }
  if (tw == 0)  // the others' units of this CTA's slice
    hopper::mbar_arrive_expect_tx(bar, (n - 1) * ((rank + 1) * U / n - rank * U / n) * 16);
  else
    hopper::mbar_arrive(bar);
}

// Once every CTA has scattered round `round`: this CTA's slice summed and
// sent to every CTA (F units a thread in a round's partial).
template <int NB, int F>
__device__ __forceinline__ void reduce(float4* sets, uint64_t* bars, int round, uint32_t n,
                                       uint32_t rank, int tw) {
  constexpr int U = kGroup * F;
  float4* slots = sets + (round % NB) * set_units<F>();
  float4* sums = slots + U + kMaxSplit;
  uint64_t* bar = &bars[2 * (round % NB)];
  const int S = (U + n - 1) / n;
  const int lo = rank * U / n, hi = (rank + 1) * U / n;
  hopper::mbar_wait<true>(bar, (round / NB) & 1);  // every slot of this CTA's slice
  for (int u = lo + tw; u < hi; u += kGroup) {
    float4 a = slots[u - lo];
    for (uint32_t r = 1; r < n; ++r) {
      const float4 b = slots[r * S + u - lo];
      a = make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
    }
    sums[u] = a;
    for (uint32_t j = 0; j < n; ++j)
      if (j != rank)
        hopper::st_async_f4(hopper::map_rank(&sums[u], j), a, hopper::map_rank(bar + 1, j));
  }
  if (tw == 0)  // the other slices' sums
    hopper::mbar_arrive_expect_tx(bar + 1, (U - (hi - lo)) * 16);
  else
    hopper::mbar_arrive(bar + 1);
}

// Once every CTA has reduced round `round`: the tiles = the sum of the
// cluster's partials.
template <int NB, typename... Tiles>
__device__ __forceinline__ void collect(float4* sets, uint64_t* bars, int round, int tw,
                                        Tiles&... tiles) {
  constexpr int F = ((int)(sizeof(Tiles) / 16) + ...);
  const float4* sums = sets + (round % NB) * set_units<F>() + kGroup * F + kMaxSplit;
  hopper::mbar_wait<true>(&bars[2 * (round % NB) + 1], (round / NB) & 1);
  float4 v[F];
#pragma unroll
  for (int f = 0; f < F; ++f) v[f] = sums[f * kGroup + tw];
  int i = 0;
  (from_units(tiles, i, v), ...);
}

}  // namespace rounds
