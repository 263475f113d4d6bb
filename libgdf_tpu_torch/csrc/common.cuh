// Shared pieces of the Hopper kernels: block geometry, a block-wide
// exclusive sum of one int per thread, and the launch check that turns a
// refused launch into the cudaError_t the C entry points return.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace gdf {

constexpr int kThreads = 256;           // threads per block
constexpr int kWarps = kThreads / 32;

// Exclusive sum over the block of one int per thread. `warp_tot` is
// kWarps ints of shared memory; `*total` receives the block total. Every
// thread of the block must call it.
__device__ __forceinline__ int block_exclusive_sum(int x, int* warp_tot,
                                                   int* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int inc = x;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    int y = __shfl_up_sync(0xffffffffu, inc, d);
    if (lane >= d) inc += y;
  }
  if (lane == 31) warp_tot[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kWarps ? warp_tot[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      int y = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w += y;
    }
    if (lane < kWarps) warp_tot[lane] = w;
  }
  __syncthreads();
  const int pre = warp > 0 ? warp_tot[warp - 1] : 0;
  *total = warp_tot[kWarps - 1];
  __syncthreads();  // warp_tot is reused by the caller's next call
  return pre + inc - x;
}

// Bit e of the result: byte e of w is not 0.
__device__ __forceinline__ unsigned nonzero_bytes(unsigned w) {
  unsigned m = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e) m |= ((w >> (8 * e)) & 0xffu) ? 1u << e : 0u;
  return m;
}

}  // namespace gdf

#define GDF_LAUNCH_CHECK()                       \
  do {                                           \
    cudaError_t gdf_err_ = cudaGetLastError();   \
    if (gdf_err_ != cudaSuccess) return (int)gdf_err_; \
  } while (0)
