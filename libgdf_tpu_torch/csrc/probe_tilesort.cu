// P-1 `tile_sort`: each 65,536-element block of (key, payload) sorted
// ascending by the pair, both signed int32, as a bitonic network.
//
// Replaces benchmarks/probe_tilesort.py:91 `tile_sort` (kernel `_kernel`,
// l.57): the TPU holds one 512 x 128 block of key and payload in VMEM and
// runs all 136 compare-exchange stages of the 2^16-element network on it
// (sizes 2^1 .. 2^16, size 2^k has k stages), partners found by rolls.
//
// Bound: device memory, n x 16 bytes read and written once (11M elements:
// 184 MB, 0.055 ms at 3.35 TB/s); the network's 136 x n/2 compare-exchanges
// are below that at the card's 32-bit rate only if they stay on chip.
//
// Design: a 64K block of key + payload is 512 KB, over the 227 KB of shared
// memory a CUDA block can hold, so the one-block design does not carry
// over. The network is split by partner distance:
//   (a) one launch over 8192-element tiles held in shared memory (64 KB of
//       packed words) runs every stage at distance < 8192: all of sizes
//       2 .. 8192, 91 stages;
//   (b) each stage at distance 8192, 16384 or 32768 (6 in all, in sizes
//       16K, 32K and 64K) is one pass over device memory;
//   (c) after each size's device-memory passes, one launch over the tiles
//       runs that size's 13 stages below 8192.
// That is 10 launches in all. The direction of a stage of size 2^k at
// element i is ascending where bit k of i (within its 64K block) is 0,
// and the last size, the whole block, is all ascending:
// probe_tilesort.py:63-80 read as a function. Key and payload are packed
// into one int64 whose signed order is the pair's (key, then payload, both
// signed), so a compare-exchange is one 64-bit compare, and ties of key
// come out in payload order, as the probe's `pv_smaller` orders them.
// The loops over stages are not unrolled (the build stays in seconds).
#include "common.cuh"

namespace {

constexpr int kBlockLog = 16;               // elements per sorted block: 2^16
constexpr long long kBlock = 1LL << kBlockLog;
constexpr int kTileLog = 13;                // elements per shared-memory tile
constexpr int kTile = 1 << kTileLog;
constexpr int kSortThreads = 1024;
constexpr int kPassThreads = 256;
constexpr size_t kTileBytes = kTile * sizeof(long long);   // 64 KB

__device__ __forceinline__ long long pack(int key, int pay) {
  return (long long)((unsigned long long)(unsigned)key << 32 |
                     (unsigned)(pay ^ 0x80000000));
}

__device__ __forceinline__ void unpack(long long w, int* key, int* pay) {
  *key = (int)(w >> 32);
  *pay = (int)((unsigned)w ^ 0x80000000u);
}

// Stages of size 2^k sort ascending where bit k of the element's index is
// 0; blocks start at multiples of 2^16, so the global index's bit k is the
// in-block one. Size 2^16 is the whole block: all ascending.
__device__ __forceinline__ bool ascending(long long i, int k) {
  return k >= kBlockLog || ((i >> k) & 1) == 0;
}

// First element of compare-exchange pair q at distance 2^j.
__device__ __forceinline__ long long pair_low(long long q, int j) {
  return ((q >> j) << (j + 1)) | (q & ((1LL << j) - 1));
}

// Sizes 2^k_lo .. 2^k_hi of the network, each only at its stages of
// distance below kTile, on the 8192-element tile of this CUDA block.
// key_in may be key_out (the passes after the first run in place).
__global__ void __launch_bounds__(kSortThreads)
tile_sort_smem(const int* key_in, const int* pay_in, int* key_out,
               int* pay_out, int k_lo, int k_hi) {
  extern __shared__ long long s_w[];
  const long long base = (long long)blockIdx.x * kTile;
  for (int e = threadIdx.x; e < kTile; e += kSortThreads) {
    s_w[e] = pack(key_in[base + e], pay_in[base + e]);
  }
  __syncthreads();
  for (int k = k_lo; k <= k_hi; ++k) {
    for (int j = (k < kTileLog ? k : kTileLog) - 1; j >= 0; --j) {
      for (int q = threadIdx.x; q < kTile / 2; q += kSortThreads) {
        const int a = (int)pair_low(q, j);
        const int b = a + (1 << j);
        const long long wa = s_w[a];
        const long long wb = s_w[b];
        if (ascending(base + a, k) ? wb < wa : wa < wb) {
          s_w[a] = wb;
          s_w[b] = wa;
        }
      }
      __syncthreads();
    }
  }
  for (int e = threadIdx.x; e < kTile; e += kSortThreads) {
    unpack(s_w[e], key_out + base + e, pay_out + base + e);
  }
}

// One stage of size 2^k at distance 2^j >= kTile, in device memory: one
// pair per thread, neighbouring threads on neighbouring elements.
__global__ void __launch_bounds__(kPassThreads)
tile_sort_global(int* key, int* pay, long long pairs, int j, int k) {
  const long long q = (long long)blockIdx.x * kPassThreads + threadIdx.x;
  if (q >= pairs) return;
  const long long a = pair_low(q, j);
  const long long b = a + (1LL << j);
  const long long wa = pack(key[a], pay[a]);
  const long long wb = pack(key[b], pay[b]);
  if (ascending(a, k) ? wb < wa : wa < wb) {
    unpack(wb, key + a, pay + a);
    unpack(wa, key + b, pay + b);
  }
}

}  // namespace

extern "C" {

// key, pay int32[n] -> key_out, pay_out int32[n], each 65,536-element
// block sorted by (key, pay); n a positive multiple of 65,536. Ten
// launches on `stream`. Returns a cudaError_t.
int gdf_probe_tile_sort(const void* key, const void* pay, void* key_out,
                        void* pay_out, long long n, void* stream) {
  if (n <= 0 || n % kBlock != 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      tile_sort_smem, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kTileBytes);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned tiles = (unsigned)(n / kTile);
  const long long pairs = n / 2;
  const unsigned pass_blocks =
      (unsigned)((pairs + kPassThreads - 1) / kPassThreads);
  int* ko = static_cast<int*>(key_out);
  int* po = static_cast<int*>(pay_out);
  tile_sort_smem<<<tiles, kSortThreads, kTileBytes, st>>>(
      static_cast<const int*>(key), static_cast<const int*>(pay), ko, po, 1,
      kTileLog);
  GDF_LAUNCH_CHECK();
  for (int k = kTileLog + 1; k <= kBlockLog; ++k) {
    for (int j = k - 1; j >= kTileLog; --j) {
      tile_sort_global<<<pass_blocks, kPassThreads, 0, st>>>(ko, po, pairs,
                                                             j, k);
      GDF_LAUNCH_CHECK();
    }
    tile_sort_smem<<<tiles, kSortThreads, kTileBytes, st>>>(ko, po, ko, po,
                                                            k, k);
    GDF_LAUNCH_CHECK();
  }
  return 0;
}

}  // extern "C"
