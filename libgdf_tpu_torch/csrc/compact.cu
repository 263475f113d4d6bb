// H1 `compact`: stable stream compaction of up to 16 arrays by one keep mask.
//
// Replaces both Pallas compaction kernels:
//   libgdf_tpu/ops/pallas/compact.py  _kernel / _run / compact_pallas
//       (K1a, l.149 / 345 / 447)
//   libgdf_tpu/ops/pallas/compact2.py _kernel / _run / compact_pallas2
//       (K1b, l.66 / 127 / 190)
// Same contract: survivors move, in order, to the front of outputs of the
// same capacity; the count is written to the device; the tail past it is
// unspecified. The TPU kernels route survivors through log2(block) shift
// stages because Mosaic has no scatter, split 8-byte values into i32 words
// and fold bool planes into the routing word. Hopper scatters natively, so
// none of that is here: every array moves in its own width (1, 2, 4 or 8
// bytes), and the f64 payload bits are copied as they are.
//
// Bound: device memory. It reads the keep bytes twice and every array
// once, and writes the survivors: for the 10M-row filter of the main path
// (int64 key, float32 value, two bool masks, 45% kept) about 10M x (2 +
// 14) + 4.5M x 14 bytes ~ 220 MB. The scatter's writes are in order, so
// they coalesce within a warp where survivors are dense.
//
// Design: three launches.
//   1. count_tiles: each 2048-row tile counts its keep flags.
//   2. scan_counts: one block turns the counts into exclusive tile offsets
//      and writes the total to the device count.
//   3. scatter_tiles: each thread ranks its 8 consecutive rows with a block
//      exclusive sum and copies every kept row of every array to
//      offset + rank.
#include "common.cuh"

namespace {

using gdf::kItems;
using gdf::kThreads;
using gdf::kTile;
using gdf::kWarps;

constexpr int kMaxArrays = 16;

struct ArraySet {
  const void* in[kMaxArrays];
  void* out[kMaxArrays];
  int width[kMaxArrays];
  int count;
};

__global__ void __launch_bounds__(kThreads)
count_tiles(const unsigned char* keep, long long n, int* tile_counts) {
  __shared__ int warp_tot[kWarps];
  const long long base = (long long)blockIdx.x * kTile;
  int c = 0;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const long long g = base + i * kThreads + threadIdx.x;
    c += (g < n && keep[g]) ? 1 : 0;
  }
  int total;
  gdf::block_exclusive_sum(c, warp_tot, &total);
  if (threadIdx.x == 0) tile_counts[blockIdx.x] = total;
}

// One block: tile counts -> exclusive tile offsets in place; the total
// goes to *count_out.
__global__ void __launch_bounds__(kThreads)
scan_counts(int* tile_counts, long long ntiles, int* count_out) {
  __shared__ int warp_tot[kWarps];
  int carry = 0;
  for (long long base = 0; base < ntiles; base += kTile) {
    int v[kItems];
    int sum = 0;
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const long long g = base + threadIdx.x * kItems + i;
      v[i] = g < ntiles ? tile_counts[g] : 0;
      sum += v[i];
    }
    int total;
    int run = carry + gdf::block_exclusive_sum(sum, warp_tot, &total);
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const long long g = base + threadIdx.x * kItems + i;
      if (g < ntiles) tile_counts[g] = run;
      run += v[i];
    }
    carry += total;
  }
  if (threadIdx.x == 0) *count_out = carry;
}

__device__ __forceinline__ void copy_elem(const ArraySet& a, int w,
                                          long long src, long long dst) {
  switch (a.width[w]) {
    case 1:
      static_cast<unsigned char*>(a.out[w])[dst] =
          static_cast<const unsigned char*>(a.in[w])[src];
      break;
    case 2:
      static_cast<unsigned short*>(a.out[w])[dst] =
          static_cast<const unsigned short*>(a.in[w])[src];
      break;
    case 4:
      static_cast<unsigned int*>(a.out[w])[dst] =
          static_cast<const unsigned int*>(a.in[w])[src];
      break;
    default:
      static_cast<unsigned long long*>(a.out[w])[dst] =
          static_cast<const unsigned long long*>(a.in[w])[src];
      break;
  }
}

__global__ void __launch_bounds__(kThreads)
scatter_tiles(const unsigned char* keep, long long n, const int* tile_offsets,
              ArraySet a) {
  __shared__ int warp_tot[kWarps];
  const long long base =
      (long long)blockIdx.x * kTile + (long long)threadIdx.x * kItems;
  unsigned char k[kItems];
  int c = 0;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const long long g = base + i;
    k[i] = (g < n) ? keep[g] : 0;
    c += k[i] != 0;
  }
  int total;
  long long rank = (long long)tile_offsets[blockIdx.x] +
                   gdf::block_exclusive_sum(c, warp_tot, &total);
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    if (k[i]) {
      for (int w = 0; w < a.count; ++w) copy_elem(a, w, base + i, rank);
      ++rank;
    }
  }
}

}  // namespace

extern "C" {

int gdf_compact_tile_elems() { return kTile; }

int gdf_compact_max_arrays() { return kMaxArrays; }

// Passes 1 and 2: keep uint8[n] -> tile_offsets int32[ntiles] (exclusive)
// and count_out int32[1]. Returns a cudaError_t.
int gdf_compact_offsets(const void* keep, long long n, void* tile_offsets,
                        void* count_out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long ntiles = (n + kTile - 1) / kTile;
  if (ntiles == 0) return (int)cudaErrorInvalidValue;
  const unsigned char* k = static_cast<const unsigned char*>(keep);
  int* offs = static_cast<int*>(tile_offsets);
  count_tiles<<<(unsigned)ntiles, kThreads, 0, s>>>(k, n, offs);
  GDF_LAUNCH_CHECK();
  scan_counts<<<1, kThreads, 0, s>>>(offs, ntiles,
                                     static_cast<int*>(count_out));
  GDF_LAUNCH_CHECK();
  return 0;
}

// Pass 3 for up to gdf_compact_max_arrays() arrays of byte widths
// 1, 2, 4 or 8.
int gdf_compact_scatter(const void* keep, long long n,
                        const void* tile_offsets, int narrays,
                        const void* const* ins, void* const* outs,
                        const int* widths, void* stream) {
  if (narrays < 1 || narrays > kMaxArrays) return (int)cudaErrorInvalidValue;
  ArraySet a;
  a.count = narrays;
  for (int w = 0; w < narrays; ++w) {
    const int wd = widths[w];
    if (wd != 1 && wd != 2 && wd != 4 && wd != 8) {
      return (int)cudaErrorInvalidValue;
    }
    a.in[w] = ins[w];
    a.out[w] = outs[w];
    a.width[w] = wd;
  }
  const long long ntiles = (n + kTile - 1) / kTile;
  if (ntiles == 0) return (int)cudaErrorInvalidValue;
  scatter_tiles<<<(unsigned)ntiles, kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(keep), n,
      static_cast<const int*>(tile_offsets), a);
  GDF_LAUNCH_CHECK();
  return 0;
}

}  // extern "C"
