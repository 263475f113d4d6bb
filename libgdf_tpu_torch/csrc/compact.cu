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
// Bound: device memory. It must read the keep bytes and every array once
// and write the survivors: for the 10M-row filter of the main path (int64
// key, float32 value, two bool masks, 45% kept) 10M x (1 + 14) + 4.5M x 14
// bytes = 213 MB, 0.064 ms at 3.35 TB/s. This design moves exactly those
// bytes.
//
// Design: one launch (after one memset of the tile descriptors), a single
// pass with decoupled look-back over the tiles' keep counts (lookback.cuh).
// Each block takes the next 4096-row tile from a global counter:
//   1. Each of 256 threads reads its 16 keep bytes as one 16-byte vector
//      and a block scan of the per-thread counts ranks the kept rows in
//      row order. The thread's rank and 16-bit mask go to shared memory.
//   2. Warp 0 publishes the tile's count, looks back for its exclusive
//      offset and publishes its inclusive prefix; the tile that holds row
//      n-1 writes the total to the count, so the count is written even
//      when nothing is kept. Meanwhile the other warps start the copy.
//   3. For each array, with its width a template parameter picked once per
//      array: neighbouring threads load neighbouring 16-byte vectors of the
//      tile's rows (coalesced), each kept value goes to shared memory at
//      its rank (at most 32 KB at 8 bytes), and after a barrier the block
//      stores the tile's survivors contiguously at out[offset + j], which
//      coalesces. All arrays share the tile's one look-back.
// A misaligned view (of keep or of an array) and the ragged last tile take
// scalar loads through the same ranks.
#include "lookback.cuh"

namespace {

using gdf::Descs;
using gdf::kAggregate;
using gdf::kPrefix;

constexpr int kMaxArrays = 16;
constexpr int kCompactThreads = gdf::kThreads;
constexpr int kRowsPerThread = 16;                        // one keep vector
constexpr int kTileRows = kCompactThreads * kRowsPerThread;   // 4096
// 4 x 34 KB of shared memory per SM; at most 64 registers a thread (left
// free, nvcc took 176, for one block per SM).
constexpr int kCompactBlocksPerSM = 4;

struct ArraySet {
  const void* in[kMaxArrays];
  void* out[kMaxArrays];
  int width[kMaxArrays];
  int count;
  unsigned aligned;  // bit w: in[w] is 16-byte aligned
};

struct CountSum {
  static __device__ int ident() { return 0; }
  static __device__ int apply(int a, int b) { return a + b; }
};

template <typename U> struct alignas(16) Vec16 {
  U v[16 / sizeof(U)];
};

// Rank within the tile of bit `b` of a thread's packed keep info: the
// rank of its first kept row << 16 | its 16-row keep mask.
__device__ __forceinline__ int rank_of(unsigned info, int b) {
  return (int)(info >> 16) + __popc(info & ((1u << b) - 1u));
}

// One array of the tile: kept rows to shared memory at their ranks, then
// the survivors to out[offset ...]. Every thread of the block must call it.
template <typename U>
__device__ __forceinline__ void copy_array(const U* __restrict__ in,
                                           U* __restrict__ out, bool vec,
                                           long long base, int rows,
                                           int kept, const unsigned* s_info,
                                           const int* s_offset, U* s_stage) {
  constexpr int VE = 16 / sizeof(U);                     // rows per vector
  constexpr int NV = kTileRows / VE / kCompactThreads;   // vectors a thread
  if (vec) {
    Vec16<U> v[NV];
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int r = (k * kCompactThreads + threadIdx.x) * VE;
      v[k] = *reinterpret_cast<const Vec16<U>*>(in + base + r);
    }
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int r = (k * kCompactThreads + threadIdx.x) * VE;
      const unsigned info = s_info[r / kRowsPerThread];
#pragma unroll
      for (int e = 0; e < VE; ++e) {
        const int b = r % kRowsPerThread + e;
        if ((info >> b) & 1u) s_stage[rank_of(info, b)] = v[k].v[e];
      }
    }
  } else {
    for (int r = threadIdx.x; r < rows; r += kCompactThreads) {
      const unsigned info = s_info[r / kRowsPerThread];
      const int b = r % kRowsPerThread;
      if ((info >> b) & 1u) s_stage[rank_of(info, b)] = in[base + r];
    }
  }
  __syncthreads();
  const long long offset = *s_offset;
  for (int j = threadIdx.x; j < kept; j += kCompactThreads) {
    out[offset + j] = s_stage[j];
  }
  __syncthreads();  // s_stage is reused by the next array
}

__global__ void __launch_bounds__(kCompactThreads, kCompactBlocksPerSM)
compact_lookback(const unsigned char* __restrict__ keep, long long n,
                 bool keep_aligned, ArraySet a, int* __restrict__ count,
                 Descs d) {
  __shared__ long long s_tile;
  __shared__ int s_warp[gdf::kWarps];
  __shared__ unsigned s_info[kCompactThreads];
  __shared__ int s_offset;
  __shared__ __align__(16) unsigned char s_stage[kTileRows * 8];
  const long long tile = gdf::next_tile(d, &s_tile);
  const long long base = tile * kTileRows;
  const int rows = (int)(n - base < kTileRows ? n - base : kTileRows);
  const bool full = rows == kTileRows;
  const int r0 = threadIdx.x * kRowsPerThread;

  unsigned mask = 0;
  if (full && keep_aligned) {
    const uint4 k = *reinterpret_cast<const uint4*>(keep + base + r0);
    mask = gdf::nonzero_bytes(k.x) | gdf::nonzero_bytes(k.y) << 4 |
           gdf::nonzero_bytes(k.z) << 8 | gdf::nonzero_bytes(k.w) << 12;
  } else {
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      if (r0 + i < rows && keep[base + r0 + i]) mask |= 1u << i;
    }
  }
  int kept;
  const int rank = gdf::block_exclusive_sum(__popc(mask), s_warp, &kept);
  s_info[threadIdx.x] = (unsigned)rank << 16 | mask;
  __syncthreads();

  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int offset = 0;
    if (tile == 0) {
      if (lane == 0) gdf::publish<int>(d, 0, kPrefix, kept);
    } else {
      if (lane == 0) gdf::publish<int>(d, tile, kAggregate, kept);
      offset = gdf::look_back<int, CountSum, false>(d, tile, nullptr);
      if (lane == 0) gdf::publish<int>(d, tile, kPrefix, offset + kept);
    }
    if (lane == 0) {
      s_offset = offset;
      if (base + rows == n) *count = offset + kept;
    }
  }
  if (kept == 0) return;  // the same for every thread of the block

  for (int w = 0; w < a.count; ++w) {
    const bool vec = full && ((a.aligned >> w) & 1u);
    switch (a.width[w]) {
      case 1:
        copy_array(static_cast<const unsigned char*>(a.in[w]),
                   static_cast<unsigned char*>(a.out[w]), vec, base, rows,
                   kept, s_info, &s_offset,
                   reinterpret_cast<unsigned char*>(s_stage));
        break;
      case 2:
        copy_array(static_cast<const unsigned short*>(a.in[w]),
                   static_cast<unsigned short*>(a.out[w]), vec, base, rows,
                   kept, s_info, &s_offset,
                   reinterpret_cast<unsigned short*>(s_stage));
        break;
      case 4:
        copy_array(static_cast<const unsigned*>(a.in[w]),
                   static_cast<unsigned*>(a.out[w]), vec, base, rows, kept,
                   s_info, &s_offset, reinterpret_cast<unsigned*>(s_stage));
        break;
      default:
        copy_array(static_cast<const unsigned long long*>(a.in[w]),
                   static_cast<unsigned long long*>(a.out[w]), vec, base,
                   rows, kept, s_info, &s_offset,
                   reinterpret_cast<unsigned long long*>(s_stage));
        break;
    }
  }
}

long long tile_count(long long n) { return (n + kTileRows - 1) / kTileRows; }

}  // namespace

extern "C" {

int gdf_compact_max_arrays() { return kMaxArrays; }

// Bytes of scratch (tile counter and descriptors) that gdf_compact needs
// for n rows.
long long gdf_compact_scratch_bytes(long long n) {
  return gdf::lookback_scratch_bytes<int>(tile_count(n));
}

// keep: uint8[n] (non-zero keeps the row), 0 < n < 2^31. Up to
// gdf_compact_max_arrays() arrays of byte widths 1, 2, 4 or 8, each [n],
// into outs [n]; count: int32[1], always written. scratch:
// gdf_compact_scratch_bytes(n) bytes, zeroed here on the stream. Returns a
// cudaError_t.
int gdf_compact(const void* keep, long long n, int narrays,
                const void* const* ins, void* const* outs, const int* widths,
                void* count, void* scratch, long long nbytes, void* stream) {
  if (narrays < 0 || narrays > kMaxArrays || n <= 0 || n >= (1LL << 31)) {
    return (int)cudaErrorInvalidValue;
  }
  ArraySet a;
  a.count = narrays;
  a.aligned = 0;
  for (int w = 0; w < narrays; ++w) {
    const int wd = widths[w];
    if (wd != 1 && wd != 2 && wd != 4 && wd != 8) {
      return (int)cudaErrorInvalidValue;
    }
    a.in[w] = ins[w];
    a.out[w] = outs[w];
    a.width[w] = wd;
    if (reinterpret_cast<uintptr_t>(ins[w]) % 16 == 0) a.aligned |= 1u << w;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Descs d;
  const int err = gdf::init_scratch(scratch, nbytes,
                                    gdf_compact_scratch_bytes(n), s, &d);
  if (err != 0) return err;
  compact_lookback<<<(unsigned)tile_count(n), kCompactThreads, 0, s>>>(
      static_cast<const unsigned char*>(keep), n,
      reinterpret_cast<uintptr_t>(keep) % 16 == 0, a,
      static_cast<int*>(count), d);
  GDF_LAUNCH_CHECK();
  return 0;
}

}  // extern "C"
