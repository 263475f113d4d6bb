// P-8 .. P-11, P-13, P-14: the capability probes of
// benchmarks/probe_pallas_caps.py, each computing what its probe computes
// (P-12, `p5`, is the lane gather of probe_gather.cu at int32):
//
//   cap_dyn_store       <- :40  `p1`  store 8 rows into a zeroed (32, 128)
//                                     scratch at a run-time row offset
//                                     x[0, 0] + 3, output its first rows
//   cap_cumsum2d        <- :54  `p2`  cumsum over axis 0, then axis 1
//   cap_onehot_compact  <- :89  `p3`  stable compaction of each 256-element
//                                     tile by keep != 0, zeros past the count
//   cap_bulk_copy       <- :114 `p4`  step b stages x[8b:8b+8] + 1000 and
//                                     copies it to out rows [5b, 5b + 8)
//   cap_carry           <- :157 `p6`  a sum carried across 8-row tiles
//   cap_dyn_loop        <- :176 `p7`  a loop of run-time trip count
//                                     (x[0, 0] & 7) + 2 over rows x[i & 7]
//
// On the TPU these ask whether Mosaic lowers a feature at all; on CUDA each
// does by construction, and the kernels are a self-test. At the probes'
// shapes each moves a few KB and is bound by its launch; P-10, P-11, P-13
// and P-14 are bound by device memory at scale.
//
// P-10 design: the TPU compacts a tile by multiplying it (split in two
// 16-bit halves, in float32) by a 256 x 256 one-hot matrix: the MXU as a
// permutation engine. That is the TPU's idiom, not the function, which is
// a stable compaction of each 256-element tile with zeros past the count,
// bound by device memory (12 bytes an element: 0.0376 ms at 10.5M). Here
// one warp compacts a tile: lane l loads elements 8l .. 8l+7 of x and keep
// as two 16-byte loads each (a coalesced 1 KB row a warp, in source
// order), counts its kept ones, and a 5-step __shfl_up_sync scan gives its
// first destination; it writes its kept values into the warp's 1 KB
// staging row in shared memory, and after __syncwarp() every lane reads
// its 8 output slots back, zero at or past the warp's total, and stores
// them as 16 bytes twice. No block barrier, no tensor core. A persistent
// grid (the blocks the SMs hold at once, no more than the tiles fill)
// strides over the tiles, a warp a tile at a time; pointers that are not
// all 16-byte aligned (a view at an odd offset) take 4-byte loads and
// stores instead.
//
// P-9 design: the whole tile (rows <= 64 of 128 int32, at most 32 KB) comes
// on chip at once. Thread (lane g, warp b) of an 8-warp block holds columns
// 4g .. 4g+3 of rows 8b .. 8b+7 as 8 16-byte loads, all issued before the
// first add (a warp reads 8 whole 512-byte rows). Axis 0 is a blocked
// scan: each thread's running column sums over its 8 rows in registers,
// the warps' totals through shared memory, one barrier, and each warp adds
// the totals of the warps above it. Axis 1: a warp holds its 8 rows whole,
// so a row's scan is an in-thread scan of 4 columns and a 5-step shuffle
// scan of the lanes' totals, and the 8 rows' chains are independent and
// overlap. 16-byte stores, a warp writing whole rows; 4-byte accesses
// where x or out is not 16-byte aligned. One barrier a call.
//
// P-8 design: the probe zero-fills a VMEM scratch, stores 8 rows into it
// at a run-time offset and copies its first rows out. The function is
// closed: out row r is x row r - start for start <= r < start + 8 and zero
// otherwise, with start = x[0, 0] + 3 (int32 wrap). One block of 256
// threads: thread t loads x[0, 0] and quad t of x's first 8 rows (the only
// rows the probe reads) in one round, stores its quad at out row start +
// t / 32 if that row is below `rows`, and stores zeros to the output quads
// t + 256 k that lie outside the 8-row window. One round trip, no shared
// memory, no barrier, 16-byte stores (4-byte ones where x or out is not
// 16-byte aligned).
//
// P-11 design: the probe's sequential grid carries a row offset and lets a
// later step's rows overwrite an earlier one's; that is a TPU idiom for a
// closed form. Out row r < bulk_rows(steps) = 5 (steps - 1) + 8 is x row
// 8b + (r - 5b) = 3b + r, plus 1000, where b = min(r / 5, steps - 1) is
// the last step that writes it; later rows are not written. A grid of
// 4-warp blocks, each warp owning 4 whole 512-byte output rows (16 bytes
// a lane): all 4 loads issued before any store, no barrier, no shared
// memory, no bulk copy; 4-byte accesses where x or out is not 16-byte
// aligned. It is bound by its launch at the probe's 3 steps and by device
// memory from about a thousand steps on.
//
// P-13 design: the TPU carries the sum from one 8-row grid step to the
// next in SMEM; unsigned addition wraps and is associative, so the carry
// is a plain sum in any order. One block of 256 threads: each thread
// issues 4 16-byte loads before its first add (the probe's 4 tiles, 16 KB,
// in one round of loads), keeps its partial sum in a register, and loops
// over 16 KB chunks for more tiles; then one block reduction (a warp's
// shuffles, 8 warp totals through shared memory, one barrier) and one
// store. 4-byte loads where x is not 16-byte aligned.
//
// P-14 design: the probe's loop of run-time trip count n = (x[0, 0] & 7) +
// 2, in [2, 9], over rows i & 7 has a closed form: out[j] is the sum of
// x[k, j] over k < min(n, 8), plus x[0, j] again when n == 9 (uint32
// wrap; `caps.loop_counts`). A loop that loads x[0, 0] first and a word
// a trip after it costs two dependent round trips to memory. Here a
// thread owns a quad of 4 consecutive columns and loads x[0, 0] with
// its quads of rows 0 and 1, which every n reads; rows 2..7 go in the
// same round where x is narrow (the wrapper's route, `caps.loop_plan`:
// one round trip, a speculative read of a few KB, each row masked by k <
// n), else as loads predicated on k < n, made once n is known, all
// before the first add, so the kernel reads only the rows the function
// reads (bound by device memory at scale: min(n, 8) rows read, one
// written). One 16-byte store; 4-byte accesses where x or out is not
// 16-byte aligned or cols % 4 != 0.
#include "common.cuh"

namespace {

constexpr int kThreads = gdf::kThreads;
constexpr int kWarps = gdf::kWarps;
constexpr int kLanes = 128;
constexpr int kScratchRows = 32;                // p1's scratch
constexpr int kStoreRows = 8;                   // rows p1 stores
constexpr int kCumRows = 64;                    // p2's tile, at most
constexpr int kCompactTile = 256;               // p3's tile
constexpr int kStepRows = 8;                    // p4's and p6's tile rows
constexpr int kStepAdvance = 5;                 // p4's offset per step
constexpr int kLoopRows = 8;                    // rows p7 reads, i & 7
constexpr int kMaxDevices = 16;
constexpr int kCompactPerLane = kCompactTile / 32;   // 8 elements a lane

constexpr int kCumRowsPerWarp = 8;                      // P-9
constexpr int kCumWarps = kCumRows / kCumRowsPerWarp;
constexpr int kCarryLoads = 4;                          // P-13, a thread
constexpr int kQuads = kLanes / 4;                      // int4 a row

template <bool kVec>
__device__ __forceinline__ uint4 load4(const int* p) {
  if (kVec) return *reinterpret_cast<const uint4*>(p);
  return make_uint4((unsigned)p[0], (unsigned)p[1], (unsigned)p[2],
                    (unsigned)p[3]);
}

template <bool kVec>
__device__ __forceinline__ void store4(int* p, uint4 v) {
  if (kVec) {
    *reinterpret_cast<uint4*>(p) = v;
  } else {
    p[0] = (int)v.x; p[1] = (int)v.y; p[2] = (int)v.z; p[3] = (int)v.w;
  }
}

__device__ __forceinline__ uint4 add4(uint4 a, uint4 b) {
  return make_uint4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// P-8: 256 threads, thread t holds quad t of x's first 8 rows.
constexpr int kStoreThreads = kStoreRows * kQuads;
constexpr int kStoreQuads = kScratchRows * kQuads;      // of out, at most

template <bool kVec>
__global__ void __launch_bounds__(kStoreThreads)
cap_dyn_store(const int* __restrict__ x, int* __restrict__ out, int rows) {
  const int t = threadIdx.x;
  const int x00 = x[0];
  const uint4 v = load4<kVec>(x + 4 * t);
  // the wrapper checks that rows [start, start + 8) fit; an offset that
  // does not leaves the window empty (all zeros), never a store outside
  const int start = (int)((unsigned)x00 + 3u);
  const bool fits = start >= 0 && start <= kScratchRows - kStoreRows;
  const int lo = fits ? start * kQuads : 0;               // window, in quads
  const int hi = fits ? lo + kStoreThreads : 0;
  const int quads = rows * kQuads;
  if (fits && lo + t < quads) store4<kVec>(out + 4 * (lo + t), v);
#pragma unroll
  for (int k = 0; k < kStoreQuads / kStoreThreads; ++k) {
    const int q = t + k * kStoreThreads;
    if (q < quads && (q < lo || q >= hi)) {
      store4<kVec>(out + 4 * q, make_uint4(0, 0, 0, 0));
    }
  }
}

// One block of kCumWarps warps; warp b holds rows [8b, 8b + 8).
template <bool kVec>
__global__ void __launch_bounds__(kCumWarps * 32)
cap_cumsum2d(const int* __restrict__ x, int* __restrict__ out, int rows) {
  __shared__ uint4 warp_tot[kCumWarps][kQuads];
  const int g = threadIdx.x & 31;
  const int b = threadIdx.x >> 5;
  const int first = b * kCumRowsPerWarp;
  uint4 v[kCumRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kCumRowsPerWarp; ++i) {
    v[i] = first + i < rows ? load4<kVec>(x + (first + i) * kLanes + 4 * g)
                            : make_uint4(0, 0, 0, 0);
  }
#pragma unroll
  for (int i = 1; i < kCumRowsPerWarp; ++i) v[i] = add4(v[i], v[i - 1]);
  warp_tot[b][g] = v[kCumRowsPerWarp - 1];
  __syncthreads();
  uint4 above = make_uint4(0, 0, 0, 0);
#pragma unroll
  for (int w = 0; w < kCumWarps - 1; ++w) {
    if (w < b) above = add4(above, warp_tot[w][g]);
  }
#pragma unroll
  for (int i = 0; i < kCumRowsPerWarp; ++i) {
    uint4 c = add4(v[i], above);
    c.y += c.x;
    c.z += c.y;
    c.w += c.z;
    unsigned inc = c.w;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const unsigned y = __shfl_up_sync(0xffffffffu, inc, d);
      if (g >= d) inc += y;
    }
    const unsigned before = inc - c.w;
    if (first + i < rows) {
      store4<kVec>(out + (first + i) * kLanes + 4 * g,
                   add4(c, make_uint4(before, before, before, before)));
    }
  }
}

template <bool kVec>
__device__ __forceinline__ void load8(const int* p, int (&v)[kCompactPerLane]) {
  if (kVec) {
    const int4 a = reinterpret_cast<const int4*>(p)[0];
    const int4 b = reinterpret_cast<const int4*>(p)[1];
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
#pragma unroll
    for (int i = 0; i < kCompactPerLane; ++i) v[i] = p[i];
  }
}

// One warp a 256-element tile, grid-striding over `tiles` tiles.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
cap_onehot_compact(const int* __restrict__ x, const int* __restrict__ keep,
                   int* __restrict__ out, long long tiles) {
  __shared__ __align__(16) int s_row[kWarps][kCompactTile];
  const int lane = threadIdx.x & 31;
  int* row = s_row[threadIdx.x >> 5];
  const long long stride = (long long)gridDim.x * kWarps;
  for (long long tile = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
       tile < tiles; tile += stride) {
    const long long at = tile * kCompactTile + lane * kCompactPerLane;
    int v[kCompactPerLane], k[kCompactPerLane];
    load8<kVec>(x + at, v);
    load8<kVec>(keep + at, k);
    unsigned kept = 0;
#pragma unroll
    for (int i = 0; i < kCompactPerLane; ++i) kept |= (k[i] != 0) << i;
    const int count = __popc(kept);
    int inc = count;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, inc, d);
      if (lane >= d) inc += y;
    }
    const int total = __shfl_sync(0xffffffffu, inc, 31);
    int dest = inc - count;
#pragma unroll
    for (int i = 0; i < kCompactPerLane; ++i) {
      if (kept >> i & 1) row[dest++] = v[i];
    }
    __syncwarp();
    const int first = lane * kCompactPerLane;
    int o[kCompactPerLane];
    load8<true>(row + first, o);
#pragma unroll
    for (int i = 0; i < kCompactPerLane; ++i) {
      if (first + i >= total) o[i] = 0;
    }
    if (kVec) {
      int4* o4 = reinterpret_cast<int4*>(out + at);
      o4[0] = make_int4(o[0], o[1], o[2], o[3]);
      o4[1] = make_int4(o[4], o[5], o[6], o[7]);
    } else {
#pragma unroll
      for (int i = 0; i < kCompactPerLane; ++i) out[at + i] = o[i];
    }
    __syncwarp();                       // the row is read before reuse
  }
}

// P-11: 4-warp blocks, kBulkRowsPerWarp whole output rows a warp.
constexpr int kBulkWarps = 4;
constexpr int kBulkRowsPerWarp = 4;
constexpr int kBulkRowsPerBlock = kBulkWarps * kBulkRowsPerWarp;

template <bool kVec>
__global__ void __launch_bounds__(kBulkWarps * 32)
cap_bulk_copy(const int* __restrict__ x, int* __restrict__ out, int steps,
              int out_rows) {
  const int lane = threadIdx.x & 31;
  const int first = blockIdx.x * kBulkRowsPerBlock +
                    (threadIdx.x >> 5) * kBulkRowsPerWarp;
  uint4 v[kBulkRowsPerWarp];
#pragma unroll
  for (int k = 0; k < kBulkRowsPerWarp; ++k) {
    const int r = first + k;
    const int b = min(r / kStepAdvance, steps - 1);   // the last step at r
    const long long src = (long long)(kStepRows - kStepAdvance) * b + r;
    v[k] = r < out_rows ? load4<kVec>(x + src * kLanes + 4 * lane)
                        : make_uint4(0, 0, 0, 0);
  }
  const uint4 plus = make_uint4(1000u, 1000u, 1000u, 1000u);
#pragma unroll
  for (int k = 0; k < kBulkRowsPerWarp; ++k) {
    const int r = first + k;
    if (r < out_rows) {
      store4<kVec>(out + (long long)r * kLanes + 4 * lane, add4(v[k], plus));
    }
  }
}

// One block; x holds `quads` groups of 4 ints (any count: 64-bit indices).
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
cap_carry(const int* __restrict__ x, int* __restrict__ out,
          long long quads) {
  __shared__ unsigned warp_tot[kWarps];
  unsigned part = 0;
  for (long long base = threadIdx.x; base < quads;
       base += kThreads * kCarryLoads) {
    uint4 v[kCarryLoads];
#pragma unroll
    for (int k = 0; k < kCarryLoads; ++k) {
      const long long q = base + k * kThreads;
      v[k] = q < quads ? load4<kVec>(x + 4 * q) : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int k = 0; k < kCarryLoads; ++k) {
      part += v[k].x + v[k].y + v[k].z + v[k].w;
    }
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    part += __shfl_xor_sync(0xffffffffu, part, d);
  }
  if ((threadIdx.x & 31) == 0) warp_tot[threadIdx.x >> 5] = part;
  __syncthreads();
  if (threadIdx.x < 32) {
    unsigned t = threadIdx.x < kWarps ? warp_tot[threadIdx.x] : 0;
#pragma unroll
    for (int d = kWarps / 2; d > 0; d >>= 1) {
      t += __shfl_xor_sync(0xffffffffu, t, d);
    }
    if (threadIdx.x == 0) out[0] = (int)t;
  }
}

// P-14: a thread a quad of 4 consecutive columns; `live` of them (the
// last quad of a width that is not a multiple of 4 holds fewer) through
// 4-byte accesses where kVec is false.
constexpr int kLoopThreads = 128;

template <bool kVec>
__device__ __forceinline__ uint4 load_cols(const int* p, int live) {
  if (kVec) return *reinterpret_cast<const uint4*>(p);
  unsigned w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (i < live) w[i] = (unsigned)p[i];
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

template <bool kVec>
__device__ __forceinline__ void store_cols(int* p, uint4 v, int live) {
  if (kVec) {
    *reinterpret_cast<uint4*>(p) = v;
    return;
  }
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (i < live) p[i] = (int)w[i];
  }
}

// kAll: rows 2..7 are loaded with x[0, 0] and rows 0, 1 whatever the trip
// count (one round trip); else only the rows k < n, once n is known.
template <bool kVec, bool kAll>
__global__ void __launch_bounds__(kLoopThreads)
cap_dyn_loop(const int* __restrict__ x, int* __restrict__ out, int cols) {
  const long long j = 4 * ((long long)blockIdx.x * kLoopThreads +
                           threadIdx.x);
  if (j >= cols) return;
  const int live = cols - j < 4 ? (int)(cols - j) : 4;
  const int x00 = x[0];
  uint4 v[kLoopRows];
#pragma unroll
  for (int k = 0; k < kLoopRows; ++k) {
    if (k < 2 || kAll) v[k] = load_cols<kVec>(x + (long long)k * cols + j,
                                              live);
  }
  const int n = (x00 & 7) + 2;                  // 2 .. 9 trips
  if (!kAll) {
#pragma unroll
    for (int k = 2; k < kLoopRows; ++k) {
      v[k] = k < n ? load_cols<kVec>(x + (long long)k * cols + j, live)
                   : make_uint4(0, 0, 0, 0);
    }
  }
  uint4 acc = add4(v[0], v[1]);
#pragma unroll
  for (int k = 2; k < kLoopRows; ++k) {
    // a mask, not a branch, so that no load is sunk to wait for n
    const unsigned m = k < n ? ~0u : 0u;
    acc = add4(acc, make_uint4(v[k].x & m, v[k].y & m, v[k].z & m,
                               v[k].w & m));
  }
  if (n > kLoopRows) acc = add4(acc, v[0]);     // trip 8 reads row 0 again
  store_cols<kVec>(out + j, acc, live);
}

cudaStream_t as_stream(void* stream) {
  return static_cast<cudaStream_t>(stream);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

extern "C" {

// x int32 (rows, 128), 8 <= rows <= 32; out (rows, 128). Any 4-byte
// alignment.
int gdf_probe_cap_dyn_store(const void* x, void* out, int rows,
                            void* stream) {
  if (rows < kStoreRows || rows > kScratchRows) {
    return (int)cudaErrorInvalidValue;
  }
  auto* kernel = aligned16(x) && aligned16(out) ? &cap_dyn_store<true>
                                                : &cap_dyn_store<false>;
  kernel<<<1, kStoreThreads, 0, as_stream(stream)>>>(
      static_cast<const int*>(x), static_cast<int*>(out), rows);
  GDF_LAUNCH_CHECK();
  return 0;
}

// x, out int32 (rows, 128), 1 <= rows <= 64.
int gdf_probe_cap_cumsum2d(const void* x, void* out, int rows,
                           void* stream) {
  if (rows < 1 || rows > kCumRows) return (int)cudaErrorInvalidValue;
  auto* kernel = aligned16(x) && aligned16(out) ? &cap_cumsum2d<true>
                                                : &cap_cumsum2d<false>;
  kernel<<<1, kCumWarps * 32, 0, as_stream(stream)>>>(
      static_cast<const int*>(x), static_cast<int*>(out), rows);
  GDF_LAUNCH_CHECK();
  return 0;
}

// x, keep, out int32 (n,), n a multiple of 256; each 256-element tile is
// compacted on its own. Any 4-byte alignment.
int gdf_probe_cap_onehot_compact(const void* x, const void* keep, void* out,
                                 long long n, void* stream) {
  if (n < 0 || n % kCompactTile != 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const bool vec = aligned16(x) && aligned16(keep) && aligned16(out);
  auto* kernel = vec ? &cap_onehot_compact<true> : &cap_onehot_compact<false>;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  // blocks an SM holds and SMs, asked once a card and kernel
  static int occupancy[kMaxDevices][2][2] = {};
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  int* occ = occupancy[dev][vec];
  if (occ[0] == 0) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ[0], kernel,
                                                        kThreads, 0);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&occ[1], cudaDevAttrMultiProcessorCount,
                                   dev);
    }
    if (err != cudaSuccess || occ[0] <= 0) {
      occ[0] = 0;
      return (int)(err != cudaSuccess ? err : cudaErrorInvalidConfiguration);
    }
  }
  const long long tiles = n / kCompactTile;
  const long long fill = (tiles + kWarps - 1) / kWarps;
  const long long most = (long long)occ[0] * occ[1];
  kernel<<<(unsigned)(fill < most ? fill : most), kThreads, 0,
           as_stream(stream)>>>(static_cast<const int*>(x),
                                static_cast<const int*>(keep),
                                static_cast<int*>(out), tiles);
  GDF_LAUNCH_CHECK();
  return 0;
}

// x, out int32 (8 * steps, 128), any 4-byte alignment. Rows past
// 5 (steps - 1) + 8 are not written.
int gdf_probe_cap_bulk_copy(const void* x, void* out, int steps,
                            void* stream) {
  if (steps < 1 || steps > (1 << 20) / kStepRows) {
    return (int)cudaErrorInvalidValue;
  }
  const int out_rows = kStepAdvance * (steps - 1) + kStepRows;
  auto* kernel = aligned16(x) && aligned16(out) ? &cap_bulk_copy<true>
                                                : &cap_bulk_copy<false>;
  kernel<<<(unsigned)((out_rows + kBulkRowsPerBlock - 1) / kBulkRowsPerBlock),
           kBulkWarps * 32, 0, as_stream(stream)>>>(
      static_cast<const int*>(x), static_cast<int*>(out), steps, out_rows);
  GDF_LAUNCH_CHECK();
  return 0;
}

// x int32 (8 * tiles, 128); out int32 (1, 1).
int gdf_probe_cap_carry(const void* x, void* out, int tiles, void* stream) {
  if (tiles < 1) return (int)cudaErrorInvalidValue;
  auto* kernel = aligned16(x) ? &cap_carry<true> : &cap_carry<false>;
  kernel<<<1, kThreads, 0, as_stream(stream)>>>(
      static_cast<const int*>(x), static_cast<int*>(out),
      (long long)tiles * kStepRows * kQuads);
  GDF_LAUNCH_CHECK();
  return 0;
}

// x int32 (8, cols); out int32 (1, cols); any 4-byte alignment (16-byte
// accesses where x and out are 16-byte aligned and cols % 4 == 0). all_rows
// != 0 loads all 8 rows with x[0, 0] (the wrapper's route for narrow x,
// `caps.loop_plan`); 0 loads rows 2..7 only where the trip count reads
// them.
int gdf_probe_cap_dyn_loop(const void* x, void* out, int cols, int all_rows,
                           void* stream) {
  if (cols < 1) return (int)cudaErrorInvalidValue;
  const bool vec = aligned16(x) && aligned16(out) && cols % 4 == 0;
  auto* kernel = vec ? (all_rows ? &cap_dyn_loop<true, true>
                                 : &cap_dyn_loop<true, false>)
                     : (all_rows ? &cap_dyn_loop<false, true>
                                 : &cap_dyn_loop<false, false>);
  const long long quads = (cols + 3LL) / 4;
  kernel<<<(unsigned)((quads + kLoopThreads - 1) / kLoopThreads),
           kLoopThreads, 0, as_stream(stream)>>>(
      static_cast<const int*>(x), static_cast<int*>(out), cols);
  GDF_LAUNCH_CHECK();
  return 0;
}

}  // extern "C"
