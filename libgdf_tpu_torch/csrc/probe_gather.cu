// P-2 .. P-5 and P-12, the gathers of the cost probes, on 4-byte values
// (float32 or int32 moved as raw words).
//
// Replaces benchmarks/probe_pallas_gather.py:63 `build_lane_gather`
// (out[i, j] = x[i, idx[i, j]], a gather inside a 128-lane row), :87
// `build_sublane_gather` (out[i, j] = x[idx[i, j], j]), :111
// `build_flat_take` (out = table[idx], a 64K-float table held in VMEM),
// :142 `build_take_2d_decomp` (the same through a (512, 128) table: here
// the flat view of it) and probe_pallas_caps.py:138 `p5` (a lane gather
// by a reversed iota, at int32).
//
// Index semantics are those of the probes' jnp.take / take_along_axis as
// they run in interpret mode: an index in [-size, 0) counts from the end,
// and an index outside [-size, size) gives the fill word (NaN for float32,
// INT32_MIN for int32), which the wrapper passes.
//
// Bound: device memory. Each kernel reads its indices and writes its
// outputs once (8 bytes an element) and reads the table once; at the main
// path's scale (81,920 x 128 indices) 84 MB, 0.025 ms at 3.35 TB/s.
//
// Design: every table sits in shared memory, so each gathered element is
// one shared-memory load and the device-memory traffic is coalesced.
//   lane_gather_rows: a CUDA block stages 16 rows of x (8 KB) and gathers
//     each output row from its own staged row.
//   sublane_gather_slabs: a CUDA block holds one 32-column slab of x (up
//     to 1792 x 32 words, 224 KB of dynamic shared memory) and gathers 256
//     output rows of that slab: output column c reads bank c of the slab,
//     so a warp's 32 loads never conflict.
//   flat_take_slabs: a 64K-word table is 256 KB, over the 227 KB limit, so
//     the table is walked in 128 KB slabs; a CUDA block keeps its 8192
//     indices in registers and, slab by slab, fills the outputs whose index
//     falls in the slab held, then writes each output once.
#include "common.cuh"

namespace {

constexpr int kLanes = 128;
constexpr int kGatherThreads = 256;
constexpr int kLaneRows = 16;                   // rows per block, lane gather
constexpr int kSlabCols = 32;                   // columns per slab, sublane
constexpr int kSubRows = 256;                   // output rows per block
constexpr int kMaxSubTableRows = 1792;          // 224 KB of shared memory
constexpr int kTakeSlab = 32768;                // table words per slab
constexpr int kTakeThreads = 512;
constexpr int kTakePerThread = 16;
constexpr int kTakeChunk = kTakeThreads * kTakePerThread;

// The position that index i names in a table of n, or -1 if none.
__device__ __forceinline__ long long resolve(long long i, long long n) {
  if (i < 0) i += n;
  return (i >= 0 && i < n) ? i : -1;
}

__global__ void __launch_bounds__(kGatherThreads)
lane_gather_rows(const unsigned* __restrict__ x, const int* __restrict__ idx,
                 unsigned* __restrict__ out, long long rows, unsigned fill) {
  __shared__ unsigned s_x[kLaneRows * kLanes];
  const long long r0 = (long long)blockIdx.x * kLaneRows;
  const int live = (int)(rows - r0 < kLaneRows ? rows - r0 : kLaneRows);
  const long long e0 = r0 * kLanes;
  for (int e = threadIdx.x; e < live * kLanes; e += kGatherThreads) {
    s_x[e] = x[e0 + e];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < live * kLanes; e += kGatherThreads) {
    const long long c = resolve(idx[e0 + e], kLanes);
    out[e0 + e] = c >= 0 ? s_x[(e & ~(kLanes - 1)) + c] : fill;
  }
}

// x (table_rows, 128); idx and out (rows, 128). Grid: (128 / 32 slabs,
// row chunks of kSubRows).
__global__ void __launch_bounds__(kGatherThreads)
sublane_gather_slabs(const unsigned* __restrict__ x, int table_rows,
                     const int* __restrict__ idx, unsigned* __restrict__ out,
                     long long rows, unsigned fill) {
  extern __shared__ unsigned s_slab[];          // table_rows x kSlabCols
  const int col0 = blockIdx.x * kSlabCols;
  for (int e = threadIdx.x; e < table_rows * kSlabCols;
       e += kGatherThreads) {
    s_slab[e] = x[(long long)(e / kSlabCols) * kLanes + col0 +
                  e % kSlabCols];
  }
  __syncthreads();
  const long long r0 = (long long)blockIdx.y * kSubRows;
  const int live = (int)(rows - r0 < kSubRows ? rows - r0 : kSubRows);
  for (int e = threadIdx.x; e < live * kSlabCols; e += kGatherThreads) {
    const int c = e % kSlabCols;
    const long long g = (r0 + e / kSlabCols) * kLanes + col0 + c;
    const long long r = resolve(idx[g], table_rows);
    out[g] = r >= 0 ? s_slab[r * kSlabCols + c] : fill;
  }
}

__global__ void __launch_bounds__(kTakeThreads)
flat_take_slabs(const unsigned* __restrict__ table, long long table_n,
                const int* __restrict__ idx, unsigned* __restrict__ out,
                long long n, unsigned fill) {
  extern __shared__ unsigned s_table[];         // kTakeSlab words
  const long long base = (long long)blockIdx.x * kTakeChunk + threadIdx.x;
  long long pos[kTakePerThread];
  unsigned val[kTakePerThread];
#pragma unroll
  for (int u = 0; u < kTakePerThread; ++u) {
    const long long g = base + (long long)u * kTakeThreads;
    pos[u] = g < n ? resolve(idx[g], table_n) : -1;
    val[u] = fill;
  }
  for (long long lo = 0; lo < table_n; lo += kTakeSlab) {
    const int len = (int)(table_n - lo < kTakeSlab ? table_n - lo : kTakeSlab);
    __syncthreads();                            // the last slab is read
    for (int e = threadIdx.x; e < len; e += kTakeThreads) {
      s_table[e] = table[lo + e];
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < kTakePerThread; ++u) {
      const long long p = pos[u] - lo;
      if (p >= 0 && p < len) val[u] = s_table[p];
    }
  }
#pragma unroll
  for (int u = 0; u < kTakePerThread; ++u) {
    const long long g = base + (long long)u * kTakeThreads;
    if (g < n) out[g] = val[u];
  }
}

}  // namespace

extern "C" {

// x, idx, out (rows, 128), 4-byte words. Returns a cudaError_t.
int gdf_probe_lane_gather(const void* x, const void* idx, void* out,
                          long long rows, int fill, void* stream) {
  if (rows <= 0) return rows == 0 ? 0 : (int)cudaErrorInvalidValue;
  const long long blocks = (rows + kLaneRows - 1) / kLaneRows;
  lane_gather_rows<<<(unsigned)blocks, kGatherThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned*>(x), static_cast<const int*>(idx),
      static_cast<unsigned*>(out), rows, (unsigned)fill);
  GDF_LAUNCH_CHECK();
  return 0;
}

// x (table_rows, 128); idx, out (rows, 128). Returns a cudaError_t.
int gdf_probe_sublane_gather(const void* x, int table_rows, const void* idx,
                             void* out, long long rows, int fill,
                             void* stream) {
  if (table_rows <= 0 || table_rows > kMaxSubTableRows || rows < 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (rows == 0) return 0;
  const int smem = table_rows * kSlabCols * (int)sizeof(unsigned);
  cudaError_t err = cudaFuncSetAttribute(
      sublane_gather_slabs, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(kLanes / kSlabCols,
                  (unsigned)((rows + kSubRows - 1) / kSubRows));
  sublane_gather_slabs<<<grid, kGatherThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned*>(x), table_rows,
      static_cast<const int*>(idx), static_cast<unsigned*>(out), rows,
      (unsigned)fill);
  GDF_LAUNCH_CHECK();
  return 0;
}

// table (table_n,); idx, out (n,). Returns a cudaError_t.
int gdf_probe_flat_take(const void* table, long long table_n,
                        const void* idx, void* out, long long n, int fill,
                        void* stream) {
  if (table_n <= 0 || n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const int smem = kTakeSlab * (int)sizeof(unsigned);
  cudaError_t err = cudaFuncSetAttribute(
      flat_take_slabs, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (n + kTakeChunk - 1) / kTakeChunk;
  flat_take_slabs<<<(unsigned)blocks, kTakeThreads, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned*>(table), table_n,
      static_cast<const int*>(idx), static_cast<unsigned*>(out), n,
      (unsigned)fill);
  GDF_LAUNCH_CHECK();
  return 0;
}

}  // extern "C"
