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
// path's scale (81,920 x 128 indices) 84 MB, 0.025 ms at 3.35 TB/s. The
// probes' tables are small (256 KB for the flat take, 224 KB at most for
// the sublane gather), so the bound is the index and output streams: the
// designs stage the table on chip once per SM, not once per block of
// indices, and keep enough 16-byte loads in flight to stream at HBM rate.
//
//   lane_gather_rows (:63, and caps :138 at int32): a warp a row, no block
//     barrier. Lane l loads its 16-byte quads x[r, 4l..4l+3] and idx[r,
//     4l..4l+3] together, writes its x quad into the warp's own 512-byte
//     row of shared memory, and after __syncwarp() reads the 4 words its
//     indices name and stores them as one 16-byte store: one round trip
//     to memory. A block of 8 warps for every 8 rows; the block scheduler
//     keeps the card full at 81,920 rows, where a persistent grid whose
//     warps load their next row before gathering the current one was
//     slower on the H100 (PERF.md §6), and so was a gather from
//     registers (4 shuffles of each of the lane's 4 words, then a
//     select). 4-byte accesses (words l + 32 k a lane, coalesced) where
//     x, idx or out is not 16-byte aligned.
//   sublane_gather_persistent (:87): a persistent grid of G blocks, G the
//     smaller of the blocks the SMs hold at once and 4 x the row chunks
//     (the wrapper's `sublane_plan`). Block b holds 32-column slab b % 4
//     of x (T rows of 128 contiguous bytes, up to 224 KB of dynamic shared
//     memory), staged once by TMA through a 2-D tensor map of x (boxes of
//     up to 256 rows x 32 columns, at most 7 copies, all completing on one
//     mbarrier; cuTensorMapEncodeTiled reached through
//     cudaGetDriverEntryPointByVersion). T copies of 128 bytes, one a row,
//     staged 128 KB several times slower (PERF.md): small bulk copies are
//     bound by the copy engine's requests, not bytes. The block then walks
//     row chunks b / 4, b / 4 + G / 4, ... Output column c reads bank c of the
//     slab, so a warp's 32 loads never conflict; each warp keeps up to 8
//     index rows in flight and loads the next chunk's before it gathers
//     the current one's.
//   flat_take_resident (:111, :142): a persistent grid (the blocks the SMs
//     hold at once, the wrapper's `take_grid`) of 1024-thread blocks, each
//     holding the table's first S words in dynamic shared memory (S the
//     table rounded up to 4 words, at most 49,152 = 192 KB; `take_plan`),
//     staged once a call by cp.async.bulk on an mbarrier. A word p < S is a
//     shared load, a word past it comes through L1 / L2 (__ldg); 2 x 4
//     loads in flight a thread, on indices loaded and outputs stored 16
//     bytes at a time. Measured on the H100 (PERF.md), a peer CTA's
//     distributed shared memory serves random words slower than L1 / L2,
//     so the table is not split over a thread-block cluster.
#include <cuda.h>
#include <cudaTypedefs.h>

#include "common.cuh"

namespace {

constexpr int kLanes = 128;
constexpr int kGatherThreads = 256;
constexpr int kGatherWarps = kGatherThreads / 32;   // rows a block, lane
constexpr int kSlabCols = 32;                   // columns per slab, sublane
constexpr int kMaxSubTableRows = 1792;          // 224 KB of shared memory
constexpr int kSubThreads = 1024;
constexpr int kSubWarps = kSubThreads / 32;
constexpr int kSubRowsInFlight = 8;             // index rows a warp holds
constexpr int kSubBoxRows = 256;                // rows of a TMA box, at most
constexpr int kMaxTakeSlab = 49152;             // words a block holds, 192 KB
constexpr int kTakeThreads = 1024;
constexpr int kTakeUnroll = 2;                  // 16-byte index loads held
constexpr int kBulkWords = 8192;                // 32 KB per bulk copy

// The position that index i names in a table of n, or -1 if none.
__device__ __forceinline__ long long resolve(long long i, long long n) {
  if (i < 0) i += n;
  return (i >= 0 && i < n) ? i : -1;
}

// -- shared-memory barriers and bulk copies (PTX, sm_90) -------------------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Initialise an mbarrier for one arrival; every thread of the block may
// wait on it after the __syncthreads that must follow.
__device__ __forceinline__ void mbar_init(unsigned bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(1u)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// The one arrival, which also expects `bytes` of bulk copies.
__device__ __forceinline__ void mbar_expect_tx(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes)
               : "memory");
}

// Wait for the barrier's first phase to complete.
__device__ __forceinline__ void mbar_wait0(unsigned bar) {
  unsigned done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(0u)
        : "memory");
  } while (!done);
}

// Copy `bytes` (a multiple of 16, both addresses 16-byte aligned) from
// device memory to this CTA's shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_load(unsigned dst, const void* src,
                                          unsigned bytes, unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// -- flat_take: indices in, outputs out, 16 bytes at a time ----------------

// The elements of idx / out before out's first 16-byte boundary.
__host__ __device__ __forceinline__ long long head_words(const void* out,
                                                         long long n) {
  const long long h =
      (long long)((16 - (reinterpret_cast<uintptr_t>(out) & 15)) & 15) / 4;
  return h < n ? h : n;
}

template <bool kVecIdx>
__device__ __forceinline__ int4 load_idx4(const int* idx, long long v) {
  if (kVecIdx) return __ldcs(reinterpret_cast<const int4*>(idx) + v);
  const int* p = idx + 4 * v;
  return make_int4(__ldcs(p), __ldcs(p + 1), __ldcs(p + 2), __ldcs(p + 3));
}

// kTakeUnroll index vectors v, v + step, ...; past nv index 0, which every
// table has.
template <bool kVecIdx>
__device__ __forceinline__ void load_group(const int* idx, long long nv,
                                           long long v, long long step,
                                           int4 (&g)[kTakeUnroll]) {
#pragma unroll
  for (int u = 0; u < kTakeUnroll; ++u) {
    const long long w = v + u * step;
    g[u] = w < nv ? load_idx4<kVecIdx>(idx, w) : make_int4(0, 0, 0, 0);
  }
}

// Word i (resolved as in `resolve`) of a table of n words whose first
// `resident` are at s[0 ..) in shared memory, the rest read through
// L1 / L2; the fill word where i names none.
struct ResidentTable {
  const unsigned* s;
  const unsigned* __restrict__ t;
  long long n;
  int resident;
  unsigned fill;
  __device__ __forceinline__ unsigned operator()(int i) const {
    const long long p = i < 0 ? (long long)i + n : (long long)i;
    const bool ok = p >= 0 && p < n;
    const long long q = ok ? p : 0;
    const unsigned v = q < resident ? s[q] : __ldg(t + q);
    return ok ? v : fill;
  }
};

// out[k] = table[idx[k]] for k < n. The block first holds table words
// [0, min(table_n, slab)) at s_slab[shift + j], shift the table's word
// offset in its 16-byte line, so that the bulk copy's addresses are
// 16-byte aligned on both sides; the head and tail words around the copy
// are plain loads. The mbarrier follows the slab's slab + 4 words. The
// gather runs grid-stride over out's 16-byte vectors (idx read as vectors
// too when kVecIdx: idx + head shares out + head's alignment), the next
// group of indices loaded before the current one is gathered; the (at
// most 6) words before and after the vectors come last.
template <bool kVecIdx>
__global__ void __launch_bounds__(kTakeThreads, 1)
flat_take_resident(const unsigned* __restrict__ table, long long table_n,
                   int slab, const int* __restrict__ idx,
                   unsigned* __restrict__ out, long long n, unsigned fill) {
  extern __shared__ __align__(128) unsigned s_slab[];
  const int len = table_n < slab ? (int)table_n : slab;
  const int shift = (int)((reinterpret_cast<uintptr_t>(table) >> 2) & 3);
  const int lead = ((4 - shift) & 3) < len ? (4 - shift) & 3 : len;
  const int body = (len - lead) & ~3;
  unsigned* dst = s_slab + shift;               // word j at dst[j]
  const unsigned bar = smem_addr(s_slab + slab + 4);
  if (threadIdx.x == 0) {
    mbar_init(bar);
    mbar_expect_tx(bar, (unsigned)body * 4u);
    for (int w = 0; w < body; w += kBulkWords) {
      const int words = body - w < kBulkWords ? body - w : kBulkWords;
      bulk_load(smem_addr(dst + lead + w), table + lead + w,
                (unsigned)words * 4u, bar);
    }
  }
  for (int j = threadIdx.x; j < len - body; j += kTakeThreads) {
    const int k = j < lead ? j : body + j;
    dst[k] = table[k];
  }
  const ResidentTable get{dst, table, table_n, len, fill};

  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long step = (long long)gridDim.x * blockDim.x;
  const long long head = head_words(out, n);
  const long long nv = (n - head) / 4;
  const long long tail = head + 4 * nv;
  const int* vidx = idx + head;
  uint4* vout = reinterpret_cast<uint4*>(out + head);
  int4 cur[kTakeUnroll];
  load_group<kVecIdx>(vidx, nv, tid, step, cur);
  __syncthreads();                              // the barrier is set up and
  mbar_wait0(bar);                              // the slab staged
  for (long long v = tid; v < nv; v += kTakeUnroll * step) {
    int4 nxt[kTakeUnroll];
    load_group<kVecIdx>(vidx, nv, v + kTakeUnroll * step, step, nxt);
    uint4 o[kTakeUnroll];
#pragma unroll
    for (int u = 0; u < kTakeUnroll; ++u) {
      o[u] = make_uint4(get(cur[u].x), get(cur[u].y), get(cur[u].z),
                        get(cur[u].w));
    }
#pragma unroll
    for (int u = 0; u < kTakeUnroll; ++u) {
      if (v + u * step < nv) __stcs(vout + v + u * step, o[u]);
      cur[u] = nxt[u];
    }
  }
  if (tid < head + (n - tail)) {
    const long long k = tid < head ? tid : tail + (tid - head);
    out[k] = get(idx[k]);
  }
}

// -- the lane and sublane gathers ------------------------------------------

// The 4 words of a row that lane `lane` holds: 4 consecutive words, moved
// as one 16-byte access (kVec), or words lane + 32 k, moved as coalesced
// 4-byte accesses.
template <bool kVec, typename T>
__device__ __forceinline__ void load_row(const T* __restrict__ p, int lane,
                                         T (&v)[4]) {
  if (kVec) {
    const uint4 q = *reinterpret_cast<const uint4*>(p + 4 * lane);
    v[0] = (T)q.x; v[1] = (T)q.y; v[2] = (T)q.z; v[3] = (T)q.w;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = p[lane + 32 * k];
  }
}

template <bool kVec>
__device__ __forceinline__ void store_row(unsigned* p, int lane,
                                          const unsigned (&v)[4]) {
  if (kVec) {
    *reinterpret_cast<uint4*>(p + 4 * lane) = make_uint4(v[0], v[1], v[2],
                                                         v[3]);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) p[lane + 32 * k] = v[k];
  }
}

// A warp a row: each lane loads its 4 words of x and of idx, the warp
// stages x's row in its own 512 bytes of shared memory, and after
// __syncwarp() each lane reads the 4 words its indices name and stores
// them.
template <bool kVec>
__global__ void __launch_bounds__(kGatherThreads)
lane_gather_rows(const unsigned* __restrict__ x, const int* __restrict__ idx,
                 unsigned* __restrict__ out, long long rows, unsigned fill) {
  __shared__ __align__(16) unsigned s_rows[kGatherWarps][kLanes];
  const int lane = threadIdx.x & 31;
  unsigned* row = s_rows[threadIdx.x >> 5];
  const long long r = (long long)blockIdx.x * kGatherWarps +
                      (threadIdx.x >> 5);
  if (r >= rows) return;                        // the whole warp
  unsigned xv[4];
  int iv[4];
  load_row<kVec>(x + r * kLanes, lane, xv);
  load_row<kVec>(idx + r * kLanes, lane, iv);
  store_row<kVec>(row, lane, xv);
  __syncwarp();
  unsigned o[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const long long c = resolve(iv[k], kLanes);
    o[k] = c >= 0 ? row[c] : fill;
  }
  store_row<kVec>(out + r * kLanes, lane, o);
}

// Row k (< rows per warp) of chunk ch that this warp gathers, or -1.
__device__ __forceinline__ long long sub_row(long long ch, int k,
                                             int chunk_rows, long long rows) {
  const long long r = ch * chunk_rows + (threadIdx.x >> 5) + k * kSubWarps;
  return k * kSubWarps < chunk_rows && r < rows ? r : -1;
}

// This lane's index in each of this warp's rows of chunk ch (0 where the
// row is past the end).
__device__ __forceinline__ void sub_load(const int* __restrict__ idx,
                                         long long ch, int chunk_rows,
                                         long long rows, int col,
                                         int (&g)[kSubRowsInFlight]) {
#pragma unroll
  for (int k = 0; k < kSubRowsInFlight; ++k) {
    const long long r = sub_row(ch, k, chunk_rows, rows);
    g[k] = r >= 0 ? __ldcs(idx + r * kLanes + col) : 0;
  }
}

// Copy box (col0, row0) of the tensor map, kSlabCols columns by its box
// rows, to shared memory by TMA, completing on `bar`; rows past the
// table's end arrive as zeros (and count as bytes of the box).
__device__ __forceinline__ void tma_load_box(unsigned dst,
                                             const CUtensorMap* map, int col0,
                                             int row0, unsigned bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<unsigned long long>(map)), "r"(col0), "r"(row0),
      "r"(bar)
      : "memory");
}

// x (table_rows, 128); idx and out (rows, 128); chunk_rows a multiple of
// 32 up to 256 (a warp's rows of a chunk, at most kSubRowsInFlight); the
// grid a multiple of 4. kTma: x is 16-byte aligned and `map` views it as
// a 2-D tensor of 4-byte words, boxes of box_rows x 32 (the slab arrives
// in at most 7 TMA copies), else the slab is staged by plain loads. The
// mbarrier follows the slab's boxes.
template <bool kTma>
__global__ void __launch_bounds__(kSubThreads)
sublane_gather_persistent(const __grid_constant__ CUtensorMap map,
                          const unsigned* __restrict__ x, int table_rows,
                          int box_rows, const int* __restrict__ idx,
                          unsigned* __restrict__ out, long long rows,
                          unsigned fill, int chunk_rows) {
  extern __shared__ __align__(128) unsigned s_sub[];
  const int boxes = (table_rows + box_rows - 1) / box_rows;
  const int lane = threadIdx.x & 31;
  const int col0 = (blockIdx.x & 3) * kSlabCols;
  const int col = col0 + lane;
  const unsigned bar = smem_addr(s_sub + boxes * box_rows * kSlabCols);
  if (kTma) {
    if (threadIdx.x == 0) {
      mbar_init(bar);
      mbar_expect_tx(bar, (unsigned)(boxes * box_rows * kSlabCols * 4));
      for (int b = 0; b < boxes; ++b) {
        tma_load_box(smem_addr(s_sub + b * box_rows * kSlabCols), &map, col0,
                     b * box_rows, bar);
      }
    }
  } else {
    for (int e = threadIdx.x; e < table_rows * kSlabCols; e += kSubThreads) {
      s_sub[e] = x[(long long)(e / kSlabCols) * kLanes + col0 +
                   e % kSlabCols];
    }
  }
  const long long chunks = (rows + chunk_rows - 1) / chunk_rows;
  const long long cstep = gridDim.x >> 2;
  long long ch = blockIdx.x >> 2;
  int cur[kSubRowsInFlight];
  sub_load(idx, ch, chunk_rows, rows, col, cur);
  __syncthreads();                              // the barrier is set up
  if (kTma) mbar_wait0(bar);
  for (; ch < chunks; ch += cstep) {
    int nxt[kSubRowsInFlight];
    sub_load(idx, ch + cstep, chunk_rows, rows, col, nxt);
    unsigned o[kSubRowsInFlight];
#pragma unroll
    for (int k = 0; k < kSubRowsInFlight; ++k) {
      int i = cur[k];
      if (i < 0) i += table_rows;
      const bool ok = (unsigned)i < (unsigned)table_rows;
      const unsigned v = s_sub[(ok ? i : 0) * kSlabCols + lane];
      o[k] = ok ? v : fill;
    }
#pragma unroll
    for (int k = 0; k < kSubRowsInFlight; ++k) {
      const long long r = sub_row(ch, k, chunk_rows, rows);
      if (r >= 0) __stcs(out + r * kLanes + col, o[k]);
      cur[k] = nxt[k];
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

bool aligned4(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 3) == 0;
}

// the slab (and 4 words of alignment shift), then the mbarrier
int take_smem(int slab) { return (slab + 4) * (int)sizeof(unsigned) + 8; }

int sub_box_rows(int table_rows) {
  return table_rows < kSubBoxRows ? table_rows : kSubBoxRows;
}

// the slab's whole boxes, then the mbarrier
int sub_smem(int table_rows) {
  const int box = sub_box_rows(table_rows);
  return (table_rows + box - 1) / box * box * kSlabCols * 4 + 8;
}

// A tensor map of x (table_rows, 128) words in boxes of
// sub_box_rows(table_rows) x 32; cuTensorMapEncodeTiled is looked up at
// run time by the runtime's entry-point query, so nothing new is linked.
cudaError_t sub_tensor_map(CUtensorMap* map, const void* x, int table_rows) {
  static const PFN_cuTensorMapEncodeTiled_v12000 encode = [] {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn,
                                         12000, cudaEnableDefault,
                                         &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess) {
      fn = nullptr;
    }
    return reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(fn);
  }();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {kLanes, (cuuint64_t)table_rows};
  const cuuint64_t strides[1] = {kLanes * sizeof(unsigned)};
  const cuuint32_t box[2] = {kSlabCols, (cuuint32_t)sub_box_rows(table_rows)};
  const cuuint32_t steps[2] = {1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_UINT32, 2, const_cast<void*>(x), dims,
      strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

cudaError_t allow_take_smem(int slab) {
  cudaError_t err = cudaFuncSetAttribute(
      flat_take_resident<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      take_smem(slab));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(flat_take_resident<false>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              take_smem(slab));
}

cudaError_t allow_sub_smem(int table_rows) {
  const int smem = sub_smem(table_rows);
  cudaError_t err = cudaFuncSetAttribute(
      sublane_gather_persistent<true>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(sublane_gather_persistent<false>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem);
}

bool valid_slab(int slab) {
  return slab > 0 && slab % 4 == 0 && slab <= kMaxTakeSlab;
}

}  // namespace

extern "C" {

// x, idx, out (rows, 128), 4-byte words. Returns a cudaError_t.
int gdf_probe_lane_gather(const void* x, const void* idx, void* out,
                          long long rows, int fill, void* stream) {
  if (rows <= 0) return rows == 0 ? 0 : (int)cudaErrorInvalidValue;
  const long long blocks = (rows + kGatherWarps - 1) / kGatherWarps;
  auto* kernel = aligned16(x) && aligned16(idx) && aligned16(out)
                     ? &lane_gather_rows<true>
                     : &lane_gather_rows<false>;
  kernel<<<(unsigned)blocks, kGatherThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned*>(x), static_cast<const int*>(idx),
      static_cast<unsigned*>(out), rows, (unsigned)fill);
  GDF_LAUNCH_CHECK();
  return 0;
}

// *blocks = the sublane gather's blocks an SM holds at once for a table of
// table_rows rows. Returns a cudaError_t.
int gdf_probe_sublane_occupancy(int table_rows, int* blocks) {
  if (table_rows <= 0 || table_rows > kMaxSubTableRows) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = allow_sub_smem(table_rows);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, sublane_gather_persistent<true>, kSubThreads,
      sub_smem(table_rows));
}

// x (table_rows, 128); idx, out (rows, 128); chunk_rows and grid from the
// wrapper's sublane_plan. Returns a cudaError_t.
int gdf_probe_sublane_gather(const void* x, int table_rows, const void* idx,
                             void* out, long long rows, int fill,
                             int chunk_rows, int grid, void* stream) {
  if (table_rows <= 0 || table_rows > kMaxSubTableRows || rows < 0 ||
      chunk_rows <= 0 || chunk_rows % kSubWarps != 0 ||
      chunk_rows > kSubWarps * kSubRowsInFlight || grid <= 0 ||
      grid % 4 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (rows == 0) return 0;
  cudaError_t err = allow_sub_smem(table_rows);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap map = {};
  const bool tma = aligned16(x);
  if (tma) {
    err = sub_tensor_map(&map, x, table_rows);
    if (err != cudaSuccess) return (int)err;
  }
  auto* kernel = tma ? &sublane_gather_persistent<true>
                     : &sublane_gather_persistent<false>;
  kernel<<<(unsigned)grid, kSubThreads, sub_smem(table_rows),
           static_cast<cudaStream_t>(stream)>>>(
      map, static_cast<const unsigned*>(x), table_rows,
      sub_box_rows(table_rows), static_cast<const int*>(idx),
      static_cast<unsigned*>(out), rows, (unsigned)fill, chunk_rows);
  GDF_LAUNCH_CHECK();
  return 0;
}

// *blocks = the blocks of flat_take_resident holding `slab` words that an
// SM holds at once. Returns a cudaError_t.
int gdf_probe_flat_take_occupancy(int slab, int* blocks) {
  if (!valid_slab(slab)) return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_take_smem(slab);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, flat_take_resident<true>, kTakeThreads, take_smem(slab));
}

// table (table_n,); idx, out (n,); slab and grid from the wrapper's
// take_plan / take_grid. Returns a cudaError_t.
int gdf_probe_flat_take(const void* table, long long table_n,
                        const void* idx, void* out, long long n, int fill,
                        int slab, int grid, void* stream) {
  if (table_n <= 0 || n < 0 || grid <= 0 || !valid_slab(slab) ||
      !aligned4(table) || !aligned4(idx) || !aligned4(out)) {
    return (int)cudaErrorInvalidValue;
  }
  if (n == 0) return 0;
  cudaError_t err = allow_take_smem(slab);
  if (err != cudaSuccess) return (int)err;
  const auto* i = static_cast<const int*>(idx);
  auto* kernel = aligned16(i + head_words(out, n)) ? &flat_take_resident<true>
                                                   : &flat_take_resident<false>;
  kernel<<<(unsigned)grid, kTakeThreads, take_smem(slab),
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned*>(table), table_n, slab, i,
      static_cast<unsigned*>(out), n, (unsigned)fill);
  GDF_LAUNCH_CHECK();
  return 0;
}

}  // extern "C"
