// P-8 .. P-11, P-13, P-14: the capability probes of
// benchmarks/probe_pallas_caps.py, each computing what its probe computes
// (P-12, `p5`, is the lane gather of probe_gather.cu at int32):
//
//   cap_dyn_store       <- :40  `p1`  store 8 rows into a zeroed (32, 128)
//                                     scratch at a run-time row offset
//                                     x[0, 0] + 3, output its first rows
//   cap_cumsum2d        <- :54  `p2`  cumsum over axis 0, then axis 1
//   cap_onehot_compact  <- :89  `p3`  stable compaction of each 256-element
//                                     tile by a one-hot matrix product
//   cap_bulk_copy       <- :114 `p4`  step b stages x[8b:8b+8] + 1000 and
//                                     copies it to out rows [5b, 5b + 8)
//   cap_carry           <- :157 `p6`  a sum carried across 8-row tiles
//   cap_dyn_loop        <- :176 `p7`  a loop of run-time trip count
//                                     (x[0, 0] & 7) + 2 over rows x[i & 7]
//
// On the TPU these ask whether Mosaic lowers a feature at all; on CUDA each
// does by construction, and the kernels are a self-test. All but P-10 move
// a few KB and are bound by their launch; P-10 is bound by device memory at
// scale (12 bytes an element).
//
// P-10 design: the TPU multiplies the payload, split in two 16-bit halves,
// by a 256 x 256 one-hot matrix in float32. Here the int32 payload is split
// into 4 byte planes (the A operand, 16 x 256 u8 with 12 rows of zeros),
// multiplied by the 0/1 one-hot matrix (B, 256 x 256 u8, B[i][d] = 1 where
// element i is kept and its exclusive prefix count is d) on the tensor
// cores with wmma u8 x u8 -> s32 at m16n16k16, and the 4 result planes are
// recombined with shifts. Each output sums at most one nonzero product, so
// the result is exact, where TF32 or bf16 would round. A is stored
// column-major (element i's 16 planes are one 16-byte word: its 4 bytes and
// 12 zeros) and B as contiguous 16 x 16 tiles, so that every fragment
// pointer is 32-byte aligned. Destinations rise with the source, so the
// kept elements of a k-tile of 16 sources land in at most two n-tiles:
// only the B tiles that hold a one (at most 32 of 256, flagged in shared
// memory) are zeroed and multiplied. Kept elements past the count leave
// zeros.
//
// P-11 design: one CUDA block loops over the steps (the TPU's sequential
// grid) with the row offset carried in a register; each step's staged rows
// go from shared to device memory with one cp.async.bulk (a 512-byte row
// keeps address and size 16-byte aligned), completed before the next step
// so that a later step's rows overwrite an earlier one's, as on the TPU.
#include <mma.h>

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
constexpr size_t kCompactSmem =
    kCompactTile * kCompactTile                 // B, u8
    + 16 * kCompactTile                         // A, u8
    + 16 * kCompactTile * sizeof(int);          // C, s32: 84 KB in all

__global__ void __launch_bounds__(kThreads)
cap_dyn_store(const int* __restrict__ x, int* __restrict__ out, int rows) {
  __shared__ int s[kScratchRows * kLanes];
  for (int e = threadIdx.x; e < kScratchRows * kLanes; e += kThreads) {
    s[e] = 0;
  }
  __syncthreads();
  // the wrapper checks that rows [start, start + 8) fit; the guard keeps
  // the store inside the scratch all the same
  const int start = (int)((unsigned)x[0] + 3u);
  if (start >= 0 && start <= kScratchRows - kStoreRows) {
    for (int e = threadIdx.x; e < kStoreRows * kLanes; e += kThreads) {
      s[start * kLanes + e] = x[e];
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < rows * kLanes; e += kThreads) out[e] = s[e];
}

// One block of 128 threads: a column per thread, then a row per warp step.
__global__ void __launch_bounds__(kLanes)
cap_cumsum2d(const int* __restrict__ x, int* __restrict__ out, int rows) {
  __shared__ unsigned s[kCumRows * kLanes];
  const int j = threadIdx.x;
  unsigned acc = 0;
  for (int r = 0; r < rows; ++r) {
    acc += (unsigned)x[r * kLanes + j];
    s[r * kLanes + j] = acc;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < rows; r += kLanes / 32) {
    unsigned v[4];
    unsigned run = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      run += s[r * kLanes + 4 * lane + q];
      v[q] = run;
    }
    unsigned inc = run;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const unsigned y = __shfl_up_sync(0xffffffffu, inc, d);
      if (lane >= d) inc += y;
    }
    const unsigned before = inc - run;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      out[r * kLanes + 4 * lane + q] = (int)(v[q] + before);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
cap_onehot_compact(const int* __restrict__ x, const int* __restrict__ keep,
                   int* __restrict__ out) {
  using namespace nvcuda;
  static_assert(kThreads == kCompactTile, "one thread per element");
  extern __shared__ __align__(128) unsigned char s_mem[];
  unsigned char* s_b = s_mem;                            // 16 x 16 tiles
  unsigned char* s_a = s_b + kCompactTile * kCompactTile;  // column-major
  int* s_c = reinterpret_cast<int*>(s_a + 16 * kCompactTile);
  __shared__ int warp_tot[kWarps];
  __shared__ unsigned char s_nz[16 * 16];       // B tile (kt, nt) holds a 1
  const long long base = (long long)blockIdx.x * kCompactTile;
  const int i = threadIdx.x;
  const int v = x[base + i];
  const int k = keep[base + i] != 0;
  s_nz[i] = 0;
  int total;
  const int dest = gdf::block_exclusive_sum(k, warp_tot, &total);
  if (k) s_nz[(i >> 4) * 16 + (dest >> 4)] = 1;
  reinterpret_cast<int4*>(s_a)[i] = make_int4(v, 0, 0, 0);  // 16 planes of i
  __syncthreads();
  int4* b4 = reinterpret_cast<int4*>(s_b);
  for (int e = i; e < kCompactTile * kCompactTile / 16; e += kThreads) {
    if (s_nz[e >> 4]) b4[e] = make_int4(0, 0, 0, 0);
  }
  __syncthreads();
  if (k) {
    s_b[((i >> 4) * 16 + (dest >> 4)) * 256 + (i & 15) * 16 + (dest & 15)] =
        1;
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  wmma::fragment<wmma::matrix_a, 16, 16, 16, unsigned char, wmma::col_major>
      fa;
  wmma::fragment<wmma::matrix_b, 16, 16, 16, unsigned char, wmma::row_major>
      fb;
  wmma::fragment<wmma::accumulator, 16, 16, 16, int> fc;
  for (int nt = warp; nt < 16; nt += kWarps) {
    wmma::fill_fragment(fc, 0);
    for (int kt = 0; kt < 16; ++kt) {
      if (!s_nz[kt * 16 + nt]) continue;        // the same for the warp
      wmma::load_matrix_sync(fa, s_a + kt * 256, 16);
      wmma::load_matrix_sync(fb, s_b + (kt * 16 + nt) * 256, 16);
      wmma::mma_sync(fc, fa, fb, fc);
    }
    wmma::store_matrix_sync(s_c + nt * 16, fc, kCompactTile,
                            wmma::mem_row_major);
  }
  __syncthreads();
  const unsigned w = (unsigned)s_c[i] | (unsigned)s_c[kCompactTile + i] << 8 |
                     (unsigned)s_c[2 * kCompactTile + i] << 16 |
                     (unsigned)s_c[3 * kCompactTile + i] << 24;
  out[base + i] = (int)w;
}

__global__ void __launch_bounds__(kThreads)
cap_bulk_copy(const int* __restrict__ x, int* __restrict__ out, int steps) {
  __shared__ __align__(128) int stage[kStepRows * kLanes];
  int off = 0;                                  // carried across the steps
  for (int b = 0; b < steps; ++b) {
    for (int e = threadIdx.x; e < kStepRows * kLanes; e += kThreads) {
      stage[e] = (int)((unsigned)x[b * kStepRows * kLanes + e] + 1000u);
    }
    // the bulk copy reads shared memory through the async proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (threadIdx.x == 0) {
      const unsigned src =
          static_cast<unsigned>(__cvta_generic_to_shared(stage));
      asm volatile(
          "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
          :: "l"(reinterpret_cast<unsigned long long>(
                 out + (long long)off * kLanes)),
             "r"(src),
             "r"((unsigned)(kStepRows * kLanes * sizeof(int)))
          : "memory");
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();                            // stage is free again
    off += kStepAdvance;
  }
}

__global__ void __launch_bounds__(kThreads)
cap_carry(const int* __restrict__ x, int* __restrict__ out, int tiles) {
  __shared__ unsigned warp_tot[kWarps];
  const int lane = threadIdx.x & 31;
  unsigned acc = 0;                             // thread 0 carries the sum
  for (int t = 0; t < tiles; ++t) {
    unsigned part = 0;
    for (int e = threadIdx.x; e < kStepRows * kLanes; e += kThreads) {
      part += (unsigned)x[t * kStepRows * kLanes + e];
    }
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      part += __shfl_xor_sync(0xffffffffu, part, d);
    }
    if (lane == 0) warp_tot[threadIdx.x >> 5] = part;
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int w = 0; w < kWarps; ++w) acc += warp_tot[w];
      out[0] = (int)acc;
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads)
cap_dyn_loop(const int* __restrict__ x, int* __restrict__ out, int cols) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= cols) return;
  const int n = (x[0] & 7) + 2;
  unsigned acc = 0;
  for (int i = 0; i < n; ++i) acc += (unsigned)x[(i & 7) * cols + j];
  out[j] = (int)acc;
}

cudaStream_t as_stream(void* stream) {
  return static_cast<cudaStream_t>(stream);
}

}  // namespace

extern "C" {

// x int32 (rows, 128), 8 <= rows <= 32; out (rows, 128).
int gdf_probe_cap_dyn_store(const void* x, void* out, int rows,
                            void* stream) {
  if (rows < kStoreRows || rows > kScratchRows) {
    return (int)cudaErrorInvalidValue;
  }
  cap_dyn_store<<<1, kThreads, 0, as_stream(stream)>>>(
      static_cast<const int*>(x), static_cast<int*>(out), rows);
  GDF_LAUNCH_CHECK();
  return 0;
}

// x, out int32 (rows, 128), 1 <= rows <= 64.
int gdf_probe_cap_cumsum2d(const void* x, void* out, int rows,
                           void* stream) {
  if (rows < 1 || rows > kCumRows) return (int)cudaErrorInvalidValue;
  cap_cumsum2d<<<1, kLanes, 0, as_stream(stream)>>>(
      static_cast<const int*>(x), static_cast<int*>(out), rows);
  GDF_LAUNCH_CHECK();
  return 0;
}

// x, keep, out int32 (n,), n a multiple of 256; each 256-element tile is
// compacted on its own.
int gdf_probe_cap_onehot_compact(const void* x, const void* keep, void* out,
                                 long long n, void* stream) {
  if (n < 0 || n % kCompactTile != 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      cap_onehot_compact, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kCompactSmem);
  if (err != cudaSuccess) return (int)err;
  cap_onehot_compact<<<(unsigned)(n / kCompactTile), kThreads, kCompactSmem,
                       as_stream(stream)>>>(
      static_cast<const int*>(x), static_cast<const int*>(keep),
      static_cast<int*>(out));
  GDF_LAUNCH_CHECK();
  return 0;
}

// x, out int32 (8 * steps, 128); out 16-byte aligned. Rows past
// 5 (steps - 1) + 8 are not written.
int gdf_probe_cap_bulk_copy(const void* x, void* out, int steps,
                            void* stream) {
  if (steps < 1 || reinterpret_cast<uintptr_t>(out) % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  cap_bulk_copy<<<1, kThreads, 0, as_stream(stream)>>>(
      static_cast<const int*>(x), static_cast<int*>(out), steps);
  GDF_LAUNCH_CHECK();
  return 0;
}

// x int32 (8 * tiles, 128); out int32 (1, 1).
int gdf_probe_cap_carry(const void* x, void* out, int tiles, void* stream) {
  if (tiles < 1) return (int)cudaErrorInvalidValue;
  cap_carry<<<1, kThreads, 0, as_stream(stream)>>>(
      static_cast<const int*>(x), static_cast<int*>(out), tiles);
  GDF_LAUNCH_CHECK();
  return 0;
}

// x int32 (8, cols); out int32 (1, cols).
int gdf_probe_cap_dyn_loop(const void* x, void* out, int cols,
                           void* stream) {
  if (cols < 1) return (int)cudaErrorInvalidValue;
  cap_dyn_loop<<<(unsigned)((cols + kThreads - 1) / kThreads), kThreads, 0,
                 as_stream(stream)>>>(static_cast<const int*>(x),
                                      static_cast<int*>(out), cols);
  GDF_LAUNCH_CHECK();
  return 0;
}

}  // extern "C"
