// P-6 / P-7, the lane-rotation probes: `reps` times
//   x = roll(x, s_i, axis=1) + 1,   out[:, j] = x[:, (j - s) mod 128]
// (np.roll's direction) over int32 rows of 128 lanes.
//
// Replaces benchmarks/probe_roll.py:38 `_kernel_static` (s_i = 1 + i % 7,
// fixed at compile time) and :46 `_kernel_dynamic` (s_i = s[i % 8], read
// at run time), which price a static against a dynamic `pltpu.roll`.
//
// Bound: operations. The block is read and written once (2 x 256 KB for
// 512 rows), but each repetition moves and adds every element: 1024 x
// 65,536 x 2 operations, 0.002 ms at 67 T 32-bit operations/s, against
// 0.00016 ms for the bytes.
//
// Design: one warp per 128-lane row, held in registers all along: lane l
// holds elements l, l + 32, l + 64, l + 96. A rotation by s = 32 a + b is
// one __shfl_sync of each of the 4 registers by b lanes, then a select
// among the registers by a (plus one where the lane wrapped: l < b). The
// static kernel takes s as a template constant (a 7-way switch over i % 7,
// each case unrolled), so a and b fold away; the dynamic one computes them
// from a register, which costs the register select.
#include "common.cuh"

namespace {

constexpr int kLanes = 128;
constexpr int kRollThreads = 256;
constexpr int kRowsPerBlock = kRollThreads / 32;
constexpr int kShifts = 8;                      // the dynamic probe's s

__device__ __forceinline__ int pick(const int (&y)[4], int k) {
  return k == 0 ? y[0] : k == 1 ? y[1] : k == 2 ? y[2] : y[3];
}

// v = roll(v, s) for s in [0, 128), one row per warp.
__device__ __forceinline__ void roll_row(int (&v)[4], int s) {
  const int lane = threadIdx.x & 31;
  const int b = s & 31;
  int y[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    y[r] = __shfl_sync(0xffffffffu, v[r], (lane - b) & 31);
  }
  const int c = (s >> 5) + (lane < b ? 1 : 0);
#pragma unroll
  for (int r = 0; r < 4; ++r) v[r] = pick(y, (r - c) & 3);
}

template <int S>
__device__ __forceinline__ void roll_row_const(int (&v)[4]) {
  constexpr int a = S >> 5;
  constexpr int b = S & 31;
  const int lane = threadIdx.x & 31;
  int y[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    y[r] = __shfl_sync(0xffffffffu, v[r], (lane - b) & 31);
  }
  const bool wrapped = lane < b;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    v[r] = wrapped ? y[(r - a - 1) & 3] : y[(r - a) & 3];
  }
}

__device__ __forceinline__ void add_one(int (&v)[4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r) v[r] = (int)((unsigned)v[r] + 1u);
}

__global__ void __launch_bounds__(kRollThreads)
roll_static_rows(const int* __restrict__ x, int* __restrict__ out,
                 long long rows, int reps) {
  const long long row =
      (long long)blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;                      // whole warps only
  const int lane = threadIdx.x & 31;
  int v[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) v[r] = x[row * kLanes + lane + 32 * r];
  int m = 0;                                    // i % 7
  for (int i = 0; i < reps; ++i) {
    switch (m) {
      case 0: roll_row_const<1>(v); break;
      case 1: roll_row_const<2>(v); break;
      case 2: roll_row_const<3>(v); break;
      case 3: roll_row_const<4>(v); break;
      case 4: roll_row_const<5>(v); break;
      case 5: roll_row_const<6>(v); break;
      default: roll_row_const<7>(v); break;
    }
    add_one(v);
    m = m == 6 ? 0 : m + 1;
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) out[row * kLanes + lane + 32 * r] = v[r];
}

// shifts: kShifts int32, any sign (taken mod 128).
__global__ void __launch_bounds__(kRollThreads)
roll_dynamic_rows(const int* __restrict__ shifts, const int* __restrict__ x,
                  int* __restrict__ out, long long rows, int reps) {
  const long long row =
      (long long)blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  int s[kShifts];
#pragma unroll
  for (int u = 0; u < kShifts; ++u) {
    s[u] = ((shifts[u] % kLanes) + kLanes) % kLanes;
  }
  int v[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) v[r] = x[row * kLanes + lane + 32 * r];
  for (int i = 0; i < reps; i += kShifts) {
#pragma unroll
    for (int u = 0; u < kShifts; ++u) {
      if (i + u < reps) {
        roll_row(v, s[u]);
        add_one(v);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) out[row * kLanes + lane + 32 * r] = v[r];
}

}  // namespace

extern "C" {

// x, out int32 (rows, 128). Returns a cudaError_t.
int gdf_probe_roll_static(const void* x, void* out, long long rows, int reps,
                          void* stream) {
  if (rows < 0 || reps < 0) return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  const long long blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  roll_static_rows<<<(unsigned)blocks, kRollThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(x), static_cast<int*>(out), rows, reps);
  GDF_LAUNCH_CHECK();
  return 0;
}

// shifts int32 (8,); x, out int32 (rows, 128). Returns a cudaError_t.
int gdf_probe_roll_dynamic(const void* shifts, const void* x, void* out,
                           long long rows, int reps, void* stream) {
  if (rows < 0 || reps < 0) return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  const long long blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  roll_dynamic_rows<<<(unsigned)blocks, kRollThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(shifts), static_cast<const int*>(x),
      static_cast<int*>(out), rows, reps);
  GDF_LAUNCH_CHECK();
  return 0;
}

}  // extern "C"
