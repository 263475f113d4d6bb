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
// 65,536 x 2 operations, 0.0020 ms at 67 T 32-bit operations/s, against
// 0.00016 ms for the bytes. Neither is reachable: the repetitions form a
// dependent chain, and one SHFL + IADD step of a warp takes 32.6 clocks
// on an H100 (37.6 with four independent shuffles a step, as here), so
// 1024 repetitions take at least 0.0169 ms at 1.98 GHz (chip_smoke.py's
// probe path measures this floor with clock64).
//
// Every repetition is one real rotation: each element crosses lanes by
// one __shfl_sync (4 a lane), then gets + 1. Nothing is folded across
// repetitions (rotation commutes with + 1, so folding would compute the
// same numbers and price nothing).
//
// Layout: one warp a row, lane l holding elements 4l .. 4l+3 (one 16-byte
// load and store a lane). For s = 4q + r, output register k takes source
// element 4l + k - s: register (k - r) & 3 of lane (l - q - [k < r]) & 31.
// The source register is the same on every lane, so the per-lane part
// lives in the shuffle's source lane and no select follows the shuffle
// (tests/test_torch_probes.py::lane_model is this arithmetic in numpy,
// renamed_model the dynamic kernel's).
// Blocks of 4 warps put the probe's 512 rows on 128 SMs, one warp a
// scheduler; 2 rows a warp (16 lanes x 8 registers) and 8-warp blocks
// measured slower on an H100 (PERF.md §6).
//
// Static: s = 1 .. 7 are template constants, so each rotation is 4 SHFL +
// 4 IADD with constant registers; the loop runs whole periods of 7
// straight-line rotations and the reps % 7 tail after it.
// Dynamic: the 8 shifts are read from device memory; q, r and the two
// source lanes (l - q, l - q - 1) of each are computed once. The source
// register (k - r) & 3 differs by shift, so the registers are renamed, not
// moved: logical register k lives in physical register (k + c) & 3 for a
// warp-uniform c, each shuffle sends and receives one physical register,
// and what a repetition pays for its run-time shift is the choice of each
// register's source lane from c and its shift (a 4-bit mask from the
// shift and the group's offset, then a select, off the data chain). The
// store undoes the renaming. Uniform selects of the
// source register before each shuffle, and a warp-uniform branch into
// four bodies, measured slower than renaming on an H100 (PERF.md §6).
// The loop runs whole groups of the 8 shifts, then the reps % 8 tail.
#include "common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kLanes = 128;
constexpr int kRollThreads = 128;               // 4 warps, one a scheduler
constexpr int kRowsPerBlock = kRollThreads / 32;
constexpr int kShifts = 8;                      // the dynamic probe's s
constexpr int kPeriod = 7;                      // the static probe's 1 .. 7

// Lane l's four elements of its row: one 16-byte access where both
// pointers allow it (`vec`), four 4-byte ones otherwise.
__device__ __forceinline__ void load4(const int* __restrict__ p, bool vec,
                                      unsigned (&v)[4]) {
  if (vec) {
    const int4 t = *reinterpret_cast<const int4*>(p);
    v[0] = (unsigned)t.x;
    v[1] = (unsigned)t.y;
    v[2] = (unsigned)t.z;
    v[3] = (unsigned)t.w;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = (unsigned)p[k];
  }
}

__device__ __forceinline__ void store4(int* __restrict__ p, bool vec,
                                       const unsigned (&v)[4]) {
  if (vec) {
    *reinterpret_cast<int4*>(p) =
        make_int4((int)v[0], (int)v[1], (int)v[2], (int)v[3]);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) p[k] = (int)v[k];
  }
}

__device__ __forceinline__ bool aligned16(const void* a, const void* b) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) &
          15) == 0;
}

// v = roll(v, S) + 1 for a constant S in [1, 8); src[d] = (lane - d) & 31.
template <int S>
__device__ __forceinline__ void roll_const(unsigned (&v)[4],
                                           const int (&src)[3]) {
  constexpr int q = S >> 2;
  constexpr int r = S & 3;
  unsigned y[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    y[k] = __shfl_sync(kFull, v[(k - r) & 3], src[q + (k < r ? 1 : 0)]) +
           1u;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) v[k] = y[k];
}

__global__ void __launch_bounds__(kRollThreads)
roll_static_rows(const int* __restrict__ x, int* __restrict__ out,
                 long long rows, int reps) {
  const long long row =
      (long long)blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;                      // whole warps only
  const int lane = threadIdx.x & 31;
  const bool vec = aligned16(x, out);
  int src[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) src[d] = (lane - d) & 31;
  unsigned v[4];
  load4(x + row * kLanes + 4 * lane, vec, v);
#pragma unroll 1
  for (int g = reps / kPeriod; g > 0; --g) {
    roll_const<1>(v, src);
    roll_const<2>(v, src);
    roll_const<3>(v, src);
    roll_const<4>(v, src);
    roll_const<5>(v, src);
    roll_const<6>(v, src);
    roll_const<7>(v, src);
  }
  const int tail = reps % kPeriod;
  if (tail > 0) roll_const<1>(v, src);
  if (tail > 1) roll_const<2>(v, src);
  if (tail > 2) roll_const<3>(v, src);
  if (tail > 3) roll_const<4>(v, src);
  if (tail > 4) roll_const<5>(v, src);
  if (tail > 5) roll_const<6>(v, src);
  store4(out + row * kLanes + 4 * lane, vec, v);
}

// One shift of the dynamic probe, ready for its rotations: the source
// lanes lo = (lane - q) & 31 and hi = (lane - q - 1) & 31, pre = r_0 + ..
// + r_u over the shifts up to this one, and wrap, which says which
// physical registers take hi (below).
struct Shift {
  int lo, hi, pre, wrap;
};

// v = roll(v, s) + 1 on renamed registers. Logical register k lives in
// physical register (k + c) & 3, with c = c0 - pre after this shift (c0
// the offset at the start of the group of 8). Physical register j then
// holds logical (j - c) & 3, which takes its source from hi where that is
// below r: bit j of the 4-bit mask (1 << r) - 1 rotated left by c. wrap
// is that mask rotated by -pre and doubled (times 0x11), so the bits for
// offset c0 are bits 4 .. 7 of wrap << c0; they depend on no earlier
// rotation of the group.
__device__ __forceinline__ void roll_renamed(unsigned (&v)[4],
                                             const Shift& s, int c0) {
  const int m = (s.wrap << c0) >> 4;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    v[j] = __shfl_sync(kFull, v[j], (m >> j) & 1 ? s.hi : s.lo) + 1u;
  }
}

// shifts: kShifts int32, any sign (taken mod 128).
__global__ void __launch_bounds__(kRollThreads)
roll_dynamic_rows(const int* __restrict__ shifts, const int* __restrict__ x,
                  int* __restrict__ out, long long rows, int reps) {
  const long long row =
      (long long)blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const bool vec = aligned16(x, out);
  Shift sh[kShifts];
  int pre = 0;
#pragma unroll
  for (int u = 0; u < kShifts; ++u) {
    const int s = ((shifts[u] % kLanes) + kLanes) % kLanes;
    const int r = s & 3;
    pre += r;
    const int m = (1 << r) - 1;
    const int k = -pre & 3;
    sh[u].lo = (lane - (s >> 2)) & 31;
    sh[u].hi = (lane - (s >> 2) - 1) & 31;
    sh[u].pre = pre;
    sh[u].wrap = (((m << k) | (m >> (4 - k))) & 15) * 0x11;
  }
  unsigned v[4];
  load4(x + row * kLanes + 4 * lane, vec, v);
  int c0 = 0;
#pragma unroll 1
  for (int g = reps / kShifts; g > 0; --g) {
#pragma unroll
    for (int u = 0; u < kShifts; ++u) roll_renamed(v, sh[u], c0);
    c0 = (c0 - pre) & 3;
  }
  const int tail = reps % kShifts;
  int c = c0;
#pragma unroll
  for (int u = 0; u < kShifts - 1; ++u) {
    if (u < tail) {
      roll_renamed(v, sh[u], c0);
      c = (c0 - sh[u].pre) & 3;
    }
  }
  unsigned o[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int j = (k + c) & 3;
    o[k] = j == 0 ? v[0] : j == 1 ? v[1] : j == 2 ? v[2] : v[3];
  }
  store4(out + row * kLanes + 4 * lane, vec, o);
}

unsigned roll_blocks(long long rows) {
  return (unsigned)((rows + kRowsPerBlock - 1) / kRowsPerBlock);
}

}  // namespace

extern "C" {

// x, out int32 (rows, 128). Returns a cudaError_t.
int gdf_probe_roll_static(const void* x, void* out, long long rows, int reps,
                          void* stream) {
  if (rows < 0 || reps < 0) return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  roll_static_rows<<<roll_blocks(rows), kRollThreads, 0,
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
  roll_dynamic_rows<<<roll_blocks(rows), kRollThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(shifts), static_cast<const int*>(x),
      static_cast<int*>(out), rows, reps);
  GDF_LAUNCH_CHECK();
  return 0;
}

}  // extern "C"
