// H8 `elementwise`: add / sub / mul of two float columns, and a column
// compared with a scalar, each in one pass with the denormal flush (C7) in
// the registers of its load.
//
// Replaces no TPU kernel. The JAX package's elementwise ops are XLA
// fusions, and XLA reads a denormal float as zero wherever it enters
// arithmetic or a comparison. The port flushed each float input with three
// torch passes (abs, a compare, a multiply by the 0 / 1 mask), then ran the
// op, and copied a compare's bool result to an int8 stencil: a float64
// compare of 60M rows made five passes where one reads the column once.
//
// Bound: device memory. An arithmetic op reads each column operand once and
// writes its result; a compare reads the column and writes one byte a row.
// TPC-H Q6 at SF 10 (60M rows): two int32 and three float64 compares, 2.2
// GB, 0.66 ms at 3.35 TB/s; Q1's four float64 ops over ~59M rows, 4.8 GB.
//
// Semantics (ops/elementwise.py): each float input is flushed in its own
// dtype, before any widening: |x| < finfo.tiny becomes a zero of x's sign;
// NaN, +-inf and +-0 pass. Arithmetic is computed in the promoted dtype
// (float64 if either input is) and stored unflushed. A compare flushes the
// column's float values; the scalar is flushed on the host, in the column's
// dtype. An integer column compared with a float scalar is compared in
// float64 (each value rounded as a conversion to float64 rounds it); with
// an integer scalar, in the column's own dtype, the scalar wrapped to it as
// torch converts it. The result is the int8 stencil, 1 where the row
// passes.
//
// Design.
//   One launch a call; the op is a run-time argument, switched once a
//   kernel, so that only the dtypes are template parameters (12 arithmetic
//   and 10 compare instances). A grid of as many 256-thread blocks as the
//   SMs hold (4 an SM, 64 registers a thread), never more than the rows
//   need, strides over the rows. Where every operand read as a column and
//   the output are 16-byte aligned, a step of a thread is the elements of
//   one 16-byte load of its widest column (2 float64s, 4 float32s or
//   int32s, 16 int8s), the narrower operand and the output moved in one
//   load or store each; the threads of a warp take adjacent steps, so that
//   each of its loads reads 512 contiguous bytes, and a thread issues the
//   loads of 2 steps a grid apart before it uses any. At Q6's and Q1's
//   shapes that ran at 85-89% of the byte bound, against 76-88% for 16
//   elements a thread in adjacent 16-byte loads (a warp load at a stride
//   of 128 bytes); 4 steps spilled, and 8 blocks an SM (32 registers)
//   spilled more (PERF.md §6). The rows past the last whole step, and
//   every row of a view that is not aligned, take the scalar path. An
//   operand of stride 0 (a literal broadcast to the column's length) is
//   one element, loaded and flushed once a thread. Launch parameters come
//   from the row count and the card's SM count, read once per card and
//   process: nothing is tuned or timed at run time.
#include "common.cuh"

#include <float.h>
#include <math.h>
#include <string.h>

#include <type_traits>

namespace {

constexpr int kThreads = gdf::kThreads;
constexpr int kBlocksPerSM = 4;
constexpr int kMaxDevices = 64;
constexpr int kUnroll = 2;       // steps a thread has in flight at once

// ops/kernels/elementwise.py::ARITH_OPS and CMP_OPS
enum : int { kAdd = 0, kSub = 1, kMul = 2 };
enum : int { kEq = 0, kNe = 1, kLt = 2, kLe = 3, kGt = 4, kGe = 5 };
// the shape of the arithmetic operands
enum : int { kColumns = 0, kScalarA = 1, kScalarB = 2, kShapes = 3 };

// A denormal is a zero of its own sign; everything else passes.
template <typename T>
__host__ __device__ __forceinline__ T flush(T x) {
  return x;
}
template <>
__host__ __device__ __forceinline__ float flush(float x) {
  return fabsf(x) < FLT_MIN ? copysignf(0.0f, x) : x;
}
template <>
__host__ __device__ __forceinline__ double flush(double x) {
  return fabs(x) < DBL_MIN ? copysign(0.0, x) : x;
}

// The word of N bytes that a thread moves at once.
template <int N> struct Word;
template <> struct Word<2> { using type = unsigned short; };
template <> struct Word<4> { using type = unsigned int; };
template <> struct Word<8> { using type = uint2; };
template <> struct Word<16> { using type = uint4; };

// K elements of T from / to memory aligned to their K * sizeof(T) bytes,
// in one load or store.
template <typename T, int K>
__device__ __forceinline__ void load(const T* __restrict__ p, T (&v)[K]) {
  using W = typename Word<K * sizeof(T)>::type;
  const W w = *reinterpret_cast<const W*>(p);
  memcpy(v, &w, sizeof(W));
}

template <typename T, int K>
__device__ __forceinline__ void store(T* __restrict__ p, const T (&v)[K]) {
  using W = typename Word<K * sizeof(T)>::type;
  W w;
  memcpy(&w, v, sizeof(W));
  *reinterpret_cast<W*>(p) = w;
}

template <int OP, typename C>
__device__ __forceinline__ C arith(C x, C y) {
  if (OP == kAdd) return x + y;
  if (OP == kSub) return x - y;
  return x * y;
}

template <int OP, typename S>
__device__ __forceinline__ signed char cmp(S x, S y) {
  if (OP == kEq) return x == y;
  if (OP == kNe) return x != y;
  if (OP == kLt) return x < y;
  if (OP == kLe) return x <= y;
  if (OP == kGt) return x > y;
  return x >= y;
}

__device__ __forceinline__ long long thread_index() {
  return (long long)blockIdx.x * blockDim.x + threadIdx.x;
}

__device__ __forceinline__ long long thread_count() {
  return (long long)gridDim.x * blockDim.x;
}

// -- arithmetic --------------------------------------------------------------

template <typename TA, typename TB>
using Promoted = typename std::conditional<
    std::is_same<TA, double>::value || std::is_same<TB, double>::value,
    double, float>::type;

// Elements a thread takes a step: a 16-byte load of the wider operand.
template <typename TA, typename TB>
__host__ __device__ constexpr int arith_step() {
  return 16 / (sizeof(TA) > sizeof(TB) ? sizeof(TA) : sizeof(TB));
}

template <int OP, int SHAPE, typename TA, typename TB>
__device__ __forceinline__ void arith_rows(const TA* __restrict__ a,
                                           const TB* __restrict__ b,
                                           Promoted<TA, TB>* __restrict__ out,
                                           long long n, bool aligned) {
  using C = Promoted<TA, TB>;
  constexpr int K = arith_step<TA, TB>();
  const C sa = SHAPE == kScalarA ? (C)flush(a[0]) : C(0);
  const C sb = SHAPE == kScalarB ? (C)flush(b[0]) : C(0);
  const long long first = thread_index(), stride = thread_count();
  long long tail = 0;
  if (aligned) {
    const long long steps = n / K;
    for (long long s0 = first; s0 < steps; s0 += kUnroll * stride) {
      TA va[kUnroll][K];
      TB vb[kUnroll][K];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long s = s0 + u * stride;
        if (s < steps) {
          if (SHAPE != kScalarA) load<TA, K>(a + s * K, va[u]);
          if (SHAPE != kScalarB) load<TB, K>(b + s * K, vb[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long s = s0 + u * stride;
        if (s < steps) {
          C r[K];
#pragma unroll
          for (int k = 0; k < K; ++k) {
            const C x = SHAPE == kScalarA ? sa : (C)flush(va[u][k]);
            const C y = SHAPE == kScalarB ? sb : (C)flush(vb[u][k]);
            r[k] = arith<OP, C>(x, y);
          }
          store<C, K>(out + s * K, r);
        }
      }
    }
    tail = steps * K;
  }
  for (long long i = tail + first; i < n; i += stride) {
    const C x = SHAPE == kScalarA ? sa : (C)flush(a[i]);
    const C y = SHAPE == kScalarB ? sb : (C)flush(b[i]);
    out[i] = arith<OP, C>(x, y);
  }
}

template <typename TA, typename TB, int SHAPE>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
elementwise_binary(int op, const TA* __restrict__ a, const TB* __restrict__ b,
                   Promoted<TA, TB>* __restrict__ out, long long n,
                   bool aligned) {
  switch (op) {
    case kAdd: arith_rows<kAdd, SHAPE>(a, b, out, n, aligned); break;
    case kSub: arith_rows<kSub, SHAPE>(a, b, out, n, aligned); break;
    default: arith_rows<kMul, SHAPE>(a, b, out, n, aligned); break;
  }
}

// -- compare with a scalar ---------------------------------------------------

// S is the type compared in: T itself, or double for an integer column
// against a float scalar.
template <int OP, typename T, typename S>
__device__ __forceinline__ void compare_rows(const T* __restrict__ x, S v,
                                             signed char* __restrict__ out,
                                             long long n, bool aligned) {
  constexpr int K = 16 / sizeof(T);    // a 16-byte load of the column
  const long long first = thread_index(), stride = thread_count();
  long long tail = 0;
  if (aligned) {
    const long long steps = n / K;
    for (long long s0 = first; s0 < steps; s0 += kUnroll * stride) {
      T vx[kUnroll][K];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long s = s0 + u * stride;
        if (s < steps) load<T, K>(x + s * K, vx[u]);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long s = s0 + u * stride;
        if (s < steps) {
          signed char r[K];
#pragma unroll
          for (int k = 0; k < K; ++k) {
            r[k] = cmp<OP, S>((S)flush(vx[u][k]), v);
          }
          store<signed char, K>(out + s * K, r);
        }
      }
    }
    tail = steps * K;
  }
  for (long long i = tail + first; i < n; i += stride) {
    out[i] = cmp<OP, S>((S)flush(x[i]), v);
  }
}

template <typename T, typename S>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
elementwise_compare(int op, const T* __restrict__ x, S v,
                    signed char* __restrict__ out, long long n,
                    bool aligned) {
  switch (op) {
    case kEq: compare_rows<kEq>(x, v, out, n, aligned); break;
    case kNe: compare_rows<kNe>(x, v, out, n, aligned); break;
    case kLt: compare_rows<kLt>(x, v, out, n, aligned); break;
    case kLe: compare_rows<kLe>(x, v, out, n, aligned); break;
    case kGt: compare_rows<kGt>(x, v, out, n, aligned); break;
    default: compare_rows<kGe>(x, v, out, n, aligned); break;
  }
}

// -- launch ------------------------------------------------------------------

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Make `device` current (remembering the card that was) and give its SM
// count, read once per card and process.
int enter(int device, int* was, int* sms) {
  if (device < 0 || device >= kMaxDevices) {
    return (int)cudaErrorInvalidDevice;
  }
  cudaError_t err = cudaGetDevice(was);
  if (err == cudaSuccess && *was != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  static int count[kMaxDevices] = {};
  if (count[device] == 0) {
    err = cudaDeviceGetAttribute(&count[device],
                                 cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return (int)err;
  }
  *sms = count[device];
  return 0;
}

// The launch's error, with the card that was current made current again.
int leave(int device, int was) {
  const int err = (int)cudaGetLastError();
  if (was != device) cudaSetDevice(was);
  return err;
}

// Blocks for `work` items a thread-step: as many as the SMs hold, fewer
// where the rows need fewer, at least one.
unsigned grid_for(long long work, int sms) {
  const long long need = (work + kThreads - 1) / kThreads;
  const long long most = (long long)sms * kBlocksPerSM;
  return (unsigned)(need < 1 ? 1 : need < most ? need : most);
}

template <typename TA, typename TB, int SHAPE>
void launch_binary(int op, const void* a, const void* b, void* out,
                   long long n, int sms, cudaStream_t s) {
  const bool aligned = (SHAPE == kScalarA || aligned16(a)) &&
                       (SHAPE == kScalarB || aligned16(b)) && aligned16(out);
  constexpr int K = arith_step<TA, TB>();
  const long long work = aligned ? n / K + n % K : n;
  elementwise_binary<TA, TB, SHAPE><<<grid_for(work, sms), kThreads, 0, s>>>(
      op, static_cast<const TA*>(a), static_cast<const TB*>(b),
      static_cast<Promoted<TA, TB>*>(out), n, aligned);
}

template <typename TA, typename TB>
void launch_binary_shape(int shape, int op, const void* a, const void* b,
                         void* out, long long n, int sms, cudaStream_t s) {
  if (shape == kScalarA) {
    launch_binary<TA, TB, kScalarA>(op, a, b, out, n, sms, s);
  } else if (shape == kScalarB) {
    launch_binary<TA, TB, kScalarB>(op, a, b, out, n, sms, s);
  } else {
    launch_binary<TA, TB, kColumns>(op, a, b, out, n, sms, s);
  }
}

template <typename T, typename S>
void launch_compare(int op, const void* x, S v, void* out, long long n,
                    int sms, cudaStream_t s) {
  const bool aligned = aligned16(x) && aligned16(out);
  constexpr int K = 16 / sizeof(T);
  const long long work = aligned ? n / K + n % K : n;
  elementwise_compare<T, S><<<grid_for(work, sms), kThreads, 0, s>>>(
      op, static_cast<const T*>(x), v, static_cast<signed char*>(out), n,
      aligned);
}

// An integer column against an integer scalar (wrapped to T, as torch
// converts a scalar to the column's dtype) or a float scalar (in float64).
template <typename T>
void launch_compare_int(int op, const void* x, int as_double,
                        long long vi, double vd, void* out, long long n,
                        int sms, cudaStream_t s) {
  if (as_double) {
    launch_compare<T, double>(op, x, flush(vd), out, n, sms, s);
  } else {
    launch_compare<T, T>(op, x, (T)vi, out, n, sms, s);
  }
}

}  // namespace

extern "C" {

// out[i] = flush(a[i]) OP flush(b[i]) in the promoted dtype, i < n, for op
// 0 add, 1 sub, 2 mul; a and b each float32 or float64 (gdf::dtype codes 5,
// 6); shape 1: a is one element (stride 0), 2: b is, 0: neither. Launches
// on `stream` of card `device`. Returns a cudaError_t.
int gdf_elementwise_binary(int op, int a_dtype, int b_dtype, int shape,
                           const void* a, const void* b, void* out,
                           long long n, int device, void* stream) {
  using namespace gdf::dtype;
  const bool fa = a_dtype == kF32 || a_dtype == kF64;
  const bool fb = b_dtype == kF32 || b_dtype == kF64;
  if (op < kAdd || op > kMul || !fa || !fb || shape < 0 || shape >= kShapes ||
      n < 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (n == 0) return 0;
  int was = 0, sms = 0;
  int err = enter(device, &was, &sms);
  if (err != 0) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a_dtype == kF64 && b_dtype == kF64) {
    launch_binary_shape<double, double>(shape, op, a, b, out, n, sms, s);
  } else if (a_dtype == kF64) {
    launch_binary_shape<double, float>(shape, op, a, b, out, n, sms, s);
  } else if (b_dtype == kF64) {
    launch_binary_shape<float, double>(shape, op, a, b, out, n, sms, s);
  } else {
    launch_binary_shape<float, float>(shape, op, a, b, out, n, sms, s);
  }
  return leave(device, was);
}

// out[i] = x[i] OP v as an int8 0 / 1, i < n, for op 0 eq, 1 ne, 2 lt, 3
// le, 4 gt, 5 ge (gdf_comparison_operator's order); x of gdf::dtype int8
// to int64, float32 or float64. A float column is flushed and compared
// with vd in its dtype (rounded to it and flushed here, on the host); an
// integer column with vd in float64 where as_double is set (vd flushed),
// else with vi wrapped to the column's dtype. Returns a cudaError_t.
int gdf_elementwise_compare(int op, int dtype, const void* x, int as_double,
                            long long vi, double vd, void* out, long long n,
                            int device, void* stream) {
  using namespace gdf::dtype;
  if (op < kEq || op > kGe || dtype == kU8 || dtype < 0 || dtype >= kTypes ||
      n < 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (n == 0) return 0;
  int was = 0, sms = 0;
  int err = enter(device, &was, &sms);
  if (err != 0) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kI8:
      launch_compare_int<signed char>(op, x, as_double, vi, vd, out, n, sms,
                                      s);
      break;
    case kI16:
      launch_compare_int<short>(op, x, as_double, vi, vd, out, n, sms, s);
      break;
    case kI32:
      launch_compare_int<int>(op, x, as_double, vi, vd, out, n, sms, s);
      break;
    case kI64:
      launch_compare_int<long long>(op, x, as_double, vi, vd, out, n, sms,
                                    s);
      break;
    case kF32:
      launch_compare<float, float>(op, x, flush((float)vd), out, n, sms, s);
      break;
    default:
      launch_compare<double, double>(op, x, flush(vd), out, n, sms, s);
      break;
  }
  return leave(device, was);
}

}  // extern "C"
