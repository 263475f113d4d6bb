// H2 `scan` and H3 `seg_scan`: inclusive (segmented) prefix scans.
//
// Replaces, from libgdf_tpu/ops/pallas/scan.py:
//   H2 (no flags): _val_kernel / _run_val / scan_pallas (K2, l.101/745/801).
//       The same template at int64 and float64 is the Hopper form of
//       _sum64_kernel (K4a, l.215) and _sumff_kernel (K5a, l.340), which
//       are not wired yet (their callers, ops/scan.py and window, are not
//       ported).
//   H3 (flags):   _pair_kernel / _run_pair / scan_pallas_pair (K3, l.122/
//       772/808), _seg_sum64_kernel (K4b, l.241), _seg_sumff_kernel (K5b,
//       l.366) and _seg_sel64_kernel (K6, l.551). The TPU split 64-bit
//       values into u32 hi/lo or f32 double-float pairs because Mosaic has
//       no 64-bit lanes; here int64 and double are native, so one template
//       covers {int32, int64, float32, float64} x {sum, max, min, carry}.
//       The 64-bit min/max of K6 runs as `min`/`max` over the caller's
//       order-preserving int64 encodings, which keeps its NaN order.
//
// Semantics. An element is a pair (flag, value); the scan applies
//   combine((fa, va), (fb, vb)) = (fa | fb, fb ? vb : op(va, vb))
// with op = +, max or min, or op(a, b) = a for `carry`. Without flags this
// is a plain inclusive scan. For `carry`, a position with no flag at or
// before it keeps its own value (scan.py:153-156). Integer sums wrap;
// float max/min propagate NaN, as torch.maximum / jnp.maximum do.
//
// Bound: device memory. The scan reads the input twice (passes 1 and 3)
// and writes it once: ~3 x n x sizeof(T) bytes, plus 2n flag bytes. At
// n = 11M int32 that is ~130 MB. A single-pass decoupled look-back scan
// would move 2x; that is later work.
//
// Design: reduce-then-scan in three launches.
//   1. tile_reduce: the aggregate pair of each 2048-element tile.
//   2. tile_prefix: one block turns the tile aggregates into exclusive tile
//      prefixes, 2048 at a time, with a running carry.
//   3. tile_scan: each tile rescans itself with its prefix as carry-in.
// Tiles go through shared memory so that global loads and stores are
// coalesced; each thread scans 8 consecutive elements in registers and a
// warp-shuffle block scan joins the threads.
#include "common.cuh"

#include <math.h>

namespace {

using gdf::kItems;
using gdf::kThreads;
using gdf::kTile;
using gdf::kWarps;

enum Kind { kSum = 0, kMax = 1, kMin = 2, kCarry = 3 };

template <typename T> struct Limits;
template <> struct Limits<int> {
  static __device__ int lowest() { return INT32_MIN; }
  static __device__ int highest() { return INT32_MAX; }
};
template <> struct Limits<long long> {
  static __device__ long long lowest() { return INT64_MIN; }
  static __device__ long long highest() { return INT64_MAX; }
};
template <> struct Limits<float> {
  static __device__ float lowest() { return -INFINITY; }
  static __device__ float highest() { return INFINITY; }
};
template <> struct Limits<double> {
  static __device__ double lowest() { return -INFINITY; }
  static __device__ double highest() { return INFINITY; }
};

template <typename T> __device__ __forceinline__ bool is_nan(T) { return false; }
template <> __device__ __forceinline__ bool is_nan<float>(float v) { return v != v; }
template <> __device__ __forceinline__ bool is_nan<double>(double v) { return v != v; }

// Wrapping integer addition (signed overflow is undefined in C++).
template <typename T> __device__ __forceinline__ T add(T a, T b) { return a + b; }
template <> __device__ __forceinline__ int add<int>(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}
template <> __device__ __forceinline__ long long add<long long>(long long a, long long b) {
  return (long long)((unsigned long long)a + (unsigned long long)b);
}

template <typename T, int K> struct Op;
template <typename T> struct Op<T, kSum> {
  static __device__ T ident() { return T(0); }
  static __device__ T apply(T a, T b) { return add(a, b); }
};
template <typename T> struct Op<T, kMax> {
  static __device__ T ident() { return Limits<T>::lowest(); }
  static __device__ T apply(T a, T b) {
    if (is_nan(a)) return a;
    if (is_nan(b)) return b;
    return b > a ? b : a;
  }
};
template <typename T> struct Op<T, kMin> {
  static __device__ T ident() { return Limits<T>::highest(); }
  static __device__ T apply(T a, T b) {
    if (is_nan(a)) return a;
    if (is_nan(b)) return b;
    return b < a ? b : a;
  }
};
template <typename T> struct Op<T, kCarry> {
  static __device__ T ident() { return T(0); }
  static __device__ T apply(T a, T) { return a; }
};

template <typename T> struct Pair {
  int f;
  T v;
};

template <typename T, int K>
__device__ __forceinline__ Pair<T> identity() {
  Pair<T> r;
  r.f = 0;
  r.v = Op<T, K>::ident();
  return r;
}

template <typename T, int K>
__device__ __forceinline__ Pair<T> combine(Pair<T> a, Pair<T> b) {
  Pair<T> r;
  r.f = a.f | b.f;
  r.v = b.f ? b.v : Op<T, K>::apply(a.v, b.v);
  return r;
}

template <typename T>
__device__ __forceinline__ Pair<T> shfl_up(Pair<T> p, int d) {
  Pair<T> r;
  r.f = __shfl_up_sync(0xffffffffu, p.f, d);
  r.v = __shfl_up_sync(0xffffffffu, p.v, d);
  return r;
}

// Exclusive scan over the block of one pair per thread; `*total` gets the
// block's aggregate. Every thread of the block must call it.
template <typename T, int K>
__device__ Pair<T> block_exclusive(Pair<T> x, Pair<T>* warp_tot,
                                   Pair<T>* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  Pair<T> inc = x;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    Pair<T> y = shfl_up(inc, d);
    if (lane >= d) inc = combine<T, K>(y, inc);
  }
  Pair<T> exc = shfl_up(inc, 1);
  if (lane == 0) exc = identity<T, K>();
  if (lane == 31) warp_tot[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    Pair<T> w = lane < kWarps ? warp_tot[lane] : identity<T, K>();
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      Pair<T> y = shfl_up(w, d);
      if (lane >= d) w = combine<T, K>(y, w);
    }
    if (lane < kWarps) warp_tot[lane] = w;
  }
  __syncthreads();
  Pair<T> pre = warp > 0 ? warp_tot[warp - 1] : identity<T, K>();
  *total = warp_tot[kWarps - 1];
  __syncthreads();
  return combine<T, K>(pre, exc);
}

// Coalesced load of one tile into shared memory, then each thread takes its
// kItems consecutive pairs. Positions past n are identity pairs.
template <typename T, int K, bool FLAGS>
__device__ __forceinline__ void load_tile(const unsigned char* flags,
                                          const T* in, long long n,
                                          long long base, T* s_v,
                                          unsigned char* s_f,
                                          Pair<T> (&items)[kItems]) {
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int idx = i * kThreads + threadIdx.x;
    const long long g = base + idx;
    const bool ok = g < n;
    s_v[idx] = ok ? in[g] : Op<T, K>::ident();
    s_f[idx] = (FLAGS && ok) ? (flags[g] != 0) : 0;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    items[i].v = s_v[threadIdx.x * kItems + i];
    items[i].f = s_f[threadIdx.x * kItems + i];
  }
  __syncthreads();
}

template <typename T, int K, bool FLAGS>
__global__ void __launch_bounds__(kThreads)
tile_reduce(const unsigned char* flags, const T* in, long long n,
            int* tile_f, T* tile_v) {
  __shared__ T s_v[kTile];
  __shared__ unsigned char s_f[kTile];
  __shared__ Pair<T> warp_tot[kWarps];
  Pair<T> items[kItems];
  load_tile<T, K, FLAGS>(flags, in, n, (long long)blockIdx.x * kTile, s_v,
                         s_f, items);
  Pair<T> agg = items[0];
#pragma unroll
  for (int i = 1; i < kItems; ++i) agg = combine<T, K>(agg, items[i]);
  Pair<T> total;
  block_exclusive<T, K>(agg, warp_tot, &total);
  if (threadIdx.x == 0) {
    tile_f[blockIdx.x] = total.f;
    tile_v[blockIdx.x] = total.v;
  }
}

// One block: tile aggregates -> exclusive tile prefixes, in place.
template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
tile_prefix(int* tile_f, T* tile_v, long long ntiles) {
  __shared__ T s_v[kTile];
  __shared__ unsigned char s_f[kTile];
  __shared__ Pair<T> warp_tot[kWarps];
  Pair<T> carry = identity<T, K>();
  for (long long base = 0; base < ntiles; base += kTile) {
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int idx = i * kThreads + threadIdx.x;
      const long long g = base + idx;
      const bool ok = g < ntiles;
      s_v[idx] = ok ? tile_v[g] : Op<T, K>::ident();
      s_f[idx] = ok ? (tile_f[g] != 0) : 0;
    }
    __syncthreads();
    Pair<T> items[kItems];
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      items[i].v = s_v[threadIdx.x * kItems + i];
      items[i].f = s_f[threadIdx.x * kItems + i];
    }
    __syncthreads();
    Pair<T> agg = items[0];
#pragma unroll
    for (int i = 1; i < kItems; ++i) agg = combine<T, K>(agg, items[i]);
    Pair<T> total;
    Pair<T> run = combine<T, K>(carry, block_exclusive<T, K>(agg, warp_tot,
                                                             &total));
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      s_v[threadIdx.x * kItems + i] = run.v;
      s_f[threadIdx.x * kItems + i] = (unsigned char)run.f;
      run = combine<T, K>(run, items[i]);
    }
    carry = combine<T, K>(carry, total);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int idx = i * kThreads + threadIdx.x;
      const long long g = base + idx;
      if (g < ntiles) {
        tile_v[g] = s_v[idx];
        tile_f[g] = s_f[idx];
      }
    }
    __syncthreads();
  }
}

template <typename T, int K, bool FLAGS>
__global__ void __launch_bounds__(kThreads)
tile_scan(const unsigned char* flags, const T* in, T* out, long long n,
          const int* tile_f, const T* tile_v) {
  __shared__ T s_v[kTile];
  __shared__ unsigned char s_f[kTile];
  __shared__ Pair<T> warp_tot[kWarps];
  const long long base = (long long)blockIdx.x * kTile;
  Pair<T> items[kItems];
  load_tile<T, K, FLAGS>(flags, in, n, base, s_v, s_f, items);
  T own[kItems];
#pragma unroll
  for (int i = 0; i < kItems; ++i) own[i] = items[i].v;
#pragma unroll
  for (int i = 1; i < kItems; ++i) items[i] = combine<T, K>(items[i - 1], items[i]);
  Pair<T> total;
  Pair<T> exc = block_exclusive<T, K>(items[kItems - 1], warp_tot, &total);
  Pair<T> pre;
  pre.f = tile_f[blockIdx.x];
  pre.v = tile_v[blockIdx.x];
  const Pair<T> p = combine<T, K>(pre, exc);
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const Pair<T> r = combine<T, K>(p, items[i]);
    s_v[threadIdx.x * kItems + i] = (K == kCarry && !r.f) ? own[i] : r.v;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int idx = i * kThreads + threadIdx.x;
    const long long g = base + idx;
    if (g < n) out[g] = s_v[idx];
  }
}

template <typename T, int K>
int launch(const unsigned char* flags, const T* in, T* out, long long n,
           int* tile_f, T* tile_v, cudaStream_t s) {
  if (n <= 0) return 0;
  const long long ntiles = (n + kTile - 1) / kTile;
  if (flags) {
    tile_reduce<T, K, true><<<(unsigned)ntiles, kThreads, 0, s>>>(
        flags, in, n, tile_f, tile_v);
  } else {
    tile_reduce<T, K, false><<<(unsigned)ntiles, kThreads, 0, s>>>(
        flags, in, n, tile_f, tile_v);
  }
  GDF_LAUNCH_CHECK();
  tile_prefix<T, K><<<1, kThreads, 0, s>>>(tile_f, tile_v, ntiles);
  GDF_LAUNCH_CHECK();
  if (flags) {
    tile_scan<T, K, true><<<(unsigned)ntiles, kThreads, 0, s>>>(
        flags, in, out, n, tile_f, tile_v);
  } else {
    tile_scan<T, K, false><<<(unsigned)ntiles, kThreads, 0, s>>>(
        flags, in, out, n, tile_f, tile_v);
  }
  GDF_LAUNCH_CHECK();
  return 0;
}

template <typename T>
int dispatch(int kind, const void* flags, const void* in, void* out,
             long long n, void* tile_f, void* tile_v, cudaStream_t s) {
  const unsigned char* f = static_cast<const unsigned char*>(flags);
  const T* x = static_cast<const T*>(in);
  T* y = static_cast<T*>(out);
  int* tf = static_cast<int*>(tile_f);
  T* tv = static_cast<T*>(tile_v);
  switch (kind) {
    case kSum: return launch<T, kSum>(f, x, y, n, tf, tv, s);
    case kMax: return launch<T, kMax>(f, x, y, n, tf, tv, s);
    case kMin: return launch<T, kMin>(f, x, y, n, tf, tv, s);
    case kCarry: return launch<T, kCarry>(f, x, y, n, tf, tv, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Elements per tile: the wrapper sizes the tile scratch as ceil(n / tile).
int gdf_scan_tile_elems() { return kTile; }

// dtype: 0 int32, 1 int64, 2 float32, 3 float64.
// kind: 0 sum, 1 max, 2 min, 3 carry. flags: uint8[n] segment heads, or
// NULL for a plain scan. tile_f: int32[ntiles], tile_v: T[ntiles] scratch.
// Returns a cudaError_t (0 on success).
int gdf_scan(int dtype, int kind, const void* flags, const void* in,
             void* out, long long n, void* tile_f, void* tile_v,
             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dispatch<int>(kind, flags, in, out, n, tile_f, tile_v, s);
    case 1: return dispatch<long long>(kind, flags, in, out, n, tile_f, tile_v, s);
    case 2: return dispatch<float>(kind, flags, in, out, n, tile_f, tile_v, s);
    case 3: return dispatch<double>(kind, flags, in, out, n, tile_f, tile_v, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* gdf_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
