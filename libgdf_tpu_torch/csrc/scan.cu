// H2 `scan` and H3 `seg_scan`: inclusive (segmented) prefix scans.
//
// Replaces, from libgdf_tpu/ops/pallas/scan.py:
//   H2 (no flags): _val_kernel / _run_val / scan_pallas (K2, l.101/745/801).
//       The same template at int64 and float64 is the Hopper form of
//       _sum64_kernel / cumsum64_pallas (K4a, l.215/664) and _sumff_kernel
//       / cumsum_f64_pallas (K5a, l.340/428): prefixsum and the window's
//       float64 prefix sums reach them through engine.cumsum.
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
// Bound: device memory. H2 reads the input once and writes the output
// once, 2 x n x sizeof(T) bytes (88 MB for 11M int32); H3 also reads n
// flag bytes (99 MB for 11M float32, 170 MB for 10M 8-byte values).
//
// Design: both are one template, scan_lookback<T, K, REV, FLAGS>, a single
// pass with decoupled look-back (lookback.cuh): one memset of the tile
// descriptors, then one launch. Each block takes the next tile from a
// global counter. A tile is 32 KB of values (8192 4-byte or 4096 8-byte
// elements): 256 threads x 8 vectors of 16 bytes, loaded straight into
// registers (32 KB tiles timed faster than 16 KB on an H100, since the
// per-tile cost of the counter, the look-back and three barriers is paid
// half as often, and 64 KB tiles were no faster). The vectors are
// warp-striped (vector j of a lane sits next to the same vector of the
// lane beside it), so each load instruction of a warp reads 512
// contiguous bytes and no shared-memory staging is needed; the price is
// eight warp scans per warp instead of one (blocked vectors with one warp
// scan timed slower). The block publishes its aggregate, one warp looks
// back until it meets an inclusive prefix, the block publishes its own
// inclusive prefix and writes its output with 16-byte stores. Float sums
// combine predecessors in whatever grouping the look-back found, so their
// rounding may differ from run to run, as CUB's does; integer results are
// exact.
//   H2 (FLAGS false): a reverse scan maps logical i to n-1-i in the loads
//   and stores (the logical array is padded at its front to whole vectors,
//   so the vectors stay aligned).
//   H3 (FLAGS true; forward only, as no caller asks for a reverse one):
//   each 16-byte vector of values comes with its flag bytes in one 4-byte
//   (4-byte T) or 2-byte (8-byte T) load, kept as one bit per element. A
//   warp's segmented scan takes the lanes' flags from one ballot, so each
//   step shuffles the value alone. The descriptor carries the tile's flag
//   beside its status, and a tile whose aggregate is flagged publishes it
//   as its inclusive prefix at once, before it looks back; the look-back
//   stops at the first flagged aggregate. At groups of ~4 rows nearly
//   every look-back is one step; with no flag at all it walks as H2's
//   does. `carry` rereads a value from the input only at positions with no
//   flag at or before them (a prefix of the array), so it keeps no second
//   copy of the tile in registers.
// Misaligned views (values, output or flags) and the ragged last tile take
// a scalar path through the same registers.
//
// Denormals (float and double sums). XLA reads a denormal float as zero
// wherever it enters a sum; CUDA adds it. So a float sum flushes every
// element where it is loaded, |v| < the type's smallest normal becoming
// a zero of v's sign: one compare and one select in registers, so the
// scan stays bound by memory, where a separate flush pass over the input
// would cost about as much as the scan. Results are not flushed.
#include "lookback.cuh"

#include <float.h>
#include <math.h>
#include <type_traits>

namespace {

using gdf::Descs;
using gdf::kAggregate;
using gdf::kPrefix;

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

// The element as a float sum reads it (FTZ): a denormal is a signed zero.
template <bool FTZ, typename T> __device__ __forceinline__ T load_value(T v) {
  return v;
}
template <> __device__ __forceinline__ float load_value<true, float>(float v) {
  return fabsf(v) < FLT_MIN ? copysignf(0.0f, v) : v;
}
template <> __device__ __forceinline__ double load_value<true, double>(double v) {
  return fabs(v) < DBL_MIN ? copysign(0.0, v) : v;
}

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

constexpr int kScanThreads = 256;
constexpr int kScanWarps = kScanThreads / 32;
constexpr int kVecs = 8;                                 // per thread
constexpr int kTileBytes = kScanThreads * kVecs * 16;    // 32 KB of values

template <typename T> struct Geom {
  static constexpr int kVecElems = 16 / sizeof(T);
  static constexpr int kTileElems = kTileBytes / sizeof(T);
};

template <typename T> struct alignas(16) Vec {
  T v[16 / sizeof(T)];
};

// Logical element i of the scan is physical element i, or n-1-i for a
// reverse scan over a logical array of nl = n rounded up to whole vectors
// whose first nl-n elements are padding. Valid iff nl-n <= i < nl. With
// FLAGS, flags[i] != 0 starts a segment at i. A float sum reads denormal
// elements as zeros.
template <typename T, int K, bool REV, bool FLAGS>
__global__ void __launch_bounds__(kScanThreads)
scan_lookback(const T* __restrict__ in, const unsigned char* __restrict__ flags,
              T* __restrict__ out, long long n, long long nl, bool aligned,
              Descs d) {
  static_assert(!(REV && FLAGS), "segmented scans run forward only");
  constexpr bool FTZ = K == kSum && std::is_floating_point<T>::value;
  using G = Geom<T>;
  using O = Op<T, K>;
  constexpr int E = G::kVecElems;
  __shared__ long long s_tile;
  __shared__ T s_warp[kScanWarps];
  __shared__ unsigned s_wflag[kScanWarps];
  __shared__ T s_prefix;
  __shared__ unsigned s_pflag;
  const long long tile = gdf::next_tile(d, &s_tile);
  const long long base = tile * G::kTileElems;
  const long long pad = nl - n;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const bool full = aligned && base >= pad && base + G::kTileElems <= nl;

  T x[kVecs][E];
  unsigned fl = 0;  // FLAGS: bit j * E + e is the flag of x[j][e]
#pragma unroll
  for (int j = 0; j < kVecs; ++j) {
    const long long first =
        base + ((long long)(warp * kVecs + j) * 32 + lane) * E;
    if (full) {
      const Vec<T> v = *reinterpret_cast<const Vec<T>*>(
          in + (REV ? nl - first - E : first));
#pragma unroll
      for (int e = 0; e < E; ++e) {
        x[j][e] = load_value<FTZ>(v.v[REV ? E - 1 - e : e]);
      }
      if constexpr (FLAGS) {
        unsigned w;
        if constexpr (E == 4) {
          w = *reinterpret_cast<const unsigned*>(flags + first);
        } else {
          w = *reinterpret_cast<const unsigned short*>(flags + first);
        }
        fl |= gdf::nonzero_bytes(w) << (j * E);
      }
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const long long i = first + e;
        const bool ok = i >= pad && i < nl;
        x[j][e] = ok ? load_value<FTZ>(in[REV ? nl - 1 - i : i]) : O::ident();
        if constexpr (FLAGS) {
          if (ok && flags[i]) fl |= 1u << (j * E + e);
        }
      }
    }
  }

  // Each vector's own scan, then one warp scan per vector slot: pre[j] is
  // what comes before vector j of this lane within the warp (with FLAGS,
  // bit j of pre_f is its flag).
  T pre[kVecs];
  unsigned pre_f = 0;
  T carry = O::ident();
  bool carry_f = false;
#pragma unroll
  for (int j = 0; j < kVecs; ++j) {
    if constexpr (FLAGS) {
      const unsigned fv = (fl >> (j * E)) & ((1u << E) - 1u);
#pragma unroll
      for (int e = 1; e < E; ++e) {
        if (!((fv >> e) & 1u)) x[j][e] = O::apply(x[j][e - 1], x[j][e]);
      }
      const unsigned heads = __ballot_sync(0xffffffffu, fv != 0);
      const T inc = gdf::seg_warp_inclusive<T, O>(x[j][E - 1], heads);
      T exc = __shfl_up_sync(0xffffffffu, inc, 1);
      if (lane == 0) exc = O::ident();
      const bool exc_f = (heads & ((1u << lane) - 1u)) != 0;
      pre[j] = exc_f ? exc : O::apply(carry, exc);
      if (carry_f || exc_f) pre_f |= 1u << j;
      const T tot = __shfl_sync(0xffffffffu, inc, 31);
      carry = heads ? tot : O::apply(carry, tot);
      carry_f = carry_f || heads != 0;
    } else {
#pragma unroll
      for (int e = 1; e < E; ++e) x[j][e] = O::apply(x[j][e - 1], x[j][e]);
      const T inc = gdf::warp_inclusive<T, O>(x[j][E - 1]);
      T exc = __shfl_up_sync(0xffffffffu, inc, 1);
      if (lane == 0) exc = O::ident();
      pre[j] = O::apply(carry, exc);
      carry = O::apply(carry, __shfl_sync(0xffffffffu, inc, 31));
    }
  }
  if (lane == 0) {
    s_warp[warp] = carry;
    if constexpr (FLAGS) s_wflag[warp] = carry_f;
  }
  __syncthreads();

  if (warp == 0) {
    const T w = lane < kScanWarps ? s_warp[lane] : O::ident();
    T winc;
    unsigned agg_f = 0;
    bool wexc_f = false;
    if constexpr (FLAGS) {
      const unsigned heads =
          __ballot_sync(0xffffffffu, lane < kScanWarps && s_wflag[lane]);
      winc = gdf::seg_warp_inclusive<T, O>(w, heads);
      agg_f = heads != 0;
      wexc_f = (heads & ((1u << lane) - 1u)) != 0;
    } else {
      winc = gdf::warp_inclusive<T, O>(w);
    }
    const T agg = __shfl_sync(0xffffffffu, winc, kScanWarps - 1);
    T wexc = __shfl_up_sync(0xffffffffu, winc, 1);
    if (lane == 0) wexc = O::ident();
    if (lane < kScanWarps) {
      s_warp[lane] = wexc;
      if constexpr (FLAGS) s_wflag[lane] = wexc_f;
    }
    T prefix = O::ident();
    unsigned pf = 0;
    if (tile == 0) {
      if (lane == 0) gdf::publish<T>(d, 0, kPrefix, agg, agg_f);
    } else if (FLAGS && agg_f) {
      // combine(anything, (1, agg)) = (1, agg): the tile's inclusive prefix
      // is known before its look-back, so successors need not wait for it.
      if (lane == 0) gdf::publish<T>(d, tile, kPrefix, agg, 1u);
      prefix = gdf::look_back<T, O, FLAGS>(d, tile, &pf);
    } else {
      if (lane == 0) gdf::publish<T>(d, tile, kAggregate, agg);
      prefix = gdf::look_back<T, O, FLAGS>(d, tile, &pf);
      if (lane == 0) {
        gdf::publish<T>(d, tile, kPrefix, O::apply(prefix, agg), pf);
      }
    }
    if (lane == 0) {
      s_prefix = prefix;
      s_pflag = pf;
    }
  }
  __syncthreads();

  T before = O::apply(s_prefix, s_warp[warp]);
  bool before_f = false;
  if constexpr (FLAGS) {
    before_f = s_pflag || s_wflag[warp];
    if (s_wflag[warp]) before = s_warp[warp];
  }
#pragma unroll
  for (int j = 0; j < kVecs; ++j) {
    const long long first =
        base + ((long long)(warp * kVecs + j) * 32 + lane) * E;
    T p = O::apply(before, pre[j]);
    bool p_f = false;
    unsigned fv = 0;
    if constexpr (FLAGS) {
      if ((pre_f >> j) & 1u) p = pre[j];
      p_f = before_f || ((pre_f >> j) & 1u);
      fv = (fl >> (j * E)) & ((1u << E) - 1u);
    }
    // The result at element e of vector j, physical index i.
    auto result = [&](int e, long long i) -> T {
      if constexpr (FLAGS) {
        const bool own_f = (fv & ((2u << e) - 1u)) != 0;
        if (K == kCarry && !own_f && !p_f) return in[i];
        return own_f ? x[j][e] : O::apply(p, x[j][e]);
      } else {
        return O::apply(p, x[j][e]);
      }
    };
    if (full) {
      Vec<T> v;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        v.v[REV ? E - 1 - e : e] = result(e, first + e);
      }
      *reinterpret_cast<Vec<T>*>(out + (REV ? nl - first - E : first)) = v;
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const long long i = first + e;
        if (i >= pad && i < nl) {
          const long long phys = REV ? nl - 1 - i : i;
          out[phys] = result(e, phys);
        }
      }
    }
  }
}

template <typename T> long long padded_len(long long n) {
  const long long e = Geom<T>::kVecElems;
  return (n + e - 1) / e * e;
}

template <typename T> long long tile_count(long long n) {
  return (padded_len<T>(n) + Geom<T>::kTileElems - 1) / Geom<T>::kTileElems;
}

template <typename T> long long scratch_bytes(long long n) {
  return gdf::lookback_scratch_bytes<T>(tile_count<T>(n));
}

bool is_aligned(const void* p, uintptr_t to) {
  return reinterpret_cast<uintptr_t>(p) % to == 0;
}

template <typename T, int K, bool REV, bool FLAGS>
int launch(const T* in, const unsigned char* flags, T* out, long long n,
           long long nl, bool aligned, void* scratch, long long nbytes,
           cudaStream_t s) {
  if (n <= 0) return 0;
  Descs d;
  const int err =
      gdf::init_scratch(scratch, nbytes, scratch_bytes<T>(n), s, &d);
  if (err != 0) return err;
  scan_lookback<T, K, REV, FLAGS>
      <<<(unsigned)tile_count<T>(n), kScanThreads, 0, s>>>(in, flags, out, n,
                                                           nl, aligned, d);
  GDF_LAUNCH_CHECK();
  return 0;
}

template <typename T, int K>
int launch_scan(const T* in, T* out, long long n, bool reverse, void* scratch,
                long long nbytes, cudaStream_t s) {
  const bool aligned = is_aligned(in, 16) && is_aligned(out, 16);
  if (reverse) {
    return launch<T, K, true, false>(in, nullptr, out, n, padded_len<T>(n),
                                     aligned, scratch, nbytes, s);
  }
  return launch<T, K, false, false>(in, nullptr, out, n, n, aligned, scratch,
                                    nbytes, s);
}

template <typename T>
int dispatch_scan(int kind, int reverse, const void* in, void* out,
                  long long n, void* scratch, long long nbytes,
                  cudaStream_t s) {
  const T* x = static_cast<const T*>(in);
  T* y = static_cast<T*>(out);
  switch (kind) {
    case kSum: return launch_scan<T, kSum>(x, y, n, reverse, scratch, nbytes, s);
    case kMax: return launch_scan<T, kMax>(x, y, n, reverse, scratch, nbytes, s);
    case kMin: return launch_scan<T, kMin>(x, y, n, reverse, scratch, nbytes, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int dispatch_seg(int kind, const void* flags, const void* in, void* out,
                 long long n, void* scratch, long long nbytes,
                 cudaStream_t s) {
  const unsigned char* f = static_cast<const unsigned char*>(flags);
  const T* x = static_cast<const T*>(in);
  T* y = static_cast<T*>(out);
  // one flag byte per element: a vector's flags are E bytes at first
  const bool a = is_aligned(x, 16) && is_aligned(y, 16) &&
                 is_aligned(f, Geom<T>::kVecElems);
  switch (kind) {
    case kSum: return launch<T, kSum, false, true>(x, f, y, n, n, a, scratch, nbytes, s);
    case kMax: return launch<T, kMax, false, true>(x, f, y, n, n, a, scratch, nbytes, s);
    case kMin: return launch<T, kMin, false, true>(x, f, y, n, n, a, scratch, nbytes, s);
    case kCarry: return launch<T, kCarry, false, true>(x, f, y, n, n, a, scratch, nbytes, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

long long dispatch_scratch_bytes(int dtype, long long n) {
  switch (dtype) {
    case 0: return scratch_bytes<int>(n);
    case 1: return scratch_bytes<long long>(n);
    case 2: return scratch_bytes<float>(n);
    case 3: return scratch_bytes<double>(n);
    default: return -1;
  }
}

}  // namespace

extern "C" {

// dtype: 0 int32, 1 int64, 2 float32, 3 float64.

// Bytes of scratch (tile counter and descriptors) that gdf_scan needs for
// n elements; -1 for an unknown dtype.
long long gdf_scan_scratch_bytes(int dtype, long long n) {
  return dispatch_scratch_bytes(dtype, n);
}

// H2. kind: 0 sum, 1 max, 2 min; reverse != 0 scans suffixes. scratch:
// gdf_scan_scratch_bytes(dtype, n) bytes, zeroed here on the stream.
// Returns a cudaError_t (0 on success).
int gdf_scan(int dtype, int kind, int reverse, const void* in, void* out,
             long long n, void* scratch, long long nbytes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long b = nbytes;
  switch (dtype) {
    case 0: return dispatch_scan<int>(kind, reverse, in, out, n, scratch, b, s);
    case 1: return dispatch_scan<long long>(kind, reverse, in, out, n, scratch, b, s);
    case 2: return dispatch_scan<float>(kind, reverse, in, out, n, scratch, b, s);
    case 3: return dispatch_scan<double>(kind, reverse, in, out, n, scratch, b, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Bytes of scratch that gdf_seg_scan needs for n elements; -1 for an
// unknown dtype. (The same tiles as gdf_scan's.)
long long gdf_seg_scan_scratch_bytes(int dtype, long long n) {
  return dispatch_scratch_bytes(dtype, n);
}

// H3. kind: 0 sum, 1 max, 2 min, 3 carry. flags: uint8[n] segment heads
// (non-zero starts a segment). scratch: gdf_seg_scan_scratch_bytes(dtype,
// n) bytes, zeroed here on the stream. Returns a cudaError_t.
int gdf_seg_scan(int dtype, int kind, const void* flags, const void* in,
                 void* out, long long n, void* scratch, long long nbytes,
                 void* stream) {
  if (flags == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long b = nbytes;
  switch (dtype) {
    case 0: return dispatch_seg<int>(kind, flags, in, out, n, scratch, b, s);
    case 1: return dispatch_seg<long long>(kind, flags, in, out, n, scratch, b, s);
    case 2: return dispatch_seg<float>(kind, flags, in, out, n, scratch, b, s);
    case 3: return dispatch_seg<double>(kind, flags, in, out, n, scratch, b, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* gdf_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
