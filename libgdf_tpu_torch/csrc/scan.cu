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
// H2: a single pass with decoupled look-back (Merrill & Garland, "Single-
// pass Parallel Prefix Scan with Decoupled Look-back", NVIDIA 2016).
//   Bound: device memory, 2 x n x sizeof(T) bytes (the input read once,
//   the output written once); 88 MB for 11M int32.
//   Design: one launch (after one memset of the tile descriptors). Each
//   block takes the next tile from a global counter, so tiles start in
//   order and a block only ever waits on blocks that are running. A tile
//   is 32 KB of values (8192 4-byte or 4096 8-byte elements): 256 threads
//   x 8 vectors of 16 bytes, loaded straight into registers: twice the
//   bytes per tile of 16 KB halves the per-tile cost (the counter, the
//   look-back, three barriers), which timed faster on an H100, while
//   64 KB tiles were no faster. The vectors are warp-striped (vector j of
//   a lane sits next to the same vector of the lane beside it), so each
//   load instruction of a warp reads 512 contiguous bytes and no
//   shared-memory staging is needed; the price is eight warp scans per
//   warp instead of one (blocked vectors with one warp scan timed
//   slower). The block publishes its
//   aggregate, one warp looks back over 32 predecessors at a time until it
//   meets an inclusive prefix, the block publishes its own inclusive
//   prefix and writes its output with 16-byte stores. A reverse scan maps
//   logical i to n-1-i in the loads and stores (the logical array is
//   padded at its front to whole vectors, so the vectors stay aligned).
//   Float sums combine predecessors in whatever grouping the look-back
//   found, so their rounding may differ from run to run, as CUB's does;
//   integer results are exact.
//   Descriptors: sizeof(T) / 4 words of 8 bytes per tile, each holding
//   the status in its high half and 32 bits of the value in its low half,
//   stored and loaded whole (st/ld.relaxed.gpu: an aligned 8-byte access
//   is single-copy atomic). A reader takes a descriptor only when all its
//   words carry the same status, so the two halves of an 8-byte value can
//   never come from the aggregate and the inclusive prefix; a torn read
//   counts as not yet published. No 16-byte store is assumed whole, and
//   the look-back needs no fence and no load that waits on another (a
//   separate status word behind __threadfence(), read with an acquire
//   load before the value, timed slower at 8 bytes).
//
// H3: reduce-then-scan in three launches (unchanged since its port).
//   Bound: it reads the input twice and writes it once: ~3 x n x sizeof(T)
//   bytes, plus 2n flag bytes.
//   1. tile_reduce: the aggregate pair of each 2048-element tile.
//   2. tile_prefix: one block turns the tile aggregates into exclusive tile
//      prefixes, 2048 at a time, with a running carry.
//   3. tile_scan: each tile rescans itself with its prefix as carry-in.
//   Tiles go through shared memory so that global loads and stores are
//   coalesced; each thread scans 8 consecutive elements in registers and a
//   warp-shuffle block scan joins the threads.
#include "common.cuh"

#include <math.h>
#include <string.h>

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

// ---- H2: single-pass scan with decoupled look-back ----------------------

constexpr int kScanThreads = 256;
constexpr int kScanWarps = kScanThreads / 32;
constexpr int kVecs = 8;                                 // per thread
constexpr int kTileBytes = kScanThreads * kVecs * 16;    // 32 KB of values
constexpr long long kDescBase = 16;  // scratch: tile counter, then descriptors

template <typename T> struct Geom {
  static constexpr int kVecElems = 16 / sizeof(T);
  static constexpr int kTileElems = kTileBytes / sizeof(T);
  static constexpr int kDescWords = sizeof(T) / 4;
};

template <typename T> struct alignas(16) Vec {
  T v[16 / sizeof(T)];
};

enum Status : unsigned { kInvalid = 0, kAggregate = 1, kPrefix = 2 };

struct Descs {
  unsigned* counter;           // the next tile to hand out
  unsigned long long* words;   // per tile: kDescWords x (status << 32 | bits)
};

__device__ __forceinline__ void st_relaxed(unsigned long long* p,
                                           unsigned long long v) {
  asm volatile("st.relaxed.gpu.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}
__device__ __forceinline__ unsigned long long ld_relaxed(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

template <typename T>
__device__ __forceinline__ void publish(const Descs& d, long long t,
                                        unsigned s, T v) {
  constexpr int W = Geom<T>::kDescWords;
  unsigned bits[W];
  memcpy(bits, &v, sizeof(T));
#pragma unroll
  for (int k = 0; k < W; ++k) {
    st_relaxed(&d.words[t * W + k], ((unsigned long long)s << 32) | bits[k]);
  }
}

template <typename T>
__device__ __forceinline__ void read_desc(const Descs& d, long long t,
                                          unsigned& s, T& v) {
  constexpr int W = Geom<T>::kDescWords;
  unsigned long long w[W];
#pragma unroll
  for (int k = 0; k < W; ++k) w[k] = ld_relaxed(&d.words[t * W + k]);
  unsigned bits[W];
  s = (unsigned)(w[0] >> 32);
#pragma unroll
  for (int k = 0; k < W; ++k) {
    if ((unsigned)(w[k] >> 32) != s) s = kInvalid;
    bits[k] = (unsigned)w[k];
  }
  memcpy(&v, bits, sizeof(T));
}

template <typename T, int K>
__device__ __forceinline__ T warp_inclusive(T x) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const T y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x = Op<T, K>::apply(y, x);
  }
  return x;
}

// One warp: the combination of every tile before `tile`. It reads the
// descriptors of 32 predecessors at a time (lane 31 the nearest), waits
// until all are published, combines them back to the nearest inclusive
// prefix and stops there, or moves 32 tiles back.
template <typename T, int K>
__device__ T look_back(const Descs& d, long long tile) {
  const int lane = threadIdx.x & 31;
  T acc = Op<T, K>::ident();
  for (long long end = tile - 1;; end -= 32) {
    const long long t = end - 31 + lane;
    unsigned s = kPrefix;              // before tile 0: the identity
    T v = Op<T, K>::ident();
    do {
      if (t >= 0) read_desc<T>(d, t, s, v);
    } while (__any_sync(0xffffffffu, s == kInvalid));
    const unsigned pre = __ballot_sync(0xffffffffu, s == kPrefix);
    const int from = pre ? 31 - __clz((int)pre) : 0;
    T x = warp_inclusive<T, K>(lane >= from ? v : Op<T, K>::ident());
    acc = Op<T, K>::apply(__shfl_sync(0xffffffffu, x, 31), acc);
    if (pre) return acc;
  }
}

// Logical element i of the scan is physical element i, or n-1-i for a
// reverse scan over a logical array of nl = n rounded up to whole vectors
// whose first nl-n elements are padding. Valid iff nl-n <= i < nl.
template <typename T, int K, bool REV>
__global__ void __launch_bounds__(kScanThreads)
scan_lookback(const T* __restrict__ in, T* __restrict__ out, long long n,
              long long nl, bool aligned, Descs d) {
  using G = Geom<T>;
  constexpr int E = G::kVecElems;
  __shared__ long long s_tile;
  __shared__ T s_warp[kScanWarps];
  __shared__ T s_prefix;
  if (threadIdx.x == 0) s_tile = atomicAdd(d.counter, 1u);
  __syncthreads();
  const long long tile = s_tile;
  const long long base = tile * G::kTileElems;
  const long long pad = nl - n;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const bool full = aligned && base >= pad && base + G::kTileElems <= nl;

  T x[kVecs][E];
#pragma unroll
  for (int j = 0; j < kVecs; ++j) {
    const long long first =
        base + ((long long)(warp * kVecs + j) * 32 + lane) * E;
    if (full) {
      const Vec<T> v = *reinterpret_cast<const Vec<T>*>(
          in + (REV ? nl - first - E : first));
#pragma unroll
      for (int e = 0; e < E; ++e) x[j][e] = v.v[REV ? E - 1 - e : e];
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const long long i = first + e;
        x[j][e] = (i >= pad && i < nl) ? in[REV ? nl - 1 - i : i]
                                       : Op<T, K>::ident();
      }
    }
  }

  // Each vector's own scan, then one warp scan per vector slot: pre[j] is
  // what comes before vector j of this lane within the warp.
  T pre[kVecs];
  T carry = Op<T, K>::ident();
#pragma unroll
  for (int j = 0; j < kVecs; ++j) {
#pragma unroll
    for (int e = 1; e < E; ++e) x[j][e] = Op<T, K>::apply(x[j][e - 1], x[j][e]);
    const T inc = warp_inclusive<T, K>(x[j][E - 1]);
    T exc = __shfl_up_sync(0xffffffffu, inc, 1);
    if (lane == 0) exc = Op<T, K>::ident();
    pre[j] = Op<T, K>::apply(carry, exc);
    carry = Op<T, K>::apply(carry, __shfl_sync(0xffffffffu, inc, 31));
  }
  if (lane == 0) s_warp[warp] = carry;
  __syncthreads();

  if (warp == 0) {
    const T w = lane < kScanWarps ? s_warp[lane] : Op<T, K>::ident();
    const T winc = warp_inclusive<T, K>(w);
    const T agg = __shfl_sync(0xffffffffu, winc, kScanWarps - 1);
    T wexc = __shfl_up_sync(0xffffffffu, winc, 1);
    if (lane == 0) wexc = Op<T, K>::ident();
    if (lane < kScanWarps) s_warp[lane] = wexc;
    T prefix = Op<T, K>::ident();
    if (tile == 0) {
      if (lane == 0) publish<T>(d, 0, kPrefix, agg);
    } else {
      if (lane == 0) publish<T>(d, tile, kAggregate, agg);
      prefix = look_back<T, K>(d, tile);
      if (lane == 0) publish<T>(d, tile, kPrefix, Op<T, K>::apply(prefix, agg));
    }
    if (lane == 0) s_prefix = prefix;
  }
  __syncthreads();

  const T before = Op<T, K>::apply(s_prefix, s_warp[warp]);
#pragma unroll
  for (int j = 0; j < kVecs; ++j) {
    const long long first =
        base + ((long long)(warp * kVecs + j) * 32 + lane) * E;
    const T p = Op<T, K>::apply(before, pre[j]);
    if (full) {
      Vec<T> v;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        v.v[REV ? E - 1 - e : e] = Op<T, K>::apply(p, x[j][e]);
      }
      *reinterpret_cast<Vec<T>*>(out + (REV ? nl - first - E : first)) = v;
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const long long i = first + e;
        if (i >= pad && i < nl) {
          out[REV ? nl - 1 - i : i] = Op<T, K>::apply(p, x[j][e]);
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
  return kDescBase + 8LL * Geom<T>::kDescWords * tile_count<T>(n);
}

template <typename T, int K>
int launch_scan(const T* in, T* out, long long n, bool reverse, void* scratch,
                long long nbytes, cudaStream_t s) {
  if (n <= 0) return 0;
  const long long need = scratch_bytes<T>(n);
  if (nbytes < need) return (int)cudaErrorInvalidValue;
  char* base = static_cast<char*>(scratch);
  const long long t = tile_count<T>(n);
  Descs d;
  d.counter = reinterpret_cast<unsigned*>(base);
  d.words = reinterpret_cast<unsigned long long*>(base + kDescBase);
  cudaError_t err = cudaMemsetAsync(scratch, 0, (size_t)need, s);
  if (err != cudaSuccess) return (int)err;
  const bool aligned = (reinterpret_cast<uintptr_t>(in) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  if (reverse) {
    scan_lookback<T, K, true><<<(unsigned)t, kScanThreads, 0, s>>>(
        in, out, n, padded_len<T>(n), aligned, d);
  } else {
    scan_lookback<T, K, false><<<(unsigned)t, kScanThreads, 0, s>>>(
        in, out, n, n, aligned, d);
  }
  GDF_LAUNCH_CHECK();
  return 0;
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

// ---- H3: reduce-then-scan of (flag, value) pairs ------------------------

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
template <typename T, int K>
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
    s_f[idx] = ok ? (flags[g] != 0) : 0;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    items[i].v = s_v[threadIdx.x * kItems + i];
    items[i].f = s_f[threadIdx.x * kItems + i];
  }
  __syncthreads();
}

template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
tile_reduce(const unsigned char* flags, const T* in, long long n,
            int* tile_f, T* tile_v) {
  __shared__ T s_v[kTile];
  __shared__ unsigned char s_f[kTile];
  __shared__ Pair<T> warp_tot[kWarps];
  Pair<T> items[kItems];
  load_tile<T, K>(flags, in, n, (long long)blockIdx.x * kTile, s_v, s_f,
                  items);
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

template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
tile_scan(const unsigned char* flags, const T* in, T* out, long long n,
          const int* tile_f, const T* tile_v) {
  __shared__ T s_v[kTile];
  __shared__ unsigned char s_f[kTile];
  __shared__ Pair<T> warp_tot[kWarps];
  const long long base = (long long)blockIdx.x * kTile;
  Pair<T> items[kItems];
  load_tile<T, K>(flags, in, n, base, s_v, s_f, items);
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
int launch_seg(const unsigned char* flags, const T* in, T* out, long long n,
               int* tile_f, T* tile_v, cudaStream_t s) {
  if (n <= 0) return 0;
  const long long ntiles = (n + kTile - 1) / kTile;
  tile_reduce<T, K><<<(unsigned)ntiles, kThreads, 0, s>>>(flags, in, n,
                                                          tile_f, tile_v);
  GDF_LAUNCH_CHECK();
  tile_prefix<T, K><<<1, kThreads, 0, s>>>(tile_f, tile_v, ntiles);
  GDF_LAUNCH_CHECK();
  tile_scan<T, K><<<(unsigned)ntiles, kThreads, 0, s>>>(flags, in, out, n,
                                                        tile_f, tile_v);
  GDF_LAUNCH_CHECK();
  return 0;
}

template <typename T>
int dispatch_seg(int kind, const void* flags, const void* in, void* out,
                 long long n, void* tile_f, void* tile_v, cudaStream_t s) {
  const unsigned char* f = static_cast<const unsigned char*>(flags);
  const T* x = static_cast<const T*>(in);
  T* y = static_cast<T*>(out);
  int* tf = static_cast<int*>(tile_f);
  T* tv = static_cast<T*>(tile_v);
  switch (kind) {
    case kSum: return launch_seg<T, kSum>(f, x, y, n, tf, tv, s);
    case kMax: return launch_seg<T, kMax>(f, x, y, n, tf, tv, s);
    case kMin: return launch_seg<T, kMin>(f, x, y, n, tf, tv, s);
    case kCarry: return launch_seg<T, kCarry>(f, x, y, n, tf, tv, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 int32, 1 int64, 2 float32, 3 float64.

// Bytes of scratch (tile counter and descriptors) that gdf_scan needs for
// n elements; -1 for an unknown dtype.
long long gdf_scan_scratch_bytes(int dtype, long long n) {
  switch (dtype) {
    case 0: return scratch_bytes<int>(n);
    case 1: return scratch_bytes<long long>(n);
    case 2: return scratch_bytes<float>(n);
    case 3: return scratch_bytes<double>(n);
    default: return -1;
  }
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

// Elements per H3 tile: the wrapper sizes the tile scratch as ceil(n / tile).
int gdf_seg_scan_tile_elems() { return kTile; }

// H3. kind: 0 sum, 1 max, 2 min, 3 carry. flags: uint8[n] segment heads.
// tile_f: int32[ntiles], tile_v: T[ntiles] scratch. Returns a cudaError_t.
int gdf_seg_scan(int dtype, int kind, const void* flags, const void* in,
                 void* out, long long n, void* tile_f, void* tile_v,
                 void* stream) {
  if (flags == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dispatch_seg<int>(kind, flags, in, out, n, tile_f, tile_v, s);
    case 1: return dispatch_seg<long long>(kind, flags, in, out, n, tile_f, tile_v, s);
    case 2: return dispatch_seg<float>(kind, flags, in, out, n, tile_f, tile_v, s);
    case 3: return dispatch_seg<double>(kind, flags, in, out, n, tile_f, tile_v, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* gdf_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
