// H5 `dense_groupby` and its domain probe: a group-by over a small integer
// key domain in one pass, without a sort.
//
// Replaces no TPU kernel. The JAX package groups by sorting, because XLA on
// a TPU has no scatter-free alternative, and so does the port's sort path
// (ops/groupby.py): keys packed into words, a radix sort, the operands
// gathered through the permutation, a segmented scan (H3) per aggregate and
// a compaction (H1) of the group-last rows. When every key is an integer
// whose live values span a small range, a row's group is a position in a
// domain of D = prod_j (max_j - min_j + 1) <= 8 slots that the row's keys
// give directly (mixed radix, key 0 most significant, so slot order is key
// order), and one pass that adds each row into per-slot accumulators does
// the whole group-by for sum, count and avg.
//
// Bound: device memory. The probe reads the live rows' keys once; H5 reads
// them again with every aggregated column. TPC-H Q1 at SF 10 (58.9M live
// rows, two one-byte keys, five float64 columns) is 0.12 GB for the probe
// and 2.47 GB for H5: 0.036 ms and 0.74 ms at 3.35 TB/s. Nothing of the
// rows' size is written: no sorted copies, no scan outputs.
//
// Design.
//   The probe (`domain_probe`): a grid of 256-thread blocks reads every
//   key of the rows below the device-side row count (dead rows of a
//   capacity + count table hold stale keys and must not widen the domain)
//   whose keys are all valid, as 16-byte vectors (four in flight a thread)
//   where the column allows, and keeps each key's min and max, in 32 bits
//   for keys up to 4 bytes; warps, then the block, reduce them, and the
//   last block to finish (an atomic ticket) reduces the blocks' partials
//   and writes 2 integers a key. The caller reads them on the host once.
//   H5 (`dense_groupby<A, F64>`, the D slots a run-time value):
//   accumulator 0 counts the rows; the others are a float64 sum, an int64
//   sum (integer sums wrap as the sort path's do) or a count of a column's
//   valid values. A grid of as many 256-thread blocks as the SMs hold
//   walks the rows warp by warp in steps of 32 x U rows, lane l taking
//   rows l, l + 32, ...: each load of a warp reads 32 adjacent elements
//   whatever their width, and a thread issues the loads of its U rows of
//   every key and value before it uses any (`Col`). Each thread keeps its
//   D x A accumulators in shared memory, indexed by the row's slot: one
//   read, add and write of the slot's accumulators a row. The first design
//   kept them in registers, where a row must reach every slot through a
//   predicated add: D x A adds a row, instruction-bound at 23% of the
//   bound (PERF.md). A denormal float is
//   zero as it is loaded, as H3 does. The F64 instance (every sum a
//   float64 column with no nulls: Q1's case) has no branch on a dtype. At
//   the end each block adds its threads' accumulators in a fixed order
//   (lanes, then a butterfly of shuffles) into one partial, and the last
//   block (atomic ticket) adds the partials in block order, so the result
//   is bit-identical from run to run on a given card. The same block
//   writes the output: the occupied slots (rows > 0) in slot order, their
//   decoded keys, sums, counts and averages (sum / count in float64, as the
//   sort path computes it), the validity of a nullable column's
//   aggregates, `live` for the groups, and the group count. Keys whose
//   span is 1 are constants: H5 does not read them and writes their value.
#include "common.cuh"

#include <float.h>
#include <limits.h>
#include <math.h>

#include <array>
#include <type_traits>
#include <utility>

namespace {

constexpr int kMaxKeys = 8;
constexpr int kMaxSlots = 8;
constexpr int kMaxAccs = 8;
constexpr int kMaxOuts = 24;
// A domain of at most 8 slots has at most 3 keys of span >= 2.
constexpr int kMaxReadKeys = 3;
constexpr int kMaxDevices = 64;
constexpr int kThreads = gdf::kThreads;
constexpr int kWarps = gdf::kWarps;
constexpr int kTicketBytes = 16;
constexpr int kProbeBlocksPerSM = 4;

using namespace gdf::dtype;
enum : long long { kRows = 0, kValid = 1, kIntSum = 2, kFloatSum = 3 };
enum : long long { kKey = 0, kSum = 1, kCount = 2, kAvg = 3 };

// One group-by; mirrors ops/kernels/dense.py::Plan field for field (every
// field 8 bytes, so the layouts agree without padding rules).
struct Plan {
  long long n;                     // rows of every column (the capacity)
  const int* num_rows;             // live rows (device int32), null: n
  const unsigned char* row_ok;     // 0 where a key is null, or null
  long long nkeys;                 // probe: every key; H5: span >= 2 only
  const void* key[kMaxKeys];
  long long key_dt[kMaxKeys];
  long long key_lo[kMaxKeys];
  long long key_span[kMaxKeys];
  long long nacc;                  // accumulator 0 counts the rows
  long long acc_kind[kMaxAccs];
  const void* val[kMaxAccs];
  long long val_dt[kMaxAccs];
  const unsigned char* val_ok[kMaxAccs];   // the column's validity, or null
  long long nout;
  long long out_kind[kMaxOuts];
  long long out_src[kMaxOuts];     // key: index in key[] or -1; else an acc
  long long out_cnt[kMaxOuts];     // the acc counting the output's values
  long long out_dt[kMaxOuts];      // dtype written; avg: its sum column's
  long long out_lo[kMaxOuts];      // key: its minimum
  long long out_exact[kMaxOuts];   // avg: divide the sum as its column holds it
  void* out[kMaxOuts];
  unsigned char* out_ok[kMaxOuts];   // validity: its count > 0, or null
  unsigned char* live;             // 1 for each group (zeroed by the caller)
  int* groups;                     // the group count
};

constexpr unsigned long long kNegZero = 0x8000000000000000ull;  // -0.0

__device__ __forceinline__ long long live_rows(const Plan& p) {
  if (p.num_rows == nullptr) return p.n;
  const long long m = *p.num_rows;
  return m < 0 ? 0 : (m > p.n ? p.n : m);
}

// A column as H5 reads it: element r is the aligned 8-byte word that holds
// it, shifted right by its byte offset and sign- or zero-extended from its
// width (float bits as they are). One load and a few shifts, no branch on
// the dtype, which is a run-time value here: under a switch the compiler
// waits for one column's loads before it issues the next column's, and
// predicated loads of every width cost a dozen instructions an element.
// An aligned 8-byte word never crosses a page, and a valid element lies in
// it, so the load never faults.
struct Col {
  const char* base;   // null: not read
  int shift;          // log2 of the element's bytes
  int drop;           // 64 - 8 x the element's bytes
  bool sign;
};

__device__ __forceinline__ Col col_of(const void* p, long long dt) {
  const int shift = dt == kI16 ? 1 : (dt == kI32 || dt == kF32) ? 2
                  : (dt == kI64 || dt == kF64) ? 3 : 0;
  return {static_cast<const char*>(p), shift, 64 - (8 << shift),
          dt == kI8 || dt == kI16 || dt == kI32 || dt == kI64};
}

__device__ __forceinline__ unsigned long long load_word(const Col& c,
                                                        long long r,
                                                        bool in) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(c.base) +
                      ((unsigned long long)r << c.shift);
  return in && c.base != nullptr
             ? __ldg(reinterpret_cast<const unsigned long long*>(
                   a & ~(uintptr_t)7))
             : 0ull;
}

__device__ __forceinline__ unsigned long long extract(const Col& c,
                                                      unsigned long long w,
                                                      long long r) {
  if (c.shift == 3) return w;
  const uintptr_t a = reinterpret_cast<uintptr_t>(c.base) +
                      ((unsigned long long)r << c.shift);
  const unsigned long long top = (w >> (8 * (a & 7))) << c.drop;
  return c.sign ? (unsigned long long)((long long)top >> c.drop)
                : top >> c.drop;
}

// A value as a float sum reads it: a denormal is a zero of its sign (in
// its own dtype, before a float32 widens), integers converted.
__device__ __forceinline__ double as_double(unsigned long long raw,
                                            long long dt) {
  if (dt == kF32) {
    const float f = __uint_as_float((unsigned)raw);
    return (double)(fabsf(f) < FLT_MIN ? copysignf(0.0f, f) : f);
  }
  if (dt == kF64) {
    const double d = __longlong_as_double((long long)raw);
    return fabs(d) < DBL_MIN ? copysign(0.0, d) : d;
  }
  return (double)(long long)raw;
}

__device__ __forceinline__ unsigned long long combine(unsigned long long a,
                                                      unsigned long long b,
                                                      bool fsum) {
  return fsum ? (unsigned long long)__double_as_longlong(
                    __longlong_as_double((long long)a) +
                    __longlong_as_double((long long)b))
              : a + b;
}

// An integer written in a column of dtype dt (wrapping to its width).
__device__ __forceinline__ void store_int(void* out, long long dt, int g,
                                          long long v) {
  switch (dt) {
    case kI8: case kU8: static_cast<signed char*>(out)[g] = (signed char)v;
      break;
    case kI16: static_cast<short*>(out)[g] = (short)v; break;
    case kI32: static_cast<int*>(out)[g] = (int)v; break;
    default: static_cast<long long*>(out)[g] = v; break;
  }
}

// A sum as its column of dtype dt holds it, as float64.
__device__ __forceinline__ double held_sum(unsigned long long x,
                                           long long kind, long long dt) {
  if (kind == kFloatSum) {
    const double d = __longlong_as_double((long long)x);
    if (dt == kF32) {
      const float f = (float)d;
      return (double)(fabsf(f) < FLT_MIN ? copysignf(0.0f, f) : f);
    }
    return fabs(d) < DBL_MIN ? copysign(0.0, d) : d;
  }
  switch (dt) {
    case kI8: return (double)(signed char)x;
    case kI16: return (double)(short)x;
    case kI32: return (double)(int)x;
    default: return (double)(long long)x;
  }
}

// Output column o of group g, the domain's slot s; tot: the slot totals.
template <int A>
__device__ void write_out(const Plan& p, int o, int g, int s,
                          const unsigned long long* tot) {
  const unsigned long long* t = tot + s * A;
  void* out = p.out[o];
  const long long dt = p.out_dt[o];
  const long long src = p.out_src[o];
  const long long cnt = (long long)t[p.out_cnt[o]];
  if (p.out_ok[o] != nullptr) p.out_ok[o][g] = cnt > 0;
  switch (p.out_kind[o]) {
    case kKey: {
      long long v = p.out_lo[o];
      if (src >= 0) {
        long long stride = 1;
        for (long long k = src + 1; k < p.nkeys; ++k) stride *= p.key_span[k];
        v += (s / stride) % p.key_span[src];
      }
      store_int(out, dt, g, v);
      break;
    }
    case kCount:
      static_cast<long long*>(out)[g] = cnt;
      break;
    case kSum:
      if (p.acc_kind[src] == kIntSum) {
        store_int(out, dt, g, (long long)t[src]);
      } else if (dt == kF32) {
        static_cast<float*>(out)[g] = (float)__longlong_as_double(
            (long long)t[src]);
      } else {
        static_cast<unsigned long long*>(out)[g] = t[src];
      }
      break;
    default: {  // kAvg
      const double num = p.out_exact[o]
                             ? held_sum(t[src], p.acc_kind[src], dt)
                             : __longlong_as_double((long long)t[src]);
      static_cast<double*>(out)[g] = num / (double)(cnt > 1 ? cnt : 1);
      break;
    }
  }
}

// Rows a lane loads per step, all in flight at once, and the blocks an SM
// holds (registers capped to fit them). The kernel hides latency with
// warps and with rows in flight; at Q1's shape (6 x 6) the generic
// instance ran fastest with two rows and three blocks (shared memory holds
// three), the F64 one, with fewer instructions a row, with four rows and
// two blocks; one block an SM took 1.6 times as long.
__host__ __device__ constexpr int unroll(bool f64) { return f64 ? 4 : 2; }
__host__ __device__ constexpr int blocks_per_sm(bool f64) {
  return f64 ? 2 : 3;
}

// Dynamic shared memory of H5 over D slots with A accumulators a slot:
// each thread's D x A accumulators.
__host__ __device__ constexpr int acc_bytes(int slots, int accs) {
  return slots * accs * kThreads * 8;
}

// F64: every accumulator but the rows is a float64 sum of a column with no
// nulls (Q1's case, and any sum / avg of float64 measures): that instance
// loads those columns as words and adds them with no branch on a dtype.
// A is a compile-time value for the registers of a row's accumulators and
// loads; the D slots, indexed at run time, only size shared memory.
template <int A, bool F64>
__global__ void __launch_bounds__(kThreads, blocks_per_sm(F64))
dense_groupby(const __grid_constant__ Plan p, int D,
              unsigned* __restrict__ ticket,
              unsigned long long* __restrict__ partial) {
  constexpr int U = unroll(F64);
  const int V = D * A;
  // thread t's accumulator (s, a) at (s * A + a) * kThreads + t: a warp's
  // 32 accesses are 32 adjacent words whatever their slots
  extern __shared__ unsigned long long s_acc[];
  __shared__ unsigned long long s_tot[kMaxSlots * A];
  __shared__ int s_slot[kMaxSlots];
  __shared__ int s_groups;
  __shared__ bool s_last;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long live = live_rows(p);
  const int nkeys = (int)p.nkeys;
  const int nacc = (int)p.nacc;

  for (int v = 0; v < V; ++v) {
    const int a = v % A;
    s_acc[v * kThreads + threadIdx.x] =
        a < nacc && p.acc_kind[a] == kFloatSum ? kNegZero : 0ull;
  }
  Col keys[kMaxReadKeys], vals[A];
#pragma unroll
  for (int j = 0; j < kMaxReadKeys; ++j) {
    keys[j] = col_of(p.key[j], p.key_dt[j]);
    if (j >= nkeys) keys[j].base = nullptr;
  }
#pragma unroll
  for (int a = 0; a < A; ++a) {
    vals[a] = col_of(p.val[a], p.val_dt[a]);
    if (a >= nacc || (p.acc_kind[a] != kIntSum &&
                      p.acc_kind[a] != kFloatSum)) {
      vals[a].base = nullptr;
    }
  }
  const Col row_ok = col_of(p.row_ok, kU8);
  unsigned long long* mine = s_acc + threadIdx.x;

  const long long step = 32LL * U;
  const long long first = ((long long)blockIdx.x * kWarps + warp) * step;
  const long long stride = (long long)gridDim.x * kWarps * step;
  for (long long base = first + lane; base - lane < live; base += stride) {
    // every load of the step first
    unsigned long long kw[kMaxReadKeys][U], vw[A][U], okw[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long r = base + 32 * u;
      const bool in = r < live;
#pragma unroll
      for (int j = 0; j < kMaxReadKeys; ++j) {
        kw[j][u] = load_word(keys[j], r, in);
      }
#pragma unroll
      for (int a = 0; a < A; ++a) {
        if (F64) {
          vw[a][u] = in && a > 0 && a < nacc
                         ? __ldg(static_cast<const unsigned long long*>(
                                     p.val[a]) + r)
                         : 0ull;
        } else {
          vw[a][u] = load_word(vals[a], r, in);
        }
      }
      okw[u] = load_word(row_ok, r, in);
    }
    // then each row into its slot's accumulators
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long r = base + 32 * u;
      if (r >= live) break;
      if (row_ok.base != nullptr && extract(row_ok, okw[u], r) == 0) continue;
      int slot = 0;
#pragma unroll
      for (int j = 0; j < kMaxReadKeys; ++j) {
        if (j < nkeys) {
          slot = slot * (int)p.key_span[j] +
                 (int)((long long)extract(keys[j], kw[j][u], r) -
                       p.key_lo[j]);
        }
      }
      // the slot's accumulators read together, added, written back
      unsigned long long* acc = mine + slot * A * kThreads;
      unsigned long long cur[A];
#pragma unroll
      for (int a = 0; a < A; ++a) {
        if (a < nacc) cur[a] = acc[a * kThreads];
      }
      if (F64) {
        cur[0] += 1;
#pragma unroll
        for (int a = 1; a < A; ++a) {
          if (a < nacc) {
            cur[a] = (unsigned long long)__double_as_longlong(
                __longlong_as_double((long long)cur[a]) +
                as_double(vw[a][u], kF64));
          }
        }
      } else {
#pragma unroll
        for (int a = 0; a < A; ++a) {
          if (a >= nacc) break;
          const long long kind = p.acc_kind[a];
          if (kind != kRows && p.val_ok[a] != nullptr &&
              __ldg(p.val_ok[a] + r) == 0) {
            continue;
          }
          if (kind == kFloatSum) {
            cur[a] = (unsigned long long)__double_as_longlong(
                __longlong_as_double((long long)cur[a]) +
                as_double(extract(vals[a], vw[a][u], r), p.val_dt[a]));
          } else {
            cur[a] += kind == kIntSum ? extract(vals[a], vw[a][u], r) : 1ull;
          }
        }
      }
#pragma unroll
      for (int a = 0; a < A; ++a) {
        if (a < nacc) acc[a * kThreads] = cur[a];
      }
    }
  }
  __syncthreads();

  // the block, in a fixed order: a warp a total, lane l adding threads
  // l, l + 32, ..., then a butterfly
  for (int v = warp; v < V; v += kWarps) {
    const bool f = p.acc_kind[v % A] == kFloatSum && v % A < nacc;
    unsigned long long x = s_acc[v * kThreads + lane];
#pragma unroll
    for (int k = 1; k < kThreads / 32; ++k) {
      x = combine(x, s_acc[v * kThreads + lane + 32 * k], f);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      x = combine(x, __shfl_xor_sync(0xffffffffu, x, off), f);
    }
    if (lane == 0) partial[(long long)blockIdx.x * V + v] = x;
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();

  // the last block: the partials in block order, a warp a total
  for (int v = warp; v < V; v += kWarps) {
    const bool f = p.acc_kind[v % A] == kFloatSum && v % A < nacc;
    unsigned long long x = f ? kNegZero : 0;
    for (int b = lane; b < (int)gridDim.x; b += 32) {
      x = combine(x, __ldcg(partial + (long long)b * V + v), f);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      x = combine(x, __shfl_xor_sync(0xffffffffu, x, off), f);
    }
    if (lane == 0) s_tot[v] = x;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int g = 0;
    for (int s = 0; s < D; ++s) {
      if ((long long)s_tot[s * A] > 0) s_slot[g++] = s;
    }
    s_groups = g;
    *p.groups = g;
  }
  __syncthreads();
  const int groups = s_groups;
  const int nout = (int)p.nout;
  for (int i = threadIdx.x; i < nout * D; i += kThreads) {
    const int g = i % D;
    if (g < groups) write_out<A>(p, i / D, g, s_slot[g], s_tot);
  }
  for (int g = threadIdx.x; g < groups; g += kThreads) p.live[g] = 1;
}

// ---- the probe ------------------------------------------------------------

// Keys up to 4 bytes keep their min and max in 32 bits: one instruction
// each, where 64-bit ones take four.
template <typename T>
using Wide = typename std::conditional<sizeof(T) == 8, long long, int>::type;

// Element k of a 16-byte vector of T, widened (k a compile-time index
// once unrolled, so this is a register extract).
template <typename T>
__device__ __forceinline__ Wide<T> element(const uint4& v, int k) {
  if (sizeof(T) == 8) {
    const unsigned lo = k == 0 ? v.x : v.z, hi = k == 0 ? v.y : v.w;
    return (Wide<T>)((unsigned long long)hi << 32 | lo);
  }
  constexpr int kPer = 4 / sizeof(T);
  const int q = k / kPer;
  const unsigned w = q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
  return (Wide<T>)(T)(w >> (8 * sizeof(T) * (k % kPer)));
}

// This thread's min and max of one key over the live rows whose keys are
// all valid: whole 16-byte vectors where the column is aligned, four in
// flight a thread, then the ragged rows one by one.
template <typename T>
__device__ void probe_key(const T* key, const unsigned char* row_ok,
                          long long live, long long* lo64, long long* hi64) {
  constexpr int E = 16 / sizeof(T);
  constexpr int kInFlight = 4;
  Wide<T> lo = (Wide<T>)(sizeof(T) == 8 ? LLONG_MAX : INT_MAX);
  Wide<T> hi = (Wide<T>)(sizeof(T) == 8 ? LLONG_MIN : INT_MIN);
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long nt = (long long)gridDim.x * kThreads;
  long long done = 0;
  if (reinterpret_cast<uintptr_t>(key) % 16 == 0) {
    const long long vecs = live / E;
    const uint4* kv = reinterpret_cast<const uint4*>(key);
    for (long long c = t; c < vecs; c += kInFlight * nt) {
      uint4 v[kInFlight];
#pragma unroll
      for (int i = 0; i < kInFlight; ++i) {
        const long long ci = c + i * nt;
        v[i] = ci < vecs ? __ldg(kv + ci) : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int i = 0; i < kInFlight; ++i) {
        const long long ci = c + i * nt;
        if (ci >= vecs) break;
#pragma unroll
        for (int e = 0; e < E; ++e) {
          if (row_ok == nullptr || __ldg(row_ok + ci * E + e)) {
            const Wide<T> x = element<T>(v[i], e);
            lo = min(lo, x);
            hi = max(hi, x);
          }
        }
      }
    }
    done = vecs * E;
  }
  for (long long r = done + t; r < live; r += nt) {
    if (row_ok == nullptr || __ldg(row_ok + r)) {
      const Wide<T> x = (Wide<T>)__ldg(key + r);
      lo = min(lo, x);
      hi = max(hi, x);
    }
  }
  *lo64 = lo;
  *hi64 = hi;
}

__global__ void __launch_bounds__(kThreads)
domain_probe(const __grid_constant__ Plan p, unsigned* __restrict__ ticket,
             long long* __restrict__ partial, long long* __restrict__ out) {
  __shared__ long long s_red[kWarps][2];
  __shared__ bool s_last;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long live = live_rows(p);
  const int nkeys = (int)p.nkeys;
  for (int j = 0; j < nkeys; ++j) {
    long long lo = LLONG_MAX, hi = LLONG_MIN;
    const void* k = p.key[j];
    switch (p.key_dt[j]) {
      case kI8: probe_key(static_cast<const signed char*>(k), p.row_ok, live,
                          &lo, &hi); break;
      case kI16: probe_key(static_cast<const short*>(k), p.row_ok, live, &lo,
                           &hi); break;
      case kI32: probe_key(static_cast<const int*>(k), p.row_ok, live, &lo,
                           &hi); break;
      case kU8: probe_key(static_cast<const unsigned char*>(k), p.row_ok,
                          live, &lo, &hi); break;
      default: probe_key(static_cast<const long long*>(k), p.row_ok, live,
                         &lo, &hi); break;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const long long a = __shfl_xor_sync(0xffffffffu, lo, off);
      const long long b = __shfl_xor_sync(0xffffffffu, hi, off);
      lo = a < lo ? a : lo;
      hi = b > hi ? b : hi;
    }
    if (lane == 0) {
      s_red[warp][0] = lo;
      s_red[warp][1] = hi;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int w = 1; w < kWarps; ++w) {
        lo = s_red[w][0] < lo ? s_red[w][0] : lo;
        hi = s_red[w][1] > hi ? s_red[w][1] : hi;
      }
      partial[((long long)blockIdx.x * nkeys + j) * 2] = lo;
      partial[((long long)blockIdx.x * nkeys + j) * 2 + 1] = hi;
    }
    __syncthreads();
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  for (int j = warp; j < nkeys; j += kWarps) {
    long long lo = LLONG_MAX, hi = LLONG_MIN;
    for (int b = lane; b < (int)gridDim.x; b += 32) {
      const long long* q = partial + ((long long)b * nkeys + j) * 2;
      const long long a = __ldcg(q), c = __ldcg(q + 1);
      lo = a < lo ? a : lo;
      hi = c > hi ? c : hi;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const long long a = __shfl_xor_sync(0xffffffffu, lo, off);
      const long long b = __shfl_xor_sync(0xffffffffu, hi, off);
      lo = a < lo ? a : lo;
      hi = b > hi ? b : hi;
    }
    if (lane == 0) {
      out[2 * j] = lo;
      out[2 * j + 1] = hi;
    }
  }
}

// ---- launch ---------------------------------------------------------------

using Kernel = void (*)(const Plan, int, unsigned*, unsigned long long*);

// H5 is built for A in {2, 4, 6, 8}, each with and without F64: a group-by
// takes the instance of its accumulators rounded up to even (the extra
// ones idle), over its own D slots. 8 instances keep the build short.
constexpr int kSizes = kMaxAccs / 2;

struct Instance {
  int d, a, index;
  bool f64;
};

// F64 where every accumulator but the rows is a float64 sum of a column
// with no nulls.
bool all_f64(const Plan& p) {
  for (long long a = 1; a < p.nacc; ++a) {
    if (p.acc_kind[a] != kFloatSum || p.val_dt[a] != kF64 ||
        p.val_ok[a] != nullptr) {
      return false;
    }
  }
  return true;
}

Instance instance_of(int slots, int accs, bool f64) {
  const int a = (accs + 1) / 2;
  return {slots, 2 * a, (a - 1) * 2 + (f64 ? 1 : 0), f64};
}

template <int... I>
constexpr std::array<Kernel, sizeof...(I)> instances(
    std::integer_sequence<int, I...>) {
  return {&dense_groupby<(I / 2 + 1) * 2, I % 2 == 1>...};
}

const std::array<Kernel, kSizes * 2> kKernels =
    instances(std::make_integer_sequence<int, kSizes * 2>{});

// SMs of the current card, and blocks of H5's instance an SM holds over
// its slots (with an instance given), asked once a card, instance and
// slot count. The instance's shared memory is allowed for the most slots.
int device_limits(const Instance* inst, int* sms, int* per_sm) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  static int sm_count[kMaxDevices] = {};
  static int occupancy[kMaxDevices][kSizes * 2][kMaxSlots] = {};
  if (sm_count[dev] == 0) {
    err = cudaDeviceGetAttribute(&sm_count[dev],
                                 cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
  }
  *sms = sm_count[dev];
  if (inst != nullptr) {
    int* occ = &occupancy[dev][inst->index][inst->d - 1];
    if (*occ == 0) {
      err = cudaFuncSetAttribute(kKernels[inst->index],
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 acc_bytes(kMaxSlots, inst->a));
      if (err != cudaSuccess) return (int)err;
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          occ, kKernels[inst->index], kThreads, acc_bytes(inst->d, inst->a));
      if (err != cudaSuccess) return (int)err;
      if (*occ <= 0) return (int)cudaErrorInvalidConfiguration;
    }
    *per_sm = *occ;
  }
  return 0;
}

// Blocks of H5 for n rows, and the scratch bytes they need.
int group_grid(const Instance& inst, long long n, long long* grid,
               long long* nbytes) {
  int sms = 0, per_sm = 0;
  const int err = device_limits(&inst, &sms, &per_sm);
  if (err != 0) return err;
  const long long rows_a_block = 32LL * kWarps * unroll(inst.f64);
  const long long need = (n + rows_a_block - 1) / rows_a_block;
  const long long most = (long long)sms * per_sm;
  *grid = need < 1 ? 1 : (need < most ? need : most);
  *nbytes = kTicketBytes + *grid * inst.d * inst.a * 8;
  return 0;
}

int probe_grid(long long n, long long* grid) {
  int sms = 0, unused = 0;
  const int err = device_limits(nullptr, &sms, &unused);
  if (err != 0) return err;
  const long long need = (n + 16LL * kThreads - 1) / (16LL * kThreads);
  const long long most = (long long)sms * kProbeBlocksPerSM;
  *grid = need < 1 ? 1 : (need < most ? need : most);
  return 0;
}

bool plan_fits(const Plan& p) {
  return p.n > 0 && p.n < (1LL << 31) && p.nkeys >= 0 &&
         p.nkeys <= kMaxKeys && p.nacc >= 1 && p.nacc <= kMaxAccs &&
         p.acc_kind[0] == kRows && p.nout >= 0 && p.nout <= kMaxOuts;
}

}  // namespace

extern "C" {

long long gdf_dense_plan_bytes() { return (long long)sizeof(Plan); }

// Bytes of scratch that gdf_domain_probe needs for n rows and nkeys keys
// on the current card, or -1 (a cudaError_t in *err).
long long gdf_domain_probe_scratch_bytes(long long n, int nkeys, int* err) {
  long long grid = 0;
  *err = probe_grid(n, &grid);
  if (*err != 0) return -1;
  return kTicketBytes + grid * 2 * (nkeys > 0 ? nkeys : 1) * 8;
}

// Each key's min and max over the rows below *num_rows whose keys are all
// valid (row_ok), into out: int64[2 nkeys], (min, max) a key; min > max
// where no row is. scratch: gdf_domain_probe_scratch_bytes bytes; its
// ticket is zeroed here on the stream. Returns a cudaError_t.
int gdf_domain_probe(const void* plan, void* out, void* scratch,
                     long long nbytes, void* stream) {
  const Plan& p = *static_cast<const Plan*>(plan);
  if (p.n <= 0 || p.n >= (1LL << 31) || p.nkeys < 1 || p.nkeys > kMaxKeys) {
    return (int)cudaErrorInvalidValue;
  }
  long long grid = 0;
  int err = probe_grid(p.n, &grid);
  if (err != 0) return err;
  if (nbytes < kTicketBytes + grid * 2 * p.nkeys * 8) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = (int)cudaMemsetAsync(scratch, 0, kTicketBytes, s);
  if (err != 0) return err;
  char* base = static_cast<char*>(scratch);
  domain_probe<<<(unsigned)grid, kThreads, 0, s>>>(
      p, reinterpret_cast<unsigned*>(base),
      reinterpret_cast<long long*>(base + kTicketBytes),
      static_cast<long long*>(out));
  GDF_LAUNCH_CHECK();
  return 0;
}

// Bytes of scratch that gdf_dense_groupby needs for (slots, accs) and n
// rows on the current card (either instance), or -1 (a cudaError_t in
// *err).
long long gdf_dense_groupby_scratch_bytes(int slots, int accs, long long n,
                                          int* err) {
  if (slots < 1 || slots > kMaxSlots || accs < 1 || accs > kMaxAccs) {
    *err = (int)cudaErrorInvalidValue;
    return -1;
  }
  long long most = 0;
  for (int f64 = 0; f64 < 2; ++f64) {
    long long grid = 0, nbytes = 0;
    *err = group_grid(instance_of(slots, accs, f64 == 1), n, &grid, &nbytes);
    if (*err != 0) return -1;
    most = nbytes > most ? nbytes : most;
  }
  return most;
}

// The group-by of `plan` over a domain of `slots` slots with plan->nacc
// accumulators a slot: writes the outputs' first G rows, the validity
// arrays' and `live`'s first G bytes (the caller zeroes those two) and the
// group count G. scratch: gdf_dense_groupby_scratch_bytes bytes; its
// ticket is zeroed here on the stream. Returns a cudaError_t.
int gdf_dense_groupby(int slots, const void* plan, void* scratch,
                      long long nbytes, void* stream) {
  const Plan& p = *static_cast<const Plan*>(plan);
  long long prod = 1;
  for (long long j = 0; j < p.nkeys && j < kMaxKeys; ++j) {
    prod *= p.key_span[j] > 0 ? p.key_span[j] : 0;
  }
  if (!plan_fits(p) || slots < 1 || slots > kMaxSlots ||
      p.nkeys > kMaxReadKeys || prod != slots) {
    return (int)cudaErrorInvalidValue;
  }
  const Instance inst = instance_of(slots, (int)p.nacc, all_f64(p));
  long long grid = 0, need = 0;
  int err = group_grid(inst, p.n, &grid, &need);
  if (err != 0) return err;
  if (nbytes < need) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = (int)cudaMemsetAsync(scratch, 0, kTicketBytes, s);
  if (err != 0) return err;
  char* base = static_cast<char*>(scratch);
  kKernels[inst.index]<<<(unsigned)grid, kThreads, acc_bytes(inst.d, inst.a),
                         s>>>(
      p, slots, reinterpret_cast<unsigned*>(base),
      reinterpret_cast<unsigned long long*>(base + kTicketBytes));
  GDF_LAUNCH_CHECK();
  return 0;
}

}  // extern "C"
