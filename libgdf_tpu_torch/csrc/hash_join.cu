// H6 `hash_join`: an inner equi-join on one key column whose build side
// holds each key at most once, through an open-addressing hash table.
//
// Replaces no TPU kernel. The JAX package joins by merge-sorting both sides
// (a TPU has no fast random atomics), and so does the port's sort path
// (ops/join.py): both sides packed into 64-bit words, one sort of all of
// them, scans and a compaction over every sorted position. When the build
// side's keys are unique, each probe row has at most one match, and a table
// of the build keys finds it with one lookup: the reference library's own
// join (libgdf/src/join/join_compute_api.h:341-551, one CAS a build row on
// a packed (key, row) pair, concurrent_unordered_multimap.cuh:428-444).
//
// Bound: device memory. The probe reads each live probe key once and writes
// the matched (probe row, build row) pairs; the build reads the build keys
// once. TPC-H Q18 at SF 10 probes 60M + 15M + 1.5M int32 keys against ~100
// build rows: 0.31 GB, 0.09 ms at 3.35 TB/s. Nothing of the probe side's
// size is written: no encodings, masks, sorted copies or scans.
//
// Design.
//   The table: a power of two of slots, at least twice the build side's
//   capacity (load factor <= 0.5, so a lookup always meets an empty slot),
//   linear probing from a murmur3 finalizer of the key. A table that fits
//   in shared memory gets up to 16 slots a row: at Q18's ~100 build rows
//   (2048 slots) nearly every lookup ends at its first slot, where at a
//   load of 0.4 a warp's lookups ran to ~5 rounds of bank-conflicted reads
//   (0.235 ms for 60M keys, 30% of the bound; PERF.md). A key of <= 4 bytes
//   and its row share one 64-bit slot, key << 32 | (row + 1), 0 empty,
//   claimed by one atomicCAS. A key of 8 bytes is CAS'd into a key array
//   whose empty value is all ones (the key all ones, which only an int64
//   -1 has, goes to one cell of its own) and its row + 1 stored beside it.
//   The key is the column's value as the sort path compares it: a float's
//   bits with -0.0 and denormals as +0.0, a NaN never inserted nor matched.
//   Null keys and rows at or past the device-side row count are skipped.
//   `hash_build<T>`: a thread a build row inserts it; a second insert of
//   an equal key sets the duplicate flag (the caller then joins by sorting).
//   `hash_probe<T, SMEM>`: a grid of as many 256-thread blocks as the SMs
//   hold. A table of <= 4096 slots (32 KB, 48 KB for 8-byte keys: a build
//   side of <= 2048 rows) is staged into each block's shared memory first;
//   a larger one is read from global memory, where Q3's 4M slots (32 MB)
//   stay in the 50 MB L2. A warp reads 32 x 16-byte vectors of keys a step
//   (U of them a lane, 8 or 16 rows), each in its own dtype, and looks up
//   every live row; the warp adds its matches to one global counter with
//   one atomic (none where it has none) and each lane writes its pairs at
//   the warp's offset. The pairs come out in no fixed order: the caller
//   sorts them by (key, probe row), the sort path's order. Every match is
//   counted; the pairs past the output's capacity are not written.
#include "common.cuh"

#include <float.h>
#include <math.h>

#include <type_traits>

namespace {

constexpr int kThreads = gdf::kThreads;
constexpr int kWarps = gdf::kWarps;
constexpr int kMaxDevices = 64;
constexpr int kBuildBlocksPerSM = 8;
constexpr long long kSmemSlots = 4096;  // the largest staged table
constexpr int kSmemSizes = 13;                // log2 slots 0 .. 12
constexpr unsigned long long kEmpty = ~0ull;  // an empty slot of a wide table

using namespace gdf::dtype;

template <typename T>
using KeyOf = std::conditional_t<sizeof(T) == 8, unsigned long long,
                                 unsigned>;

// The key a row hashes and compares (false: it never matches).
__device__ __forceinline__ bool canon(signed char x, unsigned* k) {
  *k = (unsigned)(int)x;
  return true;
}
__device__ __forceinline__ bool canon(short x, unsigned* k) {
  *k = (unsigned)(int)x;
  return true;
}
__device__ __forceinline__ bool canon(int x, unsigned* k) {
  *k = (unsigned)x;
  return true;
}
__device__ __forceinline__ bool canon(unsigned char x, unsigned* k) {
  *k = x;
  return true;
}
__device__ __forceinline__ bool canon(float x, unsigned* k) {
  if (isnan(x)) return false;
  *k = fabsf(x) < FLT_MIN ? 0u : __float_as_uint(x);
  return true;
}
__device__ __forceinline__ bool canon(long long x, unsigned long long* k) {
  *k = (unsigned long long)x;
  return true;
}
__device__ __forceinline__ bool canon(double x, unsigned long long* k) {
  if (isnan(x)) return false;
  *k = fabs(x) < DBL_MIN ? 0ull : (unsigned long long)__double_as_longlong(x);
  return true;
}

__device__ __forceinline__ unsigned mix(unsigned k) {
  k ^= k >> 16;
  k *= 0x85ebca6bu;
  k ^= k >> 13;
  k *= 0xc2b2ae35u;
  return k ^ (k >> 16);
}
__device__ __forceinline__ unsigned mix(unsigned long long k) {
  k ^= k >> 33;
  k *= 0xff51afd7ed558ccdull;
  k ^= k >> 33;
  k *= 0xc4ceb9fe1a85ec53ull;
  return (unsigned)(k ^ (k >> 33));
}

// A table of mask + 1 slots. Narrow keys: `word` holds the slots. Wide
// keys: `word` the keys, `row` each slot's row + 1, `special` the row + 1
// of the key kEmpty.
struct Table {
  unsigned long long* word;
  int* row;
  int* special;
  unsigned mask;
};

// One side of the join: its key column, validity (or null) and row count.
struct Side {
  const void* keys;
  const unsigned char* valid;
  const int* num_rows;    // device int32, or null: n
  long long n;
};

struct Out {
  int* probe;
  int* build;
  long long cap;
  unsigned long long* count;
};

__device__ __forceinline__ long long live_rows(const Side& s) {
  if (s.num_rows == nullptr) return s.n;
  const long long m = *s.num_rows;
  return m < 0 ? 0 : (m > s.n ? s.n : m);
}

// Insert (k, r); false if the key was there already.
__device__ __forceinline__ bool insert(const Table& t, unsigned k, int r) {
  const unsigned long long w =
      ((unsigned long long)k << 32) | (unsigned)(r + 1);
  for (unsigned s = mix(k) & t.mask;; s = (s + 1) & t.mask) {
    const unsigned long long old = atomicCAS(t.word + s, 0ull, w);
    if (old == 0ull) return true;
    if ((unsigned)(old >> 32) == k) return false;
  }
}
__device__ __forceinline__ bool insert(const Table& t, unsigned long long k,
                                       int r) {
  if (k == kEmpty) return atomicCAS(t.special, 0, r + 1) == 0;
  for (unsigned s = mix(k) & t.mask;; s = (s + 1) & t.mask) {
    const unsigned long long old = atomicCAS(t.word + s, kEmpty, k);
    if (old == kEmpty) {
      t.row[s] = r + 1;
      return true;
    }
    if (old == k) return false;
  }
}

template <bool SMEM, typename W>
__device__ __forceinline__ W ld(const W* p) {
  if constexpr (SMEM) {
    return *p;
  } else {
    return __ldg(p);
  }
}

// The build row of key k, or -1, in the slots of `word` (and `row`, for
// wide keys): shared memory where SMEM, else global.
template <bool SMEM>
__device__ __forceinline__ int find(const unsigned long long* word,
                                    const int*, unsigned mask, int,
                                    unsigned k) {
  for (unsigned s = mix(k) & mask;; s = (s + 1) & mask) {
    const unsigned long long w = ld<SMEM>(word + s);
    if (w == 0ull) return -1;
    if ((unsigned)(w >> 32) == k) return (int)(unsigned)w - 1;
  }
}
template <bool SMEM>
__device__ __forceinline__ int find(const unsigned long long* word,
                                    const int* row, unsigned mask,
                                    int special, unsigned long long k) {
  if (k == kEmpty) return special - 1;
  for (unsigned s = mix(k) & mask;; s = (s + 1) & mask) {
    const unsigned long long w = ld<SMEM>(word + s);
    if (w == kEmpty) return -1;
    if (w == k) return ld<SMEM>(row + s) - 1;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
hash_build(const Side b, const Table t, long long* __restrict__ result) {
  const long long live = live_rows(b);
  const T* keys = static_cast<const T*>(b.keys);
  const long long step = (long long)gridDim.x * kThreads;
  for (long long r = (long long)blockIdx.x * kThreads + threadIdx.x;
       r < live; r += step) {
    if (b.valid != nullptr && __ldg(b.valid + r) == 0) continue;
    KeyOf<T> k;
    if (!canon(__ldg(keys + r), &k)) continue;
    if (!insert(t, k, (int)r)) result[1] = 1;
  }
}

template <typename T, bool SMEM>
__global__ void __launch_bounds__(kThreads)
hash_probe(const Side p, const Table t, const Out o) {
  constexpr bool kWide = sizeof(T) == 8;
  constexpr int V = 16 / (int)sizeof(T);     // rows a vector
  constexpr int U = V >= 8 ? 1 : 8 / V;      // vectors a lane a step
  constexpr int R = U * V;
  extern __shared__ unsigned long long staged[];
  const unsigned slots = t.mask + 1;
  const unsigned long long* word = t.word;
  const int* row = t.row;
  const int special = kWide ? __ldg(t.special) : 0;
  if constexpr (SMEM) {
    for (unsigned s = threadIdx.x; s < slots; s += kThreads) {
      staged[s] = __ldg(t.word + s);
    }
    word = staged;
    if constexpr (kWide) {
      int* rows = reinterpret_cast<int*>(staged + slots);
      for (unsigned s = threadIdx.x; s < slots; s += kThreads) {
        rows[s] = __ldg(t.row + s);
      }
      row = rows;
    }
    __syncthreads();
  }
  // Rows in 32 bits: fewer than 2^31, and a step past the last adds < 2^23.
  const unsigned live = (unsigned)live_rows(p);
  const unsigned vecs = (live + V - 1) / V;
  const T* keys = static_cast<const T*>(p.keys);
  const bool aligned = reinterpret_cast<uintptr_t>(keys) % 16 == 0;
  const unsigned lane = threadIdx.x & 31;
  const unsigned warp = (blockIdx.x * kThreads + threadIdx.x) >> 5;
  const unsigned step = gridDim.x * kWarps * 32 * U;
  // v0 is the same for the whole warp: every lane runs every step
  for (unsigned v0 = warp * 32 * U; v0 < vecs; v0 += step) {
    T x[R];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const unsigned r0 = (v0 + u * 32 + lane) * V;
      if (aligned && r0 + V <= live) {
        union {
          uint4 q;
          T e[V];
        } w;
        w.q = __ldg(reinterpret_cast<const uint4*>(keys + r0));
#pragma unroll
        for (int j = 0; j < V; ++j) x[u * V + j] = w.e[j];
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j) {
          x[u * V + j] = r0 + j < live ? __ldg(keys + r0 + j) : T(0);
        }
      }
    }
    unsigned hit = 0;
    int found[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const unsigned r = (v0 + (i / V) * 32 + lane) * V + i % V;
      KeyOf<T> k;
      found[i] = -1;
      if (r < live && (p.valid == nullptr || __ldg(p.valid + r) != 0) &&
          canon(x[i], &k)) {
        found[i] = find<SMEM>(word, row, t.mask, special, k);
      }
      hit |= found[i] >= 0 ? 1u << i : 0u;
    }
    if (!__any_sync(0xffffffffu, hit != 0)) continue;
    const int mine = __popc(hit);
    int inc = mine;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, inc, d);
      if ((int)lane >= d) inc += y;
    }
    unsigned long long base = 0;
    if (lane == 31) base = atomicAdd(o.count, (unsigned long long)inc);
    base = __shfl_sync(0xffffffffu, base, 31);
    unsigned long long at = base + (unsigned long long)(inc - mine);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      if (hit & (1u << i)) {
        if (at < (unsigned long long)o.cap) {
          o.probe[at] = (int)((v0 + (i / V) * 32 + lane) * V + i % V);
          o.build[at] = found[i];
        }
        ++at;
      }
    }
  }
}

using BuildFn = void (*)(Side, Table, long long*);
using ProbeFn = void (*)(Side, Table, Out);

template <typename T>
ProbeFn probe_of(bool smem) {
  return smem ? hash_probe<T, true> : hash_probe<T, false>;
}

BuildFn build_fn(int dt) {
  switch (dt) {
    case kI8: return hash_build<signed char>;
    case kI16: return hash_build<short>;
    case kI32: return hash_build<int>;
    case kI64: return hash_build<long long>;
    case kU8: return hash_build<unsigned char>;
    case kF32: return hash_build<float>;
    case kF64: return hash_build<double>;
    default: return nullptr;
  }
}

ProbeFn probe_fn(int dt, bool smem) {
  switch (dt) {
    case kI8: return probe_of<signed char>(smem);
    case kI16: return probe_of<short>(smem);
    case kI32: return probe_of<int>(smem);
    case kI64: return probe_of<long long>(smem);
    case kU8: return probe_of<unsigned char>(smem);
    case kF32: return probe_of<float>(smem);
    case kF64: return probe_of<double>(smem);
    default: return nullptr;
  }
}

bool wide(int dt) { return dt == kI64 || dt == kF64; }

int key_bytes(int dt) {
  return dt == kI16 ? 2 : (dt == kI32 || dt == kF32) ? 4 : wide(dt) ? 8 : 1;
}

bool slots_ok(long long slots) {
  return slots >= 2 && slots <= (1LL << 31) && (slots & (slots - 1)) == 0;
}

int log2_of(long long slots) {
  int b = 0;
  while ((1LL << b) < slots) ++b;
  return b;
}

long long staged_bytes(int dt, long long slots) {
  return slots * (wide(dt) ? 12 : 8);
}

Table table_of(int dt, void* base, long long slots) {
  unsigned long long* word = static_cast<unsigned long long*>(base);
  if (!wide(dt)) return {word, nullptr, nullptr, (unsigned)(slots - 1)};
  int* row = reinterpret_cast<int*>(word + slots);
  return {word, row, row + slots, (unsigned)(slots - 1)};
}

// The current card and its SM count.
int sm_count(int* dev, int* sms) {
  cudaError_t err = cudaGetDevice(dev);
  if (err != cudaSuccess) return (int)err;
  if (*dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  static int count[kMaxDevices] = {};
  if (count[*dev] == 0) {
    err = cudaDeviceGetAttribute(&count[*dev],
                                 cudaDevAttrMultiProcessorCount, *dev);
    if (err != cudaSuccess) return (int)err;
  }
  *sms = count[*dev];
  return 0;
}

// Blocks of the probe for a table of `slots` slots: as many as the SMs
// hold, fewer where the rows need fewer.
int probe_grid(int dt, long long slots, long long m, long long* grid,
               long long* smem) {
  int dev = 0, sms = 0;
  int err = sm_count(&dev, &sms);
  if (err != 0) return err;
  const bool staged = slots <= kSmemSlots;
  *smem = staged ? staged_bytes(dt, slots) : 0;
  static int occupancy[kMaxDevices][kTypes][kSmemSizes + 1] = {};
  int* occ = &occupancy[dev][dt][staged ? log2_of(slots) : kSmemSizes];
  if (*occ == 0) {
    err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        occ, probe_fn(dt, staged), kThreads, (size_t)*smem);
    if (err != 0) return err;
    if (*occ <= 0) return (int)cudaErrorInvalidConfiguration;
  }
  const int v = 16 / key_bytes(dt);
  const long long rows_a_block = (long long)kThreads * (v >= 8 ? v : 8);
  const long long need = (m + rows_a_block - 1) / rows_a_block;
  const long long most = (long long)sms * *occ;
  *grid = need < 1 ? 1 : (need < most ? need : most);
  return 0;
}

}  // namespace

extern "C" {

// Slots of the table for a build side of n rows: the least power of two
// >= 2n, and >= 2; where that is a staged table, the least >= 16n, up to
// the largest staged one.
long long gdf_hash_slots(long long n) {
  long long s = 2;
  while (s < 2 * n) s <<= 1;
  if (s > kSmemSlots) return s;
  while (s < 16 * n && s < kSmemSlots) s <<= 1;
  return s;
}

// 1 where a probe stages a table of `slots` slots in shared memory, else 0.
int gdf_hash_staged(long long slots) { return slots <= kSmemSlots; }

// Bytes of a table of `slots` slots for keys of dtype code dt, or -1.
long long gdf_hash_table_bytes(int dt, long long slots) {
  if (build_fn(dt) == nullptr || !slots_ok(slots)) return -1;
  return wide(dt) ? slots * 12 + 16 : slots * 8;
}

// Zero the table and result (int64 [match count, duplicate flag]) and insert
// the live, matchable rows of the build side's n keys; result[1] = 1 if a
// key came twice. table: gdf_hash_table_bytes(dt, slots). Returns a
// cudaError_t.
int gdf_hash_build(int dt, const void* keys, const void* valid,
                   const void* num_rows, long long n, void* table,
                   long long slots, void* result, void* stream) {
  const BuildFn fn = build_fn(dt);
  if (fn == nullptr || n < 0 || n >= (1LL << 31) || !slots_ok(slots) ||
      slots < 2 * n) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Table t = table_of(dt, table, slots);
  int err = (int)cudaMemsetAsync(result, 0, 16, s);
  if (err != 0) return err;
  if (wide(dt)) {
    err = (int)cudaMemsetAsync(t.word, 0xff, slots * 8, s);
    if (err != 0) return err;
    err = (int)cudaMemsetAsync(t.row, 0, slots * 4 + 4, s);
  } else {
    err = (int)cudaMemsetAsync(t.word, 0, slots * 8, s);
  }
  if (err != 0 || n == 0) return err;
  int dev = 0, sms = 0;
  err = sm_count(&dev, &sms);
  if (err != 0) return err;
  const long long need = (n + kThreads - 1) / kThreads;
  const long long most = (long long)sms * kBuildBlocksPerSM;
  const Side b{keys, static_cast<const unsigned char*>(valid),
               static_cast<const int*>(num_rows), n};
  fn<<<(unsigned)(need < most ? need : most), kThreads, 0, s>>>(
      b, t, static_cast<long long*>(result));
  GDF_LAUNCH_CHECK();
  return 0;
}

// Zero result[0] and look up the live, matchable rows of the probe side's
// m keys in a table gdf_hash_build made: each match adds one to result[0]
// and, while the count is below cap, writes (probe row, build row) to
// out_probe / out_build at a free position. Returns a cudaError_t.
int gdf_hash_probe(int dt, const void* keys, const void* valid,
                   const void* num_rows, long long m, const void* table,
                   long long slots, void* out_probe, void* out_build,
                   long long cap, void* result, void* stream) {
  if (probe_fn(dt, false) == nullptr || m < 0 || m >= (1LL << 31) ||
      !slots_ok(slots) || cap < 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err = (int)cudaMemsetAsync(result, 0, 8, s);
  if (err != 0 || m == 0) return err;
  long long grid = 0, smem = 0;
  err = probe_grid(dt, slots, m, &grid, &smem);
  if (err != 0) return err;
  const Side p{keys, static_cast<const unsigned char*>(valid),
               static_cast<const int*>(num_rows), m};
  const Table t = table_of(dt, const_cast<void*>(table), slots);
  const Out o{static_cast<int*>(out_probe), static_cast<int*>(out_build), cap,
              static_cast<unsigned long long*>(result)};
  probe_fn(dt, smem > 0)<<<(unsigned)grid, kThreads, (size_t)smem, s>>>(
      p, t, o);
  GDF_LAUNCH_CHECK();
  return 0;
}

}  // extern "C"
