// Decoupled look-back (Merrill & Garland, "Single-pass Parallel Prefix
// Scan with Decoupled Look-back", NVIDIA 2016), shared by the single-pass
// kernels: H1 compact (over int32 tile counts), H2 scan and H3 seg_scan.
//
// A launch owns one scratch buffer, zeroed on its stream just before the
// launch (init_scratch): a tile counter, then one descriptor per tile.
// Each block takes the next tile from the counter (next_tile), so tiles
// start in order and a block only ever waits on blocks that are running,
// whatever order the hardware starts blocks in.
//
// A descriptor is sizeof(T) / 4 words of 8 bytes, each holding a tag in
// its high half and 32 bits of the value in its low half, stored and
// loaded whole (st/ld.relaxed.gpu: an aligned 8-byte access is single-copy
// atomic). The tag is the status, and for a segmented scan the segment
// flag beside it: tag = status | flag << 2. A reader takes a descriptor
// only when all its words carry the same tag, so the two halves of an
// 8-byte value can never come from the aggregate and the inclusive prefix;
// a torn read counts as not yet published. No 16-byte store is assumed
// whole, and the look-back needs no fence and no load that waits on
// another (a separate status word behind __threadfence(), read with an
// acquire load before the value, timed slower at 8 bytes on an H100).
//
// Segmented scans (FLAGS): combine((fa, va), (fb, vb)) = (fa | fb,
// fb ? vb : op(va, vb)), so a flagged tile aggregate is already its own
// inclusive prefix. The look-back stops at the nearest predecessor that is
// an inclusive prefix or a flagged aggregate; the tiles in between are
// unflagged aggregates and combine by op alone.
//
// The combine is a policy O with O::ident() and O::apply(earlier, later).
#pragma once

#include "common.cuh"

#include <string.h>

namespace gdf {

constexpr long long kDescBase = 16;  // scratch: tile counter, then descriptors

enum Status : unsigned { kInvalid = 0, kAggregate = 1, kPrefix = 2 };

struct Descs {
  unsigned* counter;           // the next tile to hand out
  unsigned long long* words;   // per tile: desc_words<T>() x (tag << 32 | bits)
};

template <typename T> __host__ __device__ constexpr int desc_words() {
  return sizeof(T) / 4;
}

// Bytes of scratch for the descriptors of ntiles tiles of T.
template <typename T> long long lookback_scratch_bytes(long long ntiles) {
  return kDescBase + 8LL * desc_words<T>() * ntiles;
}

// Points d into the scratch and zeroes its first `need` bytes on the
// stream. Returns a cudaError_t (cudaErrorInvalidValue if nbytes < need).
inline int init_scratch(void* scratch, long long nbytes, long long need,
                        cudaStream_t s, Descs* d) {
  if (nbytes < need) return (int)cudaErrorInvalidValue;
  char* base = static_cast<char*>(scratch);
  d->counter = reinterpret_cast<unsigned*>(base);
  d->words = reinterpret_cast<unsigned long long*>(base + kDescBase);
  return (int)cudaMemsetAsync(scratch, 0, (size_t)need, s);
}

// The block's tile: the next one from the counter. Every thread of the
// block must call it; s_tile is one shared long long.
__device__ __forceinline__ long long next_tile(const Descs& d,
                                               long long* s_tile) {
  if (threadIdx.x == 0) *s_tile = atomicAdd(d.counter, 1u);
  __syncthreads();
  return *s_tile;
}

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
                                        unsigned s, T v, unsigned flag = 0) {
  constexpr int W = desc_words<T>();
  const unsigned tag = s | flag << 2;
  unsigned bits[W];
  memcpy(bits, &v, sizeof(T));
#pragma unroll
  for (int k = 0; k < W; ++k) {
    st_relaxed(&d.words[t * W + k], ((unsigned long long)tag << 32) | bits[k]);
  }
}

template <typename T, bool FLAGS>
__device__ __forceinline__ void read_desc(const Descs& d, long long t,
                                          unsigned& s, unsigned& f, T& v) {
  constexpr int W = desc_words<T>();
  unsigned long long w[W];
#pragma unroll
  for (int k = 0; k < W; ++k) w[k] = ld_relaxed(&d.words[t * W + k]);
  unsigned bits[W];
  unsigned tag = (unsigned)(w[0] >> 32);
#pragma unroll
  for (int k = 0; k < W; ++k) {
    if ((unsigned)(w[k] >> 32) != tag) tag = kInvalid;
    bits[k] = (unsigned)w[k];
  }
  s = FLAGS ? tag & 3u : tag;
  f = FLAGS ? tag >> 2 : 0u;
  memcpy(&v, bits, sizeof(T));
}

template <typename T, class O>
__device__ __forceinline__ T warp_inclusive(T x) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const T y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x = O::apply(y, x);
  }
  return x;
}

// Inclusive scan across the warp of segments that start at the lanes set
// in `heads`: a lane combines with the lane d below it only while that
// lane is in its own segment. O::ident() is never a left operand, which
// matters for `carry` (op(a, b) = a), whose identity is a right one only.
template <typename T, class O>
__device__ __forceinline__ T seg_warp_inclusive(T x, unsigned heads) {
  const int lane = threadIdx.x & 31;
  const unsigned le = heads & ((2u << lane) - 1u);
  const int lo = le ? 31 - __clz((int)le) : 0;   // this lane's segment head
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const T y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane - d >= lo) x = O::apply(y, x);
  }
  return x;
}

// One warp: the combination of every tile before `tile`. It reads the
// descriptors of 32 predecessors at a time (lane 31 the nearest), waits
// until all are published, combines them back to the nearest one that
// stops the walk (an inclusive prefix, or with FLAGS a flagged aggregate)
// and returns there, or moves 32 tiles back. With FLAGS, *flag gets the
// segment flag of the result: that of the descriptor it stopped at.
template <typename T, class O, bool FLAGS>
__device__ T look_back(const Descs& d, long long tile, unsigned* flag) {
  const int lane = threadIdx.x & 31;
  T acc = O::ident();
  for (long long end = tile - 1;; end -= 32) {
    const long long t = end - 31 + lane;
    unsigned s = kPrefix, f = 0;     // before tile 0: the identity
    T v = O::ident();
    do {
      if (t >= 0) read_desc<T, FLAGS>(d, t, s, f, v);
    } while (__any_sync(0xffffffffu, s == kInvalid));
    const unsigned stop = __ballot_sync(0xffffffffu, s == kPrefix || f);
    const int from = stop ? 31 - __clz((int)stop) : 0;
    T x;
    if constexpr (FLAGS) {
      x = seg_warp_inclusive<T, O>(v, 1u << from);
    } else {
      x = warp_inclusive<T, O>(lane >= from ? v : O::ident());
    }
    acc = O::apply(__shfl_sync(0xffffffffu, x, 31), acc);
    if (stop) {
      if (FLAGS) *flag = __shfl_sync(0xffffffffu, f, from);
      return acc;
    }
  }
}

}  // namespace gdf
