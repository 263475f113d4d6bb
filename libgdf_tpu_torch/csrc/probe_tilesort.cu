// P-1 `tile_sort`: each 65,536-element block of (key, payload) sorted
// ascending by the pair, both signed int32, as a bitonic network.
//
// Replaces benchmarks/probe_tilesort.py:91 `tile_sort` (kernel `_kernel`,
// l.57): the TPU holds one 512 x 128 block of key and payload in VMEM and
// runs all 136 compare-exchange stages of the 2^16-element network on it
// (sizes 2^1 .. 2^16, size 2^k has k stages), partners found by rolls.
// Read as a function: a stage of size 2^k sorts ascending where bit k of
// the in-block index is 0, and size 2^16 is all ascending. Key and payload
// are packed into one int64 whose signed order is the pair's (key, then
// payload, both signed), so a compare-exchange is one 64-bit compare.
//
// Bound: the byte bound is n x 16 bytes read and written once (11.5M
// pairs: 184 MB, 0.055 ms at 3.35 TB/s), but on this card the network is
// bound by instructions: a compare-exchange of two packed words is two
// compares (the direction folded into the second) and four selects, all
// on the integer ALU pipe, 136 x n/2 of them; then by the shared-memory
// traffic of moving words between threads, then by device memory.
//
// Design: one launch of 4-CTA thread-block clusters, a cluster per 64K
// block, each CTA a 16,384-element tile (128 KB of packed words, one CTA
// an SM), 512 threads of 32 words each, held in registers.
//   - Every stage runs in registers. A layout gives 5 of the tile's 14
//     index bits to the register (compile-time indices, fully unrolled)
//     and the other 9 to the thread; a stage at distance 2^j runs in a
//     layout whose register bits hold j. Sizes 2 .. 32 run in the first
//     layout (index bits 0..4), their directions compile-time constants;
//     for every later stage bit k of the index is a thread bit, so the
//     direction is one predicate a thread, folded into the swap test.
//   - Shared memory only transposes: a change of layout writes the words
//     out, syncs and reads them back with 5 new bits in the register. A
//     size 2^k takes ceil(k / 5) layouts: 29 round trips in all, where a
//     stage at a time in shared memory takes 130 barriers. Word i sits at
//     i ^ ((i >> 5) & 15), so that in every layout a warp's 32 accesses of
//     8 bytes fall on 16 distinct bank pairs, two each: no conflict. A
//     transpose syncs only the threads that trade words in it: one warp
//     for every layout change of sizes up to 2^10, 2 to 8 warps above,
//     the CTA where index bit 13 moves (`sync_group`), so that warps drift
//     apart and one's stages overlap another's transposes.
//   - The three stages across tiles, (k, j) = (15, 14), (16, 15) and
//     (16, 14), read the partner word from the peer CTA's shared memory at
//     the same offset (map_shared_rank, 16 bytes = two words a thread, a
//     warp's loads coalesced), between two cluster barriers; the read is
//     fused with the transpose into the next layout.
//   - Index arithmetic is 32-bit within the tile; device memory is read
//     once and written once, 16 bytes a load where the pointers allow.
//   - No register spills at 128 registers a thread: addresses are formed
//     where they are used, and a cross stage keeps 8 words in flight.
// The wrapper asks cudaOccupancyMaxActiveClusters once a card and raises
// if no cluster of 4 CTAs with 128 KB each can be scheduled. Measured on
// the H100 (PERF.md): the 5-launch alternative (two device-memory passes
// for the stages across tiles) was slower.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kBlockLog = 16;               // elements per sorted block: 2^16
constexpr long long kBlock = 1LL << kBlockLog;
constexpr int kTileLog = 14;                // elements per CTA: 2^14
constexpr int kTile = 1 << kTileLog;
constexpr int kCluster = 1 << (kBlockLog - kTileLog);     // 4 CTAs a block
constexpr int kRegLog = 5;                  // words per thread: 2^5
constexpr int kWords = 1 << kRegLog;
constexpr int kSortThreads = kTile / kWords;              // 512
constexpr size_t kTileBytes = kTile * sizeof(long long);  // 128 KB
constexpr int kMaxBase = kTileLog - kRegLog;              // 9
constexpr int kCrossChunk = 8;              // words of a cross stage in flight

__device__ __forceinline__ long long pack(int key, int pay) {
  return (long long)((unsigned long long)(unsigned)key << 32 |
                     (unsigned)(pay ^ 0x80000000));
}

__device__ __forceinline__ int key_of(long long w) { return (int)(w >> 32); }

__device__ __forceinline__ int pay_of(long long w) {
  return (int)((unsigned)w ^ 0x80000000u);
}

// Shared-memory slot of tile index i. Linear over XOR, so the slot of a
// thread part | a register part is the XOR of their slots.
__host__ __device__ constexpr unsigned swizzle(unsigned i) {
  return i ^ (i >> 5 & 15u);
}

// Layout "window B": index bits B .. B+4 are the register's, the rest the
// thread's, in order.
template <int B>
struct Window {
  static_assert(B >= 0 && B <= kMaxBase, "window inside the tile");
  __device__ __forceinline__ static unsigned thread_part(unsigned t) {
    return (t & ((1u << B) - 1)) | (t >> B) << (B + kRegLog);
  }
  __host__ __device__ static constexpr unsigned reg_part(int e) {
    return (unsigned)e << B;
  }
};

// Layout of the stages across tiles: index bits 0 and 10..13 are the
// register's, bits 1..9 the thread's. Registers 2p and 2p + 1 are
// neighbouring words, one 16-byte load.
struct Cross {
  __device__ __forceinline__ static unsigned thread_part(unsigned t) {
    return t << 1;
  }
  __host__ __device__ static constexpr unsigned reg_part(int e) {
    return (unsigned)(e & 1) | (unsigned)(e >> 1) << 10;
  }
};

// The thread's slot in layout L, formed where it is used: the empty asm
// on t keeps the compiler from computing the 32 addresses of a layout
// once and holding them live across the stages (they spilled).
template <class L>
__device__ __forceinline__ unsigned thread_slot(unsigned t) {
  asm volatile("" : "+r"(t));
  return swizzle(L::thread_part(t));
}

template <class L>
__device__ __forceinline__ void store(long long* s, const long long (&w)[kWords],
                                      unsigned t) {
  const unsigned pt = thread_slot<L>(t);
#pragma unroll
  for (int e = 0; e < kWords; ++e) s[pt ^ swizzle(L::reg_part(e))] = w[e];
}

template <class L>
__device__ __forceinline__ void load(const long long* s, long long (&w)[kWords],
                                     unsigned t) {
  const unsigned pt = thread_slot<L>(t);
#pragma unroll
  for (int e = 0; e < kWords; ++e) w[e] = s[pt ^ swizzle(L::reg_part(e))];
}

// store<Window<base>> and load<Window<base>> for a window chosen at run time.
template <int B = 0>
__device__ __forceinline__ void store_window(long long* s,
                                             const long long (&w)[kWords],
                                             unsigned t, int base) {
  if constexpr (B <= kMaxBase) {
    if (base == B) {
      store<Window<B>>(s, w, t);
    } else {
      store_window<B + 1>(s, w, t, base);
    }
  }
}

template <int B = 0>
__device__ __forceinline__ void load_window(const long long* s,
                                            long long (&w)[kWords],
                                            unsigned t, int base) {
  if constexpr (B <= kMaxBase) {
    if (base == B) {
      load<Window<B>>(s, w, t);
    } else {
      load_window<B + 1>(s, w, t, base);
    }
  }
}

// The barrier between a transpose's stores and its loads, over the
// threads that trade words in it. A thread stores its words to the slots
// it loaded them from, so no barrier goes before the stores. In window B
// thread bit p >= B holds index bit p + 5, so between windows A and B the
// 2^max(A, B) threads that share thread bits max(A, B) .. 8 hold the same
// words before and after, in slots no other thread touches: a warp syncs
// alone up to window 5, groups of 2, 4 and 8 warps at windows 6, 7 and 8
// (named barriers 1-8, 9-12, 13-14), the CTA at window 9 and in the
// cross layout. The groups drift apart, so that one group's stages run
// while another moves its words.
__device__ __forceinline__ void sync_group(unsigned t, int bits) {
  if (bits <= kRegLog) {
    __syncwarp();
  } else if (bits < kTileLog - kRegLog) {
    const unsigned first_id = bits == 6 ? 1 : bits == 7 ? 9 : 13;
    asm volatile("bar.sync %0, %1;" :: "r"(first_id + (t >> bits)),
                 "r"(1u << bits) : "memory");
  } else {
    __syncthreads();
  }
}

template <class From, class To>
__device__ __forceinline__ void transpose(long long* s, long long (&w)[kWords],
                                          unsigned t, int bits) {
  store<From>(s, w, t);
  sync_group(t, bits);
  load<To>(s, w, t);
}

// Sorts a and b ascending, or descending where `desc`.
__device__ __forceinline__ void cx(long long& a, long long& b, bool desc) {
  const bool swap = (b < a) != desc;
  const long long lo = swap ? b : a;
  b = swap ? a : b;
  a = lo;
}

// One stage between registers e and e + 2^Q, one direction for all.
template <int Q>
__device__ __forceinline__ void stage(long long (&w)[kWords], bool desc) {
#pragma unroll
  for (int e = 0; e < kWords; ++e) {
    if (!(e >> Q & 1)) cx(w[e], w[e | 1 << Q], desc);
  }
}

__device__ __forceinline__ void stage_at(long long (&w)[kWords], int q,
                                         bool desc) {
  switch (q) {
    case 0: stage<0>(w, desc); break;
    case 1: stage<1>(w, desc); break;
    case 2: stage<2>(w, desc); break;
    case 3: stage<3>(w, desc); break;
    default: stage<4>(w, desc); break;
  }
}

// Sizes 2 .. 32 in the first layout (window 0): index bits 0..4 are the
// register's, so the directions of sizes 2 .. 16 are constants; size 32's
// is index bit 5, bit 0 of the thread.
__device__ __forceinline__ void sort_runs(long long (&w)[kWords], unsigned t) {
#pragma unroll
  for (int k = 1; k <= kRegLog; ++k) {
#pragma unroll
    for (int q = k - 1; q >= 0; --q) {
#pragma unroll
      for (int e = 0; e < kWords; ++e) {
        if (!(e >> q & 1)) {
          cx(w[e], w[e | 1 << q], k < kRegLog ? (e >> k & 1) : (t & 1));
        }
      }
    }
  }
}

// Bit k of the in-block index of this thread's words in window `base`
// (k above the window); `rank` is the tile's place in its block.
__device__ __forceinline__ bool index_bit(unsigned t, int base, unsigned rank,
                                          int k) {
  const unsigned i = rank << kTileLog | (t & ((1u << base) - 1)) |
                     (t >> base) << (base + kRegLog);
  return k < kBlockLog && (i >> k & 1);
}

// Sizes 64 .. 16,384: every stage inside the tile. Starts and ends in
// window 0.
__device__ __forceinline__ void sort_tile(long long* s, long long (&w)[kWords],
                                          unsigned t, unsigned rank) {
  int cur = 0;
  for (int k = kRegLog + 1; k <= kTileLog; ++k) {
    for (int hi = k - 1; hi >= 0; hi -= kRegLog) {
      const int base = max(hi - (kRegLog - 1), 0);
      store_window(s, w, t, cur);
      sync_group(t, max(cur, base));
      load_window(s, w, t, base);
      cur = base;
      const bool desc = index_bit(t, base, rank, k);
      for (int j = hi; j >= base; --j) stage_at(w, j - base, desc);
    }
  }
}

// The in-tile stages (j = 13 .. 0) of a size past the tile, from the cross
// layout to window 0; `desc` is the tile's direction.
__device__ __forceinline__ void finish_size(long long* s,
                                            long long (&w)[kWords],
                                            unsigned t, bool desc) {
  stage<4>(w, desc);                    // j = 13 .. 10
  stage<3>(w, desc);
  stage<2>(w, desc);
  stage<1>(w, desc);
  transpose<Cross, Window<5>>(s, w, t, kTileLog - kRegLog);
  stage<4>(w, desc);                    // j = 9 .. 5
  stage<3>(w, desc);
  stage<2>(w, desc);
  stage<1>(w, desc);
  stage<0>(w, desc);
  transpose<Window<5>, Window<0>>(s, w, t, 5);
  stage<4>(w, desc);                    // j = 4 .. 0
  stage<3>(w, desc);
  stage<2>(w, desc);
  stage<1>(w, desc);
  stage<0>(w, desc);
}

// One stage across tiles: each word against the word at the same index
// of `peer` (shared memory of another CTA of the cluster, in the cross
// layout), keeping the smaller where `keep_min`; this thread's own words
// come from `own` (its CTA's shared memory, in the same layout) where
// kOwn, else they are in w already. Pairs of registers come as one 16-byte
// load; which of the two is the lower slot depends on index bit 5 (thread
// bit 4), through the swizzle. The loads go in chunks of kCrossChunk
// words, so that a chunk's, not all 32 words', are in flight.
template <bool kOwn>
__device__ __forceinline__ void cross_stage(const long long* own,
                                            const long long* peer,
                                            long long (&w)[kWords],
                                            unsigned t, bool keep_min) {
  const unsigned pt = thread_slot<Cross>(t);
  const bool odd = pt & 1;
  const longlong2* own2 = reinterpret_cast<const longlong2*>(own);
  const longlong2* peer2 = reinterpret_cast<const longlong2*>(peer);
#pragma unroll
  for (int c = 0; c < kWords; c += kCrossChunk) {
#pragma unroll
    for (int e = c; e < c + kCrossChunk; e += 2) {
      const unsigned at = ((pt & ~1u) ^ Cross::reg_part(e)) >> 1;
      const longlong2 v = peer2[at];
      if (kOwn) {
        const longlong2 u = own2[at];
        w[e] = odd ? u.y : u.x;
        w[e + 1] = odd ? u.x : u.y;
      }
      const long long a = odd ? v.y : v.x;
      const long long b = odd ? v.x : v.y;
      w[e] = (a < w[e]) == keep_min ? a : w[e];
      w[e + 1] = (b < w[e + 1]) == keep_min ? b : w[e + 1];
    }
    asm volatile("" ::: "memory");
  }
}

__device__ __forceinline__ void load_run(const int* key, const int* pay,
                                         long long at, bool vec,
                                         long long (&w)[kWords]) {
  if (vec) {
    const int4* k4 = reinterpret_cast<const int4*>(key + at);
    const int4* p4 = reinterpret_cast<const int4*>(pay + at);
#pragma unroll
    for (int v = 0; v < kWords / 4; ++v) {
      const int4 k = k4[v];
      const int4 p = p4[v];
      w[4 * v] = pack(k.x, p.x);
      w[4 * v + 1] = pack(k.y, p.y);
      w[4 * v + 2] = pack(k.z, p.z);
      w[4 * v + 3] = pack(k.w, p.w);
    }
  } else {
#pragma unroll
    for (int e = 0; e < kWords; ++e) w[e] = pack(key[at + e], pay[at + e]);
  }
}

__device__ __forceinline__ void store_run(int* key, int* pay, long long at,
                                          bool vec,
                                          const long long (&w)[kWords]) {
  if (vec) {
    int4* k4 = reinterpret_cast<int4*>(key + at);
    int4* p4 = reinterpret_cast<int4*>(pay + at);
#pragma unroll
    for (int v = 0; v < kWords / 4; ++v) {
      k4[v] = make_int4(key_of(w[4 * v]), key_of(w[4 * v + 1]),
                        key_of(w[4 * v + 2]), key_of(w[4 * v + 3]));
      p4[v] = make_int4(pay_of(w[4 * v]), pay_of(w[4 * v + 1]),
                        pay_of(w[4 * v + 2]), pay_of(w[4 * v + 3]));
    }
  } else {
#pragma unroll
    for (int e = 0; e < kWords; ++e) {
      key[at + e] = key_of(w[e]);
      pay[at + e] = pay_of(w[e]);
    }
  }
}

// A cluster of 4 CTAs sorts one 64K block; CTA `rank` holds elements
// [rank x 16,384, (rank + 1) x 16,384) of it, thread t the words
// t x 32 .. t x 32 + 31 of its tile on the way in and out (window 0).
__global__ void __launch_bounds__(kSortThreads, 1)
tile_sort_cluster(const int* __restrict__ key_in,
                  const int* __restrict__ pay_in, int* __restrict__ key_out,
                  int* __restrict__ pay_out, int vec) {
  extern __shared__ __align__(16) long long s_w[];
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned t = threadIdx.x;
  const unsigned rank = cluster.block_rank();
  const long long at = (long long)blockIdx.x * kTile + t * kWords;
  long long w[kWords];
  load_run(key_in, pay_in, at, vec, w);
  sort_runs(w, t);
  sort_tile(s_w, w, t, rank);

  // sizes 2^15 and 2^16: a stage across tiles per index bit j >= 14, the
  // peer CTA's rank differing in bit j - 14, then the 14 in-tile stages
  for (int k = kTileLog + 1; k <= kBlockLog; ++k) {
    const bool asc = k == kBlockLog || !(rank >> (k - kTileLog) & 1);
    store<Window<0>>(s_w, w, t);
    cluster.sync();
    for (int j = k - 1; j >= kTileLog; --j) {
      const unsigned bit = 1u << (j - kTileLog);
      const long long* peer = cluster.map_shared_rank(s_w, rank ^ bit);
      const bool keep_min = !(rank & bit) == asc;
      if (j == k - 1) {
        cross_stage<true>(s_w, peer, w, t, keep_min);
      } else {
        store<Cross>(s_w, w, t);
        cluster.sync();
        cross_stage<false>(s_w, peer, w, t, keep_min);
      }
      cluster.sync();                   // no CTA leaves while read
    }
    finish_size(s_w, w, t, !asc);
  }
  store_run(key_out, pay_out, at, vec, w);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

cudaLaunchConfig_t cluster_config(unsigned tiles, cudaStream_t stream,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles);
  cfg.blockDim = dim3(kSortThreads);
  cfg.dynamicSmemBytes = kTileBytes;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = kCluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

cudaError_t allow_smem() {
  return cudaFuncSetAttribute(tile_sort_cluster,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)kTileBytes);
}

}  // namespace

extern "C" {

// *clusters = how many 4-CTA clusters of the tile sort the current card
// holds at once (0: it cannot run). Returns a cudaError_t.
int gdf_probe_tile_sort_clusters(int* clusters) {
  cudaError_t err = allow_smem();
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = cluster_config(kCluster, nullptr, &attr);
  return (int)cudaOccupancyMaxActiveClusters(clusters, tile_sort_cluster,
                                             &cfg);
}

// key, pay int32[n] -> key_out, pay_out int32[n], each 65,536-element
// block sorted by (key, pay); n a positive multiple of 65,536. One launch
// on `stream`. Returns a cudaError_t.
int gdf_probe_tile_sort(const void* key, const void* pay, void* key_out,
                        void* pay_out, long long n, void* stream) {
  if (n <= 0 || n % kBlock != 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem();
  if (err != cudaSuccess) return (int)err;
  const int vec = aligned16(key) && aligned16(pay) && aligned16(key_out) &&
                  aligned16(pay_out);
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = cluster_config(
      (unsigned)(n / kTile), static_cast<cudaStream_t>(stream), &attr);
  err = cudaLaunchKernelEx(&cfg, tile_sort_cluster,
                           static_cast<const int*>(key),
                           static_cast<const int*>(pay),
                           static_cast<int*>(key_out),
                           static_cast<int*>(pay_out), vec);
  if (err != cudaSuccess) return (int)err;
  GDF_LAUNCH_CHECK();
  return 0;
}

}  // extern "C"
