// H4 `expand_fill`: monotone expand-fill of up to 8 words in one launch.
//
// Replaces libgdf_tpu/ops/pallas/expand.py _kernel / _run /
// expand_fill_pallas (K7, l.112 / 170 / 226), the many-to-many expansion
// of the duplicate-key join (ops/join.py general path):
//
//   out_w[j] = w[max{i : pos[i] <= j}]   (0 where no pos[i] <= j)
//
// for j < cap, where pos is int32 and strictly increasing over the live
// sources, followed by a tail of values >= cap (SENTINEL). The TPU kernel
// routes each output block's sources into place through log2(block) shift
// stages and carry-fills with log-step pair scans, because Mosaic has no
// gather.
//
// Bound: device memory. It writes cap x sum(word widths) bytes and reads
// pos and the words once: at the duplicate-key join's shape (40M slots
// from 10M sources, three int32 words) 640 MB, 0.19 ms at 3.35 TB/s.
//
// Design: a tiled fill that searches once per run of slots, not once per
// slot (a search per slot is ~24 dependent loads for 10M sources, which
// made the work latency-bound). Each block owns kRun consecutive slots
// [j0, j0 + kRun):
//   1. Two warps count the sources at or before the run's first and last
//      slot, each with a 32-way search (32 probes per round, ~5 rounds for
//      10M sources). The sources between the two counts start inside the
//      run; strictly increasing positions bound them by kRun.
//   2. The block loads their positions with coalesced loads and sets one
//      bit per starting slot in a shared-memory bitmask (kRun bits).
//   3. A slot's source is the count before the run plus the set bits at or
//      before it: one popcount of its mask word and a prefix of the words'
//      popcounts. This was chosen over a carry-fill max-scan of source
//      indices (kRun ints of shared memory and a block scan) and over a
//      search per thread in shared memory (~12 dependent loads per slot):
//      the bitmask needs 512 bytes and O(1) work per slot.
//   4. For every word, each thread resolves its 4 groups of 4 consecutive
//      slots again from the bitmask (two shared loads and a popcount per
//      group, cheaper than keeping 16 indices live), gathers w[src] (a
//      contiguous window of the word) and writes each group with 16-byte
//      stores where the output is aligned.
//   A block waits on the searches and then on one gather per word, so the
//   fill is latency-bound unless many blocks share an SM: the kernel is
//   held to 32 registers for 8 blocks of 256 threads per SM (chip_smoke.py
//   on an H100 at the shape above: 0.33 ms with 72 registers and 3 blocks
//   per SM, 0.26 ms with 30; runs of 2048 or 8192 slots timed no faster).
#include "common.cuh"

namespace {

constexpr int kMaxWords = 8;
constexpr int kFillThreads = 256;
constexpr int kFillBlocksPerSM = 8;
constexpr int kRun = 4096;                       // output slots per block
constexpr int kGroupsPerThread = kRun / (4 * kFillThreads);
constexpr int kMaskWords = kRun / 32;
static_assert(kMaskWords == 4 * 32, "one warp scans the mask, 4 per lane");

struct WordSet {
  const void* in[kMaxWords];
  void* out[kMaxWords];
  int width[kMaxWords];
  int count;
  int aligned;  // bit w: out[w] is 16-byte aligned
};

// Number of i in [0, npos) with pos[i] <= x, by one whole warp. pos[i] <= x
// holds on a prefix of [0, npos); each round probes 32 points of [lo, hi)
// and keeps the gap between the last probe that holds and the first that
// does not.
__device__ long long count_le(const int* __restrict__ pos, long long npos,
                              long long x) {
  const int lane = threadIdx.x & 31;
  long long lo = 0, hi = npos;  // pos[i] <= x for i < lo, > x for i >= hi
  while (hi - lo > 32) {
    const long long p = lo + (hi - lo) * (lane + 1) / 33;
    const unsigned le = __ballot_sync(0xffffffffu, (long long)pos[p] <= x);
    const int c = __popc(le);
    const long long below = __shfl_sync(0xffffffffu, p, c > 0 ? c - 1 : 0);
    const long long above = __shfl_sync(0xffffffffu, p, c < 32 ? c : 31);
    if (c > 0) lo = below + 1;
    if (c < 32) hi = above;
  }
  const long long p = lo + lane;
  const bool le = p < hi && (long long)pos[p] <= x;
  return lo + __popc(__ballot_sync(0xffffffffu, le));
}

// Slot s of the run takes source first + (bits set at or before s), where
// first = c0 - 1 is the last source at or before the run's first slot.
template <typename T>
__device__ __forceinline__ void fill_word(const T* __restrict__ in,
                                          T* __restrict__ out, bool aligned,
                                          long long first,
                                          const unsigned* s_mask,
                                          const int* s_before, long long j0,
                                          int len) {
#pragma unroll
  for (int k = 0; k < kGroupsPerThread; ++k) {
    const int s = 4 * (k * kFillThreads + threadIdx.x);
    const unsigned m = s_mask[s >> 5];
    const int b = s_before[s >> 5];
    T y[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const long long src =
          first + b + __popc(m & ((2u << ((s + q) & 31)) - 1u));
      y[q] = src >= 0 ? __ldg(in + src) : T(0);
    }
    T* o = out + j0 + s;
    if (aligned && s + 4 <= len) {
      if constexpr (sizeof(T) == 4) {
        *reinterpret_cast<int4*>(o) = make_int4(y[0], y[1], y[2], y[3]);
      } else {
        reinterpret_cast<longlong2*>(o)[0] = make_longlong2(y[0], y[1]);
        reinterpret_cast<longlong2*>(o)[1] = make_longlong2(y[2], y[3]);
      }
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (s + q < len) o[q] = y[q];
      }
    }
  }
}

__global__ void __launch_bounds__(kFillThreads, kFillBlocksPerSM)
expand_fill_runs(const int* __restrict__ pos, long long npos, long long cap,
                 WordSet ws) {
  __shared__ unsigned s_mask[kMaskWords];
  __shared__ int s_before[kMaskWords];  // bits set in earlier mask words
  __shared__ long long s_count[2];
  const long long j0 = (long long)blockIdx.x * kRun;
  const int len = (int)(cap - j0 < kRun ? cap - j0 : kRun);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (warp < 2) {
    const long long c = count_le(pos, npos, warp == 0 ? j0 : j0 + len - 1);
    if (lane == 0) s_count[warp] = c;
  }
  for (int i = threadIdx.x; i < kMaskWords; i += kFillThreads) s_mask[i] = 0;
  __syncthreads();
  const long long c0 = s_count[0];
  const long long c1 = s_count[1];
  // Sources c0 .. c1-1 start at slots pos[i] - j0 in [1, len).
  for (long long i = c0 + threadIdx.x; i < c1; i += kFillThreads) {
    const int s = (int)(pos[i] - j0);
    atomicOr(&s_mask[s >> 5], 1u << (s & 31));
  }
  __syncthreads();
  if (warp == 0) {
    int pc[4];
    int tot = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      pc[q] = __popc(s_mask[4 * lane + q]);
      tot += pc[q];
    }
    int inc = tot;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, inc, d);
      if (lane >= d) inc += y;
    }
    int run = inc - tot;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      s_before[4 * lane + q] = run;
      run += pc[q];
    }
  }
  __syncthreads();

  for (int w = 0; w < ws.count; ++w) {
    const bool aligned = (ws.aligned >> w) & 1;
    if (ws.width[w] == 4) {
      fill_word<int>(static_cast<const int*>(ws.in[w]),
                     static_cast<int*>(ws.out[w]), aligned, c0 - 1, s_mask,
                     s_before, j0, len);
    } else {
      fill_word<long long>(static_cast<const long long*>(ws.in[w]),
                           static_cast<long long*>(ws.out[w]), aligned,
                           c0 - 1, s_mask, s_before, j0, len);
    }
  }
}

}  // namespace

extern "C" {

int gdf_expand_max_words() { return kMaxWords; }

// pos int32[npos]; words of byte width 4 or 8, each [npos]; outs [cap].
// Returns a cudaError_t.
int gdf_expand_fill(const void* pos, long long npos, long long cap,
                    int nwords, const void* const* words, void* const* outs,
                    const int* widths, void* stream) {
  if (nwords < 1 || nwords > kMaxWords || cap <= 0 || npos < 0) {
    return (int)cudaErrorInvalidValue;
  }
  WordSet ws;
  ws.count = nwords;
  ws.aligned = 0;
  for (int w = 0; w < nwords; ++w) {
    if (widths[w] != 4 && widths[w] != 8) return (int)cudaErrorInvalidValue;
    ws.in[w] = words[w];
    ws.out[w] = outs[w];
    ws.width[w] = widths[w];
    if (reinterpret_cast<uintptr_t>(outs[w]) % 16 == 0) ws.aligned |= 1 << w;
  }
  const long long blocks = (cap + kRun - 1) / kRun;
  expand_fill_runs<<<(unsigned)blocks, kFillThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(pos), npos, cap, ws);
  GDF_LAUNCH_CHECK();
  return 0;
}

}  // extern "C"
