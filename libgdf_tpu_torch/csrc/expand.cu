// H4 `expand_fill`: monotone expand-fill of up to 8 words in one launch.
//
// Replaces libgdf_tpu/ops/pallas/expand.py _kernel / _run /
// expand_fill_pallas (K7, l.112 / 170 / 226), the many-to-many expansion
// of the duplicate-key join (ops/join.py general path):
//
//   out_w[j] = w[max{i : pos[i] <= j}]   (0 where no pos[i] <= j)
//
// for j < cap, where pos is int32 and non-decreasing (strictly increasing
// over the live sources, then a tail of values >= cap). The TPU kernel
// routes each output block's sources into place through log2(block) shift
// stages and carry-fills with log-step pair scans, because Mosaic has no
// gather. Hopper gathers natively: one thread per output slot finds its
// source by binary search (upper bound minus one) and copies every word.
//
// Bound: device memory. It writes cap x sum(word widths) bytes and reads
// about as much from the sources; the binary search's top levels are shared
// by all threads and stay in L1/L2. At the main path's duplicate-key join
// (cap = 40M, three int32 words) that is ~0.5 GB written.
#include "common.cuh"

namespace {

constexpr int kMaxWords = 8;

struct WordSet {
  const void* in[kMaxWords];
  void* out[kMaxWords];
  int width[kMaxWords];
  int count;
};

__global__ void __launch_bounds__(gdf::kThreads)
expand_fill_kernel(const int* pos, long long npos, long long cap, WordSet ws) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       j < cap; j += stride) {
    long long lo = 0, hi = npos;
    while (lo < hi) {
      const long long mid = (lo + hi) >> 1;
      if ((long long)pos[mid] <= j) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    const long long k = lo - 1;
    for (int w = 0; w < ws.count; ++w) {
      if (ws.width[w] == 4) {
        static_cast<int*>(ws.out[w])[j] =
            k >= 0 ? static_cast<const int*>(ws.in[w])[k] : 0;
      } else {
        static_cast<long long*>(ws.out[w])[j] =
            k >= 0 ? static_cast<const long long*>(ws.in[w])[k] : 0;
      }
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
  if (nwords < 1 || nwords > kMaxWords || cap <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  WordSet ws;
  ws.count = nwords;
  for (int w = 0; w < nwords; ++w) {
    if (widths[w] != 4 && widths[w] != 8) return (int)cudaErrorInvalidValue;
    ws.in[w] = words[w];
    ws.out[w] = outs[w];
    ws.width[w] = widths[w];
  }
  long long blocks = (cap + gdf::kThreads - 1) / gdf::kThreads;
  if (blocks > (1LL << 30)) blocks = 1LL << 30;
  expand_fill_kernel<<<(unsigned)blocks, gdf::kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(pos), npos, cap, ws);
  GDF_LAUNCH_CHECK();
  return 0;
}

}  // extern "C"
