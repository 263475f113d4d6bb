"""The design choices of P-14 `cap_dyn_loop` and of the lane gather (P-2,
P-12), measured on one card.

    python -m libgdf_tpu_torch.probes.designs [--reps 50] [--rounds 3]

Device ms a call from torch.profiler over `reps` back-to-back calls (the
inputs stay in L2 between calls), each design's timings in turns, each
result held to the plain version first:

- routes: P-14 through its C entry point on (8, cols) ones at trip counts
  2, 3 and 9 (x[0, 0] = 0, 1, 7), for cols from 128 to 2^20, loading all 8
  rows with x[0, 0] (`all_rows` 1) or rows 2..7 only where the trip count
  reads them (0): `caps.LOOP_ALL_ROWS_COLS` is the widest x at which the
  first is no slower at any trip count.
- mask: P-14's all-rows route as built against the same kernel with each
  row's sum under `if (k < n)` in place of a mask, at 128 columns and
  trip counts 2 and 9, and the order of the global loads (LDG) and
  compares (ISETP) in each one's SASS (`cuobjdump -sass`).
- lane: the lane gather as built (a warp a row, a block for every 8 rows)
  against a register-only gather (the same grid, each output word taken
  by 4 shuffles of the lane's 4 words and a select) and a persistent grid
  whose warps load their next row before they gather the current one, at
  8, 1024 and 81,920 rows of float32.

The other designs come from DESIGNS_SRC, two sources that include the
package's `csrc/probe_caps.cu` and `csrc/probe_gather.cu`, built by nvcc
into one library under build/exp/. Prints the card line and one line per
case; exits 1 without CUDA, and raises if a result differs from the
plain version.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import os
import re
import subprocess
import sys

import numpy as np
import torch

from ..ops.kernels import _lib
from . import caps, gather, turns

# {file: source}, each a translation unit of its own (the package's sources
# keep their helpers in anonymous namespaces), linked into one library
DESIGNS_SRC = {"loop": r"""
#include "probe_caps.cu"

namespace {

template <bool kVec>
__global__ void __launch_bounds__(kLoopThreads)
cap_dyn_loop_branch(const int* __restrict__ x, int* __restrict__ out,
                    int cols) {
  const long long j = 4 * ((long long)blockIdx.x * kLoopThreads +
                           threadIdx.x);
  if (j >= cols) return;
  const int live = cols - j < 4 ? (int)(cols - j) : 4;
  const int x00 = x[0];
  uint4 v[kLoopRows];
#pragma unroll
  for (int k = 0; k < kLoopRows; ++k) {
    v[k] = load_cols<kVec>(x + (long long)k * cols + j, live);
  }
  const int n = (x00 & 7) + 2;
  uint4 acc = add4(v[0], v[1]);
#pragma unroll
  for (int k = 2; k < kLoopRows; ++k) {
    if (k < n) acc = add4(acc, v[k]);
  }
  if (n > kLoopRows) acc = add4(acc, v[0]);
  store_cols<kVec>(out + j, acc, live);
}

}  // namespace

// x, out int32 (8, cols), 16-byte aligned, cols % 4 == 0.
extern "C" int design_dyn_loop_branch(const void* x, void* out, int cols,
                                      void* stream) {
  cap_dyn_loop_branch<true><<<(unsigned)((cols / 4 + kLoopThreads - 1) /
                                         kLoopThreads),
                              kLoopThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(x), static_cast<int*>(out), cols);
  return (int)cudaGetLastError();
}
""", "lane": r"""
#include "probe_gather.cu"

namespace {

__global__ void __launch_bounds__(kGatherThreads)
lane_gather_shfl(const unsigned* __restrict__ x, const int* __restrict__ idx,
                 unsigned* __restrict__ out, long long rows, unsigned fill) {
  const int lane = threadIdx.x & 31;
  const long long r = (long long)blockIdx.x * kGatherWarps +
                      (threadIdx.x >> 5);
  if (r >= rows) return;
  unsigned xv[4], o[4];
  int iv[4];
  load_row<true>(x + r * kLanes, lane, xv);
  load_row<true>(idx + r * kLanes, lane, iv);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const long long c = resolve(iv[k], kLanes);
    const int src = (int)((c >> 2) & 31);
    unsigned w[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) w[q] = __shfl_sync(0xffffffffu, xv[q], src);
    const int sel = (int)(c & 3);
    const unsigned got = sel == 0 ? w[0] : sel == 1 ? w[1]
                       : sel == 2 ? w[2] : w[3];
    o[k] = c >= 0 ? got : fill;
  }
  store_row<true>(out + r * kLanes, lane, o);
}

__global__ void __launch_bounds__(kGatherThreads)
lane_gather_prefetch(const unsigned* __restrict__ x,
                     const int* __restrict__ idx, unsigned* __restrict__ out,
                     long long rows, unsigned fill) {
  __shared__ __align__(16) unsigned s_rows[kGatherWarps][kLanes];
  const int lane = threadIdx.x & 31;
  unsigned* row = s_rows[threadIdx.x >> 5];
  const long long stride = (long long)gridDim.x * kGatherWarps;
  long long r = (long long)blockIdx.x * kGatherWarps + (threadIdx.x >> 5);
  if (r >= rows) return;
  unsigned xv[4];
  int iv[4];
  load_row<true>(x + r * kLanes, lane, xv);
  load_row<true>(idx + r * kLanes, lane, iv);
  for (; r < rows; r += stride) {
    unsigned xn[4] = {0u, 0u, 0u, 0u};
    int in[4] = {0, 0, 0, 0};
    if (r + stride < rows) {
      load_row<true>(x + (r + stride) * kLanes, lane, xn);
      load_row<true>(idx + (r + stride) * kLanes, lane, in);
    }
    store_row<true>(row, lane, xv);
    __syncwarp();
    unsigned o[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const long long c = resolve(iv[k], kLanes);
      o[k] = c >= 0 ? row[c] : fill;
    }
    store_row<true>(out + r * kLanes, lane, o);
    __syncwarp();
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      xv[k] = xn[k];
      iv[k] = in[k];
    }
  }
}

}  // namespace

// variant 0: register-only, a warp a row; 1: persistent with the next row
// prefetched (grid: the blocks the SMs hold at once, at most the rows').
// x, idx, out (rows, 128), 16-byte aligned.
extern "C" int design_lane(int variant, const void* x, const void* idx,
                           void* out, long long rows, int fill,
                           void* stream) {
  auto* kernel = variant == 0 ? &lane_gather_shfl : &lane_gather_prefetch;
  long long blocks = (rows + kGatherWarps - 1) / kGatherWarps;
  if (variant == 1) {
    int dev = 0, per_sm = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, kernel, kGatherThreads, 0);
    }
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                   dev);
    }
    if (err != cudaSuccess) return (int)err;
    if (blocks > (long long)per_sm * sms) blocks = (long long)per_sm * sms;
  }
  kernel<<<(unsigned)blocks, kGatherThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned*>(x), static_cast<const int*>(idx),
      static_cast<unsigned*>(out), rows, (unsigned)fill);
  return (int)cudaGetLastError();
}
"""}
ROUTE_COLS = (128, 4096, 16_384, 32_768, 65_536, 262_144, 1 << 20)
ROUTE_X00 = (0, 1, 7)                   # 2, 3 and 9 trips
LANE_ROWS = (8, 1024, 81_920)


def build() -> str:
    """The library of DESIGNS_SRC, built by nvcc into build/exp/ unless it
    is there for these sources and the package's."""
    exp = _lib.BUILD_DIR.parent / "exp"
    exp.mkdir(parents=True, exist_ok=True)
    h = hashlib.sha256(_lib.library_path().name.encode())
    for text in DESIGNS_SRC.values():
        h.update(text.encode())
    tag = h.hexdigest()[:16]
    so = exp / f"designs_{tag}.so"
    if not so.exists():
        srcs = []
        for name, text in DESIGNS_SRC.items():
            srcs.append(exp / f"designs_{tag}_{name}.cu")
            srcs[-1].write_text(text)
        subprocess.run([_lib._nvcc(), *_lib.NVCC_FLAGS, "-I", str(_lib.CSRC),
                        "-shared", "-o", str(so), *map(str, srcs)],
                       check=True, capture_output=True, timeout=600)
    return str(so)


def sass_order(so: str, kernel: str) -> str:
    """LDG, ISETP and STG of the kernel whose mangled name holds `kernel`,
    in SASS order, a predicated one prefixed with its guard."""
    cuobjdump = os.path.join(os.path.dirname(_lib._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", so], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    ops, inside = [], False
    pat = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(@!?U?P\w+\s+)?"
                     r"((?:LDG|ISETP|STG)[A-Z0-9_.]*)")
    for ln in sass.splitlines():
        if "Function :" in ln:
            inside = kernel in ln
        elif inside and (m := pat.search(ln)):
            ops.append((m.group(1) or "").strip() + m.group(2).split(".")[0])
    return " ".join(ops)


def _timed(runs: dict, reps: int, rounds: int) -> dict:
    """{name: [device ms]} of each run, in turns (order reversed every
    other round)."""
    out = {k: [] for k in runs}
    for r in range(rounds):
        for k in (list(runs) if r % 2 == 0 else list(runs)[::-1]):
            out[k].append(turns.device_ms(runs[k], reps)[0])
    return out


def _line(what: str, times: dict, card: str) -> str:
    return f"{what}: " + " ".join(
        f"{k}=" + ",".join("None" if t is None else f"{t:.6f}" for t in v)
        for k, v in times.items()) + f" ({card})"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m libgdf_tpu_torch.probes.designs",
        description="P-14's and the lane gather's design choices, timed on "
                    "one card.")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("designs: CUDA is not available", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = turns.card_line()
    print(card, flush=True)
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib = _lib.lib()
    so = build()
    designs = ctypes.CDLL(so)
    designs.design_dyn_loop_branch.argtypes = [ctypes.c_void_p] * 2 + [
        ctypes.c_int, ctypes.c_void_p]
    designs.design_lane.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]

    def check(fn, out, want, what):
        if fn() != 0:
            raise RuntimeError(f"{what}: launch failed")
        if not turns._equal(out, want):
            raise RuntimeError(f"{what}: differs from the plain version")

    for cols in ROUTE_COLS:
        x = torch.ones((caps.LOOP_ROWS, cols), dtype=torch.int32, device=dev)
        out = torch.empty((1, cols), dtype=torch.int32, device=dev)
        runs = {}
        for x00 in ROUTE_X00:
            xn = x.clone()
            xn[0, 0] = x00
            want = caps.cap_dyn_loop_plain(xn)
            for all_rows in (1, 0):
                fn = (lambda xn=xn, a=all_rows: lib.gdf_probe_cap_dyn_loop(
                    xn.data_ptr(), out.data_ptr(), cols, a, stream))
                check(fn, out, want, f"P-14 cols={cols}")
                runs[f"n{caps.loop_trips(x00)}_all_rows{all_rows}"] = fn
        print(_line(f"routes cols={cols}", _timed(runs, args.reps,
                                                 args.rounds), card),
              flush=True)

    x = torch.ones((caps.LOOP_ROWS, 128), dtype=torch.int32, device=dev)
    out = torch.empty((1, 128), dtype=torch.int32, device=dev)
    runs = {}
    for x00 in (0, 7):
        xn = x.clone()
        xn[0, 0] = x00
        want = caps.cap_dyn_loop_plain(xn)
        n = caps.loop_trips(x00)
        for name, fn in (
                ("mask", lambda xn=xn: lib.gdf_probe_cap_dyn_loop(
                    xn.data_ptr(), out.data_ptr(), 128, 1, stream)),
                ("branch", lambda xn=xn: designs.design_dyn_loop_branch(
                    xn.data_ptr(), out.data_ptr(), 128, stream))):
            check(fn, out, want, f"P-14 {name}")
            runs[f"n{n}_{name}"] = fn
    print(_line("mask cols=128", _timed(runs, args.reps, args.rounds), card),
          flush=True)
    print("mask SASS: " + sass_order(str(_lib.library_path()),
                                     "cap_dyn_loopILb1ELb1E"), flush=True)
    print("branch SASS: " + sass_order(so, "cap_dyn_loop_branchILb1E"),
          flush=True)

    rng = np.random.default_rng(0)
    fill = gather.FILL_BITS[torch.float32]
    for rows in LANE_ROWS:
        xt = torch.as_tensor(rng.standard_normal((rows, gather.LANES))
                             .astype(np.float32), device=dev)
        it = torch.as_tensor(rng.integers(-140, 140, (rows, gather.LANES))
                             .astype(np.int32), device=dev)
        want = gather.lane_gather_plain(xt, it)
        outs = {k: torch.empty_like(xt) for k in ("register", "prefetch")}
        runs = {"built": lambda: gather.lane_gather(xt, it)}
        if not turns._equal(runs["built"](), want):
            raise RuntimeError("lane gather: differs from the plain version")
        for variant, name in enumerate(outs):
            fn = (lambda v=variant, o=outs[name]: designs.design_lane(
                v, xt.data_ptr(), it.data_ptr(), o.data_ptr(), rows, fill,
                stream))
            check(fn, outs[name], want, f"lane {name}")
            runs[name] = fn
        print(_line(f"lane rows={rows}", _timed(runs, args.reps,
                                               args.rounds), card)
              + f" bound_ms={3 * xt.numel() * 4 / turns.HBM_BYTES_PER_MS:.6f}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
