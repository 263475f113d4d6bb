#!/usr/bin/env python3
"""Smoke test of libgdf_tpu_torch on one NVIDIA Hopper GPU.

Run from the root of a checkout, on a machine with the card and nvcc:

    python3 chip_smoke.py

1. Requires CUDA and prints the card's name and power limit.
2. Builds the kernels from libgdf_tpu_torch/csrc with nvcc (sm_90a).
3. Holds each kernel (H1 compact, H2 scan, H3 seg_scan, H4 expand_fill) to
   its plain PyTorch version on CUDA tensors, at the main path's sizes and
   at ragged and edge sizes, and times the kernel, its plain version and,
   where one PyTorch call computes the same function, that call, with CUDA
   events, the kernel's own device time per call from torch.profiler (and
   that of the library call, beside H1's and H2's), the kernel launches of
   this package per call (exactly one each) and the wrapper's host time to
   enqueue a call.
   H2 is also timed at int64 and float64 over 10M elements (its instances
   that replace the TPU's K4a and K5a), and H3 at 10M for an int64 sum
   (K4b), a float64 sum (K5b) and an int64 max over encodings (K6). A
   float sum reads a denormal input as zero, folded into the kernel's
   load: H2's and H3's float32 and float64 sums equal their plain versions
   (flush, then scan) exactly on denormals and multiples of finfo.tiny at
   the edge sizes. H6's build and probe (`hash_build`, `hash_probe`) are
   held to their plain versions and timed at the shapes of Q18's lineitem
   join (60M int32 probe keys, 100 build keys: a table in shared memory)
   and of Q3's (32M against 1.46M: a table in global memory). H7
   (`wide_groupby`) is held to its plain version at its tile and chunk
   edges and at the shape of Q18's subquery (60M adjacent lines of 15M
   orders, ~6.0e7 slots), bit-identical over repeats there, and timed
   there and at two shapes no cell runs (those lines shuffled; 60M rows
   into 2^10 random slots) against the sort path, which it must not be
   slower than. H8 (`elementwise_binary`, `elementwise_compare`) is held
   bit for bit to its plain version at each operation Q6's and Q1's plans
   send through it, at SF 10's 59,986,052 rows, and timed there beside
   its plain version and the library's op alone; `--h8-first-calls` times
   the first and second call of each such operation of the four cells in
   a fresh process. The
   look-backs of H1, H2 and H3 are checked for races: H2's 10M ones scan
   to exactly 1..n (int32 and int64, forward and reverse); H3's 10M ones
   with no flag sum to exactly 1..n and with a flag every 100,003 rows to
   the restarting ramp (int32 and int64), and all-flags `carry` returns its
   input; H1 keeps all of a 10M arange payload, every other row, or none
   with the exact count; and 50 repeats of one int64 sum, one int64
   segmented sum and one compaction are bit-identical. Each kernel's bound
   is the bytes it must move (inputs read once, outputs written once) over
   the H100's 3.35 TB/s.
   Then it checks the repaired faults C3-C8 (ROADMAP queue C) on the card:
   the faults' examples give the JAX package's answers (a float32
   denormal compares equal to 0, a denormal divisor gives NaN, float32
   -1e-40 // float64 3.0 is 0, the identity hash of a float saturates,
   a float64 running min propagates NaN; a denormal is zero in add / mul,
   in a float32 -> float64 widening, in the sum / product reductions,
   prefix sums, groupby sum / avg, the window sum family and the exact
   quantiles; a bitwise op on floats raises TypeError), and 26 cases over
   1M rows equal the port's CPU run exactly: comparisons, div, floordiv,
   add, sub and mul of denormals against each float dtype and int64, both
   ways round; the identity hash of floats with inf, NaN and values past
   2^32; groupby and window min / max of denormals (ROW running, ROW over
   10,000 rows, RANGE); the sums of denormals (reductions, prefix sums,
   groupby sum / count / avg, the window sum family in the three frames,
   quantiles); the window stddev (exactly numpy's sqrt of the CPU run's
   var, and the CPU run's own within 1 ulp of it: torch's CPU float64
   sqrt is not always correctly rounded); and the float64 running min with
   its first NaN just before and after H3's tile edges.
4. Drives the main path at full size: a 10M-row fact table against a
   1M-row dimension, filter -> inner join -> groupby -> order_by, then a
   10M x 1M inner join whose build side repeats each key 4 times.
5. Drives the analytic path at full size on a 10M-row table W (50
   partitions, a permuted order key, a float32 value with 10% NULLs, an
   int64 and a float64 column): five window functions (ROW min and sum over
   10,000 rows, a running avg, a RANGE sum and a partitioned RANGE max over
   a quarter of the order range), prefix sums of the int64 and float64
   columns, five reductions and six quantiles of the value. It then
   profiles the ROW sum and the RANGE max windows.
6. Drives the ABI path at full size, calling only names of
   libgdf_tpu_torch.compat.gdf (and CSVReadArg): rmmInitialize with its
   log; read_csv of a 1M-row, 4-column file written from the seed (int64,
   int32, float64 and a `str` column, ~3% empty fields), printing the
   scanner that ran; on 10M-row columns built with gdf_column_view from
   numpy: typed and generic binary ops (an integer floor-division with
   zeros in the divisor), a float -> int32 cast over NaN and +-inf, sqrt,
   the six datetime fields of a TIMESTAMP(ms) column, gdf_validity_and;
   gpu_comparison_static_i64 -> gpu_apply_stencil, gdf_filter; inner and
   left join 10M x 1M and the inner join against a build side repeating
   each key 4 times; gdf_group_by_sum over an int64 and a float64 value,
   _max over int64, _avg, _count (1M groups); gdf_order_by; plan-based
   gdf_radixsort_i32 ascending, descending and over bits [8, 24), and
   gdf_segmented_radixsort_i64 over 10,000 segments (a freed plan must
   raise); gdf_prefixsum_i64, three reductions, gdf_quantile_exact,
   gdf_hash, gpu_hash_columns, gdf_hash_partition into 64 partitions, a
   ROW-sum gdf_window_function over 1,000 rows; gdf_to_csr over 4 float32
   columns of 2.5M rows; rmmAlloc / rmmRealloc / rmmFree / rmmGetInfo,
   whose log must hold one line per event and the card's total memory.
   Every step sits in a gdf_nvtx_range_push / pop pair, and a pushed range
   must show by name in a torch.profiler trace.
   For each path the kernels' launch counts are reset just before its run
   and read just after it; every kernel of the path must have launched (on
   the analytic path: H2 at int64 and float64, H3 at int32; on the ABI
   path: H1, H2 at int32 and int64, H3 at int64 and float64, H4). Each
   operator is timed on the host clock ending in a device sync, and each
   result is held to the same code run on CPU tensors.
7. Drives the distributed path at P = 8 in-process shards on the one card
   (libgdf_tpu_torch.parallel, one thread and one CUDA stream per shard),
   at the shape of benchmarks/dist_bench.py: a 10M-row fact table
   (Zipf(1.3) keys mod 100,000 as int64, a standard-normal float32 value)
   and a dimension of the 100,000 keys with a float32 weight, distributed
   over the mesh;
   detect_skew over 8 bins; then, each with num_batches=2 and sum + count
   aggregates, three variants of map_shards filter (v > -1) -> join ->
   dist_groupby on k: plain (dist_join with the slot capacity of
   exact_slot_capacity and out_capacity_per_shard = 4 x rows per shard),
   salted (plan_salted_join with threshold 3, dist_join_salted) and
   broadcast (broadcast_join). Each variant is planned in a first pass
   (the groupby's slot from exact_groupby_slot_capacity on the join's
   output) and timed in a second. It prints rows/s per variant (and on
   one shard over the same rows), skew_max_over_mean, groups out, the slot
   capacities, the host time in the communicator's calls as a share of
   the variant, peak device memory, the launches, and the device's busy
   share of the path from a torch.profiler trace; compact, seg_scan and
   H6 must launch. Each variant,
   collected and sorted by key, is held to the single-table filter_table ->
   join -> groupby on the card; and the same distributed pipeline at 1M
   rows runs on the card and on 8 CPU shards, held shard by shard.
   It prints torch.cuda.device_count(), then times the path again with
   every shard on one stream (the caller's) beside a stream per shard, in
   turns (one, per shard, per shard, one), and profiles each: the device
   busy share as the sum of device activity over the wall time and as the
   union of its intervals (they differ where streams overlap). Race
   checks: the plain variant 20 times on the same rows with each value
   rounded to a multiple of 1/4 (every sum of those is exact in any
   order), whose keys, counts and sums must equal the single-table
   pipeline's bit for bit in every run; the plain variant 5 times on the
   normal values, keys and counts bit-identical (how many runs also give
   bit-identical float32 sums is printed: the look-backs add tiles in an
   order that follows timing); and the race checks of H1, H2 and H3 of
   step 3 once more while 8 threads, each on a stream of its own, keep
   launching H1-H3 and checking their results. On a node of C >= 2 cards
   it runs the path on make_mesh(C), one shard per card, checks that
   shard s lies on cuda:s and holds every variant to the single-table
   pipeline; on one card it prints that this phase did not run.
   Then the same path across processes (libgdf_tpu_torch.parallel under a
   torch.distributed group, cpu:gloo,cuda:nccl): W worker processes of
   this file (--procs-worker), L shards each, make_mesh(W * L), shard s
   on cuda:(s % C); each builds the tables on the CPU from the seed and
   keeps its slabs (distribute_global), plans and runs the three
   variants once, then times each between barriers on rank 0's clock
   with the launch counts reset just before. Layouts: W = 1, L = 8 on one
   card (a one-rank group, so every collective goes through NCCL); on a
   node of C >= 2 cards also W = C, L = 1, and of C >= 4 cards W = 2,
   L = C / 2 (the layouts a node lacks print that they did not run).
   Rank 0 gathers every shard's groups; every variant is held to the
   single-table pipeline, and at W = 1, L = 8 shard by shard to the
   in-process P = 8 run (keys, per-shard counts exact, sums within the
   bound). It prints rows/s, each process's exchange share, peak device
   memory and launches; compact, seg_scan and H6 (hash_build, hash_probe:
   the local joins) must launch in every
   process. A worker that fails or outlives 600 s fails the smoke, and
   the others are killed.
8. Drives the probe path: the Hopper counterparts of the 14 Pallas cost
   probes under benchmarks/ (libgdf_tpu_torch.probes, P-1 .. P-14), each
   at its probe's shapes and the gathers and the one-hot compaction also at
   the main path's scale (81,920 x 128 indices, 10.5M elements), and the
   bulk copy also at 1000 steps (5,003 rows written) and the dynamic
   loop at (8, 2^20) ones, with the
   launch counts reset just before and read just after; every P-n must
   launch. Each output is held to its plain version on the card, exactly,
   and to its probe's own check (every 64K block sorted and key[payload]
   the sorted keys; np.roll step by step; the gathers against numpy at
   both shapes; p3's kept rows; p6's 4096). Each kernel is timed with CUDA
   events and torch.profiler (one launch a call each), beside
   its plain version and, where one PyTorch call computes the same function,
   that call; its bound is the larger of its bytes over 3.35 TB/s and its
   operations over the card's rate for their type. It prints P-1's verdict
   (the probe's full-sort estimate against the library's two-operand sort)
   and the dynamic / static roll ratio (of device times, and of event
   times, which at these kernels' ~0.02 ms also time the host's launches);
   then the rolls' chain floor (one
   warp's dependent SHFL + IADD steps on clock64 and the global timer,
   times the 1024 repetitions) and an empty launch's device and event
   time, from a small source it builds into build/exp/; and it fails
   unless `cuobjdump -sass` of the built library shows 4 SHFL in each roll
   kernel's loop for each rotation of a pass (one rotation a repetition,
   nothing folded).
9. Prints a JSON line of the operators, one of the kernels (H1-H4 and
   P-1 .. P-14), the card line, and last {"ok": true, "device": {...}}.

Tolerances: integers, counts, validity, quantiles, window minima and
maxima and row order exact; kernel float32 sums within 2e-4 and float64
sums within 1e-12 of the running sum of |x| (the kernel adds in another
order than the plain version); groupby float32 sums and averages rtol=1e-4,
atol=1e-4; window sums and averages within 2e-12 of the running sum of |v|
in the window's sort order (their float64 prefix sums run over the whole
sorted column); the float64 prefix sum within 1e-12 of the running sum of
|x|; float32 reductions within 1e-5 of the sum of |v|, relative. Any failed
check raises, so the exit code is non-zero and the last line is not
printed. On the ABI path: integers, counts, validity, row order, casts,
datetime fields, hashes, sort outputs, CSR arrays and CSV columns exact;
float32 products exact; sqrt rtol 1e-12; float64 group sums within 1e-12 of
the group's sum of |x| (averages: of that over the group's count); the
float64 reduction within 1e-12 of the sum of |x|; the window sums within
2e-12 of the column's sum of |v|. On the distributed path: keys, counts,
per-shard counts, capacities and row order exact; a group's float32 sum
within 2e-4 of the group's sum of |v|, plus 1e-4 (the shards add their
partial sums in another order than one table does).
"""
import contextlib
import ctypes
import hashlib
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
from unittest import mock

import numpy as np
import torch

from libgdf_tpu_torch import Column, GDFError, Table, TimeUnit, ops
from libgdf_tpu_torch import parallel as par
from libgdf_tpu_torch.compat import gdf
from libgdf_tpu_torch.io import CSVReadArg
from libgdf_tpu_torch import probes
from libgdf_tpu_torch.ops import kernels
from libgdf_tpu_torch.ops.kernels import _lib
from libgdf_tpu_torch.ops.sort import radix_encode
from libgdf_tpu_torch.parallel import procs as procs_mod
from libgdf_tpu_torch.parallel.mesh import Mesh
from libgdf_tpu_torch.probes import _common, caps, gather, roll, tilesort
from libgdf_tpu_torch.utils import tracing

SOURCES = {
    "compact": ("libgdf_tpu_torch/csrc/compact.cu",
                "libgdf_tpu/ops/pallas/compact.py:371; "
                "libgdf_tpu/ops/pallas/compact2.py:177"),
    "scan": ("libgdf_tpu_torch/csrc/scan.cu",
             "libgdf_tpu/ops/pallas/scan.py:754; scan.py:664; scan.py:428"),
    "seg_scan": ("libgdf_tpu_torch/csrc/scan.cu",
                 "libgdf_tpu/ops/pallas/scan.py:783; scan.py:692; "
                 "scan.py:456; scan.py:610"),
    "expand_fill": ("libgdf_tpu_torch/csrc/expand.cu",
                    "libgdf_tpu/ops/pallas/expand.py:210"),
    "domain_probe": ("libgdf_tpu_torch/csrc/dense_groupby.cu",
                     "none: H5's probe of the live key domain"),
    "dense_groupby": ("libgdf_tpu_torch/csrc/dense_groupby.cu",
                      "none: the group-by that libgdf_tpu/ops/groupby.py "
                      "sorts for, over a small integer key domain"),
    "hash_build": ("libgdf_tpu_torch/csrc/hash_join.cu",
                   "none: the table of H6, the inner join on one key that "
                   "libgdf_tpu/ops/join.py sorts for, of a unique build side"),
    "hash_probe": ("libgdf_tpu_torch/csrc/hash_join.cu",
                   "none: the probe of H6 (as hash_build)"),
    "wide_groupby": ("libgdf_tpu_torch/csrc/dense_groupby.cu",
                     "none: the group-by that libgdf_tpu/ops/groupby.py "
                     "sorts for, over a wide integer key domain"),
    "elementwise_binary": ("libgdf_tpu_torch/csrc/elementwise.cu",
                           "none: add / sub / mul of float columns, which "
                           "XLA fuses, with the denormal flush in the load"),
    "elementwise_compare": ("libgdf_tpu_torch/csrc/elementwise.cu",
                            "none: a column against a scalar into the int8 "
                            "stencil, with the denormal flush in the load"),
}
# the kernels the main path must launch (its group-by takes the sort path;
# its join on a unique build side the hash path, the one on repeated keys
# the sort path's general path)
MAIN_KERNELS = ("compact", "scan", "seg_scan", "expand_fill", "hash_build",
                "hash_probe")
REL = {torch.float32: 2e-4, torch.float64: 1e-12}
# the edges of H2's and H3's 32 KB tiles (8192 4-byte or 4096 8-byte
# elements), H1's 4096-row tiles and H4's 4096-slot runs, and many tiles
# plus one
EDGE_SIZES = (1, 2047, 2048, 2049, 4095, 4096, 4097, 8191, 8192, 8193,
              37 * 4096 + 1, 37 * 8192 + 1, 100_003)
N_FACT, N_DIM, MULT = 10_000_000, 1_000_000, 4
AGGS = [("v", "sum", "s"), ("v", "count", "c"), ("v", "avg", "a"),
        ("w", "max", "hi")]
GB_TOL = {"s": (1e-4, 1e-4), "a": (1e-4, 1e-4)}
HBM_BYTES_PER_MS = 3.35e12 / 1e3      # H100 SXM data sheet, at 700 W
N_W, W_PARTS = 10_000_000, 50
QMETHODS = ("linear", "lower", "higher", "midpoint", "nearest")
# (operator, value, reduction, preceding, partition_by, frame)
WINDOWS = (("window_min_rows", "min", 10_000, ("p",), "rows"),
           ("window_sum_rows", "sum", 10_000, ("p",), "rows"),
           ("window_avg_running", "avg", None, ("p",), "rows"),
           ("window_sum_range", "sum", N_W // 4, (), "range"),
           ("window_max_range", "max", N_W // 4, ("p",), "range"))
ANALYTIC_KERNELS = ("scan[int64]", "scan[float64]", "seg_scan[int32]")
# (the ABI's sums, average and count over 1M keys take the wide path, its
# max the sort path)
ABI_KERNELS = ("compact", "scan[int32]", "scan[int64]", "seg_scan[int64]",
               "wide_groupby", "expand_fill")
N_CSV, N_CSR, N_SEGMENTS, N_PARTS = 1_000_000, 2_500_000, 10_000, 64
N_DIST, N_DIST_CPU, DIST_P, DIST_KEYS = 10_000_000, 1_000_000, 8, 100_000
DIST_AGGS = [("v", "sum", "s"), ("v", "count", "c")]
DIST_BATCHES = 2
DIST_REPEATS = 20          # runs of the plain variant in the race check
DIST_KERNELS = ("compact", "seg_scan", "hash_build", "hash_probe",
                "wide_groupby")
# __global__ functions of libgdf_tpu_torch/csrc/*.cu, by wrapper
# (H2 and H3 are instances of one template)
KERNEL_NAMES = {"compact": ("compact_lookback",),
                "scan": ("scan_lookback",),
                "seg_scan": ("scan_lookback",),
                "expand_fill": ("expand_fill_runs",),
                "domain_probe": ("domain_probe",),
                "dense_groupby": ("dense_groupby",),
                "hash_build": ("hash_build",),
                "hash_probe": ("hash_probe",),
                "wide_groupby": ("wide_init", "wide_add", "wide_extract"),
                "elementwise_binary": ("elementwise_binary",),
                "elementwise_compare": ("elementwise_compare",),
                "tile_sort": ("tile_sort_cluster",),
                "lane_gather": ("lane_gather_rows",),
                "sublane_gather": ("sublane_gather_persistent",),
                "flat_take": ("flat_take_resident",),
                "roll_static": ("roll_static_rows",),
                "roll_dynamic": ("roll_dynamic_rows",),
                **{name: (name,) for name in caps.CAPS}}
OWN_KERNELS = tuple(k for names in KERNEL_NAMES.values() for k in names)
_PG = "benchmarks/probe_pallas_gather.py"
_PC = "benchmarks/probe_pallas_caps.py"
# P-n -> (wrapper, source, the Pallas site it replaces)
PROBE_SOURCES = {
    "P-1": ("tile_sort", "libgdf_tpu_torch/csrc/probe_tilesort.cu",
            "benchmarks/probe_tilesort.py:91"),
    "P-2": ("lane_gather", "libgdf_tpu_torch/csrc/probe_gather.cu",
            f"{_PG}:63"),
    "P-3": ("sublane_gather", "libgdf_tpu_torch/csrc/probe_gather.cu",
            f"{_PG}:87"),
    "P-4": ("flat_take", "libgdf_tpu_torch/csrc/probe_gather.cu",
            f"{_PG}:111"),
    "P-5": ("flat_take", "libgdf_tpu_torch/csrc/probe_gather.cu",
            f"{_PG}:142"),
    "P-6": ("roll_static", "libgdf_tpu_torch/csrc/probe_roll.cu",
            "benchmarks/probe_roll.py:38"),
    "P-7": ("roll_dynamic", "libgdf_tpu_torch/csrc/probe_roll.cu",
            "benchmarks/probe_roll.py:46"),
    "P-8": ("cap_dyn_store", "libgdf_tpu_torch/csrc/probe_caps.cu",
            f"{_PC}:40"),
    "P-9": ("cap_cumsum2d", "libgdf_tpu_torch/csrc/probe_caps.cu",
            f"{_PC}:54"),
    "P-10": ("cap_onehot_compact", "libgdf_tpu_torch/csrc/probe_caps.cu",
             f"{_PC}:89"),
    "P-11": ("cap_bulk_copy", "libgdf_tpu_torch/csrc/probe_caps.cu",
             f"{_PC}:114"),
    "P-12": ("lane_gather", "libgdf_tpu_torch/csrc/probe_gather.cu",
             f"{_PC}:138"),
    "P-13": ("cap_carry", "libgdf_tpu_torch/csrc/probe_caps.cu",
             f"{_PC}:157"),
    "P-14": ("cap_dyn_loop", "libgdf_tpu_torch/csrc/probe_caps.cu",
             f"{_PC}:176"),
}
# the capability probe behind each P-n of probe_pallas_caps.py
CAP_PROBES = {"P-8": "p1", "P-9": "p2", "P-10": "p3", "P-11": "p4",
              "P-12": "p5", "P-13": "p6", "P-14": "p7"}
GATHER_SCALE_ROWS = 81_920      # 10.5M indices: the gathers after a sort
COMPACT_SCALE_TILES = 40_960    # 10.5M elements of one-hot compaction
BULK_SCALE_STEPS = 1000         # P-11 at 2.56 MB read and written
LOOP_SCALE_COLS = 1 << 20       # P-14 at 12.6 MB read, 4.2 MB written
# H100 SXM data sheet, at 700 W: float32 outside the tensor cores (the
# rate taken for 32-bit scalar work)
SCALAR_OPS_PER_MS = 67e12 / 1e3


def fail(msg):
    raise RuntimeError(msg)


def card_lines():
    """Each card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()


def card_line():
    return card_lines()[0]


# -- comparisons ------------------------------------------------------------

def exact(got, want, what):
    """Equal shapes and values (NaN equals NaN); returns the error, 0."""
    if got.shape != want.shape or got.dtype != want.dtype:
        fail(f"{what}: {got.shape}/{got.dtype} vs {want.shape}/{want.dtype}")
    same = got == want
    if got.is_floating_point():
        same |= torch.isnan(got) & torch.isnan(want)
    if not bool(same.all()):
        bad = int((~same).sum())
        fail(f"{what}: {bad} of {got.numel()} elements differ")
    return 0.0


def exact_bits(got, want, what):
    """`exact`, and the sign of every zero as well."""
    exact(got, want, what)
    if got.is_floating_point():
        keep = ~torch.isnan(want)
        if not torch.equal(torch.signbit(got[keep]),
                           torch.signbit(want[keep])):
            fail(f"{what}: the sign of a zero differs")
    return 0.0


def running_sum_close(got, want, bound_abs, rel, what):
    """|got - want| <= rel * (running sum of |x|) + rel; returns max error."""
    diff = (got.double() - want.double()).abs()
    if not bool((diff <= rel * bound_abs + rel).all()):
        fail(f"{what}: max error {float(diff.max())} over the bound")
    return float(diff.max()) if diff.numel() else 0.0


def compare_tables(got, want, what, tol=None):
    """Live rows of two Tables: validity exact, values exact or to tol."""
    got, want = got.compact(), want.to(got.device).compact()
    if got.names != want.names or got.capacity != want.capacity:
        fail(f"{what}: {got.names}/{got.capacity} vs "
             f"{want.names}/{want.capacity}")
    err = 0.0
    for name, g, w in zip(got.names, got.columns, want.columns):
        gv, wv = g.valid_or_true(), w.valid_or_true()
        exact(gv, wv, f"{what}.{name} validity")
        gd = torch.where(gv, g.data, torch.zeros_like(g.data))
        wd = torch.where(wv, w.data, torch.zeros_like(w.data))
        if tol and name in tol:
            rtol, atol = tol[name]
            diff = (gd.double() - wd.double()).abs()
            if not bool((diff <= atol + rtol * wd.double().abs()).all()):
                fail(f"{what}.{name}: max error {float(diff.max())}")
            err = max(err, float(diff.max()) if diff.numel() else 0.0)
        else:
            exact(gd, wd, f"{what}.{name}")
    return err


def bound_ms(nbytes):
    """Least time for the card to move nbytes at its memory rate."""
    return nbytes / HBM_BYTES_PER_MS


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def _device_us(event):
    us = getattr(event, "self_device_time_total", None)
    return float(event.self_cuda_time_total if us is None else us)


def profiled(fn, names, reps=5, expect=None):
    """(device milliseconds, launches) per call of fn() in the kernels
    whose names contain one of `names`, and {activity: count per call} of
    every device activity (kernels and memsets), from torch.profiler over
    reps calls after a warm-up; (None, None, {}) if three profiles in a row
    saw no such kernel (a profile now and then comes back without device
    events, or, for a burst of launches, without some of them: given
    `expect` launches per call, a profile that saw another count is taken
    again, and the last one returned if none saw it)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    seen = None, None, {}
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(0.01)
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            time.sleep(0.01)
        dev = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
        mine = [e for e in dev if any(n in e.key for n in names)]
        us = sum(_device_us(e) for e in mine)
        if us:
            seen = (us / reps / 1e3, sum(e.count for e in mine) / reps,
                    {e.key[:60]: e.count / reps for e in dev})
            if expect is None or seen[1] == expect:
                return seen
    return seen


def profiled_ms(fn, names, reps=5):
    """Device milliseconds per call of fn() in the kernels named."""
    return profiled(fn, names, reps)[0]


def one_launch_ms(fn, name):
    """profiled() of one wrapper: fails unless each call launched exactly
    one kernel of this package. Returns (device ms, activities per call)."""
    ms, launches, acts = profiled(fn, KERNEL_NAMES[name])
    if launches is not None and launches != 1:
        fail(f"{name}: {launches} kernel launches per call ({acts})")
    return ms, acts


def host_ms(fn, reps=20):
    """Mean host milliseconds to enqueue fn() (no sync inside the loop),
    after a warm-up. Where it exceeds the kernel's device time, a CUDA-event
    time of back-to-back calls measures the host, not the kernel."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    return ms


def cuda_ms(fn, reps=5):
    """Mean device milliseconds of fn() over reps runs, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


# -- kernel phases ----------------------------------------------------------

def _values(rng, n, dtype, dev):
    x = rng.standard_normal(n) if dtype.is_floating_point else \
        rng.integers(-1000, 1000, n)
    return torch.as_tensor(x, device=dev).to(dtype)


def _flush_values(rng, n, dtype, dev):
    """Zeros, +-denormals and +-1, 2 times finfo.tiny: once the denormals
    are flushed, every partial sum is an exact multiple of finfo.tiny, in
    any order of addition."""
    d = 1e-40 if dtype == torch.float32 else 1e-310
    t = torch.finfo(dtype).tiny
    return torch.as_tensor(rng.choice(np.array(
        [0.0, -0.0, d, -d, 2 * d, t, -t, 2 * t, -2 * t]), n),
        device=dev).to(dtype)


def compact_inputs(rng, dev):
    """H1's main-path shape: 10M rows of int64, bool, float32 and bool,
    45% kept."""
    n = N_FACT
    keep = torch.as_tensor(rng.random(n) < 0.45, device=dev)
    arrays = [torch.as_tensor(rng.integers(0, N_DIM, n), device=dev),
              torch.as_tensor(rng.random(n) < 0.95, device=dev),
              torch.as_tensor(rng.standard_normal(n).astype(np.float32),
                              device=dev),
              torch.as_tensor(rng.random(n) < 0.9, device=dev)]
    return arrays, keep


def phase_compact(rng, dev):
    arrays, keep = compact_inputs(rng, dev)
    cases = [("main", arrays, keep)]
    for m in EDGE_SIZES:
        for p in (0.0, 0.3, 1.0):
            edge = [torch.as_tensor(rng.integers(-2**62, 2**62, m),
                                    device=dev),
                    torch.as_tensor(rng.standard_normal(m), device=dev),
                    torch.as_tensor(rng.integers(-99, 99, m)
                                    .astype(np.int16), device=dev),
                    torch.as_tensor(rng.integers(0, 9, m).astype(np.int32),
                                    device=dev),
                    torch.as_tensor(rng.random(m) < 0.5, device=dev)]
            cases.append((f"n={m},p={p}", edge,
                          torch.as_tensor(rng.random(m) < p, device=dev)))
    wide = [torch.as_tensor(rng.integers(0, 1 << 30, 50_000)
                            .astype(np.int32), device=dev)
            for _ in range(20)]
    cases.append(("20 arrays", wide,
                  torch.as_tensor(rng.random(50_000) < 0.4, device=dev)))
    for name, arrs, kp in cases:
        got, cnt = kernels.compact(arrs, kp)
        want, wcnt = kernels.compact_plain(arrs, kp)
        c = int(wcnt)
        if int(cnt) != c:
            fail(f"compact {name}: count {int(cnt)} vs {c}")
        for i, (g, w) in enumerate(zip(got, want)):
            exact(g[:c], w[:c], f"compact {name} array {i}")
    check_compact_look_back(arrays, keep, dev)
    ms = cuda_ms(lambda: kernels.compact(arrays, keep))
    dev_ms, acts = one_launch_ms(lambda: kernels.compact(arrays, keep),
                                 "compact")
    print(f"compact: device activities per call {acts}", flush=True)
    host = host_ms(lambda: kernels.compact(arrays, keep))
    plain = cuda_ms(lambda: kernels.compact_plain(arrays, keep))
    library = cuda_ms(lambda: [a[keep] for a in arrays])
    # every kernel of the library call (the mask's nonzero, the gathers)
    library_dev = profiled_ms(lambda: [a[keep] for a in arrays], ("",))
    kept = int(keep.sum())
    moved = nbytes(keep, *arrays) + kept * sum(a.element_size()
                                               for a in arrays)
    return dict(max_abs_err=0.0, ms=ms, profiler_ms=dev_ms, host_ms=host,
                plain_ms=plain, library_ms=library,
                library_profiler_ms=library_dev, bound_ms=bound_ms(moved),
                bound_by="bytes",
                shape="10M rows, int64+bool+float32+bool, 45% kept; "
                      "library: a[keep] per array")


def check_compact_look_back(arrays, keep, dev):
    """H1's look-back against races: over 10M rows all kept gives an arange
    payload and count n, every other row arange[::2], none kept count 0;
    50 compactions of the main shape are bit-identical to the first."""
    idx = torch.arange(N_FACT, dtype=torch.int64, device=dev)
    for what, kp, want in (("all", idx >= 0, idx),
                           ("every other", idx % 2 == 0, idx[::2]),
                           ("none", idx < 0, idx[:0])):
        (got,), cnt = kernels.compact([idx], kp)
        if int(cnt) != want.shape[0]:
            fail(f"compact {what}: count {int(cnt)} vs {want.shape[0]}")
        exact(got[:want.shape[0]], want, f"compact {what}")
    first, cnt = kernels.compact(arrays, keep)
    c = int(cnt)
    for i in range(50):
        again, cnt = kernels.compact(arrays, keep)
        if int(cnt) != c:
            fail(f"compact repeat {i}: count {int(cnt)} vs {c}")
        for j, (g, w) in enumerate(zip(again, first)):
            exact(g[:c], w[:c], f"compact repeat {i} array {j}")
    print("compact look-back: all / every other / none exact, 50 "
          "compactions bit-identical", flush=True)


def phase_scan(rng, dev):
    err = 0.0
    n = N_FACT + N_DIM
    for dtype in (torch.int32, torch.int64, torch.float32, torch.float64):
        for m in (n,) + EDGE_SIZES:
            x = _values(rng, m, dtype, dev)
            for kind in ("sum", "max", "min"):
                for reverse in (False, True):
                    got = kernels.scan(kind, x, reverse=reverse)
                    want = kernels.scan_plain(kind, x, reverse=reverse)
                    what = f"scan {kind} {dtype} n={m} reverse={reverse}"
                    if kind == "sum" and dtype.is_floating_point:
                        xs = x.flip(0) if reverse else x
                        bound = torch.cumsum(xs.abs().double(), 0)
                        if reverse:
                            bound = bound.flip(0)
                        err = max(err, running_sum_close(
                            got, want, bound, REL[dtype], what))
                    else:
                        exact(got, want, what)
    check_look_back(rng, dev)
    for dtype in (torch.float32, torch.float64):
        for m in (n,) + EDGE_SIZES:
            x = _flush_values(rng, m, dtype, dev)
            for reverse in (False, True):
                exact(kernels.scan("sum", x, reverse),
                      kernels.scan_plain("sum", x, reverse),
                      f"scan sum {dtype} n={m} reverse={reverse} flush")
    print("scan flush: float32 / float64 sums of denormals and multiples of "
          "finfo.tiny exact, forward and reverse", flush=True)
    timed = {}
    for dtype, m in ((torch.int32, n), (torch.int64, N_W),
                     (torch.float64, N_W)):
        x = _values(rng, m, dtype, dev)
        timed[str(dtype).removeprefix("torch.")] = dict(
            ms=cuda_ms(lambda: kernels.scan("sum", x)),
            profiler_ms=one_launch_ms(lambda: kernels.scan("sum", x),
                                      "scan")[0],
            host_ms=host_ms(lambda: kernels.scan("sum", x)),
            plain_ms=cuda_ms(lambda: kernels.scan_plain("sum", x)),
            library_ms=cuda_ms(lambda: torch.cumsum(x, 0, dtype=x.dtype)),
            # every kernel of one torch.cumsum call (CUB's init and scan)
            library_profiler_ms=profiled_ms(
                lambda: torch.cumsum(x, 0, dtype=x.dtype), ("",)),
            bound_ms=bound_ms(2 * nbytes(x)), bound_by="bytes",
            shape=f"{m} {dtype} inclusive sum")
    for dt in ("int32", "int64", "float64"):
        print(f"kernel scan[{dt}]: " + " ".join(
            f"{k}={v}" for k, v in timed[dt].items()), flush=True)
    return dict(max_abs_err=err, by_dtype={k: timed[k] for k in
                                           ("int64", "float64")},
                **timed["int32"])


def check_look_back(rng, dev):
    """H2's look-back against races: 10M ones scan to exactly 1..n, forward
    and reverse, at int32 and int64; 50 int64 sums of one input are
    bit-identical to the first and to the plain version."""
    for dtype in (torch.int32, torch.int64):
        ones = torch.ones(N_W, dtype=dtype, device=dev)
        want = torch.arange(1, N_W + 1, dtype=dtype, device=dev)
        exact(kernels.scan("sum", ones), want, f"scan of ones {dtype}")
        exact(kernels.scan("sum", ones, reverse=True), want.flip(0),
              f"reverse scan of ones {dtype}")
    x = _values(rng, N_W, torch.int64, dev) * 123_457
    first = kernels.scan("sum", x)
    exact(first, kernels.scan_plain("sum", x), "int64 sum")
    for i in range(50):
        exact(kernels.scan("sum", x), first, f"int64 sum, repeat {i}")
    print("scan look-back: ones exact, 50 int64 sums bit-identical",
          flush=True)


def phase_seg_scan(rng, dev):
    err = 0.0
    n = N_FACT + N_DIM
    for dtype in (torch.int32, torch.int64, torch.float32, torch.float64):
        for m, density in [(n, 0.25), (n, 0.0)] + \
                [(e, d) for e in EDGE_SIZES for d in (0.0, 0.03, 1.0)]:
            x = _values(rng, m, dtype, dev)
            f = torch.as_tensor(rng.random(m) < density, device=dev)
            for kind in ("sum", "max", "min", "carry"):
                got = kernels.seg_scan(kind, f, x)
                want = kernels.seg_scan_plain(kind, f, x)
                what = f"seg_scan {kind} {dtype} n={m} density={density}"
                if kind == "sum" and dtype.is_floating_point:
                    bound = kernels.seg_scan_plain("sum", f,
                                                   x.abs().double())
                    err = max(err, running_sum_close(
                        got, want, bound, REL[dtype], what))
                else:
                    exact(got, want, what)
    check_seg_look_back(rng, dev)
    for dtype in (torch.float32, torch.float64):
        for m, density in [(n, 0.25), (n, 0.0)] + \
                [(e, d) for e in EDGE_SIZES for d in (0.0, 0.03, 1.0)]:
            x = _flush_values(rng, m, dtype, dev)
            f = torch.as_tensor(rng.random(m) < density, device=dev)
            exact(kernels.seg_scan("sum", f, x),
                  kernels.seg_scan_plain("sum", f, x),
                  f"seg_scan sum {dtype} n={m} density={density} flush")
    print("seg_scan flush: float32 / float64 segmented sums of denormals and "
          "multiples of finfo.tiny exact", flush=True)
    timed = {}
    for name, kind, dtype, m in (
            ("K3 float32 sum", "sum", torch.float32, n),
            ("K4b int64 sum", "sum", torch.int64, N_W),
            ("K5b float64 sum", "sum", torch.float64, N_W),
            ("K6 int64 max over encodings", "max", torch.float64, N_W)):
        x = _values(rng, m, dtype, dev)
        if name.startswith("K6"):
            x = radix_encode(x)
        f = torch.as_tensor(rng.random(m) < 0.25, device=dev)
        timed[name] = dict(
            ms=cuda_ms(lambda: kernels.seg_scan(kind, f, x)),
            profiler_ms=one_launch_ms(lambda: kernels.seg_scan(kind, f, x),
                                      "seg_scan")[0],
            host_ms=host_ms(lambda: kernels.seg_scan(kind, f, x)),
            plain_ms=cuda_ms(lambda: kernels.seg_scan_plain(kind, f, x)),
            library_ms=None, bound_ms=bound_ms(nbytes(f) + 2 * nbytes(x)),
            bound_by="bytes", shape=f"{m} {name}, groups of ~4")
    for name, t in list(timed.items())[1:]:
        print(f"kernel seg_scan[{name}]: " + " ".join(
            f"{k}={v}" for k, v in t.items()), flush=True)
    return dict(max_abs_err=err, by_instance={k: timed[k] for k in
                                              list(timed)[1:]},
                **timed["K3 float32 sum"])


def check_seg_look_back(rng, dev, profile=True):
    """H3's look-back against races: 10M ones with no flag (the longest
    look-back) sum to exactly 1..n and with a flag every 100,003 rows to
    the restarting ramp, at int32 and int64; 50 int64 segmented sums of one
    input are bit-identical to the first and to the plain version;
    all-flags `carry` returns its input. With `profile`, one call must
    launch one kernel (not while other streams launch theirs)."""
    every = 100_003
    idx = torch.arange(N_W, dtype=torch.int64, device=dev)
    none = torch.zeros(N_W, dtype=torch.bool, device=dev)
    for dtype in (torch.int32, torch.int64):
        ones = torch.ones(N_W, dtype=dtype, device=dev)
        exact(kernels.seg_scan("sum", none, ones), (idx + 1).to(dtype),
              f"seg_scan of ones {dtype}")
        exact(kernels.seg_scan("sum", idx % every == 0, ones),
              (idx % every + 1).to(dtype), f"seg_scan ramp {dtype}")
    x = _values(rng, N_W, torch.int64, dev) * 123_457
    f = torch.as_tensor(rng.random(N_W) < 0.25, device=dev)
    first = kernels.seg_scan("sum", f, x)
    exact(first, kernels.seg_scan_plain("sum", f, x), "int64 seg sum")
    for i in range(50):
        exact(kernels.seg_scan("sum", f, x), first,
              f"int64 seg sum, repeat {i}")
    for dtype in (torch.int64, torch.float32):
        v = _values(rng, N_W, dtype, dev)
        exact(kernels.seg_scan("carry", ~none, v), v,
              f"all-flags carry {dtype}")
    acts = one_launch_ms(lambda: kernels.seg_scan("sum", f, x),
                         "seg_scan")[1] if profile else "not profiled"
    print(f"seg_scan look-back: ones and ramps exact, 50 int64 segmented "
          f"sums bit-identical, all-flags carry exact; device activities "
          f"per call {acts}", flush=True)


def phase_expand(rng, dev):
    cases = []
    # the main path's shape, edges of the 4096-slot runs, sources further
    # apart than a run with the first after slot 0, and no source at all
    for cap, nsrc in [(N_FACT * MULT, N_FACT), (1, 1), (2049, 300),
                      (4095, 1000), (4096, 4096), (4097, 2000),
                      (37 * 4096 + 1, 30_000), (100_003, 90_000),
                      (1_000_000, 100), (5000, 0)]:
        pos = np.cumsum(rng.integers(1, 2 * max(cap // max(nsrc, 1), 1),
                                     nsrc)) - 1
        pos = np.concatenate([pos[pos < cap],
                              np.full(7, kernels.SENTINEL)]).astype(np.int32)
        words = [torch.as_tensor(rng.integers(-2**31, 2**31, pos.size)
                                 .astype(np.int32), device=dev)
                 for _ in range(3)]
        words.append(torch.as_tensor(rng.integers(-2**62, 2**62, pos.size),
                                     device=dev))
        cases.append((cap, torch.as_tensor(pos, device=dev), words))
    for cap, pos, words in cases:
        got = kernels.expand_fill(pos, words, cap)
        want = kernels.expand_fill_plain(pos, words, cap)
        for i, (g, w) in enumerate(zip(got, want)):
            exact(g, w, f"expand_fill cap={cap} word {i}")
    cap, pos, words = cases[0]
    words = words[:3]
    ms = cuda_ms(lambda: kernels.expand_fill(pos, words, cap))
    dev_ms = one_launch_ms(lambda: kernels.expand_fill(pos, words, cap),
                           "expand_fill")[0]
    host = host_ms(lambda: kernels.expand_fill(pos, words, cap))
    plain = cuda_ms(lambda: kernels.expand_fill_plain(pos, words, cap))
    moved = nbytes(pos, *words) + cap * sum(w.element_size() for w in words)
    return dict(max_abs_err=0.0, ms=ms, profiler_ms=dev_ms, host_ms=host,
                plain_ms=plain, library_ms=None,
                bound_ms=bound_ms(moved), bound_by="bytes",
                shape="40M slots from 10M sources, 3 int32 words")


# -- H5 dense_groupby and its domain probe ----------------------------------

# TPC-H Q1's group-by at SF 10 (clause 2.4.1): lineitem's capacity, the
# rows its filter keeps at DELTA 90, and its keys and aggregates
N_Q1, N_Q1_LIVE = 59_986_052, 58_900_000
Q1_KEYS = ("l_returnflag", "l_linestatus")
Q1_AGGS = [("l_quantity", "sum", "sum_qty"),
           ("l_extendedprice", "sum", "sum_base_price"),
           ("disc_price", "sum", "sum_disc_price"),
           ("charge", "sum", "sum_charge"),
           ("l_quantity", "avg", "avg_qty"),
           ("l_extendedprice", "avg", "avg_price"),
           ("l_discount", "avg", "avg_disc"),
           ("l_quantity", "count", "count_order")]
# H5's sums against its plain version's on the card
DENSE_REL = 1e-12
# Q1's sums and averages on the card against the CPU run, which adds a
# group's ~1.7M rows in row order (rounding up to ~n eps, 2e-10): the
# benchmark's limit on Q1's agg_rel_gap
Q1_REL = 1e-9
DENSE_REPEATS = 10         # launches held bit-identical to the first


def q1_columns(rng, n, live, dev):
    """Q1's group-by input as its plan hands it over: n rows of capacity,
    the first `live` kept; l_returnflag and l_linestatus int8 codes of 3
    and 2 values (a stale 7 past the live rows), five float64 columns."""
    g = torch.Generator(device=dev).manual_seed(int(rng.integers(2**31)))

    def codes(k):
        c = torch.randint(0, k, (n,), generator=g, device=dev,
                          dtype=torch.int8)
        c[live:] = 7
        return c

    def uniform(lo, hi):
        return lo + (hi - lo) * torch.rand(n, generator=g, device=dev,
                                           dtype=torch.float64)
    return {"l_returnflag": codes(3), "l_linestatus": codes(2),
            "l_quantity": torch.randint(1, 51, (n,), generator=g,
                                        device=dev).double(),
            "l_extendedprice": uniform(900.0, 105_000.0),
            "l_discount": uniform(0.0, 0.1),
            "disc_price": uniform(800.0, 100_000.0),
            "charge": uniform(800.0, 110_000.0)}


def dense_plan(cols, keys, aggs, num_rows, valid=None):
    """The plan of a group-by of `cols` (`valid`: {name: validity}) over
    the domain its probe reads, or None where the input needs the sort
    path."""
    return wide_plan(group_table(cols, valid, num_rows), keys, aggs)


def same_dense(got, want, plan, what, rel=0.0):
    """H5's outputs against its plain version's over the groups: the group
    count, `live`, keys, counts and validity exact; float sums and
    averages within `rel` of the plain version's (exact where 0). Returns
    the largest absolute error."""
    (go, gk, gl, gg), (wo, wk, wl, wg) = got, want
    g = int(wg)
    if int(gg) != g:
        fail(f"{what}: {int(gg)} groups vs {g}")
    exact(gl[:g].cpu(), wl[:g].cpu(), f"{what} live")
    err = 0.0
    for i, (a, b) in enumerate(zip(go, wo)):
        a, b = a[:g].cpu(), b[:g].cpu()
        if rel and a.is_floating_point() and a.dtype == b.dtype:
            diff = (a - b).abs()
            if not bool((diff <= rel * b.abs()).all()):
                fail(f"{what} output {i}: max error {float(diff.max())}")
            err = max(err, float(diff.max()) if g else 0.0)
        else:
            exact(a, b, f"{what} output {i}")
    for i, (a, b) in enumerate(zip(gk, wk)):
        if (a is None) != (b is None):
            fail(f"{what} validity {i}: one side has none")
        if a is not None:
            exact(a[:g].cpu(), b[:g].cpu(), f"{what} validity {i}")
    return err


def check_dense_edges(rng, dev):
    """The probe and H5 at the edges of their tiles: every key dtype,
    aligned and off 16 bytes, dead rows with stale keys, null keys; H5's
    generic instance over 1 to 8 slots, one and two keys, a nullable
    float32 column, int32 sums, sums of quarters (exact in any order)."""
    for i, m in enumerate(EDGE_SIZES):
        live = torch.tensor(m - m // 7, dtype=torch.int32, device=dev)
        probed = []
        for dt in (torch.int8, torch.int16, torch.int32, torch.int64):
            k = torch.as_tensor(rng.integers(-100, 100, m + 1),
                                device=dev).to(dt)
            probed.append(k[1:] if (i + len(probed)) % 2 else k[:m])
        ok = torch.as_tensor(rng.random(m) < 0.9, device=dev)
        for row_ok in (None, ok):
            exact(kernels.domain_probe(probed, row_ok, live).cpu(),
                  kernels.domain_probe_plain(probed, row_ok, live).cpu(),
                  f"domain_probe n={m} row_ok={row_ok is not None}")
        slots = i % 8 + 1
        two = slots % 2 == 0 and slots > 2
        span0 = slots // 2 if two else slots
        cols = {"k0": torch.as_tensor(rng.integers(0, span0, m) - 3,
                                      device=dev).to(torch.int16),
                "k1": torch.as_tensor(rng.integers(0, 2, m),
                                      device=dev).to(torch.int8),
                "f64": torch.as_tensor(rng.integers(-4000, 4000, m) / 4,
                                       device=dev),
                "f32": torch.as_tensor(rng.integers(-4000, 4000, m) / 4,
                                       device=dev).float(),
                "i32": torch.as_tensor(rng.integers(-9, 9, m),
                                       device=dev).to(torch.int32)}
        cols["k0"][int(live):] = 100
        aggs = [("f64", "sum", "s"), ("f64", "avg", "a"), ("f32", "sum", "t"),
                ("f32", "count", "c"), ("i32", "sum", "i"),
                ("i32", "avg", "j")]
        keys = ("k0", "k1") if two else ("k0",)
        plan = dense_plan(cols, keys, aggs, live, {"f32": ok})
        if plan is None:
            fail(f"dense_groupby n={m}: a domain of {slots} slots took the "
                 "sort path")
        same_dense(kernels.dense_groupby(plan),
                   kernels.dense_groupby_plain(plan), plan,
                   f"dense_groupby n={m} slots={plan.slots}")


def phase_dense(rng, dev):
    """The probe and H5 at Q1's shape, each held to its plain version, H5's
    repeats bit-identical, then timed. Returns the stats of both."""
    check_dense_edges(rng, dev)
    cols = q1_columns(rng, N_Q1, N_Q1_LIVE, dev)
    live = torch.tensor(N_Q1_LIVE, dtype=torch.int32, device=dev)
    keys = [cols[k] for k in Q1_KEYS]
    exact(kernels.domain_probe(keys, None, live).cpu(),
          kernels.domain_probe_plain(keys, None, live).cpu(),
          "domain_probe at Q1's shape")
    plan = dense_plan(cols, Q1_KEYS, Q1_AGGS, live)
    if plan is None or plan.slots != 6 or len(plan.accs) != 6:
        fail(f"dense_groupby: Q1's plan is not 6 slots x 6 accumulators")
    got = kernels.dense_groupby(plan)
    err = same_dense(got, kernels.dense_groupby_plain(plan), plan,
                     "dense_groupby at Q1's shape", DENSE_REL)
    for r in range(DENSE_REPEATS):
        same_dense(kernels.dense_groupby(plan), got, plan,
                   f"dense_groupby repeat {r}")
    print(f"dense_groupby: {DENSE_REPEATS} repeats at Q1's shape "
          "bit-identical", flush=True)
    key_bytes = sum(k.element_size() for k in keys)
    val_bytes = sum(a.values.element_size() for a in plan.accs
                    if a.values is not None)
    shape = (f"{N_Q1_LIVE} live rows of {N_Q1}, 2 int8 keys, 5 float64 "
             "columns")
    stats = {}
    for name, run, plain, moved in (
            ("domain_probe",
             lambda: kernels.domain_probe(keys, None, live),
             lambda: kernels.domain_probe_plain(keys, None, live),
             N_Q1_LIVE * key_bytes),
            ("dense_groupby", lambda: kernels.dense_groupby(plan),
             lambda: kernels.dense_groupby_plain(plan),
             N_Q1_LIVE * (key_bytes + val_bytes))):
        dev_ms, acts = one_launch_ms(run, name)
        print(f"{name}: device activities per call {acts}", flush=True)
        stats[name] = dict(
            max_abs_err=err if name == "dense_groupby" else 0.0,
            ms=cuda_ms(run), profiler_ms=dev_ms, host_ms=host_ms(run),
            plain_ms=cuda_ms(plain), library_ms=None,
            bound_ms=bound_ms(moved), bound_by="bytes",
            shape=shape + ("; 6 slots x 6 accumulators"
                           if name == "dense_groupby" else ""))
    return stats


# -- H7 wide_groupby -------------------------------------------------------

# TPC-H Q18's subquery at SF 10 (clause 2.4.18): every line item grouped on
# l_orderkey, the lines of an order adjacent as dbgen writes them
N_Q18_ORDERS = 15_000_000
Q18_SUB = [("l_quantity", "sum", "sum_qty")]
WIDE_REPEATS = 5           # launches held bit-identical to the first
# the shapes no cell runs: (name, keys of 60M rows) beside Q18's
RANDOM_SLOTS = 2 ** 10


def groupby_module():
    import importlib
    return importlib.import_module("libgdf_tpu_torch.ops.groupby")


def q18_lines(rng, dev, orders=N_Q18_ORDERS):
    """l_orderkey (int32) and l_quantity (float64) as Q18's subquery reads
    them: order keys as TPC-H makes them (the first 8 of every 32, so 1 to
    59,999,976 at 15M orders), 1 to 7 lines an order, in order, quantities
    1 to 50."""
    g = torch.Generator(device=dev).manual_seed(int(rng.integers(2**31)))
    o = torch.arange(orders, device=dev)
    okey = ((o // 8) * 32 + o % 8 + 1).to(torch.int32)
    lines = torch.randint(1, 8, (orders,), generator=g, device=dev)
    key = torch.repeat_interleave(okey, lines)
    qty = torch.randint(1, 51, (key.shape[0],), generator=g,
                        device=dev).double()
    return key, qty


def group_table(cols, valid=None, num_rows=None):
    """A Table of the columns `cols` ({name: tensor}), their validity
    (`valid`: {name: tensor}) and a live row count (None: all)."""
    valid = valid or {}
    return Table.from_columns(
        [Column.from_array(v, valid=valid.get(k), name=k)
         for k, v in cols.items()],
        num_rows=None if num_rows is None else num_rows.to(torch.int32))


def wide_plan(table, keys, aggs):
    """The dense or wide plan the group-by of `table` takes, or None where
    it sorts."""
    return groupby_module()._dense_plan(
        table, [table.column(k) for k in keys], aggs, True)


def sort_groupby(table, keys, aggs):
    """The sort path's group-by of the same input."""
    return groupby_module()._sort_groupby(
        table, keys, [table.column(k) for k in keys], aggs, True)


def check_wide_edges(rng, dev):
    """H7 at the edges of its tiles and chunks: 9 to 50,000 slots (its
    shared-memory instance up to 48 KB of slots, its global one past it),
    one and two keys, int8 to int64 keys, dead rows with stale keys, null
    keys, a nullable float32 column, int32 and int8 sums, sums of quarters
    (exact in any order), against its plain version."""
    domains = (9, 100, 1000, 5000, 50_000)
    held = []
    for i, m in enumerate(EDGE_SIZES):
        live = torch.tensor(m - m // 7, dtype=torch.int32, device=dev)
        d = domains[i % len(domains)]
        two = i % 2 == 1
        kdt = (torch.int16, torch.int32, torch.int64)[i % 3]
        span0 = max(d // 3, 3) if two else d
        cols = {"k0": torch.as_tensor(rng.integers(0, span0, m) - 1000,
                                      device=dev).to(kdt),
                "k1": torch.as_tensor(rng.integers(0, 3, m),
                                      device=dev).to(torch.int8),
                "f64": torch.as_tensor(rng.integers(-4000, 4000, m) / 4,
                                       device=dev),
                "f32": torch.as_tensor(rng.integers(-4000, 4000, m) / 4,
                                       device=dev).float(),
                "i32": torch.as_tensor(rng.integers(-9, 9, m),
                                       device=dev).to(torch.int32),
                "i8": torch.as_tensor(rng.integers(-128, 128, m),
                                      device=dev).to(torch.int8)}
        if m > 2:
            cols["k0"][:2] = torch.tensor([-1000, -1000 + span0 - 1])
        cols["k0"][int(live):] = 30_000          # stale keys, far outside
        aggs = [("f64", "sum", "s"), ("f64", "avg", "a"), ("f32", "sum", "t"),
                ("f32", "count", "c"), ("i32", "sum", "i"),
                ("i8", "avg", "j")]
        valid = {"f32": torch.as_tensor(rng.random(m) < 0.9, device=dev)}
        if i % 4 == 3:
            valid["k0"] = torch.as_tensor(rng.random(m) < 0.95, device=dev)
        keys = ["k0", "k1"] if two else ["k0"]
        t = group_table(cols, valid, live)
        plan = wide_plan(t, keys, aggs)
        if plan is None or not plan.wide:
            continue       # a domain too wide for its rows: the sort path
        same_dense(kernels.wide_groupby(plan),
                   kernels.dense_groupby_plain(plan), plan,
                   f"wide_groupby n={m} slots={plan.slots}")
        held.append((m, plan.slots, plan.slots * plan.slot_bytes))
    print(f"wide_groupby: held to its plain version at (rows, slots, slot "
          f"bytes) {held}", flush=True)


def time_against_sort(what, table, keys, aggs, card):
    """H7 and the sort path over one table: each group-by's device ms
    (CUDA events) and enqueue ms, H7's groups held to the sort path's and
    to its plain version's. Returns H7's plan and times."""
    plan = wide_plan(table, keys, aggs)
    if plan is None or not plan.wide:
        fail(f"wide_groupby {what}: the input does not take the wide path")
    got = kernels.wide_groupby(plan)
    same_dense(got, kernels.dense_groupby_plain(plan), plan,
               f"wide_groupby {what}")
    want = sort_groupby(table, keys, aggs)
    g = int(want.num_rows)
    if int(got[3]) != g:
        fail(f"wide_groupby {what}: {int(got[3])} groups, the sort path {g}")
    for i, c in enumerate(want.columns):
        exact(got[0][i][:g].cpu(), c.data[:g].cpu(),
              f"wide_groupby {what} against the sort path, {c.name}")
    h7 = cuda_ms(lambda: kernels.wide_groupby(plan))
    srt = cuda_ms(lambda: sort_groupby(table, keys, aggs))
    print(f"wide_groupby {what}: H7 {h7:.4f} ms, the sort path {srt:.4f} ms "
          f"({srt / h7:.2f}x; H7 enqueue "
          f"{host_ms(lambda: kernels.wide_groupby(plan)):.4f} ms; "
          f"{plan.slots} slots, {g} groups; {card})", flush=True)
    if h7 > srt:
        fail(f"wide_groupby {what}: slower than the sort path")
    return plan, h7, srt


def phase_wide(rng, dev):
    """H7 at its edges, then at Q18's shape held to its plain version and
    to the sort path, its repeats bit-identical, timed; then at two shapes
    no cell runs (Q18's keys shuffled; 2^10 random slots), each timed
    against the sort path, which H7 must not be slower than. Returns H7's
    stats."""
    card = card_line()
    check_wide_edges(rng, dev)
    key, qty = q18_lines(rng, dev)
    n = key.shape[0]
    t = group_table({"l_orderkey": key, "l_quantity": qty})
    plan, h7_ms, sort_ms = time_against_sort("at Q18's shape", t,
                                             ["l_orderkey"], Q18_SUB, card)
    got = kernels.wide_groupby(plan)
    for r in range(WIDE_REPEATS):
        same_dense(kernels.wide_groupby(plan), got, plan,
                   f"wide_groupby repeat {r}")
    print(f"wide_groupby: {WIDE_REPEATS} repeats at Q18's shape "
          "bit-identical", flush=True)
    kernels.reset_launch_counts()
    kernels.wide_groupby(plan)
    if kernels.launch_counts()["seg_scan"] or kernels.launch_counts()[
            "compact"]:
        fail("wide_groupby launched the sort path's kernels")
    run = lambda: kernels.wide_groupby(plan)                 # noqa: E731
    dev_ms, launches, acts = profiled(run, KERNEL_NAMES["wide_groupby"],
                                      expect=3)
    print(f"wide_groupby: {launches} launches a call, device activities "
          f"{acts}", flush=True)
    groups = int(got[3])
    moved = (n * (key.element_size() + qty.element_size())
             + 2 * plan.slots * plan.slot_bytes
             + groups * (key.element_size() + qty.element_size() + 1))
    perm = torch.randperm(n, device=dev)
    shuffled = group_table({"l_orderkey": key[perm],
                            "l_quantity": qty[perm]})
    time_against_sort("shuffled (60M rows, 15M slots)", shuffled,
                      ["l_orderkey"], Q18_SUB, card)
    del shuffled, perm
    g = torch.Generator(device=dev).manual_seed(int(rng.integers(2**31)))
    small = group_table(
        {"l_orderkey": torch.randint(0, RANDOM_SLOTS, (n,), generator=g,
                                     device=dev, dtype=torch.int32),
         "l_quantity": qty})
    time_against_sort(f"at {RANDOM_SLOTS} random slots (60M rows)", small,
                      ["l_orderkey"], Q18_SUB, card)
    del small
    return dict(max_abs_err=0.0, ms=h7_ms, profiler_ms=dev_ms,
                host_ms=host_ms(run), plain_ms=cuda_ms(
                    lambda: kernels.dense_groupby_plain(plan)),
                library_ms=None, bound_ms=bound_ms(moved), bound_by="bytes",
                sort_ms=sort_ms,
                shape=f"{n} rows, an int32 key, a float64 sum, "
                      f"{plan.slots} slots, {groups} groups")


# -- H6 hash_build / hash_probe -----------------------------------------------

# (probe rows, build rows, key domain) of the joins H6 runs in the cells:
# Q18's lineitem join (60M line items against ~100 orders; a 2048-slot table
# in shared memory) and Q3's (~32M line items against ~1.46M orders; 4M
# slots in global memory, L2-resident), int32 keys
HASH_SHAPES = {"q18": (60_000_000, 100, 15_000_000),
               "q3": (32_000_000, 1_460_000, 60_000_000)}


def hash_keys(rng, dev, probe_n, build_n, domain):
    g = torch.Generator(device=dev).manual_seed(int(rng.integers(2**31)))
    build = torch.randperm(domain, generator=g, device=dev)[:build_n]
    probe = torch.randint(0, domain, (probe_n,), generator=g, device=dev)
    return build.to(torch.int32), probe.to(torch.int32)


def same_hash(bk, pk, what):
    """H6 against its plain version: count and duplicate flag exact, the
    pairs by probe row exact. Returns the match count."""
    p, b, res = kernels.hash_probe(kernels.hash_build(bk), pk)
    pw, bw, rw = kernels.hash_probe_plain(kernels.hash_build_plain(bk), pk)
    count, dup = res.tolist()
    if [count, dup] != rw.tolist() or dup:
        fail(f"{what}: count, dup {count, dup} vs {rw.tolist()}")
    order = torch.argsort(p[:count])
    exact(p[:count][order].cpu(), pw[:count].cpu(), f"{what} probe rows")
    exact(b[:count][order].cpu(), bw[:count].cpu(), f"{what} build rows")
    return count


def phase_hash(rng, dev):
    """H6's build and probe at Q18's and Q3's shapes, held to their plain
    versions, then timed. The build's bound: the build keys read and the
    table written; the probe's: the probe keys read, the table read once
    and the pairs written. Returns the stats of both (Q18's shape, Q3's
    under `at_q3`)."""
    stats = {"hash_build": {}, "hash_probe": {}}
    for shape, (probe_n, build_n, domain) in HASH_SHAPES.items():
        bk, pk = hash_keys(rng, dev, probe_n, build_n, domain)
        count = same_hash(bk, pk, f"hash join at {shape}'s shape")
        table = kernels.hash_build(bk)
        table_bytes = table.data.numel()
        where = "shared memory" if table.staged else "global memory"
        desc = (f"{probe_n} int32 probe keys, {build_n} build keys, "
                f"{table.slots} slots in {where}, {count} matches")
        for name, run, plain, moved in (
                ("hash_build", lambda: kernels.hash_build(bk),
                 lambda: kernels.hash_build_plain(bk),
                 build_n * 4 + table_bytes),
                ("hash_probe", lambda: kernels.hash_probe(table, pk),
                 lambda: kernels.hash_probe_plain(
                     kernels.hash_build_plain(bk), pk),
                 probe_n * 4 + table_bytes + count * 8)):
            dev_ms, acts = one_launch_ms(run, name)
            print(f"{name} at {shape}'s shape: device activities per call "
                  f"{acts}", flush=True)
            st = dict(max_abs_err=0.0, ms=cuda_ms(run), profiler_ms=dev_ms,
                      host_ms=host_ms(run), plain_ms=cuda_ms(plain),
                      library_ms=None, bound_ms=bound_ms(moved),
                      bound_by="bytes", shape=desc)
            if shape == "q18":
                stats[name].update(st)
            else:
                stats[name]["at_q3"] = st
                print(f"kernel {name} at q3's shape: ms={st['ms']:.4f} "
                      f"profiler_ms={st['profiler_ms']} host_ms="
                      f"{st['host_ms']:.4f} plain_ms={st['plain_ms']:.4f} "
                      f"bound_ms={st['bound_ms']:.4f} ({desc})", flush=True)
        del bk, pk, table
    return stats


# -- H8 elementwise -----------------------------------------------------------

# TPC-H SF 10's line items (a ragged tail past every 16-row step), and each
# operation that Q6's and Q1's plans send through H8 at that shape (Q1's
# expressions run over the filter's capacity, the whole table):
# (what, wrapper, op, columns, scalar)
N_LINES = 59_986_052
H8_CALLS = (
    ("q6 l_shipdate ge", "elementwise_compare", "ge", ("ship",), 8766),
    ("q6 l_shipdate lt", "elementwise_compare", "lt", ("ship",), 9131),
    ("q6 l_discount ge", "elementwise_compare", "ge", ("disc",), 0.05),
    ("q6 l_discount le", "elementwise_compare", "le", ("disc",), 0.07),
    ("q6 l_quantity lt", "elementwise_compare", "lt", ("qty",), 24),
    ("q6 price * discount", "elementwise_binary", "mul",
     ("price", "disc"), None),
    ("q1 l_shipdate le", "elementwise_compare", "le", ("ship",), 10471),
    ("q1 1 - discount", "elementwise_binary", "sub", ("one", "disc"), None),
    ("q1 1 + tax", "elementwise_binary", "add", ("one", "tax"), None),
)
# the call whose numbers stand for each wrapper in the summary
H8_SUMMARY = {"elementwise_compare": "q6 l_discount ge",
              "elementwise_binary": "q6 price * discount"}
_TORCH_CMP = {"eq": torch.eq, "ne": torch.ne, "lt": torch.lt, "le": torch.le,
              "gt": torch.gt, "ge": torch.ge}
_TORCH_ARITH = {"add": torch.add, "sub": torch.sub, "mul": torch.mul}


def line_columns(dev, n=N_LINES):
    """lineitem's columns as Q1 and Q6 read them, made on the card; `one`
    is Q1's literal, one element broadcast."""
    g = torch.Generator(device=dev).manual_seed(11)

    def hundredths(lo, hi):
        return torch.randint(lo, hi, (n,), device=dev,
                             generator=g).double() / 100
    return {"ship": torch.randint(8036, 10562, (n,), dtype=torch.int32,
                                  device=dev, generator=g),
            "disc": hundredths(0, 11), "tax": hundredths(0, 9),
            "qty": torch.randint(1, 51, (n,), device=dev,
                                 generator=g).double(),
            "price": hundredths(90_000, 10_500_000),
            "one": torch.ones((), dtype=torch.float64,
                              device=dev).expand(n)}


def h8_call(cols, wrapper, op, names, value):
    """(H8's call, its plain version's, the library's nearest call: the
    op alone, on unflushed inputs, a compare's bool not made int8)."""
    args = [cols[c] for c in names]
    if wrapper == "elementwise_compare":
        return (lambda: kernels.elementwise_compare(args[0], op, value),
                lambda: kernels.elementwise_compare_plain(args[0], op, value),
                lambda: _TORCH_CMP[op](args[0], value))
    return (lambda: kernels.elementwise_binary(op, *args),
            lambda: kernels.elementwise_binary_plain(op, *args),
            lambda: _TORCH_ARITH[op](*args))


def h8_bytes(cols, names, out_itemsize):
    """What one call must move: each column read once (a broadcast
    operand is one element) and the output written."""
    n = N_LINES
    read = sum(n * cols[c].element_size() for c in names
               if cols[c].stride(0) != 0)
    return read + n * out_itemsize


def phase_elementwise(rng, dev):
    """H8 at Q6's and Q1's shapes: each call held to its plain version,
    then timed beside its byte bound, its plain version (the torch path it
    replaces: the flushes, the op, the int8 copy; device and host time)
    and the library's op alone. Returns each wrapper's stats (H8_SUMMARY's call), every call's
    under `at_shapes`. (The edge values, tails and views are the card
    tests', `tests/test_torch_cuda.py -k h8`.)"""
    cols = line_columns(dev)
    stats = {name: {"at_shapes": {}} for name in H8_SUMMARY}
    for what, wrapper, op, names, value in H8_CALLS:
        run, plain, library = h8_call(cols, wrapper, op, names, value)
        got = run()
        exact_bits(got.cpu(), plain().cpu(), f"{wrapper} at {what}")
        moved = h8_bytes(cols, names, got.element_size())
        dev_ms, acts = one_launch_ms(run, wrapper)
        st = dict(max_abs_err=0.0, ms=cuda_ms(run), profiler_ms=dev_ms,
                  host_ms=host_ms(run), plain_host_ms=host_ms(plain),
                  plain_ms=cuda_ms(plain), library_ms=cuda_ms(library),
                  bound_ms=bound_ms(moved), bound_by="bytes",
                  shape=f"{what}, {N_LINES} rows, {got.dtype} out")
        print(f"{wrapper} at {what}: ms={st['ms']:.4f} profiler_ms="
              f"{st['profiler_ms']} host_ms={st['host_ms']:.4f} "
              f"plain_host_ms={st['plain_host_ms']:.4f} plain_ms="
              f"{st['plain_ms']:.4f} library_ms={st['library_ms']:.4f} "
              f"bound_ms={st['bound_ms']:.4f} (activities per call {acts})",
              flush=True)
        stats[wrapper]["at_shapes"][what] = st
        if H8_SUMMARY[wrapper] == what:
            stats[wrapper].update(st)
        del got
    return stats


def h8_first_calls(dev):
    """In this process (fresh: run as `chip_smoke.py --h8-first-calls`),
    the first and second call of each H8 operation the benchmark's four
    cells launch, at their shapes, host clock to a sync; the library
    loaded and one other kernel run first, so that neither counts."""
    kernels.build()
    _lib.lib()
    kernels.scan("sum", torch.zeros(1, dtype=torch.int32, device=dev))
    cols = line_columns(dev)
    cols["seg"] = torch.randint(0, 5, (1_500_000,), device=dev).to(
        torch.int8)
    cols["sums"] = torch.rand(15_000_000, device=dev,
                              dtype=torch.float64) * 400
    calls = [c[:5] for c in H8_CALLS] + [
        ("q3 c_mktsegment eq", "elementwise_compare", "eq", ("seg",), 2),
        ("q3 l_shipdate gt", "elementwise_compare", "gt", ("ship",), 9204),
        ("q3 1 - discount", "elementwise_binary", "sub", ("one", "disc"),
         None),
        ("q18 sum_qty gt", "elementwise_compare", "gt", ("sums",), 313.0)]
    torch.cuda.synchronize()
    rows = []
    for what, wrapper, op, names, value in calls:
        run = h8_call(cols, wrapper, op, names, value)[0]
        ms = []
        for _ in range(2):
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        rows.append({"call": what, "first_ms": ms[0], "second_ms": ms[1]})
        print(f"h8 first call {what}: first_ms={ms[0]:.3f} "
              f"second_ms={ms[1]:.3f}", flush=True)
    worst = max(r["first_ms"] - r["second_ms"] for r in rows)
    print(json.dumps({"h8_first_calls": rows, "worst_extra_ms": worst,
                      "card": card_line()}), flush=True)
    return 0 if worst < 50 else 1


# -- the dense path -----------------------------------------------------------

def make_q1_data(seed=0):
    """Q1's lineitem columns as numpy, N_FACT rows: ship dates over the
    seven years, the two flags as int8 codes, the measures as float64."""
    rng = np.random.default_rng(seed)
    n = N_FACT
    price = rng.uniform(900.0, 105_000.0, n)
    disc = rng.integers(0, 11, n) / 100
    tax = rng.integers(0, 9, n) / 100
    return {"l_shipdate": rng.integers(8036, 10562, n).astype(np.int32),
            "l_returnflag": rng.integers(0, 3, n).astype(np.int8),
            "l_linestatus": rng.integers(0, 2, n).astype(np.int8),
            "l_quantity": rng.integers(1, 51, n).astype(np.float64),
            "l_extendedprice": price, "l_discount": disc,
            "disc_price": price * (1 - disc),
            "charge": price * (1 - disc) * (1 + tax)}


def run_dense_path(data, device):
    """Q1's filter, group-by (the dense path: a probe and H5) and order_by
    on `device`; returns (results, per-op timings)."""
    t = Table.from_dict(data, device=device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    sync()
    times = {}

    def timed(name, rows_in, fn):
        t0 = time.perf_counter()
        out = fn()
        sync()
        times[name] = (rows_in, time.perf_counter() - t0)
        return out

    filt = timed("q1_filter", t.capacity, lambda: ops.filter_table(
        t, ops.compare_scalar(t["l_shipdate"], 10561 - 90, "le")))
    gb = timed("q1_groupby", filt.capacity,
               lambda: ops.groupby(filt, list(Q1_KEYS), Q1_AGGS).compact())
    out = timed("q1_order_by", gb.capacity,
                lambda: gb.gather(ops.order_by(gb, list(Q1_KEYS))))
    return dict(filt=filt, gb=out), times


def check_dense_path(gpu, cpu):
    compare_tables(gpu["filt"], cpu["filt"], "q1 filter")
    floats = [spec[2] for spec in Q1_AGGS if spec[1] != "count"]
    compare_tables(gpu["gb"], cpu["gb"], "q1 groupby",
                   {name: (Q1_REL, 0.0) for name in floats})
    groups = gpu["gb"].compact().capacity
    if groups != 6:
        fail(f"q1 groupby: {groups} groups, not 6")


# -- the main path ----------------------------------------------------------

def make_data(seed=0):
    """The main path's inputs as numpy: (fact, fact nulls, dim, dup probe,
    dup probe nulls, dup build)."""
    rng = np.random.default_rng(seed)
    n, nb = N_FACT, N_DIM
    fact = {"k": rng.integers(0, nb, n).astype(np.int64),
            "v": rng.standard_normal(n).astype(np.float32)}
    fact_nulls = {"k": rng.random(n) < 0.05, "v": rng.random(n) < 0.10}
    dim = {"k": rng.permutation(nb).astype(np.int64),
           "w": rng.standard_normal(nb).astype(np.float32)}
    nd = nb // MULT
    probe = {"k": rng.integers(0, nd, n).astype(np.int64)}
    probe_nulls = {"k": rng.random(n) < 0.05}
    build = {"k": np.repeat(rng.permutation(nd), MULT).astype(np.int64),
             "w": rng.standard_normal(nb).astype(np.float32)}
    return fact, fact_nulls, dim, probe, probe_nulls, build


def run_main_path(data, device):
    """The main path on `device`; returns (results, per-op timings). Each
    operator ends in a device sync so that its host time is its own."""
    fact, fact_nulls, dim, probe, probe_nulls, build = data
    ft = Table.from_dict(fact, fact_nulls, device=device)
    dt = Table.from_dict(dim, device=device)
    pt = Table.from_dict(probe, probe_nulls, device=device)
    bt = Table.from_dict(build, device=device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    sync()
    times = {}

    def timed(name, rows_in, fn):
        t0 = time.perf_counter()
        out = fn()
        sync()
        times[name] = (rows_in, time.perf_counter() - t0)
        return out

    filt = timed("filter", ft.capacity, lambda: ops.filter_table(
        ft, ops.compare_scalar(ft["v"], 0.0, "lt")))
    joined = timed("join", filt.capacity + dt.capacity,
                   lambda: ops.join(filt, dt, ["k"], ["k"], how="inner"))
    gb = timed("groupby", joined.capacity,
               lambda: ops.groupby(joined, ["k"], AGGS))
    perm = timed("order_by", gb.capacity, lambda: ops.order_by(
        gb, ["s"], ascending=False, nulls_last=True))
    dup = timed("dup_join", pt.capacity + bt.capacity,
                lambda: ops.inner_join(pt, bt, ["k"], ["k"]))
    return dict(filt=filt, joined=joined, gb=gb, perm=perm, dup=dup), times


def check_main_path(gpu, cpu, dev):
    compare_tables(gpu["filt"], cpu["filt"], "filter")
    compare_tables(gpu["joined"], cpu["joined"], "join")
    compare_tables(gpu["gb"], cpu["gb"], "groupby", GB_TOL)
    # order_by exact on identical input: the CPU run's groupby output
    again = ops.order_by(cpu["gb"].to(dev), ["s"], ascending=False,
                         nulls_last=True)
    exact(again.cpu(), cpu["perm"], "order_by")
    # and the GPU run's own order sorts its sums like the CPU run's
    g = int(gpu["gb"].num_rows)
    s_gpu = gpu["gb"]["s"].data[gpu["perm"][:g].long()].cpu()
    s_cpu = cpu["gb"]["s"].data[cpu["perm"][:g].long()]
    if not torch.allclose(s_gpu, s_cpu, rtol=1e-4, atol=1e-4):
        fail("order_by: sorted sums differ")
    for i, (a, b) in enumerate(zip(gpu["dup"], cpu["dup"])):
        exact(a.cpu(), b, f"dup_join output {i}")
    if int(gpu["dup"][2]) <= 0:
        fail("dup_join: empty")
    if int(gpu["joined"].num_rows) <= 0 or g <= 0:
        fail("main path: empty join or groupby")


# -- the analytic path ------------------------------------------------------

def make_analytic_data(seed=0):
    """W as numpy: (columns, null masks)."""
    rng = np.random.default_rng(seed)
    n = N_W
    cols = {"p": rng.integers(0, W_PARTS, n).astype(np.int32),
            "o": rng.permutation(n).astype(np.int32),
            "v": rng.standard_normal(n).astype(np.float32),
            "q": rng.integers(-2**40, 2**40, n),
            "x": rng.standard_normal(n)}
    return cols, {"v": rng.random(n) < 0.10}


def run_analytic_path(data, device):
    """The analytic path on `device`; returns (results, per-op timings),
    each operator ending in a device sync."""
    cols, nulls = data
    W = Table.from_dict(cols, nulls, device=device)
    sync = (lambda: torch.cuda.synchronize(device)) \
        if device.type == "cuda" else (lambda: None)
    sync()
    out, times = {}, {}

    def timed(name, fn):
        t0 = time.perf_counter()
        out[name] = fn()
        sync()
        times[name] = (W.capacity, time.perf_counter() - t0)

    for name, red, prec, pb, frame in WINDOWS:
        timed(name, lambda: ops.window_function(
            W, "v", red, preceding=prec, partition_by=pb, order_by=["o"],
            frame=frame))
    timed("prefixsum_int64", lambda: (ops.prefixsum(W["q"], True),
                                      ops.prefixsum(W["q"], False)))
    timed("prefixsum_float64", lambda: ops.prefixsum(W["x"]))
    timed("reductions", lambda: [ops.reduce(W["v"], op) for op in
                                 ("sum", "min", "max", "product",
                                  "sum_squared")])
    timed("quantiles", lambda: [ops.quantile_exact(W["v"], 0.5, m)
                                for m in QMETHODS]
          + [ops.quantile_approx(W["v"], 0.5)])
    return out, times, W


def sorted_running_abs(W, partition_by):
    """Running sum of |v| over valid rows in a window's sort order (the
    partition hash, then o), at each row in input order: the scale of its
    float64 prefix sums' rounding error."""
    v = W["v"]
    a = torch.where(v.valid_or_true(), v.data.double().abs(), 0.0)
    keys = {"o": W["o"].data}
    if partition_by:
        keys = {"h": ops.hash_columns([W[c] for c in partition_by]), **keys}
    perm = ops.order_by(Table.from_dict(keys, device=W.device),
                        list(keys)).long()
    run = torch.empty_like(a)
    run[perm] = torch.cumsum(a[perm], 0)
    return run


def check_analytic_path(gpu, cpu, W_cpu):
    for name, red, _, pb, _ in WINDOWS:
        g, c = gpu[name], cpu[name]
        exact(g.valid.cpu(), c.valid, f"{name} validity")
        if int(c.valid.sum()) < N_W // 2:
            fail(f"{name}: too few valid rows")
        gd = torch.where(c.valid, g.data.cpu(), 0.0)
        cd = torch.where(c.valid, c.data, 0.0)
        if red in ("min", "max"):
            exact(gd, cd, name)
        else:
            running_sum_close(gd, cd, sorted_running_abs(W_cpu, pb), 2e-12,
                              name)
    for g, c, what in zip(gpu["prefixsum_int64"], cpu["prefixsum_int64"],
                          ("inclusive", "exclusive")):
        exact(g.data.cpu(), c.data, f"prefixsum int64 {what}")
    x = W_cpu["x"].data
    err = running_sum_close(gpu["prefixsum_float64"].data.cpu(),
                            cpu["prefixsum_float64"].data,
                            torch.cumsum(x.abs(), 0), 1e-12,
                            "prefixsum float64")
    scale = float(W_cpu["v"].data.double().abs().sum())
    for op, g, c in zip(("sum", "min", "max", "product", "sum_squared"),
                        gpu["reductions"], cpu["reductions"]):
        g = g.cpu()
        if op in ("min", "max"):
            exact(g, c, f"reduce {op}")
        elif not abs(float(g) - float(c)) <= 1e-5 * (scale + abs(float(c))):
            fail(f"reduce {op}: {float(g)} vs {float(c)}")
    for i, (g, c) in enumerate(zip(gpu["quantiles"], cpu["quantiles"])):
        exact(g.cpu(), c, f"quantile {i}")
    return err


# -- the ABI path -----------------------------------------------------------

def make_abi_data(csv_path, seed=0):
    """The ABI path's inputs as numpy, and the CSV file written to
    `csv_path`: {name: (values, null mask or None)} plus the file's own
    columns under "csv"."""
    rng = np.random.default_rng(seed)
    n, nb, nd = N_FACT, N_DIM, N_DIM // MULT
    f32 = rng.standard_normal(n).astype(np.float32)
    f32[rng.integers(0, n, 1000)] = np.nan
    f32[rng.integers(0, n, 1000)] = np.inf
    f32[rng.integers(0, n, 1000)] = -np.inf
    f32[rng.integers(0, n, 1000)] = 3e10
    data = {
        "key": (rng.integers(0, nb, n), rng.random(n) < 0.05),
        "i32": (rng.integers(-1000, 1000, n).astype(np.int32), None),
        "f32": (f32, None),
        "f64": (rng.standard_normal(n) * 100, rng.random(n) < 0.10),
        "ts": (rng.integers(-2_500_000_000_000, 4_700_000_000_000, n), None),
        "q": (rng.integers(-2**40, 2**40, n), None),
        "cat": (rng.integers(0, 100, n).astype(np.int32), None),
        "flag": (rng.integers(0, 4, n).astype(np.int8), None),
        "o": (rng.permutation(n).astype(np.int32), None),
        "dkey": (rng.permutation(nb), None),
        "dw": (rng.standard_normal(nb).astype(np.float32), None),
        "pkey": (rng.integers(0, nd, n), rng.random(n) < 0.05),
        "bkey": (np.repeat(rng.permutation(nd), MULT), None),
    }
    offsets = np.sort(rng.choice(np.arange(1, n), N_SEGMENTS - 1,
                                 replace=False))
    data["offsets"] = np.concatenate([[0], offsets]).astype(np.int32)
    for j in range(4):
        data[f"m{j}"] = (rng.standard_normal(N_CSR).astype(np.float32),
                         rng.random(N_CSR) < 0.3)
    m = N_CSV
    csv = {"k": rng.integers(-2**40, 2**40, m),
           "v": rng.integers(-1000, 1000, m).astype(np.int32),
           "x": rng.standard_normal(m),
           "s": rng.integers(0, 100, m)}
    hole = rng.random((m, 4)) < 0.03
    text = [np.where(hole[:, 0], "", csv["k"].astype(str)),
            np.where(hole[:, 1], "", csv["v"].astype(str)),
            np.where(hole[:, 2], "", [repr(float(x)) for x in csv["x"]]),
            np.where(hole[:, 3], "", np.char.add(
                "w", np.char.zfill(csv["s"].astype(str), 2)))]
    with open(csv_path, "w") as f:
        f.write("\n".join(map(",".join, zip(*text))))
        f.write("\n")
    data["csv"] = (csv_path, csv, hole)
    return data


def run_abi_path(data, device):
    """The ABI path on `device` through libgdf_tpu_torch.compat.gdf;
    returns (results, per-step timings, the columns). Each step sits in an
    NVTX range and ends in a device sync."""
    on_card = device.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if on_card \
        else (lambda: None)
    out, times = {}, {}

    def step(name, rows, fn):
        gdf.gdf_nvtx_range_push(f"ABI_{name}")
        t0 = time.perf_counter()
        out[name] = fn()
        sync()
        times[f"abi_{name}"] = (rows, time.perf_counter() - t0)
        gdf.gdf_nvtx_range_pop()

    if gdf.rmmInitialize() != 0 or not gdf.rmmIsInitialized():
        fail("rmmInitialize")

    path, _, _ = data["csv"]
    arg = CSVReadArg(file_path=path, names=["k", "v", "x", "s"],
                     dtype=["int64", "int32", "float64", "str"])
    step("read_csv", N_CSV, lambda: gdf.read_csv(arg, device=device))
    out["csv_scanner"] = arg.scanner
    out["csv_categories"] = out["read_csv"].categories

    c = {name: gdf.gdf_column_view(v[0], None if v[1] is None else ~v[1],
                                   len(v[0]), device=device).with_name(name)
         for name, v in data.items() if isinstance(v, tuple) and name != "csv"}
    c["ts"] = gdf.gdf_cast_i64_to_timestamp(c["ts"], TimeUnit.ms)
    sync()
    n = N_FACT

    step("add_i64", n, lambda: gdf.gdf_add_i64(c["key"], c["q"]))
    step("mul_f32", n, lambda: gdf.gdf_mul_f32(c["f32"], c["f32"]))
    step("floordiv_generic", n,
         lambda: gdf.gdf_floordiv_generic(c["key"], c["i32"]))
    step("cast_f32_to_i32", n, lambda: gdf.gdf_cast_f32_to_i32(c["f32"]))
    step("sqrt_f64", n, lambda: gdf.gdf_sqrt_f64(c["f64"]))
    step("extract_datetime", n, lambda: [
        getattr(gdf, f"gdf_extract_datetime_{part}")(c["ts"])
        for part in ("year", "month", "day", "hour", "minute", "second")])
    step("validity_and", n, lambda: gdf.gdf_validity_and(c["key"], c["f64"]))

    def stencil():
        st = gdf.gpu_comparison_static_i64(c["key"], N_DIM // 2, "lt")
        return st, gdf.gpu_apply_stencil(c["f64"], st)
    step("stencil", n, stencil)
    step("filter", n, lambda: gdf.gdf_filter([c["cat"], c["flag"]], (7, 2)))

    left, right = [c["key"], c["i32"]], [c["dkey"], c["dw"]]
    step("inner_join", n + N_DIM, lambda: gdf.gdf_inner_join(
        left, 2, [0], right, 2, [0], 1))
    step("left_join", n + N_DIM, lambda: gdf.gdf_left_join(
        left, 2, [0], right, 2, [0], 1))
    step("dup_inner_join", n + N_DIM, lambda: gdf.gdf_inner_join(
        [c["pkey"]], 1, [0], [c["bkey"], c["dw"]], 2, [0], 1))

    for name, op, val in (("group_by_sum_i64", "sum", "q"),
                          ("group_by_sum_f64", "sum", "f64"),
                          ("group_by_max_i64", "max", "q"),
                          ("group_by_avg", "avg", "f64"),
                          ("group_by_count", "count", "f64")):
        step(name, n, lambda op=op, val=val: getattr(
            gdf, f"gdf_group_by_{op}")(1, [c["key"]], c[val]))

    step("order_by", n, lambda: gdf.gdf_order_by([c["cat"], c["key"]], 2))

    def radix(descending, begin_bit, end_bit):
        plan = gdf.gdf_radixsort_plan(n, descending, begin_bit, end_bit)
        gdf.gdf_radixsort_plan_setup(plan, 4, 8)
        res = gdf.gdf_radixsort_i32(plan, c["i32"], c["q"])
        gdf.gdf_radixsort_plan_free(plan)
        try:
            gdf.gdf_radixsort_i32(plan, c["i32"], c["q"])
        except GDFError:
            return res
        fail("a sort through a freed radixsort plan did not raise")
    step("radixsort_i32", n, lambda: radix(False, 0, 0))
    step("radixsort_i32_desc", n, lambda: radix(True, 0, 0))
    step("radixsort_i32_bits_8_24", n, lambda: radix(False, 8, 24))

    def seg_radix():
        plan = gdf.gdf_segmented_radixsort_plan(n, False)
        gdf.gdf_segmented_radixsort_plan_setup(plan, 8, 4)
        res = gdf.gdf_segmented_radixsort_i64(
            plan, c["q"], c["i32"], N_SEGMENTS, data["offsets"])
        gdf.gdf_segmented_radixsort_plan_free(plan)
        return res
    step("segmented_radixsort_i64", n, seg_radix)

    step("prefixsum_i64", n, lambda: gdf.gdf_prefixsum_i64(c["q"]))
    step("reductions", n, lambda: [gdf.gdf_sum_f64(c["f64"]),
                                   gdf.gdf_min_i32(c["i32"]),
                                   gdf.gdf_max_generic(c["key"])])
    step("quantile_exact", n, lambda: gdf.gdf_quantile_exact(c["f64"], 0.5))
    step("hash", n, lambda: gdf.gdf_hash(2, [c["key"], c["i32"]]))
    step("hash_columns", n,
         lambda: gdf.gpu_hash_columns([c["key"], c["i32"]]))
    step("hash_partition", n, lambda: gdf.gdf_hash_partition(
        2, [c["key"], c["i32"]], [0], N_PARTS))
    step("window_sum_rows", n, lambda: gdf.gdf_window_function(
        c["f64"], "sum", "row", preceding=1000, order_columns=[c["o"]]))
    step("to_csr", 4 * N_CSR,
         lambda: gdf.gdf_to_csr([c[f"m{j}"] for j in range(4)], 4))

    if on_card:
        def rmm():
            h = gdf.rmmAlloc(1 << 20)
            gdf.rmmRealloc(h, 1 << 21)
            gdf.rmmFree(h)
            return gdf.rmmGetInfo()
        step("rmm", 3, rmm)
        lines = gdf.rmmGetLog().strip().splitlines()
        total = torch.cuda.mem_get_info(device)[1]
        events = [ln.split(",") for ln in lines[1:]]
        if [e[0] for e in events] != ["Alloc", "Realloc", "Free"] or any(
                int(e[6]) != total for e in events) or \
                out["rmm"][1] != total or gdf.rmmLogSize() <= len(lines[0]):
            fail(f"rmm log: {lines}")
        out["rmm_log"] = lines
    gdf.rmmFinalize()
    return out, times, c


# -- the distributed path ---------------------------------------------------

def make_dist_data(n, seed=0):
    """The distributed path's inputs as numpy: (fact, dimension), as
    benchmarks/dist_bench.py draws them."""
    rng = np.random.default_rng(seed)
    fact = {"k": rng.zipf(1.3, n).astype(np.int64) % DIST_KEYS,
            "v": rng.standard_normal(n).astype(np.float32)}
    dim = {"k": np.arange(DIST_KEYS, dtype=np.int64),
           "w": rng.random(DIST_KEYS).astype(np.float32)}
    return fact, dim


def dist_filter(local):
    return ops.filter_table(local, ops.compare_scalar(local["v"], -1.0, "gt"))


def sync_mesh(mesh):
    """Wait for every card the mesh uses."""
    for d in dict.fromkeys(mesh.devices):
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def dist_setup(data, device, shards):
    """The distributed path's mesh (`shards` shards on `device`, or with
    device None spread over the node's cards by make_mesh), its fact table
    distributed, then dist_plan's joins, slots and readouts."""
    fact, dim = data
    mesh = par.make_mesh(shards, device=device)
    sf = par.distribute(Table.from_dict(fact, device=mesh.device), mesh)
    sd = par.distribute(Table.from_dict(dim, device=mesh.device), mesh)
    return (mesh, sf) + dist_plan(mesh, sf, sd)


def dist_plan(mesh, sf, sd):
    """detect_skew's readout and the three variants' joins over the
    distributed fact and dimension tables, planned, with the groupby slot
    capacity of each."""
    hist, _ = par.detect_skew(mesh, sf, ["k"], num_bins=DIST_P)
    info = {"skew_max_over_mean": float(hist.max() / max(hist.mean(), 1.0))}
    slot_join = par.exact_slot_capacity(mesh, [(sf, ["k"]), (sd, ["k"])],
                                        num_batches=DIST_BATCHES)
    filtered = par.map_shards(mesh, dist_filter, sf)
    plan = par.plan_salted_join(mesh, filtered, sd, ["k"], ["k"],
                                how="inner", threshold=3.0)
    joins = {
        "plain": lambda f: par.dist_join(
            mesh, f, sd, ["k"], ["k"], how="inner", slot_capacity=slot_join,
            out_capacity_per_shard=4 * (sf.capacity // mesh.size),
            num_batches=DIST_BATCHES),
        "salted": lambda f: par.dist_join_salted(mesh, f, sd, ["k"], ["k"],
                                                 plan=plan),
        "broadcast": lambda f: par.broadcast_join(mesh, f, sd, ["k"], ["k"]),
    }
    slots = {name: par.exact_groupby_slot_capacity(
        mesh, join(filtered), ["k"], DIST_AGGS, num_batches=DIST_BATCHES)
        for name, join in joins.items()}
    info["plain"] = {"slot_join": slot_join}
    info["salted"] = {"slot_join": plan.slot_capacity,
                      "hot_capacity_per_shard": plan.hot_capacity_per_shard,
                      "hot_bins": int(plan.hot.sum())}
    return joins, slots, info


def dist_run(mesh, sf, join, slot_gb):
    """One variant: filter -> join -> dist_groupby."""
    return par.dist_groupby(mesh, join(par.map_shards(mesh, dist_filter, sf)),
                            ["k"], DIST_AGGS, slot_capacity=slot_gb,
                            num_batches=DIST_BATCHES)


def run_dist_path(data, device, shards=DIST_P):
    """The distributed pipeline at `shards` in-process shards on `device`
    (None: spread over the node's cards); returns (results, per-variant
    timings). Each variant is planned in a first pass and timed in a
    second that ends in a sync of every card of the mesh; rows are the
    fact table's."""
    n = data[0]["k"].shape[0]
    mesh, sf, joins, slots, out = dist_setup(data, device, shards)
    times = {}
    for name, join in joins.items():
        sync_mesh(mesh)
        mesh.exchange.reset()
        t0 = time.perf_counter()
        g = dist_run(mesh, sf, join, slots[name])
        sync_mesh(mesh)
        secs = time.perf_counter() - t0
        times[f"dist_{name}"] = (n, secs)
        out.setdefault(name, {}).update(
            result=g, groups=int(g.total_rows()), slot_groupby=slots[name],
            exchange_share=mesh.exchange.seconds / mesh.size / secs,
            exchange_calls=mesh.exchange.calls)
    return out, times


def one_stream(mesh):
    """Every shard on the caller's current stream of its card: the
    in-process mesh without a stream per shard, for comparison."""
    return [torch.cuda.current_stream(d) for d in mesh.devices]


def quarter_data(data):
    """The distributed path's rows with each value rounded to a multiple of
    1/4: every partial sum of a group stays under 2^22 (the largest
    group's sum of |v| is 1.33M at 10M rows), so float32 adds them exactly
    in any order."""
    fact, dim = data
    v = (np.round(fact["v"].astype(np.float64) * 4) / 4).astype(np.float32)
    return {**fact, "v": v}, dim


def dist_repeats(data, dev, runs):
    """The plain variant `runs` times on one mesh of DIST_P shards on the
    card: each run's groups collected and sorted by key, as (keys, counts,
    sums) on the host."""
    mesh, sf, joins, slots, _ = dist_setup(data, dev, DIST_P)
    outs = []
    for _ in range(runs):
        g = ops.sort_table(par.collect(dist_run(mesh, sf, joins["plain"],
                                                slots["plain"])), ["k"])
        outs.append(tuple(g[c].data.cpu() for c in ("k", "c", "s")))
    return outs


def check_dist_races(ddata, dev):
    """The plain variant DIST_REPEATS times over quarter values, each run
    bit for bit the single-table pipeline's keys, counts and sums; then 5
    times over the normal values, keys and counts bit-identical."""
    qdata = quarter_data(ddata)
    ref, _ = dist_reference(qdata, dev)
    want = tuple(ref[c].data.cpu() for c in ("k", "c", "s"))
    t0 = time.perf_counter()
    for i, got in enumerate(dist_repeats(qdata, dev, DIST_REPEATS)):
        for name, g, w in zip(("keys", "counts", "sums"), got, want):
            exact(g, w, f"dist race check run {i} {name}")
    print(f"distributed race check: {DIST_REPEATS} runs of the plain variant "
          f"over quarter values, keys / counts / sums of {want[0].shape[0]} "
          f"groups equal to the single-table pipeline bit for bit "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    outs = dist_repeats(ddata, dev, 5)
    same_sums = 0
    for i, got in enumerate(outs):
        exact(got[0], outs[0][0], f"dist repeat {i} keys")
        exact(got[1], outs[0][1], f"dist repeat {i} counts")
        same_sums += bool(torch.equal(got[2], outs[0][2]))
    print(f"distributed repeats over the normal values: keys and counts "
          f"bit-identical in 5 runs, float32 sums bit-identical to the "
          f"first run's in {same_sums} of 5", flush=True)


@contextlib.contextmanager
def busy_streams(dev, n=DIST_P, rows=1 << 20):
    """n threads, each on a stream of its own, launching H2, H3 and H1
    over `rows` rows and checking each result exactly, until the block
    ends; yields each thread's count of checked rounds. Raises the first
    thread's error at the end."""
    stop = threading.Event()
    rounds = [0] * n
    errors = []

    def run(i):
        try:
            torch.cuda.set_device(dev)
            with torch.cuda.stream(torch.cuda.Stream(dev)):
                idx = torch.arange(rows, dtype=torch.int64, device=dev)
                ones = torch.ones(rows, dtype=torch.int64, device=dev)
                flags, keep = idx % 1000 == 0, idx % 3 == i % 3
                want_keep = idx[keep]
                while not stop.is_set():
                    s = kernels.scan("sum", ones)
                    g = kernels.seg_scan("sum", flags, ones)
                    (c,), cnt = kernels.compact([idx], keep)
                    m = want_keep.shape[0]
                    if not (bool((s == idx + 1).all())
                            and bool((g == idx % 1000 + 1).all())
                            and int(cnt) == m
                            and bool((c[:m] == want_keep).all())):
                        raise RuntimeError(f"busy stream {i}: round "
                                           f"{rounds[i]} differs")
                    rounds[i] += 1
        except BaseException as e:  # raised in the caller below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,), daemon=True,
                                name=f"busy-{i}") for i in range(n)]
    for t in threads:
        t.start()
    while not errors and min(rounds) < 1:
        time.sleep(0.01)
    try:
        yield rounds
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=120)
        if errors:
            raise errors[0]
        if any(t.is_alive() for t in threads):
            fail("a busy stream's thread did not stop")


def dist_rates(times):
    return " ".join(f"{k}_rows_per_s={rows / secs:.4e}"
                    for k, (rows, secs) in times.items())


STREAM_MODES = {
    "one stream": lambda: mock.patch.object(Mesh, "shard_streams",
                                            one_stream),
    "stream per shard": contextlib.nullcontext,
}


def compare_stream_modes(ddata, dev, card):
    """The path at DIST_P shards with every shard on one stream and with a
    stream per shard, in turns (one, per shard, per shard, one), then one
    profile of each: rows/s, exchange share, device busy share."""
    for mode in ("one stream", "stream per shard", "stream per shard",
                 "one stream"):
        with STREAM_MODES[mode]():
            res, times = run_dist_path(ddata, dev)
        print(f"dist {mode}: " + dist_rates(times) + " exchange_share " +
              "/".join(f"{res[v]['exchange_share']:.4f}"
                       for v in ("plain", "salted", "broadcast")) +
              f" ({card})", flush=True)
    for mode in ("one stream", "stream per shard"):
        with STREAM_MODES[mode]():
            wall, busy, own, nk, top, union = profile_op(
                lambda: run_dist_path(ddata, dev))
        print(f"profile distributed path, {mode}: wall_us={wall:.1f} "
              f"device_busy_us={busy:.1f} share={busy / wall:.4f} "
              f"busy_union_us={union:.1f} union_share={union / wall:.4f} "
              f"own_kernels_us={own:.1f} kernels={nk} top={top} ({card})",
              flush=True)


def run_across_cards(ddata, ref, absref):
    """On a node of C >= 2 cards, the path on make_mesh(C), one shard per
    card: shard s on cuda:s, every variant held to the single-table
    pipeline (ref, absref from dist_reference on cuda:0), rows/s and
    exchange share. On one card, a line that says this did not run."""
    cards = torch.cuda.device_count()
    if cards < 2:
        print("distributed path across cards: NOT RUN, this machine has one "
              "card (torch.cuda.device_count() = 1) and one shard per card "
              "needs 2 or more", flush=True)
        return
    lines = "; ".join(card_lines())
    for _ in range(2):
        res, times = run_dist_path(ddata, None, cards)
    want = [torch.device("cuda", s) for s in range(cards)]
    for name in ("plain", "salted", "broadcast"):
        got = [t.device for t in res[name]["result"].shards]
        if got != want:
            fail(f"dist across cards {name}: shards on {got}")
    t0 = time.perf_counter()
    err, _ = check_dist_path(res, ref, absref, f"dist {cards} cards")
    print(f"distributed path across {cards} cards, one shard per card "
          f"(shard s on cuda:s): " + dist_rates(times) + " exchange_share " +
          "/".join(f"{res[v]['exchange_share']:.4f}"
                   for v in ("plain", "salted", "broadcast")) +
          f"; the three variants match the single-table pipeline (sum error "
          f"{err}; {time.perf_counter() - t0:.1f} s) ({lines})", flush=True)


# -- the distributed path across processes ----------------------------------

# the local joins take the hash path (each shard's build keys are unique),
# so no scan of a join's sort path
PROC_KERNELS = ("compact", "seg_scan", "hash_build", "hash_probe")
PROC_TIMEOUT = 600          # seconds a worker may take
VARIANTS = ("plain", "salted", "broadcast")


def proc_layouts(cards):
    """(processes W, shards a process L) that a node of `cards` cards
    holds, and the lines of those it does not: W = 1, L = 8 on one card;
    one process a card; 2 processes of cards / 2, the JAX package's
    layout (tests/mp_worker.py). Each process's local shard 0 sits on a
    card of its own (NCCL takes one rank a card)."""
    run, skipped = [(1, DIST_P)], []
    if cards >= 2:
        run.append((cards, 1))
    else:
        skipped.append("W = C, L = 1 (one process a card) needs 2 cards or "
                       "more")
    if cards >= 4:
        run.append((2, cards // 2))
    else:
        skipped.append("W = 2, L = C / 2 needs 4 cards or more")
    return run, skipped


def shard_rows(st, local_ranks):
    """{global shard: (k, s, c)} of the shards `local_ranks` that this
    process holds, live rows as numpy."""
    out = {}
    for i, s in enumerate(local_ranks):
        t = st.shards[i].with_num_rows(st.counts[s]).compact()
        out[s] = tuple(t[c].data.cpu().numpy() for c in ("k", "s", "c"))
    return out


def inproc_rows(res):
    """{variant: [(k, s, c) of each shard]} of an in-process run."""
    out = {}
    for name in VARIANTS:
        st = res[name]["result"]
        by_shard = shard_rows(st, range(len(st.shards)))
        out[name] = [by_shard[s] for s in range(len(st.shards))]
    return out


def procs_worker(coord, procs, rank, local, out):
    """One of `procs` processes of the distributed path, `local` shards
    each (parallel/procs.py::join): builds the 10M-row tables on the host
    from the seed and keeps its slabs (distribute_global), plans the three
    variants, runs them once, then times each between barriers on rank
    0's clock with the launch counts reset just before. Rank 0 gathers
    every shard's live (k, s, c) rows (gather_object) into OUT/rows.npz;
    each process writes OUT/stats.<rank>.json."""
    import torch.distributed as dist
    from libgdf_tpu_torch.parallel.distributed import distribute_global

    mesh = procs_mod.join(coord, procs, rank, local)
    cards = torch.cuda.device_count()
    want = [torch.device("cuda", s % cards) for s in mesh.local_ranks]
    if list(mesh.devices) != want:
        fail(f"process {rank}: shards on {mesh.devices}, not {want}")
    fact, dim = make_dist_data(N_DIST, 0)
    n = fact["k"].shape[0]
    t0 = time.perf_counter()
    sf = distribute_global(Table.from_dict(fact, device="cpu"), mesh)
    sd = distribute_global(Table.from_dict(dim, device="cpu"), mesh)
    joins, slots, info = dist_plan(mesh, sf, sd)
    for name in VARIANTS:                                 # warm-up
        dist_run(mesh, sf, joins[name], slots[name])
    setup_s = time.perf_counter() - t0
    for d in dict.fromkeys(mesh.devices):
        torch.cuda.synchronize(d)
        torch.cuda.reset_peak_memory_stats(d)
    kernels.reset_launch_counts()
    stats = {"rank": rank, "devices": [str(d) for d in mesh.devices],
             "setup_s": setup_s, "variants": {}}
    rows = {}
    for name in VARIANTS:
        sync_mesh(mesh)
        procs_mod.host_barrier()
        mesh.exchange.reset()
        t0 = time.perf_counter()
        g = dist_run(mesh, sf, joins[name], slots[name])
        sync_mesh(mesh)
        procs_mod.host_barrier()
        secs = time.perf_counter() - t0
        stats["variants"][name] = {
            "rows": n, "seconds": secs, "groups": int(g.total_rows()),
            "exchange_share": mesh.exchange.seconds / local / secs,
            "exchange_calls": mesh.exchange.calls, **info.get(name, {})}
        rows[name] = shard_rows(g, mesh.local_ranks)
    stats["launches"] = kernels.launch_counts()
    stats["peak_gib"] = {str(d): torch.cuda.max_memory_allocated(d) / 2**30
                         for d in dict.fromkeys(mesh.devices)}
    gathered = [None] * procs if rank == 0 else None
    dist.gather_object(rows, gathered, dst=0)
    if rank == 0:
        np.savez(os.path.join(out, "rows.npz"), **{
            f"{name}.{s}.{c}": arr for part in gathered
            for name, by_shard in part.items()
            for s, cols in by_shard.items()
            for c, arr in zip(("k", "s", "c"), cols)})
    with open(os.path.join(out, f"stats.{rank}.json"), "w") as f:
        json.dump(stats, f)
    procs_mod.host_barrier()
    dist.destroy_process_group()
    return 0


def start_procs(procs, local, out):
    """Run the path's `procs` workers (this file, --procs-worker) through
    parallel/procs.py::start; a worker that exits non-zero or outlives
    PROC_TIMEOUT fails the smoke, and the others are killed. Returns each
    worker's stats, rank by rank."""
    try:
        procs_mod.start(lambda coord, r: [
            sys.executable, os.path.abspath(__file__), "--procs-worker",
            coord, str(procs), str(r), str(local), out], procs, PROC_TIMEOUT)
    except RuntimeError as e:
        fail(f"the workers of {procs} x {local}: {e}")
    stats = []
    for r in range(procs):
        with open(os.path.join(out, f"stats.{r}.json")) as f:
            stats.append(json.load(f))
    return stats


def proc_rows(out, size):
    """{variant: [(k, s, c) of each global shard]} that rank 0 saved."""
    z = np.load(os.path.join(out, "rows.npz"))
    return {name: [tuple(z[f"{name}.{s}.{c}"] for c in ("k", "s", "c"))
                   for s in range(size)]
            for name in VARIANTS}


def rows_table(cols):
    return Table.from_dict(dict(zip(("k", "s", "c"), cols)), device="cpu")


def check_proc_rows(got, ref, abs_by_key, what, inproc=None):
    """Every variant's shards, together and sorted by key, against the
    single-table pipeline; with `inproc` ({variant: [(k, s, c)]} of the
    in-process run of as many shards), also shard by shard. Returns the
    largest sum error."""
    err = 0.0
    for name in VARIANTS:
        t = ops.sort_table(rows_table([np.concatenate(c) for c in zip(
            *got[name])]), ["k"])
        if t.capacity != ref.capacity:
            fail(f"{what} {name}: {t.capacity} groups vs {ref.capacity}")
        err = max(err, check_dist_against(t, ref, abs_by_key,
                                          f"{what} {name}"))
        if inproc is None:
            continue
        if [c[0].shape[0] for c in got[name]] != \
                [c[0].shape[0] for c in inproc[name]]:
            fail(f"{what} {name}: per-shard counts differ from the "
                 f"in-process run")
        for s, (g, w) in enumerate(zip(got[name], inproc[name])):
            check_dist_against(rows_table(g), rows_table(w), abs_by_key,
                               f"{what} {name} shard {s}")
    return err


def run_processes(ref, absref, inproc):
    """The distributed path across processes on this node's cards, for
    each layout of proc_layouts: rank 0's rows/s a variant between
    barriers, each process's exchange share, peak memory and launches
    (compact, scan and seg_scan must launch in every process); every
    variant held to the single-table pipeline (ref, absref), and W = 1,
    L = 8 also shard by shard to the in-process P = 8 run (inproc).
    Returns the launches summed over every process of every layout."""
    kernels.build()                 # the workers only load the library
    cards = torch.cuda.device_count()
    layouts, skipped = proc_layouts(cards)
    for line in skipped:
        print(f"distributed path across processes: {line}: NOT RUN, this "
              f"machine has {cards} card(s)", flush=True)
    abs_by_key = torch.zeros(DIST_KEYS, dtype=torch.float64)
    abs_by_key[ref["k"].data.cpu().long()] = absref.cpu()
    torch.cuda.empty_cache()
    lines = "; ".join(card_lines())
    total = {}
    for procs, local in layouts:
        what = f"W = {procs}, L = {local}"
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as out:
            stats = start_procs(procs, local, out)
            got = proc_rows(out, procs * local)
        wall = time.perf_counter() - t0
        for st in stats:
            missing = [k for k in PROC_KERNELS if st["launches"][k] == 0]
            if missing:
                fail(f"{what}: process {st['rank']} launched no {missing}")
            for k, v in st["launches"].items():
                total[k] = total.get(k, 0) + v
        err = check_proc_rows(got, ref, abs_by_key, what,
                              inproc if (procs, local) == (1, DIST_P)
                              else None)
        for name in VARIANTS:
            r = stats[0]["variants"][name]
            print(f"dist processes {what} {name}: rows={r['rows']} "
                  f"seconds={r['seconds']:.6f} rows_per_s="
                  f"{r['rows'] / r['seconds']:.4e} groups={r['groups']} "
                  f"exchange_share " + "/".join(
                      f"{st['variants'][name]['exchange_share']:.4f}"
                      for st in stats) + f" ({lines})", flush=True)
        for st in stats:
            print(f"dist processes {what} process {st['rank']}: shards on "
                  f"{st['devices']} peak_gib " + " ".join(
                      f"{d}={g:.2f}" for d, g in st["peak_gib"].items()) +
                  " launches " + " ".join(
                      f"{k}={st['launches'][k]}" for k in PROC_KERNELS) +
                  f" setup_s={st['setup_s']:.1f}", flush=True)
        print(f"distributed path across processes, {what}: every variant "
              f"matches the single-table pipeline (sum error {err})" +
              (" and the in-process P = 8 run shard by shard"
               if (procs, local) == (1, DIST_P) else "") +
              f"; {wall:.1f} s with the workers' start", flush=True)
    return total


def check_look_backs_beside_busy_streams(dev):
    """The race checks of H1, H2 and H3 once more, on the caller's stream,
    while DIST_P other streams keep launching the same kernels."""
    rng = np.random.default_rng(3)
    arrays, keep = compact_inputs(rng, dev)
    t0 = time.perf_counter()
    with busy_streams(dev) as rounds:
        before = list(rounds)
        check_compact_look_back(arrays, keep, dev)
        check_look_back(rng, dev)
        check_seg_look_back(rng, dev, profile=False)
        during = [a - b for a, b in zip(rounds, before)]
    if min(during) < 1:
        fail(f"a busy stream made no round during the checks: {during}")
    print(f"look-back race checks of H1-H3 passed beside {len(during)} busy "
          f"streams ({sum(during)} checked rounds of H1-H3 on them meanwhile, "
          f"{min(during)}-{max(during)} a stream; "
          f"{time.perf_counter() - t0:.1f} s)", flush=True)


def dist_reference(data, device):
    """The single-table pipeline on the same data: (groupby of
    filter_table -> join, each group's sum of |v|), both by key."""
    fact, dim = data
    ft = Table.from_dict(fact, device=device)
    j = ops.join(dist_filter(ft), Table.from_dict(dim, device=device),
                 ["k"], ["k"], how="inner")
    g = ops.groupby(j, ["k"], DIST_AGGS).compact()
    absv = j.replace_column("v", j["v"].with_data(j["v"].data.abs()))
    a = ops.groupby(absv, ["k"], [("v", "sum", "s")]).compact()
    return g, a["s"].data.double()


def check_dist_against(got, want, abs_by_key, what):
    """Keys and counts exact, float32 sums within 2e-4 of the group's sum
    of |v| plus 1e-4; returns the largest sum error."""
    exact(got["k"].data.cpu(), want["k"].data.cpu(), f"{what} keys")
    exact(got["c"].data.cpu(), want["c"].data.cpu(), f"{what} counts")
    bound = 2e-4 * abs_by_key[got["k"].data.cpu().long()] + 1e-4
    return close(got["s"].data.cpu().double(), want["s"].data.cpu().double(),
                 bound, f"{what} sums")


def check_dist_path(res, ref, absref, what):
    """Every variant, collected and sorted by key, against the single-table
    pipeline."""
    abs_by_key = torch.zeros(DIST_KEYS, dtype=torch.float64)
    abs_by_key[ref["k"].data.cpu().long()] = absref.cpu()
    err = 0.0
    for name in ("plain", "salted", "broadcast"):
        got = ops.sort_table(par.collect(res[name]["result"]), ["k"])
        if got.capacity != ref.capacity or res[name]["groups"] <= 0:
            fail(f"{what} {name}: {got.capacity} groups vs {ref.capacity}")
        err = max(err, check_dist_against(got, ref, abs_by_key,
                                          f"{what} {name}"))
    return err, abs_by_key


def check_dist_shards(gpu, cpu, abs_by_key):
    """The card's run against the CPU run, shard by shard: capacity,
    per-shard counts and the live rows in order."""
    for name in ("plain", "salted", "broadcast"):
        g, c = gpu[name]["result"], cpu[name]["result"]
        if g.capacity != c.capacity or g.counts.tolist() != c.counts.tolist():
            fail(f"dist {name}: capacity or per-shard counts differ")
        for s, (gs, cs) in enumerate(zip(g.shards, c.shards)):
            k = int(c.counts[s])
            check_dist_against(gs.with_num_rows(k).compact(),
                               cs.with_num_rows(k).compact(), abs_by_key,
                               f"dist {name} shard {s}")


def close(got, want, bound, what):
    """|got - want| <= bound elementwise (NaN equals NaN); max error."""
    if got.shape != want.shape or got.dtype != want.dtype:
        fail(f"{what}: {got.shape}/{got.dtype} vs {want.shape}/{want.dtype}")
    both_nan = torch.isnan(got) & torch.isnan(want)
    diff = torch.where(both_nan | (got == want), 0.0,
                       (got.double() - want.double()).abs())
    if not bool((diff <= bound).all()):
        fail(f"{what}: max error {float(diff.max())} over the bound")
    return float(diff.max()) if diff.numel() else 0.0


def same_column(g, w, what, bound=None):
    """Two Columns: dtype, name and validity exact; the valid rows' values
    exact, or within `bound` (a float or a tensor aligned to the rows)."""
    if g.info != w.info or g.name != w.name or g.size != w.size:
        fail(f"{what}: {g.info}/{g.name}/{g.size} vs "
             f"{w.info}/{w.name}/{w.size}")
    if (g.valid is None) != (w.valid is None):
        fail(f"{what}: one side has no validity mask")
    gd, wd = g.data.cpu(), w.data.cpu()
    if g.valid is not None:
        exact(g.valid.cpu(), w.valid.cpu(), f"{what} validity")
        ok = w.valid.cpu()
        gd = torch.where(ok, gd, torch.zeros_like(gd))
        wd = torch.where(ok, wd, torch.zeros_like(wd))
    if bound is None:
        return exact(gd, wd, what)
    return close(gd, wd, bound, what)


def same_columns(gs, ws, what):
    if len(gs) != len(ws):
        fail(f"{what}: {len(gs)} vs {len(ws)} columns")
    for i, (g, w) in enumerate(zip(gs, ws)):
        same_column(g, w, f"{what}[{i}]")


def check_abi_path(gpu, cpu, c_cpu, data):
    """The card's results against the CPU run's, to the tolerances of the
    module docstring; the CSV columns also against the numbers written."""
    _, csv, hole = data["csv"]
    gt, ct = gpu["read_csv"], cpu["read_csv"]
    same_columns(gt.columns, ct.columns, "read_csv")
    if gpu["csv_categories"] != cpu["csv_categories"] or \
            gt.capacity != N_CSV:
        fail("read_csv: categories or row count")
    for j, name in enumerate(("k", "v", "x", "s")):
        vals, nulls = gt[name].to_numpy_masked()
        if not (nulls == hole[:, j]).all():
            fail(f"read_csv.{name}: null mask")
        if name == "s":
            cats = gpu["csv_categories"]["s"]
            vals = np.asarray([int(w[1:]) for w in cats])[vals]
        if not (vals[~nulls] == csv[name][~nulls]).all():
            fail(f"read_csv.{name}: values")

    for name in ("add_i64", "mul_f32", "floordiv_generic", "cast_f32_to_i32",
                 "validity_and", "order_by", "prefixsum_i64", "hash",
                 "hash_columns"):
        same_column(gpu[name], cpu[name], name)
    x = c_cpu["f64"]
    same_column(gpu["sqrt_f64"], cpu["sqrt_f64"], "sqrt_f64",
                1e-12 * cpu["sqrt_f64"].data.abs().nan_to_num(0.0))
    same_columns(gpu["extract_datetime"], cpu["extract_datetime"],
                 "extract_datetime")
    same_columns(gpu["stencil"], cpu["stencil"], "stencil")
    for name in ("filter", "inner_join", "left_join", "dup_inner_join"):
        same_columns(gpu[name], cpu[name], name)
        if gpu[name][0].size == 0:
            fail(f"{name}: empty")
    if gpu["dup_inner_join"][0].size < 3 * N_FACT:
        fail("dup_inner_join: too few rows")
    if gpu["left_join"][0].size != N_FACT:
        fail("left_join: a probe row is missing")

    absx = Column.from_array(x.data.abs(), valid=x.valid)
    _, abs_sum = gdf.gdf_group_by_sum(1, [c_cpu["key"]], absx)
    count = cpu["group_by_count"][1].data.clamp(min=1).double()
    bounds = {"group_by_sum_f64": 1e-12 * abs_sum.data + 1e-300,
              "group_by_avg": 1e-12 * abs_sum.data / count + 1e-300}
    err = 0.0
    for name in ("group_by_sum_i64", "group_by_sum_f64", "group_by_max_i64",
                 "group_by_avg", "group_by_count"):
        same_columns(gpu[name][0], cpu[name][0], f"{name} keys")
        e = same_column(gpu[name][1], cpu[name][1], name, bounds.get(name))
        err = max(err, e)
        if gpu[name][1].size < N_DIM // 2:
            fail(f"{name}: too few groups")

    for name in ("radixsort_i32", "radixsort_i32_desc",
                 "radixsort_i32_bits_8_24", "segmented_radixsort_i64"):
        same_columns(gpu[name], cpu[name], name)
    keys = gpu["radixsort_i32"][0].data
    if not bool((keys[1:] >= keys[:-1]).all()):
        fail("radixsort_i32: keys not ascending")

    total = float(torch.where(x.valid, x.data.abs(), 0.0).sum())
    gs, cs = (r["reductions"] for r in (gpu, cpu))
    close(gs[0].cpu(), cs[0], 1e-12 * total, "sum_f64")
    exact(gs[1].cpu(), cs[1], "min_i32")
    exact(gs[2].cpu(), cs[2], "max_generic")
    exact(gpu["quantile_exact"].cpu(), cpu["quantile_exact"],
          "quantile_exact")
    same_columns(gpu["hash_partition"][0], cpu["hash_partition"][0],
                 "hash_partition")
    exact(gpu["hash_partition"][1].cpu(), cpu["hash_partition"][1],
          "hash_partition offsets")
    same_column(gpu["window_sum_rows"], cpu["window_sum_rows"],
                "window_sum_rows", 2e-12 * total)
    g, w = gpu["to_csr"], cpu["to_csr"]
    if (g.rows, g.cols, g.dtype, int(g.nnz)) != (w.rows, w.cols, w.dtype,
                                                 int(w.nnz)):
        fail("to_csr: shape or nnz")
    for f in ("A", "IA", "JA"):
        exact(getattr(g, f).cpu(), getattr(w, f), f"to_csr.{f}")
    return err


def check_nvtx_range(dev):
    """A range pushed through the ABI shows by name in a torch.profiler
    trace of the card."""
    from torch.profiler import ProfilerActivity, profile
    a = gdf.gdf_column_view(torch.arange(1 << 20, device=dev))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        gdf.gdf_nvtx_range_push("LIBGDF_ABI_RANGE")
        gdf.gdf_add_i64(a, a)
        torch.cuda.synchronize()
        gdf.gdf_nvtx_range_pop()
    if not any(e.key == "LIBGDF_ABI_RANGE" for e in prof.key_averages()):
        fail("the pushed range is not in the profile")
    print("nvtx: range LIBGDF_ABI_RANGE seen in the torch.profiler trace",
          flush=True)


def busy_union_us(prof):
    """Microseconds in which the device ran at least one activity: the
    union of the intervals of every device event (kernels, copies,
    memsets) of a torch.profiler trace, which a sum of their times
    exceeds where streams overlap."""
    from torch.autograd import DeviceType
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    total, start, end = 0.0, None, None
    for a, b in spans:
        if end is None or a > end:
            if end is not None:
                total += end - start
            start, end = a, b
        else:
            end = max(end, b)
    return total + (end - start if end is not None else 0.0)


def profile_op(fn):
    """torch.profiler over one call of fn after a warm-up: (wall us,
    device busy us, device us in this package's kernels, kernel launches,
    [(kernel, us), ...] top three, device busy us as the union of device
    intervals). The profiler slows the host side, so the busy share is a
    lower bound."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e6
    kern = [(e.key, _device_us(e), e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    kern.sort(key=lambda k: -k[1])
    busy = sum(k[1] for k in kern)
    own = sum(k[1] for k in kern if any(o in k[0] for o in OWN_KERNELS))
    return wall, busy, own, sum(k[2] for k in kern), [
        (k[0][:90], k[1]) for k in kern[:3]], busy_union_us(prof)


def drive(path, run, data, dev, card):
    """Warm up, then run `path` with the launch counts reset just before
    and read just after. Returns (results, times, launches, extra)."""
    t0 = time.perf_counter()
    run(data, dev)                                  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    res = run(data, dev)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    print(f"{path} path launches {launches}", flush=True)
    peak = torch.cuda.max_memory_allocated() / 2**30
    for op, (rows, secs) in res[1].items():
        print(f"op {op}: rows_in={rows} seconds={secs:.6f} "
              f"rows_per_s={rows / secs:.4e} ({card})", flush=True)
    print(f"{path} path peak device memory {peak:.2f} GiB; phase "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return res, launches


# -- the repaired faults (ROADMAP queue C, C3-C7) ----------------------------

N_FAULTS = 1_000_000
# the first NaN of C5's running min, just before and after H3's tile edges
# (4096 8-byte or 8192 4-byte elements)
FAULT_NAN_AT = (4095, 4096, 8191, 8192, 8193, 61 * 8192 - 1)


def fault_values(rng, dtype, n):
    """Zeros, +-denormals, +-finfo.tiny, normal values, NaN and inf."""
    d = 1e-40 if dtype == np.float32 else 1e-310
    tiny = np.finfo(dtype).tiny
    return rng.choice(np.array([0.0, -0.0, d, -d, 2 * d, tiny, -tiny, 1.5,
                                -1.5, 3.0, np.nan, np.inf], dtype), n)


def sum_values(rng, dtype, n):
    """C7's values for sums: zeros, +-denormals and small multiples of a
    unit u = 1024 finfo.tiny. Once the denormals are flushed every sum is
    an exact multiple of u, in any order of addition, and a mean of one is
    no denormal, so the card and the CPU must agree exactly."""
    d = 1e-40 if dtype == np.float32 else 1e-310
    u = np.finfo(dtype).tiny * 1024
    return rng.choice(np.array([0.0, -0.0, d, -d, 2 * d,
                                np.finfo(dtype).smallest_subnormal, u, -u,
                                3 * u], dtype), n)


def fault_cases(seed=0):
    """[(name, run(device) -> tuple of Columns or tensors)] over
    N_FAULTS-row inputs: C3 / C6 / C7 comparisons, div, floordiv, add, sub
    and mul of denormals against the same dtype, the other float dtype and
    int64, both ways round; C4 the identity hash of floats with inf, NaN
    and values past 2^32; C3 the groupby and window min / max of denormals
    (ROW running, ROW over 10,000 rows, RANGE); C7 the sums of denormals
    (the three sum reductions, prefix sums, groupby sum / count / avg and
    avg alone, the window sum, avg, var and count in the three frames, the
    exact quantiles) and the window var / stddev pairs (held by
    same_stddev); C5 the float64 running min with its first NaN at H3's
    tile edges."""
    rng = np.random.default_rng(seed)
    n = N_FAULTS
    out = []
    for dt, other in ((np.float32, np.float64), (np.float64, np.float32)):
        x = fault_values(rng, dt, n)
        for p in (fault_values(rng, dt, n), fault_values(rng, other, n),
                  rng.integers(-3, 4, n)):
            for a, b in ((x, p), (p, x)):
                def run(dev, a=a, b=b):
                    ca, cb = (Column.from_array(v, device=dev)
                              for v in (a, b))
                    return tuple(ops.binary_op(ca, cb, op) for op in
                                 ("eq", "ne", "lt", "le", "gt", "ge", "div",
                                  "floordiv", "add", "sub", "mul"))
                out.append((f"C3/C6/C7 {a.dtype} op {b.dtype}", run))
        h = np.concatenate([[-1.0, -2.5, 5e9, np.inf, -np.inf, np.nan,
                             2.0 ** 32, 4294967040.0],
                            rng.standard_normal(n) * 3e9]).astype(dt)
        out.append((f"C4 identity hash {h.dtype}",
                    lambda dev, h=h: (ops.hash_columns(
                        [torch.as_tensor(h, device=dev)], "identity"),)))
        d = 1e-40 if dt == np.float32 else 1e-310
        cols = {"p": rng.integers(0, 1000, n).astype(np.int32),
                "o": rng.permutation(n).astype(np.int32),
                "v": rng.choice(np.array([d, -d, 2 * d, 0.0, -0.0, 1.0],
                                         dt), n)}
        nulls = {"v": rng.random(n) < 0.1}

        def windows(dev, cols=cols, nulls=nulls):
            W = Table.from_dict(cols, nulls, device=dev)
            aggs = [("v", "min", "lo"), ("v", "max", "hi")]
            g = ops.groupby(W, ["p"], aggs).compact()
            return (*g.columns, *(
                ops.window_function(W, "v", red, partition_by=["p"],
                                    order_by=["o"], **kw)
                for red in ("min", "max")
                for kw in ({}, dict(preceding=10_000),
                           dict(preceding=n // 4, frame="range"))))
        out.append((f"C3 groupby and window min / max {dt.__name__}",
                    windows))
        scols = {"p": cols["p"], "o": cols["o"],
                 "v": sum_values(rng, dt, n)}

        def sums(dev, cols=scols, nulls=nulls):
            W = Table.from_dict(cols, nulls, device=dev)
            v = W["v"]
            g = ops.groupby(W, ["p"], [("v", "sum", "s"), ("v", "count", "c"),
                                       ("v", "avg", "a")]).compact()
            g1 = ops.groupby(W, ["p"], [("v", "avg", "a")]).compact()
            x = Column.from_array(cols["v"], device=dev)
            return (*[ops.reduce(v, op) for op in
                      ("sum", "product", "sum_squared")],
                    ops.prefixsum(x), ops.prefixsum(x, False),
                    *g.columns, *g1.columns,
                    *[ops.quantile_exact(v, q, m) for q in (0.3, 0.5)
                      for m in QMETHODS], *(
                        ops.window_function(W, "v", red, partition_by=["p"],
                                            order_by=["o"], **kw)
                        for red in ("sum", "avg", "var", "count")
                        for kw in ({}, dict(preceding=10_000),
                                   dict(preceding=n // 4, frame="range"))))
        out.append((f"C7 sums of denormals {dt.__name__}", sums))

        def stddevs(dev, cols=scols, nulls=nulls):
            W = Table.from_dict(cols, nulls, device=dev)
            return tuple(ops.window_function(W, "v", red, partition_by=["p"],
                                             order_by=["o"], **kw)
                         for kw in ({}, dict(preceding=10_000),
                                    dict(preceding=n // 4, frame="range"))
                         for red in ("var", "stddev"))
        out.append((f"C7 window stddev of denormals {dt.__name__}", stddevs))
    for at in FAULT_NAN_AT:
        v = rng.standard_normal(n)
        v[at] = np.nan
        cols = {"o": np.arange(n, dtype=np.int32), "v": v}

        def running(dev, cols=cols):
            W = Table.from_dict(cols, device=dev)
            return (ops.window_function(W, "v", "min", order_by=["o"]),)
        out.append((f"C5 running min, first NaN at {at}", running))
    return out


def check_fault_examples(dev):
    """The reference's answers to the faults' examples (ROADMAP queue C),
    on the card."""
    f32 = np.float32

    def col(v, dt):
        return Column.from_array(np.asarray(v, dt), device=dev)

    def same(got, want, what):
        got = got.data if isinstance(got, Column) else got
        exact(got.cpu(), torch.as_tensor(want, dtype=got.dtype), what)

    a, b = col([1e-40, -1e-40, 1e-40], f32), col([0, 0, 2e-40], f32)
    same(gdf.gdf_eq_f32(a, b), [1, 1, 1], "C3 gdf_eq_f32")
    same(ops.binary_op(a, b, "div"), [np.nan] * 3, "C6 div")
    same(ops.binary_op(col([-1e-40], f32), col([3.0], np.float64),
                       "floordiv"), [0.0], "C3 floordiv")
    same(ops.binary_op(col([0], np.int32), col([1e-40], f32), "div"),
         [np.nan], "C6 int / float")
    same(ops.hash_columns([torch.tensor(
        [-1, -2.5, 5e9, np.inf, 1, 2, np.nan], dtype=torch.float64,
        device=dev)], "identity"),
        [0, 0, 4294967295, 4294967295, 1, 2, 0], "C4 identity hash")
    W = Table.from_dict({"o": np.arange(5, dtype=np.int32),
                         "v": np.array([3, np.nan, 1, 2, -1])}, device=dev)
    same(ops.window_function(W, "v", "min", order_by=["o"]),
         [3] + [np.nan] * 4, "C5 running min")
    check_c7_examples(dev, col, same)


# the aggregates each group-by path takes: a min sends a group-by over a
# one-slot key to the sort path
GROUPBY_PATHS = (((), "groupby.dense"), ((("v", "min", "m"),),
                                         "groupby.sort"))


def on_path(path, fn):
    """fn(), a group-by that must take `path` (a tracing counter)."""
    tracing.reset_counters()
    out = fn()
    if tracing.counters().get(path) != 1:
        fail(f"a group-by did not take {path}: {tracing.counters()}")
    return out


def check_c7_examples(dev, col, same):
    """C7: a denormal is zero where it enters arithmetic, a sum or a
    widening; C8: a bitwise op on floats raises TypeError."""
    f32, f64 = np.float32, np.float64
    for a, b, op, want in (
            (col([1e-40], f32), col([0.0], f64), "add", [0.0]),
            (col([1e-45], f32), col([1e300], f64), "mul", [0.0]),
            (col([1e-40], f32), col([1e30], f32), "mul", [0.0]),
            (col([1e308], f64), col([5e-324], f64), "mul", [0.0]),
            (col([1e-40], f32), col([1.2e-38], f32), "add", [1.2e-38])):
        same(ops.binary_op(a, b, op), want,
             f"C7 {a.data.dtype} {op} {b.data.dtype}")
    same(ops.compare_scalar(ops.binary_op(col([1e-40], f32),
                                          col([1e30], f32), "mul"),
                            0.0, "gt"), [0], "C7 1e-40 * 1e30 > 0")
    same(ops.reduce(col([1e-40, 1e30], f32), "product"), 0.0,
         "C7 product")
    for d, dt in ((1e-40, f32), (1e-310, f64)):
        c = col(np.full(300, d), dt)
        same(ops.reduce(c, "sum"), 0.0, f"C7 sum of 300 {d}")
        same(ops.prefixsum(c).data[-1:], [0.0], f"C7 prefixsum of 300 {d}")
        T = Table.from_dict({"k": np.zeros(300, np.int32),
                             "v": np.full(300, d, dt)}, device=dev)
        for extra, path in GROUPBY_PATHS:
            same(on_path(path, lambda: ops.groupby(
                T, ["k"], [("v", "sum", "s"), *extra]))["s"].data[:1],
                [0.0], f"C7 groupby sum of 300 {d} ({path})")
    T = Table.from_dict({"k": np.zeros(2, np.int32),
                         "v": np.full(2, 1e-40, f32)}, device=dev)
    for extra, path in GROUPBY_PATHS:
        same(on_path(path, lambda: ops.groupby(
            T, ["k"], [("v", "avg", "a"), *extra]))["a"].data[:1], [0.0],
            f"C7 groupby avg ({path})")
    W = Table.from_dict({"p": np.zeros(4, np.int32),
                         "o": np.arange(4, dtype=np.int32),
                         "v": np.array([1e-40, 1e-40, -1e-40, 1e-40], f32)},
                        device=dev)
    for red in ("sum", "avg", "var"):
        for kw in ({}, dict(preceding=3), dict(preceding=30, frame="range")):
            same(ops.window_function(W, "v", red, partition_by=["p"],
                                     order_by=["o"], **kw), [0.0] * 4,
                 f"C7 window {red} {kw}")
    q = col([1e-40, 2e-40, 3e-40, 5e-40], f32)
    for m in QMETHODS:
        same(ops.quantile_exact(q, 0.5, m), 0.0, f"C7 quantile {m}")
    for op in ("bitwise_and", "bitwise_or", "bitwise_xor"):
        try:
            ops.binary_op(col([1.0], f32), col([1], np.int32), op)
        except TypeError:
            continue
        fail(f"C8 {op} of a float column did not raise TypeError")


def check_faults(dev, card):
    """C3-C8 on the card: the examples give the reference's answers, and
    every fault case equals the port's CPU run exactly (NaN equals NaN)."""
    t0 = time.perf_counter()
    check_fault_examples(dev)
    cases = fault_cases()
    off = 0
    for name, run in cases:
        got, cpu = run(dev), run(torch.device("cpu"))
        if "stddev" in name:
            off += same_stddev(got, cpu, name)
            continue
        for i, (g, c) in enumerate(zip(got, cpu)):
            if isinstance(g, Column):
                same_column(g, c, f"{name} [{i}]")
            else:
                exact(g.cpu(), c, f"{name} [{i}]")
    torch.cuda.synchronize()
    print(f"faults C3-C7: the examples give the reference's answers (C8's "
          f"bitwise ops on floats raise TypeError) and "
          f"{len(cases)} cases over {N_FAULTS} rows equal the CPU run "
          f"(stddev: numpy's sqrt of the CPU's var exactly, the CPU's own "
          f"1 ulp off it on {off} rows) ({card}; phase "
          f"{time.perf_counter() - t0:.1f} s)", flush=True)


def same_stddev(got, cpu, what):
    """(var, stddev) Column pairs of the card against the CPU run's: var
    exactly; the card's stddev exactly numpy's sqrt of the CPU's var (IEEE
    sqrt, correctly rounded); the CPU's stddev within 1 ulp of that, since
    torch's CPU float64 sqrt is not always correctly rounded. Returns the
    valid rows where the CPU's stddev is off numpy's."""
    off = 0
    for i in range(0, len(got), 2):
        (gv, gs), (cv, cs) = got[i:i + 2], cpu[i:i + 2]
        w = f"{what} [{i // 2}]"
        same_column(gv, cv, f"{w} var")
        with np.errstate(invalid="ignore"):
            root = torch.as_tensor(np.sqrt(cv.data.numpy()))
        ok = cv.valid if cv.valid is not None else torch.ones_like(
            root, dtype=torch.bool)
        exact(torch.where(ok, gs.data.cpu(), 0.0), torch.where(ok, root, 0.0),
              f"{w} stddev against numpy's sqrt of the CPU's var")
        ulp = torch.nextafter(root, torch.full_like(root, math.inf)) - root
        same_column(gs, cs, f"{w} stddev", bound=torch.where(ok, ulp, 0.0))
        off += int((ok & (cs.data != root)).sum())
    return off


# -- the probe path ---------------------------------------------------------

def probe_case(pn, run, plain, moved, shape, *, scale=False, library=None,
               ops=0.0, rows=None, check=None):
    """One run of P-n's kernel: `run` and `plain` give its output and its
    plain version's, `library` (or None) one PyTorch call of the same
    function; `moved` bytes and `ops` 32-bit operations bound it; `rows`
    of the output are specified; `check(output)` is the probe's own
    check."""
    return dict(key=f"{pn}@scale" if scale else pn, pn=pn,
                wrapper=PROBE_SOURCES[pn][0], run=run, plain=plain,
                library=library, moved=moved, ops=ops, rows=rows,
                check=check, shape=shape)


def _tile_sort_check(key):
    kc = key.view(-1, tilesort.BLOCK)

    def check(out):
        ko, po = out
        return torch.equal(ko.view(-1, tilesort.BLOCK),
                           torch.sort(kc, 1).values) and \
            torch.equal(key[po.long()], ko)
    return check


def make_probe_cases(dev, seed=0):
    """Every P-n at its probe's shapes (the probe's own inputs), the
    gathers and the one-hot compaction at the main path's scale, and P-11
    and P-14 at a scale that their bytes bound."""
    def t(a):
        return torch.as_tensor(a, device=dev)

    n = tilesort.DEFAULT_N
    rng = np.random.default_rng(0)              # the probe's keys
    key = t(rng.integers(0, 2 ** 31 - 1, n).astype(np.int32))
    pay = torch.arange(n, dtype=torch.int32, device=dev)
    words = tilesort.pack(key, pay).view(-1, tilesort.BLOCK)
    cases = [probe_case(
        "P-1", lambda: tilesort.tile_sort(key, pay),
        lambda: tilesort.tile_sort_plain(key, pay), 2 * nbytes(key, pay),
        f"{n} int32 key + payload, 64K blocks; library: torch.sort of "
        f"the packed int64 words by block",
        library=lambda: torch.sort(words, dim=1),
        ops=2 * tilesort.stage_counts(tilesort.BLOCK, tilesort.BLOCK)[0]
        * n / 2, check=_tile_sort_check(key))]
    cases[0]["args"] = (key, pay)

    rng = np.random.default_rng(seed)
    names = {"lane": "P-2", "sublane": "P-3"}
    for i, (name, kind, x, idx) in enumerate(gather.probe_inputs()):
        pn = names.get(kind, "P-4" if i == 2 else "P-5")
        fn, plain = gather.GATHERS[kind], gather.PLAIN[kind]
        scale_idx = rng.integers(0, {"lane": 128, "sublane": x.shape[0],
                                     "flat": x.size}[kind],
                                 (GATHER_SCALE_ROWS, 128)).astype(np.int32)
        scale_x = rng.standard_normal((GATHER_SCALE_ROWS, 128)).astype(
            np.float32) if kind == "lane" else x
        for scale, (xv, iv) in ((False, (x, idx)),
                                (True, (scale_x, scale_idx))):
            xt, it = t(xv), t(iv)
            i64 = it.long()
            want = torch.as_tensor(gather.NUMPY[kind](xv, iv))
            lib = {"lane": lambda xt=xt, i64=i64:
                   torch.take_along_dim(xt, i64, 1),
                   "sublane": lambda xt=xt, i64=i64:
                   torch.take_along_dim(xt, i64, 0),
                   "flat": lambda xt=xt, i64=i64: xt.reshape(-1)[i64]}[kind]
            cases.append(probe_case(
                pn, lambda fn=fn, xt=xt, it=it: fn(xt, it),
                lambda plain=plain, xt=xt, it=it: plain(xt, it),
                nbytes(xt, it) + it.numel() * 4,
                f"{name}: x {tuple(xv.shape)} float32, idx "
                f"{tuple(iv.shape)} int32; library: the same call on int64 "
                f"indices", scale=scale, library=lib,
                check=lambda out, want=want: torch.equal(out.cpu(), want)))

    x, s = roll.probe_inputs()
    rx, rs = t(x), t(s)
    for pn, run, plain, shifts in (
            ("P-6", lambda: roll.roll_static(rx),
             lambda: roll.roll_static_plain(rx), roll.static_shifts()),
            ("P-7", lambda: roll.roll_dynamic(rs, rx),
             lambda: roll.roll_dynamic_plain(rs, rx),
             roll.dynamic_shifts(s))):
        want = torch.as_tensor(roll.numpy_roll(x, shifts))
        cases.append(probe_case(
            pn, run, plain, 2 * nbytes(rx) + (pn == "P-7") * nbytes(rs),
            f"{roll.REPS} rolls of int32 (512, 128), each + 1",
            ops=2 * roll.REPS * rx.numel(),
            check=lambda out, want=want: torch.equal(out.cpu(), want)))

    inputs = caps.probe_inputs()
    for pn, name in CAP_PROBES.items():
        _, kernel, plain, rows = caps.PROBES[name]
        args = [t(a) for a in inputs[name]]
        lib = None
        if pn == "P-10":
            def lib(px=args[0], pk=args[1]):
                out = torch.zeros_like(px).view(-1)
                kept = px.view(-1)[pk.view(-1) != 0]
                out[:kept.numel()] = kept
                return out
        elif pn == "P-12":
            lib = lambda px=args[0], i64=args[1].long(): \
                torch.take_along_dim(px, i64, 1)
        elif pn == "P-13":
            lib = lambda px=args[0]: px.sum(dtype=torch.int32)
        out_bytes = {"P-13": 4}.get(pn, nbytes(args[0]))
        # P-11 reads the rows it writes, each once (bulk_sources); P-8
        # reads only x's first STORE_ROWS rows (x[0, 0] among them); P-14
        # the rows its trip count reads (loop_bytes)
        moved = {"P-8": caps.STORE_ROWS * 128 * 4 + out_bytes,
                 "P-11": 2 * caps.bulk_rows(3) * 128 * 4,
                 "P-14": caps.loop_bytes(int(inputs["p7"][0][0, 0]), 128)
                 }.get(pn, nbytes(*args) + out_bytes)
        cases.append(probe_case(
            pn, lambda kernel=kernel, args=args: kernel(*args),
            lambda plain=plain, args=args: plain(*args), moved,
            f"probe_pallas_caps.py {name}: " + ", ".join(
                f"{a.dtype} {tuple(a.shape)}" for a in args),
            library=lib, rows=rows,
            check=lambda out, name=name, rows=rows: caps.probe_check(
                name, out.cpu()[:rows].numpy())))
    m = COMPACT_SCALE_TILES * caps.COMPACT_TILE
    cx = t(rng.integers(-2 ** 31, 2 ** 31, m).astype(np.int32))
    ck = t((rng.random(m) < 0.5).astype(np.int32))
    cases.append(probe_case(
        "P-10", lambda: caps.cap_onehot_compact(cx, ck),
        lambda: caps.cap_onehot_compact_plain(cx, ck), 3 * nbytes(cx),
        f"{COMPACT_SCALE_TILES} tiles of 256 int32, half kept",
        scale=True))
    bx = t(rng.integers(-2 ** 31, 2 ** 31, (8 * BULK_SCALE_STEPS, 128))
           .astype(np.int32))
    rows = caps.bulk_rows(BULK_SCALE_STEPS)
    want = (bx[torch.as_tensor(caps.bulk_sources(BULK_SCALE_STEPS),
                               device=dev)].long() + 1000).to(torch.int32)
    cases.append(probe_case(
        "P-11", lambda: caps.cap_bulk_copy(bx),
        lambda: caps.cap_bulk_copy_plain(bx), 2 * rows * 128 * 4,
        f"{BULK_SCALE_STEPS} steps, int32 {tuple(bx.shape)}, {rows} rows "
        f"written", scale=True, rows=rows,
        check=lambda out, want=want, rows=rows: torch.equal(out[:rows],
                                                            want)))
    lx = torch.ones((caps.LOOP_ROWS, LOOP_SCALE_COLS), dtype=torch.int32,
                    device=dev)
    cases.append(probe_case(
        "P-14", lambda: caps.cap_dyn_loop(lx),
        lambda: caps.cap_dyn_loop_plain(lx),
        caps.loop_bytes(1, LOOP_SCALE_COLS),
        f"int32 {tuple(lx.shape)} of ones, 3 trips", scale=True,
        check=lambda out: bool((out == 3).all())))
    return cases


def run_probe_path(cases):
    """Each case's kernel once, with the launch counts reset just before
    and read just after: (outputs, launches per case, launches per
    wrapper)."""
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    probes.reset_launch_counts()
    outs, per = {}, {}
    for c in cases:
        before = probes.launch_counts()[c["wrapper"]]
        outs[c["key"]] = c["run"]()
        per[c["key"]] = probes.launch_counts()[c["wrapper"]] - before
    torch.cuda.synchronize()
    return outs, per, probes.launch_counts()


def check_probe_path(cases, outs):
    """Each output against its plain version on the card, exactly, over its
    specified rows, and against its probe's own check; {case: error}."""
    errs = {}
    for c in cases:
        got, want = outs[c["key"]], c["plain"]()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        errs[c["key"]] = max(
            exact(g[:c["rows"]], w[:c["rows"]], f"{c['key']} output {i}")
            for i, (g, w) in enumerate(zip(got, want)))
        if c["check"] and not c["check"](got if len(got) > 1 else got[0]):
            fail(f"{c['key']}: the probe's own check failed")
    return errs


def time_probe_case(c, err):
    """Event, profiler, plain and library times of one case, its bound;
    `err` is its error against the plain version. Each wrapper call
    launches one kernel."""
    ms = cuda_ms(c["run"])
    dev_ms, launches, acts = profiled(c["run"], KERNEL_NAMES[c["wrapper"]],
                                      expect=1)
    if launches is not None and launches > 1:
        fail(f"{c['key']}: {launches} launches per call, not 1 ({acts})")
    if launches is not None and launches < 1:
        print(f"{c['key']}: three profiles saw {launches} launches per "
              f"call; device time not measured", flush=True)
        dev_ms = None
    by_bytes = bound_ms(c["moved"])
    by_ops = c["ops"] / SCALAR_OPS_PER_MS
    lib = c["library"]
    return dict(max_abs_err=err, ms=ms, profiler_ms=dev_ms,
                launches_per_call=launches, plain_ms=cuda_ms(c["plain"]),
                library_ms=cuda_ms(lib) if lib else None,
                library_profiler_ms=profiled_ms(lib, ("",)) if lib else None,
                bound_ms=max(by_bytes, by_ops),
                bound_by="bytes" if by_bytes >= by_ops else "operations",
                shape=c["shape"])


# The rolls' floors, built from this source into build/exp/ (not part of
# the package's kernels): one warp's dependent chain of SHFL + IADD steps,
# K independent shuffles a step, timed by the SM's clock and the global
# timer; and an empty kernel, the floor of the launch-bound probes.
FLOOR_SRC = r"""
#include <cuda_runtime.h>

template <int K>
__global__ void shfl_iadd_chain(int n, long long* out, unsigned* sink) {
  unsigned v[K];
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = threadIdx.x + k;
  const int src = (threadIdx.x - 1) & 31;
  unsigned long long t0, t1;
  const long long c0 = clock64();
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t0));
#pragma unroll 1
  for (int i = 0; i < n; i += 8) {
#pragma unroll
    for (int u = 0; u < 8; ++u) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        v[k] = __shfl_sync(0xffffffffu, v[k], src) + 1u;
      }
    }
  }
  unsigned acc = 0;
#pragma unroll
  for (int k = 0; k < K; ++k) acc += v[k];
  sink[threadIdx.x] = acc;                  // the chain ends before c1
  const long long c1 = clock64();
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t1));
  if (threadIdx.x == 0) {
    out[0] = c1 - c0;
    out[1] = (long long)(t1 - t0);
  }
}

__global__ void empty_launch() {}

extern "C" int floor_chain(int chains, int n, void* out, void* sink,
                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  long long* o = static_cast<long long*>(out);
  unsigned* s = static_cast<unsigned*>(sink);
  if (chains == 1) {
    shfl_iadd_chain<1><<<1, 32, 0, st>>>(n, o, s);
  } else {
    shfl_iadd_chain<4><<<1, 32, 0, st>>>(n, o, s);
  }
  return (int)cudaGetLastError();
}

extern "C" int floor_empty(void* stream) {
  empty_launch<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}
"""
FLOOR_STEPS = 65_536
# rotations in one pass of each roll kernel's loop: the static period 7,
# the dynamic probe's 8 shifts
ROLL_LOOP_ROTATIONS = {"roll_static_rows": 7, "roll_dynamic_rows": 8}


def floor_lib():
    """The library of FLOOR_SRC, built by nvcc into build/exp/ unless it
    is there."""
    exp = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                       "exp")
    os.makedirs(exp, exist_ok=True)
    tag = hashlib.sha256(FLOOR_SRC.encode()).hexdigest()[:16]
    so = os.path.join(exp, f"roll_floor_{tag}.so")
    if not os.path.exists(so):
        src = os.path.join(exp, f"roll_floor_{tag}.cu")
        with open(src, "w") as f:
            f.write(FLOOR_SRC)
        subprocess.run([_lib._nvcc(), *_lib.NVCC_FLAGS, "-shared", "-o",
                        so, src], check=True, capture_output=True,
                       timeout=300)
    lib = ctypes.CDLL(so)
    lib.floor_chain.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                                ctypes.c_void_p, ctypes.c_void_p]
    lib.floor_empty.argtypes = [ctypes.c_void_p]
    lib.floor_chain.restype = lib.floor_empty.restype = ctypes.c_int
    return lib


def roll_floors(dev, card):
    """The rolls' chain floor, roll.REPS dependent SHFL + IADD steps of one
    warp (and the step with 4 independent shuffles, as the kernels do), and
    the device and event time of an empty launch."""
    lib = floor_lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    out = torch.zeros(2, dtype=torch.int64, device=dev)
    sink = torch.zeros(32, dtype=torch.int32, device=dev)
    step = {}
    for chains in (1, 4):
        runs = []
        for _ in range(3):
            if lib.floor_chain(chains, FLOOR_STEPS, out.data_ptr(),
                               sink.data_ptr(), stream):
                fail("roll floor: the chain kernel did not launch")
            clocks, ns = out.tolist()
            runs.append((clocks / FLOOR_STEPS, ns / FLOOR_STEPS))
        step[chains] = min(runs, key=lambda r: r[1])
    empty = lambda: lib.floor_empty(stream)
    res = {"chain_clocks": step[1][0], "chain_ns": step[1][1],
           "chain4_clocks": step[4][0], "chain4_ns": step[4][1],
           "chain_floor_ms": roll.REPS * step[1][1] / 1e6,
           "chain4_floor_ms": roll.REPS * step[4][1] / 1e6,
           "sm_ghz": step[1][0] / step[1][1],
           "empty_launch_ms": profiled_ms(empty, ("empty_launch",), 50),
           "empty_launch_event_ms": cuda_ms(empty, 200)}
    print("roll floor: " + " ".join(f"{k}={v}" for k, v in res.items())
          + f" ({card})", flush=True)
    return res


def roll_loop_shuffles():
    """{roll kernel: SHFL instructions in its loop}, from cuobjdump -sass of
    the probes' library: the instructions from the target of the kernel's
    backward branch to the branch. Fails unless each loop pass shuffles 4
    registers a rotation (one rotation a repetition, nothing folded)."""
    cuobjdump = os.path.join(os.path.dirname(_lib._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(_common.LIBRARY.build())],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    instr = re.compile(r"\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?"
                       r"([A-Z0-9_.]+)\s*(0x[0-9a-f]+)?")
    found = {name: [] for name in ROLL_LOOP_ROTATIONS}
    fn = None
    for ln in sass.splitlines():
        if "Function :" in ln:
            fn = next((n for n in found if n in ln), None)
        elif fn and (m := instr.match(ln)):
            found[fn].append((int(m.group(1), 16), m.group(2), m.group(3)))
    counts = {}
    for name, ins in found.items():
        loops = [(int(to, 16), at) for at, op, to in ins
                 if op.startswith("BRA") and to and int(to, 16) < at]
        counts[name] = max((sum(lo <= at <= hi and op.startswith("SHFL")
                                for at, op, _ in ins)
                            for lo, hi in loops), default=0)
        if counts[name] != 4 * ROLL_LOOP_ROTATIONS[name]:
            fail(f"{name}: {counts[name]} SHFL in its loop, not 4 for each "
                 f"of its {ROLL_LOOP_ROTATIONS[name]} rotations")
    print(f"roll SASS: SHFL in each loop pass {counts} for rotations "
          f"{ROLL_LOOP_ROTATIONS} (4 a rotation)", flush=True)
    return counts


def run_probes(dev, card):
    """The probe path: drive, check, time. Returns ({P-n: stats, with the
    main-scale run under "at_scale"}, {P-n: launches on the path})."""
    t0 = time.perf_counter()
    cases = make_probe_cases(dev)
    run_probe_path(cases)                       # warm-up
    outs, per, counts = run_probe_path(cases)
    print(f"probes path launches {counts}", flush=True)
    missing = sorted({c["pn"] for c in cases if per[c["key"]] == 0} |
                     {w for w, k in counts.items() if k == 0})
    if missing:
        fail(f"probe path launched no {missing}")
    errs = check_probe_path(cases, outs)
    del outs
    print(f"probe path: every P-n equals its plain version and passes its "
          f"probe's check ({time.perf_counter() - t0:.1f} s)", flush=True)
    stats, launches = {}, {}
    for c in cases:
        st = time_probe_case(c, errs[c["key"]])
        print(f"kernel {c['key']} {c['wrapper']}: " + " ".join(
            f"{k}={v}" for k, v in st.items() if k != "shape")
            + f" ({st['shape']}; {card})", flush=True)
        launches[c["pn"]] = launches.get(c["pn"], 0) + per[c["key"]]
        if c["key"] == c["pn"]:
            stats[c["pn"]] = st
        else:
            stats[c["pn"]]["at_scale"] = st
    tile_verdict(cases[0], stats["P-1"], card)
    # the kernels' own (profiler) times: at ~0.02 ms a call the events of
    # back-to-back calls time the wrappers' host path as well
    print("roll: " + "; ".join(
        f"{what} static {static * 1e6 / roll.REPS:.2f} ns/roll, dynamic "
        f"{dynamic * 1e6 / roll.REPS:.2f} ns/roll, dynamic/static ratio "
        f"{dynamic / static:.4f}" if static and dynamic else
        f"{what} not measured"
        for what, static, dynamic in (
            ("device", stats["P-6"]["profiler_ms"],
             stats["P-7"]["profiler_ms"]),
            ("events", stats["P-6"]["ms"], stats["P-7"]["ms"])))
        + f" ({card})", flush=True)
    floors = roll_floors(dev, card)
    roll_loop_shuffles()
    for pn in ("P-6", "P-7"):
        stats[pn]["chain_floor_ms"] = floors["chain_floor_ms"]
    print(f"probe path {time.perf_counter() - t0:.1f} s", flush=True)
    return stats, launches


def tile_verdict(case, st, card):
    """The probe's verdict: its full-sort estimate from this block's stage
    counts against the library's whole-array two-operand sort."""
    key, pay = case["args"]
    n = key.shape[0]
    lib_ms = cuda_ms(lambda: tilesort.sort_2op(key, pay))
    pack_ms = cuda_ms(lambda: tilesort.pack(key, pay))
    words = tilesort.pack(key, pay)
    unpack_ms = cuda_ms(lambda: tilesort.unpack(words))
    npad = 1 << (n - 1).bit_length()
    tile_stages, in_block, cross = tilesort.stage_counts(tilesort.BLOCK, npad)
    tile_rate = n / (st["ms"] / 1e3)
    lib_rate = n / (lib_ms / 1e3)
    est = tile_rate * tile_stages / in_block * (n / npad)
    verdict = "keep" if est > tilesort.KEEP_MARGIN * lib_rate else "kill"
    st.update(torch_sort_2op_ms=lib_ms, pack_ms=pack_ms, unpack_ms=unpack_ms,
              full_sort_est_rows_per_s=est, verdict=verdict)
    print(f"tile sort verdict: n={n} tile_sort_ms={st['ms']:.4f} "
          f"tile_sort_rows_per_s={tile_rate:.4e} stages {tile_stages} / "
          f"{in_block} in-block, {cross} cross-block passes (npad {npad}) "
          f"full_sort_est_rows_per_s={est:.4e} torch_sort_2op_ms="
          f"{lib_ms:.4f} torch_sort_2op_rows_per_s={lib_rate:.4e} "
          f"(library by block: {st['library_ms']:.4f} ms, pack "
          f"{pack_ms:.4f} ms, unpack {unpack_ms:.4f} ms) verdict={verdict} "
          f"({card})", flush=True)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--procs-worker"]:
        coord, procs, rank, local, out = argv[1:]
        return procs_worker(coord, int(procs), int(rank), int(local), out)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    if argv[:1] == ["--h8-first-calls"]:
        return h8_first_calls(torch.device("cuda", 0))
    torch.set_num_threads(os.cpu_count() or 1)
    dev = torch.device("cuda", 0)
    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    t0 = time.perf_counter()
    kernels.build()
    kernels.scan("sum", torch.zeros(1, dtype=torch.int32, device=dev))
    torch.cuda.synchronize()
    print(f"build+load {time.perf_counter() - t0:.1f} s", flush=True)

    rng = np.random.default_rng(1)
    stats = {}
    for names, phase in ((("compact",), phase_compact),
                         (("scan",), phase_scan),
                         (("seg_scan",), phase_seg_scan),
                         (("expand_fill",), phase_expand),
                         (("domain_probe", "dense_groupby"), phase_dense),
                         (("wide_groupby",), phase_wide),
                         (("hash_build", "hash_probe"), phase_hash),
                         (("elementwise_binary", "elementwise_compare"),
                          phase_elementwise)):
        t0 = time.perf_counter()
        got = phase(rng, dev)
        stats.update(got if len(names) > 1 else {names[0]: got})
        for name in names:
            st = stats[name]
            print(f"kernel {name}: max_abs_err={st['max_abs_err']} "
                  f"ms={st['ms']:.4f} profiler_ms={st['profiler_ms']} "
                  f"host_ms={st['host_ms']:.4f} "
                  f"plain_ms={st['plain_ms']:.4f} "
                  f"bound_ms={st['bound_ms']:.4f} ({st['shape']}; {card}; "
                  f"phase {time.perf_counter() - t0:.1f} s)", flush=True)

    check_faults(dev, card)

    data = make_data(0)
    (gpu, times), launches = drive("main", run_main_path, data, dev, card)
    missing = [k for k in MAIN_KERNELS if launches[k] == 0]
    if missing:
        fail(f"main path launched no {missing}")
    t0 = time.perf_counter()
    cpu, _ = run_main_path(data, torch.device("cpu"))
    print(f"cpu run of the main path {time.perf_counter() - t0:.1f} s",
          flush=True)
    check_main_path(gpu, cpu, dev)
    print("main path: GPU results match the CPU run", flush=True)
    del gpu, cpu

    qdata = make_q1_data(0)
    (qgpu, qtimes), qlaunches = drive("dense", run_dense_path, qdata, dev,
                                      card)
    if (qlaunches["domain_probe"], qlaunches["dense_groupby"],
            qlaunches["seg_scan"]) != (1, 1, 0):
        fail(f"dense path: not one probe and one H5 launch, no scan "
             f"({qlaunches})")
    qcpu, _ = run_dense_path(qdata, torch.device("cpu"))
    check_dense_path(qgpu, qcpu)
    print("dense path: GPU results match the CPU run", flush=True)
    del qgpu, qcpu, qdata

    adata = make_analytic_data(0)
    (agpu, atimes, W), alaunches = drive("analytic", run_analytic_path,
                                         adata, dev, card)
    missing = [k for k in ANALYTIC_KERNELS if alaunches.get(k, 0) == 0]
    if missing:
        fail(f"analytic path launched no {missing}")
    for name, red, prec, pb, frame in (WINDOWS[1], WINDOWS[4]):
        wall, busy, own, nk, top, _ = profile_op(lambda: ops.window_function(
            W, "v", red, preceding=prec, partition_by=pb, order_by=["o"],
            frame=frame))
        print(f"profile {name}: wall_us={wall:.1f} device_busy_us="
              f"{busy:.1f} share={busy / wall:.4f} own_kernels_us={own:.1f} "
              f"kernels={nk} top={top} ({card})", flush=True)
    del W
    t0 = time.perf_counter()
    acpu, _, W_cpu = run_analytic_path(adata, torch.device("cpu"))
    print(f"cpu run of the analytic path {time.perf_counter() - t0:.1f} s",
          flush=True)
    t0 = time.perf_counter()
    check_analytic_path(agpu, acpu, W_cpu)
    print(f"analytic path: GPU results match the CPU run "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)

    del agpu, acpu, W_cpu

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        bdata = make_abi_data(os.path.join(tmp, "abi.csv"), 0)
        print(f"abi data and csv file {time.perf_counter() - t0:.1f} s",
              flush=True)
        (bgpu, btimes, _), blaunches = drive("abi", run_abi_path, bdata,
                                              dev, card)
        t0 = time.perf_counter()
        bcpu, _, c_cpu = run_abi_path(bdata, torch.device("cpu"))
        print(f"cpu run of the abi path {time.perf_counter() - t0:.1f} s",
              flush=True)
    missing = [k for k in ABI_KERNELS if blaunches.get(k, 0) == 0]
    if missing:
        fail(f"abi path launched no {missing}")
    if bgpu["read_csv"].device.type != "cuda":
        fail("read_csv did not land on the card")
    print(f"abi read_csv: scanner={bgpu['csv_scanner']} (cpu run: "
          f"{bcpu['csv_scanner']}); rmm log {bgpu['rmm_log']}", flush=True)
    t0 = time.perf_counter()
    err = check_abi_path(bgpu, bcpu, c_cpu, bdata)
    print(f"abi path: GPU results match the CPU run (group sums max error "
          f"{err}; {time.perf_counter() - t0:.1f} s)", flush=True)
    del bgpu, bcpu, c_cpu, bdata
    check_nvtx_range(dev)

    t0 = time.perf_counter()
    ddata = make_dist_data(N_DIST, 0)
    print(f"distributed data {time.perf_counter() - t0:.1f} s; "
          f"torch.cuda.device_count() = {torch.cuda.device_count()}",
          flush=True)
    (dgpu, dtimes), dlaunches = drive("distributed", run_dist_path, ddata,
                                      dev, card)
    missing = [k for k in DIST_KERNELS if dlaunches.get(k, 0) == 0]
    if missing:
        fail(f"distributed path launched no {missing}")
    print(f"distributed path: seg_scan dtypes "
          f"{sorted(k for k in dlaunches if k.startswith('seg_scan['))}, "
          f"expand_fill {dlaunches['expand_fill']} (the local joins' "
          f"general path runs only on repeated build keys)", flush=True)
    print(f"dist skew_max_over_mean={dgpu['skew_max_over_mean']:.4f} "
          f"(detect_skew, {DIST_P} bins)", flush=True)
    for name in ("plain", "salted", "broadcast"):
        r = dgpu[name]
        rows, secs = dtimes[f"dist_{name}"]
        print(f"dist {name}: rows={rows} seconds={secs:.6f} rows_per_s="
              f"{rows / secs:.4e} groups={r['groups']} " + " ".join(
                  f"{k}={v}" for k, v in r.items()
                  if k not in ("result", "groups")) + f" ({card})",
              flush=True)
    # the same 10M rows on one shard
    for _ in range(2):
        _, one = run_dist_path(ddata, dev, shards=1)
    print("dist on one shard: " + dist_rates(one) + f" ({card})", flush=True)
    t0 = time.perf_counter()
    ref, absref = dist_reference(ddata, dev)
    err, _ = check_dist_path(dgpu, ref, absref, "dist 10M")
    print(f"distributed path: the three variants at {N_DIST} rows match the "
          f"single-table pipeline on the card (sum error {err}; "
          f"{time.perf_counter() - t0:.1f} s)", flush=True)
    inproc = inproc_rows(dgpu)
    del dgpu
    compare_stream_modes(ddata, dev, card)
    check_dist_races(ddata, dev)
    check_look_backs_beside_busy_streams(dev)
    run_across_cards(ddata, ref, absref)
    del ddata
    glaunches = run_processes(ref, absref, inproc)
    del ref, absref, inproc
    t0 = time.perf_counter()
    small = make_dist_data(N_DIST_CPU, 1)
    sgpu, _ = run_dist_path(small, dev)
    scpu, _ = run_dist_path(small, torch.device("cpu"))
    print(f"distributed path at {N_DIST_CPU} rows, card and cpu "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    ref, absref = dist_reference(small, torch.device("cpu"))
    _, abs_by_key = check_dist_path(scpu, ref, absref, "dist 1M cpu")
    check_dist_shards(sgpu, scpu, abs_by_key)
    print("distributed path: GPU results at 1M rows match the CPU run shard "
          "by shard", flush=True)
    del sgpu, scpu, small

    pstats, plaunches = run_probes(dev, card)

    pipeline = {op: {"rows_in": rows, "seconds": secs,
                     "rows_per_s": rows / secs}
                for op, (rows, secs) in {**times, **qtimes, **atimes,
                                         **btimes, **dtimes}.items()}
    print(json.dumps({"pipeline": pipeline, "card": card}), flush=True)
    paths = {"main": launches, "dense": qlaunches, "analytic": alaunches,
             "abi": blaunches, "distributed": dlaunches,
             "processes": glaunches}
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name][0],
         "replaces": SOURCES[name][1],
         "launches": sum(p[name] for p in paths.values()),
         "launches_by_path": {
             path: {k: v for k, v in p.items() if k.split("[")[0] == name}
             for path, p in paths.items()},
         **{k: v for k, v in stats[name].items() if k != "shape"}}
        for name in SOURCES] + [
        {"name": f"{pn} {wrapper}", "route": "cuda", "source": source,
         "replaces": replaces, "launches": plaunches[pn], **pstats[pn]}
        for pn, (wrapper, source, replaces) in PROBE_SOURCES.items()]}),
        flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
