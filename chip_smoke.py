#!/usr/bin/env python3
"""Smoke test of libgdf_tpu_torch on one NVIDIA Hopper GPU.

Run from the root of a checkout, on a machine with the card and nvcc:

    python3 chip_smoke.py

1. Requires CUDA and prints the card's name and power limit.
2. Builds the kernels from libgdf_tpu_torch/csrc with nvcc (sm_90a).
3. Holds each kernel (H1 compact, H2 scan, H3 seg_scan, H4 expand_fill) to
   its plain PyTorch version on CUDA tensors, at the main path's sizes and
   at ragged and edge sizes, and times both with CUDA events.
4. Drives the main path at full size: a 10M-row fact table against a
   1M-row dimension, filter -> inner join -> groupby -> order_by, then a
   10M x 1M inner join whose build side repeats each key 4 times. The
   kernels' launch counts are reset just before that run and read just
   after it; every kernel must have launched. Each operator is timed, and
   each result is held to the same code run on CPU tensors.
5. Prints a JSON line of the kernels, the card line, and last
   {"ok": true, "device": {...}}.

Tolerances: integers, counts, validity and row order exact; float32 sums
within 2e-4 and float64 sums within 1e-12 of the running sum of |x| (the
kernel adds in another order than the plain version); groupby float32 sums
and averages rtol=1e-4, atol=1e-4. Any failed check raises, so the exit
code is non-zero and the last line is not printed.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from libgdf_tpu_torch import Table, ops
from libgdf_tpu_torch.ops import kernels

SOURCES = {
    "compact": ("libgdf_tpu_torch/csrc/compact.cu",
                "libgdf_tpu/ops/pallas/compact.py:371; "
                "libgdf_tpu/ops/pallas/compact2.py:177"),
    "scan": ("libgdf_tpu_torch/csrc/scan.cu",
             "libgdf_tpu/ops/pallas/scan.py:754"),
    "seg_scan": ("libgdf_tpu_torch/csrc/scan.cu",
                 "libgdf_tpu/ops/pallas/scan.py:783; scan.py:692; "
                 "scan.py:456; scan.py:610"),
    "expand_fill": ("libgdf_tpu_torch/csrc/expand.cu",
                    "libgdf_tpu/ops/pallas/expand.py:210"),
}
REL = {torch.float32: 2e-4, torch.float64: 1e-12}
EDGE_SIZES = (1, 2047, 2048, 2049, 100_003)
N_FACT, N_DIM, MULT = 10_000_000, 1_000_000, 4
AGGS = [("v", "sum", "s"), ("v", "count", "c"), ("v", "avg", "a"),
        ("w", "max", "hi")]
GB_TOL = {"s": (1e-4, 1e-4), "a": (1e-4, 1e-4)}


def fail(msg):
    raise RuntimeError(msg)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


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


def phase_compact(rng, dev):
    n = N_FACT
    keep = torch.as_tensor(rng.random(n) < 0.45, device=dev)
    arrays = [torch.as_tensor(rng.integers(0, N_DIM, n), device=dev),
              torch.as_tensor(rng.random(n) < 0.95, device=dev),
              torch.as_tensor(rng.standard_normal(n).astype(np.float32),
                              device=dev),
              torch.as_tensor(rng.random(n) < 0.9, device=dev)]
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
    ms = cuda_ms(lambda: kernels.compact(arrays, keep))
    plain = cuda_ms(lambda: kernels.compact_plain(arrays, keep))
    return dict(max_abs_err=0.0, ms=ms, plain_ms=plain,
                shape=f"10M rows, int64+bool+float32+bool, 45% kept")


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
    x = _values(rng, n, torch.int32, dev)
    ms = cuda_ms(lambda: kernels.scan("sum", x))
    plain = cuda_ms(lambda: kernels.scan_plain("sum", x))
    return dict(max_abs_err=err, ms=ms, plain_ms=plain,
                shape="11M int32 sum")


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
    x = _values(rng, n, torch.float32, dev)
    f = torch.as_tensor(rng.random(n) < 0.25, device=dev)
    ms = cuda_ms(lambda: kernels.seg_scan("sum", f, x))
    plain = cuda_ms(lambda: kernels.seg_scan_plain("sum", f, x))
    return dict(max_abs_err=err, ms=ms, plain_ms=plain,
                shape="11M float32 segmented sum, groups of ~4")


def phase_expand(rng, dev):
    cases = []
    for cap, nsrc in [(N_FACT * MULT, N_FACT), (1, 1), (2049, 300),
                      (100_003, 90_000), (5000, 0)]:
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
    plain = cuda_ms(lambda: kernels.expand_fill_plain(pos, words, cap))
    return dict(max_abs_err=0.0, ms=ms, plain_ms=plain,
                shape="40M slots from 10M sources, 3 int32 words")


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


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
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
    for name, phase in (("compact", phase_compact), ("scan", phase_scan),
                        ("seg_scan", phase_seg_scan),
                        ("expand_fill", phase_expand)):
        t0 = time.perf_counter()
        stats[name] = phase(rng, dev)
        st = stats[name]
        print(f"kernel {name}: max_abs_err={st['max_abs_err']} "
              f"ms={st['ms']:.4f} plain_ms={st['plain_ms']:.4f} "
              f"({st['shape']}; {card}; phase "
              f"{time.perf_counter() - t0:.1f} s)", flush=True)

    data = make_data(0)
    run_main_path(data, dev)                       # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    gpu, times = run_main_path(data, dev)
    launches = kernels.launch_counts()
    print(f"launches {launches}", flush=True)
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        fail(f"main path launched no {missing}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    for op, (rows, secs) in times.items():
        print(f"op {op}: rows_in={rows} seconds={secs:.6f} "
              f"rows_per_s={rows / secs:.4e} ({card})", flush=True)
    print(f"peak device memory {peak:.2f} GiB", flush=True)

    t0 = time.perf_counter()
    cpu, cpu_times = run_main_path(data, torch.device("cpu"))
    print(f"cpu run of the main path {time.perf_counter() - t0:.1f} s",
          flush=True)
    check_main_path(gpu, cpu, dev)
    print("main path: GPU results match the CPU run", flush=True)

    pipeline = {op: {"rows_in": rows, "seconds": secs,
                     "rows_per_s": rows / secs}
                for op, (rows, secs) in times.items()}
    print(json.dumps({"pipeline": pipeline, "card": card}), flush=True)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name][0],
         "replaces": SOURCES[name][1], "launches": launches[name],
         "max_abs_err": stats[name]["max_abs_err"],
         "ms": stats[name]["ms"], "plain_ms": stats[name]["plain_ms"]}
        for name in SOURCES]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
