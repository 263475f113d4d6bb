"""Time probe kernels of this checkout and of another one in turns, on one card.

    python -m libgdf_tpu_torch.probes.turns OTHER [--reps 20] [--rounds 2]
        [--cases P-1,P-10,W,F]

OTHER is an unpacked copy of another commit (for the parent:
`git archive HEAD`) in a git-ignored directory such as `build/parent`. Its
package is imported whole under another name, so its own wrappers call
its own kernel library with its own C signatures; that library is built
from OTHER/libgdf_tpu_torch/csrc into OTHER/build/kernels.

The cases, on the inputs of `chip_smoke.py`'s probe path: P-1
(`tile_sort` of 11,534,336 pairs), P-3 (`sublane_gather`), P-4
(`flat_take` of the 64K table) and P-5 (`flat_take` of the (512, 128)
table) at the probe's own shapes and at 81,920 x 128 indices, P-6 and P-7
(`roll_static`, `roll_dynamic`: 1024 rotations of the probe's (512, 128)
block), P-8 (`cap_dyn_store` of the probe's (16, 128) zeros), P-9
(`cap_cumsum2d` of the probe's (64, 128) ones), P-10
(`cap_onehot_compact`) at the probe's 256 elements and at 40,960 tiles
of 256, P-11 (`cap_bulk_copy`, its written rows) at the probe's 3 steps
and at 1000 steps of random int32, P-13 (`cap_carry`) at the probe's 4
tiles of ones and at 1000 tiles of random int32, and H2 and H3's float64
sums at the shapes of `chip_smoke.py`'s kernel phases (K5a: `scan` of 10M
standard normals; K5b: `seg_scan` of 10M with a head every ~4 rows), with
the denormal flush folded into the load, against the other build's (which
has none when it predates the flush). `--cases` keeps those whose name
(before any "@") is listed.
Both builds must equal the plain version exactly (the float sums within
1e-12 of the running sum of |x|: the kernels add in another order). Then, per
round, the two are timed in turns (other, this, this, other): CUDA-event
ms per call over `reps` back-to-back calls, and device ms per call from
torch.profiler over every activity in the window and over its kernels
alone (`kernel_ms`: without the scans' scratch memset and P-8's host
read of x[0, 0]), with the activities the profile saw per call (a
profile that drops records shows fewer than the build launches). The plain version and the library call are timed once:
for the gathers `torch.take_along_dim`, or indexing, on int64 indices;
for P-1 `torch.sort` of the packed words by block; for P-10 `x[keep]`
padded with zeros; for the rolls one `torch.roll(x, 1, 1)`, a single
rotation, so its times are also given times the repetitions
(`library_x_reps`: no one PyTorch call computes the probe's chain of
rotations without folding it); for P-9 one `torch.cumsum(x, 0)`, given
times 2 (the function is that cumsum and another over axis 1); for P-13
`x.sum(dtype=torch.int32)`. The bound is the bytes read once and
written once over the H100's 3.35 TB/s or, for the rolls, the 32-bit
operations (a move and an add an element a repetition) over its 67 T/s,
whichever is larger. Case W times, in the same turns, the analytic
path's `window_min_rows` and `window_max_range` of both builds on
chip_smoke.py's 10M-row table W (host clock around a call ending in a
device sync, as chip_smoke.py's rows/s), after checking that the two
builds' outputs are equal. Case F times in the same way the operators
whose float inputs the denormal flush reads: `prefixsum` of W's float64
column, the ROW sum, running avg and RANGE sum windows of W, the main
path's groupby (sum / count / avg over the float32 value with 10% NULL,
on the filter -> join output of chip_smoke.py's 10M x 1M tables) and the
five reductions of W's value (the two builds' outputs equal within
FLUSH_TOL: their float sums add in another order). It prints the card
line, one line per case and a JSON line of every number; it exits 1
without CUDA or if a check fails.
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

import libgdf_tpu_torch
from . import caps, gather, roll, tilesort

HBM_BYTES_PER_MS = 3.35e12 / 1e3        # H100 SXM data sheet, at 700 W
SCALAR_OPS_PER_MS = 67e12 / 1e3          # 32-bit, outside the tensor cores
SCALE_ROWS = 81_920
N_W = 10_000_000
N_FACT, N_DIM = 10_000_000, 1_000_000       # chip_smoke.py's main path
SCALE_STEPS = 1000                          # P-11@scale
REL_F64 = 1e-12     # a float64 sum against the running sum of |x|
# the builds' flushed operators against each other: float32 sums (a group's,
# a reduction's) add in another order from run to run
FLUSH_TOL = (1e-5, 1e-6)
# chip_smoke.py's window_min_rows and window_max_range
WINDOWS = {"window_min_rows": dict(reduction="min", preceding=10_000),
           "window_max_range": dict(reduction="max", preceding=N_W // 4,
                                    frame="range")}
COMPACT_SCALE_TILES = 40_960
LIBRARY = {"sublane": lambda x, i64: torch.take_along_dim(x, i64, 0),
           "flat": lambda t, i64: t.reshape(-1)[i64]}


def other_probes(root: Path) -> dict:
    """{module: the module of `probes` of the package under `root`}, the
    package imported as `libgdf_tpu_torch_other`."""
    name = "libgdf_tpu_torch_other"
    init = root / "libgdf_tpu_torch" / "__init__.py"
    spec = importlib.util.spec_from_file_location(
        name, init, submodule_search_locations=[str(init.parent)])
    pkg = importlib.util.module_from_spec(spec)
    sys.modules[name] = pkg
    spec.loader.exec_module(pkg)
    mods = {mod: importlib.import_module(f"{name}.probes.{mod}")
            for mod in ("caps", "gather", "roll", "tilesort")}
    return {**mods, "pkg": pkg}


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _case(key, shapes, this, other, plain, library, moved, ops=0,
          library_x=1, bound_abs=None):
    """`library` may be None (no one PyTorch call computes the function);
    `library_x`: how many library calls one call of the kernel is worth
    (the rolls' single rotation against the kernel's `roll.REPS`);
    `bound_abs`: for a float sum, the running sum of |x| that bounds its
    error (else the builds must equal the plain version exactly)."""
    return {"key": key, "shapes": shapes, "this": this, "other": other,
            "plain": plain, "library": library, "library_x": library_x,
            "bound_abs": bound_abs,
            "bound_ms": max(moved / HBM_BYTES_PER_MS,
                            ops / SCALAR_OPS_PER_MS)}


def cases(dev: torch.device, old: dict, seed: int = 0) -> list:
    """P-1, the gathers P-3, P-4, P-5, the rolls P-6, P-7, P-8, P-9, P-10,
    P-11 and P-13, drawn as chip_smoke.py's probe path draws them (the
    lane gather's draws included, then dropped; P-13's 1000 tiles, then
    P-11's 1000 steps, then H2's and H3's float64 sums last)."""
    out = []
    n = tilesort.DEFAULT_N
    key = torch.as_tensor(np.random.default_rng(0).integers(
        0, 2 ** 31 - 1, n).astype(np.int32), device=dev)
    pay = torch.arange(n, dtype=torch.int32, device=dev)
    words = tilesort.pack(key, pay).view(-1, tilesort.BLOCK)
    out.append(_case(
        "P-1", f"{n} int32 key + payload",
        lambda: tilesort.tile_sort(key, pay),
        lambda f=old["tilesort"].tile_sort: f(key, pay),
        lambda: tilesort.tile_sort_plain(key, pay),
        lambda: torch.sort(words, dim=1), 2 * _nbytes(key, pay)))

    rng = np.random.default_rng(seed)
    for i, (_, kind, x, idx) in enumerate(gather.probe_inputs()):
        size = {"lane": 128, "sublane": x.shape[0], "flat": x.size}[kind]
        big = rng.integers(0, size, (SCALE_ROWS, 128)).astype(np.int32)
        if kind == "lane":
            rng.standard_normal((SCALE_ROWS, 128))
            continue
        pn = "P-3" if kind == "sublane" else "P-4" if i == 2 else "P-5"
        xt = torch.as_tensor(x, device=dev)
        for k, it in ((pn, torch.as_tensor(idx, device=dev)),
                      (f"{pn}@scale", torch.as_tensor(big, device=dev))):
            i64 = it.long()
            out.append(_case(
                k, f"x {tuple(xt.shape)}, idx {tuple(it.shape)}",
                lambda f=gather.GATHERS[kind], xt=xt, it=it: f(xt, it),
                lambda f=old["gather"].GATHERS[kind], xt=xt, it=it:
                f(xt, it),
                lambda f=gather.PLAIN[kind], xt=xt, it=it: f(xt, it),
                lambda f=LIBRARY[kind], xt=xt, i64=i64: f(xt, i64),
                _nbytes(xt) + 2 * _nbytes(it)))

    x, s = roll.probe_inputs()
    rx, rs = torch.as_tensor(x, device=dev), torch.as_tensor(s, device=dev)
    shapes = f"{roll.REPS} rolls of int32 {tuple(x.shape)}, each + 1"
    one_roll = lambda: torch.roll(rx, 1, 1)
    out.append(_case(
        "P-6", shapes, lambda: roll.roll_static(rx),
        lambda f=old["roll"].roll_static: f(rx),
        lambda: roll.roll_static_plain(rx), one_roll,
        2 * _nbytes(rx), 2 * roll.REPS * rx.numel(), roll.REPS))
    out.append(_case(
        "P-7", shapes, lambda: roll.roll_dynamic(rs, rx),
        lambda f=old["roll"].roll_dynamic: f(rs, rx),
        lambda: roll.roll_dynamic_plain(rs, rx), one_roll,
        2 * _nbytes(rx) + _nbytes(rs), 2 * roll.REPS * rx.numel(),
        roll.REPS))

    inputs = caps.probe_inputs()
    t1 = torch.as_tensor(inputs["p1"][0], device=dev)
    out.append(_case(
        "P-8", f"int32 {tuple(t1.shape)}", lambda: caps.cap_dyn_store(t1),
        lambda f=old["caps"].cap_dyn_store: f(t1),
        lambda: caps.cap_dyn_store_plain(t1), None,
        # x's first STORE_ROWS rows read (x[0, 0] among them), out written
        (caps.STORE_ROWS * t1.shape[1] + t1.numel()) * 4))
    t2 = torch.as_tensor(inputs["p2"][0], device=dev)
    out.append(_case(
        "P-9", f"int32 {tuple(t2.shape)}", lambda: caps.cap_cumsum2d(t2),
        lambda f=old["caps"].cap_cumsum2d: f(t2),
        lambda: caps.cap_cumsum2d_plain(t2),
        lambda: torch.cumsum(t2, 0, dtype=torch.int32), 2 * _nbytes(t2),
        library_x=2))

    px, pk = (torch.as_tensor(a, device=dev) for a in inputs["p3"])
    m = COMPACT_SCALE_TILES * caps.COMPACT_TILE
    cx = torch.as_tensor(rng.integers(-2 ** 31, 2 ** 31, m).astype(np.int32),
                         device=dev)
    ck = torch.as_tensor((rng.random(m) < 0.5).astype(np.int32), device=dev)
    for k, x, keep in (("P-10", px, pk), ("P-10@scale", cx, ck)):
        def library(x=x, keep=keep):
            got = torch.zeros_like(x).view(-1)
            kept = x.view(-1)[keep.view(-1) != 0]
            got[:kept.numel()] = kept
            return got
        out.append(_case(
            k, f"x, keep {tuple(x.shape)} int32",
            lambda x=x, keep=keep: caps.cap_onehot_compact(x, keep),
            lambda f=old["caps"].cap_onehot_compact, x=x, keep=keep:
            f(x, keep),
            lambda x=x, keep=keep: caps.cap_onehot_compact_plain(x, keep),
            library, 3 * _nbytes(x)))

    big = rng.integers(-2 ** 31, 2 ** 31, (8 * 1000, caps.LANES))
    for k, x in (("P-13", torch.as_tensor(inputs["p6"][0], device=dev)),
                 ("P-13@scale", torch.as_tensor(big.astype(np.int32),
                                                device=dev))):
        out.append(_case(
            k, f"int32 {tuple(x.shape)}", lambda x=x: caps.cap_carry(x),
            lambda f=old["caps"].cap_carry, x=x: f(x),
            lambda x=x: caps.cap_carry_plain(x),
            lambda x=x: x.sum(dtype=torch.int32), _nbytes(x) + 4))

    big = rng.integers(-2 ** 31, 2 ** 31, (8 * SCALE_STEPS, caps.LANES))
    for k, x in (("P-11", torch.as_tensor(inputs["p4"][0], device=dev)),
                 ("P-11@scale", torch.as_tensor(big.astype(np.int32),
                                                device=dev))):
        r = caps.bulk_rows(x.shape[0] // caps.STEP_ROWS)
        out.append(_case(
            k, f"int32 {tuple(x.shape)}, {r} rows written",
            lambda x=x, r=r: caps.cap_bulk_copy(x)[:r],
            lambda f=old["caps"].cap_bulk_copy, x=x, r=r: f(x)[:r],
            lambda x=x, r=r: caps.cap_bulk_copy_plain(x)[:r], None,
            2 * r * caps.LANES * 4))
    out += flush_cases(dev, old)
    return out


def flush_cases(dev: torch.device, old: dict) -> list:
    """H2 (K5a) and H3 (K5b) float64 sums over 10M standard normals, this
    build's (the denormal flush folded into the load) against the other
    build's (none in a build that predates it); the values drawn as
    chip_smoke.py's kernel phases draw theirs."""
    from ..ops import kernels
    other = old["pkg"].ops.kernels
    rng = np.random.default_rng(1)
    x = torch.as_tensor(rng.standard_normal(N_W), device=dev)
    f = torch.as_tensor(rng.random(N_W) < 0.25, device=dev)
    return [
        _case("K5a", f"{N_W} float64 inclusive sum",
              lambda: kernels.scan("sum", x), lambda: other.scan("sum", x),
              lambda: kernels.scan_plain("sum", x),
              lambda: torch.cumsum(x, 0), 2 * _nbytes(x),
              bound_abs=torch.cumsum(x.abs(), 0)),
        _case("K5b", f"{N_W} float64 segmented sum, groups of ~4",
              lambda: kernels.seg_scan("sum", f, x),
              lambda: other.seg_scan("sum", f, x),
              lambda: kernels.seg_scan_plain("sum", f, x), None,
              _nbytes(f) + 2 * _nbytes(x),
              bound_abs=kernels.seg_scan_plain("sum", f, x.abs()))]


def window_runs(dev: torch.device, this_pkg, other_pkg) -> dict:
    """{window: (this run, other run)} for the analytic path's two windows
    whose min / max flush their values (chip_smoke.py's WINDOWS), on its
    table W: 10M rows drawn as chip_smoke.make_analytic_data draws them
    (50 partitions, a permuted order key, a float32 value with 10% NULL)."""
    n = N_W
    rng = np.random.default_rng(0)
    cols = {"p": rng.integers(0, 50, n).astype(np.int32),
            "o": rng.permutation(n).astype(np.int32),
            "v": rng.standard_normal(n).astype(np.float32)}
    rng.integers(-2 ** 40, 2 ** 40, n)          # W's q and x, not used
    rng.standard_normal(n)
    nulls = {"v": rng.random(n) < 0.10}
    runs = {}
    for pkg, who in ((other_pkg, 1), (this_pkg, 0)):
        W = pkg.Table.from_dict(cols, nulls, device=dev)
        for name, kw in WINDOWS.items():
            runs.setdefault(name, [None, None])[who] = (
                lambda pkg=pkg, W=W, kw=kw: pkg.ops.window_function(
                    W, "v", order_by=["o"], partition_by=["p"], **kw))
    return runs


def flush_runs(dev: torch.device, this_pkg, other_pkg) -> dict:
    """{operator: (this run, other run)} for the operators whose float
    inputs the denormal flush reads, on chip_smoke.py's data: W (drawn as
    make_analytic_data draws it) and the main path's filter -> join output
    (drawn as make_data draws it, joined once per build)."""
    rng = np.random.default_rng(0)
    n = N_W
    cols = {"p": rng.integers(0, 50, n).astype(np.int32),
            "o": rng.permutation(n).astype(np.int32),
            "v": rng.standard_normal(n).astype(np.float32),
            "q": rng.integers(-2 ** 40, 2 ** 40, n),
            "x": rng.standard_normal(n)}
    nulls = {"v": rng.random(n) < 0.10}
    rng = np.random.default_rng(0)
    fact = {"k": rng.integers(0, N_DIM, N_FACT).astype(np.int64),
            "v": rng.standard_normal(N_FACT).astype(np.float32)}
    fact_nulls = {"k": rng.random(N_FACT) < 0.05,
                  "v": rng.random(N_FACT) < 0.10}
    dim = {"k": rng.permutation(N_DIM).astype(np.int64),
           "w": rng.standard_normal(N_DIM).astype(np.float32)}
    aggs = [("v", "sum", "s"), ("v", "count", "c"), ("v", "avg", "a"),
            ("w", "max", "hi")]
    runs = {}
    for pkg, who in ((other_pkg, 1), (this_pkg, 0)):
        W = pkg.Table.from_dict(cols, nulls, device=dev)
        ft = pkg.Table.from_dict(fact, fact_nulls, device=dev)
        dt = pkg.Table.from_dict(dim, device=dev)
        joined = pkg.ops.join(pkg.ops.filter_table(
            ft, pkg.ops.compare_scalar(ft["v"], 0.0, "lt")), dt, ["k"],
            ["k"], how="inner")
        ops = pkg.ops
        fns = {
            "prefixsum_float64": lambda ops=ops, W=W: ops.prefixsum(W["x"]),
            "window_sum_rows": lambda ops=ops, W=W: ops.window_function(
                W, "v", "sum", preceding=10_000, partition_by=["p"],
                order_by=["o"]),
            "window_avg_running": lambda ops=ops, W=W: ops.window_function(
                W, "v", "avg", partition_by=["p"], order_by=["o"]),
            "window_sum_range": lambda ops=ops, W=W: ops.window_function(
                W, "v", "sum", preceding=N_W // 4, order_by=["o"],
                frame="range"),
            "groupby": lambda ops=ops, j=joined: ops.groupby(j, ["k"], aggs),
            "reductions": lambda ops=ops, W=W: [
                ops.reduce(W["v"], op) for op in
                ("sum", "min", "max", "product", "sum_squared")]}
        for name, fn in fns.items():
            runs.setdefault(name, [None, None])[who] = fn
    return runs


def _tensors(out) -> list:
    """The tensors of an operator's output, a Table's live rows first
    compacted."""
    if isinstance(out, (list, tuple)):
        return [t for o in out for t in _tensors(o)]
    if hasattr(out, "columns"):
        return _tensors(list(out.compact().columns))
    if hasattr(out, "valid"):
        return [out.data] + ([] if out.valid is None else [out.valid])
    return [out]


def _close(a, b, rtol: float = 0.0, atol: float = 0.0) -> bool:
    """Two operators' outputs equal, floats within rtol and atol (NaN
    equal)."""
    ta, tb = _tensors(a), _tensors(b)
    return len(ta) == len(tb) and all(
        x.shape == y.shape and (torch.allclose(x, y, rtol=rtol, atol=atol,
                                               equal_nan=True)
                                if x.is_floating_point() else
                                torch.equal(x, y))
        for x, y in zip(ta, tb))


def host_ms(fn, reps: int) -> float:
    """Host ms per call of fn() ending in a device sync, after a warm-up
    (what chip_smoke.py's rows/s read)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def time_operators(runs, reps, rounds, card, tol=(0.0, 0.0)) -> list:
    """The operators of both builds in turns (other, this, this, other):
    rows/s per timing (N_W rows each), each build's output equal to the
    other's (floats within tol = (rtol, atol))."""
    out = []
    for name, (this, other) in runs.items():
        if not _close(this(), other(), *tol):
            raise RuntimeError(f"{name}: the two builds differ")
        rate = {"other": [], "this": []}
        for _ in range(rounds):
            for who in ("other", "this", "this", "other"):
                ms = host_ms(this if who == "this" else other, reps)
                rate[who].append(N_W / (ms / 1e3))
        out.append({"operator": name, "rows": N_W, "rows_per_s": rate})
        print(f"{name}: " + " ".join(
            f"{who}_rows_per_s=" + ",".join(f"{r:.4e}" for r in rate[who])
            for who in rate) + f" ({card})", flush=True)
    return out


def _equal(got, want) -> bool:
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    return all(bool(((g == w) | (torch.isnan(g) & torch.isnan(w))).all())
               if g.is_floating_point() else torch.equal(g, w)
               for g, w in zip(got, want))


def event_ms(fn, reps: int) -> float:
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


def _copy(event) -> bool:
    """A memset or memcpy: the scans' scratch zeroing, P-8's host read."""
    return event.key.startswith(("Memset", "Memcpy"))


def device_ms(fn, reps: int):
    """(device ms per call of every activity in the window, activities
    seen per call, device ms per call of the kernels alone, memsets and
    memcpys left out) from torch.profiler; (None, 0, None) if three
    profiles saw none."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA]

        def us(evs):
            return sum(getattr(e, "self_device_time_total", None) or
                       e.self_cuda_time_total for e in evs)
        if us(events):
            return (us(events) / reps / 1e3,
                    sum(e.count for e in events) / reps,
                    us([e for e in events if not _copy(e)]) / reps / 1e3)
    return None, 0, None


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def _fmt(values) -> str:
    return ",".join(f"{v:.4f}" if v is not None else "None" for v in values)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m libgdf_tpu_torch.probes.turns",
        description="Probe kernels of this checkout and another, timed in "
                    "turns on one card.")
    ap.add_argument("other", type=Path,
                    help="an unpacked copy of another commit")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--cases", default=None,
                    help="comma-separated names (P-1, P-3, P-4, P-5, P-6, "
                         "P-7, P-8, P-9, P-10, P-11, P-13, K5a, K5b; W for "
                         "the windows, F for the flushed operators); "
                         "default all")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("turns: CUDA is not available", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = card_line()
    print(card, flush=True)
    old = other_probes(args.other.resolve())
    keep = set(args.cases.split(",")) if args.cases else None
    results = []
    for c in cases(dev, old):
        if keep is not None and c["key"].split("@")[0] not in keep:
            continue
        want = c["plain"]()
        runs = {"other": c["other"], "this": c["this"]}
        for who, fn in runs.items():
            got = fn()
            if c["bound_abs"] is None:
                ok = _equal(got, want)
            else:
                ok = bool(((got - want).abs() <= REL_F64 * c["bound_abs"]
                           + REL_F64).all())
            if not ok:
                print(f"{c['key']}: the {who} build differs from the plain "
                      f"version", file=sys.stderr)
                return 1
        del want, got
        times = {who: {"event_ms": [], "device_ms": [], "kernel_ms": [],
                       "kernels_per_call": []} for who in runs}
        for _ in range(args.rounds):
            for who in ("other", "this", "this", "other"):
                times[who]["event_ms"].append(event_ms(runs[who], args.reps))
                ms, seen, kernel = device_ms(runs[who], args.reps)
                times[who]["device_ms"].append(ms)
                times[who]["kernel_ms"].append(kernel)
                times[who]["kernels_per_call"].append(seen)
        lib = c["library"]
        lib_ms = device_ms(lib, args.reps)[0] if lib else None
        lib_x = c["library_x"]
        row = {"case": c["key"], "shapes": c["shapes"], **times,
               "plain_ms": event_ms(c["plain"], args.reps),
               "library_ms": event_ms(lib, args.reps) if lib else None,
               "library_device_ms": lib_ms, "library_x": lib_x,
               "bound_ms": c["bound_ms"]}
        if lib_x != 1:
            row["library_x_reps_ms"] = row["library_ms"] * lib_x
            row["library_x_reps_device_ms"] = (lib_ms * lib_x
                                               if lib_ms is not None
                                               else None)
        results.append(row)
        print(f"{c['key']}: " + " ".join(
            f"{who}_{m}=" + _fmt(times[who][m])
            for who in runs for m in ("device_ms", "kernel_ms", "event_ms",
                                      "kernels_per_call"))
            + f" plain_ms={row['plain_ms']:.4f} library_ms="
            f"{row['library_ms']} library_device_ms={lib_ms}"
            + (f" library_x_reps_ms={row['library_x_reps_ms']:.4f} "
               f"library_x_reps_device_ms="
               f"{row['library_x_reps_device_ms']}" if lib_x != 1 else "")
            + f" bound_ms={row['bound_ms']:.4f} ({card})", flush=True)
    operators = []
    if keep is None or "W" in keep:
        operators += time_operators(
            window_runs(dev, libgdf_tpu_torch, old["pkg"]), args.reps,
            args.rounds, card)
    if keep is None or "F" in keep:
        operators += time_operators(
            flush_runs(dev, libgdf_tpu_torch, old["pkg"]), args.reps,
            args.rounds, card, tol=FLUSH_TOL)
    print(json.dumps({"turns": results, "operators": operators,
                      "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
