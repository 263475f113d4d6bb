"""Time probe kernels of this checkout and of another one in turns, on one card.

    python -m libgdf_tpu_torch.probes.turns OTHER [--reps 20] [--rounds 2]
        [--cases P-1,P-10,W]

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
block), P-9 (`cap_cumsum2d` of the probe's (64, 128) ones), P-10
(`cap_onehot_compact`) at the probe's 256 elements and at 40,960 tiles
of 256, and P-13 (`cap_carry`) at the probe's 4 tiles of ones and at
1000 tiles of random int32. `--cases` keeps those whose name (before any
"@") is listed. Both builds must equal the plain version exactly. Then, per
round, the two are timed in turns (other, this, this, other): CUDA-event
ms per call over `reps` back-to-back calls, and device ms per call from
torch.profiler over every kernel in the window, with the kernels the
profile saw per call (a profile that drops records shows fewer than the
build launches). The plain version and the library call are timed once:
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
builds' outputs are equal. It prints the card line, one line per
case and a JSON line of every number; it exits 1 without CUDA or if a
check fails.
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
          library_x=1):
    """`library_x`: how many library calls one call of the kernel is worth
    (the rolls' single rotation against the kernel's `roll.REPS`)."""
    return {"key": key, "shapes": shapes, "this": this, "other": other,
            "plain": plain, "library": library, "library_x": library_x,
            "bound_ms": max(moved / HBM_BYTES_PER_MS,
                            ops / SCALAR_OPS_PER_MS)}


def cases(dev: torch.device, old: dict, seed: int = 0) -> list:
    """P-1, the gathers P-3, P-4, P-5, the rolls P-6, P-7, P-9, P-10 and
    P-13, drawn as chip_smoke.py's probe path draws them (the lane
    gather's draws included, then dropped; P-13's 1000 tiles last)."""
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
    return out


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


def time_windows(dev, this_pkg, other_pkg, reps, rounds, card) -> list:
    """The two windows of both builds in turns (other, this, this, other):
    rows/s per timing, each build's output equal to the other's."""
    out = []
    for name, (this, other) in window_runs(dev, this_pkg, other_pkg).items():
        a, b = this(), other()
        if not (_equal(a.data, b.data) and torch.equal(a.valid, b.valid)):
            raise RuntimeError(f"{name}: the two builds differ")
        del a, b
        rate = {"other": [], "this": []}
        for _ in range(rounds):
            for who in ("other", "this", "this", "other"):
                ms = host_ms(this if who == "this" else other, reps)
                rate[who].append(N_W / (ms / 1e3))
        out.append({"window": name, "rows": N_W, "rows_per_s": rate})
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


def device_ms(fn, reps: int):
    """(device ms per call of every kernel in the window, kernels seen per
    call) from torch.profiler; (None, 0) if three profiles saw none."""
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
        us = sum(getattr(e, "self_device_time_total", None) or
                 e.self_cuda_time_total for e in events)
        if us:
            return us / reps / 1e3, sum(e.count for e in events) / reps
    return None, 0


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
                         "P-7, P-9, P-10, P-13, and W for the windows); "
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
            if not _equal(fn(), want):
                print(f"{c['key']}: the {who} build differs from the plain "
                      f"version", file=sys.stderr)
                return 1
        del want
        times = {who: {"event_ms": [], "device_ms": [],
                       "kernels_per_call": []} for who in runs}
        for _ in range(args.rounds):
            for who in ("other", "this", "this", "other"):
                times[who]["event_ms"].append(event_ms(runs[who], args.reps))
                ms, seen = device_ms(runs[who], args.reps)
                times[who]["device_ms"].append(ms)
                times[who]["kernels_per_call"].append(seen)
        lib_ms, _ = device_ms(c["library"], args.reps)
        lib_x = c["library_x"]
        row = {"case": c["key"], "shapes": c["shapes"], **times,
               "plain_ms": event_ms(c["plain"], args.reps),
               "library_ms": event_ms(c["library"], args.reps),
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
            for who in runs for m in ("device_ms", "event_ms",
                                      "kernels_per_call"))
            + f" plain_ms={row['plain_ms']:.4f} library_ms="
            f"{row['library_ms']:.4f} library_device_ms={lib_ms}"
            + (f" library_x_reps_ms={row['library_x_reps_ms']:.4f} "
               f"library_x_reps_device_ms="
               f"{row['library_x_reps_device_ms']}" if lib_x != 1 else "")
            + f" bound_ms={row['bound_ms']:.4f} ({card})", flush=True)
    windows = []
    if keep is None or "W" in keep:
        windows = time_windows(dev, libgdf_tpu_torch, old["pkg"], args.reps,
                               args.rounds, card)
    print(json.dumps({"turns": results, "windows": windows, "card": card}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
