"""Time the gathers of this checkout and of another one in turns, on one card.

    python -m libgdf_tpu_torch.probes.turns OTHER [--reps 20] [--rounds 2]

OTHER is an unpacked copy of another commit (for the parent:
`git archive HEAD`) in a git-ignored directory such as `build/parent`. Its
package is imported whole under another name, so its own wrappers call
its own kernel library with its own C signatures; that library is built
from OTHER/libgdf_tpu_torch/csrc into OTHER/build/kernels.

For P-3 (`sublane_gather`), P-4 (`flat_take` of the 64K table) and P-5
(`flat_take` of the (512, 128) table), on the inputs of `chip_smoke.py`'s
probe path (the probe's own, and 81,920 x 128 indices), both builds must
equal the plain version exactly. Then, per round, the two are timed in
turns (other, this, this, other): CUDA-event ms per call over `reps`
back-to-back calls, and device ms per call from torch.profiler over every
kernel in the window (each wrapper call launches one). The plain version
and the library call (`torch.take_along_dim`, or indexing, on int64
indices) are timed once; the bound is the bytes read once and written
once over the H100's 3.35 TB/s. It prints the card line, one line per
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
from pathlib import Path

import numpy as np
import torch

from . import gather

HBM_BYTES_PER_MS = 3.35e12 / 1e3        # H100 SXM data sheet, at 700 W
SCALE_ROWS = 81_920
LIBRARY = {"sublane": lambda x, i64: torch.take_along_dim(x, i64, 0),
           "flat": lambda t, i64: t.reshape(-1)[i64]}


def other_gather(root: Path):
    """The `probes.gather` module of the package under `root`, imported
    as `libgdf_tpu_torch_other`."""
    name = "libgdf_tpu_torch_other"
    init = root / "libgdf_tpu_torch" / "__init__.py"
    spec = importlib.util.spec_from_file_location(
        name, init, submodule_search_locations=[str(init.parent)])
    pkg = importlib.util.module_from_spec(spec)
    sys.modules[name] = pkg
    spec.loader.exec_module(pkg)
    return importlib.import_module(f"{name}.probes.gather")


def cases(dev: torch.device, seed: int = 0) -> list:
    """[(key, kind, x, idx)]: P-3, P-4, P-5 at the probe's shapes and at
    SCALE_ROWS x 128 indices, drawn as chip_smoke.py's probe path draws
    them (the lane gather's draws included, then dropped)."""
    rng = np.random.default_rng(seed)
    out = []
    for i, (_, kind, x, idx) in enumerate(gather.probe_inputs()):
        size = {"lane": 128, "sublane": x.shape[0], "flat": x.size}[kind]
        big = rng.integers(0, size, (SCALE_ROWS, 128)).astype(np.int32)
        if kind == "lane":
            rng.standard_normal((SCALE_ROWS, 128))
            continue
        pn = "P-3" if kind == "sublane" else "P-4" if i == 2 else "P-5"
        xt = torch.as_tensor(x, device=dev)
        out += [(pn, kind, xt, torch.as_tensor(idx, device=dev)),
                (f"{pn}@scale", kind, xt, torch.as_tensor(big, device=dev))]
    return out


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
    """Device ms per call of every kernel in the window, from
    torch.profiler; None if three profiles saw none."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = sum(getattr(e, "self_device_time_total", None) or
                 e.self_cuda_time_total for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA)
        if us:
            return us / reps / 1e3
    return None


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m libgdf_tpu_torch.probes.turns",
        description="The gathers of this checkout and another, timed in "
                    "turns on one card.")
    ap.add_argument("other", type=Path,
                    help="an unpacked copy of another commit")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("turns: CUDA is not available", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = card_line()
    print(card, flush=True)
    old = other_gather(args.other.resolve())
    results = []
    for key, kind, x, idx in cases(dev):
        want = gather.PLAIN[kind](x, idx)
        runs = {"other": lambda f=old.GATHERS[kind]: f(x, idx),
                "this": lambda f=gather.GATHERS[kind]: f(x, idx)}
        for who, fn in runs.items():
            got = fn()
            same = (got == want) | (torch.isnan(got) & torch.isnan(want))
            if not bool(same.all()):
                print(f"{key}: the {who} build differs from the plain "
                      f"version", file=sys.stderr)
                return 1
        times = {who: {"event_ms": [], "device_ms": []} for who in runs}
        for _ in range(args.rounds):
            for who in ("other", "this", "this", "other"):
                times[who]["event_ms"].append(event_ms(runs[who], args.reps))
                times[who]["device_ms"].append(device_ms(runs[who],
                                                         args.reps))
        i64 = idx.long()
        row = {"case": key, "x": list(x.shape), "idx": list(idx.shape),
               **times,
               "plain_ms": event_ms(lambda: gather.PLAIN[kind](x, idx),
                                    args.reps),
               "library_ms": event_ms(lambda: LIBRARY[kind](x, i64),
                                      args.reps),
               "library_device_ms": device_ms(
                   lambda: LIBRARY[kind](x, i64), args.reps),
               "bound_ms": (x.numel() + 2 * idx.numel()) * 4
               / HBM_BYTES_PER_MS}
        results.append(row)
        print(f"{key}: " + " ".join(
            f"{who}_{m}=" + ",".join(f"{v:.4f}" if v is not None else "None"
                                     for v in times[who][m])
            for who in runs for m in ("device_ms", "event_ms"))
            + f" plain_ms={row['plain_ms']:.4f} library_ms="
            f"{row['library_ms']:.4f} library_device_ms="
            f"{row['library_device_ms']} bound_ms={row['bound_ms']:.4f} "
            f"({card})", flush=True)
    print(json.dumps({"turns": results, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
