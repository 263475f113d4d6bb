"""What the probes' wrappers and `main`s share: the launch of a C entry
point, the device a `main` runs on, and its timer."""
from __future__ import annotations

import argparse
import sys
import time

import torch

from ..ops.kernels import _lib


def launch(wrapper, what: str, entry: str, *args) -> None:
    """Call C entry point `entry` of the kernel library on the current
    stream of the (CUDA) device of the tensors among `args`, which stand
    for their data pointers; raise if it fails, else count one launch of
    `wrapper`."""
    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    dev = _lib.require_cuda(what, *tensors)
    fn = getattr(_lib.lib(), entry)
    with torch.cuda.device(dev):
        _lib.check(fn(*[a.data_ptr() if isinstance(a, torch.Tensor) else a
                        for a in args], _lib.stream_ptr(dev)), what)
    _lib.count_launch(wrapper)


def on_cpu(*tensors) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def parser(module: str, description: str) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog=f"python -m libgdf_tpu_torch.probes.{module}",
        description=description)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where to run (default: the card; never falls "
                         "back to the CPU)")
    return ap


def device(name: str) -> torch.device | None:
    """The device a `main` runs on, or None (with a message) if it asked
    for the card and there is none."""
    if name == "cuda" and not torch.cuda.is_available():
        print("CUDA is not available (pass --device cpu to run the plain "
              "versions on the CPU)", file=sys.stderr)
        return None
    return torch.device(name)


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def time_ms(fn, dev: torch.device, reps: int = 10) -> float:
    """Milliseconds per call of fn(), the best of 3 runs of `reps` calls
    after a warm-up: CUDA events on the card, the host clock on the CPU."""
    fn()
    sync(dev)
    best = float("inf")
    for _ in range(3):
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                fn()
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end) / reps
        else:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            ms = (time.perf_counter() - t0) * 1e3 / reps
        best = min(best, ms)
    return best


def require(ok: bool, what: str) -> None:
    """Raise unless a check of a `main` held."""
    if not ok:
        raise RuntimeError(f"check failed: {what}")
