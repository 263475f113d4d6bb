"""What the probes' wrappers and `main`s share: their kernel library, the
launch of one of its C entry points, its occupancy queries, the device a
`main` runs on, and its timer."""
from __future__ import annotations

import argparse
import ctypes
import functools
import sys
import time

import torch

from ..ops.kernels import _lib

_P = ctypes.c_void_p
_PI = ctypes.POINTER(ctypes.c_int)
_I = ctypes.c_int
_I64 = ctypes.c_int64

# The probes' own library, built at a probe's first launch: the operators'
# library (`_lib.KERNELS`) holds none of these.
LIBRARY = _lib.Library("probes", (
    "probe_caps.cu", "probe_gather.cu", "probe_roll.cu", "probe_tilesort.cu",
    "common.cuh"), {
    "gdf_probe_tile_sort_clusters": (_I, [_PI]),
    "gdf_probe_tile_sort": (_I, [_P, _P, _P, _P, _I64, _P]),
    "gdf_probe_lane_gather": (_I, [_P, _P, _P, _I64, _I, _P]),
    "gdf_probe_sublane_occupancy": (_I, [_I, _PI]),
    "gdf_probe_sublane_gather": (_I, [_P, _I, _P, _P, _I64, _I, _I, _I, _P]),
    "gdf_probe_flat_take_occupancy": (_I, [_I, _PI]),
    "gdf_probe_flat_take": (_I, [_P, _I64, _P, _P, _I64, _I, _I, _I, _P]),
    "gdf_probe_roll_static": (_I, [_P, _P, _I64, _I, _P]),
    "gdf_probe_roll_dynamic": (_I, [_P, _P, _P, _I64, _I, _P]),
    "gdf_probe_cap_dyn_store": (_I, [_P, _P, _I, _P]),
    "gdf_probe_cap_cumsum2d": (_I, [_P, _P, _I, _P]),
    "gdf_probe_cap_onehot_compact": (_I, [_P, _P, _P, _I64, _P]),
    "gdf_probe_cap_bulk_copy": (_I, [_P, _P, _I, _P]),
    "gdf_probe_cap_carry": (_I, [_P, _P, _I, _P]),
    "gdf_probe_cap_dyn_loop": (_I, [_P, _P, _I, _I, _P]),
})


def launch(wrapper, what: str, entry: str, *args) -> None:
    """Call C entry point `entry` of the probes' library on the current
    stream of the (CUDA) device of the tensors among `args`, which stand
    for their data pointers; raise if it fails, else count one launch of
    `wrapper`."""
    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    dev = _lib.require_cuda(what, *tensors)
    fn = getattr(LIBRARY.load(), entry)
    ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    with torch.cuda.device(dev):
        LIBRARY.check(fn(*ptrs, _lib.stream_ptr(dev)), what)
    _lib.count_launch(wrapper)


@functools.lru_cache(maxsize=None)
def units(device_index: int, entry: str, *args) -> int:
    """What occupancy query `entry` of the probes' library answers for its
    arguments on the card `device_index` (one call per key)."""
    out = ctypes.c_int(0)
    fn = getattr(LIBRARY.load(), entry)
    with torch.cuda.device(device_index):
        LIBRARY.check(fn(*args, ctypes.byref(out)), entry)
    return out.value


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
