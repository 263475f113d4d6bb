"""Hopper counterparts of the Pallas cost probes under `benchmarks/`.

Each module holds its kernels' wrappers (CUDA C++ in `csrc/probe_*.cu`,
built into the probes' own library, `_common.LIBRARY`, at a probe's first
launch), their plain PyTorch versions and a `main`, which prints what its
probe prints:

    python -m libgdf_tpu_torch.probes.tilesort [n] [--device cpu]
    python -m libgdf_tpu_torch.probes.gather [--device cpu]
    python -m libgdf_tpu_torch.probes.roll [--device cpu]
    python -m libgdf_tpu_torch.probes.caps [--device cpu]

A `main` runs on the card, or on the CPU only when asked; without CUDA it
exits non-zero. As in `ops/kernels`, a wrapper runs its plain version on
CPU tensors, launches its kernel on CUDA tensors or raises, and counts its
launches in `launches` (`ops/kernels/_lib.py::count_launch`).

  P-1          tile_sort           tilesort.py  <- probe_tilesort.py:91
  P-2, P-12    lane_gather         gather.py    <- probe_pallas_gather.py:63,
                                                   probe_pallas_caps.py:138
  P-3          sublane_gather      gather.py    <- probe_pallas_gather.py:87
  P-4, P-5     flat_take           gather.py    <- probe_pallas_gather.py:111,
                                                   :142
  P-6, P-7     roll_static,        roll.py      <- probe_roll.py:38, :46
               roll_dynamic
  P-8 .. P-11, cap_*               caps.py      <- probe_pallas_caps.py:40,
  P-13, P-14                                       54, 89, 114, 157, 176

The submodules are imported when first asked for, not by this package, so
that `python -m` runs each as the only copy of itself.
"""
from __future__ import annotations

from ..ops.kernels._lib import COUNT_LOCK, reset_counts


def wrappers() -> dict:
    """{name: wrapper} of every probe kernel."""
    from . import caps, gather, roll, tilesort
    return {"tile_sort": tilesort.tile_sort,
            "lane_gather": gather.lane_gather,
            "sublane_gather": gather.sublane_gather,
            "flat_take": gather.flat_take,
            "roll_static": roll.roll_static,
            "roll_dynamic": roll.roll_dynamic,
            **{name: getattr(caps, name) for name in caps.CAPS}}


def launch_counts() -> dict:
    """{wrapper: launches} since the last reset."""
    fns = wrappers()
    with COUNT_LOCK:
        return {name: fn.launches for name, fn in fns.items()}


def reset_launch_counts() -> None:
    for fn in wrappers().values():
        reset_counts(fn)


__all__ = ["wrappers", "launch_counts", "reset_launch_counts"]
