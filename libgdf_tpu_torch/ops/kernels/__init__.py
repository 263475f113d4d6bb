"""Hand-written Hopper kernels (CUDA C++ in `libgdf_tpu_torch/csrc/`).

Counterpart of `libgdf_tpu/ops/pallas/`. Each wrapper runs its plain
PyTorch version on CPU tensors and launches its kernel on CUDA tensors,
and counts its launches in a plain int attribute, `launches`.

  H1 compact      compact.py  <- pallas/compact.py, pallas/compact2.py
  H2 scan         scan.py     <- pallas/scan.py (value scans)
  H3 seg_scan     scan.py     <- pallas/scan.py (pair, 64-bit, f64, sel64)
  H4 expand_fill  expand.py   <- pallas/expand.py
"""
from ._lib import build
from .compact import compact, compact_plain
from .expand import SENTINEL, expand_fill, expand_fill_plain
from .scan import scan, scan_plain, seg_scan, seg_scan_plain

WRAPPERS = {"compact": compact, "scan": scan, "seg_scan": seg_scan,
            "expand_fill": expand_fill}


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


__all__ = [
    "build", "compact", "compact_plain", "scan", "scan_plain", "seg_scan",
    "seg_scan_plain", "expand_fill", "expand_fill_plain", "SENTINEL",
    "WRAPPERS", "launch_counts", "reset_launch_counts",
]
