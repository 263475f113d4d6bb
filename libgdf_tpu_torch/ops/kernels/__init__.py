"""Hand-written Hopper kernels (CUDA C++ in `libgdf_tpu_torch/csrc/`).

Counterpart of `libgdf_tpu/ops/pallas/`. Each wrapper runs its plain
PyTorch version on CPU tensors and launches its kernel on CUDA tensors,
and counts its launches in a plain int attribute, `launches`; the scans
and H8 also count them per value dtype (`launches_by_dtype`). The counts change
only under one lock (`_lib.count_launch`), so they stay exact when
several threads launch at once.

  H1 compact      compact.py  <- pallas/compact.py, pallas/compact2.py
  H2 scan         scan.py     <- pallas/scan.py (value scans)
  H3 seg_scan     scan.py     <- pallas/scan.py (pair, 64-bit, f64, sel64)
  H4 expand_fill  expand.py   <- pallas/expand.py
  H5 dense_groupby dense.py   <- none: a group-by over a small integer key
                                 domain without a sort (with domain_probe)
  H6 hash_build,  hash.py     <- none: an inner join on one key of a unique
     hash_probe                  build side through a hash table, without a
                                 sort
  H7 wide_groupby dense.py    <- none: a group-by over a wide integer key
                                 domain without a sort, through slot arrays
  H8 elementwise_ elementwise.py <- none: add / sub / mul of float columns
     binary,                     and a column against a scalar, one pass
     elementwise_compare         each with the denormal flush in its load
"""
from ._lib import COUNT_LOCK, build, count_launch, reset_counts
from .compact import compact, compact_plain
from .dense import (dense_groupby, dense_groupby_plain, domain_probe,
                    domain_probe_plain, wide_groupby)
from .elementwise import (elementwise_binary, elementwise_binary_plain,
                          elementwise_compare, elementwise_compare_plain)
from .expand import SENTINEL, expand_fill, expand_fill_plain
from .hash import (HashTable, SortedTable, hash_build, hash_build_plain,
                   hash_probe, hash_probe_plain)
from .scan import scan, scan_plain, seg_scan, seg_scan_plain

WRAPPERS = {"compact": compact, "scan": scan, "seg_scan": seg_scan,
            "expand_fill": expand_fill, "domain_probe": domain_probe,
            "dense_groupby": dense_groupby, "hash_build": hash_build,
            "hash_probe": hash_probe, "wide_groupby": wide_groupby,
            "elementwise_binary": elementwise_binary,
            "elementwise_compare": elementwise_compare}


def launch_counts() -> dict:
    """{wrapper: launches}, plus {"wrapper[dtype]": launches} for each
    value dtype a scan or H8 has launched at since the last reset."""
    with COUNT_LOCK:
        counts = {name: fn.launches for name, fn in WRAPPERS.items()}
        for name, fn in WRAPPERS.items():
            for dt, k in getattr(fn, "launches_by_dtype", {}).items():
                counts[f"{name}[{dt}]"] = k
    return counts


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        reset_counts(fn)


__all__ = [
    "build", "count_launch", "compact", "compact_plain", "scan",
    "scan_plain", "seg_scan", "seg_scan_plain", "expand_fill",
    "expand_fill_plain", "SENTINEL", "dense_groupby", "dense_groupby_plain",
    "domain_probe", "domain_probe_plain", "HashTable", "SortedTable",
    "hash_build", "hash_build_plain", "hash_probe", "hash_probe_plain",
    "wide_groupby", "elementwise_binary", "elementwise_binary_plain",
    "elementwise_compare", "elementwise_compare_plain",
    "WRAPPERS", "launch_counts", "reset_launch_counts",
]
