"""H1 `compact`: stable stream compaction of several arrays by one mask.

Wrapper around `csrc/compact.cu` (which names the Pallas kernels it
replaces), beside its plain PyTorch version. On CPU tensors the wrapper
runs the plain version; on CUDA tensors it launches the kernel or raises.

Contract (the capacity + count convention of core/table.py): each output
has the input's length, the kept rows come first in their original order,
the rows past the count are unspecified, and the count is a 0-d int32
tensor on the device.
"""
from __future__ import annotations

import torch

from ...core.errors import GDFError, GDFStatus
from . import _lib


def compact_plain(arrays, keep: torch.Tensor):
    """Plain version of `compact`: `arr[keep]`, zero-padded to capacity."""
    outs = []
    for a in arrays:
        kept = a[keep]
        out = torch.zeros_like(a)
        out[:kept.shape[0]] = kept
        outs.append(out)
    return outs, keep.sum(dtype=torch.int32)


def compact(arrays, keep: torch.Tensor):
    """Returns (compacted arrays, count)."""
    arrays = list(arrays)
    if keep.dtype != torch.bool or keep.dim() != 1:
        raise TypeError("compact: keep must be a 1-D bool tensor")
    for a in arrays:
        if a.shape != keep.shape:
            raise ValueError("compact: every array must match keep's length")
    if all(t.device.type == "cpu" for t in [keep, *arrays]):
        return compact_plain(arrays, keep)
    dev = _lib.require_cuda("compact", keep, *arrays)
    n = keep.shape[0]
    if n >= 2 ** 31:
        raise GDFError(GDFStatus.GDF_COLUMN_SIZE_TOO_BIG,
                       "compact: more than 2^31 - 1 rows")
    count = torch.zeros((), dtype=torch.int32, device=dev)
    outs = [torch.empty_like(a) for a in arrays]
    if n == 0:
        return outs, count
    lib = _lib.lib()
    ntiles = -(-n // lib.gdf_compact_tile_elems())
    offsets = torch.empty(ntiles, dtype=torch.int32, device=dev)
    per_launch = lib.gdf_compact_max_arrays()
    with torch.cuda.device(dev):
        stream = _lib.stream_ptr(dev)
        _lib.check(lib.gdf_compact_offsets(keep.data_ptr(), n,
                                           offsets.data_ptr(),
                                           count.data_ptr(), stream),
                   "compact offsets")
        for i in range(0, len(arrays), per_launch):
            ins, chunk = arrays[i:i + per_launch], outs[i:i + per_launch]
            _lib.check(lib.gdf_compact_scatter(
                keep.data_ptr(), n, offsets.data_ptr(), len(ins),
                _lib.pointer_array(ins), _lib.pointer_array(chunk),
                _lib.int_array([a.element_size() for a in ins]), stream),
                "compact scatter")
    compact.launches += 1
    return outs, count


compact.launches = 0
