"""H1 `compact`: stable stream compaction of several arrays by one mask.

Wrapper around `csrc/compact.cu` (which names the Pallas kernels it
replaces), beside its plain PyTorch version: one memset of the scratch and
one launch for each group of up to `gdf_compact_max_arrays()` arrays. On
CPU tensors the wrapper runs the plain version; on CUDA tensors it
launches the kernel or raises.

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
    outs = [torch.empty_like(a) for a in arrays]
    if n == 0:
        return outs, torch.zeros((), dtype=torch.int32, device=dev)
    lib = _lib.lib()
    # the kernel always writes the count; the tile counter and descriptors
    # in the scratch are zeroed by gdf_compact
    count = torch.empty((), dtype=torch.int32, device=dev)
    scratch = torch.empty(lib.gdf_compact_scratch_bytes(n), dtype=torch.uint8,
                          device=dev)
    per_launch = lib.gdf_compact_max_arrays()
    with torch.cuda.device(dev):
        stream = _lib.stream_ptr(dev)
        for i in range(0, max(len(arrays), 1), per_launch):
            ins, chunk = arrays[i:i + per_launch], outs[i:i + per_launch]
            _lib.check(lib.gdf_compact(
                keep.data_ptr(), n, len(ins), _lib.pointer_array(ins),
                _lib.pointer_array(chunk),
                _lib.int_array([a.element_size() for a in ins]),
                count.data_ptr(), scratch.data_ptr(), scratch.shape[0],
                stream), "compact")
    _lib.count_launch(compact)
    return outs, count


compact.launches = 0
