"""H2 `scan` and H3 `seg_scan`: inclusive (segmented) prefix scans.

Wrappers around `csrc/scan.cu` (which names the Pallas kernels it
replaces), each beside its plain PyTorch version. On a CPU tensor the
wrapper runs the plain version; on a CUDA tensor it launches the kernel or
raises.

  scan(kind, x, reverse)      kind in {sum, max, min}; `reverse` scans
                              suffixes inside the kernel.
  seg_scan(kind, flags, vals) kind in {sum, max, min, carry}: restarts at
                              flagged heads; `carry` fills forward the last
                              flagged value, and positions before any flag
                              keep their own value.

A float sum reads a denormal input as zero, as XLA's does
(core/bits.py::flush_denormals): the kernel flushes each element as it
loads it, the plain version flushes the input and then scans.

Both are one pass with decoupled look-back: one memset of a scratch buffer
(the tile counter and descriptors) and one launch.

Value dtypes: int32, int64, float32, float64. Integer sums wrap; float
max/min propagate NaN. Each wrapper counts its launches in total
(`launches`) and per value dtype (`launches_by_dtype`, keyed "int64" and
so on): H2 at int64 and float64 is what replaces the TPU's K4a and K5a.
"""
from __future__ import annotations

import torch

from ...core.bits import flush_denormals
from . import _lib

_DTYPES = {torch.int32: 0, torch.int64: 1, torch.float32: 2,
           torch.float64: 3}
_KINDS = {"sum": 0, "max": 1, "min": 2, "carry": 3}
_OPS = {"sum": torch.add, "max": torch.maximum, "min": torch.minimum}


def scan_plain(kind: str, x: torch.Tensor, reverse: bool = False):
    """Plain version of `scan`: torch.cumsum (of the flushed input) /
    cummax / cummin."""
    if x.shape[0] == 0:
        return x.clone()
    if reverse:
        x = torch.flip(x, [0])
    if kind == "sum":
        out = torch.cumsum(flush_denormals(x), 0, dtype=x.dtype)
    elif kind == "max":
        out = torch.cummax(x, 0).values
    else:
        out = torch.cummin(x, 0).values
    return torch.flip(out, [0]) if reverse else out


def seg_scan_plain(kind: str, flags: torch.Tensor, vals: torch.Tensor):
    """Plain version of `seg_scan`: a log-step doubling scan with the pair
    combine (fa, va) + (fb, vb) = (fa | fb, fb ? vb : op(va, vb))
    (libgdf_tpu/ops/engine.py:243-251, and :295-300 for `carry`); a sum
    reads the flushed values."""
    f = flags.to(torch.bool)
    v = flush_denormals(vals) if kind == "sum" else vals
    n = v.shape[0]
    s = 1
    while s < n:
        fb, vb = f[s:], v[s:]
        if kind == "carry":
            nv = torch.where(fb, vb, v[:-s])
        else:
            nv = torch.where(fb, vb, _OPS[kind](v[:-s], vb))
        v = torch.cat([v[:s], nv])
        f = torch.cat([f[:s], fb | f[:-s]])
        s <<= 1
    if kind == "carry":
        v = torch.where(f, v, vals)
    return v.clone() if v is vals else v


def _prepare(what: str, vals: torch.Tensor, *more):
    """Check a launch's tensors; returns (device, output like vals)."""
    if vals.dtype not in _DTYPES:
        raise TypeError(f"{what}: unsupported dtype {vals.dtype}")
    return _lib.require_cuda(what, vals, *more), torch.empty_like(vals)


def scan(kind: str, x: torch.Tensor, reverse: bool = False) -> torch.Tensor:
    """Inclusive scan (sum/max/min) of a 1-D tensor; `reverse` scans
    suffixes."""
    if kind not in ("sum", "max", "min"):
        raise ValueError(f"scan: unknown kind {kind!r}")
    if x.dim() != 1:
        raise ValueError("scan: 1-D tensors only")
    if x.device.type == "cpu":
        return scan_plain(kind, x, reverse)
    dev, out = _prepare("scan", x)
    n = x.shape[0]
    if n == 0:
        return out
    lib = _lib.lib()
    dt = _DTYPES[x.dtype]
    # The tile counter and the tiles' descriptors, zeroed by gdf_scan.
    scratch = torch.empty(lib.gdf_scan_scratch_bytes(dt, n),
                          dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        err = lib.gdf_scan(dt, _KINDS[kind], int(reverse), x.data_ptr(),
                           out.data_ptr(), n, scratch.data_ptr(),
                           scratch.shape[0], _lib.stream_ptr(dev))
    _lib.check(err, "scan")
    _lib.count_launch(scan, x.dtype)
    return out


scan.launches = 0
scan.launches_by_dtype = {}


def seg_scan(kind: str, flags: torch.Tensor, vals: torch.Tensor):
    """Inclusive segmented scan (sum/max/min) restarting at flagged heads,
    or the flagged carry-forward fill (`carry`)."""
    if kind not in _KINDS:
        raise ValueError(f"seg_scan: unknown kind {kind!r}")
    if vals.dim() != 1 or flags.shape != vals.shape:
        raise ValueError("seg_scan: flags and vals must be 1-D, same length")
    if vals.device.type == "cpu" and flags.device.type == "cpu":
        return seg_scan_plain(kind, flags, vals)
    if flags.dtype != torch.bool:
        flags = flags != 0
    dev, out = _prepare("seg_scan", vals, flags)
    n = vals.shape[0]
    if n == 0:
        return out
    lib = _lib.lib()
    dt = _DTYPES[vals.dtype]
    # The tile counter and the tiles' descriptors, zeroed by gdf_seg_scan.
    scratch = torch.empty(lib.gdf_seg_scan_scratch_bytes(dt, n),
                          dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        err = lib.gdf_seg_scan(dt, _KINDS[kind], flags.data_ptr(),
                               vals.data_ptr(), out.data_ptr(), n,
                               scratch.data_ptr(), scratch.shape[0],
                               _lib.stream_ptr(dev))
    _lib.check(err, "seg_scan")
    _lib.count_launch(seg_scan, vals.dtype)
    return out


seg_scan.launches = 0
seg_scan.launches_by_dtype = {}
